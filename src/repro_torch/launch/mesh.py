"""The serving mesh: one process a shard (counterpart of
``repro/launch/mesh.py``).

The JAX package runs one controller over a device mesh. The port runs one
process a rank, single-program multiple-data: rank 0, the origin, serves
the topology and owns shard 0; every other rank holds its own partition and
follows the origin's messages (``MeshBackend.follow``).

The collective backend follows one rule, decided once per launch and
logged: NCCL when each rank has a card of its own, gloo when ranks share a
card or run on the CPU. It is never switched after a failure. A group made
here has a timeout, so a rank that stops answering fails the run within
it instead of hanging it.

    torchrun --nproc-per-node=N -m repro_torch.launch.serve --fleet N \\
        --sharded --exec mesh ...

A FUNCTION, not a module constant: importing this module starts no
process and touches no device.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

__all__ = ["collective_backend", "init_shard_group", "init_from_env",
           "make_shard_mesh", "make_test_mesh", "rank_device",
           "follower_main"]

log = logging.getLogger(__name__)

TIMEOUT_S = 300.0   # a collective that waits longer fails the run


def collective_backend(world_size: int, device="cuda") -> str:
    """NCCL when each of ``world_size`` ranks has a card of its own, gloo
    when ranks share a card or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or card
    ``rank % cards`` (ranks share a card when there are more ranks than
    cards). No CPU stands in for a missing card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh asks for a card and none is visible: "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_shard_group(rank: int, world_size: int, *,
                     init_method: str = "env://", device="cuda",
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group of a ``world_size``-rank mesh as ``rank``,
    through ``init_method`` (``env://`` under torchrun, ``file://`` or
    ``tcp://`` otherwise), with the backend ``collective_backend`` picks.
    Returns the device this rank computes on."""
    backend = collective_backend(world_size, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("mesh rank %d of %d: %s collectives, computing on %s", rank,
             world_size, backend, dev)
    return dev


def init_from_env(device="cuda", timeout_s: float = TIMEOUT_S
                  ) -> torch.device | None:
    """``init_shard_group`` from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT); None, and no group, outside torchrun."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return None
    return init_shard_group(int(os.environ["RANK"]),
                            int(os.environ["WORLD_SIZE"]),
                            device=device, timeout_s=timeout_s)


def make_shard_mesh(n_shards: int, axis: str = "shard", *, device="cuda"):
    """The 1-D serving mesh of the topology's ``mesh`` execution backend:
    one rank a shard along ``axis``, over the initialised process group,
    whose world size must be ``n_shards``. Its device type is where the
    collectives run (``"cpu"`` for gloo, ``"cuda"`` for NCCL); ``device``
    is where the ranks compute, and an NCCL group computes on cards."""
    from torch.distributed.device_mesh import init_device_mesh
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != n_shards:
        found = "no process group is initialised" if have is None \
            else f"the process group has {have} ranks"
        raise ValueError(
            f"mesh backend needs {n_shards} ranks for {n_shards} shards, one "
            f"process a shard, but {found} — launch with torchrun "
            f"--nproc-per-node={n_shards} (or call init_process_group with "
            f"RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the "
            f"environment; launch.mesh.init_shard_group does it for spawned "
            f"ranks)")
    backend = dist.get_backend()
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("an NCCL group computes on cards; got device "
                         f"{device!r}")
    return init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (n_shards,), mesh_dim_names=(axis,))


def make_test_mesh(data: int = 1, model: int = 1):
    """A small ("data", "model") mesh over however many ranks the process
    group has (one process without a group cannot make one)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError("make_test_mesh needs an initialised process group")
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def follower_main(rank: int, world_size: int, init_method: str,
                  device="cuda", timeout_s: float = TIMEOUT_S,
                  axis: str = "shard") -> None:
    """A follower rank's whole life, as a spawned process runs it: join the
    group, build the mesh, follow the origin until it stops, leave. An
    exception ends the process with a non-zero exit."""
    from ..core.execbackend import MeshBackend
    dev = init_shard_group(rank, world_size, init_method=init_method,
                           device=device, timeout_s=timeout_s)
    try:
        MeshBackend.follow(make_shard_mesh(world_size, axis, device=device),
                           dev)
    finally:
        dist.destroy_process_group()
