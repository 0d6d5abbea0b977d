"""Manifest-based checkpointing: atomic, resumable, integrity-checked
(counterpart of ``repro/checkpoint/manifest.py``, on the same disk layout).

Layout (one directory per step):

    <root>/step_000000120/
        manifest.json        # step, n_leaves, paths, config hash, index
        arr_00000.npy ...    # one .npy of raw bytes per leaf

The leaves are listed in the JAX package's pytree order (dict keys sorted,
``repro_torch.tree``) and each is stored as its raw bytes (a uint8 .npy),
its dtype spelled as numpy / ml_dtypes spell it (``bfloat16``,
``float32``, ``int32``), with the adler32 of those bytes; so a checkpoint
written by either package restores in the other, bit for bit. The JAX
package's manifest also records its ``treedef`` string, which neither
package reads back; this one does not write it.

Write protocol: write into ``<root>/.tmp_<step>``, then rename it to its
final name in one step: a torn write never leaves a directory that
``latest_step`` would pick up. ``restore`` verifies every leaf's checksum
and the config hash and raises on a mismatch (``launch/train.py`` then
falls back to the previous step). ``AsyncWriter`` copies the tree to the
host at once and serialises it on a thread.

On a mesh (``sharding.use_mesh``, every rank calling) a tree of rank
blocks comes with ``shardings``, a tree of the same structure holding
each leaf's ``sharding.NamedSharding`` (None for a replicated leaf):
``save`` gathers each leaf whole, one leaf at a time, and the origin
(flat mesh position 0) writes the files a one-process run writes (the JAX
package writes ``np.asarray`` of the global array); ``restore`` reads
each leaf whole on every rank and keeps the rank's block. A checkpoint
saved on a mesh restores in one process, and one saved in one process
on a mesh, bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as T
from ..distributed.sharding import block_of, current_mesh, gather_whole

__all__ = ["save", "restore", "latest_step", "AsyncWriter", "config_hash"]


def config_hash(obj: Any) -> str:
    """The first 16 hex digits of sha256(repr(obj)): the JAX package's, and
    the two packages' ``ModelConfig`` reprs are equal."""
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _raw(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes in C order, as uint8."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy() if t.numel() else \
        np.zeros((0,), np.uint8)


def _spec_leaves(tree: Any, shardings: Any) -> list:
    """Each leaf's resolved spec (None: whole), in ``T.leaves``' order."""
    n = len(T.leaves(tree))
    if shardings is None:
        return [None] * n
    specs = [None if ns is None else ns.spec for _, ns in
             _pairs(tree, shardings)]
    if len(specs) != n:
        raise ValueError(f"{len(specs)} shardings for {n} leaves")
    return specs


def _pairs(tree, shardings):
    """(leaf, its sharding) of ``tree`` and a tree of shardings of the
    same structure, where a None sharding stands for a whole subtree."""
    if tree is None:
        return []
    kids = T._children(tree)
    if kids is None:
        return [(tree, shardings)]
    if shardings is None:
        return [(x, None) for x in T.leaves(tree)]
    return [pair for (_, a), (_, b) in zip(kids, T._children(shardings))
            for pair in _pairs(a, b)]


def _writes() -> bool:
    """Whether this rank writes: the origin of the current mesh, or the
    only process."""
    mesh = current_mesh()
    return mesh is None or int(mesh.mesh.reshape(-1)[0]) == dist.get_rank()


def _host_whole(tree: Any, shardings: Any) -> Any:
    """On the writing rank, ``tree``'s leaves whole on the host; None on
    the others. Each leaf is gathered and copied one at a time."""
    out = []
    for x, spec in zip(T.leaves(tree), _spec_leaves(tree, shardings)):
        w = x if spec is None else gather_whole(x, spec)
        out.append(w.detach().to("cpu", copy=True) if _writes() else None)
        del w
    return T.unflatten_like(tree, out) if _writes() else None


def save(root: str | pathlib.Path, step: int, tree: Any, *,
         config: Any = None, extra: dict | None = None,
         shardings: Any = None) -> pathlib.Path:
    """Write ``tree`` (tensors in dicts, lists, tuples and NamedTuples) as
    step ``step`` under ``root``; returns the step's directory. On a mesh
    (the module's docstring) every rank calls it with its blocks and their
    ``shardings``; the origin writes."""
    if shardings is not None and current_mesh() is not None:
        tree = _host_whole(tree, shardings)
        if tree is None:
            return pathlib.Path(root) / f"step_{step:09d}"
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".tmp_{step:09d}"
    final = root / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    pairs = T.leaves_with_paths(tree)
    index = []
    for i, (_, leaf) in enumerate(pairs):
        raw = _raw(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, raw)
        index.append({
            "file": fname,
            "shape": list(leaf.shape),
            "dtype": _dtype_name(leaf.dtype),
            "adler32": zlib.adler32(raw.tobytes()) & 0xFFFFFFFF,
        })
    manifest = {
        "step": step,
        "n_leaves": len(pairs),
        "paths": [p for p, _ in pairs],
        "config_hash": config_hash(config) if config is not None else None,
        "index": index,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(root: str | pathlib.Path) -> int | None:
    """The highest step with a finished directory (``step_*``), or None."""
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in root.iterdir()
                   if p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore(root: str | pathlib.Path, step: int, like: Any, *,
            config: Any = None, shardings: Any = None) -> Any:
    """Step ``step`` in the structure of ``like`` (a tree of tensors): each
    leaf on its ``like`` leaf's device, cast to its type where the stored
    type differs. Verifies the checksums (``IOError``), the config hash,
    the leaf count and the shapes (``ValueError``). On a mesh, ``like``
    holds the rank's blocks and ``shardings`` their layout: each leaf is
    read whole and the rank keeps its block."""
    specs = _spec_leaves(like, shardings) if current_mesh() is not None \
        else [None] * len(T.leaves(like))
    d = pathlib.Path(root) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if config is not None and manifest.get("config_hash") not in (
            None, config_hash(config)):
        raise ValueError("checkpoint/config hash mismatch")
    want = T.leaves(like)
    if len(want) != manifest["n_leaves"]:
        raise ValueError(
            f"leaf count mismatch: {len(want)} vs {manifest['n_leaves']}")
    out = []
    for i, (leaf, meta) in enumerate(zip(want, manifest["index"])):
        raw = np.load(d / meta["file"])
        if zlib.adler32(raw.tobytes()) & 0xFFFFFFFF != meta["adler32"]:
            raise IOError(f"checksum mismatch in leaf {i} ({meta['file']})")
        dtype = getattr(torch, meta["dtype"])
        arr = torch.from_numpy(raw.copy()).view(dtype).reshape(meta["shape"]) \
            if raw.size else torch.zeros(meta["shape"], dtype=dtype)
        if specs[i] is not None:
            arr = block_of(arr, specs[i]).contiguous()
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch leaf {i}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        out.append(arr.to(device=leaf.device, dtype=leaf.dtype))
    return T.unflatten_like(like, out)


@dataclasses.dataclass
class AsyncWriter:
    """Fire-and-forget checkpoint writer: copies the tree to the host at
    once, serialises it on a worker thread. ``wait`` joins the thread and
    raises what it raised."""
    root: str
    config: Any = None
    _thread: threading.Thread | None = None
    error: BaseException | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None,
             shardings: Any = None):
        """On a mesh every rank calls it with its blocks and their
        ``shardings``: each leaf is gathered whole at once, the origin
        keeping a host copy, which it writes on its thread."""
        self.wait()
        if shardings is not None and current_mesh() is not None:
            host_tree = _host_whole(tree, shardings)
            if host_tree is None:
                return
        else:
            host_tree = T.tree_map(
                lambda t: t.detach().to("cpu", copy=True), tree)  # snapshot

        def work():
            try:
                save(self.root, step, host_tree, config=self.config,
                     extra=extra)
            except BaseException as e:                  # noqa: BLE001
                self.error = e          # raised by wait(), on the caller

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
