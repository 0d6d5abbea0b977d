"""Execution backends of the serving topology (counterpart of
``repro/core/execbackend.py``).

How a tier runs is a seam: ``EngineWorker`` / ``ShardWorker`` dispatch
through an ``ExecutionBackend`` instead of calling the engine directly.
``InProcBackend``, the default, runs each flush on the engine in this
process, on the device that holds the engine's tensors. The JAX package's
``MeshBackend`` (one device per shard, the scatter and gather as
collectives) is not ported yet.
"""

from __future__ import annotations

from typing import Protocol

__all__ = ["ExecutionBackend", "InProcBackend", "INPROC", "EXEC_BACKENDS",
           "resolve_exec_backend"]


class ExecutionBackend(Protocol):
    """Where and how a worker's flush executes. ``search`` and
    ``search_probed`` mirror the engine's entry points; ``name`` is the
    registry key reported in ``TopologyReport``."""

    name: str

    def search(self, engine, queries, *, pad_to): ...

    def search_probed(self, engine, queries, probe, *, pad_to): ...


class InProcBackend:
    """Run flushes on the engine in this process."""

    name = "inproc"

    def search(self, engine, queries, *, pad_to):
        return engine.search(queries, pad_to=pad_to)

    def search_probed(self, engine, queries, probe, *, pad_to):
        return engine.search_probed(queries, probe, pad_to=pad_to)


INPROC = InProcBackend()

EXEC_BACKENDS = {"inproc": lambda: INPROC}


def resolve_exec_backend(spec) -> ExecutionBackend:
    """Registry key or instance -> backend instance."""
    if isinstance(spec, str):
        if spec == "mesh":
            raise NotImplementedError(
                "exec='mesh' (one device per shard, NCCL all_gather) is not "
                "ported yet: ROADMAP A4 (the mesh execution backend)")
        try:
            return EXEC_BACKENDS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown execution backend {spec!r}; registered: "
                f"{sorted(EXEC_BACKENDS)}") from None
    if hasattr(spec, "name") and hasattr(spec, "search_probed"):
        return spec
    raise ValueError(f"exec must be a registry key or ExecutionBackend, "
                     f"got {spec!r}")
