"""Wrapper of the CUDA ``topk_select`` kernel (``csrc/topk_select.cu``).

Counterpart of the Pallas kernel in ``repro/kernels/topk_select.py``. The
wrapper takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version in ``kernels/ref.py``.

Two routes of one launch, chosen from the row width C and k alone
(``route_for``): the warp route (one warp a row: a keep-first table in
shared memory, a register top-k) takes C <= WARP_MAX_C and k <= WARP_MAX_K,
the block route (two bitonic sorts of the row in shared memory) the rest up
to MAX_C columns. Neither gives way to the other or to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["topk_select", "chunked_select", "check_chunkable", "route_for",
           "smem_bytes", "MAX_C", "WARP_MAX_C", "WARP_MAX_K", "ROUTES",
           "launches"]

MAX_C = 4096        # the block route's row limit (kMaxC in the source)
WARP_MAX_C = 1024   # the warp route's: 32 lanes x 32 slots (kSelectWarpMaxC)
WARP_MAX_K = 32     # one output slot a lane (kSelectWarpMaxK, common.cuh)
ROUTES = ("warp", "block")   # their numbers in the C launch function
launches = 0   # kernel launches since the count was last set to 0


def route_for(c: int, k: int) -> str:
    """The route a row of c columns and k outputs takes: "warp" up to
    WARP_MAX_C columns and WARP_MAX_K outputs, else "block". Shared with
    ``merge_topk``, whose warp route has the same limits."""
    return "warp" if c <= WARP_MAX_C and k <= WARP_MAX_K else "block"


def _lib():
    return _build.library("topk_select")


def _fn():
    fn = _lib().topk_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(c: int, route: str) -> int:
    """Dynamic shared memory of one block of ``route`` at row width c."""
    fn = _lib().topk_select_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(c, ROUTES.index(route))


def chunked_select(select, cand_ids: torch.Tensor, dists: torch.Tensor, *,
                   k: int, max_c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep-first dedup + top-k of rows wider than ``max_c`` columns, by
    passes of ``select(ids, dists, k=...)``, a function that takes rows of
    at most ``max_c`` columns and computes ``ref.topk_select_ref``.

    The row is cut into chunks of at most ``max_c`` columns; each chunk
    gives its own min(k, width) best distinct ids, and ``select`` runs once
    more on the chunk outputs concatenated in chunk order (again in chunks
    while they are wider than ``max_c``). The result equals one call of
    ``topk_select_ref`` on the whole row when

    1. every occurrence of an id carries the same distance (the rerank's
       distance is a function of the query and the id), and
    2. no distance is NaN or -inf (a chunk writes id -1 beside a
       non-finite distance, which the next pass masks to +inf).

    Why: take an id x among the row's top k, and the chunk c0 that holds
    its first occurrence. Every id that ranks before x in c0, by (distance,
    first column in c0), ranks before x in the whole row too: by (1) it has
    its distance there, and its first column is no later than its column
    in c0. So fewer than k do, and x is among c0's k outputs. No earlier
    chunk holds x, so that output is x's first occurrence in the
    concatenation. An id that a chunk outputs but the whole row does not
    keep ranks after all k kept ones there, and the concatenation keeps
    every tie in the order of the original columns (chunk order, and
    (distance, column) order inside a chunk), so it ranks after them in the
    last pass too. Where (1) fails, a later duplicate with a smaller
    distance than its first occurrence can surface in place of it.

    Needs k <= max_c // 2 when the row is wider than ``max_c``, so that each
    pass at least halves the width; a larger k raises NotImplementedError
    (ROADMAP C3)."""
    c = cand_ids.shape[1]
    if c <= max_c:
        return select(cand_ids, dists, k=k)
    if not 0 < k <= max_c // 2:
        raise NotImplementedError(
            f"topk_select of k = {k} over {c} > {max_c} columns: the "
            f"chunked passes take k <= {max_c // 2} (ROADMAP C3)")
    outs = [select(cand_ids[:, a:a + max_c].contiguous(),
                   dists[:, a:a + max_c].contiguous(),
                   k=min(k, c - a))
            for a in range(0, c, max_c)]
    return chunked_select(select, torch.cat([o[0] for o in outs], 1),
                          torch.cat([o[1] for o in outs], 1), k=k,
                          max_c=max_c)


def check_chunkable(cand_ids: torch.Tensor, dists: torch.Tensor) -> None:
    """Raise ValueError where a row breaks ``chunked_select``'s two
    conditions: an id (>= 0) that carries two distances, or a NaN or -inf
    distance beside an id. One stable sort of each row by id."""
    ids, order = torch.sort(cand_ids, dim=1, stable=True)
    d = torch.gather(dists, 1, order)
    two = (ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0) \
        & (d[:, 1:] != d[:, :-1])
    odd = (cand_ids >= 0) & (torch.isnan(dists) | (dists == float("-inf")))
    if bool(two.any()) or bool(odd.any()):
        raise ValueError(
            f"topk_select over {cand_ids.shape[1]} > {MAX_C} columns runs in "
            f"chunked passes, which are exact only when every occurrence of "
            f"an id carries one distance and no id's distance is NaN or "
            f"-inf; these rows break that")


def topk_select(cand_ids: torch.Tensor, dists: torch.Tensor, *, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids (Q, k) int32, dists (Q, k) f32); semantics of
    ``ref.topk_select_ref``. Rows wider than MAX_C columns go through
    ``chunked_select``, exact under its two conditions, which
    ``check_chunkable`` holds them to (ValueError where they fail)."""
    dev = cand_ids.device
    if dev.type != "cuda":
        raise ValueError(f"topk_select kernel needs CUDA tensors, got {dev}")
    if cand_ids.dim() != 2 or cand_ids.dtype != torch.int32 \
            or not cand_ids.is_contiguous():
        raise ValueError("topk_select: cand_ids must be a contiguous (Q, C) "
                         f"int32 tensor, got {cand_ids.dtype} "
                         f"{tuple(cand_ids.shape)}")
    if dists.shape != cand_ids.shape or dists.dtype != torch.float32 \
            or dists.device != dev or not dists.is_contiguous():
        raise ValueError("topk_select: dists must be a contiguous float32 "
                         "tensor shaped and placed like cand_ids, got "
                         f"{dists.dtype} {tuple(dists.shape)} on "
                         f"{dists.device}")
    c = cand_ids.shape[1]
    if not 0 < k <= c:
        raise ValueError(f"k = {k} outside (0, {c}]")
    if c > MAX_C:
        check_chunkable(cand_ids, dists)
    return chunked_select(_launch, cand_ids, dists, k=k, max_c=MAX_C)


def _launch(cand_ids: torch.Tensor, dists: torch.Tensor, *, k: int,
            route: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch over rows of at most MAX_C columns, by ``route``
    (``route_for(C, k)`` when None; tests name one to hold both routes on
    the same rows)."""
    global launches
    dev = cand_ids.device
    q, c = cand_ids.shape
    route = route_for(c, k) if route is None else route
    if route not in ROUTES or (route == "warp" and route_for(c, k) != "warp"):
        raise ValueError(f"topk_select: route {route!r} cannot take C = {c},"
                         f" k = {k}")
    out_ids = torch.empty((q, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    if q == 0:
        return out_ids, out_d
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(cand_ids.data_ptr(), dists.data_ptr(), out_ids.data_ptr(),
                    out_d.data_ptr(), q, c, k, ROUTES.index(route), stream)
    if err != 0:
        raise RuntimeError(f"topk_select launch ({route} route) failed: CUDA "
                           f"error {err}")
    launches += 1
    return out_ids, out_d
