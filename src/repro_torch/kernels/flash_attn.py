"""Wrapper of the CUDA flash-attention forward kernel (``csrc/flash_attn.cu``).

Counterpart of the Pallas kernel ``flash_attention_fwd`` in
``repro/kernels/flash_attn.py`` and of the blockwise scan of
``repro/models/attention.py`` that the port's ``attend`` replaces. The
wrapper takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain version ``ref.flash_attention_ref``. ``check_args`` is shared by both
routes, so a call either route refuses is refused on both.

One launch, two kernels, chosen by q's type inside ``flash_attn_launch``:

* bf16 q (every prefill of the serving path): the tensor-core kernel
  (``wgmma``), bf16 operands and float32 sums. Its plain twin is
  ``ref.flash_attention_ref(..., operands=torch.bfloat16)``, which rounds q,
  K, V and P where the kernel does; the twin stays within
  ``ref.flash_attention_rounding_bound`` of the float32 plain version.
* float32 q: the CUDA-core kernel, float32 throughout; its plain version is
  ``ref.flash_attention_ref`` with the default operands.
* float32 q whose rows that read one KV head fit one tile, Sq x (Hq / Hkv)
  <= ``DECODE_ROWS`` (the decode step over a sequence-split cache): the
  split-KV decode kernel of ``csrc/flash_decode.cu``: a launch of one warp
  per (batch row, KV head, KV chunk), each staging its chunk's K/V tiles by
  cp.async into a two-stage ring of its own, and a second that combines
  each row's chunks in chunk order (``decode_design`` gives the split; the wrapper
  allocates its float32 workspace); float32 throughout, the same plain
  version. The route is a rule on shapes alone (``decode_route``); a call
  counts as one launch.

Head dims (``instantiation``): dk and dv up to 256 run in the instantiation
of the smallest of ``HEAD_DIMS`` that holds both, the extra columns staged
as zeros inside the kernel (the smoke configs' 8, 12 and 16, the deepseek
smoke's MLA pair (40, 32), and any head in (160, 256) at 256); (dk, dv) =
``MLA_DIMS`` = (576, 512), the absorbed MLA attention of deepseek-v2-lite
(q_all against the latent cache, V the cache's first 512 columns), has an
instantiation of its own on the tensor-core route, the split-dv kernel (64
query rows a block, dv split over two warpgroups), which stages a tile once
when v is a view of k's rows; the float32 route refuses it. On the
tensor-core route, 256 (recurrentgemma-9b's local attention, 16 query heads
over one KV head) runs in the wide kernel (128 query rows a block). Both
bring bf16 K/V with aligned rows by TMA, in cluster pairs of neighbouring
blocks that share each tile (``BLOCK_ROWS``; ``cost.flash_staged_bytes``
reckons what a launch stages).

With ``return_lse`` every route also writes each row's logsumexp of its
scaled, masked scores, float32 (B, Hq, Sq), from the running max and
denominator it already holds (the training path's residual for the
backward, ``ref.flash_attention_bwd_ref``); without it the kernels write
nothing more.

``softcap`` > 0 caps each scaled score at softcap tanh(s / softcap) before
the mask (the JAX package's attention softcap; 0 is off) on every route:
the CUDA-core kernel on its scaled score, the tensor-core kernels in their
log2 units (``ref._flash_scan``'s twin rounds where they do).

Neither route falls back on the other: a launch that fails raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "check_args",
           "instantiation", "split_design", "decode_route", "decode_design",
           "decode_chunks", "HEAD_DIMS", "MLA_DIMS", "BLOCK_ROWS",
           "DECODE_ROWS", "DECODE_TILE", "DECODE_WARPS", "launches"]

HEAD_DIMS = (64, 80, 96, 128, 160, 256)  # instantiations, dk == dv
MLA_DIMS = (576, 512)               # the latent-attention kernel's (dk, dv)
# query rows a block of the bf16-q split-dv kernel (MLA_DIMS) and wide
# kernel (256), for the reckoning of what a launch stages
BLOCK_ROWS = {MLA_DIMS: 64, (256, 256): 128}
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 64          # query rows a block of the decode kernel at most
DECODE_TILE = 32          # keys a K/V tile of the decode kernel
DECODE_WARPS = 8 * 132    # the chunks a split aims at: 8 warps an H100 SM
launches = 0   # kernel launches since the count was last set to 0


def _fn():
    fn = _build.library("flash_attn").flash_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _decode_fn():
    fn = _build.library("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def instantiation(dk: int, dv: int) -> tuple[int, int] | None:
    """The (dk, dv) instantiation a call of head dims dk and dv runs in, or
    None where the kernel takes no such call."""
    if (dk, dv) == MLA_DIMS:
        return MLA_DIMS
    d = next((h for h in HEAD_DIMS if h >= max(dk, dv)), None)
    return None if d is None else (d, d)


def split_design(q, k, v) -> tuple[int, int]:
    """(query rows a block, blocks that stage each K/V tile once between
    them) of the bf16-q split-dv or wide kernel on these inputs: bf16 K/V
    whose rows are 16-byte aligned and as wide as the instantiation come by
    TMA, multicast to a cluster pair of neighbouring blocks (2); any other
    K/V is staged by each block (1). ``flash_attn_launch``'s rule."""
    inst = instantiation(q.shape[-1], v.shape[-1])
    if inst not in BLOCK_ROWS:
        raise ValueError(f"head dims {q.shape[-1]}, {v.shape[-1]} do not "
                         f"run in the split-dv or the wide kernel")
    exact = inst == (k.shape[-1], v.shape[-1])
    aligned = all(t.data_ptr() % 16 == 0 and all(
        x > 0 and 2 * x % 16 == 0 for x in t.stride()[:3]) for t in (k, v))
    pair = k.dtype == torch.bfloat16 and exact and aligned
    return BLOCK_ROWS[inst], 2 if pair else 1


def decode_route(dtype: torch.dtype, sq: int, hq: int, hkv: int) -> bool:
    """Whether a call takes the split-KV decode kernel: float32 q whose
    query rows that read one KV head, Sq x (Hq / Hkv), fit one block."""
    return dtype == torch.float32 and sq * (hq // hkv) <= DECODE_ROWS


def _decode_split(b: int, sq: int, hq: int, hkv: int, sk: int, *,
                  causal: bool, window: int | None = None, q_offset: int = 0,
                  kv_valid_len: int | None = None
                  ) -> tuple[int, int, int, int, int]:
    """(rows, t0, t1, tiles a chunk, chunks): the keys some row sees,
    [kv_begin, kv_end) as ``flash_fwd_kernel`` bounds them, in tiles
    [t0, t1) of ``DECODE_TILE`` keys, cut into chunks of whole tiles (one
    warp each), as many as give ``DECODE_WARPS`` warps over the B x Hkv
    (batch row, KV head) items and no more than there are tiles; none is
    empty."""
    valid = sk if kv_valid_len is None else int(kv_valid_len)
    end = min(sk, valid)
    if causal:
        end = min(end, q_offset + sq)
    begin = max(0, q_offset - window + 1) if window else 0
    t0, t1 = begin // DECODE_TILE, -(-end // DECODE_TILE)
    tiles = t1 - t0
    want = min(tiles, -(-DECODE_WARPS // max(b * hkv, 1)))
    tpc = -(-tiles // want)
    return sq * (hq // hkv), t0, t1, tpc, -(-tiles // tpc)


def decode_design(b: int, sq: int, hq: int, hkv: int, sk: int, *,
                  causal: bool, window: int | None = None, q_offset: int = 0,
                  kv_valid_len: int | None = None) -> tuple[int, int]:
    """(query rows a block, KV chunks) of the decode kernel on a call of
    these shapes and mask; the wrapper hands the split to
    ``flash_decode_launch``. One warp per (batch row, KV head, chunk), up to
    four chunks of one (batch row, KV head) a block."""
    rows, _, _, _, chunks = _decode_split(
        b, sq, hq, hkv, sk, causal=causal, window=window, q_offset=q_offset,
        kv_valid_len=kv_valid_len)
    return rows, chunks


def decode_chunks(b: int, sq: int, hq: int, hkv: int, sk: int, *,
                  causal: bool, window: int | None = None, q_offset: int = 0,
                  kv_valid_len: int | None = None) -> list[tuple[int, int]]:
    """The keys [begin, end) each chunk of ``decode_design`` stages, in
    chunk order: whole tiles, the last one cut at min(Sk, kv_valid_len)."""
    _, t0, t1, tpc, chunks = _decode_split(
        b, sq, hq, hkv, sk, causal=causal, window=window, q_offset=q_offset,
        kv_valid_len=kv_valid_len)
    limit = min(sk, sk if kv_valid_len is None else int(kv_valid_len))
    return [((t0 + c * tpc) * DECODE_TILE,
             min(min(t0 + (c + 1) * tpc, t1) * DECODE_TILE, limit))
            for c in range(chunks)]


def check_args(q, k, v, *, causal: bool, window: int | None, q_offset: int,
               kv_valid_len: int | None, softcap: float = 0.0) -> int:
    """Validate the shapes and the mask; returns kv_valid_len (Sk if None).

    Every query row must keep at least one valid key: for such a row the
    kernel, which skips wholly masked tiles, gives the reference's result,
    and every row of the serving path has its own diagonal key."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention takes q (B, Sq, Hq, dk), k (B, Sk, Hkv, "
                         f"dk), v (B, Sk, Hkv, dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dk = q.shape
    if k.shape[0] != b or k.shape[-1] != dk or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    sk, hkv = k.shape[1], k.shape[2]
    if sk < 1 or hkv < 1 or hq % hkv:
        raise ValueError(f"need Sk >= 1 and Hq % Hkv == 0, got Sk {sk}, "
                         f"Hq {hq}, Hkv {hkv}")
    valid = sk if kv_valid_len is None else int(kv_valid_len)
    if not 1 <= valid <= sk:
        raise ValueError(f"kv_valid_len {valid} outside [1, Sk = {sk}]: a "
                         f"row with no valid key has no attention output")
    if int(q_offset) < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1 leaves no key")
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"softcap {softcap}: 0 (off) or a finite cap > 0")
    if causal and q_offset + sq > valid:
        raise ValueError(f"causal rows up to position {q_offset + sq - 1} "
                         f"need their own key, but only {valid} are valid")
    if not causal and window is not None and q_offset + sq - window >= valid:
        raise ValueError(f"window {window} leaves the query at position "
                         f"{q_offset + sq - 1} no valid key of {valid}")
    return valid


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None = None,
                    q_offset: int = 0, kv_valid_len: int | None = None,
                    return_lse: bool = False, softcap: float = 0.0):
    """(B, Sq, Hq, dv) in q.dtype; semantics of ``ref.flash_attention_ref``.
    With ``return_lse``, (out, lse): lse (B, Hq, Sq) float32, each row's
    logsumexp of its scaled, masked scores.

    q bf16 or f32, k and v of one type (bf16 or f32), each read in its own
    type: nothing is cast. Head dims as ``instantiation`` takes them
    ((576, 512) with bf16 q only); the last dim of each input contiguous
    (any other strides are passed on; v may be a view of k's rows)."""
    global launches
    valid = check_args(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, kv_valid_len=kv_valid_len,
                       softcap=softcap)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise ValueError("flash_attention kernel takes q in bf16 / float32 "
                         f"and k, v in one of them, got {q.dtype}, {k.dtype},"
                         f" {v.dtype}")
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    inst = instantiation(dk, dv)
    if inst is None:
        raise ValueError(f"flash_attention kernel takes head dims dk, dv up "
                         f"to {HEAD_DIMS[-1]} (run in the smallest of "
                         f"{HEAD_DIMS} that holds both) or (dk, dv) = "
                         f"{MLA_DIMS}, got dk {dk}, dv {dv}")
    if inst == MLA_DIMS and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention's float32 route does not take "
                         f"(dk, dv) = {MLA_DIMS}: its float32 tiles would "
                         f"need ~443 KB of shared memory a block; q in bf16 "
                         f"takes the tensor-core route")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention kernel needs the head dim of q, k "
                         "and v contiguous")
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if b == 0 or sq == 0 or hq == 0:
        return (out, lse) if return_lse else out
    if decode_route(q.dtype, sq, hq, hkv):
        return _decode(q, k, v, out, lse, valid, causal=causal,
                       window=window, q_offset=q_offset, softcap=softcap)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    _TYPES[q.dtype], _TYPES[k.dtype], b, sq, sk, hq, hkv,
                    dk, dv,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    int(causal), 0 if window is None else int(window),
                    int(q_offset), valid, math.sqrt(dk), float(softcap),
                    stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out


def _decode(q, k, v, out, lse, valid, *, causal, window, q_offset, softcap):
    """The decode route of ``flash_attention``: its split, its workspace
    (float32: each chunk's acc rows at the instantiation's width, then its
    (m, l) pairs) and the two launches."""
    global launches
    b, sq, hq, dk = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rows, t0, t1, tpc, chunks = _decode_split(
        b, sq, hq, hkv, sk, causal=causal, window=window, q_offset=q_offset,
        kv_valid_len=valid)
    width = instantiation(dk, dv)[0]
    ws = torch.empty(b * hkv * chunks * rows * (width + 2),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _decode_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), ws.data_ptr(),
            _TYPES[k.dtype], b, sq, sk, hq, hkv, dk, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            0 if window is None else int(window), int(q_offset), valid,
            math.sqrt(dk), float(softcap), t0, t1, tpc, chunks, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention decode launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return (out, lse) if lse is not None else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0
                        ) -> torch.Tensor:
    """The TPU kernel's signature: q (BH, Sq, dk), k/v (BH, Sk, dk/dv) with
    heads folded into BH; returns (BH, Sq, dv) in q.dtype. A view onto the
    same launch (B = BH, one head), dispatched by device like every kernel."""
    from . import ops
    return ops.flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, q_offset=q_offset)[:, :, 0]
