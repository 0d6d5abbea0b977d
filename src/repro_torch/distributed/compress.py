"""Gradient compression for the data-parallel all-reduce: int8 + error
feedback (counterpart of ``repro/distributed/compress.py``), over a
``torch.distributed`` process group.

The scheme ("compress the gather half"):
  1. reduce-scatter the gradient over the group at full precision;
  2. quantize the reduced shard to int8 (one absmax scale a shard);
  3. all-gather the int8 shards and the scales;
  4. dequantize; the quantization residual feeds the NEXT step's gradient
     (error feedback, ``apply_feedback``).

Against a plain float32 all-reduce this moves a quarter of the gather
half's bytes. ``distributed/trainer.py``'s DP step calls it for each
gradient leaf.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import tree as T

__all__ = ["quantize_int8", "dequantize_int8", "psum_mean",
           "compressed_psum_mean", "init_feedback", "apply_feedback"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 0-d): per-tensor absmax scaling, rounded to
    nearest even, clipped to [-127, 127]."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def psum_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The plain float32 mean of ``g`` over the ranks of ``group``."""
    total = g.float().clone()
    dist.all_reduce(total, group=group)
    return total / dist.get_world_size(group)


def compressed_psum_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``g`` over the ranks of ``group`` (the default group
    when None), its gather half int8-compressed; in g's type.

    Every rank calls it with a tensor of the same shape. One whose flat
    size does not tile the group, or is smaller than 8 a rank (biases,
    norms), takes the plain float32 mean instead."""
    n = dist.get_world_size(group)
    flat = g.reshape(-1).float()
    if flat.numel() % n != 0 or flat.numel() < n * 8:
        return psum_mean(g, group)
    # 1. reduce-scatter at full precision. NCCL does it in one collective;
    # gloo (whose reduce-scatter some torch builds lack) sums the whole
    # tensor and keeps this rank's slice: the same sums, more bytes
    rank = dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        shard = torch.empty(flat.numel() // n, device=flat.device)
        dist.reduce_scatter_tensor(shard, flat, group=group)
    else:
        total = flat.clone()
        dist.all_reduce(total, group=group)
        shard = total.view(n, -1)[rank]
    shard = shard / n
    # 2-3. int8 quantize + all-gather of the shards and their scales
    q, scale = quantize_int8(shard)
    qs = [torch.empty_like(q) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    scales = [torch.empty(1, device=q.device) for _ in range(n)]
    dist.all_gather(scales, scale.reshape(1), group=group)
    # 4. dequantize each source shard
    per = torch.stack(qs).float() * torch.cat(scales)[:, None]
    return per.reshape(g.shape).to(g.dtype)


def init_feedback(params):
    """Zero float32 residuals of the params' shapes."""
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def apply_feedback(grads, feedback):
    """g' = g + e (the residual carried from the previous compression)."""
    return T.tree_map(lambda g, e: g.float() + e, grads, feedback)
