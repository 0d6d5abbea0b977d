"""Query-path arithmetic whose result for a row is the same bits whatever
batch the row comes in.

A library reduction or product picks its kernel, and with it the order of
its sums, from the shapes it is given: on the card a row's norm, its
rotation product and its rerank distances differ in their last bits
between a batch of 256 queries and one of 4,096 (``scripts/
batch_invariance.py``). The sharded tier searches each query in a flush of
another size than a single engine's batch, and its parity with that
engine (equal ids in every slot) needs the same bits, so the query path
sums through these functions:

  * ``fixed_order_sum``: the last axis summed by adding halves
    elementwise, one fixed pairwise tree;
  * ``row_norm``: the square root of that sum of squares;
  * ``blocked_matmul``: rows times a matrix in blocks of exactly
    ``ROW_BLOCK`` rows (the last zero-padded), so every block is one
    product of one shape.
"""

from __future__ import annotations

import torch

__all__ = ["ROW_BLOCK", "fixed_order_sum", "row_norm", "blocked_matmul"]

ROW_BLOCK = 4096


def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order (halves added
    elementwise, zero-padded to a power of two)."""
    d = x.shape[-1]
    width = 1 << (d - 1).bit_length()
    if width != d:
        x = torch.nn.functional.pad(x, (0, width - d))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm of each row of x (..., D), summed in one fixed
    order."""
    return torch.sqrt(fixed_order_sum(x * x))


def blocked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), the rows taken ROW_BLOCK at a time."""
    lead, k = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, k)
    n = flat.shape[0]
    if n == 0:
        return x.new_zeros((*lead, w.shape[-1]))
    pad = (-n) % ROW_BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    out = torch.cat([flat[s:s + ROW_BLOCK] @ w
                     for s in range(0, flat.shape[0], ROW_BLOCK)])
    return out[:n].reshape(*lead, w.shape[-1])
