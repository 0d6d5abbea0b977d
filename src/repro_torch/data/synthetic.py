"""Deterministic synthetic ANNS data (counterpart of
``repro/data/synthetic.py``).

``clustered_vectors`` and ``query_set`` are numpy and draw the same bits as
the JAX package's generators from the same seed, so both packages index the
same corpus. ``ground_truth`` takes numpy arrays (the numpy path) or torch
tensors (the torch path, which runs wherever the tensors lie — on the card
for a corpus too large for the host's patience).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["clustered_vectors", "query_set", "ground_truth"]


def clustered_vectors(seed: int, n: int, d: int, n_clusters: int,
                      spread: float = 1.0, scale: float = 3.0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(x (N, D) f32, centers (K, D)) clustered-Gaussian dataset."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (n_clusters, d)).astype(np.float32) * scale
    sizes = np.full(n_clusters, n // n_clusters)
    sizes[: n - sizes.sum()] += 1
    x = np.empty((n, d), np.float32)
    row = 0
    for i in range(n_clusters):
        x[row:row + sizes[i]] = centers[i] + rng.normal(
            0, spread, (sizes[i], d)).astype(np.float32)
        row += sizes[i]
    rng.shuffle(x)
    return x, centers


def query_set(seed: int, x: np.ndarray, q: int, noise: float = 0.05
              ) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    base = x[rng.choice(len(x), q)]
    return (base + rng.normal(0, noise, base.shape)).astype(np.float32)


def ground_truth(x, queries, k: int, chunk: int = 512):
    """Exact top-k ids by brute force.

    numpy inputs: chunked over queries, (Q, k) int64 numpy. torch inputs:
    chunked over the corpus with a running stable merge, (Q, k) int64 on
    the inputs' device; ties go to the lower id."""
    if isinstance(x, torch.Tensor):
        return _ground_truth_torch(x, queries, k)
    out = np.empty((len(queries), k), np.int64)
    x2 = (x * x).sum(-1)
    for s in range(0, len(queries), chunk):
        qc = queries[s:s + chunk]
        d2 = x2[None, :] - 2.0 * qc @ x.T
        out[s:s + chunk] = np.argsort(d2, axis=1)[:, :k]
    return out


def _ground_truth_torch(x: torch.Tensor, queries: torch.Tensor, k: int,
                        chunk: int = 1 << 18) -> torch.Tensor:
    q = queries.to(x.device, torch.float32)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=x.device)
    best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk]
        d2 = (xc * xc).sum(-1)[None, :] - 2.0 * (q @ xc.T)
        d_top, i_top = torch.sort(d2, dim=1, stable=True)
        # earlier chunks hold lower ids, so a stable sort of [best, chunk]
        # keeps ties in id order
        cat_d = torch.cat([best_d, d_top[:, :k]], dim=1)
        cat_i = torch.cat([best_i, i_top[:, :k] + s], dim=1)
        d_sorted, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d = d_sorted[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    return best_i
