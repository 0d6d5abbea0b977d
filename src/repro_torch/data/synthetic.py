"""Deterministic synthetic data (counterpart of ``repro/data/synthetic.py``):
the ANNS corpora and traffic, and the LM token batches.

``clustered_vectors``, ``query_set``, ``zipf_query_set`` and
``drifting_hotspot_stream`` are numpy and draw the same bits as the JAX
package's generators from the same seed, so both packages index the same
corpus and serve the same traffic. ``ground_truth`` takes numpy arrays (the numpy path) or torch
tensors (the torch path, which runs wherever the tensors lie — on the card
for a corpus too large for the host's patience).

``token_batch`` draws the JAX package's tokens bit for bit (Zipf unigrams
by inverse CDF, a = 1.2, clipped to the vocabulary; with probability 0.2
the token 8 back) from ``data/prng.py``'s numpy copy of ``jax.random``'s
threefry, in the ``jax_threefry_partitionable=True`` layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import prng

__all__ = ["TokenDataConfig", "token_batch", "clustered_vectors", "query_set", "zipf_query_set",
           "drifting_hotspot_stream", "ground_truth"]


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def token_batch(cfg: TokenDataConfig, step: int) -> dict:
    """One global batch, {'tokens': (B, S) int32, 'labels': (B, S) int32}
    on the CPU (labels are the tokens shifted by one), fully determined by
    (cfg.seed, step): any host regenerates any step's batch, and the JAX
    package's ``token_batch`` gives the same bits.

    The rank u^(-1/(a-1)) is computed in float64 from the float32 u and
    the float32 exponent, and rounded to float32 once: XLA's float32 pow
    gives those bits here, where numpy's float32 pow differs in the last
    bit of about a fifth of the values (and then in a few tokens). It is
    clipped at the vocabulary before the cast, since a draw near 1e-6
    gives ~1e30, which XLA's cast saturates and numpy's leaves
    undefined."""
    key = prng.fold_in(prng.PRNGKey(cfg.seed), step)
    k1, k2 = prng.split(key)
    shape = (cfg.global_batch, cfg.seq_len + 1)
    u = prng.uniform(k1, shape, minval=1e-6, maxval=1.0)
    expo = np.float32(-1.0 / (cfg.zipf_a - 1.0))
    r = (u.astype(np.float64) ** np.float64(expo)).astype(np.float32)
    r = np.minimum(r, np.float32(cfg.vocab_size))
    rank = np.clip(r.astype(np.int32) - 1, 0, cfg.vocab_size - 1)
    # copy motifs: with p = 0.2 repeat the token 8 positions back
    rep = prng.uniform(k2, shape) < np.float32(0.2)
    seq = np.where(rep, np.roll(rank, 8, axis=1), rank).astype(np.int32)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(seq[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(seq[:, 1:]))}


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


def _cluster_members(assignment: np.ndarray, c: int) -> list:
    """The ascending row ids of each cluster 0..c-1: one stable argsort of
    the assignment, the same lists as one ``flatnonzero(assignment == cid)``
    a cluster in O(N log N) instead of O(C N)."""
    assignment = np.asarray(assignment)
    order = np.argsort(assignment, kind="stable")
    bounds = np.searchsorted(assignment[order], np.arange(c + 1),
                             side="left")
    return [order[bounds[cid]:bounds[cid + 1]] for cid in range(c)]


def zipf_query_set(seed: int, x: np.ndarray, assignment: np.ndarray,
                   n_queries: int, *, s: float = 1.0,
                   hot_order: np.ndarray | None = None,
                   n_clusters: int | None = None, noise: float = 0.05
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Zipf-skewed query workload over an ANN corpus.

    Draws each query's TARGET CLUSTER from a Zipf(``s``) law over cluster
    popularity ranks, then perturbs a random member of that cluster.
    ``assignment`` maps each corpus row to its cluster; ``hot_order[r]`` is
    the cluster holding popularity rank r (default: cluster id == rank).

    Returns (queries (Q, D) f32, target (Q,) int32 cluster of each draw);
    the draws are the JAX package's bit for bit."""
    if s <= 0:
        raise ValueError(f"zipf exponent s must be > 0, got {s}")
    c = int(n_clusters) if n_clusters is not None \
        else int(np.asarray(assignment).max()) + 1
    if hot_order is None:
        hot_order = np.arange(c)
    hot_order = np.asarray(hot_order)
    if len(hot_order) != c or len(np.unique(hot_order)) != c:
        raise ValueError(f"hot_order must be a permutation of the {c} "
                         f"cluster ids")
    rng = np.random.default_rng(seed + 1)
    p = 1.0 / np.power(np.arange(1, c + 1, dtype=np.float64), s)
    p /= p.sum()
    target = hot_order[rng.choice(c, n_queries, p=p)].astype(np.int32)
    # a member row of each target cluster (any row for an empty cluster)
    members = _cluster_members(assignment, c)
    rows = np.array([members[cid][rng.integers(len(members[cid]))]
                     if len(members[cid]) else rng.integers(len(x))
                     for cid in target])
    q = x[rows] + rng.normal(0, noise, (n_queries, x.shape[1]))
    return q.astype(np.float32), target


def drifting_hotspot_stream(seed: int, x: np.ndarray,
                            assignment: np.ndarray, n_queries: int,
                            n_rounds: int, *, s: float = 1.0,
                            hot_order: np.ndarray | None = None,
                            n_clusters: int | None = None,
                            shift_frac: float = 0.25,
                            noise: float = 0.05) -> list:
    """``n_rounds`` Zipf query sets whose hotspot DRIFTS: each round rotates
    ``hot_order`` by ``shift_frac`` of the cluster count. Returns a list of
    (queries, target) tuples, one per round."""
    if not 1 <= n_rounds:
        raise ValueError(f"need n_rounds >= 1, got {n_rounds}")
    c = int(n_clusters) if n_clusters is not None \
        else int(np.asarray(assignment).max()) + 1
    order = np.arange(c) if hot_order is None else np.asarray(hot_order)
    shift = max(1, int(round(shift_frac * c)))
    return [zipf_query_set(seed + 1000 * r, x, assignment, n_queries, s=s,
                           hot_order=np.roll(order, -shift * r),
                           n_clusters=c, noise=noise)
            for r in range(n_rounds)]


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
