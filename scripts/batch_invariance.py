"""Does a query's rerank distance depend on the batch it is reranked in?

    PYTHONPATH=src python scripts/batch_invariance.py            # the card
    PYTHONPATH=src python scripts/batch_invariance.py --device cpu

Reranks 4,096 queries of 320 candidates each (the main path's C = nprobe x
ef) over 1M vectors of dim 128, once whole and once in batches of 1, 256
and 1,024 queries (the tier's flush buckets), and counts the rows whose
distances differ in any bit from the whole batch's, for two forms: the
library form q2 + c2 - 2 q.c (``sum`` reductions and an ``einsum``, whose
summation order the library picks from the shapes, the JAX package's
form) and the port's ``rerank.exact_sqdist`` (the sum of (q - c)^2 in one
fixed order). The sharded tier's parity with a single engine needs the
second count to be 0. On the card it also times both forms at a search's
shape (1,024 queries) with CUDA events. Then the lane LUTs: the rows of
leading blocks of 65,536 lanes whose LUT, LUT sum or norm differ from the
whole batch's, through a library norm and product and through the port's
``rabitq.prepare_query``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import rabitq, rerank


def library_sqdist(q, cand_ids, vectors):
    cand = vectors[cand_ids.clamp(0, vectors.shape[0] - 1).long()]
    return (q * q).sum(-1, keepdim=True) + (cand * cand).sum(-1) \
        - 2.0 * torch.einsum("qd,qcd->qc", q, cand)


def library_lut(q, centroid, rotation):
    """The lane LUT's arithmetic through a library norm and product."""
    resid = q - centroid
    norm = torch.linalg.vector_norm(resid, dim=-1)
    g = (resid / norm.clamp(min=1e-12)[..., None]) @ rotation
    return g, g.sum(-1), norm


def rows_differing(fn, q, cand, vectors, batch) -> int:
    full = fn(q, cand, vectors)
    parts = torch.cat([fn(q[s:s + batch], cand[s:s + batch], vectors)
                       for s in range(0, q.shape[0], batch)])
    return int((parts != full).any(1).sum())


def device_ms(fn, args, iters=20) -> float:
    for _ in range(3):
        fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    vectors = torch.randn((1_000_000, 128), generator=g, device=dev) * 3
    q = torch.randn((4096, 128), generator=g, device=dev) * 3
    cand = torch.randint(-1, vectors.shape[0], (4096, 320), generator=g,
                         device=dev, dtype=torch.int32)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "queries": q.shape[0], "candidates": cand.shape[1]}
    for name, fn in (("library", library_sqdist),
                     ("fixed_order", rerank.exact_sqdist)):
        out[name] = {str(b): rows_differing(fn, q, cand, vectors, b)
                     for b in (1, 256, 1024)}
        if dev.type == "cuda":
            out[name]["ms_at_1024_queries"] = device_ms(
                fn, (q[:1024], cand[:1024], vectors))
    rot = rabitq.random_rotation(g, 128, device=dev)
    lq = torch.randn((65_536, 128), generator=g, device=dev) * 3
    lc = torch.randn((65_536, 128), generator=g, device=dev) * 3
    for name, fn in (("library_lut", library_lut),
                     ("fixed_order_lut", rabitq.prepare_query)):
        full = fn(lq, lc, rot)
        out[name] = {str(m): int(sum(
            (part != whole[:m]).reshape(m, -1).any(1)
            for part, whole in zip(fn(lq[:m], lc[:m], rot), full))
            .count_nonzero()) for m in (1, 64, 255, 256, 4096, 16_384)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
