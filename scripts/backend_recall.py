"""recall@10 of each ranking backend of the JAX package, beam and GEMV, on
a 100k-point, 40-cluster corpus of chip_smoke.py's kind (dim 128, degree
32, knn_k 64, nprobe 8, ef 40, 1024 queries searched 64 at a time), on
the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/backend_recall.py

It measures the reference that chip_smoke.py's recall floors are taken
from (PERF.md section 2); it imports the JAX package, and nothing of the
port.
"""

from __future__ import annotations

import json
import time

import jax
import numpy as np

from repro.core import compact_index, engine
from repro.data.synthetic import clustered_vectors, ground_truth, query_set


def main() -> None:
    t = time.perf_counter()
    x, _ = clustered_vectors(0, 100_000, 128, 40)
    q = query_set(0, x, 1024)
    gt = np.asarray(ground_truth(x, q, 10))
    icfg = compact_index.IndexConfig(dim=128, n_clusters=40, degree=32,
                                     knn_k=64)
    eng = engine.PIMCQGEngine.build(jax.random.PRNGKey(0), x, icfg,
                                    engine.SearchConfig(), n_shards=8)
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    out = {}
    for mode in ("mulfree", "exact", "hamming"):
        for scan in ("beam", "gemv"):
            e = engine.PIMCQGEngine(
                eng.index, eng.host, eng.place, icfg,
                engine.SearchConfig(mode=mode, scan=scan))
            ids = np.concatenate([np.asarray(e.search(q[i:i + 64])[0].ids)
                                  for i in range(0, len(q), 64)])
            hit = (ids[:, :, None] == gt[:, None, :]).any(-1).sum()
            out[f"{mode}/{scan}"] = float(hit) / gt.size
            print(f"{mode} {scan}: recall@10 {out[f'{mode}/{scan}']:.4f}",
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
