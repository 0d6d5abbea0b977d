"""Quickstart on the PyTorch / CUDA port: build a PIMCQG compact index and
search it (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Walks the paper's full query path on a synthetic clustered corpus:
IVF clustering -> canonical RabitQ codes -> per-cluster proximity graphs
-> greedy-place clusters onto "PU" shards -> beam search (the mulfree
``beam_search`` kernel on the card, its plain version on the CPU) ->
exact rerank; reports recall@10 vs brute force and the Table II footprint
ratio at this corpus' dimensionality. Runs on the card unless asked for
the CPU.
"""

import argparse

import numpy as np

from repro_torch.core import compact_index, engine
from repro_torch.data.synthetic import (clustered_vectors, ground_truth,
                                        query_set)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("== PIMCQG quickstart (PyTorch port) ==")
    x, _ = clustered_vectors(seed=0, n=args.n, d=96, n_clusters=32)
    queries = query_set(0, x, args.queries)
    gt = np.asarray(ground_truth(x, queries, 10))

    icfg = compact_index.IndexConfig(dim=96, n_clusters=32, degree=16,
                                     knn_k=32)
    scfg = engine.SearchConfig(nprobe=6, ef=60, k=10, mode="mulfree")
    print("building compact index (IVF + canonical RabitQ + graphs)...")
    eng = engine.PIMCQGEngine.build(0, x, icfg, scfg, n_shards=8,
                                    verbose=True, device=args.device)

    import torch
    res, stats = eng.search(torch.as_tensor(queries).to(args.device))
    ids = res.ids.cpu().numpy()
    recall = np.mean([len(set(ids[i]) & set(gt[i])) / 10
                      for i in range(len(queries))])
    hops = stats.hops.cpu().numpy()
    print(f"recall@10            : {recall:.3f}")
    print(f"mean beam expansions : {hops[hops > 0].mean():.1f}")
    print(f"dropped lanes        : {int(stats.dropped_lanes)}")
    fp = eng.footprint()
    print(f"footprint (this D/R) : SymphonyQG {fp['symphonyqg_bytes']:,} B "
          f"-> PIMCQG {fp['pimcqg_bytes']:,} B ({fp['reduction']:.1f}x)")
    big = compact_index.footprint_report(128, 32, 10 ** 9)
    print(f"at SIFT1B scale      : {big['symphonyqg_bytes'] / 1e9:.0f} GB -> "
          f"{big['pimcqg_bytes'] / 1e9:.0f} GB ({big['reduction']:.1f}x, "
          "paper: 1423 -> 138 GB)")
    return recall


if __name__ == "__main__":
    main()
