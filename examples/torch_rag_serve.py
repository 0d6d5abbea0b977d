"""RAG-style serving on the PyTorch / CUDA port: batched LM decode +
PIMCQG retrieval per request (``examples/rag_serve.py`` on
``repro_torch``).

    PYTHONPATH=src python examples/torch_rag_serve.py \\
        [--arch h2o-danube-1.8b] [--encoder mean-pool] [--device cpu]

A serving stack emits query embeddings, the PIMCQG engine (cluster filter
-> beam search -> rerank) returns neighbours, all through the streaming
scheduler (O2's dynamic mini-batching over a bucket ladder). The query
embedding comes from the pluggable ``QueryEncoder`` hook of
``launch/serve.py``: the probability-weighted mean token embedding by
default; ``--encoder logit-slice`` swaps in the stub. The LM is the arch's
smoke config with random weights; its prefills attend through the
``flash_attention`` kernel on the card (the plain version on the CPU).
"""

import argparse
import time

from repro_torch.launch.serve import ENCODERS, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--encoder", default="mean-pool", choices=list(ENCODERS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.time()
    toks, retrieved = run(args.arch, args.requests, args.prompt_len,
                          args.gen, rag=True, query_encoder=args.encoder,
                          device=args.device)
    print(f"generated tokens shape: {toks.shape}")
    if retrieved is None or not (retrieved >= 0).any():
        raise SystemExit("no neighbours were retrieved")
    print(f"retrieval wired through the async pipeline "
          f"({args.encoder} encoder): {retrieved.shape[1]} neighbors/request")
    print(f"total {time.time() - t0:.1f}s")
    return toks, retrieved


if __name__ == "__main__":
    main()
