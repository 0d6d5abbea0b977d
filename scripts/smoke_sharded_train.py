"""Run phases 11s (the sharded LM, with retrieval) and 19s (the sharded
train step) of ``chip_smoke.py`` alone, with what they need.

    python3 scripts/smoke_sharded_train.py     # from the root, on the card

Phases 1 (the card), 2 (the kernels' build), 4 (the 10M index, whose
engine 11s retrieves from), 11s (h2o-danube-1.8b on a (1 data x 4 model)
mesh of gloo ranks sharing the card, serving with retrieval) and 19s
(h2o-danube-1.8b training on a (2 data x 2 model) mesh), each as
``chip_smoke.py`` runs it, and each phase's wall seconds: a quicker check
of these phases than the whole smoke.
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: these phases run on the card only")
    dev = torch.device("cuda", 0)
    cs.phase_card(torch)
    cs.phase_build_kernels()
    t = time.perf_counter()
    eng, _, _ = cs.phase_build_index(torch, dev)
    cs.log(f"4 wall {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cs.phase_sharded_lm(torch, dev, eng)
    cs.log(f"11s wall {time.perf_counter() - t:.1f} s")
    del eng
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cs.phase_sharded_train(torch, dev)
    cs.log(f"19s wall {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
