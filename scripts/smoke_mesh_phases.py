"""Run the mesh phases of ``chip_smoke.py`` alone, with what they need.

    python3 scripts/smoke_mesh_phases.py        # from the root, on the card

Phases 1 (the card), 2 (the kernels' build), 4 (the 10M index), 5 (its
search), 13b (the search step on a (2 data x 4 model) mesh; phase 13's
tier is not run, so its QPS is logged as nan), 19 (training, whose losses
follow ``token_batch``), 19c and 19d (the DP steps), each as
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
    eng, qt, _ = cs.phase_build_index(torch, dev)
    _, _, qps, single = cs.phase_search(torch, eng, qt)
    t = time.perf_counter()
    cs.phase_anns_step(torch, eng, qt, qps, {"med": {"qps": float("nan")}})
    cs.log(f"13b wall {time.perf_counter() - t:.1f} s")
    del eng, single
    torch.cuda.empty_cache()
    cs.phase_train(torch, dev)
    for pod in (False, True):
        t = time.perf_counter()
        cs.phase_train_dp(torch, dev, pod=pod)
        cs.log(f"{'19d' if pod else '19c'} wall "
               f"{time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
