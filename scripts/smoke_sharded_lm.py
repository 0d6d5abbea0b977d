"""Run phase 11s of ``chip_smoke.py`` (the sharded LM) alone, with what it
needs, and phase 19w (whose depth was cut to pay for 11s).

    python3 scripts/smoke_sharded_lm.py        # from the root, on the card

Phases 1 (the card), 2 (the kernels' build), 11s (h2o-danube-1.8b on a
(1 data x 4 model) mesh of gloo ranks sharing the card) and 19w, each as
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
    for name, phase in (("11s", cs.phase_sharded_lm),
                        ("19w", cs.phase_train_witness)):
        t = time.perf_counter()
        phase(torch, dev)
        cs.log(f"{name} wall {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
