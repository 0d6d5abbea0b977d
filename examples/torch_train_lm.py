"""End-to-end run on the PyTorch / CUDA port: train a ~100M-param LM
for a few hundred steps (``examples/train_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_train_lm.py \\
        [--arch phi3-mini-3.8b] [--steps 300] [--device cpu]

Uses the '100m' preset (same family as the chosen arch, ~100M params),
the synthetic Zipf + copy-motif token pipeline, AdamW with cosine decay,
manifest checkpoints with resume; the attention trains through the
``flash_attention`` kernel's forward on the card (the plain version on the
CPU). Loss should fall from ~10.4 (ln V) toward the corpus entropy.
"""

import argparse

from repro_torch.launch.train import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    losses = run(arch=args.arch, preset="100m", steps=args.steps,
                 batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                 ckpt_every=100, resume=True, mesh_kind="test",
                 log_every=20, device=args.device)
    first, last = losses[0], sum(losses[-10:]) / min(10, len(losses))
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return losses


if __name__ == "__main__":
    main()
