"""Time the split-dv (MLA) and wide (head dim 256) attention kernels of
``kernels/csrc/flash_attn.cu`` at the serving path's prefill shapes, for
one or more checkouts in turns, on the card.

    python3 scripts/time_split_dv.py [--tree DIR ...] [--iters N]

Shapes (bf16 q and K/V, seeded random values): deepseek-v2-lite-16b's
absorbed MLA, q_all (8, 2048, 16, 576) over a latent cache (8, 2048, 1,
576) whose first 512 columns are v, causal; recurrentgemma-9b's local
attention, q (8, 3072, 16, 256) over one KV head, window 2,048. Each
uncapped and with the cap 50.

Each tree (default: this checkout) runs in a subprocess of its own that
builds its ``flash_attn.cu``, holds each output against the bf16 twin
(``ref.flash_attention_ref(..., operands=torch.bfloat16)``) within the
order bound plus the flip bound, and times the launch by CUDA events
(median of 5 runs of ``--iters`` back-to-back launches after a warm-up).
The trees go in turns: a, b, b, a for two of them. This checkout's
``kernels/cost.py`` gives each shape's bound and the bytes its kernel
stages from L2 (64-row blocks for MLA, 128-row blocks at 256; 64-row
blocks for both before the redesign), so the summary prints ms, the
share of the bound and the staged bytes' rate. Exits 1 on a card-less
machine or when an output leaves its bound.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHAPES = {  # name: (b, s, hq, hkv, dk, dv, window, alias)
    "mla": (8, 2048, 16, 1, 576, 512, None, True),
    "hd256": (8, 3072, 16, 1, 256, 256, 2048, False),
}
CAP = 50.0


def inputs(torch, name):
    b, s, hq, hkv, dk, dv, window, alias = SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(dk)
    bf = torch.bfloat16
    q = torch.randn((b, s, hq, dk), generator=g, device="cuda").to(bf)
    k = torch.randn((b, s, hkv, dk), generator=g, device="cuda").to(bf)
    v = k[..., :dv] if alias else torch.randn(
        (b, s, hkv, dv), generator=g, device="cuda").to(bf)
    return q, k, v, dict(causal=True, window=window)


def worker(iters: int) -> None:
    """One tree: hold and time every shape, one JSON line on stdout."""
    import torch
    from repro_torch.kernels import flash_attn, ref
    out = {}
    for name in SHAPES:
        q, k, v, kw = inputs(torch, name)
        for cap in (0.0, CAP):
            key = name if cap == 0 else f"softcap/{name}"
            call = dict(kw, softcap=cap)
            got = flash_attn.flash_attention(q, k, v, **call)
            twin = ref.flash_attention_ref(q, k, v, operands=torch.bfloat16,
                                           **call)
            bound = (ref.flash_attention_order_bound(twin)
                     + ref.flash_attention_flip_bound(q, k, v, **call))
            worst = float(((got.double() - twin.double()).abs()
                           / bound.double()).max())
            del twin, bound
            for _ in range(3):
                flash_attn.flash_attention(q, k, v, **call)
            runs = []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(iters):
                    flash_attn.flash_attention(q, k, v, **call)
                e.record()
                e.synchronize()
                runs.append(a.elapsed_time(e) / iters)
            out[key] = dict(ms=sorted(runs)[2], runs=runs, worst=worst)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def reckoning(name: str) -> dict:
    """Bound and staged bytes of a shape from this checkout's cost.py."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cost
    b, s, hq, hkv, dk, dv, window, alias = SHAPES[name]
    kw = dict(b=b, sq=s, sk=s, hq=hq, hkv=hkv, dk=dk, dv=dv, causal=True,
              window=window)
    bound = cost.flash_attention(q_bytes=2, kv_bytes=2, alias=alias, **kw)
    staged = {rows: cost.flash_staged_bytes(kv_bytes=2, alias=alias,
                                            rows=rows, **kw)
              for rows in (64, 128)}
    return dict(bound_ms=bound.bound_ms(), bound_by=bound.bound_by(),
                staged=staged)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time (repeatable; default: this "
                         "one)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.iters)
        return
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run on the card only",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    trees = [pathlib.Path(t).resolve() for t in args.tree] or [ROOT]
    turns = trees + trees[::-1] if len(trees) > 1 else trees
    results: dict = {str(t): [] for t in trees}
    for tree in turns:
        env = {"PYTHONPATH": str(tree / "src")}
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--worker", "--iters", str(args.iters)],
            cwd=tree, capture_output=True, text=True, timeout=1800,
            env={**os.environ, **env})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            sys.exit(1)
        line = proc.stdout.strip().splitlines()[-1]
        print(f"{tree}: {line}", flush=True)
        results[str(tree)].append(json.loads(line))
    bad = False
    for name in SHAPES:
        rk = reckoning(name)
        for key in (name, f"softcap/{name}"):
            for tree, runs in results.items():
                ms = [r[key]["ms"] for r in runs]
                worst = max(r[key]["worst"] for r in runs)
                bad |= worst > 1.0
                print(f"{key} {tree}: ms {ms}, bound {rk['bound_ms']:.5f} "
                      f"({rk['bound_by']}), {rk['bound_ms'] / min(ms):.3f} "
                      f"of it; staged bytes at 64-row blocks "
                      f"{rk['staged'][64] / 1e9:.3f} GB "
                      f"({rk['staged'][64] / min(ms) / 1e9:.3f} TB/s), at "
                      f"128-row blocks {rk['staged'][128] / 1e9:.3f} GB "
                      f"({rk['staged'][128] / min(ms) / 1e9:.3f} TB/s); "
                      f"worst share of the twin's bound {worst:.3f}",
                      flush=True)
    if bad:
        print("an output left its bound", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
