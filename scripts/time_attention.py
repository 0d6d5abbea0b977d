"""Time the port's attention kernels (``kernels/flash_attn.py``
``flash_attention``) on a table of calls, for one or more checkouts in
turns, on the card.

    python3 scripts/time_attention.py [--tree DIR ...] [--only NAME ...]
                                      [--iters N]

Calls (seeded random values, ``SHAPES``):

* ``mla``: deepseek-v2-lite-16b's absorbed MLA prefill, bf16 q_all (8,
  2048, 16, 576) over a bf16 latent cache (8, 2048, 1, 576) whose first
  512 columns are v, causal (the split-dv kernel of ``flash_attn.cu``);
* ``hd256``: recurrentgemma-9b's local attention, bf16 q (8, 3072, 16,
  256) over one bf16 KV head, window 2,048 (the wide kernel);
  each of these two uncapped and with the cap 50 (``softcap/<name>``);
* ``decode/rank``: the sequence-split decode step at a danube decode_32k
  rank, float32 q (8, 1, 32, 80) over 2,048 bf16 slots of 8 KV heads,
  non-causal, with the lse (``models/attention.py`` ``_seq_split_step``);
* ``decode/long``: the same call for one long context, B 1 over 32,768
  slots.

A checkout since the split-KV decode kernel (``csrc/flash_decode.cu``)
runs the decode calls there, an earlier one in ``flash_attn.cu``'s
CUDA-core ``flash_fwd_kernel``.

Each tree (default: this checkout) runs in a subprocess of its own that
builds the kernels it calls and holds each output: bf16 q against the bf16
twin (``ref.flash_attention_ref(..., operands=torch.bfloat16)``) within
the order bound plus the flip bound, float32 q against the float32 plain
version within the order bound. It times each call by CUDA events around
``--iters`` back-to-back calls queued behind a spin kernel that outlasts
their launch on the host, so the events span the device's work alone
(median of 5 runs). The trees go in turns: a, b, b, a for two of them.
This checkout's ``kernels/cost.py`` gives each call's bound and, for the
prefill calls, the bytes its kernel stages from L2 (64-row blocks for
MLA, 128-row blocks at 256; 64-row blocks for both before the split-dv
redesign). Exits 1 on a card-less machine or when an output leaves its
bound.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SHAPES = {  # name: (b, sq, sk, hq, hkv, dk, dv, q bf16, causal, window,
    #                alias, caps)
    "mla": (8, 2048, 2048, 16, 1, 576, 512, True, True, None, True,
            (0.0, 50.0)),
    "hd256": (8, 3072, 3072, 16, 1, 256, 256, True, True, 2048, False,
              (0.0, 50.0)),
    "decode/rank": (8, 1, 2048, 32, 8, 80, 80, False, False, None, False,
                    (0.0,)),
    "decode/long": (1, 1, 32768, 32, 8, 80, 80, False, False, None, False,
                    (0.0,)),
}


def inputs(torch, name):
    """(q, k, v, mask) of a call; K/V bf16, q bf16 or float32."""
    b, sq, sk, hq, hkv, dk, dv, q_bf16, causal, window, alias, _ = \
        SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(dk if sq > 1 else sk)
    bf = torch.bfloat16
    q = torch.randn((b, sq, hq, dk), generator=g, device="cuda")
    q = q.to(bf) if q_bf16 else q
    k = torch.randn((b, sk, hkv, dk), generator=g, device="cuda").to(bf)
    v = k[..., :dv] if alias else torch.randn(
        (b, sk, hkv, dv), generator=g, device="cuda").to(bf)
    return q, k, v, dict(causal=causal, window=window)


def keys(name: str) -> list[str]:
    """The timed keys of a call: one a cap, ``softcap/<name>`` if capped."""
    return [name if cap == 0 else f"softcap/{name}"
            for cap in SHAPES[name][-1]]


def worker(names: list[str], iters: int) -> None:
    """One tree: hold and time every call, one JSON line on stdout."""
    import torch
    from repro_torch.kernels import flash_attn, ref
    out = {}
    for name in names:
        q, k, v, kw = inputs(torch, name)
        for key, cap in zip(keys(name), SHAPES[name][-1]):
            call = dict(kw, softcap=cap)
            if q.dtype == torch.bfloat16:
                want = ref.flash_attention_ref(
                    q, k, v, operands=torch.bfloat16, **call)
                bound = (ref.flash_attention_order_bound(want)
                         + ref.flash_attention_flip_bound(q, k, v, **call))
            else:
                call["return_lse"] = True
                want = ref.flash_attention_ref(q, k, v, **call)[0]
                bound = ref.flash_attention_order_bound(want)
            got = flash_attn.flash_attention(q, k, v, **call)
            got = got[0] if isinstance(got, tuple) else got
            worst = float(((got.double() - want.double()).abs()
                           / bound.double()).max())
            del got, want, bound
            flash_attn.flash_attention(q, k, v, **call)
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(200_000_000)
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
    """A call's bound, and for a prefill the bytes its kernel stages from
    L2, from this checkout's cost.py."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cost
    b, sq, sk, hq, hkv, dk, dv, q_bf16, causal, window, alias, _ = \
        SHAPES[name]
    kw = dict(b=b, sq=sq, sk=sk, hq=hq, hkv=hkv, dk=dk, dv=dv, causal=causal,
              window=window)
    bound = cost.flash_attention(q_bytes=2 if q_bf16 else 4, kv_bytes=2,
                                 alias=alias, **kw)
    staged = {} if sq == 1 else {
        rows: cost.flash_staged_bytes(kv_bytes=2, alias=alias, rows=rows,
                                      **kw) for rows in (64, 128)}
    return dict(bound_ms=bound.bound_ms(), bound_by=bound.bound_by(),
                staged=staged)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to time (repeatable; default: this "
                         "one)")
    ap.add_argument("--only", action="append", default=[],
                    help="the calls whose names start with this "
                         "(repeatable; default: every call)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = [n for n in SHAPES
             if not args.only or any(n.startswith(o) for o in args.only)]
    if args.worker:
        worker(names, args.iters)
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
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--worker", "--iters", str(args.iters),
             *[f"--only={n}" for n in names]],
            cwd=tree, capture_output=True, text=True, timeout=1800,
            env={**os.environ, "PYTHONPATH": str(tree / "src")})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            sys.exit(1)
        line = proc.stdout.strip().splitlines()[-1]
        print(f"{tree}: {line}", flush=True)
        results[str(tree)].append(json.loads(line))
    bad = False
    for name in names:
        rk = reckoning(name)
        for key in keys(name):
            for tree, runs in results.items():
                ms = [r[key]["ms"] for r in runs]
                worst = max(r[key]["worst"] for r in runs)
                bad |= worst > 1.0
                staged = "".join(
                    f"; staged bytes at {rows}-row blocks {n / 1e9:.3f} GB "
                    f"({n / min(ms) / 1e9:.3f} TB/s)"
                    for rows, n in rk["staged"].items())
                print(f"{key} {tree}: ms {ms}, bound {rk['bound_ms']:.5f} "
                      f"({rk['bound_by']}), {rk['bound_ms'] / min(ms):.3f} "
                      f"of it{staged}; worst share of the bound "
                      f"{worst:.3f}", flush=True)
    if bad:
        print("an output left its bound", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
