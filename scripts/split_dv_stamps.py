"""Where a tile's cycles go in the split-dv (MLA) and wide (head dim 256)
attention kernels, at the serving path's prefill shapes, on the card.

    python3 scripts/split_dv_stamps.py      # from the root, on the card

Builds a copy of ``kernels/csrc/flash_attn.cu`` under ``build/stamps/``
with ``clock64()`` stamps at the steps of each kernel's tile loop (and,
for MLA, of its prologue and epilogue), written by the first thread of
each consumer warpgroup of the first 256 blocks through the lse pointer
(the copy writes no lse). The inputs are those of
``scripts/time_attention.py``'s ``mla`` and ``hd256`` calls (seeded bf16:
MLA B 8, S 2,048, 16 heads over the latent cache; hd 256 B 8, S 3,072, 16
heads over one, window 2,048).
Prints, in SM cycles, the mean of each step over the steady tiles (the
third on) and the median tile period; for MLA also the medians of the
prologue (entry to Q in shared memory, to the loop, the first tile's
wait), of the last P.V and of a whole block; and the card's name, power
limit and SM clock. The anchors are lines of the kernels' source: the
script fails on an edit that moves them.
"""

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BLOCKS, SLOTS = 256, 40          # blocks stamped, tiles a warpgroup (+ 1)


def stamp(k: int, it: str = "it") -> str:
    return ("    if ((threadIdx.x == 128 || threadIdx.x == 256) && blockIdx.x"
            f" < {BLOCKS}) reinterpret_cast<unsigned*>(a.lse)[((blockIdx.x *"
            f" 2 + (threadIdx.x >> 8)) * {SLOTS} + ({it})) * 8 + {k}] = "
            "static_cast<unsigned>(clock64());\n")


def stamped_source(src: str) -> str:
    a = src.index("    flash_mla_kernel(const __nv_bfloat16* __restrict__ q,")
    z = src.index("// The wide kernel, head dim 256")
    z2 = src.index("// cuTensorMapEncodeTiled of libcuda")
    last = str(SLOTS - 1)
    no_lse = ("      store_lse(a, b, h0 + r / rows_h, p, m[i], den, true);\n",
              "      ;\n")
    mla_edits = [
        ("  const int tid = threadIdx.x;\n  const uint32_t rank",
         "  const int tid = threadIdx.x;\n" + stamp(0, last).replace(
             "    if", "  if") + "  const uint32_t rank"),
        ("  fence_async_smem();\n  consumers_sync(1);\n\n  auto wait_k",
         "  fence_async_smem();\n  consumers_sync(1);\n" + stamp(1, last)
         + "\n  auto wait_k"),
        ("  for (int it = 0; it < n_tiles; ++it) {\n    wait_k(it);\n"
         "    if (it > 0) wait_v(it - 1);\n",
         "  for (int it = 0; it < n_tiles; ++it) {\n" + stamp(0)
         + "    wait_k(it);\n    if (it > 0) wait_v(it - 1);\n" + stamp(1)),
        ("    issue_s(it);\n    if (it > 0) {\n",
         "    issue_s(it);\n" + stamp(2) + "    if (it > 0) {\n"),
        ("      release_v(it - 1);\n    }\n    wgmma_wait<0>();  // S of tile "
         "it has landed\n",
         "      release_v(it - 1);\n    }\n" + stamp(3)
         + "    wgmma_wait<0>();  // S of tile it has landed\n" + stamp(4)),
        ("    softmax(it);\n    rescale_and_write_p();\n    fence_async_smem()"
         ";\n    consumers_sync(1);  // P of tile it is whole\n",
         "    softmax(it);\n" + stamp(5) + "    rescale_and_write_p();\n"
         "    fence_async_smem();\n" + stamp(6)
         + "    consumers_sync(1);  // P of tile it is whole\n" + stamp(7)),
        ("  wait_v(n_tiles - 1);\n  reg_fence(acc);",
         stamp(2, last) + "  wait_v(n_tiles - 1);\n  reg_fence(acc);"),
        ("  consumers_sync(2);\n#pragma unroll\n  for (int i = 0; i < 2; ++i) "
         "{\n    const int r = r_in + 8 * i;",
         stamp(3, last) + "  consumers_sync(2);\n#pragma unroll\n  for (int "
         "i = 0; i < 2; ++i) {\n    const int r = r_in + 8 * i;"),
        no_lse,
    ]
    wide_edits = [
        ("    for (int it = lo + 1; it <= hi; ++it) {\n      wait_k(it);\n"
         "      wait_v(it - 1);\n",
         "    for (int it = lo + 1; it <= hi; ++it) {\n" + stamp(0)
         + "      wait_k(it);\n      wait_v(it - 1);\n" + stamp(1)),
        ("      issue_pv(it - 1);\n      wgmma_wait<1>();  // S of tile it "
         "has landed\n",
         "      issue_pv(it - 1);\n" + stamp(2) + "      wgmma_wait<1>();  "
         "// S of tile it has landed\n" + stamp(3)),
        ("      softmax(it);\n      wgmma_wait<0>();  // P.V of tile it - 1 "
         "has landed\n",
         "      softmax(it);\n" + stamp(4) + "      wgmma_wait<0>();  // P.V "
         "of tile it - 1 has landed\n" + stamp(5)),
        ("      rescale_and_pack();\n    }\n",
         "      rescale_and_pack();\n" + stamp(6) + "    }\n"),
        no_lse,
    ]
    mla, wide = src[a:z], src[z:z2]
    for body, edits in ((0, mla_edits), (1, wide_edits)):
        for old, new in edits:
            text = mla if body == 0 else wide
            if old not in text:
                sys.exit(f"anchor moved in flash_attn.cu: {old[:60]!r}")
            if body == 0:
                mla = mla.replace(old, new)
            else:
                wide = wide.replace(old, new)
    return src[:a] + mla + wide + src[z2:]


def steps(st, n_k):
    """(mean cycles of each step over the steady tiles, median period)."""
    rows = st[:, :, 2:SLOTS - 2]                  # tiles 2 .. 37
    nxt = st[:, :, 3:SLOTS - 1, 0]
    ok = (rows[..., :n_k] != 0).all(-1) & (nxt != 0)
    d = (rows[..., 1:n_k] - rows[..., :n_k - 1]) & 0xFFFFFFFF
    period = ((nxt - rows[..., 0]) & 0xFFFFFFFF)[ok]
    d = d[ok]
    keep = (d < 10**6).all(-1)
    return (d[keep].double().mean(0).tolist(),
            float(period[period < 10**6].double().median()))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the kernels run on the card only")
    from repro_torch.kernels import _build, flash_attn
    out_dir = ROOT / "build" / "stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attn.cu").read_text()
    cu = out_dir / "flash_attn_stamped.cu"
    cu.write_text(stamped_source(src).replace(
        '#include "', f'#include "{_build.CSRC}/'))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(proc.stdout[-3000:] + proc.stderr[-3000:])
    lib = ctypes.CDLL(str(so))
    _build.library = lambda name: lib
    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    lat = torch.randn((8, 2048, 1, 576), generator=g, device="cuda").to(bf)
    cases = {
        "mla": (torch.randn((8, 2048, 16, 576), generator=g,
                            device="cuda").to(bf), lat, lat[..., :512],
                dict(causal=True), 8,
                ["wait_k", "issue P.V, S", "P.V lands", "S lands",
                 "softmax (maxima barrier)", "rescale, P written",
                 "P barrier"]),
        "hd256": (torch.randn((8, 3072, 16, 256), generator=g,
                              device="cuda").to(bf),
                  torch.randn((8, 3072, 1, 256), generator=g,
                              device="cuda").to(bf),
                  torch.randn((8, 3072, 1, 256), generator=g,
                              device="cuda").to(bf),
                  dict(causal=True, window=2048), 7,
                  ["wait_k, wait_v", "issue S, P.V", "S lands", "softmax",
                   "P.V lands", "rescale, pack"]),
    }
    for name, (q, k, v, kw, n_k, labels) in cases.items():
        for _ in range(3):
            _, lse = flash_attn.flash_attention(q, k, v, return_lse=True,
                                                **kw)
        lse.zero_()
        _, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        st = (lse.view(torch.int32).flatten()[:BLOCKS * 2 * SLOTS * 8]
              .view(BLOCKS, 2, SLOTS, 8).to(torch.int64).cpu()) & 0xFFFFFFFF
        means, period = steps(st, n_k)
        print(f"{name}: steady tile period median {period:.0f} cycles; "
              + "; ".join(f"{lab} {x:.0f}" for lab, x in zip(labels, means)),
              flush=True)
        if name == "mla":
            pro = st[:, :, SLOTS - 1]
            first = st[:, :, 0, :2]
            ok = (pro[..., :4] != 0).all(-1) & (first != 0).all(-1)
            parts = torch.stack([
                (pro[..., 1] - pro[..., 0]) & 0xFFFFFFFF,
                (first[..., 0] - pro[..., 1]) & 0xFFFFFFFF,
                (first[..., 1] - first[..., 0]) & 0xFFFFFFFF,
                (pro[..., 3] - pro[..., 2]) & 0xFFFFFFFF,
                (pro[..., 3] - pro[..., 0]) & 0xFFFFFFFF], -1)[ok].double()
            med = parts.median(0).values.tolist()
            print("mla prologue and epilogue (medians, cycles): entry to Q "
                  f"in shared memory {med[0]:.0f}, to the loop {med[1]:.0f},"
                  f" first tile's wait {med[2]:.0f}, last P.V and the "
                  f"denominator {med[3]:.0f}, whole block {med[4]:.0f}",
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
