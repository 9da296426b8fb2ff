#!/usr/bin/env python3
"""Where the f32 ``flash_attention`` kernel's time goes, on one GPU.

    python3 scripts/fa_phases.py [--shape LABEL] [--reps N]

Builds patched copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``
into ``build/fa_phases/`` and runs each at one of ``chip_smoke.py``'s
``FA_SHAPES`` (default ``gemma2_global``), with its device time (the
median of ``reps`` launches, ``chip_smoke.device_ms``, the split pass
included) and
its error against the plain version:

- ``kernel``: the source as it is;
- ``no_softmax``: the softmax, softcap and P split left out (wrong
  output): what the CUDA-core work between the products costs;
- ``one_pass``: both products as one TF32 pass (hi·hi) instead of three:
  what two thirds of the tensor-core work cost;
- ``slots6``: a ring of 6 slots instead of 4;
- ``hi_loads_only``: the lo halves of K and Vᵀ not loaded (wrong output):
  half the bytes from L2 a tile, to see whether they bound the kernel;
- ``clocks``: ``clock64()`` around the consumer's phases, read back for
  three query blocks of head 0 (the heaviest, a middle one, a light one):
  cycles a KV tile in Q·Kᵀ (and the part of it spent waiting for a slot),
  in the softmax and split, in P·V (waiting for a slot, and draining a
  piece), and cycles waiting for the q tile at the block's start.

A patch that no longer finds its place in the source raises, so that
this script fails loudly when the kernel changes under it.  Needs a CUDA
device; exits 1 without one.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOFTMAX = """    softmax_tile<kCap>(sc, m0, m1, l0, l1, corr0, corr1, edge(k0), k0, col,
                       qpos0, causal, window, Skv, cap, inv_cap);"""
SPLIT = """      const float hi = tf32_rna(sc[j]);
      px[j] = tf32_rna(sc[j] - hi);
      sc[j] = hi;"""
PATCHES = {
    "kernel": [],
    "no_softmax": [(SOFTMAX, "    corr0 = corr1 = 1.f;"),
                   (SPLIT, "      px[j] = sc[j];")],
    "one_pass": [
        ("          wgmma_ss_n64<false>(px, qh, kl);\n", ""),
        ("          wgmma_ss_n64<true>(px, qh, kl);\n", ""),
        ("        wgmma_ss_n64<true>(px, ql, kh);\n", ""),
        ("    for (int j = 0; j < 32; ++j) sc[j] += px[j];\n", ""),
        ("""          wgmma_rs<true>(ot, __float_as_uint(px[4 * j]),
                         __float_as_uint(px[4 * j + 2]),
                         __float_as_uint(px[4 * j + 1]),
                         __float_as_uint(px[4 * j + 3]), vh);
""", ""),
        ("          wgmma_rs<true>(ot, h0, h1, h2, h3, vl);\n", "")],
    "slots6": [("constexpr int kSlots = 4;", "constexpr int kSlots = 6;")],
    "hi_loads_only": [
        ("          tma_load(slot(s) + kHalf, &kl_map, full(s), 32 * c, k0, "
         "kvh);\n", ""),
        ("""          tma_load(slot(s) + kHalf, &vl_map, full(s), k0 + 32 * (j & 1),
                   kNP * (j / 2), kvh);
""", ""),
        ("mbar_expect_tx(full(s), L::kKBytes);",
         "mbar_expect_tx(full(s), L::kKBytes / 2);"),
        ("mbar_expect_tx(full(s), L::kVBytes);",
         "mbar_expect_tx(full(s), L::kVBytes / 2);")],
}
# The clocks: T[0] Q.K^T, T[1] its slot waits, T[2] softmax and split,
# T[3] P.V, T[4] its slot waits, T[5] its piece drains, T[6] tiles, T[7]
# the q tile's wait; written by the consumer's thread 0 of the chosen
# block over the first 8 values of its first output row.
CLOCKS = [
    ("  if (tiles > 0) mbar_wait(q_bar, 0);\n"
     "  for (int i = 0; i < tiles; ++i) {\n",
     "  long long T[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long t_start = clock64();\n"
     "  if (tiles > 0) mbar_wait(q_bar, 0);\n"
     "  T[7] = clock64() - t_start;\n"
     "  T[6] = tiles;\n"
     "  for (int i = 0; i < tiles; ++i) {\n"
     "    const long long ta = clock64();\n"),
    ("      mbar_wait(full(s), ((n + c) / kSlots) & 1);\n",
     "      { const long long w = clock64();\n"
     "        mbar_wait(full(s), ((n + c) / kSlots) & 1);\n"
     "        T[1] += clock64() - w; }\n"),
    (SOFTMAX, "    const long long tb = clock64();\n    T[0] += tb - ta;\n"
     + SOFTMAX),
    ("    fence_regs(sc);\n    fence_regs(px);\n#pragma unroll\n"
     "    for (int p = 0; p < L::kPieces; ++p) {\n",
     "    const long long tc = clock64();\n    T[2] += tc - tb;\n"
     "    fence_regs(sc);\n    fence_regs(px);\n#pragma unroll\n"
     "    for (int p = 0; p < L::kPieces; ++p) {\n"),
    ("        mbar_wait(full(s), (idx / kSlots) & 1);\n",
     "        { const long long w = clock64();\n"
     "          mbar_wait(full(s), (idx / kSlots) & 1);\n"
     "          T[4] += clock64() - w; }\n"),
    ("      wgmma_wait<0>();\n      fence_regs(ot);\n",
     "      { const long long w = clock64();\n"
     "        wgmma_wait<0>();\n"
     "        T[5] += clock64() - w; }\n      fence_regs(ot);\n"),
    ("    fence_regs(sc);\n    fence_regs(px);\n  }\n",
     "    fence_regs(sc);\n    fence_regs(px);\n    T[3] += clock64() - tc;\n  }\n"),
    ("""                      acc[4 * n8 + 2 * half + 1] * inv);
    }
  }
""", """                      acc[4 * n8 + 2 * half + 1] * inv);
    }
  }
  asm volatile("bar.sync 1, 128;" ::: "memory");
  if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1 - FA_CLOCK_BLOCK &&
      blockIdx.y == 0 && blockIdx.z == 0) {
    for (int z = 0; z < 8; ++z)
      ob[static_cast<int64_t>(q0) * D + z] = static_cast<float>(T[z]);
  }
"""),
]
CLOCK_NAMES = ("qk", "qk_slot_wait", "softmax_split", "pv", "pv_slot_wait",
               "pv_piece_drain")


def patched(source: str, pairs) -> str:
    for old, new in pairs:
        if source.count(old) != 1:
            raise RuntimeError(f"patch target not found once: {old[:70]!r}")
        source = source.replace(old, new)
    return source


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="gemma2_global")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fa_phases.py needs a CUDA device; none found")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import build
    from repro_torch.kernels.ref import flash_attention_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    label, B, H, KV, S, D, dtype, window, cap = next(
        s for s in cs.FA_SHAPES if s[0] == args.shape)
    if dtype != torch.float32:
        raise SystemExit(f"{label} is not an f32 shape")
    blocks = (-(-S // 64) - 1, -(-S // 64) // 2, 5)
    source = fa.SOURCE_F32.read_text()
    out_dir = ROOT / "build" / "fa_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = {}
    for name, pairs in PATCHES.items():
        variants[name] = out_dir / f"flash_attention_{name}.cu"
        variants[name].write_text(patched(source, pairs))
    for blk in blocks:
        name = f"clocks{blk}"
        variants[name] = out_dir / f"flash_attention_{name}.cu"
        variants[name].write_text(patched(source, CLOCKS).replace(
            "FA_CLOCK_BLOCK", str(blk)))
    build(list(variants.values()))

    g = torch.Generator(cs.DEVICE).manual_seed(S + D + window)
    q = 4 * torch.randn(B, H, S, D, generator=g, device=cs.DEVICE)
    k = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE)
    v = torch.randn(B, KV, S, D, generator=g, device=cs.DEVICE)
    mode = {"causal": True, "window": window, "cap": cap}
    ref = flash_attention_ref(q, k, v, **mode)
    for name, path in variants.items():
        fa.SOURCE_F32 = path
        fa._library.cache_clear()
        out = fa.flash_attention(q, k, v, **mode)
        torch.cuda.synchronize()
        line = {"variant": name, "shape": label}
        if name.startswith("clocks"):
            blk = int(name[6:])
            t = out[0, 0, blk * 64, :8].tolist()
            line.update(q_block=blk, tiles=int(t[6]),
                        q_tile_wait_cycles=t[7],
                        cycles_per_tile={n: t[i] / t[6] for i, n in
                                         enumerate(CLOCK_NAMES)})
        else:
            line["max_abs_err"] = float((out - ref).abs().max())
            line["device_ms"] = cs.device_ms(
                lambda: fa.flash_attention(q, k, v, **mode), args.reps)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
