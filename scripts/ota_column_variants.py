#!/usr/bin/env python3
"""The column path of ``ota_aggregate`` (C <= 8) against its alternatives,
in turns on one GPU.

    python3 scripts/ota_column_variants.py [--parent DIR] [--reps N]
        [--variants NAME ...]

Builds, each with ``nvcc`` and all started together, the kernel source of
this checkout (``change``: one column a thread, 8 rows of S in flight,
blocks of 256) and variants of it made by replacing text in a copy under
``build/ota_column_variants/``:

* ``n_before_loop``: N's values loaded before the loop over S;
* ``s_before_w``: the first rows of S loaded before W is staged;
* ``unroll_16``, ``threads_64`` ... ``threads_512``: 16 rows of S in
  flight, and blocks of 64 to 512 threads;
* ``vector_512``, ``vector_1024``: one 16-byte vector of S a thread (4 f32
  or 8 bf16 columns), 16-byte loads of S and N, rows off a 16-byte
  boundary joined across lanes by warp shuffles, 8 rows a batch with the
  next batch in flight, blocks of 512 or 1,024 columns (``VECTOR_COLUMN``
  below);
* ``ring``: the ring (the path for C > 8) at these shapes;
* with ``--parent``, the parent checkout's kernel (the C ABI of the
  kernel's first design, eight arguments, the weights cast to f32
  outside the timing; the checkout's entry points take one trajectory,
  ``batch`` = 1).

Then, at the C <= 8 shapes of ``chip_smoke.py``'s ``OTA_SHAPES`` and at
C = 8 at full width in f32 and in bf16, calls each library's entry point
directly on the same inputs (bf16 weights go in as they are), its output
poisoned with NaN before; checks every output bitwise against
``change``'s; and times each with the L2 flushed (``chip_smoke.device_ms``,
the median device time), three rounds in turn.  Prints the card's
``nvidia-smi`` line, each library's registers and spills, then one JSON
object a shape.  Needs a CUDA device; exits 1 without one.
"""
import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ota_column_variants"

# The scalar column kernel of the checkout, from its comment to its end.
SCALAR = re.compile(r"// C <= 8: the column path\..*?\n}\n", re.S)
N_STORE = """    __stcs(out + r * d + j,
           from_f32<T>(acc[r] + to_f32(__ldcs(n + r * d + j))));"""
STAGE = """  stage_w(ws, w, w_bf16, C * K);
  __syncthreads();
  if (!live) return;
"""
LOOP = """#pragma unroll kUnroll
  for (int k = 0; k < K; ++k) {"""
# Variants of the checkout's column kernel (its text: what, replaced by
# what) and of its plan (ota_plan.h).
VARIANTS = {
    # N's C values loaded before the loop over S.
    "n_before_loop": ([(STAGE, """  float nj[C];
#pragma unroll
  for (int r = 0; r < C; ++r)
    nj[r] = live ? to_f32(__ldcs(n + r * d + j)) : 0.f;
""" + STAGE), (N_STORE, """\
    __stcs(out + r * d + j, from_f32<T>(acc[r] + nj[r]));""")], []),
    # The first kUnroll rows of S loaded before W is staged.
    "s_before_w": ([(STAGE, """  float first[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    first[k] = live && k < K ? to_f32(__ldcs(s + k * d + j)) : 0.f;
""" + STAGE), ("""  for (int r = 0; r < C; ++r) acc[r] = 0.f;
""" + LOOP, """  for (int r = 0; r < C; ++r) acc[r] = 0.f;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k)
    if (k < K)
#pragma unroll
      for (int r = 0; r < C; ++r) acc[r] = fmaf(ws[r * K + k], first[k], acc[r]);
#pragma unroll kUnroll
  for (int k = kUnroll; k < K; ++k) {""")], []),
    "unroll_16": (
        [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 16;")], []),
    "threads_64": ([], [("kColumnThreads = 256;", "kColumnThreads = 64;")]),
    "threads_128": ([], [("kColumnThreads = 256;", "kColumnThreads = 128;")]),
    "threads_512": ([], [("kColumnThreads = 256;", "kColumnThreads = 512;")]),
    "threads_128_unroll_16": (
        [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 16;")],
        [("kColumnThreads = 256;", "kColumnThreads = 128;")]),
    # The ring (the path for C > 8) at these shapes.
    "ring": ([], [("kColumnMaxRows = 8;", "kColumnMaxRows = 0;")]),
}
# The plan's column branch, and what the vector variants put there.
PLAN_COLUMN = """    const int tile = kColumnThreads;
    p->ring = 0;
    p->warps = kColumnThreads / 32;"""
PLAN_VECTOR = """    const int tile = COLS;
    p->ring = 0;
    p->warps = tile / (16 / s_bytes) / 32;"""

VECTOR_COLUMN = r"""// What a lane of the column path holds of a row of X at its columns: the
// kCh 16-byte chunks from the one that holds its first column's first byte,
// and one more for a row that starts off a 16-byte boundary.
template <int kCh>
struct Chunks {
  uint4 u[kCh + 1];
};

// A lane's chunks of the row of X at `row` (its columns start at j; the row
// starts sb bytes past a 16-byte boundary), as 16-byte loads that stream
// past L2 (evict first).  When sb != 0 the chunk after them comes from the
// next lane (join_cols), and the warp's last lane loads it itself.  A chunk
// is loaded only if it starts before the row's end, so it holds a byte of
// the tensor and cannot fault; the others stay zero.
template <int kCh, typename X>
__device__ __forceinline__ void fetch_cols(const X* row, int64_t j, int64_t d,
                                           int sb, Chunks<kCh>& c) {
  const unsigned char* end = reinterpret_cast<const unsigned char*>(row + d);
  const uint4* q = reinterpret_cast<const uint4*>(
      reinterpret_cast<const unsigned char*>(row + j) - sb);
#pragma unroll
  for (int i = 0; i <= kCh; ++i) c.u[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < kCh; ++i)
    if (reinterpret_cast<const unsigned char*>(q + i) < end)
      c.u[i] = __ldcs(q + i);
  if (sb && threadIdx.x % 32 == 31 &&
      reinterpret_cast<const unsigned char*>(q + kCh) < end)
    c.u[kCh] = __ldcs(q + kCh);
}

// The lane's kCh x 16 / sizeof(X) columns from its chunks, as floats: for a
// misaligned row, the next lane's first chunk joins them and the bytes are
// shifted into place.  Every lane of the warp calls it (the shuffles) with
// the same sb.
template <typename X, int kCh, int V>
__device__ __forceinline__ void join_cols(Chunks<kCh>& c, int sb,
                                          float (&f)[V]) {
  constexpr int kPer = 16 / sizeof(X);
  static_assert(kCh * kPer == V, "a lane's columns are its chunks");
  if (sb) {
    const unsigned all = 0xffffffffu;
    const uint4 next = make_uint4(__shfl_down_sync(all, c.u[0].x, 1),
                                  __shfl_down_sync(all, c.u[0].y, 1),
                                  __shfl_down_sync(all, c.u[0].z, 1),
                                  __shfl_down_sync(all, c.u[0].w, 1));
    if (threadIdx.x % 32 != 31) c.u[kCh] = next;
#pragma unroll
    for (int i = 0; i < kCh; ++i)
      unpack(shift_bytes(c.u[i], c.u[i + 1], sb), f + i * kPer, X());
  } else {
#pragma unroll
    for (int i = 0; i < kCh; ++i) unpack(c.u[i], f + i * kPer, X());
  }
}

// Rows of S a thread of the column path has in flight, twice over: the
// next kColumnUnroll rows load while this batch's FMAs run.
constexpr int kColumnUnroll = UNROLL;

// The column path: C <= 8 rows of W, in shared memory.  A block takes
// kColumnCols columns, a thread one 16-byte vector of them (V = 4 in
// f32, 8 in bf16), reading S straight into registers by 16-byte loads,
// kColumnUnroll rows a batch, the next batch in flight while this one is
// summed; the first batch is issued before W is staged, and the last
// batch's FMAs run while N's rows load.  Each sum in ascending k with fmaf
// from 0, then + N, then the cast, as in the ring.  S, N and y stream past
// L2 (evict first).  Rows off a 16-byte boundary (every other f32 row at
// d = 184,214; three in four bf16 rows) are joined across lanes by
// shuffles (join_cols); y goes out at the widest width each row's address
// allows (st16).
// kBatched: the checkout's trajectory axis, which this variant, timed at
// one trajectory, does not take.
template <typename T, typename TN, int C, bool kBatched>
__global__ void __launch_bounds__(kColumnThreads)
    ota_column_kernel(const T* __restrict__ s, const void* __restrict__ w,
                      int w_bf16, const TN* __restrict__ n,
                      T* __restrict__ out, int K, int64_t d) {
  constexpr int V = Vec<T>::V, kU = kColumnUnroll;
  constexpr int kNCh = V * sizeof(TN) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // (C, K)
  const int lane = threadIdx.x % 32;
  const int64_t j =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  // Whole warps run the shuffles: a warp with a column below d runs, its
  // lanes past d included.
  const bool live = j - lane * V < d;
  // Row k of S starts (s_sb0 + k s_sbd) % 16 bytes past a 16-byte boundary.
  const int s_sb0 = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
  const int s_sbd = static_cast<int>((d * sizeof(T)) & 15);
  const int n_sb0 = static_cast<int>(reinterpret_cast<uintptr_t>(n) & 15);
  const int n_sbd = static_cast<int>((d * sizeof(TN)) & 15);
  const auto fetch = [&](Chunks<1> (&c)[kU], int k0) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (k0 + u < K)
        fetch_cols<1>(s + (k0 + u) * d, j, d, (s_sb0 + (k0 + u) * s_sbd) & 15,
                      c[u]);
  };
  Chunks<1> a[kU];
  if (live) fetch(a, 0);
  stage_w(ws, w, w_bf16, C * K);
  __syncthreads();
  if (!live) return;

  float acc[C][V];
#pragma unroll
  for (int r = 0; r < C; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  Chunks<kNCh> nc[C];
  for (int k0 = 0;; k0 += kU) {
    const bool last = k0 + kU >= K;
    Chunks<1> b[kU];
    if (!last) {
      fetch(b, k0 + kU);
    } else {
#pragma unroll
      for (int r = 0; r < C; ++r)
        fetch_cols<kNCh>(n + r * d, j, d, (n_sb0 + r * n_sbd) & 15, nc[r]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (k0 + u >= K) break;
      float sv[V];
      join_cols<T>(a[u], (s_sb0 + (k0 + u) * s_sbd) & 15, sv);
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const float wk = ws[r * K + k0 + u];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(wk, sv[v], acc[r][v]);
      }
    }
    if (last) break;
#pragma unroll
    for (int u = 0; u < kU; ++u) a[u] = b[u];
  }
  const int nv = static_cast<int>(
      max(static_cast<int64_t>(0), min(static_cast<int64_t>(V), d - j)));
#pragma unroll
  for (int r = 0; r < C; ++r) {
    float y[V];
    join_cols<TN>(nc[r], (n_sb0 + r * n_sbd) & 15, y);
#pragma unroll
    for (int v = 0; v < V; ++v) y[v] = acc[r][v] + y[v];
    if (nv > 0) store_row(out + r * d + j, nv, y);
  }
}

"""


def variants(names):
    """{name: (kernel source, plan header)} for ``change`` and ``names``."""
    cu = (CSRC / "ota_aggregate.cu").read_text()
    plan = (CSRC / "ota_plan.h").read_text()

    def patch(text, subs, name):
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the kernel source no longer "
                                 f"holds {old!r} once")
            text = text.replace(old, new)
        return text

    out = {"change": (cu, plan)}
    for name in names:
        if name in VARIANTS:
            cu_subs, plan_subs = VARIANTS[name]
            out[name] = (patch(cu, cu_subs, name),
                         patch(plan, plan_subs, name))
            continue
        cols = int(name.removeprefix("vector_"))
        out[name] = (
            patch(cu, [(SCALAR.search(cu).group(0),
                        VECTOR_COLUMN.replace("UNROLL", "8"))], name),
            patch(plan, [(PLAN_COLUMN, PLAN_VECTOR.replace("COLS",
                                                           str(cols))),
                         ("kColumnThreads = 256;",
                          f"kColumnThreads = {cols // 4};"),
                         ("constexpr int kColumnMaxRows",
                          f"constexpr int kColumnCols = {cols};\n"
                          "constexpr int kColumnMaxRows")], name))
    return out


def build(sources, parent):
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    procs = {}
    for name, (cu, plan) in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ota_aggregate.cu").write_text(cu)
        (d / "ota_plan.h").write_text(plan)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "ota_aggregate.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    if parent:
        src = (Path(parent).resolve() / "src" / "repro_torch" / "kernels"
               / "csrc" / "ota_aggregate.cu")
        (OUT / "parent").mkdir(parents=True, exist_ok=True)
        procs["parent"] = (OUT / "parent" / "lib.so", subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(OUT / "parent" / "lib.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        column = []
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "column_kernel" in ln:
                kind = re.search(r"column_kernelI(\w+?)Li(\d)E", ln)
                stats = " ".join(x.strip() for x in lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", stats)
                spill = re.search(r"(\d+) bytes spill stores", stats)
                column.append([kind.group(1) if kind else ln[-40:],
                               int(kind.group(2)) if kind else None,
                               int(regs.group(1)) if regs else None,
                               int(spill.group(1)) if spill else None])
        print(json.dumps({"library": name, "column_kernels": column}),
              flush=True)
        lib = ctypes.CDLL(str(so))
        for fn in (lib.ota_aggregate_f32, lib.ota_aggregate_bf16,
                   lib.ota_aggregate_bf16_bf16noise):
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_longlong, ctypes.c_void_p] if name == "parent"
                else [ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="*",
                    default=[*VARIANTS, "vector_512", "vector_1024"],
                    help="variants to build beside the checkout's kernel")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ota_column_variants.py needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(variants(args.variants), args.parent)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [sh for sh in cs.OTA_SHAPES if sh[2] <= 8 and sh[3] >= 2049]
    shapes += [("c8", 50, 8, 184214, f32, f32),
               ("c8_bf16", 50, 8, 184214, bf16, f32)]
    for label, K, C, d, dtype, wdtype in shapes:
        s, w, n = cs.ota_inputs(K, C, d, dtype, wdtype)
        w32 = w.to(f32).contiguous()
        outs, calls = {}, {}
        for name, lib in libs.items():
            fn = (lib.ota_aggregate_f32 if dtype == f32 else
                  lib.ota_aggregate_bf16 if n.dtype == f32 else
                  lib.ota_aggregate_bf16_bf16noise)
            out = torch.full((C, d), math.nan, dtype=dtype, device="cuda")

            def call(fn=fn, out=out, name=name):
                st = torch.cuda.current_stream().cuda_stream
                if name == "parent":
                    return fn(s.data_ptr(), w32.data_ptr(), n.data_ptr(),
                              out.data_ptr(), K, C, d, st)
                return fn(s.data_ptr(), w.data_ptr(), int(w.dtype == bf16),
                          n.data_ptr(), out.data_ptr(), K, C, d, 1, st)

            err = call()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"{name} failed at {label}: error {err}")
            outs[name], calls[name] = out, call
        times = {name: [] for name in calls}
        for _ in range(3):
            for name, call in calls.items():
                times[name].append(cs.device_ms(call, args.reps) * 1e3)
        print(json.dumps({
            "shape": label, "K": K, "C": C, "d": d, "dtype": str(dtype),
            "weights_noise_dtype": str(wdtype),
            "bitwise_equal_to_change": {
                name: bool(torch.equal(o, outs["change"]))
                for name, o in outs.items()},
            "finite": all(bool(torch.isfinite(o.float()).all())
                          for o in outs.values()),
            "device_us": times}), flush=True)


if __name__ == "__main__":
    main()
