// Blockwise online-softmax attention (flash attention) in bf16 as a
// warp-specialised Hopper kernel: TMA loads, wgmma products.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fa_kernel for bf16 q, k, v (the
// f32 instantiation stays in flash_attention.cu).  For query head h of
// batch b (KV head h / G, G = H / KV: grouped KV heads are read in place,
// never replicated):
//
//   s[q,k]  = (q[q,:] . k[k,:]) * D^-0.5                  f32 sums
//   s       = cap * tanh(s / cap)                         if cap > 0
//   s       = -1e30 unless k < Skv, and k <= q (causal),
//             and k > q - window (window > 0)
//   o[q,:]  = sum_k softmax_k(s[q,:]) v[k,:]              online: m, l, acc
//   o       = acc / max(l, 1e-30), rounded to bf16
//
// What bounds it: operations.  At Gemma-2 9B's prefill shape (B=2, H=16,
// KV=8, S=4,608, D=256) a layer does 4*D operations per unmasked (q, k)
// pair: 348.0 GFLOP on a global layer and 343.7 on a local one (window
// 4,096), against about 0.23 GB of q, k, v and o.  At the H100's 989
// TFLOP/s of dense bf16 tensor-core work that is 0.352 ms and 0.347 ms.
//
// What this design does about it: both products run on the tensor cores
// (wgmma), fed by the Tensor Memory Accelerator, so that no thread spends
// an instruction on moving a tile, and the softmax of one tile runs while
// the tensor cores work on another.  A block of 384 threads is three
// warpgroups and owns 128 query rows of one (b, h):
//
//   - warpgroup 0 is the producer: it gives its registers away
//     (setmaxnreg 24) and one of its threads issues every TMA load: the q
//     tile once, then each KV tile of 64 keys into a 2-stage ring, K and V
//     each on their own "full" barrier (armed with the bytes it expects)
//     and "empty" barrier (one arrival per consumer warp), since a K
//     buffer is free a step before its V buffer;
//   - warpgroups 1 and 2 are consumers (setmaxnreg 240: 128*24 + 256*240
//     = 65,536, the whole register file), each owning 64 query rows.  Step
//     i issues S_i = Q K_i^T (wgmma m64n64k16, Q and K both read from
//     shared memory, K-major, D/16 k-steps) and O += P_{i-1} V_{i-1}
//     (wgmma m64nDk16 with P in registers as the A operand and the V tile,
//     (key, d) with d contiguous, read MN-major through the transpose
//     bit), waits for S_i alone, and runs the softmax of tile i while the
//     P V product is still in flight.  The two consumers take turns to
//     issue (two named barriers, "ping-pong"), so that one's softmax
//     overlaps the other's products.
//
// The softmax works on the f32 accumulator fragments: the scale, the
// softcap (an exp2 form of tanh, about 2e-7 absolute: tanh.approx's 2^-11
// relative error times a cap of 50 would move a score by 2e-2), the masks
// (only on tiles that cross the diagonal, the window's lower edge or Skv)
// and the online update of m and l.  A row of the accumulator lies on the
// 4 threads of a quad, so its max and sum take two shuffles.  P is then
// split in registers into two bf16 terms, P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), in the A-operand layout of the next product, which is
// the accumulator's, and P V is issued as P_hi V + P_lo V into the same
// accumulator.  O (64 x D in f32, 128 registers a thread at D = 256)
// stays in registers until the epilogue divides by l and stores bf16,
// masking rows >= Sq.  Nothing but wgmma may write a wgmma's registers
// between its fence and its wait, or ptxas serialises every product of
// the kernel: O is rescaled before the fence, P_hi and P_lo are packed
// after the wait, and the warpgroup's index comes through a shuffle so
// that the descriptors stay in uniform registers.
//
// Tiles are loaded by a 3-D tensor map over (D, S, batch * heads), so the
// rows of a ragged tile past S are zero-filled by the hardware rather
// than read from the next head, with the 128-byte swizzle that wgmma's
// descriptors name: a 64-column (128-byte) slice of 64 rows is one 8 KB
// box, and a row of D = 256 is four of them.  Head dims below 64 (D = 32)
// are loaded as 64 columns whose upper half the TMA fills with zeros, and
// computed at 64.  Shared memory at D = 256: Q 64 KB, K and V 2 x 32 KB
// each, 192 KB in all, opted in with cudaFuncSetAttribute.
//
// KV tiles outside the block's causal/window band are never loaded; both
// consumers take every tile the block loads (their turns must match), and
// a tile masked for a whole row of one of them changes nothing (the
// argument of flash_attention.cu: it adds p = 0 after the row's first
// valid key and is wiped by corr = exp(-1e30 - m) = 0 before it).  Query
// blocks run heaviest first.
//
// Numerics: the plain version and JAX keep P and P.V in f32.  One bf16
// term would leave a relative error of about 2^-9 a weight; P_hi + P_lo
// leaves about 2^-17 (V is bf16 already, and exact), at the cost of a
// second P.V product, half again of the tensor-core work.  The scale is
// applied to S in f32, as in the Pallas kernel; the model's op passes 1.0
// and scales q in bf16 itself, as JAX's model does.  l sums the
// unrounded f32 weights.
//
// Not done here, and left to later work: a persistent schedule over the
// tiles, clusters with TMA multicast of K and V, and fp8.
//
// libcuda's cuTensorMapEncodeTiled is fetched at run time through
// cudaGetDriverEntryPoint(ByVersion), so the library links against the
// CUDA runtime alone, with the same nvcc flags as the other kernels.
//
// Plain C interface, bound with ctypes
// (src/repro_torch/kernels/flash_attention.py): flash_attention_bf16
// launches on the given stream and returns the first CUDA error, 0, or
// 1000 + the CUresult if a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;           // query rows per block, 64 per consumer
constexpr int kBK = 64;            // keys per KV tile
constexpr int kStages = 2;         // KV tiles in flight
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBox = 64;           // a TMA box: 64 columns x 64 rows
constexpr int kBoxBytes = kBox * kBox * 2;   // 8 KB, 128 bytes a row
constexpr int kEmptyArrivals = 8;  // one per consumer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for a padded head dim DP (64, 128 or 256): each
// tile is DP / 64 boxes of 8 KB (columns 64c..64c+63 of 64 rows).
template <int DP>
struct Layout {
  static_assert(DP == 64 || DP == 128 || DP == 256, "DP is 64, 128 or 256");
  static constexpr int kBoxes = DP / kBox;
  static constexpr int kTile = kBoxes * kBoxBytes;      // 64 rows x DP
  static constexpr int kQ = 0;                          // 2 tiles
  static constexpr int kK = 2 * kTile;                  // kStages tiles
  static constexpr int kV = kK + kStages * kTile;       // kStages tiles
  static constexpr int kBar = kV + kStages * kTile;     // q, 4 per stage
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;       // base aligned up
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One lane of the warp (elected, so that no branch is taken) arrives on
// an mbarrier.
__device__ __forceinline__ void mbar_arrive_one(uint32_t bar) {
  asm volatile(
      "{\n.reg .b32 rx;\n.reg .pred px;\nelect.sync rx|px, %1;\n"
      "@px mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(0xffffffffu)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle (layout type
// 1): start address, leading and stride byte offsets, each in 16-byte
// units.  K-major tiles (q, k): the stride offset is 1 KB (8 rows of 128
// bytes); the leading offset is unused.  MN-major tiles (v): the leading
// offset steps to the next 64 columns (the next 8 KB box), the stride
// offset to the next 8 keys (1 KB).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 over the two consumer warpgroups (256 threads):
// a warpgroup waits on its own, and arrives on the other's.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving accesses to wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of a wgmma: d[i], d[i + 1], ...
#define FA_D4(i) \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define FA_D16(i) FA_D4(i), FA_D4((i) + 4), FA_D4((i) + 8), FA_D4((i) + 12)
#define FA_D32(i) FA_D16(i), FA_D16((i) + 16)
#define FA_D64(i) FA_D32(i), FA_D32((i) + 32)
#define FA_D128(i) FA_D64(i), FA_D64((i) + 64)

// D (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), A and B in shared
// memory, both K-major; D is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                             uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n "
      : FA_D32(0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers a[o..o+3]) *
// B (16 x 64); B in shared memory, MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[16], int o,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n "
      : FA_D32(0)
      : "r"(a[o]), "r"(a[o + 1]), "r"(a[o + 2]), "r"(a[o + 3]),
        "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers a[o..o+3]) *
// B (16 x 128); B in shared memory, MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[16], int o,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n "
      : FA_D64(0)
      : "r"(a[o]), "r"(a[o + 1]), "r"(a[o + 2]), "r"(a[o + 3]),
        "l"(desc_b), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 in registers a[o..o+3]) *
// B (16 x 256); B in shared memory, MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[16], int o,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, "
      "0;\nwgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n "
      : FA_D128(0)
      : "r"(a[o]), "r"(a[o + 1]), "r"(a[o + 2]), "r"(a[o + 3]),
        "l"(desc_b), "r"(1));
}


template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[16], int o,
                                         uint64_t desc_b) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, o, desc_b);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(d, a, o, desc_b);
  } else {
    wgmma_rs_n256(d, a, o, desc_b);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (exp(2y) + 1), with |y| clamped at 10, where tanh is
// 1 in f32.  About 2e-7 absolute error (ex2 and rcp are within 2 ulp).
__device__ __forceinline__ float tanh_exp2(float y) {
  y = fminf(fmaxf(y, -10.f), 10.f);
  return 1.f - 2.f * rcp(ex2(y * (2.f * kLog2e)) + 1.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The steps of a consumer, and the kernel.  D is the head dim, DP the
// padded one the tiles hold.
// ---------------------------------------------------------------------------

// The scale, the softcap (kCap), the masks (only where `edge`: a tile that
// crosses the diagonal, the window's lower edge or Skv) and the online
// softmax of one 64 x 64 tile of scores in the wgmma accumulator layout:
// updates m and l, sets corr = exp(m_old - m_new) for each of the thread's
// two rows, and leaves P = exp(S - m) in f32 in place of S.
template <bool kCap>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[32], float& m0, float& m1, float& l0, float& l1,
    float& corr0, float& corr1, bool edge, int k0, int col, int qpos0,
    int causal, int window, int Skv, float cap, float inv_cap, float scale) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float x = sc[j] * scale;
    if constexpr (kCap) x = cap * tanh_exp2(x * inv_cap);
    if (edge) {
      const int kpos = k0 + 8 * (j / 4) + col + (j & 1);
      const int qpos = qpos0 + ((j & 2) ? 8 : 0);
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (!ok) x = kNegInf;
    }
    sc[j] = x;
    if (j & 2) {
      mx1 = fmaxf(mx1, x);
    } else {
      mx0 = fmaxf(mx0, x);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  corr0 = ex2((m0 - mn0) * kLog2e);
  corr1 = ex2((m1 - mn1) * kLog2e);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const float mref = (j & 2) ? mn1 : mn0;
    const float p0 = ex2((sc[j] - mref) * kLog2e);
    const float p1 = ex2((sc[j + 1] - mref) * kLog2e);
    if (j & 2) {
      sum1 += p0 + p1;
    } else {
      sum0 += p0 + p1;
    }
    sc[j] = p0;
    sc[j + 1] = p1;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
}

// P = P_hi + P_lo, both bf16, in the register A layout of the P V
// product: the accumulator's layout, two columns a register.
__device__ __forceinline__ void pack_p(const float (&sc)[32],
                                       uint32_t (&pa)[16],
                                       uint32_t (&pl)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
    pa[j] = *reinterpret_cast<const uint32_t*>(&hi);
    pl[j] = pack_bf16(sc[2 * j] - __low2float(hi),
                      sc[2 * j + 1] - __high2float(hi));
  }
}

// S = Q K^T for one warpgroup's 64 rows and a tile of 64 keys: D/16
// k-steps, +32 bytes a step inside a 128-byte swizzled row, +8 KB to the
// next 64 columns.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint32_t off = (kc / 4) * kBoxBytes + (kc % 4) * 32;
    wgmma_ss_n64(sc, smem_desc(q_tile + off, 16, 1024),
                 smem_desc(k_tile + off, 16, 1024), kc > 0);
  }
}

// O += P_hi V + P_lo V: 4 k-steps of 16 keys (2 KB of the V tile each),
// two products a step into the same accumulator.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&pa)[16],
                                         const uint32_t (&pl)[16],
                                         uint32_t v_tile) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t desc = smem_desc(v_tile + 2048 * s, kBoxBytes, 1024);
    wgmma_rs<DP>(acc, pa, 4 * s, desc);
    wgmma_rs<DP>(acc, pl, 4 * s, desc);
  }
}

template <int D, int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                __nv_bfloat16* __restrict__ o, int H, int KV,
                                int Sq, int Skv, int causal, int window,
                                float cap, float scale) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle repeats every 1 KB: tiles start on 1 KB boundaries.
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  // Barriers: q, then for K and for V a full and an empty one a stage.
  const uint32_t q_bar = base + L::kBar;
  const auto k_full = [&](int s) { return q_bar + 8 * (1 + s); };
  const auto k_empty = [&](int s) { return q_bar + 8 * (1 + kStages + s); };
  const auto v_full = [&](int s) {
    return q_bar + 8 * (1 + 2 * kStages + s);
  };
  const auto v_empty = [&](int s) {
    return q_bar + 8 * (1 + 3 * kStages + s);
  };

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * kBQ;

  // The KV range any row of this block can see, in whole tiles.
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kEmptyArrivals);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every load, K and V of a tile each on
    // its own barrier (a K buffer is released a step before its V).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * L::kTile);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(base + L::kQ + w * L::kTile + c * kBoxBytes, &qmap, q_bar,
                   c * kBox, q0 + 64 * w, b * H + h);
      const int kvh = b * KV + h / (H / KV);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = k_begin + i * kBK;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::kTile);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(base + L::kK + s * L::kTile + c * kBoxBytes, &kmap,
                   k_full(s), c * kBox, k0, kvh);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::kTile);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(base + L::kV + s * L::kTile + c * kBoxBytes, &vmap,
                   v_full(s), c * kBox, k0, kvh);
      }
    }
    return;
  }

  // Consumers: warpgroup 1 owns rows q0..q0+63, warpgroup 2 the next 64.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // The warpgroup's index through a shuffle, which the compiler knows to
  // be uniform across the warp: the descriptors derived from it stay in
  // uniform registers, and the wgmma pipeline is not serialised on them.
  const int cw = __shfl_sync(0xffffffffu, wg - 1, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // This thread's two rows of the wgmma fragments (r0, r0 + 8) and the
  // first of its two columns in each group of 8.
  const int r0 = (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int qw = q0 + 64 * cw;
  const int qpos0 = qw + r0;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const uint32_t q_tile = base + L::kQ + cw * L::kTile;
  // Ping-pong: a warpgroup issues its products between waiting on its own
  // named barrier and arriving on the other's, so that one warpgroup's
  // softmax runs while the other's products hold the tensor cores.
  const int my_turn = 1 + cw;
  const int other_turn = 2 - cw;
  const auto edge = [&](int k0) {
    return (causal && k0 + kBK - 1 > qw) ||
           (window > 0 && k0 < qw + 64 - window) || k0 + kBK > Skv;
  };

  float acc[DP / 2];
  float sc[32];
  uint32_t pa[16], pl[16];   // P_hi, P_lo
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float corr0 = 1.f, corr1 = 1.f;

  if (tiles > 0) {
    if (cw == 1) named_arrive(1);  // warpgroup 1 goes first
    mbar_wait(q_bar, 0);

    // Tile 0: S_0 = Q K_0^T and its softmax.
    mbar_wait(k_full(0), 0);
    named_sync(my_turn);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, q_tile, base + L::kK);
    wgmma_commit();
    named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive_one(k_empty(0));
    softmax_tile<kCap>(sc, m0, m1, l0, l1, corr0, corr1, edge(k_begin),
                       k_begin, col, qpos0, causal, window, Skv, cap,
                       inv_cap, scale);
    pack_p(sc, pa, pl);

    // Tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} issued together; the
    // softmax of tile i runs while the second product is in flight.
    for (int i = 1; i < tiles; ++i) {
      const int s = i % kStages;
      const int sp = (i - 1) % kStages;
      const int k0 = k_begin + i * kBK;
      // O = O * corr_{i-1} before the pipeline stage opens: nothing but
      // wgmma may write a wgmma's registers between its fence and its wait.
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= (j & 2) ? corr1 : corr0;
      mbar_wait(v_full(sp), ((i - 1) / kStages) & 1);
      mbar_wait(k_full(s), (i / kStages) & 1);
      named_sync(my_turn);
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      issue_qk<D>(sc, q_tile, base + L::kK + s * L::kTile);
      wgmma_commit();
      issue_pv<DP>(acc, pa, pl, base + L::kV + sp * L::kTile);
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait<1>();  // S_i is ready; P V may still run
      fence_regs(sc);
      mbar_arrive_one(k_empty(s));
      softmax_tile<kCap>(sc, m0, m1, l0, l1, corr0, corr1,
                         edge(k0), k0, col, qpos0, causal, window, Skv, cap,
                         inv_cap, scale);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_one(v_empty(sp));
      pack_p(sc, pa, pl);
    }

    // The last P V.
    const int sp = (tiles - 1) % kStages;
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] *= (j & 2) ? corr1 : corr0;
    mbar_wait(v_full(sp), ((tiles - 1) / kStages) & 1);
    named_sync(my_turn);
    fence_regs(acc);
    wgmma_fence();
    issue_pv<DP>(acc, pa, pl, base + L::kV + sp * L::kTile);
    wgmma_commit();
    if (cw == 0) named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_one(v_empty(sp));
  }

  // Epilogue: O / max(l, 1e-30) in bf16, rows >= Sq left out.
  __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * H + h) * Sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qpos0 + 8 * half;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<int64_t>(qpos) * D + col;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (8 * n < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * half] * inv,
                                  acc[4 * n + 2 * half + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over `planes` contiguous (S, D) bf16 matrices: boxes of 64
// columns by 64 rows with the 128-byte swizzle; what lies outside the
// tensor (rows past S, columns past D) is read as zero.
int encode(CUtensorMap* map, const void* ptr, int D, int S, int planes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1000 + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {kBox, kBox, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int Sq, int Skv, int causal, int window,
             float cap, float scale, cudaStream_t stream) {
  constexpr int DP = D < kBox ? kBox : D;
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, D, Sq, B * H);
  if (err == 0) err = encode(&km, k, D, Skv, B * KV);
  if (err == 0) err = encode(&vm, v, D, Skv, B * KV);
  if (err != 0) return err;
  auto kernel = cap > 0.f ? flash_attention_sm90_kernel<D, DP, true>
                          : flash_attention_sm90_kernel<D, DP, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<DP>::kAlloc));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ), H, B);
  kernel<<<grid, kThreads, Layout<DP>::kAlloc, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), H, KV, Sq, Skv, causal,
      window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int KV, int Sq, int Skv,
                         int D, int causal, int window, float cap,
                         float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Skv == 0) {  // no key at all: every row is 0, as in the plain version
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * H * Sq * D * 2, st));
  }
  switch (D) {
    case 32:
      return launch_d<32>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, cap,
                          scale, st);
    case 64:
      return launch_d<64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, cap,
                          scale, st);
    case 128:
      return launch_d<128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                           cap, scale, st);
    case 256:
      return launch_d<256>(q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                           cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
