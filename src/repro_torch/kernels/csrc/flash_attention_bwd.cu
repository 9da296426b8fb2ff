// The backward of blockwise flash attention (dQ, dK, dV) on Hopper's
// tensor cores: bf16 wgmma products, and 3xTF32 wgmma products for f32,
// fed by TMA; the dK/dV work split over the query heads of a KV head and
// summed in a fixed order.  Head dims 32, 64, 128 and 256.
//
// Replaces no Pallas kernel: the Pallas kernel
// src/repro/kernels/flash_attention.py::_fa_kernel has no backward, and
// the JAX package trains through jax.value_and_grad of the chunked jnp
// attention (src/repro/models/attention.py:32), the function that kernel
// computes.  This file computes that gradient from the forward's row
// statistics (lse = m + log l, written by flash_attention.cu and
// flash_attention_sm90.cu), for query head h of batch b and its KV head
// h / G (G = H / KV):
//
//   s[q,k]  = (q[q,:] * scale) . k[k,:]                   f32 sums
//   t       = tanh(s / cap), s = cap * t                  if cap > 0
//   P[q,k]  = exp(s - lse[q]) where k < Skv, k <= q (causal) and
//             k > q - window (window > 0), 0 elsewhere
//   Delta[q] = sum_d dO[q,d] O[q,d]
//   dP      = dO V^T
//   dS      = P * (dP - Delta) * (1 - t^2)                (1 - t^2: cap > 0)
//   dV[k,:] = sum_g sum_q P[q,k] dO[q,:]
//   dK[k,:] = sum_g sum_q dS[q,k] (q[q,:] * scale)
//   dQ[q,:] = scale * sum_k dS[q,k] k[k,:]
//
// dq, dk and dv are written in the input dtype.  The plain version is
// src/repro_torch/kernels/ref.py::flash_attention_bwd_ref.
//
// What bounds it: operations.  The gradient takes five products of 2 * D
// operations a kept (q, k) pair (S, dP, dV, dK, dQ).  At Qwen2.5-3B's
// training shape (B=1, H=16, KV=2, S=4,096, D=128, causal) that is 171.8
// GFLOP: 0.174 ms at the H100's 989 TFLOP/s of dense bf16, 1.04 ms as
// three TF32 passes at 495 TFLOP/s (f32 accuracy), 2.56 ms on the CUDA
// cores.  This design computes S and dP twice (once for dK/dV, once for
// dQ), seven products in all, so that no sum crosses blocks in an order
// that could change.
//
// Arithmetic.  bf16: q, k, v and dO go to wgmma as they are, every product
// accumulates in f32, and P and dS are rounded to bf16 once, in registers,
// as the A operands of dV, dK and dQ (the gradients are rounded to bf16
// anyway; tests/test_torch_flash_bwd_arith.py emulates this and holds it
// within chip_smoke.py's BWD_TOL).  f32: 3xTF32, as in flash_attention.cu:
// every operand is split as x = hi + lo, both TF32 values (bit masks,
// round to nearest, ties away), and each product runs as hi.hi + hi.lo +
// lo.hi.  A split pass writes the halves of q * scale, k, v and dO, and of
// the transposes the products need (q * scale, dO and k with d as rows,
// the 8 positions of each group stored in the order 0 2 4 6 1 3 5 7 so
// that an accumulator's columns are the register A operand's, as V^T in
// flash_attention.cu), into a workspace the wrapper allocates; P and dS
// are split in registers.  S and dP keep the hi.hi pass and the two
// correction passes in separate accumulators (at D = 256 the hi.hi pass a
// chunk of 32 columns of d at a time, each chunk added in f32), and dK, dV
// and dQ take a tile's contribution in pieces of 32 or 64 columns, each
// from zero, added to plain f32 registers: the tensor cores' accumulation
// does not round to nearest and drifts over long runs (the note in
// flash_attention.cu).
//
// Design.  Four launches on the given stream (f32 first runs the split
// pass), every tile loaded by TMA with the 128-byte swizzle that the wgmma
// descriptors name, and each product kernel warp-specialised: one thread
// of a producer warpgroup (or warp) issues the loads into a ring of
// stages with "full" and "empty" mbarriers, and consumer warpgroups run
// wgmma.
//
//   1. Delta: one warp a row, sum_d dO O in f32 (a fixed shuffle tree).
//   2. dK/dV: one block per (key tile, KV head, query head g, batch), the
//      key tiles that see the most queries launched first, so that a KV
//      head's G query heads fill the card (Qwen2.5-3B: 8 x 2 x the key
//      tiles, where one block a KV head gave 128 blocks).  K and V of the
//      tile stay in shared memory; head g's query tiles that see it stream
//      past.  Each block writes its head's dK and dV to an f32 workspace
//      of G partials.  Two layouts:
//        - bf16, D <= 128: 128 keys, 64 for each of two consumer
//          warpgroups, which read the same (q, dO) tiles (3 stages) and
//          each compute S^T = K q^T and dP^T = V dO^T, P^T and dS^T, and
//          dV += P^T dO, dK += dS^T q in registers; the tile's lse and
//          Delta come into the stage from the producer warpgroup's
//          threads; the consumers take turns to issue (named barriers);
//        - bf16, D = 256 (dK and dV would not fit in one warpgroup's
//          registers) and f32: 64 keys; warpgroup 0 computes
//          S^T and P^T, hands P^T (1 - t^2) to warpgroup 1 through shared
//          memory (two named barriers) and accumulates dV; warpgroup 1
//          computes dP^T, dS^T and dK.  Both issue the same wgmma sequence
//          on other tiles, so no wgmma sits in a branch.  f32 streams
//          32-query tiles through a ring of its own for each warpgroup: q
//          chunks and dO^T pieces for warpgroup 0, dO chunks and q^T
//          pieces for warpgroup 1; at D = 256 the lo halves of K and V
//          come with the q and dO chunks instead of staying resident.
//   3. dQ: one block per (query tile, head, batch), heaviest first, q and
//      dO of its tile in shared memory, K and V streamed: S and dP again,
//      dS in registers, dQ += dS K; scaled once at the end.  bf16: two
//      consumer warpgroups of 64 rows (one at D = 256); below D = 256
//      tile i's S and dP are issued with tile i - 1's dQ product, so that
//      the scores run while it is in flight, and the consumers take turns
//      to issue.  f32: one consumer warpgroup; at D = 256 32-key tiles,
//      the lo halves of q and dO coming with the K and V chunks.
//   4. The G partials of dK and dV summed in the order g = 0, 1, ..., in
//      f32, and written in the output dtype.
//
// No atomics: every output element is written once, by one thread, and
// the partials meet in a fixed order, so the gradients are bitwise the
// same run to run.  The product kernels with two consumer warpgroups give
// the producer's registers to them (setmaxnreg 24 or 40 against 240 or
// 232).
//
// Tiles and shared memory (bf16's D = 32 runs at 64, its upper columns
// zero-filled by the TMA).  bf16 dK/dV: K and V of 128 keys and 3 stages
// of (q, dO, lse, Delta) of 64 queries, 161.5 KB at D = 128; at D = 256,
// 64 keys, 2 stages and a 16 KB exchange, 208 KB.  bf16 dQ: q and dO of
// 128 rows and 3 stages of (K, V) of 64 keys, 160 KB at D = 128; 64 rows
// and 2 stages at D = 256, 192 KB.  f32 dK/dV (D = 32, 64, 128): K and V
// hi and lo of 64 keys (128 KB at D = 128), two rings of 4 slots of 8 KB
// and an 8 KB exchange, 200 KB; f32 dQ: q and dO hi and lo of 64 rows
// (128 KB) and 4 slots of 16 KB for K, V and K^T, 192 KB.  At D = 256 the
// f32 operands' hi and lo halves together would not fit (K and V alone
// 256 KB of the 227 KB a block may use): only the hi halves stay (128 KB),
// and each chunk of a lo half comes through the ring with the chunk it
// multiplies, in slots of 16 KB (two a ring in dK/dV, 200 KB; four in dQ,
// 192 KB), at the price of reading those lo halves once a tile.  The
// gradient accumulators stay in registers: 64 x D f32 a warpgroup for
// each of dK and dV (bf16, D <= 128), dK or dV (the split layouts), or
// dQ.
//
// libcuda's cuTensorMapEncodeTiled is fetched at run time through
// cudaGetDriverEntryPoint(ByVersion), so the library links against the
// CUDA runtime alone.
//
// Plain C interface, bound with ctypes
// (src/repro_torch/kernels/flash_attention.py): flash_attention_bwd_f32
// and flash_attention_bwd_bf16 launch the kernels and return the first
// CUDA error, 0, or 1000 + the CUresult if a tensor map cannot be
// encoded.  `work` is an f32 workspace the wrapper allocates
// (`bwd_workspace_floats` there), carved in this order, each piece
// rounded up to 64 floats: Delta (B, H, Sq); the dK partials (G, B, KV,
// Skv, D) and the dV partials; for f32 then the hi and lo
// halves of q * scale and of dO (B, H, Sq, D), of (q * scale)^T and dO^T
// (B, H, D, Sq rounded up to 8), of k and v (B, KV, Skv, D) and of k^T
// (B, KV, D, Skv rounded up to 8).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;            // keys a dK/dV block, keys a dQ tile
constexpr int kBoxBytes = 8192;    // a TMA box: 64 bf16 or 32 f32 x 64 rows
constexpr int kKvThreads = 384;   // dK/dV: two consumer + a producer warpgroup
constexpr int kXFull = 1;          // named barriers of the P exchange
constexpr int kXEmpty = 2;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma (as in flash_attention.cu and
// flash_attention_sm90.cu).
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

// This thread arrives on an mbarrier (release: its shared-memory stores
// are seen by a thread whose wait completes the phase).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// Named barriers over the two consumer warpgroups (256 threads): one
// warpgroup arrives, the other waits.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle (layout type
// 1): start address, leading and stride byte offsets, each in 16-byte
// units.  K-major tiles: the stride offset is 1 KB (8 rows of 128 bytes);
// the leading offset is unused.  MN-major bf16 tiles (read through the
// transpose bit): the leading offset steps to the next 64 columns (the
// next 8 KB box), the stride offset to the next 8 rows (1 KB).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// A K-major descriptor (32-bit operands: 32 values a 128-byte row).
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
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

// Keep the compiler from moving accesses to wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of a wgmma, d[i], d[i + 1], ..., read and
// written ("+f") or only written ("=f"): a product that starts from zero
// leaves the registers' old values dead.
#define FB_D4(c, i) c(d[(i)]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3])
#define FB_D8(c, i) FB_D4(c, i), FB_D4(c, (i) + 4)
#define FB_D16(c, i) FB_D8(c, i), FB_D8(c, (i) + 8)
#define FB_D32(c, i) FB_D16(c, i), FB_D16(c, (i) + 16)
#define FB_D64(c, i) FB_D32(c, i), FB_D32(c, (i) + 32)
#define FB_D128(c, i) FB_D64(c, i), FB_D64(c, (i) + 64)
#define FB_RW(x) "+f"(x)
#define FB_W(x) "=f"(x)

// bf16: D (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), A and B in shared
// memory, both K-major; D is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FB_D32(FB_RW, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// bf16: D (64 x N, f32) += A (64 x 16, in registers a[o..o+3]) * B (16 x
// N); B in shared memory, MN-major (N contiguous, the transpose bit).
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[16], int o,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FB_D32(FB_RW, 0)
      : "r"(a[o]), "r"(a[o + 1]), "r"(a[o + 2]), "r"(a[o + 3]),
        "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64],
                                              const uint32_t (&a)[16], int o,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FB_D64(FB_RW, 0)
      : "r"(a[o]), "r"(a[o + 1]), "r"(a[o + 2]), "r"(a[o + 3]),
        "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[128],
                                              const uint32_t (&a)[16], int o,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
      "%101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, "
      "1, 1;\n}\n"
      : FB_D128(FB_RW, 0)
      : "r"(a[o]), "r"(a[o + 1]), "r"(a[o + 2]), "r"(a[o + 3]),
        "l"(desc_b), "r"(1));
}

// TF32: D (64 x N, f32) (+)= A (64 x 8) * B (8 x N), A and B in shared
// memory, both K-major (no transpose bit for 32-bit operands), N = 32 or
// 64; D is overwritten unless kAcc.
#define FB_SS_N32(C, ACC)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, "   \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "    \
      "%17, p, 1, 1;\n}\n"                                                   \
      : FB_D16(C, 0)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(ACC))
#define FB_SS_N64(C, ACC)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "   \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "   \
      "%31}, %32, %33, p, 1, 1;\n}\n"                                        \
      : FB_D32(C, 0)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(ACC))

template <bool kAcc>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t desc_a,
                                              uint64_t desc_b) {
  if constexpr (kAcc) {
    FB_SS_N32(FB_RW, 1);
  } else {
    FB_SS_N32(FB_W, 0);
  }
}

template <bool kAcc>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b) {
  if constexpr (kAcc) {
    FB_SS_N64(FB_RW, 1);
  } else {
    FB_SS_N64(FB_W, 0);
  }
}

// TF32: D (64 x N, f32) (+)= A (64 x 8, in registers a0..a3) * B (8 x N),
// B in shared memory, K-major, N = 32 or 64; D is overwritten unless kAcc.
#define FB_RS_N32(C, ACC)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, "   \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "         \
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"                            \
      : FB_D16(C, 0)                                                         \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(ACC))
#define FB_RS_N64(C, ACC)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "   \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "   \
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"                      \
      : FB_D32(C, 0)                                                         \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(ACC))

template <bool kAcc>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  if constexpr (kAcc) {
    FB_RS_N32(FB_RW, 1);
  } else {
    FB_RS_N32(FB_W, 0);
  }
}

template <bool kAcc>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t desc_b) {
  if constexpr (kAcc) {
    FB_RS_N64(FB_RW, 1);
  } else {
    FB_RS_N64(FB_W, 0);
  }
}

// ---------------------------------------------------------------------------
// Arithmetic helpers.
// ---------------------------------------------------------------------------

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

// Round to TF32, to nearest with ties away from zero: clear the low 13
// bits of the f32 after adding half of their range.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Whether query qry sees key `key`.
__device__ __forceinline__ bool kept(int qry, int key, int Sq, int Skv,
                                     int causal, int window) {
  bool ok = qry < Sq && key < Skv;
  if (causal) ok = ok && key <= qry;
  if (window > 0) ok = ok && key > qry - window;
  return ok;
}

// P = exp(s - l) of one product x = q.k * scale after the softcap, or 0
// where the pair is masked; dt = 1 - tanh^2 under the cap, else 1.
template <bool kCap>
__device__ __forceinline__ float prob(float x, float l, bool ok, float cap,
                                      float inv_cap, float& dt) {
  if constexpr (kCap) {
    const float t = tanh_exp2(x * inv_cap);
    x = cap * t;
    dt = 1.f - t * t;
  } else {
    dt = 1.f;
  }
  return ok ? ex2((x - l) * kLog2e) : 0.f;
}

// A row's lse or Delta, 0 past Sq.
__device__ __forceinline__ float row_value(const float* __restrict__ x,
                                           int64_t row0, int qry, int Sq) {
  return qry < Sq ? __ldg(x + row0 + qry) : 0.f;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Small passes: Delta, the TF32 split, the sum of the partials.
// ---------------------------------------------------------------------------

// Delta = rowsum(dO * O), one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta,
                                     int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 a = load4(o + row * D + c);
    const float4 b = load4(dout + row * D + c);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// hi = tf32(x * scale), lo = tf32(x * scale - hi), four floats a thread.
__global__ void flash_attention_bwd_split_kernel(const float4* __restrict__ x,
                                                 float4* __restrict__ hi,
                                                 float4* __restrict__ lo,
                                                 int64_t n4, float scale) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 a = x[i];
    const float e[4] = {a.x * scale, a.y * scale, a.z * scale, a.w * scale};
    float h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = tf32_rna(e[j]);
      l[j] = tf32_rna(e[j] - h[j]);
    }
    hi[i] = make_float4(h[0], h[1], h[2], h[3]);
    lo[i] = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// x * scale (planes, S, D) -> hi and lo of its transpose (planes, D, S8),
// S8 = S rounded up to 8 (zero past S), the positions of each group of 8
// stored in the order 0 2 4 6 1 3 5 7.  A block transposes 32 rows x 32
// columns through shared memory.
__global__ void flash_attention_bwd_split_transpose_kernel(
    const float* __restrict__ x, float* __restrict__ hi,
    float* __restrict__ lo, int S, int S8, int D, float scale) {
  __shared__ float tile[32][33];
  const int s0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int64_t plane = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r;
    tile[r][tx] = s < S ? x[(plane * S + s) * D + d0 + tx] * scale : 0.f;
  }
  __syncthreads();
  const int pos = s0 + tx;                   // position in the stored row
  const int kap = tx & 7;
  const int src = (tx & ~7) + (kap < 4 ? 2 * kap : 2 * (kap - 4) + 1);
  if (pos >= S8) return;
  for (int r = ty; r < 32; r += 8) {
    const float v = tile[src][r];
    const float h = tf32_rna(v);
    const int64_t at = (plane * D + d0 + r) * S8 + pos;
    hi[at] = h;
    lo[at] = tf32_rna(v - h);
  }
}

// dk and dv from the G partials of each (dK first, then dV, each G
// blocks of n4 float4), summed in the order g = 0, 1, ..., G - 1.
template <typename T>
__global__ void flash_attention_bwd_reduce_kernel(
    const float4* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
    int64_t n4, int G) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < 2 * n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int which = i >= n4;
    const int64_t j = i - which * n4;
    const float4* p = part + which * G * n4 + j;
    float4 s = p[0];
    for (int g = 1; g < G; ++g) {
      const float4 x = p[g * n4];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    store4((which ? dv : dk) + 4 * j, s);
  }
}

// ---------------------------------------------------------------------------
// bf16: dK/dV and dQ on bf16 wgmma.  Tiles of 64 rows x DP columns (DP =
// D, or 64 for D = 32), in boxes of 64 columns with the 128-byte swizzle.
// ---------------------------------------------------------------------------

// S = A B^T for 64 rows of A and 64 of B, both K-major tiles: D/16 k-steps,
// +32 bytes a step inside a 128-byte swizzled row, +8 KB to the next 64
// columns.
template <int D>
__device__ __forceinline__ void bf16_nt(float (&sc)[32], uint32_t a_tile,
                                        uint32_t b_tile) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint32_t off = (kc / 4) * kBoxBytes + (kc % 4) * 32;
    wgmma_bf16_ss(sc, kdesc(a_tile + off), kdesc(b_tile + off), kc > 0);
  }
}

// acc += A B, A (64 x 64) the bf16 registers `a` in the accumulator's
// layout (two columns a register), B a 64-row tile read MN-major: 4
// k-steps of 16 rows (2 KB of the tile each).
template <int DP>
__device__ __forceinline__ void bf16_nn(float (&acc)[DP / 2],
                                        const uint32_t (&a)[16],
                                        uint32_t b_tile) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_bf16_rs(acc, a, 4 * s,
                  smem_desc(b_tile + 2048 * s, kBoxBytes, 1024));
}

// dK/dV for D <= 128: a block takes 128 keys, 64 a consumer warpgroup,
// both consumers reading the same stream of (q, dO) tiles, so that each
// tile loaded serves twice the keys.  Each warpgroup computes S^T and dP^T
// of its keys, P and dS, and keeps its dK and dV in registers (128 a
// thread at D = 128).  The producer warpgroup's threads also copy the
// tile's lse and Delta into the stage, so that no consumer register holds
// them across a product.  The two consumers take turns to issue (named
// barriers 1 and 2, as in flash_attention_sm90.cu), so that one's scores
// run while the other's products hold the tensor cores.
template <int DP>
struct Bf16Kv128 {
  static constexpr int kStages = 3;
  static constexpr int kTile = DP / 64 * kBoxBytes;   // 64 rows x DP
  static constexpr int kK = 0;                        // 2 tiles of K
  static constexpr int kV = 2 * kTile;                // 2 tiles of V
  static constexpr int kRing = 4 * kTile;             // stages of (q, dO)
  static constexpr int kRows = kRing + 2 * kStages * kTile;   // lse, Delta
  static constexpr int kBar = kRows + kStages * 2 * 64 * 4;
  static constexpr size_t kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int DP, bool kCap>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_attention_bwd_dkdv128_bf16_kernel(
        const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __grid_constant__ CUtensorMap omap,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ part, int64_t nkv, int H, int KV, int Sq,
        int Skv, int causal, int window, float cap, float scale) {
  using L = Bf16Kv128<DP>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t kv_bar = base + L::kBar;
  const auto full = [&](int i) { return kv_bar + 8 * (1 + i % kStages); };
  const auto empty = [&](int i) {
    return kv_bar + 8 * (1 + kStages + i % kStages);
  };
  // Tile i's stage: q at +0, dO at +kTile; its 64 lse and 64 Delta
  // values in rows_s.
  const auto stage = [&](int i) {
    return base + L::kRing + (i % kStages) * 2 * L::kTile;
  };
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base + L::kRows - raw));

  const int G = H / KV;
  const int g = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int h = (bkv % KV) * G + g;
  const int k0 = blockIdx.z * 2 * kBK;   // the causal heavy tiles come first
  const int kmax = min(k0 + 2 * kBK, Skv) - 1;
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(Sq, kmax + window) : Sq;
  const int tiles = i_end > i_begin ? (i_end - i_begin + 63) / 64 : 0;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 128);   // the TMA's bytes + each producer thread
      mbar_init(empty(s), 8);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: one thread loads K and V once and q and dO of each query
    // tile; every thread copies one of the tile's 64 lse or Delta values.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - 256;
    if (tiles > 0) {
      if (pt == 0) {
        mbar_expect_tx(kv_bar, 4 * L::kTile);
        for (int w = 0; w < 2; ++w)
          for (int c = 0; c < DP / 64; ++c) {
            tma_load(base + L::kK + w * L::kTile + c * kBoxBytes, &kmap,
                     kv_bar, 64 * c, k0 + 64 * w, bkv);
            tma_load(base + L::kV + w * L::kTile + c * kBoxBytes, &vmap,
                     kv_bar, 64 * c, k0 + 64 * w, bkv);
          }
      }
      for (int i = 0; i < tiles; ++i) {
        const int i0 = i_begin + 64 * i;
        mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect_tx(full(i), 2 * L::kTile);
          for (int c = 0; c < DP / 64; ++c) {
            tma_load(stage(i) + c * kBoxBytes, &qmap, full(i), 64 * c, i0,
                     b * H + h);
            tma_load(stage(i) + L::kTile + c * kBoxBytes, &omap, full(i),
                     64 * c, i0, b * H + h);
          }
        }
        rows_s[(i % kStages) * 128 + pt] =
            row_value(pt < 64 ? lse : delta, row0, i0 + pt % 64, Sq);
        mbar_arrive(full(i));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int key0 = k0 + 64 * wg + (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const uint32_t k_tile = base + L::kK + wg * L::kTile;
  const uint32_t v_tile = base + L::kV + wg * L::kTile;
  const int my_turn = 1 + wg;
  const int other_turn = 2 - wg;

  float acc_k[DP / 2], acc_v[DP / 2];
  float sc[32], dp[32];
  uint32_t pp[16], ps[16];   // P^T and dS^T in bf16
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc_k[j] = acc_v[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;

  if (tiles > 0) {
    if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
    mbar_wait(kv_bar, 0);
  }
  for (int i = 0; i < tiles; ++i) {
    const int i0 = i_begin + 64 * i;
    const uint32_t qt = stage(i);
    const float* lse_s = rows_s + (i % kStages) * 128;
    mbar_wait(full(i), (i / kStages) & 1);
    // S^T = K q^T and dP^T = V dO^T.
    named_sync(my_turn);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    bf16_nt<D>(sc, k_tile, qt);
    bf16_nt<D>(dp, v_tile, qt + L::kTile);
    wgmma_commit();
    named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // P^T and dS^T, packed two columns a register as they come.
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = j + e;
        const int key = key0 + ((jj & 2) ? 8 : 0);
        const int n = 8 * (jj / 4) + col + (jj & 1);
        float dt;
        const float p = prob<kCap>(sc[jj] * scale, lse_s[n],
                                   kept(i0 + n, key, Sq, Skv, causal, window),
                                   cap, inv_cap, dt);
        p2[e] = p;
        d2[e] = p * dt * (dp[jj] - lse_s[64 + n]);
      }
      pp[j / 2] = pack_bf16(p2[0], p2[1]);
      ps[j / 2] = pack_bf16(d2[0], d2[1]);
    }
    // dV += P^T dO and dK += dS^T q; the last turn of warpgroup 1 hands
    // nothing on.
    named_sync(my_turn);
    fence_regs(acc_k);
    fence_regs(acc_v);
    wgmma_fence();
    bf16_nn<DP>(acc_v, pp, qt + L::kTile);
    bf16_nn<DP>(acc_k, ps, qt);
    wgmma_commit();
    if (wg == 0 || i + 1 < tiles) named_arrive(other_turn);
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
    mbar_arrive_one(empty(i));
  }

  // This head's partials of the warpgroup's 64 keys.
  float* pk = part + g * nkv + static_cast<int64_t>(bkv) * Skv * D;
  float* pv = pk + G * nkv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= Skv) continue;
    const int64_t at = static_cast<int64_t>(key) * D + col;
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8)
      if (8 * n8 < D) {
        store2(pk + at + 8 * n8, acc_k[4 * n8 + 2 * half] * scale,
               acc_k[4 * n8 + 2 * half + 1] * scale);
        store2(pv + at + 8 * n8, acc_v[4 * n8 + 2 * half],
               acc_v[4 * n8 + 2 * half + 1]);
      }
  }
}

// dK/dV at D = 256, where one warpgroup's dK and dV (256 registers a
// thread) would not fit: a block takes 64 keys and splits the work between
// its consumers.  Warpgroup 0 computes S^T = K q^T and P^T, hands P^T (1 -
// t^2) to warpgroup 1 through shared memory (named barriers 1 and 2), and
// accumulates dV += P^T dO; warpgroup 1 computes dP^T = V dO^T and dS^T,
// and accumulates dK += dS^T q.  Both issue the same wgmma sequence on
// other tiles, so no wgmma sits in a branch.  One product at a time: with
// the next tile's product issued early the accumulators spilled and ran
// slower on the H100.
struct Bf16Kv256 {
  static constexpr int kStages = 2;              // (q, dO) in flight
  static constexpr int kTile = 4 * kBoxBytes;    // 64 rows x 256
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kX = kRing + 2 * kStages * kTile;   // 32 x 128 f32
  static constexpr int kBar = kX + 32 * 128 * 4;   // kv, full[], empty[]
  static constexpr size_t kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <bool kCap>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_attention_bwd_dkdv256_bf16_kernel(
        const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __grid_constant__ CUtensorMap omap,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ part, int64_t nkv, int H, int KV, int Sq,
        int Skv, int causal, int window, float cap, float scale) {
  using L = Bf16Kv256;
  constexpr int D = 256;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t kv_bar = base + L::kBar;
  const auto full = [&](int i) { return kv_bar + 8 * (1 + i % kStages); };
  const auto empty = [&](int i) {
    return kv_bar + 8 * (1 + kStages + i % kStages);
  };
  // Tile i's stage: q at +0, dO at +kTile.
  const auto stage = [&](int i) {
    return base + L::kRing + (i % kStages) * 2 * L::kTile;
  };
  float* xch = reinterpret_cast<float*>(smem_raw + (base + L::kX - raw));

  const int G = H / KV;
  const int g = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int h = (bkv % KV) * G + g;
  const int k0 = blockIdx.z * kBK;   // the causal heavy tiles come first
  // The query tiles of 64 rows that see a key of this tile.
  const int kmax = min(k0 + kBK, Skv) - 1;
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(Sq, kmax + window) : Sq;
  const int tiles = i_end > i_begin ? (i_end - i_begin + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: gives its registers to the consumers; one thread loads K
    // and V once, then q and dO of each query tile into the ring, whose
    // stages both consumers release.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && tiles > 0) {
      mbar_expect_tx(kv_bar, 2 * L::kTile);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(base + L::kK + c * kBoxBytes, &kmap, kv_bar, 64 * c, k0, bkv);
        tma_load(base + L::kV + c * kBoxBytes, &vmap, kv_bar, 64 * c, k0, bkv);
      }
      for (int i = 0; i < tiles; ++i) {
        const int i0 = i_begin + 64 * i;
        mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(i), 2 * L::kTile);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(stage(i) + c * kBoxBytes, &qmap, full(i), 64 * c, i0,
                   b * H + h);
          tma_load(stage(i) + L::kTile + c * kBoxBytes, &omap, full(i),
                   64 * c, i0, b * H + h);
        }
      }
    }
    return;
  }

  // Consumers (setmaxnreg 240: 128 * 24 + 256 * 240 = 64,512 registers).
  // The index comes through a shuffle so that the descriptors stay in
  // uniform registers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // This thread's two rows of the wgmma fragments (keys key0, key0 + 8)
  // and the first of its two columns (queries) in each group of 8.
  const int key0 = k0 + (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const uint32_t a_tile = base + (wg ? L::kV : L::kK);
  const uint32_t b1 = wg ? L::kTile : 0;   // B of the first product: q, dO
  const uint32_t b2 = wg ? 0 : L::kTile;   // of the second: dO, q
  const float* rows = wg ? delta : lse;

  float acc[D / 2];
  float sc[32];
  float rv[16];   // lse (warpgroup 0) or Delta (1) of the tile's 16 columns
  uint32_t pa[16];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;

  if (tiles > 0) mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int i0 = i_begin + 64 * i;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      rv[n] = row_value(rows, row0, i0 + 8 * (n / 2) + col + (n & 1), Sq);
    mbar_wait(full(i), (i / kStages) & 1);
    fence_regs(sc);
    wgmma_fence();
    bf16_nt<D>(sc, a_tile, stage(i) + b1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (wg == 0) {
      if (i > 0) named_sync(kXEmpty);   // the last tile's P^T has been read
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int key = key0 + ((j & 2) ? 8 : 0);
        const int qry = i0 + 8 * (j / 4) + col + (j & 1);
        float dt;
        const float p = prob<kCap>(sc[j] * scale, rv[(j / 4) * 2 + (j & 1)],
                                   kept(qry, key, Sq, Skv, causal, window),
                                   cap, inv_cap, dt);
        xch[j * 128 + t] = p * dt;
        sc[j] = p;
      }
      named_arrive(kXFull);
    } else {
      named_sync(kXFull);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        sc[j] = xch[j * 128 + t] * (sc[j] - rv[(j / 4) * 2 + (j & 1)]);
      if (i + 1 < tiles) named_arrive(kXEmpty);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
    fence_regs(acc);
    wgmma_fence();
    bf16_nn<D>(acc, pa, stage(i) + b2);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_one(empty(i));
  }

  // This head's partial: dK (warpgroup 1, times the scale) or dV.
  float* out = part + (wg ? 0 : G * nkv) + g * nkv +
               static_cast<int64_t>(bkv) * Skv * D;
  const float mul = wg ? scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= Skv) continue;
    float* row = out + static_cast<int64_t>(key) * D + col;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      store2(row + 8 * n8, acc[4 * n8 + 2 * half] * mul,
             acc[4 * n8 + 2 * half + 1] * mul);
  }
}

template <int DP>
struct Bf16Q {
  static constexpr int kNC = DP == 256 ? 1 : 2;    // consumer warpgroups
  static constexpr int kStages = DP == 256 ? 2 : 3;
  static constexpr int kThreads = 128 * (kNC + 1);   // + the producer's
  static constexpr int kTile = DP / 64 * kBoxBytes;
  static constexpr int kQ = 0;                     // kNC tiles of q
  static constexpr int kO = kNC * kTile;           // kNC tiles of dO
  static constexpr int kRing = 2 * kNC * kTile;    // stages of (K, V)
  static constexpr int kBar = kRing + 2 * kStages * kTile;
  static constexpr size_t kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int DP, bool kCap>
__global__ void __launch_bounds__(Bf16Q<DP>::kThreads, 1)
    flash_attention_bwd_dq_bf16_kernel(
        const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __grid_constant__ CUtensorMap omap,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int H, int KV, int Sq, int Skv,
        int causal, int window, float cap, float scale) {
  using L = Bf16Q<DP>;
  constexpr int kNC = L::kNC;
  constexpr int kStages = L::kStages;
  constexpr int kBQ = 64 * kNC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_bar = base + L::kBar;
  const auto full = [&](int i) { return q_bar + 8 * (1 + i % kStages); };
  const auto empty = [&](int i) {
    return q_bar + 8 * (1 + kStages + i % kStages);
  };
  // Key tile i's stage: K at +0, V at +kTile.
  const auto stage = [&](int i) {
    return base + L::kRing + (i % kStages) * 2 * L::kTile;
  };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  // The keys any row of this block sees, in whole tiles.
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kNC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kNC) {
    // Producer: q and dO once, then K and V of each key tile.
    if constexpr (kNC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kNC && tiles > 0) {
      mbar_expect_tx(q_bar, 2 * kNC * L::kTile);
      for (int w = 0; w < kNC; ++w)
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(base + L::kQ + w * L::kTile + c * kBoxBytes, &qmap, q_bar,
                   64 * c, q0 + 64 * w, b * H + h);
          tma_load(base + L::kO + w * L::kTile + c * kBoxBytes, &omap, q_bar,
                   64 * c, q0 + 64 * w, b * H + h);
        }
      const int kvh = b * KV + h / (H / KV);
      for (int i = 0; i < tiles; ++i) {
        const int k0 = k_begin + i * kBK;
        mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(i), 2 * L::kTile);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(stage(i) + c * kBoxBytes, &kmap, full(i), 64 * c, k0, kvh);
          tma_load(stage(i) + L::kTile + c * kBoxBytes, &vmap, full(i),
                   64 * c, k0, kvh);
        }
      }
    }
    return;
  }

  if constexpr (kNC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int qw = q0 + 64 * wg;
  const int qpos0 = qw + (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const float l0 = row_value(lse, row0, qpos0, Sq);
  const float l1 = row_value(lse, row0, qpos0 + 8, Sq);
  const float d0 = row_value(delta, row0, qpos0, Sq);
  const float d1 = row_value(delta, row0, qpos0 + 8, Sq);
  const uint32_t q_tile = base + L::kQ + wg * L::kTile;
  const uint32_t o_tile = base + L::kO + wg * L::kTile;

  float acc[DP / 2];
  float sc[32], dp[32];
  uint32_t pa[16];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;

  // S and dP of key tile i become dS, packed into bf16 A operands after
  // the dQ product of tile i - 1 is done.
  const auto scores = [&](int i) {
    const int k0 = k_begin + i * kBK;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + 8 * (j / 4) + col + (j & 1);
      const int qry = qpos0 + ((j & 2) ? 8 : 0);
      float dt;
      const float p = prob<kCap>(
          sc[j] * scale, (j & 2) ? l1 : l0,
          kept(qry, key, Sq, Skv, causal, window), cap, inv_cap,
          dt);
      sc[j] = p * dt * (dp[j] - ((j & 2) ? d1 : d0));
    }
  };
  const auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < 16; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
  };

  // Below D = 256, tile i's S and dP are issued with tile i - 1's dQ
  // product, and the two consumers take turns to issue (named barriers 1
  // and 2), so that one's scores run while the other's products hold the
  // tensor cores.  At D = 256 (one consumer) one product at a time: the
  // pipelined form spilled there and ran slower on the H100.
  if constexpr (DP < 256) {
    const int my_turn = 1 + wg;
    const int other_turn = 2 - wg;
    if (tiles > 0) {
      if (wg == 1) named_arrive(1);   // warpgroup 0 issues first
      mbar_wait(q_bar, 0);
      mbar_wait(full(0), 0);
      named_sync(my_turn);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      bf16_nt<D>(sc, q_tile, stage(0));
      bf16_nt<D>(dp, o_tile, stage(0) + L::kTile);
      wgmma_commit();
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      scores(0);
      pack();
      // Key tile i: S and dP issued with tile i - 1's dQ product; the scores
      // of tile i run while that product is in flight.
      for (int i = 1; i < tiles; ++i) {
        mbar_wait(full(i), (i / kStages) & 1);
        named_sync(my_turn);
        fence_regs(sc);
        fence_regs(dp);
        fence_regs(acc);
        wgmma_fence();
        bf16_nt<D>(sc, q_tile, stage(i));
        bf16_nt<D>(dp, o_tile, stage(i) + L::kTile);
        wgmma_commit();
        bf16_nn<DP>(acc, pa, stage(i - 1));
        wgmma_commit();
        named_arrive(other_turn);
        wgmma_wait<1>();
        fence_regs(sc);
        fence_regs(dp);
        scores(i);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive_one(empty(i - 1));
        pack();
      }
      named_sync(my_turn);
      fence_regs(acc);
      wgmma_fence();
      bf16_nn<DP>(acc, pa, stage(tiles - 1));
      wgmma_commit();
      if (wg == 0) named_arrive(other_turn);   // none follows 1's last
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_one(empty(tiles - 1));
    }
  } else {
    if (tiles > 0) mbar_wait(q_bar, 0);
    for (int i = 0; i < tiles; ++i) {
      mbar_wait(full(i), (i / kStages) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      bf16_nt<D>(sc, q_tile, stage(i));
      bf16_nt<D>(dp, o_tile, stage(i) + L::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      scores(i);
      pack();
      fence_regs(acc);
      wgmma_fence();
      bf16_nn<DP>(acc, pa, stage(i));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_one(empty(i));
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qpos0 + 8 * half;
    if (qpos >= Sq) continue;
    __nv_bfloat16* row = dq + (row0 + qpos) * D + col;
#pragma unroll
    for (int n8 = 0; n8 < DP / 8; ++n8)
      if (8 * n8 < D)
        store2(row + 8 * n8, acc[4 * n8 + 2 * half] * scale,
               acc[4 * n8 + 2 * half + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// f32: dK/dV and dQ on 3xTF32 wgmma.  Operands are the split pass's hi and
// lo halves, in boxes of 32 f32 columns (128 bytes) with the 128-byte
// swizzle.
// ---------------------------------------------------------------------------

template <int D>
struct F32Kv {
  static constexpr int kC = D / 32;                  // 32-column chunks
  static constexpr int kQB = 32;                     // queries a tile
  // K and V lo stay in shared memory up to D = 128; at D = 256 (256 KB
  // with their hi halves) each chunk of K lo or V lo comes through the
  // ring beside the chunk of q or dO it multiplies.
  static constexpr bool kLoRes = D <= 128;
  static constexpr int kSlots = kLoRes ? 4 : 2;      // a ring's slots
  // A slot: the B operand's hi at +0 and lo at +4 KB; A lo at +8 KB.
  static constexpr int kSlot = kLoRes ? 8192 : 16384;
  static constexpr int kHalf = 4096;
  static constexpr int kALo = 8192;
  // K hi (K lo), V hi (V lo): kC boxes of 64 keys x 32 columns each.
  static constexpr int kLo = kC * kBoxBytes;
  static constexpr int kAStride = kLoRes ? 2 * kLo : kLo;   // K to V
  static constexpr int kRing = 2 * kAStride;                // two rings
  static constexpr int kX = kRing + 2 * kSlots * kSlot;
  static constexpr int kBar = kX + 16 * 128 * 4;     // kv, 2 x (full, empty)
  static constexpr size_t kAlloc = kBar + 8 * (1 + 4 * kSlots) + 1024;
};

template <int D, bool kCap>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_attention_bwd_dkdv_tf32_kernel(
        const __grid_constant__ CUtensorMap qh_map,
        const __grid_constant__ CUtensorMap ql_map,
        const __grid_constant__ CUtensorMap oh_map,
        const __grid_constant__ CUtensorMap ol_map,
        const __grid_constant__ CUtensorMap qth_map,
        const __grid_constant__ CUtensorMap qtl_map,
        const __grid_constant__ CUtensorMap oth_map,
        const __grid_constant__ CUtensorMap otl_map,
        const __grid_constant__ CUtensorMap kh_map,
        const __grid_constant__ CUtensorMap kl_map,
        const __grid_constant__ CUtensorMap vh_map,
        const __grid_constant__ CUtensorMap vl_map,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ part, int64_t nkv, int H, int KV, int Sq,
        int Skv, int causal, int window, float cap) {
  using L = F32Kv<D>;
  constexpr int kC = L::kC;
  constexpr int kSlots = L::kSlots;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t kv_bar = base + L::kBar;
  // Ring w (0: warpgroup 0's, 1: warpgroup 1's), slot s.
  const auto full = [&](int w, int s) {
    return kv_bar + 8 * (1 + 2 * kSlots * w + s);
  };
  const auto empty = [&](int w, int s) {
    return kv_bar + 8 * (1 + 2 * kSlots * w + kSlots + s);
  };
  const auto slot = [&](int w, int s) {
    return base + L::kRing + (w * kSlots + s) * L::kSlot;
  };
  float* xch = reinterpret_cast<float*>(smem_raw + (base + L::kX - raw));

  const int G = H / KV;
  const int g = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int bh = b * H + (bkv % KV) * G + g;
  const int k0 = blockIdx.z * kBK;   // the causal heavy tiles come first
  const int kmax = min(k0 + kBK, Skv) - 1;
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(Sq, kmax + window) : Sq;
  const int tiles =
      i_end > i_begin ? (i_end - i_begin + L::kQB - 1) / L::kQB : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);   // one arrival per warp of its consumer
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: gives its registers to the consumers; one thread loads K
    // and V once (hi, and lo up to D = 128), then for each query tile, slot
    // by slot, ring 0 (q chunks, with K lo's at D = 256, then dO^T pieces)
    // and ring 1 (dO chunks, with V lo's, then q^T pieces), in the order
    // the consumers take them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && tiles > 0) {
      mbar_expect_tx(kv_bar, 2 * L::kAStride);
      for (int c = 0; c < kC; ++c) {
        tma_load(base + c * kBoxBytes, &kh_map, kv_bar, 32 * c, k0, bkv);
        tma_load(base + L::kAStride + c * kBoxBytes, &vh_map, kv_bar, 32 * c,
                 k0, bkv);
        if constexpr (L::kLoRes) {
          tma_load(base + L::kLo + c * kBoxBytes, &kl_map, kv_bar, 32 * c,
                   k0, bkv);
          tma_load(base + L::kAStride + L::kLo + c * kBoxBytes, &vl_map,
                   kv_bar, 32 * c, k0, bkv);
        }
      }
      uint32_t n = 0;
      for (int i = 0; i < tiles; ++i) {
        const int i0 = i_begin + L::kQB * i;
        for (int c = 0; c < 2 * kC; ++c, ++n) {
          const int s = n % kSlots;
          const uint32_t parity = ((n / kSlots) & 1) ^ 1;
          const bool chunk = c < kC;   // else a transposed piece
          const int c0 = chunk ? 32 * c : i0;
          const int c1 = chunk ? i0 : 32 * (c - kC);
          const bool a_lo = !L::kLoRes && chunk;   // A lo rides along
          const uint32_t bytes = 2 * L::kHalf + (a_lo ? L::kALo : 0);
          mbar_wait(empty(0, s), parity);
          mbar_expect_tx(full(0, s), bytes);
          tma_load(slot(0, s), chunk ? &qh_map : &oth_map, full(0, s), c0, c1,
                   bh);
          tma_load(slot(0, s) + L::kHalf, chunk ? &ql_map : &otl_map,
                   full(0, s), c0, c1, bh);
          if (a_lo)
            tma_load(slot(0, s) + L::kALo, &kl_map, full(0, s), c0, k0, bkv);
          mbar_wait(empty(1, s), parity);
          mbar_expect_tx(full(1, s), bytes);
          tma_load(slot(1, s), chunk ? &oh_map : &qth_map, full(1, s), c0, c1,
                   bh);
          tma_load(slot(1, s) + L::kHalf, chunk ? &ol_map : &qtl_map,
                   full(1, s), c0, c1, bh);
          if (a_lo)
            tma_load(slot(1, s) + L::kALo, &vl_map, full(1, s), c0, k0, bkv);
        }
      }
    }
    return;
  }

  // Consumers.  Warpgroup 0: S^T = K (q scale)^T, P^T, dV += P^T dO.
  // Warpgroup 1: dP^T = V dO^T, dS^T, dK += dS^T (q scale).  Each takes
  // its own ring; both issue the same sequence of wgmma.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int key0 = k0 + (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int64_t row0 = static_cast<int64_t>(bh) * Sq;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const uint64_t a_desc = kdesc(base + wg * L::kAStride);
  const float* rows = wg ? delta : lse;

  // dV or dK in plain registers; each tile's contribution comes in pieces
  // of 32 columns from zero (see the note on accuracy above).
  float acc[D / 2];
  float sc[16];   // the hi.hi pass, then the scores, then their hi half
  float px[16];   // the correction passes, then the lo half
  float cc[2][16];   // D = 256: a chunk's hi.hi pass
  float ot[16];   // a piece of the gradient
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  if (tiles > 0) mbar_wait(kv_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const uint32_t n = static_cast<uint32_t>(i) * 2 * kC;
    const int i0 = i_begin + L::kQB * i;
    float rv[8];   // lse (warpgroup 0) or Delta (1) of the 8 columns
#pragma unroll
    for (int m = 0; m < 8; ++m)
      rv[m] = row_value(rows, row0, i0 + 8 * (m / 2) + col + (m & 1), Sq);

    // The scores (or dP): hi.hi into sc, hi.lo + lo.hi into px, one group
    // a chunk of 32 columns of d; a chunk's slot is released once the next
    // chunk's group is issued and its own has completed.  At D = 256 each
    // chunk's hi.hi pass starts from zero in cc and is added to sc in f32
    // while the next chunk runs: 32 k-steps in one accumulator missed
    // BWD_TOL on the H100.
    const auto add_chunk = [&](int c) {
      fence_regs(cc[c & 1]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sc[j] = c == 0 ? cc[0][j] : sc[j] + cc[c & 1][j];
    };
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const uint32_t idx = n + c;
      const int s = idx % kSlots;
      mbar_wait(full(wg, s), (idx / kSlots) & 1);
      wgmma_fence();
      const uint64_t b_desc = kdesc(slot(wg, s));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ah = a_desc + ((c * kBoxBytes + kk * 32) >> 4);
        const uint64_t al = L::kLoRes ? ah + (L::kLo >> 4)
                                      : b_desc + ((L::kALo + kk * 32) >> 4);
        const uint64_t bh_ = b_desc + ((kk * 32) >> 4);
        const uint64_t bl = bh_ + (L::kHalf >> 4);
        if constexpr (L::kLoRes) {
          if (c == 0 && kk == 0) {   // resolved at compile time
            wgmma_tf32_ss<false>(sc, ah, bh_);
            wgmma_tf32_ss<false>(px, ah, bl);
          } else {
            wgmma_tf32_ss<true>(sc, ah, bh_);
            wgmma_tf32_ss<true>(px, ah, bl);
          }
        } else {
          if (kk == 0) {
            wgmma_tf32_ss<false>(cc[c & 1], ah, bh_);
          } else {
            wgmma_tf32_ss<true>(cc[c & 1], ah, bh_);
          }
          if (c == 0 && kk == 0) {
            wgmma_tf32_ss<false>(px, ah, bl);
          } else {
            wgmma_tf32_ss<true>(px, ah, bl);
          }
        }
        wgmma_tf32_ss<true>(px, al, bh_);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        mbar_arrive_one(empty(wg, (idx - 1) % kSlots));
        if constexpr (!L::kLoRes) add_chunk(c - 1);
      }
    }
    wgmma_wait<0>();
    if constexpr (L::kLoRes) {
      fence_regs(sc);
    } else {
      add_chunk(kC - 1);
    }
    fence_regs(px);
    mbar_arrive_one(empty(wg, (n + kC - 1) % kSlots));
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] += px[j];

    if (wg == 0) {
      if (i > 0) named_sync(kXEmpty);   // the last tile's P^T has been read
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = key0 + ((j & 2) ? 8 : 0);
        const int qry = i0 + 8 * (j / 4) + col + (j & 1);
        float dt;
        const float p = prob<kCap>(
            sc[j], rv[(j / 4) * 2 + (j & 1)],
            kept(qry, key, Sq, Skv, causal, window), cap, inv_cap,
            dt);
        xch[j * 128 + t] = p * dt;
        sc[j] = p;
      }
      named_arrive(kXFull);
    } else {
      named_sync(kXFull);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sc[j] = xch[j * 128 + t] * (sc[j] - rv[(j / 4) * 2 + (j & 1)]);
      if (i + 1 < tiles) named_arrive(kXEmpty);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float hi = tf32_rna(sc[j]);
      px[j] = tf32_rna(sc[j] - hi);
      sc[j] = hi;
    }

    // The gradient's pieces: P^T dO (or dS^T q scale) for 32 columns of d
    // at a time, 4 k-steps of 8 queries, the A fragment of queries
    // 8kk..8kk+7 the accumulator's sc[4kk], sc[4kk+2], sc[4kk+1],
    // sc[4kk+3] (the queries permuted to match in the split pass).
    fence_regs(sc);
    fence_regs(px);
#pragma unroll
    for (int p = 0; p < kC; ++p) {
      const uint32_t idx = n + kC + p;
      const int s = idx % kSlots;
      mbar_wait(full(wg, s), (idx / kSlots) & 1);
      wgmma_fence();
      const uint64_t b_desc = kdesc(slot(wg, s));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bh_ = b_desc + ((kk * 32) >> 4);
        const uint64_t bl = bh_ + (L::kHalf >> 4);
        const uint32_t h0 = __float_as_uint(sc[4 * kk]);
        const uint32_t h1 = __float_as_uint(sc[4 * kk + 2]);
        const uint32_t h2 = __float_as_uint(sc[4 * kk + 1]);
        const uint32_t h3 = __float_as_uint(sc[4 * kk + 3]);
        if (kk == 0) {   // resolved at compile time
          wgmma_tf32_rs<false>(ot, h0, h1, h2, h3, bh_);
        } else {
          wgmma_tf32_rs<true>(ot, h0, h1, h2, h3, bh_);
        }
        wgmma_tf32_rs<true>(ot, __float_as_uint(px[4 * kk]),
                            __float_as_uint(px[4 * kk + 2]),
                            __float_as_uint(px[4 * kk + 1]),
                            __float_as_uint(px[4 * kk + 3]), bh_);
        wgmma_tf32_rs<true>(ot, h0, h1, h2, h3, bl);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ot);
      mbar_arrive_one(empty(wg, s));
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[16 * p + j] += ot[j];
    }
    fence_regs(sc);
    fence_regs(px);
  }

  float* out = part + (wg ? 0 : G * nkv) + g * nkv +
               static_cast<int64_t>(bkv) * Skv * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + 8 * half;
    if (key >= Skv) continue;
    float* row = out + static_cast<int64_t>(key) * D + col;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      store2(row + 8 * n8, acc[4 * n8 + 2 * half],
             acc[4 * n8 + 2 * half + 1]);
  }
}

template <int D>
struct F32Q {
  static constexpr int kC = D / 32;
  // q and dO lo stay in shared memory up to D = 128; at D = 256 each chunk
  // of q lo or dO lo comes through the ring beside the chunk of K or V it
  // multiplies, and key tiles take 32 keys, since dQ's accumulator (128
  // registers a thread) leaves no room for 64-key S and dP.
  static constexpr bool kLoRes = D <= 128;
  static constexpr int kTK = kLoRes ? 64 : 32;       // keys a tile
  static constexpr int kNS = kTK / 2;                // S's registers a thread
  static constexpr int kSlots = 4;
  // A slot: K or V hi at +0 and lo at +kBHalf, then q or dO lo (D = 256);
  // or K^T hi at +0 and lo at +kHalf.
  static constexpr int kSlot = 16384;
  static constexpr int kBHalf = kTK * 128;
  static constexpr int kALo = 2 * kBHalf;
  static constexpr int kHalf = 8192;
  static constexpr int kLo = kC * kBoxBytes;         // q hi (q lo), dO hi (lo)
  static constexpr int kO = kLoRes ? 2 * kLo : kLo;
  static constexpr int kRing = 2 * kO;
  static constexpr int kBar = kRing + kSlots * kSlot;  // q, full, empty
  static constexpr size_t kAlloc = kBar + 8 * (1 + 2 * kSlots) + 1024;
  // dQ runs in pieces of kNP columns (32 at D = 256, where registers are
  // short): a K^T slot holds kNP rows (d) of 32 keys, hi and lo; a key
  // tile takes kTK / 32 slots a piece.
  static constexpr int kNP = D < 64 || D == 256 ? 32 : 64;
  static constexpr int kPieces = D / kNP;
  static constexpr int kKtSlots = kTK / 32;
  static constexpr int kKtBytes = 2 * kNP * 128;
  static constexpr int kPerTile = 2 * kC + kKtSlots * kPieces;
};

template <int D, bool kCap>
__global__ void __launch_bounds__(160, 1)
    flash_attention_bwd_dq_tf32_kernel(
        const __grid_constant__ CUtensorMap qh_map,
        const __grid_constant__ CUtensorMap ql_map,
        const __grid_constant__ CUtensorMap oh_map,
        const __grid_constant__ CUtensorMap ol_map,
        const __grid_constant__ CUtensorMap kh_map,
        const __grid_constant__ CUtensorMap kl_map,
        const __grid_constant__ CUtensorMap vh_map,
        const __grid_constant__ CUtensorMap vl_map,
        const __grid_constant__ CUtensorMap kth_map,
        const __grid_constant__ CUtensorMap ktl_map,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int H, int KV, int Sq, int Skv, int causal,
        int window, float cap, float scale) {
  using L = F32Q<D>;
  constexpr int kC = L::kC;
  constexpr int kNP = L::kNP;
  constexpr int kSlots = L::kSlots;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_bar = base + L::kBar;
  const auto full = [&](uint32_t s) { return q_bar + 8 * (1 + s); };
  const auto empty = [&](uint32_t s) { return q_bar + 8 * (1 + kSlots + s); };
  const auto slot = [&](uint32_t s) { return base + L::kRing + s * L::kSlot; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  constexpr int kTK = L::kTK;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;   // heaviest first
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + 64, Sq));
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kTK * kTK : 0;
  const int tiles = k_end > k_begin ? (k_end - k_begin + kTK - 1) / kTK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: q and dO once (hi, and lo up to D = 128); then for each
    // key tile its K chunks (with q lo's at D = 256), its V chunks (with dO
    // lo's) and its K^T slots, in the order the consumer takes them.
    if (threadIdx.x == 128 && tiles > 0) {
      mbar_expect_tx(q_bar, 2 * L::kO);
      for (int c = 0; c < kC; ++c) {
        tma_load(base + c * kBoxBytes, &qh_map, q_bar, 32 * c, q0, b * H + h);
        tma_load(base + L::kO + c * kBoxBytes, &oh_map, q_bar, 32 * c, q0,
                 b * H + h);
        if constexpr (L::kLoRes) {
          tma_load(base + L::kLo + c * kBoxBytes, &ql_map, q_bar, 32 * c, q0,
                   b * H + h);
          tma_load(base + L::kO + L::kLo + c * kBoxBytes, &ol_map, q_bar,
                   32 * c, q0, b * H + h);
        }
      }
      const int kvh = b * KV + h / (H / KV);
      uint32_t n = 0;
      for (int i = 0; i < tiles; ++i) {
        const int k0 = k_begin + i * kTK;
        for (int c = 0; c < 2 * kC; ++c, ++n) {
          const uint32_t s = n % kSlots;
          const bool kc = c < kC;
          mbar_wait(empty(s), ((n / kSlots) & 1) ^ 1);
          mbar_expect_tx(full(s),
                         2 * L::kBHalf + (L::kLoRes ? 0 : kBoxBytes));
          tma_load(slot(s), kc ? &kh_map : &vh_map, full(s), 32 * (c % kC),
                   k0, kvh);
          tma_load(slot(s) + L::kBHalf, kc ? &kl_map : &vl_map, full(s),
                   32 * (c % kC), k0, kvh);
          if constexpr (!L::kLoRes)
            tma_load(slot(s) + L::kALo, kc ? &ql_map : &ol_map, full(s),
                     32 * (c % kC), q0, b * H + h);
        }
        for (int j = 0; j < L::kKtSlots * L::kPieces; ++j, ++n) {
          const uint32_t s = n % kSlots;
          const int k1 = k0 + 32 * (j % L::kKtSlots);
          mbar_wait(empty(s), ((n / kSlots) & 1) ^ 1);
          mbar_expect_tx(full(s), L::kKtBytes);
          tma_load(slot(s), &kth_map, full(s), k1, kNP * (j / L::kKtSlots),
                   kvh);
          tma_load(slot(s) + L::kHalf, &ktl_map, full(s), k1,
                   kNP * (j / L::kKtSlots), kvh);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int qpos0 = q0 + (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const float l0 = row_value(lse, row0, qpos0, Sq);
  const float l1 = row_value(lse, row0, qpos0 + 8, Sq);
  const float d0 = row_value(delta, row0, qpos0, Sq);
  const float d1 = row_value(delta, row0, qpos0 + 8, Sq);

  constexpr int kNS = L::kNS;
  float acc[D / 2];
  float sc[kNS];       // S's hi.hi pass, then P (1 - t^2), then dS hi
  float px[kNS];       // correction passes, then dS lo
  float dp[kNS];       // dP's hi.hi pass
  float cc[2][kNS];    // D = 256: a chunk's hi.hi pass
  float ot[kNP / 2];   // a piece of dQ
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  if (tiles > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const uint32_t n = static_cast<uint32_t>(i) * L::kPerTile;
    const int k0 = k_begin + i * kTK;

    // S = (q scale) K^T, then dP = dO V^T: hi.hi and the two correction
    // passes in separate accumulators, one group a chunk of 32 columns; at
    // D = 256 each chunk's hi.hi pass from zero in cc, added in f32 (as in
    // the dK/dV kernel).
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const uint32_t a_base = base + (pass ? L::kO : 0);
      float (&hh)[kNS] = pass ? dp : sc;
      const auto add_chunk = [&](int c) {
        fence_regs(cc[c & 1]);
#pragma unroll
        for (int j = 0; j < kNS; ++j)
          hh[j] = c == 0 ? cc[0][j] : hh[j] + cc[c & 1][j];
      };
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const uint32_t idx = n + pass * kC + c;
        const uint32_t s = idx % kSlots;
        mbar_wait(full(s), (idx / kSlots) & 1);
        wgmma_fence();
        const uint64_t b_desc = kdesc(slot(s));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t ah = kdesc(a_base + c * kBoxBytes + kk * 32);
          const uint64_t al = L::kLoRes
                                  ? ah + (L::kLo >> 4)
                                  : b_desc + ((L::kALo + kk * 32) >> 4);
          const uint64_t bh_ = b_desc + ((kk * 32) >> 4);
          const uint64_t bl = bh_ + (L::kBHalf >> 4);
          if constexpr (L::kLoRes) {
            if (pass == 0) {   // resolved at compile time
              if (c == 0 && kk == 0) {
                wgmma_tf32_ss<false>(sc, ah, bh_);
                wgmma_tf32_ss<false>(px, ah, bl);
              } else {
                wgmma_tf32_ss<true>(sc, ah, bh_);
                wgmma_tf32_ss<true>(px, ah, bl);
              }
            } else {
              if (c == 0 && kk == 0) {
                wgmma_tf32_ss<false>(dp, ah, bh_);
                wgmma_tf32_ss<false>(px, ah, bl);
              } else {
                wgmma_tf32_ss<true>(dp, ah, bh_);
                wgmma_tf32_ss<true>(px, ah, bl);
              }
            }
          } else {
            if (kk == 0) {
              wgmma_tf32_ss<false>(cc[c & 1], ah, bh_);
            } else {
              wgmma_tf32_ss<true>(cc[c & 1], ah, bh_);
            }
            if (c == 0 && kk == 0) {
              wgmma_tf32_ss<false>(px, ah, bl);
            } else {
              wgmma_tf32_ss<true>(px, ah, bl);
            }
          }
          wgmma_tf32_ss<true>(px, al, bh_);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          mbar_arrive_one(empty((idx - 1) % kSlots));
          if constexpr (!L::kLoRes) add_chunk(c - 1);
        }
      }
      wgmma_wait<0>();
      if constexpr (L::kLoRes) {
        fence_regs(hh);
      } else {
        add_chunk(kC - 1);
      }
      fence_regs(px);
      mbar_arrive_one(empty((n + pass * kC + kC - 1) % kSlots));
      if (pass == 0) {
        // P (1 - t^2), the factor of dS that the scores give.
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const int key = k0 + 8 * (j / 4) + col + (j & 1);
          const int qry = qpos0 + ((j & 2) ? 8 : 0);
          float dt;
          const float p = prob<kCap>(
              sc[j] + px[j], (j & 2) ? l1 : l0,
              kept(qry, key, Sq, Skv, causal, window), cap, inv_cap,
              dt);
          sc[j] = p * dt;
        }
      } else {
        // dS = P (1 - t^2) (dP - Delta), split into hi and lo.
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const float ds = sc[j] * (dp[j] + px[j] - ((j & 2) ? d1 : d0));
          const float hi = tf32_rna(ds);
          px[j] = tf32_rna(ds - hi);
          sc[j] = hi;
        }
      }
    }

    // dQ += dS K: for each piece of kNP columns, kTK / 32 K^T slots of 32
    // keys, 4 k-steps of 8 keys a slot, summed into dQ in f32.
    fence_regs(sc);
    fence_regs(px);
#pragma unroll
    for (int p = 0; p < L::kPieces; ++p) {
#pragma unroll
      for (int hf = 0; hf < L::kKtSlots; ++hf) {
        const uint32_t idx = n + 2 * kC + L::kKtSlots * p + hf;
        const uint32_t s = idx % kSlots;
        mbar_wait(full(s), (idx / kSlots) & 1);
        wgmma_fence();
        const uint64_t k_desc = kdesc(slot(s));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = 4 * hf + kk;
          const uint64_t kh = k_desc + ((kk * 32) >> 4);
          const uint64_t kl = kh + (L::kHalf >> 4);
          const uint32_t h0 = __float_as_uint(sc[4 * j]);
          const uint32_t h1 = __float_as_uint(sc[4 * j + 2]);
          const uint32_t h2 = __float_as_uint(sc[4 * j + 1]);
          const uint32_t h3 = __float_as_uint(sc[4 * j + 3]);
          if (hf == 0 && kk == 0) {   // resolved at compile time
            wgmma_tf32_rs<false>(ot, h0, h1, h2, h3, kh);
          } else {
            wgmma_tf32_rs<true>(ot, h0, h1, h2, h3, kh);
          }
          wgmma_tf32_rs<true>(ot, __float_as_uint(px[4 * j]),
                              __float_as_uint(px[4 * j + 2]),
                              __float_as_uint(px[4 * j + 1]),
                              __float_as_uint(px[4 * j + 3]), kh);
          wgmma_tf32_rs<true>(ot, h0, h1, h2, h3, kl);
        }
        wgmma_commit();
        if (hf > 0) {
          wgmma_wait<1>();
          mbar_arrive_one(empty((idx - 1) % kSlots));
        }
      }
      wgmma_wait<0>();
      fence_regs(ot);
      mbar_arrive_one(
          empty((n + 2 * kC + L::kKtSlots * (p + 1) - 1) % kSlots));
#pragma unroll
      for (int j = 0; j < kNP / 2; ++j) acc[p * (kNP / 2) + j] += ot[j];
    }
    fence_regs(sc);
    fence_regs(px);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qpos0 + 8 * half;
    if (qpos >= Sq) continue;
    float* row = dq + (row0 + qpos) * D + col;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      store2(row + 8 * n8, acc[4 * n8 + 2 * half] * scale,
             acc[4 * n8 + 2 * half + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Host side: the workspace, tensor maps and the launches.
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

// A tensor map over `planes` contiguous (rows, cols) matrices of `bytes`
// bytes an element, in boxes of box_cols x box_rows with the 128-byte
// swizzle; what lies outside the tensor is read as zero.
int encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
           int bytes, int cols, int rows, int planes, int box_cols,
           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1000 + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * bytes,
      static_cast<cuuint64_t>(rows) * cols * bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

int encode_bf16(CUtensorMap* map, const void* ptr, int D, int S,
                int planes) {
  return encode(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, S, planes,
                64, 64);
}

int encode_f32(CUtensorMap* map, const float* ptr, int cols, int rows,
               int planes, int box_rows) {
  return encode(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, cols, rows,
                planes, 32, box_rows);
}

int64_t round_up(int64_t n, int64_t m) { return (n + m - 1) / m * m; }
int64_t r64(int64_t n) { return round_up(n, 64); }

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int grid_stride_blocks(int64_t n) {
  return static_cast<int>(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
}

template <typename T, int D>
int launch_delta(const T* o, const T* dout, float* delta, int64_t rows,
                 cudaStream_t stream) {
  if (rows == 0) return 0;
  flash_attention_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(o, dout,
                                                                  delta, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const float* part, T* dk, T* dv, int64_t nkv, int G,
                  cudaStream_t stream) {
  const int64_t n4 = nkv / 4;   // D is a multiple of 32
  flash_attention_bwd_reduce_kernel<T>
      <<<grid_stride_blocks(2 * n4), 256, 0, stream>>>(
          reinterpret_cast<const float4*>(part), dk, dv, n4, G);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const __nv_bfloat16* o,
                const float* lse, const __nv_bfloat16* dout,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                float* work, int B, int H, int KV, int Sq, int Skv,
                int causal, int window, float cap, float scale,
                cudaStream_t stream) {
  constexpr int DP = D < 64 ? 64 : D;
  const int G = H / KV;
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  const int64_t nkv = static_cast<int64_t>(B) * KV * Skv * D;
  float* delta = work;
  float* part = delta + r64(rows);
  int err = launch_delta<__nv_bfloat16, D>(o, dout, delta, rows, stream);
  if (err != 0) return err;
  CUtensorMap qm, km, vm, om;
  err = encode_bf16(&qm, q, D, Sq, B * H);
  if (err == 0) err = encode_bf16(&km, k, D, Skv, B * KV);
  if (err == 0) err = encode_bf16(&vm, v, D, Skv, B * KV);
  if (err == 0) err = encode_bf16(&om, dout, D, Sq, B * H);
  if (err != 0) return err;

  if constexpr (DP < 256) {
    auto dkdv = cap > 0.f
                    ? flash_attention_bwd_dkdv128_bf16_kernel<D, DP, true>
                    : flash_attention_bwd_dkdv128_bf16_kernel<D, DP, false>;
    err = set_smem(dkdv, Bf16Kv128<DP>::kAlloc);
    if (err != 0) return err;
    const dim3 g1(G, B * KV,
                  static_cast<unsigned>((Skv + 2 * kBK - 1) / (2 * kBK)));
    dkdv<<<g1, kKvThreads, Bf16Kv128<DP>::kAlloc, stream>>>(
        qm, km, vm, om, lse, delta, part, nkv, H, KV, Sq, Skv, causal,
        window, cap, scale);
  } else {
    auto dkdv = cap > 0.f ? flash_attention_bwd_dkdv256_bf16_kernel<true>
                          : flash_attention_bwd_dkdv256_bf16_kernel<false>;
    err = set_smem(dkdv, Bf16Kv256::kAlloc);
    if (err != 0) return err;
    const dim3 g1(G, B * KV, static_cast<unsigned>((Skv + kBK - 1) / kBK));
    dkdv<<<g1, kKvThreads, Bf16Kv256::kAlloc, stream>>>(
        qm, km, vm, om, lse, delta, part, nkv, H, KV, Sq, Skv, causal,
        window, cap, scale);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  using LQ = Bf16Q<DP>;
  auto dqk = cap > 0.f ? flash_attention_bwd_dq_bf16_kernel<D, DP, true>
                       : flash_attention_bwd_dq_bf16_kernel<D, DP, false>;
  err = set_smem(dqk, LQ::kAlloc);
  if (err != 0) return err;
  const int bq = 64 * LQ::kNC;
  const dim3 g2(H, B, static_cast<unsigned>((Sq + bq - 1) / bq));
  dqk<<<g2, LQ::kThreads, LQ::kAlloc, stream>>>(qm, km, vm, om, lse, delta,
                                                 dq, H, KV, Sq, Skv, causal,
                                                 window, cap, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(part, dk, dv, nkv, G, stream);
}

int split_launch(const float* x, float* hi, float* lo, int64_t n,
                 float scale, cudaStream_t stream) {
  const int64_t n4 = n / 4;   // D is a multiple of 32
  flash_attention_bwd_split_kernel<<<grid_stride_blocks(n4), 256, 0,
                                     stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n4, scale);
  return static_cast<int>(cudaGetLastError());
}

int split_transpose_launch(const float* x, float* hi, float* lo, int S,
                           int S8, int D, int planes, float scale,
                           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S8 + 31) / 32), D / 32, planes);
  flash_attention_bwd_split_transpose_kernel<<<grid, dim3(32, 8), 0,
                                               stream>>>(x, hi, lo, S, S8, D,
                                                         scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const float* q, const float* k, const float* v,
                const float* o, const float* lse, const float* dout,
                float* dq, float* dk, float* dv, float* work, int B, int H,
                int KV, int Sq, int Skv, int causal, int window, float cap,
                float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  const int64_t nq = rows * D;
  const int64_t nkv = static_cast<int64_t>(B) * KV * Skv * D;
  const int Sq8 = static_cast<int>(round_up(Sq, 8));
  const int Skv8 = static_cast<int>(round_up(Skv, 8));
  const int64_t nqt = static_cast<int64_t>(B) * H * D * Sq8;
  const int64_t nkt = static_cast<int64_t>(B) * KV * D * Skv8;
  float* delta = work;
  float* part = delta + r64(rows);
  float* qh = part + r64(2 * G * nkv);
  float* ql = qh + r64(nq);
  float* oh = ql + r64(nq);
  float* ol = oh + r64(nq);
  float* qth = ol + r64(nq);
  float* qtl = qth + r64(nqt);
  float* oth = qtl + r64(nqt);
  float* otl = oth + r64(nqt);
  float* kh = otl + r64(nqt);
  float* kl = kh + r64(nkv);
  float* vh = kl + r64(nkv);
  float* vl = vh + r64(nkv);
  float* kth = vl + r64(nkv);
  float* ktl = kth + r64(nkt);

  int err = launch_delta<float, D>(o, dout, delta, rows, stream);
  if (err == 0) err = split_launch(q, qh, ql, nq, scale, stream);
  if (err == 0) err = split_launch(dout, oh, ol, nq, 1.f, stream);
  if (err == 0) err = split_launch(k, kh, kl, nkv, 1.f, stream);
  if (err == 0) err = split_launch(v, vh, vl, nkv, 1.f, stream);
  if (err == 0)
    err = split_transpose_launch(q, qth, qtl, Sq, Sq8, D, B * H, scale,
                                 stream);
  if (err == 0)
    err = split_transpose_launch(dout, oth, otl, Sq, Sq8, D, B * H, 1.f,
                                 stream);
  if (err == 0)
    err = split_transpose_launch(k, kth, ktl, Skv, Skv8, D, B * KV, 1.f,
                                 stream);
  if (err != 0) return err;

  constexpr int kNP = F32Q<D>::kNP;
  constexpr int kTK = F32Q<D>::kTK;
  CUtensorMap m[22];
  // dK/dV: q and dO in boxes of 32 rows, their transposes (32 positions x
  // 32 rows of d), k and v in boxes of 64 rows.
  err = encode_f32(&m[0], qh, D, Sq, B * H, 32);
  if (err == 0) err = encode_f32(&m[1], ql, D, Sq, B * H, 32);
  if (err == 0) err = encode_f32(&m[2], oh, D, Sq, B * H, 32);
  if (err == 0) err = encode_f32(&m[3], ol, D, Sq, B * H, 32);
  if (err == 0) err = encode_f32(&m[4], qth, Sq8, D, B * H, 32);
  if (err == 0) err = encode_f32(&m[5], qtl, Sq8, D, B * H, 32);
  if (err == 0) err = encode_f32(&m[6], oth, Sq8, D, B * H, 32);
  if (err == 0) err = encode_f32(&m[7], otl, Sq8, D, B * H, 32);
  if (err == 0) err = encode_f32(&m[8], kh, D, Skv, B * KV, 64);
  if (err == 0) err = encode_f32(&m[9], kl, D, Skv, B * KV, 64);
  if (err == 0) err = encode_f32(&m[10], vh, D, Skv, B * KV, 64);
  if (err == 0) err = encode_f32(&m[11], vl, D, Skv, B * KV, 64);
  // dQ: q and dO in boxes of 64 rows, k and v in boxes of its key tile,
  // k^T (32 keys x kNP rows of d).
  if (err == 0) err = encode_f32(&m[12], qh, D, Sq, B * H, 64);
  if (err == 0) err = encode_f32(&m[13], ql, D, Sq, B * H, 64);
  if (err == 0) err = encode_f32(&m[14], oh, D, Sq, B * H, 64);
  if (err == 0) err = encode_f32(&m[15], ol, D, Sq, B * H, 64);
  if (err == 0) err = encode_f32(&m[16], kth, Skv8, D, B * KV, kNP);
  if (err == 0) err = encode_f32(&m[17], ktl, Skv8, D, B * KV, kNP);
  if (err == 0) err = encode_f32(&m[18], kh, D, Skv, B * KV, kTK);
  if (err == 0) err = encode_f32(&m[19], kl, D, Skv, B * KV, kTK);
  if (err == 0) err = encode_f32(&m[20], vh, D, Skv, B * KV, kTK);
  if (err == 0) err = encode_f32(&m[21], vl, D, Skv, B * KV, kTK);
  if (err != 0) return err;

  auto dkdv = cap > 0.f ? flash_attention_bwd_dkdv_tf32_kernel<D, true>
                        : flash_attention_bwd_dkdv_tf32_kernel<D, false>;
  err = set_smem(dkdv, F32Kv<D>::kAlloc);
  if (err != 0) return err;
  const dim3 g1(G, B * KV, static_cast<unsigned>((Skv + kBK - 1) / kBK));
  dkdv<<<g1, kKvThreads, F32Kv<D>::kAlloc, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9], m[10],
      m[11], lse, delta, part, nkv, H, KV, Sq, Skv, causal, window, cap);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  auto dqk = cap > 0.f ? flash_attention_bwd_dq_tf32_kernel<D, true>
                       : flash_attention_bwd_dq_tf32_kernel<D, false>;
  err = set_smem(dqk, F32Q<D>::kAlloc);
  if (err != 0) return err;
  const dim3 g2(H, B, static_cast<unsigned>((Sq + 63) / 64));
  dqk<<<g2, 160, F32Q<D>::kAlloc, stream>>>(
      m[12], m[13], m[14], m[15], m[18], m[19], m[20], m[21], m[16], m[17],
      lse, delta, dq, H, KV, Sq, Skv, causal, window, cap, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(part, dk, dv, nkv, G, stream);
}

// No key: dq is 0 and dk, dv are empty.  No query: dk and dv are 0.
int launch_empty(void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
                 int Skv, int D, int bytes, cudaStream_t stream) {
  if (Skv == 0)
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, static_cast<size_t>(B) * H * Sq * D * bytes, stream));
  const size_t n = static_cast<size_t>(B) * KV * Skv * D * bytes;
  int err = static_cast<int>(cudaMemsetAsync(dk, 0, n, stream));
  if (err == 0) err = static_cast<int>(cudaMemsetAsync(dv, 0, n, stream));
  return err;
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* dk, void* dv, void* work, int B,
                            int H, int KV, int Sq, int Skv, int D, int causal,
                            int window, float cap, float scale,
                            void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Skv == 0 || Sq == 0)
    return launch_empty(dq, dk, dv, B, H, KV, Sq, Skv, D, 4, st);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* wf = static_cast<float*>(work);
  switch (D) {
    case 32:
      return launch_tf32<32>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, wf, B, H,
                             KV, Sq, Skv, causal, window, cap, scale, st);
    case 64:
      return launch_tf32<64>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, wf, B, H,
                             KV, Sq, Skv, causal, window, cap, scale, st);
    case 128:
      return launch_tf32<128>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, wf, B,
                              H, KV, Sq, Skv, causal, window, cap, scale, st);
    case 256:
      return launch_tf32<256>(qf, kf, vf, of, lf, df, dqf, dkf, dvf, wf, B,
                              H, KV, Sq, Skv, causal, window, cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dout,
                             void* dq, void* dk, void* dv, void* work, int B,
                             int H, int KV, int Sq, int Skv, int D,
                             int causal, int window, float cap, float scale,
                             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Skv == 0 || Sq == 0)
    return launch_empty(dq, dk, dv, B, H, KV, Sq, Skv, D, 2, st);
  using bf = __nv_bfloat16;
  const auto* qb = static_cast<const bf*>(q);
  const auto* kb = static_cast<const bf*>(k);
  const auto* vb = static_cast<const bf*>(v);
  const auto* ob = static_cast<const bf*>(o);
  const auto* lf = static_cast<const float*>(lse);
  const auto* db = static_cast<const bf*>(dout);
  auto* dqb = static_cast<bf*>(dq);
  auto* dkb = static_cast<bf*>(dk);
  auto* dvb = static_cast<bf*>(dv);
  auto* wf = static_cast<float*>(work);
  switch (D) {
    case 32:
      return launch_bf16<32>(qb, kb, vb, ob, lf, db, dqb, dkb, dvb, wf, B, H,
                             KV, Sq, Skv, causal, window, cap, scale, st);
    case 64:
      return launch_bf16<64>(qb, kb, vb, ob, lf, db, dqb, dkb, dvb, wf, B, H,
                             KV, Sq, Skv, causal, window, cap, scale, st);
    case 128:
      return launch_bf16<128>(qb, kb, vb, ob, lf, db, dqb, dkb, dvb, wf, B,
                              H, KV, Sq, Skv, causal, window, cap, scale, st);
    case 256:
      return launch_bf16<256>(qb, kb, vb, ob, lf, db, dqb, dkb, dvb, wf, B,
                              H, KV, Sq, Skv, causal, window, cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
