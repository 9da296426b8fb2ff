// Blockwise online-softmax attention (flash attention) in f32 on Hopper's
// tensor cores: 3xTF32 wgmma products fed by TMA, warp-specialised.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fa_kernel for f32 q, k, v (bf16
// runs in flash_attention_sm90.cu).  For query head h of batch b (KV head
// h / G, G = H / KV: grouped KV heads are read in place, never
// replicated):
//
//   s[q,k]  = (q[q,:] * scale) . k[k,:]                   f32 accuracy
//   s       = cap * tanh(s / cap)                         if cap > 0
//   s       = -1e30 unless k < Skv, and k <= q (causal),
//             and k > q - window (window > 0)
//   o[q,:]  = sum_k softmax_k(s[q,:]) v[k,:]              online: m, l, acc
//   o       = acc / max(l, 1e-30)
//
// What bounds it: operations.  At Gemma-2 9B's prefill shape (B=2, H=16,
// KV=8, S=4,608, D=256) a layer does 4*D operations per unmasked (q, k)
// pair: 348.0 GFLOP on a global layer, 343.7 on a local one (window
// 4,096), against about 0.45 GB of q, k, v and o.  One TF32 pass keeps
// about 11 bits of each operand, too few for f32 accuracy (scores reach
// +-60), so every product runs as three TF32 passes (below): 3 x 348.0
// GFLOP at the H100's 495 TFLOP/s of dense TF32 is 2.11 ms, the least
// time for this work at f32 accuracy (on the CUDA cores, 5.19 ms).
//
// Arithmetic (3xTF32).  Each operand x is split as x = hi + lo, hi =
// tf32(x) (round to nearest, ties away: the low 13 bits of the f32 cleared)
// and lo = tf32(x - hi), both exact TF32 values, so the tensor cores see no
// bits they would drop.  A.B ~ A_hi.B_hi + A_hi.B_lo + A_lo.B_hi with f32
// accumulation; the dropped A_lo.B_lo and the rounding of lo are about
// 2^-22 of each term.  Both products take this form: S = Q.K^T and
// O += P.V, P split in registers after the softmax.  The softmax, the
// softcap (the exp2 form of tanh, as in flash_attention_sm90.cu) and the
// rescale stay in f32 on the CUDA cores.
//
// Accuracy of the accumulation.  The tensor cores' f32 accumulation does
// not round each sum to nearest as the CUDA cores do, and its error grows
// with every wgmma that adds to a large accumulator.  On the H100 a first
// version that ran all three passes into S, and P.V into O across the
// whole KV sweep (1,728 wgmmas a row at 4,608 keys), missed the plain
// version by 1.04e-4 at Gemma-2's shape and 2.2e-5 at a 130-token D = 256
// one, against 2.2e-5 and 1.3e-5 now.  So the hi.hi pass of S has its own
// accumulator and the two small correction passes another, summed in f32;
// and P.V runs in pieces of 64 output columns, each piece of a tile
// accumulated from zero (24 wgmmas) and added to O, which lives in plain
// registers, in f32.  What is left is the f32 rounding that the plain
// version has too: both lie about 1e-5 from the function in float64 at
// scores of +-20 (tests/test_torch_tf32.py emulates this arithmetic).
//
// Design.  A split pass (three small kernels, launched first on the same
// stream) writes the hi and lo halves of q * scale and of k, and of v
// transposed (d, key) with the keys of each group of 8 permuted as below,
// into a workspace the wrapper allocates: wgmma reads 32-bit operands from
// shared memory only K-major (no transpose bit for .tf32), so the P.V
// product needs V with the keys contiguous.  Then one block of 160
// threads owns 64 query rows of one (b, h):
//
//   - warp 4 is the producer: one thread issues every TMA load, the q tile
//     (hi and lo, D x 64 f32 each) once, then for each KV tile of 64 keys
//     D/32 chunks of K (32 columns x 64 keys, hi and lo) and 2 D/64 slots
//     of V^T (32 keys x 64 rows of d, hi and lo) into a ring of 4 slots of
//     16 KB, each slot with a "full" barrier (armed with its bytes) and an
//     "empty" one (one arrival per consumer warp);
//   - warps 0-3 are the consumer warpgroup.  S = Q K^T: for each K chunk,
//     4 k-steps of three wgmma m64n64k8 (Q hi/lo and K hi/lo both read
//     from shared memory), committed as one group; a slot is released
//     once the group after it is issued and its own has completed.  Then
//     the softmax on the accumulator fragments (a row lies on the 4
//     threads of a quad: two shuffles), O rescaled, P split into P_hi (in
//     place) and P_lo.  O += P V: for each piece of 64 columns of O, two
//     V^T slots of 4 k-steps of three wgmma m64n64k8, P_hi or P_lo as
//     the register A operand.
//
// The A fragment of a TF32 k8 step gives thread (r, c) of a quad the
// columns c and c + 4 of its rows, where the accumulator gives it columns
// 2c and 2c + 1.  Rather than move P across the quad, the split pass
// stores the keys of each group of 8 in V^T in the order 0 2 4 6 1 3 5 7,
// so that the accumulator's two columns of a thread are exactly the
// A operand's: d[4j], d[4j+2], d[4j+1], d[4j+3] for k-step j.
//
// Shared memory at D = 256: Q hi and lo 128 KB, the ring 64 KB, 192 KB in
// all (one block an SM, opted in with cudaFuncSetAttribute).  O (64 x D
// in f32, 128 registers a thread at D = 256), S (32), P_lo (32) and a
// piece of P V (32) stay in registers.  Nothing but wgmma writes a wgmma's registers between its
// fence and its wait, no wgmma sits in a branch, and the descriptors
// depend on nothing but uniform values, or ptxas serialises every product
// (warnings C7513/C7520).  The softmax does not overlap the products, as
// the bf16 kernel's ping-pong does: a second consumer warpgroup would need
// either 64 more rows of q in shared memory (128 KB more at D = 256) or a
// second O in registers, and neither fits.  On the H100 the softmax takes
// about 0.55 of 4.1 ms at Gemma-2's shape (measured by leaving it out).
//
// Tiles are loaded by 3-D tensor maps over (columns, rows, batch * heads),
// so the rows of a ragged tile past S are zero-filled by the hardware, in
// boxes of 32 f32 columns (128 bytes) x 64 rows with the 128-byte swizzle
// that the wgmma descriptors name (q and k: 32 columns of d x 64 rows;
// V^T: 32 keys x 64 rows of d).  KV
// tiles outside the block's causal/window band are never loaded (the
// argument of the bf16 kernel: a tile masked for a whole row adds p = 0
// after the row's first valid key and is wiped by corr = exp(-1e30 - m) =
// 0 before it).  Query blocks run heaviest first.
//
// libcuda's cuTensorMapEncodeTiled is fetched at run time through
// cudaGetDriverEntryPoint(ByVersion), so the library links against the
// CUDA runtime alone.
//
// Plain C interface, bound with ctypes
// (src/repro_torch/kernels/flash_attention.py): flash_attention_f32
// launches the split pass and the kernel on the given stream and returns
// the first CUDA error, 0, or 1000 + the CUresult if a tensor map cannot
// be encoded.  The workspace (allocated by the wrapper, `workspace_floats`
// there) holds, in this order, q_hi and q_lo (B, H, Sq, D), k_hi and k_lo
// (B, KV, Skv, D), and v^T_hi and v^T_lo (B, KV, D, Skv rounded up to 8).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;            // query rows per block (one warpgroup)
constexpr int kBK = 64;            // keys per KV tile
constexpr int kThreads = 160;      // consumer warpgroup + producer warp
// Ring slots of 16 KB.  Four: a KV tile takes a multiple of 4 slots at
// D >= 64, so every slot index of the unrolled tile is a constant; 4 ran
// faster than 5 or 6 on the H100 (3.8 against 4.05 ms at Gemma-2's shape).
constexpr int kSlots = 4;
constexpr int kSlotBytes = 16384;  // hi half at +0, lo half at +8 KB
constexpr int kHalf = 8192;
constexpr int kBoxBytes = 8192;    // a q or k box: 32 f32 columns x 64 rows
constexpr int kEmptyArrivals = 4;  // one per consumer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "D is 32, 64, 128 or 256");
  static constexpr int kChunks = D / 32;                // K chunks a tile
  static constexpr int kQ = 0;                          // hi boxes, lo boxes
  static constexpr int kQLo = kChunks * kBoxBytes;
  static constexpr int kRing = 2 * kChunks * kBoxBytes;
  static constexpr int kBar = kRing + kSlots * kSlotBytes;  // q, full, empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kSlots);
  static constexpr size_t kAlloc = kBytes + 1024;       // base aligned up
  static constexpr int kKBytes = 2 * kBoxBytes;         // a K chunk, hi + lo
  // P V runs in pieces of kNP output columns: a V^T slot holds kNP rows
  // (d) of 32 keys, hi and lo; a KV tile takes two slots a piece.
  static constexpr int kNP = D < 64 ? D : 64;
  static constexpr int kPieces = D / kNP;
  static constexpr int kVBytes = 2 * kNP * 128;
};

// Round to TF32, to nearest with ties away from zero: clear the low 13
// bits of the f32 after adding half of their range.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// ---------------------------------------------------------------------------
// The split pass.
// ---------------------------------------------------------------------------

// hi = tf32(x * scale), lo = tf32(x * scale - hi), four floats a thread.
__global__ void flash_attention_split_kernel(const float4* __restrict__ x,
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

// v (planes, Skv, D) -> hi and lo of v^T (planes, D, Skv8), Skv8 = Skv
// rounded up to 8 (zero past Skv), the keys of each group of 8 stored in
// the order 0 2 4 6 1 3 5 7.  A block transposes 32 keys x 32 columns
// through shared memory.
__global__ void flash_attention_split_transpose_kernel(
    const float* __restrict__ v, float* __restrict__ hi,
    float* __restrict__ lo, int Skv, int Skv8, int D) {
  __shared__ float tile[32][33];
  const int key0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int64_t plane = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int key = key0 + r;
    tile[r][tx] = key < Skv ? v[(plane * Skv + key) * D + d0 + tx] : 0.f;
  }
  __syncthreads();
  const int pos = key0 + tx;                 // position in the stored row
  const int kap = tx & 7;
  const int src = (tx & ~7) + (kap < 4 ? 2 * kap : 2 * (kap - 4) + 1);
  if (pos >= Skv8) return;
  for (int r = ty; r < 32; r += 8) {
    const float x = tile[src][r];
    const float h = tf32_rna(x);
    const int64_t at = (plane * D + d0 + r) * Skv8 + pos;
    hi[at] = h;
    lo[at] = tf32_rna(x - h);
  }
}

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

// A wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle (layout type 1): start address, the (unused) leading byte offset
// and the stride byte offset between groups of 8 rows (1 KB: 8 rows of
// 128 bytes), each in 16-byte units.  A k-step of 8 TF32 values is +32
// bytes inside a row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The descriptor of `desc`'s tile moved by `bytes` (a multiple of 16;
// shared memory ends below 256 KB, so the start field does not carry).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
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
// written ("+f", kAcc) or only written ("=f"): a product that starts from
// zero leaves the registers' old values dead, so that the compiler may
// give them to another array in between.
#define FA_D4(c, i) c(d[(i)]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3])
#define FA_D8(c, i) FA_D4(c, i), FA_D4(c, (i) + 4)
#define FA_D16(c, i) FA_D8(c, i), FA_D8(c, (i) + 8)
#define FA_D32(c, i) FA_D16(c, i), FA_D16(c, (i) + 16)
#define FA_RW(x) "+f"(x)
#define FA_W(x) "=f"(x)

// D (64 x 64, f32) (+)= A (64 x 8) * B (8 x 64), TF32, A and B in shared
// memory, both K-major; D is overwritten unless kAcc.
#define FA_SS_N64(C, ACC)                                                   \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "  \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "  \
      "%31}, %32, %33, p, 1, 1;\n}\n "                                     \
      : FA_D32(C, 0)                                                        \
      : "l"(desc_a), "l"(desc_b), "r"(ACC))

template <bool kAcc>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  if constexpr (kAcc) {
    FA_SS_N64(FA_RW, 1);
  } else {
    FA_SS_N64(FA_W, 0);
  }
}

// D (64 x N, f32) (+)= A (64 x 8, TF32 in registers a0..a3) * B (8 x N),
// B in shared memory, K-major, N = 32 or 64; D is overwritten unless kAcc.
#define FA_RS_N32(C, ACC)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, "   \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "         \
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n "                           \
      : FA_D16(C, 0)                                                         \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(ACC))
#define FA_RS_N64(C, ACC)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "   \
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "   \
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n "                     \
      : FA_D32(C, 0)                                                         \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(ACC))

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  if constexpr (kAcc) {
    FA_RS_N32(FA_RW, 1);
  } else {
    FA_RS_N32(FA_W, 0);
  }
}

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  if constexpr (kAcc) {
    FA_RS_N64(FA_RW, 1);
  } else {
    FA_RS_N64(FA_W, 0);
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

// ---------------------------------------------------------------------------
// The steps of the consumer, and the kernel.
// ---------------------------------------------------------------------------

// The softcap (kCap), the masks (only where `edge`: a tile that crosses the
// diagonal, the window's lower edge or Skv) and the online softmax of one
// 64 x 64 tile of scores in the wgmma accumulator layout: updates m and l,
// sets corr = exp(m_old - m_new) for each of the thread's two rows, and
// leaves P = exp(S - m) in f32 in place of S.
template <bool kCap>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[32], float& m0, float& m1, float& l0, float& l1,
    float& corr0, float& corr1, bool edge, int k0, int col, int qpos0,
    int causal, int window, int Skv, float cap, float inv_cap) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float x = sc[j];
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

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap qh_map,
                                const __grid_constant__ CUtensorMap ql_map,
                                const __grid_constant__ CUtensorMap kh_map,
                                const __grid_constant__ CUtensorMap kl_map,
                                const __grid_constant__ CUtensorMap vh_map,
                                const __grid_constant__ CUtensorMap vl_map,
                                float* __restrict__ o, int H, int KV, int Sq,
                                int Skv, int causal, int window, float cap) {
  using L = Layout<D>;
  constexpr int kC = L::kChunks;
  constexpr int kNP = L::kNP;
  constexpr int kPerTile = kC + 2 * L::kPieces;  // ring slots a KV tile takes
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1 KB: tiles start on 1 KB
  // boundaries.
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t q_bar = base + L::kBar;
  const auto full = [&](uint32_t s) { return q_bar + 8 * (1 + s); };
  const auto empty = [&](uint32_t s) {
    return q_bar + 8 * (1 + kSlots + s);
  };
  const auto slot = [&](uint32_t s) { return base + L::kRing + s * kSlotBytes; };

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
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: one thread issues every load into the ring, in the order
    // the consumer takes them: a tile's K chunks, then its V^T chunks.
    if (threadIdx.x == 128 && tiles > 0) {
      mbar_expect_tx(q_bar, 2 * kC * kBoxBytes);
      for (int c = 0; c < kC; ++c) {
        tma_load(base + L::kQ + c * kBoxBytes, &qh_map, q_bar, 32 * c, q0,
                 b * H + h);
        tma_load(base + L::kQLo + c * kBoxBytes, &ql_map, q_bar, 32 * c, q0,
                 b * H + h);
      }
      const int kvh = b * KV + h / (H / KV);
      uint32_t n = 0;
      for (int i = 0; i < tiles; ++i) {
        const int k0 = k_begin + i * kBK;
        for (int c = 0; c < kC; ++c, ++n) {
          const uint32_t s = n % kSlots;
          mbar_wait(empty(s), ((n / kSlots) & 1) ^ 1);
          mbar_expect_tx(full(s), L::kKBytes);
          tma_load(slot(s), &kh_map, full(s), 32 * c, k0, kvh);
          tma_load(slot(s) + kHalf, &kl_map, full(s), 32 * c, k0, kvh);
        }
        for (int j = 0; j < 2 * L::kPieces; ++j, ++n) {
          const uint32_t s = n % kSlots;
          mbar_wait(empty(s), ((n / kSlots) & 1) ^ 1);
          mbar_expect_tx(full(s), L::kVBytes);
          tma_load(slot(s), &vh_map, full(s), k0 + 32 * (j & 1),
                   kNP * (j / 2), kvh);
          tma_load(slot(s) + kHalf, &vl_map, full(s), k0 + 32 * (j & 1),
                   kNP * (j / 2), kvh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup: threads 0..127 own rows q0..q0+63.
  const int t = threadIdx.x;
  const int lane = t % 32;
  // This thread's two rows of the wgmma fragments (r0, r0 + 8) and the
  // first of its two columns in each group of 8.
  const int r0 = (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int qpos0 = q0 + r0;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const auto edge = [&](int k0) {
    return (causal && k0 + kBK - 1 > q0) ||
           (window > 0 && k0 < q0 + kBQ - window) || k0 + kBK > Skv;
  };

  // O lives in plain registers; wgmma writes S (hi.hi), its correction
  // terms (hi.lo + lo.hi) and one piece of P V at a time (kNP columns),
  // each from zero, so that the tensor cores' accumulation never runs
  // long at O's scale (see the note on accuracy above).
  float acc[D / 2];
  float sc[32];        // S_hi.hi, then S, then P_hi in place
  float px[32];        // S's correction terms, then P_lo in place
  float ot[kNP / 2];   // one piece of P V
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float corr0 = 1.f, corr1 = 1.f;

  const uint64_t q_desc = smem_desc(base + L::kQ);
  if (tiles > 0) mbar_wait(q_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const uint32_t n = static_cast<uint32_t>(i) * kPerTile;
    const int k0 = k_begin + i * kBK;

    // S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T, one group a K chunk;
    // a chunk's slot is released once the next chunk's group is issued
    // and its own has completed.
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const uint32_t s = (n + c) % kSlots;
      mbar_wait(full(s), ((n + c) / kSlots) & 1);
      wgmma_fence();
      const uint64_t k_desc = smem_desc(slot(s));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t qh = desc_at(q_desc, c * kBoxBytes + kk * 32);
        const uint64_t ql = desc_at(qh, L::kQLo);
        const uint64_t kh = desc_at(k_desc, kk * 32);
        const uint64_t kl = desc_at(kh, kHalf);
        if (c == 0 && kk == 0) {   // resolved at compile time
          wgmma_ss_n64<false>(sc, qh, kh);
          wgmma_ss_n64<false>(px, qh, kl);
        } else {
          wgmma_ss_n64<true>(sc, qh, kh);
          wgmma_ss_n64<true>(px, qh, kl);
        }
        wgmma_ss_n64<true>(px, ql, kh);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        mbar_arrive_one(empty((n + c - 1) % kSlots));
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(px);
    mbar_arrive_one(empty((n + kC - 1) % kSlots));
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] += px[j];

    softmax_tile<kCap>(sc, m0, m1, l0, l1, corr0, corr1, edge(k0), k0, col,
                       qpos0, causal, window, Skv, cap, inv_cap);
    // O = O * corr, and P = P_hi + P_lo.
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? corr1 : corr0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float hi = tf32_rna(sc[j]);
      px[j] = tf32_rna(sc[j] - hi);
      sc[j] = hi;
    }

    // O += P_hi V_hi + P_lo V_hi + P_hi V_lo, one piece of kNP columns at
    // a time: a piece takes two V^T slots of 32 keys, one group each, 4
    // k-steps of 8 keys a slot; the A fragment of keys 8j..8j+7 is the
    // accumulator's d[4j], d[4j+2], d[4j+1], d[4j+3] (the keys permuted
    // to match in the split pass).  Each piece is summed into O in f32.
    fence_regs(sc);
    fence_regs(px);
#pragma unroll
    for (int p = 0; p < L::kPieces; ++p) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t idx = n + kC + 2 * p + hf;
        const uint32_t s = idx % kSlots;
        mbar_wait(full(s), (idx / kSlots) & 1);
        wgmma_fence();
        const uint64_t v_desc = smem_desc(slot(s));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = 4 * hf + kk;
          const uint64_t vh = desc_at(v_desc, kk * 32);
          const uint64_t vl = desc_at(vh, kHalf);
          const uint32_t h0 = __float_as_uint(sc[4 * j]);
          const uint32_t h1 = __float_as_uint(sc[4 * j + 2]);
          const uint32_t h2 = __float_as_uint(sc[4 * j + 1]);
          const uint32_t h3 = __float_as_uint(sc[4 * j + 3]);
          if (hf == 0 && kk == 0) {   // resolved at compile time
            wgmma_rs<false>(ot, h0, h1, h2, h3, vh);
          } else {
            wgmma_rs<true>(ot, h0, h1, h2, h3, vh);
          }
          wgmma_rs<true>(ot, __float_as_uint(px[4 * j]),
                         __float_as_uint(px[4 * j + 2]),
                         __float_as_uint(px[4 * j + 1]),
                         __float_as_uint(px[4 * j + 3]), vh);
          wgmma_rs<true>(ot, h0, h1, h2, h3, vl);
        }
        wgmma_commit();
        if (hf > 0) {
          wgmma_wait<1>();
          mbar_arrive_one(empty((idx - 1) % kSlots));
        }
      }
      wgmma_wait<0>();
      fence_regs(ot);
      mbar_arrive_one(empty((n + kC + 2 * p + 1) % kSlots));
#pragma unroll
      for (int j = 0; j < kNP / 2; ++j) acc[p * (kNP / 2) + j] += ot[j];
    }
    fence_regs(sc);
    fence_regs(px);
  }

  // Epilogue: O / max(l, 1e-30), rows >= Sq left out.
  float* ob = o + (static_cast<int64_t>(b) * H + h) * Sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = qpos0 + 8 * half;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
    float* orow = ob + static_cast<int64_t>(qpos) * D + col;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      *reinterpret_cast<float2*>(orow + 8 * n8) =
          make_float2(acc[4 * n8 + 2 * half] * inv,
                      acc[4 * n8 + 2 * half + 1] * inv);
    }
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

// A tensor map over `planes` contiguous (rows, cols) f32 matrices, in
// boxes of box_cols x box_rows with the given swizzle; what lies outside
// the tensor is read as zero.
int encode(CUtensorMap* map, const float* ptr, int cols, int rows,
           int planes, int box_cols, int box_rows,
           CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1000 + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr),
         dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

int64_t round8(int64_t n) { return (n + 7) / 8 * 8; }

int split_launch(const float* x, float* hi, float* lo, int64_t n,
                 float scale, cudaStream_t stream) {
  const int64_t n4 = n / 4;   // D is a multiple of 32
  const int blocks = static_cast<int>(
      n4 / 256 + 1 < 132 * 16 ? n4 / 256 + 1 : 132 * 16);
  flash_attention_split_kernel<<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n4, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, float* o,
             float* work, int B, int H, int KV, int Sq, int Skv, int causal,
             int window, float cap, float scale, cudaStream_t stream) {
  const int64_t nq = static_cast<int64_t>(B) * H * Sq * D;
  const int64_t nk = static_cast<int64_t>(B) * KV * Skv * D;
  const int Skv8 = static_cast<int>(round8(Skv));
  float* qh = work;
  float* ql = qh + nq;
  float* kh = ql + nq;
  float* kl = kh + nk;
  float* vh = kl + nk;
  float* vl = vh + static_cast<int64_t>(B) * KV * D * Skv8;

  int err = split_launch(q, qh, ql, nq, scale, stream);
  if (err == 0) err = split_launch(k, kh, kl, nk, 1.f, stream);
  if (err != 0) return err;
  const dim3 tgrid(static_cast<unsigned>((Skv8 + 31) / 32), D / 32, B * KV);
  flash_attention_split_transpose_kernel<<<tgrid, dim3(32, 8), 0, stream>>>(
      v, vh, vl, Skv, Skv8, D);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  CUtensorMap m[6];
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  err = encode(&m[0], qh, D, Sq, B * H, 32, kBQ, sw128);
  if (err == 0) err = encode(&m[1], ql, D, Sq, B * H, 32, kBQ, sw128);
  if (err == 0) err = encode(&m[2], kh, D, Skv, B * KV, 32, kBK, sw128);
  if (err == 0) err = encode(&m[3], kl, D, Skv, B * KV, 32, kBK, sw128);
  constexpr int kNP = Layout<D>::kNP;
  if (err == 0) err = encode(&m[4], vh, Skv8, D, B * KV, 32, kNP, sw128);
  if (err == 0) err = encode(&m[5], vl, Skv8, D, B * KV, 32, kNP, sw128);
  if (err != 0) return err;
  auto kernel = cap > 0.f ? flash_attention_tf32_kernel<D, true>
                          : flash_attention_tf32_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<D>::kAlloc));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ), H, B);
  kernel<<<grid, kThreads, Layout<D>::kAlloc, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], o, H, KV, Sq, Skv, causal, window,
      cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* work, int B, int H, int KV, int Sq, int Skv,
                        int D, int causal, int window, float cap, float scale,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Skv == 0) {  // no key at all: every row is 0, as in the plain version
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * H * Sq * D * 4, st));
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* wf = static_cast<float*>(work);
  switch (D) {
    case 32:
      return launch_d<32>(qf, kf, vf, of, wf, B, H, KV, Sq, Skv, causal,
                          window, cap, scale, st);
    case 64:
      return launch_d<64>(qf, kf, vf, of, wf, B, H, KV, Sq, Skv, causal,
                          window, cap, scale, st);
    case 128:
      return launch_d<128>(qf, kf, vf, of, wf, B, H, KV, Sq, Skv, causal,
                           window, cap, scale, st);
    case 256:
      return launch_d<256>(qf, kf, vf, of, wf, B, H, KV, Sq, Skv, causal,
                           window, cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
