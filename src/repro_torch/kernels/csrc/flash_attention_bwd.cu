// The backward of blockwise flash attention (dQ, dK, dV) on Hopper's CUDA
// cores, in f32, for f32 and bf16 q, k, v.
//
// Replaces no Pallas kernel: the Pallas kernel
// src/repro/kernels/flash_attention.py::_fa_kernel has no backward, and
// the JAX package trains through jax.value_and_grad of the chunked jnp
// attention (src/repro/models/attention.py:32), the function that kernel
// computes.  This kernel computes that gradient from the forward's row
// statistics (lse = m + log l, written by flash_attention.cu and
// flash_attention_sm90.cu), for query head h of batch b and its KV head
// h / G (G = H / KV):
//
//   s[q,k]  = (q[q,:] * scale) . k[k,:]                   f32
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
// bf16 inputs are widened to f32 as they are loaded and every sum is in
// f32 (JAX upcasts q, k and v before its products, and its gradient
// follows); dq, dk and dv are written in the input dtype.  The plain
// version is src/repro_torch/kernels/ref.py::flash_attention_bwd_ref.
//
// What bounds it: operations.  The gradient takes five products of 2 * D
// operations a kept (q, k) pair (S, dP, dV, dK, dQ); this design computes
// S and dP twice (once for dK/dV, once for dQ), seven in all.  At
// Qwen2.5-3B's training shape (B=1, H=16, KV=2, S=4,096, D=128, causal)
// the five products are 171.8 GFLOP, 2.56 ms at the H100's 67 TFLOP/s of
// f32 on the CUDA cores and 0.35 ms at 495 TFLOP/s of TF32 on the tensor
// cores (where f32 accuracy takes three passes, 1.04 ms).  This is
// the first, simple kernel: f32 FMAs on the CUDA cores, from shared
// memory, in register micro-tiles.  wgmma and TMA are later work.
//
// Design.  Three launches on the given stream, all in this file:
//
//   1. Delta: one warp a row, sum_d dO O in f32 (a fixed shuffle tree).
//   2. dK/dV: one block of 256 threads per (key tile of BK keys, KV head,
//      batch).  K and V of the tile stay in shared memory; the block
//      walks the G query heads of its group and, for each, the query
//      tiles of BQ rows that can see the tile (the causal and window band
//      in whole tiles), in that fixed order: it loads q * scale and dO of
//      the tile, computes S and dP (each thread a micro-tile of BQ/16 x
//      BK/16 scores, float4 loads from rows padded by 4 floats so that a
//      quarter warp touches 32 distinct banks), P and dS, stores both to
//      shared memory, and accumulates dV += P^T dO and dK += dS^T q in
//      registers (each thread BK*D/256 of each, 4 columns at a time).
//      The G heads' contributions to a KV head meet in the same
//      registers, in the same order every run: no atomics.
//   3. dQ: one block per (query tile, head, batch), heaviest tiles first,
//      q * scale, dO, lse and Delta of its tile in shared memory, walking
//      the key tiles of its band: S, dP and dS again, dS stored
//      transposed, dQ += dS K in registers; scaled once at the end.
//
// Every output element is written by one thread, once, so the gradients
// are bitwise the same run to run.  Tiles: BQ = 64, BK = 64 (32 at D =
// 256); shared memory 169 KB (dK/dV) and 152 KB (dQ) at D = 128, 217 KB
// and 209 KB at D = 256, opted in with cudaFuncSetAttribute: one block an
// SM.  With G = 8 (Qwen2.5-3B) the dK/dV grid has 2 x 64 blocks and the
// causal tiles near the start do 8 x 64 query tiles each against 8 x 1
// at the end: the first redesign should split that work.
//
// Plain C interface, bound with ctypes
// (src/repro_torch/kernels/flash_attention.py): flash_attention_bwd_f32
// and flash_attention_bwd_bf16 launch the three kernels and return the
// first CUDA error, or 0.  `delta` is a (B, H, Sq) f32 workspace the
// wrapper allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int D>
struct Tiles {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "D is 32, 64, 128 or 256");
  static constexpr int BQ = 64;                 // query rows a tile
  static constexpr int BK = D == 256 ? 32 : 64;  // keys a tile
  static constexpr int LD = D + 4;     // row stride of the q, k, v, dO tiles
  static constexpr int LP = BK + 1;    // row stride of P and dS (dK/dV)
  static constexpr int LT = BQ + 1;    // row stride of dS^T (dQ)
  static constexpr int RA = BQ / 16;   // score rows a thread
  static constexpr int RB = BK / 16;   // score columns a thread
  static constexpr int CG = D / 4;     // groups of 4 columns of a gradient
  static constexpr int RG = kThreads / CG;  // threads down a gradient
  static constexpr int RK = BK / RG;   // dK, dV rows a thread
  static constexpr int RQ = BQ / RG;   // dQ rows a thread
  static_assert(BK % RG == 0 && BQ % RG == 0, "rows split evenly");
  static constexpr size_t kKV = 2ull * BK * LD * 4;
  static constexpr size_t kQO = 2ull * BQ * LD * 4;
  static constexpr size_t kRows = 2ull * BQ * 4;     // lse and Delta
  static constexpr size_t kDkdv = kKV + kQO + 2ull * BQ * LP * 4 + kRows;
  static constexpr size_t kDq = kKV + kQO + 1ull * BK * LT * 4 + kRows;
};

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

// ROWS rows of a (rows, D) matrix from row0 into shared memory (row
// stride D + 4), widened to f32 and multiplied by `mul`; rows past
// `nrows` are zero.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int nrows, float mul) {
  constexpr int C4 = D / 4;
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < ROWS * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c = 4 * (idx % C4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) {
      x = load4(src + static_cast<int64_t>(row0 + r) * D + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// This thread's micro-tile of C = A B^T, A (16 RA, D) and B (16 RB, D) in
// shared memory with row stride D + 4: rows tm + 16 a, columns tn + 16 b.
template <int RA, int RB, int D>
__device__ __forceinline__ void nt_tile(float (&c)[RA][RB],
                                        const float* __restrict__ A,
                                        const float* __restrict__ Bm,
                                        int tm, int tn) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) c[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[RA], bv[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (tm + 16 * a) * LD + d);
#pragma unroll
    for (int b = 0; b < RB; ++b)
      bv[b] = *reinterpret_cast<const float4*>(Bm + (tn + 16 * b) * LD + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        c[a][b] = fmaf(av[a].x, bv[b].x, c[a][b]);
        c[a][b] = fmaf(av[a].y, bv[b].y, c[a][b]);
        c[a][b] = fmaf(av[a].z, bv[b].z, c[a][b]);
        c[a][b] = fmaf(av[a].w, bv[b].w, c[a][b]);
      }
  }
}

// S and dP of a micro-tile become P and dS (see the header), in place.
// Row i0 + tm + 16 a, key k0 + tn + 16 b; lse_s and del_s hold the tile's
// rows.
template <int RA, int RB>
__device__ __forceinline__ void grad_scores(float (&s)[RA][RB],
                                            float (&dp)[RA][RB],
                                            const float* lse_s,
                                            const float* del_s, int i0,
                                            int k0, int tm, int tn, int Sq,
                                            int Skv, int causal, int window,
                                            float cap) {
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = i0 + tm + 16 * a;
    const float l = lse_s[tm + 16 * a];
    const float dl = del_s[tm + 16 * a];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int j = k0 + tn + 16 * b;
      float x = s[a][b];
      float dt = 1.f;
      if (cap > 0.f) {
        const float t = tanhf(x / cap);
        x = cap * t;
        dt = 1.f - t * t;
      }
      bool ok = i < Sq && j < Skv;
      if (causal) ok = ok && j <= i;
      if (window > 0) ok = ok && j > i - window;
      const float p = ok ? expf(x - l) : 0.f;
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - dl) * dt;
    }
  }
}

// C (R rows a thread: rg + RG a; columns 4 cg .. 4 cg + 3) += sum over r <
// NR of A[r][row] B[r][col]; A in shared memory with row stride LA, B
// with row stride LB.
template <int R, int RG, int NR, int LA, int LB>
__device__ __forceinline__ void tn_acc(float (&c)[R][4],
                                       const float* __restrict__ A,
                                       const float* __restrict__ Bm, int rg,
                                       int cg) {
#pragma unroll 4
  for (int r = 0; r < NR; ++r) {
    const float4 bv = *reinterpret_cast<const float4*>(Bm + r * LB + 4 * cg);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float av = A[r * LA + rg + RG * a];
      c[a][0] = fmaf(av, bv.x, c[a][0]);
      c[a][1] = fmaf(av, bv.y, c[a][1]);
      c[a][2] = fmaf(av, bv.z, c[a][2]);
      c[a][3] = fmaf(av, bv.w, c[a][3]);
    }
  }
}

// Delta = rowsum(dO * O), one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta,
                                     int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
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

// The query tile's lse and Delta into shared memory (0 past Sq).
template <int BQ>
__device__ __forceinline__ void load_rows(float* lse_s, float* del_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int64_t row0, int i0, int Sq) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = i0 + r < Sq;
    lse_s[r] = in ? lse[row0 + i0 + r] : 0.f;
    del_s[r] = in ? delta[row0 + i0 + r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq,
        int Skv, int causal, int window, float cap, float scale) {
  using L = Tiles<D>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + L::BK * L::LD;
  float* Qs = Vs + L::BK * L::LD;
  float* Os = Qs + L::BQ * L::LD;   // dO
  float* Ps = Os + L::BQ * L::LD;
  float* Ss = Ps + L::BQ * L::LP;   // dS
  float* lse_s = Ss + L::BQ * L::LP;
  float* del_s = lse_s + L::BQ;

  const int k0 = blockIdx.x * L::BK;   // the causal heavy tiles come first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const int cg = tid % L::CG, rg = tid / L::CG;
  const int64_t kv_plane = (static_cast<int64_t>(b) * KV + kvh) * Skv;

  load_tile<L::BK, D>(Ks, k + kv_plane * D, k0, Skv, 1.f);
  load_tile<L::BK, D>(Vs, v + kv_plane * D, k0, Skv, 1.f);

  float dka[L::RK][4], dva[L::RK][4];
#pragma unroll
  for (int a = 0; a < L::RK; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[a][c] = dva[a][c] = 0.f;

  // The query rows that see a key of this tile, in whole tiles.
  const int kmax = min(k0 + L::BK, Skv) - 1;
  const int i_begin = causal ? k0 / L::BQ * L::BQ : 0;
  const int i_end = window > 0 ? min(Sq, kmax + window) : Sq;

  for (int g = 0; g < G; ++g) {
    const int64_t q_plane = (static_cast<int64_t>(b) * H + kvh * G + g) * Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += L::BQ) {
      __syncthreads();   // the previous tile's reads are done
      load_tile<L::BQ, D>(Qs, q + q_plane * D, i0, Sq, scale);
      load_tile<L::BQ, D>(Os, dout + q_plane * D, i0, Sq, 1.f);
      load_rows<L::BQ>(lse_s, del_s, lse, delta, q_plane, i0, Sq);
      __syncthreads();
      float s[L::RA][L::RB], dp[L::RA][L::RB];
      nt_tile<L::RA, L::RB, D>(s, Qs, Ks, tm, tn);
      nt_tile<L::RA, L::RB, D>(dp, Os, Vs, tm, tn);
      grad_scores(s, dp, lse_s, del_s, i0, k0, tm, tn, Sq, Skv, causal,
                  window, cap);
#pragma unroll
      for (int a = 0; a < L::RA; ++a)
#pragma unroll
        for (int bb = 0; bb < L::RB; ++bb) {
          Ps[(tm + 16 * a) * L::LP + tn + 16 * bb] = s[a][bb];
          Ss[(tm + 16 * a) * L::LP + tn + 16 * bb] = dp[a][bb];
        }
      __syncthreads();
      tn_acc<L::RK, L::RG, L::BQ, L::LP, L::LD>(dva, Ps, Os, rg, cg);
      tn_acc<L::RK, L::RG, L::BQ, L::LP, L::LD>(dka, Ss, Qs, rg, cg);
    }
  }

#pragma unroll
  for (int a = 0; a < L::RK; ++a) {
    const int j = k0 + rg + L::RG * a;
    if (j < Skv) {
      const int64_t at = (kv_plane + j) * D + 4 * cg;
      store4(dk + at, make_float4(dka[a][0], dka[a][1], dka[a][2], dka[a][3]));
      store4(dv + at, make_float4(dva[a][0], dva[a][1], dva[a][2], dva[a][3]));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dq, int H, int KV, int Sq, int Skv, int causal,
        int window, float cap, float scale) {
  using L = Tiles<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + L::BQ * L::LD;   // dO
  float* Ks = Os + L::BQ * L::LD;
  float* Vs = Ks + L::BK * L::LD;
  float* St = Vs + L::BK * L::LD;   // dS^T
  float* lse_s = St + L::BK * L::LT;
  float* del_s = lse_s + L::BQ;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * L::BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const int cg = tid % L::CG, rg = tid / L::CG;
  const int64_t q_plane = (static_cast<int64_t>(b) * H + h) * Sq;
  const int64_t kv_plane =
      (static_cast<int64_t>(b) * KV + h / (H / KV)) * Skv;

  load_tile<L::BQ, D>(Qs, q + q_plane * D, i0, Sq, scale);
  load_tile<L::BQ, D>(Os, dout + q_plane * D, i0, Sq, 1.f);
  load_rows<L::BQ>(lse_s, del_s, lse, delta, q_plane, i0, Sq);

  float dqa[L::RQ][4];
#pragma unroll
  for (int a = 0; a < L::RQ; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[a][c] = 0.f;

  // The keys any row of this tile sees, in whole tiles.
  int k_end = Skv;
  if (causal) k_end = min(k_end, i0 + L::BQ);
  const int k_begin =
      window > 0 ? max(0, i0 - window + 1) / L::BK * L::BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += L::BK) {
    __syncthreads();   // the previous tile's reads are done
    load_tile<L::BK, D>(Ks, k + kv_plane * D, k0, Skv, 1.f);
    load_tile<L::BK, D>(Vs, v + kv_plane * D, k0, Skv, 1.f);
    __syncthreads();
    float s[L::RA][L::RB], dp[L::RA][L::RB];
    nt_tile<L::RA, L::RB, D>(s, Qs, Ks, tm, tn);
    nt_tile<L::RA, L::RB, D>(dp, Os, Vs, tm, tn);
    grad_scores(s, dp, lse_s, del_s, i0, k0, tm, tn, Sq, Skv, causal,
                window, cap);
#pragma unroll
    for (int a = 0; a < L::RA; ++a)
#pragma unroll
      for (int bb = 0; bb < L::RB; ++bb)
        St[(tn + 16 * bb) * L::LT + tm + 16 * a] = dp[a][bb];
    __syncthreads();
    tn_acc<L::RQ, L::RG, L::BK, L::LT, L::LD>(dqa, St, Ks, rg, cg);
  }

#pragma unroll
  for (int a = 0; a < L::RQ; ++a) {
    const int i = i0 + rg + L::RG * a;
    if (i < Sq) {
      store4(dq + (q_plane + i) * D + 4 * cg,
             make_float4(dqa[a][0] * scale, dqa[a][1] * scale,
                         dqa[a][2] * scale, dqa[a][3] * scale));
    }
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* o,
             const float* lse, const T* dout, T* dq, T* dk, T* dv,
             float* delta, int B, int H, int KV, int Sq, int Skv, int causal,
             int window, float cap, float scale, cudaStream_t stream) {
  using L = Tiles<D>;
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  if (Skv == 0) {   // no key: dq is 0, dk and dv are empty
    return static_cast<int>(
        cudaMemsetAsync(dq, 0, static_cast<size_t>(rows) * D * sizeof(T),
                        stream));
  }
  if (rows > 0) {
    const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    flash_attention_bwd_delta_kernel<T, D>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(o, dout,
                                                                 delta, rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kDkdv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g1(static_cast<unsigned>((Skv + L::BK - 1) / L::BK), KV, B);
  dkdv<<<g1, kThreads, L::kDkdv, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                           H, KV, Sq, Skv, causal, window,
                                           cap, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || Sq == 0) return err;
  auto dqk = flash_attention_bwd_dq_kernel<T, D>;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L::kDq));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2(static_cast<unsigned>((Sq + L::BQ - 1) / L::BQ), H, B);
  dqk<<<g2, kThreads, L::kDq, stream>>>(q, k, v, dout, lse, delta, dq, H, KV,
                                        Sq, Skv, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int B, int H, int KV, int Sq, int Skv, int D,
           int causal, int window, float cap, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* ot = static_cast<const T*>(o);
  const auto* lf = static_cast<const float*>(lse);
  const auto* dot = static_cast<const T*>(dout);
  auto* dqt = static_cast<T*>(dq);
  auto* dkt = static_cast<T*>(dk);
  auto* dvt = static_cast<T*>(dv);
  auto* df = static_cast<float*>(delta);
  switch (D) {
    case 32:
      return launch_d<T, 32>(qt, kt, vt, ot, lf, dot, dqt, dkt, dvt, df, B, H,
                             KV, Sq, Skv, causal, window, cap, scale, st);
    case 64:
      return launch_d<T, 64>(qt, kt, vt, ot, lf, dot, dqt, dkt, dvt, df, B, H,
                             KV, Sq, Skv, causal, window, cap, scale, st);
    case 128:
      return launch_d<T, 128>(qt, kt, vt, ot, lf, dot, dqt, dkt, dvt, df, B,
                              H, KV, Sq, Skv, causal, window, cap, scale, st);
    case 256:
      return launch_d<T, 256>(qt, kt, vt, ot, lf, dot, dqt, dkt, dvt, df, B,
                              H, KV, Sq, Skv, causal, window, cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* dk, void* dv, void* delta, int B,
                            int H, int KV, int Sq, int Skv, int D, int causal,
                            int window, float cap, float scale,
                            void* stream) {
  return launch<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, KV,
                       Sq, Skv, D, causal, window, cap, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dout,
                             void* dq, void* dk, void* dv, void* delta, int B,
                             int H, int KV, int Sq, int Skv, int D,
                             int causal, int window, float cap, float scale,
                             void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, delta, B,
                               H, KV, Sq, Skv, D, causal, window, cap, scale,
                               stream);
}

}  // extern "C"
