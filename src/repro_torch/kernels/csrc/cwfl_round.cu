// The fused CWFL sync round (Algorithm 1) as one Hopper kernel.
//
// Replaces the Pallas TPU kernels
// src/repro/kernels/cwfl_round.py::_cwfl_round_kernel and, with the Guard
// template flag, ::_cwfl_round_kernel_guard.  For every column j of the
// flat parameter dimension d:
//
//   tt[c]    = sum_k A[c,k] * S[k,j] + N1[c,j]     phase 1: OTA MAC   (C,)
//   tb[c]    = sum_i B[c,i] * tt[i]  + N2[c,j]     phase 2: consensus (C,)
//   new[k,j] = sum_c M[k,c] * tb[c]                phase 3: broadcast (K,)
//   cons[j]  = (sum_c tb[c]) / C
//
// What bounds it: memory.  The round must read S (K*d), N1 and N2 (2*C*d)
// and write new (K*d) and cons (d): hbm_bytes_model's fused bytes, 78.8 MB
// at the main shape (K=50, C=3, d=184,214, f32), about 23.5 us at an H100
// SXM's 3.35 TB/s, against some 114 MFLOP of work.
//
// What this design does about it: it reads S exactly once and keeps the
// intermediates tt and tb in registers, out of device memory.  One thread
// owns one column; neighbouring threads own neighbouring columns, so every
// row of S, N1, N2 and new, and cons, is read or written coalesced.  The
// tiny weights A (C,K), B (C,C) and M (K,C) are staged in shared memory
// once per block.  C is a template parameter (1..kMaxC) so that tt and tb
// live in registers; all sums run in f32, in index order.  The ragged edge
// is masked here; nothing is padded.  wgmma, TMA and wider loads are left
// to later work.
//
// A trajectory axis (the counterpart of jax.vmap over the Pallas call,
// which gives its grid a leading axis): a launch may run B independent
// rounds, one per trajectory of a Monte-Carlo sweep, with S, N1, N2, new
// and cons stacked as (B, K, d), (B, C, d), (B, C, d), (B, K, d) and
// (B, d) and the weights as (B, C, K), (B, C, C) and (B, K, C).
// blockIdx.y is the trajectory: each block offsets every pointer to its
// own trajectory (64-bit offsets) and stages only that trajectory's
// weights, so the shared memory a block needs does not grow with B.  The
// offsets are a template flag (Batched): a launch of one trajectory runs
// the unbatched instantiation, the same code as before the axis existed
// (with the offsets compiled in, it ran 9-24 % slower on the card:
// PERF.md), and so the same bits.
//
// The guarded variant (fault scenarios) adds two guards and no traffic:
// every S load that is not finite becomes 0 before its FMA (0 * NaN = NaN,
// so a zero amplitude cannot contain a poisoned client), and a row c with
// sum_k |A[c,k]| <= 0 (a cluster whose every member failed) forces tt[c],
// its noise included, to 0.  Each block takes the dead flags once from the
// A it staged in shared memory.  The unguarded instantiations compile to
// the same code as without the flag.
//
// Plain C interface, bound with ctypes (src/repro_torch/kernels/cwfl_round.py):
// each entry point launches `batch` trajectories (1..65535) on the given
// stream and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxC = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int C, bool Guard, bool Batched>
__global__ void __launch_bounds__(kThreads)
    cwfl_round_kernel(const T* __restrict__ s, const float* __restrict__ a,
                      const float* __restrict__ n1,
                      const float* __restrict__ b,
                      const float* __restrict__ n2,
                      const float* __restrict__ m, T* __restrict__ out,
                      float* __restrict__ cons, int K, int d) {
  if constexpr (Batched) {  // this block's trajectory
    const int64_t traj = blockIdx.y;
    s += traj * K * d;
    out += traj * K * d;
    n1 += traj * C * d;
    n2 += traj * C * d;
    cons += traj * d;
    a += traj * C * K;
    b += traj * C * C;
    m += traj * K * C;
  }
  extern __shared__ float w[];
  float* wa = w;           // (C, K)
  float* wb = wa + C * K;  // (C, C)
  float* wm = wb + C * C;  // (K, C)
  for (int i = threadIdx.x; i < C * K; i += blockDim.x) wa[i] = a[i];
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) wb[i] = b[i];
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) wm[i] = m[i];
  __syncthreads();
  __shared__ bool dead[Guard ? C : 1];
  if constexpr (Guard) {
    if (threadIdx.x < C) {
      float mass = 0.f;
      for (int k = 0; k < K; ++k) mass += fabsf(wa[threadIdx.x * K + k]);
      dead[threadIdx.x] = mass <= 0.f;
    }
    __syncthreads();
  }

  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= d) return;

  // Phase 1: tt = A S[:, j] + N1[:, j].
  float tt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) tt[c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float sk = to_f32(s[static_cast<int64_t>(k) * d + j]);
    if (Guard && !isfinite(sk)) sk = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) tt[c] = fmaf(wa[c * K + k], sk, tt[c]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    tt[c] += n1[static_cast<int64_t>(c) * d + j];
    if (Guard && dead[c]) tt[c] = 0.f;
  }

  // Phase 2: tb = B tt + N2[:, j]; the consensus is the mean of tb.
  float tb[C];
  float total = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) acc = fmaf(wb[c * C + i], tt[i], acc);
    tb[c] = acc + n2[static_cast<int64_t>(c) * d + j];
    total += tb[c];
  }
  cons[j] = total / static_cast<float>(C);

  // Phase 3: new[:, j] = M tb.
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc = fmaf(wm[k * C + c], tb[c], acc);
    out[static_cast<int64_t>(k) * d + j] = from_f32<T>(acc);
  }
}

template <typename T, bool Guard>
int launch(const void* s, const void* a, const void* n1, const void* b,
           const void* n2, const void* m, void* out, void* cons, int K,
           int C, int d, int batch, void* stream) {
  if (batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(2 * C * K + C * C);
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* sp = static_cast<const T*>(s);
  const float* ap = static_cast<const float*>(a);
  const float* n1p = static_cast<const float*>(n1);
  const float* bp = static_cast<const float*>(b);
  const float* n2p = static_cast<const float*>(n2);
  const float* mp = static_cast<const float*>(m);
  T* op = static_cast<T*>(out);
  float* cp = static_cast<float*>(cons);
  switch (C) {
#define CWFL_CASE(CC)                                                   \
  case CC:                                                              \
    if (batch > 1)                                                      \
      cwfl_round_kernel<T, CC, Guard, true><<<grid, kThreads, smem, st>>>( \
          sp, ap, n1p, bp, n2p, mp, op, cp, K, d);                      \
    else                                                                \
      cwfl_round_kernel<T, CC, Guard, false><<<grid, kThreads, smem,    \
                                               st>>>(                   \
          sp, ap, n1p, bp, n2p, mp, op, cp, K, d);                      \
    break;
    CWFL_CASE(1) CWFL_CASE(2) CWFL_CASE(3) CWFL_CASE(4)
    CWFL_CASE(5) CWFL_CASE(6) CWFL_CASE(7) CWFL_CASE(8)
    CWFL_CASE(9) CWFL_CASE(10) CWFL_CASE(11) CWFL_CASE(12)
    CWFL_CASE(13) CWFL_CASE(14) CWFL_CASE(15) CWFL_CASE(16)
#undef CWFL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxC == 16, "the switch above covers C = 1..kMaxC");
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cwfl_round_f32(const void* s, const void* a, const void* n1,
                   const void* b, const void* n2, const void* m, void* out,
                   void* cons, int K, int C, int d, int batch,
                   void* stream) {
  return launch<float, false>(s, a, n1, b, n2, m, out, cons, K, C, d, batch,
                              stream);
}

int cwfl_round_bf16(const void* s, const void* a, const void* n1,
                    const void* b, const void* n2, const void* m, void* out,
                    void* cons, int K, int C, int d, int batch,
                    void* stream) {
  return launch<__nv_bfloat16, false>(s, a, n1, b, n2, m, out, cons, K, C,
                                      d, batch, stream);
}

int cwfl_round_guard_f32(const void* s, const void* a, const void* n1,
                         const void* b, const void* n2, const void* m,
                         void* out, void* cons, int K, int C, int d,
                         int batch, void* stream) {
  return launch<float, true>(s, a, n1, b, n2, m, out, cons, K, C, d, batch,
                             stream);
}

int cwfl_round_guard_bf16(const void* s, const void* a, const void* n1,
                          const void* b, const void* n2, const void* m,
                          void* out, void* cons, int K, int C, int d,
                          int batch, void* stream) {
  return launch<__nv_bfloat16, true>(s, a, n1, b, n2, m, out, cons, K, C, d,
                                     batch, stream);
}

}  // extern "C"
