// The phase-1 OTA MAC of CWFL (y = W S + N) as one Hopper kernel.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ota_aggregate.py::_ota_kernel.  For every cluster c
// and every column j of the flat parameter dimension d:
//
//   y[c,j] = sum_k W[c,k] * S[k,j] + N[c,j]
//
// with f32 sums and y written in S's dtype.
//
// What bounds it: memory.  The MAC must read S (K*d) and N (C*d) and write
// y (C*d): 41.3 MB at the paper's MNIST width (K=50, C=3, d=184,214, f32),
// about 12.3 us at an H100 SXM's 3.35 TB/s, against 55 MFLOP of work.
//
// What this design does about it: it reads S exactly once for all the
// clusters of a launch.  The Pallas kernel's grid is (C, d/tile), which
// re-reads the whole (K, tile) block of S for every cluster; here one
// thread owns one column, neighbouring threads neighbouring columns, so a
// warp's loads of a row of S are coalesced, and keeps the column's C sums
// in registers (C is a template parameter, 1..kMaxC).  The loop over the
// rows of S is unrolled kUnroll deep, so a thread keeps that many loads in
// flight; with one column a thread the card holds enough threads to hide
// the memory's latency (four columns a thread, and fewer threads, ran
// slower).  W (C x K, f32) is staged in shared memory once per block;
// every thread of a warp reads the same W[c,k], a broadcast.  Element
// offsets are 64-bit.  The ragged edge is masked; nothing is padded.
// Wider loads, TMA and a persistent grid are left to later work.
//
// N is read as f32 or as S's dtype (the JAX tests pass it in S's dtype, the
// flat phase-1 route in f32).  The wrapper casts W to f32 and runs clusters
// beyond kMaxC in groups of kMaxC, one launch (and one read of S) a group.
//
// Plain C interface, bound with ctypes
// (src/repro_torch/kernels/ota_aggregate.py): each entry point launches on
// the given stream and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxC = 16;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;
// The most dynamic shared memory a block may opt in to on Hopper.
constexpr size_t kMaxSmem = 232448;

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

template <typename T, typename TN, int C>
__global__ void __launch_bounds__(kThreads)
    ota_aggregate_kernel(const T* __restrict__ s, const float* __restrict__ w,
                         const TN* __restrict__ n, T* __restrict__ out, int K,
                         int64_t d) {
  extern __shared__ float ws[];  // (C, K)
  for (int i = threadIdx.x; i < C * K; i += blockDim.x) ws[i] = w[i];
  __syncthreads();

  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= d) return;

  // y[:, j] = W S[:, j], one row of S at a time, in index order.
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll kUnroll
  for (int k = 0; k < K; ++k) {
    const float sk = to_f32(s[static_cast<int64_t>(k) * d + j]);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(ws[c * K + k], sk, acc[c]);
  }

  // + N, written in S's dtype.
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t off = static_cast<int64_t>(c) * d + j;
    out[off] = from_f32<T>(acc[c] + to_f32(n[off]));
  }
}

template <typename T, typename TN, int C>
int launch_c(const T* s, const float* w, const TN* n, T* out, int K,
             int64_t d, cudaStream_t stream) {
  auto kernel = ota_aggregate_kernel<T, TN, C>;
  const size_t smem = sizeof(float) * static_cast<size_t>(C) * K;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads));
  kernel<<<grid, kThreads, smem, stream>>>(s, w, n, out, K, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TN>
int launch(const void* s, const void* w, const void* n, void* out, int K,
           int C, long long d, void* stream) {
  const T* sp = static_cast<const T*>(s);
  const float* wp = static_cast<const float*>(w);
  const TN* np = static_cast<const TN*>(n);
  T* op = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kMaxC == 16, "the switch below covers C = 1..kMaxC");
  switch (C) {
#define OTA_CASE(CC) \
  case CC:           \
    return launch_c<T, TN, CC>(sp, wp, np, op, K, d, st);
    OTA_CASE(1) OTA_CASE(2) OTA_CASE(3) OTA_CASE(4)
    OTA_CASE(5) OTA_CASE(6) OTA_CASE(7) OTA_CASE(8)
    OTA_CASE(9) OTA_CASE(10) OTA_CASE(11) OTA_CASE(12)
    OTA_CASE(13) OTA_CASE(14) OTA_CASE(15) OTA_CASE(16)
#undef OTA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// S f32, N f32.
int ota_aggregate_f32(const void* s, const void* w, const void* n, void* out,
                      int K, int C, long long d, void* stream) {
  return launch<float, float>(s, w, n, out, K, C, d, stream);
}

// S bf16, N f32.
int ota_aggregate_bf16(const void* s, const void* w, const void* n,
                       void* out, int K, int C, long long d, void* stream) {
  return launch<__nv_bfloat16, float>(s, w, n, out, K, C, d, stream);
}

// S bf16, N bf16.
int ota_aggregate_bf16_bf16noise(const void* s, const void* w, const void* n,
                                 void* out, int K, int C, long long d,
                                 void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(s, w, n, out, K, C, d,
                                              stream);
}

}  // extern "C"
