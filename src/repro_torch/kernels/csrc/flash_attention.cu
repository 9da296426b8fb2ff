// Blockwise online-softmax attention (flash attention) in f32 as one
// Hopper kernel on the CUDA cores.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fa_kernel for f32 q, k, v (bf16
// runs on the tensor cores: flash_attention_sm90.cu).  For query head h of
// batch b (KV head h / G, G = H / KV: grouped KV heads are read in place,
// never replicated):
//
//   s[q,k]  = (q[q,:] * D^-0.5) . k[k,:]                  f32 sums
//   s       = cap * tanh(s / cap)                         if cap > 0
//   s       = -1e30 unless k < Skv, and k <= q (causal),
//             and k > q - window (window > 0)
//   o[q,:]  = sum_k softmax_k(s[q,:]) v[k,:]              online: m, l, acc
//   o       = acc / max(l, 1e-30)
//
// What bounds it: operations.  At Gemma-2 9B's prefill shape (B=2, H=16,
// KV=8, S=4,608, D=256) a layer does 4*D operations (2*D multiply-adds)
// per unmasked (q, k) pair, about 348 GFLOP, against some 0.45 GB of q,
// k, v and o; the products run on the CUDA cores (67 TFLOP/s in f32 on
// an H100 SXM), so the least time is about 5.2 ms a layer.
//
// What this design does about it: one block of 256 threads owns 64 query
// rows of one (b, h) and sweeps the KV sequence in tiles of 64 keys.  The
// scaled q tile, each k and v tile, and the tile of probabilities live in
// shared memory; the scores never reach device memory.  Both products are register-tiled: a thread
// computes 4 rows x 4 keys of the score tile (keys strided by 16, so the
// k rows a quarter-warp reads fall in distinct banks) and 4 rows x D/16
// columns of the output, from 128-bit shared loads.  The 16 threads that
// share a row take its max and sum with half-warp shuffles, and every one
// of them keeps the row's m and l.  KV tiles that lie wholly above the
// causal diagonal or below the window are skipped: the result is the same,
// because a tile that is masked for a whole row adds p = 0 after the row's
// first valid key and is wiped by corr = exp(-1e30 - m) = 0 before it.
// Query blocks run heaviest first (reversed), so the causal tail is short.
// The ragged edges (Sq, Skv not multiples of 64, Sq = 1) are masked here;
// nothing is padded in device memory.  TF32 or bf16 tensor cores,
// TMA and pipelining are left to later work.
//
// Plain C interface, bound with ctypes
// (src/repro_torch/kernels/flash_attention.py): flash_attention_f32
// launches on the given stream and returns the first CUDA error, or 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows, tx keys / columns
constexpr int kPad = 4;        // floats of padding on the q, k and p rows
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages q, k and v tiles alike");

template <int D>
struct Shape {
  static_assert(D % 32 == 0 && D <= 256, "D is 32, 64, 128 or 256");
  static constexpr int kVec = D >= 64 ? 4 : 2;      // columns per load
  static constexpr int kGroups = D / (16 * kVec);   // loads per row
  static constexpr int kLd = D + kPad;              // q, k row stride
  static constexpr int kLdP = kBK + kPad;           // p row stride
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kBQ) * kLd + kBK * kLd +
                       kBK * D + kBQ * kLdP);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copy a (64, D) tile starting at global row `row0` into
// shared memory with row stride `ld`, multiplied by `scale`; rows at or
// past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int limit, float scale) {
  constexpr int kQuads = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kQuads; idx += kThreads) {
    const int r = idx / kQuads;
    const int c = (idx % kQuads) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) {
      x = load4(src + static_cast<int64_t>(row0 + r) * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int H,
                           int KV, int Sq, int Skv, bool causal, int window,
                           float cap, float scale) {
  using S = Shape<D>;
  extern __shared__ float smem[];
  float* qs = smem;                // (kBQ, kLd)   q * D^-0.5
  float* ks = qs + kBQ * S::kLd;   // (kBK, kLd)
  float* vs = ks + kBK * S::kLd;   // (kBK, D)
  float* ps = vs + kBK * D;        // (kBQ, kLdP)  probabilities

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * kBQ;
  const int G = H / KV;

  const float* qp = q + (static_cast<int64_t>(b) * H + h) * Sq * D;
  const float* kp = k + (static_cast<int64_t>(b) * KV + h / G) * Skv * D;
  const float* vp = v + (static_cast<int64_t>(b) * KV + h / G) * Skv * D;
  float* op = o + (static_cast<int64_t>(b) * H + h) * Sq * D;

  load_tile<D>(qs, S::kLd, qp, q0, Sq, scale);

  // The KV range any row of this block can see.
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  float m[4], l[4], acc[4][S::kGroups * S::kVec];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < S::kGroups * S::kVec; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    load_tile<D>(ks, S::kLd, kp, k0, Skv, 1.f);
    load_tile<D>(vs, D, vp, k0, Skv, 1.f);
    __syncthreads();

    // Scores: rows ty*4 + i, keys tx + 16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (ty * 4 + i) * S::kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(ks + (tx + 16 * j) * S::kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Softcap, mask, and the online-softmax update of each row.
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        ps[(ty * 4 + i) * S::kLdP + tx + 16 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * corr + p v: rows ty*4 + i, columns g*16*kVec + tx*kVec + e.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < S::kGroups * S::kVec; ++c) acc[i][c] *= corr[i];
#pragma unroll 1
    for (int kk = 0; kk < kBK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = load4(ps + (ty * 4 + i) * S::kLdP + kk);
        pv[i][0] = x.x;
        pv[i][1] = x.y;
        pv[i][2] = x.z;
        pv[i][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (kk + e) * D + tx * S::kVec;
#pragma unroll
        for (int g = 0; g < S::kGroups; ++g) {
          float vv[S::kVec];
          if constexpr (S::kVec == 4) {
            const float4 x = load4(vrow + g * 16 * S::kVec);
            vv[0] = x.x;
            vv[1] = x.y;
            vv[2] = x.z;
            vv[3] = x.w;
          } else {
            const float2 x =
                *reinterpret_cast<const float2*>(vrow + g * 16 * S::kVec);
            vv[0] = x.x;
            vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < S::kVec; ++c)
              acc[i][g * S::kVec + c] =
                  fmaf(pv[i][e], vv[c], acc[i][g * S::kVec + c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = op + static_cast<int64_t>(row) * D + tx * S::kVec;
#pragma unroll
    for (int g = 0; g < S::kGroups; ++g)
#pragma unroll
      for (int c = 0; c < S::kVec; ++c)
        orow[g * 16 * S::kVec + c] = acc[i][g * S::kVec + c] / denom;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int Sq, int Skv, int causal, int window,
             float cap, float scale, void* stream) {
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<D>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ), H, B);
  kernel<<<grid, kThreads, Shape<D>::kSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Skv,
      causal != 0, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Skv, int D, int causal, int window,
           float cap, float scale, void* stream) {
  switch (D) {
    case 32:
      return launch_d<32>(q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                             cap, scale, stream);
    case 64:
      return launch_d<64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                             cap, scale, stream);
    case 128:
      return launch_d<128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                              cap, scale, stream);
    case 256:
      return launch_d<256>(q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                              cap, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int D,
                        int causal, int window, float cap, float scale,
                        void* stream) {
  return launch(q, k, v, o, B, H, KV, Sq, Skv, D, causal, window, cap,
                scale, stream);
}

}  // extern "C"
