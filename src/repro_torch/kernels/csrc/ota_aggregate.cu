// The phase-1 OTA MAC of CWFL (y = W S + N) as one Hopper kernel launch.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ota_aggregate.py::_ota_kernel (pallas_call at :68).
// For every row c of W and every column j of the flat dimension d:
//
//   y[c,j] = sum_k W[c,k] * S[k,j] + N[c,j]
//
// with f32 sums (fmaf in ascending k from 0, then + N, then the cast) and
// y written in S's dtype: bitwise the result of the one-column-a-thread
// design this replaces.
//
// What bounds it.  The least traffic reads S (K x d) and N (C x d) once and
// writes y (C x d) once; at an H100 SXM's 3.35 TB/s and K = 50,
// d = 184,214 in f32 that is 38.3 MB, 11.4 us at C = 1 (FedAvg, COTAF);
// 41.3 MB, 12.3 us at C = 3 (CWFL's phase 1; 6.2 us in bf16); and
// 110.5 MB, 33.0 us at C = K = 50 (decentralized consensus).  The work is
// 2 C K d FLOP, 0.92 GFLOP at C = K = 50: 13.7 us at 67 TFLOP/s on the
// CUDA cores, under the bytes.  A column costs 12 K bytes (S, N, y at
// C = K) against 2 K^2 FLOP, so f32 on the CUDA cores stays bound by the
// bytes up to C = K of about 120 (67 / 3.35 = 20 FLOP a byte); above that
// the tensor cores (3xTF32 wgmma) are the next step.
//
// Two paths, one launch either way, chosen by ota::make_plan (ota_plan.h,
// plain C++: the wrapper and the tests read the plan back through
// ota_aggregate_plan_batched()), which also fixes the ring's shared-memory layout.
// One launch takes any C and K with C x K < 2^31.
//
// C <= 8 (with W's C x K floats in a block's shared memory, opted in past
// 48 KB): the column path.  One thread a column, S read straight into
// registers (8 rows in flight), S, N and y streamed past L2 (evict
// first).  With so few rows a tile
// of S in shared memory serves little reuse, and on the card this
// streamed faster than the ring and than 16-byte vectors of S a thread
// (scripts/ota_column_variants.py; PERF.md, the kernel table).
//
// C > 8, the ring.  What it does about what held the one-column design
// back at C = 50 (4 launches of 16 rows, each reading all of S; one
// shared-memory read of W for every FMA; 4-byte loads, no overlap):
//
// 1. S read once for all C rows.  A block owns a tile of 32 V columns
//    (V = 4 in f32, 8 in bf16: one 16-byte vector a lane) and brings the
//    tile's K rows of S (K = 50 f32: 25.6 KB) and its C rows of N into a
//    stage once.  Its warps (8, or 16 when one block fills an SM) run every
//    row of W against the resident tile, R rows a warp at a time (R in
//    {2, 4, 8}, the smallest that spreads C over the warps), several passes
//    when C > warps x R.  When two such stages and W do not fit, S is
//    streamed in chunks of up to 64 rows with the matching chunk of W, once
//    for each pass: S's traffic is then K d times the number of passes
//    (C = K = 128: two passes; wide_k, K = 1,000).
// 2. Register tiles.  A lane keeps R x V sums.  It reads 4 consecutive
//    weights of a row in one 16-byte shared-memory broadcast, so each
//    weight fetched feeds V FMAs and each 16-byte vector of S fetched
//    feeds R rows.
// 3. Memory kept busy.  A persistent grid (two blocks of 8 warps an SM
//    where shared memory allows, else one block) walks the column tiles
//    through a ring of stages filled by the TMA (cp.async.bulk, one copy a
//    row, evict-first), each stage completing on its mbarrier: the next
//    item's loads are in flight while this one's FMAs and stores run.  A
//    depth of 2 measured faster than 3 or 4 at every ring shape.  W is
//    staged once a block, behind the first tile's loads.  y leaves as
//    16-byte streaming stores.
// 4. Misaligned rows.  A row of S, N or y starts on a 16-byte boundary only
//    when d is a multiple of the vector: at d = 184,214 every other f32
//    row is 8 bytes off, which also rules out a tensor map (it needs
//    16-byte row strides).  Each row is copied as the 16-byte chunks that
//    hold it (one chunk more in its pitch) and lands shifted; after item
//    it is computed the warps move item it + 1's rows of S back in place
//    (realign_rows), N is read shifted once, and y is stored at the widest
//    width each row's address allows.  The ragged edge is masked; nothing
//    is padded; element offsets are 64-bit.
//
// A trajectory axis (the counterpart of jax.vmap over the Pallas call, which
// gives its grid a leading axis): one launch may run B independent products,
// the stacked trajectories of a Monte-Carlo sweep, with S, W, N and y
// stacked as (B, K, d), (B, C, K), (B, C, d) and (B, C, d).  The grid's y
// dimension is the trajectory; each block moves its pointers to its own
// trajectory (64-bit offsets) and runs as at B = 1, so both paths, the
// ring's layout and its realignment (a trajectory's rows start where its
// own pointer says) are unchanged.  ota::make_plan divides the ring's
// persistent grid over the trajectories.  The ring copies rows by their
// addresses (cp.async.bulk), with no tensor map, so nothing is encoded on
// the host per trajectory.  The offsets are a template flag (kBatched): a
// launch of one trajectory runs the unbatched instantiation, the code of
// the kernel before the axis existed, bit for bit.
//
// N is read as f32 or as S's dtype (the JAX tests pass it in S's dtype, the
// flat phase-1 route in f32); W as f32 or bf16, widened to f32 exactly as
// it is staged in shared memory (no cast launch for bf16 weights).
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() after the launch, or -1 for
// a shape beyond one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ota_plan.h"

namespace {

using ota::kColumnThreads;
using ota::kPitch;
using ota::kStages;
using ota::Layout;
using ota::make_layout;

template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);  // columns a lane
  static constexpr int kTile = 32 * V;      // columns a ring tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
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

// An L2 policy for data read or written once: evict it first.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned) by the TMA, completing on `bar`, under L2 `policy`.
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, min(r0 + rows, rmax)) of src (row stride `stride` elements),
// columns [j0, min(j0 + (kChunks - 1) * 16 / sizeof(X), jmax)), into dst
// (row pitch kChunks * 16 bytes), one TMA copy a row, issued by lane 0 of
// warp r % warps; returns the bytes this lane issued.  A row goes as the
// 16-byte chunks that hold it, from its address rounded down to 16 bytes:
// at most one chunk more than its bytes, and a misaligned row lands
// shifted by its address mod 16 (realign_rows() moves it back, or its
// reader shifts it).  A chunk that holds one byte of the tensor lies in
// the same 16-byte granule, so it never faults.
template <int kChunks, typename X>
__device__ __forceinline__ uint32_t load_rows(unsigned char* dst,
                                              const X* src, int64_t stride,
                                              int r0, int rows, int rmax,
                                              int64_t j0, int64_t jmax,
                                              uint32_t bar) {
  if (threadIdx.x % 32) return 0;
  const uint64_t policy = evict_first();
  const int64_t nbytes =
      min(static_cast<int64_t>((kChunks - 1) * 16 / sizeof(X)), jmax - j0) *
      static_cast<int64_t>(sizeof(X));
  const int nrows = min(rows, rmax - r0);
  uint32_t issued = 0;
  for (int r = threadIdx.x / 32; r < nrows; r += blockDim.x / 32) {
    const uintptr_t a =
        reinterpret_cast<uintptr_t>(src + (r0 + r) * stride + j0);
    const uintptr_t base = a & ~static_cast<uintptr_t>(15);
    const uint32_t bytes = static_cast<uint32_t>(
        ((a + nbytes + 15) & ~static_cast<uintptr_t>(15)) - base);
    bulk_load(dst + r * kChunks * 16, base, bytes, bar, policy);
    issued += bytes;
  }
  return issued;
}

// Bytes [sb, sb + 16) of the 32 bytes a, b (sb < 16, even), without
// branches: words by the bits of sb / 4, then a funnel shift for sb % 4.
__device__ __forceinline__ uint4 shift_bytes(const uint4& a, const uint4& b,
                                             int sb) {
  const bool w2 = sb & 8, w1 = sb & 4;
  const uint32_t c0 = w2 ? a.z : a.x, c1 = w2 ? a.w : a.y,
                 c2 = w2 ? b.x : a.z, c3 = w2 ? b.y : a.w,
                 c4 = w2 ? b.z : b.x;
  const uint32_t d0 = w1 ? c1 : c0, d1 = w1 ? c2 : c1, d2 = w1 ? c3 : c2,
                 d3 = w1 ? c4 : c3;
  if (!(sb & 2)) return make_uint4(d0, d1, d2, d3);
  const uint32_t c5 = w2 ? b.w : b.y, d4 = w1 ? c5 : c4;
  return make_uint4(__funnelshift_r(d0, d1, 16), __funnelshift_r(d1, d2, 16),
                    __funnelshift_r(d2, d3, 16), __funnelshift_r(d3, d4, 16));
}

// A lane's 16 bytes of a row that landed sb bytes late (load_rows): its
// chunk and the next, shifted.  p: the lane's chunk, in shared memory.
template <bool kShift>
__device__ __forceinline__ uint4 lds16(const void* p, int sb) {
  const uint4* q = static_cast<const uint4*>(p);
  if (!kShift) return q[0];
  return shift_bytes(q[0], q[1], sb);
}

// The warps move the misaligned rows of S in a stage (row r landed
// (sb0 + r * sbd) % 16 bytes late) to the start of their pitch, in place,
// a warp four rows at a time: every lane reads its chunk and the next of
// each, the warp syncs, every lane writes.
__device__ __forceinline__ void realign_rows(unsigned char* st, int rows,
                                             int sb0, int sbd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  for (int r0 = warp; r0 < rows; r0 += 4 * nw) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * nw, sb = (sb0 + r * sbd) & 15;
      if (r < rows && sb) v[i] = lds16<true>(st + r * kPitch + lane * 16, sb);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * nw;
      if (r < rows && (sb0 + r * sbd) & 15)
        reinterpret_cast<uint4*>(st + r * kPitch)[lane] = v[i];
    }
  }
}

// 16 bytes to global p (aligned to 2 bytes) at the widest width its
// address allows, as streaming stores (written once, evicted first).
__device__ __forceinline__ void st16(void* p, const uint4& v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    __stcs(static_cast<uint4*>(p), v);
  } else if ((a & 7) == 0) {
    __stcs(static_cast<uint2*>(p), make_uint2(v.x, v.y));
    __stcs(static_cast<uint2*>(p) + 1, make_uint2(v.z, v.w));
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if ((a & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        __stcs(static_cast<unsigned int*>(p) + i, w[i]);
    } else {
      unsigned short* h = static_cast<unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __stcs(h + 2 * i, static_cast<unsigned short>(w[i]));
        __stcs(h + 2 * i + 1, static_cast<unsigned short>(w[i] >> 16));
      }
    }
  }
}

// A 16-byte vector as floats: 4 f32 or 8 bf16 (a bf16 is the high half of
// its f32).
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// V elements of X at p (shared, 16-byte aligned; a row that landed sb
// bytes late) as floats.
template <bool kShift, typename X, int V>
__device__ __forceinline__ void load_smem(const X* p, int sb, float (&f)[V]) {
  constexpr int kPer = 16 / sizeof(X);
#pragma unroll
  for (int i = 0; i < V / kPer; ++i)
    unpack(lds16<kShift>(p + i * kPer, sb), f + i * kPer, X());
}

// The `n` (<= V) elements at p from f, cast to T (V T's are 16 bytes).
template <typename T, int V>
__device__ __forceinline__ void store_row(T* p, int n, const float (&f)[V]) {
  if (n == V) {
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = bits(from_f32<T>(f[i]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = bits(from_f32<T>(f[2 * i])) |
               (bits(from_f32<T>(f[2 * i + 1])) << 16);
    }
    st16(p, make_uint4(w[0], w[1], w[2], w[3]));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n) p[i] = from_f32<T>(f[i]);
  }
}

// acc[r][v] += sum over k < kn of w[r * wstride + k] * s[k][v], one fmaf at
// a time in ascending k.  w: shared, 16-byte aligned rows (wstride a
// multiple of 4); s: this lane's columns of a shared tile (row pitch
// kPitch).
template <typename T, int R>
__device__ __forceinline__ void mac(float (&acc)[R][Vec<T>::V],
                                    const float* w, int wstride, const T* s,
                                    int kn) {
  constexpr int V = Vec<T>::V, kStep = kPitch / sizeof(T);
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= kn; k += 4) {
    float sv[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      unpack(*reinterpret_cast<const uint4*>(s + (k + q) * kStep), sv[q],
             T());
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + r * wstride + k);
      const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r][v] = fmaf(wq[q], sv[q][v], acc[r][v]);
    }
  }
  for (; k < kn; ++k) {
    float sv[V];
    unpack(*reinterpret_cast<const uint4*>(s + k * kStep), sv, T());
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float wk = w[r * wstride + k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(wk, sv[v], acc[r][v]);
    }
  }
}

// W rows [r0, r0 + rows) x columns [k0, k0 + kcols) into dst (row stride
// `stride` floats), a warp a row; rows >= C and columns past kcols are
// zero-filled.  f32 W comes by cp.async; bf16 W (w_bf16) is loaded and
// widened to f32 here, exactly (the caller's barrier publishes both).
__device__ __forceinline__ void load_w(float* dst, int stride, const void* w,
                                       int w_bf16, int K, int C, int r0,
                                       int rows, int k0, int kcols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* wf = static_cast<const float*>(w);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w);
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const bool live = r0 + r < C;
    const int64_t row = static_cast<int64_t>(r0 + r) * K + k0;
    for (int k = lane; k < stride; k += 32) {
      const bool ok = live && k < kcols;
      if (w_bf16)
        dst[r * stride + k] = ok ? __bfloat162float(wh[row + k]) : 0.f;
      else
        cp_async4(dst + r * stride + k, ok ? wf + row + k : wf, ok ? 4 : 0);
    }
  }
}

// All n floats of W (f32, or bf16 widened exactly) into dst, by the block.
__device__ __forceinline__ void stage_w(float* dst, const void* w, int w_bf16,
                                        int n) {
  const float* wf = static_cast<const float*>(w);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = w_bf16 ? __bfloat162float(wh[i]) : wf[i];
}

// Where a block is in its sequence of items: its tile (0.. of its own),
// the pass and the chunk of K within the tile (streamed), and the stage.
struct Cursor {
  int tile = 0, pass = 0, chunk = 0, slot = 0, phase = 0;
  __device__ void next(const Layout& L) {
    if (++chunk == L.chunks) {
      chunk = 0;
      if (L.resident || ++pass == L.passes) pass = 0, ++tile;
    }
    if (++slot == kStages) slot = 0, phase ^= 1;
  }
};

// 8 or 16 warps a block, at most 128 registers a thread (two blocks of 8
// warps, or one of 16, an SM), but with R = 8: its 32 sums a lane need
// more, and it runs one block of 8 warps an SM.
template <typename T, typename TN, int R, bool kRealign, bool kBatched>
__global__ void __launch_bounds__(R == 8 ? 256 : 512, 1)
    ota_aggregate_kernel(const T* __restrict__ s, const void* __restrict__ w,
                         int w_bf16,
                         const TN* __restrict__ n, T* __restrict__ out, int K,
                         int C, int64_t d, int kc) {
  if constexpr (kBatched) {  // this block's trajectory
    const int64_t traj = blockIdx.y;
    s += traj * K * d;
    n += traj * C * d;
    out += traj * C * d;
    w = static_cast<const unsigned char*>(w) +
        traj * C * K * (w_bf16 ? 2 : 4);
  }
  constexpr int V = Vec<T>::V, kTile = Vec<T>::kTile;
  constexpr int kNRow = kTile * sizeof(TN), kNChunks = kNRow / 16 + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const Layout L = make_layout(K, C, R, kc, kNRow, warps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = static_cast<int>((d + kTile - 1) / kTile);
  const int my_tiles = static_cast<int>(blockIdx.x) < tiles
                           ? (tiles - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  // An item is what one stage holds: a tile (resident), or one pass's
  // chunk of K for a tile (streamed).
  const int items = my_tiles * (L.resident ? 1 : L.passes * L.chunks);
  float* w_res = reinterpret_cast<float*>(smem + kStages * L.stage_bytes);
  // Row r of S (of N) starts (sb0 + r * sbd) % 16 bytes past a 16-byte
  // boundary, and lands that late in its stage (load_rows); a tile's first
  // column moves it by a multiple of 512 bytes.
  const int s_sb0 = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
  const int s_sbd = static_cast<int>((d * sizeof(T)) & 15);
  const int n_sb0 = static_cast<int>(reinterpret_cast<uintptr_t>(n) & 15);
  const int n_sbd = static_cast<int>((d * sizeof(TN)) & 15);
  const auto j0_of = [&](const Cursor& c) {
    return (static_cast<int64_t>(blockIdx.x) +
            static_cast<int64_t>(c.tile) * gridDim.x) * kTile;
  };

  // A stage's mbarrier: one arrival a warp, and the bytes its TMA copies.
  const uint32_t bars = smem_addr(smem + L.bar_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, warps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // An item into its stage: S's rows of its chunk; N's rows of the tile
  // (resident) or of the pass, with its last chunk; the pass's W chunk
  // (streamed).
  const auto load = [&](const Cursor& c) {
    unsigned char* st = smem + c.slot * L.stage_bytes;
    const uint32_t bar = bars + 8 * c.slot;
    const int64_t j0 = j0_of(c);
    const int k0 = c.chunk * L.kc, r0 = c.pass * L.pass_rows;
    uint32_t bytes = load_rows<kPitch / 16>(st, s, d, k0, L.kc, K, j0, d, bar);
    if (L.resident) {
      bytes += load_rows<kNChunks>(st + L.n_off, n, d, 0, C, C, j0, d, bar);
    } else {
      load_w(reinterpret_cast<float*>(st + L.w_off), L.kc, w, w_bf16, K, C, r0,
             L.pass_rows, k0, min(L.kc, K - k0));
      if (c.chunk == L.chunks - 1)
        bytes += load_rows<kNChunks>(st + L.n_off, n, d, r0, L.pass_rows, C,
                                     j0, d, bar);
    }
    if (lane == 0) mbar_arrive_expect_tx(bar, bytes);
  };

  // Prologue: the first item, and W (resident) behind its S and N.  W
  // (and a streamed item's chunk of W) comes by cp.async, S and N by TMA.
  Cursor ahead;
  if (items > 0) {
    load(ahead);
    if (L.resident)
      load_w(w_res, L.kp, w, w_bf16, K, C, 0, L.rows_pad, 0, K);
    cp_async_commit();
    ahead.next(L);
  }

  float acc[R][V];
  // + N (rows row0.. of the stage's N, whose first row is n_r0), the cast,
  // the store of this lane's columns j.. (nv of them).
  const auto finish = [&](const unsigned char* st, int row0, int n_r0,
                          int64_t j, int nv) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= C || nv <= 0) continue;
      float y[V];
      load_smem<kRealign>(reinterpret_cast<const TN*>(
                              st + L.n_off + (row0 + r - n_r0) * L.n_pitch) +
                              lane * V,
                          (n_sb0 + (row0 + r) * n_sbd) & 15, y);
#pragma unroll
      for (int v = 0; v < V; ++v) y[v] = acc[r][v] + y[v];
      store_row(out + static_cast<int64_t>(row0 + r) * d + j, nv, y);
    }
  };
  const auto zero = [&] {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  };

  // Misaligned rows of S in an item's stage to the start of their pitch
  // (N is read shifted, once).
  const auto realign_item = [&](const Cursor& c) {
    mbar_wait(bars + 8 * c.slot, c.phase);
    const int k0 = c.chunk * L.kc;
    realign_rows(smem + c.slot * L.stage_bytes, min(L.kc, K - k0),
                 (s_sb0 + k0 * s_sbd) & 15, s_sbd);
    // The TMA writes this stage again after these stores.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // With misaligned rows, item it + 1 is realigned after item it is
  // computed (it has landed meanwhile), by every warp, and the barrier at
  // the top of the next iteration publishes it.
  Cursor c;
  if (kRealign && items > 0) realign_item(c);
  for (int it = 0; it < items; ++it, c.next(L)) {
    cp_async_wait_all();  // this item's W
    __syncthreads();  // everyone is done with item it - 1 and its stage
    if (it + 1 < items) {
      load(ahead);
      cp_async_commit();
      ahead.next(L);
    }
    if (!kRealign) mbar_wait(bars + 8 * c.slot, c.phase);

    unsigned char* st = smem + c.slot * L.stage_bytes;
    const int k0 = c.chunk * L.kc, krows = min(L.kc, K - k0);
    const int r0 = c.pass * L.pass_rows;
    const bool last_chunk = c.chunk == L.chunks - 1;
    const T* s_lane = reinterpret_cast<const T*>(st) + lane * V;
    const int64_t j = j0_of(c) + lane * V;
    const int nv = static_cast<int>(
        max(static_cast<int64_t>(0), min(static_cast<int64_t>(V), d - j)));
    if (L.resident) {
      for (int row0 = warp * R; row0 < C; row0 += L.pass_rows) {
        zero();
        mac<T, R>(acc, w_res + row0 * L.kp, L.kp, s_lane, K);
        finish(st, row0, 0, j, nv);
      }
    } else if (r0 + warp * R < C) {
      if (c.chunk == 0) zero();
      mac<T, R>(acc, reinterpret_cast<const float*>(st + L.w_off) +
                         warp * R * L.kc,
                L.kc, s_lane, krows);
      if (last_chunk) finish(st, r0 + warp * R, r0, j, nv);
    }
    if (kRealign && it + 1 < items) {
      Cursor c1 = c;
      c1.next(L);
      realign_item(c1);
    }
  }
  cp_async_wait_all();
}

template <typename T, typename TN, int R>
int launch_r(const T* s, const void* w, int w_bf16, const TN* n, T* out,
             int K, int C, int64_t d, int batch, const ota::Plan& p,
             cudaStream_t stream) {
  // Every row of S and N on a 16-byte boundary: nothing to realign.
  const bool aligned = ((reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(n)) & 15) == 0 &&
                       (d * sizeof(T)) % 16 == 0 && (d * sizeof(TN)) % 16 == 0;
  auto kernel =
      batch > 1 ? (aligned ? ota_aggregate_kernel<T, TN, R, false, true>
                           : ota_aggregate_kernel<T, TN, R, true, true>)
                : (aligned ? ota_aggregate_kernel<T, TN, R, false, false>
                           : ota_aggregate_kernel<T, TN, R, true, false>);
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(p.grid, batch), 32 * p.warps, p.smem_bytes, stream>>>(
      s, w, w_bf16, n, out, K, C, d, p.kc);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// C <= 8: the column path.  One thread a column, the C rows of W in shared
// memory (bf16 weights widened as they are staged), S read straight into
// registers with the loop over its rows unrolled kUnroll deep (that many
// loads in flight); each sum in ascending k with fmaf from 0, then + N,
// then the cast, as in the ring.  S, N and y
// stream past L2 (evict first).  With so few rows a tile of S in shared
// memory serves little reuse, and one column a thread streamed faster than
// the ring and than 16-byte vectors a thread at these shapes (PERF.md,
// scripts/ota_column_variants.py).
template <typename T, typename TN, int C, bool kBatched>
__global__ void __launch_bounds__(kColumnThreads)
    ota_column_kernel(const T* __restrict__ s, const void* __restrict__ w,
                      int w_bf16, const TN* __restrict__ n,
                      T* __restrict__ out, int K, int64_t d) {
  if constexpr (kBatched) {  // this block's trajectory
    const int64_t traj = blockIdx.y;
    s += traj * K * d;
    n += traj * C * d;
    out += traj * C * d;
    w = static_cast<const unsigned char*>(w) +
        traj * C * K * (w_bf16 ? 2 : 4);
  }
  constexpr int kUnroll = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // (C, K)
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = j < d;
  stage_w(ws, w, w_bf16, C * K);
  __syncthreads();
  if (!live) return;

  float acc[C];
#pragma unroll
  for (int r = 0; r < C; ++r) acc[r] = 0.f;
#pragma unroll kUnroll
  for (int k = 0; k < K; ++k) {
    const float sk = to_f32(__ldcs(s + k * d + j));
#pragma unroll
    for (int r = 0; r < C; ++r) acc[r] = fmaf(ws[r * K + k], sk, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < C; ++r)
    __stcs(out + r * d + j,
           from_f32<T>(acc[r] + to_f32(__ldcs(n + r * d + j))));
}

template <typename T, typename TN, int C>
int launch_column(const T* s, const void* w, int w_bf16, const TN* n, T* out,
                  int K, int64_t d, int batch, const ota::Plan& p,
                  cudaStream_t stream) {
  auto kernel = batch > 1 ? ota_column_kernel<T, TN, C, true>
                          : ota_column_kernel<T, TN, C, false>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(p.grid, batch), 32 * p.warps, p.smem_bytes, stream>>>(
      s, w, w_bf16, n, out, K, d);
  return static_cast<int>(cudaGetLastError());
}

// One launch by ota::make_plan on the current device; kOutOfRange when the
// shape lies beyond one launch.
constexpr int kOutOfRange = -1;

template <typename T, typename TN>
int launch(const void* s, const void* w, int w_bf16, const void* n,
           void* out, int K, int C, long long d, int batch, void* stream) {
  const T* sp = static_cast<const T*>(s);
  const TN* np = static_cast<const TN*>(n);
  T* op = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  ota::Plan p;
  if (ota::make_plan(K, C, d, sizeof(T), sizeof(TN), sms, &p, batch))
    return kOutOfRange;
  if (!p.ring) {
    switch (C) {
#define OTA_COLUMN(CC) \
  case CC:             \
    return launch_column<T, TN, CC>(sp, w, w_bf16, np, op, K, d, batch, p, \
                                    st);
      OTA_COLUMN(1) OTA_COLUMN(2) OTA_COLUMN(3) OTA_COLUMN(4)
      OTA_COLUMN(5) OTA_COLUMN(6) OTA_COLUMN(7) OTA_COLUMN(8)
#undef OTA_COLUMN
    }
  } else if (p.rows == 2) {
    return launch_r<T, TN, 2>(sp, w, w_bf16, np, op, K, C, d, batch, p, st);
  } else if (p.rows == 4) {
    return launch_r<T, TN, 4>(sp, w, w_bf16, np, op, K, C, d, batch, p, st);
  } else if constexpr (Vec<T>::V == 4) {
    if (p.rows == 8)
      return launch_r<T, TN, 8>(sp, w, w_bf16, np, op, K, C, d, batch, p,
                                st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// W is f32, or bf16 when w_bf16 != 0 (widened exactly as it is staged);
// `batch` trajectories (1..65535) stacked along a leading axis.

// S f32, N f32.
int ota_aggregate_f32(const void* s, const void* w, int w_bf16, const void* n,
                      void* out, int K, int C, long long d, int batch,
                      void* stream) {
  return launch<float, float>(s, w, w_bf16, n, out, K, C, d, batch, stream);
}

// S bf16, N f32.
int ota_aggregate_bf16(const void* s, const void* w, int w_bf16,
                       const void* n, void* out, int K, int C, long long d,
                       int batch, void* stream) {
  return launch<__nv_bfloat16, float>(s, w, w_bf16, n, out, K, C, d, batch,
                                      stream);
}

// S bf16, N bf16.
int ota_aggregate_bf16_bf16noise(const void* s, const void* w, int w_bf16,
                                 const void* n, void* out, int K, int C,
                                 long long d, int batch, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(s, w, w_bf16, n, out, K, C, d,
                                              batch, stream);
}

}  // extern "C"
