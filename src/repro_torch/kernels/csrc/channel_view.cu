// One round of the channel process, its step and its view, in XLA's CPU
// arithmetic, as one Hopper kernel launch.
//
// No Pallas twin: the JAX package computes this round in XLA's fused CPU
// loops (src/repro/sim/processes.py:118-162, src/repro/core/topology.py:54-78).
// The port must get the same bits, because a cluster-head election on the
// round's link SNRs turns on the last ulp at a tie.  Its plain version is
// repro_torch/core/xla_math.py (xla_channel_step, xla_channel_view), whose
// docstring records what the XLA dumps show; this kernel is bitwise that.
//
// For every trajectory b of a (B, K, K) stack (one block each):
//
//   step (do_step != 0): random-waypoint mobility per client, then for
//     every link (i, j), the symmetric draws read from (min, max):
//       w     = conj-mirrored (fade_re, fade_im) * fade_fold
//       h'    = rho * h + innov_std * w            (two roundings a part)
//       s'    = fma(rho_s, s, shadow_std * mirrored(shadow_n * shadow_fold))
//   view: dist = max(sqrt(fma(dy, dy, dx * dx) + 1e-9), d0) * (1 / d0)
//       amp   = powf(dist, -ς/2) * powf(10, s' * (1/20))   (glibc's powf)
//       g     = (h' * amp) * off                   (complex, zero terms kept)
//       snr   = (|g| * |g|) * (P/K / σ²) * off      (XLA's complex abs)
//       adj   = 10 log10(max(snr, 1e-12)) >= outage, i != j   (XLA's log)
//
// The arithmetic is XLA's on the CPU, so every f32 operation is written
// with an intrinsic that rounds once and is never contracted (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), and every FMA XLA's
// machine code has is an explicit __fmaf_rn.  nvcc contracts a plain
// a * b + c into an FMA by default (-fmad=true); the _rn intrinsics are
// the documented way to rule that out without a file-wide flag.  glibc's
// powf works in double: __dmul_rn / __dadd_rn / __dsub_rn and __fma_rn
// where the FMA build of libm has vfmadd.
//
// What bounds it: the (B, K, K) state in and out (h complex, s, the three
// draws, the gains complex, the SNR, the adjacency: 38 bytes a link) is
// 0.76 MB at B = 8, K = 50, 0.23 us at 3.35 TB/s; the two powf and the
// log a link are about 150 double and float operations, so the launch is
// latency-bound at these sizes.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

struct Consts {
  float speed, area, rho, innov_std, rho_s, shadow_std, fade_fold,
      shadow_fold, inv_d0, d0, exponent, inv20, snr_scale, outage_db;
};
constexpr int kNumConsts = 14;

// glibc 2.36 e_powf.c's tables (read off libm.so.6; see xla_math.py).
__constant__ double kLog2Tab[16][2] = {
    {0x1.661ec79f8f3bep+0, -0x1.efec65b963019p-2},
    {0x1.571ed4aaf883dp+0, -0x1.b0b6832d4fca4p-2},
    {0x1.49539f0f010b0p+0, -0x1.7418b0a1fb77bp-2},
    {0x1.3c995b0b80385p+0, -0x1.39de91a6dcf7bp-2},
    {0x1.30d190c8864a5p+0, -0x1.01d9bf3f2b631p-2},
    {0x1.25e227b0b8ea0p+0, -0x1.97c1d1b3b7af0p-3},
    {0x1.1bb4a4a1a343fp+0, -0x1.2f9e393af3c9fp-3},
    {0x1.12358f08ae5bap+0, -0x1.960cbbf788d5cp-4},
    {0x1.0953f419900a7p+0, -0x1.a6f9db6475fcep-5},
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.e608cfd9a47acp-1, 0x1.338ca9f24f53dp-4},
    {0x1.ca4b31f026aa0p-1, 0x1.476a9543891bap-3},
    {0x1.b2036576afce6p-1, 0x1.e840b4ac4e4d2p-3},
    {0x1.9c2d163a1aa2dp-1, 0x1.40645f0c6651cp-2},
    {0x1.886e6037841edp-1, 0x1.88e9c2c1b9ff8p-2},
    {0x1.767dcf5534862p-1, 0x1.ce0a44eb17bccp-2}};
__constant__ double kLog2Poly[5] = {
    0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2, 0x1.ec70a6ca7baddp-2,
    -0x1.7154748bef6c8p-1, 0x1.71547652ab82bp+0};
__constant__ double kExp2Poly[3] = {
    0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3, 0x1.62e42ff0c52d6p-1};
__constant__ unsigned long long kExp2Tab[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};
constexpr double kExp2Shift = 0x1.8p+47;
constexpr double kPowfOflow = 0x1.fffffffd1d571p+6;

// glibc's powf (the FMA build), with the special cases of xla_math.glibc_powf.
__device__ float glibc_powf(float x, float y) {
  const float ax = fabsf(x);
  const bool y_int = floorf(y) == y;
  const bool odd = y_int && fmodf(fabsf(y), 2.0f) == 1.0f;
  const unsigned long long sign_bias = (x < 0.0f && odd) ? (1ull << 16) : 0;
  const bool sub = ax < 0x1p-126f;
  uint32_t ix = __float_as_uint(sub ? __fmul_rn(ax, 0x1p23f) : ax);
  if (sub) ix -= 23u << 23;
  const uint32_t tmp = ix - 0x3F330000u;
  const int i = (tmp >> 19) & 15;
  const uint32_t top = tmp & 0xFF800000u;
  const int k = static_cast<int32_t>(top) >> 23;
  const double z = static_cast<double>(__uint_as_float(ix - top));
  const double r = __fma_rn(z, kLog2Tab[i][0], -1.0);
  const double y0 = __dadd_rn(kLog2Tab[i][1], static_cast<double>(k));
  const double r2 = __dmul_rn(r, r);
  const double p = __fma_rn(r, kLog2Poly[0], kLog2Poly[1]);
  double q = __fma_rn(r, kLog2Poly[2], kLog2Poly[3]);
  const double r4 = __dmul_rn(r2, r2);
  q = __fma_rn(r2, q, __fma_rn(r, kLog2Poly[4], y0));
  const double ylogx = __dmul_rn(static_cast<double>(y), __fma_rn(r4, p, q));
  double kd = __dadd_rn(ylogx, kExp2Shift);
  const unsigned long long ki = __double_as_longlong(kd);
  kd = __dsub_rn(kd, kExp2Shift);
  const double rr = __dsub_rn(ylogx, kd);
  const unsigned long long t = kExp2Tab[ki & 31] + ((ki + sign_bias) << 47);
  const double s = __fma_rn(__fma_rn(rr, kExp2Poly[0], kExp2Poly[1]),
                            __dmul_rn(rr, rr),
                            __fma_rn(rr, kExp2Poly[2], 1.0));
  float out = __double2float_rn(__dmul_rn(s, __longlong_as_double(t)));
  const float sgn = sign_bias ? -1.0f : 1.0f;
  if (ylogx > kPowfOflow) out = sgn * INFINITY;
  if (ylogx <= -150.0) out = sgn * 0.0f;
  if (ylogx > -150.0 && ylogx < -149.0) out = sgn * 0x1p-149f;
  if (x < 0.0f && !y_int) out = NAN;
  if (x == 0.0f) out = y < 0.0f ? sgn * INFINITY : sgn * 0.0f;
  if (isinf(x)) out = y < 0.0f ? sgn * 0.0f : sgn * INFINITY;
  if (isnan(x) || isnan(y)) out = NAN;
  if (isinf(y) && ax == 1.0f) out = 1.0f;
  if (isinf(y) && ax != 1.0f && !isnan(x))
    out = ((ax < 1.0f) == (y < 0.0f)) ? INFINITY : 0.0f;
  if (y == 0.0f) out = 1.0f;
  if (x == 1.0f) out = 1.0f;
  return out;
}

// XLA's inlined CPU log (xla_math.xla_log_f32).
constexpr float kFltMin = 0x1p-126f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
__constant__ float kP[9] = {0x1.2043760p-4f, -0x1.d7a3700p-4f, 0x1.de4a340p-4f,
                           -0x1.fcba9e0p-4f, 0x1.23d37e0p-3f, -0x1.555ca00p-3f,
                           0x1.999d580p-3f, -0x1.ffffff8p-3f, 0x1.5555540p-2f};
constexpr float kLn2Hi = 0x1.630000p-1f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kTenInvLn10 = 0x1.15f2d0p+2f;

__device__ float xla_log(float x) {
  const bool nonpos = !(x > 0.0f);
  const float xc = x <= kFltMin ? kFltMin : x;
  int ex;
  const float m = frexpf(xc, &ex);
  const bool low = m < kSqrtHalf;
  const float u = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float e = __fsub_rn(static_cast<float>(ex), low ? 1.0f : 0.0f);
  const float z = __fmul_rn(u, u);
  const float u3 = __fmul_rn(z, u);
  const float y1 = __fmaf_rn(__fmaf_rn(u, kP[0], kP[1]), u, kP[2]);
  const float y2 = __fmaf_rn(__fmaf_rn(u, kP[3], kP[4]), u, kP[5]);
  const float y3 = __fmaf_rn(__fmaf_rn(u, kP[6], kP[7]), u, kP[8]);
  const float y = __fmaf_rn(__fmaf_rn(y1, u3, y2), u3, y3);
  const float t = __fmaf_rn(y, u3, __fmul_rn(e, kLn2Lo));
  float r = __fadd_rn(__fmaf_rn(z, -0.5f, u), t);
  r = __fmaf_rn(e, kLn2Hi, r);
  if (nonpos) r = NAN;
  if (x == 0.0f) r = -INFINITY;
  if (x == INFINITY) r = INFINITY;
  return r;
}

// NaN-propagating max / min, as torch.maximum and XLA's llvm.maximum.
__device__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

__global__ void channel_round_kernel(
    const float* __restrict__ pos, const float* __restrict__ way,
    const float2* __restrict__ h, const float* __restrict__ shadow,
    const float* __restrict__ fade_re, const float* __restrict__ fade_im,
    const float* __restrict__ shadow_n, const float* __restrict__ way_u,
    float* __restrict__ pos_out, float* __restrict__ way_out,
    float2* __restrict__ h_out, float* __restrict__ shadow_out,
    float2* __restrict__ gain, float* __restrict__ snr,
    bool* __restrict__ adj, int K, int do_step, Consts c) {
  extern __shared__ float s_pos[];            // (K, 2) the round's positions
  const long long b = blockIdx.x;
  const long long kk = static_cast<long long>(K) * K;
  pos += b * 2 * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float px = pos[2 * i], py = pos[2 * i + 1];
    if (do_step) {
      const float* w = way + b * 2 * K + 2 * i;
      const float tx = __fsub_rn(w[0], px), ty = __fsub_rn(w[1], py);
      const float dist = __fsqrt_rn(
          __fadd_rn(__fmaf_rn(ty, ty, __fmul_rn(tx, tx)), 1e-12f));
      const bool arrived = dist <= c.speed;
      const float q = __fdiv_rn(c.speed, dist);
      const float m = isnan(q) ? q : fminf(q, 1.0f);
      const float* u = way_u + b * 2 * K + 2 * i;
      float* wo = way_out + b * 2 * K + 2 * i;
      wo[0] = arrived ? __fmul_rn(u[0], c.area) : w[0];
      wo[1] = arrived ? __fmul_rn(u[1], c.area) : w[1];
      px = __fmaf_rn(m, tx, px);
      py = __fmaf_rn(m, ty, py);
      pos_out[b * 2 * K + 2 * i] = px;
      pos_out[b * 2 * K + 2 * i + 1] = py;
    }
    s_pos[2 * i] = px;
    s_pos[2 * i + 1] = py;
  }
  __syncthreads();
  h += b * kk;
  shadow += b * kk;
  for (long long idx = threadIdx.x; idx < kk; idx += blockDim.x) {
    const int i = static_cast<int>(idx / K), j = static_cast<int>(idx % K);
    float2 hv = h[idx];
    float sv = shadow[idx];
    if (do_step) {
      // The draws of the strict upper triangle, mirrored (conjugated).
      const bool upper = j > i;
      const long long src = b * kk + (upper ? idx : static_cast<long long>(j) * K + i);
      const float wr = __fmul_rn(fade_re[src], c.fade_fold);
      float wi = __fmul_rn(fade_im[src], c.fade_fold);
      if (!upper) wi = -wi;
      hv.x = __fadd_rn(__fmul_rn(c.rho, hv.x), __fmul_rn(c.innov_std, wr));
      hv.y = __fadd_rn(__fmul_rn(c.rho, hv.y), __fmul_rn(c.innov_std, wi));
      const float n = __fmul_rn(shadow_n[src], c.shadow_fold);
      sv = __fmaf_rn(c.rho_s, sv, __fmul_rn(c.shadow_std, n));
      h_out[b * kk + idx] = hv;
      shadow_out[b * kk + idx] = sv;
    }
    const float dx = __fsub_rn(s_pos[2 * i], s_pos[2 * j]);
    const float dy = __fsub_rn(s_pos[2 * i + 1], s_pos[2 * j + 1]);
    float dist = __fsqrt_rn(__fadd_rn(__fmaf_rn(dy, dy, __fmul_rn(dx, dx)), 1e-9f));
    dist = __fmul_rn(isnan(dist) ? dist : fmaxf(dist, c.d0), c.inv_d0);
    const float amp = __fmul_rn(glibc_powf(dist, c.exponent),
                                glibc_powf(10.0f, __fmul_rn(sv, c.inv20)));
    const float off = i != j ? 1.0f : 0.0f;
    float gr = __fsub_rn(__fmul_rn(hv.x, amp), __fmul_rn(hv.y, 0.0f));
    float gi = __fadd_rn(__fmul_rn(hv.y, amp), __fmul_rn(hv.x, 0.0f));
    const float gr2 = __fsub_rn(__fmul_rn(off, gr), __fmul_rn(gi, 0.0f));
    const float gi2 = __fadd_rn(__fmul_rn(off, gi), __fmul_rn(gr, 0.0f));
    gain[b * kk + idx] = make_float2(gr2, gi2);
    // XLA's loops flush denormals: a subnormal part counts as 0.
    float ar = fabsf(gr2), ai = fabsf(gi2);
    if (ar < kFltMin) ar = 0.0f;
    if (ai < kFltMin) ai = 0.0f;
    const float mx = nan_max(ar, ai), mn = nan_min(ar, ai);
    const float q = __fdiv_rn(mn, mx);
    float a = __fmul_rn(mx, __fsqrt_rn(__fmaf_rn(q, q, 1.0f)));
    if (isnan(a)) a = mn;
    const float sn = __fmul_rn(__fmul_rn(__fmul_rn(a, a), c.snr_scale), off);
    snr[b * kk + idx] = sn;
    const float db = __fmul_rn(xla_log(nan_max(sn, 1e-12f)), kTenInvLn10);
    adj[b * kk + idx] = db >= c.outage_db && i != j;
  }
}

}  // namespace

// The C interface: state (pos, way: (B, K, 2); h: (B, K, K) complex64 as
// float pairs; shadow: (B, K, K)), the draws (fade_re, fade_im, shadow_n:
// (B, K, K); way_u: (B, K, 2); ignored when do_step is 0), the outputs
// (the stepped state, written only when do_step is 1; gain complex64,
// snr f32, adj bool, each (B, K, K)), the 14 constants in Consts' order
// (host memory) and the stream.  Returns a cudaError_t.
extern "C" int channel_round_f32(
    const float* pos, const float* way, const float* h, const float* shadow,
    const float* fade_re, const float* fade_im, const float* shadow_n,
    const float* way_u, float* pos_out, float* way_out, float* h_out,
    float* shadow_out, float* gain, float* snr, bool* adj, int K, int batch,
    int do_step, const float* consts, cudaStream_t stream) {
  Consts c;
  static_assert(sizeof(Consts) == kNumConsts * sizeof(float), "Consts layout");
  memcpy(&c, consts, sizeof(Consts));
  const int threads = 256;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(K);
  channel_round_kernel<<<batch, threads, smem, stream>>>(
      pos, way, reinterpret_cast<const float2*>(h), shadow, fade_re, fade_im,
      shadow_n, way_u, pos_out, way_out, reinterpret_cast<float2*>(h_out),
      shadow_out, reinterpret_cast<float2*>(gain), snr, adj, K, do_step, c);
  return static_cast<int>(cudaGetLastError());
}
