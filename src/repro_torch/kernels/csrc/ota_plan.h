// How one launch of the ota_aggregate kernel covers (C, K, d): its path,
// block, grid and shared-memory layout.  Plain C++ (no CUDA), included by
// ota_aggregate.cu, which launches by it and computes the layout on the
// device from it; the tests compile this header alone with the host's C++
// compiler and read the plan back through ota_aggregate_plan_batched().
#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#define OTA_HD __host__ __device__
#else
#define OTA_HD
#endif

namespace ota {

// The most dynamic shared memory a block may opt in to on Hopper, and an
// SM's, of which each resident block reserves 1 KiB.
constexpr size_t kMaxSmem = 232448;
constexpr size_t kSmSmem = 233472;
// The column path takes up to this many rows of W (while they fit in
// shared memory), in blocks of kColumnThreads, one column a thread.
constexpr int kColumnMaxRows = 8;
constexpr int kColumnThreads = 256;
// The ring's tile: 32 lanes x 16 bytes of a row of S; in shared memory a
// row takes one 16-byte chunk more, for the aligned superset of a
// misaligned row.
constexpr int kRowBytes = 512;
constexpr int kPitch = kRowBytes + 16;
// The ring's depth: one item in flight while one is computed (3 and 4 ran
// slower at every ring shape measured).
constexpr int kStages = 2;
// The most rows of S a stage holds when a tile's whole K does not fit
// (halved until the ring fits).
constexpr int kChunkRows = 64;

// Where a ring launch keeps what in shared memory.  Resident (kc == 0): a
// stage is the K x tile block of S and the tile's C rows of N; W (rows_pad
// x kp floats, kp = K rounded up to 4) sits after the ring.  Streamed: a
// stage is kc rows of S, the pass's rows of W for those kc columns
// (pass_rows x kc floats) and the pass's rows of N.  A row of S takes
// kPitch bytes, a row of N n_pitch (n_row bytes, plus 16).
struct Layout {
  bool resident;
  int kc, kp, rows_pad, pass_rows, passes, chunks;
  size_t w_off, n_off, n_pitch, stage_bytes, w_bytes, bar_off, smem_bytes;
};

OTA_HD inline Layout make_layout(int K, int C, int R, int kc, int n_row,
                                 int warps) {
  Layout L;
  L.resident = kc == 0;
  L.kc = L.resident ? K : kc;
  L.kp = (K + 3) / 4 * 4;
  L.rows_pad = (C + R - 1) / R * R;
  L.pass_rows = warps * R;
  L.passes = (C + L.pass_rows - 1) / L.pass_rows;
  L.chunks = (K + L.kc - 1) / L.kc;
  L.n_pitch = n_row + 16;
  L.w_off = static_cast<size_t>(L.kc) * kPitch;
  L.n_off = L.w_off + (L.resident ? 0 : sizeof(float) * L.pass_rows * L.kc);
  L.stage_bytes = L.n_off + L.n_pitch * (L.resident ? C : L.pass_rows);
  L.w_bytes = L.resident ? sizeof(float) * L.rows_pad * L.kp : 0;
  L.bar_off = kStages * L.stage_bytes + L.w_bytes;  // a stage's mbarrier
  L.smem_bytes = L.bar_off + 8 * kStages;
  return L;
}

struct Plan {
  int ring;           // the ring; else the column path
  int warps;          // a block's warps
  int tile;           // columns of a block's tile
  int rows;           // R, rows of W a warp takes (the column path: C)
  int kc;             // rows of S a stage holds; 0: all K, S resident
  int blocks_per_sm;  // the ring's persistent blocks an SM (0: none)
  int tiles;          // ceil(d / tile)
  int grid;           // blocks
  long long smem_bytes;
};

// The ring at blocks of `warps`: a lane holds R rows x one 16-byte vector
// of sums (R x V <= 32), R the smallest that spreads C over the warps.  A
// stage holds a tile's K rows of S and C rows of N, and S stays resident
// for all C rows, when two stages fit beside W (two blocks an SM if they
// fit, else one); otherwise a stage holds kc rows of S (up to kChunkRows,
// halved until the ring fits) and the matching chunk of W and N for one
// pass of warps x R rows.  False if not even 4 rows fit.
inline bool ring_plan(int K, int C, long long d, int s_bytes, int n_bytes,
                      int num_sms, int warps, Plan* p) {
  const int tile = kRowBytes / s_bytes, n_row = tile * n_bytes;
  int rows = 2;
  while (rows < (s_bytes == 4 ? 8 : 4) && rows * warps < C) rows *= 2;
  if (warps == 16 && rows > 4) rows = 4;
  // Blocks an SM: two if their shared memory fits (not with R = 8, whose
  // registers take an SM's, nor with 16 warps), else one; 0 if none fits.
  const auto fit = [&](const Layout& L) {
    for (int bps = (rows == 8 || warps == 16) ? 1 : 2; bps >= 1; --bps) {
      const size_t budget = kSmSmem / bps - 1024;
      if (L.smem_bytes <= (budget < kMaxSmem ? budget : kMaxSmem)) return bps;
    }
    return 0;
  };
  Layout L = make_layout(K, C, rows, 0, n_row, warps);
  int bps = fit(L), kc = 0;
  if (!bps) {
    kc = (K + 3) / 4 * 4;
    if (kc > kChunkRows) kc = kChunkRows;
    for (;;) {
      L = make_layout(K, C, rows, kc, n_row, warps);
      if ((bps = fit(L))) break;
      if (kc == 4) return false;
      kc = kc / 8 * 4 > 4 ? kc / 8 * 4 : 4;
    }
  }
  p->ring = 1;
  p->warps = warps;
  p->tile = tile;
  p->rows = rows;
  p->kc = kc;
  p->blocks_per_sm = bps;
  p->tiles = static_cast<int>((d + tile - 1) / tile);
  p->grid = p->tiles < bps * num_sms ? p->tiles : bps * num_sms;
  p->smem_bytes = static_cast<long long>(L.smem_bytes);
  return true;
}

// The most trajectories one launch takes: the grid's y dimension.
constexpr int kMaxBatch = 65535;

// The launch for W (C, K) against S (K, d) of s_bytes elements and N of
// n_bytes on a card of num_sms SMs.  C <= kColumnMaxRows with C x K
// floats of W in a block's shared memory: the column path.  Otherwise the
// ring, at blocks of 8 warps, or of 16 when only one block fits an SM and
// 16 warps still hold S resident for all C rows.  Returns 0, or -1 when
// the shape lies beyond one launch: C x K past 2^31 - 1 (W's elements),
// more than 2^31 - 1 tiles of d, or a block's walk over its items (tiles
// x passes x chunks of K) past 2^31 - 1, the kernel's int counters.
//
// `batch` independent products (the stacked trajectories of a Monte-Carlo
// sweep, each with its own S, W and N) run in one launch as the grid's y
// dimension, each block on its own trajectory; everything per block stays
// as at batch 1.  The column path's grid is per trajectory as it was; the
// ring's persistent grid is the resident blocks divided over the
// trajectories, rounded down (at least one block each), so the launch
// stays one wave wherever the card holds a block for every trajectory.
// At batch 1 the plan is the unbatched one.
inline int make_plan(int K, int C, long long d, int s_bytes, int n_bytes,
                     int num_sms, Plan* p, int batch = 1) {
  if (K < 1 || C < 1 || d < 1 || num_sms < 1 || batch < 1 ||
      batch > kMaxBatch ||
      (s_bytes != 4 && s_bytes != 2) || (n_bytes != 4 && n_bytes != 2) ||
      static_cast<long long>(C) * K > INT32_MAX ||
      d / (kRowBytes / s_bytes) >= INT32_MAX)
    return -1;
  const long long w_bytes = 4LL * C * K;
  if (C <= kColumnMaxRows && w_bytes <= static_cast<long long>(kMaxSmem)) {
    const int tile = kColumnThreads;
    p->ring = 0;
    p->warps = kColumnThreads / 32;
    p->tile = tile;
    p->rows = C;
    p->kc = 0;
    p->blocks_per_sm = 0;
    p->tiles = static_cast<int>((d + tile - 1) / tile);
    p->grid = p->tiles;
    p->smem_bytes = w_bytes;
    return 0;
  }
  if (!ring_plan(K, C, d, s_bytes, n_bytes, num_sms, 8, p)) return -1;
  if (p->kc == 0 && p->blocks_per_sm == 1) {
    Plan wide;
    if (ring_plan(K, C, d, s_bytes, n_bytes, num_sms, 16, &wide) &&
        wide.kc == 0 && wide.rows * 16 >= C)
      *p = wide;
  }
  if (batch > 1) {
    int share = p->blocks_per_sm * num_sms / batch;
    if (share < 1) share = 1;
    p->grid = p->tiles < share ? p->tiles : share;
  }
  const Layout L = make_layout(K, C, p->rows, p->kc, p->tile * n_bytes,
                               p->warps);
  const long long items = (p->tiles + p->grid - 1LL) / p->grid *
                          L.passes * L.chunks;
  return items > INT32_MAX ? -1 : 0;
}

}  // namespace ota

extern "C" {

// The plan of `batch` trajectories as ten ints: ring, warps, tile, rows,
// kc, blocks_per_sm, tiles, grid (blocks a trajectory), smem_bytes, and
// the layout's passes over C (1 when S is resident).  Returns make_plan's
// status.
int ota_aggregate_plan_batched(int K, int C, long long d, int s_bytes,
                               int n_bytes, int num_sms, int batch,
                               int* out) {
  ota::Plan p;
  const int err = ota::make_plan(K, C, d, s_bytes, n_bytes, num_sms, &p,
                                 batch);
  if (err) return err;
  const ota::Layout L = ota::make_layout(K, C, p.rows, p.kc, p.tile * n_bytes,
                                         p.warps);
  const int v[10] = {p.ring,  p.warps, p.tile, p.rows,
                     p.kc,    p.blocks_per_sm, p.tiles, p.grid,
                     static_cast<int>(p.smem_bytes),
                     p.ring && !L.resident ? L.passes : 1};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
