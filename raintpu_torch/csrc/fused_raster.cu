// Fused streak raster+composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of raintpu/ops/pallas/fused_kernel.py
// on the render path, all three bodies of its two pallas_calls:
// _make_kernel_pipelined (K1: single-tile windows, one call per rung),
// _make_kernel (K2: the same call for windows over MAX_SLAB_AREA =
// 80,000 px, in row tiles) and _make_kernel_resident (K3: all rungs in
// one call, the frame's plane stack held on chip and written once). This
// kernel is K3's scheme on this card, and serves K1 and K2 through it:
// one launch takes every rung of a call, each image tile's planes are
// summed in shared memory and written to HBM once. There is no zero-fill
// and no global atomic.
//
// Work unit: (frame b, image tile). The wrapper (ops/fused_raster.
// tile_plan) picks the tile (tile_h x tile_w pixels); the grid is
// (tiles, B), tiles row-major on x. The rungs arrive as a table of
// records passed by value (operand pointers, C, R, My, Mx, ph, pw), so
// each rung keeps its own series shape. A 256-thread block:
//
//  1. bins: reads every rung's n_valid[b] at once and scans the valid
//     slots of all rungs, concatenated in rung order, 256 slots a step,
//     one thread a slot: it tests the drop's window [ax, ax + pw) x [ay,
//     ay + ph), clipped to the image, against the tile, and appends the
//     overlapping (rung, slot) pairs to a shared list in rung-major,
//     slot-minor order (warp ballot, prefix sums over the warps).
//     n_valid is read here, on the device; the host never reads it and
//     the grid comes from shapes alone;
//  2. draws: whenever the list might not take another step's hits, and
//     at the end, the block draws what the list holds, in list order.
//     Each warp stages one listed drop (its 26 params, its R x (My + Mx)
//     damped DCT coefficients and the window's overlap with the tile) in
//     shared memory, eight drops a round; then the block's threads
//     spread over each drop's overlap pixels in turn. A barrier
//     separates two drops whose overlaps share a pixel; drops with
//     disjoint overlaps run without one;
//  3. evaluates: each pixel maps through the inverse homography to
//     texture coordinates and is tested against the content window's
//     hard cut (4 sigma + 0.25); inside it, the rank-R Chebyshev series,
//     then, if the clipped series exceeds ALPHA_CUTOFF, the tanh-erf
//     window, and the contributions of _plane_contribs, added to the
//     tile's accumulators in shared memory with plain adds: P = 5 planes
//     (alpha, log_att, add_rgb) or 8 (and clip(g * sat_rgb, 0, 1));
//  4. writes: the tile's P planes, zeros included, a warp a row.
//
// Every pixel's sums run in rung-major, slot-minor order, the order of
// the plain PyTorch version: two launches give bit-identical planes. The
// file is built with --fmad=false and every contribution is computed by
// the float32 operations of the plain version, in its order. What the
// kernel leaves out is work whose result is exactly zero: outside the
// hard cut the window is 0, and a clipped series at or under the cutoff
// keeps g = series * window (|window| <= 1) under it, so neither
// contributes. The Chebyshev values T_m, the same for every rank, are
// computed once for all ranks; each rank's sum takes the same terms in
// the same order as a rank-by-rank loop.
//
// What bounds it on this card: the planes written once (447 MB for the
// bench batch of 48 KITTI frames with 5 planes, 0.13 ms at 3.35 TB/s),
// and per-pixel arithmetic — about R*(My+Mx) multiply-adds of series, 5
// divides, 4 tanh, 1 log and 2 cos per window pixel (some 300-1,000
// FLOP) — whichever is larger for the call. What the design does about
// it: one pass writes every plane element once (the zero-fill and the
// atomics' read-modify-writes are gone); slots past n_valid cost one
// step of the scan, not a block each; the series runs only inside the
// cut. Registers bound the blocks an SM holds, so the kernel comes in
// two instantiations by the call's largest rank: up to 4 ranks (held to
// 64 registers, four blocks an SM), each thread evaluates its own
// pixels; above 4, where the series is long, each warp gathers its
// pixels inside the cut into a queue (ballot and shuffles) and runs the
// series on 32 of them at a time, so that thin streaks do not leave most
// lanes idle. What it costs: each (drop, tile) pair stages the drop
// again, and small overlaps leave lanes idle.

#include <cuda_runtime.h>
#include <math.h>

// One rung's operands and shapes: a record of the launch's rung table.
// Outside the unnamed namespace, so that the C entry keeps external
// linkage.
struct Rung {
  const float* params;   // (B, 26, C)
  const int* anchor;     // (B, C, 2) image (x, y) of the window origin
  const float* ayc;      // (B, C, R, My)
  const float* bxc;      // (B, C, R, Mx)
  const int* n_valid;    // (B,)
  int C, R, My, Mx, ph, pw;
};

namespace {

// Params row layout, as fused_kernel.py's P_* (rows of a (26, C) matrix).
constexpr int P_M00 = 0, P_M01 = 1, P_M02 = 2, P_M10 = 3, P_M11 = 4,
              P_M12 = 5, P_M20 = 6, P_M21 = 7, P_M22 = 8;
constexpr int P_MINCX = 9, P_MINCY = 10, P_SGX = 13, P_SGY = 14, P_LO = 15;
constexpr int P_ADDR = 16, P_ADDG = 17, P_ADDB = 18;
constexpr int P_SATR = 19, P_SATG = 20, P_SATB = 21;
constexpr int P_UL = 22, P_UU = 23, P_VL = 24, P_VU = 25;
constexpr int N_PARAMS = 26;
constexpr int N_PLANES = 5;
constexpr int N_PLANES_SAT = 8;

constexpr float ALPHA_CUTOFF = 2e-4f;
constexpr float LOG_EPS = 1e-6f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float SQRT2 = 1.4142135f;

// Launch constants; ops/fused_raster.py mirrors them in its plan.
constexpr int THREADS = 256;
constexpr int N_WARPS = THREADS / 32;
constexpr int MAX_RUNGS = 8;
constexpr int MAX_RANKS = 8;         // ranks R of a rung's series
constexpr int LIST_CAP = 512;        // (rung, slot) entries of the list
constexpr int STAGE = N_WARPS;       // drops staged a round, one a warp
constexpr int DROP_HDR = 9;          // ints of a staged drop's header
constexpr int SLOT_BITS = 24;        // list entry: rung << 24 | slot
constexpr int MAX_SMEM_BYTES = 232448;

// Staged drop header: the overlap's tile-local origin and size, the
// window pixel it starts at, the anchor, the rung.
constexpr int H_LX = 0, H_LY = 1, H_OW = 2, H_OH = 3, H_J0 = 4, H_I0 = 5,
              H_AX = 6, H_AY = 7, H_RUNG = 8;

struct RungTable {
  Rung rung[MAX_RUNGS];
};

// The model's tanh approximation of erf (not true erf).
__device__ __forceinline__ float tanh_erf(float x) {
  const float x3 = x * x * x;
  return tanhf(1.1283791671f * x + 0.1009055155f * x3);
}

struct Tile {
  int b, tx0, ty0, tx1, ty1, tile_w, tile_px, n_planes;
  float inv_th, inv_tw;
};

// A warp stages list entry e: params, coefficients, header.
__device__ __forceinline__ void stage_drop(const RungTable& table, int e,
                                           const Tile& t, float* dst,
                                           int* hdr, int lane) {
  const int r = e >> SLOT_BITS;
  const int c = e & ((1 << SLOT_BITS) - 1);
  const Rung& rg = table.rung[r];
  const size_t drop = (size_t)t.b * rg.C + c;
  for (int k = lane; k < N_PARAMS; k += 32)
    dst[k] = rg.params[((size_t)t.b * N_PARAMS + k) * rg.C + c];
  const int ny = rg.R * rg.My, nx = rg.R * rg.Mx;
  for (int k = lane; k < ny; k += 32)
    dst[N_PARAMS + k] = rg.ayc[drop * ny + k];
  for (int k = lane; k < nx; k += 32)
    dst[N_PARAMS + ny + k] = rg.bxc[drop * nx + k];
  if (lane == 0) {
    const int ax = rg.anchor[drop * 2];
    const int ay = rg.anchor[drop * 2 + 1];
    const int x0 = max(ax, t.tx0), y0 = max(ay, t.ty0);
    hdr[H_LX] = x0 - t.tx0;
    hdr[H_LY] = y0 - t.ty0;
    hdr[H_OW] = min(ax + rg.pw, t.tx1) - x0;
    hdr[H_OH] = min(ay + rg.ph, t.ty1) - y0;
    hdr[H_J0] = x0 - ax;
    hdr[H_I0] = y0 - ay;
    hdr[H_AX] = ax;
    hdr[H_AY] = ay;
    hdr[H_RUNG] = r;
  }
}

// Position of the n-th (from 0) set bit of mask, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = __popc(mask & ((1u << w) - 1u));
    if (c <= n) {
      n -= c;
      mask >>= w;
      pos += w;
    }
  }
  return pos;
}

// The block's threads add one staged drop's contributions over its
// overlap with the tile into the accumulators; the drop's series has NR
// ranks.
template <int NR>
__device__ __forceinline__ void accumulate_drop(const float* prm,
                                                const int* hdr, int My,
                                                int Mx, const Tile& t,
                                                float* acc) {
  const float* cy = prm + N_PARAMS;    // NR * My
  const float* cx = cy + NR * My;      // NR * Mx
  const int lx0 = hdr[H_LX], ly0 = hdr[H_LY], ow = hdr[H_OW];
  const int j0 = hdr[H_J0], i0 = hdr[H_I0];
  const int n_px = ow * hdr[H_OH];

  const bool with_sat = t.n_planes == N_PLANES_SAT;
  const int tp = t.tile_px;
  // The drop's params are read from shared memory where they are used,
  // not held in registers across the pixel loop.

  // One pixel inside the cut: series, window, contributions.
  auto eval = [&](int dy, int dx, float xhat, float yhat) {
    // Damped DCT series via Chebyshev recurrence. Each rank's sums take
    // the same terms in the same order as a rank-by-rank loop; the
    // Chebyshev values T_m, the same for every rank, are computed once.
    const float ty = cosf(PI_F * yhat);
    const float tx = cosf(PI_F * xhat);
    float uy[NR > 0 ? NR : 1], vx[NR > 0 ? NR : 1];
#pragma unroll
    for (int r = 0; r < NR; ++r) uy[r] = cy[r * My];
    float cm_prev = 1.0f, cm = ty;
    for (int m = 1; m < My; ++m) {
#pragma unroll
      for (int r = 0; r < NR; ++r) uy[r] = uy[r] + cy[r * My + m] * cm;
      const float nxt = 2.0f * ty * cm - cm_prev;
      cm_prev = cm;
      cm = nxt;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) vx[r] = cx[r * Mx];
    cm_prev = 1.0f;
    cm = tx;
    for (int m = 1; m < Mx; ++m) {
#pragma unroll
      for (int r = 0; r < NR; ++r) vx[r] = vx[r] + cx[r * Mx + m] * cm;
      const float nxt = 2.0f * tx * cm - cm_prev;
      cm_prev = cm;
      cm = nxt;
    }
    float g = 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) g = g + uy[r] * vx[r];

    // The window is at most 1, so g is at most the clipped series: at or
    // under ALPHA_CUTOFF, every contribution is 0 and the window is not
    // evaluated.
    const float gs = fminf(fmaxf(g, 0.0f), 1.0f);
    if (!(gs > ALPHA_CUTOFF)) return;
    // erf content window over the texture rect (inside its hard cut at
    // 4 sigma + 0.25).
    const float ul = prm[P_UL], uu = prm[P_UU], vl = prm[P_VL];
    const float vu = prm[P_VU];
    const float den_x = SQRT2 * fmaxf(prm[P_SGX], 2e-3f);
    const float den_y = SQRT2 * fmaxf(prm[P_SGY], 2e-3f);
    const float win = 0.5f * (tanh_erf((xhat - ul) / den_x)
                              - tanh_erf((xhat - uu) / den_x))
                      * 0.5f * (tanh_erf((yhat - vl) / den_y)
                                - tanh_erf((yhat - vu) / den_y));
    g = gs * win;
    if (!(g > ALPHA_CUTOFF)) return;   // every contribution is 0

    float* a = acc + (ly0 + dy) * t.tile_w + lx0 + dx;
    a[0] += g;
    a[tp] += logf(fmaxf(1.0f - g * prm[P_LO], LOG_EPS));
    a[2 * tp] += g * prm[P_ADDR];
    a[3 * tp] += g * prm[P_ADDG];
    a[4 * tp] += g * prm[P_ADDB];
    if (with_sat) {
      a[5 * tp] += fminf(fmaxf(g * prm[P_SATR], 0.0f), 1.0f);
      a[6 * tp] += fminf(fmaxf(g * prm[P_SATG], 0.0f), 1.0f);
      a[7 * tp] += fminf(fmaxf(g * prm[P_SATB], 0.0f), 1.0f);
    }
  };

  // Maps window pixel (i0 + dy, j0 + dx) to texture coordinates; true
  // inside the hard cut of the content window. Outside it the window is
  // 0, and so is every contribution.
  auto project = [&](int dy, int dx, float& xhat, float& yhat) {
    const float lx = (float)(j0 + dx) + ((float)hdr[H_AX] - prm[P_MINCX]);
    const float ly = (float)(i0 + dy) + ((float)hdr[H_AY] - prm[P_MINCY]);
    const float hx = prm[P_M00] * lx + prm[P_M01] * ly + prm[P_M02];
    const float hy = prm[P_M10] * lx + prm[P_M11] * ly + prm[P_M12];
    float hz = prm[P_M20] * lx + prm[P_M21] * ly + prm[P_M22];
    if (fabsf(hz) < 1e-9f) hz = 1e-9f;
    const float inv_hz = 1.0f / hz;
    xhat = (hx * inv_hz + 0.5f) * t.inv_tw;
    yhat = (hy * inv_hz + 0.5f) * t.inv_th;
    const float mx = 0.25f + 4.0f * fmaxf(prm[P_SGX], 2e-3f);
    const float my = 0.25f + 4.0f * fmaxf(prm[P_SGY], 2e-3f);
    return xhat >= prm[P_UL] - mx && xhat <= prm[P_UU] + mx &&
           yhat >= prm[P_VL] - my && yhat <= prm[P_VU] + my;
  };

  // Thread k takes overlap pixels k, k + THREADS, ... in row-major order,
  // stepping step_y rows and step_x columns at a time.
  const int step_y = THREADS / ow, step_x = THREADS - step_y * ow;
  int dy = threadIdx.x / ow, dx = threadIdx.x - dy * ow;
  auto next_pixel = [&](int p) {
    if (p != threadIdx.x) {
      dy += step_y;
      dx += step_x;
      if (dx >= ow) {
        dx -= ow;
        ++dy;
      }
    }
  };
  if constexpr (NR <= 4) {
    // A short series: each thread evaluates its own pixels.
    for (int p = threadIdx.x; p < n_px; p += THREADS) {
      next_pixel(p);
      float xhat, yhat;
      if (project(dy, dx, xhat, yhat)) eval(dy, dx, xhat, yhat);
    }
    return;
  }
  // A long series: the warp's pixels inside the cut join a queue held
  // one entry a lane, and the warp evaluates them 32 at a time, so that
  // thin streaks do not leave most lanes idle through the series.
  const int lane = threadIdx.x & 31;
  int q_yx = 0, count = 0;   // queue entry: dy << 16 | dx; its length
  float q_x = 0.0f, q_y = 0.0f;
  for (int p = threadIdx.x; p - lane < n_px; p += THREADS) {
    next_pixel(p);
    float xhat = 0.0f, yhat = 0.0f;
    const bool inside = p < n_px && project(dy, dx, xhat, yhat);
    const unsigned ballot = __ballot_sync(0xffffffffu, inside);
    const int k = __popc(ballot);
    if (k == 0) continue;
    const int yx = (dy << 16) | dx;
    // The new entries take lanes count .. count + k - 1; those past lane
    // 31 wait until the full queue has been evaluated.
    int rank = lane - count;
    bool take = rank >= 0 && rank < k;
    int src = take ? nth_set_bit(ballot, rank) : lane;
    int got_yx = __shfl_sync(0xffffffffu, yx, src);
    float got_x = __shfl_sync(0xffffffffu, xhat, src);
    float got_y = __shfl_sync(0xffffffffu, yhat, src);
    if (take) {
      q_yx = got_yx;
      q_x = got_x;
      q_y = got_y;
    }
    if (count + k < 32) {
      count += k;
      continue;
    }
    eval(q_yx >> 16, q_yx & 0xffff, q_x, q_y);
    rank = lane + 32 - count;
    take = rank < k;
    src = take ? nth_set_bit(ballot, rank) : lane;
    got_yx = __shfl_sync(0xffffffffu, yx, src);
    got_x = __shfl_sync(0xffffffffu, xhat, src);
    got_y = __shfl_sync(0xffffffffu, yhat, src);
    if (take) {
      q_yx = got_yx;
      q_x = got_x;
      q_y = got_y;
    }
    count += k - 32;
  }
  if (lane < count) eval(q_yx >> 16, q_yx & 0xffff, q_x, q_y);
}

// accumulate_drop for the drop's own rank R <= NRMAX.
template <int NRMAX>
__device__ __forceinline__ void accumulate_any(const RungTable& table,
                                               const float* prm,
                                               const int* hdr, const Tile& t,
                                               float* acc) {
  const Rung& rg = table.rung[hdr[H_RUNG]];
  if constexpr (NRMAX > 0) {
    if (rg.R < NRMAX) {
      accumulate_any<NRMAX - 1>(table, prm, hdr, t, acc);
      return;
    }
  }
  accumulate_drop<NRMAX>(prm, hdr, rg.My, rg.Mx, t, acc);
}

__device__ __forceinline__ bool rects_meet(const int* a, const int* b) {
  return a[H_LX] < b[H_LX] + b[H_OW] && b[H_LX] < a[H_LX] + a[H_OW] &&
         a[H_LY] < b[H_LY] + b[H_OH] && b[H_LY] < a[H_LY] + a[H_OH];
}

// Draw the list's first n entries into the accumulators, in list order.
// Every thread of the block calls it; it ends with a barrier.
template <int NRMAX>
__device__ __forceinline__ void draw_list(const RungTable& table, const int* list, int n,
                          const Tile& t, float* acc, int* hdr,
                          float* staged, int drop_floats) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = 0; i0 < n; i0 += STAGE) {
    const int m = min(STAGE, n - i0);
    for (int q = warp; q < m; q += N_WARPS)
      stage_drop(table, list[i0 + q], t, staged + q * drop_floats,
                 hdr + q * DROP_HDR, lane);
    __syncthreads();
    // Drops since the last barrier have pairwise disjoint overlaps, so
    // no pixel is touched twice between two barriers.
    int since = 0;
    for (int s = 0; s < m; ++s) {
      const int* hs = hdr + s * DROP_HDR;
      bool clash = false;
      for (int q = since; q < s; ++q)
        clash = clash || rects_meet(hs, hdr + q * DROP_HDR);
      if (clash) {
        __syncthreads();
        since = s;
      }
      accumulate_any<NRMAX>(table, staged + s * drop_floats, hs, t, acc);
    }
    __syncthreads();   // the round's adds are done; staging is free
  }
}

// NRMAX: the largest rank of the call's rungs, 4 or 8. The rank-4
// instantiation is held to 64 registers, so that four blocks fit an SM
// (five planes of a 2,048-px tile leave room for four); the rank-8 one to
// 85, so that three fit (eight planes leave room for three).
template <int NRMAX>
__global__ void __launch_bounds__(THREADS, NRMAX <= 4 ? 4 : 3)
fused_raster_kernel(const __grid_constant__ RungTable table, int n_rungs,
                    float* __restrict__ planes, int H, int W, int n_planes,
                    float inv_th, float inv_tw, int tile_h, int tile_w,
                    int tiles_x, int coef_floats) {
  extern __shared__ float smem[];
  Tile t;
  t.b = blockIdx.y;
  t.tx0 = (blockIdx.x % tiles_x) * tile_w;
  t.ty0 = (blockIdx.x / tiles_x) * tile_h;
  t.tx1 = min(t.tx0 + tile_w, W);
  t.ty1 = min(t.ty0 + tile_h, H);
  t.tile_w = tile_w;
  t.tile_px = tile_h * tile_w;
  t.n_planes = n_planes;
  t.inv_th = inv_th;
  t.inv_tw = inv_tw;

  float* acc = smem;                                       // P * tile_px
  int* list = reinterpret_cast<int*>(acc + n_planes * t.tile_px);
  int* warp_n = list + LIST_CAP;                           // N_WARPS
  int* start = warp_n + N_WARPS;                           // MAX_RUNGS + 1
  int* hdr = start + MAX_RUNGS + 1;                        // STAGE * HDR
  float* staged = reinterpret_cast<float*>(hdr + STAGE * DROP_HDR);
  const int drop_floats = N_PARAMS + coef_floats;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < n_planes * t.tile_px; k += THREADS) acc[k] = 0.0f;

  // Bin: the valid slots of every rung, concatenated in rung order
  // (rung r's slots [0, n_r) at [start[r], start[r + 1])), THREADS slots
  // a step. Every rung's n_valid is read at once.
  if (tid == 0) {
    int n[MAX_RUNGS];
#pragma unroll
    for (int r = 0; r < MAX_RUNGS; ++r)
      n[r] = r < n_rungs ? max(0, min(table.rung[r].n_valid[t.b],
                                      table.rung[r].C))
                         : 0;
    start[0] = 0;
#pragma unroll
    for (int r = 0; r < MAX_RUNGS; ++r) start[r + 1] = start[r] + n[r];
  }
  __syncthreads();
  const int total = start[MAX_RUNGS];
  int n_list = 0;
  for (int base = 0; base < total; base += THREADS) {
    const int v = base + tid;
    bool hit = false;
    int entry = 0;
    if (v < total) {
      int r = 0, c = v;
#pragma unroll
      for (int q = 1; q < MAX_RUNGS; ++q)
        if (v >= start[q]) {
          r = q;
          c = v - start[q];
        }
      const Rung& rg = table.rung[r];
      const size_t drop = (size_t)t.b * rg.C + c;
      const int ax = rg.anchor[drop * 2];
      const int ay = rg.anchor[drop * 2 + 1];
      hit = max(ax, t.tx0) < min(ax + rg.pw, t.tx1) &&
            max(ay, t.ty0) < min(ay + rg.ph, t.ty1);
      entry = (r << SLOT_BITS) | c;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, step = 0;
    for (int w = 0; w < N_WARPS; ++w) {
      const int k = warp_n[w];
      before += w < warp ? k : 0;
      step += k;
    }
    if (hit)
      list[n_list + before + __popc(ballot & ((1u << lane) - 1u))] = entry;
    n_list += step;
    __syncthreads();   // the list holds this step; warp_n is free
    if (n_list > LIST_CAP - THREADS) {
      draw_list<NRMAX>(table, list, n_list, t, acc, hdr, staged,
                       drop_floats);
      n_list = 0;
    }
  }
  if (n_list > 0)
    draw_list<NRMAX>(table, list, n_list, t, acc, hdr, staged, drop_floats);
  __syncthreads();

  // Write the tile's planes once, a warp a row.
  const size_t plane = (size_t)H * W;
  float* out = planes + (size_t)t.b * n_planes * plane +
               (size_t)t.ty0 * W + t.tx0;
  const int rows = t.ty1 - t.ty0, cols = t.tx1 - t.tx0;
  for (int pl = 0; pl < n_planes; ++pl)
    for (int row = warp; row < rows; row += N_WARPS)
      for (int col = lane; col < cols; col += 32)
        out[pl * plane + (size_t)row * W + col] =
            acc[pl * t.tile_px + row * tile_w + col];
}

}  // namespace

// Accumulate every rung of `rungs` (n_rungs records) into fresh planes
// (B, n_planes, H, W), n_planes 5 or 8, on `stream`, with the wrapper's
// launch plan: tiles of tile_h x tile_w pixels, the grid (grid_x,
// grid_y) = (tiles, B), smem_bytes of dynamic shared memory for a list
// of list_cap entries and staged drops of up to coef_floats
// coefficients. Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for a plan that does not match the kernel's
// layout or a rung it cannot take); does not synchronise.
extern "C" int fused_raster_launch(const Rung* rungs, int n_rungs,
                                   float* planes, int B, int H, int W,
                                   int n_planes, float inv_th, float inv_tw,
                                   int tile_h, int tile_w, int grid_x,
                                   int grid_y, int smem_bytes, int list_cap,
                                   int coef_floats, void* stream) {
  if (n_rungs < 1 || n_rungs > MAX_RUNGS || list_cap != LIST_CAP ||
      tile_h < 1 || tile_w < 1 || coef_floats < 0 ||
      (n_planes != N_PLANES && n_planes != N_PLANES_SAT))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const long long tiles_x = (W + tile_w - 1) / tile_w;
  const long long tiles_y = (H + tile_h - 1) / tile_h;
  if (tiles_x * tiles_y != grid_x || grid_y != B)
    return (int)cudaErrorInvalidValue;
  RungTable table = {};
  for (int r = 0; r < n_rungs; ++r) {
    const Rung& rg = rungs[r];
    if (rg.C < 0 || rg.C >= (1 << SLOT_BITS) || rg.ph < 1 || rg.pw < 1 ||
        rg.R < 0 || rg.R > MAX_RANKS || rg.My < 1 || rg.Mx < 1 ||
        (long long)rg.R * (rg.My + rg.Mx) > coef_floats)
      return (int)cudaErrorInvalidValue;
    table.rung[r] = rg;
  }
  const long long floats = (long long)n_planes * tile_h * tile_w +
                           LIST_CAP + N_WARPS + MAX_RUNGS + 1 +
                           STAGE * DROP_HDR +
                           (long long)STAGE * (N_PARAMS + coef_floats);
  if (floats * 4 != smem_bytes || smem_bytes > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  int max_r = 0;
  for (int r = 0; r < n_rungs; ++r) max_r = max(max_r, rungs[r].R);
  // The rank ceiling picks the instantiation: a series of at most 4
  // ranks needs fewer registers.
  auto kernel =
      max_r <= 4 ? &fused_raster_kernel<4> : &fused_raster_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  kernel<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      table, n_rungs, planes, H, W, n_planes, inv_th, inv_tw, tile_h, tile_w,
      (int)tiles_x, coef_floats);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_raster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
