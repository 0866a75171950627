// Fused streak raster+composite for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of raintpu/ops/pallas/fused_kernel.py
// on the render path, all three bodies of its two pallas_calls:
// _make_kernel_pipelined (single-tile windows, one call per rung, window
// DMAs read-modify-write the field planes), _make_kernel (the same call
// for windows over MAX_SLAB_AREA = 80,000 px, evaluated in row tiles that
// bound the TPU's VMEM working set) and _make_kernel_resident (all rungs
// in one call, the plane stack held in VMEM). All three compute the same
// per-drop sums; on this card none of their memory schemes carries over,
// so one kernel takes windows of any size.
//
// Work unit: (frame b, slot c, row chunk k). A chunk is `rows` window
// rows, rows = max(1, TARGET_PX / pw) chosen by the wrapper
// (ops/fused_raster.raster_plan), so a unit holds about TARGET_PX pixels
// and a window at or under TARGET_PX is one unit. One 256-thread block
// per unit; the grid is (C * n_chunks, B) with the chunk index fastest
// on x, so a drop's chunks are scheduled side by side. The grid comes
// from shapes alone: a slot at or beyond n_valid[b] returns at once, as
// does a chunk whose rows all lie at or below the image's bottom edge,
// and the host never reads n_valid. The block stages the drop's 26
// params and its R x (My + Mx) damped DCT coefficients in shared memory,
// then its threads stride over the chunk's rows clipped to the image
// (window columns at or past the right edge are never visited). Each
// pixel evaluates _patch_eval (inverse homography, rank-R Chebyshev
// series, tanh-erf content window with its hard cut, ALPHA_CUTOFF) and
// _plane_contribs, and adds its contributions into image-sized float32
// planes (B, P, H, W) with atomicAdd: P = 5 (alpha, log_att, add_rgb) or
// P = 8, which adds the saturation planes clip(g * sat_rgb, 0, 1). A
// pixel whose g is 0 contributes exactly 0 to every plane and skips its
// atomics. The file is built with --fmad=false and each pixel runs the
// float32 operations of the plain PyTorch version in its order, so the
// two differ only by the order of the atomic sums.
//
// What bounds it on this card: per-pixel arithmetic — about R*(My+Mx)
// multiply-adds of series, 1 divide, 4 tanh, 1 log and 2 cos per pixel
// (some 300-1,000 FLOP) — and the float atomics into the planes (one
// frame's 8 planes, 15 MB at KITTI 1242x375, fit in the 50 MB L2). The
// operations bound it. One block per drop, as this kernel first was,
// left a (704, 384) window to a single SM (~1,056 pixels a thread) while
// the other SMs idled, so a launch lasted as long as its biggest drop;
// cutting windows into chunks of about TARGET_PX pixels spreads one big
// drop over dozens of SMs and evens the load. What remains: the empty
// blocks of unused slots (each reads n_valid and exits), the per-block
// staging of a drop's coefficients, which small windows (under 1,000
// px, 3 pixels a thread) do not amortise, and the global atomics. Later
// work: binning drops into image tiles with shared-memory accumulation,
// and one persistent launch over all rungs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Params row layout, as fused_kernel.py's P_* (rows of a (26, C) matrix).
constexpr int P_M00 = 0, P_M01 = 1, P_M02 = 2, P_M10 = 3, P_M11 = 4,
              P_M12 = 5, P_M20 = 6, P_M21 = 7, P_M22 = 8;
constexpr int P_MINCX = 9, P_MINCY = 10, P_SGX = 13, P_SGY = 14, P_LO = 15;
constexpr int P_ADDR = 16, P_ADDG = 17, P_ADDB = 18;
constexpr int P_SATR = 19, P_SATG = 20, P_SATB = 21;
constexpr int P_UL = 22, P_UU = 23, P_VL = 24, P_VU = 25;
constexpr int N_PARAMS = 26;
constexpr int N_PLANES_SAT = 8;

constexpr float ALPHA_CUTOFF = 2e-4f;
constexpr float LOG_EPS = 1e-6f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float SQRT2 = 1.4142135f;
constexpr int THREADS = 256;

// The model's tanh approximation of erf (not true erf).
__device__ __forceinline__ float tanh_erf(float x) {
  const float x3 = x * x * x;
  return tanhf(1.1283791671f * x + 0.1009055155f * x3);
}

__global__ void __launch_bounds__(THREADS)
fused_raster_kernel(const float* __restrict__ params,   // (B, 26, C)
                    const int* __restrict__ anchor,     // (B, C, 2)
                    const float* __restrict__ ayc,      // (B, C, R, My)
                    const float* __restrict__ bxc,      // (B, C, R, Mx)
                    const int* __restrict__ n_valid,    // (B,)
                    float* __restrict__ planes,         // (B, P, H, W)
                    int C, int R, int My, int Mx, int ph, int pw, int H,
                    int W, int n_planes, float inv_th, float inv_tw,
                    int rows, int n_chunks) {
  const int c = blockIdx.x / n_chunks;
  const int b = blockIdx.y;
  if (c >= n_valid[b]) return;
  const size_t drop = (size_t)b * C + c;
  const int ax = anchor[drop * 2];
  const int ay = anchor[drop * 2 + 1];
  // This chunk's window rows [row0, row1) and columns [0, cols) inside
  // the image (anchors are clipped to [0, W] x [0, H]).
  const int row0 = (blockIdx.x - c * n_chunks) * rows;
  const int row1 = min(min(row0 + rows, ph), H - ay);
  const int cols = min(pw, W - ax);
  if (row1 <= row0 || cols <= 0) return;

  extern __shared__ float smem[];
  float* prm = smem;                 // N_PARAMS
  float* cy = smem + N_PARAMS;       // R * My
  float* cx = cy + R * My;           // R * Mx
  for (int k = threadIdx.x; k < N_PARAMS; k += blockDim.x)
    prm[k] = params[((size_t)b * N_PARAMS + k) * C + c];
  for (int k = threadIdx.x; k < R * My; k += blockDim.x)
    cy[k] = ayc[drop * R * My + k];
  for (int k = threadIdx.x; k < R * Mx; k += blockDim.x)
    cx[k] = bxc[drop * R * Mx + k];
  __syncthreads();

  const float ox = (float)ax - prm[P_MINCX];
  const float oy = (float)ay - prm[P_MINCY];
  const float m00 = prm[P_M00], m01 = prm[P_M01], m02 = prm[P_M02];
  const float m10 = prm[P_M10], m11 = prm[P_M11], m12 = prm[P_M12];
  const float m20 = prm[P_M20], m21 = prm[P_M21], m22 = prm[P_M22];
  const float sx = fmaxf(prm[P_SGX], 2e-3f);
  const float sy = fmaxf(prm[P_SGY], 2e-3f);
  const float ul = prm[P_UL], uu = prm[P_UU], vl = prm[P_VL], vu = prm[P_VU];
  const float lo = prm[P_LO];
  const float add_r = prm[P_ADDR], add_g = prm[P_ADDG], add_b = prm[P_ADDB];
  const float sat_r = prm[P_SATR], sat_g = prm[P_SATG], sat_b = prm[P_SATB];
  const bool with_sat = n_planes == N_PLANES_SAT;
  const float den_x = SQRT2 * sx, den_y = SQRT2 * sy;
  const float mx = 0.25f + 4.0f * sx;
  const float my = 0.25f + 4.0f * sy;

  const size_t plane = (size_t)H * W;
  float* out = planes + (size_t)b * n_planes * plane;
  const int n_px = (row1 - row0) * cols;
  for (int p = threadIdx.x; p < n_px; p += blockDim.x) {
    const int di = p / cols;
    const int j = p - di * cols;
    const int i = row0 + di;
    const int y = ay + i;
    const int x = ax + j;

    const float lx = (float)j + ox;
    const float ly = (float)i + oy;
    const float hx = m00 * lx + m01 * ly + m02;
    const float hy = m10 * lx + m11 * ly + m12;
    float hz = m20 * lx + m21 * ly + m22;
    if (fabsf(hz) < 1e-9f) hz = 1e-9f;
    const float inv_hz = 1.0f / hz;
    const float xhat = (hx * inv_hz + 0.5f) * inv_tw;
    const float yhat = (hy * inv_hz + 0.5f) * inv_th;

    // Damped DCT series via Chebyshev recurrence, rank by rank.
    const float ty = cosf(PI_F * yhat);
    const float tx = cosf(PI_F * xhat);
    float g = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float* cyr = cy + r * My;
      float uy = cyr[0];
      float cm_prev = 1.0f, cm = ty;
      for (int m = 1; m < My; ++m) {
        uy = uy + cyr[m] * cm;
        const float nxt = 2.0f * ty * cm - cm_prev;
        cm_prev = cm;
        cm = nxt;
      }
      const float* cxr = cx + r * Mx;
      float vx = cxr[0];
      cm_prev = 1.0f;
      cm = tx;
      for (int m = 1; m < Mx; ++m) {
        vx = vx + cxr[m] * cm;
        const float nxt = 2.0f * tx * cm - cm_prev;
        cm_prev = cm;
        cm = nxt;
      }
      g = g + uy * vx;
    }

    // erf content window over the texture rect, hard-cut at 4 sigma + 0.25.
    float win = 0.5f * (tanh_erf((xhat - ul) / den_x)
                        - tanh_erf((xhat - uu) / den_x))
                * 0.5f * (tanh_erf((yhat - vl) / den_y)
                          - tanh_erf((yhat - vu) / den_y));
    if (!(xhat >= ul - mx && xhat <= uu + mx && yhat >= vl - my &&
          yhat <= vu + my))
      win = 0.0f;
    g = fminf(fmaxf(g, 0.0f), 1.0f) * win;
    if (!(g > ALPHA_CUTOFF)) continue;   // every contribution is 0

    const size_t o = (size_t)y * W + x;
    atomicAdd(out + o, g);
    atomicAdd(out + plane + o, logf(fmaxf(1.0f - g * lo, LOG_EPS)));
    atomicAdd(out + 2 * plane + o, g * add_r);
    atomicAdd(out + 3 * plane + o, g * add_g);
    atomicAdd(out + 4 * plane + o, g * add_b);
    if (with_sat) {
      atomicAdd(out + 5 * plane + o, fminf(fmaxf(g * sat_r, 0.0f), 1.0f));
      atomicAdd(out + 6 * plane + o, fminf(fmaxf(g * sat_g, 0.0f), 1.0f));
      atomicAdd(out + 7 * plane + o, fminf(fmaxf(g * sat_b, 0.0f), 1.0f));
    }
  }
}

}  // namespace

// Accumulate one rung's drops into planes (B, n_planes, H, W), n_planes
// 5 or 8, on `stream`, with the wrapper's launch plan: `rows` window rows
// per chunk, `n_chunks` chunks per window and the grid (grid_x, grid_y),
// which must be (C * n_chunks, B). Returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for a plan that does not cover the
// window); does not synchronise.
extern "C" int fused_raster_launch(const float* params, const int* anchor,
                                   const float* ayc, const float* bxc,
                                   const int* n_valid, float* planes, int B,
                                   int C, int R, int My, int Mx, int ph,
                                   int pw, int H, int W, int n_planes,
                                   float inv_th, float inv_tw, int rows,
                                   int n_chunks, int grid_x, int grid_y,
                                   void* stream) {
  if (B == 0 || C == 0) return 0;
  if (rows < 1 || n_chunks < 1 || (long long)rows * n_chunks < ph ||
      (long long)rows * (n_chunks - 1) >= ph ||
      (long long)C * n_chunks != grid_x || grid_y != B)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const size_t smem = sizeof(float) * (N_PARAMS + (size_t)R * (My + Mx));
  fused_raster_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      params, anchor, ayc, bxc, n_valid, planes, C, R, My, Mx, ph, pw, H, W,
      n_planes, inv_th, inv_tw, rows, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_raster_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
