// Separable blur with REFLECT_101 borders for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of raintpu/ops/pallas/blur_kernel.py
// (separable_blur_pallas -> _blur_call -> _make_blur_kernel): both axes of
// an odd-length separable filter over (N, H, W) float32 planes in one
// pass, borders reflected the cv2 REFLECT_101 way. The TPU kernel runs the
// two stencils as band matmuls on the MXU with a split-bf16 operand trick,
// because TPU float32 matmuls truncate to bf16; on this card the taps are
// plain float32 multiply-adds on the CUDA cores, with nothing to split.
//
// The planes are cut into tiles of tile_h rows x tile_w columns, 32 x 128
// for the fog (the wrapper, ops/blur_kernel.blur_plan, picks the tile and
// passes it in with the shared-memory bytes it implies). Persistent
// 256-thread blocks, as many as the card holds at once (two an SM for the
// fog), walk the tiles W-fastest; each tile goes through:
//   1. Load: the tile plus a halo of r = (K - 1) / 2 on each side goes
//      into one of two shared buffers with cp.async, issued one tile
//      ahead so that it lands while the previous tile's sums run. Rows
//      fold at the top and bottom edges, and only tiles whose halo
//      crosses the left or right edge fold their columns; reflect101
//      folds as often as it needs to, so radius >= axis length works too
//      (the Pallas kernel refuses those shapes; ops/blur._dense_axis_blur
//      folds the same way). Copies are 4 bytes: a KITTI row of 1242
//      floats is 4,968 bytes, not a multiple of 16, so wider copies would
//      be misaligned on odd rows (8-byte copies, aligned for the fog,
//      measured no faster).
//   2. H pass (down the rows, as the plain version's first product): each
//      thread takes one halo column and a run of RUN = 8 output rows,
//      reads the run's RUN + 2r inputs from shared memory once and sums
//      the K taps for all 8 outputs in registers, side by side. Results
//      go to a column-major intermediate (odd pitch: no bank conflicts).
//   3. W pass: each thread takes one row and a run of RUN output columns
//      the same way, and writes the outputs to a staging tile.
//   4. Store: the staging tile goes out row by row, coalesced.
// Each output is summed acc = acc + t[k] * x[k] for k = 0 .. K-1 from
// acc = 0, in that order as the first version of this kernel did, each
// step one fused multiply-add (fmaf: one rounding a tap where that
// version, built with --fmad=false, rounded the product and the sum; the
// plain version's matrix products round differently again). For the
// fog's K = 25 the kernel is instantiated on the radius: the loops
// unroll, the taps arrive by value among the kernel's parameters (the
// constant bank, read as operands of the multiply-adds), the run's inputs
// stay in registers, and a pass costs (RUN + 2r) / RUN = 4 shared loads
// per output instead of 2K. Every other radius (K <= 129) takes the
// generic instantiation of the same kernel, which stages the taps in
// shared memory from a device array and reads each input once per tap.
//
// What bounds it on this card: the bytes, each element read once and
// written once, 8 bytes per output over 3.35 TB/s; the 2K fused
// multiply-adds per output (50 at K = 25) need about a third of that
// time at 67 TFLOP/s. What holds it back: the halo, which makes a 32 x
// 128 tile read (32 + 2r)(128 + 2r) / (32 * 128) = 2.1x its inputs from
// L2 at r = 12; with two blocks an SM the loads alone (the sums left
// out) take well over half the kernel's time. Taller tiles re-read less
// but leave one block an SM, which was slower. Later work: column strips
// that march down the plane (a ring of rows, ~1.2x re-read), and fusing
// the fog's elementwise math around the blur.
//
// Shared memory: taps (K) + two halo tiles 2 (tile_h + 2r)(tile_w + 2r)
// + the intermediate (tile_w + 2r)(tile_h + 1) + the staging tile
// tile_h (tile_w + 1) floats, 105 KB for a 32 x 128 tile at r = 12, so
// the launch raises the kernel's dynamic shared-memory limit past the
// default 48 KB.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 8;              // outputs per thread and item, each pass
constexpr int MAX_TAPS = 129;
constexpr int FOG_RADIUS = 12;      // the fog's 25 taps
constexpr size_t MAX_SMEM = 232448;

// REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...; the reflection group
// has period 2(n - 1), so any index folds into [0, n).
__device__ __forceinline__ int reflect101(int j, int n) {
  if ((unsigned)j < (unsigned)n) return j;
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  j = (j < 0 ? -j : j) % p;
  return j >= n ? p - j : j;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

size_t smem_floats(int r, int tile_h, int tile_w) {
  const size_t in_w = tile_w + 2 * r, in_h = tile_h + 2 * r;
  return (2 * r + 1) + 2 * in_h * in_w + in_w * (tile_h + 1) +
         (size_t)tile_h * (tile_w + 1);
}

// The taps: by value (a kernel parameter) for a radius known at compile
// time, else a pointer to their copy in shared memory.
template <int RC>
struct Taps {
  float v[2 * RC + 1];
};
template <>
struct Taps<0> {
  const float* v;
};

// acc[q] = sum_k t[k] * src[(q + k) * stride], k = 0 .. 2r in order, one
// fused multiply-add a tap, for the RUN outputs q of one run. The taps run
// in the outer loop, so the RUN sums advance side by side (RUN independent
// chains).
template <int RC>
__device__ __forceinline__ void stencil_run(const float* src, int stride,
                                            const Taps<RC>& t, int r,
                                            float (&acc)[RUN]) {
#pragma unroll
  for (int q = 0; q < RUN; ++q) acc[q] = 0.0f;
  if constexpr (RC > 0) {
    float v[RUN + 2 * RC];
#pragma unroll
    for (int m = 0; m < RUN + 2 * RC; ++m) v[m] = src[m * stride];
#pragma unroll
    for (int k = 0; k <= 2 * RC; ++k) {
#pragma unroll
      for (int q = 0; q < RUN; ++q) acc[q] = fmaf(t.v[k], v[q + k], acc[q]);
    }
  } else {
    for (int k = 0; k <= 2 * r; ++k) {
      const float tk = t.v[k];
      const float* s = src + k * stride;
#pragma unroll
      for (int q = 0; q < RUN; ++q) acc[q] = fmaf(tk, s[q * stride], acc[q]);
    }
  }
}

template <int RC>
__global__ void __launch_bounds__(THREADS)
separable_blur_kernel(const float* __restrict__ x,      // (N, H, W)
                      const float* __restrict__ taps,   // (2r + 1,)
                      Taps<RC> t,
                      float* __restrict__ out,          // (N, H, W)
                      int H, int W, int r_arg, int tile_h, int tile_w,
                      int tiles_x, int tiles_y, int n_tiles) {
  const int r = RC > 0 ? RC : r_arg;
  const int k_taps = 2 * r + 1;
  const int in_w = tile_w + 2 * r;
  const int in_h = tile_h + 2 * r;
  const int mid_p = tile_h + 1;     // odd: tile_h is a multiple of RUN
  const int out_p = tile_w + 1;     // odd: tile_w is a multiple of RUN
  extern __shared__ float smem[];
  float* s_taps = smem;
  float* s_in = s_taps + k_taps;              // 2 x in_h x in_w
  float* s_mid = s_in + 2 * in_h * in_w;      // in_w x mid_p
  float* s_out = s_mid + in_w * mid_p;        // tile_h x out_p

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (RC == 0) {
    for (int k = threadIdx.x; k < k_taps; k += THREADS) s_taps[k] = taps[k];
    t.v = s_taps;
  }

  // Start copying tile `tile`'s input, halo included, into buffer `dst`.
  // Rows fold at the top and bottom edges; only tiles whose halo crosses
  // the left or right edge fold their columns.
  auto load = [&](int tile, float* dst) {
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    const int x0 = tx * tile_w;
    const int y0 = (rest % tiles_y) * tile_h;
    const float* src = x + (size_t)(rest / tiles_y) * H * W;
    const bool cols_inside = x0 >= r && x0 + tile_w + r <= W;
    for (int i = warp; i < in_h; i += WARPS) {
      const float* row = src + (size_t)reflect101(y0 - r + i, H) * W;
      float* d = dst + i * in_w;
      if (cols_inside) {
        for (int j = lane; j < in_w; j += 32)
          copy_async(d + j, row + x0 - r + j);
      } else {
        for (int j = lane; j < in_w; j += 32)
          copy_async(d + j, row + reflect101(x0 - r + j, W));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // Each block walks the tiles blockIdx.x, + gridDim.x, ... (tiles along
  // W fastest, then along H, then planes); the next tile's input is in
  // flight while this one's sums run.
  float acc[RUN];
  int buf = 0;
  if (blockIdx.x < n_tiles) load(blockIdx.x, s_in);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const float* cur = s_in + buf * in_h * in_w;
    if (tile + gridDim.x < n_tiles) {
      load(tile + gridDim.x, s_in + (buf ^ 1) * in_h * in_w);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    // H pass: every halo column of the tile's rows, RUN rows an item.
    const int n_runs = tile_h / RUN;
    for (int it = threadIdx.x; it < n_runs * in_w; it += THREADS) {
      const int run = it / in_w;
      const int c = it - run * in_w;
      stencil_run<RC>(cur + run * RUN * in_w + c, in_w, t, r, acc);
      float* dst = s_mid + c * mid_p + run * RUN;
#pragma unroll
      for (int q = 0; q < RUN; ++q) dst[q] = acc[q];
    }
    __syncthreads();

    // W pass: every row of the tile, RUN columns an item, into the
    // staging tile.
    const int n_wruns = tile_w / RUN;
    for (int it = threadIdx.x; it < n_wruns * tile_h; it += THREADS) {
      const int jr = it / tile_h;
      const int i = it - jr * tile_h;
      stencil_run<RC>(s_mid + jr * RUN * mid_p + i, mid_p, t, r, acc);
      float* dst = s_out + i * out_p + jr * RUN;
#pragma unroll
      for (int q = 0; q < RUN; ++q) dst[q] = acc[q];
    }
    __syncthreads();

    // Store the tile's outputs inside the image, row by row.
    const int rest = tile / tiles_x;
    const int x0 = (tile - rest * tiles_x) * tile_w;
    const int y0 = (rest % tiles_y) * tile_h;
    float* dst = out + (size_t)(rest / tiles_y) * H * W;
    const int rows = min(tile_h, H - y0);
    const int cols = min(tile_w, W - x0);
    for (int i = warp; i < rows; i += WARPS) {
      float* orow = dst + (size_t)(y0 + i) * W + x0;
      const float* srow = s_out + i * out_p;
      for (int j = lane; j < cols; j += 32) orow[j] = srow[j];
    }
    buf ^= 1;
  }
}

template <int RC>
int launch(const float* x, const float* taps, Taps<RC> t, float* out, int H,
           int W, int r, int tile_h, int tile_w, int tiles_x, int tiles_y,
           int n_tiles, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      separable_blur_kernel<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, separable_blur_kernel<RC>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // Persistent blocks: as many as the card holds at once, at most one a
  // tile.
  const int blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  separable_blur_kernel<RC><<<blocks, THREADS, smem, stream>>>(
      x, taps, t, out, H, W, r, tile_h, tile_w, tiles_x, tiles_y, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Blur N planes of (H, W) with the 2r + 1 taps, given both on the device
// (`taps`) and on the host (`host_taps`, read before this returns), on
// `stream`, with the wrapper's plan: tiles of tile_h x tile_w (multiples
// of 8), tiles_x x tiles_y of them a plane, and smem_bytes of dynamic
// shared memory, which must match the kernel's layout. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for a plan
// the kernel does not take); does not synchronise.
extern "C" int separable_blur_launch(const float* x, const float* taps,
                                     const float* host_taps, float* out,
                                     int N, int H, int W, int r, int tile_h,
                                     int tile_w, int tiles_x, int tiles_y,
                                     long long smem_bytes, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (r < 0 || 2 * r + 1 > MAX_TAPS || tile_h < RUN || tile_w < RUN ||
      tile_h % RUN || tile_w % RUN ||
      tiles_x != (W + tile_w - 1) / tile_w ||
      tiles_y != (H + tile_h - 1) / tile_h ||
      (long long)tiles_x * tiles_y * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = tiles_x * tiles_y * N;
  const size_t smem = sizeof(float) * smem_floats(r, tile_h, tile_w);
  if ((long long)smem != smem_bytes || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (r == FOG_RADIUS) {
    Taps<FOG_RADIUS> t;
    for (int k = 0; k <= 2 * FOG_RADIUS; ++k) t.v[k] = host_taps[k];
    return launch<FOG_RADIUS>(x, taps, t, out, H, W, r, tile_h, tile_w,
                              tiles_x, tiles_y, n_tiles, smem,
                              (cudaStream_t)stream);
  }
  return launch<0>(x, taps, Taps<0>{nullptr}, out, H, W, r, tile_h, tile_w,
                   tiles_x, tiles_y, n_tiles, smem, (cudaStream_t)stream);
}

extern "C" const char* separable_blur_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
