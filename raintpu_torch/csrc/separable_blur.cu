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
// One thread block per (plane n, tile of TILE_H rows x TILE_W columns). The
// block loads the tile plus a halo of r = (K - 1) / 2 on each side into
// shared memory, reflecting out-of-range indices; the reflection folds as
// often as it needs to, so radius >= axis length works too (the Pallas
// kernel refuses those shapes; ops/blur._dense_axis_blur folds the same
// way). The H pass (down the rows, as the plain version's first matmul)
// writes a shared intermediate of TILE_H x (TILE_W + 2r); the W pass
// reads it and writes the output tile. The taps (K <= 129) are staged in
// shared memory from a small device array.
//
// What bounds it on this card: the bytes. Each element is read once and
// written once from device memory (the halo re-reads hit L2); its 4K
// FLOP (K taps on each axis) are ~100 FLOP per 8 bytes at K = 25, well
// under the card's ~20 FLOP/byte fp32 balance point, so the least time
// is 8 bytes per element over 3.35 TB/s. The halo makes each block read
// (TILE_H + 2r)(TILE_W + 2r) / (TILE_H TILE_W) = 2.1x its tile at r = 12
// from L2. Later work: taller tiles to amortise the halo, vectorised
// loads, and fusing the fog's elementwise math around the blur.
//
// Shared memory: taps + (TILE_H + 2r)(TILE_W + 2r) + TILE_H (TILE_W + 2r)
// floats — 53 KB at r = 12 and 130 KB at r = 64 — so the launch raises the
// kernel's dynamic shared-memory limit past the default 48 KB.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 129;

// REFLECT_101: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...; the reflection group
// has period 2(n - 1), so any index folds into [0, n).
__device__ __forceinline__ int reflect101(int j, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  j = (j < 0 ? -j : j) % p;
  return j >= n ? p - j : j;
}

size_t smem_bytes(int r) {
  const int k = 2 * r + 1;
  const int hw = TILE_W + 2 * r;
  return sizeof(float) * ((size_t)k + (size_t)(TILE_H + 2 * r) * hw +
                          (size_t)TILE_H * hw);
}

__global__ void __launch_bounds__(THREADS)
separable_blur_kernel(const float* __restrict__ x,      // (N, H, W)
                      const float* __restrict__ taps,   // (2r + 1,)
                      float* __restrict__ out,          // (N, H, W)
                      int H, int W, int r) {
  extern __shared__ float smem[];
  const int k_taps = 2 * r + 1;
  const int halo_w = TILE_W + 2 * r;
  const int halo_h = TILE_H + 2 * r;
  float* s_taps = smem;
  float* s_in = s_taps + k_taps;          // halo_h x halo_w
  float* s_mid = s_in + halo_h * halo_w;  // TILE_H x halo_w

  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const float* src = x + plane;

  for (int k = threadIdx.x; k < k_taps; k += blockDim.x) s_taps[k] = taps[k];
  for (int p = threadIdx.x; p < halo_h * halo_w; p += blockDim.x) {
    const int i = p / halo_w;
    const int j = p - i * halo_w;
    const int gy = reflect101(y0 - r + i, H);
    const int gx = reflect101(x0 - r + j, W);
    s_in[p] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // H pass: every halo column of the tile's rows.
  for (int p = threadIdx.x; p < TILE_H * halo_w; p += blockDim.x) {
    const int i = p / halo_w;
    const int j = p - i * halo_w;
    float acc = 0.0f;
    const float* col = s_in + i * halo_w + j;
    for (int k = 0; k < k_taps; ++k) acc = acc + s_taps[k] * col[k * halo_w];
    s_mid[p] = acc;
  }
  __syncthreads();

  // W pass: the tile's outputs inside the image.
  float* dst = out + plane;
  for (int p = threadIdx.x; p < TILE_H * TILE_W; p += blockDim.x) {
    const int i = p / TILE_W;
    const int j = p - i * TILE_W;
    const int y = y0 + i;
    const int xx = x0 + j;
    if (y >= H || xx >= W) continue;
    float acc = 0.0f;
    const float* row = s_mid + i * halo_w + j;
    for (int k = 0; k < k_taps; ++k) acc = acc + s_taps[k] * row[k];
    dst[(size_t)y * W + xx] = acc;
  }
}

}  // namespace

// Blur N planes of (H, W) with the 2r + 1 taps (device pointer) on
// `stream`. Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int separable_blur_launch(const float* x, const float* taps,
                                     float* out, int N, int H, int W, int r,
                                     void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (r < 0 || 2 * r + 1 > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(
      separable_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + TILE_W - 1) / TILE_W),
                  (unsigned)((H + TILE_H - 1) / TILE_H), (unsigned)N);
  separable_blur_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, taps, out, H, W, r);
  return (int)cudaGetLastError();
}

extern "C" const char* separable_blur_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
