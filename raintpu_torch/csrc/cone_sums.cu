// Cone photometry sums for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the cone test to XLA
// (raintpu/ops/photometry.py, _cone_sums), and so did the port until this
// kernel, as plain PyTorch (raintpu_torch/ops/photometry._cone_sums, the
// plain version the CPU runs and the card tests hold this kernel to). That
// version writes the (frames, Q, N) planes of the test (Dn, Dp, s, w2 and
// the inside mask) to device memory and sums the mask against the 4
// feature columns as a float32 matrix product, whose 32-column tiles waste
// 28 of every 32 columns. Here nothing of size Q x N leaves the SM.
//
// For frame b, envmap texel block q and drop i (apex p_i, axis n_i, with
// pn_i = p_i . n_i and pp_i = p_i . p_i computed by the wrapper with the
// plain version's PyTorch expressions, and c2 = cos(fov/2)^2 read from the
// device):
//
//   Dn = (d_q0 n_i0 + d_q1 n_i1) + d_q2 n_i2,   Dp likewise with p_i,
//   s  = R Dn - pn_i,   w2 = (R^2 - (2R) Dp) + pp_i,
//   inside = s >= 0 and s s >= c2 w2,
//
// each operation rounded on its own in the plain version's order (explicit
// __fmul_rn / __fadd_rn, never contracted, and the file is built with
// --fmad=false besides), R^2 and 2R passed in as the float32 roundings of
// the plain version's Python floats. So the inside mask is the plain
// version's bit for bit, and only the order of the float sums of
//
//   sums[b, i] += feats[b, q]   (4 columns: x*sa, y*sa, Y*sa, sa)
//
// over the inside texels differs.
//
// Layout: a block of THREADS threads takes DROPS_PER_BLOCK drops of one
// frame (grid x; frame on grid y), each thread DPT of them, drop i =
// first + k * THREADS, whose constants (p, n, pn, pp) and sums stay in
// registers. The block walks its share of the texel axis TILE texel blocks
// at a time: the tile's directions and the frame's features go to shared
// memory as two float4s a texel (32 bytes), and every thread reads each
// texel once (a broadcast) for its DPT drops. A tile's inside features are
// summed on their own and then added to the drop's running sums, so a sum
// of Q terms rounds like one of about TILE + Q / TILE.
//
// Filling the card: frames x N drops can be few (KITTI at 10 mm/hr: 48 x
// 320, 30 blocks). The wrapper (ops/photometry.cone_plan) then splits the
// texel axis into `splits` parts of q_per_split (grid z), from the shapes
// and the SM count, so a launch has about BLOCKS_PER_SM blocks an SM. Each
// part writes its partial sums to (splits, frames, N, 4) and a second
// kernel adds the parts in order 0, 1, ..., splits - 1. No atomics: the
// sums are the same bit for bit from one launch to the next, and eager or
// replayed in a CUDA graph.
//
// What bounds it on this card: the tests, about 23 float32 operations each
// (none fused: --fmad=false), 6 x 8,344 x 16,384 of them on the nuScenes
// rig, at 128 lanes an SM a cycle. Bytes are small: p, n, pn, pp and the
// sums once per drop, the directions and features (0.2 MB a frame on the
// rig) once per block from L2.
//
// Capturable: launches on the caller's stream, allocates nothing (the
// wrapper passes the partial sums' buffer), never synchronises, and uses
// static shared memory only (8 KB), so no attribute is set at launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int DPT = 4;                       // drops a thread
constexpr int DROPS_PER_BLOCK = THREADS * DPT;
constexpr int TILE = 256;                    // texel blocks a shared tile
constexpr int SUM_THREADS = 256;
constexpr int MAX_GRID_YZ = 65535;

__global__ void __launch_bounds__(THREADS)
cone_sums_kernel(const float* __restrict__ p, const float* __restrict__ n,
                 const float* __restrict__ pn, const float* __restrict__ pp,
                 const float* __restrict__ dirs,
                 const float* __restrict__ feats,
                 const float* __restrict__ c2p, float r, float rr, float r2,
                 float* __restrict__ out, int frames, int N, int Q,
                 int q_per_split) {
  __shared__ float4 s_dir[TILE];
  __shared__ float4 s_feat[TILE];
  const int b = blockIdx.y;
  const int first = blockIdx.x * DROPS_PER_BLOCK + threadIdx.x;
  const float c2 = *c2p;

  float n0[DPT], n1[DPT], n2[DPT], p0[DPT], p1[DPT], p2[DPT], pnk[DPT],
      ppk[DPT], acc[DPT][4];
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    // Lanes past the frame's last drop repeat it and write nothing.
    const int i = min(first + k * THREADS, N - 1);
    const long long o = (long long)b * N + i;
    n0[k] = n[3 * o];
    n1[k] = n[3 * o + 1];
    n2[k] = n[3 * o + 2];
    p0[k] = p[3 * o];
    p1[k] = p[3 * o + 1];
    p2[k] = p[3 * o + 2];
    pnk[k] = pn[o];
    ppk[k] = pp[o];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.f;
  }

  const float* fb = feats + (long long)b * Q * 4;
  const int q_begin = blockIdx.z * q_per_split;
  const int q_end = min(Q, q_begin + q_per_split);
  for (int q0 = q_begin; q0 < q_end; q0 += TILE) {
    const int m = min(TILE, q_end - q0);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < m; j += THREADS) {
      const long long q = q0 + j;
      s_dir[j] = make_float4(dirs[3 * q], dirs[3 * q + 1], dirs[3 * q + 2],
                             0.f);
      s_feat[j] = make_float4(fb[4 * q], fb[4 * q + 1], fb[4 * q + 2],
                              fb[4 * q + 3]);
    }
    __syncthreads();

    float t[DPT][4];
#pragma unroll
    for (int k = 0; k < DPT; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) t[k][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < m; ++j) {
      const float4 d = s_dir[j];
      const float4 f = s_feat[j];
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        const float dn = __fadd_rn(
            __fadd_rn(__fmul_rn(d.x, n0[k]), __fmul_rn(d.y, n1[k])),
            __fmul_rn(d.z, n2[k]));
        const float dp = __fadd_rn(
            __fadd_rn(__fmul_rn(d.x, p0[k]), __fmul_rn(d.y, p1[k])),
            __fmul_rn(d.z, p2[k]));
        const float s = __fsub_rn(__fmul_rn(r, dn), pnk[k]);
        const float w2 = __fadd_rn(__fsub_rn(rr, __fmul_rn(r2, dp)), ppk[k]);
        const bool inside =
            (s >= 0.f) & (__fmul_rn(s, s) >= __fmul_rn(c2, w2));
        if (inside) {
          t[k][0] = __fadd_rn(t[k][0], f.x);
          t[k][1] = __fadd_rn(t[k][1], f.y);
          t[k][2] = __fadd_rn(t[k][2], f.z);
          t[k][3] = __fadd_rn(t[k][3], f.w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DPT; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[k][c] = __fadd_rn(acc[k][c], t[k][c]);
  }

  float4* o4 = reinterpret_cast<float4*>(out) +
               ((long long)blockIdx.z * frames + b) * N;
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int i = first + k * THREADS;
    if (i < N) o4[i] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
}

// out[e] = part[0][e] + part[1][e] + ... + part[splits - 1][e], in order.
__global__ void __launch_bounds__(SUM_THREADS)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  long long count, int splits) {
  for (long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
       e < count; e += (long long)gridDim.x * SUM_THREADS) {
    float s = part[e];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[k * count + e]);
    out[e] = s;
  }
}

}  // namespace

// The masked feature sums of `frames` frames of N drops over Q texel
// blocks, on `stream`: p, n (frames, N, 3), pn, pp (frames, N), dirs (Q, 3),
// feats (frames, Q, 4), c2 a device scalar, r, rr, r2 = R, R^2, 2R; out
// (frames, N, 4). The wrapper's plan:
// drop_blocks = ceil(N / 512) blocks along the drops, the texel axis in
// `splits` parts of q_per_split (splits = ceil(Q / q_per_split)), and with
// splits > 1 a `partial` buffer of (splits, frames, N, 4) floats (null
// otherwise). Pointers to float4 rows (out, partial) are 16-byte aligned.
// Returns the launches' cudaError_t (0 on success; cudaErrorInvalidValue for
// a plan the kernel does not take); does not synchronise.
extern "C" int cone_sums_launch(const float* p, const float* n,
                                const float* pn, const float* pp,
                                const float* dirs, const float* feats,
                                const float* c2, float r, float rr, float r2,
                                float* partial, float* out, int frames,
                                int N, int Q, int drop_blocks, int splits,
                                int q_per_split, void* stream) {
  if (frames < 1 || frames > MAX_GRID_YZ || N < 1 || Q < 1 ||
      drop_blocks != (N + DROPS_PER_BLOCK - 1) / DROPS_PER_BLOCK ||
      splits < 1 || splits > MAX_GRID_YZ || q_per_split < 1 ||
      splits != (Q + q_per_split - 1) / q_per_split ||
      (splits > 1) != (partial != nullptr) ||
      (reinterpret_cast<unsigned long long>(out) & 15) ||
      (reinterpret_cast<unsigned long long>(partial) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(drop_blocks, frames, splits);
  cone_sums_kernel<<<grid, THREADS, 0, s>>>(
      p, n, pn, pp, dirs, feats, c2, r, rr, r2,
      splits > 1 ? partial : out, frames, N, Q, q_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long count = (long long)frames * N * 4;
  long long blocks = (count + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(int)blocks, SUM_THREADS, 0, s>>>(partial, out, count,
                                                        splits);
  return (int)cudaGetLastError();
}

extern "C" const char* cone_sums_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
