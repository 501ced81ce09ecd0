// chol-bundle: per row of z, G^{-1} = sum_k exp(-||z - c_k||^2 / T^2) M_k + diag*I,
// then L = chol(G^{-1}) (lower, row-major [B,16,16]) and logdet = 2 sum_i log L_ii.
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/metric_kernels.py:470
// chol_bundle_pallas (_chol_bundle_kernel, resident bank; _chol_bundle_kernel_kc,
// K-chunked bank).
//
// What bounds it on an H100: at serving sizes (B <= 64, K = 50) the work is
// ~30 kFLOP and ~55 KB of bank per row, microseconds of either resource, so the
// launch itself bounds it.  At large K (>= 20 000) every row streams the whole
// bank (K * 1 KB), which sits in the 50 MB L2 after the first block touches it;
// the bound is then the bank's bytes over the memory rate for one pass plus
// the fp32 FMAs of the weighted sum.
//
// Design: one warp per row, ROWS warps per block.  K is walked in chunks of 32
// centroids staged through shared memory (centroids and matrices), shared by the
// block's rows, so any K works with one code path.  Lane j of a warp computes the
// weight of centroid k0+j with d^2 as direct differences in fp32; the weights are
// then broadcast with __shfl_sync and each lane accumulates 8 of the 256 entries
// of G^{-1} (entries lane + 32e, so the shared-memory reads are conflict-free).
// The 16x16 Cholesky runs column by column in the warp's own shared-memory tile,
// lanes 0..15 owning rows, in the same order of operations as
// rlvae_tpu_torch/ops/linalg.py::cholesky_small.  fp32 IEEE arithmetic throughout.
#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int DD = D * D;
constexpr int KC = 32;    // centroids per staged chunk (one per lane)
constexpr int ROWS = 4;   // rows (warps) per block
constexpr int THREADS = ROWS * 32;

__global__ void __launch_bounds__(THREADS)
chol_bundle_kernel(const float* __restrict__ z, const float* __restrict__ c,
                   const float* __restrict__ m, float inv_t2, float diag,
                   float* __restrict__ l_out, float* __restrict__ logdet_out,
                   int n_rows, int n_centroids) {
  __shared__ float m_s[KC * DD];     // 32 KB: the chunk's matrices
  __shared__ float c_s[KC * (D + 1)];  // the chunk's centroids, rows padded against bank conflicts
  __shared__ float a_s[ROWS][DD];    // 4 KB: one G^{-1} / L tile per warp

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + warp;
  const bool live = row < n_rows;

  float zr[D];
#pragma unroll
  for (int i = 0; i < D; ++i) zr[i] = live ? z[row * D + i] : 0.f;

  float acc[DD / 32];
#pragma unroll
  for (int e = 0; e < DD / 32; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < n_centroids; k0 += KC) {
    const int nk = min(KC, n_centroids - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int idx = threadIdx.x; idx < nk * DD; idx += THREADS)
      m_s[idx] = m[(size_t)k0 * DD + idx];
    for (int idx = threadIdx.x; idx < nk * D; idx += THREADS)
      c_s[(idx / D) * (D + 1) + idx % D] = c[(size_t)k0 * D + idx];
    __syncthreads();

    float w = 0.f;
    if (lane < nk) {
      float d2 = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float diff = zr[i] - c_s[lane * (D + 1) + i];
        d2 += diff * diff;
      }
      w = expf(-d2 * inv_t2);
    }
    for (int j = 0; j < nk; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
#pragma unroll
      for (int e = 0; e < DD / 32; ++e)
        acc[e] = fmaf(wj, m_s[j * DD + lane + 32 * e], acc[e]);
    }
  }

  float* a = a_s[warp];
#pragma unroll
  for (int e = 0; e < DD / 32; ++e) {
    const int idx = lane + 32 * e;
    a[idx] = (idx % (D + 1) == 0) ? acc[e] + diag : acc[e];
  }
  __syncwarp();

  // Column-by-column Cholesky in place: column j of the lower triangle is
  // replaced by L[:, j]; the strict upper triangle is never read.
  const int i = lane & (D - 1);
  for (int j = 0; j < D; ++j) {
    float v = a[i * D + j];
    for (int k = 0; k < j; ++k) v -= a[i * D + k] * a[j * D + k];
    const float ljj = sqrtf(__shfl_sync(0xffffffffu, v, j));
    __syncwarp();
    if (lane < D && lane >= j) a[i * D + j] = v / ljj;
    __syncwarp();
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < DD / 32; ++e) {
      const int idx = lane + 32 * e;
      l_out[(size_t)row * DD + idx] = ((idx & (D - 1)) <= (idx >> 4)) ? a[idx] : 0.f;
    }
    if (lane == 0) {
      float s = 0.f;
      for (int j = 0; j < D; ++j) s += logf(a[j * D + j]);
      logdet_out[row] = 2.f * s;
    }
  }
}

}  // namespace

extern "C" int chol_bundle_f32(const float* z, const float* c, const float* m,
                               float inv_t2, float diag, float* l_out,
                               float* logdet_out, int n_rows, int n_centroids,
                               cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  chol_bundle_kernel<<<blocks, THREADS, 0, stream>>>(z, c, m, inv_t2, diag, l_out,
                                                      logdet_out, n_rows, n_centroids);
  return static_cast<int>(cudaGetLastError());
}
