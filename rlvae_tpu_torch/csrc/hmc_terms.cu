// HMC terms: per row of z, the manifold-HMC target and its pythae-form gradient
//
//   w_k    = exp(-||z - c_k||^2 / T^2)
//   G^{-1} = sum_k w_k M_k + lbd*I,   L = chol(G^{-1})
//   log pi = logaddexp(sum_i log L_ii, log_eps)
//   v_j    = (-2/T^2) sum_k w_k sum_i (c_k - z)_i M_k[i,j]
//   grad   = -1/2 G v,   G = (G^{-1})^{-1}
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/metric_kernels.py:809
// hmc_terms_pallas (_hmc_kernel with _v_slab, resident bank; _hmc_kernel_kc,
// K-chunked bank).  The gradient is the closed form the reference's sampler
// integrates with, not the exact gradient of log pi; it is reproduced as is.
//
// What bounds it on an H100: at the generation path's sizes (B <= 64, K = 50)
// the work is ~57 kFLOP per row and ~55 KB of bank in all, well under a
// microsecond of either resource.  What the card spends (~18 us of device time
// per launch at B=64, K=50, chip_smoke.py's profile on an H100 80GB HBM3 at
// 700 W) is latency: the dependent steps of one warp's column-by-column
// Cholesky and triangular solves, and the staging of each chunk.  At large K
// (>= 20 000) every row streams the whole bank (K * 1 KB, from L2 after the
// first block) and the fp32 FMAs of the two weighted sums (G^{-1} and v) bound
// it, with only B/4 blocks in flight.
//
// Design: the chol-bundle's (csrc/chol_bundle.cu), plus v.  One warp per row,
// ROWS warps per block; K is walked in chunks of 32 centroids staged through
// shared memory, shared by the block's rows, so any K takes one code path.
// Lane j computes the weight of centroid k0+j with d^2 as direct differences;
// each weight is broadcast with __shfl_sync.  Lane l owns the 8 entries
// (i, j) = ((l + 32e) / 16, l % 16) of the 16x16 tile, e = 0..7: rows
// i = 2e + l/16 of column j = l % 16.  One conflict-free shared-memory read of
// M_k[i, j] feeds both sums: acc[e] += w M[i,j] for G^{-1}, and
// vacc += (w (c_k - z)_i) M[i,j] for v, the weighted difference formed first
// (never sum(w c M) - sum(w z M), which cancels near the centroids).  The two
// half-warps' partial v_j are added with one shuffle.  The 16x16 Cholesky runs
// column by column in the warp's shared-memory tile, as in the chol-bundle.
// G v is taken as two triangular solves, L y = v then L^T x = y, instead of
// forming G: the same function, better conditioned and cheaper.  When every
// weight underflows (z far from the bank), G^{-1} = lbd*I, v = 0, and the
// outputs are the log_eps plateau and a zero gradient.  fp32 IEEE arithmetic
// throughout (expf, logf, log1pf; no fast math).
#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int DD = D * D;
constexpr int KC = 32;    // centroids per staged chunk (one per lane)
constexpr int ROWS = 4;   // rows (warps) per block
constexpr int THREADS = ROWS * 32;
constexpr int E = DD / 32;  // tile entries per lane

__global__ void __launch_bounds__(THREADS)
hmc_terms_kernel(const float* __restrict__ z, const float* __restrict__ c,
                 const float* __restrict__ m, float inv_t2, float lbd, float log_eps,
                 float* __restrict__ logpi_out, float* __restrict__ grad_out,
                 int n_rows, int n_centroids) {
  __shared__ float m_s[KC * DD];       // 32 KB: the chunk's matrices
  __shared__ float c_s[KC * (D + 1)];  // the chunk's centroids, rows padded against bank conflicts
  __shared__ float a_s[ROWS][DD];      // 4 KB: one G^{-1} / L tile per warp

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + warp;
  const bool live = row < n_rows;
  const int half = lane >> 4;    // this lane's rows of the tile: i = 2e + half
  const int col = lane & (D - 1);  // this lane's column of the tile: j

  float zr[D];
#pragma unroll
  for (int i = 0; i < D; ++i) zr[i] = live ? z[row * D + i] : 0.f;
  float zh[E];  // z_i for this lane's rows i = 2e + half
#pragma unroll
  for (int e = 0; e < E; ++e) zh[e] = half ? zr[2 * e + 1] : zr[2 * e];

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float vacc = 0.f;

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
      const float* mj = m_s + j * DD;
      const float* cj = c_s + j * (D + 1);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float mij = mj[lane + 32 * e];
        acc[e] = fmaf(wj, mij, acc[e]);
        const float wd = wj * (cj[2 * e + half] - zh[e]);
        vacc = fmaf(wd, mij, vacc);
      }
    }
  }
  // v_j: the two half-warps' partial sums over i, scaled by -2/T^2
  const float v = (vacc + __shfl_xor_sync(0xffffffffu, vacc, 16)) * (-2.f * inv_t2);

  float* a = a_s[warp];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = lane + 32 * e;
    a[idx] = (idx % (D + 1) == 0) ? acc[e] + lbd : acc[e];
  }
  __syncwarp();

  // Column-by-column Cholesky in place: column j of the lower triangle is
  // replaced by L[:, j]; the strict upper triangle is never read.
  const int i = col;  // lanes 0..15 own rows; lanes 16..31 mirror them
  for (int j = 0; j < D; ++j) {
    float s = a[i * D + j];
    for (int k = 0; k < j; ++k) s -= a[i * D + k] * a[j * D + k];
    const float ljj = sqrtf(__shfl_sync(0xffffffffu, s, j));
    __syncwarp();
    if (lane < D && lane >= j) a[i * D + j] = s / ljj;
    __syncwarp();
  }

  // L y = v (forward), then L^T x = y (backward); lane i < 16 owns r_i.
  float r = v;
  float y = 0.f;
  for (int j = 0; j < D; ++j) {
    const float yj = __shfl_sync(0xffffffffu, r, j) / a[j * D + j];
    if (i > j) r = fmaf(-a[i * D + j], yj, r);
    if (i == j) y = yj;
  }
  r = y;
  float x = 0.f;
  for (int j = D - 1; j >= 0; --j) {
    const float xj = __shfl_sync(0xffffffffu, r, j) / a[j * D + j];
    if (i < j) r = fmaf(-a[j * D + i], xj, r);
    if (i == j) x = xj;
  }

  if (live) {
    if (lane < D) grad_out[(size_t)row * D + lane] = -0.5f * x;
    if (lane == 0) {
      float s = 0.f;
      for (int j = 0; j < D; ++j) s += logf(a[j * D + j]);
      // logaddexp(s, log_eps), as torch.logaddexp / jnp.logaddexp
      const float hi = fmaxf(s, log_eps);
      logpi_out[row] = hi + log1pf(expf(-fabsf(s - log_eps)));
    }
  }
}

}  // namespace

extern "C" int hmc_terms_f32(const float* z, const float* c, const float* m, float inv_t2,
                             float lbd, float log_eps, float* logpi_out, float* grad_out,
                             int n_rows, int n_centroids, cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  hmc_terms_kernel<<<blocks, THREADS, 0, stream>>>(z, c, m, inv_t2, lbd, log_eps, logpi_out,
                                                    grad_out, n_rows, n_centroids);
  return static_cast<int>(cudaGetLastError());
}
