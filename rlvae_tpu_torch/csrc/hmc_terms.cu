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
// Any latent width 1 <= d <= 32 (hmc_bank.cuh: compiled at DP = 16 and 32).
//
// What bounds it on an H100: at the generation path's sizes (B <= 64, K = 50)
// the work is ~57 kFLOP per row and ~55 KB of bank in all, well under a
// microsecond of either resource, so latency bounds it: a chunk's staging, the
// warps' short walks and sums, and the epilogue's chain of dependent steps.
// At large K (>= 20 000) the fp32 FMAs of the two weighted sums (G^{-1} and v)
// bound it, 1.41 GFLOP at B = 64: 0.021 ms at 67 TFLOP/s.
//
// Design: the front half is csrc/hmc_bank.cuh's (shared with
// csrc/hmc_partials.cu and the metric kernels): the bank split over the CTAs
// of a cluster and the warps of a CTA, rows blocked in registers, chunks
// staged by bulk copies, the sums added in warp and rank order.  The leader
// CTA then gives each of its rows to a warp, which holds G^{-1} in registers,
// lane j (DP = 16: and its mirror j + 16) owning row j of the lower triangle:
// - hmc_bank.cuh's right-looking Cholesky (cholesky_row, shared with B1 and
//   B6), one rank-1 update per column: DP dependent steps of a shuffle, a
//   sqrt beside a reciprocal sqrt, a product, a shuffle of the column and
//   one FMA (the left-looking form's last lane takes ~120 dependent steps);
//   L is then transposed once through shared memory for the second solve;
// - sum_i log L_ii by a DP-lane shuffle tree of logf;
// - G v as two triangular solves, L y = v then L^T x = y, each DP steps of a
//   product with 1 / L_jj (the Cholesky's reciprocal root), a shuffle and an
//   FMA, in registers: the same function as G formed explicitly, better
//   conditioned and cheaper.
// When every weight underflows (z far from the bank), G^{-1} = lbd*I, v = 0,
// and the outputs are the log_eps plateau and a zero gradient.  fp32 IEEE
// arithmetic throughout (expf, logf, log1pf, sqrtf, __frsqrt_rn; no fast math).
#include "hmc_bank.cuh"

namespace {

using namespace hmc;

// The epilogue of one row: sums [DD + DP] (G^{-1} without lbd, then v
// unscaled) -> log pi and grad [dim], by the calling warp; `scratch` is DP x
// (DP + 1) floats of shared memory of this warp's own.  A pad index j >= dim
// has L[j, j] = 1 and v_j = 0, so its y_j and x_j are exact zeros.
template <int DP>
__device__ __forceinline__ void finish_row(const float* sums, float inv_t2, float lbd,
                                           float log_eps, int dim, float* logpi_out,
                                           float* grad_out, float* scratch,
                                           PhaseClock<HMC_PHASES>& clk) {
  constexpr int DD = DP * DP;
  const int lane = threadIdx.x & 31;
  const int j = lane & (DP - 1);  // this lane's row of the tile
  float a[DP];  // row j of L in a[0..j]
  float ljj, inv_ljj;
  cholesky_row<DP>(sums, lbd, dim, a, ljj, inv_ljj);
  // column j of L (L[m, j], m > j) for the second solve: L transposed once
  // through this warp's scratch
  if (lane < DP) {
#pragma unroll
    for (int m = 0; m < DP; ++m) scratch[j * (DP + 1) + m] = m <= j ? a[m] : 0.f;
  }
  __syncwarp();
  float col[DP];
#pragma unroll
  for (int m = 0; m < DP; ++m) col[m] = scratch[m * (DP + 1) + j];
  clk.lap(CHOLESKY);

  const float s = sum_log_diag<DP>(ljj);

  // L y = v, then L^T x = y; lane j owns r_j and divides by L[j, j] as a
  // product with its reciprocal
  float r = sums[DD + j] * (-2.f * inv_t2);
  float y = 0.f;
#pragma unroll
  for (int m = 0; m < DP; ++m) {
    const float ym = __shfl_sync(FULL, r * inv_ljj, m);
    if (j == m) y = ym;
    if (j > m) r = fmaf(-a[m], ym, r);
  }
  r = y;
  float x = 0.f;
#pragma unroll
  for (int m = DP - 1; m >= 0; --m) {
    const float xm = __shfl_sync(FULL, r * inv_ljj, m);
    if (j == m) x = xm;
    if (j < m) r = fmaf(-col[m], xm, r);
  }
  if (lane < dim) grad_out[lane] = -0.5f * x;
  if (lane == 0) {
    // logaddexp(s, log_eps), as torch.logaddexp / jnp.logaddexp
    const float hi = fmaxf(s, log_eps);
    *logpi_out = hi + log1pf(expf(-fabsf(s - log_eps)));
  }
  __syncwarp();  // the scratch is read before a next row of this warp writes it
}

template <int DP, int R>
__global__ void __launch_bounds__(max_warps(R, HMC, DP) * 32)
hmc_terms_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock<HMC_PHASES> clk(p.prof);
  const float* sum = bank_sums<DP, R, true>(p, smem, clk);
  if (sum != nullptr) {
    const int row0 = (int)(blockIdx.x / cg::this_cluster().num_blocks()) * R;
    for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
      const int row = row0 + r;
      if (row < p.n_rows)
        finish_row<DP>(sum + r * width(true, DP), p.inv_t2, p.lbd, p.log_eps, p.dim,
                       p.out0 + row, p.out1 + (size_t)row * p.dim, warp_scratch<DP>(smem), clk);
    }
  }
  clk.lap(FINISH);
  clk.finish();
}

template <int DP>
int launch_dp(const Params& p, const Geometry& g, cudaStream_t stream) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(launch<DP>(hmc_terms_kernel<DP, R_>, p, g, HMC, stream)))
}

int launch_terms(const float* z, const float* c, const float* m, float inv_t2, float lbd,
                 float log_eps, float* logpi_out, float* grad_out, int n_rows, int n_centroids,
                 int dim, const Geometry* given, long long* prof, cudaStream_t stream) {
  if (!valid_dim(dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params p{z, c, m, inv_t2, lbd, log_eps, logpi_out, grad_out, n_rows, n_centroids, prof};
  p.dim = dim;
  const bool wide = padded_dim(dim) == 32;
  Geometry g;
  if (given != nullptr) {
    g = *given;
  } else {
    const cudaError_t err = wide ? rule_geometry<32>(n_rows, n_centroids, HMC, &g)
                                 : rule_geometry<16>(n_rows, n_centroids, HMC, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return wide ? launch_dp<32>(p, g, stream) : launch_dp<16>(p, g, stream);
}

template <int DP>
int slots_dp(const Geometry& g, int* out) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(cluster_slots<DP>(hmc_terms_kernel<DP, R_>, g, HMC, out)))
}

}  // namespace

// The rule's geometry for (B, K, d) on the current card; z [B, d], the bank
// padded to d's compiled width (c [K, DP], M [K, DP, DP]).
extern "C" int hmc_terms_f32(const float* z, const float* c, const float* m, float inv_t2,
                             float lbd, float log_eps, float* logpi_out, float* grad_out,
                             int n_rows, int n_centroids, int dim, cudaStream_t stream) {
  return launch_terms(z, c, m, inv_t2, lbd, log_eps, logpi_out, grad_out, n_rows, n_centroids,
                      dim, nullptr, nullptr, stream);
}

// A given geometry (rows per CTA, warps per CTA, CTAs per cluster), for the
// sweep (rlvae_tpu_torch.ops.hmc_sweep) and the tests.
extern "C" int hmc_terms_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                                float lbd, float log_eps, float* logpi_out, float* grad_out,
                                int n_rows, int n_centroids, int dim, int rows, int warps,
                                int ctas, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_terms(z, c, m, inv_t2, lbd, log_eps, logpi_out, grad_out, n_rows, n_centroids,
                      dim, &g, nullptr, stream);
}

// The rule's geometry of `kernel` (hmc_bank.cuh BankKernel: 0 B4 and B8, 1
// B1, 2 B6 and B7) at width dp (16 or 32) on the current card: out = {rows
// per CTA, warps per CTA, CTAs per cluster, clusters}.
extern "C" int hmc_geometry(int n_rows, int n_centroids, int sms, int kernel, int dp, int* out) {
  if (kernel < 0 || kernel >= hmc::BANK_KERNELS || !hmc::valid_dp(dp))
    return static_cast<int>(cudaErrorInvalidValue);
  hmc::Geometry g;
  const cudaError_t err = hmc::hmc_geometry(n_rows, n_centroids, sms, kernel, dp, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = g.rows;
  out[1] = g.warps;
  out[2] = g.ctas;
  out[3] = g.clusters;
  return 0;
}

// How many clusters of (rows, warps, ctas) of `kernel` at width dp (as
// hmc_geometry's) the card holds at once (B4's kernel of that many rows and
// that width for B4 and B8; B1's and B6's from their files), in out[0].
extern "C" int hmc_cluster_slots(int rows, int warps, int ctas, int kernel, int dp, int* out) {
  using namespace hmc;
  if (kernel < 0 || kernel >= BANK_KERNELS || !valid_dp(dp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == CHOL_BUNDLE) return chol_bundle_cluster_slots(rows, warps, ctas, dp, out);
  if (kernel == METRIC_BUNDLE) return metric_bundle_cluster_slots(rows, warps, ctas, dp, out);
  const Geometry g{rows, warps, ctas, 1};
  return dp == 32 ? slots_dp<32>(g, out) : slots_dp<16>(g, out);
}

#ifdef HMC_PROFILE
// ... at a given geometry, with the clock64 sums per phase (HMC_PHASES) in prof.
extern "C" int hmc_terms_profile_f32(const float* z, const float* c, const float* m,
                                     float inv_t2, float lbd, float log_eps, float* logpi_out,
                                     float* grad_out, int n_rows, int n_centroids, int dim,
                                     int rows, int warps, int ctas, long long* prof,
                                     cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_terms(z, c, m, inv_t2, lbd, log_eps, logpi_out, grad_out, n_rows, n_centroids,
                      dim, &g, prof, stream);
}
#endif
