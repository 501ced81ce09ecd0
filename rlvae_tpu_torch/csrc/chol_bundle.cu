// chol-bundle: per row of z,
//
//   w_k    = exp(-||z - c_k||^2 / T^2)                 (direct differences, fp32)
//   G^{-1} = sum_k w_k M_k + diag*I                    (diag = lbd + jitter)
//   L      = chol(G^{-1}),  logdet = 2 sum_i log L_ii
//
// L lower, row-major [B,d,d], with exact zeros above the diagonal, at any
// latent width 1 <= d <= 32 (hmc_bank.cuh: compiled at DP = 16 and 32).
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/metric_kernels.py:470
// chol_bundle_pallas (_chol_bundle_kernel, resident bank; _chol_bundle_kernel_kc,
// K-chunked bank).
//
// What bounds it on an H100: at the serving and training sizes (B <= 64,
// K = 50) the work is ~30 kFLOP per row and ~55 KB of bank in all, well under
// a microsecond of either resource, so latency bounds it: a chunk's staging,
// a warp's short walk, the warp- and CTA-order sums, and the epilogue's 16
// dependent column steps (the hmc_sweep profile at B = 64: 2.6 us of the CTA's
// 5.4 in the Cholesky).  At a dataset-sized bank (K = 20 000) the fp32 FMAs of
// the weighted sum bound it: 0.72 GFLOP at B = 64, 0.0107 ms at 67 TFLOP/s
// (the profile: 42 us of 58 in the weights and the sums).
//
// Design: the front half is csrc/hmc_bank.cuh's, without the gradient's
// second sum (bank_sums<R, false>): the bank split over the CTAs of a
// thread-block cluster and the warps of a CTA, rows blocked in registers,
// chunks staged by bulk copies onto mbarriers, the sums added in warp and
// rank order, one launch at any K with no workspace.  The leader CTA then
// gives each of its rows to a warp: hmc_bank.cuh's register Cholesky (B4's:
// lane j (DP = 16: and its mirror j + 16) owns row j, one rank-1 update per
// column), sum_i log L_ii by a DP-lane shuffle tree of logf, and row j of L
// stored by those lanes (as float4s at d = DP).  No atomics: a relaunch and a CUDA-graph
// replay give the same bits.  fp32 IEEE arithmetic throughout (expf, logf,
// sqrtf, __frsqrt_rn; no fast math).
#include "hmc_bank.cuh"

namespace {

using namespace hmc;

template <int DP, int R>
__global__ void __launch_bounds__(max_warps(R, CHOL_BUNDLE, DP) * 32)
chol_bundle_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock<HMC_PHASES> clk(p.prof);
  const float* sum = bank_sums<DP, R, false>(p, smem, clk);
  if (sum != nullptr) {
    const int row0 = (int)(blockIdx.x / cg::this_cluster().num_blocks()) * R;
    const int dd = p.dim * p.dim;
    for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
      const int row = row0 + r;
      if (row >= p.n_rows) break;  // warp-uniform: the shuffles below need every lane
      float a[DP], ljj, inv_ljj;
      cholesky_row<DP>(sum + r * Bank<DP>::DD, p.lbd, p.dim, a, ljj, inv_ljj);
      clk.lap(CHOLESKY);
      const float s = sum_log_diag<DP>(ljj);
      store_lower_row<DP>(a, p.out0 + (size_t)row * dd, p.dim);
      if ((threadIdx.x & 31) == 0) p.out1[row] = 2.f * s;
    }
  }
  clk.lap(FINISH);
  clk.finish();
}

template <int DP>
int launch_dp(const Params& p, const Geometry& g, cudaStream_t stream) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(launch<DP>(chol_bundle_kernel<DP, R_>, p, g, CHOL_BUNDLE,
                                                stream)))
}

int launch_chol(const float* z, const float* c, const float* m, float inv_t2, float diag,
                float* l_out, float* logdet_out, int n_rows, int n_centroids, int dim,
                const Geometry* given, long long* prof, cudaStream_t stream) {
  if (!valid_dim(dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params p{z, c, m, inv_t2, diag, 0.f, l_out, logdet_out, n_rows, n_centroids, prof};
  p.dim = dim;
  const bool wide = padded_dim(dim) == 32;
  Geometry g;
  if (given != nullptr) {
    g = *given;
  } else {
    const cudaError_t err = wide ? rule_geometry<32>(n_rows, n_centroids, CHOL_BUNDLE, &g)
                                 : rule_geometry<16>(n_rows, n_centroids, CHOL_BUNDLE, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return wide ? launch_dp<32>(p, g, stream) : launch_dp<16>(p, g, stream);
}

template <int DP>
int slots_dp(const Geometry& g, int* out) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(cluster_slots<DP>(chol_bundle_kernel<DP, R_>, g,
                                                       CHOL_BUNDLE, out)))
}

}  // namespace

// The rule's geometry for (B, K, d) on the current card; z [B, d], the bank
// padded to d's compiled width (c [K, DP], M [K, DP, DP]).
extern "C" int chol_bundle_f32(const float* z, const float* c, const float* m, float inv_t2,
                               float diag, float* l_out, float* logdet_out, int n_rows,
                               int n_centroids, int dim, cudaStream_t stream) {
  return launch_chol(z, c, m, inv_t2, diag, l_out, logdet_out, n_rows, n_centroids, dim, nullptr,
                     nullptr, stream);
}

// A given geometry (rows per CTA, warps per CTA, CTAs per cluster), for the
// sweep (rlvae_tpu_torch.ops.hmc_sweep) and the tests.
extern "C" int chol_bundle_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                                  float diag, float* l_out, float* logdet_out, int n_rows,
                                  int n_centroids, int dim, int rows, int warps, int ctas,
                                  cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_chol(z, c, m, inv_t2, diag, l_out, logdet_out, n_rows, n_centroids, dim, &g,
                     nullptr, stream);
}

// How many clusters of (rows, warps, ctas) of this kernel at width dp (16 or
// 32) the card holds at once, in out[0] (hmc_cluster_slots' CHOL_BUNDLE).
extern "C" int chol_bundle_cluster_slots(int rows, int warps, int ctas, int dp, int* out) {
  const hmc::Geometry g{rows, warps, ctas, 1};
  if (dp == 32) return slots_dp<32>(g, out);
  if (dp == 16) return slots_dp<16>(g, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef HMC_PROFILE
// ... at a given geometry, with the clock64 sums per phase (HMC_PHASES) in prof.
extern "C" int chol_bundle_profile_f32(const float* z, const float* c, const float* m,
                                       float inv_t2, float diag, float* l_out, float* logdet_out,
                                       int n_rows, int n_centroids, int dim, int rows, int warps,
                                       int ctas, long long* prof, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_chol(z, c, m, inv_t2, diag, l_out, logdet_out, n_rows, n_centroids, dim, &g, prof,
                     stream);
}
#endif
