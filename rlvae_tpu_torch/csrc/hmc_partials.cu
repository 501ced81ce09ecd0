// HMC partials: per row of z, over one shard of the centroid bank,
//
//   w_k     = exp(-||z - c_k||^2 / T^2)                  (direct differences, fp32)
//   gi_part = sum_k w_k M_k                              (no + lbd*I)
//   v_j     = (-2/T^2) sum_k w_k sum_i (c_k - z)_i M_k[i,j]
//
// the K-proportional part of the manifold-HMC terms.  The centroid-sharded
// path (rlvae_tpu_torch/parallel/metric_parallel.py) sums gi_part and v over
// the shards in one all-reduce and then finishes locally: + lbd*I, Cholesky,
// log-det, inverse and G v.  gi_part is written i-major ([B,d,d], entry
// (i, j) at i*d + j), v as [B,d], at any latent width 1 <= d <= 32
// (hmc_bank.cuh: compiled at DP = 16 and 32).
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/metric_kernels.py:886
// hmc_partials_pallas (_hmc_partial_kernel :869, resident bank;
// _hmc_partial_kernel_kc :438, K-chunked bank).  The TPU kernel returns the
// j-major slab reshaped, which is i-major only because every M_k is
// symmetric; this port writes true i-major matrices.
//
// What bounds it on an H100: per row and centroid ~1104 flops (d^2 48, the
// weighted sum of M 512, the weighted differences 32, their contraction with
// M 512) and the bank read once.  At the EP chain's sizes (B = 64, K = 50 per
// shard or fewer) that is 3.5 MFLOP and ~55 KB, well under a microsecond of
// either resource, so latency bounds it: the staging of a chunk, a warp's
// walk over its few chunks, the warp- and cluster-order sums.  At large K
// (>= 20 000) the fp32 FMAs of the two weighted sums bound it (1.41 GFLOP at
// B = 64: 0.021 ms at 67 TFLOP/s).
//
// Design: the front half of csrc/hmc_terms.cu, csrc/hmc_bank.cuh (the bank
// split over the CTAs of a cluster and the warps of a CTA, rows blocked in
// registers, chunks staged by bulk copies), then the leader CTA writes the
// cluster's sums, v scaled by -2/T^2 once after the whole sum.  One launch, no
// workspace, no atomics: a relaunch is bit-identical.
#include "hmc_bank.cuh"

namespace {

using namespace hmc;

template <int DP, int R>
__global__ void __launch_bounds__(max_warps(R, HMC, DP) * 32)
hmc_partials_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock<HMC_PHASES> clk(p.prof);
  const float* sum = bank_sums<DP, R, true>(p, smem, clk);
  if (sum != nullptr) {
    constexpr int W = width(true, DP);
    const int row0 = (int)(blockIdx.x / cg::this_cluster().num_blocks()) * R;
    const float scale = -2.f * p.inv_t2;
    const int dd = p.dim * p.dim, wd = dd + p.dim;
    for (int idx = threadIdx.x; idx < R * wd; idx += blockDim.x) {
      const int r = idx / wd, e = idx % wd;
      const int row = row0 + r;
      if (row >= p.n_rows) continue;
      if (e < dd)
        p.out0[(size_t)row * dd + e] = sum[r * W + (e / p.dim) * DP + e % p.dim];
      else
        p.out1[(size_t)row * p.dim + e - dd] = sum[r * W + DP * DP + e - dd] * scale;
    }
  }
  clk.lap(FINISH);
  clk.finish();
}

template <int DP>
int launch_dp(const Params& p, const Geometry& g, cudaStream_t stream) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(launch<DP>(hmc_partials_kernel<DP, R_>, p, g, HMC, stream)))
}

int launch_partials(const float* z, const float* c, const float* m, float inv_t2, float* gi_out,
                    float* v_out, int n_rows, int n_centroids, int dim, const Geometry* given,
                    long long* prof, cudaStream_t stream) {
  if (!valid_dim(dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params p{z, c, m, inv_t2, 0.f, 0.f, gi_out, v_out, n_rows, n_centroids, prof};
  p.dim = dim;
  const bool wide = padded_dim(dim) == 32;
  Geometry g;
  if (given != nullptr) {
    g = *given;
  } else {  // B4's geometry
    const cudaError_t err = wide ? rule_geometry<32>(n_rows, n_centroids, HMC, &g)
                                 : rule_geometry<16>(n_rows, n_centroids, HMC, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return wide ? launch_dp<32>(p, g, stream) : launch_dp<16>(p, g, stream);
}

}  // namespace

// The rule's geometry for (B, K, d) on the current card; z [B, d], the bank
// padded to d's compiled width (c [K, DP], M [K, DP, DP]).
extern "C" int hmc_partials_f32(const float* z, const float* c, const float* m, float inv_t2,
                                float* gi_out, float* v_out, int n_rows, int n_centroids,
                                int dim, cudaStream_t stream) {
  return launch_partials(z, c, m, inv_t2, gi_out, v_out, n_rows, n_centroids, dim, nullptr,
                         nullptr, stream);
}

// A given geometry (rows per CTA, warps per CTA, CTAs per cluster), for the
// sweep (rlvae_tpu_torch.ops.hmc_sweep) and the tests.
extern "C" int hmc_partials_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                                   float* gi_out, float* v_out, int n_rows, int n_centroids,
                                   int dim, int rows, int warps, int ctas, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_partials(z, c, m, inv_t2, gi_out, v_out, n_rows, n_centroids, dim, &g, nullptr,
                         stream);
}

#ifdef HMC_PROFILE
// ... at a given geometry, with the clock64 sums per phase (HMC_PHASES) in prof.
extern "C" int hmc_partials_profile_f32(const float* z, const float* c, const float* m,
                                        float inv_t2, float* gi_out, float* v_out, int n_rows,
                                        int n_centroids, int dim, int rows, int warps, int ctas,
                                        long long* prof, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_partials(z, c, m, inv_t2, gi_out, v_out, n_rows, n_centroids, dim, &g, prof,
                         stream);
}
#endif
