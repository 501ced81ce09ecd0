// HMC partials: per row of z, over one shard of the centroid bank,
//
//   w_k     = exp(-||z - c_k||^2 / T^2)                  (direct differences, fp32)
//   gi_part = sum_k w_k M_k                              (no + lbd*I)
//   v_j     = (-2/T^2) sum_k w_k sum_i (c_k - z)_i M_k[i,j]
//
// the K-proportional part of the manifold-HMC terms.  The centroid-sharded
// path (rlvae_tpu_torch/parallel/metric_parallel.py) sums gi_part and v over
// the shards in one all-reduce and then finishes locally: + lbd*I, Cholesky,
// log-det, inverse and G v.  gi_part is written i-major ([B,16,16], entry
// (i, j) at i*16 + j), v as [B,16].
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

template <int R>
__global__ void __launch_bounds__(max_warps(R, HMC) * 32)
hmc_partials_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock<HMC_PHASES> clk(p.prof);
  const float* sum = bank_sums<R, true>(p, smem, clk);
  if (sum != nullptr) {
    const int row0 = (int)(blockIdx.x / cg::this_cluster().num_blocks()) * R;
    const float scale = -2.f * p.inv_t2;
    for (int idx = threadIdx.x; idx < R * WIDTH; idx += blockDim.x) {
      const int row = row0 + idx / WIDTH, e = idx % WIDTH;
      if (row >= p.n_rows) continue;
      if (e < DD)
        p.out0[(size_t)row * DD + e] = sum[idx];
      else
        p.out1[(size_t)row * D + e - DD] = sum[idx] * scale;
    }
  }
  clk.lap(FINISH);
  clk.finish();
}

int launch_partials(const float* z, const float* c, const float* m, float inv_t2, float* gi_out,
                    float* v_out, int n_rows, int n_centroids, Geometry g, long long* prof,
                    cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const Params p{z, c, m, inv_t2, 0.f, 0.f, gi_out, v_out, n_rows, n_centroids, prof};
  switch (g.rows) {
    case 1: return static_cast<int>(launch(hmc_partials_kernel<1>, p, g, HMC, stream));
    case 2: return static_cast<int>(launch(hmc_partials_kernel<2>, p, g, HMC, stream));
    case 4: return static_cast<int>(launch(hmc_partials_kernel<4>, p, g, HMC, stream));
    case 8: return static_cast<int>(launch(hmc_partials_kernel<8>, p, g, HMC, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The rule's geometry for (B, K) on the current card.
extern "C" int hmc_partials_f32(const float* z, const float* c, const float* m, float inv_t2,
                                float* gi_out, float* v_out, int n_rows, int n_centroids,
                                cudaStream_t stream) {
  hmc::Geometry g;
  const cudaError_t err = hmc::rule_geometry(n_rows, n_centroids, hmc::HMC, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_partials(z, c, m, inv_t2, gi_out, v_out, n_rows, n_centroids,
                         g, nullptr, stream);
}

// A given geometry (rows per CTA, warps per CTA, CTAs per cluster), for the
// sweep (rlvae_tpu_torch.ops.hmc_sweep) and the tests.
extern "C" int hmc_partials_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                                   float* gi_out, float* v_out, int n_rows, int n_centroids,
                                   int rows, int warps, int ctas, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_partials(z, c, m, inv_t2, gi_out, v_out, n_rows, n_centroids, g, nullptr, stream);
}

#ifdef HMC_PROFILE
// ... at a given geometry, with the clock64 sums per phase (HMC_PHASES) in prof.
extern "C" int hmc_partials_profile_f32(const float* z, const float* c, const float* m,
                                        float inv_t2, float* gi_out, float* v_out, int n_rows,
                                        int n_centroids, int rows, int warps, int ctas,
                                        long long* prof, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_partials(z, c, m, inv_t2, gi_out, v_out, n_rows, n_centroids, g, prof, stream);
}
#endif
