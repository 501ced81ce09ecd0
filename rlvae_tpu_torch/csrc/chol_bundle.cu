// chol-bundle: per row of z,
//
//   w_k    = exp(-||z - c_k||^2 / T^2)                 (direct differences, fp32)
//   G^{-1} = sum_k w_k M_k + diag*I                    (diag = lbd + jitter)
//   L      = chol(G^{-1}),  logdet = 2 sum_i log L_ii
//
// L lower, row-major [B,16,16], with exact zeros above the diagonal.
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
// lane j and its mirror j + 16 own row j, one rank-1 update per column),
// sum_i log L_ii by a 16-lane shuffle tree of logf, and row j of L stored by
// lanes j and j + 16 as float4s.  No atomics: a relaunch and a CUDA-graph
// replay give the same bits.  fp32 IEEE arithmetic throughout (expf, logf,
// sqrtf, __frsqrt_rn; no fast math).
#include "hmc_bank.cuh"

namespace {

using namespace hmc;

template <int R>
__global__ void __launch_bounds__(max_warps(R, CHOL_BUNDLE) * 32)
chol_bundle_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock<HMC_PHASES> clk(p.prof);
  const float* sum = bank_sums<R, false>(p, smem, clk);
  if (sum != nullptr) {
    const int row0 = (int)(blockIdx.x / cg::this_cluster().num_blocks()) * R;
    for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
      const int row = row0 + r;
      if (row >= p.n_rows) break;  // warp-uniform: the shuffles below need every lane
      float a[D], ljj, inv_ljj;
      cholesky_row(sum + r * DD, p.lbd, a, ljj, inv_ljj);
      clk.lap(CHOLESKY);
      const float s = sum_log_diag(ljj);
      store_lower_row(a, p.out0 + (size_t)row * DD);
      if ((threadIdx.x & 31) == 0) p.out1[row] = 2.f * s;
    }
  }
  clk.lap(FINISH);
  clk.finish();
}

int launch_chol(const float* z, const float* c, const float* m, float inv_t2, float diag,
                float* l_out, float* logdet_out, int n_rows, int n_centroids, Geometry g,
                long long* prof, cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const Params p{z, c, m, inv_t2, diag, 0.f, l_out, logdet_out, n_rows, n_centroids, prof};
  switch (g.rows) {
    case 1: return static_cast<int>(launch(chol_bundle_kernel<1>, p, g, CHOL_BUNDLE, stream));
    case 2: return static_cast<int>(launch(chol_bundle_kernel<2>, p, g, CHOL_BUNDLE, stream));
    case 4: return static_cast<int>(launch(chol_bundle_kernel<4>, p, g, CHOL_BUNDLE, stream));
    case 8: return static_cast<int>(launch(chol_bundle_kernel<8>, p, g, CHOL_BUNDLE, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The rule's geometry for (B, K) on the current card.
extern "C" int chol_bundle_f32(const float* z, const float* c, const float* m, float inv_t2,
                               float diag, float* l_out, float* logdet_out, int n_rows,
                               int n_centroids, cudaStream_t stream) {
  hmc::Geometry g;
  const cudaError_t err = hmc::rule_geometry(n_rows, n_centroids, hmc::CHOL_BUNDLE, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_chol(z, c, m, inv_t2, diag, l_out, logdet_out, n_rows, n_centroids, g, nullptr,
                     stream);
}

// A given geometry (rows per CTA, warps per CTA, CTAs per cluster), for the
// sweep (rlvae_tpu_torch.ops.hmc_sweep) and the tests.
extern "C" int chol_bundle_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                                  float diag, float* l_out, float* logdet_out, int n_rows,
                                  int n_centroids, int rows, int warps, int ctas,
                                  cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_chol(z, c, m, inv_t2, diag, l_out, logdet_out, n_rows, n_centroids, g, nullptr,
                     stream);
}

// How many clusters of (rows, warps, ctas) of this kernel the card holds at
// once, in out[0] (hmc_cluster_slots' CHOL_BUNDLE).
extern "C" int chol_bundle_cluster_slots(int rows, int warps, int ctas, int* out) {
  using namespace hmc;
  const Geometry g{rows, warps, ctas, 1};
  switch (rows) {
    case 1: return static_cast<int>(cluster_slots(chol_bundle_kernel<1>, g, CHOL_BUNDLE, out));
    case 2: return static_cast<int>(cluster_slots(chol_bundle_kernel<2>, g, CHOL_BUNDLE, out));
    case 4: return static_cast<int>(cluster_slots(chol_bundle_kernel<4>, g, CHOL_BUNDLE, out));
    case 8: return static_cast<int>(cluster_slots(chol_bundle_kernel<8>, g, CHOL_BUNDLE, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef HMC_PROFILE
// ... at a given geometry, with the clock64 sums per phase (HMC_PHASES) in prof.
extern "C" int chol_bundle_profile_f32(const float* z, const float* c, const float* m,
                                       float inv_t2, float diag, float* l_out, float* logdet_out,
                                       int n_rows, int n_centroids, int rows, int warps, int ctas,
                                       long long* prof, cudaStream_t stream) {
  const hmc::Geometry g{rows, warps, ctas, (n_rows + rows - 1) / rows};
  return launch_chol(z, c, m, inv_t2, diag, l_out, logdet_out, n_rows, n_centroids, g, prof,
                     stream);
}
#endif
