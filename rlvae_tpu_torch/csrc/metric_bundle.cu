// Metric bundle and G^{-1}: per row of z,
//
//   w_k    = exp(-||z - c_k||^2 / T^2)                 (direct differences, fp32)
//   G^{-1} = sum_k w_k M_k + lbd*I
//   L      = chol(G^{-1}),  logdet = 2 sum_i log L_ii
//   X      = L^{-1}         (forward substitution)
//   G      = X^T X          (= (G^{-1})^{-1})
//
// metric_bundle_f32 writes (G^{-1}, L, logdet, G); g_inv_f32 is the same
// kernel output-pruned to G^{-1}, launched at the same geometry, so its G^{-1}
// has the bundle's bits.  Every matrix is written i-major ([B,d,d], entry
// (i, j) at i*d + j); L's strict upper triangle holds exact zeros.  Any
// latent width 1 <= d <= 32 (hmc_bank.cuh: compiled at DP = 16 and 32).
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/metric_kernels.py:657
// metric_bundle_pallas (_bundle_kernel, resident bank; _bundle_kernel_kc,
// K-chunked bank) and rlvae_tpu/ops/metric_kernels.py:618 g_inv_pallas
// (_g_inv_kernel, _g_inv_kernel_kc).  The TPU kernels write j-major slabs and
// return G^{-1} transposed (it is symmetric); this port writes true i-major
// matrices.  Their MXU distance variants (mxu_dist) are a device for the TPU's
// matrix unit and are not ported: the distances here are elementwise.
//
// What bounds it on an H100: at the posterior's and the validation's sizes
// (B <= 64, K <= 200) the work is ~0.1 MFLOP per row and ~220 KB of bank in
// all, well under a microsecond of either resource, so latency bounds it: a
// chunk's staging, a warp's walk over its few chunks, the warp- and CTA-order
// sums, and the epilogue's ~48 dependent steps (16 columns of the Cholesky,
// 16 rows of the substitution, G's 16-deep sums; the hmc_sweep profile at
// B = 64, K = 200: 2.5, 1.0 and 0.6 us of the CTA's 8.8).  At a dataset-sized
// bank (K = 20 000) the fp32 FMAs of the weighted sum bound it: 0.72 GFLOP at
// B = 64, 0.0107 ms at 67 TFLOP/s (the profile: 39 us of 55 in the weights
// and the sums).
//
// Design: the front half is csrc/hmc_bank.cuh's, without the gradient's
// second sum (bank_sums<R, false>): the bank split over the CTAs of a
// thread-block cluster and the warps of a CTA, rows blocked in registers,
// chunks staged by bulk copies onto mbarriers, the sums added in warp and
// rank order; one launch at any K, with no workspace.  Every thread of the
// leader CTA then stores G^{-1} (as float4s at d = DP), and (metric_bundle_f32)
// each row goes to a warp, lane j (DP = 16: and its mirror j + 16) owning row j:
// - hmc_bank.cuh's register Cholesky (B4's and B1's), then sum_i log L_ii by
//   a DP-lane shuffle tree of logf;
// - X = L^{-1} by forward substitution in registers, DP steps: at step m,
//   lane m finishes row m of X (a product with its 1 / L[m, m], the
//   Cholesky's reciprocal root), which is broadcast by shuffles, and every
//   later row takes its term with one FMA;
// - G[i, j] = sum_{k >= max(i, j)} X[k, i] X[k, j] in increasing k, with X
//   sent once through the warp's DP x (DP + 1) scratch (conflict-free: lane i
//   reads row k's entry i, every lane of a half the same entries j).  (i, j) and
//   (j, i) take the same products in the same order, so G is bitwise
//   symmetric.
// No atomics: a relaunch and a CUDA-graph replay give the same bits.  When
// every weight underflows (z far from the bank), G^{-1} = lbd*I exactly.
// fp32 IEEE arithmetic throughout (expf, logf, sqrtf, __frsqrt_rn; no fast
// math).
#include "hmc_bank.cuh"

namespace {

using namespace hmc;

// G^{-1} = sums + lbd*I of the CTA's rows [row0, row0 + R), by every thread
// of the CTA (as float4s at d = DP): cholesky_row's own input, in its
// arithmetic; only the real d x d block is stored.
template <int DP, int R>
__device__ __forceinline__ void store_g_inv(const float* sum, int row0, const Params& p) {
  constexpr int DD = DP * DP;
  if (p.dim == DP) {
    for (int q = threadIdx.x; q < R * DD / 4; q += blockDim.x) {
      const int r = q / (DD / 4), e = 4 * (q % (DD / 4));
      const int row = row0 + r;
      if (row >= p.n_rows) break;
      const int i = e / DP, j = e % DP;
      float4 v = *reinterpret_cast<const float4*>(sum + r * DD + e);
      v.x = v.x + (j == i ? p.lbd : 0.f);
      v.y = v.y + (j + 1 == i ? p.lbd : 0.f);
      v.z = v.z + (j + 2 == i ? p.lbd : 0.f);
      v.w = v.w + (j + 3 == i ? p.lbd : 0.f);
      *reinterpret_cast<float4*>(p.out0 + (size_t)row * DD + e) = v;
    }
    return;
  }
  const int dd = p.dim * p.dim;
  for (int q = threadIdx.x; q < R * dd; q += blockDim.x) {
    const int r = q / dd, e = q % dd;
    const int row = row0 + r;
    if (row >= p.n_rows) break;
    const int i = e / p.dim, j = e % p.dim;
    p.out0[(size_t)row * dd + e] = sum[r * DD + i * DP + j] + (j == i ? p.lbd : 0.f);
  }
}

// L, logdet and G of one row from its sums [DD] (G^{-1} without lbd), by the
// calling warp; `scratch` is DP x (DP + 1) floats of shared memory of this
// warp's own.  The pad block of L, X and G is the identity, and the
// off-diagonal pad blocks are exact zeros: no pad entry is stored.
template <int DP>
__device__ __forceinline__ void finish_row(const float* sums, float lbd, int dim, float* l_out,
                                           float* logdet_out, float* g_out, float* scratch,
                                           PhaseClock<HMC_PHASES>& clk) {
  constexpr int CPL = Bank<DP>::CPL;
  const int lane = threadIdx.x & 31;
  const int j = lane & (DP - 1), h = lane / DP;
  float a[DP], ljj, inv_ljj;
  cholesky_row<DP>(sums, lbd, dim, a, ljj, inv_ljj);
  clk.lap(CHOLESKY);

  // X[j, c] = (delta_jc - sum_{m<j} L[j, m] X[m, c]) / L[j, j], row j in
  // lane j; x[c] = 0 for c > j throughout
  float x[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) x[c] = c == j ? 1.f : 0.f;
#pragma unroll
  for (int m = 0; m < DP; ++m) {
#pragma unroll
    for (int c = 0; c <= m; ++c) {
      const float xmc = __shfl_sync(FULL, x[c] * inv_ljj, m);  // X[m, c]
      if (j == m) x[c] = xmc;
      if (j > m) x[c] = fmaf(-a[m], xmc, x[c]);
    }
  }
  clk.lap(INVERSE);

  // G[j, c] for c = CPL h..CPL h + CPL - 1; the scratch is free once every
  // lane has passed the shuffles above
  if (lane < DP) {
#pragma unroll
    for (int c = 0; c < DP; ++c) scratch[j * (DP + 1) + c] = x[c];
  }
  __syncwarp();
  float g[CPL];
#pragma unroll
  for (int e = 0; e < CPL; ++e) g[e] = 0.f;
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    const float xkj = scratch[k * (DP + 1) + j];
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      const int c = CPL * h + e;
      if (k >= j && k >= c) g[e] = fmaf(xkj, scratch[k * (DP + 1) + c], g[e]);
    }
  }
  __syncwarp();  // the scratch is read before a next row of this warp writes it
  clk.lap(GRAM);

  if (dim == DP) {
    float4* dst = reinterpret_cast<float4*>(g_out + j * DP + CPL * h);
#pragma unroll
    for (int q = 0; q < CPL / 4; ++q)
      dst[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  } else if (j < dim) {
#pragma unroll
    for (int e = 0; e < CPL; ++e)
      if (CPL * h + e < dim) g_out[j * dim + CPL * h + e] = g[e];
  }
  const float s = sum_log_diag<DP>(ljj);
  store_lower_row<DP>(a, l_out, dim);
  if (lane == 0) *logdet_out = 2.f * s;
}

// BUNDLE: G^{-1}, L, logdet and G (out0..out3); otherwise G^{-1} alone.
template <int DP, int R, bool BUNDLE>
__global__ void __launch_bounds__(max_warps(R, METRIC_BUNDLE, DP) * 32)
metric_bundle_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  PhaseClock<HMC_PHASES> clk(p.prof);
  const float* sum = bank_sums<DP, R, false>(p, smem, clk);
  if (sum != nullptr) {
    const int row0 = (int)(blockIdx.x / cg::this_cluster().num_blocks()) * R;
    store_g_inv<DP, R>(sum, row0, p);
    clk.lap(FINISH);
    if constexpr (BUNDLE) {
      const int dd = p.dim * p.dim;
      for (int r = threadIdx.x >> 5; r < R; r += blockDim.x >> 5) {
        const int row = row0 + r;
        if (row >= p.n_rows) break;  // warp-uniform: the shuffles need every lane
        finish_row<DP>(sum + r * Bank<DP>::DD, p.lbd, p.dim, p.out1 + (size_t)row * dd,
                       p.out2 + row, p.out3 + (size_t)row * dd, warp_scratch<DP>(smem), clk);
      }
    }
  }
  clk.lap(FINISH);
  clk.finish();
}

template <int DP, bool BUNDLE>
int launch_dp(const Params& p, const Geometry& g, cudaStream_t stream) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(launch<DP>(metric_bundle_kernel<DP, R_, BUNDLE>, p, g,
                                                METRIC_BUNDLE, stream)))
}

template <bool BUNDLE>
int launch_bundle(const float* z, const float* c, const float* m, float inv_t2, float lbd,
                  float* gi_out, float* l_out, float* logdet_out, float* g_out, int n_rows,
                  int n_centroids, int dim, const Geometry* given, long long* prof,
                  cudaStream_t stream) {
  if (!valid_dim(dim)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params p{z, c, m, inv_t2, lbd, 0.f, gi_out, l_out, n_rows, n_centroids, prof,
           logdet_out, g_out};
  p.dim = dim;
  const bool wide = padded_dim(dim) == 32;
  Geometry g;
  if (given != nullptr) {
    g = *given;
  } else {  // B7 at B6's geometry
    const cudaError_t err = wide ? rule_geometry<32>(n_rows, n_centroids, METRIC_BUNDLE, &g)
                                 : rule_geometry<16>(n_rows, n_centroids, METRIC_BUNDLE, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return wide ? launch_dp<32, BUNDLE>(p, g, stream) : launch_dp<16, BUNDLE>(p, g, stream);
}

hmc::Geometry given(int n_rows, int rows, int warps, int ctas) {
  return hmc::Geometry{rows, warps, ctas, (n_rows + rows - 1) / rows};
}

template <int DP>
int slots_dp(const Geometry& g, int* out) {
  HMC_BANK_DISPATCH(DP, g.rows,
                    static_cast<int>(cluster_slots<DP>(metric_bundle_kernel<DP, R_, true>, g,
                                                       METRIC_BUNDLE, out)))
}

}  // namespace

// The rule's geometry for (B, K, d) on the current card (both entries take
// B6's); z [B, d], the bank padded to d's compiled width (c [K, DP], M [K,
// DP, DP]).
extern "C" int metric_bundle_f32(const float* z, const float* c, const float* m, float inv_t2,
                                 float lbd, float* gi_out, float* l_out, float* logdet_out,
                                 float* g_out, int n_rows, int n_centroids, int dim,
                                 cudaStream_t stream) {
  return launch_bundle<true>(z, c, m, inv_t2, lbd, gi_out, l_out, logdet_out, g_out, n_rows,
                             n_centroids, dim, nullptr, nullptr, stream);
}

extern "C" int g_inv_f32(const float* z, const float* c, const float* m, float inv_t2, float lbd,
                         float* gi_out, int n_rows, int n_centroids, int dim,
                         cudaStream_t stream) {
  return launch_bundle<false>(z, c, m, inv_t2, lbd, gi_out, nullptr, nullptr, nullptr, n_rows,
                              n_centroids, dim, nullptr, nullptr, stream);
}

// A given geometry (rows per CTA, warps per CTA, CTAs per cluster), for the
// sweep (rlvae_tpu_torch.ops.hmc_sweep) and the tests.
extern "C" int metric_bundle_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                                    float lbd, float* gi_out, float* l_out, float* logdet_out,
                                    float* g_out, int n_rows, int n_centroids, int dim, int rows,
                                    int warps, int ctas, cudaStream_t stream) {
  const hmc::Geometry g = given(n_rows, rows, warps, ctas);
  return launch_bundle<true>(z, c, m, inv_t2, lbd, gi_out, l_out, logdet_out, g_out, n_rows,
                             n_centroids, dim, &g, nullptr, stream);
}

extern "C" int g_inv_at_f32(const float* z, const float* c, const float* m, float inv_t2,
                            float lbd, float* gi_out, int n_rows, int n_centroids, int dim,
                            int rows, int warps, int ctas, cudaStream_t stream) {
  const hmc::Geometry g = given(n_rows, rows, warps, ctas);
  return launch_bundle<false>(z, c, m, inv_t2, lbd, gi_out, nullptr, nullptr, nullptr, n_rows,
                              n_centroids, dim, &g, nullptr, stream);
}

// How many clusters of (rows, warps, ctas) of the bundle's kernel at width dp
// (16 or 32) the card holds at once, in out[0] (hmc_cluster_slots'
// METRIC_BUNDLE).
extern "C" int metric_bundle_cluster_slots(int rows, int warps, int ctas, int dp, int* out) {
  const hmc::Geometry g{rows, warps, ctas, 1};
  if (dp == 32) return slots_dp<32>(g, out);
  if (dp == 16) return slots_dp<16>(g, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef HMC_PROFILE
// ... at a given geometry, with the clock64 sums per phase (HMC_PHASES) in prof.
extern "C" int metric_bundle_profile_f32(const float* z, const float* c, const float* m,
                                         float inv_t2, float lbd, float* gi_out, float* l_out,
                                         float* logdet_out, float* g_out, int n_rows,
                                         int n_centroids, int dim, int rows, int warps, int ctas,
                                         long long* prof, cudaStream_t stream) {
  const hmc::Geometry g = given(n_rows, rows, warps, ctas);
  return launch_bundle<true>(z, c, m, inv_t2, lbd, gi_out, l_out, logdet_out, g_out, n_rows,
                             n_centroids, dim, &g, prof, stream);
}

extern "C" int g_inv_profile_f32(const float* z, const float* c, const float* m, float inv_t2,
                                 float lbd, float* gi_out, int n_rows, int n_centroids, int dim,
                                 int rows, int warps, int ctas, long long* prof,
                                 cudaStream_t stream) {
  const hmc::Geometry g = given(n_rows, rows, warps, ctas);
  return launch_bundle<false>(z, c, m, inv_t2, lbd, gi_out, nullptr, nullptr, nullptr, n_rows,
                              n_centroids, dim, &g, prof, stream);
}
#endif
