// Metric bundle and G^{-1}: per row of z,
//
//   w_k    = exp(-||z - c_k||^2 / T^2)                 (direct differences, fp32)
//   G^{-1} = sum_k w_k M_k + lbd*I
//   L      = chol(G^{-1}),  logdet = 2 sum_i log L_ii
//   X      = L^{-1}         (forward substitution)
//   G      = X^T X          (= (G^{-1})^{-1})
//
// metric_bundle_f32 writes (G^{-1}, L, logdet, G); g_inv_f32 is the same front
// half, output-pruned to G^{-1}.  Every matrix is written i-major ([B,16,16],
// entry (i, j) at i*16 + j); L's strict upper triangle holds exact zeros.
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/metric_kernels.py:657
// metric_bundle_pallas (_bundle_kernel, resident bank; _bundle_kernel_kc,
// K-chunked bank) and rlvae_tpu/ops/metric_kernels.py:618 g_inv_pallas
// (_g_inv_kernel, _g_inv_kernel_kc).  The TPU kernels write j-major slabs and
// return G^{-1} transposed (it is symmetric); this port writes true i-major
// matrices.  Their MXU distance variants (mxu_dist) are a device for the TPU's
// matrix unit and are not ported: the distances here are elementwise.
//
// What bounds it on an H100: at the posterior's sizes (B <= 64, K <= 200) the
// work is ~0.1 MFLOP per row and ~200 KB of bank in all, well under a
// microsecond of either resource, so the latency of one warp's dependent
// steps (the K walk, the 16-column Cholesky, the 16-row substitution and the
// product) bounds it.  At large K (>= 20 000) the fp32 FMAs of the weighted
// sum and the bank's reads (K * 1 KB per block of rows, from L2 after the
// first touch) bound it.
//
// Design: the chol-bundle's (csrc/chol_bundle.cu), extended by the inverse.
// One warp per row, ROWS warps per block.  K is walked in chunks of 32
// centroids staged through shared memory, shared by the block's rows.  Lane j
// computes the weight of centroid k0+j; each weight is broadcast with
// __shfl_sync and each lane accumulates 8 of the 256 entries of G^{-1}
// (entries lane + 32e: conflict-free shared-memory reads).  The Cholesky runs
// column by column in the warp's shared-memory tile, lanes 0..15 owning rows,
// in the order of rlvae_tpu_torch/ops/linalg.py cholesky_small.  X = L^{-1}
// runs row by row, lanes 0..15 owning columns, in the order of the TPU
// kernel's _inv_rows_from_chol; G[i, j] sums X[k, i] X[k, j] over
// k = max(i, j)..15 in increasing k, so G is bitwise symmetric.
//
// Large K: with n_splits = 1 one kernel does everything, and a launch has
// only B/ROWS blocks.  The wrapper asks for n_splits > 1 when that leaves the
// card's SMs idle and K is large: then a grid of (B/ROWS) x n_splits blocks
// each sums one contiguous range of the bank into a workspace slot, and a
// second kernel adds the slots in split order (deterministic) and runs the
// epilogue.  fp32 IEEE arithmetic throughout (expf, logf, sqrtf; no fast math).
#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int DD = D * D;
constexpr int KC = 32;    // centroids per staged chunk (one per lane)
constexpr int ROWS = 4;   // rows (warps) per block
constexpr int THREADS = ROWS * 32;
constexpr int E = DD / 32;  // tile entries per lane

// acc[e] += sum_{k in [k_begin, k_end)} w_k M_k[lane + 32e] for this warp's
// row; every thread of the block calls it (it stages through shared memory).
__device__ void accumulate(const float* zr, const float* __restrict__ c,
                           const float* __restrict__ m, float inv_t2, int k_begin, int k_end,
                           float* m_s, float* c_s, float* acc) {
  const int lane = threadIdx.x & 31;
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    const int nk = min(KC, k_end - k0);
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
      for (int e = 0; e < E; ++e)
        acc[e] = fmaf(wj, m_s[j * DD + lane + 32 * e], acc[e]);
    }
  }
}

// From this warp's sums acc (without lbd): G^{-1}, and for FULL also L,
// logdet and G, written for row ``row`` when ``live``.  a and x are the
// warp's two shared-memory tiles.
template <bool FULL>
__device__ void epilogue(const float* acc, float lbd, int row, bool live, float* a, float* x,
                         float* __restrict__ gi_out, float* __restrict__ l_out,
                         float* __restrict__ logdet_out, float* __restrict__ g_out) {
  const int lane = threadIdx.x & 31;
  // G^{-1} = acc + lbd*I, i-major: entry idx = i*16 + j is M_k's own flat index
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = lane + 32 * e;
    const float v = (idx % (D + 1) == 0) ? acc[e] + lbd : acc[e];
    a[idx] = v;
    if (live) gi_out[(size_t)row * DD + idx] = v;
  }
  if (!FULL) return;
  __syncwarp();

  // Column-by-column Cholesky in place: column j of the lower triangle is
  // replaced by L[:, j]; the strict upper triangle is never read.
  const int i = lane & (D - 1);  // lanes 0..15 own rows; lanes 16..31 mirror them
  for (int j = 0; j < D; ++j) {
    float s = a[i * D + j];
    for (int k = 0; k < j; ++k) s -= a[i * D + k] * a[j * D + k];
    const float ljj = sqrtf(__shfl_sync(0xffffffffu, s, j));
    __syncwarp();
    if (lane < D && lane >= j) a[i * D + j] = s / ljj;
    __syncwarp();
  }

  // X = L^{-1} by forward substitution, lane c < 16 owning column c:
  // X[r, c] = (delta_rc - sum_{k<r} L[r, k] X[k, c]) / L[r, r].
  if (lane < D) {
    for (int r = 0; r < D; ++r) {
      float v = (r == lane) ? 1.f : 0.f;
      for (int k = 0; k < r; ++k) v = fmaf(-a[r * D + k], x[k * D + lane], v);
      x[r * D + lane] = v / a[r * D + r];
    }
  }
  __syncwarp();

  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = lane + 32 * e;
      const int gi = idx >> 4, gj = idx & (D - 1);
      l_out[(size_t)row * DD + idx] = (gj <= gi) ? a[idx] : 0.f;
      // G[gi, gj] = sum_{k >= max(gi, gj)} X[k, gi] X[k, gj] (X is lower-triangular)
      float s = 0.f;
      for (int k = max(gi, gj); k < D; ++k) s = fmaf(x[k * D + gi], x[k * D + gj], s);
      g_out[(size_t)row * DD + idx] = s;
    }
    if (lane == 0) {
      float s = 0.f;
      for (int j = 0; j < D; ++j) s += logf(a[j * D + j]);
      logdet_out[row] = 2.f * s;
    }
  }
}

__device__ void load_row(const float* __restrict__ z, int row, bool live, float* zr) {
#pragma unroll
  for (int i = 0; i < D; ++i) zr[i] = live ? z[row * D + i] : 0.f;
}

// n_splits = 1: the whole bank and the epilogue in one launch.
template <bool FULL>
__global__ void __launch_bounds__(THREADS)
metric_bundle_kernel(const float* __restrict__ z, const float* __restrict__ c,
                     const float* __restrict__ m, float inv_t2, float lbd,
                     float* __restrict__ gi_out, float* __restrict__ l_out,
                     float* __restrict__ logdet_out, float* __restrict__ g_out,
                     int n_rows, int n_centroids) {
  __shared__ float m_s[KC * DD];       // 32 KB: the chunk's matrices
  __shared__ float c_s[KC * (D + 1)];  // the chunk's centroids, rows padded against bank conflicts
  __shared__ float a_s[ROWS][DD];      // 4 KB: one G^{-1} / L tile per warp
  __shared__ float x_s[FULL ? ROWS : 1][DD];  // 4 KB: one X = L^{-1} tile per warp

  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + warp;
  const bool live = row < n_rows;
  float zr[D], acc[E];
  load_row(z, row, live, zr);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  accumulate(zr, c, m, inv_t2, 0, n_centroids, m_s, c_s, acc);
  epilogue<FULL>(acc, lbd, row, live, a_s[warp], x_s[FULL ? warp : 0], gi_out, l_out,
                 logdet_out, g_out);
}

// n_splits > 1, pass 1: block (x, s) sums bank range s into part[s, row, :].
__global__ void __launch_bounds__(THREADS)
partial_sum_kernel(const float* __restrict__ z, const float* __restrict__ c,
                   const float* __restrict__ m, float inv_t2, float* __restrict__ part,
                   int n_rows, int n_centroids, int per_split) {
  __shared__ float m_s[KC * DD];
  __shared__ float c_s[KC * (D + 1)];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const bool live = row < n_rows;
  const int k_begin = min(static_cast<int>(blockIdx.y) * per_split, n_centroids);
  const int k_end = min(k_begin + per_split, n_centroids);
  float zr[D], acc[E];
  load_row(z, row, live, zr);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  accumulate(zr, c, m, inv_t2, k_begin, k_end, m_s, c_s, acc);
  if (live) {
    float* out = part + ((size_t)blockIdx.y * n_rows + row) * DD;
#pragma unroll
    for (int e = 0; e < E; ++e) out[lane + 32 * e] = acc[e];
  }
}

// n_splits > 1, pass 2: add the slots in split order, then the epilogue.
template <bool FULL>
__global__ void __launch_bounds__(THREADS)
reduce_epilogue_kernel(const float* __restrict__ part, float lbd, float* __restrict__ gi_out,
                       float* __restrict__ l_out, float* __restrict__ logdet_out,
                       float* __restrict__ g_out, int n_rows, int n_splits) {
  __shared__ float a_s[ROWS][DD];
  __shared__ float x_s[FULL ? ROWS : 1][DD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + warp;
  const bool live = row < n_rows;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if (live) {
    for (int s = 0; s < n_splits; ++s) {
      const float* p = part + ((size_t)s * n_rows + row) * DD;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += p[lane + 32 * e];
    }
  }
  epilogue<FULL>(acc, lbd, row, live, a_s[warp], x_s[FULL ? warp : 0], gi_out, l_out,
                 logdet_out, g_out);
}

template <bool FULL>
int launch(const float* z, const float* c, const float* m, float inv_t2, float lbd,
           float* gi_out, float* l_out, float* logdet_out, float* g_out, float* part,
           int n_rows, int n_centroids, int n_splits, cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  if (n_splits <= 1) {
    metric_bundle_kernel<FULL><<<blocks, THREADS, 0, stream>>>(
        z, c, m, inv_t2, lbd, gi_out, l_out, logdet_out, g_out, n_rows, n_centroids);
    return static_cast<int>(cudaGetLastError());
  }
  // ranges of whole chunks, so only the bank's last chunk is ragged
  const int per_split = ((n_centroids + n_splits - 1) / n_splits + KC - 1) / KC * KC;
  partial_sum_kernel<<<dim3(blocks, n_splits), THREADS, 0, stream>>>(
      z, c, m, inv_t2, part, n_rows, n_centroids, per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_epilogue_kernel<FULL><<<blocks, THREADS, 0, stream>>>(
      part, lbd, gi_out, l_out, logdet_out, g_out, n_rows, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: a workspace of n_splits * n_rows * 256 floats (unused, may be null,
// when n_splits == 1).
extern "C" int metric_bundle_f32(const float* z, const float* c, const float* m, float inv_t2,
                                 float lbd, float* gi_out, float* l_out, float* logdet_out,
                                 float* g_out, float* part, int n_rows, int n_centroids,
                                 int n_splits, cudaStream_t stream) {
  return launch<true>(z, c, m, inv_t2, lbd, gi_out, l_out, logdet_out, g_out, part, n_rows,
                      n_centroids, n_splits, stream);
}

extern "C" int g_inv_f32(const float* z, const float* c, const float* m, float inv_t2,
                         float lbd, float* gi_out, float* part, int n_rows, int n_centroids,
                         int n_splits, cudaStream_t stream) {
  return launch<false>(z, c, m, inv_t2, lbd, gi_out, nullptr, nullptr, nullptr, part, n_rows,
                       n_centroids, n_splits, stream);
}
