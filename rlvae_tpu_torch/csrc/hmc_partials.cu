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
// either resource, so the latency of one warp's dependent K walk and the
// chunk staging bound it.  At large K (>= 20 000) the fp32 FMAs of the two
// weighted sums bound it (1.41 GFLOP at B = 64: 0.021 ms at 67 TFLOP/s).
//
// Design: the front half of csrc/hmc_terms.cu, with no epilogue.  One warp
// per row, ROWS warps per block; K is walked in chunks of 32 centroids staged
// through shared memory, shared by the block's rows.  Lane j computes the
// weight of centroid k0+j from direct differences (padded centroids at 1e6
// give w = 0 exactly) and each weight is broadcast with __shfl_sync.  Lane l
// owns the 8 entries (i, j) = ((l + 32e) / 16, l % 16) of the 16x16 tile,
// e = 0..7: rows i = 2e + l/16 of column j = l % 16.  One conflict-free
// shared-memory read of M_k[i, j] feeds both sums: acc[e] += w M[i,j], and
// vacc += (w (c_k - z)_i) M[i,j] with the weighted difference formed first
// (never sum(w c M) - sum(w z M), which cancels near the centroids).  The two
// half-warps' partial v_j are added with one shuffle; the -2/T^2 scale is
// applied once, after the whole sum.
//
// Large K: with n_splits = 1 one kernel does everything, and a launch has
// only B/ROWS blocks.  With n_splits > 1 (the wrapper's choice when that
// leaves the card's SMs idle and K is large) a grid of (B/ROWS) x n_splits
// blocks each sums one contiguous range of the bank into a [B, 272]
// workspace slot (gi_part, then v unscaled), and a second kernel adds the
// slots in range order (no atomics: reruns are bit-identical).  fp32 IEEE
// arithmetic throughout (expf; no fast math, no TF32).
#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int DD = D * D;
constexpr int WIDTH = DD + D;  // a workspace row: gi_part, then v before its scale
constexpr int KC = 32;    // centroids per staged chunk (one per lane)
constexpr int ROWS = 4;   // rows (warps) per block
constexpr int THREADS = ROWS * 32;
constexpr int E = DD / 32;  // tile entries per lane

// For this warp's row z (zr; zh = z_i of this lane's rows i = 2e + half):
// acc[e] += sum_k w_k M_k[lane + 32e] and vacc += sum_k sum_e w_k (c_k - z)_i
// M_k[i, lane % 16] over k in [k_begin, k_end).  Every thread of the block
// calls it (it stages through shared memory).
__device__ void accumulate(const float* zr, const float* zh, const float* __restrict__ c,
                           const float* __restrict__ m, float inv_t2, int k_begin, int k_end,
                           float* m_s, float* c_s, float* acc, float& vacc) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
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
}

__device__ void load_row(const float* __restrict__ z, int row, bool live, float* zr, float* zh) {
  const int half = (threadIdx.x & 31) >> 4;
#pragma unroll
  for (int i = 0; i < D; ++i) zr[i] = live ? z[row * D + i] : 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) zh[e] = half ? zr[2 * e + 1] : zr[2 * e];
}

// n_splits = 1: the whole bank in one launch.
__global__ void __launch_bounds__(THREADS)
hmc_partials_kernel(const float* __restrict__ z, const float* __restrict__ c,
                    const float* __restrict__ m, float inv_t2, float* __restrict__ gi_out,
                    float* __restrict__ v_out, int n_rows, int n_centroids) {
  __shared__ float m_s[KC * DD];       // 32 KB: the chunk's matrices
  __shared__ float c_s[KC * (D + 1)];  // the chunk's centroids, rows padded against bank conflicts

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const bool live = row < n_rows;
  float zr[D], zh[E], acc[E];
  load_row(z, row, live, zr, zh);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float vacc = 0.f;
  accumulate(zr, zh, c, m, inv_t2, 0, n_centroids, m_s, c_s, acc, vacc);
  // v_j: the two half-warps' partial sums over i
  const float v = vacc + __shfl_xor_sync(0xffffffffu, vacc, 16);
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e) gi_out[(size_t)row * DD + lane + 32 * e] = acc[e];
    if (lane < D) v_out[(size_t)row * D + lane] = v * (-2.f * inv_t2);
  }
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
  float zr[D], zh[E], acc[E];
  load_row(z, row, live, zr, zh);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float vacc = 0.f;
  accumulate(zr, zh, c, m, inv_t2, k_begin, k_end, m_s, c_s, acc, vacc);
  const float v = vacc + __shfl_xor_sync(0xffffffffu, vacc, 16);
  if (live) {
    float* out = part + ((size_t)blockIdx.y * n_rows + row) * WIDTH;
#pragma unroll
    for (int e = 0; e < E; ++e) out[lane + 32 * e] = acc[e];
    if (lane < D) out[DD + lane] = v;
  }
}

// n_splits > 1, pass 2: thread t adds entry t of every slot in range order,
// then scales the v entries.
__global__ void reduce_kernel(const float* __restrict__ part, float inv_t2,
                              float* __restrict__ gi_out, float* __restrict__ v_out,
                              int n_rows, int n_splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows * WIDTH) return;
  float s = 0.f;
  for (int r = 0; r < n_splits; ++r) s += part[(size_t)r * n_rows * WIDTH + t];
  const int row = t / WIDTH, col = t % WIDTH;
  if (col < DD)
    gi_out[(size_t)row * DD + col] = s;
  else
    v_out[(size_t)row * D + col - DD] = s * (-2.f * inv_t2);
}

}  // namespace

// part: a workspace of n_splits * n_rows * 272 floats (unused, may be null,
// when n_splits == 1).
extern "C" int hmc_partials_f32(const float* z, const float* c, const float* m, float inv_t2,
                                float* gi_out, float* v_out, float* part, int n_rows,
                                int n_centroids, int n_splits, cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  if (n_splits <= 1) {
    hmc_partials_kernel<<<blocks, THREADS, 0, stream>>>(z, c, m, inv_t2, gi_out, v_out, n_rows,
                                                        n_centroids);
    return static_cast<int>(cudaGetLastError());
  }
  // ranges of whole chunks, so only the bank's last chunk is ragged
  const int per_split = ((n_centroids + n_splits - 1) / n_splits + KC - 1) / KC * KC;
  partial_sum_kernel<<<dim3(blocks, n_splits), THREADS, 0, stream>>>(
      z, c, m, inv_t2, part, n_rows, n_centroids, per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int REDUCE_THREADS = 256;
  const int reduce_blocks = (n_rows * WIDTH + REDUCE_THREADS - 1) / REDUCE_THREADS;
  reduce_kernel<<<reduce_blocks, REDUCE_THREADS, 0, stream>>>(part, inv_t2, gi_out, v_out,
                                                              n_rows, n_splits);
  return static_cast<int>(cudaGetLastError());
}
