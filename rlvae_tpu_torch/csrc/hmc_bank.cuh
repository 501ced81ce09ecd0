// The K-proportional front half of the kernels that read the metric's
// centroid bank: the manifold-HMC kernels (csrc/hmc_terms.cu, B4;
// csrc/hmc_partials.cu, B8) and the metric kernels (csrc/chol_bundle.cu, B1;
// csrc/metric_bundle.cu, B6 and B7).  For each row z of a group of R rows,
//
//   w_k     = exp(-||z - c_k||^2 / T^2)                  (direct differences)
//   gi_part = sum_k w_k M_k
//   vsum_j  = sum_k sum_i (w_k (c_k - z)_i) M_k[i, j]    (before its -2/T^2; B4, B8 only)
//
// the weighted difference w (c_k - z) formed before it meets M_k, never
// sum(w c M) - sum(w z M), which cancels near the centroids.  bank_sums<DP, R, V>
// takes vsum with V = true (B4, B8) and drops it with V = false (B1, B6, B7:
// half the FMAs a row and centroid, and a row's sums [DD] instead of [DD + DP]).
//
// Latent widths.  Every kernel takes any real width 1 <= d <= 32 (Params::dim)
// at one of two compiled widths DP: 16 for d <= 16, 32 for 17..32.  The bank
// it reads is DP wide (c [K, DP], M [K, DP, DP]), zero-padded in its trailing
// indices by the caller once per bank (rlvae_tpu_torch.ops.metric_kernels.
// padded_bank); z is read at its real width and padded with zeros on the way
// into shared memory.  The padding is exact for the real block: d^2 and every
// weighted sum only gain exact zeros, the real block of G^{-1} is unchanged
// and its pad block is the identity (the epilogues add 1 there, not diag), so
// a Cholesky, whose pad indices come last, does the same operations on the
// real block, the log-det sums log 1 = 0 for each pad index, and no pad entry
// is stored.  At d = DP the kernels are those of a single width.
//
// The bank is split three ways.
//
// 1. Across the CTAs of a thread-block cluster (C <= 8, the portable size):
//    CTA `rank` sums one contiguous range of the bank's chunks.  The CTAs'
//    sums are added through distributed shared memory by the leader (rank 0)
//    in rank order, between two cluster barriers; the leader then runs the
//    kernel's epilogue.  C = 1 for small banks: one CTA, no cluster traffic.
// 2. Across the W warps of a CTA: warp w sums one contiguous range of the
//    CTA's chunks for all R rows; the warps' sums are added in warp order
//    through shared memory.
// 3. Inside a warp, register blocking of the R rows: lane l owns NQ = DD / 128
//    float4s of each DP x DP matrix, l + 32q for q < NQ (DP = 16: rows l/4 and
//    8 + l/4; DP = 32: rows l/8 + 4q; columns 4(l % (DP/4))..+3), so NQ
//    conflict-free 16-byte shared loads of M_k feed the 4 NQ FMAs of every
//    row (and 4 NQ more for vsum); a row's weighted differences w_r (c_k -
//    z_r)_i are formed once per centroid and lane.  The lanes that share a
//    column add their vsum partials with shuffles once, after the walk.
//
// Staging: each warp walks its range in chunks of KC centroids (DP = 16: 4,
// 4352 bytes; DP = 32: 2, 8448 bytes: matrices, then centroids), with STAGES
// = 3 buffers of its own, each filled by two bulk copies (cp.async.bulk) that
// complete on the buffer's mbarrier; lane 0 issues the next chunk into a buffer
// as soon as the warp has read it.  No __syncthreads inside the walk.  A
// chunk's R x KC weights are computed one per lane (d^2 as direct differences,
// expf) into a small shared table that the FMA loop reads as float4s.
// Centroids past the bank's end are not copied and get no weight; padded
// centroids at 1e6 give w = 0 exactly and add exact zeros.
//
// Ranges are whole chunks and depend only on the number of chunks, C and W,
// so a relaunch is bit-identical, and a bank padded within its last chunk
// (37 -> 40) sums in the same order as the unpadded one.  No atomics.  fp32
// IEEE arithmetic throughout (expf; no fast math, no TF32).
//
// The geometry (hmc_geometry below, mirrored by
// rlvae_tpu_torch.ops.metric_kernels.hmc_geometry), measured with
// rlvae_tpu_torch.ops.hmc_sweep: chunks = ceil(K / KC); C_max = min(8,
// chunks / MIN_CTA_CHUNKS), at least 1, so a CTA sums at least 32 chunks
// and small banks take one CTA; the rows per CTA R is the smallest of 1, 2,
// 4, 8 (DP = 32: up to 4) whose ceil(B / R) clusters of C_max CTAs fit within
// the SMs (the largest if none does); W = min(max_warps(R, kernel, DP),
// max(R, ceil(chunks / C_max))), so the epilogue has a warp per row; the
// cluster size C is the largest C <= C_max whose ceil(B / R) clusters the card
// holds at once (cudaOccupancyMaxActiveClusters of the kernel launched), else
// 1.  A second wave of clusters costs a whole CTA's time: at B = 64, K = 20 000
// the H100 holds 15 clusters of 8 such CTAs, so 16 row groups take clusters of
// 6 (17 fit).  The rule has one argument for the kernel (BankKernel) and
// one for the width DP: the kernels without vsum hold fewer
// registers, so their DP = 16 CTAs may have 16 warps at any R, and each
// kernel's cluster slots are its own.  B7 launches at B6's geometry, so the
// two sum G^{-1} in the same order and give the same bits.
//
// DP = 32: a row's sums are 4x those of DP = 16 (32 gi_part floats a lane
// and row), so R stops at 4 and a CTA at 8 warps (255 registers a thread at
// 256 threads), and the chunk is halved so that 8 warps' 3 stages fit in
// shared memory (200 KB); the epilogues give each lane one row of the 32 x 32
// tile (no mirror lanes) with a 32 x 33 scratch.
//
// Built with -DHMC_PROFILE (rlvae_tpu_torch.ops.hmc_sweep's library), thread 0
// of CTA 0 sums clock64 laps per phase (HMC_PHASES); otherwise the laps compile
// to nothing.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace hmc {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int MAX_DIM = 32;    // the widest real width; DP is 16 or 32
constexpr int STAGES = 3;      // a warp's chunk buffers
constexpr int MAX_ROWS = 8;    // over both widths (DP = 32: Layout<32>::MAX_ROWS)
constexpr int MAX_WARPS = 16;  // over both widths (DP = 32: 8)
constexpr int MAX_CTAS = 8;    // the portable cluster size
constexpr int MIN_CTA_CHUNKS = 32;
constexpr int BAR_BYTES = 512;  // mbarriers (MAX_WARPS x STAGES) at the start of shared memory

// The compiled widths' constants: centroids per staged chunk and the most
// rows per CTA.
template <int DP>
struct Layout;
template <>
struct Layout<16> {
  static constexpr int KC = 4, MAX_ROWS = 8;
};
template <>
struct Layout<32> {
  static constexpr int KC = 2, MAX_ROWS = 4;
};

// The compiled width of a real width d (1 <= d <= 32).
__host__ __device__ constexpr int padded_dim(int d) { return d <= 16 ? 16 : 32; }

template <int DP>
struct Bank {
  static constexpr int DD = DP * DP;
  static constexpr int KC = Layout<DP>::KC;
  static constexpr int ROWS = Layout<DP>::MAX_ROWS;
  static constexpr int CHUNK_FLOATS = KC * DD + KC * DP;  // matrices, then centroids
  static constexpr int LPR = DP / 4;      // lanes that share a row of a matrix
  static constexpr int ROW_STEP = 32 / LPR;  // rows between a lane's float4s
  static constexpr int NQ = DD / 128;     // float4s of a matrix a lane holds
  static constexpr int CPL = DD / 32;     // columns of a row a lane holds in the epilogues
  // a warp's staging buffers hold, after the walk, its partial (warp 0: the
  // CTA's sums) and the epilogue's DP x (DP + 1) scratch at their end
  static_assert(ROWS * (DD + DP) + DP * (DP + 1) <= STAGES * CHUNK_FLOATS, "staging too small");
};

// The profile's phases (-DHMC_PROFILE), laps of thread 0 of CTA 0: set-up, the
// waits for staged chunks, the weights, the weighted sums, the warp's column
// sums and its partial's store, the CTA's warp-order sum, the cluster's
// rank-order sum, the epilogue's factorization (B4, B1, B6), B6's inverse X =
// L^{-1} and its G = X^T X, and the rest of the epilogue (B4: log-det,
// solves, stores; B8, B7: stores; B1, B6: log-det, stores), then the whole
// kernel.
constexpr int HMC_PHASES = 12;
enum Phase { SETUP, STAGE_WAIT, WEIGHTS, SUMS, WARP_REDUCE, CTA_REDUCE, CLUSTER_REDUCE, CHOLESKY,
             INVERSE, GRAM, FINISH };

// The kernels of this front half, as the geometry rule tells them apart: B4
// and B8 (with vsum), B1, and B6 with B7 (B7 launches at B6's geometry).
enum BankKernel { HMC = 0, CHOL_BUNDLE = 1, METRIC_BUNDLE = 2 };
constexpr int BANK_KERNELS = 3;

struct Geometry {
  int rows, warps, ctas, clusters;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The most warps a CTA of R rows of `kernel` at width DP may have: DP = 16:
// 16, or 8 for B4 and B8 at R = 8, whose ~190 registers a thread allow 256
// threads (the kernels without vsum hold at most 128 at R = 8); DP = 32: 8
// (shared memory: 3 stages of 8448 bytes a warp; registers).
__host__ __device__ constexpr int max_warps(int rows, int kernel, int dp = 16) {
  return dp == 32 ? 8 : (kernel == HMC && rows > 4 ? 8 : 16);
}

// A row's sums: gi_part, then vsum when V.
__host__ __device__ constexpr int width(bool v, int dp) { return v ? dp * dp + dp : dp * dp; }

// The most rows per CTA and centroids per chunk at width dp (16 or 32).
__host__ __device__ constexpr int rule_rows(int dp) {
  return dp == 32 ? Layout<32>::MAX_ROWS : Layout<16>::MAX_ROWS;
}
__host__ __device__ constexpr int rule_chunk(int dp) {
  return dp == 32 ? Layout<32>::KC : Layout<16>::KC;
}

// True when dp is a compiled width.
__host__ __device__ constexpr bool valid_dp(int dp) { return dp == 16 || dp == 32; }

}  // namespace hmc

// How many clusters of (rows, warps, ctas) of `kernel` (a BankKernel) at
// width dp the card holds at once, in out[0] (csrc/hmc_terms.cu;
// cudaOccupancyMaxActiveClusters of B4's, B1's or B6's kernel of that many
// rows and that width).  Each kernel's own count comes from its file.
extern "C" int hmc_cluster_slots(int rows, int warps, int ctas, int kernel, int dp, int* out);
extern "C" int chol_bundle_cluster_slots(int rows, int warps, int ctas, int dp, int* out);
extern "C" int metric_bundle_cluster_slots(int rows, int warps, int ctas, int dp, int* out);

namespace hmc {

// hmc_cluster_slots, cached per (device, width, kernel, rows, warps, ctas).
inline cudaError_t cached_slots(int rows, int warps, int ctas, int kernel, int dp, int* out) {
  constexpr int DEVICES = 16;
  static std::mutex mu;
  static int table[DEVICES][2][BANK_KERNELS][MAX_ROWS + 1][MAX_WARPS + 1][MAX_CTAS + 1];
  static bool filled[DEVICES][2][BANK_KERNELS][MAX_ROWS + 1][MAX_WARPS + 1][MAX_CTAS + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= DEVICES || kernel < 0 || kernel >= BANK_KERNELS || !valid_dp(dp) ||
      rows > MAX_ROWS || warps > MAX_WARPS || ctas > MAX_CTAS)
    return static_cast<cudaError_t>(hmc_cluster_slots(rows, warps, ctas, kernel, dp, out));
  std::lock_guard<std::mutex> lock(mu);
  const int wide = dp == 32;
  int& slot = table[dev][wide][kernel][rows][warps][ctas];
  bool& done = filled[dev][wide][kernel][rows][warps][ctas];
  if (!done) {
    err = static_cast<cudaError_t>(hmc_cluster_slots(rows, warps, ctas, kernel, dp, &slot));
    if (err != cudaSuccess) return err;
    done = true;
  }
  *out = slot;
  return cudaSuccess;
}

// The rule (see the top of this file), for B rows and K centroids of
// `kernel` (a BankKernel) at width dp (16 or 32) on the current card of
// `sms` SMs.
inline cudaError_t hmc_geometry(int b, int k, int sms, int kernel, int dp, Geometry* g) {
  const int chunks = ceil_div(k, rule_chunk(dp));
  const int c_max = std::max(1, std::min(MAX_CTAS, chunks / MIN_CTA_CHUNKS));
  int rows = 1;
  while (rows < rule_rows(dp) && ceil_div(b, rows) * c_max > sms) rows *= 2;
  const int clusters = ceil_div(b, rows);
  const int warps =
      std::min(max_warps(rows, kernel, dp), std::max(rows, ceil_div(chunks, c_max)));
  int ctas = c_max;
  for (; ctas > 1; --ctas) {
    int slots = 0;
    const cudaError_t err = cached_slots(rows, warps, ctas, kernel, dp, &slots);
    if (err != cudaSuccess) return err;
    if (clusters <= slots) break;
  }
  *g = Geometry{rows, warps, ctas, clusters};
  return cudaSuccess;
}

template <int DP>
inline bool valid_geometry(const Geometry& g, int kernel) {
  const bool pow2_rows = g.rows == 1 || g.rows == 2 || g.rows == 4 || g.rows == 8;
  return pow2_rows && g.rows <= Bank<DP>::ROWS && g.warps >= 1 &&
         g.warps <= max_warps(g.rows, kernel, DP) && g.ctas >= 1 && g.ctas <= MAX_CTAS &&
         g.clusters >= 1;
}

// Dynamic shared memory of a CTA: the mbarriers, z of the R rows, the weight
// tables (KC x R a warp), then STAGES chunk buffers a warp (reused for the
// warps' partial sums after the walk).
template <int DP>
__host__ __device__ inline int smem_bytes(int warps) {
  using B = Bank<DP>;
  return BAR_BYTES + B::ROWS * DP * 4 + MAX_WARPS * B::KC * B::ROWS * 4 +
         warps * STAGES * B::CHUNK_FLOATS * 4;
}

struct Params {
  const float* z;  // [B, dim]
  const float* c;  // [K, DP], zero past dim
  const float* m;  // [K, DP, DP], zero past dim
  float inv_t2, lbd, log_eps;
  float* out0;  // B4: log pi [B]; B8: gi_part [B, d, d]; B1: L; B6, B7: G^{-1}
  float* out1;  // B4: grad [B, d]; B8: v [B, d]; B1: logdet [B]; B6: L
  int n_rows, n_centroids;
  long long* prof;  // -DHMC_PROFILE: null, or HMC_PHASES clock64 sums (PhaseClock)
  float* out2;      // B6: logdet [B]
  float* out3;      // B6: G [B, d, d]
  int dim;          // the real width d <= DP; every output is d wide
};

template <int DP>
struct Smem {
  uint64_t* bars;  // [warps][STAGES]
  float* zs;       // [R][DP]
  float* ws;       // [warps][KC][R]
  float* stage;    // [warps][STAGES][CHUNK_FLOATS]
};

template <int DP>
__device__ __forceinline__ Smem<DP> carve(unsigned char* base) {
  using B = Bank<DP>;
  Smem<DP> s;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.zs = reinterpret_cast<float*>(base + BAR_BYTES);
  s.ws = s.zs + B::ROWS * DP;
  s.stage = s.ws + MAX_WARPS * B::KC * B::ROWS;
  return s;
}

// DP x (DP + 1) floats of the calling warp's own shared memory, for after the
// walk: the end of its staging buffers (warp 0's partial, which holds the
// CTA's sums, is at their start and takes at most ROWS x (DD + DP) floats).
template <int DP>
__device__ __forceinline__ float* warp_scratch(unsigned char* smem) {
  return carve<DP>(smem).stage +
         (size_t)((threadIdx.x >> 5) + 1) * STAGES * Bank<DP>::CHUNK_FLOATS - DP * (DP + 1);
}

// Chunk `ch` of the bank into buffer `buf`, completing on `bar` (lane 0).
template <int DP>
__device__ __forceinline__ void issue_chunk(const Params& p, int ch, float* buf, uint64_t* bar) {
  using B = Bank<DP>;
  const int k0 = ch * B::KC;
  const int nk = min(B::KC, p.n_centroids - k0);
  mbar_arrive_expect_tx(bar, (uint32_t)(nk * (B::DD + DP) * 4));
  bulk_g2s(buf, p.m + (size_t)k0 * B::DD, (uint32_t)(nk * B::DD * 4), bar);
  bulk_g2s(buf + B::KC * B::DD, p.c + (size_t)k0 * DP, (uint32_t)(nk * DP * 4), bar);
}

template <int R>
__device__ __forceinline__ void load_weights(const float* w, float (&out)[R]) {
  if constexpr (R == 1) {
    out[0] = w[0];
  } else if constexpr (R == 2) {
    const float2 a = *reinterpret_cast<const float2*>(w);
    out[0] = a.x;
    out[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(w + 4 * q);
      out[4 * q] = a.x;
      out[4 * q + 1] = a.y;
      out[4 * q + 2] = a.z;
      out[4 * q + 3] = a.w;
    }
  }
}

// One centroid's contribution to the R rows' sums held by this lane (vsum's
// only with V): for each of the lane's NQ float4s of M_k, in q order.
template <int DP, int R, bool V>
__device__ __forceinline__ void add_centroid(const float* mk, const float* ck, const float* wk,
                                             const float (&zr)[R][Bank<DP>::NQ],
                                             float (&g)[R][4 * Bank<DP>::NQ],
                                             float (&vv)[R][4]) {
  using B = Bank<DP>;
  const int lane = threadIdx.x & 31;
  float w[R];
  load_weights<R>(wk, w);
#pragma unroll
  for (int q = 0; q < B::NQ; ++q) {
    const float4 mq = *reinterpret_cast<const float4*>(mk + 4 * lane + 128 * q);
    const float cq = V ? ck[lane / B::LPR + B::ROW_STEP * q] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g[r][4 * q] = fmaf(w[r], mq.x, g[r][4 * q]);
      g[r][4 * q + 1] = fmaf(w[r], mq.y, g[r][4 * q + 1]);
      g[r][4 * q + 2] = fmaf(w[r], mq.z, g[r][4 * q + 2]);
      g[r][4 * q + 3] = fmaf(w[r], mq.w, g[r][4 * q + 3]);
      if constexpr (V) {
        const float wd = w[r] * (cq - zr[r][q]);
        vv[r][0] = fmaf(wd, mq.x, vv[r][0]);
        vv[r][1] = fmaf(wd, mq.y, vv[r][1]);
        vv[r][2] = fmaf(wd, mq.z, vv[r][2]);
        vv[r][3] = fmaf(wd, mq.w, vv[r][3]);
      }
    }
  }
}

// The bank's sums for the CTA's R rows [row0, row0 + R).  Every thread of
// every CTA of the cluster calls it.  Returns, in the leader CTA, the
// cluster's sums in shared memory ([R][width(V, DP)]: gi_part, then with V
// vsum unscaled), after a barrier that makes them visible to every thread of
// the CTA; nullptr in the other CTAs, which may then exit.
template <int DP, int R, bool V>
__device__ float* bank_sums(const Params& p, unsigned char* smem, PhaseClock<HMC_PHASES>& clk) {
  using B = Bank<DP>;
  constexpr int W = width(V, DP);
  constexpr int KC = B::KC, NQ = B::NQ, CH = B::CHUNK_FLOATS;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / ctas) * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Smem<DP> s = carve<DP>(smem);

  for (int idx = threadIdx.x; idx < R * DP; idx += blockDim.x) {
    const int row = row0 + idx / DP, col = idx % DP;
    s.zs[idx] = row < p.n_rows && col < p.dim ? p.z[(size_t)row * p.dim + col] : 0.f;
  }
  uint64_t* bars = s.bars + warp * STAGES;
  if (lane == 0) {
    for (int b = 0; b < STAGES; ++b) mbar_init(&bars[b], 1);
    mbar_fence_init();
  }
  __syncthreads();  // z staged, mbarriers initialized

  // this CTA's and this warp's ranges of chunks
  const int chunks = ceil_div(p.n_centroids, KC);
  const int per_cta = ceil_div(chunks, ctas);
  const int cta_begin = min(rank * per_cta, chunks);
  const int cta_end = min(cta_begin + per_cta, chunks);
  const int per_warp = ceil_div(cta_end - cta_begin, warps);
  const int begin = min(cta_begin + warp * per_warp, cta_end);
  const int n = min(begin + per_warp, cta_end) - begin;

  float* stage = s.stage + (size_t)warp * STAGES * CH;
  float* ws = s.ws + warp * KC * R;
  if (lane == 0)
    for (int t = 0; t < min(STAGES, n); ++t)
      issue_chunk<DP>(p, begin + t, stage + t * CH, &bars[t]);

  float zr[R][NQ];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      zr[r][q] = V ? s.zs[r * DP + lane / B::LPR + B::ROW_STEP * q] : 0.f;
  }
  float g[R][4 * NQ], vv[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 4 * NQ; ++e) g[r][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) vv[r][e] = 0.f;
  }
  clk.lap(SETUP);

  for (int t = 0; t < n; ++t) {
    const int b = t % STAGES;
    float* buf = stage + b * CH;
    const float* cs = buf + KC * B::DD;
    const int nk = min(KC, p.n_centroids - (begin + t) * KC);
    mbar_wait(&bars[b], (uint32_t)(t / STAGES) & 1u);
    clk.lap(STAGE_WAIT);

    // the chunk's weights, one (row, centroid) a lane, into ws[j][r]
    for (int idx = lane; idx < R * KC; idx += 32) {
      const int r = idx / KC, j = idx % KC;
      float w = 0.f;
      if (j < nk && row0 + r < p.n_rows) {
        // d^2 in four partial sums (coordinates i = 4q + e in sum e), a
        // quarter of the dependent chain of one running sum
        float d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < DP / 4; ++q) {
          const float4 cq = *reinterpret_cast<const float4*>(cs + j * DP + 4 * q);
          const float4 zq = *reinterpret_cast<const float4*>(s.zs + r * DP + 4 * q);
          d2[0] = fmaf(zq.x - cq.x, zq.x - cq.x, d2[0]);
          d2[1] = fmaf(zq.y - cq.y, zq.y - cq.y, d2[1]);
          d2[2] = fmaf(zq.z - cq.z, zq.z - cq.z, d2[2]);
          d2[3] = fmaf(zq.w - cq.w, zq.w - cq.w, d2[3]);
        }
        w = expf(-((d2[0] + d2[1]) + (d2[2] + d2[3])) * p.inv_t2);
      }
      ws[j * R + r] = w;
    }
    __syncwarp();
    clk.lap(WEIGHTS);

    if (nk == KC) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        add_centroid<DP, R, V>(buf + j * B::DD, cs + j * DP, ws + j * R, zr, g, vv);
    } else {
      for (int j = 0; j < nk; ++j)
        add_centroid<DP, R, V>(buf + j * B::DD, cs + j * DP, ws + j * R, zr, g, vv);
    }
    __syncwarp();  // the buffer and the weight table are read
    if (lane == 0 && t + STAGES < n) {
      fence_proxy_async();
      issue_chunk<DP>(p, begin + t + STAGES, buf, &bars[b]);
    }
    clk.lap(SUMS);
  }

  // the warp's partial, [R][W], into its own (drained) buffers: with V, the
  // lanes that share columns 4(l % LPR)..+3 add their vsum partials first
  float* part = stage;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* pr = part + r * W;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      *reinterpret_cast<float4*>(pr + 4 * lane + 128 * q) =
          make_float4(g[r][4 * q], g[r][4 * q + 1], g[r][4 * q + 2], g[r][4 * q + 3]);
    if constexpr (V) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int off = B::LPR; off < 32; off <<= 1)
          vv[r][e] += __shfl_xor_sync(0xffffffffu, vv[r][e], off);
      }
      if (lane < B::LPR)
        *reinterpret_cast<float4*>(pr + B::DD + 4 * lane) =
            make_float4(vv[r][0], vv[r][1], vv[r][2], vv[r][3]);
    }
  }
  __syncthreads();
  clk.lap(WARP_REDUCE);

  // the CTA's sum, in warp order, into warp 0's partial
  float* sum = s.stage;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
    float acc = sum[idx];
    for (int w = 1; w < warps; ++w) acc += s.stage[(size_t)w * STAGES * CH + idx];
    sum[idx] = acc;
  }
  clk.lap(CTA_REDUCE);

  if (ctas == 1) {
    __syncthreads();
    clk.lap(CLUSTER_REDUCE);
    return sum;
  }
  // the cluster's sum, in rank order, by the leader through distributed shared
  // memory; the second barrier keeps every peer's shared memory alive until
  // the leader has read it
  cluster.sync();
  if (rank == 0) {
    for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
      float acc = sum[idx];
      for (int q = 1; q < ctas; ++q) acc += cluster.map_shared_rank(sum, q)[idx];
      sum[idx] = acc;
    }
  }
  cluster.sync();
  clk.lap(CLUSTER_REDUCE);
  return rank == 0 ? sum : nullptr;
}

// ---------------------------------------------------------------------------
// The epilogues' shared parts: the register Cholesky of B4, B1 and B6, the
// log-det, and a row of L
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

// Element c = CPL h + e of a lane's row (a of DP floats) with e known at
// compile time: DP = 16 splits a row over a lane and its mirror (h = 0, 1),
// DP = 32 gives a lane its whole row (h = 0).
template <int DP>
__device__ __forceinline__ float row_entry(const float (&a)[DP], int h, int e) {
  if constexpr (DP == 16) {
    return h ? a[8 + e] : a[e];
  } else {
    return a[e];
  }
}

// The Cholesky factor of one row's G^{-1} = sums + diag*I (sums i-major [DD],
// without the diagonal term; the pad indices j >= dim take 1, not diag), in
// the calling warp's registers: lane j (DP = 16: and its mirror j + 16) ends
// with row j of L in a[0..j] (a[m] for m > j keeps G^{-1}[j, m] and is not
// part of L), L[j, j] in ljj and 1 / L[j, j] in inv_ljj.  Right-looking, one
// rank-1 update per column: DP dependent steps of a shuffle, a sqrt beside a
// reciprocal sqrt (both correctly rounded, so no division sits on the chain
// from one column to the next), a product, a shuffle of the column and one
// FMA (the left-looking form's last lane takes ~120 dependent steps at 16).
template <int DP>
__device__ __forceinline__ void cholesky_row(const float* sums, float diag, int dim,
                                             float (&a)[DP], float& ljj, float& inv_ljj) {
  const int j = threadIdx.x & (DP - 1);  // this lane's row of the tile
  const float dj = j < dim ? diag : 1.f;
#pragma unroll
  for (int m = 0; m < DP; ++m) a[m] = sums[j * DP + m] + (m == j ? dj : 0.f);
  ljj = 0.f;
  inv_ljj = 0.f;
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    const float akk = __shfl_sync(FULL, a[k], k);
    const float lkk = sqrtf(akk);
    const float inv = __frsqrt_rn(akk);
    if (j > k) a[k] *= inv;
    if (j == k) {
      a[k] = ljj = lkk;
      inv_ljj = inv;
    }
#pragma unroll
    for (int m = k + 1; m < DP; ++m) {
      const float lmk = __shfl_sync(FULL, a[k], m);
      if (j >= m) a[m] = fmaf(-a[k], lmk, a[m]);  // G^{-1}[j, m] -= L[j, k] L[m, k]
    }
  }
}

// sum_i log L_ii from each lane's L[j, j], by a DP-lane shuffle tree of logf
// (every lane gets the sum; a pad index adds log 1 = 0).
template <int DP>
__device__ __forceinline__ float sum_log_diag(float ljj) {
  float s = logf(ljj);
#pragma unroll
  for (int off = DP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// Row j of L (a from cholesky_row) into out (the row's [dim, dim] tile), with
// exact zeros above the diagonal.  At dim = DP (out 16-byte aligned): DP =
// 16: lane j writes its columns 0..7 and lane j + 16 columns 8..15, two
// float4 stores each; DP = 32: lane j its 32 columns, 8 float4 stores.  Below
// DP, each real lane stores its real columns one by one.
template <int DP>
__device__ __forceinline__ void store_lower_row(const float (&a)[DP], float* out, int dim) {
  constexpr int CPL = Bank<DP>::CPL;
  const int lane = threadIdx.x & 31, j = lane & (DP - 1), h = lane / DP;
  float v[CPL];
#pragma unroll
  for (int e = 0; e < CPL; ++e) v[e] = CPL * h + e <= j ? row_entry<DP>(a, h, e) : 0.f;
  if (dim == DP) {
    float4* dst = reinterpret_cast<float4*>(out + j * DP + CPL * h);
#pragma unroll
    for (int q = 0; q < CPL / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if (j < dim) {
#pragma unroll
    for (int e = 0; e < CPL; ++e)
      if (CPL * h + e < dim) out[j * dim + CPL * h + e] = v[e];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The SM count of the current device.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Sets `kernel`'s shared-memory opt-in (its width's most warps), once per
// (device, kernel).
template <int DP>
inline cudaError_t opt_in_smem(void (*kernel)(Params)) {
  static std::mutex mu;
  static const void* done[64];
  static int done_dev[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i] == reinterpret_cast<const void*>(kernel) && done_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<DP>(max_warps(1, CHOL_BUNDLE, DP)));
  if (err != cudaSuccess) return err;
  if (n_done < 64) {
    done[n_done] = reinterpret_cast<const void*>(kernel);
    done_dev[n_done++] = dev;
  }
  return cudaSuccess;
}

// The launch of geometry g: g.clusters clusters of g.ctas CTAs of g.warps
// warps; `attr` holds the cluster dimension.
template <int DP>
inline cudaLaunchConfig_t launch_config(const Geometry& g, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.clusters * g.ctas);
  cfg.blockDim = dim3(g.warps * 32);
  cfg.dynamicSmemBytes = smem_bytes<DP>(g.warps);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `fn`, a kernel of `kernel` (a BankKernel) at width DP, at geometry
// g on `stream`.  Neither synchronises nor allocates.
template <int DP>
inline cudaError_t launch(void (*fn)(Params), const Params& params, const Geometry& g, int kernel,
                          cudaStream_t stream) {
  if (!valid_geometry<DP>(g, kernel)) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem<DP>(fn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<DP>(g, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fn, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of geometry g of `fn` (a kernel of `kernel` at width DP)
// the card holds at once.
template <int DP>
inline cudaError_t cluster_slots(void (*fn)(Params), Geometry g, int kernel, int* out) {
  if (!valid_geometry<DP>(g, kernel)) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem<DP>(fn);
  if (err != cudaSuccess) return err;
  g.clusters = 1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<DP>(g, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// The launchers' switch over the rows per CTA, inside a function template on
// DP: returns EXPR_OF_R with R_ the rows as a constant (DP = 32 has no R = 8
// instance).
#define HMC_BANK_DISPATCH(DP, ROWS_OF_G, EXPR_OF_R)                         \
  switch (ROWS_OF_G) {                                                     \
    case 1: { constexpr int R_ = 1; return EXPR_OF_R; }                    \
    case 2: { constexpr int R_ = 2; return EXPR_OF_R; }                    \
    case 4: { constexpr int R_ = 4; return EXPR_OF_R; }                    \
    case 8: if constexpr (Bank<DP>::ROWS >= 8) { constexpr int R_ = 8; return EXPR_OF_R; } \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

// The rule's geometry for (B, K) of `kernel` (a BankKernel) at width DP on
// the current card.
template <int DP>
inline cudaError_t rule_geometry(int n_rows, int n_centroids, int kernel, Geometry* g) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  return hmc_geometry(n_rows, n_centroids, sms, kernel, DP, g);
}

// True when the real width d can be taken (1 <= d <= 32).
inline bool valid_dim(int dim) { return dim >= 1 && dim <= MAX_DIM; }

}  // namespace hmc
