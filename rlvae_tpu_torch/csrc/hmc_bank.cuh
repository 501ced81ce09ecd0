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
// sum(w c M) - sum(w z M), which cancels near the centroids.  bank_sums<R, V>
// takes vsum with V = true (B4, B8) and drops it with V = false (B1, B6, B7:
// 8 FMAs a row and centroid in each lane instead of 16, and a row's sums
// [DD] instead of [DD + D]).
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
// 3. Inside a warp, register blocking of the R rows: lane l owns the float4s
//    l and l + 32 of each 16x16 matrix (rows i0 = l/4 and i1 = 8 + l/4,
//    columns 4(l%4)..+3), so one pair of conflict-free 16-byte shared loads
//    of M_k feeds the 16 FMAs of every row (8 for gi_part, 8 for vsum); the
//    two weighted differences w_r (c_k - z_r)_i of a row are formed once per
//    centroid and lane.  The lanes that share a column add their vsum
//    partials with three shuffles once, after the walk.
//
// Staging: each warp walks its range in chunks of KC = 4 centroids (4 KB of
// matrices, 256 B of centroids), with STAGES = 3 buffers of its own, each
// filled by two bulk copies (cp.async.bulk) that complete on the buffer's
// mbarrier; lane 0 issues the next chunk into a buffer as soon as the warp has
// read it.  No __syncthreads inside the walk.  A chunk's R x 4 weights are
// computed one per lane (d^2 as direct differences, expf) into a small shared
// table that the FMA loop reads as float4s.  Centroids past the bank's end
// are not copied and get no weight; padded centroids at 1e6 give w = 0
// exactly and add exact zeros.
//
// Ranges are whole chunks and depend only on the number of chunks, C and W,
// so a relaunch is bit-identical, and a bank padded within its last chunk
// (37 -> 40) sums in the same order as the unpadded one.  No atomics.  fp32
// IEEE arithmetic throughout (expf; no fast math, no TF32).
//
// The geometry (hmc_geometry below, mirrored by
// rlvae_tpu_torch.ops.metric_kernels.hmc_geometry), measured with
// rlvae_tpu_torch.ops.hmc_sweep: chunks = ceil(K / 4); C_max = min(8,
// chunks / MIN_CTA_CHUNKS), at least 1, so a CTA sums at least 128 centroids
// and small banks take one CTA; the rows per CTA R is the smallest of 1, 2,
// 4, 8 whose ceil(B / R) clusters of C_max CTAs fit within the SMs (8 if none
// does); W = min(max_warps(R, kernel), max(R, ceil(chunks / C_max))), so the
// epilogue has a warp per row; the cluster size C is the largest C <= C_max
// whose ceil(B / R) clusters the card holds at once (cudaOccupancyMaxActive-
// Clusters of the kernel launched), else 1.  A second wave of clusters costs
// a whole CTA's time: at B = 64, K = 20 000 the H100 holds 15 clusters of 8
// such CTAs, so 16 row groups take clusters of 6 (17 fit).  The rule has one
// argument for the kernel (BankKernel): the kernels without vsum hold fewer
// registers, so their CTAs may have 16 warps at any R, and each kernel's
// cluster slots are its own.  B7 launches at B6's geometry, so the two sum
// G^{-1} in the same order and give the same bits.
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

constexpr int D = 16;
constexpr int DD = D * D;
constexpr int WIDTH = DD + D;  // a row's sums with vsum: gi_part (i-major), then vsum
constexpr int KC = 4;          // centroids per staged chunk
constexpr int STAGES = 3;      // a warp's chunk buffers
constexpr int CHUNK_FLOATS = KC * DD + KC * D;  // 4352 bytes: matrices, then centroids
constexpr int MAX_ROWS = 8;
constexpr int MAX_WARPS = 16;  // B4 and B8: 8 at R = 8 (registers: max_warps)
constexpr int MAX_CTAS = 8;    // the portable cluster size
constexpr int MIN_CTA_CHUNKS = 32;
constexpr int BAR_BYTES = 512;  // mbarriers (MAX_WARPS x STAGES) at the start of shared memory
// a warp's staging buffers hold, after the walk, its partial (warp 0: the
// CTA's sums) and the epilogue's 16 x 17 scratch at their end
static_assert(MAX_ROWS * WIDTH + D * (D + 1) <= STAGES * CHUNK_FLOATS, "staging too small");

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

// The most warps a CTA of R rows of `kernel` may have: 16, or 8 for B4 and
// B8 at R = 8, whose ~190 registers a thread allow 256 threads (the kernels
// without vsum hold at most 128 at R = 8).
__host__ __device__ constexpr int max_warps(int rows, int kernel) {
  return kernel == HMC && rows > 4 ? 8 : 16;
}

// A row's sums: gi_part, then vsum when V.
__host__ __device__ constexpr int width(bool v) { return v ? DD + D : DD; }

}  // namespace hmc

// How many clusters of (rows, warps, ctas) of `kernel` (a BankKernel) the
// card holds at once, in out[0] (csrc/hmc_terms.cu; cudaOccupancyMaxActive-
// Clusters of B4's, B1's or B6's kernel of that many rows).  Each kernel's
// own count comes from its file.
extern "C" int hmc_cluster_slots(int rows, int warps, int ctas, int kernel, int* out);
extern "C" int chol_bundle_cluster_slots(int rows, int warps, int ctas, int* out);
extern "C" int metric_bundle_cluster_slots(int rows, int warps, int ctas, int* out);

namespace hmc {

// hmc_cluster_slots, cached per (device, kernel, rows, warps, ctas).
inline cudaError_t cached_slots(int rows, int warps, int ctas, int kernel, int* out) {
  constexpr int DEVICES = 16;
  static std::mutex mu;
  static int table[DEVICES][BANK_KERNELS][MAX_ROWS + 1][MAX_WARPS + 1][MAX_CTAS + 1];
  static bool filled[DEVICES][BANK_KERNELS][MAX_ROWS + 1][MAX_WARPS + 1][MAX_CTAS + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= DEVICES || kernel < 0 || kernel >= BANK_KERNELS || rows > MAX_ROWS ||
      warps > MAX_WARPS || ctas > MAX_CTAS)
    return static_cast<cudaError_t>(hmc_cluster_slots(rows, warps, ctas, kernel, out));
  std::lock_guard<std::mutex> lock(mu);
  int& slot = table[dev][kernel][rows][warps][ctas];
  bool& done = filled[dev][kernel][rows][warps][ctas];
  if (!done) {
    err = static_cast<cudaError_t>(hmc_cluster_slots(rows, warps, ctas, kernel, &slot));
    if (err != cudaSuccess) return err;
    done = true;
  }
  *out = slot;
  return cudaSuccess;
}

// The rule (see the top of this file), for B rows and K centroids of
// `kernel` (a BankKernel) on the current card of `sms` SMs.
inline cudaError_t hmc_geometry(int b, int k, int sms, int kernel, Geometry* g) {
  const int chunks = ceil_div(k, KC);
  const int c_max = std::max(1, std::min(MAX_CTAS, chunks / MIN_CTA_CHUNKS));
  int rows = 1;
  while (rows < MAX_ROWS && ceil_div(b, rows) * c_max > sms) rows *= 2;
  const int clusters = ceil_div(b, rows);
  const int warps = std::min(max_warps(rows, kernel), std::max(rows, ceil_div(chunks, c_max)));
  int ctas = c_max;
  for (; ctas > 1; --ctas) {
    int slots = 0;
    const cudaError_t err = cached_slots(rows, warps, ctas, kernel, &slots);
    if (err != cudaSuccess) return err;
    if (clusters <= slots) break;
  }
  *g = Geometry{rows, warps, ctas, clusters};
  return cudaSuccess;
}

inline bool valid_geometry(const Geometry& g, int kernel) {
  const bool pow2_rows = g.rows == 1 || g.rows == 2 || g.rows == 4 || g.rows == 8;
  return pow2_rows && g.warps >= 1 && g.warps <= max_warps(g.rows, kernel) && g.ctas >= 1 &&
         g.ctas <= MAX_CTAS && g.clusters >= 1;
}

// Dynamic shared memory of a CTA: the mbarriers, z of the R rows, the weight
// tables (KC x R a warp), then STAGES chunk buffers a warp (reused for the
// warps' partial sums after the walk).
__host__ __device__ inline int smem_bytes(int warps) {
  return BAR_BYTES + MAX_ROWS * D * 4 + MAX_WARPS * KC * MAX_ROWS * 4 +
         warps * STAGES * CHUNK_FLOATS * 4;
}

struct Params {
  const float* z;
  const float* c;
  const float* m;
  float inv_t2, lbd, log_eps;
  float* out0;  // B4: log pi [B]; B8: gi_part [B, 16, 16]; B1: L; B6, B7: G^{-1}
  float* out1;  // B4: grad [B, 16]; B8: v [B, 16]; B1: logdet [B]; B6: L
  int n_rows, n_centroids;
  long long* prof;  // -DHMC_PROFILE: null, or HMC_PHASES clock64 sums (PhaseClock)
  float* out2;      // B6: logdet [B]
  float* out3;      // B6: G [B, 16, 16]
};

struct Smem {
  uint64_t* bars;  // [warps][STAGES]
  float* zs;       // [R][16]
  float* ws;       // [warps][KC][R]
  float* stage;    // [warps][STAGES][CHUNK_FLOATS]
};

__device__ __forceinline__ Smem carve(unsigned char* base) {
  Smem s;
  s.bars = reinterpret_cast<uint64_t*>(base);
  s.zs = reinterpret_cast<float*>(base + BAR_BYTES);
  s.ws = s.zs + MAX_ROWS * D;
  s.stage = s.ws + MAX_WARPS * KC * MAX_ROWS;
  return s;
}

// 16 x 17 floats of the calling warp's own shared memory, for after the
// walk: the end of its staging buffers (warp 0's partial, which holds the
// CTA's sums, is at their start and takes at most MAX_ROWS x WIDTH floats).
__device__ __forceinline__ float* warp_scratch(unsigned char* smem) {
  return carve(smem).stage + (size_t)((threadIdx.x >> 5) + 1) * STAGES * CHUNK_FLOATS -
         D * (D + 1);
}

// Chunk `ch` of the bank into buffer `buf`, completing on `bar` (lane 0).
__device__ __forceinline__ void issue_chunk(const Params& p, int ch, float* buf, uint64_t* bar) {
  const int k0 = ch * KC;
  const int nk = min(KC, p.n_centroids - k0);
  mbar_arrive_expect_tx(bar, (uint32_t)(nk * (DD + D) * 4));
  bulk_g2s(buf, p.m + (size_t)k0 * DD, (uint32_t)(nk * DD * 4), bar);
  bulk_g2s(buf + KC * DD, p.c + (size_t)k0 * D, (uint32_t)(nk * D * 4), bar);
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
// only with V).
template <int R, bool V>
__device__ __forceinline__ void add_centroid(const float* mk, const float* ck, const float* wk,
                                             const float (&z0)[R], const float (&z1)[R],
                                             float (&g)[R][8], float (&vv)[R][4]) {
  const int lane = threadIdx.x & 31;
  const float4 ma = *reinterpret_cast<const float4*>(mk + 4 * lane);
  const float4 mb = *reinterpret_cast<const float4*>(mk + 128 + 4 * lane);
  float w[R];
  load_weights<R>(wk, w);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    g[r][0] = fmaf(w[r], ma.x, g[r][0]);
    g[r][1] = fmaf(w[r], ma.y, g[r][1]);
    g[r][2] = fmaf(w[r], ma.z, g[r][2]);
    g[r][3] = fmaf(w[r], ma.w, g[r][3]);
    g[r][4] = fmaf(w[r], mb.x, g[r][4]);
    g[r][5] = fmaf(w[r], mb.y, g[r][5]);
    g[r][6] = fmaf(w[r], mb.z, g[r][6]);
    g[r][7] = fmaf(w[r], mb.w, g[r][7]);
    if constexpr (V) {
      const float c0 = ck[lane >> 2], c1 = ck[8 + (lane >> 2)];
      const float wd0 = w[r] * (c0 - z0[r]);
      const float wd1 = w[r] * (c1 - z1[r]);
      vv[r][0] = fmaf(wd1, mb.x, fmaf(wd0, ma.x, vv[r][0]));
      vv[r][1] = fmaf(wd1, mb.y, fmaf(wd0, ma.y, vv[r][1]));
      vv[r][2] = fmaf(wd1, mb.z, fmaf(wd0, ma.z, vv[r][2]));
      vv[r][3] = fmaf(wd1, mb.w, fmaf(wd0, ma.w, vv[r][3]));
    }
  }
}

// The bank's sums for the CTA's R rows [row0, row0 + R).  Every thread of
// every CTA of the cluster calls it.  Returns, in the leader CTA, the
// cluster's sums in shared memory ([R][width(V)]: gi_part, then with V vsum
// unscaled), after a barrier that makes them visible to every thread of the
// CTA; nullptr in the other CTAs, which may then exit.
template <int R, bool V>
__device__ float* bank_sums(const Params& p, unsigned char* smem, PhaseClock<HMC_PHASES>& clk) {
  constexpr int W = width(V);
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / ctas) * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const Smem s = carve(smem);

  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int row = row0 + idx / D;
    s.zs[idx] = row < p.n_rows ? p.z[(size_t)row * D + idx % D] : 0.f;
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

  float* stage = s.stage + (size_t)warp * STAGES * CHUNK_FLOATS;
  float* ws = s.ws + warp * KC * R;
  if (lane == 0)
    for (int t = 0; t < min(STAGES, n); ++t)
      issue_chunk(p, begin + t, stage + t * CHUNK_FLOATS, &bars[t]);

  float z0[R], z1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    z0[r] = V ? s.zs[r * D + (lane >> 2)] : 0.f;
    z1[r] = V ? s.zs[r * D + 8 + (lane >> 2)] : 0.f;
  }
  float g[R][8], vv[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) g[r][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) vv[r][e] = 0.f;
  }
  clk.lap(SETUP);

  for (int t = 0; t < n; ++t) {
    const int b = t % STAGES;
    float* buf = stage + b * CHUNK_FLOATS;
    const float* cs = buf + KC * DD;
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
        for (int q = 0; q < D / 4; ++q) {
          const float4 cq = *reinterpret_cast<const float4*>(cs + j * D + 4 * q);
          const float4 zq = *reinterpret_cast<const float4*>(s.zs + r * D + 4 * q);
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
        add_centroid<R, V>(buf + j * DD, cs + j * D, ws + j * R, z0, z1, g, vv);
    } else {
      for (int j = 0; j < nk; ++j)
        add_centroid<R, V>(buf + j * DD, cs + j * D, ws + j * R, z0, z1, g, vv);
    }
    __syncwarp();  // the buffer and the weight table are read
    if (lane == 0 && t + STAGES < n) {
      fence_proxy_async();
      issue_chunk(p, begin + t + STAGES, buf, &bars[b]);
    }
    clk.lap(SUMS);
  }

  // the warp's partial, [R][W], into its own (drained) buffers: with V, the
  // lanes that share columns 4(l%4)..+3 add their vsum partials first
  float* part = stage;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* pr = part + r * W;
    *reinterpret_cast<float4*>(pr + 4 * lane) = make_float4(g[r][0], g[r][1], g[r][2], g[r][3]);
    *reinterpret_cast<float4*>(pr + 128 + 4 * lane) =
        make_float4(g[r][4], g[r][5], g[r][6], g[r][7]);
    if constexpr (V) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vv[r][e] += __shfl_xor_sync(0xffffffffu, vv[r][e], 4);
        vv[r][e] += __shfl_xor_sync(0xffffffffu, vv[r][e], 8);
        vv[r][e] += __shfl_xor_sync(0xffffffffu, vv[r][e], 16);
      }
      if (lane < 4)
        *reinterpret_cast<float4*>(pr + DD + 4 * lane) =
            make_float4(vv[r][0], vv[r][1], vv[r][2], vv[r][3]);
    }
  }
  __syncthreads();
  clk.lap(WARP_REDUCE);

  // the CTA's sum, in warp order, into warp 0's partial
  float* sum = s.stage;
  for (int idx = threadIdx.x; idx < R * W; idx += blockDim.x) {
    float acc = sum[idx];
    for (int w = 1; w < warps; ++w) acc += s.stage[(size_t)w * STAGES * CHUNK_FLOATS + idx];
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

// The Cholesky factor of one row's G^{-1} = sums + diag*I (sums i-major [DD],
// without the diagonal term), in the calling warp's registers: lane j (and
// its mirror j + 16) ends with row j of L in a[0..j] (a[m] for m > j keeps
// G^{-1}[j, m] and is not part of L), L[j, j] in ljj and 1 / L[j, j] in
// inv_ljj.  Right-looking, one rank-1 update per column: 16 dependent steps of
// a shuffle, a sqrt beside a reciprocal sqrt (both correctly rounded, so no
// division sits on the chain from one column to the next), a product, a
// shuffle of the column and one FMA (the left-looking form's last lane takes
// ~120 dependent steps).
__device__ __forceinline__ void cholesky_row(const float* sums, float diag, float (&a)[D],
                                             float& ljj, float& inv_ljj) {
  const int j = threadIdx.x & (D - 1);  // this lane's row of the tile; lanes 16..31 mirror 0..15
#pragma unroll
  for (int m = 0; m < D; ++m) a[m] = sums[j * D + m] + (m == j ? diag : 0.f);
  ljj = 0.f;
  inv_ljj = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float akk = __shfl_sync(FULL, a[k], k);
    const float lkk = sqrtf(akk);
    const float inv = __frsqrt_rn(akk);
    if (j > k) a[k] *= inv;
    if (j == k) {
      a[k] = ljj = lkk;
      inv_ljj = inv;
    }
#pragma unroll
    for (int m = k + 1; m < D; ++m) {
      const float lmk = __shfl_sync(FULL, a[k], m);
      if (j >= m) a[m] = fmaf(-a[k], lmk, a[m]);  // G^{-1}[j, m] -= L[j, k] L[m, k]
    }
  }
}

// sum_i log L_ii from each lane's L[j, j], by a 16-lane shuffle tree of logf
// (every lane gets the sum).
__device__ __forceinline__ float sum_log_diag(float ljj) {
  float s = logf(ljj);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// Row j of L (a from cholesky_row) into out (the row's [16, 16] tile,
// 16-byte aligned), with exact zeros above the diagonal: lane j writes its
// columns 0..7 and lane j + 16 columns 8..15, two float4 stores each.
__device__ __forceinline__ void store_lower_row(const float (&a)[D], float* out) {
  const int lane = threadIdx.x & 31, j = lane & (D - 1), h = lane >> 4;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 8 * h + e <= j ? (h ? a[8 + e] : a[e]) : 0.f;
  float4* dst = reinterpret_cast<float4*>(out + j * D + 8 * h);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
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

// Sets `kernel`'s shared-memory opt-in, once per (device, kernel).
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
                             smem_bytes(MAX_WARPS));
  if (err != cudaSuccess) return err;
  if (n_done < 64) {
    done[n_done] = reinterpret_cast<const void*>(kernel);
    done_dev[n_done++] = dev;
  }
  return cudaSuccess;
}

// The launch of geometry g: g.clusters clusters of g.ctas CTAs of g.warps
// warps; `attr` holds the cluster dimension.
inline cudaLaunchConfig_t launch_config(const Geometry& g, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.clusters * g.ctas);
  cfg.blockDim = dim3(g.warps * 32);
  cfg.dynamicSmemBytes = smem_bytes(g.warps);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `fn`, a kernel of `kernel` (a BankKernel), at geometry g on
// `stream`.  Neither synchronises nor allocates.
inline cudaError_t launch(void (*fn)(Params), const Params& params, const Geometry& g, int kernel,
                          cudaStream_t stream) {
  if (!valid_geometry(g, kernel)) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(fn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fn, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of geometry g of `fn` (a kernel of `kernel`) the card
// holds at once.
inline cudaError_t cluster_slots(void (*fn)(Params), Geometry g, int kernel, int* out) {
  if (!valid_geometry(g, kernel)) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(fn);
  if (err != cudaSuccess) return err;
  g.clusters = 1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// The rule's geometry for (B, K) of `kernel` on the current card.
inline cudaError_t rule_geometry(int n_rows, int n_centroids, int kernel, Geometry* g) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  return hmc_geometry(n_rows, n_centroids, sms, kernel, g);
}

}  // namespace hmc
