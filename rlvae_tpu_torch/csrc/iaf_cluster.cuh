// What the IAF-chain kernels (csrc/iaf_chain.cu, csrc/iaf_chain_bwd.cu) share:
// the launch geometry, the per-CTA weight-slice layout, the asynchronous copies
// that fill it, and the cluster-wide products and exchanges.
//
// Geometry.  A thread-block cluster of C = 8 CTAs owns R latent rows for the
// whole chain.  CTA `rank` owns the hidden columns [rank*HC, rank*HC + HC) of
// the hidden layers: a column slice of each WH[l] [H,H] and the matching row
// (K) slice of WO [H,2D]; layer 0 (D inputs, cheap) is computed whole in every
// CTA from the whole W0.  A hidden layer's output slice is sent to every
// peer's copy of the full [R,H] activation with st.async, which completes the
// bytes on the peer's mbarrier: a CTA waits on its own mbarrier for the bytes
// of all peers, with no cluster-wide barrier inside the chain.  The output
// layer, a K-split, gives each CTA a partial that the peers add in rank order
// (no atomics, so a relaunch gives the same bits).  Each exchange alternates
// between two buffers and two mbarriers; a peer can only send into a buffer
// again after it has received this CTA's next message, which this CTA sends
// only after reading that buffer, so no further barrier is needed.
//
// The rule (cluster_rows below; rlvae_tpu_torch.ops.iaf_kernels.chain_geometry
// gives the same R and cluster count in Python, for the backward's
// workspace): C = 8, the portable cluster size, and R is the smallest of 1, 2,
// 4, 8 that keeps ceil(B/R) <= 8 clusters, so B <= 64 needs at most 64 CTAs,
// one wave on an H100.
//
// Weights.  Where a MADE block's weights fit in the CTA's shared memory with
// the next block's (every shipped preset: D=16, H=256, NH=3), they are
// resident: one thread copies the next block's while the current block runs,
// with one tensor copy (a 2-D tensor map, cp.async.bulk.tensor) per hidden
// layer's column slice and 1-D bulk copies (cp.async.bulk) for the rest, all
// completed on an mbarrier, so each weight crosses from L2 once per cluster and
// block instead of once per pass.  (The column slice is 256 strided rows of
// 128 bytes: one tensor copy, not 256 bulk copies.)  Otherwise (for example
// NH=16 at H=256, or an odd D whose WO rows are not 16-byte aligned) the same
// kernel, instantiated with RESIDENT=false, reads them from global memory
// where it uses them.  Biases go through 4-byte cp.async.
//
// Built with -DIAF_PROFILE (rlvae_tpu_torch.ops.iaf_sweep's own library), the
// kernels also sum clock64 laps per phase on one thread (PhaseClock in
// sm90.cuh); otherwise the laps compile to nothing.  The PTX helpers
// (mbarriers, bulk copies, st.async, mapa) are sm90.cuh's, shared with the
// HMC kernels.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace iaf {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int MAX_D = 32;
constexpr int MAX_H = 256;
constexpr int MAX_NH = 16;         // the backward keeps NH-1 full activations
constexpr int CLUSTER_CTAS = 8;    // C, the portable cluster size
constexpr int CLUSTERS_PER_WAVE = 8;
constexpr int MAX_ROWS = 8;
constexpr float LOG_VAR_CLAMP = 1.5f;
// mbarriers at the start of dynamic shared memory; the floats after them
// start on a 128-byte boundary, as the tensor copies' destinations must
constexpr int BAR_BYTES = 128;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round32(int x) { return (x + 31) & ~31; }

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// R: the smallest power of two <= MAX_ROWS with ceil(B / R) <= CLUSTERS_PER_WAVE.
inline int cluster_rows(int B) {
  int r = 1;
  while (r < MAX_ROWS && (B + r - 1) / r > CLUSTERS_PER_WAVE) r *= 2;
  return r;
}

// One CTA's slice layout (all strides in floats, each a multiple of 4 so that
// every row a bulk copy lands on is 16-byte aligned).  A column slice of a
// hidden layer lies in shared memory as [K][HC], dense, as its tensor copy
// lands it.
struct Layout {
  int HC;   // hidden columns per CTA: a power of two >= 4
  int KG;   // THREADS / HC: groups that split a product's K
  int LS;   // floats from one layer's column slice to the next: H*HC, 128-byte aligned
  int WRS;  // row stride of a row slice [HC][H] (the backward's WH^T products)
  int WOS;  // row stride of WO's row slice [HC][2D]
  int DP;   // D rounded up to 4: the row stride of the latent buffers
  int D2P;  // 2D rounded up to 4
};

__host__ __device__ inline Layout make_layout(int D, int H) {
  Layout l;
  l.HC = pow2_at_least(round4((H + CLUSTER_CTAS - 1) / CLUSTER_CTAS));
  l.KG = THREADS / l.HC;
  l.LS = round32(H * l.HC);
  l.WRS = H + 4;
  l.WOS = round4(2 * D) + 4;
  l.DP = round4(D);
  l.D2P = round4(2 * D);
  return l;
}

// ---------------------------------------------------------------------------
// Exchanges: a channel is two buffers and two mbarriers, alternated by use
// ---------------------------------------------------------------------------

// Before the sends of use `use`, one thread announces the bytes that will
// arrive here (from every peer, this CTA included).  The peers' bytes may
// land first: the phase completes when both are in.
__device__ __forceinline__ void expect_bytes(uint64_t* bars, int use, uint32_t bytes) {
  if (threadIdx.x == 0) mbar_arrive_expect_tx(&bars[use & 1], bytes);
}

__device__ __forceinline__ void wait_bytes(uint64_t* bars, int use) {
  mbar_wait_cluster(&bars[use & 1], (uint32_t)(use >> 1) & 1u);
}

// v to the same address `local` in peers first, first+step, ... < C, each
// completing on that peer's copy of `bar`.
__device__ __forceinline__ void send_v4(float* local, const float4& v, uint64_t* bar,
                                        int first = 0, int step = 1) {
  const uint32_t a = smem_u32(local), b = smem_u32(bar);
  for (int p = first; p < CLUSTER_CTAS; p += step) st_async_v4(mapa(a, p), v, mapa(b, p));
}

__device__ __forceinline__ void send_v2(float2* local, const float2& v, uint64_t* bar,
                                        int first = 0, int step = 1) {
  const uint32_t a = smem_u32(local), b = smem_u32(bar);
  for (int p = first; p < CLUSTER_CTAS; p += step) st_async_v2(mapa(a, p), v, mapa(b, p));
}

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------

// `count` floats from src to dst with 4-byte asynchronous copies (whole,
// in-bounds ranges), by the whole CTA.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int count) {
  for (int idx = threadIdx.x; idx < count; idx += THREADS) cp_async4(dst + idx, src + idx);
}

// Rows [0, n_rows) of `row_bytes` each from src (stride src_stride floats) to
// dst (stride dst_stride floats), one bulk copy per row, by the calling warp.
__device__ __forceinline__ void bulk_rows(float* dst, int dst_stride, const float* src,
                                          size_t src_stride, int n_rows, uint32_t row_bytes,
                                          uint64_t* bar) {
  for (int i = threadIdx.x & 31; i < n_rows; i += 32)
    bulk_g2s(dst + (size_t)i * dst_stride, src + i * src_stride, row_bytes, bar);
}

// MADE block n's biases into dst = [b0 (whole, H)][bh column slices (NH-1)][HC]
// [bo (2D)], by the whole CTA; one commit group per thread.
__device__ __forceinline__ void issue_biases(const float* b0, const float* bh, const float* bo,
                                             int n, int D, int H, int NH, int HC, int col0,
                                             int ncols, float* dst) {
  copy_async(dst, b0 + (size_t)n * H, H);
  for (int idx = threadIdx.x; idx < (NH - 1) * HC; idx += THREADS) {
    const int l = idx / HC, cc = idx - l * HC;
    if (cc < ncols) cp_async4(dst + H + idx, bh + ((size_t)n * (NH - 1) + l) * H + col0 + cc);
  }
  copy_async(dst + H + (NH - 1) * HC, bo + (size_t)n * 2 * D, 2 * D);
  cp_async_commit();
}

__host__ __device__ inline int bias_floats(int D, int H, int NH, int HC) {
  return H + (NH - 1) * HC + round4(2 * D);
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// acc[r] = sum over this thread's K-chunks of src[r][k] * w[k*ws + c]: the
// thread's share of out[:, c] = src @ W[:, c] for a column slice W (in shared
// memory, or in global memory at stride H when streamed).  K-chunks of 4 are
// dealt round-robin to the KG groups.
template <int R>
__device__ __forceinline__ void dot_cols(const float* __restrict__ src, int K,
                                         const float* __restrict__ w, int ws, int c, int kg,
                                         int KG, bool active, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  if (!active) return;
#pragma unroll 4
  for (int q = kg; q < K / 4; q += KG) {
    const int k = 4 * q;
    const float w0 = w[(size_t)(k + 0) * ws + c];
    const float w1 = w[(size_t)(k + 1) * ws + c];
    const float w2 = w[(size_t)(k + 2) * ws + c];
    const float w3 = w[(size_t)(k + 3) * ws + c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(src + r * K + k);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
}

// acc[r] = sum over this thread's K-chunks of src[r][k] * w[c*ws + k]: the
// thread's share of out[:, c] = src @ W^T[:, c] for a row slice W (row c of
// the slice contiguous over K).
template <int R>
__device__ __forceinline__ void dot_rows(const float* __restrict__ src, int K,
                                         const float* __restrict__ w, int ws, int c, int kg,
                                         int KG, bool active, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  if (!active) return;
  const float* wc = w + (size_t)c * ws;
#pragma unroll 4
  for (int q = kg; q < K / 4; q += KG) {
    const float4 wv = *reinterpret_cast<const float4*>(wc + 4 * q);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(src + r * K + 4 * q);
      acc[r] = fmaf(a.x, wv.x, acc[r]);
      acc[r] = fmaf(a.y, wv.y, acc[r]);
      acc[r] = fmaf(a.z, wv.z, acc[r]);
      acc[r] = fmaf(a.w, wv.w, acc[r]);
    }
  }
}

// Stores every thread's acc for reduce_quad: red [KG][R][HC].
template <int R>
__device__ __forceinline__ void store_groups(const float (&acc)[R], float* red, int HC, int c,
                                             int kg) {
#pragma unroll
  for (int r = 0; r < R; ++r) red[(kg * R + r) * HC + c] = acc[r];
}

// After store_groups and a barrier: the sum over the KG groups, in group
// order, of columns [4q, 4q+4) of row r.
template <int R>
__device__ __forceinline__ float4 reduce_quad(const float* red, int KG, int HC, int r, int q) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int g = 0; g < KG; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(red + (g * R + r) * HC + 4 * q);
    v.x += x.x;
    v.y += x.y;
    v.z += x.z;
    v.w += x.w;
  }
  return v;
}

// Layer 0 whole, in every CTA: out[r][h] = sum_d y[r][d] * W0[d][h] + b0[h]
// for h < H, one column per thread (H <= THREADS), no activation.
template <int R>
__device__ __forceinline__ void layer0(const float* __restrict__ y, int DP, int D,
                                       const float* __restrict__ w0, const float* __restrict__ b0,
                                       int H, float* __restrict__ out) {
  const int h = threadIdx.x;
  if (h >= H) return;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float w = w0[(size_t)d * H + h];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(y[r * DP + d], w, acc[r]);
  }
  const float b = b0[h];
#pragma unroll
  for (int r = 0; r < R; ++r) out[r * H + h] = acc[r] + b;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The tensor map of the stacked hidden weights wh viewed as [rows][H] fp32,
// whose box is one CTA's column slice of one layer: H rows by HC columns.
// cuTensorMapEncodeTiled is looked up once, through the runtime.
inline cudaError_t encode_wh_map(CUtensorMap* map, const float* wh, int H, long long rows,
                                 int HC) {
  using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (encode == nullptr) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err =
          cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
      if (err != cudaSuccess) return err;
      if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
      encode = reinterpret_cast<EncodeTiled>(fn);
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)H * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)HC, (cuuint32_t)H};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(wh),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Sets the kernel's shared-memory attribute and asks how many clusters of C
// CTAs with `smem` bytes each the card can hold at once (0: none, the launch
// would fail).  The answer is cached per (device, kernel, smem).
inline cudaError_t max_active_clusters(const void* kernel, size_t smem, int* out) {
  struct Entry {
    int device;
    const void* kernel;
    size_t smem;
    int clusters;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n_cached = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].device == device && cache[i].kernel == kernel && cache[i].smem == smem) {
      *out = cache[i].clusters;
      return cudaSuccess;
    }
  // the largest opt-in once per kernel, so that later launches of the same
  // kernel with another geometry's smaller or larger request all pass
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin_smem());
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CLUSTER_CTAS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n_cached < 64) cache[n_cached++] = Entry{device, kernel, smem, clusters};
  *out = clusters;
  return cudaSuccess;
}

// Launches `kernel` as n_clusters clusters of C CTAs on `stream`; an error if
// no such cluster can be resident.  Neither synchronises nor allocates.
template <typename Params>
inline cudaError_t launch_clusters(void (*kernel)(Params), const Params& params, int n_clusters,
                                   size_t smem, cudaStream_t stream) {
  int clusters = 0;
  cudaError_t err = max_active_clusters(reinterpret_cast<const void*>(kernel), smem, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n_clusters * CLUSTER_CTAS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace iaf
