// decode_mse at a hidden width past decode_mse.cu's (K > 512): the same
// function,
//
//   pre[m, n] = bf16(h[m]) . bf16(W[n]) + b[n]        (fp32 sum of exact products)
//   s         = 1 / (1 + exp(-pre))
//   loss      = sum_m rw[m] sum_n (s - x[m, n])^2
//   dp        = bf16(rw * 2 * (s - x) * s * (1 - s))  (the TPU kernel's _dpre)
//   dh        = g * round?(dp . bf16(W)),  dW = g * dp^T . bf16(h),  db = g * sum_m dp
//
// for any K.  Replaces, past K = 512, the Pallas kernels behind
// rlvae_tpu/ops/recon_kernels.py:229 decode_mse (_fwd_pallas :165, pallas_call
// :167; _bwd_pallas :180, the dh pallas_call :183, the dW/db pallas_call
// :192), which take any width.
//
// What bounds it on an H100: at the mlp_rlvae decoder's last layer (K = 1024,
// N = 12288) and B*T = 128 rows each product is 3.2 GFLOP, 3.3 us on the bf16
// tensor cores, and W (50 MB as fp32) takes 15 us to read: the bytes.  This
// version does its products on the fp32 pipes instead (48 us at 67 TFLOP/s
// for one product alone), with W read once per 64-row tile of h.
//
// Design: every product is one tiled loop, C[64 x 64] a CTA of 256 threads
// (4 x 4 outputs a thread, read from shared memory as float4s), the
// contraction walked in 16-deep steps staged in shared memory, the operands
// rounded to bf16 as they are staged (so each product of two bf16 values is
// exact in fp32 and only the sums round).  Each operand is staged along the
// index its memory runs along, so a warp's loads are contiguous: h, W and dp
// along the contraction for pre and dh's dp; W along k for dh; dp along n
// and h along k for dW.
// - forward: pre per tile, then each thread's rw (s - x)^2, summed over the
//   CTA in a fixed order into one partial; a second kernel adds the partials
//   in order.
// - backward: dp [M, N] (bf16 values as fp32) into a workspace once; the dh
//   entry fills it and the dW/db entry reads it when its caller passes it
//   filled (DecodeMSE's backward), else fills it too.  dh [M, K] sums over N
//   in `slices` ranges of whole 16-column steps (ceil(K/64) x ceil(M/64)
//   tiles alone would leave most SMs idle at M = 128), each slice's partial
//   into a workspace, added in slice order by a second kernel; dW [N, K]
//   over M; db over M; each sum in a fixed order.
// No atomics: a relaunch and a CUDA-graph replay give the same bits.  fp32
// IEEE arithmetic (expf, IEEE division; no fast math).  K <= 512 takes
// decode_mse.cu (tensor cores, W once per launch): these entries serve only
// wider layers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_wide {  // named, so that -Xptxas -v lines carry "11decode_wide"
namespace {

constexpr int TILE = 64, DEPTH = 16, THREADS = 256;
constexpr int PITCH = TILE + 4;  // a staged row: float4-aligned

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// s[l][r] = f(r0 + r, l0 + l) for r < TILE, l < DEPTH; adjacent threads take
// adjacent l (ALONG_L: the operand's memory runs along the contraction) or
// adjacent r.
template <bool ALONG_L, class F>
__device__ __forceinline__ void stage(float (*s)[PITCH], F f, int r0, int l0) {
#pragma unroll
  for (int i = 0; i < DEPTH * TILE / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = ALONG_L ? idx / DEPTH : idx % TILE;
    const int l = ALONG_L ? idx % DEPTH : idx / TILE;
    s[l][r] = f(r0 + r, l0 + l);
  }
}

// C[i0 + 4 ty + q][j0 + 4 tx + p] += sum_{l0 <= l < l1} a(i, l) b(j, l), l in
// increasing 16-deep steps from l0, each step's products in increasing l;
// a and b give 0 outside their operands (and their range of l).
template <bool A_ALONG_L, bool B_ALONG_L, class A, class B>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], A a, B b, int i0, int j0,
                                             int l0, int l1) {
  __shared__ __align__(16) float as[DEPTH][PITCH];
  __shared__ __align__(16) float bs[DEPTH][PITCH];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int ls = l0; ls < l1; ls += DEPTH) {
    stage<A_ALONG_L>(as, a, i0, ls);
    stage<B_ALONG_L>(bs, b, j0, ls);
    __syncthreads();
#pragma unroll
    for (int l = 0; l < DEPTH; ++l) {
      const float4 av = *reinterpret_cast<const float4*>(&as[l][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[l][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(a4[q], b4[p], acc[q][p]);
    }
    __syncthreads();
  }
}

// Sum of v over the CTA in a fixed order; valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float red[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
  return s;
}

// The CTA's tile of pre (rows blockIdx.y, columns blockIdx.x), without b.
__device__ __forceinline__ void pre_tile(float (&acc)[4][4], const uint16_t* h, const float* w,
                                         int M, int K, int N) {
  tile_product<true, true>(
      acc, [&](int m, int k) { return m < M && k < K ? bf16_bits(h[(size_t)m * K + k]) : 0.f; },
      [&](int n, int k) { return n < N && k < K ? round_bf16(w[(size_t)n * K + k]) : 0.f; },
      blockIdx.y * TILE, blockIdx.x * TILE, 0, K);
}

// grid (ceil(N / 64), ceil(M / 64)): partials[y * gridDim.x + x] = the
// tile's sum of rw (s - x)^2.
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const uint16_t* __restrict__ h, const float* __restrict__ w,
           const float* __restrict__ b, const float* __restrict__ x,
           const float* __restrict__ rw, float* __restrict__ partials, int M, int K, int N) {
  float acc[4][4] = {};
  pre_tile(acc, h, w, M, K, N);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float part = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = blockIdx.y * TILE + 4 * ty + q;
    if (m >= M) continue;
    float rs = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n = blockIdx.x * TILE + 4 * tx + p;
      if (n >= N) continue;
      const float d = sigmoid(acc[q][p] + b[n]) - x[(size_t)m * N + n];
      rs += d * d;
    }
    part += rw[m] * rs;
  }
  const float s = block_sum(part);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// out[0] = sum of partials[0..n), in a fixed order.
__global__ void __launch_bounds__(THREADS)
sum_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) v += partials[i];
  const float s = block_sum(v);
  if (threadIdx.x == 0) out[0] = s;
}

// grid as fwd_kernel: dp[m, n] for the tile (0 past M and N).
__global__ void __launch_bounds__(THREADS)
dp_kernel(const uint16_t* __restrict__ h, const float* __restrict__ w,
          const float* __restrict__ b, const float* __restrict__ x,
          const float* __restrict__ rw, float* __restrict__ dp, int M, int K, int N) {
  float acc[4][4] = {};
  pre_tile(acc, h, w, M, K, N);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = blockIdx.y * TILE + 4 * ty + q;
    if (m >= M) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n = blockIdx.x * TILE + 4 * tx + p;
      if (n >= N) continue;
      const float s = sigmoid(acc[q][p] + b[n]);
      const float d = s - x[(size_t)m * N + n];
      dp[(size_t)m * N + n] = round_bf16(rw[m] * 2.f * d * s * (1.f - s));
    }
  }
}

// grid (ceil(K / 64), ceil(M / 64), slices): slice z sums n in [z per,
// min(N, (z + 1) per)): out[z][m][k] = sum_n dp[m, n] bf16(W[n, k]).  With
// one slice, out is dh itself: g * round?(the sum).
__global__ void __launch_bounds__(THREADS)
dh_kernel(const float* __restrict__ dp, const float* __restrict__ w, const float* __restrict__ g,
          float* __restrict__ out, int M, int K, int N, int per, int round_dh) {
  float acc[4][4] = {};
  const int n0 = blockIdx.z * per, n1 = min(N, n0 + per);
  tile_product<true, false>(
      acc, [&](int m, int n) { return m < M && n < n1 ? dp[(size_t)m * N + n] : 0.f; },
      [&](int k, int n) { return k < K && n < n1 ? round_bf16(w[(size_t)n * K + k]) : 0.f; },
      blockIdx.y * TILE, blockIdx.x * TILE, n0, n1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool whole = gridDim.z == 1;
  const float gv = g[0];
  float* dst = out + (size_t)blockIdx.z * M * K;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = blockIdx.y * TILE + 4 * ty + q;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = blockIdx.x * TILE + 4 * tx + p;
      if (m < M && k < K)
        dst[(size_t)m * K + k] =
            whole ? gv * (round_dh ? round_bf16(acc[q][p]) : acc[q][p]) : acc[q][p];
    }
  }
}

// dh[i] = g * round?(sum_z partials[z][i]), z in order, i < M * K.
__global__ void __launch_bounds__(THREADS)
dh_sum_kernel(const float* __restrict__ partials, const float* __restrict__ g,
              float* __restrict__ dh, int mk, int slices, int round_dh) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= mk) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += partials[(size_t)z * mk + i];
  dh[i] = g[0] * (round_dh ? round_bf16(s) : s);
}

// grid (ceil(K / 64), ceil(N / 64)): dW[n, k] = g * sum_m dp[m, n] bf16(h[m, k]).
__global__ void __launch_bounds__(THREADS)
dw_kernel(const float* __restrict__ dp, const uint16_t* __restrict__ h,
          const float* __restrict__ g, float* __restrict__ dw, int M, int K, int N) {
  float acc[4][4] = {};
  tile_product<false, false>(
      acc, [&](int n, int m) { return n < N && m < M ? dp[(size_t)m * N + n] : 0.f; },
      [&](int k, int m) { return k < K && m < M ? bf16_bits(h[(size_t)m * K + k]) : 0.f; },
      blockIdx.y * TILE, blockIdx.x * TILE, 0, M);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float gv = g[0];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = blockIdx.y * TILE + 4 * ty + q;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = blockIdx.x * TILE + 4 * tx + p;
      if (n < N && k < K) dw[(size_t)n * K + k] = gv * acc[q][p];
    }
  }
}

// db[n] = g * sum_m dp[m, n], m in order; a thread a column.
__global__ void __launch_bounds__(THREADS)
db_kernel(const float* __restrict__ dp, const float* __restrict__ g, float* __restrict__ db,
          int M, int N) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int m = 0; m < M; ++m) s += dp[(size_t)m * N + n];
  db[n] = g[0] * s;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

inline bool valid(int M, int K, int N) { return M >= 1 && K >= 1 && N >= 1; }

int launch_dp(const uint16_t* h, const float* w, const float* b, const float* x, const float* rw,
              float* dp, int M, int K, int N, cudaStream_t stream) {
  dp_kernel<<<dim3(ceil_div(N, TILE), ceil_div(M, TILE)), THREADS, 0, stream>>>(h, w, b, x, rw,
                                                                               dp, M, K, N);
  return last_error();
}

}  // namespace
}  // namespace decode_wide

using decode_wide::ceil_div;
using decode_wide::THREADS;
using decode_wide::TILE;

// The loss into loss[0]; partials holds ceil(N / 64) * ceil(M / 64) floats.
// h is bf16 [M, K]; W, b, x, rw fp32.
extern "C" int decode_mse_wide_fwd_f32(const void* h, const float* w, const float* b,
                                       const float* x, const float* rw, float* partials,
                                       float* loss, int M, int K, int N, cudaStream_t stream) {
  if (!decode_wide::valid(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ceil_div(N, TILE), ceil_div(M, TILE));
  decode_wide::fwd_kernel<<<grid, THREADS, 0, stream>>>(static_cast<const uint16_t*>(h), w, b, x,
                                                        rw, partials, M, K, N);
  int err = decode_wide::last_error();
  if (err != 0) return err;
  decode_wide::sum_kernel<<<1, THREADS, 0, stream>>>(partials, grid.x * grid.y, loss);
  return decode_wide::last_error();
}

// dh [M, K] fp32 (rounded to bf16 first with round_dh); dp is an [M, N]
// fp32 workspace, left holding dp; partials holds slices * M * K floats
// (null with one slice).
extern "C" int decode_mse_wide_bwd_dh_f32(const void* h, const float* w, const float* b,
                                          const float* x, const float* rw, const float* g,
                                          float* dp, float* partials, float* dh, int M, int K,
                                          int N, int slices, int round_dh, cudaStream_t stream) {
  if (!decode_wide::valid(M, K, N) || slices < 1 || slices > 65535 ||
      (slices > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = decode_wide::launch_dp(static_cast<const uint16_t*>(h), w, b, x, rw, dp, M, K, N,
                                   stream);
  if (err != 0) return err;
  const int per = ceil_div(ceil_div(N, decode_wide::DEPTH), slices) * decode_wide::DEPTH;
  decode_wide::dh_kernel<<<dim3(ceil_div(K, TILE), ceil_div(M, TILE), slices), THREADS, 0,
                           stream>>>(dp, w, g, slices == 1 ? dh : partials, M, K, N, per,
                                     round_dh);
  err = decode_wide::last_error();
  if (err != 0 || slices == 1) return err;
  decode_wide::dh_sum_kernel<<<ceil_div(M * K, THREADS), THREADS, 0, stream>>>(
      partials, g, dh, M * K, slices, round_dh);
  return decode_wide::last_error();
}

// dW [N, K] and db [N] fp32; dp is an [M, N] fp32 workspace, read as the dh
// entry left it on the same inputs when dp_ready, else filled here.
extern "C" int decode_mse_wide_bwd_dw_f32(const void* h, const float* w, const float* b,
                                          const float* x, const float* rw, const float* g,
                                          float* dp, float* dw, float* db, int M, int K, int N,
                                          int dp_ready, cudaStream_t stream) {
  if (!decode_wide::valid(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* hb = static_cast<const uint16_t*>(h);
  if (!dp_ready) {
    const int err = decode_wide::launch_dp(hb, w, b, x, rw, dp, M, K, N, stream);
    if (err != 0) return err;
  }
  decode_wide::dw_kernel<<<dim3(ceil_div(K, TILE), ceil_div(N, TILE)), THREADS, 0, stream>>>(
      dp, hb, g, dw, M, K, N);
  int err = decode_wide::last_error();
  if (err != 0) return err;
  decode_wide::db_kernel<<<ceil_div(N, THREADS), THREADS, 0, stream>>>(dp, g, db, M, N);
  return decode_wide::last_error();
}
