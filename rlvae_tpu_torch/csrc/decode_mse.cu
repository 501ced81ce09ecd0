// decode_mse: the decoder's last Dense, its sigmoid and the row-weighted MSE,
//
//   pre[m, n] = bf16(h[m]) . bf16(W[n]) + b[n]        (fp32 sum of exact products)
//   s         = 1 / (1 + exp(-pre))
//   loss      = sum_m rw[m] sum_n (s - x[m, n])^2
//
// and its gradient, without the [M, N] reconstruction ever reaching device
// memory.  W is the port's nn.Linear weight, [N, K] (the TPU kernel's is its
// transpose); h [M, K] is bf16; W, b, x, rw and every output are fp32.
//
// Replaces the Pallas kernels behind rlvae_tpu/ops/recon_kernels.py:229
// decode_mse: _fwd_pallas (:165, pallas_call :167) and _bwd_pallas (:180; the
// dh pallas_call :183, the dW/db pallas_call :192).  As there, h and W enter
// the product rounded to bf16 (round to nearest even) with fp32 accumulation,
// the sigmoid, residual and sums are fp32, and the backward recomputes each
// tile's pre-activation and forms dp = bf16(rw * 2 * d * s * (1 - s)) before
// both of its products: dh = dp W (fp32, then rounded to bf16 when h is bf16)
// and dW = dp^T h, db = sum_m dp, each scaled by the cotangent g.
//
// What bounds it on an H100: at the fast preset's training shape (M = B*8 =
// 128, K = 512, N = 12288) the forward is 1.6 GFLOP on ~32 MB of inputs (W,
// read as fp32, and x dominate), so in bf16 on the tensor cores the bytes bound
// it (~10 us); the backward recomputes the product twice and adds two more, 4x
// the operations on the same bytes.  This first kernel does its products with
// fp32 FMAs on the bf16-rounded operands (each product exact in fp32), so the
// card's fp32 rate, not the tensor cores', is its roof; wgmma and TMA are
// later work.
//
// Design (no block carries a sum to another, no floating-point atomics, so
// every output is bit-identical from run to run):
// - forward: 64x64 output tiles, K staged through shared memory in chunks of
//   16, 4x4 outputs per thread; the epilogue adds b, takes the sigmoid and the
//   residual in registers and writes one partial sum per block; a second
//   kernel adds the partials in a fixed order.
// - dh: a block holds 32 rows of h and walks its own range of 64-column
//   subtiles of W (both kept as bf16 in shared memory): the subtile's
//   pre-activation and dp, then dh_partial += dp W_subtile.  Each range writes
//   its partial [32, K] to a workspace; a second kernel adds the ranges in
//   order, rounds and scales.  The wrapper picks the number of ranges so that
//   about two blocks run per SM.
// - dW/db: a block owns 32 columns of W and loops over every row of h in tiles
//   of 32, accumulating dW[its columns] and db in registers; it writes them
//   once.
// Ragged M and N are masked in the kernels; a row with rw = 0 contributes
// exactly 0 to the loss and to every gradient.  fp32 IEEE arithmetic (expf,
// IEEE division; no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 512;

// forward tiles
constexpr int F_BM = 64, F_BN = 64, F_KC = 16;
// dh: rows per block, columns per subtile
constexpr int H_BM = 32, H_BN = 64;
// dW/db: rows per tile, columns per block
constexpr int W_BM = 32, W_BN = 32;

__device__ __forceinline__ float bits_to_float(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// dp = bf16(rw * 2 * d * s * (1 - s)), in the TPU kernel's order (_dpre)
__device__ __forceinline__ float dpre(float pre, float xv, float rwv) {
  const float s = sigmoid(pre);
  const float d = s - xv;
  return round_bf16(rwv * 2.f * d * s * (1.f - s));
}

// Sum of v over the block, in a fixed order; valid in thread 0.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
  return s;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
fwd_tile_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, const float* __restrict__ x,
                const float* __restrict__ rw, float* __restrict__ partials, int M, int K,
                int N) {
  __shared__ float hs[F_KC][F_BM + 1];  // h^T chunk, padded against bank conflicts
  __shared__ float ws[F_KC][F_BN + 1];  // bf16-rounded W^T chunk
  __shared__ float red[THREADS / 32];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int row0 = blockIdx.y * F_BM, col0 = blockIdx.x * F_BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_KC) {
    for (int idx = t; idx < F_BM * F_KC; idx += THREADS) {
      const int r = idx / F_KC, kk = idx % F_KC;
      const int row = row0 + r, k = k0 + kk;
      hs[kk][r] = (row < M && k < K) ? __bfloat162float(h[(size_t)row * K + k]) : 0.f;
    }
    for (int idx = t; idx < F_BN * F_KC; idx += THREADS) {
      const int c = idx / F_KC, kk = idx % F_KC;
      const int col = col0 + c, k = k0 + kk;
      ws[kk][c] = (col < N && k < K) ? round_bf16(w[(size_t)col * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_KC; ++kk) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= M) continue;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < N) {
        const float d = sigmoid(acc[i][j] + b[col]) - x[(size_t)row * N + col];
        rs += d * d;
      }
    }
    part += rw[row] * rs;
  }
  const float s = block_sum(part, red);
  if (t == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// out[0] = sum of partials[0..n), in a fixed order.
__global__ void __launch_bounds__(THREADS)
sum_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) v += partials[i];
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[0] = s;
}

// ---------------------------------------------------------------------------
// backward, dh
// ---------------------------------------------------------------------------

// Shared memory of the dh kernel: hs [H_BM][K+2] and ws [K][H_BN+2] as bf16
// bits (the +2 staggers rows over the banks), dps [H_BM][H_BN+1] fp32.
__host__ __device__ constexpr size_t dh_smem_bytes(int K) {
  return (size_t)H_BM * (K + 2) * 2 + (size_t)K * (H_BN + 2) * 2 +
         (size_t)H_BM * (H_BN + 1) * 4;
}

__global__ void __launch_bounds__(THREADS)
bwd_dh_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ x,
              const float* __restrict__ rw, float* __restrict__ partials, int M, int K,
              int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs_stride = K + 2, ws_stride = H_BN + 2, dp_stride = H_BN + 1;
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ws = hs + (size_t)H_BM * hs_stride;
  float* dps = reinterpret_cast<float*>(ws + (size_t)K * ws_stride);

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * H_BM;
  const int n_sub = (N + H_BN - 1) / H_BN;
  const int s_begin = (int)((long long)blockIdx.y * n_sub / gridDim.y);
  const int s_end = (int)((long long)(blockIdx.y + 1) * n_sub / gridDim.y);

  // this block's rows of h, kept for every subtile
  const uint16_t* hb = reinterpret_cast<const uint16_t*>(h);
  for (int idx = t; idx < H_BM * K; idx += THREADS) {
    const int r = idx / K, k = idx % K;
    const int row = row0 + r;
    hs[r * hs_stride + k] = row < M ? hb[(size_t)row * K + k] : (uint16_t)0;
  }

  // the pre-activation tile: rows ty + 16a, columns tx + 16c
  const int tx = t & 15, ty = t >> 4;
  // the dh partial: rows rg + 4i, hidden units kg + 64j
  const int kg = t & 63, rg = t >> 6;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int sub = s_begin; sub < s_end; ++sub) {
    const int col0 = sub * H_BN;
    __syncthreads();  // the previous subtile's ws and dps are no longer read
    for (int idx = t; idx < H_BN * K; idx += THREADS) {
      const int c = idx / K, k = idx % K;
      const int col = col0 + c;
      ws[k * ws_stride + c] = col < N ? bf16_bits(w[(size_t)col * K + k]) : (uint16_t)0;
    }
    __syncthreads();

    float p[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[a][c] = 0.f;
    for (int k = 0; k < K; ++k) {
      float hv[2], wv[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) hv[a] = bits_to_float(hs[(ty + 16 * a) * hs_stride + k]);
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = bits_to_float(ws[k * ws_stride + tx + 16 * c]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[a][c] = fmaf(hv[a], wv[c], p[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty + 16 * a, row = row0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = tx + 16 * c, col = col0 + cc;
        dps[r * dp_stride + cc] = (row < M && col < N)
            ? dpre(p[a][c] + b[col], x[(size_t)row * N + col], rw[row]) : 0.f;
      }
    }
    __syncthreads();

    for (int n = 0; n < H_BN; ++n) {
      float dv[8], wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dv[i] = dps[(rg + 4 * i) * dp_stride + n];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = kg + 64 * j;
        wv[j] = k < K ? bits_to_float(ws[k * ws_stride + n]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dv[i], wv[j], acc[i][j]);
    }
  }

  float* out = partials + (size_t)blockIdx.y * M * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + rg + 4 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kg + 64 * j;
      if (k < K) out[(size_t)row * K + k] = acc[i][j];
    }
  }
}

// dh[e] = g * round?(sum over ranges of partials[range][e]), ranges in order.
__global__ void __launch_bounds__(THREADS)
dh_reduce_kernel(const float* __restrict__ partials, int n_ranges, size_t count,
                 const float* __restrict__ g, int round_dh, float* __restrict__ dh) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int r = 0; r < n_ranges; ++r) s += partials[(size_t)r * count + e];
  dh[e] = g[0] * (round_dh ? round_bf16(s) : s);
}

// ---------------------------------------------------------------------------
// backward, dW and db
// ---------------------------------------------------------------------------

// Shared memory of the dW kernel: ws [K][W_BN+2] and hs [W_BM][K+2] as bf16
// bits, dps [W_BM][W_BN+1] fp32.
__host__ __device__ constexpr size_t dw_smem_bytes(int K) {
  return (size_t)K * (W_BN + 2) * 2 + (size_t)W_BM * (K + 2) * 2 +
         (size_t)W_BM * (W_BN + 1) * 4;
}

__global__ void __launch_bounds__(THREADS)
bwd_dw_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ x,
              const float* __restrict__ rw, const float* __restrict__ g,
              float* __restrict__ dw, float* __restrict__ db, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws_stride = W_BN + 2, hs_stride = K + 2, dp_stride = W_BN + 1;
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem);
  uint16_t* hs = ws + (size_t)K * ws_stride;
  float* dps = reinterpret_cast<float*>(hs + (size_t)W_BM * hs_stride);

  const int t = threadIdx.x;
  const int col0 = blockIdx.x * W_BN;
  const uint16_t* hb = reinterpret_cast<const uint16_t*>(h);

  // this block's columns of W, kept for every row tile
  for (int idx = t; idx < W_BN * K; idx += THREADS) {
    const int c = idx / K, k = idx % K;
    const int col = col0 + c;
    ws[k * ws_stride + c] = col < N ? bf16_bits(w[(size_t)col * K + k]) : (uint16_t)0;
  }

  // the pre-activation tile: rows ty + 16a, columns tx + 16c
  const int tx = t & 15, ty = t >> 4;
  // dW: columns cg + 8i, hidden units kg + 32j
  const int kg = t & 31, cg = t >> 5;
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  float db_acc = 0.f;

  for (int row0 = 0; row0 < M; row0 += W_BM) {
    __syncthreads();  // the previous tile's hs and dps are no longer read
    for (int idx = t; idx < W_BM * K; idx += THREADS) {
      const int r = idx / K, k = idx % K;
      const int row = row0 + r;
      hs[r * hs_stride + k] = row < M ? hb[(size_t)row * K + k] : (uint16_t)0;
    }
    __syncthreads();

    float p[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int k = 0; k < K; ++k) {
      float hv[2], wv[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) hv[a] = bits_to_float(hs[(ty + 16 * a) * hs_stride + k]);
#pragma unroll
      for (int c = 0; c < 2; ++c) wv[c] = bits_to_float(ws[k * ws_stride + tx + 16 * c]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) p[a][c] = fmaf(hv[a], wv[c], p[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty + 16 * a, row = row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cc = tx + 16 * c, col = col0 + cc;
        dps[r * dp_stride + cc] = (row < M && col < N)
            ? dpre(p[a][c] + b[col], x[(size_t)row * N + col], rw[row]) : 0.f;
      }
    }
    __syncthreads();

    if (t < W_BN)
      for (int r = 0; r < W_BM; ++r) db_acc += dps[r * dp_stride + t];
    for (int r = 0; r < W_BM; ++r) {
      float dv[4], hv[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dps[r * dp_stride + cg + 8 * i];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = kg + 32 * j;
        hv[j] = k < K ? bits_to_float(hs[r * hs_stride + k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(dv[i], hv[j], acc[i][j]);
    }
  }

  const float gv = g[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = col0 + cg + 8 * i;
    if (col >= N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = kg + 32 * j;
      if (k < K) dw[(size_t)col * K + k] = gv * acc[i][j];
    }
  }
  if (t < W_BN && col0 + t < N) db[col0 + t] = gv * db_acc;
}

bool bad_shape(int m, int k, int n) { return m < 1 || n < 1 || k < 1 || k > MAX_K; }

}  // namespace

// Shapes: h [M, K] bf16, w [N, K], b [N], x [M, N], rw [M] fp32, contiguous;
// partials [ceil(N/64) * ceil(M/64)] workspace; loss [1].
extern "C" int decode_mse_fwd_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                  const float* x, const float* rw, float* partials,
                                  float* loss, int m, int k, int n, cudaStream_t stream) {
  if (bad_shape(m, k, n)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + F_BN - 1) / F_BN, (m + F_BM - 1) / F_BM);
  fwd_tile_kernel<<<grid, THREADS, 0, stream>>>(h, w, b, x, rw, partials, m, k, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<1, THREADS, 0, stream>>>(partials, (int)(grid.x * grid.y), loss);
  return static_cast<int>(cudaGetLastError());
}

// As decode_mse_fwd_f32, with g [1] the cotangent; partials [n_ranges, M, K]
// workspace (1 <= n_ranges <= ceil(N/64)); dh [M, K] fp32, rounded to bf16
// before the scaling when round_dh is not 0.
extern "C" int decode_mse_bwd_dh_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                     const float* x, const float* rw, const float* g,
                                     float* partials, float* dh, int m, int k, int n,
                                     int n_ranges, int round_dh, cudaStream_t stream) {
  if (bad_shape(m, k, n) || n_ranges < 1 || n_ranges > (n + H_BN - 1) / H_BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dh_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + H_BM - 1) / H_BM, n_ranges);
  bwd_dh_kernel<<<grid, THREADS, smem, stream>>>(h, w, b, x, rw, partials, m, k, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t count = (size_t)m * k;
  dh_reduce_kernel<<<(unsigned)((count + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partials, n_ranges, count, g, round_dh, dh);
  return static_cast<int>(cudaGetLastError());
}

// As decode_mse_fwd_f32, with g [1] the cotangent; dw [N, K] and db [N] fp32.
extern "C" int decode_mse_bwd_dw_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                     const float* x, const float* rw, const float* g,
                                     float* dw, float* db, int m, int k, int n,
                                     cudaStream_t stream) {
  if (bad_shape(m, k, n)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dw_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = (unsigned)((n + W_BN - 1) / W_BN);
  bwd_dw_kernel<<<grid, THREADS, smem, stream>>>(h, w, b, x, rw, g, dw, db, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
