// IAF chain forward: all NT temporal transitions of the density-direction IAF in
// one launch.  Per transition, per MADE block, D sequential updates
//   y_i = (x_i - mu_i(y)) * exp(-clamp(s_i(y), -1.5, 1.5)),  ld -= clamp(s_i)
// then the dims are flipped; the flipped output feeds the next block, and the
// last block's output is the transition's z.
//
// Replaces the forward Pallas kernel of rlvae_tpu/ops/iaf_kernels.py:504-583
// (_build_fused_iaf_chain's fwd_pallas: _iaf_chain_fwd_kernel -> _transition_fwd_body
// -> _made_pass).  When `ys_out` is non-null it also writes that kernel's
// residual ys [NT, NB, B, D], each block's output before the flip, which is all
// the backward (csrc/iaf_chain_bwd.cu) reads; serving passes null.
//
// What bounds it on an H100: fp32 operations.  One MADE pass is
// [rows,D]x[D,H] (no activation), (NH-1) x ([rows,H]x[H,H] + ReLU), [rows,H]x[H,2D];
// at D=16, H=256, NH=3 that is 286 720 FLOP per row, and a row makes
// NT*NB*D = 224 passes, ~64 MFLOP per row.  The weights (~9.2 MB for NT=7) stay
// resident in the 50 MB L2 and are re-read from there on every pass.
//
// Design (right and simple; no tensor cores, fp32 IEEE so s feeding exp(-s) keeps
// full precision): one block of 256 threads owns ROWS rows for the whole chain,
// so the latent never leaves shared memory between transitions.  Activations
// ([ROWS,H]) ping-pong between two shared buffers; a thread owns one output
// column of a layer for all ROWS rows, reading each weight once from global
// memory (coalesced across the warp) and the activations as float4 broadcasts.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;        // latent rows per block
constexpr int THREADS = 256;
constexpr int MAX_D = 32;
constexpr int MAX_H = 256;
constexpr float LOG_VAR_CLAMP = 1.5f;

// dst[r, h] = relu(sum_k src[r, k] * w[k, h] + bias[h]) for r < ROWS, h < H.
__device__ __forceinline__ void dense_relu(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias, int H) {
  for (int h = threadIdx.x; h < H; h += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int k = 0; k < H; k += 4) {
      const float w0 = w[(size_t)(k + 0) * H + h];
      const float w1 = w[(size_t)(k + 1) * H + h];
      const float w2 = w[(size_t)(k + 2) * H + h];
      const float w3 = w[(size_t)(k + 3) * H + h];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(src + r * H + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
    const float bh = bias[h];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dst[r * H + h] = fmaxf(acc[r] + bh, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
iaf_chain_fwd_kernel(const float* __restrict__ z0, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ wh,
                     const float* __restrict__ bh, const float* __restrict__ wo,
                     const float* __restrict__ bo, float* __restrict__ z_out,
                     float* __restrict__ ld_out, float* __restrict__ ys_out, int B, int D,
                     int H, int NB, int NH, int NT) {
  __shared__ __align__(16) float act_a[ROWS * MAX_H];
  __shared__ __align__(16) float act_b[ROWS * MAX_H];
  __shared__ float x_s[ROWS * MAX_D];       // the current block's input
  __shared__ float y_s[ROWS * MAX_D];       // the current block's output, dim by dim
  __shared__ float out_s[ROWS * 2 * MAX_D]; // (mu, s_pre) of the last MADE pass
  __shared__ float ld_s[ROWS];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int D2 = 2 * D;

  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D;
    x_s[idx] = (row0 + r < B) ? z0[(size_t)(row0 + r) * D + idx % D] : 0.f;
  }

  for (int t = 0; t < NT; ++t) {
    if (tid < ROWS) ld_s[tid] = 0.f;
    for (int blk = 0; blk < NB; ++blk) {
      const size_t tb = (size_t)t * NB + blk;
      const float* W0 = w0 + tb * D * H;
      const float* B0 = b0 + tb * H;
      const float* WH = wh + tb * (NH - 1) * H * H;
      const float* BH = bh + tb * (NH - 1) * H;
      const float* WO = wo + tb * H * D2;
      const float* BO = bo + tb * D2;

      for (int idx = tid; idx < ROWS * D; idx += THREADS) y_s[idx] = 0.f;
      __syncthreads();

      for (int i = 0; i < D; ++i) {
        // layer 0, masked, no activation
        for (int h = tid; h < H; h += THREADS) {
          float acc[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
          for (int d = 0; d < D; ++d) {
            const float w = W0[(size_t)d * H + h];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(y_s[r * D + d], w, acc[r]);
          }
          const float bias = B0[h];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) act_a[r * H + h] = acc[r] + bias;
        }
        __syncthreads();

        float* src = act_a;
        float* dst = act_b;
        for (int l = 0; l < NH - 1; ++l) {
          dense_relu(src, dst, WH + (size_t)l * H * H, BH + (size_t)l * H, H);
          __syncthreads();
          float* tmp = src;
          src = dst;
          dst = tmp;
        }

        // output layer -> (mu, s_pre) for every row
        for (int o = tid; o < ROWS * D2; o += THREADS) {
          const int r = o / D2;
          const int c = o - r * D2;
          float acc = 0.f;
          for (int k = 0; k < H; ++k) acc = fmaf(src[r * H + k], WO[(size_t)k * D2 + c], acc);
          out_s[o] = acc + BO[c];
        }
        __syncthreads();

        if (tid < ROWS) {
          const float mu = out_s[tid * D2 + i];
          const float s = fminf(fmaxf(out_s[tid * D2 + D + i], -LOG_VAR_CLAMP), LOG_VAR_CLAMP);
          y_s[tid * D + i] = (x_s[tid * D + i] - mu) * expf(-s);
          ld_s[tid] -= s;
        }
        __syncthreads();
      }

      if (ys_out != nullptr) {  // the backward's residual: this block's unflipped output
        for (int idx = tid; idx < ROWS * D; idx += THREADS) {
          const int r = idx / D;
          if (row0 + r < B) ys_out[(tb * B + row0 + r) * D + idx % D] = y_s[idx];
        }
      }

      // dim flip: the next block (or transition) reads reversed y
      for (int idx = tid; idx < ROWS * D; idx += THREADS) {
        const int r = idx / D;
        x_s[idx] = y_s[r * D + (D - 1 - (idx - r * D))];
      }
      __syncthreads();
    }

    for (int idx = tid; idx < ROWS * D; idx += THREADS) {
      const int r = idx / D;
      if (row0 + r < B) z_out[((size_t)t * B + row0 + r) * D + idx % D] = x_s[idx];
    }
    if (tid < ROWS && row0 + tid < B) ld_out[(size_t)t * B + row0 + tid] = ld_s[tid];
    __syncthreads();
  }
}

}  // namespace

extern "C" int iaf_chain_fwd_f32(const float* z0, const float* w0, const float* b0,
                                 const float* wh, const float* bh, const float* wo,
                                 const float* bo, float* z_out, float* ld_out,
                                 float* ys_out, int B, int D, int H, int NB, int NH,
                                 int NT, cudaStream_t stream) {
  if (B <= 0 || NT <= 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > MAX_D || H < 4 || H > MAX_H || H % 4 != 0 || NB < 1 || NH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + ROWS - 1) / ROWS;
  iaf_chain_fwd_kernel<<<blocks, THREADS, 0, stream>>>(z0, w0, b0, wh, bh, wo, bo, z_out,
                                                        ld_out, ys_out, B, D, H, NB, NH,
                                                        NT);
  return static_cast<int>(cudaGetLastError());
}
