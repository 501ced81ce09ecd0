// IAF chain backward: the exact adjoint VJP of csrc/iaf_chain.cu, all NT temporal
// transitions in one launch.
//
// Replaces bwd_pallas of rlvae_tpu/ops/iaf_kernels.py:585 (pallas_call at :604),
// i.e. _iaf_chain_bwd_kernel with adj_sweeps = D, the default that
// get_fused_iaf_chain resolves when fp_iters == 0; its body is
// _transition_bwd_adjoint_body (:232-301).  Transitions run in reverse.  The
// cotangent of transition t's output is dz[t] plus what transition t+1 carried
// back; the final dim flip's adjoint comes first, then each MADE block in reverse:
//   1. one MADE pass at the block's output y (the forward's residual ys) gives the
//      activations, the ReLU gates, e = exp(-clamp(s_pre)) and the clamp gate
//      |s_pre| < 1.5;
//   2. D Jacobi sweeps lam <- dy + J^T lam solve the block's adjoint system
//      exactly: J^T lam backpropagates dout = [-lam e, g_s (-lam y - dld)] through
//      the output layer, the ReLU-gated hidden layers and layer 0 (no weight
//      gradients), and J^T is strictly triangular (MADE output i sees only inputs
//      < i), so it is nilpotent of index <= D;
//   3. one more pass at lam writes the weight gradients (outer products);
//   4. dx = lam e is the cotangent of the block's input, flipped into the previous
//      block's output (or carried to transition t-1 after block 0).
// Weight gradients are written per block of ROWS rows into partials
// [n_row_blocks, NT, NB, ...] that the caller sums (torch .sum(0)), as the TPU
// kernel writes per-tile partials that XLA sums (:647-648).  Blocks never share an
// accumulator, so the result does not depend on the order they run in.
//
// What bounds it on an H100: fp32 operations.  Per block and transition a row
// costs about (1 + D + 2) MADE-pass equivalents (the pass, D sweeps, the final
// VJP with its outer products); one pass is 286 720 FLOP at D=16, H=256, NH=3, so
// a row of the 7-transition, 2-block chain costs ~19 x 286 720 x 14 ~ 76 MFLOP.
//
// Design (right and simple, like the forward kernel): one block of 256 threads
// owns ROWS rows for the whole reversed chain; the cotangent carry, lam and every
// activation of the pass stay in shared memory; weights are read from L2 on every
// product; fp32 FMAs, no tensor cores (e = exp(-s) and the clamp gate need full
// fp32 s).  A transposed product (cotangent times W^T) gives each thread one output
// and reads that output's weight row with float4 loads; the W0^T product, with only
// D outputs, gives each warp one output and reduces over lanes with shuffles.  Like
// the forward, the kernel is bound by the latency of its long chain of dependent
// layer steps (14 block-transitions x (D + 2) passes), not by the card's
// arithmetic rate.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;  // latent rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 32;
constexpr int MAX_H = 256;
constexpr int MAX_NH = 16;
constexpr float LOG_VAR_CLAMP = 1.5f;

// dst[r, n] = act(sum_k src[r, k] * w[k, n] + bias[n]) for r < ROWS, n < N.
template <bool RELU>
__device__ __forceinline__ void dense(const float* __restrict__ src, float* __restrict__ dst,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias, int K, int N) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = w[(size_t)k * N + n];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(src[r * K + k], wk, acc[r]);
    }
    const float b = bias[n];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = acc[r] + b;
      dst[r * N + n] = RELU ? fmaxf(v, 0.f) : v;
    }
  }
}

// dst[r, n] = sum_j src[r, j] * w[n, j] for r < ROWS, n < N: the cotangent of a
// layer's input from that of its output (w is the layer's [N, J] weight).
__device__ __forceinline__ void dense_t(const float* __restrict__ src, float* __restrict__ dst,
                                        const float* __restrict__ w, int J, int N) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    const float* wn = w + (size_t)n * J;
    if ((J & 3) == 0) {
      for (int j = 0; j < J; j += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wn + j);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(src + r * J + j);
          acc[r] = fmaf(a.x, wv.x, acc[r]);
          acc[r] = fmaf(a.y, wv.y, acc[r]);
          acc[r] = fmaf(a.z, wv.z, acc[r]);
          acc[r] = fmaf(a.w, wv.w, acc[r]);
        }
      }
    } else {
      for (int j = 0; j < J; ++j) {
        const float wj = wn[j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(src[r * J + j], wj, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dst[r * N + n] = acc[r];
  }
}

// gw[k, n] = sum_r a[r, k] * g[r, n] and gb[n] = sum_r g[r, n]: one block's share
// of a layer's weight and bias gradients, written (not accumulated) to its slot.
__device__ __forceinline__ void outer(const float* __restrict__ a, const float* __restrict__ g,
                                      float* __restrict__ gw, float* __restrict__ gb, int K,
                                      int N) {
  for (int idx = threadIdx.x; idx < K * N; idx += THREADS) {
    const int k = idx / N;
    const int n = idx - k * N;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc = fmaf(a[r * K + k], g[r * N + n], acc);
    gw[idx] = acc;
  }
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc += g[r * N + n];
    gb[n] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
iaf_chain_bwd_kernel(const float* __restrict__ ys, const float* __restrict__ dz,
                     const float* __restrict__ dld, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ wh,
                     const float* __restrict__ bh, const float* __restrict__ wo,
                     const float* __restrict__ bo, float* __restrict__ dz0,
                     float* __restrict__ gw0, float* __restrict__ gb0,
                     float* __restrict__ gwh, float* __restrict__ gbh,
                     float* __restrict__ gwo, float* __restrict__ gbo, int B, int D, int H,
                     int NB, int NH, int NT) {
  extern __shared__ __align__(16) float smem[];
  float* acts = smem;                                // [NH][ROWS][H]: the MADE pass at y
  float* buf_a = acts + (size_t)NH * ROWS * H;       // [ROWS][H]: a layer's cotangent
  float* buf_b = buf_a + ROWS * H;                   // [ROWS][H]
  __shared__ float y_s[ROWS * MAX_D];                // the block's output (residual)
  __shared__ float e_s[ROWS * MAX_D];                // exp(-clamp(s_pre))
  __shared__ float gs_s[ROWS * MAX_D];               // 1 where |s_pre| < 1.5, else 0
  __shared__ float dy_s[ROWS * MAX_D];               // cotangent of the block's output
  __shared__ float lam_s[ROWS * MAX_D];              // the adjoint iterate
  __shared__ float dx_s[ROWS * MAX_D];               // cotangent of the transition's input
  __shared__ __align__(16) float dout_s[ROWS * 2 * MAX_D];  // (mu, s_pre), then dout
  __shared__ float dld_s[ROWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int D2 = 2 * D;
  const size_t slot0 = (size_t)blockIdx.x * NT * NB;  // this block's partials

  for (int idx = tid; idx < ROWS * D; idx += THREADS) dx_s[idx] = 0.f;
  __syncthreads();

  for (int t = NT - 1; t >= 0; --t) {
    // the cotangent of transition t's output, then the adjoint of its final flip
    for (int idx = tid; idx < ROWS * D; idx += THREADS) {
      const int r = idx / D;
      const int j = D - 1 - (idx - r * D);
      dy_s[idx] = (row0 + r < B) ? dz[((size_t)t * B + row0 + r) * D + j] + dx_s[r * D + j]
                                 : 0.f;
    }
    if (tid < ROWS) dld_s[tid] = (row0 + tid < B) ? dld[(size_t)t * B + row0 + tid] : 0.f;

    for (int blk = NB - 1; blk >= 0; --blk) {
      const size_t tb = (size_t)t * NB + blk;
      const size_t slot = slot0 + tb;
      const float* W0 = w0 + tb * D * H;
      const float* B0 = b0 + tb * H;
      const float* WH = wh + tb * (NH - 1) * H * H;
      const float* BH = bh + tb * (NH - 1) * H;
      const float* WO = wo + tb * H * D2;
      const float* BO = bo + tb * D2;

      for (int idx = tid; idx < ROWS * D; idx += THREADS) {
        const int r = idx / D;
        y_s[idx] = (row0 + r < B) ? ys[(tb * B + row0 + r) * D + idx - r * D] : 0.f;
      }
      __syncthreads();

      // 1. the MADE pass at y, keeping every layer's activation
      dense<false>(y_s, acts, W0, B0, D, H);  // layer 0: no activation
      __syncthreads();
      for (int l = 0; l < NH - 1; ++l) {
        dense<true>(acts + (size_t)l * ROWS * H, acts + (size_t)(l + 1) * ROWS * H,
                    WH + (size_t)l * H * H, BH + (size_t)l * H, H, H);
        __syncthreads();
      }
      dense<false>(acts + (size_t)(NH - 1) * ROWS * H, dout_s, WO, BO, H, D2);
      __syncthreads();
      for (int idx = tid; idx < ROWS * D; idx += THREADS) {
        const int r = idx / D;
        const float s_pre = dout_s[r * D2 + D + idx - r * D];
        const float s = fminf(fmaxf(s_pre, -LOG_VAR_CLAMP), LOG_VAR_CLAMP);
        e_s[idx] = expf(-s);
        gs_s[idx] = fabsf(s_pre) < LOG_VAR_CLAMP ? 1.f : 0.f;
        lam_s[idx] = dy_s[idx];
      }
      __syncthreads();

      // 2. D adjoint sweeps, then 3. one more pass that writes the weight gradients
      for (int sweep = 0; sweep <= D; ++sweep) {
        const bool grads = sweep == D;
        for (int idx = tid; idx < ROWS * D2; idx += THREADS) {
          const int r = idx / D2;
          const int c = idx - r * D2;
          const int i = c < D ? c : c - D;
          const float lam = lam_s[r * D + i];
          dout_s[idx] = c < D ? -lam * e_s[r * D + i]
                              : gs_s[r * D + i] * (-lam * y_s[r * D + i] - dld_s[r]);
        }
        __syncthreads();
        if (grads)
          outer(acts + (size_t)(NH - 1) * ROWS * H, dout_s, gwo + slot * H * D2,
                gbo + slot * D2, H, D2);
        dense_t(dout_s, buf_a, WO, D2, H);
        __syncthreads();
        float* da = buf_a;
        float* nxt = buf_b;
        for (int l = NH - 2; l >= 0; --l) {
          const float* act = acts + (size_t)(l + 1) * ROWS * H;
          for (int idx = tid; idx < ROWS * H; idx += THREADS)
            da[idx] = act[idx] > 0.f ? da[idx] : 0.f;  // ReLU gate
          __syncthreads();
          if (grads)
            outer(acts + (size_t)l * ROWS * H, da, gwh + (slot * (NH - 1) + l) * H * H,
                  gbh + (slot * (NH - 1) + l) * H, H, H);
          dense_t(da, nxt, WH + (size_t)l * H * H, H, H);
          __syncthreads();
          float* tmp = da;
          da = nxt;
          nxt = tmp;
        }
        if (grads) {
          outer(y_s, da, gw0 + slot * D * H, gb0 + slot * H, D, H);
        } else {
          // lam = dy + da W0^T: one warp per latent dim, lanes over the hidden units
          for (int d = warp; d < D; d += WARPS) {
            float acc[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
            for (int h = lane; h < H; h += 32) {
              const float wv = W0[(size_t)d * H + h];
#pragma unroll
              for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(da[r * H + h], wv, acc[r]);
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
            }
            if (lane == 0) {
#pragma unroll
              for (int r = 0; r < ROWS; ++r) lam_s[r * D + d] = dy_s[r * D + d] + acc[r];
            }
          }
        }
        __syncthreads();
      }

      // 4. the cotangent of the block's input: flipped into the previous block's
      // output, or, after block 0, carried to transition t-1
      for (int idx = tid; idx < ROWS * D; idx += THREADS) {
        const int r = idx / D;
        const int i = idx - r * D;
        const float dx = lam_s[idx] * e_s[idx];
        if (blk > 0)
          dy_s[r * D + (D - 1 - i)] = dx;
        else
          dx_s[idx] = dx;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D;
    if (row0 + r < B) dz0[(size_t)(row0 + r) * D + idx - r * D] = dx_s[idx];
  }
}

}  // namespace

// Shapes (all fp32, contiguous): ys [NT, NB, B, D], dz [NT, B, D], dld [NT, B], the
// weights as for iaf_chain_fwd_f32; out dz0 [B, D] and the partials
// gw0 [RB, NT, NB, D, H], gb0 [RB, NT, NB, H], gwh [RB, NT, NB, NH-1, H, H],
// gbh [RB, NT, NB, NH-1, H], gwo [RB, NT, NB, H, 2D], gbo [RB, NT, NB, 2D] with
// RB = ceil(B / 8) row blocks.
extern "C" int iaf_chain_bwd_f32(const float* ys, const float* dz, const float* dld,
                                 const float* w0, const float* b0, const float* wh,
                                 const float* bh, const float* wo, const float* bo,
                                 float* dz0, float* gw0, float* gb0, float* gwh, float* gbh,
                                 float* gwo, float* gbo, int B, int D, int H, int NB, int NH,
                                 int NT, cudaStream_t stream) {
  if (B <= 0 || NT <= 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > MAX_D || H < 4 || H > MAX_H || H % 4 != 0 || NB < 1 || NH < 1 ||
      NH > MAX_NH)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(NH + 2) * ROWS * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      iaf_chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + ROWS - 1) / ROWS;
  iaf_chain_bwd_kernel<<<blocks, THREADS, smem, stream>>>(
      ys, dz, dld, w0, b0, wh, bh, wo, bo, dz0, gw0, gb0, gwh, gbh, gwo, gbo, B, D, H, NB,
      NH, NT);
  return static_cast<int>(cudaGetLastError());
}
