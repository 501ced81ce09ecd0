// IAF chain forward: all NT temporal transitions of the density-direction IAF in
// one launch.  Per transition, per MADE block, D sequential updates
//   y_i = (x_i - mu_i(y)) * exp(-clamp(s_i(y), -1.5, 1.5)),  ld -= clamp(s_i)
// then the dims are flipped; the flipped output feeds the next block, and the
// last block's output is the transition's z.  With K > 0 (fp_iters) each block
// is instead solved by Jacobi fixed-point iteration: K full MADE passes
//   y <- (x - mu(y)) * exp(-clamp(s(y)))  from y = 0,
// then one more whose clamped s gives ld -= sum_i s_i (exact at K >= D - 1).
//
// Replaces the forward Pallas kernel of rlvae_tpu/ops/iaf_kernels.py:504-583
// (_build_fused_iaf_chain's fwd_pallas at :555: _iaf_chain_fwd_kernel ->
// _transition_fwd_body, both modes (:125-170) -> _made_pass).  When `ys_out` is non-null it also writes that kernel's
// residual ys [NT, NB, B, D], each block's output before the flip, which is all
// the backward (csrc/iaf_chain_bwd.cu) reads; serving passes null.
//
// What bounds it on an H100: not the arithmetic (one MADE pass is 286 720 FLOP
// per row at D=16, H=256, NH=3; 224 passes are ~64 MFLOP per row, 0.06 ms for
// B=64 at the fp32 peak) but the chain of dependent steps: NT*NB*D = 224
// sequential MADE passes of NH+1 = 4 layers each, 896 layer steps whose
// latency adds up whatever the batch.  In the Jacobi mode a block takes K+1
// passes instead of D: at K=8, 14 x (9 x 4 + 1) = 518 dependent layer steps.
//
// Design (see iaf_cluster.cuh): a cluster of C=8 CTAs owns R rows for the whole
// chain, so each layer step is spread over 8 SMs, and each CTA keeps its
// column slice of the current MADE block's weights resident in shared memory,
// filled by tensor-map and bulk copies one block ahead.  Per MADE pass:
//   layer 0 (y @ W0 + b0, no activation): whole, in every CTA; it starts at
//     b0 and, since a pass changes only y's column i, follows y by one FMA
//     per entry;
//   each hidden layer: this CTA's HC columns, the product over K=H split over
//     256 threads (HC column lanes x KG K-groups), the groups added in order,
//     + bias, ReLU, each row's 4-column quads sent to every peer with st.async
//     (except the last hidden layer, which stays local);
//   output layer: pass i needs only columns i and D+i; the last hidden layer's
//     quads give this CTA's K-slice partial for them, summed over the row's
//     lanes by shuffles and sent to every peer; every CTA adds the C partials
//     in rank order and applies the same update to its own copy of y and ld.
// Two exchanges per pass at NH=3 (NH-1 in general), each a wait on a local
// mbarrier.
// The Jacobi mode (K > 0) cannot use either shortcut of a sequential pass:
// every column of y changes each pass, so layer 0 is the full [R,D]x[D,H]
// product (layer0(), whole in every CTA), and every output column is needed,
// so each CTA's K-slice partial of all 2D columns is sent to every peer
// ([2][C][R][D2P] floats instead of [2][C][R] float2s; iaf_chain_fwd_geometry
// reports the shared memory) and added in rank order.  The update is Jacobi,
// not Gauss-Seidel, with one y buffer: a pass reads y only in layer 0, which is
// finished (a barrier) before any thread writes the next iterate.  The latent, ld and ys never leave shared memory between
// transitions; rank 0 writes the outputs.  fp32 FMAs and expf: no tensor
// cores, no TF32 (s feeds exp(-s)).  No atomics: a relaunch gives the same bits.
#include "iaf_cluster.cuh"

namespace {

using namespace iaf;

struct FwdParams {
  CUtensorMap wh_map;  // wh as [NT*NB*(NH-1)*H][H], boxes of one column slice (resident)
  const float *z0, *w0, *b0, *wh, *bh, *wo, *bo;
  float *z, *ld, *ys;
  int B, D, H, NB, NH, NT;
  int K;  // Jacobi iterations per block; 0: the sequential update
  Layout L;
  long long* prof;  // -DIAF_PROFILE: null, or FWD_PHASES clock64 sums (PhaseClock)
};

// The profile's phases (-DIAF_PROFILE): a block's start, with the weights'
// wait (0); layer 0's update (the Jacobi mode: its whole product) + barrier
// (1); per hidden layer the product + barrier (2) and its exchange (3); the
// output partial and its exchange (4); the y update + barrier (5); a block's
// end: residual, flip, outputs (6); and the whole kernel (7).
constexpr int FWD_PHASES = 8;

// Shared-memory carve-up, in floats after BAR_BYTES of mbarriers.
struct FwdSmem {
  int wsz, bsz;
  int wbuf, bbuf, act0, xa, red, part, last, sc, x, y, ld, floats;
};

// `jacobi`: the K > 0 mode's larger partials and its two staging buffers.
__host__ __device__ inline FwdSmem fwd_smem(int R, bool resident, const Layout& L, int D, int H,
                                            int NH, bool jacobi) {
  FwdSmem s;
  // W0 | WH column slices (128-byte aligned) | WO rows [HC][2D]
  s.wsz = round32(round32(D * H) + (NH - 1) * L.LS + L.HC * 2 * D);
  s.bsz = bias_floats(D, H, NH, L.HC);
  int o = 0;
  s.wbuf = o; o += resident ? 2 * s.wsz : 0;
  s.bbuf = o; o += 2 * s.bsz;
  s.act0 = o; o += R * H;                  // layer 0, whole
  s.xa = o;   o += NH > 2 ? 2 * R * H : 0;  // exchanged hidden layers, whole
  s.red = o;  o += THREADS * R;
  // [2][C][R] float2 partials, or (jacobi) [2][C][R][D2P] of all 2D columns
  s.part = o; o += 2 * CLUSTER_CTAS * R * (jacobi ? L.D2P : 2);
  s.last = o; o += jacobi ? R * L.HC : 0;  // the last hidden layer, this CTA's columns
  s.sc = o;   o += jacobi ? R * L.DP : 0;  // the final pass's clamped s
  s.x = o;    o += R * L.DP;
  s.y = o;    o += R * L.DP;
  s.ld = o;   o += round4(R);
  s.floats = o;
  return s;
}

inline size_t fwd_smem_bytes(int R, bool resident, const Layout& L, int D, int H, int NH,
                             bool jacobi) {
  return BAR_BYTES + sizeof(float) * (size_t)fwd_smem(R, resident, L, D, H, NH, jacobi).floats;
}

// MADE block n's weights into dst: W0 whole [D][H], this CTA's column slice of
// each WH[l] [H][HC] at stride LS (one tensor copy each) and its rows of WO
// [HC][2D], on
// `bar`.  One thread.
__device__ __forceinline__ void issue_weights(const FwdParams& p, int n, int col0, int ncols,
                                              float* dst, uint64_t* bar) {
  const int D = p.D, H = p.H, NH = p.NH, HC = p.L.HC;
  mbar_arrive_expect_tx(bar, 4u * (uint32_t)(D * H + (NH - 1) * H * HC + ncols * 2 * D));
  bulk_g2s(dst, p.w0 + (size_t)n * D * H, 4u * (uint32_t)(D * H), bar);
  float* wh_s = dst + round32(D * H);
  for (int l = 0; l < NH - 1; ++l)
    tma_load_2d(wh_s + l * p.L.LS, &p.wh_map, col0, (n * (NH - 1) + l) * H, bar);
  if (ncols > 0)
    bulk_g2s(wh_s + (NH - 1) * p.L.LS, p.wo + ((size_t)n * H + col0) * 2 * D,
             8u * (uint32_t)(ncols * D), bar);
}

template <int R, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    iaf_chain_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout& L = p.L;
  const int D = p.D, H = p.H, NH = p.NH, B = p.B, C = CLUSTER_CTAS, HC = L.HC, DP = L.DP;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / C) * R;
  const int col0 = rank * HC;
  const int ncols = max(0, min(HC, H - col0));
  const int c = tid % HC, kg = tid / HC;  // a product's column lane and K-group
  const bool col_active = c < ncols;
  const int lanes = HC / 4;               // quads (4 columns) per row
  const int qr = tid / lanes, qq = tid % lanes;
  const bool quad = tid < R * lanes;       // thread (row qr, quad qq) of a layer's output
  const bool quad_active = quad && 4 * qq < ncols;

  const int K = p.K, D2 = 2 * D, D2P = L.D2P;
  const FwdSmem S = fwd_smem(R, RESIDENT, L, D, H, NH, K > 0);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* abar = wbar + 2;
  uint64_t* pbar = wbar + 4;
  float* f = reinterpret_cast<float*>(smem_raw + BAR_BYTES);
  float* wbuf = f + S.wbuf;
  float* bbuf = f + S.bbuf;
  float* act0 = f + S.act0;
  float* xa = f + S.xa;
  float* red = f + S.red;
  float2* part = reinterpret_cast<float2*>(f + S.part);
  float* part_j = f + S.part;  // the Jacobi mode's [2][C][R][D2P] partials
  float* last = f + S.last;
  float* sc_s = f + S.sc;
  float* x_s = f + S.x;
  float* y_s = f + S.y;
  float* ld_s = f + S.ld;

  for (int idx = tid; idx < R * DP; idx += THREADS) {
    const int r = idx / DP, d = idx - r * DP;
    x_s[idx] = (row0 + r < B && d < D) ? p.z0[(size_t)(row0 + r) * D + d] : 0.f;
    y_s[idx] = 0.f;
  }
  if (tid < R) ld_s[tid] = 0.f;
  if (tid == 0) {
    for (int k = 0; k < 6; ++k) mbar_init(&wbar[k], 1);
    mbar_fence_init();
  }
  cluster.sync();  // every CTA of the cluster runs, and its mbarriers are set

  const int n_blocks = p.NT * p.NB;
  if (RESIDENT && tid == 0) issue_weights(p, 0, col0, ncols, wbuf, &wbar[0]);
  issue_biases(p.b0, p.bh, p.bo, 0, D, H, NH, HC, col0, ncols, bbuf);

  int ua = 0, up = 0;  // uses of the activation and partial channels
  PhaseClock<FWD_PHASES> clk(p.prof);
  for (int n = 0; n < n_blocks; ++n) {
    const int t = n / p.NB, blk = n - t * p.NB;
    clk.lap(6);
    cp_async_wait_all();
    if (RESIDENT) mbar_wait(&wbar[n & 1], (n >> 1) & 1);
    __syncthreads();  // block n's weights have landed; block n-1's buffers are free
    if (n + 1 < n_blocks) {
      if (RESIDENT && tid == 0) {
        fence_proxy_async();
        issue_weights(p, n + 1, col0, ncols, wbuf + ((n + 1) & 1) * S.wsz, &wbar[(n + 1) & 1]);
      }
      issue_biases(p.b0, p.bh, p.bo, n + 1, D, H, NH, HC, col0, ncols,
                   bbuf + ((n + 1) & 1) * S.bsz);
    }
    // this block's weights: resident, or in global memory
    const float* wb = wbuf + (n & 1) * S.wsz;
    const float* W0 = RESIDENT ? wb : p.w0 + (size_t)n * D * H;
    const float* WH =
        RESIDENT ? wb + round32(D * H) : p.wh + (size_t)n * (NH - 1) * H * H + col0;
    const float* WO = RESIDENT ? wb + round32(D * H) + (NH - 1) * L.LS
                               : p.wo + ((size_t)n * H + col0) * 2 * D;
    const int ws = RESIDENT ? L.HC : H;
    const size_t wh_layer = RESIDENT ? (size_t)L.LS : (size_t)H * H;
    const int wos = 2 * D;
    const float* bias = bbuf + (n & 1) * S.bsz;  // b0 [H] | bh[l] at H + l*HC | bo
    const float* bo = bias + H + (NH - 1) * HC;

    // NH-1 hidden layers from act0 (layer 0, whole): this quad's values of the
    // last layer before the output (layer 0's own when NH = 1: no ReLU there)
    auto hidden = [&]() -> float4 {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (NH == 1 && quad_active)
        v = *reinterpret_cast<const float4*>(act0 + qr * H + col0 + 4 * qq);
      const float* src = act0;
      for (int l = 0; l < NH - 1; ++l) {
        float acc[R];
        dot_cols<R>(src, H, WH + l * wh_layer, ws, c, kg, L.KG, col_active, acc);
        store_groups<R>(acc, red, HC, c, kg);
        __syncthreads();
        clk.lap(2);
        if (quad_active) {
          v = reduce_quad<R>(red, L.KG, HC, qr, qq);
          const float* bl = bias + H + l * HC + 4 * qq;
          v = make_float4(fmaxf(v.x + bl[0], 0.f), fmaxf(v.y + bl[1], 0.f),
                          fmaxf(v.z + bl[2], 0.f), fmaxf(v.w + bl[3], 0.f));
        }
        if (l < NH - 2) {  // to every peer's copy of the whole layer
          float* dst = xa + (ua & 1) * R * H;
          expect_bytes(abar, ua, 4u * R * H);
          if (quad_active) send_v4(dst + qr * H + col0 + 4 * qq, v, &abar[ua & 1]);
          wait_bytes(abar, ua);
          ++ua;
          src = dst;
          clk.lap(3);
        }
      }
      return v;
    };

    if (K > 0) {
      // Jacobi: K passes from y = 0, then the final one, which also gives ld
      for (int pass = 0; pass <= K; ++pass) {
        layer0<R>(y_s, DP, D, W0, bias, H, act0);
        __syncthreads();  // y is not read again in this pass
        clk.lap(1);
        const float4 v = hidden();
        if (quad) *reinterpret_cast<float4*>(last + qr * HC + 4 * qq) = v;
        __syncthreads();
        // output layer, all 2D columns: this CTA's K-slice partial, to every peer
        float* pb = part_j + (up & 1) * C * R * D2P;
        expect_bytes(pbar, up, 4u * C * R * D2P);
        const int q4 = D2P / 4;
        if (tid < R * q4) {
          const int r = tid / q4, j0 = 4 * (tid - r * q4);
          float o[4] = {0.f, 0.f, 0.f, 0.f};
          for (int cc = 0; cc < ncols; ++cc) {
            const float a = last[r * HC + cc];
            const float* wrow = WO + (size_t)cc * wos;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (j0 + jj < D2) o[jj] = fmaf(a, wrow[j0 + jj], o[jj]);
          }
          send_v4(pb + (rank * R + r) * D2P + j0, make_float4(o[0], o[1], o[2], o[3]),
                  &pbar[up & 1]);
        }
        wait_bytes(pbar, up);
        ++up;
        clk.lap(4);
        if (tid < R * D) {  // every CTA: the C partials in rank order, the same update
          const int r = tid / D, j = tid - r * D;
          float mu = pb[r * D2P + j], sp = pb[r * D2P + D + j];
          for (int q = 1; q < C; ++q) {
            mu += pb[(q * R + r) * D2P + j];
            sp += pb[(q * R + r) * D2P + D + j];
          }
          mu += bo[j];
          const float sc = fminf(fmaxf(sp + bo[D + j], -LOG_VAR_CLAMP), LOG_VAR_CLAMP);
          y_s[r * DP + j] = (x_s[r * DP + j] - mu) * expf(-sc);
          if (pass == K) sc_s[r * DP + j] = sc;
        }
        __syncthreads();
        clk.lap(5);
      }
      if (tid < R) {  // ld -= sum_i s_i of the final pass, in column order
        float acc = 0.f;
        for (int j = 0; j < D; ++j) acc += sc_s[tid * DP + j];
        ld_s[tid] -= acc;
      }
    } else {
      // layer 0 at y = 0 is b0; after each pass only y's column i changes, so
      // layer 0 follows it with one FMA per entry: a0 = b0 + sum_{d<i} y_d W0[d]
      if (tid < H) {
#pragma unroll
        for (int r = 0; r < R; ++r) act0[r * H + tid] = bias[tid];
      }
      __syncthreads();
      clk.lap(0);
      for (int i = 0; i < D; ++i) {
        const float4 v = hidden();
        // output layer, columns i (mu) and D+i (s): this CTA's K-slice partial
        float pm = 0.f, ps = 0.f;
        if (quad_active) {
          const float* wo_q = WO + (size_t)(4 * qq) * wos;
          pm = fmaf(v.x, wo_q[i], pm);
          pm = fmaf(v.y, wo_q[wos + i], pm);
          pm = fmaf(v.z, wo_q[2 * wos + i], pm);
          pm = fmaf(v.w, wo_q[3 * wos + i], pm);
          ps = fmaf(v.x, wo_q[D + i], ps);
          ps = fmaf(v.y, wo_q[wos + D + i], ps);
          ps = fmaf(v.z, wo_q[2 * wos + D + i], ps);
          ps = fmaf(v.w, wo_q[3 * wos + D + i], ps);
        }
        for (int off = 1; off < lanes; off <<= 1) {  // the row's lanes, same bits in each
          pm += __shfl_xor_sync(0xffffffffu, pm, off);
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        }
        float2* pb = part + (up & 1) * C * R;
        expect_bytes(pbar, up, 8u * C * R);
        if (quad) send_v2(pb + rank * R + qr, make_float2(pm, ps), &pbar[up & 1], qq, lanes);
        wait_bytes(pbar, up);
        ++up;
        clk.lap(4);
        if (tid < R) {
          float2 s = pb[tid];
          for (int q = 1; q < C; ++q) {
            const float2 o = pb[q * R + tid];
            s.x += o.x;
            s.y += o.y;
          }
          const float mu = s.x + bo[i];
          const float sc = fminf(fmaxf(s.y + bo[D + i], -LOG_VAR_CLAMP), LOG_VAR_CLAMP);
          y_s[tid * DP + i] = (x_s[tid * DP + i] - mu) * expf(-sc);
          ld_s[tid] -= sc;
        }
        __syncthreads();
        clk.lap(5);
        if (i + 1 < D) {
          if (tid < H) {
            const float w = W0[(size_t)i * H + tid];
#pragma unroll
            for (int r = 0; r < R; ++r)
              act0[r * H + tid] = fmaf(y_s[r * DP + i], w, act0[r * H + tid]);
          }
          __syncthreads();
          clk.lap(1);
        }
      }
    }

    if (p.ys != nullptr && rank == 0) {  // the backward's residual: the unflipped output
      for (int idx = tid; idx < R * D; idx += THREADS) {
        const int r = idx / D, d = idx - r * D;
        if (row0 + r < B) p.ys[((size_t)n * B + row0 + r) * D + d] = y_s[r * DP + d];
      }
    }
    // dim flip: the next block (or transition) reads reversed y
    for (int idx = tid; idx < R * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      x_s[r * DP + d] = y_s[r * DP + (D - 1 - d)];
    }
    __syncthreads();
    for (int idx = tid; idx < R * DP; idx += THREADS) y_s[idx] = 0.f;
    if (blk == p.NB - 1) {
      if (rank == 0) {
        for (int idx = tid; idx < R * D; idx += THREADS) {
          const int r = idx / D, d = idx - r * D;
          if (row0 + r < B) p.z[((size_t)t * B + row0 + r) * D + d] = x_s[r * DP + d];
        }
        if (tid < R && row0 + tid < B) p.ld[(size_t)t * B + row0 + tid] = ld_s[tid];
      }
      __syncthreads();
      if (tid < R) ld_s[tid] = 0.f;
    }
  }
  cluster.sync();  // no CTA leaves while a peer could still address its memory
  clk.finish();
}

using FwdKernel = void (*)(FwdParams);

FwdKernel fwd_kernel(int R, bool resident) {
  switch (R) {
    case 1: return resident ? iaf_chain_fwd_kernel<1, true> : iaf_chain_fwd_kernel<1, false>;
    case 2: return resident ? iaf_chain_fwd_kernel<2, true> : iaf_chain_fwd_kernel<2, false>;
    case 4: return resident ? iaf_chain_fwd_kernel<4, true> : iaf_chain_fwd_kernel<4, false>;
    case 8: return resident ? iaf_chain_fwd_kernel<8, true> : iaf_chain_fwd_kernel<8, false>;
    default: return nullptr;
  }
}

// The weights are resident where two MADE blocks' fit in the CTA's shared
// memory and every WO row is a whole number of 16-byte units (D even).
bool fwd_resident(int R, const Layout& L, int D, int H, int NH, bool jacobi) {
  return D % 2 == 0 &&
         fwd_smem_bytes(R, true, L, D, H, NH, jacobi) <= (size_t)max_optin_smem();
}

bool valid_shape(int D, int H, int NB, int NH) {
  return D >= 1 && D <= MAX_D && H >= 4 && H <= MAX_H && H % 4 == 0 && NB >= 1 && NH >= 1;
}

// The forward at R rows per cluster; stream_weights forces the streamed
// instantiation; prof as FwdParams::prof.
cudaError_t launch_fwd(FwdParams p, int R, bool stream_weights, cudaStream_t stream) {
  if (p.K < 0) return cudaErrorInvalidValue;
  if (p.B <= 0 || p.NT <= 0) return cudaSuccess;
  if (!valid_shape(p.D, p.H, p.NB, p.NH) || fwd_kernel(R, true) == nullptr)
    return cudaErrorInvalidValue;
  p.L = make_layout(p.D, p.H);
  const bool jacobi = p.K > 0;
  const bool resident = !stream_weights && fwd_resident(R, p.L, p.D, p.H, p.NH, jacobi);
  if (resident && p.NH > 1) {
    const cudaError_t err = encode_wh_map(&p.wh_map, p.wh, p.H,
                                          (long long)p.NT * p.NB * (p.NH - 1) * p.H, p.L.HC);
    if (err != cudaSuccess) return err;
  }
  return launch_clusters(fwd_kernel(R, resident), p, (p.B + R - 1) / R,
                         fwd_smem_bytes(R, resident, p.L, p.D, p.H, p.NH, jacobi), stream);
}

}  // namespace

// The entries' shared arguments as FwdParams.
#define FWD_PARAMS \
  FwdParams {                                                                               \
    {}, z0, w0, b0, wh, bh, wo, bo, z_out, ld_out, ys_out, B, D, H, NB, NH, NT, K, {}, nullptr \
  }

// K: Jacobi iterations per block (0: the sequential update).
extern "C" int iaf_chain_fwd_f32(const float* z0, const float* w0, const float* b0,
                                 const float* wh, const float* bh, const float* wo,
                                 const float* bo, float* z_out, float* ld_out,
                                 float* ys_out, int B, int D, int H, int NB, int NH,
                                 int NT, int K, cudaStream_t stream) {
  return static_cast<int>(launch_fwd(FWD_PARAMS, cluster_rows(B), false, stream));
}

// As iaf_chain_fwd_f32 at a given R (1, 2, 4 or 8) rather than the rule's, and
// with stream_weights != 0 the streamed instantiation: every instantiation
// the rule can pick, held to the plain version by the checks.
extern "C" int iaf_chain_fwd_at_f32(const float* z0, const float* w0, const float* b0,
                                    const float* wh, const float* bh, const float* wo,
                                    const float* bo, float* z_out, float* ld_out,
                                    float* ys_out, int B, int D, int H, int NB, int NH,
                                    int NT, int K, int R, int stream_weights,
                                    cudaStream_t stream) {
  return static_cast<int>(launch_fwd(FWD_PARAMS, R, stream_weights != 0, stream));
}

#ifdef IAF_PROFILE
// As iaf_chain_fwd_f32, with prof receiving FWD_PHASES clock64 sums.
extern "C" int iaf_chain_fwd_profile_f32(const float* z0, const float* w0, const float* b0,
                                         const float* wh, const float* bh, const float* wo,
                                         const float* bo, float* z_out, float* ld_out,
                                         float* ys_out, int B, int D, int H, int NB, int NH,
                                         int NT, int K, long long* prof, cudaStream_t stream) {
  FwdParams p = FWD_PARAMS;
  p.prof = prof;
  return static_cast<int>(launch_fwd(p, cluster_rows(B), false, stream));
}
#endif

// out[0..5] = R, C, clusters, dynamic shared memory per CTA (bytes), weights
// resident (1/0), and clusters of this shape the card holds at once: the
// forward's geometry at (B, D, H, NH) and K Jacobi iterations (0: the
// sequential mode) under the fixed rule.
extern "C" int iaf_chain_fwd_geometry(int B, int D, int H, int NH, int K, int* out) {
  if (B <= 0 || K < 0 || !valid_shape(D, H, 1, NH))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = cluster_rows(B);
  const Layout L = make_layout(D, H);
  const bool resident = fwd_resident(R, L, D, H, NH, K > 0);
  const size_t smem = fwd_smem_bytes(R, resident, L, D, H, NH, K > 0);
  int active = 0;
  const cudaError_t err =
      max_active_clusters(reinterpret_cast<const void*>(fwd_kernel(R, resident)), smem, &active);
  out[0] = R;
  out[1] = CLUSTER_CTAS;
  out[2] = (B + R - 1) / R;
  out[3] = (int)smem;
  out[4] = resident ? 1 : 0;
  out[5] = active;
  return static_cast<int>(err);
}
