// IAF chain backward: the exact adjoint VJP of csrc/iaf_chain.cu, all NT temporal
// transitions in one launch.
//
// Replaces bwd_pallas of rlvae_tpu/ops/iaf_kernels.py:585 (pallas_call at :604),
// i.e. _iaf_chain_bwd_kernel with adj_sweeps = n_sweeps >= 1: D, the default
// that get_fused_iaf_chain resolves when fp_iters == 0, or K + 1 after the
// forward's K-iteration Jacobi mode (:493-496); its body is
// _transition_bwd_adjoint_body (:232-301); and with n_sweeps = 0 the sequential
// _transition_bwd_body (:172-229) that adj_sweeps = 0 selects (:375-380; JAX
// reaches it through ADJ_SWEEPS_OVERRIDE, :477-480).  Transitions run in reverse.  The
// cotangent of transition t's output is dz[t] plus what transition t+1 carried
// back; the final dim flip's adjoint comes first, then each MADE block in reverse:
//   1. one MADE pass at the block's output y (the forward's residual ys) gives the
//      activations, the ReLU gates, e = exp(-clamp(s_pre)) and the clamp gate
//      |s_pre| < 1.5;
//   2. n_sweeps Jacobi sweeps lam <- dy + J^T lam solve the block's adjoint
//      system, exactly at n_sweeps >= D: J^T lam backpropagates
//      dout = [-lam e, g_s (-lam y - dld)] through the output layer, the
//      ReLU-gated hidden layers and layer 0 (no weight gradients), and J^T is
//      strictly triangular (MADE output i sees only inputs < i), so it is
//      nilpotent of index <= D;
//   3. one more pass at lam writes the weight gradients (outer products);
//   4. dx = lam e is the cotangent of the block's input, flipped into the previous
//      block's output (or carried to transition t-1 after block 0).
//
// What bounds it on an H100: the chain of dependent steps, not the arithmetic
// (~76 MFLOP per row, 0.07 ms for B=64 at the fp32 peak).  Per MADE block: the
// recomputed pass, n_sweeps (D) sweeps and the final VJP, each NH+1 layer steps, and the
// flip: 14 x ((16 + 2) x 4 + 1) = 1022 dependent layer steps at D=16, NH=3,
// NT=7, NB=2; 14 x ((9 + 2) x 4 + 1) = 630 at the K=8 forward's 9 sweeps.
//
// Design: the forward's cluster geometry (iaf_cluster.cuh).  Layer 0 of the
// recomputed pass is whole in every CTA; each CTA keeps its column slices of
// the hidden layers, and the full [R,H] inputs of the hidden layers (gathered
// by st.async) for the weight gradients.  The transposed products:
//   dout @ WO^T: WO's row slice gives this CTA's own columns, no exchange;
//   (g . da) @ WH[l]^T for l >= 1: the gated cotangent's slices are gathered
//     into every CTA, then each CTA's row slice of WH[l] gives its own
//     columns (the second orientation of the slice is held, rather than
//     partials reduce-scattered in rank order);
//   the last two, @ WH[0]^T @ W0^T, as one product with M = W0 @ WH[0]
//     ([D,H], this CTA's columns computed once per block): each CTA's partial
//     over its columns, sent to every peer and added in rank order.
// So a sweep is two exchanges at NH=3 (NH-1 in general); the final VJP also
// gathers the last gated cotangent for dW0.  Weights: each CTA holds W0 and its
// column slices of WH (read by the recomputed pass and M only, then refilled
// with the next block's), its row slices of WH (refilled at the block's end)
// and WO's row slice (double-buffered), all by bulk copies.
// The sequential mode (n_sweeps = 0) is the exact VJP of the D-step update, one
// reverse step i = D-1 ... 0 at a time: the MADE pass recomputed at y masked to
// columns < i (layer0() over the first i columns), the output's columns i and
// D+i exchanged as the forward's (float2 partials in rank order), the update's
// VJP at column i (du = dy_i, dmu = -du e, ds = -du (x_i - mu_i) e - dld, gated
// by |s_pre| < 1.5), the hidden layers' VJP with the weight gradients as in the
// final VJP above, and dy[:, :i] += (da0 @ W0^T)[:, :i] from each CTA's column
// partial, added in rank order.  The block's input x (z0, or the previous
// block's output flipped, read from ys) is the one input the adjoint lacks.
// WO's gradient gets its columns i and D+i at step i; the others are added
// into the slot D times, each CTA read-modify-writing its own entries (the
// same thread every step: no atomics, no barrier).  Each hidden layer's outer
// product a^T g is taken by the product lanes, a lane's column of g held in
// registers and four rows of a read as one float4: the same sums in the same
// order as one element at a time, with a quarter of the shared-memory reads.
// That read-modify-write is still most of a reverse step (iaf_sweep
// --n-sweeps 0: 12.0 of 21.4 us at B=64 on an H100).  Bound at D=16, H=256,
// NH=3: 3 x (2 H^2 + 2 H + i H) MACs a row at step i (the pass, its VJP,
// the outer products over layer 0's first i columns and WO's columns i and
// D+i), 11.5 GFLOP at B=64, 0.171 ms at the fp32 peak; its chain is
// 14 x (16 x 8 + 1) = 1806 dependent layer steps, the adjoint's 1022.  The
// weights stay resident for the block's D steps, so the next block's are
// copied only after its last step.
//
// Weight gradients: each CTA writes the gradient of exactly the slices it owns
// (rank 0 also bo's), per cluster into a [n_clusters, NT, NB, ...] workspace
// that the caller sums in cluster order, as the TPU kernel writes per-tile
// partials that XLA sums (:647-648).  No atomics: the result does not depend on
// the order the clusters run in, and a relaunch gives the same bits.
#include "iaf_cluster.cuh"

namespace {

using namespace iaf;

struct BwdParams {
  CUtensorMap wh_map;  // as for the forward (resident)
  const float *ys, *dz, *dld, *z0, *w0, *b0, *wh, *bh, *wo, *bo;  // z0: the sequential mode only
  float *dz0, *gw0, *gb0, *gwh, *gbh, *gwo, *gbo;
  int B, D, H, NB, NH, NT;
  int n_sweeps;  // adjoint sweeps per block, >= 1; 0: the sequential mode
  Layout L;
  long long* prof;  // -DIAF_PROFILE: null, or BWD_PHASES clock64 sums (PhaseClock)
};

// The profile's phases (-DIAF_PROFILE): a block's start (0); the recomputed
// pass with M (1); per sweep dout @ WO^T + gate (2), the gather (3), the WH^T
// product + gate (4), the lam partial and its exchange (5), the lam update
// (6); the final VJP's weight-gradient writes (7); a block's end (8); and the
// whole kernel (9).  The sequential mode, per reverse step: the recomputed
// pass with its two output columns' exchange and the update's VJP (1); the
// dout @ WO^T product + gate (2), the gathers (3), the WH^T products + gates
// (4) and the weight-gradient outer products, WO's included (7); dy's
// partial and its exchange (5), and dy's update (6).
constexpr int BWD_PHASES = 10;

struct BwdSmem {
  int asz, osz, bsz, bias;
  int wa, wo, wb, bbuf, m, afull, last, gfull, red, gown, da0, part, y, e, gs, dy, lam, dx,
      dout, dld, xb, floats;
};

__host__ __device__ inline BwdSmem bwd_smem(int R, bool resident, const Layout& L, int D, int H,
                                            int NH) {
  BwdSmem s;
  s.asz = round32(D * H) + (NH - 1) * L.LS;  // W0 | WH column slices (128-byte aligned)
  s.osz = L.HC * L.WOS;                 // WO rows
  s.bsz = (NH - 1) * L.HC * L.WRS;      // WH row slices
  s.bias = bias_floats(D, H, NH, L.HC);
  int o = 0;
  s.wa = o;    o += resident ? s.asz : 0;
  s.wo = o;    o += resident ? 2 * s.osz : 0;
  s.wb = o;    o += resident ? s.bsz : 0;
  s.bbuf = o;  o += 2 * s.bias;
  s.m = o;     o += D * L.HC;
  s.afull = o; o += (NH > 1 ? NH - 1 : 1) * R * H;  // layers 0..NH-2, whole
  s.last = o;  o += R * L.HC;                       // layer NH-1, this CTA's columns
  s.gfull = o; o += NH > 1 ? 2 * R * H : 0;
  s.red = o;   o += THREADS * R;
  s.gown = o;  o += R * L.HC;
  s.da0 = o;   o += R * L.HC;
  s.part = o;  o += 2 * CLUSTER_CTAS * R * L.DP;
  s.y = o;     o += R * L.DP;
  s.e = o;     o += R * L.DP;
  s.gs = o;    o += R * L.DP;
  s.dy = o;    o += R * L.DP;
  s.lam = o;   o += R * L.DP;
  s.dx = o;    o += R * L.DP;
  s.dout = o;  o += R * L.D2P;
  s.dld = o;   o += round4(R);
  s.xb = o;    o += R * L.DP;  // the sequential mode's block input
  s.floats = o;
  return s;
}

inline size_t bwd_smem_bytes(int R, bool resident, const Layout& L, int D, int H, int NH) {
  return BAR_BYTES + sizeof(float) * (size_t)bwd_smem(R, resident, L, D, H, NH).floats;
}

// MADE block n's W0 (whole) and this CTA's column slice of each WH[l] (one
// tensor copy each) into wa, and its rows of WO into wo, on `bar`.  One
// whole warp.
__device__ __forceinline__ void issue_a(const BwdParams& p, int n, int col0, int ncols, float* wa,
                                        float* wo, uint64_t* bar) {
  const int D = p.D, H = p.H, NH = p.NH, HC = p.L.HC;
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive_expect_tx(bar, 4u * (uint32_t)(D * H + (NH - 1) * H * HC + ncols * 2 * D));
    bulk_g2s(wa, p.w0 + (size_t)n * D * H, 4u * (uint32_t)(D * H), bar);
    for (int l = 0; l < NH - 1; ++l)
      tma_load_2d(wa + round32(D * H) + l * p.L.LS, &p.wh_map, col0, (n * (NH - 1) + l) * H,
                  bar);
  }
  __syncwarp();
  if (ncols > 0)
    bulk_rows(wo, p.L.WOS, p.wo + ((size_t)n * H + col0) * 2 * D, 2 * D, ncols, 8u * D, bar);
}

// MADE block n's row slices of each WH[l] ([HC][WRS] per layer) into wb.
__device__ __forceinline__ void issue_b(const BwdParams& p, int n, int col0, int ncols, float* wb,
                                        uint64_t* bar) {
  const int H = p.H, NH = p.NH;
  if ((threadIdx.x & 31) == 0) mbar_arrive_expect_tx(bar, 4u * (uint32_t)((NH - 1) * ncols * H));
  __syncwarp();
  for (int l = 0; l < NH - 1 && ncols > 0; ++l)
    bulk_rows(wb + l * p.L.HC * p.L.WRS, p.L.WRS,
              p.wh + (((size_t)n * (NH - 1) + l) * H + col0) * H, H, ncols, 4u * H, bar);
}

template <int R, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    iaf_chain_bwd_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout& L = p.L;
  const int D = p.D, H = p.H, NH = p.NH, B = p.B, C = CLUSTER_CTAS, HC = L.HC, DP = L.DP;
  const int D2 = 2 * D;
  const int D2P = L.D2P;
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int cid = (int)(blockIdx.x / C);
  const int row0 = cid * R;
  const int col0 = rank * HC;
  const int ncols = max(0, min(HC, H - col0));
  const int c = tid % HC, kg = tid / HC;
  const bool col_active = c < ncols;
  const int lanes = HC / 4;
  const int qr = tid / lanes, qq = tid % lanes;
  const bool quad = tid < R * lanes;
  const bool quad_active = quad && 4 * qq < ncols;
  const int n_blocks = p.NT * p.NB;
  const bool seq = p.n_sweeps == 0;  // the sequential mode (_transition_bwd_body)

  const BwdSmem S = bwd_smem(R, RESIDENT, L, D, H, NH);
  uint64_t* abar = reinterpret_cast<uint64_t*>(smem_raw);  // weights A
  uint64_t* bbar = abar + 1;                               // weights B
  uint64_t* xbar = abar + 2;                               // recomputed activations [2]
  uint64_t* gbar = abar + 4;                               // gated cotangents [2]
  uint64_t* pbar = abar + 6;                               // partials [2]
  float* f = reinterpret_cast<float*>(smem_raw + BAR_BYTES);
  float* wa = f + S.wa;
  float* wob = f + S.wo;
  float* wb = f + S.wb;
  float* bbuf = f + S.bbuf;
  float* m_own = f + S.m;      // [D][HC]: M = W0 @ WH[0] (W0 when NH = 1), this CTA's columns
  float* afull = f + S.afull;  // [NH-1][R][H]: layers 0..NH-2, whole
  float* last = f + S.last;    // [R][HC]: layer NH-1, this CTA's columns
  float* gfull = f + S.gfull;  // [2][R][H]: a gated cotangent, gathered
  float* red = f + S.red;
  float* gown = f + S.gown;    // [R][HC]: a gated cotangent, this CTA's columns
  float* da0 = f + S.da0;      // [R][HC]: layer 0's cotangent, this CTA's columns
  float* part = f + S.part;    // [2][C][R][DP] partials over the cluster (seq: [2][C][R] float2)
  float* y_s = f + S.y;
  float* x_s = f + S.xb;       // seq: the block's input
  float* e_s = f + S.e;
  float* gs_s = f + S.gs;
  float* dy_s = f + S.dy;
  float* lam_s = f + S.lam;
  float* dx_s = f + S.dx;
  float* dout_s = f + S.dout;
  float* dld_s = f + S.dld;

  for (int idx = tid; idx < R * DP; idx += THREADS) dx_s[idx] = 0.f;
  if (tid == 0) {
    for (int k = 0; k < 8; ++k) mbar_init(&abar[k], 1);
    mbar_fence_init();
  }
  cluster.sync();

  // blocks run in reverse: step s handles block n = n_blocks-1-s
  if (RESIDENT && tid < 32) {
    issue_a(p, n_blocks - 1, col0, ncols, wa, wob, abar);
    issue_b(p, n_blocks - 1, col0, ncols, wb, bbar);
  }
  issue_biases(p.b0, p.bh, p.bo, n_blocks - 1, D, H, NH, HC, col0, ncols, bbuf);

  int ux = 0, ug = 0, up = 0;  // uses of the three exchange channels
  PhaseClock<BWD_PHASES> clk(p.prof);
  for (int s = 0; s < n_blocks; ++s) {
    const int n = n_blocks - 1 - s, t = n / p.NB, blk = n - t * p.NB;
    cp_async_wait_all();
    if (RESIDENT) mbar_wait(abar, s & 1);
    const float* W0 = RESIDENT ? wa : p.w0 + (size_t)n * D * H;
    const float* WHc =
        RESIDENT ? wa + round32(D * H) : p.wh + (size_t)n * (NH - 1) * H * H + col0;
    const float* WO = RESIDENT ? wob + (s & 1) * S.osz : p.wo + ((size_t)n * H + col0) * D2;
    const float* WHr = RESIDENT ? wb : p.wh + (size_t)n * (NH - 1) * H * H + (size_t)col0 * H;
    const int ws = RESIDENT ? L.HC : H;
    const size_t whc_layer = RESIDENT ? (size_t)L.LS : (size_t)H * H;
    const int wrs = RESIDENT ? L.WRS : H;
    const size_t whr_layer = RESIDENT ? (size_t)HC * L.WRS : (size_t)H * H;
    const int wos = RESIDENT ? L.WOS : D2;
    const float* bias = bbuf + (s & 1) * S.bias;
    const float* bo = bias + H + (NH - 1) * HC;
    const size_t slot = (size_t)cid * n_blocks + n;  // this cluster's partials of block n

    if (blk == p.NB - 1) {  // transition t's cotangent, then the adjoint of its final flip
      for (int idx = tid; idx < R * D; idx += THREADS) {
        const int r = idx / D, d = idx - r * D, j = D - 1 - d;
        dy_s[r * DP + d] = row0 + r < B
                               ? p.dz[((size_t)t * B + row0 + r) * D + j] + dx_s[r * DP + j]
                               : 0.f;
      }
      if (tid < R) dld_s[tid] = row0 + tid < B ? p.dld[(size_t)t * B + row0 + tid] : 0.f;
    }
    for (int idx = tid; idx < R * DP; idx += THREADS) {
      const int r = idx / DP, d = idx - r * DP;
      const bool in = row0 + r < B && d < D;
      y_s[idx] = in ? p.ys[((size_t)n * B + row0 + r) * D + d] : 0.f;
      // the block's input: z0 for the chain's first block, else the previous
      // block's output flipped (the previous transition's z at a block 0)
      if (seq)
        x_s[idx] = !in ? 0.f
                   : n == 0 ? p.z0[(size_t)(row0 + r) * D + d]
                            : p.ys[((size_t)(n - 1) * B + row0 + r) * D + (D - 1 - d)];
    }
    __syncthreads();
    clk.lap(0);

    // The MADE pass at y masked to its first d_in columns (all D in the
    // adjoint mode): layer 0 whole, the hidden layers' columns, their inputs
    // gathered whole; `last` holds layer NH-1's columns (layer 0's when
    // NH = 1).  Returns this quad's values of it.
    auto recompute = [&](int d_in) -> float4 {
      layer0<R>(y_s, DP, d_in, W0, bias, H, afull);
      __syncthreads();
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (NH == 1 && quad_active)
        v = *reinterpret_cast<const float4*>(afull + qr * H + col0 + 4 * qq);
      for (int l = 0; l < NH - 1; ++l) {
        float acc[R];
        dot_cols<R>(afull + l * R * H, H, WHc + l * whc_layer, ws, c, kg, L.KG, col_active, acc);
        store_groups<R>(acc, red, HC, c, kg);
        __syncthreads();
        if (quad_active) {
          v = reduce_quad<R>(red, L.KG, HC, qr, qq);
          const float* bl = bias + H + l * HC + 4 * qq;
          v = make_float4(fmaxf(v.x + bl[0], 0.f), fmaxf(v.y + bl[1], 0.f),
                          fmaxf(v.z + bl[2], 0.f), fmaxf(v.w + bl[3], 0.f));
        }
        if (l < NH - 2) {
          expect_bytes(xbar, ux, 4u * R * H);
          if (quad_active)
            send_v4(afull + (l + 1) * R * H + qr * H + col0 + 4 * qq, v, &xbar[ux & 1]);
          wait_bytes(xbar, ux);
          ++ux;
        }
      }
      if (quad) *reinterpret_cast<float4*>(last + qr * HC + 4 * qq) = v;
      __syncthreads();
      return v;
    };

    // From gown (the cotangent at layer NH-1's pre-activation, this CTA's
    // columns) down through the hidden layers to da0 (layer 0's).  With
    // `grads`, each layer's weight and bias gradients of this CTA's columns
    // go to the slot, added to what is there when `accumulate`; without,
    // it stops at layer 1's gated cotangent in gown (a sweep ends with M).
    auto vjp_hidden = [&](bool grads, bool accumulate) {
      for (int l = NH - 2; l >= 0; --l) {
        if (grads) {
          float* gwh = p.gwh + (slot * (NH - 1) + l) * H * H;
          const float* a_l = afull + l * R * H;
          // a_l^T gown: each product lane (column c, K-group kg) holds its
          // column of gown in registers and takes four rows k at a time
          // from a float4 of a_l (the same sums, in the same order, as one
          // element at a time)
          if (col_active) {
            float g_c[R];
#pragma unroll
            for (int r = 0; r < R; ++r) g_c[r] = gown[r * HC + c];
            for (int q = kg; q < H / 4; q += L.KG) {
              float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float4 a = *reinterpret_cast<const float4*>(a_l + r * H + 4 * q);
                o[0] = fmaf(a.x, g_c[r], o[0]);
                o[1] = fmaf(a.y, g_c[r], o[1]);
                o[2] = fmaf(a.z, g_c[r], o[2]);
                o[3] = fmaf(a.w, g_c[r], o[3]);
              }
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                float* g = gwh + (size_t)(4 * q + jj) * H + col0 + c;
                *g = accumulate ? *g + o[jj] : o[jj];
              }
            }
          }
          for (int cc = tid; cc < ncols; cc += THREADS) {
            float acc = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) acc += gown[r * HC + cc];
            float* g = p.gbh + (slot * (NH - 1) + l) * H + col0 + cc;
            *g = accumulate ? *g + acc : acc;
          }
          clk.lap(7);
        }
        if (l == 0 && !grads) break;
        float* g_all = gfull + (ug & 1) * R * H;
        expect_bytes(gbar, ug, 4u * R * H);
        if (quad_active)
          send_v4(g_all + qr * H + col0 + 4 * qq,
                  *reinterpret_cast<const float4*>(gown + qr * HC + 4 * qq), &gbar[ug & 1]);
        wait_bytes(gbar, ug);
        ++ug;
        clk.lap(3);
        // (g @ WH[l]^T)[:, own columns] from WH[l]'s row slice
        float acc[R];
        dot_rows<R>(g_all, H, WHr + l * whr_layer, wrs, c, kg, L.KG, col_active, acc);
        store_groups<R>(acc, red, HC, c, kg);
        __syncthreads();
        if (quad) {
          float4 da = make_float4(0.f, 0.f, 0.f, 0.f);
          if (quad_active) da = reduce_quad<R>(red, L.KG, HC, qr, qq);
          if (l > 0) {  // gate by layer l's ReLU
            const float* a = afull + l * R * H + qr * H + col0 + 4 * qq;
            if (quad_active)
              da = make_float4(a[0] > 0.f ? da.x : 0.f, a[1] > 0.f ? da.y : 0.f,
                               a[2] > 0.f ? da.z : 0.f, a[3] > 0.f ? da.w : 0.f);
            *reinterpret_cast<float4*>(gown + qr * HC + 4 * qq) = da;
          } else {
            *reinterpret_cast<float4*>(da0 + qr * HC + 4 * qq) = da;
          }
        }
        __syncthreads();
        clk.lap(4);
      }
    };

    // layer 0's weight and bias gradients of this CTA's columns from da0 and
    // y's first d_in columns (the rows past them are 0), into the slot
    auto grads0 = [&](int d_in, bool accumulate) {
      float* gw0 = p.gw0 + slot * D * H;
      for (int idx = tid; idx < D * ncols; idx += THREADS) {
        const int d = idx / ncols, cc = idx - d * ncols;
        float acc = 0.f;
        if (d < d_in) {
#pragma unroll
          for (int r = 0; r < R; ++r) acc = fmaf(y_s[r * DP + d], da0[r * HC + cc], acc);
        }
        float* g = gw0 + (size_t)d * H + col0 + cc;
        *g = accumulate ? *g + acc : acc;
      }
      for (int cc = tid; cc < ncols; cc += THREADS) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc += da0[r * HC + cc];
        float* g = p.gb0 + slot * H + col0 + cc;
        *g = accumulate ? *g + acc : acc;
      }
      clk.lap(7);
    };

    // g0 @ mat^T over this CTA's columns (g0 [R][HC], mat [D][..] at row
    // stride ms, rows < d_out; the others 0), sent to every peer; returns the
    // buffer of the C partials, [C][R][DP], to be added in rank order
    auto exchange_rows = [&](const float* g0, const float* mat, int ms, int d_out) -> float* {
      float* pb = part + (up & 1) * C * R * DP;
      expect_bytes(pbar, up, 4u * C * R * DP);
      // 8 lanes per (row, d), each over every 8th column, added by shuffles;
      // the sums staged in `red` [R][DP], then sent as float4s
      for (int base = 0; base < R * D * 8; base += THREADS) {
        const int t8 = base + tid, g = t8 & 7, rd = t8 >> 3;
        const int r = rd / D, d = rd - r * D;
        float o = 0.f;
        if (rd < R * D && d < d_out)
          for (int cc = g; cc < ncols; cc += 8) o = fmaf(g0[r * HC + cc], mat[d * ms + cc], o);
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
        if (rd < R * D && g == 0) red[r * DP + d] = o;
      }
      __syncthreads();
      const int q4 = DP / 4;
      if (tid < R * q4) {
        const int r = tid / q4, j4 = tid - r * q4;
        float o[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) o[jj] = 4 * j4 + jj < D ? red[r * DP + 4 * j4 + jj] : 0.f;
        send_v4(pb + (rank * R + r) * DP + 4 * j4, make_float4(o[0], o[1], o[2], o[3]),
                &pbar[up & 1]);
      }
      wait_bytes(pbar, up);
      ++up;
      return pb;
    };
    auto rank_sum = [&](const float* pb, int r, int d) {
      float sum = pb[r * DP + d];
      for (int q = 1; q < C; ++q) sum += pb[(q * R + r) * DP + d];
      return sum;
    };

    if (seq) {
      // _transition_bwd_body: D reverse steps i = D-1 ... 0, each the MADE
      // pass at y masked to columns < i, the update's VJP at column i, and
      // the weight gradients added into the slot
      if (RESIDENT) mbar_wait(bbar, s & 1);
      for (int i = D - 1; i >= 0; --i) {
        const float4 v = recompute(i);
        // output columns i (mu) and D+i (s): this CTA's K-slice partial,
        // summed over the row's lanes by shuffles and sent to every peer
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
        for (int off = 1; off < lanes; off <<= 1) {
          pm += __shfl_xor_sync(0xffffffffu, pm, off);
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        }
        // the float2s at the start of this use's half of the buffer
        float2* pb2 = reinterpret_cast<float2*>(part + (up & 1) * C * R * DP);
        expect_bytes(pbar, up, 8u * C * R);
        if (quad) send_v2(pb2 + rank * R + qr, make_float2(pm, ps), &pbar[up & 1], qq, lanes);
        wait_bytes(pbar, up);
        ++up;
        // per row: u = (x_i - mu) e, du = dy_i, dmu = -du e, ds = -du u - dld,
        // gated by |s_pre| < 1.5; du and e kept for dx_i = du e at the block's end
        if (tid < R) {
          float2 sum = pb2[tid];
          for (int q = 1; q < C; ++q) {
            const float2 o = pb2[q * R + tid];
            sum.x += o.x;
            sum.y += o.y;
          }
          const float mu = sum.x + bo[i], s_pre = sum.y + bo[D + i];
          const float e = expf(-fminf(fmaxf(s_pre, -LOG_VAR_CLAMP), LOG_VAR_CLAMP));
          const float u = (x_s[tid * DP + i] - mu) * e;
          const float du = dy_s[tid * DP + i];
          const float ds = -du * u - dld_s[tid];
          lam_s[tid * DP + i] = du;
          e_s[tid * DP + i] = e;
          dout_s[tid * D2P] = -du * e;
          dout_s[tid * D2P + 1] = fabsf(s_pre) < LOG_VAR_CLAMP ? ds : 0.f;
        }
        __syncthreads();
        clk.lap(1);
        // WO's gradient at columns i and D+i (written once each over the
        // steps), this CTA's rows; rank 0 also bo's
        float* gwo = p.gwo + slot * H * D2;
        for (int cc = tid; cc < ncols; cc += THREADS) {
          float am = 0.f, as = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            am = fmaf(last[r * HC + cc], dout_s[r * D2P], am);
            as = fmaf(last[r * HC + cc], dout_s[r * D2P + 1], as);
          }
          gwo[(size_t)(col0 + cc) * D2 + i] = am;
          gwo[(size_t)(col0 + cc) * D2 + D + i] = as;
        }
        if (rank == 0 && tid < 2) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) acc += dout_s[r * D2P + tid];
          p.gbo[slot * D2 + tid * D + i] = acc;
        }
        clk.lap(7);
        // dout @ WO^T: two columns of WO's row slice
        if (tid < R * HC) {
          const int r = tid / HC, cc = tid - r * HC;
          float acc = 0.f;
          if (cc < ncols) {
            const float* wrow = WO + (size_t)cc * wos;
            acc = fmaf(dout_s[r * D2P + 1], wrow[D + i], dout_s[r * D2P] * wrow[i]);
          }
          if (NH == 1)
            da0[tid] = acc;
          else
            gown[tid] = last[tid] > 0.f ? acc : 0.f;
        }
        __syncthreads();
        clk.lap(2);
        vjp_hidden(true, i < D - 1);
        grads0(i, i < D - 1);
        // dy[:, :i] += (da0 @ W0^T)[:, :i]
        if (i > 0) {
          const float* pb = exchange_rows(da0, W0 + col0, H, i);
          clk.lap(5);
          if (tid < R * D) {
            const int r = tid / D, d = tid - r * D;
            if (d < i) dy_s[r * DP + d] += rank_sum(pb, r, d);
          }
          __syncthreads();
          clk.lap(6);
        }
      }
    } else {
      // 1. the MADE pass at y
      recompute(D);
      // s_pre = (out layer)[:, D:]: this CTA's K-slice partials, added in rank order
      const int q4 = DP / 4;
      float* pb = part + (up & 1) * C * R * DP;
      expect_bytes(pbar, up, 4u * C * R * DP);
      if (tid < R * q4) {
        const int r = tid / q4, j4 = tid - r * q4;
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        for (int jj = 0; jj < 4; ++jj) {
          const int i = 4 * j4 + jj;
          if (i >= D) break;
          for (int cc = 0; cc < ncols; ++cc)
            o[jj] = fmaf(last[r * HC + cc], WO[(size_t)cc * wos + D + i], o[jj]);
        }
        send_v4(pb + (rank * R + r) * DP + 4 * j4, make_float4(o[0], o[1], o[2], o[3]),
                &pbar[up & 1]);
      }
      // M = W0 @ WH[0] (W0 itself when NH = 1), this CTA's columns
      for (int idx = tid; idx < D * HC; idx += THREADS) {
        const int d = idx / HC, cc = idx - d * HC;
        float acc = 0.f;
        if (cc < ncols) {
          if (NH == 1) {
            acc = W0[(size_t)d * H + col0 + cc];
          } else {
            for (int h = 0; h < H; ++h)
              acc = fmaf(W0[(size_t)d * H + h], WHc[(size_t)h * ws + cc], acc);
          }
        }
        m_own[idx] = acc;
      }
      wait_bytes(pbar, up);
      ++up;
      if (tid < R * D) {
        const int r = tid / D, i = tid - r * D;
        const float s_pre = rank_sum(pb, r, i) + bo[D + i];
        const float sc = fminf(fmaxf(s_pre, -LOG_VAR_CLAMP), LOG_VAR_CLAMP);
        const float e = expf(-sc), gsv = fabsf(s_pre) < LOG_VAR_CLAMP ? 1.f : 0.f;
        const float lam = dy_s[r * DP + i];
        e_s[r * DP + i] = e;
        gs_s[r * DP + i] = gsv;
        lam_s[r * DP + i] = lam;
        dout_s[r * D2P + i] = -lam * e;
        dout_s[r * D2P + D + i] = gsv * (-lam * y_s[r * DP + i] - dld_s[r]);
      }
      __syncthreads();  // W0 and WH's column slices are no longer read in this block
      if (s + 1 < n_blocks) {
        if (RESIDENT && tid < 32) {
          fence_proxy_async();
          issue_a(p, n - 1, col0, ncols, wa, wob + ((s + 1) & 1) * S.osz, abar);
        }
        issue_biases(p.b0, p.bh, p.bo, n - 1, D, H, NH, HC, col0, ncols,
                     bbuf + ((s + 1) & 1) * S.bias);
      }
      if (RESIDENT) mbar_wait(bbar, s & 1);
      clk.lap(1);

      // 2. n_sweeps adjoint sweeps, then 3. one more pass that writes the weight
      // gradients
      for (int sweep = 0; sweep <= p.n_sweeps; ++sweep) {
        const bool grads = sweep == p.n_sweeps;
        if (grads) {
          float* gwo = p.gwo + slot * H * D2;
          for (int idx = tid; idx < ncols * D2; idx += THREADS) {
            const int cc = idx / D2, j = idx - cc * D2;
            float acc = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) acc = fmaf(last[r * HC + cc], dout_s[r * D2P + j], acc);
            gwo[(size_t)(col0 + cc) * D2 + j] = acc;
          }
          if (rank == 0) {
            for (int j = tid; j < D2; j += THREADS) {
              float acc = 0.f;
#pragma unroll
              for (int r = 0; r < R; ++r) acc += dout_s[r * D2P + j];
              p.gbo[slot * D2 + j] = acc;
            }
          }
          clk.lap(7);
        }
        // dout @ WO^T: this CTA's columns of the last hidden layer's cotangent,
        // gated (or layer 0's cotangent when NH = 1)
        if (tid < R * HC) {
          const int r = tid / HC, cc = tid - r * HC;
          float acc = 0.f;
          if (cc < ncols) {
            const float* wrow = WO + (size_t)cc * wos;
            const float* drow = dout_s + r * D2P;
            float a4[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, added at the end
            int j = 0;
            if ((D2 & 3) == 0) {  // both rows 16-byte aligned: float4 loads
              for (; j < D2; j += 4) {
                const float4 dv = *reinterpret_cast<const float4*>(drow + j);
                const float4 wv = *reinterpret_cast<const float4*>(wrow + j);
                a4[0] = fmaf(dv.x, wv.x, a4[0]);
                a4[1] = fmaf(dv.y, wv.y, a4[1]);
                a4[2] = fmaf(dv.z, wv.z, a4[2]);
                a4[3] = fmaf(dv.w, wv.w, a4[3]);
              }
            }
            for (; j < D2; ++j) a4[j & 3] = fmaf(drow[j], wrow[j], a4[j & 3]);
            acc = (a4[0] + a4[1]) + (a4[2] + a4[3]);
          }
          if (NH == 1)
            da0[tid] = acc;
          else
            gown[tid] = last[tid] > 0.f ? acc : 0.f;
        }
        __syncthreads();
        clk.lap(2);
        vjp_hidden(grads, false);
        if (grads) {
          grads0(D, false);
        } else {
          // lam = dy + (layer 1's gated cotangent) M^T: this CTA's partial,
          // added in rank order
          pb = exchange_rows(NH == 1 ? da0 : gown, m_own, HC, D);
          clk.lap(5);
          if (tid < R * D) {
            const int r = tid / D, d = tid - r * D;
            const float lam = dy_s[r * DP + d] + rank_sum(pb, r, d);
            lam_s[r * DP + d] = lam;
            dout_s[r * D2P + d] = -lam * e_s[r * DP + d];
            dout_s[r * D2P + D + d] = gs_s[r * DP + d] * (-lam * y_s[r * DP + d] - dld_s[r]);
          }
          __syncthreads();
          clk.lap(6);
        }
      }
    }

    // 4. the cotangent of the block's input, dx = lam e (seq: dx_i = du_i e_i):
    // flipped into the previous block's output, or, after block 0, carried to
    // transition t-1
    if (tid < R * D) {
      const int r = tid / D, i = tid - r * D;
      const float dx = lam_s[r * DP + i] * e_s[r * DP + i];
      if (blk > 0)
        dy_s[r * DP + (D - 1 - i)] = dx;
      else
        dx_s[r * DP + i] = dx;
    }
    __syncthreads();  // WH's row slices (seq: all of the block's weights) are no longer read
    if (s + 1 < n_blocks) {
      if (RESIDENT && tid < 32) {
        fence_proxy_async();
        if (seq) issue_a(p, n - 1, col0, ncols, wa, wob + ((s + 1) & 1) * S.osz, abar);
        issue_b(p, n - 1, col0, ncols, wb, bbar);
      }
      if (seq)
        issue_biases(p.b0, p.bh, p.bo, n - 1, D, H, NH, HC, col0, ncols,
                     bbuf + ((s + 1) & 1) * S.bias);
    }
    clk.lap(8);
  }

  if (rank == 0) {
    for (int idx = tid; idx < R * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D;
      if (row0 + r < B) p.dz0[(size_t)(row0 + r) * D + d] = dx_s[r * DP + d];
    }
  }
  cluster.sync();  // no CTA leaves while a peer could still address its memory
  clk.finish();
}

using BwdKernel = void (*)(BwdParams);

BwdKernel bwd_kernel(int R, bool resident) {
  switch (R) {
    case 1: return resident ? iaf_chain_bwd_kernel<1, true> : iaf_chain_bwd_kernel<1, false>;
    case 2: return resident ? iaf_chain_bwd_kernel<2, true> : iaf_chain_bwd_kernel<2, false>;
    case 4: return resident ? iaf_chain_bwd_kernel<4, true> : iaf_chain_bwd_kernel<4, false>;
    case 8: return resident ? iaf_chain_bwd_kernel<8, true> : iaf_chain_bwd_kernel<8, false>;
    default: return nullptr;
  }
}

bool bwd_resident(int R, const Layout& L, int D, int H, int NH) {
  return D % 2 == 0 && bwd_smem_bytes(R, true, L, D, H, NH) <= (size_t)max_optin_smem();
}

bool valid_shape(int D, int H, int NB, int NH) {
  return D >= 1 && D <= MAX_D && H >= 4 && H <= MAX_H && H % 4 == 0 && NB >= 1 && NH >= 1 &&
         NH <= MAX_NH;
}

// The backward at R rows per cluster; stream_weights forces the streamed
// instantiation; prof as BwdParams::prof.
cudaError_t launch_bwd(BwdParams p, int R, bool stream_weights, cudaStream_t stream) {
  if (p.n_sweeps < 0 || (p.n_sweeps == 0 && p.z0 == nullptr)) return cudaErrorInvalidValue;
  if (p.B <= 0 || p.NT <= 0) return cudaSuccess;
  if (!valid_shape(p.D, p.H, p.NB, p.NH) || bwd_kernel(R, true) == nullptr)
    return cudaErrorInvalidValue;
  p.L = make_layout(p.D, p.H);
  const bool resident = !stream_weights && bwd_resident(R, p.L, p.D, p.H, p.NH);
  if (resident && p.NH > 1) {
    const cudaError_t err = encode_wh_map(&p.wh_map, p.wh, p.H,
                                          (long long)p.NT * p.NB * (p.NH - 1) * p.H, p.L.HC);
    if (err != cudaSuccess) return err;
  }
  return launch_clusters(bwd_kernel(R, resident), p, (p.B + R - 1) / R,
                         bwd_smem_bytes(R, resident, p.L, p.D, p.H, p.NH), stream);
}

}  // namespace

// The entries' shared arguments as BwdParams.
#define BWD_PARAMS                                                                              \
  BwdParams {                                                                                   \
    {}, ys, dz, dld, z0, w0, b0, wh, bh, wo, bo, dz0, gw0, gb0, gwh, gbh, gwo, gbo, B, D, H, NB, \
        NH, NT, n_sweeps, {}, nullptr                                                           \
  }

// Shapes (all fp32, contiguous): ys [NT, NB, B, D], dz [NT, B, D], dld [NT, B], the
// weights as for iaf_chain_fwd_f32; out dz0 [B, D] and the per-cluster partials
// gw0 [NCL, NT, NB, D, H], gb0 [NCL, NT, NB, H], gwh [NCL, NT, NB, NH-1, H, H],
// gbh [NCL, NT, NB, NH-1, H], gwo [NCL, NT, NB, H, 2D], gbo [NCL, NT, NB, 2D] with
// NCL = n_clusters = ceil(B / R) under the rule (an error otherwise); n_sweeps
// adjoint sweeps per block (>= 1; D is exact), or 0 for the sequential mode,
// which also reads z0 [B, D], the chain's input (null otherwise).
extern "C" int iaf_chain_bwd_f32(const float* ys, const float* dz, const float* dld,
                                 const float* z0, const float* w0, const float* b0, const float* wh,
                                 const float* bh, const float* wo, const float* bo,
                                 float* dz0, float* gw0, float* gb0, float* gwh, float* gbh,
                                 float* gwo, float* gbo, int B, int D, int H, int NB, int NH,
                                 int NT, int n_sweeps, int n_clusters, cudaStream_t stream) {
  const int R = cluster_rows(B);
  if (B > 0 && n_clusters != (B + R - 1) / R) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bwd(BWD_PARAMS, R, false, stream));
}

// As iaf_chain_bwd_f32 at a given R (NCL = ceil(B / R)) and, with
// stream_weights != 0, in the streamed instantiation (iaf_chain_fwd_at_f32).
extern "C" int iaf_chain_bwd_at_f32(const float* ys, const float* dz, const float* dld,
                                    const float* z0, const float* w0, const float* b0,
                                    const float* wh, const float* bh, const float* wo,
                                    const float* bo, float* dz0, float* gw0, float* gb0, float* gwh,
                                    float* gbh, float* gwo, float* gbo, int B, int D, int H,
                                    int NB, int NH, int NT, int n_sweeps, int R,
                                    int stream_weights, cudaStream_t stream) {
  return static_cast<int>(launch_bwd(BWD_PARAMS, R, stream_weights != 0, stream));
}

#ifdef IAF_PROFILE
// As iaf_chain_bwd_f32 (NCL by the rule), with prof receiving BWD_PHASES
// clock64 sums.
extern "C" int iaf_chain_bwd_profile_f32(const float* ys, const float* dz, const float* dld,
                                         const float* z0, const float* w0, const float* b0,
                                         const float* wh, const float* bh, const float* wo,
                                         const float* bo, float* dz0, float* gw0, float* gb0,
                                         float* gwh, float* gbh, float* gwo, float* gbo, int B,
                                         int D, int H, int NB, int NH, int NT, int n_sweeps,
                                         long long* prof, cudaStream_t stream) {
  BwdParams p = BWD_PARAMS;
  p.prof = prof;
  return static_cast<int>(launch_bwd(p, cluster_rows(B), false, stream));
}
#endif

// As iaf_chain_fwd_geometry, for the backward.
extern "C" int iaf_chain_bwd_geometry(int B, int D, int H, int NH, int* out) {
  if (B <= 0 || !valid_shape(D, H, 1, NH)) return static_cast<int>(cudaErrorInvalidValue);
  const int R = cluster_rows(B);
  const Layout L = make_layout(D, H);
  const bool resident = bwd_resident(R, L, D, H, NH);
  const size_t smem = bwd_smem_bytes(R, resident, L, D, H, NH);
  int active = 0;
  const cudaError_t err =
      max_active_clusters(reinterpret_cast<const void*>(bwd_kernel(R, resident)), smem, &active);
  out[0] = R;
  out[1] = CLUSTER_CTAS;
  out[2] = (B + R - 1) / R;
  out[3] = (int)smem;
  out[4] = resident ? 1 : 0;
  out[5] = active;
  return static_cast<int>(err);
}
