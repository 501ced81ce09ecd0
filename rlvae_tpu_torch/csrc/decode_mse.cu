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
// the products rounded to bf16 (round to nearest even) with fp32 accumulation,
// the sigmoid, residual and sums are fp32, and the backward recomputes each
// tile's pre-activation and forms dp = bf16(rw * 2 * d * s * (1 - s)) before
// both of its products: dh = dp W (fp32, then rounded to bf16 when h is bf16)
// and dW = dp^T h, db = sum_m dp, each scaled by the cotangent g.
//
// What bounds it on an H100: at the fast preset's training shape (M = B*8 =
// 128, K = 512, N = 12288) each product is 1.6 GFLOP, 1.6 us on the bf16
// tensor cores, while W (25.2 MB as fp32) and x (6.3 MB) take 9.4 us to read
// at 3.35 TB/s: the bytes bound every entry point up to M of a few thousand.
// So the design reads W once per launch, does every product on the tensor
// cores and keeps every intermediate on chip:
// - A CTA owns a range of whole 8-column blocks of N (at most 96 or 112
//   columns; one CTA per SM, 128 or 112 of them at N = 12288) and keeps its
//   rows of W in shared memory as bf16 for the whole launch while it walks
//   its row tiles of h.  W's fp32 rows arrive by bulk copies (the copy
//   engine keeps two 32 KB slots in flight; the threads' own loads reached
//   about half of HBM's rate) and are rounded to bf16 from there; each CTA
//   stages its own rows, so W crosses device memory once.  h tiles (bf16,
//   L2-resident) arrive by cp.async.
// - Products are mma.sync.m16n8k16 bf16 -> fp32 with fragments from ldmatrix
//   on XOR-swizzled tiles (conflict-free); the second products take the dp
//   tile from shared memory, and W and h transposed by ldmatrix.trans.  The
//   tensor cores truncate their fp32 sums, so each 32-deep chunk of the
//   pre-activation is summed from zero and added to the running fp32 sum
//   with rounding: dp's bf16 rounding then flips about as rarely as after a
//   plain fp32 sum.
// - x, b and rw of a thread's outputs are loaded a tile ahead (into
//   registers; dW, whose accumulators fill its registers, stages them in
//   shared memory with the h tile), so their latency hides behind the
//   products.
// - forward: one loss partial per CTA, added in a fixed order by a second
//   kernel.
// - dh: each CTA's [32, K] partial (its columns' share of dp W) is summed in
//   rank order through distributed shared memory inside a cluster of up to 8
//   CTAs; one partial per cluster reaches a fixed-order second pass, or, when
//   one cluster covers N, the cluster writes dh itself.
// - dW/db: a CTA walks all of M and accumulates dW[its columns, K] in
//   registers (12 warps, 128 accumulators a thread) and db in a fixed
//   order; each is written once.
// No floating-point atomics and no sum whose order depends on scheduling, so
// a relaunch and a CUDA-graph replay give the same bits.  Ragged M, N and any
// 1 <= K <= 512 (K is zero-padded to a multiple of 64 in shared memory; W by
// the threads' loads when K % 4 != 0); a row with rw = 0 contributes exactly
// 0 to the loss and to every gradient.  fp32 IEEE arithmetic in the
// epilogues (expf, IEEE division; no fast math).
//
// The launch geometry (CTAs, row groups, the dh cluster size) is the caller's:
// rlvae_tpu_torch/ops/recon_kernels.py:decode_geometry, validated here.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace decode {  // named, so that -Xptxas -v lines of these kernels carry "6decode"
namespace {

constexpr int MAX_K = 512;
constexpr int KQ = 64;  // K is zero-padded to a multiple of KQ in shared memory
constexpr int MAX_CLUSTER = 8;

// forward: 64-row tiles, 8 warps (2 along M x 4 along N, 32 x 24 each),
// at most 12 8-column blocks (96 columns) a CTA
constexpr int F_THREADS = 256, F_BM = 64, F_N8 = 12;
// dh: 32-row tiles, 8 warps (pre 2 x 4, 16 x 24-32 each; dp W 32 x K/8 each),
// at most 14 blocks (112 columns) a CTA
constexpr int H_THREADS = 256, H_BM = 32, H_N8 = 14;
constexpr int H_DPS = H_N8 * 8 + 8;  // dp tile row stride (bf16), conflict-free
// dW/db: 32-row tiles, 12 warps (pre 2 x 6, 16 x 16 each; dp^T h 3 x 4,
// 32 columns x K/4 each), at most 12 blocks (96 columns) a CTA
constexpr int W_THREADS = 384, W_BM = 32, W_N8 = 12;
constexpr int W_DPS = W_N8 * 8 + 8;

// The profile's phases (-DDECODE_PROFILE), laps of thread 0 of CTA 0: W
// staged into shared memory; waits for an h tile; the pre-activation
// product; the epilogue (sigmoid, residual, dp); the second product (dp W or
// dp^T h); dh's wait for its cluster's shares and its rank-ordered sum; the
// stores; the whole kernel.
enum Phase {
  W_STAGE, H_WAIT, PRE, EPILOGUE, PRODUCT2, CLUSTER_WAIT, CLUSTER_SUM, STORE, PHASES_TOTAL
};
constexpr int PHASES = PHASES_TOTAL + 1;

// ---------------------------------------------------------------------------
// PTX: ldmatrix, mma.sync, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), fp32 c.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (a zero accumulator in): the first product of a chunk.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// 16 bytes global -> shared, the bytes past src_bytes (0 or 16) zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The two halves of a cluster barrier: arrive (release this CTA's shared
// memory writes, or announce that its reads of peers are done) and wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// ---------------------------------------------------------------------------
// Tiles and arithmetic
// ---------------------------------------------------------------------------

// Byte offset of bf16 element (row, k) in a [rows][kp] tile whose 16-byte
// chunks are XOR-swizzled by row & 7: the 8 rows an ldmatrix reads at one
// column fall in 8 distinct bank groups.  kp is a multiple of KQ.
__device__ __forceinline__ uint32_t swz(int row, int k, int kp) {
  return (uint32_t)(row * kp * 2 + ((((k >> 3) ^ (row & 7))) << 4) + ((k & 7) << 1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bits_to_float(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// Two floats already on the bf16 grid, packed (lo at the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// dp = bf16(rw * 2 * d * s * (1 - s)), in the TPU kernel's order (_dpre)
__device__ __forceinline__ float dpre(float pre, float xv, float rwv) {
  const float s = sigmoid(pre);
  const float d = s - xv;
  return round_bf16(rwv * 2.f * d * s * (1.f - s));
}

// Sum of v over the block, in a fixed order; valid in thread 0.
template <int THREADS>
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

// The CTA's columns: 8-column blocks [P_i, P_{i+1}) of ceil(N/8), split
// evenly over the `ctas` CTAs of the column axis.
struct Cols {
  int c0, c1;
};

__device__ __forceinline__ Cols cta_cols(int i, int ctas, int N) {
  const int nb = (N + 7) >> 3;
  const int b0 = (int)((long long)i * nb / ctas), b1 = (int)((long long)(i + 1) * nb / ctas);
  return Cols{b0 * 8, min(N, b1 * 8)};
}

// h rows [row0, row0 + BM) into the swizzled [BM][kp] tile `dst`, zeros past
// M and K; by cp.async (one commit group) when rows are 16-byte aligned.
template <int BM, int THREADS>
__device__ void stage_h(unsigned char* dst, const __nv_bfloat16* h, int M, int K, int kp,
                        int row0) {
  const int chunks = kp >> 3;
  if ((K & 7) == 0) {
    const uint32_t base = sm90::smem_u32(dst);
    for (int idx = threadIdx.x; idx < BM * chunks; idx += THREADS) {
      const int r = idx / chunks, k = (idx - r * chunks) << 3, row = row0 + r;
      const bool ok = row < M && k < K;
      cp_async16(base + swz(r, k, kp), ok ? h + (size_t)row * K + k : h, ok ? 16u : 0u);
    }
  } else {
    const uint16_t* hb = reinterpret_cast<const uint16_t*>(h);
    for (int idx = threadIdx.x; idx < BM * chunks; idx += THREADS) {
      const int r = idx / chunks, k = (idx - r * chunks) << 3, row = row0 + r;
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k0 = k + 2 * j;
        const uint32_t lo = row < M && k0 < K ? hb[(size_t)row * K + k0] : 0u;
        const uint32_t hi = row < M && k0 + 1 < K ? hb[(size_t)row * K + k0 + 1] : 0u;
        v[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + swz(r, k, kp)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  sm90::cp_async_commit();
}

// W rows [c0, c1) (fp32 [N][K]) into the swizzled [ROWS][kp] bf16 tile
// `dst`, rounded to nearest even; zeros past c1 and K.  By the threads' own
// loads, eight 16-byte loads in flight per thread: the path for K % 4 != 0,
// where W's rows are not 16-byte aligned for bulk copies.
template <int ROWS, int THREADS>
__device__ void stage_w(unsigned char* dst, const float* w, int K, int kp, int c0, int c1) {
  constexpr int U = 8;
  const int quads = kp >> 2, total = ROWS * quads;
  for (int base = threadIdx.x; base < total; base += THREADS * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total) {
        const int n = idx / quads, k = (idx - n * quads) << 2, col = c0 + n;
        if (col < c1 && k < K) {
          const float* src = w + (size_t)col * K + k;
          v[u].x = src[0];
          if (k + 1 < K) v[u].y = src[1];
          if (k + 2 < K) v[u].z = src[2];
          if (k + 3 < K) v[u].w = src[3];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      if (idx < total) {
        const int n = idx / quads, k = (idx - n * quads) << 2;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
        *reinterpret_cast<uint2*>(dst + swz(n, k, kp)) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

// As stage_w, with W's fp32 rows brought into `scratch` by bulk copies
// (the copy engine, not the threads' loads: whole 2 KB rows, two slots of
// rows in flight) and rounded from there.  Warp 0 starts each slot's
// copies onto its mbarrier in `bars` (initialised, count 1); every thread
// rounds a landed slot, and the slot is refilled after a barrier.  Needs
// K % 4 == 0 (16-byte rows).
template <int ROWS, int THREADS>
__device__ void stage_w_bulk(unsigned char* dst, float* scratch, int scratch_bytes,
                             uint64_t* bars, const float* w, int K, int kp, int c0, int c1) {
  const int rows = max(0, min(ROWS, c1 - c0));
  const int slot_rows = min(ROWS, scratch_bytes / 2 / (K * 4));
  const int chunks = (rows + slot_rows - 1) / slot_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quads = kp >> 2;
  auto fetch = [&](int c) {
    const int slot = c & 1, r0 = c * slot_rows, nr = min(slot_rows, rows - r0);
    if (lane == 0) sm90::mbar_arrive_expect_tx(&bars[slot], (uint32_t)(nr * K * 4));
    __syncwarp();
    for (int r = lane; r < nr; r += 32)
      sm90::bulk_g2s(scratch + ((size_t)slot * slot_rows + r) * K, w + (size_t)(c0 + r0 + r) * K,
                     (uint32_t)(K * 4), &bars[slot]);
  };
  if (warp == 0) {
    if (chunks > 0) fetch(0);
    if (chunks > 1) fetch(1);
  }
  // rows past the CTA's columns are zeros
  for (int idx = threadIdx.x; idx < (ROWS - rows) * quads; idx += THREADS) {
    const int n = rows + idx / quads, k = (idx % quads) << 2;
    *reinterpret_cast<uint2*>(dst + swz(n, k, kp)) = make_uint2(0u, 0u);
  }
  for (int c = 0; c < chunks; ++c) {
    const int slot = c & 1, r0 = c * slot_rows, nr = min(slot_rows, rows - r0);
    sm90::mbar_wait(&bars[slot], (c >> 1) & 1);
    const float* src = scratch + (size_t)slot * slot_rows * K;
    for (int idx = threadIdx.x; idx < nr * quads; idx += THREADS) {
      const int r = idx / quads, k = (idx - r * quads) << 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K) v = *reinterpret_cast<const float4*>(src + (size_t)r * K + k);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(dst + swz(r0 + r, k, kp)) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
    __syncthreads();  // the slot is read
    if (warp == 0 && c + 2 < chunks) {
      sm90::fence_proxy_async();
      fetch(c + 2);
    }
  }
}

// The bytes W's fp32 slots are given: two of 16 rows at K = 512.
constexpr size_t W_SLOTS_BYTES = 64 * 1024;

// The mbarriers of stage_w_bulk, initialised by thread 0 (a barrier follows
// before their first use).
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars[0], 1);
    sm90::mbar_init(&bars[1], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// x rows [row0, row0 + BM) and columns [c0, c1) into xs ([BM][XS] fp32, the
// tile's columns from 0), and rw of those rows into column XS - 4; zeros
// outside M and [c0, c1).  By cp.async (in the caller's commit group) where
// rows are 16-byte aligned, else by plain loads.
template <int BM, int COLS, int XS, int THREADS>
__device__ void stage_x(float* xs, const float* x, const float* rw, int M, int N, int row0,
                        int c0, int c1) {
  constexpr int CH = COLS / 4;  // 16-byte chunks a row
  if ((N & 3) == 0) {
    const uint32_t base = sm90::smem_u32(xs);
    for (int idx = threadIdx.x; idx < BM * CH; idx += THREADS) {
      const int r = idx / CH, c = (idx - r * CH) * 4, row = row0 + r, col = c0 + c;
      const bool ok = row < M && col < c1;
      cp_async16(base + (uint32_t)(r * XS + c) * 4, ok ? x + (size_t)row * N + col : x,
                 ok ? 16u : 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < BM * COLS; idx += THREADS) {
      const int r = idx / COLS, c = idx - r * COLS, row = row0 + r, col = c0 + c;
      xs[r * XS + c] = row < M && col < c1 ? x[(size_t)row * N + col] : 0.f;
    }
  }
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    if (row0 + r < M)
      sm90::cp_async4(xs + r * XS + XS - 4, rw + row0 + r);
    else
      xs[r * XS + XS - 4] = 0.f;
  }
}

// The fragments of one 16-deep step of the pre-activation product: h rows
// r0 + 16 mt + .. (A) and the W rows of 8-column blocks nb0 + j (B, two
// blocks per x4 load), j < nt <= NT.
template <int MT, int NT>
struct PreFrags {
  uint32_t a[MT][4];
  uint32_t b[(NT + 1) / 2][4];

  __device__ __forceinline__ void load(uint32_t hs, uint32_t ws, int kp, int r0, int nb0, int nt,
                                       int k0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(hs + swz(r0 + mt * 16 + (lane & 15), k0 + ((lane >> 4) << 3), kp), a[mt]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j + 1 < NT && j + 1 < nt)
        ldsm_x4(ws + swz((nb0 + j) * 8 + (lane & 7) + ((lane >> 4) << 3),
                         k0 + (((lane >> 3) & 1) << 3), kp),
                b[j / 2]);
      else if (j < nt)
        ldsm_x2(ws + swz((nb0 + j) * 8 + (lane & 7), k0 + (((lane >> 3) & 1) << 3), kp),
                b[j / 2][0], b[j / 2][1]);
    }
  }

  // t (+)= a . b for every (mt, j < nt); `first` starts t from zero.
  __device__ __forceinline__ void mma_into(float (&t)[MT][NT][4], int nt, bool first) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
        const uint32_t b0 = b[j / 2][(j & 1) * 2], b1 = b[j / 2][(j & 1) * 2 + 1];
        if (first)
          mma0(t[mt][j], a[mt], b0, b1);
        else
          mma(t[mt][j], a[mt], b0, b1);
      }
  }
};

// acc[mt][j] += h tile rows (r0 + 16 mt ..) . W tile rows of 8-column block
// (nb0 + j), over kp, for j < nt <= NT.  Each 32-deep chunk is summed on the
// tensor cores from zero and added to acc in fp32 with rounding to nearest:
// the tensor cores truncate their fp32 sums, and a chunk's sum is far smaller
// than the running one, so this keeps the pre-activation (and the bf16
// rounding of dp) close to a plain fp32 sum.  With PIPE the next step's
// fragments load while this step's products run (two sets of fragments in
// registers); without, each step loads and then multiplies.
template <int MT, int NT, bool PIPE>
__device__ __forceinline__ void pre_product(float (&acc)[MT][NT][4], uint32_t hs, uint32_t ws,
                                            int kp, int r0, int nb0, int nt) {
  PreFrags<MT, NT> f0, f1;
  if (PIPE) f0.load(hs, ws, kp, r0, nb0, nt, 0);
  for (int k0 = 0; k0 < kp; k0 += 32) {
    float t[MT][NT][4];
    if (PIPE) {
      f1.load(hs, ws, kp, r0, nb0, nt, k0 + 16);
      f0.mma_into(t, nt, true);
      if (k0 + 32 < kp) f0.load(hs, ws, kp, r0, nb0, nt, k0 + 32);
      f1.mma_into(t, nt, false);
    } else {
      f0.load(hs, ws, kp, r0, nb0, nt, k0);
      f0.mma_into(t, nt, true);
      f0.load(hs, ws, kp, r0, nb0, nt, k0 + 16);
      f0.mma_into(t, nt, false);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j < nt) acc[mt][j][e] += t[mt][j][e];
  }
}

// The fragments of one 16-deep step of dh's product: the dp tile's 32 rows
// (A) and the W tile's rows k0.. read transposed, K columns of 8-column
// blocks kb0 + j (B), j < nj <= NJ.
template <int NJ>
struct DhFrags {
  uint32_t a[2][4], b[NJ / 2][4];

  __device__ __forceinline__ void load(uint32_t dps, int dps_stride, uint32_t ws, int kp, int k0,
                                       int kb0, int nj) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(dps + ((mt * 16 + (lane & 15)) * dps_stride + k0 + ((lane >> 4) << 3)) * 2, a[mt]);
    const int wrow = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j + 1 < nj)
        ldsm_x4_t(ws + swz(wrow, (kb0 + j) * 8 + ((lane >> 4) << 3), kp), b[j / 2]);
      else if (j < nj)
        ldsm_x2_t(ws + swz(wrow, (kb0 + j) * 8, kp), b[j / 2][0], b[j / 2][1]);
    }
  }

  __device__ __forceinline__ void mma_into(float (&acc)[2][NJ][4], int nj) const {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma(acc[mt][j], a[mt], b[j / 2][(j & 1) * 2], b[j / 2][(j & 1) * 2 + 1]);
    }
  }
};

// acc[mt][j] (rows 16 mt + .., K columns of 8-column block kb0 + j) +=
// dp tile [32][k_rows] (row-major, stride dps_stride) . W tile [k_rows][kp]
// (swizzled, read transposed), for j < nj <= NJ; k_rows a multiple of 16.
// The next step's fragments load while this step's products run.
template <int NJ>
__device__ __forceinline__ void dh_product(float (&acc)[2][NJ][4], uint32_t dps, int dps_stride,
                                           uint32_t ws, int kp, int k_rows, int kb0, int nj) {
  DhFrags<NJ> f0, f1;
  f0.load(dps, dps_stride, ws, kp, 0, kb0, nj);
  for (int k0 = 0; k0 < k_rows; k0 += 32) {
    if (k0 + 16 < k_rows) f1.load(dps, dps_stride, ws, kp, k0 + 16, kb0, nj);
    f0.mma_into(acc, nj);
    if (k0 + 16 >= k_rows) break;
    if (k0 + 32 < k_rows) f0.load(dps, dps_stride, ws, kp, k0 + 32, kb0, nj);
    f1.mma_into(acc, nj);
  }
}

// acc[mt][j] (W rows n0 + 16 mt + .., K columns of 8-column block kb0 + j)
// += dp^T . h over the tile's 32 rows: dp tile [32][..] read transposed,
// h tile [32][kp] (swizzled) read transposed; j < nj <= NJ.
template <int NJ>
__device__ __forceinline__ void dw_product(float (&acc)[2][NJ][4], uint32_t dps, int dps_stride,
                                           uint32_t hs, int kp, int n0, int kb0, int nj) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < W_BM; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4_t(dps + ((k0 + (lane & 7) + ((lane >> 4) << 3)) * dps_stride + n0 + mt * 16 +
                       (((lane >> 3) & 1) << 3)) * 2,
                a[mt]);
    const int hrow = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j + 1 < nj) {
        uint32_t bf[4];
        ldsm_x4_t(hs + swz(hrow, (kb0 + j) * 8 + ((lane >> 4) << 3), kp), bf);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][j], a[mt], bf[0], bf[1]);
          mma(acc[mt][j + 1], a[mt], bf[2], bf[3]);
        }
      } else if (j < nj) {
        uint32_t b0, b1;
        ldsm_x2_t(hs + swz(hrow, (kb0 + j) * 8, kp), b0, b1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(acc[mt][j], a[mt], b0, b1);
      }
    }
  }
}

// x, b and rw at a thread's pre-activation outputs (the mma accumulator
// layout: rows g and g + 8 of each 16-row block, columns 2q and 2q + 1 of
// each 8-column block), loaded ahead of the products; zeros outside the
// tile's valid rows and columns.
template <int MT, int NT>
struct Operands {
  float x[MT][NT][4];
  float b[NT][2];
  float rw[MT][2];
  bool col_ok[NT][2];
  bool row_ok[MT][2];

  __device__ __forceinline__ void load(const float* xg, const float* bg, const float* rwg, int M,
                                       int N, int row0, int c0, int c1, int nb0, int nt) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + (nb0 + j) * 8 + 2 * q + e;
        col_ok[j][e] = j < nt && col < c1;
        b[j][e] = col_ok[j][e] ? bg[col] : 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + mt * 16 + g + 8 * hf;
        row_ok[mt][hf] = row < M;
        rw[mt][hf] = row_ok[mt][hf] ? rwg[row] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = c0 + (nb0 + j) * 8 + 2 * q;
          const float* src = xg + (size_t)row * N + col;
          if (row_ok[mt][hf] && col_ok[j][1] && (N & 1) == 0) {
            const float2 v = *reinterpret_cast<const float2*>(src);
            x[mt][j][2 * hf] = v.x;
            x[mt][j][2 * hf + 1] = v.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              x[mt][j][2 * hf + e] = row_ok[mt][hf] && col_ok[j][e] ? src[e] : 0.f;
          }
        }
      }
  }
};

// dp of a thread's outputs into the dp tile (bf16, [rows][stride]); zeros
// outside the valid rows and columns.  r0 and the 8-column blocks are tile
// coordinates.
template <int MT, int NT>
__device__ __forceinline__ void store_dp(const float (&acc)[MT][NT][4],
                                         const Operands<MT, NT>& op, unsigned char* dps,
                                         int stride, int r0, int nb0, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dp = dpre(acc[mt][j][2 * hf + e] + op.b[j][e], op.x[mt][j][2 * hf + e],
                                op.rw[mt][hf]);
          v[e] = op.row_ok[mt][hf] && op.col_ok[j][e] ? dp : 0.f;
        }
        const int r = r0 + mt * 16 + g + 8 * hf, c = (nb0 + j) * 8 + 2 * q;
        *reinterpret_cast<uint32_t*>(dps + ((size_t)r * stride + c) * 2) = pack_bf16(v[0], v[1]);
      }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// [W bf16][h 0][h 1]; h 1 holds W's fp32 slots while W is staged.
__host__ __device__ constexpr size_t fwd_smem_bytes(int kp) {
  return (size_t)F_N8 * 8 * kp * 2 + (size_t)F_BM * kp * 2 +
         ((size_t)F_BM * kp * 2 > W_SLOTS_BYTES ? (size_t)F_BM * kp * 2 : W_SLOTS_BYTES);
}

// grid (ctas, row groups): CTA (i, y) owns column range i and row tiles y,
// y + row groups, ...; partials[y * ctas + i] = its share of the loss.
__global__ void __launch_bounds__(F_THREADS, 1)
fwd_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ w,
           const float* __restrict__ b, const float* __restrict__ x,
           const float* __restrict__ rw, float* __restrict__ partials, int M, int K, int N,
           int kp, long long* prof) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[F_THREADS / 32];
  __shared__ __align__(8) uint64_t wbar[2];
  unsigned char* wt = smem;
  unsigned char* hbuf = wt + (size_t)F_N8 * 8 * kp * 2;
  const size_t h_bytes = (size_t)F_BM * kp * 2;
  sm90::PhaseClock<PHASES> clk(prof);
  init_bars(wbar);

  const Cols cols = cta_cols(blockIdx.x, gridDim.x, N);
  const int row_tiles = (M + F_BM - 1) / F_BM;
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  // x, b, rw of the first row tile and h load while W is staged; later
  // tiles' x while the tile before is finished
  Operands<2, 3> op;
  if ((int)blockIdx.y < row_tiles) {
    stage_h<F_BM, F_THREADS>(hbuf, h, M, K, kp, blockIdx.y * F_BM);
    op.load(x, b, rw, M, N, blockIdx.y * F_BM + wm * 32, cols.c0, cols.c1, wn * 3, 3);
  }
  if ((K & 3) == 0)
    stage_w_bulk<F_N8 * 8, F_THREADS>(wt, reinterpret_cast<float*>(hbuf + h_bytes),
                                     (int)W_SLOTS_BYTES, wbar, w, K, kp, cols.c0, cols.c1);
  else
    stage_w<F_N8 * 8, F_THREADS>(wt, w, K, kp, cols.c0, cols.c1);
  clk.lap(W_STAGE);

  float part = 0.f;
  int i = 0;
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y, ++i) {
    sm90::cp_async_wait_all();
    __syncthreads();
    clk.lap(H_WAIT);
    if (rt + (int)gridDim.y < row_tiles)
      stage_h<F_BM, F_THREADS>(hbuf + ((i + 1) & 1) * h_bytes, h, M, K, kp,
                               (rt + gridDim.y) * F_BM);
    float acc[2][3][4] = {};
    pre_product<2, 3, true>(acc, sm90::smem_u32(hbuf + (i & 1) * h_bytes), sm90::smem_u32(wt), kp,
                            wm * 32, wn * 3, 3);
    clk.lap(PRE);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // computed everywhere (zeros outside the tile give finite values)
            // and masked after: no branch splits the independent chains
            const float d = sigmoid(acc[mt][j][2 * hf + e] + op.b[j][e]) -
                            op.x[mt][j][2 * hf + e];
            rs += op.col_ok[j][e] ? d * d : 0.f;
          }
        part += op.row_ok[mt][hf] ? op.rw[mt][hf] * rs : 0.f;
      }
    if (rt + (int)gridDim.y < row_tiles)
      op.load(x, b, rw, M, N, (rt + gridDim.y) * F_BM + wm * 32, cols.c0, cols.c1, wn * 3, 3);
    clk.lap(EPILOGUE);
  }
  const float s = block_sum<F_THREADS>(part, red);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  clk.lap(STORE);
  clk.finish();
}

// out[0] = sum of partials[0..n), in a fixed order.
__global__ void __launch_bounds__(256)
sum_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float red[256 / 32];
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) v += partials[i];
  const float s = block_sum<256>(v, red);
  if (threadIdx.x == 0) out[0] = s;
}

// ---------------------------------------------------------------------------
// backward, dh
// ---------------------------------------------------------------------------

// [W bf16][h][dp][part]; part holds W's fp32 slots while W is staged.
__host__ __device__ constexpr size_t dh_smem_bytes(int kp) {
  return (size_t)H_N8 * 8 * kp * 2 + (size_t)H_BM * kp * 2 + (size_t)H_BM * H_DPS * 2 +
         ((size_t)H_BM * (kp + 8) * 4 > W_SLOTS_BYTES ? (size_t)H_BM * (kp + 8) * 4
                                                      : W_SLOTS_BYTES);
}

// grid (cluster * clusters, row groups), clusters of `cluster` CTAs along x:
// CTA (i, y) owns column range i and row tiles y, y + row groups, ...  For
// each row tile, its [32, K] share of dp W goes to shared memory; the
// cluster adds its CTAs' shares in rank order, each rank a slice of the
// tile, into workspace[i / cluster] ([clusters][M][K]), or, with one cluster
// along x, into dh = g * round?(sum).
__global__ void __launch_bounds__(H_THREADS, 1)
dh_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ w,
          const float* __restrict__ b, const float* __restrict__ x,
          const float* __restrict__ rw, const float* __restrict__ g,
          float* __restrict__ workspace, float* __restrict__ dh, int M, int K, int N, int kp,
          int round_dh, long long* prof) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wt = smem;
  unsigned char* hs = wt + (size_t)H_N8 * 8 * kp * 2;
  unsigned char* dps = hs + (size_t)H_BM * kp * 2;
  float* part = reinterpret_cast<float*>(dps + (size_t)H_BM * H_DPS * 2);
  const int ps = kp + 8;  // part row stride (floats)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const bool single = (int)gridDim.x == csize;
  __shared__ __align__(8) uint64_t wbar[2];
  sm90::PhaseClock<PHASES> clk(prof);
  init_bars(wbar);

  const Cols cols = cta_cols(blockIdx.x, gridDim.x, N);
  const int row_tiles = (M + H_BM - 1) / H_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  // pre-activation: rows 16 wm.., blocks [nb0, nb0 + nt) of the 14 (3 or 4)
  const int wm = warp & 1, wn = warp >> 1;
  const int nb0 = wn * H_N8 / 4, nt = (wn + 1) * H_N8 / 4 - nb0;
  static_assert(H_N8 == 14, "the warps' blocks are 3 or 4");
  // dp W: all 32 rows, K columns [kb0 * 8, (kb0 + nj) * 8)
  const int nj = kp / 64, kb0 = warp * nj;
  Operands<1, 4> op;
  if ((int)blockIdx.y < row_tiles) {
    stage_h<H_BM, H_THREADS>(hs, h, M, K, kp, blockIdx.y * H_BM);
    op.load(x, b, rw, M, N, blockIdx.y * H_BM + wm * 16, cols.c0, cols.c1, nb0, nt);
  }
  if ((K & 3) == 0)
    stage_w_bulk<H_N8 * 8, H_THREADS>(wt, part, (int)W_SLOTS_BYTES, wbar, w, K, kp, cols.c0,
                                      cols.c1);
  else
    stage_w<H_N8 * 8, H_THREADS>(wt, w, K, kp, cols.c0, cols.c1);
  const float gv = g[0];
  clk.lap(W_STAGE);

  bool peers_reading = false;
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int row0 = rt * H_BM;
    sm90::cp_async_wait_all();
    __syncthreads();
    clk.lap(H_WAIT);
    float acc[1][4][4] = {};
    // nt as a constant in each copy: 3 or 4 blocks, no branches in the loop
    if (nt == 4)
      pre_product<1, 4, true>(acc, sm90::smem_u32(hs), sm90::smem_u32(wt), kp, wm * 16, nb0, 4);
    else
      pre_product<1, 4, true>(acc, sm90::smem_u32(hs), sm90::smem_u32(wt), kp, wm * 16, nb0, 3);
    __syncthreads();  // every warp is done with this h tile
    if (rt + (int)gridDim.y < row_tiles)
      stage_h<H_BM, H_THREADS>(hs, h, M, K, kp, (rt + gridDim.y) * H_BM);
    clk.lap(PRE);
    store_dp<1, 4>(acc, op, dps, H_DPS, wm * 16, nb0, nt);
    if (rt + (int)gridDim.y < row_tiles)
      op.load(x, b, rw, M, N, (rt + gridDim.y) * H_BM + wm * 16, cols.c0, cols.c1, nb0, nt);
    __syncthreads();
    clk.lap(EPILOGUE);

    float acc2[2][8][4] = {};
    dh_product<8>(acc2, sm90::smem_u32(dps), H_DPS, sm90::smem_u32(wt), kp, H_N8 * 8, kb0, nj);
    if (peers_reading) cluster_wait();  // the peers are done with the last tile's part
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nj) continue;
        const int c = (kb0 + j) * 8 + 2 * q;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(part + (mt * 16 + gq + 8 * hf) * ps + c) =
              make_float2(acc2[mt][j][2 * hf], acc2[mt][j][2 * hf + 1]);
      }
    clk.lap(PRODUCT2);

    // the cluster's sum, in rank order; rank r adds slice r of the tile
    cluster_arrive();
    cluster_wait();
    clk.lap(CLUSTER_WAIT);
    const int quads = kp >> 2, total = H_BM * quads;
    const int beg = rank * total / csize, end = (rank + 1) * total / csize;
    // every peer's float4 loads in flight before the rank-ordered sum
    const float* peer[MAX_CLUSTER];
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p) peer[p] = cluster.map_shared_rank(part, p < csize ? p : 0);
    for (int idx = beg + (int)threadIdx.x; idx < end; idx += H_THREADS) {
      const int r = idx / quads, k = (idx - r * quads) << 2, row = row0 + r;
      if (row >= M || k >= K) continue;
      const int off = r * ps + k;
      float4 v[MAX_CLUSTER];
#pragma unroll
      for (int p = 0; p < MAX_CLUSTER; ++p)
        if (p < csize) v[p] = *reinterpret_cast<const float4*>(peer[p] + off);
      float4 sum = v[0];
#pragma unroll
      for (int p = 1; p < MAX_CLUSTER; ++p) {
        if (p >= csize) break;
        sum.x += v[p].x;
        sum.y += v[p].y;
        sum.z += v[p].z;
        sum.w += v[p].w;
      }
      float sv[4] = {sum.x, sum.y, sum.z, sum.w};
      float* out = single ? dh + (size_t)row * K + k
                          : workspace + ((size_t)(blockIdx.x / csize) * M + row) * K + k;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (single) sv[e] = gv * (round_dh ? round_bf16(sv[e]) : sv[e]);
        if (k + e < K) out[e] = sv[e];
      }
    }
    // this CTA is done reading its peers; it waits for theirs before it
    // writes its part again (or exits, freeing its shared memory)
    cluster_arrive();
    peers_reading = true;
    clk.lap(CLUSTER_SUM);
  }
  if (peers_reading) cluster_wait();
  clk.finish();
}

// dh[e] = g * round?(sum over ranges of partials[range][e]), ranges in order.
__global__ void __launch_bounds__(256)
dh_reduce_kernel(const float* __restrict__ partials, int n_ranges, size_t count,
                 const float* __restrict__ g, int round_dh, float* __restrict__ dh) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int r = 0; r < n_ranges; ++r) s += partials[(size_t)r * count + e];
  dh[e] = g[0] * (round_dh ? round_bf16(s) : s);
}

// ---------------------------------------------------------------------------
// backward, dW and db
// ---------------------------------------------------------------------------

constexpr int W_XS = W_N8 * 8 + 4;  // x tile row stride (floats); rw in the last column
// [W bf16][h 0][x 0][dp][h 1][x 1]; h 1 and x 1 (and what follows them)
// hold W's fp32 slots while W is staged.
__host__ __device__ constexpr size_t dw_second_buffers(int kp) {
  return (size_t)W_N8 * 8 * kp * 2 + (size_t)W_BM * kp * 2 + (size_t)W_BM * W_XS * 4 +
         (size_t)W_BM * W_DPS * 2;
}

__host__ __device__ constexpr size_t dw_smem_bytes(int kp) {
  return dw_second_buffers(kp) +
         ((size_t)W_BM * kp * 2 + (size_t)W_BM * W_XS * 4 > W_SLOTS_BYTES
              ? (size_t)W_BM * kp * 2 + (size_t)W_BM * W_XS * 4
              : W_SLOTS_BYTES);
}

// grid (ctas): CTA i owns column range i and walks every row tile;
// dW[its columns] and db[its columns] are written once, at the end.
__global__ void __launch_bounds__(W_THREADS, 1)
dw_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ w,
          const float* __restrict__ b, const float* __restrict__ x,
          const float* __restrict__ rw, const float* __restrict__ g, float* __restrict__ dw,
          float* __restrict__ db, int M, int K, int N, int kp, long long* prof) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t wbar[2];
  const size_t h_bytes = (size_t)W_BM * kp * 2, x_bytes = (size_t)W_BM * W_XS * 4;
  unsigned char* wt = smem;
  unsigned char* second = smem + dw_second_buffers(kp);
  unsigned char* first = wt + (size_t)W_N8 * 8 * kp * 2;
  unsigned char* dps = first + h_bytes + x_bytes;
  // buffer set i & 1: h at first or second, x right after it
  auto hbuf = [&](int i) { return (i & 1) ? second : first; };
  auto xbuf = [&](int i) { return reinterpret_cast<float*>(hbuf(i) + h_bytes); };
  sm90::PhaseClock<PHASES> clk(prof);
  init_bars(wbar);

  const Cols cols = cta_cols(blockIdx.x, gridDim.x, N);
  const int row_tiles = (M + W_BM - 1) / W_BM;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gq = lane >> 2, q = lane & 3;
  // pre-activation: rows 16 wm.., blocks 2 wn, 2 wn + 1
  const int wm = warp & 1, wn = warp >> 1;
  // dp^T h: W rows [32 wr, 32 wr + 32), K columns [kb0 * 8, (kb0 + nj) * 8)
  const int wr = warp % 3, nj = kp / 32, kb0 = (warp / 3) * nj;
  // x and rw of a tile arrive in shared memory with its h (no registers
  // held across the products: dW's accumulators fill them)
  stage_x<W_BM, W_N8 * 8, W_XS, W_THREADS>(xbuf(0), x, rw, M, N, 0, cols.c0, cols.c1);
  stage_h<W_BM, W_THREADS>(hbuf(0), h, M, K, kp, 0);
  if ((K & 3) == 0)
    stage_w_bulk<W_N8 * 8, W_THREADS>(wt, reinterpret_cast<float*>(second), (int)W_SLOTS_BYTES,
                                     wbar, w, K, kp, cols.c0, cols.c1);
  else
    stage_w<W_N8 * 8, W_THREADS>(wt, w, K, kp, cols.c0, cols.c1);
  clk.lap(W_STAGE);

  float acc2[2][16][4] = {};
  float db_acc = 0.f;
  for (int rt = 0; rt < row_tiles; ++rt) {
    const int row0 = rt * W_BM;
    unsigned char* hs = hbuf(rt);
    const float* xs = xbuf(rt);
    sm90::cp_async_wait_all();
    __syncthreads();  // this tile's h, x, rw have landed; the last tile's reads are done
    clk.lap(H_WAIT);
    if (rt + 1 < row_tiles) {
      stage_x<W_BM, W_N8 * 8, W_XS, W_THREADS>(xbuf(rt + 1), x, rw, M, N, row0 + W_BM, cols.c0,
                                              cols.c1);
      stage_h<W_BM, W_THREADS>(hbuf(rt + 1), h, M, K, kp, row0 + W_BM);
    }
    float acc[1][2][4] = {};
    pre_product<1, 2, false>(acc, sm90::smem_u32(hs), sm90::smem_u32(wt), kp, wm * 16, wn * 2, 2);
    clk.lap(PRE);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 16 + gq + 8 * hf, row = row0 + r;
      const float rwv = xs[r * W_XS + W_XS - 4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = (wn * 2 + j) * 8 + 2 * q;
        const float2 xv = *reinterpret_cast<const float2*>(xs + r * W_XS + c);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cols.c0 + c + e;
          const bool ok = row < M && col < cols.c1;
          const float dp = dpre(acc[0][j][2 * hf + e] + (ok ? __ldg(b + col) : 0.f),
                                e ? xv.y : xv.x, rwv);
          v[e] = ok ? dp : 0.f;
        }
        *reinterpret_cast<uint32_t*>(dps + ((size_t)r * W_DPS + c) * 2) = pack_bf16(v[0], v[1]);
      }
    }
    __syncthreads();
    clk.lap(EPILOGUE);
    if (t < W_N8 * 8) {
      const uint16_t* col = reinterpret_cast<const uint16_t*>(dps) + t;
      for (int r = 0; r < W_BM; ++r) db_acc += bits_to_float(col[r * W_DPS]);
    }
    dw_product<16>(acc2, sm90::smem_u32(dps), W_DPS, sm90::smem_u32(hs), kp, wr * 32, kb0, nj);
    clk.lap(PRODUCT2);
  }

  const float gv = g[0];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = cols.c0 + wr * 32 + mt * 16 + gq + 8 * hf;
      if (col >= cols.c1) continue;
      float* out = dw + (size_t)col * K;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j >= nj) continue;
        const int k = (kb0 + j) * 8 + 2 * q;
        const float v0 = gv * acc2[mt][j][2 * hf], v1 = gv * acc2[mt][j][2 * hf + 1];
        if ((K & 1) == 0 && k + 1 < K) {
          *reinterpret_cast<float2*>(out + k) = make_float2(v0, v1);
        } else {
          if (k < K) out[k] = v0;
          if (k + 1 < K) out[k + 1] = v1;
        }
      }
    }
  if (t < W_N8 * 8 && cols.c0 + t < cols.c1) db[cols.c0 + t] = gv * db_acc;
  clk.lap(STORE);
  clk.finish();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool bad_shape(int m, int k, int n) { return m < 1 || n < 1 || k < 1 || k > MAX_K; }

int padded_k(int k) { return (k + KQ - 1) / KQ * KQ; }

// The fewest CTAs along N whose column ranges hold at most `n8` blocks.
int min_ctas(int n, int n8) { return ((n + 7) / 8 + n8 - 1) / n8; }

// Sets `kernel`'s dynamic shared memory to the largest this file asks for
// (K = 512), once per (device, kernel).
cudaError_t opt_in(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaLaunchConfig_t dh_config(int cluster, int clusters, int row_groups, size_t smem,
                             cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters, row_groups);
  cfg.blockDim = dim3(H_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_fwd(const __nv_bfloat16* h, const float* w, const float* b, const float* x,
                       const float* rw, float* partials, float* loss, int m, int k, int n,
                       int ctas, int row_groups, long long* prof, cudaStream_t stream) {
  if (bad_shape(m, k, n) || ctas < min_ctas(n, F_N8) || row_groups < 1)
    return cudaErrorInvalidValue;
  const int kp = padded_k(k);
  cudaError_t err = opt_in(reinterpret_cast<const void*>(fwd_kernel), fwd_smem_bytes(MAX_K));
  if (err != cudaSuccess) return err;
  fwd_kernel<<<dim3(ctas, row_groups), F_THREADS, fwd_smem_bytes(kp), stream>>>(
      h, w, b, x, rw, partials, m, k, n, kp, prof);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_kernel<<<1, 256, 0, stream>>>(partials, ctas * row_groups, loss);
  return cudaGetLastError();
}

cudaError_t launch_dh(const __nv_bfloat16* h, const float* w, const float* b, const float* x,
                      const float* rw, const float* g, float* workspace, float* dh, int m, int k,
                      int n, int cluster, int clusters, int row_groups, int round_dh,
                      long long* prof, cudaStream_t stream) {
  if (bad_shape(m, k, n) || cluster < 1 || cluster > MAX_CLUSTER || clusters < 1 ||
      row_groups < 1 || cluster * clusters < min_ctas(n, H_N8))
    return cudaErrorInvalidValue;
  const int kp = padded_k(k);
  cudaError_t err = opt_in(reinterpret_cast<const void*>(dh_kernel), dh_smem_bytes(MAX_K));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      dh_config(cluster, clusters, row_groups, dh_smem_bytes(kp), stream, &attr);
  err = cudaLaunchKernelEx(&cfg, dh_kernel, h, w, b, x, rw, g, workspace, dh, m, k, n, kp,
                           round_dh, prof);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || clusters == 1) return err;
  const size_t count = (size_t)m * k;
  dh_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(workspace, clusters,
                                                                      count, g, round_dh, dh);
  return cudaGetLastError();
}

cudaError_t launch_dw(const __nv_bfloat16* h, const float* w, const float* b, const float* x,
                      const float* rw, const float* g, float* dw, float* db, int m, int k, int n,
                      int ctas, long long* prof, cudaStream_t stream) {
  if (bad_shape(m, k, n) || ctas < min_ctas(n, W_N8)) return cudaErrorInvalidValue;
  const int kp = padded_k(k);
  cudaError_t err = opt_in(reinterpret_cast<const void*>(dw_kernel), dw_smem_bytes(MAX_K));
  if (err != cudaSuccess) return err;
  dw_kernel<<<ctas, W_THREADS, dw_smem_bytes(kp), stream>>>(h, w, b, x, rw, g, dw, db, m, k, n,
                                                            kp, prof);
  return cudaGetLastError();
}

}  // namespace
}  // namespace decode

using decode::launch_dh;
using decode::launch_dw;
using decode::launch_fwd;

// Shapes: h [M, K] bf16, w [N, K], b [N], x [M, N], rw [M] fp32, contiguous;
// partials [ctas * row_groups] workspace; loss [1].  ctas CTAs split N into
// ranges of whole 8-column blocks, at most 12 each; row_groups >= 1 split
// the 64-row tiles.
extern "C" int decode_mse_fwd_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                  const float* x, const float* rw, float* partials,
                                  float* loss, int m, int k, int n, int ctas, int row_groups,
                                  cudaStream_t stream) {
  return static_cast<int>(
      launch_fwd(h, w, b, x, rw, partials, loss, m, k, n, ctas, row_groups, nullptr, stream));
}

// As decode_mse_fwd_f32, with g [1] the cotangent and dh [M, K] fp32 (rounded
// to bf16 before the scaling when round_dh is not 0).  clusters clusters of
// `cluster` (1..8) CTAs split N into ranges of at most 14 blocks;
// row_groups >= 1 split the 32-row tiles; workspace [clusters, M, K] (unused
// when clusters is 1).
extern "C" int decode_mse_bwd_dh_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                     const float* x, const float* rw, const float* g,
                                     float* workspace, float* dh, int m, int k, int n,
                                     int cluster, int clusters, int row_groups, int round_dh,
                                     cudaStream_t stream) {
  return static_cast<int>(launch_dh(h, w, b, x, rw, g, workspace, dh, m, k, n, cluster,
                                    clusters, row_groups, round_dh, nullptr, stream));
}

// As decode_mse_fwd_f32, with g [1] the cotangent; dw [N, K] and db [N] fp32;
// ctas CTAs split N into ranges of at most 12 blocks, each walking all of M.
extern "C" int decode_mse_bwd_dw_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                     const float* x, const float* rw, const float* g,
                                     float* dw, float* db, int m, int k, int n, int ctas,
                                     cudaStream_t stream) {
  return static_cast<int>(launch_dw(h, w, b, x, rw, g, dw, db, m, k, n, ctas, nullptr, stream));
}

// out[0] = how many clusters of `cluster` dh CTAs (shared memory at this K)
// the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int decode_mse_dh_cluster_slots(int k, int cluster, int* out) {
  using namespace decode;
  if (k < 1 || k > MAX_K || cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dh_smem_bytes(padded_k(k));
  cudaError_t err = opt_in(reinterpret_cast<const void*>(dh_kernel), dh_smem_bytes(MAX_K));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = dh_config(cluster, 1, 1, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, dh_kernel, &cfg));
}

#ifdef DECODE_PROFILE
// As the three entries, with prof receiving PHASES clock64 sums.
extern "C" int decode_mse_fwd_profile_f32(const __nv_bfloat16* h, const float* w, const float* b,
                                          const float* x, const float* rw, float* partials,
                                          float* loss, int m, int k, int n, int ctas,
                                          int row_groups, long long* prof, cudaStream_t stream) {
  return static_cast<int>(
      launch_fwd(h, w, b, x, rw, partials, loss, m, k, n, ctas, row_groups, prof, stream));
}

extern "C" int decode_mse_bwd_dh_profile_f32(const __nv_bfloat16* h, const float* w,
                                             const float* b, const float* x, const float* rw,
                                             const float* g, float* workspace, float* dh, int m,
                                             int k, int n, int cluster, int clusters,
                                             int row_groups, int round_dh, long long* prof,
                                             cudaStream_t stream) {
  return static_cast<int>(launch_dh(h, w, b, x, rw, g, workspace, dh, m, k, n, cluster,
                                    clusters, row_groups, round_dh, prof, stream));
}

extern "C" int decode_mse_bwd_dw_profile_f32(const __nv_bfloat16* h, const float* w,
                                             const float* b, const float* x, const float* rw,
                                             const float* g, float* dw, float* db, int m, int k,
                                             int n, int ctas, long long* prof,
                                             cudaStream_t stream) {
  return static_cast<int>(launch_dw(h, w, b, x, rw, g, dw, db, m, k, n, ctas, prof, stream));
}
#endif
