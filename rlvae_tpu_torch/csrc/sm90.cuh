// What the Hopper kernels of this package share: the PTX of mbarriers, bulk
// (TMA) and 4-byte asynchronous copies, st.async and mapa; the clock64 phase
// profile of the profile build; and the shared-memory opt-in.  Used by the
// IAF-chain kernels (iaf_cluster.cuh) and the HMC kernels (hmc_bank.cuh).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk and 4-byte asynchronous copies, st.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase with `parity` of a local mbarrier completed by this
// CTA's bulk copies.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Waits for the phase with `parity` of a local mbarrier that peers complete
// with st.async, acquiring their stores at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A [H rows][HC columns] box of a 2-D tensor map (columns c0.., rows c1..),
// into dst (128-byte aligned), completing its bytes on `bar`.  Columns past
// the tensor's edge arrive as zeros and count all the same.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Orders this CTA's earlier generic-proxy reads of a buffer before the async
// proxy's (bulk copy's) writes into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(float* dst, const float* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The shared::cluster address of this CTA's shared address `a` in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

// Stores into a peer's shared memory that complete their bytes on the peer's
// mbarrier `rbar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async_v4(uint32_t raddr, const float4& v, uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];" ::
          "r"(raddr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void st_async_v2(uint32_t raddr, const float2& v, uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
          raddr),
      "f"(v.x), "f"(v.y), "r"(rbar)
      : "memory");
}

// ---------------------------------------------------------------------------
// Profile (-DIAF_PROFILE or -DHMC_PROFILE only)
// ---------------------------------------------------------------------------

// N clock64 sums, written to `prof` by thread 0 of cluster 0's rank 0: lap(k)
// adds the cycles since the previous lap to slot k, finish() puts the whole
// kernel's cycles in slot N-1.  Without a profile define every call is empty.
template <int N>
struct PhaseClock {
#if defined(IAF_PROFILE) || defined(HMC_PROFILE)
  long long* out;
  long long acc[N];
  long long mark, start;
  __device__ explicit PhaseClock(long long* prof)
      : out(prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? prof : nullptr) {
    for (int k = 0; k < N; ++k) acc[k] = 0;
    mark = start = clock64();
  }
  __device__ __forceinline__ void lap(int phase) {
    if (out != nullptr) {
      const long long now = clock64();
      acc[phase] += now - mark;
      mark = now;
    }
  }
  __device__ __forceinline__ void finish() {
    if (out != nullptr) {
      acc[N - 1] = clock64() - start;
      for (int k = 0; k < N; ++k) out[k] = acc[k];
    }
  }
#else
  __device__ explicit PhaseClock(long long*) {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void finish() {}
#endif
};

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

inline int max_optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace sm90
