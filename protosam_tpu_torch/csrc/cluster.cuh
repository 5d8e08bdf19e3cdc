// Inline PTX helpers for Hopper's asynchronous pipelines: mbarriers, TMA
// tile loads (with multicast to a cluster), thread-block clusters and
// their distributed shared memory.  Shared-memory addresses are 32-bit
// (smem_u32 in mma.cuh).
#pragma once

#include <cstdint>

namespace ptk {

// A wait that has not seen its phase complete after this many clocks (about
// two seconds) traps, so a broken pipeline ends the launch with an error
// instead of hanging the card.
constexpr long long kWaitTrapCycles = 1LL << 32;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the cluster (and to TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, announcing `bytes` more to come by TMA
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// the shared::cluster address of `addr` (a CTA-relative shared address) in
// CTA `cta` of this cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(cta));
  return r;
}

// arrive on the barrier at CTA-relative address `bar` in CTA `cta` of this
// cluster (this CTA included); a no-op where `on` is false (a predicate,
// not a branch).  The arrival releases at CTA scope only, which is enough
// to free a stage whose reads were wgmma's (complete at wgmma_wait); data
// this thread stored for a peer to read needs fence_cluster() first.  (A
// release at cluster scope cost about 800 clocks an arrival on an H100.)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta,
                                                    bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [%0];\n}\n" ::"r"(
          mapa(bar, cta)),
      "r"((int)on)
      : "memory");
}

// true once the phase of parity `parity` has completed; kCluster acquires
// at cluster scope (arrivals from other CTAs' threads)
template <bool kCluster>
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  if constexpr (kCluster)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  return ok != 0;
}

// as mbar_try_wait, but returns at once
template <bool kCluster>
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  if constexpr (kCluster)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  return ok != 0;
}

template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait<kCluster>(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait<kCluster>(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

// TMA: the box at coordinates (c0 innermost, c1) of a 2-D tensor map into
// shared memory at `dst`, completing its bytes on the barrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// as tma_load_2d, into the same offset `dst` of every CTA in `cta_mask`,
// each completing its own barrier at offset `bar`
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const void* map,
                                                      uint32_t bar, int c0,
                                                      int c1,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(cta_mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: arrive (release), then wait
// (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
}

// 16 bytes from a shared::cluster address (this CTA's or a peer's)
__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// barrier `id` (1-15) over `threads` threads of this CTA
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace ptk
