// The fused fronts' device code, shared by front.cu (the dense engine's
// front over one layout) and frontshard.cu (the node-sharded engine's front
// over every shard of one card): the tile staging of the row pass through
// the Tensor Memory Accelerator and the contrast's two segment reductions.
// front.cu's header says what the front computes, why it is one launch and
// why it is bitwise the two launches it replaced; both kernels run these
// very functions, so they round alike.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "front_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // rows per tile, and segstep.cu's block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// One thread: the copy of ``bytes`` (a multiple of 16, both addresses
// 16-byte aligned) from device memory into the shared buffer ``dst``,
// completing the transaction count of ``bar``.  The proxy fence orders the
// threads' earlier reads of the buffer (a previous tile, ordered before
// this thread by a __syncthreads) before the copy's writes.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of ``bar`` with the given parity has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// A CTA's set-up: the weights into shared memory, the tile's mbarrier
// initialised and made visible to the async proxy.
__device__ __forceinline__ void front_setup(const float* anomaly_w,
                                            const float* hard_w, int C,
                                            float* wa, float* wh,
                                            uint64_t* full) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    wa[c] = anomaly_w[c];
    wh[c] = hard_w[c];
  }
  if (threadIdx.x == 0) {
    barrier_init(full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Stages one tile of ``count`` floats from ``src`` into ``tile``: one bulk
// copy that ``full`` completes where ``bulk`` (a 16-byte aligned base and a
// multiple of 4 floats), else plain loads, through the read-only cache
// where ``read_only`` (an input this launch does not write).  The tile's
// last readers have passed the previous tile's barrier.
template <bool kReadOnly>
__device__ __forceinline__ void stage_tile(float* tile, const float* src,
                                           int count, bool bulk,
                                           uint64_t* full,
                                           uint32_t* parity) {
  if (bulk) {
    if (threadIdx.x == 0) bulk_load(tile, src, count * 4, full);
    barrier_wait(full, *parity);
    *parity ^= 1u;
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) {
      tile[i] = kReadOnly ? __ldg(src + i) : src[i];
    }
    __syncthreads();
  }
}

// The contrast of one long segment: node s, whose edges [offsets[q],
// offsets[q + 1]) of ``other`` are its dependencies, by all threads in
// segstep.cu's reduction order (strided walk, shuffle tree, walk over the
// warps' partials), folded into a[s].  ``a`` and ``e`` were written in
// this launch: plain loads.
__device__ __forceinline__ void contrast_long(const int* offsets,
                                              const int* other, int q, int s,
                                              float weight, float* a,
                                              const float* e,
                                              float* partial) {
  const int end = __ldg(offsets + q + 1);
  float acc = 0.0f;
#pragma unroll 4
  for (int i = __ldg(offsets + q) + threadIdx.x; i < end; i += kThreads) {
    acc = fmaxf(acc, e[__ldg(other + i)]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = fmaxf(acc, __shfl_down_sync(kFull, acc, off));
  }
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = partial[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total = fmaxf(total, partial[w]);
    a[s] = contrast_fold(a[s], e[s], total, weight);
  }
  __syncthreads();   // partial is rewritten by the next long segment
}

// The contrast of one short segment (as contrast_long's): one thread, in
// edge order, four edges' loads in flight.
__device__ __forceinline__ void contrast_short(const int* offsets,
                                               const int* other, int q,
                                               int s, float weight, float* a,
                                               const float* e) {
  const int end = __ldg(offsets + q + 1);
  int i = __ldg(offsets + q);
  float acc = 0.0f;
  for (; i + 4 <= end; i += 4) {
    const float v0 = e[__ldg(other + i)];
    const float v1 = e[__ldg(other + i + 1)];
    const float v2 = e[__ldg(other + i + 2)];
    const float v3 = e[__ldg(other + i + 3)];
    acc = fmaxf(acc, v0);
    acc = fmaxf(acc, v1);
    acc = fmaxf(acc, v2);
    acc = fmaxf(acc, v3);
  }
  for (; i < end; ++i) acc = fmaxf(acc, e[__ldg(other + i)]);
  a[s] = contrast_fold(a[s], e[s], acc, weight);
}

// The staged tile: at most 32 KB (C <= 32), under the 48 KB a launch
// takes without an opt-in.
size_t tile_bytes(int n_channels) {
  return sizeof(float) * kThreads * n_channels;
}

// *cap = the most CTAs of ``kernel`` (kThreads threads, a tile of
// ``n_channels``) co-resident on the current device: the bound a
// cooperative launch's grid keeps.
int front_co_resident(const void* kernel, int n_channels, int* cap) {
  if (n_channels < 1 || n_channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int per_sm = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, tile_bytes(n_channels));
  }
  *cap = per_sm * sms;
  return static_cast<int>(err);
}

}  // namespace
