// The propagation's evidence front in one launch, for Hopper (sm_90a).
//
// Replaces, on the engine's dense main path, the two launches that
// composed the front (evidence.cu's row pass, with the memset that
// cleared its bad-row counter, then segstep.cu's contrast step), and
// through them the TPU kernel rca_tpu/engine/pallas_kernels.py::
// noisy_or_pair_pallas (body _pair_kernel) with the sanitize and the
// contrast around it (rca_tpu/engine/propagate.py::finite_mask_rows,
// ::error_source_excess, ::fold_error_contrast).  Over the RAW padded
// features of B lanes (B*n_pad rows of C channels, row-major) and the up
// layout's CSR form (segment s, a dependent, owns the sorted edges
// [offsets[s], offsets[s+1]) whose other endpoints are its dependencies):
//
//   row r:   bad = any non-finite f[r, :];  x = bad ? 0 : clip(f[r], 0, 1)
//            a_raw[r], h[r] = the noisy-OR pair of x;  e[r] = x[err_col]
//   node s:  a[s] = 1 - (1 - a_raw[s]) * (1 - w * relu(e[s] - max_e e[o_e]))
//   n_bad = the count of bad rows over every lane
//
// and, with `persist`, every bad row of the input zeroed in place (the
// streaming flush keeps the sanitized buffer).  With `fold` 0 (a contrast
// weight of 0) there is no fold at all, a = a_raw, as the reference and
// the two-launch front skip it.
//
// Why one launch: the front moves 0.16 MB at the 2047-service tier (0.05
// us at 3.35 TB/s), yet each of its three device operations cost launch,
// ramp and tail (the contrast step alone, 0.015 us of bytes, takes 3.7
// us on the H100).  The contrast reads e at other rows, so the row
// pass must be done everywhere before any of it; here that is one grid
// barrier inside a cooperative launch, where it was a kernel boundary.
//
// The design:
//   - a persistent cooperative grid, sized by the wrapper to the work (the
//     row tiles, or the contrast's segment blocks where there are more)
//     and capped at the co-resident bound the occupancy API gives
//     (rca_evidence_front_fused_cap), so other streams' kernels can hold
//     the rest of the card;
//   - phase 1, the row pass: each CTA walks its 256-row tiles (grid
//     stride).  One thread stages a tile with one bulk copy of the Tensor
//     Memory Accelerator (cp.async.bulk, 13,312 bytes at C = 13) that an
//     mbarrier completes; the other CTAs on the SM (up to 8) overlap one
//     CTA's load with their 13-channel chains.  One buffer, not two: a
//     double-buffered build, each CTA prefetching its next tile, ran
//     slower (44.6 against 40.1 us at 16 lanes of 49,999 services, each
//     against 45.2-45.4 for the two launches, PERF.md §6), probably
//     because its 26 KB a CTA left less of the SM's unified L1 / shared
//     memory to the L1 that phase 2's gathers hit (not profiled).  A
//     ragged last tile, or a base that is not 16-byte aligned, takes
//     plain loads.  Each thread then runs
//     front_row.cuh's row on its row: h to the output, a_raw into a (only
//     node s's own thread reads it back) and e to a scratch vector that
//     stays in L2; a persisting launch zeroes its bad row right there
//     (the row's tile is already staged, and no one reads the row
//     again).  The CTA's bad rows go to its own slot of `counts`;
//   - one grid barrier (cooperative_groups' grid sync, which makes phase
//     1's writes visible to every CTA);
//   - CTA 0 sums the slots into counts[0] = n_bad: an integer sum, exact
//     in any order, with no memset and no atomic;
//   - phase 2, the contrast: a grid-stride walk over the work items of
//     every lane, segstep.cu's: each long segment (the host's bin, the
//     hubs and the padding run on the dummy slot) is one item reduced by
//     all 256 threads, and each 256 short segments are one item, a thread
//     each.  A segment is reduced by the same threads in the same order
//     as segstep.cu's ContrastStep (strided walk, shuffle tree, walk over
//     the warps' partials; the short walk in edge order) and folded by
//     front_row.cuh's contrast_fold, so a is bitwise the two launches'.
//     Phase 2 reads a and e, written in this launch, with plain loads:
//     the grid barrier orders phase 1's writes before them (a release
//     and an acquire at device scope), and they may hit in L1, which
//     matters where many edges gather one node (the dummy slot's run of
//     6,629 padding edges at 49,999).  Never through the read-only cache,
//     which assumes data the launch does not write.
//
// Bitwise the two-launch front: h and a_raw through the same noisy_or_row
// on the same staged row, e the same clip, the contrast's max reduced in
// the same order and folded by the same function; n_bad is an integer
// count.  A lane runs through the same arithmetic as a solo launch, so it
// is bitwise solo.
//
// Bound: bytes.  B*n_pad*C*4 in, 2*B*n_pad*4 out (a, h), the up layout's
// offsets, edges and bins read once, the weights and the count: 0.16 MB
// at the 2047-service tier, 4.0 MB at 49,999.  The scratch e stays in L2.
//
// The tile staging and the two segment reductions live in front.cuh,
// shared with frontshard.cu, the node-sharded engine's front over every
// shard of one card.

#include <cuda_runtime.h>

#include <cstdint>

#include "front.cuh"

namespace {

struct FrontArgs {
  float* features;            // [n_rows, C]; persisting: bad rows zeroed
  const float* anomaly_w;     // [C]
  const float* hard_w;        // [C]
  float* a;                   // [n_rows]: a_raw after phase 1, then a
  float* h;                   // [n_rows]
  float* e;                   // [n_rows] scratch: the error rates
  int* counts;                // [1 + grid]: n_bad, then one slot per CTA
  const int* offsets;         // the up layout, shared by the lanes
  const int* other;
  const int* long_ids;
  const int* short_ids;
  int n_long;
  int n_short;
  int n_pad;                  // rows per lane = segments of the layout
  int n_rows;                 // n_lanes * n_pad
  int n_lanes;
  int n_channels;
  int err_col;
  float weight;
  int fold;                   // 0: a = a_raw (a contrast weight of 0)
  int bulk;                   // the features start 16-byte aligned
};

template <bool kPersist>
__global__ void __launch_bounds__(kThreads) front_kernel(FrontArgs p) {
  extern __shared__ __align__(128) float tile[];   // kThreads * C
  __shared__ __align__(8) uint64_t full;
  __shared__ float wa[kMaxChannels];
  __shared__ float wh[kMaxChannels];
  __shared__ float partial[kWarps];
  __shared__ int partial_bad[kWarps];
  const int C = p.n_channels;
  const int n_tiles = (p.n_rows + kThreads - 1) / kThreads;
  front_setup(p.anomaly_w, p.hard_w, C, wa, wh, &full);

  // -- phase 1: the row pass, each tile staged through the TMA -----------
  uint32_t parity = 0;   // the phase of `full` to wait for
  int bad_rows = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int count = min(kThreads, p.n_rows - t * kThreads) * C;
    const float* src = p.features + static_cast<size_t>(t) * kThreads * C;
    stage_tile<!kPersist>(tile, src, count, p.bulk && count % 4 == 0, &full,
                          &parity);
    const int r = t * kThreads + threadIdx.x;
    bool bad = false;
    if (r < p.n_rows) {
      bad = front_row(tile + threadIdx.x * C, wa, wh, C, p.err_col, p.a + r,
                      p.h + r, p.e + r);
      if (kPersist && bad) {
        float* row = p.features + static_cast<size_t>(r) * C;
        for (int c = 0; c < C; ++c) row[c] = 0.0f;
      }
    }
    // also the barrier after which the tile may be refilled
    bad_rows += __syncthreads_count(bad);
  }
  if (threadIdx.x == 0) p.counts[1 + blockIdx.x] = bad_rows;

  cg::this_grid().sync();

  // -- n_bad: CTA 0 sums the slots --------------------------------------
  if (blockIdx.x == 0) {
    int sum = 0;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
      sum += __ldcg(p.counts + 1 + i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_down_sync(kFull, sum, off);
    }
    if ((threadIdx.x & 31) == 0) partial_bad[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += partial_bad[w];
      p.counts[0] = total;
    }
  }
  if (!p.fold) return;

  // -- phase 2: the contrast over the up layout, every lane ---------------
  const int chunks = (p.n_short + kThreads - 1) / kThreads;
  const int per_lane = p.n_long + chunks;
  const long long items = static_cast<long long>(per_lane) * p.n_lanes;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int lane = static_cast<int>(w / per_lane);
    const int j = static_cast<int>(w % per_lane);
    const size_t off = static_cast<size_t>(lane) * p.n_pad;
    float* a = p.a + off;
    const float* e = p.e + off;
    if (j < p.n_long) {
      const int s = __ldg(p.long_ids + j);
      contrast_long(p.offsets, p.other, s, s, p.weight, a, e, partial);
    } else {
      const int i = (j - p.n_long) * kThreads + static_cast<int>(threadIdx.x);
      if (i < p.n_short) {
        const int s = __ldg(p.short_ids + i);
        contrast_short(p.offsets, p.other, s, s, p.weight, a, e);
      }
    }
  }
}

void* kernel_for(int persist) {
  return persist ? reinterpret_cast<void*>(&front_kernel<true>)
                 : reinterpret_cast<void*>(&front_kernel<false>);
}

}  // namespace

// *cap = the most CTAs of the front's kernel (persisting or not) that can
// be resident on the current device at once: the bound a cooperative
// launch's grid must keep.  The wrapper caches it per device and width.
extern "C" int rca_evidence_front_fused_cap(int n_channels, int persist,
                                            int* cap) {
  return front_co_resident(kernel_for(persist), n_channels, cap);
}

// One cooperative launch of the front over n_lanes lanes of n_pad rows
// with `grid` CTAs (1 <= grid <= the cap above); `counts` holds 1 + grid
// ints.  Returns the cudaError_t of the launch.
extern "C" int rca_evidence_front_fused(
    float* features, const float* anomaly_w, const float* hard_w, float* a,
    float* h, float* e, int* counts, int n_lanes, int n_pad, int n_channels,
    int err_col, float weight, int fold, int persist, const int* offsets,
    const int* other, const int* long_ids, int n_long, const int* short_ids,
    int n_short, int grid, void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || err_col < 0 ||
      err_col >= n_channels || n_pad < 1 || n_lanes < 1 || grid < 1 ||
      n_long < 0 || n_short < 0 || n_long + n_short != n_pad ||
      static_cast<long long>(n_lanes) * n_pad > (1LL << 31) - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FrontArgs args{features, anomaly_w, hard_w, a, h, e, counts, offsets,
                 other, long_ids, short_ids, n_long, n_short, n_pad,
                 n_lanes * n_pad, n_lanes, n_channels, err_col, weight, fold,
                 reinterpret_cast<std::uintptr_t>(features) % 16 == 0};
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_for(persist), dim3(grid), dim3(kThreads), params,
      tile_bytes(n_channels), static_cast<cudaStream_t>(stream)));
}
