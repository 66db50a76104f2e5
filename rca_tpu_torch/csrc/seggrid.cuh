// The grid recursions' device code, shared by seggrid.cu (the dense
// engine's recursions above one CTA), segshard.cu (the node-sharded
// engine's recursions over every shard of one card) and segpeer.cu (its
// recursions over distinct cards, one launch a card): the work items, the
// staging of a CTA's layout run, the three segment reductions and the
// persistent cooperative kernel over one layout in item order.  seggrid.cu's
// header says what the kernel computes, why it is one launch and why it is
// bitwise the per-step launches.
//
// A layout here has n_seg positions (segments in item order); the vectors
// an edge gathers from, and the scratch of gathered values, have lanes of
// n_pad entries, and the output lanes of out_stride entries.  The dense
// recursions and the shards' merged up layout have n_seg == out_stride ==
// n_pad; the shards' impact contributions (segshard.cu) write one entry per
// position, out_stride == n_seg, and leave the gathered values to their
// second phase (an Op with kOwner false).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // short segments per item, threads a CTA,
                                // and segstep.cu's threads per long segment
constexpr int kWarps = kThreads / 32;   // long segments per item
constexpr int kStage = 6144;    // ints of a CTA's staged layout (24 KB)
constexpr unsigned kFull = 0xffffffffu;

// value(gamma, in, x) is what an edge gathers from its other endpoint
// whose state is x (segstep.cu's UpStep / DownStep::value, so the same
// bits); finish(total, self, scale) the step's epilogue, scale(inv_deg, s)
// the node's factor in it (none for the up-step); pad_total the exact
// shortcut over the certified padding run of copies of v, false where it
// does not apply.  kOwner: segment s is node s, whose epilogue also writes
// the value the next step gathers from it.
struct UpGrid {
  static constexpr bool kOwner = true;
  static __device__ __forceinline__ float value(float gamma, float in,
                                                float x) {
    return fmaxf(in, __fmul_rn(gamma, x));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float finish(float total, float self,
                                                 float) {
    return fmaxf(self, total);
  }
  static __device__ __forceinline__ float scale(const float*, int) {
    return 1.0f;
  }
  static __device__ __forceinline__ bool pad_total(float v, float* total) {
    if (!(v > 0.0f) && __float_as_uint(v) != 0u) return false;
    *total = v;
    return true;
  }
};

struct DownGrid {
  static constexpr bool kOwner = true;
  static __device__ __forceinline__ float value(float gamma, float in,
                                                float x) {
    return __fadd_rn(in, __fmul_rn(gamma, x));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float finish(float total, float,
                                                 float scale) {
    return __fmul_rn(total, scale);
  }
  static __device__ __forceinline__ float scale(const float* inv_deg, int s) {
    return __ldg(inv_deg + s);
  }
  static __device__ __forceinline__ bool pad_total(float v, float* total) {
    if (__float_as_uint(v) != 0u) return false;
    *total = 0.0f;
    return true;
  }
};

// Phase 1 of the shards' impact step (segshard.cu, segpeer.cu): a (shard,
// destination) pair's unscaled sum of segstep.cu's DownSumStep values,
// written to the pair's slot; the pair is no node, so it reads nothing of
// its own and writes no gathered value.
struct DownPart {
  static constexpr bool kOwner = false;
  static __device__ __forceinline__ float value(float gamma, float in,
                                                float x) {
    return __fadd_rn(in, __fmul_rn(gamma, x));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float finish(float total, float,
                                                 float) {
    return total;
  }
  static __device__ __forceinline__ float scale(const float*, int) {
    return 1.0f;
  }
  static __device__ __forceinline__ bool pad_total(float, float*) {
    return false;
  }
};

struct GridArgs {
  const float* in;            // [B, n_pad]: h or a_ex
  const float* inv_deg;       // [n_pad], shared by the lanes (down only)
  float* w;                   // [2, B, n_pad] scratch: w_k, double-buffered
  float* out;                 // [B, out_stride]: x_k, then x_steps
  const int* item_seg;        // [n_seg] segment ids in item order
  const int* item_offsets;    // [n_seg + 1] their edge offsets
  const int* item_other;      // [e] the other endpoints in item order
  int n_big;                  // big segments, the first positions
  int n_long;                 // long segments, the big ones included
  int n_seg;                  // positions of the layout
  int n_pad;                  // entries of a lane of in and w
  int out_stride;             // entries of a lane of out
  int n_lanes;
  int steps;
  int pad_item;               // the certified padding run's position, or -1
  int n_groups;               // items of the other long segments
  int n_items;                // items a lane
  int g_items;                // CTAs along the items
  int g_lanes;                // CTAs along the lanes
  float gamma;
  int bulk;                   // item_other starts 16-byte aligned
};

// A CTA's view of its layout run: staged in shared memory, or the device
// arrays themselves (base 0).
struct Slice {
  const int* offs;   // offs[q - qbase], q a position
  const int* segs;
  int qbase;
  const int* edges;  // edges[e - ebase]
  int ebase;
};

// the items of a layout of n_seg positions, n_long long and n_big big
__host__ __device__ __forceinline__ int groups_of(int n_long, int n_big) {
  return (n_long - n_big + kWarps - 1) / kWarps;
}

__host__ __device__ __forceinline__ int items_of(int n_seg, int n_long,
                                                 int n_big) {
  return n_big + groups_of(n_long, n_big) +
         (n_seg - n_long + kThreads - 1) / kThreads;
}

// the first position of item j: the big segments one an item, then the
// other long ones kWarps an item, then the short ones kThreads an item
__device__ __forceinline__ int item_start(const GridArgs& p, int j) {
  if (j < p.n_big) return j;
  j -= p.n_big;
  if (j < p.n_groups) return p.n_big + j * kWarps;
  return min(p.n_seg, p.n_long + (j - p.n_groups) * kThreads);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// One thread: the bulk copy of ``bytes`` (a multiple of 16, both ends
// 16-byte aligned) into the shared ``dst``, completing ``bar``'s count.
__device__ __forceinline__ void bulk_load(int* dst, const int* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

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

// The CTA's run of positions [q0, q1) and their edges: staged once where
// it fits kStage ints, else read where it lies.
__device__ Slice stage_run(const GridArgs& p, int q0, int q1, int* stage,
                           uint64_t* full) {
  const int e0 = __ldg(p.item_offsets + q0) & ~3;   // 16-byte aligned
  const int e1 = __ldg(p.item_offsets + q1);
  const int ne = (e1 - e0 + 3) & ~3;
  const int nq = q1 - q0;
  if (ne + 2 * nq + 1 > kStage) {
    return Slice{p.item_offsets, p.item_seg, 0, p.item_other, 0};
  }
  int* edges = stage;
  int* offs = stage + ne;
  int* segs = offs + nq + 1;
  const int tid = static_cast<int>(threadIdx.x);
  const int e_bulk = p.bulk ? (e1 & ~3) : e0;   // [e0, e_bulk) in bulk
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (e_bulk > e0) {
      bulk_load(edges, p.item_other + e0, 4u * (e_bulk - e0), full);
    }
  }
  for (int e = e_bulk + tid; e < e1; e += kThreads) {
    edges[e - e0] = __ldg(p.item_other + e);
  }
  for (int i = tid; i <= nq; i += kThreads) {
    offs[i] = __ldg(p.item_offsets + q0 + i);
  }
  for (int i = tid; i < nq; i += kThreads) {
    segs[i] = __ldg(p.item_seg + q0 + i);
  }
  __syncthreads();   // the mbarrier's init, before anyone waits on it
  if (e_bulk > e0) barrier_wait(full, 0);
  __syncthreads();
  return Slice{offs, segs, q0, edges, e0};
}

// what an edge gathers from node o at a step: value(in[o], 0) at step 0,
// w_k[o] after (written in this launch: a plain load, never the read-only
// path)
template <class Op, bool kFirst>
__device__ __forceinline__ float gathered(const GridArgs& p, const float* in,
                                          const float* w, int o) {
  return kFirst ? Op::value(p.gamma, __ldg(in + o), 0.0f) : w[o];
}

// What the epilogue of segment s reads besides its total: x_k[s], the
// input and the scale, loaded before the segment's gathers so their
// latency overlaps (only the segment's owner reads x[s], written by the
// same thread at the step before).  A segment that is no node's reads
// nothing.
struct Own {
  float self;
  float in;
  float scale;
};

template <class Op, bool kFirst>
__device__ __forceinline__ Own own_of(const GridArgs& p, const float* in,
                                      const float* x, int s) {
  if constexpr (!Op::kOwner) {
    return Own{0.0f, 0.0f, 1.0f};
  } else {
    return Own{kFirst ? 0.0f : x[s], __ldg(in + s), Op::scale(p.inv_deg, s)};
  }
}

// the step's epilogue at segment s: x_{k+1} into out, and for a node
// w_{k+1} for the next step's gathers
template <class Op>
__device__ __forceinline__ void finish(const GridArgs& p, const Own& own,
                                       float* x, float* w_next, int s,
                                       float total, bool last) {
  const float next = Op::finish(total, own.self, own.scale);
  x[s] = next;
  if constexpr (Op::kOwner) {
    if (!last) w_next[s] = Op::value(p.gamma, own.in, next);
  }
}

// One short segment at position q: one thread, in edge order, four
// edges' loads in flight (segstep.cu's short walk).
template <class Op, bool kFirst>
__device__ __forceinline__ void short_segment(const GridArgs& p,
                                              const Slice& sl, int q,
                                              const float* in, const float* w,
                                              float* x, float* w_next,
                                              bool last) {
  const int s = sl.segs[q - sl.qbase];
  const Own own = own_of<Op, kFirst>(p, in, x, s);
  const int end = sl.offs[q - sl.qbase + 1] - sl.ebase;
  int e = sl.offs[q - sl.qbase] - sl.ebase;
  float acc = 0.0f;
  for (; e + 4 <= end; e += 4) {
    const float v0 = gathered<Op, kFirst>(p, in, w, sl.edges[e]);
    const float v1 = gathered<Op, kFirst>(p, in, w, sl.edges[e + 1]);
    const float v2 = gathered<Op, kFirst>(p, in, w, sl.edges[e + 2]);
    const float v3 = gathered<Op, kFirst>(p, in, w, sl.edges[e + 3]);
    acc = Op::combine(acc, v0);
    acc = Op::combine(acc, v1);
    acc = Op::combine(acc, v2);
    acc = Op::combine(acc, v3);
  }
  for (; e < end; ++e) {
    acc = Op::combine(acc, gathered<Op, kFirst>(p, in, w, sl.edges[e]));
  }
  finish<Op>(p, own, x, w_next, s, acc, last);
}

// One big segment at position q: all the CTA's threads, segstep.cu's
// block reduction, or the padding run's shortcut.  Every thread calls it
// (the branch is uniform over the CTA).
template <class Op, bool kFirst>
__device__ __forceinline__ void big_segment(const GridArgs& p,
                                            const Slice& sl, int q,
                                            const float* in, const float* w,
                                            float* x, float* w_next,
                                            bool last, float* partial) {
  const int tid = static_cast<int>(threadIdx.x);
  const int s = sl.segs[q - sl.qbase];
  const Own own = own_of<Op, kFirst>(p, in, x, s);
  float total = 0.0f;
  // the certified run gathers the dummy's own value at every edge; the
  // test is uniform over the CTA
  if (q == p.pad_item &&
      Op::pad_total(gathered<Op, kFirst>(p, in, w, s), &total)) {
    if (tid == 0) finish<Op>(p, own, x, w_next, s, total, last);
    return;
  }
  const int end = sl.offs[q - sl.qbase + 1] - sl.ebase;
  float acc = 0.0f;
#pragma unroll 4
  for (int e = sl.offs[q - sl.qbase] - sl.ebase + tid; e < end;
       e += kThreads) {
    acc = Op::combine(acc, gathered<Op, kFirst>(p, in, w, sl.edges[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = Op::combine(acc, __shfl_down_sync(kFull, acc, off));
  }
  if ((tid & 31) == 0) partial[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    total = partial[0];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) total = Op::combine(total, partial[v]);
    finish<Op>(p, own, x, w_next, s, total, last);
  }
  __syncthreads();   // partial is rewritten by the next big segment
}

// One other long segment at position q (at most 256 edges): one warp
// playing segstep.cu's 256 threads (segsteps.cu's long walk), or the
// padding run's shortcut.
template <class Op, bool kFirst>
__device__ __forceinline__ void long_segment(const GridArgs& p,
                                             const Slice& sl, int q, int lane,
                                             const float* in, const float* w,
                                             float* x, float* w_next,
                                             bool last) {
  const int s = sl.segs[q - sl.qbase];
  const Own own = own_of<Op, kFirst>(p, in, x, s);
  float total = 0.0f;
  // the certified run gathers the dummy's own value at every edge; the
  // test is uniform over the warp
  if (q == p.pad_item &&
      Op::pad_total(gathered<Op, kFirst>(p, in, w, s), &total)) {
    if (lane == 0) finish<Op>(p, own, x, w_next, s, total, last);
    return;
  }
  const int beg = sl.offs[q - sl.qbase] - sl.ebase;
  const int end = sl.offs[q - sl.qbase + 1] - sl.ebase;
  float part[kWarps];
#pragma unroll
  for (int v = 0; v < kWarps; ++v) part[v] = 0.0f;
  for (int c = beg + lane; c < end; c += kThreads) {
    float got[kWarps];
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      got[v] = c + 32 * v < end
                   ? gathered<Op, kFirst>(p, in, w, sl.edges[c + 32 * v])
                   : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      if (c + 32 * v < end) part[v] = Op::combine(part[v], got[v]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float got[kWarps];
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      got[v] = __shfl_down_sync(kFull, part[v], off);
    }
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      part[v] = Op::combine(part[v], got[v]);
    }
  }
  if (lane == 0) {
    total = part[0];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) total = Op::combine(total, part[v]);
    finish<Op>(p, own, x, w_next, s, total, last);
  }
}

// One step of the CTA's items [j0, j1) over its lanes [b0, b1), reading
// w_k from ``w_all`` (unused at step 0) and writing w_{k+1} to
// ``w_next_all`` (skipped at the last step).  A block barrier only around
// a big segment's partials: another long segment is one warp's, a short
// one a thread's.
template <class Op, bool kFirst>
__device__ void grid_step(const GridArgs& p, const Slice& sl, int j0, int j1,
                          int b0, int b1, const float* w_all,
                          float* w_next_all, bool last, float* partial) {
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int b = b0; b < b1; ++b) {
    const size_t off = static_cast<size_t>(b) * p.n_pad;
    const float* in = p.in + off;
    const float* w = w_all + off;
    float* w_next = w_next_all + off;
    float* x = p.out + static_cast<size_t>(b) * p.out_stride;
    for (int j = j0; j < j1; ++j) {
      if (j < p.n_big) {
        big_segment<Op, kFirst>(p, sl, j, in, w, x, w_next, last, partial);
      } else if (j < p.n_big + p.n_groups) {
        const int q = p.n_big + (j - p.n_big) * kWarps + warp;
        if (q < p.n_long) {
          long_segment<Op, kFirst>(p, sl, q, lane, in, w, x, w_next, last);
        }
      } else {
        const int q =
            p.n_long + (j - p.n_big - p.n_groups) * kThreads + tid;
        if (q < p.n_seg) {
          short_segment<Op, kFirst>(p, sl, q, in, w, x, w_next, last);
        }
      }
    }
  }
}

// The CTA's items and lanes of the launch (CTA c = lg * g_items + jg: the
// items [jg * n / g_items, (jg + 1) * n / g_items) of the lanes
// [lg * B / g_lanes, (lg + 1) * B / g_lanes)), and its layout run staged.
struct Share {
  int j0, j1, b0, b1;
  Slice sl;
};

__device__ __forceinline__ Share share_of(const GridArgs& p, int* stage,
                                          uint64_t* full) {
  const int jg = static_cast<int>(blockIdx.x) % p.g_items;
  const int lg = static_cast<int>(blockIdx.x) / p.g_items;
  const int j0 = static_cast<int>(
      static_cast<long long>(jg) * p.n_items / p.g_items);
  const int j1 = static_cast<int>(
      static_cast<long long>(jg + 1) * p.n_items / p.g_items);
  return Share{j0, j1, lg * p.n_lanes / p.g_lanes,
               (lg + 1) * p.n_lanes / p.g_lanes,
               stage_run(p, item_start(p, j0), item_start(p, j1), stage,
                         full)};
}

template <class Op>
__global__ void __launch_bounds__(kThreads) seg_grid_kernel(GridArgs p) {
  extern __shared__ __align__(128) int stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[kWarps];
  const Share sh = share_of(p, stage, &full);

  const size_t lanes = static_cast<size_t>(p.n_lanes) * p.n_pad;
  float* read = p.w;           // w_k for the step that reads it
  float* write = p.w + lanes;
  // step 0 gathers from the input (its ``w`` is not read) and writes w_1
  // into the buffer step 1 reads
  grid_step<Op, true>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, write, read,
                      p.steps == 1, partial);
  for (int k = 1; k < p.steps; ++k) {
    // w_k complete everywhere, and no one reads w_{k-1} any more
    cg::this_grid().sync();
    grid_step<Op, false>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, read, write,
                         k == p.steps - 1, partial);
    float* done = read;
    read = write;
    write = done;
  }
}

constexpr size_t kStageBytes = sizeof(int) * kStage;

// *cap = the most CTAs of ``kernel`` (kThreads threads, kStageBytes of
// dynamic shared memory) co-resident on the current device
inline int co_resident(const void* kernel, int* cap) {
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
        &per_sm, kernel, kThreads, kStageBytes);
  }
  *cap = per_sm * sms;
  return static_cast<int>(err);
}

template <class Op>
void* kernel_of() {
  return reinterpret_cast<void*>(&seg_grid_kernel<Op>);
}

template <class Op>
int grid_cap(int* cap) {
  return co_resident(kernel_of<Op>(), cap);
}

// The arguments of a recursion over a layout of n_seg positions whose
// output lanes hold out_stride entries, or an invalid value's error.
inline int grid_args(GridArgs* args, const float* in, const float* inv_deg,
                     float gamma, int steps, const int* item_seg,
                     const int* item_offsets, const int* item_other,
                     int n_seg, int n_long, int n_big, int pad_item,
                     int n_lanes, int n_pad, int out_stride, float* scratch,
                     float* out, int g_items, int g_lanes) {
  if (steps < 1 || n_lanes < 1 || n_pad < 1 || n_seg < 0 || n_big < 0 ||
      n_long < n_big || n_long > n_seg || pad_item < -1 ||
      pad_item >= n_long ||
      static_cast<long long>(n_lanes) * n_pad > (1LL << 31) - kThreads ||
      static_cast<long long>(n_lanes) * out_stride >
          (1LL << 31) - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_items = items_of(n_seg, n_long, n_big);
  if (g_items < 1 || g_items > (n_items > 0 ? n_items : 1) || g_lanes < 1 ||
      g_lanes > n_lanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *args = GridArgs{in, inv_deg, scratch, out, item_seg, item_offsets,
                   item_other, n_big, n_long, n_seg, n_pad, out_stride,
                   n_lanes, steps, pad_item, groups_of(n_long, n_big),
                   n_items, g_items, g_lanes, gamma,
                   reinterpret_cast<std::uintptr_t>(item_other) % 16 == 0};
  return 0;
}

// One cooperative launch of a recursion over n_pad segments, each node's
// own (the dense layouts, the shards' merged up layout).
template <class Op>
int launch(const float* in, const float* inv_deg, float gamma, int steps,
           const int* item_seg, const int* item_offsets,
           const int* item_other, int n_long, int n_big, int pad_item,
           int n_lanes, int n_pad, float* scratch, float* out, int g_items,
           int g_lanes, void* stream) {
  GridArgs args;
  const int bad = grid_args(&args, in, inv_deg, gamma, steps, item_seg,
                            item_offsets, item_other, n_pad, n_long, n_big,
                            pad_item, n_lanes, n_pad, n_pad, scratch, out,
                            g_items, g_lanes);
  if (bad) return bad;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_of<Op>(), dim3(g_items * g_lanes), dim3(kThreads), params,
      kStageBytes, static_cast<cudaStream_t>(stream)));
}

}  // namespace
