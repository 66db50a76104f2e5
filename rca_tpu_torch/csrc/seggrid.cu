// All the steps of one propagation recursion in one cooperative launch
// over the whole card, for Hopper (sm_90a): the form the engine's plan
// takes where a graph does not fit one CTA's shared memory (segsteps.cu).
//
// Replaces, on the engine's main path above the 2047-service tier, the 8
// launches of segstep.cu's per-step kernels that composed each recursion,
// and through them the TPU kernels rca_tpu/engine/segscan.py::
// pallas_segscan_max and ::pallas_segscan inside the step bodies
// ::up_seg_step and ::down_seg_step, which rca_tpu/engine/propagate.py
// runs under lax.scan.  The recursions are segsteps.cu's: over the CSR
// form of one scan direction (segment s owns the sorted edges, o_e the
// edge's other endpoint),
//
//   up   (explain-away, K3):  u_0 = 0,
//        u_{k+1}[s] = max(u_k[s], max_e max(h[o_e], g*u_k[o_e]))
//   down (impact, K2):        m_0 = 0,
//        m_{k+1}[d] = inv_deg[d] * sum_e (a_ex[o_e] + g*m_k[o_e])
//
// and each entry writes u_steps / m_steps.
//
// Why one launch: a step moves 1.3-1.5 MB at the 49,999-service tier,
// under half a microsecond at 3.35 TB/s, yet a per-step launch costs the
// card 4-6 us of launch, ramp and tail, 8 times each way.  The graph's
// gathers need the whole card, so the recursion stays spread over it:
// one persistent grid whose steps a grid barrier separates.
//
// The design:
//   - a persistent cooperative grid (cudaLaunchCooperativeKernel) sized to
//     the work and capped at the co-resident bound of the occupancy API
//     (rca_seg_steps_grid_cap), as front.cu's.  Steps are separated by
//     cooperative_groups' grid sync, which every CTA reaches: no CTA
//     returns early, the loops only skip;
//   - the work items of one lane, each one CTA's for a step: a big
//     segment (> 256 edges: the largest hubs, the padding run) is one
//     item, reduced by all 256 threads as segstep.cu's block reduces it;
//     each 8 other long segments (the host's bin, > SHORT_SEGMENT_MAX
//     edges) are one item, a warp each; each 256 short segments one item,
//     a thread each.
//     The wrapper sizes the grid (engine/segscan.py::steps_grid): g_items
//     CTAs along a lane's items, g_lanes along the lanes, at most the cap.
//     CTA c = lg * g_items + jg takes, for every step, items
//     [jg * n / g_items, (jg + 1) * n / g_items) of lanes
//     [lg * B / g_lanes, (lg + 1) * B / g_lanes): each item of each lane
//     once, and CTAs' shares differ by one item at most;
//   - the host lays each layout out in item order (SegLayout's item_*
//     fields: the big segments, the other long ones, then the short, each
//     segment's edges contiguous), so a CTA's items own one contiguous run of positions
//     and of edges.  The CTA stages that run once, before the first step,
//     in its shared memory: the edges' other endpoints with one bulk copy
//     of the Tensor Memory Accelerator (cp.async.bulk, an mbarrier
//     completing it; the ragged end and a misaligned base take plain
//     loads), the positions' edge offsets and segment ids with plain
//     loads.  A run above the stage (the padding run at 49,999, 6,629
//     edges) is read from device memory instead;
//   - each node's gathered value w_k[s] = value(in[s], x_k[s]) is computed
//     once per step by the node's owner and kept in a double-buffered
//     scratch of 2*B*n_pad floats (the caller's, 0.43 MB a lane at 49,999:
//     it stays in L2), so an edge gathers one float.  Step 0 gathers
//     value(in[o], 0) from the input itself, which is the same bits and
//     saves a barrier.  The owner updates x = out in place (only the
//     owner's thread, the same at every step, reads it back);
//   - w is written inside the launch, so it is read with plain loads,
//     never through the read-only path (__ldg), which may keep the line
//     the same buffer held two steps before.  The grid barrier is a
//     release and an acquire at device scope, which orders the step's
//     writes before the next step's plain loads; those may hit in L1,
//     which matters where many edges gather one node (a hub's dependents
//     in the up layout: with __ldcg, L2 only, the up recursion at 49,999
//     services took 1.8x as long, PERF.md §6).  front.cu reads its
//     scratch the same way.  The input, inv_deg and the layout are
//     read-only here.
//
// Bitwise equal to `steps` launches of segstep.cu's per-step kernel, since
// every value and every segment's reduction is the same (segsteps.cu's
// argument): value(o, x) and the epilogues spelled with the same _rn
// intrinsics, so nvcc contracts nothing into an fma; a short segment is
// one thread walking its edges in order from 0, four loads in flight; a
// big one is segstep.cu's 256 threads themselves (each a walk by 256 from
// the segment's start, the shuffle tree, the walk over the 8 warps'
// partials); another long one is one warp that plays those 256 threads
// (lane l holds threads l + 32 v, v < 8: at most 256 edges, so one load
// each, all in flight; then the shuffle tree per v and the walk over the
// 8 partials), as segsteps.cu's long walk does.
//
// The padding run: padded edges self-loop on the dummy slot, a run three
// times the largest hub at 49,999.  Where the host certified that the
// dummy's segment holds only dummy->dummy edges (pad_item), every edge of
// it gathers one value v = w_k[dummy], and two exact shortcuts skip the
// walk: up, a max over copies of v >= 0 from 0 is v (taken for v > 0 or
// v == +0); down, a sum of copies of +0 is +0 in any order (taken when
// the bits of v are +0, as the engine's background excess leaves a
// padding slot).  Otherwise the run is walked in full.  Either way the
// dummy's output is bitwise what the walk gives.
//
// Lanes: a lane's vectors sit lane * n_pad entries in (inv_deg and the
// layout shared); a lane goes through the same threads' arithmetic as a
// solo launch, so it is bitwise solo.
//
// Bound: bytes.  One pass over the CSR, the read-only vectors and the
// output (kernels/cost.py::up_steps / ::down_steps, the same work as
// segsteps.cu's): 1.06 / 1.28 MB (up / down) at 49,999, 0.32 / 0.38 us
// at 3.35 TB/s.  What the launch costs beyond that is one launch and
// ramp, 7 grid barriers and each step's longest chain of gathers.

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
// does not apply.
struct UpGrid {
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

struct GridArgs {
  const float* in;            // [B, n_pad]: h or a_ex
  const float* inv_deg;       // [n_pad], shared by the lanes (down only)
  float* w;                   // [2, B, n_pad] scratch: w_k, double-buffered
  float* out;                 // [B, n_pad]: x_k, then x_steps
  const int* item_seg;        // [n_pad] segment ids in item order
  const int* item_offsets;    // [n_pad + 1] their edge offsets
  const int* item_other;      // [e_pad] the other endpoints in item order
  int n_big;                  // big segments, the first positions
  int n_long;                 // long segments, the big ones included
  int n_pad;
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

// the first position of item j: the big segments one an item, then the
// other long ones kWarps an item, then the short ones kThreads an item
__device__ __forceinline__ int item_start(const GridArgs& p, int j) {
  if (j < p.n_big) return j;
  j -= p.n_big;
  if (j < p.n_groups) return p.n_big + j * kWarps;
  return min(p.n_pad, p.n_long + (j - p.n_groups) * kThreads);
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
// same thread at the step before).
struct Own {
  float self;
  float in;
  float scale;
};

template <class Op, bool kFirst>
__device__ __forceinline__ Own own_of(const GridArgs& p, const float* in,
                                      const float* x, int s) {
  return Own{kFirst ? 0.0f : x[s], __ldg(in + s), Op::scale(p.inv_deg, s)};
}

// the step's epilogue at segment s: x_{k+1} into out, w_{k+1} for the
// next step's gathers
template <class Op>
__device__ __forceinline__ void finish(const GridArgs& p, const Own& own,
                                       float* x, float* w_next, int s,
                                       float total, bool last) {
  const float next = Op::finish(total, own.self, own.scale);
  x[s] = next;
  if (!last) w_next[s] = Op::value(p.gamma, own.in, next);
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
    float* x = p.out + off;
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
        if (q < p.n_pad) {
          short_segment<Op, kFirst>(p, sl, q, in, w, x, w_next, last);
        }
      }
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads) seg_grid_kernel(GridArgs p) {
  extern __shared__ __align__(128) int stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[kWarps];
  const int jg = static_cast<int>(blockIdx.x) % p.g_items;
  const int lg = static_cast<int>(blockIdx.x) / p.g_items;
  const int j0 = static_cast<int>(
      static_cast<long long>(jg) * p.n_items / p.g_items);
  const int j1 = static_cast<int>(
      static_cast<long long>(jg + 1) * p.n_items / p.g_items);
  const int b0 = lg * p.n_lanes / p.g_lanes;
  const int b1 = (lg + 1) * p.n_lanes / p.g_lanes;
  const Slice sl =
      stage_run(p, item_start(p, j0), item_start(p, j1), stage, &full);

  const size_t lanes = static_cast<size_t>(p.n_lanes) * p.n_pad;
  float* read = p.w;           // w_k for the step that reads it
  float* write = p.w + lanes;
  // step 0 gathers from the input (its ``w`` is not read) and writes w_1
  // into the buffer step 1 reads
  grid_step<Op, true>(p, sl, j0, j1, b0, b1, write, read, p.steps == 1,
                      partial);
  for (int k = 1; k < p.steps; ++k) {
    // w_k complete everywhere, and no one reads w_{k-1} any more
    cg::this_grid().sync();
    grid_step<Op, false>(p, sl, j0, j1, b0, b1, read, write,
                         k == p.steps - 1, partial);
    float* done = read;
    read = write;
    write = done;
  }
}

template <class Op>
void* kernel_of() {
  return reinterpret_cast<void*>(&seg_grid_kernel<Op>);
}

constexpr size_t kStageBytes = sizeof(int) * kStage;

template <class Op>
int grid_cap(int* cap) {
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
        &per_sm, kernel_of<Op>(), kThreads, kStageBytes);
  }
  *cap = per_sm * sms;
  return static_cast<int>(err);
}

template <class Op>
int launch(const float* in, const float* inv_deg, float gamma, int steps,
           const int* item_seg, const int* item_offsets,
           const int* item_other, int n_long, int n_big, int pad_item,
           int n_lanes, int n_pad, float* scratch, float* out, int g_items,
           int g_lanes, void* stream) {
  if (steps < 1 || n_lanes < 1 || n_pad < 1 || n_big < 0 || n_long < n_big ||
      n_long > n_pad || pad_item < -1 || pad_item >= n_long ||
      static_cast<long long>(n_lanes) * n_pad > (1LL << 31) - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_groups = (n_long - n_big + kWarps - 1) / kWarps;
  const int n_items =
      n_big + n_groups + (n_pad - n_long + kThreads - 1) / kThreads;
  if (g_items < 1 || g_items > n_items || g_lanes < 1 || g_lanes > n_lanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GridArgs args{in, inv_deg, scratch, out, item_seg, item_offsets,
                item_other, n_big, n_long, n_pad, n_lanes, steps, pad_item,
                n_groups, n_items, g_items, g_lanes, gamma,
                reinterpret_cast<std::uintptr_t>(item_other) % 16 == 0};
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel_of<Op>(), dim3(g_items * g_lanes), dim3(kThreads), params,
      kStageBytes, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// *cap = the most CTAs of one recursion's grid kernel (down != 0: the
// impact's) co-resident on the current device: the bound the launch's
// grid keeps.  The wrapper caches it per device.
extern "C" int rca_seg_steps_grid_cap(int down, int* cap) {
  return down ? grid_cap<DownGrid>(cap) : grid_cap<UpGrid>(cap);
}

// Each entry runs `steps` >= 1 steps of one recursion over n_lanes lanes
// of n_pad entries in one cooperative launch of g_items x g_lanes CTAs
// (their product at most the cap above), over a layout in item order
// with n_long long segments, the first n_big of them big (pad_item: the
// certified padding run's position, or -1), with `scratch` holding 2 * n_lanes * n_pad floats,
// and returns the cudaError_t of the launch.
extern "C" int rca_seg_up_steps_grid(const float* h, float gamma, int steps,
                                     const int* item_seg,
                                     const int* item_offsets,
                                     const int* item_other, int n_long,
                                     int n_big, int pad_item, int n_lanes,
                                     int n_pad,
                                     float* scratch, float* out,
                                     int g_items, int g_lanes,
                                     void* stream) {
  return launch<UpGrid>(h, nullptr, gamma, steps, item_seg, item_offsets,
                        item_other, n_long, n_big, pad_item, n_lanes, n_pad,
                        scratch, out, g_items, g_lanes, stream);
}

extern "C" int rca_seg_down_steps_grid(const float* a_ex,
                                       const float* inv_deg, float gamma,
                                       int steps, const int* item_seg,
                                       const int* item_offsets,
                                       const int* item_other, int n_long,
                                       int n_big, int pad_item, int n_lanes,
                                       int n_pad,
                                       float* scratch, float* out,
                                       int g_items, int g_lanes,
                                       void* stream) {
  return launch<DownGrid>(a_ex, inv_deg, gamma, steps, item_seg,
                          item_offsets, item_other, n_long, n_big, pad_item,
                          n_lanes, n_pad, scratch, out, g_items, g_lanes,
                          stream);
}
