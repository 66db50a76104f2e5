// One propagation seg step per launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels rca_tpu/engine/segscan.py::pallas_segscan and
// ::pallas_segscan_max together with the step bodies around them,
// ::down_seg_step and ::up_seg_step (gather, flagged scan, s[ends], where,
// epilogue).  Where the per-step entries run: the contrast step in the
// node-sharded engine and as the yardstick of the dense front, which
// reduces its segments the same way inside its one launch (front.cu);
// the *_shard entries of the node-sharded engine, whose steps a
// collective separates; and as the bitwise yardstick of the one-launch
// recursions the dense engine runs (segsteps.cu's one CTA a lane up to
// the 2047-service tier, seggrid.cu's cooperative grid above).  Over the CSR form of one
// scan direction (segment s owns the sorted edges [offsets[s],
// offsets[s+1]), o_e = other[e] is the edge's other endpoint):
//
//   up   (explain-away, K3):  u'[s] = max(u[s], max_e max(h[o_e], g*u[o_e]))
//   down (impact, K2):        m'[d] = inv_deg[d] * sum_e (a_ex[o_e] + g*m[o_e])
//
// with the reduction's identity (0) for a segment without edges.  Both read
// their inputs and write a fresh output: never in place, since a segment
// reads other segments' entries of u / m.
//
// A third step, over the up layout, is the error-source contrast of the
// propagation's front (rca_tpu/engine/propagate.py::error_source_excess
// and ::fold_error_contrast, a gather and a scatter-max there):
//
//   contrast:  a[s] = 1 - (1 - a_raw[s]) * (1 - w*max(e[s] - max_e e[o_e], 0))
//
// with e the error rates the front pass (evidence.cu) wrote.  The up
// layout's segments are the dependents and its other endpoints their
// dependencies, so the segment max is the reference's
// at[dep_src].max(e[dep_dst]) over zeros.
//
// The TPU walked one sequential grid and carried the scan between rows in
// VMEM, so the step was a full prefix scan read at each segment's end.
// Segments are independent, so here each is reduced where it lies, and the
// step is one launch with no carry between blocks and no atomics:
//
//   - short segments (the host's bin, <= 16 edges) take one thread each, in
//     ascending id order, so neighbouring threads walk neighbouring runs;
//     the loop issues four edges' loads before it combines them, in edge
//     order, to keep loads in flight;
//   - long segments (the hub, the padding run on the dummy slot) take one
//     block each: the threads stride over the run, then a warp-shuffle
//     tree and a fixed walk over the warps' partials finish it.
//
// One grid covers both bins: blocks below n_long take a long segment each,
// the rest 256 short segments each.  Every segment is reduced by a fixed
// set of threads in a fixed order, so two runs give the same bits.
//
// Lanes: a launch may carry B lanes, [B, n_pad] vectors that share one
// layout (the hypothesis batch, the counterfactual sweep): the grid's y
// index is the lane, and each lane's vectors sit lane * n_pad entries in.
// inv_deg and the layout are per graph, read by every lane.  A lane goes
// through the same threads in the same order as a launch of one, so it is
// bitwise equal to a solo launch on the same input, and the batch costs one
// launch per step instead of one per lane.
//
// Shards: the node-sharded engine (rca_tpu/parallel/sharded.py::
// _propagate_block, where each device calls pallas_segscan_max at :252 and
// pallas_segscan at :285 over its own edge partition) launches the same
// kernel once per shard through the *_shard entries at the bottom.  A
// shard's segments are not the value vectors' index space: its up-step
// and contrast reduce its `block` own sources, gathering from full-length
// [n_pad] vectors and reading the node's own entry at base + s
// (base = shard * block); its down-step reduces every destination over
// its partition only and writes the unscaled totals, which the
// reduce-scatter and inv_deg finish.  So the kernel takes the segment
// count apart from the value length (each with its own lane stride) and a
// segment base.  A dense launch is the case n_seg == n_val, base 0: the
// same arithmetic, so its bits do not change.  The shard layouts hold real
// edges only, so a padded edge adds nothing to any node of any shard.
//
// Bound: bytes.  other (4 B per edge), offsets, two or three node vectors
// read and one written: about 1.3-1.5 MB at the 50k tier, under half a
// microsecond at 3.35 TB/s; the working set sits in the 50 MB L2.  The
// gathers are indexed, so neither TMA nor the tensor cores apply; what the
// design buys is one launch per step in place of a gather, three scan
// launches and the epilogue's ops, and no edge-sized intermediate in
// device memory.  A launch costs the card 4-6 us whatever the graph, which
// is what segsteps.cu removes where a recursion fits one CTA and
// seggrid.cu, with a grid barrier a step, above.
//
// Rounding: every product and sum is spelled with an _rn intrinsic so nvcc
// cannot contract a*b+c into an fma; the per-edge values and the epilogues
// then round as the plain version's separate torch ops do.  The up-step and
// the contrast reduce with a max, exact in any order, so u' and a are
// bit-equal to the plain version; the down-step's sum runs in another order
// than the plain version's doubling scan.

#include <cuda_runtime.h>

#include "front_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct UpStep {
  const float* u;
  const float* h;
  float gamma;

  __device__ __forceinline__ UpStep lane(size_t in_off, size_t) const {
    return UpStep{u + in_off, h + in_off, gamma};
  }

  __device__ __forceinline__ float value(int o) const {
    return fmaxf(__ldg(h + o), __fmul_rn(gamma, __ldg(u + o)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fmaxf(a, b);
  }
  __device__ __forceinline__ float finish(int s, int base, float total) const {
    return fmaxf(__ldg(u + base + s), total);
  }
};

struct DownStep {
  const float* m;
  const float* a_ex;
  const float* inv_deg;   // per graph: not offset by the lane
  float gamma;

  __device__ __forceinline__ DownStep lane(size_t in_off, size_t) const {
    return DownStep{m + in_off, a_ex + in_off, inv_deg, gamma};
  }

  __device__ __forceinline__ float value(int o) const {
    return __fadd_rn(__ldg(a_ex + o), __fmul_rn(gamma, __ldg(m + o)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ float finish(int s, int, float total) const {
    return __fmul_rn(total, __ldg(inv_deg + s));
  }
};

// The down-step of one shard: the same per-edge values and sum over the
// shard's own edge partition, finished with no epilogue at all (the
// unscaled segment totals; the reduce-scatter over the shards and then
// inv_deg finish the step, as the reference's psum_scatter and multiply
// do).  Not scaling at all is bitwise the same as scaling by 1.0.
struct DownSumStep {
  const float* m;
  const float* a_ex;
  float gamma;

  __device__ __forceinline__ DownSumStep lane(size_t in_off, size_t) const {
    return DownSumStep{m + in_off, a_ex + in_off, gamma};
  }

  __device__ __forceinline__ float value(int o) const {
    return __fadd_rn(__ldg(a_ex + o), __fmul_rn(gamma, __ldg(m + o)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ float finish(int, int, float total) const {
    return total;
  }
};

struct ContrastStep {
  const float* a_raw;
  const float* e;
  float weight;

  // a_raw is indexed like the output, e like the gathered values
  __device__ __forceinline__ ContrastStep lane(size_t in_off,
                                               size_t out_off) const {
    return ContrastStep{a_raw + out_off, e + in_off, weight};
  }

  __device__ __forceinline__ float value(int o) const { return __ldg(e + o); }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fmaxf(a, b);
  }
  __device__ __forceinline__ float finish(int s, int base,
                                          float dep_max) const {
    return contrast_fold(__ldg(a_raw + s), __ldg(e + base + s), dep_max,
                         weight);
  }
};

template <class Step>
__global__ void __launch_bounds__(kThreads)
    seg_step_kernel(Step all_lanes, const int* __restrict__ offsets,
                    const int* __restrict__ other,
                    const int* __restrict__ long_ids, int n_long,
                    const int* __restrict__ short_ids, int n_short,
                    int in_stride, int out_stride, int base,
                    float* __restrict__ out_lanes) {
  const size_t in_off = static_cast<size_t>(blockIdx.y) * in_stride;
  const size_t out_off = static_cast<size_t>(blockIdx.y) * out_stride;
  const Step step = all_lanes.lane(in_off, out_off);
  float* __restrict__ out = out_lanes + out_off;
  if (static_cast<int>(blockIdx.x) < n_long) {
    // one long segment per block (the branch is uniform over the block)
    __shared__ float partial[kWarps];
    const int s = long_ids[blockIdx.x];
    const int end = offsets[s + 1];
    float acc = 0.0f;
#pragma unroll 4
    for (int e = offsets[s] + threadIdx.x; e < end; e += kThreads) {
      acc = Step::combine(acc, step.value(__ldg(other + e)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = Step::combine(acc, __shfl_down_sync(kFull, acc, off));
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = partial[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) total = Step::combine(total, partial[w]);
      out[s] = step.finish(s, base, total);
    }
    return;
  }
  const int i = (static_cast<int>(blockIdx.x) - n_long) * kThreads +
                static_cast<int>(threadIdx.x);
  if (i >= n_short) return;
  const int s = short_ids[i];
  const int end = offsets[s + 1];
  int e = offsets[s];
  float acc = 0.0f;
  for (; e + 4 <= end; e += 4) {
    const int o0 = __ldg(other + e);
    const int o1 = __ldg(other + e + 1);
    const int o2 = __ldg(other + e + 2);
    const int o3 = __ldg(other + e + 3);
    const float v0 = step.value(o0);
    const float v1 = step.value(o1);
    const float v2 = step.value(o2);
    const float v3 = step.value(o3);
    acc = Step::combine(acc, v0);
    acc = Step::combine(acc, v1);
    acc = Step::combine(acc, v2);
    acc = Step::combine(acc, v3);
  }
  for (; e < end; ++e) acc = Step::combine(acc, step.value(__ldg(other + e)));
  out[s] = step.finish(s, base, acc);
}

// n_seg segments write an output lane of n_seg entries; the values the
// edges gather (and, at base + s, the segment's own entry) lie in lanes
// of n_val entries.  A dense step has n_seg == n_val and base 0.
template <class Step>
int launch(const Step& step, const int* offsets, const int* other,
           const int* long_ids, int n_long, const int* short_ids, int n_short,
           int n_lanes, int n_seg, int n_val, int base, float* out,
           void* stream) {
  if (n_long < 0 || n_short < 0 || n_long + n_short != n_seg || n_seg < 1 ||
      n_lanes < 1 || n_lanes > 65535 || base < 0 || base + n_seg > n_val) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_long + (n_short + kThreads - 1) / kThreads, n_lanes);
  seg_step_kernel<Step><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      step, offsets, other, long_ids, n_long, short_ids, n_short, n_val,
      n_seg, base, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry runs one step over n_lanes lanes of n_pad entries (the
// layout's segment count) and returns the cudaError_t of the launch.
extern "C" int rca_seg_up_step(const float* u, const float* h, float gamma,
                               const int* offsets, const int* other,
                               const int* long_ids, int n_long,
                               const int* short_ids, int n_short, int n_lanes,
                               int n_pad, float* out, void* stream) {
  return launch(UpStep{u, h, gamma}, offsets, other, long_ids, n_long,
                short_ids, n_short, n_lanes, n_pad, n_pad, 0, out, stream);
}

extern "C" int rca_seg_down_step(const float* m, const float* a_ex,
                                 const float* inv_deg, float gamma,
                                 const int* offsets, const int* other,
                                 const int* long_ids, int n_long,
                                 const int* short_ids, int n_short,
                                 int n_lanes, int n_pad, float* out,
                                 void* stream) {
  return launch(DownStep{m, a_ex, inv_deg, gamma}, offsets, other, long_ids,
                n_long, short_ids, n_short, n_lanes, n_pad, n_pad, 0, out,
                stream);
}

extern "C" int rca_seg_contrast_step(const float* a_raw, const float* e,
                                     float weight, const int* offsets,
                                     const int* other, const int* long_ids,
                                     int n_long, const int* short_ids,
                                     int n_short, int n_lanes, int n_pad,
                                     float* out, void* stream) {
  return launch(ContrastStep{a_raw, e, weight}, offsets, other, long_ids,
                n_long, short_ids, n_short, n_lanes, n_pad, n_pad, 0, out,
                stream);
}

// The per-shard entries of the node-sharded engine: one shard's step over
// its own edge partition (the shard's CSR layout, real edges only), with
// the values gathered from full-length [n_val] vectors.
//
//   up, contrast: n_seg = block segments, the shard's own sources; the
//     node's own entry is u_full[base + s] / e_full[base + s] with
//     base = shard * block; the output (and a_raw) are [block] lanes.
//   down: n_seg = n_val = n_pad segments, every destination; the output is
//     the shard's unscaled [n_pad] contribution vector (DownSumStep).
extern "C" int rca_seg_up_step_shard(const float* u_full, const float* h_full,
                                     float gamma, int base, int n_val,
                                     const int* offsets, const int* other,
                                     const int* long_ids, int n_long,
                                     const int* short_ids, int n_short,
                                     int n_lanes, int n_seg, float* out,
                                     void* stream) {
  return launch(UpStep{u_full, h_full, gamma}, offsets, other, long_ids,
                n_long, short_ids, n_short, n_lanes, n_seg, n_val, base, out,
                stream);
}

extern "C" int rca_seg_down_step_shard(const float* m_full,
                                       const float* a_ex_full, float gamma,
                                       int n_val, const int* offsets,
                                       const int* other, const int* long_ids,
                                       int n_long, const int* short_ids,
                                       int n_short, int n_lanes, int n_seg,
                                       float* out, void* stream) {
  return launch(DownSumStep{m_full, a_ex_full, gamma}, offsets, other,
                long_ids, n_long, short_ids, n_short, n_lanes, n_seg, n_val,
                0, out, stream);
}

extern "C" int rca_seg_contrast_step_shard(const float* a_raw,
                                           const float* e_full, float weight,
                                           int base, int n_val,
                                           const int* offsets,
                                           const int* other,
                                           const int* long_ids, int n_long,
                                           const int* short_ids, int n_short,
                                           int n_lanes, int n_seg, float* out,
                                           void* stream) {
  return launch(ContrastStep{a_raw, e_full, weight}, offsets, other,
                long_ids, n_long, short_ids, n_short, n_lanes, n_seg, n_val,
                base, out, stream);
}
