// One propagation seg step per launch, for Hopper (sm_90a).
//
// Replaces, on the engine's main path, the TPU kernels
// rca_tpu/engine/segscan.py::pallas_segscan and ::pallas_segscan_max
// together with the step bodies around them, ::down_seg_step and
// ::up_seg_step (gather, flagged scan, s[ends], where, epilogue).  Over the
// CSR form of one scan direction (segment s owns the sorted edges
// [offsets[s], offsets[s+1]), o_e = other[e] is the edge's other endpoint):
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
// Bound: bytes.  other (4 B per edge), offsets, two or three node vectors
// read and one written: about 1.3-1.5 MB at the 50k tier, under half a
// microsecond at 3.35 TB/s; the working set sits in the 50 MB L2.  The
// gathers are indexed, so neither TMA nor the tensor cores apply; what the
// design buys is one launch per step in place of a gather, three scan
// launches and the epilogue's ops, and no edge-sized intermediate in
// device memory.
//
// Rounding: every product and sum is spelled with an _rn intrinsic so nvcc
// cannot contract a*b+c into an fma; the per-edge values and the epilogues
// then round as the plain version's separate torch ops do.  The up-step and
// the contrast reduce with a max, exact in any order, so u' and a are
// bit-equal to the plain version; the down-step's sum runs in another order
// than the plain version's doubling scan.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct UpStep {
  const float* u;
  const float* h;
  float gamma;

  __device__ __forceinline__ float value(int o) const {
    return fmaxf(__ldg(h + o), __fmul_rn(gamma, __ldg(u + o)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fmaxf(a, b);
  }
  __device__ __forceinline__ float finish(int s, float total) const {
    return fmaxf(__ldg(u + s), total);
  }
};

struct DownStep {
  const float* m;
  const float* a_ex;
  const float* inv_deg;
  float gamma;

  __device__ __forceinline__ float value(int o) const {
    return __fadd_rn(__ldg(a_ex + o), __fmul_rn(gamma, __ldg(m + o)));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ __forceinline__ float finish(int s, float total) const {
    return __fmul_rn(total, __ldg(inv_deg + s));
  }
};

struct ContrastStep {
  const float* a_raw;
  const float* e;
  float weight;

  __device__ __forceinline__ float value(int o) const { return __ldg(e + o); }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fmaxf(a, b);
  }
  __device__ __forceinline__ float finish(int s, float dep_max) const {
    const float excess = fmaxf(__fsub_rn(__ldg(e + s), dep_max), 0.0f);
    const float keep = __fsub_rn(1.0f, __fmul_rn(weight, excess));
    return __fsub_rn(1.0f, __fmul_rn(__fsub_rn(1.0f, __ldg(a_raw + s)), keep));
  }
};

template <class Step>
__global__ void __launch_bounds__(kThreads)
    seg_step_kernel(Step step, const int* __restrict__ offsets,
                    const int* __restrict__ other,
                    const int* __restrict__ long_ids, int n_long,
                    const int* __restrict__ short_ids, int n_short,
                    float* __restrict__ out) {
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
      out[s] = step.finish(s, total);
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
  out[s] = step.finish(s, acc);
}

template <class Step>
int launch(const Step& step, const int* offsets, const int* other,
           const int* long_ids, int n_long, const int* short_ids, int n_short,
           float* out, void* stream) {
  if (n_long < 0 || n_short < 0 || n_long + n_short < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = n_long + (n_short + kThreads - 1) / kThreads;
  seg_step_kernel<Step><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      step, offsets, other, long_ids, n_long, short_ids, n_short, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int rca_seg_up_step(const float* u, const float* h, float gamma,
                               const int* offsets, const int* other,
                               const int* long_ids, int n_long,
                               const int* short_ids, int n_short, float* out,
                               void* stream) {
  return launch(UpStep{u, h, gamma}, offsets, other, long_ids, n_long,
                short_ids, n_short, out, stream);
}

extern "C" int rca_seg_down_step(const float* m, const float* a_ex,
                                 const float* inv_deg, float gamma,
                                 const int* offsets, const int* other,
                                 const int* long_ids, int n_long,
                                 const int* short_ids, int n_short,
                                 float* out, void* stream) {
  return launch(DownStep{m, a_ex, inv_deg, gamma}, offsets, other, long_ids,
                n_long, short_ids, n_short, out, stream);
}

extern "C" int rca_seg_contrast_step(const float* a_raw, const float* e,
                                     float weight, const int* offsets,
                                     const int* other, const int* long_ids,
                                     int n_long, const int* short_ids,
                                     int n_short, float* out, void* stream) {
  return launch(ContrastStep{a_raw, e, weight}, offsets, other, long_ids,
                n_long, short_ids, n_short, out, stream);
}
