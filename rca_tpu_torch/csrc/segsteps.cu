// All the steps of one propagation recursion in one launch, for Hopper
// (sm_90a): one CTA per lane, the whole graph staged in its shared memory
// for every step.
//
// Replaces, on the engine's main path, the 8 launches of segstep.cu's
// per-step kernels that composed each recursion, and through them the TPU
// kernels rca_tpu/engine/segscan.py::pallas_segscan_max and
// ::pallas_segscan inside the step bodies ::up_seg_step and
// ::down_seg_step, which rca_tpu/engine/propagate.py runs under lax.scan.
// Over the CSR form of one scan direction (segment s owns the sorted edges
// [offsets[s], offsets[s+1]), o_e = other[e] the edge's other endpoint):
//
//   up   (explain-away, K3):  u_0 = 0,
//        u_{k+1}[s] = max(u_k[s], max_e max(h[o_e], g*u_k[o_e]))
//   down (impact, K2):        m_0 = 0,
//        m_{k+1}[d] = inv_deg[d] * sum_e (a_ex[o_e] + g*m_k[o_e])
//
// and each entry writes u_steps / m_steps.
//
// Why one launch: a step moves about 30 KB at the 2047-service tier, well
// under a microsecond at 3.35 TB/s, yet a per-step launch costs 4-5 us of
// launch, ramp and tail on the card.  The state is one float per node.
//
// The design.  At the start the CTA stages the layout in its shared
// memory: per node its input (h or a_ex), its inv_deg, its offset and its
// x_k = u_k or m_k; per edge the other endpoint; the long segments' ids.
// It also keeps, in two buffers, w_k[s] = value(s, x_k[s]) for every node,
// what an edge gathers from its other endpoint.  A step then touches no
// device memory: the CTA reduces every segment, gathering w_k[o] from one
// buffer, updates x in place (only the node's own thread reads it) and
// writes w_{k+1} to the other buffer.  One __syncthreads separates two
// steps: after it every w_{k+1} is written and nobody reads w_k any more.
// Then the CTA writes x to out.
//
// Capacity: 6 words per node, 1 per edge and per long segment
// (smem_bytes), within the device's opt-in shared memory per block, which
// rca_seg_steps_smem reads; the engine's plan takes this form only where
// both layouts fit (the 2047-service tier: about 66 KB of the H100's 227
// KB) and the card-wide grid recursions of seggrid.cu above.  Clusters of 2-16 CTAs sharing the
// state through distributed shared memory were built and ran slower than
// the per-step launches at every size where one fits (PERF.md).
//
// Bitwise equal to `steps` launches of segstep.cu's per-step kernel, since
// every value and every segment's reduction is the same:
//   - value(o, x) and the epilogues are segstep.cu's, spelled with the
//     same _rn intrinsics, so nvcc contracts nothing into an fma; a node's
//     w is computed once per step instead of once per edge, the same bits;
//   - a short segment (the host's bin, <= SHORT_SEGMENT_MAX edges) is one
//     thread walking its edges in order from 0;
//   - a long segment is one warp that plays segstep.cu's 256 threads: lane
//     l holds threads l + 32 v (v < 8), each a walk by 256 from the
//     segment's start, then segstep.cu's shuffle tree per v and its walk
//     over the 8 partials.
// The up max is exact in any order; the down sum then gives the same bits.
//
// Lanes: the grid is one CTA per lane (the hypothesis batch, the
// attribution sweep, serve batches); a lane's vectors sit lane * n_pad
// entries in and inv_deg is shared.  A lane runs through the same threads
// in the same order as a solo launch, so it is bitwise solo.
//
// Bound: bytes.  One pass over the CSR fields it reads (offsets, other,
// the long ids), the read-only vectors and the output: 41 KB (up) and
// 49 KB (down) at the 2047 tier, 0.012-0.015 us at 3.35 TB/s.  The steps
// are chains of shared memory accesses and one SM's issue rate bounds
// them; what the design buys is 1 launch for 8 and no device-memory round
// trip per step.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 256;          // segstep.cu's threads per long segment
constexpr int kBlockWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

// value(in, x) is what an edge gathers from its other endpoint whose state
// is x (segstep.cu's UpStep / DownStep::value, so the same bits), from the
// node's staged input `in` (h or a_ex); finish(total, self, scale) is the
// step's epilogue, `scale` the node's staged inv_deg.
struct UpSteps {
  const float* h;
  const float* inv_deg;   // unused: the up-step has no scale
  float gamma;

  __device__ __forceinline__ const float* input() const { return h; }
  __device__ __forceinline__ float value(float in, float x) const {
    return fmaxf(in, __fmul_rn(gamma, x));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float finish(float total, float self,
                                                 float) {
    return fmaxf(self, total);
  }
};

struct DownSteps {
  const float* a_ex;
  const float* inv_deg;   // per graph: not offset by the lane
  float gamma;

  __device__ __forceinline__ const float* input() const { return a_ex; }
  __device__ __forceinline__ float value(float in, float x) const {
    return __fadd_rn(in, __fmul_rn(gamma, x));
  }
  static __device__ __forceinline__ float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float finish(float total, float,
                                                 float scale) {
    return __fmul_rn(total, scale);
  }
};

// A long segment's first edge is stored as -(first + 1) in the offsets
// cache, so the short walk can skip it without another array.
__device__ __forceinline__ int edge_at(int stored) {
  return stored < 0 ? -stored - 1 : stored;
}

// What the CTA keeps in shared memory besides the two w buffers: per node
// its x, its input, its scale and its offset; per edge the other endpoint;
// and the long segments' ids.
struct Local {
  float* x;
  float* in;
  float* scale;
  int* offs;       // n_pad + 1, a long segment's start stored negative
  int* other;
  int* longs;
};

// One step of every segment, from shared memory only, in segstep.cu's
// order: a short segment by one thread, in edge order; a long one by one
// warp that plays segstep.cu's 256 threads, lane l holding threads l + 32 v
// (v < 8), each a walk by 256 from the segment's start, then segstep.cu's
// shuffle tree per v and its walk over the 8 partials.  The finish updates
// the node's own x in place (only its own thread reads it) and writes
// w_{k+1}.
template <class Op>
__device__ __forceinline__ void step(const Op& op, const float* w,
                                     float* w_next, const Local& my,
                                     int n_pad, int n_long) {
  const int tid = static_cast<int>(threadIdx.x);
  for (int s = tid; s < n_pad; s += kThreads) {
    const int stored = my.offs[s];
    if (stored < 0) continue;   // long: a warp reduces it below
    const int end = edge_at(my.offs[s + 1]);
    float acc = 0.0f;
    for (int e = stored; e < end; ++e) {
      acc = Op::combine(acc, w[my.other[e]]);
    }
    const float next = Op::finish(acc, my.x[s], my.scale[s]);
    my.x[s] = next;
    w_next[s] = op.value(my.in[s], next);
  }

  const int lane = tid & 31;
  for (int j = tid >> 5; j < n_long; j += kWarps) {
    const int s = my.longs[j];
    const int beg = edge_at(my.offs[s]);
    const int end = edge_at(my.offs[s + 1]);
    float part[kBlockWarps];
#pragma unroll
    for (int v = 0; v < kBlockWarps; ++v) part[v] = 0.0f;
    for (int c = beg + lane; c < end; c += kBlock) {
      float got[kBlockWarps];
#pragma unroll
      for (int v = 0; v < kBlockWarps; ++v) {
        got[v] = c + 32 * v < end ? w[my.other[c + 32 * v]] : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < kBlockWarps; ++v) {
        if (c + 32 * v < end) part[v] = Op::combine(part[v], got[v]);
      }
    }
    // level by level, so the 8 trees' shuffles are in flight together
    // (each tree still combines in segstep.cu's order)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float got[kBlockWarps];
#pragma unroll
      for (int v = 0; v < kBlockWarps; ++v) {
        got[v] = __shfl_down_sync(kFull, part[v], off);
      }
#pragma unroll
      for (int v = 0; v < kBlockWarps; ++v) {
        part[v] = Op::combine(part[v], got[v]);
      }
    }
    if (lane == 0) {
      float total = part[0];
#pragma unroll
      for (int v = 1; v < kBlockWarps; ++v) total = Op::combine(total, part[v]);
      const float next = Op::finish(total, my.x[s], my.scale[s]);
      my.x[s] = next;
      w_next[s] = op.value(my.in[s], next);
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
    seg_steps_kernel(Op all_lanes, int steps,
                     const int* __restrict__ offsets,
                     const int* __restrict__ other,
                     const int* __restrict__ long_ids, int n_long,
                     int n_edges, int n_pad, float* __restrict__ out_lanes) {
  extern __shared__ float smem[];

  float* w0 = smem;
  float* w1 = smem + n_pad;
  Local my;
  my.x = smem + 2 * n_pad;
  my.in = my.x + n_pad;
  my.scale = my.in + n_pad;
  my.offs = reinterpret_cast<int*>(my.scale + n_pad);
  my.other = my.offs + n_pad + 1;
  my.longs = my.other + n_edges;

  const size_t lane_off = static_cast<size_t>(blockIdx.x) * n_pad;
  const Op op = all_lanes;
  const float* in = op.input() + lane_off;
  float* __restrict__ out = out_lanes + lane_off;
  const int tid = static_cast<int>(threadIdx.x);

  // stage the layout and the lane's input
#pragma unroll 4
  for (int i = tid; i <= n_pad; i += kThreads) my.offs[i] = __ldg(offsets + i);
#pragma unroll 4
  for (int i = tid; i < n_pad; i += kThreads) {
    my.in[i] = __ldg(in + i);
    my.scale[i] = op.inv_deg == nullptr ? 1.0f : __ldg(op.inv_deg + i);
    my.x[i] = 0.0f;
  }
#pragma unroll 4
  for (int e = tid; e < n_edges; e += kThreads) my.other[e] = __ldg(other + e);
  for (int j = tid; j < n_long; j += kThreads) my.longs[j] = __ldg(long_ids + j);
  __syncthreads();
  for (int j = tid; j < n_long; j += kThreads) {
    const int s = my.longs[j];
    my.offs[s] = -my.offs[s] - 1;
  }
  for (int i = tid; i < n_pad; i += kThreads) w0[i] = op.value(my.in[i], 0.0f);
  __syncthreads();

  float* cur = w0;
  float* nxt = w1;
  for (int k = 0; k < steps; ++k) {
    step<Op>(op, cur, nxt, my, n_pad, n_long);
    // w_{k+1} complete, and nobody reads w_k any more
    __syncthreads();
    float* done = cur;
    cur = nxt;
    nxt = done;
  }

  for (int i = tid; i < n_pad; i += kThreads) out[i] = my.x[i];
}

// The dynamic shared memory of a launch: two w buffers, 4 more words per
// node and the offsets' end, one word per edge and per long segment.
size_t smem_bytes(int n_pad, int n_edges, int n_long) {
  return 4 * (6 * static_cast<size_t>(n_pad) + 1 +
              static_cast<size_t>(n_edges) + static_cast<size_t>(n_long));
}

// The dynamic shared memory one CTA may take on the current device: the
// opt-in limit less the kernel's static shared memory (none; both entries
// share the one count).
cudaError_t smem_limit(size_t* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, seg_steps_kernel<DownSteps>);
  if (err != cudaSuccess) return err;
  *bytes = static_cast<size_t>(optin) - attrs.sharedSizeBytes;
  return cudaSuccess;
}

template <class Op>
int launch(const Op& op, int steps, const int* offsets, const int* other,
           const int* long_ids, int n_long, int n_edges, int n_lanes,
           int n_pad, float* out, void* stream) {
  if (steps < 1 || n_lanes < 1 || n_pad < 1 || n_edges < 0 || n_long < 0 ||
      n_long > n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(n_pad, n_edges, n_long);
  if (smem > static_cast<size_t>(INT_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = seg_steps_kernel<Op>;
  // a layout above the device's shared memory fails here: the plan runs
  // the grid recursions for it, so no launch of it is ever asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_lanes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      op, steps, offsets, other, long_ids, n_long, n_edges, n_pad, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry runs `steps` >= 1 steps of one recursion over n_lanes lanes of
// n_pad entries, one CTA per lane, over a layout of n_edges edges of which
// n_long segments are long, and returns the cudaError_t of the launch.
extern "C" int rca_seg_up_steps(const float* h, float gamma, int steps,
                                const int* offsets, const int* other,
                                const int* long_ids, int n_long, int n_edges,
                                int n_lanes, int n_pad, float* out,
                                void* stream) {
  return launch(UpSteps{h, nullptr, gamma}, steps, offsets, other, long_ids,
                n_long, n_edges, n_lanes, n_pad, out, stream);
}

extern "C" int rca_seg_down_steps(const float* a_ex, const float* inv_deg,
                                  float gamma, int steps, const int* offsets,
                                  const int* other, const int* long_ids,
                                  int n_long, int n_edges, int n_lanes,
                                  int n_pad, float* out, void* stream) {
  return launch(DownSteps{a_ex, inv_deg, gamma}, steps, offsets, other,
                long_ids, n_long, n_edges, n_lanes, n_pad, out, stream);
}

// The plan's capacity question, answered with the launch's own count: the
// dynamic shared memory a launch over a layout of these sizes takes
// (*need) and the most one CTA may take on the current device (*limit).
// The layout fits where *need <= *limit.
extern "C" int rca_seg_steps_smem(int n_pad, int n_edges, int n_long,
                                  long long* need, long long* limit) {
  if (n_pad < 1 || n_edges < 0 || n_long < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t got = 0;
  const cudaError_t err = smem_limit(&got);
  if (err != cudaSuccess) return static_cast<int>(err);
  *need = static_cast<long long>(smem_bytes(n_pad, n_edges, n_long));
  *limit = static_cast<long long>(got);
  return 0;
}
