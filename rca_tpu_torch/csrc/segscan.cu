// Flagged inclusive segmented scan (sum or max) for Hopper (sm_90a).
//
// Replaces the TPU kernels rca_tpu/engine/segscan.py::pallas_segscan and
// ::pallas_segscan_max (body _make_segscan_kernel).  Contract, the same as
// the TPU kernel's: x is a flat [N] float32 array of nonnegative values
// sorted by segment, flags[i] != 0 marks the first element of a segment,
// and out[i] is the combine of x over [start of i's segment, i].  Each
// segment's total is its last element, so no error accumulates across
// segments (no global cumsum with boundary subtraction).  Any N >= 1.
//
// The TPU kernel ran one grid step over a VMEM-resident [R, 128] tile and
// carried rows in order.  Blocks on the card run in no order, so the scan
// is three launches, all free of atomics on the data and so deterministic:
//   1. each block of 1024 elements scans its own tile (warp shuffles, then
//      a carry between the 32 warps) and records its aggregate (value,
//      any-flag) and the position of its first flag;
//   2. one block scans the block aggregates in chunks of 1024;
//   3. each block after the first folds the carry of the blocks before it
//      into its elements that precede its first flag.
//
// Bound: bytes, 12 per element (x and flags in, out written), 1.3 MB at the
// 50k tier's 106,496 edges: well under a microsecond of traffic, so the
// three launches dominate.  Fusing the gather and the s[ends] read into
// the scan, and replaying the step chain as a CUDA graph, are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMax = 1 };

template <int OP>
__device__ __forceinline__ float combine(float left, float right) {
  return OP == kSum ? __fadd_rn(left, right) : fmaxf(left, right);
}

// Inclusive flagged scan of (v, f) over the 1024 threads of the block, in
// thread order.  The pair operator is (v1, f1) . (v2, f2) =
// (f2 ? v2 : v1 op v2, f1 | f2).  Leaves smem reusable on return.
template <int OP>
__device__ __forceinline__ void block_scan(float& v, int& f, float* sv,
                                           int* sf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float vu = __shfl_up_sync(kFull, v, off);
    const int fu = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) v = combine<OP>(vu, v);
      f |= fu;
    }
  }
  if (lane == 31) {
    sv[warp] = v;
    sf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    float wv = sv[lane];
    int wf = sf[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vu = __shfl_up_sync(kFull, wv, off);
      const int fu = __shfl_up_sync(kFull, wf, off);
      if (lane >= off) {
        if (!wf) wv = combine<OP>(vu, wv);
        wf |= fu;
      }
    }
    sv[lane] = wv;
    sf[lane] = wf;
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v = combine<OP>(sv[warp - 1], v);
    f |= sf[warp - 1];
  }
  __syncthreads();
}

template <int OP>
__global__ void __launch_bounds__(kBlock)
    tile_scan_kernel(const float* __restrict__ x, const float* __restrict__ flags,
                     float* __restrict__ out, float* __restrict__ agg_v,
                     int* __restrict__ agg_f, int* __restrict__ first_flag,
                     int n) {
  __shared__ float sv[kWarps];
  __shared__ int sf[kWarps];
  __shared__ int first;
  if (threadIdx.x == 0) first = kBlock;
  __syncthreads();
  const int i = blockIdx.x * kBlock + threadIdx.x;
  // padding past n is (0, no flag): the identity of both combines on
  // nonnegative data, and only the last block has any
  float v = i < n ? x[i] : 0.0f;
  int f = (i < n && flags[i] != 0.0f) ? 1 : 0;
  if (f) atomicMin(&first, static_cast<int>(threadIdx.x));
  block_scan<OP>(v, f, sv, sf);
  if (i < n) out[i] = v;
  if (threadIdx.x == kBlock - 1) {
    agg_v[blockIdx.x] = v;
    agg_f[blockIdx.x] = f;
    first_flag[blockIdx.x] = first;
  }
}

template <int OP>
__global__ void __launch_bounds__(kBlock)
    aggregate_scan_kernel(float* __restrict__ agg_v, int* __restrict__ agg_f,
                          int n_blocks) {
  __shared__ float sv[kWarps];
  __shared__ int sf[kWarps];
  __shared__ float carry_v;
  __shared__ int carry_f;
  if (threadIdx.x == 0) {
    carry_v = 0.0f;
    carry_f = 0;
  }
  __syncthreads();
  for (int base = 0; base < n_blocks; base += kBlock) {
    const int b = base + threadIdx.x;
    float v = b < n_blocks ? agg_v[b] : 0.0f;
    int f = b < n_blocks ? agg_f[b] : 0;
    block_scan<OP>(v, f, sv, sf);
    if (base > 0) {
      if (!f) v = combine<OP>(carry_v, v);
      f |= carry_f;
    }
    if (b < n_blocks) {
      agg_v[b] = v;
      agg_f[b] = f;
    }
    __syncthreads();  // every thread has read the old carry
    if (threadIdx.x == kBlock - 1) {
      carry_v = v;
      carry_f = f;
    }
    __syncthreads();
  }
}

template <int OP>
__global__ void __launch_bounds__(kBlock)
    carry_fixup_kernel(float* __restrict__ out, const float* __restrict__ agg_v,
                       const int* __restrict__ first_flag, int n) {
  const int b = blockIdx.x + 1;  // block 0 has no carry
  const int i = b * kBlock + threadIdx.x;
  if (i < n && static_cast<int>(threadIdx.x) < first_flag[b]) {
    out[i] = combine<OP>(agg_v[b - 1], out[i]);
  }
}

template <int OP>
int launch(const float* x, const float* flags, float* out, float* agg_v,
           int* agg_i, int n, cudaStream_t stream) {
  const int n_blocks = (n + kBlock - 1) / kBlock;
  int* agg_f = agg_i;
  int* first_flag = agg_i + n_blocks;
  tile_scan_kernel<OP><<<n_blocks, kBlock, 0, stream>>>(
      x, flags, out, agg_v, agg_f, first_flag, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_blocks == 1) return static_cast<int>(err);
  aggregate_scan_kernel<OP><<<1, kBlock, 0, stream>>>(agg_v, agg_f, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_fixup_kernel<OP><<<n_blocks - 1, kBlock, 0, stream>>>(
      out, agg_v, first_flag, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements per tile: the caller sizes the scratch from it (agg_v holds
// ceil(n / block) floats, agg_i twice as many ints).
extern "C" int rca_segscan_block_size() { return kBlock; }

// op: 0 = sum, 1 = max.  Returns the cudaError_t of the launches.
extern "C" int rca_segscan(const float* x, const float* flags, float* out,
                           float* agg_v, int* agg_i, int n, int op,
                           void* stream) {
  if (n < 1 || (op != kSum && op != kMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return op == kSum ? launch<kSum>(x, flags, out, agg_v, agg_i, n, s)
                    : launch<kMax>(x, flags, out, agg_v, agg_i, n, s);
}
