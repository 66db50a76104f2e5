// The propagation's evidence front for Hopper (sm_90a): the fused noisy-OR
// pair (rca_noisy_or_pair) and the front's row pass (rca_evidence_front).
//
// Both replace the TPU kernel rca_tpu/engine/pallas_kernels.py::
// noisy_or_pair_pallas (body _pair_kernel): one read of each feature
// element feeds both products
//
//     a[s] = 1 - prod_c (1 - clip(f[s, c], 0, 1) * wa[c])
//     h[s] = 1 - prod_c (1 - clip(f[s, c], 0, 1) * wh[c])
//
// The TPU kernel worked on the channel-major transpose to fill 128 lanes;
// here both work on the row-major [S, C] matrix, which is the layout the
// engine's public functions take, so no transpose is made.
//
// rca_noisy_or_pair: one thread owns one service and reads its row
// straight from device memory.  It stays as the twin of the reference's
// public noisy_or_pair_pallas; the main path does not launch it.
//
// rca_evidence_front: the row pass.  The node-sharded engine runs it on
// each shard's rows between its collectives, and it stays as the bitwise
// yardstick of the dense main path's front, which runs the row pass and
// the contrast in one launch (front.cu).  Over the RAW padded
// features it also does the reference's finite-mask sanitize
// (rca_tpu/engine/propagate.py::finite_mask_rows: a row with any NaN/Inf
// counts as a row of zeros) and takes the error rate
// e = clip(f[:, err_col], 0, 1) of the sanitized row, which the
// error-source contrast (seg_contrast_step in segstep.cu) reads.  It
// writes a_raw, h and e as [S] vectors and the count of bad rows.  The
// clean matrix is written only by the persisting launch (persist != 0,
// evidence_front_persist_kernel), the streaming flush's: it also writes
// zeros over each row it found non-finite, in place in its input, as the
// reference's flush persists the sanitized buffer
// (rca_tpu/engine/streaming.py::_flush_propagate_ranked).  Each row is
// read only by its own block, into the tile, before its thread writes
// it, so the persisting kernel reads its input with plain loads (never
// through the read-only cache, and through no const __restrict__
// pointer); clean rows are not touched.  The non-persisting launch keeps
// its read-only loads and its bits.
//
//   - Each block first stages its 256-row tile (13,312 bytes at C = 13) in
//     shared memory with coalesced 16-byte loads, where one thread per row
//     would make each warp load touch 32 addresses C*4 bytes apart.  With
//     C odd the per-thread row reads that follow hit no bank conflicts
//     (stride C words over 32 banks).
//   - The bad-row count is one __syncthreads_count per block and one
//     integer atomicAdd per block that has any, into a counter the C entry
//     clears with a memset on the same stream: an integer sum, the same in
//     any order, and no second kernel.
//   - Lanes: B feature matrices [B, S, C] of one graph (the hypothesis
//     batch, the counterfactual sweep) are B*S rows of one launch, laid out
//     as the [B, S] vectors the seg steps read.  Rows are independent, so
//     a lane is bitwise equal to a solo launch on the same rows, and the
//     bad-row count runs across the whole batch, as the reference counts it.
//
// Bound: bytes.  S*C*4 in plus 3*S*4 out (3.4 MB at the 50k tier, about
// 1 us at 3.35 TB/s), so one launch costs more than the traffic; the
// design's gain is the launches it removes around it (the sanitize's six
// torch ops, the error rate's clip and the clean matrix's round trip).
//
// Rounding: the noisy-OR's sequence in front_row.cuh (shared with the
// fused front, front.cu), the reference's compiled propagation's on the
// CPU and the plain version's, so h, which feeds the order-free max of
// the up-scan, and with it u come out bit-equal.  A bad row goes through
// the same sequence on zeros, as the reference's zeroed row does.

#include <cuda_runtime.h>

#include <cstdint>

#include "front_row.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void noisy_or_pair_kernel(const float* __restrict__ features,
                                     const float* __restrict__ anomaly_w,
                                     const float* __restrict__ hard_w,
                                     float* __restrict__ a,
                                     float* __restrict__ h,
                                     int n_rows, int n_channels) {
  __shared__ float wa[kMaxChannels];
  __shared__ float wh[kMaxChannels];
  for (int c = threadIdx.x; c < n_channels; c += blockDim.x) {
    wa[c] = anomaly_w[c];
    wh[c] = hard_w[c];
  }
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_rows) return;
  const float* row = features + static_cast<size_t>(s) * n_channels;
  noisy_or_row(row, false, wa, wh, n_channels, a + s, h + s);
}

// Stages ``count`` floats from ``src`` into the block's tile: 16-byte
// loads where the rows start aligned, through the read-only cache where
// the launch never writes its input (kReadOnly).
template <bool kReadOnly>
__device__ __forceinline__ void stage_tile(const float* src, float* tile,
                                           int count, bool vector_loads) {
  int done = 0;
  if (vector_loads) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* tile4 = reinterpret_cast<float4*>(tile);
    const int n4 = count / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      tile4[i] = kReadOnly ? __ldg(src4 + i) : src4[i];
    }
    done = n4 * 4;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    tile[i] = kReadOnly ? __ldg(src + i) : src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    evidence_front_kernel(const float* __restrict__ features,
                          const float* __restrict__ anomaly_w,
                          const float* __restrict__ hard_w,
                          float* __restrict__ a_raw, float* __restrict__ h,
                          float* __restrict__ e, int* __restrict__ n_bad,
                          int n_rows, int n_channels, int err_col,
                          bool vector_loads) {
  extern __shared__ __align__(16) float tile[];   // kThreads * n_channels
  __shared__ float wa[kMaxChannels];
  __shared__ float wh[kMaxChannels];
  for (int c = threadIdx.x; c < n_channels; c += kThreads) {
    wa[c] = anomaly_w[c];
    wh[c] = hard_w[c];
  }
  const int row0 = blockIdx.x * kThreads;
  const int count = min(kThreads, n_rows - row0) * n_channels;
  // the tile is contiguous in device memory and starts 16-byte aligned
  // when the matrix does (kThreads * 4 bytes is a multiple of 16)
  stage_tile<true>(features + static_cast<size_t>(row0) * n_channels, tile,
                   count, vector_loads);
  __syncthreads();

  const int s = row0 + threadIdx.x;
  bool bad = false;
  if (s < n_rows) {
    bad = front_row(tile + threadIdx.x * n_channels, wa, wh, n_channels,
                    err_col, a_raw + s, h + s, e + s);
  }
  const int block_bad = __syncthreads_count(bad);
  if (threadIdx.x == 0 && block_bad > 0) atomicAdd(n_bad, block_bad);
}

// The same row pass, which also zeroes each bad row in place in
// ``features``: the thread that owns the row writes it after the block's
// tile is staged, and no other thread reads the row again.
__global__ void __launch_bounds__(kThreads)
    evidence_front_persist_kernel(float* features,
                                  const float* __restrict__ anomaly_w,
                                  const float* __restrict__ hard_w,
                                  float* __restrict__ a_raw,
                                  float* __restrict__ h,
                                  float* __restrict__ e,
                                  int* __restrict__ n_bad, int n_rows,
                                  int n_channels, int err_col,
                                  bool vector_loads) {
  extern __shared__ __align__(16) float tile[];   // kThreads * n_channels
  __shared__ float wa[kMaxChannels];
  __shared__ float wh[kMaxChannels];
  for (int c = threadIdx.x; c < n_channels; c += kThreads) {
    wa[c] = anomaly_w[c];
    wh[c] = hard_w[c];
  }
  const int row0 = blockIdx.x * kThreads;
  const int count = min(kThreads, n_rows - row0) * n_channels;
  stage_tile<false>(features + static_cast<size_t>(row0) * n_channels, tile,
                    count, vector_loads);
  __syncthreads();

  const int s = row0 + threadIdx.x;
  bool bad = false;
  if (s < n_rows) {
    bad = front_row(tile + threadIdx.x * n_channels, wa, wh, n_channels,
                    err_col, a_raw + s, h + s, e + s);
    if (bad) {
      float* row = features + static_cast<size_t>(s) * n_channels;
      for (int c = 0; c < n_channels; ++c) row[c] = 0.0f;
    }
  }
  const int block_bad = __syncthreads_count(bad);
  if (threadIdx.x == 0 && block_bad > 0) atomicAdd(n_bad, block_bad);
}

}  // namespace

extern "C" int rca_noisy_or_pair(const float* features, const float* anomaly_w,
                                 const float* hard_w, float* a, float* h,
                                 int n_rows, int n_channels, void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  noisy_or_pair_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      features, anomaly_w, hard_w, a, h, n_rows, n_channels);
  return static_cast<int>(cudaGetLastError());
}

// Clears *n_bad, then runs the row pass (persist != 0: the persisting
// kernel, which zeroes the bad rows of ``features`` in place); returns the
// first cudaError_t.
extern "C" int rca_evidence_front(float* features, const float* anomaly_w,
                                  const float* hard_w, float* a_raw, float* h,
                                  float* e, int* n_bad, int n_rows,
                                  int n_channels, int err_col, int persist,
                                  void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_rows < 1 ||
      err_col < 0 || err_col >= n_channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t cleared = cudaMemsetAsync(n_bad, 0, sizeof(int), st);
  if (cleared != cudaSuccess) return static_cast<int>(cleared);
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  const size_t tile_bytes = sizeof(float) * kThreads * n_channels;
  const bool vector_loads =
      reinterpret_cast<std::uintptr_t>(features) % 16 == 0;
  if (persist) {
    evidence_front_persist_kernel<<<blocks, kThreads, tile_bytes, st>>>(
        features, anomaly_w, hard_w, a_raw, h, e, n_bad, n_rows, n_channels,
        err_col, vector_loads);
  } else {
    evidence_front_kernel<<<blocks, kThreads, tile_bytes, st>>>(
        features, anomaly_w, hard_w, a_raw, h, e, n_bad, n_rows, n_channels,
        err_col, vector_loads);
  }
  return static_cast<int>(cudaGetLastError());
}
