// Fused noisy-OR evidence pair for Hopper (sm_90a).
//
// Replaces the TPU kernel rca_tpu/engine/pallas_kernels.py::noisy_or_pair_pallas
// (body _pair_kernel): one read of each feature element feeds both products
//
//     a[s] = 1 - prod_c (1 - clip(f[s, c], 0, 1) * wa[c])
//     h[s] = 1 - prod_c (1 - clip(f[s, c], 0, 1) * wh[c])
//
// The TPU kernel worked on the channel-major transpose to fill 128 lanes;
// here one thread owns one service of the row-major [S, C] matrix, which is
// the layout the engine's public functions take, so no transpose is made.
//
// Bound: bytes.  S*C*4 in plus 2*S*4 out (3.2 MB at the 50k tier), well
// under a microsecond at 3.35 TB/s, so one launch costs more than the
// traffic.  The weight vectors sit in shared memory.  Coalescing the row
// loads through shared memory and fusing the finite-mask are left for later.
//
// Rounding: spelled with explicit _rn intrinsics so nvcc cannot contract
// on its own.  Every factor but the last is one fused multiply-add
// (1 - x*w rounded once), the last is a multiply then a subtract, the
// factors multiply left to right, then 1 - p: the rounding sequence of the
// reference's compiled propagation on the CPU (XLA fuses all but the last
// factor) and of the plain version, so h, which feeds the order-free max
// of the up-scan, and with it u come out bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 32;
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
  float pa = 1.0f;
  float ph = 1.0f;
  const int last = n_channels - 1;
  for (int c = 0; c < last; ++c) {
    const float x = fminf(fmaxf(row[c], 0.0f), 1.0f);
    pa = __fmul_rn(pa, __fmaf_rn(-x, wa[c], 1.0f));
    ph = __fmul_rn(ph, __fmaf_rn(-x, wh[c], 1.0f));
  }
  const float x = fminf(fmaxf(row[last], 0.0f), 1.0f);
  pa = __fmul_rn(pa, __fsub_rn(1.0f, __fmul_rn(x, wa[last])));
  ph = __fmul_rn(ph, __fsub_rn(1.0f, __fmul_rn(x, wh[last])));
  a[s] = __fsub_rn(1.0f, pa);
  h[s] = __fsub_rn(1.0f, ph);
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
