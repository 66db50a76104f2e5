// The evidence front's arithmetic, shared by evidence.cu (the row pass),
// segstep.cu (the contrast step) and front.cu (the fused front), so the
// three round alike: the fused front is bitwise the two launches it
// replaces because it runs these very functions.
//
// Rounding: spelled with explicit _rn intrinsics so nvcc cannot contract
// on its own.  The noisy-OR's every factor but the last is one fused
// multiply-add (1 - x*w rounded once), the last is a multiply then a
// subtract, the factors multiply left to right, then 1 - p: the rounding
// sequence of the reference's compiled propagation on the CPU (XLA fuses
// all but the last factor) and of the plain version.  The contrast's fold
// spells the plain version's separate torch ops one rounding each.

#pragma once

namespace {

constexpr int kMaxChannels = 32;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// false for NaN (every comparison with it fails) and for +-Inf
__device__ __forceinline__ bool finite_value(float v) {
  return fabsf(v) <= 3.402823466e+38f;   // FLT_MAX
}

// The noisy-OR pair of one row in the rounding sequence above, over the
// clipped row, or over zeros where ``zero`` (a sanitized row).
__device__ __forceinline__ void noisy_or_row(const float* row, bool zero,
                                             const float* wa, const float* wh,
                                             int n_channels, float* a,
                                             float* h) {
  float pa = 1.0f;
  float ph = 1.0f;
  const int last = n_channels - 1;
  for (int c = 0; c < last; ++c) {
    const float x = zero ? 0.0f : clip01(row[c]);
    pa = __fmul_rn(pa, __fmaf_rn(-x, wa[c], 1.0f));
    ph = __fmul_rn(ph, __fmaf_rn(-x, wh[c], 1.0f));
  }
  const float x = zero ? 0.0f : clip01(row[last]);
  pa = __fmul_rn(pa, __fsub_rn(1.0f, __fmul_rn(x, wa[last])));
  ph = __fmul_rn(ph, __fsub_rn(1.0f, __fmul_rn(x, wh[last])));
  *a = __fsub_rn(1.0f, pa);
  *h = __fsub_rn(1.0f, ph);
}

// One thread's row pass over its staged row: the sanitize (a row with any
// NaN/Inf is a row of zeros), the pair and the error rate.  Returns
// whether the row was bad.
__device__ __forceinline__ bool front_row(const float* row, const float* wa,
                                          const float* wh, int n_channels,
                                          int err_col, float* a_raw,
                                          float* h, float* e) {
  bool bad = false;
  for (int c = 0; c < n_channels; ++c) bad |= !finite_value(row[c]);
  noisy_or_row(row, bad, wa, wh, n_channels, a_raw, h);
  *e = bad ? 0.0f : clip01(row[err_col]);
  return bad;
}

// The error-source contrast of one node folded into its anomaly evidence:
// a = 1 - (1 - a_raw) * (1 - weight * max(e - dep_max, 0)).
__device__ __forceinline__ float contrast_fold(float a_raw, float e,
                                              float dep_max, float weight) {
  const float excess = fmaxf(__fsub_rn(e, dep_max), 0.0f);
  const float keep = __fsub_rn(1.0f, __fmul_rn(weight, excess));
  return __fsub_rn(1.0f, __fmul_rn(__fsub_rn(1.0f, a_raw), keep));
}

}  // namespace
