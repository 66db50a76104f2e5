// The node-sharded engine's evidence front for every shard of one card, in
// one cooperative launch, for Hopper (sm_90a).
//
// Replaces, where every shard of a dp row lies on one CUDA device (logical
// shards), the per-shard composition of the sharded front: one launch of
// evidence.cu's row pass a shard (with the memset of its bad-row count),
// the one-time all-gather of the error rates, one launch of segstep.cu's
// per-shard contrast entry a shard, and the all-gathers of h and a (3*sp +
// 3 CUDA launches per dp row on one card: 15 at sp 4, 27 at sp 8).
// Through them it replaces the reference's per-device front,
// rca_tpu/parallel/sharded.py:225-242 inside shard_map: the noisy-OR pair
// over the block (the dense path's TPU kernel is rca_tpu/engine/
// pallas_kernels.py::noisy_or_pair_pallas), e gathered over sp (:234), the
// masked scatter-max over the shard's own edges and fold_error_contrast
// (:235-239), the h and a gathers (:241-242).
//
// Shard k owns the nodes [k * block, (k + 1) * block); its raw rows are a
// buffer of its own, n_lanes lanes of block rows of C channels,
// contiguous (the staged batch's [B, block, C] piece, or the first block
// rows of a resident [block + 1, C] buffer).  The outputs are joined:
// a and h are [n_lanes, n_pad] with shard k's block at k * block, as the
// all-gathers hand them to every shard of the card, so the score and the
// stack after them run once over the joined vectors.
//
//   row (lane b, shard k, r):  i = b * n_pad + k * block + r
//        bad = any non-finite row;  x = bad ? 0 : clip(row, 0, 1)
//        a_raw[i], h[i] = the noisy-OR pair of x;  e[i] = x[err_col]
//   node s (every lane):  a[s] = 1 - (1 - a_raw[s]) * (1 - w * relu(e[s]
//        - max over the shard's own edges (s, d) of e[d]))
//
// with no fold at a contrast weight of 0.  The shards' own sources
// partition the nodes, so their up layouts joined in shard order are one
// layout over all n_pad nodes (engine/segscan.py::ShardGrid's up_*, in the
// grid recursions' item order: the long segments, more than 16 real edges,
// then the short ones), and the contrast is the dense front's work over
// it.  No bad-row count: the sharded engine sanitizes on the host and
// drops the per-shard counts; a bad row is still zeroed as the row pass
// zeroes it.
//
// The design, front.cu's over a table of shard buffers:
//   - the shards' row pointers are a table passed BY VALUE in the kernel's
//     parameters (kMaxShards of them), so the launch needs no upload, no
//     allocation and no host sync;
//   - a persistent cooperative grid, sized by the wrapper to the work and
//     capped at the co-resident bound (rca_evidence_front_shard_cap);
//   - phase 1, the row pass: each CTA walks its 256-row tiles (grid
//     stride).  Tiles are counted per shard, so none straddles two
//     buffers, and a shard's last tile may be ragged; a tile finds its
//     shard and its offset from its index.  It is staged by one bulk copy
//     of the Tensor Memory Accelerator where its base is 16-byte aligned
//     and its size a multiple of 16 bytes, else by plain loads, then each
//     thread runs front_row.cuh's row on its row (front.cuh's staging);
//   - one grid barrier, which orders phase 1's writes before phase 2;
//   - phase 2, the contrast: a grid-stride walk over the joined layout's
//     items of every lane, a long segment one item of 256 threads, 256
//     short segments one item, a thread each (front.cuh's reductions, the
//     order of segstep.cu's ContrastStep), each folded by contrast_fold.
//
// Bitwise the per-shard composition, and through it the dense front: the
// same staged row through the same noisy_or_row and clip, the same fold;
// a max does not depend on the order, and e is finite and in [0, 1].  An
// empty segment folds +0.0f, the identity of the per-shard masked max.
//
// Bound: bytes.  The function's: the shards' rows and the weights read,
// the joined up layout's CSR (n_pad + 1 offsets, the real edges) and its
// segment order read once, a and h written (kernels/cost.py::front over
// the real edges, the dense fused front's count).  The scratch e stays in
// L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "front.cuh"

namespace {

constexpr int kMaxShards = 64;

struct ShardFrontArgs {
  const float* rows[kMaxShards];   // shard k: [n_lanes, block, C]
  const float* anomaly_w;          // [C]
  const float* hard_w;             // [C]
  float* a;                        // [n_lanes, n_pad]: a_raw, then a
  float* h;                        // [n_lanes, n_pad]
  float* e;                        // [n_lanes, n_pad] scratch
  const int* item_seg;             // [n_pad] node ids in item order
  const int* item_offsets;         // [n_pad + 1]
  const int* item_other;           // the real edges' destinations
  int n_long;                      // the long segments, the first ids
  int n_shards;
  int block;                       // rows of a lane of a shard
  int n_pad;                       // n_shards * block
  int n_lanes;
  int tiles;                       // tiles of one shard's buffer
  int n_channels;
  int err_col;
  float weight;
  int fold;                        // 0: a = a_raw (a contrast weight of 0)
};

__global__ void __launch_bounds__(kThreads)
    front_shard_kernel(ShardFrontArgs p) {
  extern __shared__ __align__(128) float tile[];   // kThreads * C
  __shared__ __align__(8) uint64_t full;
  __shared__ float wa[kMaxChannels];
  __shared__ float wh[kMaxChannels];
  __shared__ float partial[kWarps];
  const int C = p.n_channels;
  const int shard_rows = p.n_lanes * p.block;
  front_setup(p.anomaly_w, p.hard_w, C, wa, wh, &full);

  // -- phase 1: the row pass, a shard's tiles in its own buffer -----------
  uint32_t parity = 0;   // the phase of `full` to wait for
  const int n_tiles = p.n_shards * p.tiles;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int k = t / p.tiles;
    const int first = (t - k * p.tiles) * kThreads;
    const int count = min(kThreads, shard_rows - first) * C;
    const float* src = p.rows[k] + static_cast<size_t>(first) * C;
    const bool bulk =
        reinterpret_cast<std::uintptr_t>(src) % 16 == 0 && count % 4 == 0;
    stage_tile<true>(tile, src, count, bulk, &full, &parity);
    const int r = first + static_cast<int>(threadIdx.x);
    if (r < shard_rows) {
      const int lane = r / p.block;
      const size_t i = static_cast<size_t>(lane) * p.n_pad +
                       static_cast<size_t>(k) * p.block + (r - lane * p.block);
      front_row(tile + threadIdx.x * C, wa, wh, C, p.err_col, p.a + i,
                p.h + i, p.e + i);
    }
    __syncthreads();   // the tile may be refilled
  }
  if (!p.fold) return;   // uniform: no CTA reaches the barrier

  cg::this_grid().sync();

  // -- phase 2: the contrast over the joined up layout, every lane --------
  const int n_short = p.n_pad - p.n_long;
  const int per_lane = p.n_long + (n_short + kThreads - 1) / kThreads;
  const long long items = static_cast<long long>(per_lane) * p.n_lanes;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int lane = static_cast<int>(w / per_lane);
    const int j = static_cast<int>(w % per_lane);
    const size_t off = static_cast<size_t>(lane) * p.n_pad;
    float* a = p.a + off;
    const float* e = p.e + off;
    if (j < p.n_long) {
      contrast_long(p.item_offsets, p.item_other, j,
                    __ldg(p.item_seg + j), p.weight, a, e, partial);
    } else {
      const int i = (j - p.n_long) * kThreads + static_cast<int>(threadIdx.x);
      if (i < n_short) {
        const int q = p.n_long + i;
        contrast_short(p.item_offsets, p.item_other, q,
                       __ldg(p.item_seg + q), p.weight, a, e);
      }
    }
  }
}

}  // namespace

// *cap = the most CTAs of the sharded front's kernel co-resident on the
// current device: the bound its cooperative launch's grid keeps.  The
// wrapper caches it per device and width.
extern "C" int rca_evidence_front_shard_cap(int n_channels, int* cap) {
  return front_co_resident(
      reinterpret_cast<const void*>(&front_shard_kernel), n_channels, cap);
}

// One cooperative launch of the front of n_shards shards (rows[k]: shard
// k's n_lanes x block rows of n_channels, a host table of n_shards device
// pointers, copied into the kernel's parameters) with `grid` CTAs (1 <=
// grid <= the cap above), over the shards' joined up layout in item order
// (n_shards * block segments, the first n_long long), into the joined
// [n_lanes, n_shards * block] a, h and the scratch e.  Returns the
// cudaError_t of the launch.
extern "C" int rca_evidence_front_shard(
    const float* const* rows, int n_shards, int block, int n_lanes,
    const float* anomaly_w, const float* hard_w, float* a, float* h,
    float* e, int n_channels, int err_col, float weight, int fold,
    const int* item_seg, const int* item_offsets, const int* item_other,
    int n_long, int grid, void* stream) {
  const long long n_pad = static_cast<long long>(n_shards) * block;
  if (n_shards < 1 || n_shards > kMaxShards || block < 1 || n_lanes < 1 ||
      n_channels < 1 || n_channels > kMaxChannels || err_col < 0 ||
      err_col >= n_channels || grid < 1 || n_long < 0 || n_long > n_pad ||
      n_pad * n_lanes > (1LL << 31) - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ShardFrontArgs args{};
  for (int k = 0; k < n_shards; ++k) args.rows[k] = rows[k];
  args.anomaly_w = anomaly_w;
  args.hard_w = hard_w;
  args.a = a;
  args.h = h;
  args.e = e;
  args.item_seg = item_seg;
  args.item_offsets = item_offsets;
  args.item_other = item_other;
  args.n_long = n_long;
  args.n_shards = n_shards;
  args.block = block;
  args.n_pad = static_cast<int>(n_pad);
  args.n_lanes = n_lanes;
  args.tiles = (n_lanes * block + kThreads - 1) / kThreads;
  args.n_channels = n_channels;
  args.err_col = err_col;
  args.weight = weight;
  args.fold = fold;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&front_shard_kernel), dim3(grid),
      dim3(kThreads), params, tile_bytes(n_channels),
      static_cast<cudaStream_t>(stream)));
}
