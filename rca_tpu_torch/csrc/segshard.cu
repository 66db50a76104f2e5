// The node-sharded engine's two recursions for every shard of one card, one
// cooperative launch per recursion, for Hopper (sm_90a).
//
// Replaces, where every shard of a dp row lies on one CUDA device (logical
// shards), the per-step composition of the node-sharded engine: per step an
// all-gather, one launch of segstep.cu's per-shard entry a shard and, for
// the impact, a fixed-order reduce-scatter and a multiply by inv_deg (8
// steps each way, 150 of the 252 launches of a sharded analysis at sp 4).
// Through them it replaces the TPU kernels rca_tpu/engine/segscan.py::
// pallas_segscan_max and ::pallas_segscan that each device runs over its own
// edge partition inside shard_map (rca_tpu/parallel/sharded.py:252 and
// :285, 8 steps each under lax.scan).  Shard k owns the nodes
// [k * block, (k + 1) * block) and the edges whose sources lie there; the
// vectors are one [B, n_pad] buffer on the card, shard k's block at
// k * block, so the all-gather between steps is only the grid barrier that
// orders a step's writes before the next step's reads.
//
//   up   (explain-away, K3):  u_0 = 0,
//        u_{k+1}[s] = max(u_k[s], max over the shard's edges (s, d) of
//                     max(h[d], g * u_k[d]))
//   down (impact, K2):        m_0 = 0, each step
//        phase 1: c_j[d] = sum over shard j's edges (s, d) of
//                 (a_ex[s] + g * m_k[s]),            for every shard j
//        phase 2: m_{k+1}[i] = (((c_0[i] + c_1[i]) + ...) + c_{sp-1}[i])
//                              * inv_deg[i]
//
// The up recursion: the shards' own sources partition the nodes, so their
// up layouts (real edges only) joined in shard order are one layout over
// all n_pad nodes, segment k * block + s holding shard k's segment s.  Over
// it the recursion is seggrid.cu's kernel itself (seg_grid_kernel, an Op
// of its own so a profile tells the two apart), and every segment is
// reduced by the tree segstep.cu's per-shard entry takes for it: a short
// one (at most 16 edges) by one thread in edge order, a longer one by the
// 256-thread block tree (a warp playing it up to 256 edges, the CTA
// above).  A max does not depend on the order, so u is bitwise the
// per-step composition and the dense engine.
//
// The down recursion, two phases a step, two grid barriers (the last one
// dropped: 15 for 8 steps):
//   - phase 1 reduces every (shard j, destination d) pair that shard j
//     reaches, as seggrid.cu reduces a segment (the pairs of all the
//     card's shards in one layout in item order: the big ones, the other
//     long ones 8 an item, the short ones 256 an item; a CTA stages its
//     run of edges once by cp.async.bulk), and writes the unscaled total
//     into the pair's slot of the contribution scratch c ([B, pairs]
//     floats, the caller's);
//   - phase 2: each node's thread adds the contributions of the shards
//     that reach it in shard order, scales by inv_deg, writes m and the
//     value the next step's edges gather, a_ex + g * m (w, [B, n_pad]
//     floats, the caller's: phase 1 reads it and phase 2 rewrites it, a
//     barrier between, so it needs no second buffer).
//
// Bitwise the per-step composition on the card: the per-edge value and
// every pair's reduction tree are DownSumStep's (segstep.cu), the adds and
// the multiply are spelled __fadd_rn / __fmul_rn, so nvcc contracts
// nothing, as torch's separate add and mul kernels do not.  The
// composition's reduce-scatter also adds a +0 for every shard that does
// not reach the node (the per-shard entry writes 0.0f there).  Phase 2
// skips those adds, which cannot change the bits: a contribution is 0.0f
// or a sum of __fadd_rn from +0, and under round-to-nearest such a sum is
// never -0, so no partial sum is -0 and x + (+0) is x (a NaN stays the NaN
// it is); a node no shard reaches gets +0, as 0.0f + ... + 0.0f.
//
// Lanes: a lane's vectors sit lane * n_pad entries in, its contributions
// lane * pairs in (inv_deg, the layouts and the reach lists shared); a
// lane goes through the same threads' arithmetic as a solo launch.
//
// The grid is capped at the occupancy API's co-resident bound
// (rca_seg_steps_grid_cap for up, rca_seg_steps_shard_cap for down);
// CTAs loop over their items and lanes, and in phase 2 stride over the
// nodes, so no shape is refused, and every CTA reaches every barrier.
//
// Bound: bytes.  The function's own: one pass over a CSR of the real
// edges (n_pad + 1 + e ints), h or a_ex and inv_deg read, the output
// written, as for the grid recursions (kernels/cost.py::up_steps /
// ::down_steps with no long-segment ids; the layouts above are this
// kernel's choice and are not charged): about 1 MB at 49,999 services,
// well under a microsecond at 3.35 TB/s.  What the launch costs beyond
// that is one launch and ramp, the grid barriers (7 up, 15 down) and each
// step's longest chain of gathers.

#include "seggrid.cuh"

namespace {

// the up recursion over the shards' joined layout: seggrid.cu's UpGrid
// under a name of its own
struct UpShard : UpGrid {};

struct ShardDown {
  GridArgs g;                 // phase 1: in = a_ex, w, out = c, inv_deg
  const int* reach_offsets;   // [n_pad + 1]
  const int* reach;           // [pairs] the node's pairs, in shard order
  float* m;                   // [B, n_pad]: m_k, then m_steps
};

// Phase 2 of step k: every (lane, node) of the launch, strided over all
// its threads.  ``last``: the recursion's end, no gathered value to write.
__device__ __forceinline__ void reduce_shards(const ShardDown& a, bool last) {
  const GridArgs& p = a.g;
  const long long total = static_cast<long long>(p.n_lanes) * p.n_pad;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < total; t += stride) {
    const int b = static_cast<int>(t / p.n_pad);
    const int i = static_cast<int>(t - static_cast<long long>(b) * p.n_pad);
    const float* c = p.out + static_cast<size_t>(b) * p.out_stride;
    const int r0 = __ldg(a.reach_offsets + i);
    const int r1 = __ldg(a.reach_offsets + i + 1);
    // written in this launch: plain loads, never the read-only path
    float acc = r0 < r1 ? c[__ldg(a.reach + r0)] : 0.0f;
    for (int r = r0 + 1; r < r1; ++r) {
      acc = __fadd_rn(acc, c[__ldg(a.reach + r)]);
    }
    const float m = __fmul_rn(acc, __ldg(p.inv_deg + i));
    a.m[t] = m;
    if (!last) p.w[t] = DownPart::value(p.gamma, __ldg(p.in + t), m);
  }
}

__global__ void __launch_bounds__(kThreads) seg_shard_down_kernel(
    ShardDown a) {
  extern __shared__ __align__(128) int stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[kWarps];
  const GridArgs& p = a.g;
  const Share sh = share_of(p, stage, &full);
  for (int k = 0; k < p.steps; ++k) {
    // step 0 gathers value(a_ex, 0) from the input; w_k after
    if (k == 0) {
      grid_step<DownPart, true>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, p.w,
                                p.w, true, partial);
    } else {
      grid_step<DownPart, false>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, p.w,
                                 p.w, true, partial);
    }
    // every shard's contributions written, and w_k read
    cg::this_grid().sync();
    const bool last = k == p.steps - 1;
    reduce_shards(a, last);
    // m_{k+1} and w_{k+1} written, the contributions read
    if (!last) cg::this_grid().sync();
  }
}

}  // namespace

// *cap = the most CTAs of the impact shard kernel co-resident on the
// current device: the bound the launch's grid keeps.  The up shard kernel
// is the up grid kernel under its own symbol, so rca_seg_steps_grid_cap
// gives its bound.  The wrapper caches it per device.
extern "C" int rca_seg_steps_shard_cap(int* cap) {
  return co_resident(reinterpret_cast<const void*>(&seg_shard_down_kernel),
                     cap);
}

// `steps` >= 1 explain-away steps of every shard of the card over n_lanes
// lanes of n_pad entries, over the shards' joined up layout in item order
// (n_pad segments, n_long long, the first n_big big), in one cooperative
// launch of g_items x g_lanes CTAs (their product at most the cap above),
// with `scratch` holding 2 * n_lanes * n_pad floats; returns the
// cudaError_t of the launch.
extern "C" int rca_seg_up_steps_shard(const float* h, float gamma, int steps,
                                      const int* item_seg,
                                      const int* item_offsets,
                                      const int* item_other, int n_long,
                                      int n_big, int n_lanes, int n_pad,
                                      float* scratch, float* out,
                                      int g_items, int g_lanes,
                                      void* stream) {
  return launch<UpShard>(h, nullptr, gamma, steps, item_seg, item_offsets,
                         item_other, n_long, n_big, -1, n_lanes, n_pad,
                         scratch, out, g_items, g_lanes, stream);
}

// `steps` >= 1 impact steps of every shard of the card over n_lanes lanes
// of n_pad entries: the shards' (shard, destination) pairs as one layout
// in item order (n_pairs positions, item_seg their slots, n_long long,
// the first n_big big), each node's pairs in shard order (reach_offsets,
// reach), in one cooperative launch of g_items x g_lanes CTAs, with
// `scratch` holding n_lanes * (n_pad + n_pairs) floats; returns the
// cudaError_t of the launch.
extern "C" int rca_seg_down_steps_shard(
    const float* a_ex, const float* inv_deg, float gamma, int steps,
    const int* item_seg, const int* item_offsets, const int* item_other,
    int n_pairs, int n_long, int n_big, const int* reach_offsets,
    const int* reach, int n_lanes, int n_pad, float* scratch, float* out,
    int g_items, int g_lanes, void* stream) {
  ShardDown args;
  float* contrib = scratch + static_cast<size_t>(n_lanes) * n_pad;
  // w: the first n_lanes * n_pad floats of the scratch, the contributions
  // the rest
  const int bad = grid_args(&args.g, a_ex, inv_deg, gamma, steps, item_seg,
                            item_offsets, item_other, n_pairs, n_long, n_big,
                            -1, n_lanes, n_pad, n_pairs, scratch, contrib,
                            g_items, g_lanes);
  if (bad) return bad;
  args.reach_offsets = reach_offsets;
  args.reach = reach;
  args.m = out;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&seg_shard_down_kernel),
      dim3(g_items * g_lanes), dim3(kThreads), params, kStageBytes,
      static_cast<cudaStream_t>(stream)));
}
