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

// The device code lives in seggrid.cuh, which segshard.cu shares.
#include "seggrid.cuh"

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
