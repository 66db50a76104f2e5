// The node-sharded engine's two recursions over distinct cards, one
// cooperative launch per card per recursion, exchanging blocks through
// NVLink peer memory, for Hopper (sm_90a).
//
// Replaces, where a dp row's shards lie one a card on cards that reach each
// other's memory (the multi-card default of make_engine()), the per-step
// composition of the node-sharded engine: per step an all-gather issued by
// the host (a peer copy per foreign block and a concatenation per card),
// one launch of segstep.cu's per-shard entry a card and, for the impact, a
// fixed-order reduce-scatter and a multiply by inv_deg (8 steps each way:
// 64 launches, 16 all-gathers and 8 reduce-scatters an analysis at sp 4).
// Through them it replaces the TPU kernels rca_tpu/engine/segscan.py::
// pallas_segscan_max and ::pallas_segscan that each device runs over its own
// edge partition inside shard_map, between jax.lax.all_gather and
// psum_scatter over the sp axis (rca_tpu/parallel/sharded.py:246-254 and
// :280-289, 8 steps each under lax.scan).
//
// Card k (its rank) owns the nodes [k * block, (k + 1) * block) and the
// edges whose sources lie there.  Each card keeps a full copy of the
// gathered values w (what an edge reads from its other endpoint), and
// every step each card stores its own block of the next w into every
// peer's copy with plain coalesced stores into peer memory, then crosses a
// barrier of all the cards:
//
//   up   (explain-away, K3):  u_0 = 0,
//        u_{k+1}[s] = max(u_k[s], max over the card's edges (s, d) of
//                     max(h[d], g * u_k[d]))
//        each step: the card's own sources reduced over its up layout
//        (seggrid.cuh's grid_step, the up grid recursion's arithmetic), a
//        grid barrier, its block of w_{k+1} = max(h, g * u_{k+1}) pushed
//        into every peer's copy, the cards' barrier (the last step
//        neither pushes nor waits: 7 barriers for 8 steps).  w is
//        double-buffered, two halves of `half` floats on each card (each
//        holding [B, n_pad]), so a push never overwrites what a slower
//        peer still reads;
//   down (impact, K2):        m_0 = 0, each step
//        phase 1: card j reduces every (j, d) pair its edges reach with
//                 segstep.cu's DownSumStep tree (seggrid.cuh's DownPart)
//                 into its dense contributions c_j ([B, n_pad], 0 where it
//                 reaches nothing); a grid barrier; c_j's block of each
//                 owner o pushed into row j of o's inbox; the cards'
//                 barrier;
//        phase 2: the owner adds its inbox rows 0, 1, ..., sp-1 in that
//                 order with __fadd_rn, multiplies by inv_deg with
//                 __fmul_rn, writes m_{k+1}, and pushes the value the next
//                 step's edges gather, a_ex + g * m_{k+1}, into every
//                 card's copy of w; the cards' barrier (dropped after the
//                 last step: 15 barriers for 8 steps).
//
// Bitwise the per-step composition (the per-shard entries between the
// collectives) and so the shard_grid form (segshard.cu): the up step is
// the up grid recursion's arithmetic over the card's own part of the
// shards' joined layout (every segment reduced by the tree its length
// picks, as segshard.cu reduces it; a max does not depend on the order);
// each pair's sum is DownPart's tree as in segshard.cu; and phase 2 is
// the composition's reduce-scatter itself, the sp dense rows (zeros
// included) added in shard order, then the multiply, spelled with _rn
// intrinsics so nvcc contracts nothing.  No float result depends on the
// order of atomics or of arrival: only the integer flags are atomic.
//
// The barrier across the cards: every thread fences its pushes at system
// scope (__threadfence_system), then a grid barrier; then one thread of
// the card stores the barrier's number into its word of every peer's flag
// array with st.release.sys, and spins with ld.acquire.sys on its own
// array until every peer has stored that number; then a grid barrier
// again, which carries the acquire to every CTA (a device-scope fence
// drops stale L1 lines, so the step's plain loads of w see the peers'
// stores).  The host numbers the barriers from a counter it advances by
// each launch's count, so flags are never reset and a stale flag cannot
// pass; numbers compare by their signed 32-bit difference, safe across
// wrap-around.  The exchange buffers' parity runs on across launches (the
// host advances it by the pushes of each launch), so the first push of a
// launch never lands in the buffer a peer may still read in the launch
// before.  The two halves of the up w and of the inbox sit `half` floats
// apart, the capacity of the card's buffers and not this launch's lanes x
// n_pad: two launches of one kind back to back at different widths (or
// over different graphs) keep their halves disjoint, so the first push of
// the narrow one cannot land inside the half that a slower peer still
// reads at the end of the wide one.
//
// A wait is bounded: a spin that passes wait_ns on %globaltimer executes
// trap.  The kernel then fails with an error, the context is lost, and the
// next CUDA call on the card raises; a peer that never arrives cannot hang
// the caller.  Co-residency across cards is the caller's to keep: the sp
// launches of one recursion are enqueued back to back under one lock, one
// dedicated stream a card (engine/segscan.py::launch_peer), so no card's
// queue holds a peer launch behind one that waits for it.
//
// Bound: the larger of the card's own HBM bytes (its CSR, h or a_ex and
// inv_deg read, its block written) over 3.35 TB/s and the bytes it pushes
// over NVLink (its block of w to sp - 1 peers each step; for the impact
// also its dense contributions' foreign blocks) over the per-direction
// NVLink rate (kernels/cost.py::up_steps_peer, ::down_steps_peer).  What
// the launch costs beyond that is the grid barriers and the round trips
// of the flags across the cards.

#include "seggrid.cuh"

namespace {

constexpr int kMaxCards = 16;

// What one card's launch knows of the others.
struct Peers {
  float* w[kMaxCards];          // each card's copy of w (its base)
  float* inbox[kMaxCards];      // down: each card's [2, sp, B, block] inbox
  unsigned* flags[kMaxCards];   // each card's flag words, one a card
  int rank;
  int n_cards;
  int block;                    // nodes a card owns
  int base;                     // rank * block
  size_t half;                  // floats between the buffers' two halves
  unsigned epoch;               // barriers numbered before this launch
  int parity;                   // the exchange buffers' parity at step 0
  unsigned long long wait_ns;   // the bound of one wait
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every card has reached barrier number `target` (the caller fenced its
// pushes at system scope first).
__device__ void cards_barrier(const Peers& q, unsigned target) {
  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int j = 0; j < q.n_cards; ++j) {
      if (j != q.rank) store_release_sys(q.flags[j] + q.rank, target);
    }
    const unsigned long long t0 = global_ns();
    for (int j = 0; j < q.n_cards; ++j) {
      if (j == q.rank) continue;
      while (static_cast<int>(load_acquire_sys(q.flags[q.rank] + j) -
                              target) < 0) {
        if (global_ns() - t0 > q.wait_ns) __trap();
        __nanosleep(64);
      }
    }
  }
  cg::this_grid().sync();
}

__device__ __forceinline__ long long first_thread() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long all_threads() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

struct PeerUp {
  GridArgs g;   // in = h (full), w = this card's copy, out = u's block
  Peers q;
};

// The card's block of the w buffer at `offset` floats, every lane, stored
// into every peer's copy (written in this launch: plain loads).
__device__ void push_block(const GridArgs& p, const Peers& q, size_t offset) {
  const long long total = static_cast<long long>(p.n_lanes) * q.block;
  for (long long t = first_thread(); t < total; t += all_threads()) {
    const int b = static_cast<int>(t / q.block);
    const int i = static_cast<int>(t - static_cast<long long>(b) * q.block);
    const size_t at = offset + static_cast<size_t>(b) * p.n_pad + q.base + i;
    const float v = p.w[at];
    for (int j = 0; j < q.n_cards; ++j) {
      if (j != q.rank) q.w[j][at] = v;
    }
  }
  __threadfence_system();
}

__global__ void __launch_bounds__(kThreads) seg_peer_up_kernel(PeerUp a) {
  extern __shared__ __align__(128) int stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[kWarps];
  const GridArgs& p = a.g;
  const Peers& q = a.q;
  const Share sh = share_of(p, stage, &full);
  for (int k = 0; k < p.steps; ++k) {
    const bool last = k == p.steps - 1;
    // w_k in the buffer of parity + k - 1 (unread at step 0), w_{k+1}
    // into parity + k
    float* read = p.w + ((q.parity + k + 1) & 1) * q.half;
    float* write = p.w + ((q.parity + k) & 1) * q.half;
    if (k == 0) {
      grid_step<UpGrid, true>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, read,
                              write, last, partial);
    } else {
      grid_step<UpGrid, false>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, read,
                               write, last, partial);
    }
    if (!last) {
      // the card's block of w_{k+1} written, then pushed
      cg::this_grid().sync();
      push_block(p, q, static_cast<size_t>(write - p.w));
      cards_barrier(q, q.epoch + static_cast<unsigned>(k) + 1u);
    }
  }
}

struct PeerDown {
  GridArgs g;               // in = a_ex (full), w = this card's copy,
                            // out = c ([B, n_pad]), inv_deg = its block
  Peers q;
  float* m;                 // [B, block]: m_steps of the card's nodes
};

// The card's contributions, every lane, into row `rank` of their owners'
// inboxes' half `par` (the card's own block into its own inbox).
__device__ void push_contributions(const PeerDown& a, int par) {
  const GridArgs& p = a.g;
  const Peers& q = a.q;
  const long long total = static_cast<long long>(p.n_lanes) * p.n_pad;
  const size_t row = static_cast<size_t>(p.n_lanes) * q.block;
  const size_t mine = static_cast<size_t>(par) * q.half +
                      static_cast<size_t>(q.rank) * row;
  for (long long t = first_thread(); t < total; t += all_threads()) {
    const int b = static_cast<int>(t / p.n_pad);
    const int d = static_cast<int>(t - static_cast<long long>(b) * p.n_pad);
    const int owner = d / q.block;
    const int i = d - owner * q.block;
    q.inbox[owner][mine + static_cast<size_t>(b) * q.block + i] = p.out[t];
  }
  __threadfence_system();
}

// Phase 2: every (lane, node) of the card, strided over its threads.
// ``last``: the recursion's end, no gathered value to push.
__device__ void reduce_inbox(const PeerDown& a, int par, bool last) {
  const GridArgs& p = a.g;
  const Peers& q = a.q;
  const long long total = static_cast<long long>(p.n_lanes) * q.block;
  const size_t row = static_cast<size_t>(p.n_lanes) * q.block;
  const float* box = q.inbox[q.rank] + static_cast<size_t>(par) * q.half;
  for (long long t = first_thread(); t < total; t += all_threads()) {
    const int b = static_cast<int>(t / q.block);
    const int i = static_cast<int>(t - static_cast<long long>(b) * q.block);
    // written in this launch, by this card and its peers: plain loads
    float acc = box[t];
    for (int r = 1; r < q.n_cards; ++r) {
      acc = __fadd_rn(acc, box[static_cast<size_t>(r) * row + t]);
    }
    const float m = __fmul_rn(acc, __ldg(p.inv_deg + i));
    a.m[t] = m;
    if (!last) {
      const size_t at = static_cast<size_t>(b) * p.n_pad + q.base + i;
      const float v = DownPart::value(p.gamma, __ldg(p.in + at), m);
      for (int j = 0; j < q.n_cards; ++j) q.w[j][at] = v;
    }
  }
  if (!last) __threadfence_system();
}

__global__ void __launch_bounds__(kThreads) seg_peer_down_kernel(
    PeerDown a) {
  extern __shared__ __align__(128) int stage[];
  __shared__ __align__(8) uint64_t full;
  __shared__ float partial[kWarps];
  const GridArgs& p = a.g;
  const Peers& q = a.q;
  const Share sh = share_of(p, stage, &full);
  for (int k = 0; k < p.steps; ++k) {
    const int par = (q.parity + k) & 1;
    const unsigned number = q.epoch + 2u * static_cast<unsigned>(k);
    // step 0 gathers value(a_ex, 0) from the input; w_k after
    if (k == 0) {
      grid_step<DownPart, true>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, p.w,
                                p.w, true, partial);
    } else {
      grid_step<DownPart, false>(p, sh.sl, sh.j0, sh.j1, sh.b0, sh.b1, p.w,
                                 p.w, true, partial);
    }
    // the card's contributions written, then pushed to their owners
    cg::this_grid().sync();
    push_contributions(a, par);
    cards_barrier(q, number + 1u);
    const bool last = k == p.steps - 1;
    reduce_inbox(a, par, last);
    // m_{k+1} written and w_{k+1} pushed everywhere, the inbox read
    if (!last) cards_barrier(q, number + 2u);
  }
}

template <class Args>
void* peer_kernel();

template <>
void* peer_kernel<PeerUp>() {
  return reinterpret_cast<void*>(&seg_peer_up_kernel);
}

template <>
void* peer_kernel<PeerDown>() {
  return reinterpret_cast<void*>(&seg_peer_down_kernel);
}

// The peers' table, checked; an invalid value's error.
int peers_of(Peers* q, int rank, int n_cards, int n_lanes, int n_pad,
             const unsigned long long* w_table,
             const unsigned long long* inbox_table,
             const unsigned long long* flag_table, unsigned long long half,
             unsigned epoch, int parity, unsigned long long wait_ns) {
  if (n_cards < 1 || n_cards > kMaxCards || rank < 0 || rank >= n_cards ||
      n_pad < n_cards || n_pad % n_cards != 0 || parity < 0 ||
      wait_ns == 0 || n_lanes < 1 ||
      half < static_cast<unsigned long long>(n_lanes) * n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *q = Peers{};
  for (int j = 0; j < n_cards; ++j) {
    q->w[j] = reinterpret_cast<float*>(w_table[j]);
    q->inbox[j] = inbox_table ? reinterpret_cast<float*>(inbox_table[j])
                              : nullptr;
    q->flags[j] = reinterpret_cast<unsigned*>(flag_table[j]);
    if (!q->w[j] || !q->flags[j] || (inbox_table && !q->inbox[j])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  q->rank = rank;
  q->n_cards = n_cards;
  q->block = n_pad / n_cards;
  q->base = rank * q->block;
  q->half = static_cast<size_t>(half);
  q->epoch = epoch;
  q->parity = parity & 1;
  q->wait_ns = wait_ns;
  return 0;
}

template <class Args>
int launch_peer(Args* args, int g_items, int g_lanes, void* stream) {
  void* params[] = {args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      peer_kernel<Args>(), dim3(g_items * g_lanes), dim3(kThreads), params,
      kStageBytes, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// *cap = the most CTAs of the down (else up) peer kernel co-resident on the
// current device: the bound the launch's grid keeps (the wrapper caches it
// per device, and splits it between the ranks that share a card).
extern "C" int rca_seg_steps_peer_cap(int down, int* cap) {
  return co_resident(down ? peer_kernel<PeerDown>() : peer_kernel<PeerUp>(),
                     cap);
}

// `steps` >= 1 explain-away steps of card `rank` of n_cards over n_lanes
// lanes of n_pad entries: the card's up layout in item order (n_seg =
// n_pad / n_cards segments, the card's own sources as global node ids, n_long
// long, the first n_big big), h the full [B, n_pad] input, out the card's
// [B, block] block of u; w_table / flag_table: every card's copy of w (two
// halves of `half` >= n_lanes x n_pad floats) and its flag words; the
// barriers numbered from epoch + 1, the buffers' parity from `parity`; one
// cooperative launch of g_items x g_lanes CTAs.  Returns the cudaError_t of
// the launch.
extern "C" int rca_seg_up_steps_peer(
    const float* h, float gamma, int steps, const int* item_seg,
    const int* item_offsets, const int* item_other, int n_seg, int n_long,
    int n_big, int n_lanes, int n_pad, int rank, int n_cards,
    const unsigned long long* w_table, const unsigned long long* flag_table,
    unsigned long long half, unsigned epoch, int parity,
    unsigned long long wait_ns, float* out, int g_items, int g_lanes,
    void* stream) {
  PeerUp args;
  int bad = peers_of(&args.q, rank, n_cards, n_lanes, n_pad, w_table,
                     nullptr, flag_table, half, epoch, parity, wait_ns);
  if (bad) return bad;
  if (n_seg != args.q.block) return static_cast<int>(cudaErrorInvalidValue);
  // out addressed by global node id: the block starts at base
  bad = grid_args(&args.g, h, nullptr, gamma, steps, item_seg, item_offsets,
                  item_other, n_seg, n_long, n_big, -1, n_lanes, n_pad,
                  args.q.block, args.q.w[rank], out - args.q.base, g_items,
                  g_lanes);
  if (bad) return bad;
  return launch_peer(&args, g_items, g_lanes, stream);
}

// `steps` >= 1 impact steps of card `rank` of n_cards over n_lanes lanes of
// n_pad entries: the card's (card, destination) pairs in item order
// (n_pairs positions, item_seg their destinations, n_long long, the first
// n_big big), a_ex the full [B, n_pad] input, inv_deg the card's [block]
// block, out the card's [B, block] block of m, contrib the card's
// [B, n_pad] contributions (0 where it reaches nothing, kept between
// launches); w_table / inbox_table / flag_table: every card's [B, n_pad]
// copy of w, its inbox (two halves of `half` >= n_lanes x n_pad floats,
// each [n_cards, B, block]) and its flag words; one cooperative launch of
// g_items x g_lanes CTAs.  Returns the cudaError_t of the launch.
extern "C" int rca_seg_down_steps_peer(
    const float* a_ex, const float* inv_deg, float gamma, int steps,
    const int* item_seg, const int* item_offsets, const int* item_other,
    int n_pairs, int n_long, int n_big, int n_lanes, int n_pad, int rank,
    int n_cards, const unsigned long long* w_table,
    const unsigned long long* inbox_table,
    const unsigned long long* flag_table, unsigned long long half,
    unsigned epoch, int parity, unsigned long long wait_ns, float* contrib,
    float* out, int g_items, int g_lanes, void* stream) {
  PeerDown args;
  int bad = peers_of(&args.q, rank, n_cards, n_lanes, n_pad, w_table,
                     inbox_table, flag_table, half, epoch, parity, wait_ns);
  if (bad) return bad;
  bad = grid_args(&args.g, a_ex, inv_deg, gamma, steps, item_seg,
                  item_offsets, item_other, n_pairs, n_long, n_big, -1,
                  n_lanes, n_pad, n_pad, args.q.w[rank], contrib, g_items,
                  g_lanes);
  if (bad) return bad;
  args.m = out;
  return launch_peer(&args, g_items, g_lanes, stream);
}
