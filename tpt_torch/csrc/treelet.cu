// Treelet scan and self-rebinning closest hit for NVIDIA Hopper (sm_90a),
// with a plain C interface for ctypes (tpt_torch/bvh/treelet_traverse.py
// binds them).
//
// Replaces the Pallas TPU kernels of tpt/bvh/pallas_treelet.py:
//   K9  tpt_treelet_scan        <- treelet_scan        (:522, :544)
//   K10 tpt_treelet_closest_hit <- treelet_closest_hit (:570, :614)
//   K11 tpt_treelet_scan_multi  <- treelet_scan_multi  (:769, :792)
//
// Tables: the wide pack's node_f32 [Nt, W], node_child [Nt, 16] and
// tri_f32 [Tp, 16] (packet_wide.cu describes them), and the treelet top
// tree above the cut (tpt_torch/bvh/treelet.py:attach_treelets): top_f32
// [Ntop, W] child boxes, top_child [Ntop, 16] (cols < arity: a top child,
// or -1 for a treelet reference or an empty slot; cols 8-15 the octant
// order words), top_tref [Ntop, 8] the treelet root codes (a wide node id
// >= 0, or a cluster code < -1) and top_tord [Ntop, 8] their ordinals.
//
// Semantics. The three TPU kernels walk one stack per super-packet of
// consecutive lanes (2048 on bounces, 4096 for camera rays), and what
// they return depends on the packet: a node is pushed when ANY lane of
// the packet hits it and keeps it, every lane then tests every child of
// every popped node (K9's overflow flag and candidate count, which
// decides the hybrid easy/hard split, count those, and K11's thr is
// lowered by every one its slot window excludes), and the packet's child
// order comes from the octant of its first ray. K10's packet also
// decides, round by round, which treelet the whole packet drains next
// (the minimum entry t, then the minimum code), so which triangle a lane
// finds among equal t depends on its packet too. To give tpt's results
// tie for tie, the kernels keep tpt's packets: one block per packet, the
// "any lane" tests block-wide ORs of per-child bit masks, the drain's
// choice a block-wide minimum. Padded lanes past n behave as tpt's
// padding (t_max = -1; for K10's seed: no candidate, exhausted). Every
// control decision is computed by every thread from the same block-wide
// values, so the control flow is uniform and __syncthreads is safe.
//
// What bounds K9/K10 on this card, and the design. A packet is serial: a
// drain step cannot start before the step before it has voted, and every
// lane tests every cluster the packet pops, so a packet's time is its
// steps times one step's critical path, and the longest packets set a
// launch's time. One step's path is its lanes' Moller-Trumbore and slab
// tests (operations), spread over the block's threads, plus the votes.
// So:
//  - a packet is a block of THREADS = 1024 threads (32 warps on one SM,
//    enough to hide the tests' latency), a thread owning packet / THREADS
//    lanes (lanes base + k * THREADS + threadIdx.x: 2 on bounces, 4 for
//    camera rays);
//  - K10 keeps each lane's state on chip: the ray, its inverse direction
//    and the best hit (13 planes, [plane][lane]) in dynamic shared memory
//    for packets up to 4096 lanes, and the thresholds, flags and S
//    candidate slots (3 + 2S planes, touched at round edges and in scans)
//    there too where they fit beside them (2048 lanes at S <= 5); a plane
//    set that does not fit lives in a global scratch per block, read
//    through the same (generic) pointer. K9 keeps its lanes' rays,
//    inverse directions and its one slot in registers (a template on the
//    lanes a thread) and writes them once;
//  - each drain step stages the popped clusters' triangle rows (up to 4 x
//    16 rows, in pop then row order; more in chunks of STAGE_ROWS), the
//    popped nodes' child boxes and child rows into shared memory once
//    (one scalar load per thread), and every lane reads each row as three
//    float4 broadcasts, lane after lane (two lanes a row at once spilled
//    and ran slower); K9 reads each top node's child box once per pop for
//    all its lanes (child outer, lane inner);
//  - a packet-wide vote is a warp reduction (__reduce_or_sync, and
//    __reduce_min_sync on a 64-bit key's two words) and one barrier,
//    every thread reading the 32 warps' words from a double buffer: one
//    barrier a step for the child bits, one a round for the round's end
//    and the next drain's (min t, min code), which is one 64-bit key. The
//    stacks need no barrier of their own: every thread computes the same
//    pushes and writes them itself.
// One step is then a staging barrier, the lanes' tests and one vote, and
// the SM's instruction issue bounds it: on an H100 (700 W) a bounce-1
// drain of 2048 lanes takes ~47 us, a packet of 570 drains 26.6 ms alone.
// A launch of many packets, one an SM at a time, is the sum of their
// times over the SMs plus the tail of the packets it starts last; its
// order is the pool's (scripts/treelet_packet_order.py measures both).
//
// K11 runs K9's walk (scan_kernel) with another lane policy: each lane
// keeps S (entry t, ordinal) slots and thr, as K3 does over every treelet
// box; its slots equal K3's, and its thr, which also counts pruned
// subtrees, lies at or below K3's. Its result depends on every slab test
// its packets make (thr is lowered by each child the slot window
// excludes), so what bounds it is the same as K9's: the packet's serial
// pops times one pop's lane tests and vote. The walk is K9's: 1024
// threads a packet, the rays in registers, each child box read once for
// all of a thread's lanes, one vote a pop. The slots, 2S + 1 words a
// lane, stay in registers while a thread's lanes hold at most 18 of them
// (S <= 8 at one lane a thread, S <= 4 at two), else in [2S + 1][packet]
// planes in dynamic shared memory (up to 227 KB), else in a global
// scratch per block; a lane reads its window (the S-th slot's t) at every
// box it passes and the slots only to insert.
//
// K10 runs tpt's round machine per packet: SCAN rounds walk the top tree
// and fill each lane's S candidate slots past its (thr_t, thr_c)
// threshold (overflow re-enters a later scan), DRAIN rounds walk the
// subtree of the packet-nearest requested treelet once with the node and
// cluster stacks (4 node pops and 4 cluster pops a step, the cluster-stack
// throttle, NSTACK 192 and CSTACK 1024) and every lane tests every popped
// cluster with a strict t < best, in pop order then row order, then the
// step's slab tests with the best t those tests left; the drained slot is
// then removed.
//
// The arithmetic is tpt's, operation for operation: the slab test with
// NaN-propagating min/max (ray_common.cuh), Moller-Trumbore as in
// ray_common.cuh, built with -fmad=false, so the plain PyTorch versions
// (treelet_traverse.py) give the same bits. Lanes that cannot pass a test
// (best t below 0 or NaN) skip it; nothing they could change is skipped.
//
// Bounds. tpt drops a push that finds a stack full and stops at its step
// caps (8 * num_top + 1024 pops of the top tree a walk, 8 * num_nodes +
// 8192 drain steps, max_rounds rounds) silently; here a packet that did
// any of these adds its live lanes (t_max > 0) to *capped, whose results
// are then not exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define THREADS 1024          // K9/K10/K11: threads a packet (one block)
#define WARPS (THREADS / 32)
#define NONE_CODE 0x7FFFFFFF
#define NONE_ORD 0x7FFFFF     // K11's empty slot (pallas_treelet.py NONE_ORD)
#define CODE_MIN (-0x7FFFFFFF - 1)
#define BIG 3.0e38f           // pallas_treelet.py _INF
#define MISS_T 3.4e38f        // FLT_MAX of tpt/integrators/intersect.py
#define SCAN_STACK 256        // K9's stack (pallas_treelet.py:499)
#define NSTACK 192            // K10's node stack (NSTACK_DEPTH)
#define CSTACK 1024           // K10's cluster stack (CSTACK_DEPTH)
#define NODE_POPS 4
#define CLUSTER_POPS 4
#define MAX_SLOTS 8
#define MAX_ARITY 8           // NODE_POPS * arity bits in one mask
#define STAGE_ROWS 64         // triangle rows staged a chunk (4 x 16)
#define SMEM_LIMIT 232448     // shared memory a block may use (227 KB)
#define FULL_MASK 0xffffffffu
#define KEY_NONE 0xffffffffffffffffull

// K10's lane planes that fit on chip (dynamic shared memory)
#ifndef DYNAMIC_SHARED
extern __shared__ __align__(16) unsigned char dynamic_shared_[];
#define DYNAMIC_SHARED dynamic_shared_
#endif

namespace {

struct Top {
  const float* f32;
  int width;
  const int* child;
  const int* tref;
  const int* tord;
  int num;
};

struct Wide {
  const float* node_f32;
  int width;
  const int* child;
  int num_nodes;
  const float* tri;
  int tri_rows;
  int max_cluster;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  int n;
};

__device__ __forceinline__ bool lex_lt(float ta, int ca, float tb, int cb) {
  return ta < tb || (ta == tb && ca < cb);
}

// child box slab test against [0, limit] (pallas_traverse.py:_slab), with
// jnp's NaN-propagating min/max; tn is the entry t
__device__ __forceinline__ bool slab_box(float b0, float b1, float b2,
                                         float b3, float b4, float b5,
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float limit, float& tn) {
  float t0x = (b0 - ox) * ix;
  float t0y = (b1 - oy) * iy;
  float t0z = (b2 - oz) * iz;
  float t1x = (b3 - ox) * ix;
  float t1y = (b4 - oy) * iy;
  float t1z = (b5 - oz) * iz;
  tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
            nmax(nmin(t0z, t1z), 0.0f));
  float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                  nmin(nmax(t0z, t1z), limit));
  return tn <= tf;
}

// the same on a box in global memory
__device__ __forceinline__ bool slab_tn(const float* __restrict__ b, float ox,
                                        float oy, float oz, float ix,
                                        float iy, float iz, float limit,
                                        float& tn) {
  return slab_box(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
                  __ldg(b + 4), __ldg(b + 5), ox, oy, oz, ix, iy, iz, limit,
                  tn);
}

// float -> int preserving order
__device__ __forceinline__ int ordered(float f) {
  int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

// (entry t, code) as one unsigned key in lexicographic order: the drain
// takes the minimum t, then the minimum code (entry t is never -0 or NaN
// in a valid slot: nmax(., 0) gives +0, and a NaN fails t < bt)
__device__ __forceinline__ unsigned long long slot_key(float t, int c) {
  return ((unsigned long long)((unsigned)ordered(t) ^ 0x80000000u) << 32) |
         (unsigned long long)((unsigned)c ^ 0x80000000u);
}
__device__ __forceinline__ int key_code(unsigned long long k) {
  return (int)((unsigned)k ^ 0x80000000u);
}

// the packet's octant, from its first lane (pallas_traverse.py:465)
__device__ __forceinline__ int packet_octant(const Rays& r, int base) {
  return (r.dx[base] >= 0.0f ? 4 : 0) + (r.dy[base] >= 0.0f ? 2 : 0) +
         (r.dz[base] >= 0.0f ? 1 : 0);
}

__device__ __forceinline__ unsigned long long warp_sum64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Packet-wide votes of K9/K10: a warp reduction, one barrier, and every
// thread reading the warps' words. The buffers alternate: a vote's
// readers are past the next vote's barrier before the vote after next
// writes the same half.
// ---------------------------------------------------------------------------

struct Votes {
  unsigned long long key[2][WARPS];
  unsigned bits[2][WARPS];
  int count[WARPS];
};

// OR of `bits` over the packet
__device__ __forceinline__ unsigned vote_or(Votes& v, int& par,
                                            unsigned bits) {
  bits = __reduce_or_sync(FULL_MASK, bits);
  if ((threadIdx.x & 31) == 0) v.bits[par][threadIdx.x >> 5] = bits;
  __syncthreads();
  unsigned any = 0u;
#pragma unroll 8
  for (int q = 0; q < WARPS; ++q) any |= v.bits[par][q];
  par ^= 1;
  return any;
}

// OR of `bits` and minimum of `key` over the packet
__device__ __forceinline__ void vote(Votes& v, int& par, unsigned& bits,
                                     unsigned long long& key) {
  bits = __reduce_or_sync(FULL_MASK, bits);
  // the warp's minimum key: the least high word, then the least low word
  // among the lanes that hold it
  const unsigned hi = __reduce_min_sync(FULL_MASK, (unsigned)(key >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL_MASK, (unsigned)(key >> 32) == hi ? (unsigned)key : 0xffffffffu);
  key = ((unsigned long long)hi << 32) | lo;
  if ((threadIdx.x & 31) == 0) {
    v.bits[par][threadIdx.x >> 5] = bits;
    v.key[par][threadIdx.x >> 5] = key;
  }
  __syncthreads();
  bits = 0u;
  key = KEY_NONE;
#pragma unroll 8
  for (int q = 0; q < WARPS; ++q) {
    bits |= v.bits[par][q];
    const unsigned long long x = v.key[par][q];
    key = x < key ? x : key;
  }
  par ^= 1;
}

// a warp's sum of `n` into v.count, read after the next vote's barrier
__device__ __forceinline__ void post_count(Votes& v, int n) {
  n = __reduce_add_sync(FULL_MASK, n);
  if ((threadIdx.x & 31) == 0) v.count[threadIdx.x >> 5] = n;
}
__device__ __forceinline__ int read_count(const Votes& v) {
  int s = 0;
  for (int q = 0; q < WARPS; ++q) s += v.count[q];
  return s;
}

#define V_POS 1u    // some lane's best t > 0
#define V_NAN 2u    // some lane's best t is NaN
#define V_NEED 4u   // some lane needs a scan

// ---------------------------------------------------------------------------
// K9 and K11: one walk of the top tree per packet (pallas_treelet.py:408-519
// and :647-766). The walk is shared; what a lane keeps is the policy's
// (`Lanes`): K9's nearest candidate, overflow flag and count; K11's S
// (entry t, ordinal) slots and thr. The policy is told, for each child
// box a lane passes, whether the child is kept (tn within the lane's
// window), and whether it is an internal child the window excludes or a
// treelet candidate.
// ---------------------------------------------------------------------------

// K9's outputs, f32/int32 [n] planes
struct NearestOut {
  float* st;
  int *sc, *so, *ovf, *cnt;
};

// K9's lane state, in registers: the lexicographically nearest (entry t,
// code) candidate and its ordinal, an overflow flag and a candidate count
template <int LPT>
struct Nearest {
  using Out = NearestOut;
  static constexpr bool kCodes = true;  // reads the children's codes
  float t[LPT];
  int c[LPT], o[LPT], f[LPT], m[LPT];

  __device__ __forceinline__ Nearest(const Out&, int, int) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      t[k] = BIG;
      c[k] = NONE_CODE;
      o[k] = 0;
      f[k] = 0;
      m[k] = 0;
    }
  }
  __device__ __forceinline__ float window(int k) const { return t[k]; }
  __device__ __forceinline__ void excluded(int k, float) { f[k] = 1; }
  __device__ __forceinline__ void candidate(int k, float tn, bool kept,
                                            int code, int ord) {
    ++m[k];
    if (!kept) {
      f[k] = 1;
    } else if (lex_lt(tn, code, t[k], c[k])) {
      if (c[k] != NONE_CODE) f[k] = 1;
      t[k] = tn;
      c[k] = code;
      o[k] = ord;
    } else {
      f[k] = 1;
    }
  }
  __device__ __forceinline__ void store(const Out& out, int k, int i,
                                        int) const {
    out.st[i] = t[k];
    out.sc[i] = c[k];
    out.so[i] = o[k];
    out.ovf[i] = f[k];
    out.cnt[i] = m[k];
  }
};

// K11's outputs, st/so [S, n] and thr [n], and where its planes live when
// they are not in registers
struct SlotOut {
  float* st;
  int* so;
  float* thr;
  int S;
  float* scratch;  // [blocks][2S + 1][packet] when not in shared memory
  int shared;      // the planes are in dynamic shared memory
};

// K11's lane state in registers: S slots and thr a lane, LPT lanes
template <int LPT, int S>
struct SlotRegs {
  using Out = SlotOut;
  static constexpr bool kCodes = false;
  float t[LPT][S];
  int o[LPT][S];
  float th[LPT];

  __device__ __forceinline__ SlotRegs(const Out&, int, int) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
#pragma unroll
      for (int q = 0; q < S; ++q) {
        t[k][q] = BIG;
        o[k][q] = NONE_ORD;
      }
      th[k] = BIG;
    }
  }
  __device__ __forceinline__ float window(int k) const { return t[k][S - 1]; }
  __device__ __forceinline__ void excluded(int k, float tn) {
    th[k] = nmin(th[k], tn);
  }
  __device__ __forceinline__ void candidate(int k, float tn, bool kept, int,
                                            int ord) {
    if (!kept) {
      th[k] = nmin(th[k], tn);
      return;
    }
    // insert (tn, ord) in ascending lexicographic order, a compare-swap
    // cascade; the entry it displaces, or the candidate itself when the
    // slots hold S nearer ones, lowers thr
    float ct = tn;
    int co = ord;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const float tq = t[k][q];
      const int oq = o[k][q];
      if (lex_lt(ct, co, tq, oq)) {
        t[k][q] = ct;
        o[k][q] = co;
        ct = tq;
        co = oq;
      }
    }
    if (co != NONE_ORD) th[k] = nmin(th[k], ct);
  }
  __device__ __forceinline__ void store(const Out& out, int k, int i,
                                        int n) const {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      out.st[(size_t)q * n + i] = t[k][q];
      out.so[(size_t)q * n + i] = o[k][q];
    }
    out.thr[i] = th[k];
  }
};

// K11's lane state in [2S + 1][packet] planes (S entry t, S ordinals,
// thr), in dynamic shared memory or in the block's slice of a global
// scratch, read through the same pointer; S at run time
template <int LPT>
struct SlotPlanes {
  using Out = SlotOut;
  static constexpr bool kCodes = false;
  float* p;
  int packet, S;

  __device__ __forceinline__ SlotPlanes(const Out& out, int packet_, int lpt)
      : p(out.shared ? reinterpret_cast<float*>(DYNAMIC_SHARED)
                     : out.scratch + (size_t)blockIdx.x * packet_ *
                                         (2 * out.S + 1)),
        packet(packet_),
        S(out.S) {
    for (int k = 0; k < lpt; ++k) {
      const int j = k * THREADS + threadIdx.x;
      for (int q = 0; q < S; ++q) {
        tf(q, j) = BIG;
        oi(q, j) = NONE_ORD;
      }
      tf(2 * S, j) = BIG;
    }
  }
  __device__ __forceinline__ float& tf(int q, int j) const {
    return p[q * packet + j];
  }
  __device__ __forceinline__ int& oi(int q, int j) const {
    return reinterpret_cast<int*>(p)[(S + q) * packet + j];
  }
  __device__ __forceinline__ float window(int k) const {
    return tf(S - 1, k * THREADS + threadIdx.x);
  }
  __device__ __forceinline__ void excluded(int k, float tn) {
    float& th = tf(2 * S, k * THREADS + threadIdx.x);
    th = nmin(th, tn);
  }
  __device__ __forceinline__ void candidate(int k, float tn, bool kept, int,
                                            int ord) {
    const int j = k * THREADS + threadIdx.x;
    float& th = tf(2 * S, j);
    if (!kept) {
      th = nmin(th, tn);
      return;
    }
    // SlotRegs' cascade, rolled: S is known only at run time, and
    // unrolled to MAX_SLOTS it spilled beside the rays
    float ct = tn;
    int co = ord;
#pragma unroll 1
    for (int q = 0; q < S; ++q) {
      const float tq = tf(q, j);
      const int oq = oi(q, j);
      if (lex_lt(ct, co, tq, oq)) {
        tf(q, j) = ct;
        oi(q, j) = co;
        ct = tq;
        co = oq;
      }
    }
    if (co != NONE_ORD) th = nmin(th, ct);
  }
  __device__ __forceinline__ void store(const Out& out, int k, int i,
                                        int n) const {
    const int j = k * THREADS + threadIdx.x;
    for (int q = 0; q < S; ++q) {
      out.st[(size_t)q * n + i] = tf(q, j);
      out.so[(size_t)q * n + i] = oi(q, j);
    }
    out.thr[i] = tf(2 * S, j);
  }
};

struct ScanShared {
  int stack[SCAN_STACK + 2];
  Votes votes;
};

// LPT: the most lanes a thread owns (packet / THREADS, rounded up to the
// instantiation); the lanes' rays live in registers
template <int LPT, class Lanes>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(
    Rays r, int packet, Top top, int arity, int node_pops,
    typename Lanes::Out out, int* __restrict__ capped,
    unsigned long long* __restrict__ stats) {
  __shared__ ScanShared sh;
  int* stack = sh.stack;
  const int n = r.n;
  const int base = blockIdx.x * packet;
  const int lpt = packet / THREADS;
  const int A = arity;
  float ox[LPT], oy[LPT], oz[LPT], ix[LPT], iy[LPT], iz[LPT], bt[LPT];
  Lanes lanes(out, packet, lpt);
  unsigned vb = 0u;
  int nlive = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = base + k * THREADS + threadIdx.x;
    const bool in = k < lpt && i < n;
    const float tm = in ? r.tmax[i] : -1.0f;
    bt[k] = nmin(tm, BIG);
    vb |= (bt[k] > 0.0f ? V_POS : 0u) | (bt[k] != bt[k] ? V_NAN : 0u);
    nlive += tm > 0.0f;
    ox[k] = in ? r.ox[i] : 0.0f;
    oy[k] = in ? r.oy[i] : 0.0f;
    oz[k] = in ? r.oz[i] : 0.0f;
    ix[k] = safe_inv(in ? r.dx[i] : 0.0f);
    iy[k] = safe_inv(in ? r.dy[i] : 0.0f);
    iz[k] = safe_inv(in ? r.dz[i] : 0.0f);
  }
  int par = 0;
  post_count(sh.votes, nlive);
  // jnp.max(bt) > 0: false when any lane's bt is NaN
  const unsigned any0 = vote_or(sh.votes, par, vb);
  const int live = read_count(sh.votes);
  const int oct = packet_octant(r, base);
  int sp = ((any0 & V_POS) && !(any0 & V_NAN)) ? 1 : 0;
  stack[0] = 0;  // every thread writes the same stack entries
  int step = 0;
  bool exact = true;
  unsigned long long pops = 0, slabs = 0;
  const int cap = 8 * top.num + 1024;
  while (sp > 0 && step < cap) {
    for (int p = 0; p < node_pops && sp > 0; ++p) {
      const int code = stack[--sp];
      ++pops;
      const float* row = top.f32 + (size_t)code * top.width;
      const int* crow = top.child + (size_t)code * 16;
      const int* trow = top.tref + (size_t)code * 8;
      const int* orow = top.tord + (size_t)code * 8;
      unsigned bits = 0u;
      // each child box read once for all the thread's lanes; each lane
      // still takes the children in order
      for (int s = 0; s < A; ++s) {
        const float* b = row + 6 * s;
        const float b0 = __ldg(b + 0), b1 = __ldg(b + 1), b2 = __ldg(b + 2),
                    b3 = __ldg(b + 3), b4 = __ldg(b + 4), b5 = __ldg(b + 5);
        const bool internal = __ldg(crow + s) >= 0;
        const int tcode = Lanes::kCodes ? __ldg(trow + s) : 0;
        const int tord = __ldg(orow + s);
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          if (!(bt[k] >= 0.0f)) continue;  // no box can pass: tn >= 0 > limit
          float tn;
          const bool hit = slab_box(b0, b1, b2, b3, b4, b5, ox[k], oy[k],
                                    oz[k], ix[k], iy[k], iz[k], bt[k], tn);
          ++slabs;
          if (!hit) continue;
          const bool kept = tn <= lanes.window(k);
          if (internal) {
            if (kept) bits |= 1u << s;
            else lanes.excluded(k, tn);
            continue;
          }
          if (!(tn < bt[k])) continue;
          lanes.candidate(k, tn, kept, tcode, tord);
        }
      }
      const unsigned any = vote_or(sh.votes, par, bits);
      // push the kept top children far to near in the packet's order
      const unsigned ordw = (unsigned)__ldg(crow + 8 + oct);
      for (int pos = A - 1; pos >= 0; --pos) {
        const int slot = (ordw >> (4 * pos)) & 15;
        if (slot >= A || !((any >> slot) & 1u)) continue;
        const int csel = __ldg(crow + slot);
        if (csel < 0) continue;
        if (sp < SCAN_STACK) stack[sp++] = csel;
        else exact = false;
      }
    }
    ++step;
  }
  if (sp > 0) exact = false;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int i = base + k * THREADS + threadIdx.x;
    if (k >= lpt || i >= n) continue;
    lanes.store(out, k, i, n);
  }
  if (threadIdx.x == 0) {
    if (!exact && live) atomicAdd(capped, live);
    if (stats) atomicAdd(stats + 0, pops);
  }
  if (stats) {
    slabs = warp_sum64(slabs);
    if ((threadIdx.x & 31) == 0 && slabs) atomicAdd(stats + 1, slabs);
  }
}

// ---------------------------------------------------------------------------
// K10: self-rebinning closest hit (pallas_treelet.py:77-405)
// ---------------------------------------------------------------------------

// per-lane planes, [plane][packet lane]: the hot set (ray, inverse
// direction, best hit) and the cold set (thresholds, flags, S slots)
enum HotPlane { H_OX, H_OY, H_OZ, H_DX, H_DY, H_DZ, H_IX, H_IY, H_IZ, H_BT,
                H_BU, H_BV, H_TRI, HOT_PLANES };
enum ColdPlane { C_THR, C_THRC, C_FLAGS, C_SLOT };  // then S t, S codes
#define COLD_PLANES(S) (3 + 2 * (S))
#define F_EXH 1    // the lane's scans are exhausted
#define F_SCAN 2   // the lane scans this round (scan_mask)
#define F_OVF 4    // the lane's scan overflowed this round

// one step's staged tables: the popped clusters' triangle rows (floats
// 0-11 of each row: v0, e1, e2, id, in pop then row order), the popped
// nodes' child boxes and their child rows
struct Stage {
  float tri[STAGE_ROWS * 12];
  float box[NODE_POPS * 6 * MAX_ARITY];
  int child[NODE_POPS * 16];
};

struct ClosestShared {
  Stage stage[2];
  Votes votes;
  int nstack[NSTACK + 2];
  int cstack[CSTACK + 2];
};

struct Packet {
  Rays r;
  Wide w;
  Top top;
  int A, base, lpt, packet, oct;
  float* hot;   // HOT_PLANES x packet, shared or global
  float* cold;  // COLD_PLANES(S) x packet, shared or global
  ClosestShared* sh;
  int par, spar;
  bool exact;
  unsigned long long pops, slabs, tris;

  __device__ __forceinline__ float& hf(int p, int j) const {
    return hot[p * packet + j];
  }
  __device__ __forceinline__ int& hi(int p, int j) const {
    return reinterpret_cast<int*>(hot)[p * packet + j];
  }
  __device__ __forceinline__ float& cf(int p, int j) const {
    return cold[p * packet + j];
  }
  __device__ __forceinline__ int& ci(int p, int j) const {
    return reinterpret_cast<int*>(cold)[p * packet + j];
  }
  __device__ __forceinline__ Ray ray(int j, bool inv) const {
    Ray q;
    q.ox = hf(H_OX, j);
    q.oy = hf(H_OY, j);
    q.oz = hf(H_OZ, j);
    q.dx = hf(H_DX, j);
    q.dy = hf(H_DY, j);
    q.dz = hf(H_DZ, j);
    if (inv) {
      q.ix = hf(H_IX, j);
      q.iy = hf(H_IY, j);
      q.iz = hf(H_IZ, j);
    }
    q.oct = oct;
    return q;
  }
};

// the round's end for lane j: the drain's key of its first slot, and
// whether it needs a scan (pallas_treelet.py:336-362)
template <int S>
__device__ __forceinline__ void lane_vote(const Packet& pk, int j,
                                          unsigned& bits,
                                          unsigned long long& key) {
  const float bt = pk.hf(H_BT, j);
  const int c0 = pk.ci(C_SLOT + S, j);
  if (c0 != NONE_CODE) {
    const float t0 = pk.cf(C_SLOT, j);
    if (t0 < bt) {
      const unsigned long long k = slot_key(t0, c0);
      key = k < key ? k : key;
    }
  } else if (!(pk.ci(C_FLAGS, j) & F_EXH) && pk.cf(C_THR, j) < bt) {
    bits |= V_NEED;
  }
}

// SCAN round: walk the top tree, filling the slots of lanes that need
// candidates (pallas_treelet.py:115-218)
template <int S>
__device__ __forceinline__ void scan_round(Packet& pk, unsigned& vbits,
                           unsigned long long& vkey) {
  ClosestShared& sh = *pk.sh;
  for (int k = 0; k < pk.lpt; ++k) {
    const int j = k * THREADS + threadIdx.x;
    const int fl = pk.ci(C_FLAGS, j) & F_EXH;
    const bool m = pk.ci(C_SLOT + S, j) == NONE_CODE && !fl &&
                   pk.cf(C_THR, j) < pk.hf(H_BT, j);
    pk.ci(C_FLAGS, j) = fl | (m ? F_SCAN : 0);
  }
  sh.nstack[0] = 0;
  const int A = pk.A;
  int sp = 1, step = 0;
  const int cap = 8 * pk.top.num + 1024;
  while (sp > 0 && step < cap) {
    for (int p = 0; p < NODE_POPS && sp > 0; ++p) {
      const int code = sh.nstack[--sp];
      ++pk.pops;
      const float* row = pk.top.f32 + (size_t)code * pk.top.width;
      const int* crow = pk.top.child + (size_t)code * 16;
      const int* trow = pk.top.tref + (size_t)code * 8;
      unsigned bits = 0u;
      for (int k = 0; k < pk.lpt; ++k) {
        const int j = k * THREADS + threadIdx.x;
        int flags = pk.ci(C_FLAGS, j);
        if (!(flags & F_SCAN)) continue;  // limit -1: no box passes
        const float bt = pk.hf(H_BT, j);
        if (!(bt >= 0.0f)) continue;
        const Ray q = pk.ray(j, true);
        float s_t[S];
        int s_c[S];
#pragma unroll
        for (int m = 0; m < S; ++m) {
          s_t[m] = pk.cf(C_SLOT + m, j);
          s_c[m] = pk.ci(C_SLOT + S + m, j);
        }
        const float thr_t = pk.cf(C_THR, j);
        const int thr_c = pk.ci(C_THRC, j);
        bool dirty = false;
        for (int s = 0; s < A; ++s) {
          float tn;
          const bool hit = slab_tn(row + 6 * s, q.ox, q.oy, q.oz, q.ix, q.iy,
                                   q.iz, bt, tn);
          ++pk.slabs;
          if (!hit) continue;
          const bool kept = tn <= s_t[S - 1];
          const bool internal = __ldg(crow + s) >= 0;
          if (internal) {
            if (kept) bits |= 1u << s;
            else flags |= F_OVF;
            continue;
          }
          const int tcode = __ldg(trow + s);
          if (!(tn < bt) ||
              !(tn > thr_t || (tn == thr_t && tcode > thr_c)))
            continue;
          if (!kept) {
            flags |= F_OVF;
            continue;
          }
          // insert (tn, tcode) in lex order: compare-swap cascade
          float ct = tn;
          int cc = tcode;
#pragma unroll
          for (int m = 0; m < S; ++m) {
            if (lex_lt(ct, cc, s_t[m], s_c[m])) {
              const float tt = s_t[m];
              const int tc = s_c[m];
              s_t[m] = ct;
              s_c[m] = cc;
              ct = tt;
              cc = tc;
            }
          }
          if (cc != NONE_CODE) flags |= F_OVF;
          dirty = true;
        }
        if (dirty) {
#pragma unroll
          for (int m = 0; m < S; ++m) {
            pk.cf(C_SLOT + m, j) = s_t[m];
            pk.ci(C_SLOT + S + m, j) = s_c[m];
          }
        }
        pk.ci(C_FLAGS, j) = flags;
      }
      const unsigned any = vote_or(sh.votes, pk.par, bits);
      const unsigned ordw = (unsigned)__ldg(crow + 8 + pk.oct);
      for (int pos = A - 1; pos >= 0; --pos) {
        const int slot = (ordw >> (4 * pos)) & 15;
        if (slot >= A || !((any >> slot) & 1u)) continue;
        const int csel = __ldg(crow + slot);
        if (csel < 0) continue;
        if (sp < NSTACK) sh.nstack[sp++] = csel;
        else pk.exact = false;
      }
    }
    ++step;
  }
  if (sp > 0) pk.exact = false;
  // thresholds advance to the last kept candidate of a full list; a lane
  // whose scan did not overflow is exhausted
  for (int k = 0; k < pk.lpt; ++k) {
    const int j = k * THREADS + threadIdx.x;
    const int flags = pk.ci(C_FLAGS, j);
    if (flags & F_SCAN) {
      const int last = pk.ci(C_SLOT + 2 * S - 1, j);
      if (last != NONE_CODE) {
        pk.cf(C_THR, j) = pk.cf(C_SLOT + S - 1, j);
        pk.ci(C_THRC, j) = last;
      }
      pk.ci(C_FLAGS, j) = (flags & F_OVF) ? 0 : F_EXH;
    }
    lane_vote<S>(pk, j, vbits, vkey);
  }
}

__device__ __forceinline__ int pick4(const int* v, int c) {
  int x = v[0];
  x = c == 1 ? v[1] : x;
  x = c == 2 ? v[2] : x;
  x = c == 3 ? v[3] : x;
  return x;
}

// DRAIN round: walk the treelet `root` once, every lane testing every
// popped cluster, then remove the drained slot (pallas_treelet.py:223-331)
template <int S>
__device__ __forceinline__ void drain_round(Packet& pk, int root, unsigned& vbits,
                            unsigned long long& vkey) {
  ClosestShared& sh = *pk.sh;
  const int A = pk.A;
  const int tid = threadIdx.x;
  int nsp = root >= 0 ? 1 : 0, csp = root < 0 ? 1 : 0;
  if (root >= 0) sh.nstack[0] = root;
  else sh.cstack[0] = -(root + 1);
  const int K = pk.w.max_cluster;
  const int max_steps = 8 * pk.w.num_nodes + 8192;
  const int cmargin = CSTACK - NODE_POPS * A - 1;
  int step = 0;
  while ((nsp > 0 || csp > 0) && step < max_steps) {
    const bool allow = csp < cmargin;
    int ncode[NODE_POPS];
    int nn = 0;
#pragma unroll
    for (int q = 0; q < NODE_POPS; ++q) {
      const bool has = nsp > 0 && allow;
      ncode[q] = has ? sh.nstack[nsp - 1] : -1;
      if (has) {
        --nsp;
        ++nn;
      }
    }
    int cstart[CLUSTER_POPS], ccount[CLUSTER_POPS];
    int total = 0;
#pragma unroll
    for (int q = 0; q < CLUSTER_POPS; ++q) {
      const int v = csp > 0 ? sh.cstack[csp - 1] : 0;
      csp = max(csp - 1, 0);
      ccount[q] = min(v & 255, K);
      cstart[q] = min(max(v >> 8, 0), pk.w.tri_rows - K);
      total += ccount[q];
    }
    const int nch = total > 0 ? (total + STAGE_ROWS - 1) / STAGE_ROWS : 1;
    unsigned bits = 0u;
    for (int ch = 0; ch < nch; ++ch) {
      Stage& sb = sh.stage[pk.spar];
      pk.spar ^= 1;
      const bool last = ch == nch - 1;
      const int r0 = ch * STAGE_ROWS;
      const int rows = min(total - r0, STAGE_ROWS);
      // stage: threads [0, 12 * rows) a triangle float each, then on the
      // last chunk the node boxes and the child rows
      if (tid < 12 * rows) {
        const int rr = tid / 12, q = tid - 12 * rr;
        int off = r0 + rr, src = -1;
#pragma unroll
        for (int c = 0; c < CLUSTER_POPS; ++c) {
          if (src < 0 && off < ccount[c]) src = cstart[c] + off;
          off -= ccount[c];
        }
        sb.tri[tid] = __ldg(pk.w.tri + (size_t)src * 16 + q);
      }
      if (last) {
        const int u = tid - 12 * STAGE_ROWS;
        if (u >= 0 && u < nn * 6 * A) {
          const int c = u / (6 * A);
          sb.box[u] = __ldg(pk.w.node_f32 + (size_t)pick4(ncode, c) *
                                                pk.w.width + (u - c * 6 * A));
        }
        const int u2 = u - NODE_POPS * 6 * MAX_ARITY;
        if (u2 >= 0 && u2 < nn * 16) {
          sb.child[u2] = __ldg(pk.w.child +
                               (size_t)pick4(ncode, u2 >> 4) * 16 + (u2 & 15));
        }
      }
      __syncthreads();
      const float4* trows = reinterpret_cast<const float4*>(sb.tri);
      for (int k = 0; k < pk.lpt; ++k) {
        const int j = k * THREADS + tid;
        float bt = pk.hf(H_BT, j);
        if (!(bt >= 0.0f)) continue;  // neither a triangle nor a box can pass
        const bool boxes = last && nn > 0;
        const Ray q = pk.ray(j, boxes);
        if (bt > 0.0f && rows > 0) {
          int btri = pk.hi(H_TRI, j);
          float bu = pk.hf(H_BU, j), bv = pk.hf(H_BV, j);
          bool dirty = false;
          for (int m = 0; m < rows; ++m) {
            const float4 a = trows[3 * m], b = trows[3 * m + 1],
                         e = trows[3 * m + 2];
            float t, u, v;
            if (mt_tri(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, q, &t, &u,
                       &v) &&
                t < bt) {
              bt = t;
              btri = (int)e.y;
              bu = u;
              bv = v;
              dirty = true;
            }
          }
          pk.tris += rows;
          if (dirty) {
            pk.hf(H_BT, j) = bt;
            pk.hi(H_TRI, j) = btri;
            pk.hf(H_BU, j) = bu;
            pk.hf(H_BV, j) = bv;
          }
        }
        if (boxes) {
          for (int c = 0; c < nn; ++c) {
            for (int s = 0; s < A; ++s) {
              const float* b = sb.box + c * 6 * A + 6 * s;
              float tn;
              if (slab_box(b[0], b[1], b[2], b[3], b[4], b[5], q.ox, q.oy,
                           q.oz, q.ix, q.iy, q.iz, bt, tn))
                bits |= 1u << (c * A + s);
            }
          }
          pk.slabs += nn * A;
        }
      }
    }
    const unsigned any = vote_or(sh.votes, pk.par, bits);
    // push node by node, each far to near in the packet's order
    const Stage& sl = sh.stage[pk.spar ^ 1];
    for (int c = 0; c < nn; ++c) {
      ++pk.pops;
      const int* crow = sl.child + c * 16;
      const unsigned ordw = (unsigned)crow[8 + pk.oct];
      for (int pos = A - 1; pos >= 0; --pos) {
        const int slot = (ordw >> (4 * pos)) & 15;
        if (slot >= A || !((any >> (c * A + slot)) & 1u)) continue;
        const int csel = crow[slot];
        if (csel >= 0) {
          if (nsp < NSTACK) sh.nstack[nsp++] = csel;
          else pk.exact = false;
        } else if (-(csel + 1) > 0) {
          if (csp < CSTACK) sh.cstack[csp++] = -(csel + 1);
          else pk.exact = false;
        }
      }
    }
    ++step;
  }
  if (nsp > 0 || csp > 0) pk.exact = false;
  // consume the drained slot: from the match on, each slot takes its
  // successor's entry
  for (int k = 0; k < pk.lpt; ++k) {
    const int j = k * THREADS + tid;
    bool shifted = false;
#pragma unroll
    for (int m = 0; m < S; ++m) {
      shifted |= pk.ci(C_SLOT + S + m, j) == root;
      if (shifted) {
        pk.cf(C_SLOT + m, j) = m + 1 < S ? pk.cf(C_SLOT + m + 1, j) : BIG;
        pk.ci(C_SLOT + S + m, j) =
            m + 1 < S ? pk.ci(C_SLOT + S + m + 1, j) : NONE_CODE;
      }
    }
    lane_vote<S>(pk, j, vbits, vkey);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) closest_kernel(
    Rays r, int packet, int max_rounds, const float* __restrict__ seed_t,
    const int* __restrict__ seed_c, const int* __restrict__ seed_ovf, Wide w,
    Top top, int arity, int hot_shared, int cold_shared,
    float* __restrict__ scratch, int scratch_planes,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ capped, unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) ClosestShared sh;
  float* dyn = reinterpret_cast<float*>(DYNAMIC_SHARED);
  float* glb = scratch + (size_t)blockIdx.x * packet * scratch_planes;
  Packet pk;
  pk.r = r;
  pk.w = w;
  pk.top = top;
  pk.A = arity;
  pk.base = blockIdx.x * packet;
  pk.lpt = packet / THREADS;
  pk.packet = packet;
  pk.oct = packet_octant(r, pk.base);
  pk.hot = hot_shared ? dyn : glb;
  pk.cold = cold_shared ? dyn + (hot_shared ? HOT_PLANES * packet : 0)
                        : glb + (hot_shared ? 0 : HOT_PLANES * packet);
  pk.sh = &sh;
  pk.par = pk.spar = 0;
  pk.exact = true;
  pk.pops = pk.slabs = pk.tris = 0;
  const bool seeded = seed_t != nullptr;

  // initial state (pallas_treelet.py:364-398); padded lanes have t_max -1
  // and, seeded, no candidate and the exhausted flag
  unsigned vbits = 0u;
  unsigned long long vkey = KEY_NONE;
  int nlive = 0;
  for (int k = 0; k < pk.lpt; ++k) {
    const int j = k * THREADS + threadIdx.x;
    const int i = pk.base + j;
    const bool in = i < r.n;
    const float tm = in ? r.tmax[i] : -1.0f;
    const float bt = nmin(tm, BIG);
    nlive += tm > 0.0f;
    vbits |= (bt > 0.0f ? V_POS : 0u) | (bt != bt ? V_NAN : 0u);
    const float dx = in ? r.dx[i] : 0.0f, dy = in ? r.dy[i] : 0.0f,
                dz = in ? r.dz[i] : 0.0f;
    pk.hf(H_OX, j) = in ? r.ox[i] : 0.0f;
    pk.hf(H_OY, j) = in ? r.oy[i] : 0.0f;
    pk.hf(H_OZ, j) = in ? r.oz[i] : 0.0f;
    pk.hf(H_DX, j) = dx;
    pk.hf(H_DY, j) = dy;
    pk.hf(H_DZ, j) = dz;
    pk.hf(H_IX, j) = safe_inv(dx);
    pk.hf(H_IY, j) = safe_inv(dy);
    pk.hf(H_IZ, j) = safe_inv(dz);
    pk.hf(H_BT, j) = bt;
    pk.hf(H_BU, j) = 0.0f;
    pk.hf(H_BV, j) = 0.0f;
    pk.hi(H_TRI, j) = -1;
    float t0 = BIG, thr_t = -BIG;
    int c0 = NONE_CODE, thr_c = CODE_MIN, exh = 0;
    if (seeded) {
      const float sd_t = in ? seed_t[i] : BIG;
      const int sd_c = in ? seed_c[i] : NONE_CODE;
      exh = in ? 1 - seed_ovf[i] : 1;
      if (sd_c != NONE_CODE && sd_t < bt) {
        t0 = thr_t = sd_t;
        c0 = thr_c = sd_c;
        const unsigned long long key = slot_key(t0, c0);
        vkey = key < vkey ? key : vkey;
      } else if (exh == 0 && bt > 0.0f) {
        vbits |= V_NEED;
      }
    }
    pk.cf(C_THR, j) = thr_t;
    pk.ci(C_THRC, j) = thr_c;
    pk.ci(C_FLAGS, j) = exh ? F_EXH : 0;
    pk.cf(C_SLOT, j) = t0;
    pk.ci(C_SLOT + S, j) = c0;
#pragma unroll
    for (int m = 1; m < S; ++m) {
      pk.cf(C_SLOT + m, j) = BIG;
      pk.ci(C_SLOT + S + m, j) = NONE_CODE;
    }
  }
  post_count(sh.votes, nlive);
  vote(sh.votes, pk.par, vbits, vkey);
  const int live = threadIdx.x == 0 ? read_count(sh.votes) : 0;
  bool done, drain;
  if (seeded) {
    done = vkey == KEY_NONE && !(vbits & V_NEED);
    drain = vkey != KEY_NONE;
  } else {
    // jnp.max(bt) <= 0, NaN-propagating
    done = !(vbits & V_POS) && !(vbits & V_NAN);
    drain = false;
  }

  // round loop (pallas_treelet.py:336-362)
  int round = 0;
  unsigned long long drains = 0, scans = 0;
  while (!done && round < max_rounds) {
    const int root = key_code(vkey);
    vbits = 0u;
    vkey = KEY_NONE;
    if (drain) {
      drain_round<S>(pk, root, vbits, vkey);
      ++drains;
    } else {
      scan_round<S>(pk, vbits, vkey);
      ++scans;
    }
    vote(sh.votes, pk.par, vbits, vkey);
    done = vkey == KEY_NONE && !(vbits & V_NEED);
    drain = vkey != KEY_NONE;
    ++round;
  }
  if (!done) pk.exact = false;

  for (int k = 0; k < pk.lpt; ++k) {
    const int j = k * THREADS + threadIdx.x;
    const int i = pk.base + j;
    if (i >= r.n) continue;
    const int btri = pk.hi(H_TRI, j);
    t_out[i] = btri >= 0 ? pk.hf(H_BT, j) : MISS_T;
    tri_out[i] = btri;
    u_out[i] = pk.hf(H_BU, j);
    v_out[i] = pk.hf(H_BV, j);
  }
  if (threadIdx.x == 0) {
    if (!pk.exact && live) atomicAdd(capped, live);
    if (stats) {
      atomicAdd(stats + 0, pk.pops);
      atomicAdd(stats + 3, drains);
      atomicAdd(stats + 4, scans);
      atomicMax(stats + 5, drains);
    }
  }
  if (stats) {
    const unsigned long long sl = warp_sum64(pk.slabs);
    const unsigned long long tr = warp_sum64(pk.tris);
    if ((threadIdx.x & 31) == 0) {
      if (sl) atomicAdd(stats + 1, sl);
      if (tr) atomicAdd(stats + 2, tr);
    }
  }
}

// where K10's lane planes live for a packet of `packet` lanes and S slots:
// the hot set on chip if it fits beside the static shared memory, the
// cold set if it fits in what is left; the rest in the global scratch
struct Layout {
  int hot_shared, cold_shared, dyn_bytes, scratch_planes;
};

Layout closest_layout(int packet, int S) {
  const long budget = SMEM_LIMIT - (long)sizeof(ClosestShared);
  const long hot = 4L * HOT_PLANES * packet;
  const long cold = 4L * COLD_PLANES(S) * packet;
  Layout L;
  L.hot_shared = hot <= budget;
  L.cold_shared = cold <= budget - (L.hot_shared ? hot : 0);
  L.dyn_bytes = (int)((L.hot_shared ? hot : 0) + (L.cold_shared ? cold : 0));
  L.scratch_planes = (L.hot_shared ? 0 : HOT_PLANES) +
                     (L.cold_shared ? 0 : COLD_PLANES(S));
  return L;
}

template <int S>
int launch_closest(Rays r, int packet, int nt, int max_rounds,
                   const float* seed_t, const int* seed_c,
                   const int* seed_ovf, Wide w, Top top, int arity,
                   float* scratch, float* t, int* tri, float* u, float* v,
                   int* capped, unsigned long long* stats,
                   cudaStream_t stream) {
  const Layout L = closest_layout(packet, S);
  const cudaError_t e = cudaFuncSetAttribute(
      closest_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.dyn_bytes);
  if (e != cudaSuccess) return (int)e;
  closest_kernel<S><<<nt, THREADS, L.dyn_bytes, stream>>>(
      r, packet, max_rounds, seed_t, seed_c, seed_ovf, w, top, arity,
      L.hot_shared, L.cold_shared, scratch, L.scratch_planes, t, tri, u, v,
      capped, stats);
  return (int)cudaGetLastError();
}

// one launch of the top-tree walk with lane policy `Lanes`, with `dyn`
// bytes of dynamic shared memory
template <int LPT, class Lanes>
int launch_walk(Rays r, int packet, int nt, Top top, int arity,
                int node_pops, const typename Lanes::Out& out, int dyn,
                int* capped, unsigned long long* stats,
                cudaStream_t stream) {
  if (dyn > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<LPT, Lanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dyn);
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<LPT, Lanes><<<nt, THREADS, dyn, stream>>>(
      r, packet, top, arity, node_pops, out, capped, stats);
  return (int)cudaGetLastError();
}

// the instantiated lanes a thread for a packet: 1, 2, 4 or 8
int lanes_inst(int packet) {
  const int lpt = packet / THREADS;
  return lpt <= 1 ? 1 : lpt <= 2 ? 2 : lpt <= 4 ? 4 : 8;
}

// Where K11 keeps a lane's 2S + 1 slot words: in registers while a
// thread's LPT lanes hold at most MULTI_REG_WORDS of them (S <= 8 at one
// lane a thread, S <= 4 at two: beside the rays' 7 LPT words that fits
// the 64 registers a thread of a 1024-thread block has), else in
// [2S + 1][packet] planes in dynamic shared memory, else in a global
// scratch per block.
#define MULTI_REG_WORDS 18
enum MultiPlace { IN_REGS = 0, IN_SHARED = 1, IN_SCRATCH = 2 };

int multi_place(int packet, int S) {
  if (lanes_inst(packet) * (2 * S + 1) <= MULTI_REG_WORDS) return IN_REGS;
  const long bytes = 4L * (2 * S + 1) * packet;
  return bytes <= SMEM_LIMIT - (long)sizeof(ScanShared) ? IN_SHARED
                                                        : IN_SCRATCH;
}

template <int LPT, int S>
int launch_multi_regs(Rays r, int packet, int nt, Top top, int arity,
                      int node_pops, const SlotOut& out, int* capped,
                      unsigned long long* stats, cudaStream_t stream) {
  return launch_walk<LPT, SlotRegs<LPT, S>>(r, packet, nt, top, arity,
                                            node_pops, out, 0, capped, stats,
                                            stream);
}

// the register instantiations MULTI_REG_WORDS allows, by (LPT, S)
#define MULTI_REGS_CASES(X)                                        \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(1, 5) X(1, 6) X(1, 7) X(1, 8) \
  X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(4, 1)

int launch_multi(Rays r, int packet, int nt, Top top, int arity,
                 int node_pops, SlotOut out, int* capped,
                 unsigned long long* stats, cudaStream_t stream) {
  const int L = lanes_inst(packet), S = out.S;
  const int place = multi_place(packet, S);
  if (place == IN_REGS) {
#define REGS_CASE(LPT, SS)                                                  \
  if (L == LPT && S == SS)                                                  \
    return launch_multi_regs<LPT, SS>(r, packet, nt, top, arity, node_pops, \
                                      out, capped, stats, stream);
    MULTI_REGS_CASES(REGS_CASE)
#undef REGS_CASE
    return (int)cudaErrorInvalidValue;
  }
  out.shared = place == IN_SHARED;
  const int dyn = out.shared ? 4 * (2 * S + 1) * packet : 0;
#define PLANES_CASE(LPT)                                                   \
  if (L == LPT)                                                            \
    return launch_walk<LPT, SlotPlanes<LPT>>(r, packet, nt, top, arity,    \
                                             node_pops, out, dyn, capped,  \
                                             stats, stream);
  PLANES_CASE(1) PLANES_CASE(2) PLANES_CASE(4) PLANES_CASE(8)
#undef PLANES_CASE
  return (int)cudaErrorInvalidValue;
}

// the attributes of the K11 instantiation a packet and S launch
cudaError_t multi_attributes(int packet, int S, cudaFuncAttributes* a) {
  const int L = lanes_inst(packet);
  if (multi_place(packet, S) == IN_REGS) {
#define REGS_ATTR(LPT, SS)                                             \
  if (L == LPT && S == SS)                                             \
    return cudaFuncGetAttributes(a, scan_kernel<LPT, SlotRegs<LPT, SS>>);
    MULTI_REGS_CASES(REGS_ATTR)
#undef REGS_ATTR
    return cudaErrorInvalidValue;
  }
  return L == 1   ? cudaFuncGetAttributes(a, scan_kernel<1, SlotPlanes<1>>)
         : L == 2 ? cudaFuncGetAttributes(a, scan_kernel<2, SlotPlanes<2>>)
         : L == 4 ? cudaFuncGetAttributes(a, scan_kernel<4, SlotPlanes<4>>)
                  : cudaFuncGetAttributes(a, scan_kernel<8, SlotPlanes<8>>);
}

}  // namespace

extern "C" {

int tpt_treelet_max_slots() { return MAX_SLOTS; }
int tpt_treelet_threads() { return THREADS; }

// All pointers are device pointers; `stream` is a cudaStream_t. The top
// tables are [num_top, top_width] f32 and [num_top, 16], [num_top, 8],
// [num_top, 8] int32. `stats`, if not null, accumulates (top node pops
// summed over packets, slab tests). The packet (lanes per block) is a
// multiple of THREADS, at most 8 * THREADS. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a packet
// or arity the kernel does not take.
int tpt_treelet_scan(const float* ox, const float* oy, const float* oz,
                     const float* dx, const float* dy, const float* dz,
                     const float* tmax, int n, int packet,
                     const float* top_f32, int top_width, const int* top_child,
                     const int* top_tref, const int* top_tord, int num_top,
                     int arity, float* st, int* sc, int* so, int* ovf,
                     int* cnt, int* capped, unsigned long long* stats,
                     void* stream) {
  if (packet <= 0 || packet % THREADS || packet > 8 * THREADS || arity < 2 ||
      arity > MAX_ARITY)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Rays r{ox, oy, oz, dx, dy, dz, tmax, n};
  Top top{top_f32, top_width, top_child, top_tref, top_tord, num_top};
  const int nt = (n + packet - 1) / packet;
  cudaStream_t s = (cudaStream_t)stream;
  const NearestOut out{st, sc, so, ovf, cnt};
#define SCAN_CASE(LPT)                                                  \
  if (lanes_inst(packet) == LPT)                                        \
    return launch_walk<LPT, Nearest<LPT>>(r, packet, nt, top, arity,    \
                                          NODE_POPS, out, 0, capped,    \
                                          stats, s);
  SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(4) SCAN_CASE(8)
#undef SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

// f32 planes a lane of K10's global scratch needs for a packet of
// `packet` lanes and `slots` slots (the planes that do not fit in shared
// memory), or -1 for a packet or slot count the kernel does not take.
int tpt_treelet_closest_scratch(int packet, int slots) {
  if (packet <= 0 || packet % THREADS || slots < 1 || slots > MAX_SLOTS)
    return -1;
  return closest_layout(packet, slots).scratch_planes;
}

// Seeded when seed_t is not null: (seed_t f32, seed_c int32, seed_ovf
// int32) [n] from K9, in pool order. `scratch` is f32 [planes, np] with
// planes = tpt_treelet_closest_scratch(packet, slots) and np =
// ceil(n / packet) * packet (unused when planes is 0). `stats`, if not
// null, is uint64 [6]: node pops (top and treelet, summed over packets),
// slab tests, triangle tests, drain rounds, scan rounds, and the most
// drain rounds of one packet.
int tpt_treelet_closest_hit(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, int n, int packet,
    int slots, int max_rounds, const float* seed_t, const int* seed_c,
    const int* seed_ovf, const float* node_f32, int node_width,
    const int* node_child, int num_nodes, const float* tri_f32, int tri_rows,
    int max_cluster, const float* top_f32, int top_width,
    const int* top_child, const int* top_tref, int num_top, int arity,
    float* scratch, float* t, int* tri, float* u, float* v, int* capped,
    unsigned long long* stats, void* stream) {
  if (packet <= 0 || packet % THREADS || arity < 2 || arity > MAX_ARITY ||
      max_cluster < 1 || max_cluster > 255)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Rays r{ox, oy, oz, dx, dy, dz, tmax, n};
  Wide w{node_f32, node_width, node_child, num_nodes, tri_f32, tri_rows,
         max_cluster};
  Top top{top_f32, top_width, top_child, top_tref, nullptr, num_top};
  const int nt = (n + packet - 1) / packet;
  cudaStream_t s = (cudaStream_t)stream;
#define CLOSEST_CASE(K)                                                     \
  case K:                                                                   \
    return launch_closest<K>(r, packet, nt, max_rounds, seed_t, seed_c,     \
                             seed_ovf, w, top, arity, scratch, t, tri, u, v, \
                             capped, stats, s);
  switch (slots) {
    CLOSEST_CASE(1) CLOSEST_CASE(2) CLOSEST_CASE(3) CLOSEST_CASE(4)
    CLOSEST_CASE(5) CLOSEST_CASE(6) CLOSEST_CASE(7) CLOSEST_CASE(8)
  }
#undef CLOSEST_CASE
  return (int)cudaErrorInvalidValue;
}

// Where K11 keeps its lane state for a packet of `packet` lanes and
// `slots` slots: 0 in registers, 1 in dynamic shared memory, 2 in a
// global scratch of f32 [ceil(n / packet), 2 * slots + 1, packet] the
// caller allocates; -1 for a packet or slot count the kernel does not
// take.
int tpt_treelet_scan_multi_place(int packet, int slots) {
  if (packet <= 0 || packet % THREADS || packet > 8 * THREADS || slots < 1 ||
      slots > MAX_SLOTS)
    return -1;
  return multi_place(packet, slots);
}

// K11. `st`, `so` are f32/int32 [S, n], `thr` f32 [n]; `scratch` as
// tpt_treelet_scan_multi_place says (unused unless it says 2); the other
// arguments as for tpt_treelet_scan, with `node_pops` pops a step (the
// step cap counts steps). Returns cudaErrorInvalidValue also for S
// outside 1..MAX_SLOTS.
int tpt_treelet_scan_multi(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmax, int n, int packet, int slots,
                           int node_pops, const float* top_f32, int top_width,
                           const int* top_child, const int* top_tord,
                           int num_top, int arity, float* scratch, float* st,
                           int* so, float* thr, int* capped,
                           unsigned long long* stats, void* stream) {
  if (tpt_treelet_scan_multi_place(packet, slots) < 0 || arity < 2 ||
      arity > MAX_ARITY || node_pops < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Rays r{ox, oy, oz, dx, dy, dz, tmax, n};
  Top top{top_f32, top_width, top_child, nullptr, top_tord, num_top};
  const int nt = (n + packet - 1) / packet;
  const SlotOut out{st, so, thr, slots, scratch, 0};
  return launch_multi(r, packet, nt, top, arity, node_pops, out, capped,
                      stats, (cudaStream_t)stream);
}

// Registers a thread, local (spill) bytes a thread, static shared bytes,
// dynamic shared bytes at `group` * 1024 lanes a packet and the most
// threads a block of kernel 9 (K9), 10 (K10) or 11 (K11) for `slots`
// slots, as compiled (out: int[5]). Returns a cudaError_t.
int tpt_treelet_attributes(int kernel, int group, int slots, int* out) {
  if (group < 1 || group > 8 || slots < 1 || slots > MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  int dyn = 0;
  const int packet = 1024 * group;
  if (kernel == 9) {
    e = group <= 1   ? cudaFuncGetAttributes(&a, scan_kernel<1, Nearest<1>>)
        : group <= 2 ? cudaFuncGetAttributes(&a, scan_kernel<2, Nearest<2>>)
        : group <= 4 ? cudaFuncGetAttributes(&a, scan_kernel<4, Nearest<4>>)
                     : cudaFuncGetAttributes(&a, scan_kernel<8, Nearest<8>>);
  } else if (kernel == 10) {
    dyn = closest_layout(packet, slots).dyn_bytes;
#define ATTR_CASE(K)                                        \
  case K:                                                   \
    e = cudaFuncGetAttributes(&a, closest_kernel<K>); \
    break;
    switch (slots) {
      ATTR_CASE(1) ATTR_CASE(2) ATTR_CASE(3) ATTR_CASE(4)
      ATTR_CASE(5) ATTR_CASE(6) ATTR_CASE(7) ATTR_CASE(8)
    }
#undef ATTR_CASE
  } else if (kernel == 11) {
    dyn = multi_place(packet, slots) == IN_SHARED
              ? 4 * (2 * slots + 1) * packet : 0;
    e = multi_attributes(packet, slots, &a);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = dyn;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
