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
// K11 is K9's walk that keeps S candidate slots and thr per lane, as K3
// does over every treelet box; its slots equal K3's, and its thr, which
// also counts pruned subtrees, lies at or below K3's. It keeps the
// earlier layout: blocks of MULTI_THREADS threads, the lanes' state in its
// output planes.
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

#define THREADS 1024          // K9/K10: threads a packet (one block)
#define WARPS (THREADS / 32)
#define MULTI_THREADS 256     // K11: threads a packet
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

// block-wide OR of each thread's bits into *dst (zero beforehand; K11)
__device__ __forceinline__ void or_bits(unsigned* dst, unsigned bits) {
  bits = __reduce_or_sync(FULL_MASK, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(dst, bits);
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
// K9: nearest treelet candidate per lane (pallas_treelet.py:408-519)
// ---------------------------------------------------------------------------

// LPT: the most lanes a thread owns (packet / THREADS, rounded up to the
// instantiation); the lanes' state lives in registers
template <int LPT>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(
    Rays r, int packet, Top top, int arity, float* __restrict__ st,
    int* __restrict__ sc, int* __restrict__ so, int* __restrict__ ovf,
    int* __restrict__ cnt, int* __restrict__ capped,
    unsigned long long* __restrict__ stats) {
  __shared__ int stack[SCAN_STACK + 2];
  __shared__ Votes votes;
  const int n = r.n;
  const int base = blockIdx.x * packet;
  const int lpt = packet / THREADS;
  const int A = arity;
  float ox[LPT], oy[LPT], oz[LPT], ix[LPT], iy[LPT], iz[LPT], bt[LPT],
      s_t[LPT];
  int s_c[LPT], s_o[LPT], f[LPT], c[LPT];
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
    s_t[k] = BIG;
    s_c[k] = NONE_CODE;
    s_o[k] = 0;
    f[k] = 0;
    c[k] = 0;
  }
  int par = 0;
  post_count(votes, nlive);
  // jnp.max(bt) > 0: false when any lane's bt is NaN
  const unsigned any0 = vote_or(votes, par, vb);
  const int live = read_count(votes);
  const int oct = packet_octant(r, base);
  int sp = ((any0 & V_POS) && !(any0 & V_NAN)) ? 1 : 0;
  stack[0] = 0;  // every thread writes the same stack entries
  int step = 0;
  bool exact = true;
  unsigned long long pops = 0, slabs = 0;
  const int cap = 8 * top.num + 1024;
  while (sp > 0 && step < cap) {
    for (int p = 0; p < NODE_POPS && sp > 0; ++p) {
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
        const int tcode = __ldg(trow + s), tord = __ldg(orow + s);
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          if (!(bt[k] >= 0.0f)) continue;  // no box can pass: tn >= 0 > limit
          float tn;
          const bool hit = slab_box(b0, b1, b2, b3, b4, b5, ox[k], oy[k],
                                    oz[k], ix[k], iy[k], iz[k], bt[k], tn);
          ++slabs;
          if (!hit) continue;
          const bool kept = tn <= s_t[k];
          if (internal) {
            if (kept) bits |= 1u << s;
            else f[k] = 1;
            continue;
          }
          if (!(tn < bt[k])) continue;
          ++c[k];
          if (!kept) {
            f[k] = 1;
            continue;
          }
          if (lex_lt(tn, tcode, s_t[k], s_c[k])) {
            if (s_c[k] != NONE_CODE) f[k] = 1;
            s_t[k] = tn;
            s_c[k] = tcode;
            s_o[k] = tord;
          } else {
            f[k] = 1;
          }
        }
      }
      const unsigned any = vote_or(votes, par, bits);
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
    st[i] = s_t[k];
    sc[i] = s_c[k];
    so[i] = s_o[k];
    ovf[i] = f[k];
    cnt[i] = c[k];
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

template <int LPT>
int launch_scan(Rays r, int packet, int nt, Top top, int arity, float* st,
                int* sc, int* so, int* ovf, int* cnt, int* capped,
                unsigned long long* stats, cudaStream_t stream) {
  scan_kernel<LPT><<<nt, THREADS, 0, stream>>>(r, packet, top, arity, st, sc,
                                               so, ovf, cnt, capped, stats);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11: the S nearest treelet candidates per lane and thr
// (pallas_treelet.py:647-766)
// ---------------------------------------------------------------------------

// K9's walk with K3's output: each lane keeps S (entry t, ordinal) slots
// in ascending lexicographic order, and thr, a lower bound on the entry t
// of every candidate the slots do not hold: it is lowered by each
// candidate or kept internal child the window (t <= the S-th slot's t)
// excludes, and by each entry an insert displaces. The lane's state lives
// in the output planes st/so [S, n] and thr [n], read and written per
// popped node.
template <int S>
__global__ void __launch_bounds__(MULTI_THREADS) scan_multi_kernel(
    Rays r, int packet, Top top, int arity, int node_pops,
    float* __restrict__ inv, float* __restrict__ st, int* __restrict__ so,
    float* __restrict__ thr, int* __restrict__ capped,
    unsigned long long* __restrict__ stats) {
  __shared__ int stack[SCAN_STACK + 2];
  __shared__ unsigned any_buf[2];
  __shared__ int s_live;
  const int n = r.n;
  const int base = blockIdx.x * packet;
  const int lpt = packet / MULTI_THREADS;
  const int A = arity;
  bool any_pos = false, any_nan = false;
  int nlive = 0;
  for (int k = 0; k < lpt; ++k) {
    const int i = base + k * MULTI_THREADS + threadIdx.x;
    if (i >= n) continue;
    const float bt = nmin(r.tmax[i], BIG);
    any_pos |= bt > 0.0f;
    any_nan |= bt != bt;
    nlive += r.tmax[i] > 0.0f;
    inv[i] = safe_inv(r.dx[i]);
    inv[(size_t)n + i] = safe_inv(r.dy[i]);
    inv[2 * (size_t)n + i] = safe_inv(r.dz[i]);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      st[(size_t)q * n + i] = BIG;
      so[(size_t)q * n + i] = NONE_ORD;
    }
    thr[i] = BIG;
  }
  if (threadIdx.x == 0) {
    stack[0] = 0;
    any_buf[0] = any_buf[1] = 0u;
    s_live = 0;
  }
  __syncthreads();
  if (nlive) atomicAdd(&s_live, nlive);
  // jnp.max(bt) > 0: false when any lane's bt is NaN
  const bool b_pos = __syncthreads_or(any_pos);
  const bool b_nan = __syncthreads_or(any_nan);
  const int oct = packet_octant(r, base);
  int sp = (b_pos && !b_nan) ? 1 : 0;
  int step = 0, par = 0;
  bool exact = true;
  unsigned long long pops = 0, slabs = 0;
  const int cap = 8 * top.num + 1024;
  while (sp > 0 && step < cap) {
    for (int p = 0; p < node_pops; ++p) {
      __syncthreads();  // the pushes and the buffer reset are visible
      if (threadIdx.x == 0) any_buf[par ^ 1] = 0u;
      const int code = sp > 0 ? stack[sp - 1] : -1;
      if (sp > 0) --sp;
      unsigned bits = 0;
      const float* row = top.f32 + (size_t)max(code, 0) * top.width;
      const int* crow = top.child + (size_t)max(code, 0) * 16;
      if (code >= 0) {
        ++pops;
        const int* orow = top.tord + (size_t)code * 8;
        for (int k = 0; k < lpt; ++k) {
          const int i = base + k * MULTI_THREADS + threadIdx.x;
          if (i >= n) continue;
          const float bt = nmin(r.tmax[i], BIG);
          if (!(bt >= 0.0f)) continue;  // no box can pass: tn >= 0 > limit
          const float ox = r.ox[i], oy = r.oy[i], oz = r.oz[i];
          const float ix = inv[i], iy = inv[(size_t)n + i],
                      iz = inv[2 * (size_t)n + i];
          float s_t[S];
          int s_o[S];
#pragma unroll
          for (int q = 0; q < S; ++q) {
            s_t[q] = st[(size_t)q * n + i];
            s_o[q] = so[(size_t)q * n + i];
          }
          float th = thr[i];
          bool dirty = false;
          for (int s = 0; s < A; ++s) {
            float tn;
            const bool hit =
                slab_tn(row + 6 * s, ox, oy, oz, ix, iy, iz, bt, tn);
            ++slabs;
            if (!hit) continue;
            const bool kept = tn <= s_t[S - 1];
            if (__ldg(crow + s) >= 0) {  // an internal top child
              if (kept) {
                bits |= 1u << s;
              } else {
                th = nmin(th, tn);
                dirty = true;
              }
              continue;
            }
            if (!(tn < bt)) continue;
            dirty = true;
            if (!kept) {  // outside the slot window
              th = nmin(th, tn);
              continue;
            }
            // insert (tn, ordinal) in lex order; the displaced entry falls
            // to thr
            float ct = tn;
            int co = __ldg(orow + s);
#pragma unroll
            for (int q = 0; q < S; ++q) {
              const bool swap = lex_lt(ct, co, s_t[q], s_o[q]);
              const float tt = swap ? s_t[q] : ct;
              const int oo = swap ? s_o[q] : co;
              s_t[q] = swap ? ct : s_t[q];
              s_o[q] = swap ? co : s_o[q];
              ct = tt;
              co = oo;
            }
            if (co != NONE_ORD) th = nmin(th, ct);
          }
          if (dirty) {
#pragma unroll
            for (int q = 0; q < S; ++q) {
              st[(size_t)q * n + i] = s_t[q];
              so[(size_t)q * n + i] = s_o[q];
            }
            thr[i] = th;
          }
        }
      }
      or_bits(&any_buf[par], bits);
      __syncthreads();
      const unsigned any = any_buf[par];
      par ^= 1;
      if (code >= 0) {
        // push the kept top children far to near in the packet's order
        const unsigned ordw = (unsigned)__ldg(crow + 8 + oct);
        for (int pos = A - 1; pos >= 0; --pos) {
          const int slot = (ordw >> (4 * pos)) & 15;
          if (slot >= A || !((any >> slot) & 1u)) continue;
          const int csel = __ldg(crow + slot);
          if (csel < 0) continue;
          if (sp < SCAN_STACK) {
            if (threadIdx.x == 0) stack[sp] = csel;
            ++sp;
          } else {
            exact = false;
          }
        }
      }
    }
    ++step;
  }
  if (sp > 0) exact = false;
  if (threadIdx.x == 0) {
    if (!exact && s_live) atomicAdd(capped, s_live);
    if (stats) atomicAdd(stats + 0, pops);
  }
  if (stats && slabs) atomicAdd(stats + 1, slabs);
}

template <int S>
int launch_scan_multi(Rays r, int packet, int nt, Top top, int arity,
                      int node_pops, float* inv, float* st, int* so,
                      float* thr, int* capped, unsigned long long* stats,
                      cudaStream_t stream) {
  scan_multi_kernel<S><<<nt, MULTI_THREADS, 0, stream>>>(
      r, packet, top, arity, node_pops, inv, st, so, thr, capped, stats);
  return (int)cudaGetLastError();
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
  const int lpt = packet / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (lpt <= 1)
    return launch_scan<1>(r, packet, nt, top, arity, st, sc, so, ovf, cnt,
                          capped, stats, s);
  if (lpt <= 2)
    return launch_scan<2>(r, packet, nt, top, arity, st, sc, so, ovf, cnt,
                          capped, stats, s);
  if (lpt <= 4)
    return launch_scan<4>(r, packet, nt, top, arity, st, sc, so, ovf, cnt,
                          capped, stats, s);
  return launch_scan<8>(r, packet, nt, top, arity, st, sc, so, ovf, cnt,
                        capped, stats, s);
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

// K11. `inv` is a [3, n] f32 scratch; `st`, `so` are f32/int32 [S, n],
// `thr` f32 [n]; the other arguments as for tpt_treelet_scan, with
// `node_pops` pops a step (the step cap counts steps) and the packet a
// multiple of MULTI_THREADS. Returns cudaErrorInvalidValue also for S
// outside 1..MAX_SLOTS.
int tpt_treelet_scan_multi(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmax, int n, int packet, int slots,
                           int node_pops, const float* top_f32, int top_width,
                           const int* top_child, const int* top_tord,
                           int num_top, int arity, float* inv, float* st,
                           int* so, float* thr, int* capped,
                           unsigned long long* stats, void* stream) {
  if (packet <= 0 || packet % MULTI_THREADS || arity < 2 ||
      arity > MAX_ARITY || node_pops < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Rays r{ox, oy, oz, dx, dy, dz, tmax, n};
  Top top{top_f32, top_width, top_child, nullptr, top_tord, num_top};
  const int nt = (n + packet - 1) / packet;
  cudaStream_t s = (cudaStream_t)stream;
#define MULTI_CASE(K)                                                      \
  case K:                                                                  \
    return launch_scan_multi<K>(r, packet, nt, top, arity, node_pops, inv, \
                                st, so, thr, capped, stats, s);
  switch (slots) {
    MULTI_CASE(1) MULTI_CASE(2) MULTI_CASE(3) MULTI_CASE(4)
    MULTI_CASE(5) MULTI_CASE(6) MULTI_CASE(7) MULTI_CASE(8)
  }
#undef MULTI_CASE
  return (int)cudaErrorInvalidValue;
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
    e = group <= 1   ? cudaFuncGetAttributes(&a, scan_kernel<1>)
        : group <= 2 ? cudaFuncGetAttributes(&a, scan_kernel<2>)
        : group <= 4 ? cudaFuncGetAttributes(&a, scan_kernel<4>)
                     : cudaFuncGetAttributes(&a, scan_kernel<8>);
  } else if (kernel == 10 || kernel == 11) {
    dyn = kernel == 10 ? closest_layout(packet, slots).dyn_bytes : 0;
#define ATTR_CASE(K)                                             \
  case K:                                                        \
    e = kernel == 10 ? cudaFuncGetAttributes(&a, closest_kernel<K>) \
                     : cudaFuncGetAttributes(&a, scan_multi_kernel<K>); \
    break;
    switch (slots) {
      ATTR_CASE(1) ATTR_CASE(2) ATTR_CASE(3) ATTR_CASE(4)
      ATTR_CASE(5) ATTR_CASE(6) ATTR_CASE(7) ATTR_CASE(8)
    }
#undef ATTR_CASE
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
