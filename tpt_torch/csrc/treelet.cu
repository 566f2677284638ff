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
// Design. The three TPU kernels walk one stack per super-packet of consecutive
// lanes (2048 on bounces, 4096 for camera rays), and what they return
// depends on the packet: a node is pushed when ANY lane of the packet hits
// it and keeps it, every lane then tests every child of every popped node
// (K9's overflow flag and candidate count, which decides the hybrid
// easy/hard split, count those, and K11's thr is lowered by every one
// its slot window excludes), and the packet's child order comes from
// the octant of its first ray. K10's packet also decides, round by round,
// which treelet the whole packet drains next, so which triangle a lane
// finds among equal t depends on its packet too. To give tpt's results
// tie for tie, the kernels keep tpt's packets: one block of THREADS
// threads per packet, each thread owning packet / THREADS lanes (lanes
// base + k * THREADS + threadIdx.x), the stacks in shared memory, the
// "any lane" tests block-wide ORs of per-child bit masks (a warp
// reduction, then one shared atomic per warp), the packet's minimum entry
// t and treelet code block-wide minima. Padded lanes past n behave as
// tpt's padding (t_max = -1; for K10's seed: no candidate, exhausted).
// Every control decision is computed by every thread from the same
// shared values, so the control flow is uniform and __syncthreads is
// safe; only thread 0 writes the stacks.
//
// K11 is K9's walk that keeps S candidate slots and thr per lane, as K3
// does over every treelet box; its slots equal K3's, and its thr, which
// also counts pruned subtrees, lies at or below K3's.
//
// K10 runs tpt's round machine per packet: SCAN rounds walk the top tree
// and fill each lane's S candidate slots past its (thr_t, thr_c)
// threshold (overflow re-enters a later scan), DRAIN rounds walk the
// subtree of the packet-nearest requested treelet once with the node and
// cluster stacks (4 node pops and 4 cluster pops a step, the cluster-stack
// throttle, NSTACK 192 and CSTACK 1024) and every lane tests every popped
// cluster with a strict t < best, then the drained slot is removed. A
// lane's state (slots, thresholds, best hit) lives in a global scratch
// the wrapper allocates, plane by plane ([field][lane], so a warp's
// accesses are contiguous): S up to 8 slots for up to 16 lanes a thread
// would not fit in registers, and the work per access (a drain step tests
// up to 64 triangles a lane) dwarfs it.
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
// are then not exact. What bounds the kernels on this card: operations.
// A lane moves a few hundred bytes; a drain tests up to 4 clusters of
// triangles against every lane of the packet, and a scan slab-tests every
// child of every top node the packet visits against every lane, so the
// work grows with the packet's union of treelets, not the lane's own. The
// tables sit in the 50 MB L2. This is a simple kernel that is right;
// making it fast (splitting packets into warps, keeping state in
// registers) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define THREADS 256
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
__device__ __forceinline__ bool slab_tn(const float* __restrict__ b, float ox,
                                        float oy, float oz, float ix,
                                        float iy, float iz, float limit,
                                        float& tn) {
  float t0x = (__ldg(b + 0) - ox) * ix;
  float t0y = (__ldg(b + 1) - oy) * iy;
  float t0z = (__ldg(b + 2) - oz) * iz;
  float t1x = (__ldg(b + 3) - ox) * ix;
  float t1y = (__ldg(b + 4) - oy) * iy;
  float t1z = (__ldg(b + 5) - oz) * iz;
  tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
            nmax(nmin(t0z, t1z), 0.0f));
  float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                  nmin(nmax(t0z, t1z), limit));
  return tn <= tf;
}

// block-wide OR of each thread's bits into *dst (zero beforehand)
__device__ __forceinline__ void or_bits(unsigned* dst, unsigned bits) {
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(dst, bits);
}

// float -> int preserving order (for atomicMin on floats)
__device__ __forceinline__ int ordered(float f) {
  int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

// the packet's octant, from its first lane (pallas_traverse.py:465)
__device__ __forceinline__ int packet_octant(const Rays& r, int base) {
  return (r.dx[base] >= 0.0f ? 4 : 0) + (r.dy[base] >= 0.0f ? 2 : 0) +
         (r.dz[base] >= 0.0f ? 1 : 0);
}

// ---------------------------------------------------------------------------
// K9: nearest treelet candidate per lane (pallas_treelet.py:408-519)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) scan_kernel(
    Rays r, int packet, Top top, int arity, float* __restrict__ inv,
    float* __restrict__ st, int* __restrict__ sc, int* __restrict__ so,
    int* __restrict__ ovf, int* __restrict__ cnt, int* __restrict__ capped,
    unsigned long long* __restrict__ stats) {
  __shared__ int stack[SCAN_STACK + 2];
  __shared__ unsigned any_buf[2];
  __shared__ int s_live;
  const int n = r.n;
  const int base = blockIdx.x * packet;
  const int lpt = packet / THREADS;
  const int A = arity;
  bool any_pos = false, any_nan = false;
  int nlive = 0;
  for (int k = 0; k < lpt; ++k) {
    const int i = base + k * THREADS + threadIdx.x;
    if (i >= n) continue;
    const float bt = nmin(r.tmax[i], BIG);
    any_pos |= bt > 0.0f;
    any_nan |= bt != bt;
    nlive += r.tmax[i] > 0.0f;
    inv[i] = safe_inv(r.dx[i]);
    inv[(size_t)n + i] = safe_inv(r.dy[i]);
    inv[2 * (size_t)n + i] = safe_inv(r.dz[i]);
    st[i] = BIG;
    sc[i] = NONE_CODE;
    so[i] = 0;
    ovf[i] = 0;
    cnt[i] = 0;
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
    for (int p = 0; p < NODE_POPS; ++p) {
      __syncthreads();  // the pushes and the buffer reset are visible
      if (threadIdx.x == 0) any_buf[par ^ 1] = 0u;
      const int code = sp > 0 ? stack[sp - 1] : -1;
      if (sp > 0) --sp;
      unsigned bits = 0;
      const float* row = top.f32 + (size_t)max(code, 0) * top.width;
      const int* crow = top.child + (size_t)max(code, 0) * 16;
      if (code >= 0) {
        ++pops;
        const int* trow = top.tref + (size_t)code * 8;
        const int* orow = top.tord + (size_t)code * 8;
        for (int k = 0; k < lpt; ++k) {
          const int i = base + k * THREADS + threadIdx.x;
          if (i >= n) continue;
          const float bt = nmin(r.tmax[i], BIG);
          if (!(bt >= 0.0f)) continue;  // no box can pass: tn >= 0 > limit
          const float ox = r.ox[i], oy = r.oy[i], oz = r.oz[i];
          const float ix = inv[i], iy = inv[(size_t)n + i],
                      iz = inv[2 * (size_t)n + i];
          float s_t = st[i];
          int s_c = sc[i], s_o = so[i], f = ovf[i], c = cnt[i];
          bool dirty = false;
          for (int s = 0; s < A; ++s) {
            float tn;
            const bool hit =
                slab_tn(row + 6 * s, ox, oy, oz, ix, iy, iz, bt, tn);
            ++slabs;
            if (!hit) continue;
            const bool kept = tn <= s_t;
            const bool internal = __ldg(crow + s) >= 0;
            if (internal) {
              if (kept) bits |= 1u << s;
              else if (!f) { f = 1; dirty = true; }
              continue;
            }
            if (!(tn < bt)) continue;
            ++c;
            dirty = true;
            if (!kept) { f = 1; continue; }
            const int tcode = __ldg(trow + s);
            if (lex_lt(tn, tcode, s_t, s_c)) {
              if (s_c != NONE_CODE) f = 1;
              s_t = tn;
              s_c = tcode;
              s_o = __ldg(orow + s);
            } else {
              f = 1;
            }
          }
          if (dirty) {
            st[i] = s_t;
            sc[i] = s_c;
            so[i] = s_o;
            ovf[i] = f;
            cnt[i] = c;
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

// ---------------------------------------------------------------------------
// K10: self-rebinning closest hit (pallas_treelet.py:77-405)
// ---------------------------------------------------------------------------

// per-lane state planes of the scratch, [plane][lane]
enum FPlane { F_IX, F_IY, F_IZ, F_BT, F_BU, F_BV, F_THR, F_SLOT };
enum IPlane { I_TRI, I_THR, I_EXH, I_FLAGS, I_SLOT };
#define FLAG_SCAN 1   // the lane scans this round (scan_mask)
#define FLAG_OVF 2    // the lane's scan overflowed this round

struct Packet {
  Rays r;
  Wide w;
  Top top;
  int A, base, lpt, np, oct;
  float* fs;
  int* is;
  int* nstack;
  int* cstack;
  unsigned* any_buf;
  int par;
  bool exact;
  unsigned long long pops, slabs, tris;

  __device__ __forceinline__ int lane(int k) const {
    return base + k * THREADS + threadIdx.x;
  }
  __device__ __forceinline__ float& f(int p, int i) const {
    return fs[(size_t)p * np + i];
  }
  __device__ __forceinline__ int& g(int p, int i) const {
    return is[(size_t)p * np + i];
  }
  __device__ __forceinline__ Ray ray(int i) const {
    Ray q;
    const bool in = i < r.n;
    q.ox = in ? r.ox[i] : 0.0f;
    q.oy = in ? r.oy[i] : 0.0f;
    q.oz = in ? r.oz[i] : 0.0f;
    q.dx = in ? r.dx[i] : 0.0f;
    q.dy = in ? r.dy[i] : 0.0f;
    q.dz = in ? r.dz[i] : 0.0f;
    q.ix = f(F_IX, i);
    q.iy = f(F_IY, i);
    q.iz = f(F_IZ, i);
    q.oct = oct;
    return q;
  }
  // block-wide OR of bits (one barrier before the caller reads the result)
  __device__ __forceinline__ unsigned block_or(unsigned bits) {
    or_bits(&any_buf[par], bits);
    __syncthreads();
    const unsigned any = any_buf[par];
    par ^= 1;
    return any;
  }
  // at the start of a step, after a barrier: zero the buffer the next
  // block_or uses (its last readers passed that barrier)
  __device__ __forceinline__ void reset_next() {
    if (threadIdx.x == 0) any_buf[par ^ 1] = 0u;
  }
};

// SCAN round: walk the top tree, filling the slots of lanes that need
// candidates (pallas_treelet.py:115-218)
template <int S>
__device__ void scan_round(Packet& pk) {
  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    const bool m = pk.g(I_SLOT, i) == NONE_CODE && pk.g(I_EXH, i) == 0 &&
                   pk.f(F_THR, i) < pk.f(F_BT, i);
    pk.g(I_FLAGS, i) = m ? FLAG_SCAN : 0;
  }
  __syncthreads();  // the previous round's stack readers are done
  if (threadIdx.x == 0) pk.nstack[0] = 0;
  const int A = pk.A;
  int sp = 1, step = 0;
  const int cap = 8 * pk.top.num + 1024;
  while (sp > 0 && step < cap) {
    for (int p = 0; p < NODE_POPS; ++p) {
      __syncthreads();
      pk.reset_next();
      const int code = sp > 0 ? pk.nstack[sp - 1] : -1;
      if (sp > 0) --sp;
      unsigned bits = 0;
      const float* row = pk.top.f32 + (size_t)max(code, 0) * pk.top.width;
      const int* crow = pk.top.child + (size_t)max(code, 0) * 16;
      if (code >= 0) {
        ++pk.pops;
        const int* trow = pk.top.tref + (size_t)code * 8;
        for (int k = 0; k < pk.lpt; ++k) {
          const int i = pk.lane(k);
          int flags = pk.g(I_FLAGS, i);
          if (!(flags & FLAG_SCAN)) continue;  // limit -1: no box passes
          const float bt = pk.f(F_BT, i);
          if (!(bt >= 0.0f)) continue;
          const Ray q = pk.ray(i);
          float s_t[S];
          int s_c[S];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            s_t[j] = pk.f(F_SLOT + j, i);
            s_c[j] = pk.g(I_SLOT + j, i);
          }
          const float thr_t = pk.f(F_THR, i);
          const int thr_c = pk.g(I_THR, i);
          bool dirty = false;
          for (int s = 0; s < A; ++s) {
            float tn;
            const bool hit = slab_tn(row + 6 * s, q.ox, q.oy, q.oz, q.ix,
                                     q.iy, q.iz, bt, tn);
            ++pk.slabs;
            if (!hit) continue;
            const bool kept = tn <= s_t[S - 1];
            const bool internal = __ldg(crow + s) >= 0;
            if (internal) {
              if (kept) bits |= 1u << s;
              else flags |= FLAG_OVF;
              continue;
            }
            const int tcode = __ldg(trow + s);
            if (!(tn < bt) ||
                !(tn > thr_t || (tn == thr_t && tcode > thr_c)))
              continue;
            if (!kept) {
              flags |= FLAG_OVF;
              continue;
            }
            // insert (tn, tcode) in lex order: compare-swap cascade
            float ct = tn;
            int cc = tcode;
#pragma unroll
            for (int j = 0; j < S; ++j) {
              if (lex_lt(ct, cc, s_t[j], s_c[j])) {
                const float tt = s_t[j];
                const int tc = s_c[j];
                s_t[j] = ct;
                s_c[j] = cc;
                ct = tt;
                cc = tc;
              }
            }
            if (cc != NONE_CODE) flags |= FLAG_OVF;
            dirty = true;
          }
          if (dirty) {
#pragma unroll
            for (int j = 0; j < S; ++j) {
              pk.f(F_SLOT + j, i) = s_t[j];
              pk.g(I_SLOT + j, i) = s_c[j];
            }
          }
          pk.g(I_FLAGS, i) = flags;
        }
      }
      const unsigned any = pk.block_or(bits);
      if (code >= 0) {
        const unsigned ordw = (unsigned)__ldg(crow + 8 + pk.oct);
        for (int pos = A - 1; pos >= 0; --pos) {
          const int slot = (ordw >> (4 * pos)) & 15;
          if (slot >= A || !((any >> slot) & 1u)) continue;
          const int csel = __ldg(crow + slot);
          if (csel < 0) continue;
          if (sp < NSTACK) {
            if (threadIdx.x == 0) pk.nstack[sp] = csel;
            ++sp;
          } else {
            pk.exact = false;
          }
        }
      }
    }
    ++step;
  }
  if (sp > 0) pk.exact = false;
  // thresholds advance to the last kept candidate of a full list; a lane
  // whose scan did not overflow is exhausted
  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    const int flags = pk.g(I_FLAGS, i);
    if (!(flags & FLAG_SCAN)) continue;
    const int last = pk.g(I_SLOT + S - 1, i);
    if (last != NONE_CODE) {
      pk.f(F_THR, i) = pk.f(F_SLOT + S - 1, i);
      pk.g(I_THR, i) = last;
    }
    pk.g(I_EXH, i) = (flags & FLAG_OVF) ? 0 : 1;
  }
}

// DRAIN round: walk the packet-nearest requested treelet once, every lane
// testing every popped cluster, then remove the drained slot
// (pallas_treelet.py:223-331)
template <int S>
__device__ void drain_round(Packet& pk, int* s_min_t, int* s_root) {
  const int A = pk.A;
  int my_t = ordered(BIG);
  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    const float t0 = pk.f(F_SLOT, i);
    if (pk.g(I_SLOT, i) != NONE_CODE && t0 < pk.f(F_BT, i))
      my_t = min(my_t, ordered(t0));
  }
  __syncthreads();  // the previous round's readers of the shared minima
  if (threadIdx.x == 0) {
    *s_min_t = ordered(BIG);
    *s_root = NONE_CODE;
  }
  __syncthreads();
  atomicMin(s_min_t, my_t);
  __syncthreads();
  const int min_t = *s_min_t;
  int my_root = NONE_CODE;
  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    const float t0 = pk.f(F_SLOT, i);
    const int c0 = pk.g(I_SLOT, i);
    if (c0 != NONE_CODE && t0 < pk.f(F_BT, i) && ordered(t0) == min_t)
      my_root = min(my_root, c0);
  }
  atomicMin(s_root, my_root);
  __syncthreads();
  const int root = *s_root;
  int nsp = root >= 0 ? 1 : 0, csp = root < 0 ? 1 : 0;
  if (threadIdx.x == 0) {
    if (root >= 0) pk.nstack[0] = root;
    else pk.cstack[0] = -(root + 1);
  }
  const int K = pk.w.max_cluster;
  const int max_steps = 8 * pk.w.num_nodes + 8192;
  const int cmargin = CSTACK - NODE_POPS * A - 1;
  int step = 0;
  while ((nsp > 0 || csp > 0) && step < max_steps) {
    __syncthreads();
    pk.reset_next();
    const bool allow = csp < cmargin;
    int ncode[NODE_POPS], cval[CLUSTER_POPS];
#pragma unroll
    for (int q = 0; q < NODE_POPS; ++q) {
      const bool has = nsp > 0 && allow;
      ncode[q] = has ? pk.nstack[nsp - 1] : -1;
      if (has) --nsp;
    }
#pragma unroll
    for (int q = 0; q < CLUSTER_POPS; ++q) {
      cval[q] = csp > 0 ? pk.cstack[csp - 1] : 0;
      csp = max(csp - 1, 0);
    }
    unsigned bits = 0;
    for (int k = 0; k < pk.lpt; ++k) {
      const int i = pk.lane(k);
      float bt = pk.f(F_BT, i);
      if (!(bt >= 0.0f)) continue;  // neither a triangle nor a box can pass
      const Ray q = pk.ray(i);
      if (bt > 0.0f) {
        int btri = pk.g(I_TRI, i);
        float bu = pk.f(F_BU, i), bv = pk.f(F_BV, i);
        bool dirty = false;
        for (int c = 0; c < CLUSTER_POPS; ++c) {
          const int v = cval[c];
          const int count = min(v & 255, K);
          if (count == 0) continue;
          const int start = min(max(v >> 8, 0), pk.w.tri_rows - K);
          for (int j = 0; j < count; ++j) {
            const float* row = pk.w.tri + (size_t)(start + j) * 16;
            float t, u, vv;
            ++pk.tris;
            if (mt_tri(__ldg(row + 0), __ldg(row + 1), __ldg(row + 2),
                       __ldg(row + 3), __ldg(row + 4), __ldg(row + 5),
                       __ldg(row + 6), __ldg(row + 7), __ldg(row + 8), q, &t,
                       &u, &vv) &&
                t < bt) {
              bt = t;
              btri = (int)__ldg(row + 9);
              bu = u;
              bv = vv;
              dirty = true;
            }
          }
        }
        if (dirty) {
          pk.f(F_BT, i) = bt;
          pk.g(I_TRI, i) = btri;
          pk.f(F_BU, i) = bu;
          pk.f(F_BV, i) = bv;
        }
      }
      for (int c = 0; c < NODE_POPS; ++c) {
        if (ncode[c] < 0) continue;
        const float* row = pk.w.node_f32 + (size_t)ncode[c] * pk.w.width;
        for (int s = 0; s < A; ++s) {
          float tn;
          ++pk.slabs;
          if (slab_tn(row + 6 * s, q.ox, q.oy, q.oz, q.ix, q.iy, q.iz, bt, tn))
            bits |= 1u << (c * A + s);
        }
      }
    }
    const unsigned any = pk.block_or(bits);
    // push node by node, each far to near in the packet's order
    for (int c = 0; c < NODE_POPS; ++c) {
      if (ncode[c] < 0) continue;
      ++pk.pops;
      const int* crow = pk.w.child + (size_t)ncode[c] * 16;
      const unsigned ordw = (unsigned)__ldg(crow + 8 + pk.oct);
      for (int pos = A - 1; pos >= 0; --pos) {
        const int slot = (ordw >> (4 * pos)) & 15;
        if (slot >= A || !((any >> (c * A + slot)) & 1u)) continue;
        const int csel = __ldg(crow + slot);
        if (csel >= 0) {
          if (nsp < NSTACK) {
            if (threadIdx.x == 0) pk.nstack[nsp] = csel;
            ++nsp;
          } else {
            pk.exact = false;
          }
        } else if (-(csel + 1) > 0) {
          if (csp < CSTACK) {
            if (threadIdx.x == 0) pk.cstack[csp] = -(csel + 1);
            ++csp;
          } else {
            pk.exact = false;
          }
        }
      }
    }
    ++step;
  }
  if (nsp > 0 || csp > 0) pk.exact = false;
  // consume the drained slot: from the match on, each slot takes its
  // successor's entry
  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    bool shifted = false;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      shifted |= pk.g(I_SLOT + j, i) == root;
      if (shifted) {
        pk.f(F_SLOT + j, i) = j + 1 < S ? pk.f(F_SLOT + j + 1, i) : BIG;
        pk.g(I_SLOT + j, i) = j + 1 < S ? pk.g(I_SLOT + j + 1, i) : NONE_CODE;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS) closest_kernel(
    Rays r, int packet, int max_rounds, const float* __restrict__ seed_t,
    const int* __restrict__ seed_c, const int* __restrict__ seed_ovf, Wide w,
    Top top, int arity, float* __restrict__ fs, int* __restrict__ is, int np,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ capped, unsigned long long* __restrict__ stats) {
  __shared__ int nstack[NSTACK + 2];
  __shared__ int cstack[CSTACK + 2];
  __shared__ unsigned any_buf[2];
  __shared__ int s_live, s_min_t, s_root;
  Packet pk;
  pk.r = r;
  pk.w = w;
  pk.top = top;
  pk.A = arity;
  pk.base = blockIdx.x * packet;
  pk.lpt = packet / THREADS;
  pk.np = np;
  pk.oct = packet_octant(r, pk.base);
  pk.fs = fs;
  pk.is = is;
  pk.nstack = nstack;
  pk.cstack = cstack;
  pk.any_buf = any_buf;
  pk.par = 0;
  pk.exact = true;
  pk.pops = pk.slabs = pk.tris = 0;
  const bool seeded = seed_t != nullptr;

  // initial state (pallas_treelet.py:364-398); padded lanes have t_max -1
  // and, seeded, no candidate and the exhausted flag
  bool any_pos = false, any_nan = false, any_slot = false, need_scan = false;
  int nlive = 0;
  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    const bool in = i < r.n;
    const float tm = in ? r.tmax[i] : -1.0f;
    const float bt = nmin(tm, BIG);
    nlive += tm > 0.0f;
    any_pos |= bt > 0.0f;
    any_nan |= bt != bt;
    pk.f(F_IX, i) = safe_inv(in ? r.dx[i] : 0.0f);
    pk.f(F_IY, i) = safe_inv(in ? r.dy[i] : 0.0f);
    pk.f(F_IZ, i) = safe_inv(in ? r.dz[i] : 0.0f);
    pk.f(F_BT, i) = bt;
    pk.f(F_BU, i) = 0.0f;
    pk.f(F_BV, i) = 0.0f;
    pk.g(I_TRI, i) = -1;
    pk.g(I_FLAGS, i) = 0;
    float t0 = BIG, thr_t = -BIG;
    int c0 = NONE_CODE, thr_c = CODE_MIN, exh = 0;
    if (seeded) {
      const float sd_t = in ? seed_t[i] : BIG;
      const int sd_c = in ? seed_c[i] : NONE_CODE;
      exh = in ? 1 - seed_ovf[i] : 1;
      if (sd_c != NONE_CODE && sd_t < bt) {
        t0 = thr_t = sd_t;
        c0 = thr_c = sd_c;
        any_slot = true;
      } else if (exh == 0 && bt > 0.0f) {
        need_scan = true;
      }
    }
    pk.f(F_THR, i) = thr_t;
    pk.g(I_THR, i) = thr_c;
    pk.g(I_EXH, i) = exh;
    pk.f(F_SLOT, i) = t0;
    pk.g(I_SLOT, i) = c0;
#pragma unroll
    for (int j = 1; j < S; ++j) {
      pk.f(F_SLOT + j, i) = BIG;
      pk.g(I_SLOT + j, i) = NONE_CODE;
    }
  }
  if (threadIdx.x == 0) {
    any_buf[0] = any_buf[1] = 0u;
    s_live = 0;
  }
  __syncthreads();
  if (nlive) atomicAdd(&s_live, nlive);
  const bool b_slot = __syncthreads_or(any_slot);
  const bool b_need = __syncthreads_or(need_scan);
  const bool b_pos = __syncthreads_or(any_pos);
  const bool b_nan = __syncthreads_or(any_nan);
  bool done, drain;
  if (seeded) {
    done = !b_slot && !b_need;
    drain = b_slot;
  } else {
    done = !b_pos && !b_nan;  // jnp.max(bt) <= 0, NaN-propagating
    drain = false;
  }

  // round loop (pallas_treelet.py:336-362)
  int round = 0;
  unsigned long long drains = 0, scans = 0;
  while (!done && round < max_rounds) {
    if (drain) {
      drain_round<S>(pk, &s_min_t, &s_root);
      ++drains;
    } else {
      scan_round<S>(pk);
      ++scans;
    }
    bool a = false, ns = false;
    for (int k = 0; k < pk.lpt; ++k) {
      const int i = pk.lane(k);
      const float bt = pk.f(F_BT, i);
      const int c0 = pk.g(I_SLOT, i);
      a |= c0 != NONE_CODE && pk.f(F_SLOT, i) < bt;
      ns |= c0 == NONE_CODE && pk.g(I_EXH, i) == 0 && pk.f(F_THR, i) < bt;
    }
    const bool b_a = __syncthreads_or(a);
    const bool b_ns = __syncthreads_or(ns);
    done = !b_a && !b_ns;
    drain = b_a;
    ++round;
  }
  if (!done) pk.exact = false;

  for (int k = 0; k < pk.lpt; ++k) {
    const int i = pk.lane(k);
    if (i >= r.n) continue;
    const int btri = pk.g(I_TRI, i);
    t_out[i] = btri >= 0 ? pk.f(F_BT, i) : MISS_T;
    tri_out[i] = btri;
    u_out[i] = pk.f(F_BU, i);
    v_out[i] = pk.f(F_BV, i);
  }
  if (threadIdx.x == 0) {
    if (!pk.exact && s_live) atomicAdd(capped, s_live);
    if (stats) {
      atomicAdd(stats + 0, pk.pops);
      atomicAdd(stats + 3, drains);
      atomicAdd(stats + 4, scans);
      atomicMax(stats + 5, drains);
    }
  }
  if (stats) {
    if (pk.slabs) atomicAdd(stats + 1, pk.slabs);
    if (pk.tris) atomicAdd(stats + 2, pk.tris);
  }
}

template <int S>
int launch_closest(Rays r, int packet, int nt, int max_rounds,
                   const float* seed_t, const int* seed_c,
                   const int* seed_ovf, Wide w, Top top, int arity,
                   float* fs, int* is, float* t, int* tri, float* u, float* v,
                   int* capped, unsigned long long* stats,
                   cudaStream_t stream) {
  closest_kernel<S><<<nt, THREADS, 0, stream>>>(
      r, packet, max_rounds, seed_t, seed_c, seed_ovf, w, top, arity, fs, is,
      nt * packet, t, tri, u, v, capped, stats);
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
__global__ void __launch_bounds__(THREADS) scan_multi_kernel(
    Rays r, int packet, Top top, int arity, int node_pops,
    float* __restrict__ inv, float* __restrict__ st, int* __restrict__ so,
    float* __restrict__ thr, int* __restrict__ capped,
    unsigned long long* __restrict__ stats) {
  __shared__ int stack[SCAN_STACK + 2];
  __shared__ unsigned any_buf[2];
  __shared__ int s_live;
  const int n = r.n;
  const int base = blockIdx.x * packet;
  const int lpt = packet / THREADS;
  const int A = arity;
  bool any_pos = false, any_nan = false;
  int nlive = 0;
  for (int k = 0; k < lpt; ++k) {
    const int i = base + k * THREADS + threadIdx.x;
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
          const int i = base + k * THREADS + threadIdx.x;
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
  scan_multi_kernel<S><<<nt, THREADS, 0, stream>>>(
      r, packet, top, arity, node_pops, inv, st, so, thr, capped, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpt_treelet_max_slots() { return MAX_SLOTS; }
int tpt_treelet_threads() { return THREADS; }

// All pointers are device pointers; `stream` is a cudaStream_t. The top
// tables are [num_top, top_width] f32 and [num_top, 16], [num_top, 8],
// [num_top, 8] int32. `inv` is a [3, n] f32 scratch. `stats`, if not
// null, accumulates (top node pops summed over packets, slab tests). The
// packet (lanes per block) is a positive multiple of THREADS. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a packet or arity the kernel does not take.
int tpt_treelet_scan(const float* ox, const float* oy, const float* oz,
                     const float* dx, const float* dy, const float* dz,
                     const float* tmax, int n, int packet,
                     const float* top_f32, int top_width, const int* top_child,
                     const int* top_tref, const int* top_tord, int num_top,
                     int arity, float* inv, float* st, int* sc, int* so,
                     int* ovf, int* cnt, int* capped,
                     unsigned long long* stats, void* stream) {
  if (packet <= 0 || packet % THREADS || arity < 2 || arity > MAX_ARITY)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Rays r{ox, oy, oz, dx, dy, dz, tmax, n};
  Top top{top_f32, top_width, top_child, top_tref, top_tord, num_top};
  const int nt = (n + packet - 1) / packet;
  scan_kernel<<<nt, THREADS, 0, (cudaStream_t)stream>>>(
      r, packet, top, arity, inv, st, sc, so, ovf, cnt, capped, stats);
  return (int)cudaGetLastError();
}

// Seeded when seed_t is not null: (seed_t f32, seed_c int32, seed_ovf
// int32) [n] from K9, in pool order. fs and is are f32 [7 + S, np] and
// int32 [4 + S, np] scratch, np = ceil(n / packet) * packet. `stats`, if
// not null, is uint64 [6]: node pops (top and treelet, summed over
// packets), slab tests, triangle tests, drain rounds, scan rounds, and the
// most drain rounds of one packet.
int tpt_treelet_closest_hit(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, int n, int packet,
    int slots, int max_rounds, const float* seed_t, const int* seed_c,
    const int* seed_ovf, const float* node_f32, int node_width,
    const int* node_child, int num_nodes, const float* tri_f32, int tri_rows,
    int max_cluster, const float* top_f32, int top_width,
    const int* top_child, const int* top_tref, int num_top, int arity,
    float* fs, int* is, float* t, int* tri, float* u, float* v, int* capped,
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
                             seed_ovf, w, top, arity, fs, is, t, tri, u, v, \
                             capped, stats, s);
  switch (slots) {
    CLOSEST_CASE(1) CLOSEST_CASE(2) CLOSEST_CASE(3) CLOSEST_CASE(4)
    CLOSEST_CASE(5) CLOSEST_CASE(6) CLOSEST_CASE(7) CLOSEST_CASE(8)
  }
#undef CLOSEST_CASE
  return (int)cudaErrorInvalidValue;
}

// K11. `st`, `so` are f32/int32 [S, n], `thr` f32 [n]; the other
// arguments as for tpt_treelet_scan, with `node_pops` pops a step (the
// step cap counts steps). Returns cudaErrorInvalidValue also for S
// outside 1..MAX_SLOTS.
int tpt_treelet_scan_multi(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmax, int n, int packet, int slots,
                           int node_pops, const float* top_f32, int top_width,
                           const int* top_child, const int* top_tord,
                           int num_top, int arity, float* inv, float* st,
                           int* so, float* thr, int* capped,
                           unsigned long long* stats, void* stream) {
  if (packet <= 0 || packet % THREADS || arity < 2 || arity > MAX_ARITY ||
      node_pops < 1)
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

}  // extern "C"
