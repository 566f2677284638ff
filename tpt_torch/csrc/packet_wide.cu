// Packet-BVH traversal kernels for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes (tpt_torch/bvh/packet_traverse.py binds them).
//
// Replaces the Pallas TPU kernels of tpt/bvh/pallas_traverse.py:
//   K2  tpt_packet_closest_hit_wide <- packet_closest_hit_wide (:893, :931)
//   K1  tpt_packet_any_hit_wide     <- packet_any_hit_wide     (:959, :985)
//   K8a tpt_packet_closest_hit      <- packet_closest_hit      (:350, :368)
//   K8b tpt_packet_any_hit          <- packet_any_hit          (:394, :405)
//
// The TPU kernels walk one shared stack per 1024-ray packet, because
// Mosaic has no per-lane gather. A GPU thread can gather, so here every
// ray walks with its own stack: it pops a code, and a node slab-tests its
// children and pushes the hit ones far to near, so the nearest is popped
// next; a cluster runs Moller-Trumbore over its triangles and takes a
// triangle only on a strict t < best (K1: stops at the first hit before
// t_max - 1e-3).
//
// Wide layout (K1/K2; build_packet_bvh_wide):
//   node_f32   [Nt, W]  child s box at cols [6s, 6s+6), W a multiple of 4
//   node_child [Nt, 16] cols [0, A) child codes (>= 0 node, < -1 cluster
//                       -(start*256+count)-1, -1 empty), cols [8, 16) one
//                       packed near-to-far slot order per octant
// A popped node slab-tests its non-empty slots and pushes the hit ones in
// the order word of the ray's octant, far first.
//
// Binary layout (K8a/K8b; build_packet_bvh):
//   node_f32   [Nt, 16] left child box at cols [0, 6), right at [6, 12)
//   node_child [Nt, 2]  the two child codes, encoded as above
// K8a slab-tests both children against the best t so far and pushes the
// hit ones far first, ordered by entry t with a swap only when the left
// child's is strictly larger. tpt orders them by the smallest entry t
// over its 1024-lane packet (pallas_traverse.py:158-175); a per-ray walk
// orders them by the ray's own, which visits every cluster whose box
// holds the nearest hit in either order, so the closest t is tpt's (an
// equal-t tie on a shared edge may name the other triangle). K8b pushes
// the hit children in slot order, 0 then 1, as tpt does. A cluster's
// start is clipped to [0, tri_rows - max_cluster] and at most
// max_cluster triangles are tested (pallas_traverse.py:188-190).
//
//   tri_f32    [Tp, 16] v0, e1, e2, triangle id (col 9), both layouts
//
// The arithmetic is the TPU kernels', operation for operation, and the
// library is compiled with -fmad=false so no multiply-add is contracted:
// the plain PyTorch version (packet_traverse.py) gives the same bits. The
// ray set-up and the triangle test live in ray_common.cuh, shared with the
// sweep and treelet kernels. A ray's slab arithmetic cannot make a NaN
// (its origin and direction are finite, the reciprocal is bounded, the
// boxes are finite), so fminf/fmaxf here give what NaN-propagating
// min/max give.
//
// Bounds. Per ray: a stack of STACK_DEPTH entries and at most
// 8 * num_nodes + pad pops, the TPU kernels' own caps (pad 8192 for the
// wide kernels, pallas_traverse.py:567; 4096 for the binary ones, :203).
// tpt drops a push onto a full stack silently; here a ray whose push finds
// the stack full (the push is dropped) or that reaches the cap stops being
// exact and is counted once in *capped, so no input can hang the card and
// none can go wrong unseen. Rays with a NaN or infinite origin or
// direction, or a NaN t_max, miss without traversal.
//
// What bounds K1/K2 on this card: operations, not bytes, and latency. A
// ray reads 28 bytes and writes 16 (K1: 1); the tables (9 MB for the
// 139k-triangle bench interior) sit in the 50 MB L2, and the work is slab
// tests and triangle tests per ray, each step waiting on the load of the
// node or the rows the step before chose.
//
// K1/K2's walk (wide_thread_kernel): one thread a ray. A node's row is
// read as 6A/4 float4 and its child codes as A/4 int4 (one 16-byte load
// each), its slots are slab-tested unrolled with static indices (no
// register array is indexed by data, so nothing spills to local memory),
// and the hit ones are pushed in the order word's order by selects over
// the static slots. A triangle row is three float4 (cols 0-11; the id is
// col 9). The loop is while-while (Aila & Laine 2009): the lanes of a warp
// pop and visit nodes until every lane holds a cluster or is done (a warp
// vote), then test their clusters, so lanes on nodes and lanes on clusters
// do not take turns on every step. A ray's pops are the plain walk's, in
// the same order, so its bits are the same. The stack keeps its top entry
// in a register (the nearest child, pushed last, is popped next without a
// memory round trip) and the rest in local memory, 128 threads a block:
// on an H100 a stack in shared memory (entry k of thread x at k * 128 + x)
// and 256-thread blocks were no faster (slower on the bench's shadow rays,
// within the noise of repeated timings elsewhere), and a walk that carried
// a ray on a group of `arity` lanes, faster alone on the sweep's small
// tail launches, showed no gain in the frame and was slower on full pools
// (PERF.md), so the simplest stayed. The counters of `stats` are compiled
// in only for launches that ask for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define STACK_DEPTH 64
#define BLOCK 128        // threads a block
#define BIG 3.0e38f
#define MISS_T 3.4e38f
#define FULL_MASK 0xffffffffu

namespace {

__device__ __forceinline__ bool ray_finite(const Ray& r, float tm) {
  return isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) &&
         isfinite(r.dx) && isfinite(r.dy) && isfinite(r.dz) && !isnan(tm);
}

// box (b0, b1, b2) min, (b3, b4, b5) max slab test against [0, limit]
// (pallas_traverse.py:_slab); *tn gets the entry t
__device__ __forceinline__ bool slab6(float b0, float b1, float b2, float b3,
                                      float b4, float b5, const Ray& r,
                                      float limit, float* tn) {
  const float t0x = (b0 - r.ox) * r.ix;
  const float t0y = (b1 - r.oy) * r.iy;
  const float t0z = (b2 - r.oz) * r.iz;
  const float t1x = (b3 - r.ox) * r.ix;
  const float t1y = (b4 - r.oy) * r.iy;
  const float t1z = (b5 - r.oz) * r.iz;
  *tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
              fmaxf(fminf(t0z, t1z), 0.0f));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fminf(fmaxf(t0z, t1z), limit));
  return *tn <= tf;
}

__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float limit, float* tn) {
  return slab6(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
               __ldg(b + 4), __ldg(b + 5), r, limit, tn);
}

// Moller-Trumbore of one tri_f32 row (ray_common.cuh:mt_tri)
__device__ __forceinline__ bool mt(const float* __restrict__ row,
                                   const Ray& r, float* t_out, float* u_out,
                                   float* v_out) {
  return mt_tri(__ldg(row + 0), __ldg(row + 1), __ldg(row + 2),
                __ldg(row + 3), __ldg(row + 4), __ldg(row + 5),
                __ldg(row + 6), __ldg(row + 7), __ldg(row + 8), r, t_out,
                u_out, v_out);
}

// the row of packed triangle j as three float4 (cols 0-11; id at col 9)
__device__ __forceinline__ bool mt_row4(const float4* __restrict__ tri4,
                                        int j, const Ray& r, float* t,
                                        float* u, float* v, int* id) {
  const float4* w = tri4 + (size_t)j * 4;
  const float4 p = __ldg(w), q = __ldg(w + 1), s = __ldg(w + 2);
  *id = (int)s.y;
  return mt_tri(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, s.x, r, t, u, v);
}

struct Tables {
  const float* node_f32;
  int node_width;
  const int* node_child;
  int num_nodes;
  const float* tri_f32;
  int tri_rows;
  int arity;
  int max_cluster;
};

__device__ __forceinline__ bool push(int* stack, int& sp, int c) {
  if (sp < STACK_DEPTH) { stack[sp++] = c; return true; }
  return false;
}

// K8a/K8b: both children slab-tested; K8a orders them by entry t, K8b
// keeps slot order (pallas_traverse.py:152-183, :205-224)
struct Binary {
  static constexpr int kStepPad = 4096;

  template <bool kAnyHit>
  static __device__ __forceinline__ bool push_children(
      const Tables& tb, int code, const Ray& r, float limit, int* stack,
      int& sp, unsigned long long& slabs) {
    const float* row = tb.node_f32 + (size_t)code * 16;
    const int* crow = tb.node_child + (size_t)code * 2;
    int c0 = __ldg(crow + 0), c1 = __ldg(crow + 1);
    float t0, t1;
    bool h0 = slab(row, r, limit, &t0);
    bool h1 = slab(row + 6, r, limit, &t1);
    slabs += 2;
    bool ok = true;
    if (kAnyHit) {
      if (h0) ok &= push(stack, sp, c0);
      if (h1) ok &= push(stack, sp, c1);
      return ok;
    }
    float m0 = h0 ? t0 : BIG, m1 = h1 ? t1 : BIG;
    if (m0 > m1) {
      float tm = m0; m0 = m1; m1 = tm;
      int tc = c0; c0 = c1; c1 = tc;
    }
    // far first, so the nearer child is popped next
    if (m1 < BIG) ok &= push(stack, sp, c1);
    if (m0 < BIG) ok &= push(stack, sp, c0);
    return ok;
  }

  static __device__ __forceinline__ void cluster(const Tables& tb, int code,
                                                 int& start, int& count) {
    int v = -(code + 1);
    start = min(max(v >> 8, 0), tb.tri_rows - tb.max_cluster);
    count = min(v & 255, tb.max_cluster);
  }
};

// K8a over the binary layout: one thread a ray, the stack in local memory
template <class L>
__global__ void __launch_bounds__(BLOCK) closest_hit_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, Tables tb,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ capped, unsigned long long* __restrict__ stats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float tm = tmax[i];
  float bt = fminf(tm, BIG);
  int btri = -1;
  float bu = 0.0f, bv = 0.0f;
  int stack[STACK_DEPTH];
  int sp = 0;
  if (ray_finite(r, tm) && bt > 0.0f) stack[sp++] = 0;
  const int max_steps = 8 * tb.num_nodes + L::kStepPad;
  int steps = 0;
  bool exact = true;
  unsigned long long node_visits = 0, slab_tests = 0, tri_tests = 0;
  while (sp > 0) {
    if (steps >= max_steps) { exact = false; break; }
    ++steps;
    int code = stack[--sp];
    if (code >= 0) {
      ++node_visits;
      exact &= L::template push_children<false>(tb, code, r, bt, stack, sp,
                                                slab_tests);
    } else {
      int start, count;
      L::cluster(tb, code, start, count);
      tri_tests += count;
      for (int j = 0; j < count; ++j) {
        const float* row = tb.tri_f32 + (size_t)(start + j) * 16;
        float t, u, v;
        if (mt(row, r, &t, &u, &v) && t < bt) {
          bt = t;
          btri = (int)__ldg(row + 9);
          bu = u;
          bv = v;
        }
      }
    }
  }
  t_out[i] = btri >= 0 ? bt : MISS_T;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  if (!exact) atomicAdd(capped, 1);
  if (stats) {
    atomicAdd(stats + 0, node_visits);
    atomicAdd(stats + 1, slab_tests);
    atomicAdd(stats + 2, tri_tests);
  }
}

// K8b over the binary layout
template <class L>
__global__ void __launch_bounds__(BLOCK) any_hit_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, Tables tb,
    unsigned char* __restrict__ occ_out, int* __restrict__ capped,
    unsigned long long* __restrict__ stats) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float tm = tmax[i];
  float limit = tm - 1e-3f;
  // dead lanes (limit <= 0) report occluded, as the TPU kernels do
  bool occ = limit <= 0.0f;
  int stack[STACK_DEPTH];
  int sp = 0;
  if (ray_finite(r, tm) && !occ) stack[sp++] = 0;
  const int max_steps = 8 * tb.num_nodes + L::kStepPad;
  int steps = 0;
  bool exact = true;
  unsigned long long node_visits = 0, slab_tests = 0, tri_tests = 0;
  while (sp > 0) {
    if (steps >= max_steps) { exact = false; break; }
    ++steps;
    int code = stack[--sp];
    if (code >= 0) {
      ++node_visits;
      exact &= L::template push_children<true>(tb, code, r, limit, stack, sp,
                                               slab_tests);
    } else {
      int start, count;
      L::cluster(tb, code, start, count);
      for (int j = 0; j < count; ++j) {
        const float* row = tb.tri_f32 + (size_t)(start + j) * 16;
        float t, u, v;
        ++tri_tests;
        if (mt(row, r, &t, &u, &v) && t < limit) { occ = true; break; }
      }
      if (occ) break;
    }
  }
  occ_out[i] = occ ? 1 : 0;
  if (!exact) atomicAdd(capped, 1);
  if (stats) {
    atomicAdd(stats + 0, node_visits);
    atomicAdd(stats + 1, slab_tests);
    atomicAdd(stats + 2, tri_tests);
  }
}

// ---------------------------------------------------------------------------
// K1/K2 over the wide layout
// ---------------------------------------------------------------------------

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  int n;
};

struct Outs {
  float* t;            // K2: t, tri, u, v
  int* tri;
  float *u, *v;
  unsigned char* occ;  // K1
  int* capped;
  unsigned long long* stats;
};

constexpr int kWideStepPad = 8192;

// a ray's stack: the top entry in a register, the entries below it in
// the thread's array `mem` (local memory), mem[0] the bottom
struct RayStack {
  int* mem;
  int top;
  int sp;  // entries held, the top one included

  __device__ __forceinline__ bool push(int c) {
    if (sp >= STACK_DEPTH) return false;
    if (sp > 0) mem[sp - 1] = top;
    top = c;
    ++sp;
    return true;
  }
  __device__ __forceinline__ int pop() {
    const int c = top;
    --sp;
    if (sp > 0) top = mem[sp - 1];
    return c;
  }
};

// The state of one ray's wide walk: the pop with its step cap, the
// cluster decode, the result.
template <bool kAny>
struct WideRay {
  Ray r;
  float tm;
  float bt;      // K2: best t so far, the slab limit
  float limit;   // K1: t_max - 1e-3, the slab and hit limit
  int btri;
  float bu, bv;
  bool occ, exact, done;
  int held;      // the code popped last (node >= 0, cluster < -1)
  int steps, max_steps;
  RayStack st;
  unsigned long long nodes, slabs, tris;

  __device__ __forceinline__ void start(const Rays& ra, int i, bool in,
                                        const Tables& tb, int* mem) {
    r = in ? load_ray(ra.ox, ra.oy, ra.oz, ra.dx, ra.dy, ra.dz, i) : Ray{};
    tm = in ? ra.tmax[i] : 0.0f;
    bt = fminf(tm, BIG);
    limit = tm - 1e-3f;
    btri = -1;
    bu = bv = 0.0f;
    // K1: dead lanes (limit <= 0) report occluded, as the TPU kernels do
    occ = kAny && limit <= 0.0f;
    exact = true;
    steps = 0;
    max_steps = 8 * tb.num_nodes + kWideStepPad;
    st = RayStack{mem, 0, 0};
    nodes = slabs = tris = 0;
    held = 0;
    done = !(in && ray_finite(r, tm) && (kAny ? !occ : bt > 0.0f));
    if (!done) { st.push(0); fetch(); }
  }
  __device__ __forceinline__ float slab_limit() const {
    return kAny ? limit : bt;
  }
  // the next code, or done once the stack is empty or the cap is reached
  __device__ __forceinline__ void fetch() {
    if (st.sp == 0) { done = true; return; }
    if (steps >= max_steps) { exact = false; done = true; return; }
    ++steps;
    held = st.pop();
  }
  __device__ __forceinline__ bool on_node() const {
    return !done && held >= 0;
  }
  __device__ __forceinline__ bool on_cluster() const {
    return !done && held < 0;
  }
  __device__ __forceinline__ void cluster(const Tables& tb, int& start,
                                          int& count) const {
    const int v = -(held + 1);
    start = v >> 8;
    count = v & 255;
    if (start + count > tb.tri_rows) count = max(tb.tri_rows - start, 0);
  }
  // push node `held`'s children in `mask` (bit s: slot s hit) far to
  // near in the order word's order; child(s) gives slot s's code
  template <int A, class Child>
  __device__ __forceinline__ void push_hits(const Tables& tb, unsigned mask,
                                            Child child) {
    const unsigned ordw =
        (unsigned)__ldg(tb.node_child + (size_t)held * 16 + 8 + r.oct);
#pragma unroll
    for (int pos = A - 1; pos >= 0; --pos) {
      const int s = (ordw >> (4 * pos)) & 15;
      if (mask >> s & 1u) exact &= st.push(child(s));
    }
  }
  __device__ __forceinline__ void write(const Outs& o, int i) const {
    if (kAny) {
      o.occ[i] = occ ? 1 : 0;
    } else {
      o.t[i] = btri >= 0 ? bt : MISS_T;
      o.tri[i] = btri;
      o.u[i] = bu;
      o.v[i] = bv;
    }
  }
};

// capped rays and the counters of `stats`, one atomic a warp; `lead`
// marks the lanes that carry a ray
template <bool kStats, class W>
__device__ __forceinline__ void report(const W& w, bool lead, const Outs& o) {
  const int nc = __popc(__ballot_sync(FULL_MASK, lead && !w.exact));
  if ((threadIdx.x & 31) == 0 && nc) atomicAdd(o.capped, nc);
  if (kStats) {
    unsigned long long c[3] = {lead ? w.nodes : 0ull, lead ? w.slabs : 0ull,
                               lead ? w.tris : 0ull};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c[k] += __shfl_xor_sync(FULL_MASK, c[k], off);
      if ((threadIdx.x & 31) == 0 && c[k]) atomicAdd(o.stats + k, c[k]);
    }
  }
}

// K1/K2: one thread a ray, while-while over the warp.
template <bool kAny, int A, bool kStats>
__global__ void __launch_bounds__(BLOCK) wide_thread_kernel(Rays ra,
                                                            Tables tb,
                                                            Outs o) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < ra.n;
  int stack[STACK_DEPTH - 1];
  WideRay<kAny> w;
  w.start(ra, i, in, tb, stack);
  const float4* tri4 = reinterpret_cast<const float4*>(tb.tri_f32);
  while (__any_sync(FULL_MASK, !w.done)) {
    // nodes, until every lane of the warp holds a cluster or is done
    while (__any_sync(FULL_MASK, w.on_node())) {
      if (!w.on_node()) continue;
      const float4* row = reinterpret_cast<const float4*>(
          tb.node_f32 + (size_t)w.held * tb.node_width);
      const int4* crow =
          reinterpret_cast<const int4*>(tb.node_child + (size_t)w.held * 16);
      float b[6 * A];
      int c[A];
#pragma unroll
      for (int k = 0; k < 6 * A / 4; ++k) {
        const float4 q = __ldg(row + k);
        b[4 * k] = q.x; b[4 * k + 1] = q.y; b[4 * k + 2] = q.z;
        b[4 * k + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < A / 4; ++k) {
        const int4 q = __ldg(crow + k);
        c[4 * k] = q.x; c[4 * k + 1] = q.y; c[4 * k + 2] = q.z;
        c[4 * k + 3] = q.w;
      }
      const float lim = w.slab_limit();
      unsigned mask = 0;
#pragma unroll
      for (int s = 0; s < A; ++s) {
        if (c[s] == -1) continue;
        if (kStats) ++w.slabs;
        float tn;
        if (slab6(b[6 * s], b[6 * s + 1], b[6 * s + 2], b[6 * s + 3],
                  b[6 * s + 4], b[6 * s + 5], w.r, lim, &tn))
          mask |= 1u << s;
      }
      if (kStats) ++w.nodes;
      w.template push_hits<A>(tb, mask, [&](int s) {
        int cs = c[0];
#pragma unroll
        for (int k = 1; k < A; ++k) cs = s == k ? c[k] : cs;
        return cs;
      });
      w.fetch();
    }
    // clusters, until no lane of the warp holds one
    while (__any_sync(FULL_MASK, w.on_cluster())) {
      if (!w.on_cluster()) continue;
      int start, count;
      w.cluster(tb, start, count);
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        int id;
        const bool hit = mt_row4(tri4, start + j, w.r, &t, &u, &v, &id);
        if (kAny) {
          if (kStats) ++w.tris;
          if (hit && t < w.limit) { w.occ = true; break; }
        } else if (hit && t < w.bt) {
          w.bt = t;
          w.btri = id;
          w.bu = u;
          w.bv = v;
        }
      }
      if (kStats && !kAny) w.tris += count;
      if (kAny && w.occ) w.done = true;
      else w.fetch();
    }
  }
  if (in) w.write(o, i);
  report<kStats>(w, in, o);
}

template <class L>
int launch_closest(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const float* tmax, int n, Tables tb, float* t_out,
                   int* tri_out, float* u_out, float* v_out, int* capped,
                   unsigned long long* stats, void* stream) {
  if (n > 0) {
    closest_hit_kernel<L><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                            (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, tb, t_out, tri_out, u_out, v_out,
        capped, stats);
  }
  return (int)cudaGetLastError();
}

template <class L>
int launch_any(const float* ox, const float* oy, const float* oz,
               const float* dx, const float* dy, const float* dz,
               const float* tmax, int n, Tables tb, unsigned char* occ_out,
               int* capped, unsigned long long* stats, void* stream) {
  if (n > 0) {
    any_hit_kernel<L><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                        (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, tb, occ_out, capped, stats);
  }
  return (int)cudaGetLastError();
}

template <bool kAny, int A>
int launch_wide_arity(const Rays& ra, const Tables& tb, const Outs& o,
                      cudaStream_t s) {
  const int grid = (ra.n + BLOCK - 1) / BLOCK;
  if (o.stats)
    wide_thread_kernel<kAny, A, true><<<grid, BLOCK, 0, s>>>(ra, tb, o);
  else
    wide_thread_kernel<kAny, A, false><<<grid, BLOCK, 0, s>>>(ra, tb, o);
  return (int)cudaGetLastError();
}

template <bool kAny>
int launch_wide(const Rays& ra, const Tables& tb, const Outs& o,
                void* stream) {
  if (ra.n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (tb.arity == 4) return launch_wide_arity<kAny, 4>(ra, tb, o, s);
  if (tb.arity == 8) return launch_wide_arity<kAny, 8>(ra, tb, o, s);
  return (int)cudaErrorInvalidValue;
}

template <class K>
int attributes(K kernel, int* out) {
  cudaFuncAttributes a;
  const int rc = (int)cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return rc;
}

}  // namespace

extern "C" {

int tpt_stack_depth() { return STACK_DEPTH; }

// All pointers are device pointers; `stream` is a cudaStream_t. `stats`,
// if not null, accumulates (node visits, slab tests, triangle tests).
// Each returns cudaGetLastError() after the launch (0 = launched).
#define TABLES_ARGS                                                        \
  const float *ox, const float *oy, const float *oz, const float *dx,      \
      const float *dy, const float *dz, const float *tmax, int n,          \
      const float *node_f32, int node_width, const int *node_child,        \
      int num_nodes, const float *tri_f32, int tri_rows, int arity,        \
      int max_cluster
#define TABLES                                                             \
  Tables { node_f32, node_width, node_child, num_nodes, tri_f32, tri_rows, \
           arity, max_cluster }

// K2/K1: the node table's rows and the triangle table must be 16-byte
// aligned and node_width a multiple of 4. cudaErrorInvalidValue for
// another arity.
int tpt_packet_closest_hit_wide(TABLES_ARGS,
                                float* t_out, int* tri_out, float* u_out,
                                float* v_out, int* capped,
                                unsigned long long* stats, void* stream) {
  const Rays ra{ox, oy, oz, dx, dy, dz, tmax, n};
  const Outs o{t_out, tri_out, u_out, v_out, nullptr, capped, stats};
  return launch_wide<false>(ra, TABLES, o, stream);
}

int tpt_packet_any_hit_wide(TABLES_ARGS, unsigned char* occ_out,
                            int* capped,
                            unsigned long long* stats, void* stream) {
  const Rays ra{ox, oy, oz, dx, dy, dz, tmax, n};
  const Outs o{nullptr, nullptr, nullptr, nullptr, occ_out, capped, stats};
  return launch_wide<true>(ra, TABLES, o, stream);
}

// registers a thread, local bytes a thread, static shared bytes a block
// and the most threads a block of the stats-free K2 (any_hit 0) or K1
// (any_hit 1) kernel of `arity`, into out[0..3]
int tpt_packet_wide_attributes(int any_hit, int arity, int* out) {
  if (arity == 4 && !any_hit)
    return attributes(wide_thread_kernel<false, 4, false>, out);
  if (arity == 4 && any_hit)
    return attributes(wide_thread_kernel<true, 4, false>, out);
  if (arity == 8 && !any_hit)
    return attributes(wide_thread_kernel<false, 8, false>, out);
  if (arity == 8 && any_hit)
    return attributes(wide_thread_kernel<true, 8, false>, out);
  return (int)cudaErrorInvalidValue;
}

int tpt_packet_closest_hit(TABLES_ARGS, float* t_out, int* tri_out,
                           float* u_out, float* v_out, int* capped,
                           unsigned long long* stats, void* stream) {
  return launch_closest<Binary>(ox, oy, oz, dx, dy, dz, tmax, n, TABLES,
                                t_out, tri_out, u_out, v_out, capped, stats,
                                stream);
}

int tpt_packet_any_hit(TABLES_ARGS, unsigned char* occ_out, int* capped,
                       unsigned long long* stats, void* stream) {
  return launch_any<Binary>(ox, oy, oz, dx, dy, dz, tmax, n, TABLES, occ_out,
                            capped, stats, stream);
}

}  // extern "C"
