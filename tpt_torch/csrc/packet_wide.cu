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
// What bounds the four kernels on this card: operations, not bytes, and
// latency. A ray reads 28 bytes and writes 16 (K1/K8b: 1); the tables
// (9 MB for the 139k-triangle bench interior) sit in the 50 MB L2, and
// the work is slab tests and triangle tests per ray, each step waiting on
// the load of the node or the rows the step before chose.
//
// One walk for all four (walk_kernel): one thread a ray. The layout is a
// policy (Layout<A>): it reads a node, slab-tests its children and pushes
// the hit ones, and decodes a cluster. A wide node's row is read as 6A/4
// float4 and its child codes as A/4 int4 (one 16-byte load each), its
// slots are slab-tested unrolled with static indices (no register array
// is indexed by data, so nothing spills to local memory), and the hit
// ones are pushed in the order word's order by selects over the static
// slots. A binary node is three float4 (cols 0-11 of its 64-byte row) and
// one int2 (its child codes). A triangle row is three float4 (cols 0-11;
// the id is col 9). The loop is while-while (Aila & Laine 2009): the
// lanes of a warp pop and visit nodes until every lane holds a cluster or
// is done (a warp vote), then test their clusters, so lanes on nodes and
// lanes on clusters do not take turns on every step. A ray's pops are the
// plain walk's, in the same order, so its bits are the same. The stack
// keeps its top entry in a register (the nearest child, pushed last, is
// popped next without a memory round trip) and the rest in local memory,
// 128 threads a block: on an H100 a stack in shared memory (entry k of
// thread x at k * 128 + x) and 256-thread blocks were no faster (slower
// on the bench's shadow rays, within the noise of repeated timings
// elsewhere), and a walk that carried a ray on a group of `arity` lanes,
// faster alone on the sweep's small tail launches, showed no gain in the
// frame and was slower on full pools (PERF.md), so the simplest stayed.
// The counters of `stats` are compiled in only for launches that ask for
// them, and capped rays and counters go out as one atomic a warp.
//
// Lane refill (K8b): a launch of one wave of resident blocks whose lanes,
// once fewer than 8 of their warp's 32 are live, write their finished
// rays and take the next ray indices from a counter of the launch's own
// (one atomic a warp), so a warp does not idle until its longest ray
// ends. Each ray still walks alone from a fresh stack and step count, so
// its bits do not change. On the H100 (PERF.md) it made K8b's bounce-1
// shadow rays 8% faster and its bounce-0 ones 2%; K8a it made 10% slower
// on the camera rays (refilled lanes break a coherent warp's lockstep)
// and 1-4% faster on the bounce-1 pool, so K8a launches one thread a ray.

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

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  int n;
};

struct Outs {
  float* t;            // K2/K8a: t, tri, u, v
  int* tri;
  float *u, *v;
  unsigned char* occ;  // K1/K8b
  int* capped;
  int* next;           // K8b: the launch's ray counter (capped + 1)
  unsigned long long* stats;
};

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

// The state of one ray's walk: the pop with its step cap, the result,
// and the lane's counters of `stats` (summed over its rays).
template <bool kAny>
struct RayWalk {
  static constexpr bool kAnyHit = kAny;
  Ray r;
  float tm;
  float bt;      // K2/K8a: best t so far, the slab limit
  float limit;   // K1/K8b: t_max - 1e-3, the slab and hit limit
  int btri;
  float bu, bv;
  bool occ, exact, done;
  int held;      // the code popped last (node >= 0, cluster < 0)
  int steps, max_steps;
  RayStack st;
  unsigned long long nodes = 0, slabs = 0, tris = 0;

  // ray i (`in`: i < n) from the root, at most `max_pops` pops
  __device__ __forceinline__ void start(const Rays& ra, int i, bool in,
                                        int max_pops, int* mem) {
    r = in ? load_ray(ra.ox, ra.oy, ra.oz, ra.dx, ra.dy, ra.dz, i) : Ray{};
    tm = in ? ra.tmax[i] : 0.0f;
    bt = fminf(tm, BIG);
    limit = tm - 1e-3f;
    btri = -1;
    bu = bv = 0.0f;
    // K1/K8b: dead lanes (limit <= 0) report occluded, as the TPU kernels do
    occ = kAny && limit <= 0.0f;
    exact = true;
    steps = 0;
    max_steps = max_pops;
    st = RayStack{mem, 0, 0};
    held = 0;
    done = !(in && ray_finite(r, tm) && (kAny ? !occ : bt > 0.0f));
    if (!done) { st.push(0); fetch(); }
  }
  __device__ __forceinline__ float slab_limit() const {
    return kAny ? limit : bt;
  }
  __device__ __forceinline__ void push(int c) { exact &= st.push(c); }
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

// The layouts. visit() reads node `w.held`, slab-tests its children
// against w.slab_limit() and pushes the hit ones in the layout's order
// (the one pushed last is popped next); cluster() decodes a cluster code
// into its rows.
template <int A>
struct Layout {  // K1/K2: arity 4 or 8, children in the octant's order
  static constexpr int kStepPad = 8192;

  template <bool kStats, class W>
  static __device__ __forceinline__ void visit(W& w, const Tables& tb) {
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
    // far to near in the order word of the ray's octant
    const unsigned ordw =
        (unsigned)__ldg(tb.node_child + (size_t)w.held * 16 + 8 + w.r.oct);
#pragma unroll
    for (int pos = A - 1; pos >= 0; --pos) {
      const int s = (ordw >> (4 * pos)) & 15;
      if (mask >> s & 1u) {
        int cs = c[0];
#pragma unroll
        for (int k = 1; k < A; ++k) cs = s == k ? c[k] : cs;
        w.push(cs);
      }
    }
  }
  static __device__ __forceinline__ void cluster(const Tables& tb, int code,
                                                 int& start, int& count) {
    const int v = -(code + 1);
    start = v >> 8;
    count = v & 255;
    if (start + count > tb.tri_rows) count = max(tb.tri_rows - start, 0);
  }
};

template <>
struct Layout<2> {  // K8a/K8b (pallas_traverse.py:152-183, :188-190, :205-224)
  static constexpr int kStepPad = 4096;

  template <bool kStats, class W>
  static __device__ __forceinline__ void visit(W& w, const Tables& tb) {
    const float4* row =
        reinterpret_cast<const float4*>(tb.node_f32 + (size_t)w.held * 16);
    const float4 p = __ldg(row), q = __ldg(row + 1), s = __ldg(row + 2);
    const int2 c = __ldg(reinterpret_cast<const int2*>(tb.node_child) +
                         w.held);
    const float lim = w.slab_limit();
    float t0, t1;
    const bool h0 = slab6(p.x, p.y, p.z, p.w, q.x, q.y, w.r, lim, &t0);
    const bool h1 = slab6(q.z, q.w, s.x, s.y, s.z, s.w, w.r, lim, &t1);
    if (kStats) { ++w.nodes; w.slabs += 2; }
    if (W::kAnyHit) {  // slot order
      if (h0) w.push(c.x);
      if (h1) w.push(c.y);
      return;
    }
    // by entry t, swapped only when the left one is strictly larger
    const float m0 = h0 ? t0 : BIG, m1 = h1 ? t1 : BIG;
    const bool swap = m0 > m1;
    if ((swap ? m0 : m1) < BIG) w.push(swap ? c.x : c.y);
    if ((swap ? m1 : m0) < BIG) w.push(swap ? c.y : c.x);
  }
  static __device__ __forceinline__ void cluster(const Tables& tb, int code,
                                                 int& start, int& count) {
    const int v = -(code + 1);
    start = min(max(v >> 8, 0), tb.tri_rows - tb.max_cluster);
    count = min(v & 255, tb.max_cluster);
  }
};

// K8b refills its lanes, once fewer than kRefillBelow of a warp are
// live; K1, K2 and K8a launch a thread a ray
template <bool kAny, int A>
constexpr bool kRefill = kAny && A == 2;
constexpr int kRefillBelow = 8;

// Once fewer than kRefillBelow lanes of the warp are live, the lanes
// whose ray is done write its result and take the next ray, until every
// lane holds a live ray or the rays are used up (`dry`); `ncap` counts
// the lane's capped rays. The indices past the first wave come from the
// launch's counter o.next, one atomic a warp a round.
template <bool kAny, int A, class W>
__device__ __forceinline__ void refill(W& w, const Rays& ra,
                                       const Tables& tb, const Outs& o,
                                       int* mem, int& i, bool& in, bool& dry,
                                       int& ncap) {
  if (__popc(__ballot_sync(FULL_MASK, !w.done)) >= kRefillBelow) return;
  if (w.done && in) {
    w.write(o, i);
    ncap += !w.exact;
    in = false;
  }
  const int lane = threadIdx.x & 31;
  for (;;) {
    const unsigned want = __ballot_sync(FULL_MASK, w.done && !dry);
    if (!want) return;
    const int lead = __ffs(want) - 1;
    int base = 0;
    if (lane == lead) base = atomicAdd(o.next, __popc(want));
    base = __shfl_sync(FULL_MASK, base, lead);
    if (w.done && !dry) {
      i = gridDim.x * BLOCK + base + __popc(want & ((1u << lane) - 1u));
      if (i < ra.n) {
        w.start(ra, i, true, 8 * tb.num_nodes + Layout<A>::kStepPad, mem);
        // a ray that needs no walk (dead, NaN) is written at once
        if (w.done) w.write(o, i);
        in = !w.done;
      } else {
        dry = true;
      }
    }
  }
}

// capped rays (`ncap` a lane) and the counters of `stats`, one atomic a
// warp
template <bool kStats, class W>
__device__ __forceinline__ void report(const W& w, int ncap, const Outs& o) {
  const int nc = __reduce_add_sync(FULL_MASK, ncap);
  if ((threadIdx.x & 31) == 0 && nc) atomicAdd(o.capped, nc);
  if (kStats) {
    unsigned long long c[3] = {w.nodes, w.slabs, w.tris};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c[k] += __shfl_xor_sync(FULL_MASK, c[k], off);
      if ((threadIdx.x & 31) == 0 && c[k]) atomicAdd(o.stats + k, c[k]);
    }
  }
}

// K1/K2 (A = 4, 8) and K8b/K8a (A = 2): one thread a ray, while-while over
// the warp; K8b (kRefill) launches one wave, and a lane takes the next ray
// once fewer than kRefillBelow lanes of its warp are live.
template <bool kAny, int A, bool kStats>
__global__ void __launch_bounds__(BLOCK) walk_kernel(Rays ra, Tables tb,
                                                     Outs o) {
  using L = Layout<A>;
  int i = blockIdx.x * BLOCK + threadIdx.x;
  bool in = i < ra.n;
  bool dry = !in;
  int ncap = 0;
  int stack[STACK_DEPTH - 1];
  RayWalk<kAny> w;
  w.start(ra, i, in, 8 * tb.num_nodes + L::kStepPad, stack);
  if (kRefill<kAny, A>)
    refill<kAny, A>(w, ra, tb, o, stack, i, in, dry, ncap);
  const float4* tri4 = reinterpret_cast<const float4*>(tb.tri_f32);
  while (__any_sync(FULL_MASK, !w.done)) {
    // nodes, until every lane of the warp holds a cluster or is done
    while (__any_sync(FULL_MASK, w.on_node())) {
      if (!w.on_node()) continue;
      L::template visit<kStats>(w, tb);
      w.fetch();
    }
    // clusters, until no lane of the warp holds one
    while (__any_sync(FULL_MASK, w.on_cluster())) {
      if (!w.on_cluster()) continue;
      int start, count;
      L::cluster(tb, w.held, start, count);
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
    if (kRefill<kAny, A>)
      refill<kAny, A>(w, ra, tb, o, stack, i, in, dry, ncap);
  }
  if (!kRefill<kAny, A> && in) {
    w.write(o, i);
    ncap = !w.exact;
  }
  report<kStats>(w, ncap, o);
}

template <bool kAny, int A, bool kStats>
int launch_arity(const Rays& ra, const Tables& tb, const Outs& o,
                 cudaStream_t s) {
  int grid = (ra.n + BLOCK - 1) / BLOCK;
  if constexpr (kRefill<kAny, A>) {
    // one wave: the blocks that fit on the card at once
    static int dev_seen = -1, wave = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev != dev_seen) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, walk_kernel<kAny, A, kStats>, BLOCK, 0);
      wave = max(sms * per_sm, 1);
      dev_seen = dev;
    }
    grid = min(grid, wave);
  }
  walk_kernel<kAny, A, kStats><<<grid, BLOCK, 0, s>>>(ra, tb, o);
  return (int)cudaGetLastError();
}

template <bool kAny>
int launch(const Rays& ra, const Tables& tb, const Outs& o, void* stream) {
  if (ra.n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool st = o.stats != nullptr;
  switch (tb.arity) {
    case 2: return st ? launch_arity<kAny, 2, true>(ra, tb, o, s)
                      : launch_arity<kAny, 2, false>(ra, tb, o, s);
    case 4: return st ? launch_arity<kAny, 4, true>(ra, tb, o, s)
                      : launch_arity<kAny, 4, false>(ra, tb, o, s);
    case 8: return st ? launch_arity<kAny, 8, true>(ra, tb, o, s)
                      : launch_arity<kAny, 8, false>(ra, tb, o, s);
  }
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

template <bool kAny>
int attributes_of(int arity, int* out) {
  if (arity == 2) return attributes(walk_kernel<kAny, 2, false>, out);
  if (arity == 4) return attributes(walk_kernel<kAny, 4, false>, out);
  if (arity == 8) return attributes(walk_kernel<kAny, 8, false>, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int tpt_stack_depth() { return STACK_DEPTH; }

// All pointers are device pointers; `stream` is a cudaStream_t. `stats`,
// if not null, accumulates (node visits, slab tests, triangle tests).
// Each returns cudaGetLastError() after the launch (0 = launched). The
// node table's rows and the triangle table must be 16-byte aligned,
// node_width a multiple of 4, and the binary node_child 8-byte aligned.
// cudaErrorInvalidValue for an arity the entry does not take.
#define TABLES_ARGS                                                        \
  const float *ox, const float *oy, const float *oz, const float *dx,      \
      const float *dy, const float *dz, const float *tmax, int n,          \
      const float *node_f32, int node_width, const int *node_child,        \
      int num_nodes, const float *tri_f32, int tri_rows, int arity,        \
      int max_cluster
#define TABLES                                                             \
  Tables { node_f32, node_width, node_child, num_nodes, tri_f32, tri_rows, \
           arity, max_cluster }
#define RAYS Rays { ox, oy, oz, dx, dy, dz, tmax, n }

// K2 (arity 4, 8)
int tpt_packet_closest_hit_wide(TABLES_ARGS,
                                float* t_out, int* tri_out, float* u_out,
                                float* v_out, int* capped,
                                unsigned long long* stats, void* stream) {
  if (arity == 2) return (int)cudaErrorInvalidValue;
  const Outs o{t_out, tri_out, u_out, v_out, nullptr, capped, nullptr, stats};
  return launch<false>(RAYS, TABLES, o, stream);
}

// K1 (arity 4, 8)
int tpt_packet_any_hit_wide(TABLES_ARGS, unsigned char* occ_out,
                            int* capped,
                            unsigned long long* stats, void* stream) {
  if (arity == 2) return (int)cudaErrorInvalidValue;
  const Outs o{nullptr, nullptr, nullptr, nullptr, occ_out, capped, nullptr,
               stats};
  return launch<true>(RAYS, TABLES, o, stream);
}

// K8a (arity 2)
int tpt_packet_closest_hit(TABLES_ARGS, float* t_out, int* tri_out,
                           float* u_out, float* v_out, int* capped,
                           unsigned long long* stats, void* stream) {
  if (arity != 2) return (int)cudaErrorInvalidValue;
  const Outs o{t_out, tri_out, u_out, v_out, nullptr, capped, nullptr, stats};
  return launch<false>(RAYS, TABLES, o, stream);
}

// K8b (arity 2): `capped` points to two zeroed ints, the count of capped
// rays and the launch's lane-refill counter
int tpt_packet_any_hit(TABLES_ARGS, unsigned char* occ_out, int* capped,
                       unsigned long long* stats, void* stream) {
  if (arity != 2) return (int)cudaErrorInvalidValue;
  const Outs o{nullptr, nullptr, nullptr, nullptr, occ_out, capped,
               capped + 1, stats};
  return launch<true>(RAYS, TABLES, o, stream);
}

// registers a thread, local bytes a thread, static shared bytes a block
// and the most threads a block of the stats-free K2 (any_hit 0) or K1
// (any_hit 1) kernel of `arity` 4 or 8, or of K8a/K8b for arity 2, into
// out[0..3]
int tpt_packet_wide_attributes(int any_hit, int arity, int* out) {
  return any_hit ? attributes_of<true>(arity, out)
                 : attributes_of<false>(arity, out);
}

}  // extern "C"
