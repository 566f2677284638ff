// Packet-BVH traversal kernels for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes (tpt_torch/bvh/packet_traverse.py binds them).
//
// Replaces the Pallas TPU kernels of tpt/bvh/pallas_traverse.py:
//   K2  tpt_packet_closest_hit_wide <- packet_closest_hit_wide (:893, :931)
//   K1  tpt_packet_any_hit_wide     <- packet_any_hit_wide     (:959, :985)
//   K8a tpt_packet_closest_hit      <- packet_closest_hit      (:350, :368)
//   K8b tpt_packet_any_hit          <- packet_any_hit          (:394, :405)
//
// Design. The TPU kernels walk one shared stack per 1024-ray packet,
// because Mosaic has no per-lane gather. A GPU thread can gather, so here
// each thread walks its own ray with its own stack in local memory (one
// thread per ray, 128 threads per block). One walk template serves both
// node layouts that tpt/bvh/pack.py builds; a layout gives the walk its
// child order, its cluster decode and its step cap.
//
// Wide layout (K1/K2; build_packet_bvh_wide):
//   node_f32   [Nt, W]  child s box at cols [6s, 6s+6)
//   node_child [Nt, 16] cols [0, A) child codes (>= 0 node, < -1 cluster
//                       -(start*256+count)-1, -1 empty), cols [8, 16) one
//                       packed near-to-far slot order per octant
// A popped node slab-tests its children in the ray's octant order and
// pushes the hit ones far to near, so the nearest is popped next.
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
// A popped cluster runs Moller-Trumbore over its triangles with a strict
// t < best. The arithmetic is the TPU kernels', operation for operation,
// and the library is compiled with -fmad=false so no multiply-add is
// contracted: the plain PyTorch version (packet_traverse.py) gives the
// same bits. The ray set-up and the triangle test live in ray_common.cuh,
// shared with the sweep and treelet kernels. A ray's slab arithmetic
// cannot make a NaN (its origin and direction are finite, the reciprocal
// is bounded, the boxes are finite), so fminf/fmaxf here give what
// NaN-propagating min/max give.
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
// What bounds it on this card: operations, not bytes. A ray reads 28 bytes
// and writes 16; the tables (9 MB wide, about twice the nodes binary, for
// the 139k-triangle bench interior) sit in the 50 MB L2, and the work is
// slab tests and triangle tests per ray, with divergence between the
// threads of a warp. Making it fast (shared-memory stack, warp-wide node
// fetch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define STACK_DEPTH 64
#define BLOCK 128
#define BIG 3.0e38f
#define MISS_T 3.4e38f

namespace {

__device__ __forceinline__ bool ray_finite(const Ray& r, float tm) {
  return isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz) &&
         isfinite(r.dx) && isfinite(r.dy) && isfinite(r.dz) && !isnan(tm);
}

// child AABB slab test against [0, limit] (pallas_traverse.py:_slab);
// *tn gets the entry t
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float limit, float* tn) {
  float t0x = (__ldg(b + 0) - r.ox) * r.ix;
  float t0y = (__ldg(b + 1) - r.oy) * r.iy;
  float t0z = (__ldg(b + 2) - r.oz) * r.iz;
  float t1x = (__ldg(b + 3) - r.ox) * r.ix;
  float t1y = (__ldg(b + 4) - r.oy) * r.iy;
  float t1z = (__ldg(b + 5) - r.oz) * r.iz;
  *tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
              fmaxf(fminf(t0z, t1z), 0.0f));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fminf(fmaxf(t0z, t1z), limit));
  return *tn <= tf;
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

// K1/K2: octant order, empty slots skipped, the same rule for both
struct Wide {
  static constexpr int kStepPad = 8192;

  // Pushes node `code`'s children that the ray hits within `limit`, far
  // to near, counting the slab tests in `slabs`. Returns false if a push
  // found the stack full.
  template <bool kAnyHit>
  static __device__ __forceinline__ bool push_children(
      const Tables& tb, int code, const Ray& r, float limit, int* stack,
      int& sp, unsigned long long& slabs) {
    const float* row = tb.node_f32 + (size_t)code * tb.node_width;
    const int* crow = tb.node_child + (size_t)code * 16;
    unsigned ordw = (unsigned)__ldg(crow + 8 + r.oct);
    bool ok = true;
    for (int pos = tb.arity - 1; pos >= 0; --pos) {
      int s = (ordw >> (4 * pos)) & 15;
      int c = __ldg(crow + s);
      if (c == -1) continue;
      ++slabs;
      float tn;
      if (!slab(row + 6 * s, r, limit, &tn)) continue;
      ok &= push(stack, sp, c);
    }
    return ok;
  }

  static __device__ __forceinline__ void cluster(const Tables& tb, int code,
                                                 int& start, int& count) {
    int v = -(code + 1);
    start = v >> 8;
    count = v & 255;
    if (start + count > tb.tri_rows) count = max(tb.tri_rows - start, 0);
  }
};

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

int tpt_packet_closest_hit_wide(TABLES_ARGS, float* t_out, int* tri_out,
                                float* u_out, float* v_out, int* capped,
                                unsigned long long* stats, void* stream) {
  return launch_closest<Wide>(ox, oy, oz, dx, dy, dz, tmax, n, TABLES, t_out,
                              tri_out, u_out, v_out, capped, stats, stream);
}

int tpt_packet_any_hit_wide(TABLES_ARGS, unsigned char* occ_out, int* capped,
                            unsigned long long* stats, void* stream) {
  return launch_any<Wide>(ox, oy, oz, dx, dy, dz, tmax, n, TABLES, occ_out,
                          capped, stats, stream);
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
