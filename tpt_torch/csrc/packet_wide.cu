// Wide-BVH traversal kernels for NVIDIA Hopper (sm_90a), with a plain C
// interface for ctypes (tpt_torch/bvh/packet_traverse.py binds them).
//
// Replaces the Pallas TPU kernels of tpt/bvh/pallas_traverse.py:
//   K2 tpt_packet_closest_hit_wide <- packet_closest_hit_wide (:893, :931)
//   K1 tpt_packet_any_hit_wide     <- packet_any_hit_wide     (:959, :985)
//
// Design. The TPU kernel walks one shared stack per 1024-ray packet,
// because Mosaic has no per-lane gather. A GPU thread can gather, so here
// each thread walks its own ray with its own stack in local memory (one
// thread per ray, 128 threads per block), over the SAME tables that
// tpt/bvh/pack.py:build_packet_bvh_wide builds:
//   node_f32   [Nt, W]  child s box at cols [6s, 6s+6)
//   node_child [Nt, 16] cols [0, A) child codes (>= 0 node, < -1 cluster
//                       -(start*256+count)-1, -1 empty), cols [8, 16) one
//                       packed near-to-far slot order per octant
//   tri_f32    [Tp, 16] v0, e1, e2, triangle id (col 9)
// A popped node slab-tests its children in the ray's octant order and
// pushes the hit ones far to near, so the nearest is popped next; a popped
// cluster runs Moller-Trumbore over its triangles. The arithmetic is the
// TPU kernel's, operation for operation, and the library is compiled with
// -fmad=false so no multiply-add is contracted: the plain PyTorch version
// (packet_traverse.py) gives the same bits. The ray set-up and the
// triangle test live in ray_common.cuh, shared with the sweep kernels.
//
// Bounds. Per ray: a stack of STACK_DEPTH entries and at most
// 8 * num_nodes + 8192 pops (the TPU kernel's own cap,
// pallas_traverse.py:567). A ray whose push finds the stack full (the push
// is dropped) or that reaches the cap stops being exact and is counted
// once in *capped, so no input can hang the card and none can go wrong
// unseen. Rays with a NaN or infinite origin or direction, or a NaN t_max,
// miss without traversal.
//
// What bounds it on this card: operations, not bytes. A ray reads 28 bytes
// and writes 16; the tables (9 MB for the 139k-triangle bench interior)
// sit in the 50 MB L2, and the work is slab tests and triangle tests per
// ray, with divergence between the threads of a warp. Rays arrive
// coherence-sorted from the integrator, which keeps warps on similar
// paths. Making it fast (shared-memory stack, warp-wide node fetch) is
// later work.

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

// child AABB slab test against [0, limit] (pallas_traverse.py:_slab)
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float limit) {
  float t0x = (__ldg(b + 0) - r.ox) * r.ix;
  float t0y = (__ldg(b + 1) - r.oy) * r.iy;
  float t0z = (__ldg(b + 2) - r.oz) * r.iz;
  float t1x = (__ldg(b + 3) - r.ox) * r.ix;
  float t1y = (__ldg(b + 4) - r.oy) * r.iy;
  float t1z = (__ldg(b + 5) - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                   fmaxf(fminf(t0z, t1z), 0.0f));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fminf(fmaxf(t0z, t1z), limit));
  return tn <= tf;
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
};

// Pops node `code`'s children that the ray hits within `limit` onto the
// stack, far to near, counting the slab tests done in `slabs`. Returns
// false if a push found the stack full.
__device__ __forceinline__ bool push_children(const Tables& tb, int code,
                                              const Ray& r, float limit,
                                              int* stack, int& sp,
                                              unsigned long long& slabs) {
  const float* row = tb.node_f32 + (size_t)code * tb.node_width;
  const int* crow = tb.node_child + (size_t)code * 16;
  unsigned ordw = (unsigned)__ldg(crow + 8 + r.oct);
  bool ok = true;
  for (int pos = tb.arity - 1; pos >= 0; --pos) {
    int s = (ordw >> (4 * pos)) & 15;
    int c = __ldg(crow + s);
    if (c == -1) continue;
    ++slabs;
    if (!slab(row + 6 * s, r, limit)) continue;
    if (sp < STACK_DEPTH) stack[sp++] = c;
    else ok = false;
  }
  return ok;
}

__device__ __forceinline__ void cluster_range(const Tables& tb, int code,
                                              int& start, int& count) {
  int v = -(code + 1);
  start = v >> 8;
  count = v & 255;
  if (start + count > tb.tri_rows) count = max(tb.tri_rows - start, 0);
}

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
  const int max_steps = 8 * tb.num_nodes + 8192;
  int steps = 0;
  bool exact = true;
  unsigned long long node_visits = 0, slab_tests = 0, tri_tests = 0;
  while (sp > 0) {
    if (steps >= max_steps) { exact = false; break; }
    ++steps;
    int code = stack[--sp];
    if (code >= 0) {
      ++node_visits;
      exact &= push_children(tb, code, r, bt, stack, sp, slab_tests);
    } else {
      int start, count;
      cluster_range(tb, code, start, count);
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
  // dead lanes (limit <= 0) report occluded, as the TPU kernel does
  bool occ = limit <= 0.0f;
  int stack[STACK_DEPTH];
  int sp = 0;
  if (ray_finite(r, tm) && !occ) stack[sp++] = 0;
  const int max_steps = 8 * tb.num_nodes + 8192;
  int steps = 0;
  bool exact = true;
  unsigned long long node_visits = 0, slab_tests = 0, tri_tests = 0;
  while (sp > 0) {
    if (steps >= max_steps) { exact = false; break; }
    ++steps;
    int code = stack[--sp];
    if (code >= 0) {
      ++node_visits;
      exact &= push_children(tb, code, r, limit, stack, sp, slab_tests);
    } else {
      int start, count;
      cluster_range(tb, code, start, count);
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

}  // namespace

extern "C" {

int tpt_stack_depth() { return STACK_DEPTH; }

// All pointers are device pointers; `stream` is a cudaStream_t. `stats`,
// if not null, accumulates (node visits, slab tests, triangle tests).
// Returns cudaGetLastError() after the launch (0 = launched).
int tpt_packet_closest_hit_wide(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, int n,
    const float* node_f32, int node_width, const int* node_child,
    int num_nodes, const float* tri_f32, int tri_rows, int arity,
    float* t_out, int* tri_out, float* u_out, float* v_out, int* capped,
    unsigned long long* stats, void* stream) {
  Tables tb{node_f32, node_width, node_child, num_nodes, tri_f32, tri_rows,
            arity};
  if (n > 0) {
    closest_hit_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                         (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, tb, t_out, tri_out, u_out, v_out,
        capped, stats);
  }
  return (int)cudaGetLastError();
}

int tpt_packet_any_hit_wide(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, int n,
    const float* node_f32, int node_width, const int* node_child,
    int num_nodes, const float* tri_f32, int tri_rows, int arity,
    unsigned char* occ_out, int* capped, unsigned long long* stats,
    void* stream) {
  Tables tb{node_f32, node_width, node_child, num_nodes, tri_f32, tri_rows,
            arity};
  if (n > 0) {
    any_hit_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                     (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, tb, occ_out, capped, stats);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
