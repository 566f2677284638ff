// Dense treelet scan and demand sweep for NVIDIA Hopper (sm_90a), with a
// plain C interface for ctypes (tpt_torch/bvh/sweep.py binds them).
//
// Replaces the Pallas TPU kernels of tpt/bvh/pallas_sweep.py:
//   K3 tpt_dense_scan         <- dense_scan         (:337, :371)
//   K4 tpt_sweep8_closest_hit <- sweep8_closest_hit (:623, :696), demand
//                                mode, closest hit, no group culling
//
// K3, dense_scan_kernel. One thread per ray slab-tests every treelet box
// (SweepTables.boxes [T, 8]) and keeps its S nearest candidates in
// ascending (entry t, ordinal) order in registers, plus thr, the smallest
// entry t of every candidate it rejected or displaced. Every thread of a
// block reads the same box at the same time, so the boxes are staged in
// shared memory in tiles of SCAN_TILE boxes (24 KB), and any T fits.
// Bound: operations (T slab tests per ray; a ray reads 28 bytes and
// writes 8S+4). The arithmetic is the Pallas kernel's, operation for
// operation (pallas_sweep.py:278-322), with min/max that propagate NaN
// as jnp.minimum does: CUDA's fminf/fmaxf drop a NaN, which would give a
// ray with a NaN origin candidates that tpt never gives it.
//
// K4, sweep8_kernel. One block of 128 threads per 128 consecutive pool
// lanes, one thread per lane, as the Pallas kernel's [1, 128] block: a
// lane is tested against every treelet of its block's demand union, not
// only its own, and the raw result depends on the block (the pipeline's
// tail makes the final hits exact either way). The block walks the
// union in ascending ordinal: cur = the smallest ordinal > cur that some
// lane still demands (a slot k is demanded while entry_t[k] < the lane's
// best t), found by a warp shuffle reduction and a 4-warp step in shared
// memory, so cur is uniform and __syncthreads is safe. Each treelet's
// rows are staged in shared memory (9 of the 16 columns, tiles of
// SWEEP_TILE_ROWS rows) and every thread runs Moller-Trumbore over them
// in ascending row order, taking a hit only if t < best. Since
// sweep_tables lays treelets out by ascending ordinal, this serial first
// minimum is the smallest packed row among equal t, which is what the
// Pallas kernel's per-sublane reduction (:600-616) picks, so the two
// agree bit for bit. Bound: operations (rows x 128 lanes triangle tests
// per treelet of the union; the tables sit in the 50 MB L2).
//
// Both are simple kernels that are right; making them fast (warp-level
// candidate compaction, splitting large unions across blocks) is later
// work. Dead lanes (t_max <= 0) skip the arithmetic but take part in the
// block's barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

#define NONE_ORD 0x7FFFFF
#define SCAN_BLOCK 128
#define SCAN_TILE 1024        // boxes per shared tile: 1024 x 6 x 4 B = 24 KB
#define SCAN_INF 3.0e38f      // pallas_sweep.py _INF
#define SWEEP_LANES 128
#define SWEEP_WARPS (SWEEP_LANES / 32)
#define SWEEP_TILE_ROWS 256   // rows per shared tile: 256 x 9 x 4 B = 9 KB
#define MISS_T 3.4e38f        // FLT_MAX of tpt/integrators/intersect.py
#define MAX_SLOTS 8

namespace {

// min/max that return NaN when either operand is NaN (jnp.minimum)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int S>
__global__ void __launch_bounds__(SCAN_BLOCK) dense_scan_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, const float* __restrict__ boxes,
    int T, float* __restrict__ st_out, int* __restrict__ so_out,
    float* __restrict__ thr_out, unsigned long long* __restrict__ stats) {
  __shared__ float sbox[SCAN_TILE * 6];
  const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
  const bool in = i < n;
  Ray r{};
  float bt = 0.0f;
  if (in) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    float tm = tmax[i];
    tm = tm > 0.0f ? tm : 0.0f;
    bt = nmin(tm, SCAN_INF);
  }
  // a ray with bt = 0 can have no candidate: tn >= 0 (or NaN) < 0 fails
  const bool live = bt > 0.0f;
  if (stats) {
    int nlive = __syncthreads_count(live);
    if (threadIdx.x == 0)
      atomicAdd(stats, (unsigned long long)nlive * (unsigned long long)T);
  }
  float st[S];
  int so[S];
#pragma unroll
  for (int k = 0; k < S; ++k) { st[k] = SCAN_INF; so[k] = NONE_ORD; }
  float thr = SCAN_INF;

  for (int base = 0; base < T; base += SCAN_TILE) {
    const int cnt = min(SCAN_TILE, T - base);
    __syncthreads();  // the previous tile's readers are done
    for (int k = threadIdx.x; k < cnt * 6; k += SCAN_BLOCK)
      sbox[k] = boxes[(size_t)(base + k / 6) * 8 + k % 6];
    __syncthreads();
    if (!live) continue;
    for (int b = 0; b < cnt; ++b) {
      const float* bx = sbox + 6 * b;
      float t0x = (bx[0] - r.ox) * r.ix;
      float t0y = (bx[1] - r.oy) * r.iy;
      float t0z = (bx[2] - r.oz) * r.iz;
      float t1x = (bx[3] - r.ox) * r.ix;
      float t1y = (bx[4] - r.oy) * r.iy;
      float t1z = (bx[5] - r.oz) * r.iz;
      float tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
                      nmax(nmin(t0z, t1z), 0.0f));
      float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                      nmin(nmax(t0z, t1z), bt));
      if (!(tn <= tf && tn < bt)) continue;
      if (!(tn <= st[S - 1])) {  // rejected: the slots hold S nearer
        thr = nmin(thr, tn);
        continue;
      }
      // insert (tn, ordinal) in lex order; the displaced entry falls out
      float ct = tn;
      int co = base + b;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        bool swap = ct < st[k] || (ct == st[k] && co < so[k]);
        float tt = swap ? st[k] : ct;
        int oo = swap ? so[k] : co;
        st[k] = swap ? ct : st[k];
        so[k] = swap ? co : so[k];
        ct = tt;
        co = oo;
      }
      if (co != NONE_ORD) thr = nmin(thr, ct);
    }
  }
  if (!in) return;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    st_out[(size_t)k * n + i] = st[k];
    so_out[(size_t)k * n + i] = so[k];
  }
  thr_out[i] = thr;
}

// block-wide min of v; cur is the same for every thread of the block
__device__ __forceinline__ int block_min(int v, int* swarp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // earlier readers of swarp are done
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = swarp[0];
#pragma unroll
  for (int w = 1; w < SWEEP_WARPS; ++w) m = min(m, swarp[w]);
  return m;
}

template <int S>
__global__ void __launch_bounds__(SWEEP_LANES) sweep8_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, const int* __restrict__ ord,
    const float* __restrict__ entry, const int* __restrict__ ranges,
    const float* __restrict__ tri, int rows_per_chunk,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    unsigned long long* __restrict__ stats) {
  __shared__ float srow[SWEEP_TILE_ROWS * 9];
  __shared__ int swarp[SWEEP_WARPS];
  const int i = blockIdx.x * SWEEP_LANES + threadIdx.x;
  const bool in = i < n;
  Ray r{};
  float tm = 0.0f;
  int o[S];
  float e[S];
#pragma unroll
  for (int k = 0; k < S; ++k) { o[k] = NONE_ORD; e[k] = SCAN_INF; }
  if (in) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    const float raw = tmax[i];
    // dead lanes (t_max <= 0 or NaN) demand nothing (pallas_sweep.py:673)
    const bool alive = raw > 0.0f;
    tm = alive ? raw : 0.0f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      o[k] = alive ? ord[(size_t)k * n + i] : NONE_ORD;
      e[k] = entry[(size_t)k * n + i];
    }
  }
  float bt = fminf(tm, MISS_T);  // tm is >= 0, never NaN
  const bool live = bt > 0.0f;
  int brow = -1;
  float bu = 0.0f, bv = 0.0f;
  unsigned long long sweeps = 0, rows_swept = 0;
  int cur = -1;
  while (true) {
    int mine = NONE_ORD;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (o[k] > cur && e[k] < bt) mine = min(mine, o[k]);
    cur = block_min(mine, swarp);
    if (cur >= NONE_ORD) break;
    const int start = ranges[2 * cur];
    const int nrows = ranges[2 * cur + 1] * rows_per_chunk;
    ++sweeps;
    rows_swept += nrows;
    for (int base = 0; base < nrows; base += SWEEP_TILE_ROWS) {
      const int cnt = min(SWEEP_TILE_ROWS, nrows - base);
      __syncthreads();  // the previous tile's readers are done
      for (int k = threadIdx.x; k < cnt * 9; k += SWEEP_LANES)
        srow[k] = tri[(size_t)(start + base + k / 9) * 16 + k % 9];
      __syncthreads();
      if (!live) continue;
      for (int q = 0; q < cnt; ++q) {
        const float* w = srow + 9 * q;
        float t, u, v;
        if (mt_tri(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], r,
                   &t, &u, &v) &&
            t < bt) {
          bt = t;
          brow = start + base + q;
          bu = u;
          bv = v;
        }
      }
    }
  }
  if (stats) {
    int nlive = __syncthreads_count(live);
    if (threadIdx.x == 0) {
      atomicAdd(stats + 0, sweeps);
      atomicAdd(stats + 1, rows_swept * (unsigned long long)nlive);
      atomicAdd(stats + 2, (unsigned long long)nlive);
    }
  }
  if (!in) return;
  const bool found = brow >= 0;
  t_out[i] = found ? bt : MISS_T;
  tri_out[i] = found ? (int)tri[(size_t)brow * 16 + 9] : -1;
  u_out[i] = found ? bu : 0.0f;
  v_out[i] = found ? bv : 0.0f;
}

template <int S>
int launch_scan(const float* ox, const float* oy, const float* oz,
                const float* dx, const float* dy, const float* dz,
                const float* tmax, int n, const float* boxes, int T,
                float* st, int* so, float* thr, unsigned long long* stats,
                cudaStream_t stream) {
  dense_scan_kernel<S><<<(n + SCAN_BLOCK - 1) / SCAN_BLOCK, SCAN_BLOCK, 0,
                         stream>>>(ox, oy, oz, dx, dy, dz, tmax, n, boxes, T,
                                   st, so, thr, stats);
  return (int)cudaGetLastError();
}

template <int S>
int launch_sweep(const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz,
                 const float* tmax, int n, const int* ord, const float* entry,
                 const int* ranges, const float* tri, int rows_per_chunk,
                 float* t, int* tri_id, float* u, float* v,
                 unsigned long long* stats, cudaStream_t stream) {
  sweep8_kernel<S><<<(n + SWEEP_LANES - 1) / SWEEP_LANES, SWEEP_LANES, 0,
                     stream>>>(ox, oy, oz, dx, dy, dz, tmax, n, ord, entry,
                               ranges, tri, rows_per_chunk, t, tri_id, u, v,
                               stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpt_sweep_max_slots() { return MAX_SLOTS; }

// All pointers are device pointers; `stream` is a cudaStream_t. Slot
// planes are [S, n] row-major. `stats`, if not null, accumulates the slab
// tests of live rays. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for S outside 1..MAX_SLOTS.
int tpt_dense_scan(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const float* tmax, int n, const float* boxes, int T, int S,
                   float* st, int* so, float* thr, unsigned long long* stats,
                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SCAN_CASE(K)                                                      \
  case K:                                                                 \
    return launch_scan<K>(ox, oy, oz, dx, dy, dz, tmax, n, boxes, T, st,  \
                          so, thr, stats, s);
  switch (S) {
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(3) SCAN_CASE(4)
    SCAN_CASE(5) SCAN_CASE(6) SCAN_CASE(7) SCAN_CASE(8)
  }
#undef SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

// `stats`, if not null, accumulates (treelet sweeps summed over blocks,
// triangle tests of live lanes, live lanes).
int tpt_sweep8_closest_hit(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmax, int n, int S, const int* ord,
                           const float* entry, const int* ranges,
                           const float* tri, int rows_per_chunk, float* t,
                           int* tri_id, float* u, float* v,
                           unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SWEEP_CASE(K)                                                      \
  case K:                                                                  \
    return launch_sweep<K>(ox, oy, oz, dx, dy, dz, tmax, n, ord, entry,    \
                           ranges, tri, rows_per_chunk, t, tri_id, u, v,   \
                           stats, s);
  switch (S) {
    SWEEP_CASE(1) SWEEP_CASE(2) SWEEP_CASE(3) SWEEP_CASE(4)
    SWEEP_CASE(5) SWEEP_CASE(6) SWEEP_CASE(7) SWEEP_CASE(8)
  }
#undef SWEEP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
