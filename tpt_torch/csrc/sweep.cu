// Dense treelet scan and demand sweeps for NVIDIA Hopper (sm_90a), with a
// plain C interface for ctypes (tpt_torch/bvh/sweep.py binds them).
//
// Replaces the Pallas TPU kernels of tpt/bvh/pallas_sweep.py:
//   K3 tpt_dense_scan         <- dense_scan         (:337, :371)
//   K4 tpt_sweep8_closest_hit <- sweep8_closest_hit (:623, :696): demand
//                                closest hit, any-hit and group modes
//   K7 tpt_sweep_closest_hit  <- sweep_closest_hit  (:168, :216): demand
//                                or not, closest hit or any-hit
//
// K3, dense_scan_kernel. Each thread carries SCAN_RAYS rays and
// slab-tests every treelet box (SweepTables.boxes [T, 8]) against each,
// keeping for each ray its S nearest candidates in ascending (entry t,
// ordinal) order in registers, plus thr, the smallest entry t of every
// candidate it rejected or displaced. Bound: operations (T slab tests a
// ray: 6 sub, 6 mul, 12 min/max, compares; a ray reads 28 bytes and
// writes 8S+4). So the design spends as few instructions as it can
// beside those: every thread of a block reads the same box at the same
// time, so the boxes are staged in shared memory, 1024 a tile (32 KB, any
// T fits), each as the two float4 of its [8]-float row, and read with two
// 128-bit broadcast loads that serve all SCAN_RAYS rays of the thread;
// min/max are one instruction each (ray_common.cuh: PTX min.NaN/max.NaN,
// which propagate NaN as jnp.minimum does, so a ray with a NaN origin
// gets no candidate). A ray slot whose lanes are dead across the whole
// warp skips the arithmetic. The arithmetic is the Pallas kernel's,
// operation for operation (pallas_sweep.py:278-322).
//
// K4 and K7, sweep_kernel. One block per LANES consecutive pool lanes,
// one thread per lane: 128 for K4 (the Pallas kernel's [1, 128] block),
// 1024 for K7 (its [8, 128] block). The contract is tpt's: a lane is
// tested against its block's demand union, not only its own treelets, so
// the raw result depends on the block (the pipeline's tail makes the
// final hits exact either way). The block walks the union in ascending
// ordinal: cur = the smallest ordinal > cur that some lane still demands
// (slot k is demanded while entry_t[k] is below the lane's budget, its
// best t; without entry planes every requested slot is), found by a warp
// shuffle reduction and a step over the warps in shared memory, so cur is
// uniform and __syncthreads is safe.
//   Bound: operations, the Moller-Trumbore tests the contract prescribes:
// every live lane tests every row of every treelet of its block's union,
// as tpt's sweep8_closest_hit without groups and its sweep_closest_hit
// do. No box can stand in for those tests. A slab test of a box that
// holds a triangle is no bound on the t that mt_tri computes for it: on a
// ray nearly parallel to the triangle's plane, det is a difference of
// products of float32 values whose rounding (about 2^-24 of |e1||d||e2|
// each) is of the size of det itself, while mt_tri only asks |det| >
// 1e-9; t, u and v then carry errors of any size, and mt_tri accepts
// points far outside the triangle. One float32 case (tests/
// test_torch_flatgroup.py): mt_tri takes a triangle at t = 0.0696 where
// the ray enters its box, padded as group_boxes pads, at t = 0.249; a
// search over grazing rays finds such cases for every relative slack on
// the limit up to 10%. Even a flat group at coordinate 0 (a pad of
// 1e-30 in that axis) lets the slab's entry t round above mt_tri's t, by
// 2 ulp on a ray at 10 degrees to the plane (the same file). So a group
// box missed at the lane's best t proves nothing, and the kernels cull no
// row: culling each warp's rows by group boxes returned another hit than
// the plain sweep on such inputs. K4's group mode keeps tpt's own window
// (pallas_sweep.py:542-580): every lane of the block, dead and padded
// ones too, slab-tests the treelet's 8 group boxes at its best t, and the
// block sweeps the rows from the first group some lane enters to the
// last, the groups between included. That is tpt's result, not the
// unculled one, wherever tpt's window drops a hit.
// Rows go to shared memory with cp.async (3 x 16 bytes, the 9 floats of
// a row and its id), in two buffers of SWEEP_TILE_ROWS rows: the next
// tile loads while the current one is tested; a warp without a live lane
// skips the tests. A lane tests its rows in ascending packed row and
// takes a hit only if t < best; since sweep_tables lays treelets out by
// ascending ordinal, this serial first minimum is the smallest packed row
// among equal t, which K7's serial scan (:118-131) and K4's per-sublane
// reduction (:600-616) pick too, so kernel and Pallas kernel agree bit
// for bit.
//   Any-hit mode: after each treelet a lane with a hit before
// t_max - 1e-3 sets its budget to -3.4e38, so it demands nothing more;
// it keeps testing the rows its block sweeps, as tpt's lane does.
//
// Dead lanes (t_max <= 0) skip the arithmetic but take part in the
// block's barriers.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ray_common.cuh"

#define NONE_ORD 0x7FFFFF
#define SCAN_BLOCK 128
// rays a K3 thread carries: 1, 2 and 4 ran within a few percent of each
// other on an H100 (the min/max bound K3, not the box loads)
#define SCAN_RAYS 2
#define SCAN_TILE 1024        // boxes per shared tile: 1024 x 32 B = 32 KB
#define SCAN_INF 3.0e38f      // pallas_sweep.py _INF
#define SWEEP8_LANES 128      // K4's block: tpt's [1, 128] tile
#define SWEEP_LANES 1024      // K7's block: tpt's [8, 128] tile
#define SWEEP_TILE_ROWS 128   // rows per shared tile: 128 x 48 B = 6 KB
#define MISS_T 3.4e38f        // FLT_MAX of tpt/integrators/intersect.py
#define MAX_SLOTS 8
#define GROUPS 8              // group boxes a treelet (SweepTables.group_boxes)
#define FULL_MASK 0xffffffffu

namespace {

// one slab test of box (lo.xyz, (lo.w, hi.x, hi.y)) against a ray at
// limit `bt`: (entry t, exit t); the box is entered iff tn <= tf
__device__ __forceinline__ void slab(float4 lo, float4 hi, float ox,
                                     float oy, float oz, float ix, float iy,
                                     float iz, float bt, float* tn,
                                     float* tf) {
  const float t0x = (lo.x - ox) * ix;
  const float t0y = (lo.y - oy) * iy;
  const float t0z = (lo.z - oz) * iz;
  const float t1x = (lo.w - ox) * ix;
  const float t1y = (hi.x - oy) * iy;
  const float t1z = (hi.y - oz) * iz;
  *tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
             nmax(nmin(t0z, t1z), 0.0f));
  *tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
             nmin(nmax(t0z, t1z), bt));
}

// K3's slot insert: (tn, ordinal) into S slots in (t, ordinal) order; the
// displaced or rejected entry lowers thr
template <int S>
__device__ __forceinline__ void insert(float (&st)[S], int (&so)[S],
                                       float& thr, float tn, int ordinal) {
  if (!(tn <= st[S - 1])) {  // rejected: the slots hold S nearer
    thr = nmin(thr, tn);
    return;
  }
  float ct = tn;
  int co = ordinal;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool swap = ct < st[k] || (ct == st[k] && co < so[k]);
    const float tt = swap ? st[k] : ct;
    const int oo = swap ? so[k] : co;
    st[k] = swap ? ct : st[k];
    so[k] = swap ? co : so[k];
    ct = tt;
    co = oo;
  }
  if (co != NONE_ORD) thr = nmin(thr, ct);
}

// rays of a K3 block: lane j of thread x is pool lane
// blockIdx.x * SCAN_BLOCK * R + j * SCAN_BLOCK + x (coalesced loads and
// stores)
template <int S, int R>
__global__ void __launch_bounds__(SCAN_BLOCK) dense_scan_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, const float4* __restrict__ boxes,
    int T, float* __restrict__ st_out, int* __restrict__ so_out,
    float* __restrict__ thr_out, unsigned long long* __restrict__ stats) {
  __shared__ float4 sbox[2 * SCAN_TILE];
  const int first = blockIdx.x * (SCAN_BLOCK * R) + threadIdx.x;
  float rox[R], roy[R], roz[R], rix[R], riy[R], riz[R], bt[R], thr[R];
  float st[R][S];
  int so[R][S];
  unsigned warp_live = 0;  // bit j: some lane of the warp has ray j live
  int nlive = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = first + j * SCAN_BLOCK;
    rox[j] = roy[j] = roz[j] = rix[j] = riy[j] = riz[j] = 0.0f;
    bt[j] = 0.0f;
    if (i < n) {
      const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      rox[j] = r.ox; roy[j] = r.oy; roz[j] = r.oz;
      rix[j] = r.ix; riy[j] = r.iy; riz[j] = r.iz;
      float tm = tmax[i];
      tm = tm > 0.0f ? tm : 0.0f;
      bt[j] = nmin(tm, SCAN_INF);
    }
    // a ray with bt = 0 can have no candidate: tn >= 0 (or NaN) < 0 fails
    const bool live = bt[j] > 0.0f;
    nlive += live;
    if (__any_sync(FULL_MASK, live)) warp_live |= 1u << j;
    thr[j] = SCAN_INF;
#pragma unroll
    for (int k = 0; k < S; ++k) { st[j][k] = SCAN_INF; so[j][k] = NONE_ORD; }
  }
  if (stats) {
    const int w = __reduce_add_sync(FULL_MASK, nlive);
    if ((threadIdx.x & 31) == 0 && w)
      atomicAdd(stats, (unsigned long long)w * (unsigned long long)T);
  }

  for (int base = 0; base < T; base += SCAN_TILE) {
    const int cnt = min(SCAN_TILE, T - base);
    __syncthreads();  // the previous tile's readers are done
    for (int k = threadIdx.x; k < 2 * cnt; k += SCAN_BLOCK)
      sbox[k] = __ldg(boxes + 2 * (size_t)base + k);
    __syncthreads();
    if (!warp_live) continue;
    for (int b = 0; b < cnt; ++b) {
      const float4 lo = sbox[2 * b], hi = sbox[2 * b + 1];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!(warp_live >> j & 1u)) continue;  // uniform over the warp
        float tn, tf;
        slab(lo, hi, rox[j], roy[j], roz[j], rix[j], riy[j], riz[j], bt[j],
             &tn, &tf);
        if (tn <= tf && tn < bt[j]) insert<S>(st[j], so[j], thr[j], tn,
                                              base + b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = first + j * SCAN_BLOCK;
    if (i >= n) continue;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      st_out[(size_t)k * n + i] = st[j][k];
      so_out[(size_t)k * n + i] = so[j][k];
    }
    thr_out[i] = thr[j];
  }
}

// block-wide min of v over LANES threads; the result is the same for
// every thread of the block
template <int LANES>
__device__ __forceinline__ int block_min(int v, int* swarp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(FULL_MASK, v, off));
  __syncthreads();  // earlier readers of swarp are done
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = swarp[0];
#pragma unroll
  for (int w = 1; w < LANES / 32; ++w) m = min(m, swarp[w]);
  return m;
}

// 16 bytes global -> shared without a register round trip (cp.async.cg:
// cached in L2 only); a host compile (a CPU emulation) copies directly
__device__ __forceinline__ void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}
__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// stage tile k of `total` rows from `rows` (rows k*SWEEP_TILE_ROWS.. in
// order): one row a thread, as one copy group
__device__ __forceinline__ void stage_rows(float4* dst, const float* rows,
                                           int k, int total) {
  const int v = k * SWEEP_TILE_ROWS + (int)threadIdx.x;
  if (threadIdx.x < SWEEP_TILE_ROWS && v < total) {
    const float* src = rows + (size_t)v * 16;
    dst += 3 * threadIdx.x;
    copy16(dst, src);
    copy16(dst + 1, src + 4);
    copy16(dst + 2, src + 8);
  }
  copy_commit();
}

// the ray of a lane past n: tpt pads its tiles with zero origins and
// directions and t_max 0 (pallas_sweep.py:_tile)
__device__ __forceinline__ Ray pad_ray() {
  Ray r{};
  r.ix = r.iy = r.iz = safe_inv(0.0f);
  r.oct = 7;
  return r;
}

// K4 and K7: the demand sweep over blocks of LANES consecutive lanes.
// `entry` null sweeps every requested ordinal (no demand drop);
// `any_hit` drops a lane's remaining demand once it holds a hit before
// t_max - 1e-3; `gbox` (SweepTables.group_boxes, null for none) is K4's
// group mode: each treelet's rows are cut to tpt's window of groups of
// group_rows rows.
template <int S, int LANES>
__global__ void __launch_bounds__(LANES) sweep_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, const int* __restrict__ ord,
    const float* __restrict__ entry, const int* __restrict__ ranges,
    const float* __restrict__ tri, int rows_per_chunk, int any_hit,
    const float4* __restrict__ gbox, int group_rows,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    unsigned long long* __restrict__ stats) {
  // a row: (v0x v0y v0z e1x) (e1y e1z e2x e2y) (e2z id - -)
  __shared__ float4 srow[2][SWEEP_TILE_ROWS * 3];
  __shared__ int swarp[LANES / 32];
  __shared__ unsigned smask[LANES / 32];
  const int i = blockIdx.x * LANES + threadIdx.x;
  const bool in = i < n;
  const Ray r = in ? load_ray(ox, oy, oz, dx, dy, dz, i) : pad_ray();
  float tm = 0.0f;
  int o[S];
  float e[S];
#pragma unroll
  for (int k = 0; k < S; ++k) { o[k] = NONE_ORD; e[k] = SCAN_INF; }
  if (in) {
    const float raw = tmax[i];
    // dead lanes (t_max <= 0 or NaN) demand nothing (pallas_sweep.py:673)
    const bool alive = raw > 0.0f;
    tm = alive ? raw : 0.0f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      o[k] = alive ? ord[(size_t)k * n + i] : NONE_ORD;
      if (entry) e[k] = entry[(size_t)k * n + i];
    }
  }
  float bt = fminf(tm, MISS_T);  // tm is >= 0, never NaN
  const bool live = bt > 0.0f;
  float budget = bt;             // what the demand test holds entries to
  int brow = -1;
  float bu = 0.0f, bv = 0.0f;
  unsigned long long sweeps = 0, tested = 0;
  int cur = -1;
  while (true) {
    int mine = NONE_ORD;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (o[k] > cur && (!entry || e[k] < budget)) mine = min(mine, o[k]);
    cur = block_min<LANES>(mine, swarp);
    if (cur >= NONE_ORD) break;
    ++sweeps;
    const int start = ranges[2 * cur];
    const int nrows = ranges[2 * cur + 1] * rows_per_chunk;
    int lo = 0, hi = nrows;
    if (gbox) {
      // tpt's window: the groups every lane enters at its best t, dead
      // and padded lanes too (pallas_sweep.py:542-580)
      unsigned m = 0;
      const float4* gb = gbox + (size_t)cur * 2 * GROUPS;
      for (int g = 0; g < GROUPS; ++g) {
        float tn, tf;
        slab(__ldg(gb + 2 * g), __ldg(gb + 2 * g + 1), r.ox, r.oy, r.oz,
             r.ix, r.iy, r.iz, bt, &tn, &tf);
        if (tn <= tf) m |= 1u << g;
      }
      const unsigned wm = __reduce_or_sync(FULL_MASK, m);
      if ((threadIdx.x & 31) == 0) smask[threadIdx.x >> 5] = wm;
      __syncthreads();
      unsigned bm = 0;
#pragma unroll
      for (int w = 0; w < LANES / 32; ++w) bm |= smask[w];
      // smask is written again only after the next block_min's barriers
      lo = bm ? (__ffs(bm) - 1) * group_rows : 0;
      hi = bm ? min((32 - __clz(bm)) * group_rows, nrows) : 0;
    }
    const int total = max(hi - lo, 0);
    const int ntiles = (total + SWEEP_TILE_ROWS - 1) / SWEEP_TILE_ROWS;
    const float* rows = tri + (size_t)(start + lo) * 16;
    if (ntiles > 0) stage_rows(srow[0], rows, 0, total);
    for (int k = 0; k < ntiles; ++k) {
      if (k + 1 < ntiles) {
        stage_rows(srow[(k + 1) & 1], rows, k + 1, total);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();  // tile k is in shared memory for every thread
      const int tb = k * SWEEP_TILE_ROWS;
      const int te = min(tb + SWEEP_TILE_ROWS, total);
      const float4* buf = srow[k & 1];
      if (live) {
        tested += te - tb;
        for (int v = tb; v < te; ++v) {
          const float4* w = buf + 3 * (v - tb);
          const float4 p = w[0], q = w[1], s = w[2];
          float t, u, vv;
          if (mt_tri(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, s.x, r, &t, &u,
                     &vv) &&
              t < bt) {
            bt = t;
            brow = start + lo + v;
            bu = u;
            bv = vv;
          }
        }
      }
      // the buffer read here is refilled two tiles on
      if (k + 2 < ntiles) __syncthreads();
    }
    // an occluded lane (a hit before t_max - 1e-3) demands nothing more
    // but keeps testing the rows its block sweeps (pallas_sweep.py:136-141,
    // :587-594)
    budget = (any_hit && bt < tm - 1e-3f) ? -MISS_T : bt;
  }
  if (stats) {
    unsigned long long w = tested;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w += __shfl_xor_sync(FULL_MASK, w, off);
    const int nl = __popc(__ballot_sync(FULL_MASK, live));
    if ((threadIdx.x & 31) == 0) {
      if (w) atomicAdd(stats + 1, w);
      if (nl) atomicAdd(stats + 2, (unsigned long long)nl);
    }
    if (threadIdx.x == 0) atomicAdd(stats + 0, sweeps);
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
  const int per_block = SCAN_BLOCK * SCAN_RAYS;
  dense_scan_kernel<S, SCAN_RAYS><<<(n + per_block - 1) / per_block,
                                    SCAN_BLOCK, 0, stream>>>(
      ox, oy, oz, dx, dy, dz, tmax, n, (const float4*)boxes, T, st, so, thr,
      stats);
  return (int)cudaGetLastError();
}

struct SweepArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  int n;
  const int* ord;
  const float* entry;
  const int* ranges;
  const float* tri;
  int rows_per_chunk, any_hit;
  const float* gbox;
  int chunk_align;
  float* t;
  int* tri_id;
  float *u, *v;
  unsigned long long* stats;
};

template <int S, int LANES>
int launch_sweep(const SweepArgs& a, cudaStream_t stream) {
  sweep_kernel<S, LANES><<<(a.n + LANES - 1) / LANES, LANES, 0, stream>>>(
      a.ox, a.oy, a.oz, a.dx, a.dy, a.dz, a.tmax, a.n, a.ord, a.entry,
      a.ranges, a.tri, a.rows_per_chunk, a.any_hit, (const float4*)a.gbox,
      a.chunk_align * a.rows_per_chunk, a.t, a.tri_id, a.u, a.v, a.stats);
  return (int)cudaGetLastError();
}

template <int LANES>
int sweep_slots(int S, const SweepArgs& a, cudaStream_t s) {
  if (a.gbox && a.chunk_align <= 0) return (int)cudaErrorInvalidValue;
#define SWEEP_CASE(K) \
  case K:             \
    return launch_sweep<K, LANES>(a, s);
  switch (S) {
    SWEEP_CASE(1) SWEEP_CASE(2) SWEEP_CASE(3) SWEEP_CASE(4)
    SWEEP_CASE(5) SWEEP_CASE(6) SWEEP_CASE(7) SWEEP_CASE(8)
  }
#undef SWEEP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int tpt_sweep_max_slots() { return MAX_SLOTS; }

// All pointers are device pointers, the tables' 16-byte aligned;
// `stream` is a cudaStream_t. Slot planes are [S, n] row-major. `stats`,
// if not null, accumulates the slab tests of live rays. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for S outside 1..MAX_SLOTS.
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

// K4 (128-lane blocks) and K7 (1024-lane blocks). `entry` null: every
// requested ordinal is swept; `any_hit` nonzero: the any-hit demand
// drop; `gbox` non-null: K4's group mode, tpt's window of groups of
// `chunk_align` chunks (null: every warp with a live lane sweeps every
// row of the union). `stats`, if not null, accumulates (treelet sweeps summed
// over blocks, triangle tests made by live lanes, live lanes).
int tpt_sweep8_closest_hit(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmax, int n, int S, const int* ord,
                           const float* entry, const int* ranges,
                           const float* tri, int rows_per_chunk, int any_hit,
                           const float* gbox, int chunk_align, float* t,
                           int* tri_id, float* u, float* v,
                           unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  SweepArgs a{ox, oy, oz, dx, dy, dz, tmax, n, ord, entry, ranges, tri,
              rows_per_chunk, any_hit, gbox, chunk_align, t, tri_id, u, v,
              stats};
  return sweep_slots<SWEEP8_LANES>(S, a, (cudaStream_t)stream);
}

int tpt_sweep_closest_hit(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* tmax, int n, int S, const int* ord,
                          const float* entry, const int* ranges,
                          const float* tri, int rows_per_chunk, int any_hit,
                          const float* gbox, int chunk_align, float* t,
                          int* tri_id, float* u, float* v,
                          unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  SweepArgs a{ox, oy, oz, dx, dy, dz, tmax, n, ord, entry, ranges, tri,
              rows_per_chunk, any_hit, gbox, chunk_align, t, tri_id, u, v,
              stats};
  return sweep_slots<SWEEP_LANES>(S, a, (cudaStream_t)stream);
}

}  // extern "C"
