// SVGF a-trous stencil and temporal reprojection for NVIDIA Hopper
// (sm_90a), with a plain C interface for ctypes (tpt_torch/denoise/
// stencil.py and reproject.py bind them).
//
// Replaces the Pallas TPU kernels of tpt/denoise/:
//   K5 tpt_atrous, tpt_atrous_passes <- atrous_pallas (pallas_stencil.py:180,
//                                       :213)
//   K6 tpt_reproject <- reproject_pallas (pallas_reproject.py:227, :265)
//
// Both compute the plain PyTorch versions in tpt_torch/denoise/svgf.py
// (_atrous_once, _reproject_taps) operation for operation in float32:
// the same order of every sum and product, built with -fmad=false so no
// multiply-add is contracted, expf/powf/sqrtf where PyTorch's CUDA exp,
// pow and sqrt call them, IEEE division, and a max(0, v) and clamp that
// keep a NaN as torch.clamp does. So kernel and plain agree bit for bit.
//
// K5, atrous_kernel. A pixel reads its 12 input values (direct and
// indirect illumination rgb and variance, depth, normal xyz) at its own
// position and at the 8 taps (dy, dx) in {-step, 0, step}^2, and writes
// 8. Taps outside the image read 0 and get weight 0, as the plain
// version's shifted planes do; sky pixels (depth < 0) pass through. What
// bounds it is instruction issue, not bytes (80 B a pixel: >= 49.5 us at
// 1080p and 3.35 TB/s): a thread a pixel, it took the same time at every
// step, and it issued 24 expf (8 SASS instructions each), 8 powf (96
// each: a quarter of its time on an H100 at 700 W,
// scripts/svgf_sass.py) and 110 scalar loads a pixel. The design cuts
// the powf and the loads:
//  - a block takes a strip of STRIP_ROWS rows y0, y0 + step, ... over 32
//    columns, a warp a row, a lane a column, and computes each edge's
//    normal weight powf(max(0, n_p . n_q), sigma_n) once where it can
//    (the same bits from either end): a lane computes its right and
//    three down edges; its up edges are the row above's down edges
//    (shared memory) and its left edge its left neighbour's right edge
//    (a shuffle); the edges that reach outside the block come from a
//    list the warp computes, 32 a powf: 5.4 powf a pixel at steps up to
//    10, 6.3 at 16, were 8. The depth and luminance weights use the
//    centre's gradient and variance and stay per tap;
//  - tpt_atrous_passes runs a frame's passes in one call: the first
//    reads the planes and writes three float4 records a pixel (depth and
//    normal, which the frame keeps; direct and its variance; indirect
//    and its variance), the others read and write the records, 3 vector
//    loads a tap, and the passes the caller keeps write planes;
//  - at most 64 registers a thread (4 blocks a SM; 8-16 bytes spill):
//    at 75-80 the pass was 11% slower.
// What is left, the 24 expf and the taps' arithmetic, loads and
// selects, takes about four fifths of its time.
// The Pallas kernel stages haloed row bands in VMEM because the TPU has
// no cache; here the taps are served by L1/L2.
//
// K6, reproject_kernel. One thread per pixel gathers the four bilinear
// corners of the history at (x - mu, y - mv) through tpt's clamped flat
// index (a NaN index becomes 0) and runs the consistency test on each:
// in image, bilinear weight > 1e-6, n.n' > 0.95, |dz| < 2, same
// material. It writes the weighted sums of the 10 history planes
// run_svgf reads and the weight sum. The Pallas kernel shifts rows and
// columns separately and drops history beyond +-reproject_radius px,
// both because a TPU lane cannot gather; a CUDA thread can, so this
// kernel is exact for any motion. Bound: bytes (15 history and 7 current
// planes read, 11 written, 132 B a pixel: 273.7 MB at 1080p, >= 81.7 us);
// camera motion is smooth, so a warp's gathers stay on a few cache lines.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ATROUS_IN 12
#define ATROUS_OUT 8
#define HIST_DATA 10     // the sums run_svgf reads (svgf.DATA_KEYS)
#define HIST_F32 14      // HIST_DATA, prev normal xyz, prev depth
#define CUR_F32 6        // motion u, v, depth, normal xyz
#define REPRO_OUT 11     // HIST_DATA sums and the weight sum
#define BLOCK_X 32       // K6's block
#define BLOCK_Y 8
#define ATROUS_THREADS 256
#define ATROUS_BLOCKS 4  // resident a SM: at most 64 registers a thread
#define STRIP_ROWS (ATROUS_THREADS / 32)  // a K5 block's rows, a warp each
#define FULL_MASK 0xffffffffu
#define IN_PLANES 0      // a K5 pass reads the 12 planes
#define IN_PACKED 1      // ... or the packed records
#define OUT_PACKED 1     // a K5 pass writes the packed records
#define OUT_PLANES 2     // ... and/or the 8 planes

namespace {

struct ReprojPlanes {
  const float* hist[HIST_F32];
  const int* prev_matid;
  const float* cur[CUR_F32];
  const int* matid;
  float* out[REPRO_OUT];
};

// torch.clamp_min(v, 0) / jnp.maximum(0, v): a NaN stays NaN (fmaxf
// alone would drop it)
__device__ __forceinline__ float max0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// torch.clamp(v, lo, hi), a NaN kept
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// where a pass reads and writes: the 12 planes or the packed records
// (geo [hw], ill [2][hw]: direct then indirect), and the 8 output planes
struct AtrousArgs {
  const float* in[ATROUS_IN];
  float* out[ATROUS_OUT];
  const float4* geo_in;
  float4* geo_out;   // written by a first pass that feeds packed passes
  const float4* ill_in;
  float4* ill_out;
};

template <int IN>
__device__ __forceinline__ float4 load_geo(const AtrousArgs& a, int t) {
  if (IN == IN_PACKED) return __ldg(a.geo_in + t);
  return make_float4(__ldg(a.in[8] + t), __ldg(a.in[9] + t),
                     __ldg(a.in[10] + t), __ldg(a.in[11] + t));
}

template <int IN>
__device__ __forceinline__ float load_depth(const AtrousArgs& a, int t) {
  if (IN == IN_PACKED)
    return __ldg(reinterpret_cast<const float*>(a.geo_in + t));
  return __ldg(a.in[8] + t);
}

template <int IN>
__device__ __forceinline__ void load_ill(const AtrousArgs& a, int t, int hw,
                                         float4& d, float4& e) {
  if (IN == IN_PACKED) {
    d = __ldg(a.ill_in + t);
    e = __ldg(a.ill_in + hw + t);
  } else {
    d = make_float4(__ldg(a.in[0] + t), __ldg(a.in[1] + t),
                    __ldg(a.in[2] + t), __ldg(a.in[3] + t));
    e = make_float4(__ldg(a.in[4] + t), __ldg(a.in[5] + t),
                    __ldg(a.in[6] + t), __ldg(a.in[7] + t));
  }
}

// the normal weight of an edge: the same bits from either end (the same
// three products summed in the same order)
__device__ __forceinline__ float normal_weight(float4 p, float4 q,
                                               float sigma_n) {
  return powf(max0(p.y * q.y + p.z * q.z + p.w * q.w), sigma_n);
}

// the centre pixel's terms every tap uses
struct Centre {
  float depth, lum_d, lum_i, denom_d, denom_i, dzdx, dzdy, sigma_z;
};

struct Sums {
  float wd, wi;
  float4 d, e;  // illumination rgb and variance, weighted
};

// one tap at offset (dy, dx) with normal weight w_n: _atrous_once's body
__device__ __forceinline__ void tap(Sums& acc, const Centre& c, int dy,
                                    int dx, bool valid, float nd, float4 d,
                                    float4 e, float w_n) {
  const float eps = 1e-6f;
  const float d_approx = c.dzdx * (float)dx + c.dzdy * (float)dy;
  const float w_z = expf(-fabsf(c.depth - nd) /
                         (c.sigma_z * fabsf(d_approx) + eps));
  const float n_lum_d = luminance(d.x, d.y, d.z);
  const float n_lum_i = luminance(e.x, e.y, e.z);
  // the normal weight twice, as the reference's EdgeStoppingWeights
  const float w_l_d = w_n * expf(-fabsf(c.lum_d - n_lum_d) * c.denom_d);
  const float w_l_i = w_n * expf(-fabsf(c.lum_i - n_lum_i) * c.denom_i);
  const float w_d = valid ? w_z * w_n * w_l_d : 0.0f;
  const float w_i = valid ? w_z * w_n * w_l_i : 0.0f;
  acc.wd = acc.wd + w_d;
  acc.wi = acc.wi + w_i;
  acc.d.x = acc.d.x + d.x * w_d;
  acc.d.y = acc.d.y + d.y * w_d;
  acc.d.z = acc.d.z + d.z * w_d;
  acc.d.w = acc.d.w + d.w * w_d;
  acc.e.x = acc.e.x + e.x * w_i;
  acc.e.y = acc.e.y + e.y * w_i;
  acc.e.z = acc.e.z + e.z * w_i;
  acc.e.w = acc.e.w + e.w * w_i;
}

// One a-trous pass with stride `step`. A block takes a strip of
// STRIP_ROWS rows y0, y0 + step, ... over 32 consecutive columns, a warp a
// row and a lane a column, and computes each edge's normal weight once
// where it can: a lane computes its right and three down edges; its up
// edges are the row above's down edges (through shared memory), its left
// edge its left neighbour's right edge (a shuffle). The edges that reach
// outside the block (the left and up-left edges of lanes < step, the
// up-right edges of lanes >= 32 - step, the first row's up edges) come
// from a list each warp computes together, 32 edges a powf.
template <int IN, int OUT>
__global__ void __launch_bounds__(ATROUS_THREADS, ATROUS_BLOCKS)
atrous_kernel(AtrousArgs a, int h, int w, int step, int segs, float sigma_z,
              float sigma_n, float sigma_l) {
  // each row's down-left, down and down-right edges, for the row below
  __shared__ float downs[3][STRIP_ROWS][32];
  // each row's list of edges that reach outside the block
  __shared__ float lists[STRIP_ROWS][128];
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int seg = blockIdx.x % segs, strip = blockIdx.x / segs;
  const int s = step, sb = min(step, 32);
  const int x = seg * 32 + lane;
  const int y = strip / s * (s * STRIP_ROWS) + strip % s + r * s;
  const int hw = h * w;
  const bool in = x < w && y < h;  // y is the same for the whole warp
  const float eps = 1e-6f;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int c = y * w + x;
  float4 g = zero, d = zero, e = zero;
  if (in) {
    g = load_geo<IN>(a, c);
    load_ill<IN>(a, c, hw, d, e);
  }
  Centre ct;
  ct.depth = g.x;
  ct.sigma_z = sigma_z;
  ct.lum_d = luminance(d.x, d.y, d.z);
  ct.lum_i = luminance(e.x, e.y, e.z);
  ct.denom_d = 1.0f / (sigma_l * sqrtf(max0(d.w)) + eps);
  ct.denom_i = 1.0f / (sigma_l * sqrtf(max0(e.w)) + eps);
  // edge-clamped depth gradient, |g| < eps replaced by eps
  float dzdx = in && x + 1 < w ? load_depth<IN>(a, c + 1) - g.x : 0.0f;
  float dzdy = in && y + 1 < h ? load_depth<IN>(a, c + w) - g.x : 0.0f;
  if (fabsf(dzdx) < eps) dzdx = eps;
  if (fabsf(dzdy) < eps) dzdy = eps;
  ct.dzdx = dzdx;
  ct.dzdy = dzdy;

  // the edges this lane computes: right, down-left, down, down-right
  const bool down = y + s < h;
  const bool v_r = in && x + s < w, v_dl = in && down && x - s >= 0,
             v_d = in && down, v_dr = in && down && x + s < w;
  const float4 g_r = v_r ? load_geo<IN>(a, c + s) : zero;
  const float4 g_dl = v_dl ? load_geo<IN>(a, c + s * w - s) : zero;
  const float4 g_d = v_d ? load_geo<IN>(a, c + s * w) : zero;
  const float4 g_dr = v_dr ? load_geo<IN>(a, c + s * w + s) : zero;
  const float w_r = normal_weight(g, g_r, sigma_n);
  const float w_dl = normal_weight(g, g_dl, sigma_n);
  const float w_d = normal_weight(g, g_d, sigma_n);
  const float w_dr = normal_weight(g, g_dr, sigma_n);

  // the edges the block shares: the row above's down edges through
  // shared memory, the left neighbour's right edge by a shuffle
  downs[0][r][lane] = w_dl;
  downs[1][r][lane] = w_d;
  downs[2][r][lane] = w_dr;
  const bool first = r == 0;
  const float sh_l = __shfl_sync(FULL_MASK, w_r, (lane - s) & 31);
  // the list of the row's edges whose other end lies outside the block:
  // the left edges of lanes < sb; the up-left edges of lanes < sb and
  // the up-right edges of lanes >= 32 - sb, or on the strip's first row
  // every lane's up-left, up-right and up edges. Entry m is computed by
  // lane m % 32 in round m / 32.
  const int nul = first ? 32 : sb, nu = first ? 32 : 0;
  const int o_ul = sb, o_ur = o_ul + nul, o_u = o_ur + nul;
  const int nb = o_u + nu;
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // nb <= 128
    if (q * 32 >= nb) break;     // the same for the whole warp
    const int m = q * 32 + lane;
    int tl, dy = -s, dx = -s;  // the lane that needs entry m, its edge
    if (m < o_ul) {
      tl = m;
      dy = 0;
    } else if (m < o_ur) {
      tl = m - o_ul;
    } else if (m < o_u) {
      tl = m - o_ur + 32 - nul;
      dx = s;
    } else {
      tl = m - o_u;
      dx = 0;
    }
    float4 gl;  // the normal of lane tl's pixel
    gl.x = 0.0f;
    gl.y = __shfl_sync(FULL_MASK, g.y, tl & 31);
    gl.z = __shfl_sync(FULL_MASK, g.z, tl & 31);
    gl.w = __shfl_sync(FULL_MASK, g.w, tl & 31);
    const int yy = y + dy, xx = seg * 32 + tl + dx;
    const bool ok = m < nb && seg * 32 + tl < w && yy >= 0 && yy < h &&
                    xx >= 0 && xx < w;
    const float4 gq = ok ? load_geo<IN>(a, yy * w + xx) : zero;
    const float wq = normal_weight(gl, gq, sigma_n);
    if (m < nb) lists[r][m] = wq;
  }
  __syncthreads();  // the rows' down edges and the lists are written
  const float wn_l = lane >= s ? sh_l : lists[r][lane];
  const float wn_ul = !first && lane >= s ? downs[2][r - 1][lane - s]
                                          : lists[r][o_ul + lane];
  const float wn_ur = !first && lane + s < 32
                          ? downs[0][r - 1][lane + s]
                          : lists[r][o_ur + lane - (32 - nul)];
  const float wn_u = first ? lists[r][o_u + lane] : downs[1][r - 1][lane];

  Sums acc;
  acc.wd = 1.0f;
  acc.wi = 1.0f;
  acc.d = d;
  acc.e = e;
  // the taps in _atrous_once's order: (dy, dx) row by row
  const bool up = y - s >= 0;
  {
    const bool v = in && up && x - s >= 0;
    float4 gt = zero, dt = zero, et = zero;
    if (v) {
      gt = load_geo<IN>(a, c - s * w - s);
      load_ill<IN>(a, c - s * w - s, hw, dt, et);
    }
    tap(acc, ct, -s, -s, v, gt.x, dt, et, wn_ul);
  }
  {
    const bool v = in && up;
    float4 gt = zero, dt = zero, et = zero;
    if (v) {
      gt = load_geo<IN>(a, c - s * w);
      load_ill<IN>(a, c - s * w, hw, dt, et);
    }
    tap(acc, ct, -s, 0, v, gt.x, dt, et, wn_u);
  }
  {
    const bool v = in && up && x + s < w;
    float4 gt = zero, dt = zero, et = zero;
    if (v) {
      gt = load_geo<IN>(a, c - s * w + s);
      load_ill<IN>(a, c - s * w + s, hw, dt, et);
    }
    tap(acc, ct, -s, s, v, gt.x, dt, et, wn_ur);
  }
  {
    const bool v = in && x - s >= 0;
    float nd = 0.0f;
    float4 dt = zero, et = zero;
    if (v) {
      nd = load_depth<IN>(a, c - s);
      load_ill<IN>(a, c - s, hw, dt, et);
    }
    tap(acc, ct, 0, -s, v, nd, dt, et, wn_l);
  }
  {
    float4 dt = zero, et = zero;
    if (v_r) load_ill<IN>(a, c + s, hw, dt, et);
    tap(acc, ct, 0, s, v_r, g_r.x, dt, et, w_r);
  }
  {
    float4 dt = zero, et = zero;
    if (v_dl) load_ill<IN>(a, c + s * w - s, hw, dt, et);
    tap(acc, ct, s, -s, v_dl, g_dl.x, dt, et, w_dl);
  }
  {
    float4 dt = zero, et = zero;
    if (v_d) load_ill<IN>(a, c + s * w, hw, dt, et);
    tap(acc, ct, s, 0, v_d, g_d.x, dt, et, w_d);
  }
  {
    float4 dt = zero, et = zero;
    if (v_dr) load_ill<IN>(a, c + s * w + s, hw, dt, et);
    tap(acc, ct, s, s, v_dr, g_dr.x, dt, et, w_dr);
  }
  if (in) {
    const bool sky = g.x < 0.0f;
    const float inv_d = 1.0f / acc.wd;
    const float inv_i = 1.0f / acc.wi;
    float4 od, oe;
    od.x = sky ? d.x : acc.d.x * inv_d;
    od.y = sky ? d.y : acc.d.y * inv_d;
    od.z = sky ? d.z : acc.d.z * inv_d;
    od.w = sky ? d.w : acc.d.w / acc.wd;
    oe.x = sky ? e.x : acc.e.x * inv_i;
    oe.y = sky ? e.y : acc.e.y * inv_i;
    oe.z = sky ? e.z : acc.e.z * inv_i;
    oe.w = sky ? e.w : acc.e.w / acc.wi;
    if (OUT & OUT_PACKED) {
      a.ill_out[c] = od;
      a.ill_out[hw + c] = oe;
      if (IN == IN_PLANES) a.geo_out[c] = g;
    }
    if (OUT & OUT_PLANES) {
      a.out[0][c] = od.x;
      a.out[1][c] = od.y;
      a.out[2][c] = od.z;
      a.out[3][c] = od.w;
      a.out[4][c] = oe.x;
      a.out[5][c] = oe.y;
      a.out[6][c] = oe.z;
      a.out[7][c] = oe.w;
    }
  }
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
reproject_kernel(ReprojPlanes p, int h, int w) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int c = y * w + x;

  const float mu = __ldg(p.cur[0] + c);
  const float mv = __ldg(p.cur[1] + c);
  const float depth = __ldg(p.cur[2] + c);
  const float nx = __ldg(p.cur[3] + c);
  const float ny = __ldg(p.cur[4] + c);
  const float nz = __ldg(p.cur[5] + c);
  const float matid = (float)__ldg(p.matid + c);

  const float sx = (float)x - mu;
  const float sy = (float)y - mv;
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = sx - x0;
  const float fy = sy - y0;

  float sums[HIST_DATA];
  for (int k = 0; k < HIST_DATA; ++k) sums[k] = 0.0f;
  float wsum = 0.0f;
  for (int j = 0; j < 2; ++j) {
    for (int i = 0; i < 2; ++i) {
      const float tx = x0 + (float)i;
      const float ty = y0 + (float)j;
      const float wbil = (i ? fx : 1.0f - fx) * (j ? fy : 1.0f - fy);
      const bool inb = tx >= 0.0f && tx < (float)w && ty >= 0.0f
                       && ty < (float)h;
      const float fidx = clamp_nan(ty, 0.0f, (float)(h - 1)) * (float)w
                         + clamp_nan(tx, 0.0f, (float)(w - 1));
      const int t = isnan(fidx) ? 0 : (int)fidx;
      const float pnx = __ldg(p.hist[10] + t);
      const float pny = __ldg(p.hist[11] + t);
      const float pnz = __ldg(p.hist[12] + t);
      const float pd = __ldg(p.hist[13] + t);
      const float pm = (float)__ldg(p.prev_matid + t);
      const bool consistent = inb && wbil > 1e-6f
                              && nx * pnx + ny * pny + nz * pnz > 0.95f
                              && fabsf(depth - pd) < 2.0f && matid == pm;
      const float wv = consistent ? wbil : 0.0f;
      wsum = wsum + wv;
      for (int k = 0; k < HIST_DATA; ++k)
        sums[k] = sums[k] + wv * __ldg(p.hist[k] + t);
    }
  }
  for (int k = 0; k < HIST_DATA; ++k) p.out[k][c] = sums[k];
  p.out[HIST_DATA][c] = wsum;
}

dim3 grid_of(int h, int w) {
  return dim3((w + BLOCK_X - 1) / BLOCK_X, (h + BLOCK_Y - 1) / BLOCK_Y);
}

template <int IN, int OUT>
int launch_atrous(const AtrousArgs& a, int h, int w, int step, float sz,
                  float sn, float sl, cudaStream_t stream) {
  const int segs = (w + 31) / 32;
  const long strips = (long)(h + step * STRIP_ROWS - 1) /
                      (step * STRIP_ROWS) * step;
  const long blocks = segs * strips;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  atrous_kernel<IN, OUT><<<(unsigned)blocks, ATROUS_THREADS, 0, stream>>>(
      a, h, w, step, segs, sz, sn, sl);
  return (int)cudaGetLastError();
}

int launch_pass(int in, int out, const AtrousArgs& a, int h, int w,
                int step, float sz, float sn, float sl, cudaStream_t st) {
#define PASS_CASE(I, O)                                                  \
  if (in == I && out == O)                                               \
    return launch_atrous<I, O>(a, h, w, step, sz, sn, sl, st);
  PASS_CASE(IN_PLANES, OUT_PLANES)
  PASS_CASE(IN_PLANES, OUT_PACKED)
  PASS_CASE(IN_PLANES, OUT_PACKED | OUT_PLANES)
  PASS_CASE(IN_PACKED, OUT_PLANES)
  PASS_CASE(IN_PACKED, OUT_PACKED)
  PASS_CASE(IN_PACKED, OUT_PACKED | OUT_PLANES)
#undef PASS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All plane pointers are device pointers to contiguous [h, w] planes, in
// host arrays; `stream` is a cudaStream_t. Returns cudaGetLastError()
// after the (last) launch (0 = launched), or cudaErrorInvalidValue for an
// image too large for the grid.

// One pass. in: ill_d rgb, var_d, ill_i rgb, var_i, depth, normal xyz
// (float32); out: the same 8 first planes filtered.
int tpt_atrous(const void* const* in, void* const* out, int h, int w,
               int step, float sigma_z, float sigma_n, float sigma_l,
               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step < 1) return (int)cudaErrorInvalidValue;
  AtrousArgs a = {};
  for (int k = 0; k < ATROUS_IN; ++k) a.in[k] = (const float*)in[k];
  for (int k = 0; k < ATROUS_OUT; ++k) a.out[k] = (float*)out[k];
  return launch_pass(IN_PLANES, OUT_PLANES, a, h, w, step, sigma_z, sigma_n,
                     sigma_l, (cudaStream_t)stream);
}

// A frame's `iterations` passes at steps 1, 2, 4, ...: the first reads
// the 12 planes, the others the packed records the pass before wrote
// (`packed`: float4 [5, h * w], the geometry and two ping-pong pairs);
// pass iterations - 2 also writes its 8 planes to `hist` (run_svgf's
// history), the last writes them to `out`.
int tpt_atrous_passes(const void* const* in, void* const* out,
                      void* const* hist, void* packed, int h, int w,
                      int iterations, float sigma_z, float sigma_n,
                      float sigma_l, void* stream) {
  if (h <= 0 || w <= 0 || iterations <= 0) return 0;
  if (iterations > 30) return (int)cudaErrorInvalidValue;
  const size_t hw = (size_t)h * w;
  float4* geo = (float4*)packed;
  float4* ping[2] = {geo + hw, geo + 3 * hw};
  AtrousArgs a = {};
  for (int k = 0; k < ATROUS_IN; ++k) a.in[k] = (const float*)in[k];
  a.geo_in = geo;
  a.geo_out = geo;
  for (int it = 0; it < iterations; ++it) {
    const bool last = it == iterations - 1;
    void* const* planes = last ? out : it == iterations - 2 ? hist : nullptr;
    for (int k = 0; k < ATROUS_OUT; ++k)
      a.out[k] = planes ? (float*)planes[k] : nullptr;
    a.ill_in = it > 0 ? ping[(it - 1) & 1] : nullptr;
    a.ill_out = last ? nullptr : ping[it & 1];
    const int o = (last ? 0 : OUT_PACKED) | (planes ? OUT_PLANES : 0);
    const int rc = launch_pass(it == 0 ? IN_PLANES : IN_PACKED, o, a, h, w,
                               1 << it, sigma_z, sigma_n, sigma_l,
                               (cudaStream_t)stream);
    if (rc) return rc;
  }
  return 0;
}

// hist: the 10 data planes in svgf.DATA_KEYS order, prev normal xyz, prev
// depth (float32); cur: motion u, v, depth, normal xyz (float32); out:
// the 10 weighted sums and the weight sum.
int tpt_reproject(const void* const* hist, const int* prev_matid,
                  const void* const* cur, const int* matid, void* const* out,
                  int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if ((h + BLOCK_Y - 1) / BLOCK_Y > 65535) return (int)cudaErrorInvalidValue;
  ReprojPlanes p;
  for (int k = 0; k < HIST_F32; ++k) p.hist[k] = (const float*)hist[k];
  for (int k = 0; k < CUR_F32; ++k) p.cur[k] = (const float*)cur[k];
  for (int k = 0; k < REPRO_OUT; ++k) p.out[k] = (float*)out[k];
  p.prev_matid = prev_matid;
  p.matid = matid;
  reproject_kernel<<<grid_of(h, w), dim3(BLOCK_X, BLOCK_Y), 0,
                     (cudaStream_t)stream>>>(p, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
