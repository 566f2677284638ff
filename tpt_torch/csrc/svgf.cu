// SVGF a-trous stencil and temporal reprojection for NVIDIA Hopper
// (sm_90a), with a plain C interface for ctypes (tpt_torch/denoise/
// stencil.py and reproject.py bind them).
//
// Replaces the Pallas TPU kernels of tpt/denoise/:
//   K5 tpt_atrous    <- atrous_pallas    (pallas_stencil.py:180, :213)
//   K6 tpt_reproject <- reproject_pallas (pallas_reproject.py:227, :265)
//
// Both compute the plain PyTorch versions in tpt_torch/denoise/svgf.py
// (_atrous_once, _reproject_taps) operation for operation in float32:
// the same order of every sum and product, built with -fmad=false so no
// multiply-add is contracted, expf/powf/sqrtf where PyTorch's CUDA exp,
// pow and sqrt call them, IEEE division, and a max(0, v) and clamp that
// keep a NaN as torch.clamp does. So kernel and plain agree bit for bit.
//
// K5, atrous_kernel. One thread per pixel, 32x8 blocks. A pixel reads
// its 12 input planes (direct and indirect illumination rgb and
// variance, depth, normal xyz) at its own position and at the 8 taps
// (dy, dx) in {-step, 0, step}^2, and writes 8 planes. Taps outside the
// image read 0 and get weight 0, as the plain version's shifted planes
// do; sky pixels (depth < 0) pass through. The Pallas kernel stages
// haloed row bands in VMEM because the TPU has no cache; here a warp
// reads 32 neighbouring addresses of a row and the taps of a block are
// served by L1/L2, so the kernel reads the planes directly. Bound: bytes
// (12 planes read and 8 written once, 80 B a pixel: 165.9 MB at 1080p,
// >= 49.5 us at 3.35 TB/s; ~500 fp32 operations a pixel are far below
// the card's rate). A shared-memory tile that cuts the taps' L1/L2
// traffic is later work.
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
#define BLOCK_X 32
#define BLOCK_Y 8

namespace {

struct AtrousPlanes {
  const float* in[ATROUS_IN];
  float* out[ATROUS_OUT];
};

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

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
atrous_kernel(AtrousPlanes p, int h, int w, int step, float sigma_z,
              float sigma_n, float sigma_l) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float eps = 1e-6f;
  const int c = y * w + x;

  float ill_d[3], ill_i[3];
  for (int k = 0; k < 3; ++k) {
    ill_d[k] = __ldg(p.in[k] + c);
    ill_i[k] = __ldg(p.in[4 + k] + c);
  }
  const float var_d = __ldg(p.in[3] + c);
  const float var_i = __ldg(p.in[7] + c);
  const float depth = __ldg(p.in[8] + c);
  const float nx = __ldg(p.in[9] + c);
  const float ny = __ldg(p.in[10] + c);
  const float nz = __ldg(p.in[11] + c);

  const float lum_d = luminance(ill_d[0], ill_d[1], ill_d[2]);
  const float lum_i = luminance(ill_i[0], ill_i[1], ill_i[2]);
  const float denom_d = 1.0f / (sigma_l * sqrtf(max0(var_d)) + eps);
  const float denom_i = 1.0f / (sigma_l * sqrtf(max0(var_i)) + eps);

  // edge-clamped depth gradient, |g| < eps replaced by eps
  float dzdx = x + 1 < w ? __ldg(p.in[8] + c + 1) - depth : 0.0f;
  float dzdy = y + 1 < h ? __ldg(p.in[8] + c + w) - depth : 0.0f;
  if (fabsf(dzdx) < eps) dzdx = eps;
  if (fabsf(dzdy) < eps) dzdy = eps;

  float sum_wd = 1.0f, sum_wi = 1.0f;
  float acc_d[3] = {ill_d[0], ill_d[1], ill_d[2]};
  float acc_i[3] = {ill_i[0], ill_i[1], ill_i[2]};
  float acc_vd = var_d, acc_vi = var_i;

  for (int j = -1; j <= 1; ++j) {
    for (int i = -1; i <= 1; ++i) {
      if (i == 0 && j == 0) continue;
      const int dy = j * step, dx = i * step;
      const int yy = y + dy, xx = x + dx;
      const bool valid = yy >= 0 && yy < h && xx >= 0 && xx < w;
      float nd = 0.0f, nn[3] = {0.0f, 0.0f, 0.0f};
      float n_ill_d[3] = {0.0f, 0.0f, 0.0f}, n_ill_i[3] = {0.0f, 0.0f, 0.0f};
      float n_var_d = 0.0f, n_var_i = 0.0f;
      if (valid) {
        const int t = yy * w + xx;
        for (int k = 0; k < 3; ++k) {
          n_ill_d[k] = __ldg(p.in[k] + t);
          n_ill_i[k] = __ldg(p.in[4 + k] + t);
          nn[k] = __ldg(p.in[9 + k] + t);
        }
        n_var_d = __ldg(p.in[3] + t);
        n_var_i = __ldg(p.in[7] + t);
        nd = __ldg(p.in[8] + t);
      }
      const float d_approx = dzdx * (float)dx + dzdy * (float)dy;
      const float w_z = expf(-fabsf(depth - nd)
                             / (sigma_z * fabsf(d_approx) + eps));
      const float w_n = powf(max0(nx * nn[0] + ny * nn[1] + nz * nn[2]),
                             sigma_n);
      const float n_lum_d = luminance(n_ill_d[0], n_ill_d[1], n_ill_d[2]);
      const float n_lum_i = luminance(n_ill_i[0], n_ill_i[1], n_ill_i[2]);
      // the normal weight twice, as the reference's EdgeStoppingWeights
      const float w_l_d = w_n * expf(-fabsf(lum_d - n_lum_d) * denom_d);
      const float w_l_i = w_n * expf(-fabsf(lum_i - n_lum_i) * denom_i);
      const float w_d = valid ? w_z * w_n * w_l_d : 0.0f;
      const float w_i = valid ? w_z * w_n * w_l_i : 0.0f;

      sum_wd = sum_wd + w_d;
      sum_wi = sum_wi + w_i;
      for (int k = 0; k < 3; ++k) {
        acc_d[k] = acc_d[k] + n_ill_d[k] * w_d;
        acc_i[k] = acc_i[k] + n_ill_i[k] * w_i;
      }
      acc_vd = acc_vd + n_var_d * w_d;
      acc_vi = acc_vi + n_var_i * w_i;
    }
  }

  const bool sky = depth < 0.0f;
  const float inv_d = 1.0f / sum_wd;
  const float inv_i = 1.0f / sum_wi;
  for (int k = 0; k < 3; ++k) {
    p.out[k][c] = sky ? ill_d[k] : acc_d[k] * inv_d;
    p.out[4 + k][c] = sky ? ill_i[k] : acc_i[k] * inv_i;
  }
  p.out[3][c] = sky ? var_d : acc_vd / sum_wd;
  p.out[7][c] = sky ? var_i : acc_vi / sum_wi;
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

}  // namespace

extern "C" {

// All plane pointers are device pointers to contiguous [h, w] planes, in
// host arrays; `stream` is a cudaStream_t. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for an image
// taller than the grid allows.

// in: ill_d rgb, var_d, ill_i rgb, var_i, depth, normal xyz (float32);
// out: the same 8 first planes filtered.
int tpt_atrous(const void* const* in, void* const* out, int h, int w,
               int step, float sigma_z, float sigma_n, float sigma_l,
               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if ((h + BLOCK_Y - 1) / BLOCK_Y > 65535 || step < 1)
    return (int)cudaErrorInvalidValue;
  AtrousPlanes p;
  for (int k = 0; k < ATROUS_IN; ++k) p.in[k] = (const float*)in[k];
  for (int k = 0; k < ATROUS_OUT; ++k) p.out[k] = (float*)out[k];
  atrous_kernel<<<grid_of(h, w), dim3(BLOCK_X, BLOCK_Y), 0,
                  (cudaStream_t)stream>>>(p, h, w, step, sigma_z, sigma_n,
                                          sigma_l);
  return (int)cudaGetLastError();
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
