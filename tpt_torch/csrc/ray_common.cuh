// Ray set-up, NaN-propagating min/max and the ray-triangle test shared by
// the port's CUDA kernels (packet_wide.cu: K1/K2; sweep.cu: K3/K4;
// treelet.cu: K9/K10), so that every kernel tests a ray-triangle pair
// with the same code. Every kernel that includes this is compiled with
// -fmad=false and without fast-math: the arithmetic is the TPU kernels',
// operation for operation, and the plain PyTorch versions give the same
// bits.

#pragma once

#include <cuda_runtime.h>

namespace {

// min/max that return NaN when either operand is NaN (jnp.minimum,
// torch.minimum); CUDA's fminf/fmaxf drop a NaN
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// 1/d with |d| <= 1e-12 replaced by +-1e-12; -0.0 and NaN go to the
// branch the TPU kernels' jnp.where sends them to (-0.0 >= 0 holds, NaN
// compares false everywhere)
__device__ __forceinline__ float safe_inv(float d) {
  float dd = fabsf(d) > 1e-12f ? d : (d >= 0.0f ? 1e-12f : -1e-12f);
  return 1.0f / dd;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct;
};

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  r.oct = (r.dx >= 0.0f ? 4 : 0) + (r.dy >= 0.0f ? 2 : 0) +
          (r.dz >= 0.0f ? 1 : 0);
  return r;
}

// Moller-Trumbore of one triangle (v0, e1, e2) against a ray
// (pallas_traverse.py:_mt_scalar_tri, pallas_sweep.py:_mt_chunk)
__device__ __forceinline__ bool mt_tri(float v0x, float v0y, float v0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       const Ray& r, float* t_out,
                                       float* u_out, float* v_out) {
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabsf(det) > 1e-9f;
  float inv_det = 1.0f / (ok ? det : 1.0f);
  float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_out = t; *u_out = u; *v_out = v;
  return ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > 1e-4f;
}

}  // namespace
