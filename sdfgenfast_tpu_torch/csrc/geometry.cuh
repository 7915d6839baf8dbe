// Point-triangle squared distance on the device, for the recompute kernels
// R1/R1b (recompute.cu).
//
// Operation for operation geometry.point_triangle_distance_sq_soa (the JAX
// package's and the port's), so a kernel built with --fmad=false matches the
// PyTorch twin bit for bit. The pieces are exposed (the segment term with its
// parameter and offset, the barycentric case) because R1b needs the closest
// point that the distance was taken to, not only the distance.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float d3(float ux, float uy, float uz, float vx,
                                    float vy, float vz) {
  return ux * vx + uy * vy + uz * vz;
}

// Squared distance from p to segment [x1, x2]: the closest point is
// s*x1 + (1-s)*x2 with s = clamp(((x2-p).(x2-x1)) / max(|x2-x1|^2, 1e-30)),
// and (ddx, ddy, ddz) = p - closest.
__device__ __forceinline__ float seg_closest(float px, float py, float pz,
                                             float x1x, float x1y, float x1z,
                                             float x2x, float x2y, float x2z,
                                             float& s, float& ddx, float& ddy,
                                             float& ddz) {
  const float dvx = x2x - x1x, dvy = x2y - x1y, dvz = x2z - x1z;
  const float m2 = d3(dvx, dvy, dvz, dvx, dvy, dvz);
  float t = d3(x2x - px, x2y - py, x2z - pz, dvx, dvy, dvz) / fmaxf(m2, 1e-30f);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  ddx = px - (t * x1x + (1.0f - t) * x2x);
  ddy = py - (t * x1y + (1.0f - t) * x2y);
  ddz = pz - (t * x1z + (1.0f - t) * x2z);
  s = t;
  return d3(ddx, ddy, ddz, ddx, ddy, ddz);
}

__device__ __forceinline__ float seg_d2(float px, float py, float pz,
                                        float x1x, float x1y, float x1z,
                                        float x2x, float x2y, float x2z) {
  float s, ddx, ddy, ddz;
  return seg_closest(px, py, pz, x1x, x1y, x1z, x2x, x2y, x2z, s, ddx, ddy,
                     ddz);
}

// The plane projection's barycentric weights (w23 on a, w31 on b, w12 on c),
// whether it falls inside, and (ex, ey, ez) = p - projection.
struct TriangleCase {
  float w23, w31, w12, ex, ey, ez;
  bool inside;
};

__device__ __forceinline__ TriangleCase triangle_case(
    float px, float py, float pz, float ax, float ay, float az, float bx,
    float by, float bz, float cx, float cy, float cz) {
  const float x13x = ax - cx, x13y = ay - cy, x13z = az - cz;
  const float x23x = bx - cx, x23y = by - cy, x23z = bz - cz;
  const float x03x = px - cx, x03y = py - cy, x03z = pz - cz;
  const float m13 = d3(x13x, x13y, x13z, x13x, x13y, x13z);
  const float m23 = d3(x23x, x23y, x23z, x23x, x23y, x23z);
  const float d = d3(x13x, x13y, x13z, x23x, x23y, x23z);
  const float invdet = 1.0f / fmaxf(m13 * m23 - d * d, 1e-30f);
  const float pa = d3(x13x, x13y, x13z, x03x, x03y, x03z);
  const float pb = d3(x23x, x23y, x23z, x03x, x03y, x03z);
  TriangleCase r;
  r.w23 = invdet * (m23 * pa - d * pb);
  r.w31 = invdet * (m13 * pb - d * pa);
  r.w12 = 1.0f - r.w23 - r.w31;
  r.inside = (r.w23 >= 0.0f) && (r.w31 >= 0.0f) && (r.w12 >= 0.0f);
  r.ex = px - (r.w23 * ax + r.w31 * bx + r.w12 * cx);
  r.ey = py - (r.w23 * ay + r.w31 * by + r.w12 * cy);
  r.ez = pz - (r.w23 * az + r.w31 * bz + r.w12 * cz);
  return r;
}

// geometry.point_triangle_distance_sq_soa, operation for operation.
__device__ __forceinline__ float point_triangle_d2(
    float px, float py, float pz, float ax, float ay, float az, float bx,
    float by, float bz, float cx, float cy, float cz) {
  const TriangleCase tc =
      triangle_case(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz);
  const float din = d3(tc.ex, tc.ey, tc.ez, tc.ex, tc.ey, tc.ez);
  const float d12 = seg_d2(px, py, pz, ax, ay, az, bx, by, bz);
  const float d13 = seg_d2(px, py, pz, ax, ay, az, cx, cy, cz);
  const float d23 = seg_d2(px, py, pz, bx, by, bz, cx, cy, cz);
  const float d_edge = tc.w23 > 0.0f   ? fminf(d12, d13)
                       : tc.w31 > 0.0f ? fminf(d12, d23)
                                       : fminf(d13, d23);
  return tc.inside ? din : d_edge;
}
