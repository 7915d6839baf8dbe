// R1 and R1b: the differentiable final distance evaluation, forward and
// backward.
//
// They have no Pallas counterpart. The JAX package runs this stage as jnp
// code under autodiff (sdfgenfast_tpu/pipeline.py::_recompute_phi, one
// jax.checkpoint per 2^20-cell chunk with nothing saved): from the frozen
// closest-triangle ids `tid` and the parity field, every cell's phi is
// evaluated again from the triangle's vertices, so the gradient reaches them.
//
// R1 (forward): phi = +-sqrt(max(d2, 1e-30)) with d2 the point-triangle
// squared distance to triangle tid (geometry.cuh, the operation order of
// point_triangle_distance_sq_soa), `upper` where tid < 0, negated where the
// parity is odd. Cell (i, j, k) sits at f32(i) * dx + origin, in world
// coordinates, as in _recompute_phi. One thread per cell, k fastest.
//
// R1b (backward): the per-cell vector-Jacobian product into the (M, 9)
// triangle-vertex gradient, by reverse-mode differentiation of R1's own
// float32 operations with autograd's rules: maximum / minimum pass all of
// the gradient to the winner and half to each side of a tie (so a clamp
// bound passes half), where() passes it to the selected branch only, and
// division and reciprocal use autograd's formulas. In exact arithmetic this
// is the envelope-theorem result, dphi/da = -sign * w_a * (p - cp) / d; in
// float32 the terms through the weights and edge parameters are not zero
// where p - cp is rounding noise (cells within ~1e-7 of the surface), and
// the closed form alone then differs from autograd by up to 4.6e-3 of the
// largest vertex gradient (icosphere(4) at 64^3, float32 on a CPU); the
// reverse-mode form tracks autograd to rounding.
// Branches that autograd evaluates with a zero gradient (the unselected
// case, a tie's loser) are skipped: they add exactly 0.
// The nine per-cell values are float32, as autograd's; a warp first sums, in
// float64 and ascending lane order, the lanes that share a triangle, then one
// lane adds the nine sums to the float64 accumulator with atomics; the
// wrapper casts to float32 once. Atomic order varies between runs; float64
// keeps that far below a float32 ulp.
//
// Bound on the H100: R1 is ~110 FP32 operations per cell plus a 36-byte
// gather of the triangle (cached: neighbouring cells share it) and 9 bytes of
// traffic; R1b ~3x the operations and the atomics, which the warp sum cuts
// by up to 32x where runs of cells share a triangle (dense meshes). Built
// with --fmad=false, so R1 matches its PyTorch twin bit for bit.

#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cell_world(long long n, int nj, int nk,
                                           float ox, float oy, float oz,
                                           float dx, float& x, float& y,
                                           float& z) {
  const int k = (int)(n % nk);
  const long long r = n / nk;
  const int j = (int)(r % nj);
  const int i = (int)(r / nj);
  x = (float)i * dx + ox;
  y = (float)j * dx + oy;
  z = (float)k * dx + oz;
}

__global__ void __launch_bounds__(kThreads)
recompute_phi_kernel(const float* __restrict__ tri, const int* __restrict__ tid,
                     const unsigned char* __restrict__ parity, long long n,
                     int nj, int nk, float ox, float oy, float oz, float dx,
                     float upper, float* __restrict__ phi) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < n;
       c += step) {
    const int t = tid[c];
    float d = upper;
    if (t >= 0) {
      float x, y, z;
      cell_world(c, nj, nk, ox, oy, oz, dx, x, y, z);
      const float* v = tri + 9LL * t;
      const float d2 = point_triangle_d2(x, y, z, v[0], v[1], v[2], v[3],
                                         v[4], v[5], v[6], v[7], v[8]);
      d = sqrtf(fmaxf(d2, 1e-30f));
    }
    phi[c] = parity[c] ? -d : d;
  }
}

// autograd's backward of maximum(x, lo) / minimum(x, hi) with respect to x
__device__ __forceinline__ float bwd_max(float g, float x, float lo) {
  return x < lo ? 0.0f : (x == lo ? g / 2.0f : g);
}

__device__ __forceinline__ float bwd_min(float g, float x, float hi) {
  return x > hi ? 0.0f : (x == hi ? g / 2.0f : g);
}

__device__ __forceinline__ float dot3(const float u[3], const float v[3]) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

// Adds gd * d(segment d2)/d(x1, x2) to g1, g2: seg_closest's operations in
// reverse.
__device__ __forceinline__ void seg_vjp(const float p[3], const float x1[3],
                                        const float x2[3], float gd,
                                        float g1[3], float g2[3]) {
  float dv[3], r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dv[i] = x2[i] - x1[i];
    r[i] = x2[i] - p[i];
  }
  const float m2 = dot3(dv, dv);
  const float m2c = fmaxf(m2, 1e-30f);
  const float num = dot3(r, dv);
  const float s0 = num / m2c;
  const float s1 = fmaxf(s0, 0.0f);
  const float s = fminf(s1, 1.0f);
  const float q = 1.0f - s;
  float gs = 0.0f, gq = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dd = p[i] - (s * x1[i] + q * x2[i]);
    const float t = gd * dd;
    const float gcc = -(t + t);
    gs = gs + gcc * x1[i];
    g1[i] = g1[i] + gcc * s;
    gq = gq + gcc * x2[i];
    g2[i] = g2[i] + gcc * q;
  }
  gs = gs - gq;
  const float gs0 = bwd_max(bwd_min(gs, s1, 1.0f), s0, 0.0f);
  const float gnum = gs0 / m2c;
  const float gm2 = bwd_max(-gs0 * ((num / m2c) / m2c), m2, 1e-30f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = gm2 * dv[i];
    const float gdv = gnum * r[i] + (t + t);
    g2[i] = g2[i] + gnum * dv[i];
    g2[i] = g2[i] + gdv;
    g1[i] = g1[i] - gdv;
  }
}

// Adds gd * d(plane-projection d2)/d(a, b, c) to ga, gb, gc: triangle_case's
// operations and d3(e, e) in reverse.
__device__ __forceinline__ void plane_vjp(const float p[3], const float a[3],
                                          const float b[3], const float c[3],
                                          float gd, float ga[3], float gb[3],
                                          float gc[3]) {
  float x13[3], x23[3], x03[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x13[i] = a[i] - c[i];
    x23[i] = b[i] - c[i];
    x03[i] = p[i] - c[i];
  }
  const float m13 = dot3(x13, x13);
  const float m23 = dot3(x23, x23);
  const float dd = dot3(x13, x23);
  const float den = m13 * m23 - dd * dd;
  const float inv = 1.0f / fmaxf(den, 1e-30f);
  const float pa = dot3(x13, x03);
  const float pb = dot3(x23, x03);
  const float u = m23 * pa - dd * pb;
  const float v = m13 * pb - dd * pa;
  const float w23 = inv * u;
  const float w31 = inv * v;
  const float w12 = 1.0f - w23 - w31;
  float gw23 = 0.0f, gw31 = 0.0f, gw12 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float e = p[i] - (w23 * a[i] + w31 * b[i] + w12 * c[i]);
    const float t = gd * e;
    const float gcin = -(t + t);
    gw23 = gw23 + gcin * a[i];
    ga[i] = ga[i] + gcin * w23;
    gw31 = gw31 + gcin * b[i];
    gb[i] = gb[i] + gcin * w31;
    gw12 = gw12 + gcin * c[i];
    gc[i] = gc[i] + gcin * w12;
  }
  gw23 = gw23 - gw12;
  gw31 = gw31 - gw12;
  const float ginv = gw23 * u + gw31 * v;
  const float gu = gw23 * inv;
  const float gv = gw31 * inv;
  const float gden = bwd_max(-ginv * (inv * inv), den, 1e-30f);
  const float gm13 = gv * pb + gden * m23;
  const float gm23 = gu * pa + gden * m13;
  const float t = gden * dd;
  const float gdd = -(gu * pb) - gv * pa - (t + t);
  const float gpa = gu * m23 - gv * dd;
  const float gpb = gv * m13 - gu * dd;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t13 = gm13 * x13[i];
    const float t23 = gm23 * x23[i];
    const float gx13 = gpa * x03[i] + (t13 + t13) + gdd * x23[i];
    const float gx23 = gpb * x03[i] + (t23 + t23) + gdd * x13[i];
    const float gx03 = gpa * x13[i] + gpb * x23[i];
    ga[i] = ga[i] + gx13;
    gb[i] = gb[i] + gx23;
    gc[i] = gc[i] - gx13 - gx23 - gx03;
  }
}

// g (already signed by the parity) * dphi/d(a, b, c) for one cell, into
// out[9] = (ga, gb, gc), float32.
__device__ __forceinline__ void cell_vjp(const float p[3], const float* v,
                                         float g, float out[9]) {
  const float a[3] = {v[0], v[1], v[2]};
  const float b[3] = {v[3], v[4], v[5]};
  const float c[3] = {v[6], v[7], v[8]};
  float* ga = out;
  float* gb = out + 3;
  float* gc = out + 6;
#pragma unroll
  for (int q = 0; q < 9; ++q) out[q] = 0.0f;
  const TriangleCase tc = triangle_case(p[0], p[1], p[2], a[0], a[1], a[2],
                                        b[0], b[1], b[2], c[0], c[1], c[2]);
  const float din = d3(tc.ex, tc.ey, tc.ez, tc.ex, tc.ey, tc.ez);
  const float d12 = seg_d2(p[0], p[1], p[2], a[0], a[1], a[2], b[0], b[1], b[2]);
  const float d13 = seg_d2(p[0], p[1], p[2], a[0], a[1], a[2], c[0], c[1], c[2]);
  const float d23 = seg_d2(p[0], p[1], p[2], b[0], b[1], b[2], c[0], c[1], c[2]);
  // the forward's case: the plane projection, or the minimum of two edges
  int e1, e2;  // 0: ab, 1: ac, 2: bc
  float dp, dq;
  if (tc.w23 > 0.0f) {
    e1 = 0; e2 = 1; dp = d12; dq = d13;
  } else if (tc.w31 > 0.0f) {
    e1 = 0; e2 = 2; dp = d12; dq = d23;
  } else {
    e1 = 1; e2 = 2; dp = d13; dq = d23;
  }
  const float d2 = tc.inside ? din : fminf(dp, dq);
  const float d = sqrtf(fmaxf(d2, 1e-30f));
  const float gd2 = bwd_max(g / (d + d), d2, 1e-30f);
  if (gd2 == 0.0f) return;
  if (tc.inside) {
    plane_vjp(p, a, b, c, gd2, ga, gb, gc);
    return;
  }
  const float gp = bwd_min(gd2, dp, dq);
  const float gq = bwd_min(gd2, dq, dp);
  const int edges[2] = {e1, e2};
  const float gs[2] = {gp, gq};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (gs[k] == 0.0f) continue;
    if (edges[k] == 0)
      seg_vjp(p, a, b, gs[k], ga, gb);
    else if (edges[k] == 1)
      seg_vjp(p, a, c, gs[k], ga, gc);
    else
      seg_vjp(p, b, c, gs[k], gb, gc);
  }
}

__global__ void __launch_bounds__(kThreads)
recompute_vjp_kernel(const float* __restrict__ tri,
                     const int* __restrict__ tid,
                     const unsigned char* __restrict__ parity,
                     const float* __restrict__ grad_phi, long long n, int nj,
                     int nk, float ox, float oy, float oz, float dx,
                     double* __restrict__ grad_tri) {
  __shared__ float stage[9][kThreads];
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x - lane;
  const long long step = (long long)gridDim.x * kThreads;
  // the loop bound is uniform over the block, so every lane reaches the
  // warp collectives together
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += step) {
    const long long c = base + threadIdx.x;
    int t = -1;
    float g[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) g[q] = 0.0f;
    if (c < n) {
      t = tid[c];
      const float up = grad_phi[c];
      if (t >= 0 && up != 0.0f) {
        float p[3];
        cell_world(c, nj, nk, ox, oy, oz, dx, p[0], p[1], p[2]);
        cell_vjp(p, tri + 9LL * t, parity[c] ? -up : up, g);
      } else {
        t = -1;
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) stage[q][threadIdx.x] = g[q];
    const unsigned peers = __match_any_sync(kFullMask, t);
    __syncwarp();
    if (t >= 0 && lane == __ffs(peers) - 1) {
      for (int q = 0; q < 9; ++q) {
        double sum = 0.0;
        for (unsigned m = peers; m != 0; m &= m - 1)
          sum += (double)stage[q][warp0 + __ffs(m) - 1];
        atomicAdd(grad_tri + 9LL * t + q, sum);
      }
    }
    __syncwarp();
  }
}

template <typename Kernel>
cudaError_t grid_blocks(Kernel kernel, long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1) * 4;
  *blocks = (int)(need < fit ? need : fit);
  return cudaSuccess;
}

}  // namespace

extern "C" int sdf_recompute_phi(const float* tri, const int* tid,
                                 const unsigned char* parity, long long n,
                                 int nj, int nk, float ox, float oy, float oz,
                                 float dx, float upper, float* phi,
                                 void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int blocks = 0;
  const cudaError_t err = grid_blocks(recompute_phi_kernel, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  recompute_phi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tri, tid, parity, n, nj, nk, ox, oy, oz, dx, upper, phi);
  return (int)cudaGetLastError();
}

extern "C" int sdf_recompute_vjp(const float* tri, const int* tid,
                                 const unsigned char* parity,
                                 const float* grad_phi, long long n, int nj,
                                 int nk, float ox, float oy, float oz,
                                 float dx, double* grad_tri, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int blocks = 0;
  const cudaError_t err = grid_blocks(recompute_vjp_kernel, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  recompute_vjp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tri, tid, parity, grad_phi, n, nj, nk, ox, oy, oz, dx, grad_tri);
  return (int)cudaGetLastError();
}
