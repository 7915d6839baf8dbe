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
// squared distance to triangle tid (the operation order of
// point_triangle_distance_sq_soa), `upper` where tid < 0, negated where the
// parity is odd. Cell (i, j, k) sits at f32(i) * dx + origin, in world
// coordinates, as in _recompute_phi. A thread takes chunks of four
// consecutive cells (k fastest; wide loads and stores) or, for large
// meshes, one cell at a time, walks (i, j, k) without dividing, and
// evaluates only the path each cell takes: the plane projection's
// weights, then its distance inside, or else the two segments that the
// case selects (cell_d2). The triangle-only terms
// (x13, x23, m13, m23, d, invdet and each edge's dv and max(|dv|^2,
// 1e-30)) come, for small meshes, from a per-triangle table built by its
// own launch (sdf_recompute_terms) and staged in shared memory, or are computed per cell from
// the vertices (the faster for large meshes); the form per M is
// ops/recompute.r1_config's. Every term takes the operations of
// triangle_case and seg_closest (geometry.cuh), so phi keeps the bits of
// point_triangle_distance_sq_soa.
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
//
// R1b's sum. The nine per-cell values are float32, as autograd's; they are
// summed in float64 in an order fixed by n, M and the range split that the
// wrapper passes (ops/recompute.py::vjp_ranges), never by the card:
// - Warp w owns the contiguous cells [w * span, min((w + 1) * span, n)) and
//   walks them 32 at a time (lane l takes cell base + l). A cell's key is
//   its tid; a cell with tid < 0, or past the range's end, has key -1 and
//   adds 0; a cell with grad_phi == 0 keeps its key and adds exactly 0, so
//   it does not break a run. A run is a maximal stretch of equal keys.
// - The warp carries the current run (key K) as nine float64 sums per lane,
//   in shared memory (so they hold no registers while cell_vjp runs): lane
//   l adds its cell's values while every lane of a step has key K.
// - A step that holds another key: if lane 0 has key K, the lanes of that
//   first run add theirs; K's sum is then flushed: lane q < 9 sums
//   component q of lanes 0-15's carries in ascending lane order from 0.0,
//   lane 16 + q that of lanes 16-31, and lane q adds the second half to the
//   first (a shuffle butterfly over the nine components was slower on
//   box36). Runs that start and end inside the step are summed by a
//   segmented inclusive scan
//   (__shfl_up_sync at offsets 1, 2, 4, 8, 16, a lane adding what the
//   lane `offset` below holds while that lane is in its run) and flushed
//   from their last lane, after the carry: the runs of one key in ascending
//   lane order, runs of distinct keys at once. The run that holds lane 31
//   becomes the carry: its lanes' values, 0 elsewhere.
// - The range's end flushes the carry. A flush of key -1 writes nothing.
// M <= 1024 (every dense mesh; sdf_recompute_vjp_rows): a flush goes into
// the warp's own (M, 9) float64 row of a (ranges, M, 9) scratch; no other
// warp writes that row, so no atomic. The row is not zeroed: the warp keeps
// a mask of the keys it has flushed in shared memory (M <= 1024 bits, word
// l holding keys 32 l .. 32 l + 31), stores a key's first flush and adds
// the later ones, and writes the mask at its end. Then each column is
// summed over the rows whose mask holds its key: G x 32 row slices (G
// groups, from ops/recompute.py::vjp_sum_groups, so that small M still
// fills the card), slice y taking rows y, y + 32 G, .. in ascending order
// from 0.0; a shared-memory tree over each group's 32 slices at strides 16,
// 8, 4, 2, 1; the G group sums in ascending order from 0.0 (a third launch
// when G > 1); one cast to float32. A skipped entry would have added +0.0
// to a float64 sum that starts at +0.0, so the result is that of zeroed
// rows, and the scratch's traffic is per flush, not per row.
// Bit-equal from run to run by construction; tests/test_torch_recompute.py
// transcribes the order. M > 1024 (sdf_recompute_vjp): an (M, 9) table per
// warp does not fit, so a flush is one float64 atomicAdd per component into
// one accumulator, which the wrapper casts to float32; equal bits between
// runs are then a measured property, not a guaranteed one (float64 keeps
// the atomics' order far below a float32 ulp).
//
// Cell indices are 32-bit (unsigned) when n < 2^31 and 64-bit above. R1
// divides once per thread and walks (i, j, k); R1b divides once per lane
// and then walks (i, j, k) 32 cells a step. R1b loads the next step's id,
// gradient and parity before this step's cell_vjp.
//
// Bound on the H100: R1 is bytes, 9 per cell (tid, parity, phi) plus the
// 36-byte triangles read once; a plane-case cell needs 58 FP32
// operations with the table, an outside cell 96 with its two segments (two
// divisions; chip_smoke.py's OPS_R1_*). R1b needs ~224 operations for a plane-case
// cell and ~216 for a one-edge cell (chip_smoke.py's OPS_R1B_*; cell_vjp computes more: all
// three segment distances, and plane_vjp and seg_vjp compute their forward
// values again), and its sum, whose flush work is per run, not per cell. Built with --fmad=false, so R1
// matches its PyTorch twin bit for bit.

#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSlices = 32;  // row slices per block of the summing launch

// R1's per-triangle table, kTerms floats (eight float4) per triangle, each
// term computed with the operations triangle_case and seg_closest use:
//   float4 0-2: a, b, c, invdet, m13, m23;
//   float4 3-4: x13 = a - c, d; x23 = b - c, 0;
//   float4 5-7: per edge ab, ac, bc (seg_d2(a, b), (a, c), (b, c)):
//   dv = x2 - x1 and max(|dv|^2, 1e-30).
constexpr int kTerms = 32;
constexpr int kQuads = kTerms / 4;

// The plane projection's triangle terms.
struct Plane {
  float a[3], b[3], c[3], x13[3], x23[3], m13, m23, d, invdet;
};

// every term from the nine vertex coordinates v
__device__ __forceinline__ Plane plane_from_verts(const float* v) {
  Plane P;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    P.a[q] = v[q];
    P.b[q] = v[3 + q];
    P.c[q] = v[6 + q];
    P.x13[q] = P.a[q] - P.c[q];
    P.x23[q] = P.b[q] - P.c[q];
  }
  P.m13 = d3(P.x13[0], P.x13[1], P.x13[2], P.x13[0], P.x13[1], P.x13[2]);
  P.m23 = d3(P.x23[0], P.x23[1], P.x23[2], P.x23[0], P.x23[1], P.x23[2]);
  P.d = d3(P.x13[0], P.x13[1], P.x13[2], P.x23[0], P.x23[1], P.x23[2]);
  P.invdet = 1.0f / fmaxf(P.m13 * P.m23 - P.d * P.d, 1e-30f);
  return P;
}

// segment [x1, x2]'s dv = x2 - x1 and max(|dv|^2, 1e-30)
__device__ __forceinline__ float4 edge_terms(const float* x1,
                                             const float* x2) {
  const float dvx = x2[0] - x1[0], dvy = x2[1] - x1[1], dvz = x2[2] - x1[2];
  return make_float4(dvx, dvy, dvz,
                     fmaxf(d3(dvx, dvy, dvz, dvx, dvy, dvz), 1e-30f));
}

// Where R1 takes a triangle's terms from (ops/recompute.R1_FORMS):
// plane() gives the plane terms, edge(x1, x2, e) those of edge e (0: ab,
// 1: ac, 2: bc) with endpoints x1, x2.
// kShared: the whole table row, staged in shared memory.
struct SharedTri {
  const float4* row;
  __device__ __forceinline__ Plane plane() const {
    const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3],
                 q4 = row[4];
    return Plane{{q0.x, q0.y, q0.z}, {q0.w, q1.x, q1.y}, {q1.z, q1.w, q2.x},
                 {q3.x, q3.y, q3.z}, {q4.x, q4.y, q4.z}, q2.z, q2.w, q3.w,
                 q2.y};
  }
  __device__ __forceinline__ float4 edge(const float*, const float*,
                                         int e) const {
    return row[5 + e];
  }
};

// kVerts: the nine vertex coordinates (36 bytes), every term computed.
struct VertTri {
  float v[9];
  __device__ __forceinline__ Plane plane() const {
    return plane_from_verts(v);
  }
  __device__ __forceinline__ float4 edge(const float* x1, const float* x2,
                                         int) const {
    return edge_terms(x1, x2);
  }
};

enum PhiForm { kShared = 0, kVerts = 1 };

template <int kForm>
struct FormTri {
  using type = SharedTri;
};
template <>
struct FormTri<kVerts> {
  using type = VertTri;
};

// triangle t's terms (t >= 0; zeros, nothing read, for t < 0)
template <int kForm>
__device__ __forceinline__ typename FormTri<kForm>::type load_tri(
    int t, const float* __restrict__ tri, const float4* stab) {
  typename FormTri<kForm>::type r{};
  if constexpr (kForm == kShared) {
    r.row = stab + (t >= 0 ? t : 0) * kQuads;
  } else {
    if (t >= 0) {
#pragma unroll
      for (int e = 0; e < 9; ++e) r.v[e] = __ldg(tri + 9LL * t + e);
    }
  }
  return r;
}

// seg_closest's distance with dv and max(|dv|^2, 1e-30) from edge_terms
__device__ __forceinline__ float seg_d2_terms(float px, float py, float pz,
                                              const float* x1,
                                              const float* x2, float4 dv) {
  float t = d3(x2[0] - px, x2[1] - py, x2[2] - pz, dv.x, dv.y, dv.z) / dv.w;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float ddx = px - (t * x1[0] + (1.0f - t) * x2[0]);
  const float ddy = py - (t * x1[1] + (1.0f - t) * x2[1]);
  const float ddz = pz - (t * x1[2] + (1.0f - t) * x2[2]);
  return d3(ddx, ddy, ddz, ddx, ddy, ddz);
}

// point_triangle_distance_sq_soa's d2, evaluating only the path the cell
// takes: the plane projection's weights first; inside, its distance; else
// the two segments that d_edge selects, fminf(first, second) with first
// ab (w23 > 0 or w31 > 0) or ac, second ac (w23 > 0) or bc. The two
// segments' endpoints are selected, not branched on, so lanes in
// different outside cases evaluate two segments together. Every value
// that reaches the result takes the twin's operations in its order, so
// the result has its bits.
template <typename Tri>
__device__ __forceinline__ float cell_d2(float px, float py, float pz,
                                         const Tri& tri) {
  const Plane P = tri.plane();
  const float x03x = px - P.c[0], x03y = py - P.c[1], x03z = pz - P.c[2];
  const float pa = d3(P.x13[0], P.x13[1], P.x13[2], x03x, x03y, x03z);
  const float pb = d3(P.x23[0], P.x23[1], P.x23[2], x03x, x03y, x03z);
  const float w23 = P.invdet * (P.m23 * pa - P.d * pb);
  const float w31 = P.invdet * (P.m13 * pb - P.d * pa);
  const float w12 = 1.0f - w23 - w31;
  if ((w23 >= 0.0f) && (w31 >= 0.0f) && (w12 >= 0.0f)) {
    const float ex = px - (w23 * P.a[0] + w31 * P.b[0] + w12 * P.c[0]);
    const float ey = py - (w23 * P.a[1] + w31 * P.b[1] + w12 * P.c[1]);
    const float ez = pz - (w23 * P.a[2] + w31 * P.b[2] + w12 * P.c[2]);
    return d3(ex, ey, ez, ex, ey, ez);
  }
  const bool ab = (w23 > 0.0f) || (w31 > 0.0f);  // first: ab, else ac
  const bool ac = w23 > 0.0f;                    // second: ac, else bc
  float x2f[3], x1s[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    x2f[q] = ab ? P.b[q] : P.c[q];
    x1s[q] = ac ? P.a[q] : P.b[q];
  }
  return fminf(
      seg_d2_terms(px, py, pz, P.a, x2f, tri.edge(P.a, x2f, ab ? 0 : 1)),
      seg_d2_terms(px, py, pz, x1s, P.c, tri.edge(x1s, P.c, ac ? 1 : 2)));
}

__global__ void __launch_bounds__(kThreads)
recompute_terms_kernel(const float* __restrict__ tri, int m,
                       float4* __restrict__ table) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= m) return;
  float v[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) v[e] = tri[9LL * t + e];
  const Plane P = plane_from_verts(v);
  float4* row = table + (long long)t * kQuads;
  row[0] = make_float4(P.a[0], P.a[1], P.a[2], P.b[0]);
  row[1] = make_float4(P.b[1], P.b[2], P.c[0], P.c[1]);
  row[2] = make_float4(P.c[2], P.invdet, P.m13, P.m23);
  row[3] = make_float4(P.x13[0], P.x13[1], P.x13[2], P.d);
  row[4] = make_float4(P.x23[0], P.x23[1], P.x23[2], 0.0f);
  row[5] = edge_terms(P.a, P.b);
  row[6] = edge_terms(P.a, P.c);
  row[7] = edge_terms(P.b, P.c);
}

// phi of one cell (i, j, k) with id t, parity par and triangle terms tr
// (local; `off` is the block's global index of cell (0, 0, 0))
template <typename Tri>
__device__ __forceinline__ float cell_phi(int t, unsigned char par, int i,
                                          int j, int k, const Tri& tr,
                                          int3 off, float ox, float oy,
                                          float oz, float dx, float upper) {
  float d = upper;
  if (t >= 0) {
    const float d2 = cell_d2((float)(i + off.x) * dx + ox,
                             (float)(j + off.y) * dx + oy,
                             (float)(k + off.z) * dx + oz, tr);
    d = sqrtf(fmaxf(d2, 1e-30f));
  }
  return par ? -d : d;
}

// (i, j, k) += (si, sj, sk), a number of cells written as mixed-radix
// digits (sj < nj, sk < nk), without dividing
__device__ __forceinline__ void walk(int& i, int& j, int& k, int si, int sj,
                                     int sk, int nj, int nk) {
  k += sk;
  if (k >= nk) {
    k -= nk;
    ++j;
  }
  j += sj;
  if (j >= nj) {
    j -= nj;
    ++i;
  }
  i += si;
}

// `cells` as mixed-radix digits (si, sj, sk) of a (nj, nk) plane
template <typename Index>
__device__ __forceinline__ void digits(Index cells, Index plane, int nk,
                                       int& si, int& sj, int& sk) {
  const Index r = cells % plane;
  si = (int)(cells / plane);
  sj = (int)(r / (Index)nk);
  sk = (int)(r % (Index)nk);
}

// (i, j, k) += one cell, k fastest
__device__ __forceinline__ void next_cell(int& i, int& j, int& k, int nj,
                                          int nk) {
  if (++k == nk) {
    k = 0;
    if (++j == nj) {
      j = 0;
      ++i;
    }
  }
}

// R1. Thread g takes the chunks of kVec cells v = g, g + G, .. (G threads
// in all). kVec = 4: an int4 of ids, a uchar4 of parities and a float4 of
// phi per chunk (the wrapper passes 16-byte aligned ids and phi, 4-byte
// aligned parities), the n % 4 cells past the last whole chunk to threads
// 0-2, one each; kVec = 1: a cell a step, so that more threads gather
// triangles at once (ops/recompute.r1_config picks per M). (i, j, k) of
// the thread's first cell comes from one division; then it steps one cell
// within a chunk and walks kVec G cells between chunks as mixed-radix
// digits, without dividing.
template <typename Index, int kForm, int kVec, bool kShift>
__global__ void __launch_bounds__(kThreads)
recompute_phi_kernel(const float* __restrict__ tri,
                     const float4* __restrict__ table,
                     const int* __restrict__ tid,
                     const unsigned char* __restrict__ parity, Index n,
                     int nj, int nk, int3 shift, float ox, float oy, float oz,
                     float dx, float upper, int m, float* __restrict__ phi) {
  static_assert(kVec == 1 || kVec == 4, "one or four cells a chunk");
  const int3 off = kShift ? shift : make_int3(0, 0, 0);
  extern __shared__ float4 stab[];
  if (kForm == kShared) {
    for (int e = threadIdx.x; e < m * kQuads; e += kThreads)
      stab[e] = table[e];
    __syncthreads();
  }
  const Index g = (Index)blockIdx.x * kThreads + threadIdx.x;
  const Index threads = (Index)gridDim.x * kThreads;
  const Index chunks = n / kVec;
  const Index plane = (Index)nj * (Index)nk;
  if (g < n - kVec * chunks) {  // the ragged tail
    const Index c = kVec * chunks + g;
    int i, j, k;
    digits(c, plane, nk, i, j, k);
    const int t = tid[c];
    phi[c] = cell_phi(t, parity[c], i, j, k,
                      load_tri<kForm>(t, tri, stab), off, ox, oy, oz, dx,
                      upper);
  }
  if (g >= chunks) return;
  int ci, cj, ck, si, sj, sk;
  digits(kVec * g, plane, nk, ci, cj, ck);
  digits(kVec * threads, plane, nk, si, sj, sk);  // past n: unused
  for (Index v = g; v < chunks; v += threads) {
    if constexpr (kVec == 4) {
      const int4 t4 = reinterpret_cast<const int4*>(tid)[v];
      const uchar4 p4 = reinterpret_cast<const uchar4*>(parity)[v];
      const int t[4] = {t4.x, t4.y, t4.z, t4.w};
      const unsigned char par[4] = {p4.x, p4.y, p4.z, p4.w};
      float out[4];
      int i = ci, j = cj, k = ck;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q] = cell_phi(t[q], par[q], i, j, k,
                          load_tri<kForm>(t[q], tri, stab), off, ox, oy,
                          oz, dx, upper);
        next_cell(i, j, k, nj, nk);
      }
      reinterpret_cast<float4*>(phi)[v] =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {
      const int t = tid[v];
      phi[v] = cell_phi(t, parity[v], ci, cj, ck,
                        load_tri<kForm>(t, tri, stab), off, ox, oy, oz, dx,
                        upper);
    }
    walk(ci, cj, ck, si, sj, sk, nj, nk);
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

// The carried run's flush (key >= 0) from the lanes' carries in shared
// memory: lane q < 9 sums component q of lanes 0-15 in ascending order,
// lane 16 + q that of lanes 16-31; lane q adds the two halves and writes
// into the warp's row (kRows; a store at the key's first flush, marked in
// the warp's 32 mask words `seen`) or the shared accumulator (atomically).
template <bool kRows>
__device__ __forceinline__ void flush_carry(double* out, int key, int lane,
                                            double (*acc)[kThreads],
                                            unsigned* seen) {
  __syncwarp();  // the other lanes' carries
  const int q = lane & 15;
  const double* a = &acc[q < 9 ? q : 0][(threadIdx.x & ~31) + (lane & 16)];
  double s = 0.0;
  if (q < 9) {
#pragma unroll
    for (int l = 0; l < 16; ++l) s += a[l];
  }
  s += __shfl_down_sync(kFullMask, s, 16);
  if (kRows) {
    // lane 0 reads and marks the key's bit and passes what it read on
    const unsigned bit = 1u << (key & 31);
    unsigned word = 0;
    if (lane == 0) {
      word = seen[key >> 5];
      seen[key >> 5] = word | bit;
    }
    const bool first = (__shfl_sync(kFullMask, word, 0) & bit) == 0;
    if (lane < 9) {
      if (first)
        out[9 * key + lane] = s;
      else
        out[9 * key + lane] += s;
    }
  } else if (lane < 9) {
    atomicAdd(out + 9LL * key + lane, s);
  }
  __syncwarp();  // before the carries are written again
}

template <typename Index, bool kRows, bool kShift>
__global__ void __launch_bounds__(kThreads)
recompute_vjp_kernel(const float* __restrict__ tri,
                     const int* __restrict__ tid,
                     const unsigned char* __restrict__ parity,
                     const float* __restrict__ grad_phi, Index n, int nj,
                     int nk, int3 shift, float ox, float oy, float oz,
                     float dx, Index span, int ranges, int m9,
                     double* __restrict__ out, unsigned* __restrict__ masks) {
  const int3 off = kShift ? shift : make_int3(0, 0, 0);
  // the carry, per lane: in shared memory, so that it holds no registers
  // while cell_vjp runs
  __shared__ double acc[9][kThreads];
  // kRows: the keys this warp has flushed, one bit each
  __shared__ unsigned seen_words[kWarps][kRows ? 32 : 1];
  const int lane = threadIdx.x & 31;
  const int range = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (range >= ranges) return;  // whole warps
  unsigned* seen = seen_words[threadIdx.x >> 5];
  if (kRows) {
    out += (long long)range * m9;
    seen[lane] = 0;
  }
  const Index begin = (Index)range * span;
  const Index end = begin + span < n ? begin + span : n;
  int key = -1;  // the carried run's key (warp-uniform)
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q][threadIdx.x] = 0.0;
  // the lane's cell as (i, j, k), divided once and then walked 32 cells a
  // step
  int ci, cj, ck;
  {
    const Index c0 = begin + lane;
    const Index r = c0 / (Index)nk;
    ck = (int)(c0 % (Index)nk);
    cj = (int)(r % (Index)nj);
    ci = (int)(r / (Index)nj);
  }
  // the next step's id, gradient and parity are loaded a step ahead
  int t_next = -1;
  float up_next = 0.0f;
  unsigned char par_next = 0;
  if (begin + lane < end) {
    t_next = tid[begin + lane];
    up_next = grad_phi[begin + lane];
    par_next = parity[begin + lane];
  }
  // the loop bound is uniform over the warp, so every lane reaches the
  // warp collectives together
  for (Index base = begin; base < end;
       base += 32, ck += 32) {
    while (ck >= nk) {
      ck -= nk;
      if (++cj == nj) {
        cj = 0;
        ++ci;
      }
    }
    int t = t_next;
    const float up = up_next;
    const bool odd = par_next != 0;
    const Index c_next = base + 32 + lane;
    if (c_next < end) {
      t_next = tid[c_next];
      up_next = grad_phi[c_next];
      par_next = parity[c_next];
    } else {
      t_next = -1;
    }
    float g[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) g[q] = 0.0f;
    if (t < 0) {
      t = -1;
    } else if (up != 0.0f) {
      const float p[3] = {(float)(ci + off.x) * dx + ox,
                          (float)(cj + off.y) * dx + oy,
                          (float)(ck + off.z) * dx + oz};
      cell_vjp(p, tri + 9LL * t, odd ? -up : up, g);
    }
    const unsigned same = __ballot_sync(kFullMask, t == key);
    if (same == kFullMask) {
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q][threadIdx.x] += (double)g[q];
      continue;
    }
    const int below = __shfl_up_sync(kFullMask, t, 1);
    const unsigned heads = __ballot_sync(kFullMask, lane == 0 || t != below);
    const unsigned later = heads & ~1u;
    const int lead_end = later ? __ffs(later) - 1 : 32;
    const int last = 31 - __clz(heads);  // the head of lane 31's run
    const bool joins = (same & 1u) != 0;
    if (joins && lane < lead_end) {
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q][threadIdx.x] += (double)g[q];
    }
    if (key >= 0) flush_carry<kRows>(out, key, lane, acc, seen);
    // runs that start and end in this step
    const unsigned mids = heads & ~(1u << last) & (joins ? ~1u : ~0u);
    if (mids != 0) {
      const int start = 31 - __clz(heads & ((2u << lane) - 1u));
      double s[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) s[q] = (double)g[q];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const double u = __shfl_up_sync(kFullMask, s[q], off);
          if (lane - off >= start) s[q] += u;
        }
      }
      // a run's last lane: the next head's lane - 1
      const unsigned next = heads & ~((2u << lane) - 1u);
      const int tail_of = next ? __ffs(next) - 2 : 31;
      const bool mid_tail = ((mids >> start) & 1u) && tail_of == lane;
      if (kRows) {
        // the tails flush at once where their keys differ; a key's runs in
        // ascending lane order, one round each, the first a store if the
        // warp has not flushed the key before
        const bool mine = mid_tail && t >= 0;
        const unsigned peers = __match_any_sync(kFullMask,
                                                mine ? t : -2 - lane);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const unsigned bit = 1u << (t & 31);
        const bool fresh = mine && rank == 0 && (seen[t >> 5] & bit) == 0;
        const int rounds = __reduce_max_sync(kFullMask, mine ? rank + 1 : 0);
        for (int r = 0; r < rounds; ++r) {
          if (mine && rank == r) {
#pragma unroll
            for (int q = 0; q < 9; ++q) {
              if (fresh)
                out[9 * t + q] = s[q];
              else
                out[9 * t + q] += s[q];
            }
          }
          __syncwarp();
        }
        if (fresh) atomicOr(&seen[t >> 5], bit);  // shared memory
      } else if (mid_tail && t >= 0) {
#pragma unroll
        for (int q = 0; q < 9; ++q) atomicAdd(out + 9LL * t + q, s[q]);
      }
    }
    if (kRows) __syncwarp();
    key = __shfl_sync(kFullMask, t, 31);
#pragma unroll
    for (int q = 0; q < 9; ++q)
      acc[q][threadIdx.x] = lane >= last ? (double)g[q] : 0.0;
  }
  if (key >= 0) flush_carry<kRows>(out, key, lane, acc, seen);
  if (kRows) {
    __syncwarp();
    masks[32 * range + lane] = seen[lane];
  }
}

// The rows' column c summed in float64 over `groups` x kSlices slices:
// thread (x, y) of block (bx, g), 32 x kSlices threads, takes column
// bx * 32 + x and slice g * kSlices + y: the rows y', y' + groups * kSlices,
// .. whose mask holds the column's key, in ascending order from 0.0; then a
// tree over the block's slices at strides 16, 8, 4, 2, 1. One group: the
// float32 cast into out[c]; else the group's sum into parts[g][c].
__global__ void __launch_bounds__(32 * kSlices)
vjp_rows_sum_kernel(const double* __restrict__ rows,
                    const unsigned* __restrict__ masks, int ranges, int m9,
                    double* __restrict__ parts, float* __restrict__ out) {
  __shared__ double part[kSlices][33];
  const int x = threadIdx.x & 31;
  const int y = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + x;
  const int stride = gridDim.y * kSlices;
  double s = 0.0;
  if (col < m9) {
    const int key = col / 9;
    const unsigned* mask = masks + (key >> 5);
    const unsigned bit = 1u << (key & 31);
    for (int r = blockIdx.y * kSlices + y; r < ranges; r += stride)
      if (mask[32 * r] & bit) s += rows[(long long)r * m9 + col];
  }
  part[y][x] = s;
  __syncthreads();
#pragma unroll
  for (int st = kSlices / 2; st > 0; st >>= 1) {
    if (y < st) part[y][x] += part[y + st][x];
    __syncthreads();
  }
  if (y == 0 && col < m9) {
    if (gridDim.y == 1)
      out[col] = (float)part[0][x];
    else
      parts[(long long)blockIdx.y * m9 + col] = part[0][x];
  }
}

// out[c] = float32 of the groups' sums of column c, in ascending order from
// 0.0.
__global__ void __launch_bounds__(kThreads)
vjp_parts_sum_kernel(const double* __restrict__ parts, int groups, int m9,
                     float* __restrict__ out) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= m9) return;
  double s = 0.0;
  for (int g = 0; g < groups; ++g) s += parts[(long long)g * m9 + col];
  out[col] = (float)s;
}

// blocks of kThreads threads for n work items: enough for n, at most four
// times what the SMs hold at once with `smem` bytes of dynamic shared
// memory a block
template <typename Kernel>
cudaError_t grid_blocks(Kernel kernel, long long n, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1) * 4;
  *blocks = (int)(need < fit ? need : fit);
  return cudaSuccess;
}

// A block with a nonzero offset takes the kShift instantiations; the
// unshifted ones (one device, a grid's first shard) fold the adds away, so
// the main path's kernels keep their registers and occupancy.
inline bool shifted(int3 off) {
  return off.x != 0 || off.y != 0 || off.z != 0;
}

template <typename Index, int kForm, int kVec>
cudaError_t launch_phi_form(const float* tri, const float4* table,
                            const int* tid, const unsigned char* parity,
                            long long n, int nj, int nk, int3 off, float ox,
                            float oy, float oz, float dx, float upper, int m,
                            float* phi, cudaStream_t stream) {
  const int smem = kForm == kShared ? m * kQuads * 16 : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const auto kernel = shifted(off)
                          ? recompute_phi_kernel<Index, kForm, kVec, true>
                          : recompute_phi_kernel<Index, kForm, kVec, false>;
  int blocks = 0;
  const cudaError_t err =
      grid_blocks(kernel, (n + kVec - 1) / kVec, smem, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(tri, table, tid, parity,
                                             (Index)n, nj, nk, off, ox, oy,
                                             oz, dx, upper, m, phi);
  return cudaGetLastError();
}

template <typename Index, int kForm>
cudaError_t launch_phi_vec(int vec, const float* tri, const float4* table,
                           const int* tid, const unsigned char* parity,
                           long long n, int nj, int nk, int3 off, float ox,
                           float oy, float oz, float dx, float upper, int m,
                           float* phi, cudaStream_t stream) {
  if (vec == 4)
    return launch_phi_form<Index, kForm, 4>(tri, table, tid, parity, n, nj,
                                            nk, off, ox, oy, oz, dx, upper, m,
                                            phi, stream);
  if (vec == 1)
    return launch_phi_form<Index, kForm, 1>(tri, table, tid, parity, n, nj,
                                            nk, off, ox, oy, oz, dx, upper, m,
                                            phi, stream);
  return cudaErrorInvalidValue;
}

template <typename Index>
cudaError_t launch_phi(int form, int vec, const float* tri,
                       const float4* table, const int* tid,
                       const unsigned char* parity, long long n, int nj,
                       int nk, int3 off, float ox, float oy, float oz,
                       float dx, float upper, int m, float* phi,
                       cudaStream_t stream) {
  switch (form) {
    case kShared:
      return launch_phi_vec<Index, kShared>(vec, tri, table, tid, parity, n,
                                            nj, nk, off, ox, oy, oz, dx, upper,
                                            m, phi, stream);
    case kVerts:
      return launch_phi_vec<Index, kVerts>(vec, tri, table, tid, parity, n,
                                           nj, nk, off, ox, oy, oz, dx, upper,
                                           m, phi, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kRows>
cudaError_t launch_vjp(const float* tri, const int* tid,
                       const unsigned char* parity, const float* grad_phi,
                       long long n, int nj, int nk, int3 off, float ox,
                       float oy, float oz, float dx, long long span,
                       int ranges, int m9, double* out, unsigned* masks,
                       cudaStream_t stream) {
  const int blocks = (ranges + kWarps - 1) / kWarps;
  if (n < (1LL << 31)) {
    const auto kernel = shifted(off)
                            ? recompute_vjp_kernel<unsigned, kRows, true>
                            : recompute_vjp_kernel<unsigned, kRows, false>;
    kernel<<<blocks, kThreads, 0, stream>>>(
        tri, tid, parity, grad_phi, (unsigned)n, nj, nk, off, ox, oy, oz, dx,
        (unsigned)span, ranges, m9, out, masks);
  } else {
    const auto kernel =
        shifted(off) ? recompute_vjp_kernel<unsigned long long, kRows, true>
                     : recompute_vjp_kernel<unsigned long long, kRows, false>;
    kernel<<<blocks, kThreads, 0, stream>>>(
        tri, tid, parity, grad_phi, (unsigned long long)n, nj, nk, off, ox,
        oy, oz, dx, (unsigned long long)span, ranges, m9, out, masks);
  }
  return cudaGetLastError();
}

}  // namespace

// R1's table: `table` ((m, 32) float32, 16-byte aligned) gets the
// per-triangle terms of the m triangles `tri` ((m, 9) float32), one launch.
extern "C" int sdf_recompute_terms(const float* tri, int m, float* table,
                                   void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  recompute_terms_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(
      tri, m, reinterpret_cast<float4*>(table));
  return (int)cudaGetLastError();
}

// The cells of R1 and R1b are the (n / (nj nk), nj, nk) block whose cell
// (0, 0, 0) has the global index (oi, oj, ok): cell (i, j, k) sits at
// f32(i + oi) * dx + ox (zeros on one device; a shard's offset when sharded).

// R1: `form` is a PhiForm, `vec` (1 or 4) the cells a thread takes at a
// time. kShared reads `table`, filled by sdf_recompute_terms, and takes
// m <= 384 (48 KB); kVerts reads only `tri`. With vec = 4, tid and phi
// 16-byte aligned and parity 4-byte.
extern "C" int sdf_recompute_phi(const float* tri, const float* table,
                                 const int* tid, const unsigned char* parity,
                                 long long n, int nj, int nk, int oi, int oj,
                                 int ok, float ox, float oy, float oz,
                                 float dx, float upper, int m, int form,
                                 int vec, float* phi, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int3 off = make_int3(oi, oj, ok);
  return (int)(n < (1LL << 31)
                   ? launch_phi<unsigned>(form, vec, tri, table4, tid, parity,
                                          n, nj, nk, off, ox, oy, oz, dx,
                                          upper, m, phi, s)
                   : launch_phi<unsigned long long>(
                         form, vec, tri, table4, tid, parity, n, nj, nk, off,
                         ox, oy, oz, dx, upper, m, phi, s));
}

// M > 1024: the flushes go to `grad_tri` ((M, 9) float64, zeroed by the
// caller) by atomics.
extern "C" int sdf_recompute_vjp(const float* tri, const int* tid,
                                 const unsigned char* parity,
                                 const float* grad_phi, long long n, int nj,
                                 int nk, int oi, int oj, int ok, float ox,
                                 float oy, float oz, float dx, long long span,
                                 int ranges, double* grad_tri, void* stream) {
  if (n <= 0 || ranges <= 0) return (int)cudaGetLastError();
  return (int)launch_vjp<false>(tri, tid, parity, grad_phi, n, nj, nk,
                                make_int3(oi, oj, ok), ox, oy, oz, dx, span,
                                ranges, 0, grad_tri, nullptr,
                                (cudaStream_t)stream);
}

// M <= 1024: the flushes go to `rows` ((ranges, M, 9) float64 scratch,
// never zeroed) and the keys each range flushed to `masks` ((ranges, 32)),
// then the flushed entries are summed in `groups` groups of row slices
// (their sums in `parts`, (groups, M, 9) float64, when groups > 1) into
// `grad` ((M, 9) float32).
extern "C" int sdf_recompute_vjp_rows(const float* tri, const int* tid,
                                      const unsigned char* parity,
                                      const float* grad_phi, long long n,
                                      int nj, int nk, int oi, int oj, int ok,
                                      float ox, float oy, float oz, float dx,
                                      long long span, int ranges, int m,
                                      int groups, double* rows,
                                      unsigned* masks, double* parts,
                                      float* grad, void* stream) {
  if (m > 1024 || groups < 1)  // the masks' bits
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || ranges <= 0 || m <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_vjp<true>(tri, tid, parity, grad_phi, n, nj, nk,
                                     make_int3(oi, oj, ok), ox, oy, oz, dx,
                                     span, ranges, 9 * m, rows, masks, s);
  if (err != cudaSuccess) return (int)err;
  vjp_rows_sum_kernel<<<dim3((9 * m + 31) / 32, groups), 32 * kSlices, 0,
                        s>>>(rows, masks, ranges, 9 * m, parts, grad);
  if (groups > 1)
    vjp_parts_sum_kernel<<<(9 * m + kThreads - 1) / kThreads, kThreads, 0,
                           s>>>(parts, groups, 9 * m, grad);
  return (int)cudaGetLastError();
}
