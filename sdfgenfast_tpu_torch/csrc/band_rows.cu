// K2: narrow-band tile evaluation over CSR candidate segments.
//
// Replaces sdfgenfast_tpu/ops/band_pallas.py::_band_kernel (wrapper
// band_rows_pallas). For every active 8x8x8 tile, each cell takes the exact
// squared distance to every candidate of the tile's segment
// pair[off[a] .. off[a] + cnt[a]) (plane distance for barycentric-inside
// cells, the clamped-edge difference form otherwise), walked in ascending
// order with a strict '<', so the earliest (lowest-id) candidate wins exact
// d2 ties, as in the Pallas chunk reduction. Per cell the kernel writes phi
// (or `upper` when no candidate is below upper^2), the winner's triangle id
// (-1 for none) and the closest point p - dd (FAR for none) into row ids[a]
// of five (T+1, 512) row arrays. Slots with ids[a] >= T (padding) are
// skipped. Cell positions come from the coordinate id cids[a] on a
// (., ctj, ctk) tile grid and `upper` from dims_sum: the row's own tile and
// grid on one device; on a shard's block the global tile id and the global
// grid, so that every cell equals the single-device run's.
//
// Two launches:
// - band_coefs_kernel, one thread per triangle, builds the 40 affine
//   coefficients of every triangle once (edge vectors and projections,
//   barycentric gradients, unit normal, the degenerate flag) into a
//   triangle-major (M, 40) table: ten 16-byte words per triangle.
// - band_rows_kernel, one block of 64 threads per active tile. Thread r
//   owns the kCells = 8 cells of the tile's (i, j) row r, consecutive in k.
//   The tile's candidate rows are copied into shared memory with 16-byte
//   cp.async copies by every thread, in chunks of kChunk candidates,
//   double-buffered (sphere82k's segments, at most 121 candidates, take two
//   chunks); sentinel ids (>= M) are never copied and are skipped by the
//   walk. Each candidate's words are float4 broadcasts. The row half of each
//   affine form, cx*x + (cy*y + c0), and the x and y edge offsets are
//   computed once per candidate and shared by the thread's 8 cells; only
//   the lane half (+ cz*z) and the rest run per cell. The walk tracks only
//   the best d2 and its id; after the walk, each cell evaluates its winner
//   once more with the same arithmetic to get p - cp (bit-equal to tracking
//   it), where the inside/edge choice is made.
//
// TPU artefacts dropped: the 0x40000000 id bias (a TPU denormal-flush
// workaround; ids are plain int32 here), the (P, 128) lane-padded pair
// table and its kcap DMA window, and the sentinel row (ids >= M are
// skipped).
//
// Bound on the H100: the FP32 instruction rate. Each (cell, candidate) pair
// costs ~58 instructions (the 90 FP32 operations of the formula, less the
// row halves that 8 cells share), plus ~45 per candidate and thread for the
// row halves and the ten shared loads. Device-memory traffic: the table row
// of each candidate (from L2), the CSR arrays, and 20 bytes per cell
// written. The plane-bound cull of the dense kernel is not used: on a
// finely tessellated sphere every candidate's plane passes within a
// fraction of a cell of the cells' nearest point, so it skips almost
// nothing. Built with --fmad=false so products and sums round like the
// PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kTileCells = 512;  // 8x8x8
constexpr int kCells = 8;        // consecutive k cells per thread
constexpr int kThreads = kTileCells / kCells;  // one per (i, j) row: 64
constexpr int kChunk = 64;       // candidates per shared-memory stage
constexpr int kRowWords = 10;    // 40 coefficients as ten float4
constexpr int kCoefThreads = 128;  // triangles per coefficient-pass block
constexpr float kFar = 3e18f;    // closest point of cells without a winner

// The (M, 40) table's rows, word by word (ops/band_kernel._band_coefs):
//   0: n (unit normal) x y z, h0      1: g23 x y z, g23c
//   2: g31 x y z, g31c                3-5: e_ab, e_ac, e_bc: e x y z, e0
//   6: w_ab x y z, w_ac x             7: w_ac y z, w_bc x y
//   8: w_bc z, b x y z                9: c x y z, degenerate flag
// e.p + e0 is an edge's parameter along w = x1 - x2 from x2 (ab: x2 = b;
// ac, bc: x2 = c); g23.p + g23c and g31.p + g31c the barycentric weights.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// clamp(a + b, 0, 1) in one instruction
__device__ __forceinline__ float add_sat(float a, float b) {
  float r;
  asm("add.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void edge_coef(float x1x, float x1y, float x1z,
                                          float x2x, float x2y, float x2z,
                                          float* w, float4& e) {
  // s_raw = dot(p - x2, x1 - x2) / |x1 - x2|^2 written as e.p + e0
  w[0] = x1x - x2x;
  w[1] = x1y - x2y;
  w[2] = x1z - x2z;
  const float m2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float inv = 1.0f / fmaxf(m2, 1e-30f);
  e = make_float4(w[0] * inv, w[1] * inv, w[2] * inv,
                  -(x2x * w[0] + x2y * w[1] + x2z * w[2]) * inv);
}

// One triangle's row of the table from its 9 vertex coordinates.
__device__ __forceinline__ void triangle_row(const float* v, float4* row) {
  const float ax = v[0], ay = v[1], az = v[2];
  const float bx = v[3], by = v[4], bz = v[5];
  const float cx = v[6], cy = v[7], cz = v[8];
  float wab[3], wac[3], wbc[3];
  float4 eab, eac, ebc;
  edge_coef(ax, ay, az, bx, by, bz, wab, eab);
  edge_coef(ax, ay, az, cx, cy, cz, wac, eac);
  edge_coef(bx, by, bz, cx, cy, cz, wbc, ebc);

  const float x13x = ax - cx, x13y = ay - cy, x13z = az - cz;
  const float x23x = bx - cx, x23y = by - cy, x23z = bz - cz;
  const float m13 = x13x * x13x + x13y * x13y + x13z * x13z;
  const float m23 = x23x * x23x + x23y * x23y + x23z * x23z;
  const float d = x13x * x23x + x13y * x23y + x13z * x23z;
  const float invdet = 1.0f / fmaxf(m13 * m23 - d * d, 1e-30f);
  const float g23x = invdet * (m23 * x13x - d * x23x);
  const float g23y = invdet * (m23 * x13y - d * x23y);
  const float g23z = invdet * (m23 * x13z - d * x23z);
  const float g31x = invdet * (m13 * x23x - d * x13x);
  const float g31y = invdet * (m13 * x23y - d * x13y);
  const float g31z = invdet * (m13 * x23z - d * x13z);

  const float crx = x13y * x23z - x13z * x23y;
  const float cry = x13z * x23x - x13x * x23z;
  const float crz = x13x * x23y - x13y * x23x;
  const float cr2 = crx * crx + cry * cry + crz * crz;
  // 1 / sqrt, each correctly rounded: the twin computes the same on the CPU
  const float rn = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(cr2, 1e-37f)));
  const float nx = crx * rn, ny = cry * rn, nz = crz * rn;

  row[0] = make_float4(nx, ny, nz, -(nx * cx + ny * cy + nz * cz));
  row[1] = make_float4(g23x, g23y, g23z, -(g23x * cx + g23y * cy + g23z * cz));
  row[2] = make_float4(g31x, g31y, g31z, -(g31x * cx + g31y * cy + g31z * cz));
  row[3] = eab;
  row[4] = eac;
  row[5] = ebc;
  row[6] = make_float4(wab[0], wab[1], wab[2], wac[0]);
  row[7] = make_float4(wac[1], wac[2], wbc[0], wbc[1]);
  row[8] = make_float4(wbc[2], bx, by, bz);
  row[9] = make_float4(cx, cy, cz, cr2 <= 1e-30f ? 1.0f : 0.0f);
}

// One thread per triangle; a block's vertices come in and its rows go out
// through shared memory, so both are contiguous runs of the device arrays.
__global__ void __launch_bounds__(kCoefThreads)
band_coefs_kernel(const float* __restrict__ tri9, int m,
                  float4* __restrict__ coef) {
  __shared__ float s_in[kCoefThreads * 9];
  __shared__ float4 s_out[kCoefThreads * kRowWords];
  const long long t0 = (long long)blockIdx.x * kCoefThreads;
  const int n = (int)min((long long)kCoefThreads, m - t0);
  for (int w = threadIdx.x; w < n * 9; w += kCoefThreads)
    s_in[w] = tri9[9 * t0 + w];
  __syncthreads();
  if (threadIdx.x < n)
    triangle_row(s_in + 9 * threadIdx.x, s_out + kRowWords * threadIdx.x);
  __syncthreads();
  for (int w = threadIdx.x; w < n * kRowWords; w += kCoefThreads)
    coef[kRowWords * t0 + w] = s_out[w];
}

// One candidate's row halves at the thread's (x, y).
struct Rows {
  float4 n, g23, g31, eab, eac, ebc, w6, w7, w8, w9;
  float hu, w23u, w31u, sab, sac, sbc, ubx, uby, ucx, ucy;
};

__device__ __forceinline__ Rows row_halves(const float4* g, float x,
                                           float y) {
  Rows r;
  r.n = g[0];
  r.g23 = g[1];
  r.g31 = g[2];
  r.eab = g[3];
  r.eac = g[4];
  r.ebc = g[5];
  r.w6 = g[6];
  r.w7 = g[7];
  r.w8 = g[8];
  r.w9 = g[9];
  r.hu = r.n.x * x + (r.n.y * y + r.n.w);
  r.w23u = r.g23.x * x + (r.g23.y * y + r.g23.w);
  r.w31u = r.g31.x * x + (r.g31.y * y + r.g31.w);
  // a degenerate candidate is never inside: w23 = -inf fails the test
  if (r.w9.w != 0.0f) r.w23u = -__int_as_float(0x7f800000);
  r.sab = r.eab.x * x + (r.eab.y * y + r.eab.w);
  r.sac = r.eac.x * x + (r.eac.y * y + r.eac.w);
  r.sbc = r.ebc.x * x + (r.ebc.y * y + r.ebc.w);
  r.ubx = x - r.w8.y;
  r.uby = y - r.w8.z;
  r.ucx = x - r.w9.x;
  r.ucy = y - r.w9.y;
  return r;
}

struct Edge {
  float d2, ddx, ddy, ddz;
};

// p - (x2 + s*w) and its square, s = clamp(su + ez*z, 0, 1), u = p - x2.
__device__ __forceinline__ Edge edge(float su, float ez, float z, float wx,
                                     float wy, float wz, float ux, float uy,
                                     float uz) {
  const float s = add_sat(su, ez * z);
  Edge e;
  e.ddx = ux - s * wx;
  e.ddy = uy - s * wy;
  e.ddz = uz - s * wz;
  e.d2 = e.ddx * e.ddx + e.ddy * e.ddy + e.ddz * e.ddz;
  return e;
}

// The cell at z: its plane distance h, whether its projection is inside,
// and the three edges.
struct Cell {
  float h;
  bool inside;
  Edge ab, ac, bc;
};

__device__ __forceinline__ Cell cell(const Rows& r, float z) {
  Cell c;
  c.h = r.hu + r.n.z * z;
  const float w23 = r.w23u + r.g23.z * z;
  const float w31 = r.w31u + r.g31.z * z;
  // min(w23, w31, (1 - w23) - w31) >= 0 as three compares: a rounded
  // difference a - b is >= 0 exactly when a >= b
  c.inside = w23 >= 0.0f && w31 >= 0.0f && 1.0f - w23 >= w31;
  const float ubz = z - r.w8.w;
  const float ucz = z - r.w9.z;
  c.ab = edge(r.sab, r.eab.z, z, r.w6.x, r.w6.y, r.w6.z, r.ubx, r.uby, ubz);
  c.ac = edge(r.sac, r.eac.z, z, r.w6.w, r.w7.x, r.w7.y, r.ucx, r.ucy, ucz);
  c.bc = edge(r.sbc, r.ebc.z, z, r.w7.z, r.w7.w, r.w8.x, r.ucx, r.ucy, ucz);
  return c;
}

__device__ __forceinline__ float cell_d2(const Cell& c) {
  return c.inside ? c.h * c.h : fminf(c.ab.d2, fminf(c.ac.d2, c.bc.d2));
}

// Start the copies of a chunk's real candidate rows: slot q's row to
// dst[q * 10 ..], its id to dst_id[q]; sentinel slots are not copied.
__device__ __forceinline__ void stage_chunk(float4* dst, int* dst_id,
                                            const float4* __restrict__ coef,
                                            const int* __restrict__ seg,
                                            int count, int num_tris) {
  for (int w = threadIdx.x; w < count * kRowWords; w += kThreads) {
    const int q = w / kRowWords;
    const int id = seg[q];
    if (w == q * kRowWords) dst_id[q] = id;
    if (id >= 0 && id < num_tris)
      cp_async16(dst + w,
                 coef + (long long)id * kRowWords + (w - q * kRowWords));
  }
}

__global__ void __launch_bounds__(kThreads)
band_rows_kernel(const float4* __restrict__ coef, int num_tris,
                 const int* __restrict__ pair, const int* __restrict__ ids,
                 const int* __restrict__ cids, const int* __restrict__ off,
                 const int* __restrict__ cnt, int num_tiles, int ctj, int ctk,
                 int dims_sum, float dx,
                 float* __restrict__ phi, int* __restrict__ tid,
                 float* __restrict__ cpx, float* __restrict__ cpy,
                 float* __restrict__ cpz) {
  __shared__ float4 stage[2][kChunk * kRowWords];
  __shared__ int s_id[2][kChunk];

  const int a = blockIdx.x;
  const int r = threadIdx.x;  // the tile's (i, j) row: i = r / 8, j = r % 8
  const int t = ids[a];
  if (t >= num_tiles) return;  // a padded slot
  const int g = cids[a];
  const int tk = g % ctk;
  const int tj = (g / ctk) % ctj;
  const int ti = g / (ctk * ctj);
  const float x = (float)(ti * 8 + r / 8) * dx;
  const float y = (float)(tj * 8 + r % 8) * dx;
  float z[kCells], best[kCells];
  int best_id[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    z[c] = (float)(tk * 8 + c) * dx;
    best[c] = __int_as_float(0x7f800000);  // +inf
    best_id[c] = -1;
  }

  const int* seg = pair + off[a];
  const int n = cnt[a];
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    stage_chunk(stage[0], s_id[0], coef, seg, min(kChunk, n), num_tris);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int base = ch * kChunk;
    if (ch + 1 < n_chunks) {
      // the other buffer was released by the barrier that ended chunk ch-1
      const int nb = (ch + 1) & 1;
      stage_chunk(stage[nb], s_id[nb], coef, seg + base + kChunk,
                  min(kChunk, n - base - kChunk), num_tris);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tab = stage[ch & 1];
    const int* tab_id = s_id[ch & 1];
    const int q_n = min(kChunk, n - base);
    for (int q = 0; q < q_n; ++q) {
      const int id = tab_id[q];
      if (id < 0 || id >= num_tris) continue;  // sentinel padding never wins
      const Rows rw = row_halves(tab + q * kRowWords, x, y);
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        const float d2 = cell_d2(cell(rw, z[c]));
        if (d2 < best[c]) {
          best[c] = d2;
          best_id[c] = id;
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }

  // retire: each cell's winner once more, for its closest point
  const float upper = (float)dims_sum * dx;  // makelevelset3.cpp:197
  float o_phi[kCells], o_x[kCells], o_y[kCells], o_z[kCells];
  int o_tid[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const bool has = best[c] < upper * upper;
    o_phi[c] = has ? sqrtf(best[c]) : upper;
    o_tid[c] = has ? best_id[c] : -1;
    o_x[c] = o_y[c] = o_z[c] = kFar;
    if (has) {
      const Rows rw =
          row_halves(coef + (long long)best_id[c] * kRowWords, x, y);
      const Cell e = cell(rw, z[c]);
      float ddx, ddy, ddz;
      if (e.inside) {
        ddx = e.h * rw.n.x;
        ddy = e.h * rw.n.y;
        ddz = e.h * rw.n.z;
      } else {
        const bool ab_best = (e.ab.d2 <= e.ac.d2) && (e.ab.d2 <= e.bc.d2);
        const bool ac_best = !ab_best && (e.ac.d2 <= e.bc.d2);
        const Edge& w = ab_best ? e.ab : (ac_best ? e.ac : e.bc);
        ddx = w.ddx;
        ddy = w.ddy;
        ddz = w.ddz;
      }
      o_x[c] = x - ddx;
      o_y[c] = y - ddy;
      o_z[c] = z[c] - ddz;
    }
  }
  // the row's 8 cells are consecutive: two 16-byte stores per array
  const long long o = (long long)t * kTileCells + r * kCells;
  float4* out_phi = reinterpret_cast<float4*>(phi + o);
  int4* out_tid = reinterpret_cast<int4*>(tid + o);
  float4* out_x = reinterpret_cast<float4*>(cpx + o);
  float4* out_y = reinterpret_cast<float4*>(cpy + o);
  float4* out_z = reinterpret_cast<float4*>(cpz + o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 4 * h;
    out_phi[h] =
        make_float4(o_phi[c], o_phi[c + 1], o_phi[c + 2], o_phi[c + 3]);
    out_tid[h] = make_int4(o_tid[c], o_tid[c + 1], o_tid[c + 2], o_tid[c + 3]);
    out_x[h] = make_float4(o_x[c], o_x[c + 1], o_x[c + 2], o_x[c + 3]);
    out_y[h] = make_float4(o_y[c], o_y[c + 1], o_y[c + 2], o_y[c + 3]);
    out_z[h] = make_float4(o_z[c], o_z[c + 1], o_z[c + 2], o_z[c + 3]);
  }
}

}  // namespace

extern "C" int sdf_band_coefs(const float* tri9, int m, float* coef,
                              void* stream) {
  if (m > 0) {
    band_coefs_kernel<<<(m + kCoefThreads - 1) / kCoefThreads, kCoefThreads,
                        0, (cudaStream_t)stream>>>(
        tri9, m, reinterpret_cast<float4*>(coef));
  }
  return (int)cudaGetLastError();
}

extern "C" int sdf_band_rows(const float* coef, int num_tris, const int* pair,
                             const int* ids, const int* cids, const int* off,
                             const int* cnt, int num_active, int num_tiles,
                             int ctj, int ctk, int dims_sum, float dx,
                             float* phi, int* tid, float* cpx, float* cpy,
                             float* cpz, void* stream) {
  if (num_active > 0) {
    band_rows_kernel<<<num_active, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(coef), num_tris, pair, ids, cids, off,
        cnt, num_tiles, ctj, ctk, dims_sum, dx, phi, tid, cpx, cpy, cpz);
  }
  return (int)cudaGetLastError();
}
