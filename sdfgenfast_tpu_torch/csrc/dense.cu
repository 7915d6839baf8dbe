// K1: the dense all-triangles distance field, one kernel for every M <= 1024.
//
// dense_stream_kernel evaluates the separable formulation: every
// affine-in-p quantity of the point-triangle distance (plane distance,
// barycentric weights, edge parameters) comes from the per-triangle (40, M)
// coefficient table of ops/dense._sep_coefs. It replaces both of the JAX
// package's dense kernels, sdfgenfast_tpu/ops/dense.py::_sep_kernel
// (M <= 384, the table in SMEM) and ::_dense_kernel (its per-triangle
// fallback above that). Every cell takes the exact squared distance to every
// triangle, keeps the lowest id among exact ties (ascending walk, strict
// '<'), and writes sqrt(best) and the winner id.
//
// Layout:
// - Each thread owns kCells consecutive k cells of one (i, j) column; a warp
//   owns a compact tile of 8 columns in j by 16 cells in k (128 cells), and
//   a block's 8 warps take 8 consecutive warp tiles along k. The row half of
//   every affine form (the x and y terms, e.g. cf(27)*x + (cf(28)*y +
//   cf(30))) and the edge offsets p.x - x2.x and p.y - x2.y are computed once
//   per triangle and shared by the thread's cells; only the lane half
//   (cf(29)*z) and the sums run per cell, and every shared-memory read feeds
//   kCells cells. This is the Pallas kernel's row/lane split
//   (sdfgenfast_tpu/ops/dense.py:163-238) carried into registers.
// - The table lives in shared memory triangle-major (40 words per triangle),
//   so a triangle's coefficients are ten 16-byte words read as float4
//   broadcasts. A table of at most kChunk triangles (box36: 36) is staged
//   once per block and stays resident while the block walks its warp tiles
//   (kResident, no barriers in the walk); larger tables stream through two
//   kChunk buffers with cp.async, chunk c + 1 in flight while chunk c is
//   evaluated, the last chunk ragged and bounded by index.
// - The plane-bound cull: |h| bounds the distance to a triangle from below,
//   so a triangle is skipped for a whole warp when every cell's h^2 exceeds
//   its own best so far. Degenerate triangles are never skipped. Before the
//   ascending walk, each warp finds the triangle nearest its centre cell
//   (one triangle per lane, a warp argmin) and evaluates it at its own
//   cells; that distance, one ulp up, is every cell's starting bound. So the
//   cull works from the first triangle instead of from +inf, while the walk
//   still takes the first triangle at the minimum: every triangle at the
//   minimum lies below the starting bound.
// - Cells past a column's end (and warps past the grid's end) evaluate a
//   clamped copy of a real cell, so their votes change nothing, and are not
//   stored.
//
// The arithmetic keeps the Pallas kernel's grouping of every affine form
// exactly: cf(27)*x + (cf(28)*y + cf(30)) plus cf(29)*z, and the same for the
// barycentric weights and the three edge parameters. Built with
// --fmad=false, so the kernel equals dense_sep_reference step for step,
// except where the cull decides a near-tie by an ulp: in float32 the edge
// form can land an ulp below h^2, so a skipped triangle could have won by an
// ulp; chip_smoke.py counts the cells where the kernel and its cull-free twin
// differ.
//
// Bound on the H100: the FP32 instruction rate, ~62 instructions per
// evaluated (cell, triangle) pair, ~6 per culled one, plus the row halves'
// ~30 per kCells cells; device-memory traffic is the table once per block
// (from L2) and 8 B written per cell.
// TPU artefacts dropped: the 32-row x nk block shape, the unroll-by-4 loop
// and the padding of M to a multiple of 4 with far-translated triangles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNumCoef = 40;
constexpr int kRowWords = kNumCoef / 4;
constexpr int kCells = 4;                     // consecutive k cells per thread
constexpr int kWarpJ = 8;                     // a warp tile: 8 columns in j
constexpr int kWarpK = 32 / kWarpJ * kCells;  // by 16 cells in k
constexpr int kCentreLane = 18;               // column 4, cells 8-11 of 16
constexpr int kChunk = 128;                   // triangles per shared stage
constexpr int kChunkWords = kChunk * kNumCoef;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
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

// Start the copies of triangles [t0, t0 + count) of the (40, m) table into
// dst, triangle-major: dst[t * 40 + row]. Warps take rows, lanes triangles,
// so each warp reads runs of consecutive words.
__device__ __forceinline__ void stage_chunk(float* dst,
                                            const float* __restrict__ coef,
                                            int m, int t0, int count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kNumCoef; r += kWarps)
    for (int t = lane; t < count; t += 32)
      cp_async4(dst + t * kNumCoef + r, coef + (long long)r * m + t0 + t);
}

// clamp(a + b, 0, 1) in one instruction (a NaN sum gives 0, as
// fminf(fmaxf(NaN, 0), 1) does)
__device__ __forceinline__ float add_sat(float a, float b) {
  float r;
  asm("add.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One triangle's coefficients, from a triangle-major row of ten float4.
struct Coef {
  float v[kNumCoef];
};

__device__ __forceinline__ void load_words(Coef& cf, const float4* g, int q) {
  const float4 w = g[q];
  cf.v[4 * q] = w.x;
  cf.v[4 * q + 1] = w.y;
  cf.v[4 * q + 2] = w.z;
  cf.v[4 * q + 3] = w.w;
}

// The plane term's row half, cf(27)*x + (cf(28)*y + cf(30)).
__device__ __forceinline__ float plane_row(const Coef& cf, float x, float y) {
  return cf.v[27] * x + (cf.v[28] * y + cf.v[30]);
}

// The other row halves of one triangle at the thread's (x, y).
struct Rows {
  float w23u, w31u, w12u, su_ab, su_ac, su_bc, ubx, uby, ucx, ucy;
  bool degen;
};

__device__ __forceinline__ Rows other_rows(const Coef& cf, float x, float y) {
  Rows r;
  r.w23u = cf.v[31] * x + (cf.v[32] * y + cf.v[34]);
  r.w31u = cf.v[35] * x + (cf.v[36] * y + cf.v[38]);
  r.w12u = 1.0f - r.w23u - r.w31u;
  r.su_ab = cf.v[15] * x + (cf.v[16] * y + cf.v[18]);
  r.su_ac = cf.v[19] * x + (cf.v[20] * y + cf.v[22]);
  r.su_bc = cf.v[23] * x + (cf.v[24] * y + cf.v[26]);
  r.ubx = x - cf.v[0];
  r.uby = y - cf.v[1];
  r.ucx = x - cf.v[3];
  r.ucy = y - cf.v[4];
  r.degen = !(cf.v[39] < 0.5f);
  return r;
}

// Squared distance to edge x2 + s*w, s = clamp(su + sv, 0, 1), u = p - x2.
__device__ __forceinline__ float edge_d2(float su, float sv, float wx,
                                         float wy, float wz, float ux,
                                         float uy, float uz) {
  const float s = add_sat(su, sv);
  const float ddx = ux - s * wx;
  const float ddy = uy - s * wy;
  const float ddz = uz - s * wz;
  return ddx * ddx + ddy * ddy + ddz * ddz;
}

// The squared distance of the cell at z, given its plane term din = h^2.
__device__ __forceinline__ float cell_d2(const Coef& cf, const Rows& r,
                                         float z, float din) {
  const float w23v = cf.v[33] * z;
  const float w31v = cf.v[37] * z;
  const float w12v = -(w23v + w31v);
  const bool inside =
      fminf(fminf(r.w23u + w23v, r.w31u + w31v), r.w12u + w12v) >= 0.0f &&
      !r.degen;
  const float ubz = z - cf.v[2];
  const float ucz = z - cf.v[5];
  const float d_ab = edge_d2(r.su_ab, cf.v[17] * z, cf.v[6], cf.v[7],
                             cf.v[8], r.ubx, r.uby, ubz);
  const float d_ac = edge_d2(r.su_ac, cf.v[21] * z, cf.v[9], cf.v[10],
                             cf.v[11], r.ucx, r.ucy, ucz);
  const float d_bc = edge_d2(r.su_bc, cf.v[25] * z, cf.v[12], cf.v[13],
                             cf.v[14], r.ucx, r.ucy, ucz);
  return inside ? din : fminf(d_ab, fminf(d_ac, d_bc));
}

// The same squared distance as the walk's, at n cells of one column.
template <int n>
__device__ __forceinline__ void eval_cells(const Coef& cf, float x, float y,
                                           const float* z, float* d2) {
  const float hu = plane_row(cf, x, y);
  const Rows r = other_rows(cf, x, y);
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const float h = hu + cf.v[29] * z[c];
    d2[c] = cell_d2(cf, r, z[c], h * h);
  }
}

// Pass 1 over the staged triangles [t0, t0 + count): each lane evaluates
// every 32nd one at the warp's centre cell and keeps its nearest.
__device__ __forceinline__ void nearest_scan(const float4* tab, int t0,
                                             int count, float x, float y,
                                             float z, float& dmin,
                                             int& tmin) {
  const int lane = threadIdx.x & 31;
  for (int tl = lane; tl < count; tl += 32) {
    const float4* g = tab + tl * kRowWords;
    Coef cf;
#pragma unroll
    for (int q = 0; q < kRowWords; ++q) load_words(cf, g, q);
    float d;
    eval_cells<1>(cf, x, y, &z, &d);
    if (d < dmin) {
      dmin = d;
      tmin = t0 + tl;
    }
  }
}

// Pass 2, the ascending walk over the staged triangles [t0, t0 + count).
template <bool kCount>
__device__ __forceinline__ void walk(const float4* tab, int t0, int count,
                                     float x, float y, const float* z,
                                     float* best, int* best_t,
                                     unsigned long long& n_eval) {
  for (int tl = 0; tl < count; ++tl) {
    const float4* g = tab + tl * kRowWords;
    Coef cf;
    load_words(cf, g, 6);
    load_words(cf, g, 7);
    load_words(cf, g, 9);
    const float hu = plane_row(cf, x, y);
    float din[kCells];
    bool far = true;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const float h = hu + cf.v[29] * z[c];
      din[c] = h * h;
      far = far && din[c] > best[c];
    }
    const bool degen = !(cf.v[39] < 0.5f);  // warp-uniform
    if (!degen && __all_sync(kFullMask, far)) continue;
    if (kCount) ++n_eval;
#pragma unroll
    for (int q = 0; q < 6; ++q) load_words(cf, g, q);
    load_words(cf, g, 8);
    const Rows r = other_rows(cf, x, y);
    const int t = t0 + tl;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const float d2 = cell_d2(cf, r, z[c], din[c]);
      if (d2 < best[c]) {
        best[c] = d2;
        best_t[c] = t;
      }
    }
  }
}

// three resident blocks per SM (80 registers): at two, the cull's short,
// dependent path per triangle leaves the schedulers idle; at four the
// streamed variant spills. kResident: the table is one chunk, staged once
// per block (the streamed steps without their barriers; on box36 ~10%
// faster than one walk that makes that choice at run time, PERF.md).
// kCount: count the (warp, triangle) steps the cull does not skip into
// *evaluated (a measurement build of the same walk).
template <bool kResident, bool kCount>
__global__ void __launch_bounds__(kThreads, 3)
dense_stream_kernel(const float* __restrict__ coef, int m, int ni, int nj,
                    int nk, int oi, int oj, int ok, float dx,
                    float* __restrict__ phi, int* __restrict__ tid,
                    unsigned long long* __restrict__ evaluated) {
  extern __shared__ float4 stage[];  // kResident: m rows; else 2 x kChunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_j = (nj + kWarpJ - 1) / kWarpJ;
  const int tiles_k = (nk + kWarpK - 1) / kWarpK;
  const long long n_tiles = (long long)ni * tiles_j * tiles_k;
  const long long n_groups = (n_tiles + kWarps - 1) / kWarps;
  const int n_chunks = (m + kChunk - 1) / kChunk;
  float4* buf[2] = {stage, stage + kChunkWords / 4};
  unsigned long long n_eval = 0, n_eval_live = 0;

  if (kResident && m > 0) {
    stage_chunk(reinterpret_cast<float*>(stage), coef, m, 0, m);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    long long wt = grp * kWarps + warp;
    const bool live = wt < n_tiles;
    if (!live) wt = n_tiles - 1;  // a copy of the last real warp tile
    const int kt = (int)(wt % tiles_k);
    const long long col = wt / tiles_k;
    const int i = (int)(col / tiles_j);
    const int j = (int)(col % tiles_j) * kWarpJ + lane / (kWarpK / kCells);
    const int k0 = kt * kWarpK + lane % (kWarpK / kCells) * kCells;
    const float x = (float)(i + oi) * dx;
    const float y = (float)(min(j, nj - 1) + oj) * dx;
    float z[kCells], best[kCells], bound[kCells];
    int best_t[kCells];
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      z[c] = (float)(min(k0 + c, nk - 1) + ok) * dx;
      best[c] = __int_as_float(0x7f800000);  // +inf
      best_t[c] = -1;
      bound[c] = best[c];
    }
    const float yc = __shfl_sync(kFullMask, y, kCentreLane);
    const float zc = __shfl_sync(kFullMask, z[0], kCentreLane);
    float dmin = __int_as_float(0x7f800000);
    int tmin = 0;

    // the starting bound: the warp's nearest triangle at its own cells
    auto start_bound = [&](const Coef& cf) {
      eval_cells<kCells>(cf, x, y, z, bound);
#pragma unroll
      for (int c = 0; c < kCells; ++c) {
        best[c] = nextafterf(bound[c], __int_as_float(0x7f800000));
        best_t[c] = tmin;
      }
    };
    auto warp_argmin = [&]() {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(kFullMask, dmin, o);
        const int ot = __shfl_xor_sync(kFullMask, tmin, o);
        if (od < dmin || (od == dmin && ot < tmin)) {
          dmin = od;
          tmin = ot;
        }
      }
    };

    if (kResident) {
      if (m > 0) {
        nearest_scan(stage, 0, m, x, yc, zc, dmin, tmin);
        warp_argmin();
        Coef cf;
#pragma unroll
        for (int q = 0; q < kRowWords; ++q)
          load_words(cf, stage + tmin * kRowWords, q);
        start_bound(cf);
        walk<kCount>(stage, 0, m, x, y, z, best, best_t, n_eval);
      }
    } else {
      // steps 0 .. n_chunks - 1 scan for the nearest triangle, steps
      // n_chunks .. 2 n_chunks - 1 walk; each step's chunk is staged while
      // the step before it runs
      const int steps = 2 * n_chunks;
      __syncthreads();  // the previous warp tiles are done with the buffers
      stage_chunk(reinterpret_cast<float*>(buf[0]), coef, m, 0,
                  min(kChunk, m));
      cp_async_commit();
      for (int s = 0; s < steps; ++s) {
        const int t0 = (s % n_chunks) * kChunk;
        const int count = min(kChunk, m - t0);
        if (s + 1 < steps) {
          // the other buffer was released by the barrier that ended step s-1
          const int t1 = ((s + 1) % n_chunks) * kChunk;
          stage_chunk(reinterpret_cast<float*>(buf[(s + 1) & 1]), coef, m,
                      t1, min(kChunk, m - t1));
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (s < n_chunks) {
          nearest_scan(buf[s & 1], t0, count, x, yc, zc, dmin, tmin);
        } else {
          if (s == n_chunks) {
            warp_argmin();
            Coef cf;
#pragma unroll
            for (int q = 0; q < kNumCoef; ++q)
              cf.v[q] = __ldg(coef + (long long)q * m + tmin);
            start_bound(cf);
          }
          walk<kCount>(buf[s & 1], t0, count, x, y, z, best, best_t, n_eval);
        }
        __syncthreads();  // every warp is done with this buffer
      }
    }

    if (kCount && live) n_eval_live += n_eval;
    n_eval = 0;
    if (!live || j >= nj) continue;
    const long long base = ((long long)i * nj + j) * nk;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      if (k0 + c < nk) {
        // the nearest triangle culled at a near-tie and nothing below its
        // bound: the bound's own triangle and distance
        phi[base + k0 + c] = sqrtf(best[c] > bound[c] ? bound[c] : best[c]);
        tid[base + k0 + c] = best_t[c];
      }
    }
  }
  if (kCount && lane == 0 && n_eval_live > 0)
    atomicAdd(evaluated, n_eval_live);
}

template <bool kResident, bool kCount>
int launch(const float* coef, int m, int ni, int nj, int nk, int oi, int oj,
           int ok, float dx, float* phi, int* tid,
           unsigned long long* evaluated, cudaStream_t stream) {
  const long long tiles = (long long)ni * ((nj + kWarpJ - 1) / kWarpJ) *
                          ((nk + kWarpK - 1) / kWarpK);
  const long long groups = (tiles + kWarps - 1) / kWarps;
  const size_t smem = (size_t)(kResident ? m : 2 * kChunk) * kNumCoef *
                      sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_stream_kernel<kResident, kCount>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as are resident at once; each walks warp-tile groups
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dense_stream_kernel<kResident, kCount>
      <<<(unsigned int)(groups < fit ? groups : fit), kThreads, smem,
         stream>>>(coef, m, ni, nj, nk, oi, oj, ok, dx, phi, tid, evaluated);
  return (int)cudaGetLastError();
}

template <bool kCount>
int launch_any(const float* coef, int m, int ni, int nj, int nk, int oi,
               int oj, int ok, float dx, float* phi, int* tid,
               unsigned long long* evaluated, void* stream) {
  if ((long long)ni * nj * nk <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (m <= kChunk)
    return launch<true, kCount>(coef, m, ni, nj, nk, oi, oj, ok, dx, phi,
                                tid, evaluated, s);
  return launch<false, kCount>(coef, m, ni, nj, nk, oi, oj, ok, dx, phi, tid,
                               evaluated, s);
}

// -- the (40, M) table -------------------------------------------------------
//
// sep_table_kernel builds K1's table from the mesh on the card: one thread per
// triangle gathers its three corners (verts[tris[3t + v]], or rows 3t + v of
// pre-gathered corners when tris is null), subtracts the origin and writes
// its 40 coefficients, row r to out[r * m + t], so the stores of a warp
// coalesce. It follows ops/dense._sep_coefs operation by operation, in the
// same order: _dot as (u0*v0 + u1*v1) + u2*v2, torch.clamp's min as a
// compare that lets NaN through, 1 / x as torch's reciprocal, sqrtf.
// Built with --fmad=false and IEEE division and square root, every operation
// rounds on its own as torch's elementwise ops do, so the table is
// byte-equal to the plain-torch one. A corner index outside [0, n) reads
// nothing and gives the triangle a row of NaN.

constexpr int kTableThreads = 128;

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2];
}

// torch.clamp(x, min=lo): a NaN x stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__global__ void __launch_bounds__(kTableThreads)
sep_table_kernel(const float* __restrict__ verts, int n,
                 const int* __restrict__ tris, int m,
                 const float* __restrict__ origin, float* __restrict__ out) {
  const int t = blockIdx.x * kTableThreads + threadIdx.x;
  if (t >= m) return;
  float p[3][3];  // a, b, c in grid-local coordinates
  bool valid = true;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    int row = 3 * t + v;
    if (tris != nullptr) {
      row = tris[3 * t + v];
      if (row < 0 || row >= n) {
        valid = false;
        row = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[v][k] = verts[3 * (long long)row + k] - origin[k];
  }
  const float* a = p[0];
  const float* b = p[1];
  const float* c = p[2];
  float cf[kNumCoef];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cf[k] = b[k];
    cf[3 + k] = c[k];
  }
  // the edges x1 - x2 (rows 6:15) and their parameters e.p + e0 (15:27)
  const float* ends[3][2] = {{a, b}, {a, c}, {b, c}};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* x1 = ends[e][0];
    const float* x2 = ends[e][1];
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = x1[k] - x2[k];
    const float inv = 1.0f / clamp_min(dot3(w, w), 1e-30f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cf[6 + 3 * e + k] = w[k];
      cf[15 + 4 * e + k] = w[k] * inv;
    }
    cf[18 + 4 * e] = -dot3(x2, w) * inv;
  }
  float x13[3], x23[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x13[k] = a[k] - c[k];
    x23[k] = b[k] - c[k];
  }
  const float m13 = dot3(x13, x13);
  const float m23 = dot3(x23, x23);
  const float d = dot3(x13, x23);
  const float invdet = 1.0f / clamp_min(m13 * m23 - d * d, 1e-30f);
  float g23[3], g31[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g23[k] = invdet * (m23 * x13[k] - d * x23[k]);
    g31[k] = invdet * (m13 * x23[k] - d * x13[k]);
  }
  const float cr[3] = {x13[1] * x23[2] - x13[2] * x23[1],
                       x13[2] * x23[0] - x13[0] * x23[2],
                       x13[0] * x23[1] - x13[1] * x23[0]};
  const float cr2 = dot3(cr, cr);
  const float norm = sqrtf(clamp_min(cr2, 1e-37f));
  float nrm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) nrm[k] = cr[k] / norm;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cf[27 + k] = nrm[k];
    cf[31 + k] = g23[k];
    cf[35 + k] = g31[k];
  }
  cf[30] = -dot3(nrm, c);
  cf[34] = -dot3(g23, c);
  cf[38] = -dot3(g31, c);
  cf[39] = cr2 <= 1e-30f ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < kNumCoef; ++r)
    out[(long long)r * m + t] = valid ? cf[r] : __int_as_float(0x7fc00000);
}

}  // namespace

extern "C" int sdf_dense_stream(const float* coef, int m, int ni, int nj,
                                int nk, int oi, int oj, int ok, float dx,
                                float* phi, int* tid, void* stream) {
  return launch_any<false>(coef, m, ni, nj, nk, oi, oj, ok, dx, phi, tid,
                           nullptr, stream);
}

// The same walk, counting: *evaluated gains the number of (warp, triangle)
// steps that the cull did not skip; the warp tiles times m is the total.
// For measurement only (chip_smoke.py); no wrapper calls it.
extern "C" int sdf_dense_stream_counted(const float* coef, int m, int ni,
                                        int nj, int nk, int oi, int oj,
                                        int ok, float dx, float* phi,
                                        int* tid,
                                        unsigned long long* evaluated,
                                        void* stream) {
  return launch_any<true>(coef, m, ni, nj, nk, oi, oj, ok, dx, phi, tid,
                          evaluated, stream);
}

// K1's (40, m) table into out: verts (n, 3) float32 and tris (m, 3) int32, or
// tris null and verts the (3m, 3) gathered corners; origin 3 floats; all on
// the card. One launch, on `stream`.
extern "C" int sdf_sep_table(const float* verts, int n, const int* tris,
                             int m, const float* origin, float* out,
                             void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  sep_table_kernel<<<(m + kTableThreads - 1) / kTableThreads, kTableThreads,
                     0, (cudaStream_t)stream>>>(verts, n, tris, m, origin,
                                                out);
  return (int)cudaGetLastError();
}
