// K1 and K1b: the dense all-triangles distance field.
//
// Both evaluate the separable formulation: every affine-in-p quantity of the
// point-triangle distance (plane distance, barycentric weights, edge
// parameters) comes from the per-triangle (40, M) coefficient table of
// ops/dense._sep_coefs. K1 (dense_sep_kernel, M <= 384) replaces
// sdfgenfast_tpu/ops/dense.py::_sep_kernel; K1b (dense_stream_kernel,
// 384 < M <= 1024) replaces ::_dense_kernel, the JAX package's per-triangle
// fallback, with the same separable function. Every cell takes the exact
// squared distance to every triangle, keeps the lowest id among exact ties
// (ascending walk, strict '<'), and writes sqrt(best) and the winner id.
//
// K1 layout: one thread per cell, k fastest, so a warp covers 32 consecutive
// cells of one (i, j) column and the stores coalesce. Cells are indexed with
// 64-bit integers (512-class grids hold 134 M cells). Blocks loop over the
// grid (grid-stride) so each block stages the (40, M) table in shared memory
// once (61,440 B at M = 384, above the 48 KB default, hence the opt-in
// attribute). Every lane of a warp reads the same table word, a
// shared-memory broadcast. K1b's layout is described above its kernel.
//
// Both keep the Pallas kernel's grouping of every affine form exactly:
// cf(27)*x + (cf(28)*y + cf(30)) plus cf(29)*z, and the same for the
// barycentric weights and the three edge parameters. Built with
// --fmad=false, so both match dense_sep_reference step for step.
//
// The plane-bound cull: |h| bounds the distance to a triangle from below, so
// a triangle is skipped for a whole warp when every cell's h^2 exceeds its
// own best so far (the Pallas kernel decides per block of 32 rows x nk with
// min(h^2) > max(best)). Degenerate triangles are never skipped. In float32
// the edge form can land an ulp below h^2, so at near-ties a skipped
// triangle could have won by an ulp; chip_smoke.py counts the cells where
// the kernels and their cull-free twin differ.
//
// Bound on the H100: FP32 arithmetic. K1 costs ~45 operations per (cell,
// triangle) pair when it is evaluated (none but the plane distance when it
// is culled). Device-memory traffic is 8 B written per cell.
// TPU artefacts dropped: the 32-row x nk block shape, the unroll-by-4 loop
// and the padding of M to a multiple of 4 with far-translated triangles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNumCoef = 40;
constexpr unsigned kFullMask = 0xffffffffu;

// Grid-local position of linear cell n (k fastest): f32(index + offset) * dx.
__device__ __forceinline__ void cell_position(long long n, int nj, int nk,
                                              int oi, int oj, int ok, float dx,
                                              float& x, float& y, float& z) {
  const int k = (int)(n % nk);
  const long long r = n / nk;
  const int j = (int)(r % nj);
  const int i = (int)(r / nj);
  x = (float)(i + oi) * dx;
  y = (float)(j + oj) * dx;
  z = (float)(k + ok) * dx;
}

// Squared distance to edge x2 + s*w, s = clamp(su + sv, 0, 1), u = p - x2.
__device__ __forceinline__ float edge_d2(float su, float sv, float wx,
                                         float wy, float wz, float ux,
                                         float uy, float uz) {
  const float s = fminf(fmaxf(su + sv, 0.0f), 1.0f);
  const float ddx = ux - s * wx;
  const float ddy = uy - s * wy;
  const float ddz = uz - s * wz;
  return ddx * ddx + ddy * ddy + ddz * ddz;
}

__global__ void __launch_bounds__(kThreads)
dense_sep_kernel(const float* __restrict__ coef, int m, int ni, int nj,
                 int nk, int oi, int oj, int ok, float dx,
                 float* __restrict__ phi, int* __restrict__ tid) {
  extern __shared__ float s[];  // (40, m): row r of triangle t at s[r*m + t]
  for (int q = threadIdx.x; q < kNumCoef * m; q += kThreads) s[q] = coef[q];
  __syncthreads();

  const long long n_cells = (long long)ni * nj * nk;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < n_cells;
       base += step) {
    const long long n = base + threadIdx.x;
    const bool valid = n < n_cells;
    float x, y, z;
    cell_position(valid ? n : 0, nj, nk, oi, oj, ok, dx, x, y, z);

    float best = __int_as_float(0x7f800000);  // +inf
    int best_t = -1;
    for (int t = 0; t < m; ++t) {
      const float* cf = s + t;
#define CF(row) cf[(row) * m]
      const float h = (CF(27) * x + (CF(28) * y + CF(30))) + CF(29) * z;
      const float din = h * h;
      const bool degen = !(CF(39) < 0.5f);  // warp-uniform
      // lanes past the grid's end vote to skip
      if (!degen && __all_sync(kFullMask, !valid || din > best)) continue;

      const float w23u = CF(31) * x + (CF(32) * y + CF(34));
      const float w23v = CF(33) * z;
      const float w31u = CF(35) * x + (CF(36) * y + CF(38));
      const float w31v = CF(37) * z;
      const float w12u = 1.0f - w23u - w31u;
      const float w12v = -(w23v + w31v);
      const bool inside =
          fminf(fminf(w23u + w23v, w31u + w31v), w12u + w12v) >= 0.0f &&
          !degen;

      const float ubx = x - CF(0), uby = y - CF(1), ubz = z - CF(2);
      const float ucx = x - CF(3), ucy = y - CF(4), ucz = z - CF(5);
      const float d_ab = edge_d2(CF(15) * x + (CF(16) * y + CF(18)),
                                 CF(17) * z, CF(6), CF(7), CF(8), ubx, uby,
                                 ubz);
      const float d_ac = edge_d2(CF(19) * x + (CF(20) * y + CF(22)),
                                 CF(21) * z, CF(9), CF(10), CF(11), ucx, ucy,
                                 ucz);
      const float d_bc = edge_d2(CF(23) * x + (CF(24) * y + CF(26)),
                                 CF(25) * z, CF(12), CF(13), CF(14), ucx, ucy,
                                 ucz);
#undef CF
      const float d2 = inside ? din : fminf(d_ab, fminf(d_ac, d_bc));
      if (d2 < best) {
        best = d2;
        best_t = t;
      }
    }
    if (valid) {
      phi[n] = sqrtf(best);
      tid[n] = best_t;
    }
  }
}

// ---------------------------------------------------------------------------
// K1b: the streamed, register-blocked separable kernel (384 < M <= 1024).
//
// The same function as dense_sep_kernel over the same (40, M) table, laid out
// for a table that no longer fits beside several blocks in one SM's shared
// memory (160 KB at M = 1024):
//
// - The table streams through shared memory in chunks of kChunk triangles,
//   double-buffered with cp.async: chunk c + 1 is in flight while chunk c is
//   evaluated. Each chunk is stored triangle-major (40 words per triangle),
//   so a triangle's coefficients are ten 16-byte words read as float4
//   broadcasts. 2 x 20 KB per block leaves room for several resident blocks.
//   The last chunk is ragged and bounded by index: no padding triangles.
// - Each thread owns kCells consecutive k cells of one (i, j) column. The
//   row half of every affine form (the x and y terms, e.g.
//   cf(27)*x + (cf(28)*y + cf(30))) and the edge offsets p.x - x2.x and
//   p.y - x2.y are computed once per triangle and shared by the kCells
//   cells; only the lane half (cf(29)*z) and the sums run per cell, and
//   every shared-memory read feeds kCells cells. This is the Pallas
//   kernel's row/lane split (sdfgenfast_tpu/ops/dense.py:163-238) carried
//   into registers. Threads are numbered over (column, k group) pairs, so a
//   warp covers 32 * kCells cells of one or two neighbouring columns.
// - The plane-bound cull of dense_sep_kernel, decided per warp over its
//   32 * kCells cells; degenerate triangles are never skipped. Cells past a
//   column's end (and threads past the grid's end) evaluate a clamped copy
//   of a real cell, so their votes change nothing, and are not stored.
//
// The arithmetic is dense_sep_kernel's, grouping for grouping, so the
// kernel equals dense_sep_reference except where the cull decides a near-tie
// by an ulp. Replaces sdfgenfast_tpu/ops/dense.py::_dense_kernel (the JAX
// package's fallback for tables that did not fit the TPU's SMEM).
// Bound on the H100: the FP32 instruction rate, ~66 instructions per
// evaluated (cell, triangle) pair plus the row halves' ~30 per kCells cells;
// device-memory traffic is the table once per block (from L2) and 8 B
// written per cell.

constexpr int kStreamThreads = 256;
constexpr int kCells = 4;     // consecutive k cells per thread
constexpr int kChunk = 128;   // triangles per shared-memory stage
constexpr int kChunkWords = kChunk * kNumCoef;

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
  for (int r = warp; r < kNumCoef; r += kStreamThreads / 32)
    for (int t = lane; t < count; t += 32)
      cp_async4(dst + t * kNumCoef + r, coef + (long long)r * m + t0 + t);
}

__global__ void __launch_bounds__(kStreamThreads, 2)
dense_stream_kernel(const float* __restrict__ coef, int m, int ni, int nj,
                    int nk, int oi, int oj, int ok, float dx,
                    float* __restrict__ phi, int* __restrict__ tid) {
  __shared__ float4 stage[2][kChunkWords / 4];

  const int groups = (nk + kCells - 1) / kCells;
  const long long n_threads = (long long)ni * nj * groups;
  long long q = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
  const bool live = q < n_threads;
  if (!live) q = n_threads - 1;  // a copy of the last real thread
  const long long col = q / groups;
  const int k0 = (int)(q - col * groups) * kCells;
  const int j = (int)(col % nj);
  const int i = (int)(col / nj);
  const float x = (float)(i + oi) * dx;
  const float y = (float)(j + oj) * dx;
  float z[kCells], best[kCells];
  int best_t[kCells];
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    z[r] = (float)(min(k0 + r, nk - 1) + ok) * dx;
    best[r] = __int_as_float(0x7f800000);  // +inf
    best_t[r] = -1;
  }

  const int n_chunks = (m + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    stage_chunk(reinterpret_cast<float*>(stage[0]), coef, m, 0,
                min(kChunk, m));
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    const int count = min(kChunk, m - t0);
    if (c + 1 < n_chunks) {
      // the other buffer was released by the barrier that ended chunk c - 1
      stage_chunk(reinterpret_cast<float*>(stage[(c + 1) & 1]), coef, m,
                  t0 + kChunk, min(kChunk, m - t0 - kChunk));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float4* tab = stage[c & 1];
    for (int tl = 0; tl < count; ++tl) {
      const float4* g = tab + tl * (kNumCoef / 4);
      float cf[kNumCoef];
#define LOAD4(q)              \
  {                           \
    const float4 v = g[q];    \
    cf[4 * (q)] = v.x;        \
    cf[4 * (q) + 1] = v.y;    \
    cf[4 * (q) + 2] = v.z;    \
    cf[4 * (q) + 3] = v.w;    \
  }
      LOAD4(6) LOAD4(7) LOAD4(9)
      const float hu = cf[27] * x + (cf[28] * y + cf[30]);
      float din[kCells];
      bool far = true;
#pragma unroll
      for (int r = 0; r < kCells; ++r) {
        const float h = hu + cf[29] * z[r];
        din[r] = h * h;
        far = far && din[r] > best[r];
      }
      const bool degen = !(cf[39] < 0.5f);  // warp-uniform
      if (!degen && __all_sync(kFullMask, far)) continue;

      LOAD4(0) LOAD4(1) LOAD4(2) LOAD4(3) LOAD4(4) LOAD4(5) LOAD4(8)
#undef LOAD4
      // row halves, shared by the thread's cells
      const float w23u = cf[31] * x + (cf[32] * y + cf[34]);
      const float w31u = cf[35] * x + (cf[36] * y + cf[38]);
      const float w12u = 1.0f - w23u - w31u;
      const float su_ab = cf[15] * x + (cf[16] * y + cf[18]);
      const float su_ac = cf[19] * x + (cf[20] * y + cf[22]);
      const float su_bc = cf[23] * x + (cf[24] * y + cf[26]);
      const float ubx = x - cf[0], uby = y - cf[1];
      const float ucx = x - cf[3], ucy = y - cf[4];
      const int t = t0 + tl;
#pragma unroll
      for (int r = 0; r < kCells; ++r) {
        const float w23v = cf[33] * z[r];
        const float w31v = cf[37] * z[r];
        const float w12v = -(w23v + w31v);
        const bool inside = fminf(fminf(w23u + w23v, w31u + w31v),
                                  w12u + w12v) >= 0.0f &&
                            !degen;
        const float ubz = z[r] - cf[2];
        const float ucz = z[r] - cf[5];
        const float d_ab = edge_d2(su_ab, cf[17] * z[r], cf[6], cf[7], cf[8],
                                   ubx, uby, ubz);
        const float d_ac = edge_d2(su_ac, cf[21] * z[r], cf[9], cf[10],
                                   cf[11], ucx, ucy, ucz);
        const float d_bc = edge_d2(su_bc, cf[25] * z[r], cf[12], cf[13],
                                   cf[14], ucx, ucy, ucz);
        const float d2 = inside ? din[r] : fminf(d_ab, fminf(d_ac, d_bc));
        if (d2 < best[r]) {
          best[r] = d2;
          best_t[r] = t;
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  if (!live) return;
  const long long base = col * nk;
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    if (k0 + r < nk) {
      phi[base + k0 + r] = sqrtf(best[r]);
      tid[base + k0 + r] = best_t[r];
    }
  }
}

}  // namespace

// K1: the whole (40, m) table in dynamic shared memory, then as many blocks
// as fit on the card at once (capped by the cells); the kernel loops over
// the rest.
extern "C" int sdf_dense_sep(const float* coef, int m, int ni, int nj, int nk,
                             int oi, int oj, int ok, float dx, float* phi,
                             int* tid, void* stream) {
  const long long n_cells = (long long)ni * nj * nk;
  if (n_cells <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kNumCoef * m * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    // the card's whole opt-in size, so concurrent callers never lower it
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dense_sep_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_sep_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n_cells + kThreads - 1) / kThreads;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dense_sep_kernel<<<(int)(need < fit ? need : fit), kThreads, smem,
                     (cudaStream_t)stream>>>(coef, m, ni, nj, nk, oi, oj, ok,
                                             dx, phi, tid);
  return (int)cudaGetLastError();
}

extern "C" int sdf_dense_stream(const float* coef, int m, int ni, int nj,
                                int nk, int oi, int oj, int ok, float dx,
                                float* phi, int* tid, void* stream) {
  const long long groups = (nk + kCells - 1) / kCells;
  const long long n_threads = (long long)ni * nj * groups;
  if (n_threads > 0) {
    const long long blocks = (n_threads + kStreamThreads - 1) / kStreamThreads;
    dense_stream_kernel<<<(unsigned int)blocks, kStreamThreads, 0,
                          (cudaStream_t)stream>>>(coef, m, ni, nj, nk, oi, oj,
                                                  ok, dx, phi, tid);
  }
  return (int)cudaGetLastError();
}
