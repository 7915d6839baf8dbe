// K1 and K1b: the dense all-triangles distance field.
//
// K1 replaces sdfgenfast_tpu/ops/dense.py::_sep_kernel and K1b replaces
// ::_dense_kernel (both launched by _dense_impl). Every cell takes the exact
// squared distance to every triangle, keeps the lowest id among exact ties
// (ascending walk, strict '<'), and writes sqrt(best) and the winner id.
//
// Layout: one thread per cell, k fastest, so a warp covers 32 consecutive
// cells of one (i, j) column and the stores coalesce. Cells are indexed with
// 64-bit integers (512-class grids hold 134 M cells). Blocks loop over the
// grid (grid-stride) so each block stages the triangle table in shared
// memory once: K1's (40, M) coefficient table (61,440 B at M = 384, above the
// 48 KB default, hence the opt-in attribute) or K1b's (9, M) vertex table.
// Every lane of a warp reads the same table word, a shared-memory broadcast.
//
// K1 keeps the Pallas kernel's grouping of every affine form exactly:
// cf(27)*x + (cf(28)*y + cf(30)) plus cf(29)*z, and the same for the
// barycentric weights and the three edge parameters. K1b keeps the operation
// order of geometry.point_triangle_distance_sq_soa (geometry.cuh). Built
// with --fmad=false, so both match their PyTorch twins step for step.
//
// The plane-bound cull: |h| bounds the distance to a triangle from below, so
// K1 skips a triangle for a whole warp when every lane's h^2 exceeds its own
// best so far (the Pallas kernel decides per block of 32 rows x nk with
// min(h^2) > max(best)). Degenerate triangles are never skipped. In float32
// the edge form can land an ulp below h^2, so at near-ties a skipped
// triangle could have won by an ulp; chip_smoke.py counts the cells where
// the kernel and its cull-free twin differ.
//
// Bound on the H100: FP32 arithmetic. K1 costs ~45 operations per (cell,
// triangle) pair when it is evaluated (none but the plane distance when it
// is culled); K1b ~110. Device-memory traffic is 8 B written per cell.
// TPU artefacts dropped: the 32-row x nk block shape, the unroll-by-4 loop
// and the padding of M to a multiple of 4 with far-translated triangles.

#include <cuda_runtime.h>

#include "geometry.cuh"

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

__global__ void __launch_bounds__(kThreads)
dense_soa_kernel(const float* __restrict__ tri9, int m, int ni, int nj,
                 int nk, int oi, int oj, int ok, float dx,
                 float* __restrict__ phi, int* __restrict__ tid) {
  extern __shared__ float s[];  // (9, m): a, b, c by rows
  for (int q = threadIdx.x; q < 9 * m; q += kThreads) s[q] = tri9[q];
  __syncthreads();

  const long long n_cells = (long long)ni * nj * nk;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
       n < n_cells; n += step) {
    float x, y, z;
    cell_position(n, nj, nk, oi, oj, ok, dx, x, y, z);
    float best = __int_as_float(0x7f800000);  // +inf
    int best_t = -1;
    for (int t = 0; t < m; ++t) {
      const float d2 = point_triangle_d2(
          x, y, z, s[t], s[m + t], s[2 * m + t], s[3 * m + t], s[4 * m + t],
          s[5 * m + t], s[6 * m + t], s[7 * m + t], s[8 * m + t]);
      if (d2 < best) {
        best = d2;
        best_t = t;
      }
    }
    phi[n] = sqrtf(best);
    tid[n] = best_t;
  }
}

// Dynamic shared memory for `smem` bytes, then as many blocks as fit on the
// card at once (capped by the cells); the kernels loop over the rest.
template <typename Kernel>
cudaError_t launch_shape(Kernel kernel, size_t smem, long long n_cells,
                         int* blocks) {
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
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long need = (n_cells + kThreads - 1) / kThreads;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < fit ? need : fit);
  return cudaSuccess;
}

template <typename Kernel>
int launch(Kernel kernel, int rows, const float* table, int m, int ni, int nj,
           int nk, int oi, int oj, int ok, float dx, float* phi, int* tid,
           void* stream) {
  const long long n_cells = (long long)ni * nj * nk;
  if (n_cells <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)rows * m * sizeof(float);
  int blocks = 0;
  const cudaError_t err = launch_shape(kernel, smem, n_cells, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      table, m, ni, nj, nk, oi, oj, ok, dx, phi, tid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdf_dense_sep(const float* coef, int m, int ni, int nj, int nk,
                             int oi, int oj, int ok, float dx, float* phi,
                             int* tid, void* stream) {
  return launch(dense_sep_kernel, kNumCoef, coef, m, ni, nj, nk, oi, oj, ok,
                dx, phi, tid, stream);
}

extern "C" int sdf_dense_soa(const float* tri9, int m, int ni, int nj, int nk,
                             int oi, int oj, int ok, float dx, float* phi,
                             int* tid, void* stream) {
  return launch(dense_soa_kernel, 9, tri9, m, ni, nj, nk, oi, oj, ok, dx, phi,
                tid, stream);
}
