// K4: P fused 26-offset min-plus (chamfer / Lipschitz) relaxation passes,
// 1 <= P <= 4, in one launch.
//
// Replaces sdfgenfast_tpu/ops/vdt_pallas.py::_chamfer_kernel (wrapper
// pallas_chamfer), which fused `passes` passes into one kernel with a
// `passes`-deep halo. Each pass is
//   out(p) = min(in(p), min_o in(p + o) + |o| * dx)
// over the 26 offsets in _OFFSETS26 order (acc = fminf(acc, nb + step)),
// with cells outside the grid reading 3e38 before EVERY pass, exactly as
// vdt.chamfer_relax pads them. The three step lengths |o| * dx (for |o|^2 =
// 1, 2, 3) come from the caller, rounded to float32 the same way as the
// twin's.
//
// Layout. A block owns a (kTJ x kTK) column of the grid (k fastest) and
// marches along i over one segment [i0, i1) of `seg` planes; the launcher
// splits i so that the card holds every block at once (one wave: the
// columns times the segments fill the SMs times the blocks one SM holds).
// Shared memory holds a rolling window per pass level: level 0 (the
// input) in a ring of four planes, levels 1..P-1 in rings of three, each
// plane (kTJ + 2P [+ pad]) x (kTK + 2P) floats, the column and its P-deep
// halo in j and k. Step q copies input plane q+1
// into the ring with cp.async while it relaxes level L at plane q - L for
// L = 1..P from level L-1's planes q-L-1, q-L, q-L+1; level P is the
// output and goes straight to device memory. Level L is computed on the
// column plus a (P - L)-deep halo, so the segment starts with a warm-up of
// 2P planes before its first output plane (input planes i0 - P .. i1 + P -
// 1 are read).
// Out-of-grid cells: a window cell outside the grid (j or k outside, or a
// plane outside [0, ni)) holds 3e38 at every level: level 0 stores 3e38
// there instead of copying, and each later level stores 3e38 there instead
// of its relaxed value (the twin pads each pass's input anew).
// A thread relaxes a strip of kR cells along j at one k: per source plane
// it loads the (kR + 2) x 3 neighbourhood once into registers and applies
// its offsets to each cell in _OFFSETS26 order (plane i-1's nine, plane i's
// eight, plane i+1's nine; ob, then oc, ascending).
//
// Bound on the H100: device-memory traffic, 4 B read and 4 B written per
// cell for all P passes together (the halo re-reads between blocks hit
// L2); 2 x 26 x P FP32 operations per cell. Built with --fmad=false (there
// is nothing to contract, but the flag keeps all kernels of the library
// under one rule).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3e38f;

// tile geometry per P (tests/test_torch_chamfer_tiles.py transcribes it)
template <int P>
struct Tile {
  static constexpr int kTJ = P <= 2 ? 32 : 16;  // j rows of the column
  static constexpr int kTK = 64;                // k columns of the column
  static constexpr int kR = 4;                  // cells per thread strip
  static constexpr int kW = kTK + 2 * P;        // plane row length
  // plane rows: the halo'd column plus rows that the last strip of a level
  // may overhang (computed, never read by a kept value)
  static constexpr int kRows = kTJ + 2 * P + kR - 1;
  static constexpr int kPlane = kRows * kW;
  static constexpr int kPlanes = 4 + 3 * (P - 1);
  static constexpr int kSmem = kPlanes * kPlane * 4;
};

// Level `level`'s slot for the plane `rel` planes after the segment's
// first input plane (rel >= 0): level 0 rings over four slots, levels 1..P-1
// over three each.
template <int P>
__device__ __forceinline__ float* ring(float* smem, int level, int rel) {
  const int slot = level == 0 ? (rel & 3) : 4 + 3 * (level - 1) + rel % 3;
  return smem + slot * Tile<P>::kPlane;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Level 0's plane q of the block's window into `dst`: copied where the
// cell lies in the grid, 3e38 elsewhere.
template <int P>
__device__ __forceinline__ void load_plane(const float* __restrict__ in,
                                           float* dst, int q, int ni, int nj,
                                           int nk, int j0, int k0) {
  using T = Tile<P>;
  const bool plane_in = q >= 0 && q < ni;
  const long long base = (long long)q * nj;
  for (int e = threadIdx.x; e < (T::kTJ + 2 * P) * T::kW; e += kThreads) {
    const int r = e / T::kW, c = e - r * T::kW;
    const int gj = j0 - P + r, gk = k0 - P + c;
    if (plane_in && gj >= 0 && gj < nj && gk >= 0 && gk < nk)
      cp_async4(dst + e, in + (base + gj) * nk + gk);
    else
      dst[e] = kBig;
  }
}

// Level L (1..P) at one plane from level L-1's planes below / at / above
// it. The level covers window rows and columns [L, L + n) with n = kTJ +
// 2(P - L) rows and kTK + 2(P - L) columns. L < P: into `dst` (3e38 for a
// cell outside the grid); L == P: into `out` at plane `p`, cells in the
// grid only.
template <int P, int L>
__device__ __forceinline__ void relax_level(
    const float* below, const float* at, const float* above, float* dst,
    float* __restrict__ out, long long p, int nj, int nk, int j0, int k0,
    float s1, float s2, float s3) {
  using T = Tile<P>;
  constexpr int kH = P - L;
  constexpr int kCols = T::kTK + 2 * kH;
  constexpr int kStrips = (T::kTJ + 2 * kH + T::kR - 1) / T::kR;
  const float steps[3] = {s1, s2, s3};
  for (int it = threadIdx.x; it < kStrips * kCols; it += kThreads) {
    const int s = it / kCols;
    const int c = L + (it - s * kCols);
    const int r0 = L + s * T::kR;
    float acc[T::kR];
#pragma unroll
    for (int t = 0; t < T::kR; ++t) acc[t] = at[(r0 + t) * T::kW + c];
#pragma unroll
    for (int oa = -1; oa <= 1; ++oa) {
      const float* src = oa < 0 ? below : (oa == 0 ? at : above);
      float v[T::kR + 2][3];
#pragma unroll
      for (int rr = 0; rr < T::kR + 2; ++rr)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          v[rr][cc] = src[(r0 - 1 + rr) * T::kW + c - 1 + cc];
#pragma unroll
      for (int t = 0; t < T::kR; ++t)
#pragma unroll
        for (int ob = -1; ob <= 1; ++ob)
#pragma unroll
          for (int oc = -1; oc <= 1; ++oc) {
            if (oa == 0 && ob == 0 && oc == 0) continue;
            const float step = steps[oa * oa + ob * ob + oc * oc - 1];
            acc[t] = fminf(acc[t], v[t + 1 + ob][1 + oc] + step);
          }
    }
    const int gk = k0 - P + c;
#pragma unroll
    for (int t = 0; t < T::kR; ++t) {
      const int gj = j0 - P + r0 + t;
      const bool in_grid = gj >= 0 && gj < nj && gk >= 0 && gk < nk;
      if (L < P)
        dst[(r0 + t) * T::kW + c] = in_grid ? acc[t] : kBig;
      else if (in_grid)
        out[(p * nj + gj) * nk + gk] = acc[t];
    }
  }
}

// Step q's levels L, L+1, .., P: level L at plane p = q - L from level
// L-1's planes p-1, p, p+1 (held from step base + 2L on), then a barrier
// before level L+1 reads it.
template <int P, int L>
__device__ __forceinline__ void relax_levels(float* smem,
                                             float* __restrict__ out, int q,
                                             int base, int ni, int nj, int nk,
                                             int j0, int k0, float s1,
                                             float s2, float s3) {
  using T = Tile<P>;
  const int p = q - L;
  if (q >= base + 2 * L) {
    const float* below = ring<P>(smem, L - 1, p - 1 - base);
    const float* at = ring<P>(smem, L - 1, p - base);
    const float* above = ring<P>(smem, L - 1, p + 1 - base);
    float* dst = L < P ? ring<P>(smem, L, p - base) : nullptr;
    if (L < P && (p < 0 || p >= ni)) {
      for (int e = threadIdx.x; e < T::kPlane; e += kThreads) dst[e] = kBig;
    } else {
      relax_level<P, L>(below, at, above, dst, out, p, nj, nk, j0, k0, s1,
                        s2, s3);
    }
  }
  if constexpr (L < P) {
    __syncthreads();
    relax_levels<P, L + 1>(smem, out, q, base, ni, nj, nk, j0, k0, s1, s2,
                           s3);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
chamfer_fused_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int ni, int nj, int nk, int seg, int tiles_k, float s1,
                     float s2, float s3) {
  extern __shared__ float smem[];
  const int j0 = (blockIdx.x / tiles_k) * Tile<P>::kTJ;
  const int k0 = (blockIdx.x % tiles_k) * Tile<P>::kTK;
  const int i0 = blockIdx.y * seg;
  const int i1 = min(i0 + seg, ni);
  const int base = i0 - P;  // the segment's first input plane

  load_plane<P>(in, ring<P>(smem, 0, 0), base, ni, nj, nk, j0, k0);
  cp_async_commit();
  for (int q = base; q < i1 + P; ++q) {
    cp_async_wait_all();
    // plane q has landed, and every thread is past step q-1's reads, so
    // the slots of level 0's plane q-3 and level L's plane q-L-3 are free
    __syncthreads();
    if (q + 1 < i1 + P)
      load_plane<P>(in, ring<P>(smem, 0, q + 1 - base), q + 1, ni, nj, nk,
                    j0, k0);
    cp_async_commit();
    relax_levels<P, 1>(smem, out, q, base, ni, nj, nk, j0, k0, s1, s2, s3);
  }
}

// the opt-in above 48 KB of dynamic shared memory (per device, so before
// every launch)
template <int P>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(chamfer_fused_kernel<P>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<P>::kSmem);
}

template <int P>
cudaError_t launch(const float* in, float* out, int ni, int nj, int nk,
                   float s1, float s2, float s3, cudaStream_t stream) {
  using T = Tile<P>;
  cudaError_t err = allow_smem<P>();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chamfer_fused_kernel<P>, kThreads, T::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_j = (nj + T::kTJ - 1) / T::kTJ;
  const int tiles_k = (nk + T::kTK - 1) / T::kTK;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long columns = (long long)tiles_j * tiles_k;
  const long long segments = slots / columns > 1 ? slots / columns : 1;
  const int seg = (int)((ni + segments - 1) / segments);
  const dim3 grid(tiles_j * tiles_k, (ni + seg - 1) / seg);
  chamfer_fused_kernel<P><<<grid, kThreads, T::kSmem, stream>>>(
      in, out, ni, nj, nk, seg, tiles_k, s1, s2, s3);
  return cudaGetLastError();
}

}  // namespace

// `passes` (1..4) fused passes from `in` into `out` (distinct buffers).
extern "C" int sdf_chamfer(const float* in, float* out, int ni, int nj,
                           int nk, int passes, float s1, float s2, float s3,
                           void* stream) {
  if (passes < 1 || passes > 4 || in == out)
    return (int)cudaErrorInvalidValue;
  if ((long long)ni * nj * nk == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (passes) {
    case 1: return (int)launch<1>(in, out, ni, nj, nk, s1, s2, s3, s);
    case 2: return (int)launch<2>(in, out, ni, nj, nk, s1, s2, s3, s);
    case 3: return (int)launch<3>(in, out, ni, nj, nk, s1, s2, s3, s);
    default: return (int)launch<4>(in, out, ni, nj, nk, s1, s2, s3, s);
  }
}
