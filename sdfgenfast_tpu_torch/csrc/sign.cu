// The sign stage: the x-ray parity decoded to its (ni, nj, nk) bool field,
// or phi's sign flipped where the parity is odd, in one pass over the grid.
//
// Replaces the torch ops of the stage (ops/sign_host.unpack_parity_device
// or parity_from_crossings_device, then torch.where(parity, -phi, phi)):
// a shift, a mask and a cast over the packed field, or a broadcast compare
// and an XOR a crossing row, then -phi and the select, each a pass over the
// grid. The parity comes in one of three forms (`kind`):
//   0 packed:    (nb >= ceil(ni / 8), nj, nk) uint8, bit r of byte (b, j, k)
//                the parity of cell (8b + r, j, k) (pack_parity, bitorder
//                little);
//   1 crossings: (C, nj, nk) int16, parity(i) = XOR_c [i >= cr(c)]
//                (crossings_host; the sentinel 32767 toggles nothing);
//   2 bool:      (ni, nj, nk), the parity itself (the device sign's field).
// Modes: decode (phi null) writes the bool field, one byte 0 or 1 a cell;
// sign writes phi with its sign bit XOR the parity, bit for bit -phi where
// odd (-0.0 and NaN included). `out` may be `phi` (in place): each cell is
// read and written by one thread.
//
// Layout. A thread owns one byte row b of one column col = j * nk + k: the
// cells i = 8b .. min(8b + 8, ni) - 1. blockIdx.y is b and the threads of
// a block run along col, so at each i a warp reads and writes 32
// consecutive columns: 32 bytes of parity or bool field, 128 of phi. The
// thread first builds its eight cells' parity bits in one byte: packed
// reads that byte; crossings XOR each crossing's suffix mask over the eight
// rows (0xff where cr <= 8b, 0 where cr >= 8b + 8, else 0xff << (cr - 8b)),
// each crossing read once a byte row (from L2 after the first); bool reads
// the eight cells. Then it writes its cells, the loads all issued before
// the stores.
//
// Bound on the H100: device-memory traffic. Decode: 1 B written a cell,
// plus the input (1/8 B a cell packed, 2C B a column crossings, 1 B a cell
// bool); sign: 4 B read and 4 B written a cell, plus the input.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kKind>
__device__ __forceinline__ unsigned parity_bits(const void* __restrict__ par,
                                                int rows, long long ncols,
                                                long long col, int i0,
                                                int n) {
  if (kKind == 0)
    return static_cast<const unsigned char*>(par)[(long long)blockIdx.y
                                                  * ncols + col];
  unsigned bits = 0;
  if (kKind == 1) {
    const short* cr = static_cast<const short*>(par) + col;
    for (int c = 0; c < rows; ++c) {
      const int d = (int)cr[(long long)c * ncols] - i0;
      bits ^= d <= 0 ? 0xffu : d >= 8 ? 0u : (0xffu << d) & 0xffu;
    }
    return bits;
  }
  const unsigned char* p = static_cast<const unsigned char*>(par) + col;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < n) bits |= (unsigned)(p[(long long)(i0 + r) * ncols] != 0) << r;
  return bits;
}

template <int kKind, bool kSign>
__global__ void __launch_bounds__(kThreads)
    parity_sign_kernel(const void* __restrict__ par, int rows,
                       const float* phi, void* out, int ni, long long ncols) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= ncols) return;
  const int i0 = (int)blockIdx.y * 8;
  const int n = min(8, ni - i0);
  const unsigned bits = parity_bits<kKind>(par, rows, ncols, col, i0, n);
  const long long base = (long long)i0 * ncols + col;
  if (!kSign) {
    unsigned char* o = static_cast<unsigned char*>(out) + base;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < n) o[(long long)r * ncols] = (unsigned char)((bits >> r) & 1u);
    return;
  }
  const unsigned* src = reinterpret_cast<const unsigned*>(phi) + base;
  unsigned* dst = static_cast<unsigned*>(out) + base;
  unsigned v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < n) v[r] = src[(long long)r * ncols];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < n) dst[(long long)r * ncols] = v[r] ^ (((bits >> r) & 1u) << 31);
}

template <int kKind>
cudaError_t launch(const void* par, int rows, const float* phi, void* out,
                   int ni, long long ncols, cudaStream_t s) {
  const dim3 grid((unsigned)((ncols + kThreads - 1) / kThreads),
                  (unsigned)((ni + 7) / 8));
  if (phi != nullptr)
    parity_sign_kernel<kKind, true><<<grid, kThreads, 0, s>>>(
        par, rows, phi, out, ni, ncols);
  else
    parity_sign_kernel<kKind, false><<<grid, kThreads, 0, s>>>(
        par, rows, phi, out, ni, ncols);
  return cudaGetLastError();
}

}  // namespace

// kind 0 packed, 1 crossings (rows = C), 2 bool; phi null: decode into the
// bool field `out`, else the signed phi into `out` (which may be phi).
extern "C" int sdf_parity_sign(const void* parity, int kind, int rows,
                               const float* phi, void* out, int ni, int nj,
                               int nk, void* stream) {
  if (kind < 0 || kind > 2 || ni < 0 || nj < 0 || nk < 0 || rows < 0
      || (ni + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  const long long ncols = (long long)nj * nk;
  if (ni == 0 || ncols == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return (int)launch<0>(parity, rows, phi, out, ni, ncols, s);
    case 1: return (int)launch<1>(parity, rows, phi, out, ni, ncols, s);
    default: return (int)launch<2>(parity, rows, phi, out, ni, ncols, s);
  }
}
