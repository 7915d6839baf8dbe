// K3: one Jacobi round of the closest-point jump flood.
//
// Replaces sdfgenfast_tpu/ops/vdt_pallas.py::_round_kernel (wrappers
// _call_round / pallas_round_phase). State is channel-first (5, ni, nj, nk):
// closest point x/y/z, the int32 triangle id stored as raw bits, and d2.
// One thread per cell visits the 26 donors at `stride` in _OFFSETS26 order
// (a, b, c each over -1, 0, 1, c fastest), scores each donor's closest point
// against the cell position f32(index * scale) * dx with the same operation
// order as vdt._dist2, and adopts all five channels on a strict '<'. Donors
// outside the grid do not exist (the jnp round reads FAR padding there,
// which never wins). Reads come from `in`, writes go to `out`: the caller
// ping-pongs two buffers, which is the Jacobi semantics.
//
// Every channel is loaded and stored as 32-bit words. The id channel never
// passes through float arithmetic: small ids are denormal floats, and a
// float move or compare could flush them.
//
// Bound on the H100: device-memory traffic. Per cell one round reads 26
// donor closest points (12 B each, mostly from L1/L2 at small strides) plus
// its own 20 B and writes 20 B; the arithmetic is ~9 FP32 operations per
// donor. No shape gate: any (ni, nj, nk), stride and scale.
// Built with --fmad=false so d2 rounds exactly like the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vdt_round_kernel(const unsigned int* __restrict__ in,
                 unsigned int* __restrict__ out, int ni, int nj, int nk,
                 int stride, int scale, float dx) {
  const long long n = (long long)ni * nj * nk;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int k = (int)(idx % nk);
  const long long r = idx / nk;
  const int j = (int)(r % nj);
  const int i = (int)(r / nj);

  const float px = (float)(i * scale) * dx;
  const float py = (float)(j * scale) * dx;
  const float pz = (float)(k * scale) * dx;

  const unsigned int* in_x = in;
  const unsigned int* in_y = in + n;
  const unsigned int* in_z = in + 2 * n;
  const unsigned int* in_t = in + 3 * n;
  const unsigned int* in_d = in + 4 * n;

  unsigned int bx = in_x[idx], by = in_y[idx], bz = in_z[idx];
  unsigned int bt = in_t[idx];
  float bd = __uint_as_float(in_d[idx]);

#pragma unroll
  for (int m = 0; m < 27; ++m) {
    const int oa = m / 9 - 1, ob = (m / 3) % 3 - 1, oc = m % 3 - 1;
    if (m == 13) continue;  // (0, 0, 0)
    const int ci = i + oa * stride;
    const int cj = j + ob * stride;
    const int ck = k + oc * stride;
    if (ci < 0 || ci >= ni || cj < 0 || cj >= nj || ck < 0 || ck >= nk)
      continue;
    const long long d = ((long long)ci * nj + cj) * nk + ck;
    const unsigned int cxb = in_x[d], cyb = in_y[d], czb = in_z[d];
    const float ex = px - __uint_as_float(cxb);
    const float ey = py - __uint_as_float(cyb);
    const float ez = pz - __uint_as_float(czb);
    const float cd2 = ex * ex + ey * ey + ez * ez;
    if (cd2 < bd) {
      bx = cxb;
      by = cyb;
      bz = czb;
      bt = in_t[d];
      bd = cd2;
    }
  }
  out[idx] = bx;
  out[n + idx] = by;
  out[2 * n + idx] = bz;
  out[3 * n + idx] = bt;
  out[4 * n + idx] = __float_as_uint(bd);
}

}  // namespace

extern "C" int sdf_vdt_round(const void* in, void* out, int ni, int nj, int nk,
                             int stride, int scale, float dx, void* stream) {
  const long long n = (long long)ni * nj * nk;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    vdt_round_kernel<<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const unsigned int*)in, (unsigned int*)out, ni, nj, nk, stride, scale,
        dx);
  }
  return (int)cudaGetLastError();
}
