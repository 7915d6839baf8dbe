// K4: one 26-offset min-plus (chamfer / Lipschitz) relaxation pass.
//
// Replaces sdfgenfast_tpu/ops/vdt_pallas.py::_chamfer_kernel (wrapper
// pallas_chamfer), which fused `passes` passes into one kernel with a
// `passes`-deep halo. Here each pass is one launch over ping-pong buffers:
//   out(p) = min(in(p), min_o in(p + o) + |o| * dx)
// over the 26 offsets in _OFFSETS26 order, with cells outside the grid
// reading 3e38 exactly as vdt.chamfer_relax pads them. The three step
// lengths |o| * dx (for |o|^2 = 1, 2, 3) come from the caller, rounded to
// float32 the same way as the twin's.
//
// Bound on the H100: device-memory traffic, 4 B read and 4 B written per
// cell once the 26 neighbour reads hit L1/L2; ~52 FP32 operations per cell.
// Built with --fmad=false (there is nothing to contract, but the flag keeps
// all kernels of the library under one rule).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3e38f;

__global__ void __launch_bounds__(kThreads)
chamfer_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int ni, int nj, int nk, float s1, float s2, float s3) {
  const long long n = (long long)ni * nj * nk;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int k = (int)(idx % nk);
  const long long r = idx / nk;
  const int j = (int)(r % nj);
  const int i = (int)(r / nj);

  float acc = in[idx];
#pragma unroll
  for (int m = 0; m < 27; ++m) {
    const int oa = m / 9 - 1, ob = (m / 3) % 3 - 1, oc = m % 3 - 1;
    if (m == 13) continue;  // (0, 0, 0)
    const int norm2 = oa * oa + ob * ob + oc * oc;
    const float step = norm2 == 1 ? s1 : (norm2 == 2 ? s2 : s3);
    const int ci = i + oa, cj = j + ob, ck = k + oc;
    const bool inside =
        ci >= 0 && ci < ni && cj >= 0 && cj < nj && ck >= 0 && ck < nk;
    const float nb =
        inside ? in[((long long)ci * nj + cj) * nk + ck] : kBig;
    acc = fminf(acc, nb + step);
  }
  out[idx] = acc;
}

}  // namespace

extern "C" int sdf_chamfer_pass(const float* in, float* out, int ni, int nj,
                                int nk, float s1, float s2, float s3,
                                void* stream) {
  const long long n = (long long)ni * nj * nk;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    chamfer_pass_kernel<<<(unsigned int)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(in, out, ni, nj, nk, s1, s2,
                                                  s3);
  }
  return (int)cudaGetLastError();
}
