// P1-P4: probes of the card's ceilings, built with the same flags as the
// distance kernels (--fmad=false, IEEE division and sqrt) and launched the
// same way (plain C entry points on a given stream).
//
// They replace the Pallas probes of tools/micro_bench.py: vpu_peak (P1),
// vpu_mixed (P2), grid_overhead (P3) and hbm_stream (P4). Each computes what
// the Pallas kernel computes, element for element; the TPU block layout is
// not carried over, except in P3, whose point is the cost of a block.
//
// P1  a = x; b = a*1.000001 + 0.5; `chain` times { a = a*b + 1; b = b*a + 0.5 };
//     out = a + b. Two variants: separate __fmul_rn/__fadd_rn (what the
//     distance kernels get under --fmad=false) and __fmaf_rn (the card's FP32
//     peak). Bound: dependent FP32 issue; one thread per element, so enough
//     warps are in flight to hide the 4-cycle dependency. The loops unroll
//     32 times, so the counter, compare and branch cost 3 instructions per
//     64 (FMA) or 128 (no FMA) arithmetic ones.
// P2  a = x; b = a + 0.25; best = a*0 + 3e18; `chain` times { d = a*b + 1;
//     d = d*d; best = d < best ? d : best; a = a + 0.125; b = b*0.999 };
//     out = best: multiply, add, compare and select, as the distance kernels
//     mix them.
// P3  out = x*2, one thread block per TPU grid step of `block_floats`
//     floats: the cost of a block that moves little data.
// P4  out = x + 1 over the whole array, 16-byte loads and stores, four in
//     flight per thread before the stores: the device-memory stream rate.
//
// The chains read their start from memory and store their end, so the loops
// cannot be folded; `cuobjdump -sass` counts their FFMA/FMUL/FADD.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kFma>
__global__ void __launch_bounds__(kThreads)
vpu_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long n, int chain) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float b = kFma ? __fmaf_rn(a, 1.000001f, 0.5f)
                 : __fadd_rn(__fmul_rn(a, 1.000001f), 0.5f);
#pragma unroll 32
  for (int s = 0; s < chain; ++s) {
    if (kFma) {
      a = __fmaf_rn(a, b, 1.0f);
      b = __fmaf_rn(b, a, 0.5f);
    } else {
      a = __fadd_rn(__fmul_rn(a, b), 1.0f);
      b = __fadd_rn(__fmul_rn(b, a), 0.5f);
    }
  }
  out[i] = a + b;
}

__global__ void __launch_bounds__(kThreads)
vpu_mixed_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int chain) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float b = a + 0.25f;
  float best = a * 0.0f + 3e18f;
#pragma unroll 32
  for (int s = 0; s < chain; ++s) {
    float d = a * b + 1.0f;
    d = d * d;
    best = d < best ? d : best;
    a = a + 0.125f;
    b = b * 0.999f;
  }
  out[i] = best;
}

// Block b owns floats [b * block_floats, (b + 1) * block_floats).
__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float* __restrict__ x, float* __restrict__ out,
              int block_floats) {
  const long long base = (long long)blockIdx.x * block_floats;
  for (int q = threadIdx.x; q < block_floats; q += kThreads)
    out[base + q] = x[base + q] * 2.0f;
}

constexpr int kVec = 4;  // float4s in flight per thread

// x and out 16-byte aligned; n4 float4s, then a scalar tail of n % 4. Block
// b owns float4s [b * kThreads * kVec, (b + 1) * kThreads * kVec), thread t
// the ones at t + q * kThreads: neighbouring lanes on neighbouring addresses.
__global__ void __launch_bounds__(kThreads)
add1_kernel(const float4* __restrict__ x, float4* __restrict__ out,
            long long n4, const float* __restrict__ xt, float* __restrict__ ot,
            int tail) {
  const long long base = (long long)blockIdx.x * (kThreads * kVec) + threadIdx.x;
  float4 v[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const long long i = base + (long long)q * kThreads;
    if (i < n4) v[q] = x[i];
  }
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const long long i = base + (long long)q * kThreads;
    if (i < n4) {
      v[q].x = v[q].x + 1.0f;
      v[q].y = v[q].y + 1.0f;
      v[q].z = v[q].z + 1.0f;
      v[q].w = v[q].w + 1.0f;
      out[i] = v[q];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail)
    ot[threadIdx.x] = xt[threadIdx.x] + 1.0f;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int sdf_probe_vpu_peak(const float* x, float* out, long long n,
                                  int chain, int fma, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (fma)
    vpu_peak_kernel<true><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, out, n, chain);
  else
    vpu_peak_kernel<false><<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(x, out, n, chain);
  return (int)cudaGetLastError();
}

extern "C" int sdf_probe_vpu_mixed(const float* x, float* out, long long n,
                                   int chain, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  vpu_mixed_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, chain);
  return (int)cudaGetLastError();
}

extern "C" int sdf_probe_scale2(const float* x, float* out, int n_blocks,
                                int block_floats, void* stream) {
  if (n_blocks <= 0 || block_floats <= 0) return (int)cudaGetLastError();
  scale2_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, block_floats);
  return (int)cudaGetLastError();
}

extern "C" int sdf_probe_add1(const float* x, float* out, long long n,
                              void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long n4 = n / 4;
  const int tail = (int)(n % 4);
  const long long per_block = (long long)kThreads * kVec;
  const long long blocks = n4 > 0 ? (n4 + per_block - 1) / per_block : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  add1_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4,
      x + 4 * n4, out + 4 * n4, tail);
  return (int)cudaGetLastError();
}
