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
// P3  out = x*2, one CTA per TPU grid step of `block_floats` floats: the
//     cost of a block that moves little data. Bound: device-memory bytes.
// P4  out = x + 1 over the whole array: the device-memory stream rate.
//     Bound: bytes.
//     Both are tile_kernel: each CTA moves its tile's 16-byte-aligned body
//     with bulk copies (cp.async.bulk, the TMA's 1-D form) through a ring
//     of `stages` shared-memory stages of `chunk` floats, completing on one
//     mbarrier per stage: one thread issues the loads and the stores, every
//     thread applies the operation to the stage in place with float4
//     arithmetic. A tile of several chunks keeps the loads of the next
//     stages in flight while a chunk is computed and stored, and a stage is
//     loaded again only after its store has read it (wait_group.read). The
//     launcher may give a CTA more shared memory than its ring needs, to
//     hold an SM to a few CTAs: the card streams fastest with few tiles in
//     flight (tools/micro_bench: P3 one CTA per TPU grid step, P4 one per
//     stage-sized tile). x and out share their offset modulo 16 bytes (P3's
//     wrapper allocates out so; P4 takes 16-byte-aligned x only), so the up
//     to 3 floats before a tile's first 16-byte boundary and the up to 3
//     after its body are the same floats in both; the CTA's threads move
//     them with scalar loads.
//
// The chains read their start from memory and store their end, so the loops
// cannot be folded; `cuobjdump -sass` counts their FFMA/FMUL/FADD.

#include <cuda_runtime.h>

#include <cstdint>

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

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// -- bulk copies and mbarriers (sm_90) ---------------------------------------

constexpr int kMaxStages = 16;
// the stages' barriers at the start of dynamic shared memory; the stages
// follow, 128-byte aligned
constexpr int kBarBytes = kMaxStages * 8;
// a barrier's transaction count is below 2^20 bytes: the largest stage
constexpr long long kMaxStageBytes = (1 << 20) - 16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of bulk-copy transactions
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on the barrier at `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, committed as one bulk group of the issuing thread
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until all but the newest kPending bulk groups have read their source
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy (bulk copy) accesses
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- P3 and P4: tiles through a ring of bulk copies --------------------------

constexpr int kTileThreads = 128;

// P4's x + 1 (kAdd) or P3's x * 2
template <bool kAdd>
__device__ __forceinline__ float apply(float v) {
  return kAdd ? v + 1.0f : v * 2.0f;
}

// CTA b owns floats [b * tile, min((b + 1) * tile, n)) of x and out, which
// sit `lead` floats past a 16-byte boundary. Its head (up to 3 floats, to
// the tile's first 16-byte boundary) and tail (up to 3 after the body) are
// scalar; its body goes through the ring in chunks of `chunk` floats.
template <bool kAdd>
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
            long long tile, int lead, int stages, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * tile;
  const long long len = min(tile, n - base);
  const long long head = min((long long)((4 - (lead + base) % 4) % 4), len);
  const long long body = (len - head) / 4 * 4;
  const long long tail = len - head - body;
  const int nch = (int)((body + chunk - 1) / chunk);
  const float* xb = x + base + head;
  float* ob = out + base + head;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(full + s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    for (int c = 0; c < min(stages, nch); ++c) {
      const unsigned bytes = 4u * (unsigned)min((long long)chunk,
                                                body - (long long)c * chunk);
      mbar_expect_tx(smem_u32(full + c), bytes);
      bulk_load(smem_u32(ring + (long long)c * chunk),
                xb + (long long)c * chunk, bytes, smem_u32(full + c));
    }
  }
  if (t >= 32 && t < 32 + head)
    out[base + t - 32] = apply<kAdd>(x[base + t - 32]);
  if (t >= 64 && t < 64 + tail) {
    const long long i = base + head + body + (t - 64);
    out[i] = apply<kAdd>(x[i]);
  }
  for (int c = 0; c < nch; ++c) {
    const int s = c % stages;
    const int len4 =
        (int)min((long long)chunk, body - (long long)c * chunk) / 4;
    float4* v = reinterpret_cast<float4*>(ring + (long long)s * chunk);
    mbar_wait(smem_u32(full + s), (unsigned)(c / stages) & 1u);
    for (int q = t; q < len4; q += kTileThreads) {
      float4 w = v[q];
      w.x = apply<kAdd>(w.x);
      w.y = apply<kAdd>(w.y);
      w.z = apply<kAdd>(w.z);
      w.w = apply<kAdd>(w.w);
      v[q] = w;
    }
    fence_async_smem();
    __syncthreads();
    if (t == 0) {
      bulk_store(ob + (long long)c * chunk, smem_u32(v), 16u * len4);
      // chunk c + stages - 1 into the stage of chunk c - 1, once that
      // chunk's store (the group before this one) has read it
      const int next = c + stages - 1;
      if (c >= 1 && next < nch) {
        const int ns = next % stages;
        const unsigned bytes = 4u * (unsigned)min((long long)chunk,
                                                  body - (long long)next * chunk);
        bulk_wait_read<1>();
        mbar_expect_tx(smem_u32(full + ns), bytes);
        bulk_load(smem_u32(ring + (long long)ns * chunk),
                  xb + (long long)next * chunk, bytes, smem_u32(full + ns));
      }
    }
  }
  // the last stores must have read shared memory before the CTA exits
  if (t == 0 && nch > 0) bulk_wait_read<0>();
}

// dynamic shared memory of a ring of `stages` stages of `chunk` floats
long long ring_bytes(int stages, int chunk) {
  return kBarBytes + 4LL * stages * chunk;
}

// opt in to more than 48 KB of dynamic shared memory where needed
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ceil(n / tile) CTAs of tile_kernel<kAdd> with `smem` bytes of dynamic
// shared memory (at least the ring's); x and out share their offset modulo
// 16 bytes. A ring of one stage takes a tile whose body is one chunk at
// most.
template <bool kAdd>
int launch_tiles(const float* x, float* out, long long n, long long tile,
                 int stages, int chunk, long long smem, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
  const long long blocks = tile > 0 ? (n + tile - 1) / tile : 0;
  if (tile <= 0 || blocks > 0x7fffffffLL || stages < 1 ||
      stages > kMaxStages || chunk < 4 || chunk % 4 ||
      4LL * chunk > kMaxStageBytes || (stages == 1 && chunk < tile / 4 * 4) ||
      smem < ring_bytes(stages, chunk) || xa % 4 || (xa ^ oa) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(tile_kernel<kAdd>, smem);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<kAdd><<<(int)blocks, kTileThreads, (size_t)smem,
                      (cudaStream_t)stream>>>(x, out, n, tile,
                                              (int)(xa / 4 % 4), stages,
                                              chunk);
  return (int)cudaGetLastError();
}

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

// P3: x * 2, one CTA per tile of `tile` floats of the n (the TPU grid's
// steps: n = steps * tile).
extern "C" int sdf_probe_scale2(const float* x, float* out, long long n,
                                long long tile, int stages, int chunk,
                                long long smem, void* stream) {
  return launch_tiles<false>(x, out, n, tile, stages, chunk, smem, stream);
}

// P4: x + 1, one CTA per tile of `tile` floats, the last one ragged.
extern "C" int sdf_probe_add1(const float* x, float* out, long long n,
                              long long tile, int stages, int chunk,
                              long long smem, void* stream) {
  return launch_tiles<true>(x, out, n, tile, stages, chunk, smem, stream);
}

// The dynamic shared memory of a launch of P3's (add = 0) or P4's (1)
// kernel whose ring takes `ring` bytes: the ring, or more where that holds
// the SM to at most `ctas_per_sm` CTAs (0: no cap); then the CTAs an SM
// holds at that size, and the threads per CTA.
extern "C" int sdf_probe_tile_plan(int add, long long ring, int ctas_per_sm,
                                   long long* smem, int* blocks,
                                   int* threads) {
  int dev, per_sm, reserved, optin;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return (int)err;
  *smem = ring;
  if (ctas_per_sm > 0) {
    const long long cap = per_sm / ctas_per_sm - reserved;
    *smem = cap < ring ? ring : cap < optin ? cap : optin;
  }
  *threads = kTileThreads;
  err = add ? allow_smem(tile_kernel<true>, *smem)
            : allow_smem(tile_kernel<false>, *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)(add ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, tile_kernel<true>, kTileThreads, *smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, tile_kernel<false>, kTileThreads, *smem));
}
