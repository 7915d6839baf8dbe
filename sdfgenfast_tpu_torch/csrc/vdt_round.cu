// K3: one Jacobi round of the closest-point jump flood, tiled in shared
// memory.
//
// Replaces sdfgenfast_tpu/ops/vdt_pallas.py::_round_kernel (wrappers
// _call_round / pallas_round_phase). State is channel-first (5, ni, nj, nk):
// closest point x/y/z, the int32 triangle id stored as raw bits, and d2.
// Every cell visits the 26 donors at `stride` in _OFFSETS26 order (a, b, c
// each over -1, 0, 1, c fastest), scores each donor's closest point against
// the cell position f32(index * scale) * dx with the same operation order as
// vdt._dist2, and adopts all five channels on a strict '<'. Donors outside
// the grid do not exist: they are excluded by index, never by a sentinel
// value (the jnp round reads FAR padding there, which never wins). Reads come
// from `in`, writes go to `out`: the caller ping-pongs two buffers, which is
// the Jacobi semantics.
//
// Tiling. A block owns cells that form a sub-lattice in i and j,
// i = ri + (qa0 + a) * stride (a segment of up to kMaxSeg cells of residue
// class ri) and j = rj + (qb0 + b) * stride (a tile of 8 or 16 rows), and
// that are contiguous in k, k = k0 + kk (kTileK cells). The +-stride donors
// in i and j are then direct lattice neighbours, so one halo shape, one
// lattice row on each side, serves every stride. In k each staged row holds
// the run [k0 - stride, k0 + kTileK + stride) when stride <= kTileK and
// otherwise the three runs of kTileK cells at k0 - stride, k0 and
// k0 + stride: the donor at k offset c of the cell k0 + kk lies at position
// kk + (1 + c) * min(stride, kTileK) of its row in both cases. Every global
// load is a run along k.
//
// Staging. The block walks its segment along i one lattice plane at a time
// (plane la: lattice row qa0 - 1 + la and the tile's rows in j, plus one on
// each side). Each plane's round-start x, y, z and id are copied into
// shared memory once, with cp.async (4 B each, positions outside the grid
// left unread), into a ring of kSlots planes; kAhead planes are in flight
// while the walk reads the current one, so the copies overlap the
// arithmetic inside every block (blocks that each stage a whole tile and
// then compute run in lockstep, and their copy and compute phases add up).
// Every donor is read from the ring; the own d2 is read once, two cells
// ahead.
//
// Layout: a warp takes one or two rows b of the tile (two where the residue
// classes have 16 rows or more, so a staged position serves both), its lanes
// the kTileK cells along k, so ring reads are conflict-free and the stores
// of all five channels coalesce.
//
// Every channel moves as 32-bit words. The id channel never passes through
// float arithmetic: small ids are denormal floats, and a float move or
// compare could flush them.
//
// Bound on the H100: device-memory traffic, 40 B per cell and round (20 B
// read once, 20 B written). The ring moves ~(rows + 2) / rows x (32 + 2
// min(stride, 32)) / 32 x (seg + 2) / seg x 16 B per cell from L2 into
// shared memory. Per cell, the 26 donors cost ~5 instructions each (2 sums,
// the compare and two selects); each staged position costs ~14 more (three
// shared loads, the x terms of the three cells, the y and z terms), shared
// by up to six cells. No shape gate: any (ni, nj, nk), stride and scale.
// Built with --fmad=false so d2 rounds exactly like the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;          // contiguous cells along k, one per lane
constexpr int kChannels = 4;        // x, y, z, id
constexpr int kAhead = 2;           // planes in flight ahead of the walk
constexpr int kSlots = kAhead + 3;  // the walk reads 3 planes, plus those
constexpr int kMaxSeg = 32;         // lattice cells along i per block

__device__ __forceinline__ void cp_async4(unsigned int* dst,
                                          const unsigned int* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Words of one staged row: kTileK cells plus min(stride, kTileK) on each side.
__host__ __device__ __forceinline__ int row_words(int stride) {
  return kTileK + 2 * (stride < kTileK ? stride : kTileK);
}

// Shared memory of the ring: kSlots planes of kChannels x (tile rows + 2)
// staged rows.
__host__ __device__ __forceinline__ int ring_words(int stride, int rows_b) {
  return kSlots * kChannels * (rows_b + 2) * row_words(stride);
}

// kRows lattice rows along j per warp: a tile of kRows * kWarps rows. At
// least three blocks per SM (at most 85 registers a thread): resident blocks
// are what hides each block's copies behind the others' arithmetic.
template <int kRows>
__global__ void __launch_bounds__(kThreads, 3)
vdt_round_kernel(const unsigned int* __restrict__ in,
                 unsigned int* __restrict__ out, int ni, int nj, int nk,
                 int stride, int scale, float dx, int seg, int segs_a,
                 int tiles_b) {
  constexpr int kTileB = kRows * kWarps;
  constexpr int kRowsB = kTileB + 2;
  extern __shared__ unsigned int ring[];
  const long long n = (long long)ni * nj * nk;
  const int s = stride;
  const int sb = s < kTileK ? s : kTileK;
  const int w = row_words(s);
  const int cw = kRowsB * w;  // words of one channel of a plane
  const int plane_words = kChannels * cw;

  const int ri = blockIdx.z / segs_a, qa0 = (blockIdx.z % segs_a) * seg;
  const int rj = blockIdx.y / tiles_b, qb0 = (blockIdx.y % tiles_b) * kTileB;
  const int k0 = blockIdx.x * kTileK;
  const int na = min(seg, (ni - ri + s - 1) / s - qa0);
  if (na <= 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Stage plane la (lattice row q = qa0 - 1 + la: the halo row, the block's
  // cells, the halo row) into its ring slot, all four channels; positions
  // outside the grid are left unread. This lane copies the positions
  // p = lane, lane + 32, lane + 64 of each row.
  int gk[3];
  bool okk[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int p = lane + 32 * q;
    gk[q] = s <= kTileK ? k0 - s + p : k0 + (q - 1) * s + lane;
    okk[q] = p < w && gk[q] >= 0 && gk[q] < nk;
  }

  auto stage = [&](int la) {
    const int gi = ri + (qa0 - 1 + la) * s;
    if (la > na + 1 || gi < 0 || gi >= ni) return;
    unsigned int* slot = ring + (la % kSlots) * plane_words;
    for (int lb = warp; lb < kRowsB; lb += kWarps) {
      const int gj = rj + (qb0 - 1 + lb) * s;
      if (gj < 0 || gj >= nj) continue;
      const unsigned int* src = in + ((long long)gi * nj + gj) * nk;
      unsigned int* dst = slot + lb * w + lane;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (!okk[q]) continue;
#pragma unroll
        for (int c = 0; c < kChannels; ++c)
          cp_async4(dst + c * cw + 32 * q, src + c * n + gk[q]);
      }
    }
  };

  // Each thread owns kRows columns of cells (a, b = b0 + h, k = k0 + lane),
  // a = 0 .. na - 1, and walks the planes la = 0 .. na + 1 in order. A
  // position of plane la is a donor of the cells a = la - 2, la - 1, la (as
  // i offsets +1, 0, -1) and of the thread's rows b within one lattice row
  // of it, so it is read once for up to 3 * kRows cells; its z term is
  // shared by all of them, its y term by each row's. Each cell merges its
  // donors in _OFFSETS26 order: its planes arrive in ascending la, which is
  // ascending i offset, and within a plane the position rows and k offsets
  // ascend. Cell la - 2 is complete after plane la; its winner lies in
  // planes la - 2 .. la, which the ring still holds.
  const int b0 = kRows * warp;
  const int k = k0 + lane;
  int j[kRows];
  bool live[kRows];
  float py[kRows];
  long long idx0[kRows];  // cell a = 0; cells past the grid's end read 0
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    j[h] = rj + (qb0 + b0 + h) * s;
    live[h] = j[h] < nj && k < nk;
    py[h] = (float)(j[h] * scale) * dx;
    idx0[h] =
        live[h] ? ((long long)(ri + qa0 * s) * nj + j[h]) * nk + k : 0;
  }
  const float pz = (float)(k * scale) * dx;
  // rows b0 - 1 .. b0 + kRows of the plane, and k offsets -1, 0, 1
  bool vrj[kRows + 2];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r) {
    const int gj = rj + (qb0 + b0 - 1 + r) * s;
    vrj[r] = gj >= 0 && gj < nj;
  }
  const bool vc[3] = {k - s >= 0, true, k + s < nk};
  const long long step_i = (long long)s * nj * nk;

  // per row: the walk's three cells (0: la - 2, 1: la - 1, 2: la), their
  // best d2 and winning donor (13 = (0, 0, 0): the cell itself), and the
  // own d2 of the next two cells, loaded ahead
  float bd0[kRows], bd1[kRows], bd2[kRows], bd3[kRows], bd4[kRows];
  int win0[kRows], win1[kRows], win2[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    bd0[h] = bd1[h] = 0.0f;
    win0[h] = win1[h] = win2[h] = 13;
    bd2[h] = __uint_as_float(in[4 * n + idx0[h]]);
    bd3[h] = __uint_as_float(
        in[4 * n + (live[h] ? idx0[h] + min(1, na - 1) * step_i : 0)]);
  }

  for (int la = 0; la < kAhead; ++la) {
    stage(la);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int la = 0; la < na + 2; ++la) {
    // plane la has landed (this thread's copies, then everyone's), and
    // every warp is done with plane la - 3, whose slot the next stage takes
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncthreads();
    stage(la + kAhead);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int a4 = min(la + 2, na - 1);
#pragma unroll
    for (int h = 0; h < kRows; ++h)
      bd4[h] = __uint_as_float(
          in[4 * n + (live[h] ? idx0[h] + a4 * step_i : 0)]);

    const int gi = ri + (qa0 - 1 + la) * s;
    const bool vrow = gi >= 0 && gi < ni;  // block-uniform
    const bool has0 = la >= 2, has1 = la >= 1 && la <= na, has2 = la < na;
    const float px0 = (float)((gi - s) * scale) * dx;  // cells la - 2
    const float px1 = (float)(gi * scale) * dx;        // cells la - 1
    const float px2 = (float)((gi + s) * scale) * dx;  // cells la
    const unsigned int* slot = ring + (la % kSlots) * plane_words;
    // Merge the plane's donors into the cells la - 2, la - 1 and la that
    // exist (use0..2). A donor outside the grid does not exist: rows of the
    // plane outside it are skipped (warp-uniform), k offsets outside it mask
    // the compare (per lane), so the merges compile to selects, not
    // branches.
    const auto merge = [&](bool use0, bool use1, bool use2) {
#pragma unroll
      for (int r = 0; r < kRows + 2; ++r) {  // plane row b0 + r
        if (!vrj[r]) continue;
#pragma unroll
        for (int oc = -1; oc <= 1; ++oc) {
          const bool ok = vc[oc + 1];
          const int o = (b0 + r) * w + lane + (1 + oc) * sb;
          const float cx = __uint_as_float(slot[o]);
          const float cy = __uint_as_float(slot[cw + o]);
          const float ez = pz - __uint_as_float(slot[2 * cw + o]);
          const float ez2 = ez * ez;
          const float ex0 = px0 - cx, ex1 = px1 - cx, ex2 = px2 - cx;
          const float exx0 = ex0 * ex0, exx1 = ex1 * ex1, exx2 = ex2 * ex2;
#pragma unroll
          for (int h = 0; h < kRows; ++h) {
            const int ob = r - 1 - h;  // the position's j offset from row h
            if (ob < -1 || ob > 1) continue;
            const float ey = py[h] - cy;
            const float ey2 = ey * ey;
            const int m = (ob + 1) * 3 + (oc + 1);  // + 9 * (oa + 1)
            // vdt._dist2's order: (ex * ex + ey * ey) + ez * ez
            if (use0) {  // i offset +1
              const float cd2 = exx0 + ey2 + ez2;
              const bool b = ok && cd2 < bd0[h];
              bd0[h] = b ? cd2 : bd0[h];
              win0[h] = b ? 18 + m : win0[h];
            }
            if (use1 && m != 4) {  // i offset 0, not the cell itself
              const float cd2 = exx1 + ey2 + ez2;
              const bool b = ok && cd2 < bd1[h];
              bd1[h] = b ? cd2 : bd1[h];
              win1[h] = b ? 9 + m : win1[h];
            }
            if (use2) {  // i offset -1
              const float cd2 = exx2 + ey2 + ez2;
              const bool b = ok && cd2 < bd2[h];
              bd2[h] = b ? cd2 : bd2[h];
              win2[h] = b ? m : win2[h];
            }
          }
        }
      }
    };
    // interior planes serve all three cells: a copy with the tests folded
    if (vrow && has0 && has2)
      merge(true, true, true);
    else if (vrow)
      merge(has0, has1, has2);

    if (has0) {  // cells la - 2 are complete
#pragma unroll
      for (int h = 0; h < kRows; ++h) {
        if (!live[h]) continue;
        const long long idx = idx0[h] + (la - 2) * step_i;
        const int oa = win0[h] / 9 - 1, ob = (win0[h] / 3) % 3 - 1,
                  oc = win0[h] % 3 - 1;
        const unsigned int* ws =
            ring + ((la - 1 + oa) % kSlots) * plane_words;
        const int o = (b0 + h + 1 + ob) * w + lane + (1 + oc) * sb;
        out[idx] = ws[o];
        out[n + idx] = ws[cw + o];
        out[2 * n + idx] = ws[2 * cw + o];
        out[3 * n + idx] = ws[3 * cw + o];
        out[4 * n + idx] = __float_as_uint(bd0[h]);
      }
    }
    // shift the walk by one cell
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      bd0[h] = bd1[h];
      win0[h] = win1[h];
      bd1[h] = bd2[h];
      win1[h] = win2[h];
      bd2[h] = bd3[h];
      win2[h] = 13;
      bd3[h] = bd4[h];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" int sdf_vdt_round(const void* in, void* out, int ni, int nj, int nk,
                             int stride, int scale, float dx, void* stream) {
  if ((long long)ni * nj * nk <= 0) return (int)cudaGetLastError();
  if (stride < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Blocks: one per (residue class, segment) along i, (residue class, tile)
  // along j and tile along k, residues only where cells exist. Tiles take
  // two lattice rows along j per warp where the classes have 16 rows or
  // more, else one (large strides). Segments are as long as kMaxSeg,
  // halved while that leaves fewer than 1.5 blocks per SM (small grids,
  // where a block's walk is latency-bound; each segment stages two planes
  // of halo, so shorter ones cost traffic).
  const int lat_i = (ni + stride - 1) / stride;  // the most rows a class has
  const int lat_j = (nj + stride - 1) / stride;
  const int rows = lat_j >= 2 * kWarps ? 2 : 1;
  const int tile_b = rows * kWarps;
  const int tiles_b = (lat_j + tile_b - 1) / tile_b;
  const long long gy = (long long)(stride < nj ? stride : nj) * tiles_b;
  const long long gx = (nk + kTileK - 1) / kTileK;
  const long long res_i = stride < ni ? stride : ni;
  int seg = kMaxSeg;
  while (seg > 1 &&
         2 * res_i * ((lat_i + seg - 1) / seg) * gy * gx < 3LL * sms)
    seg /= 2;
  const int segs_a = (lat_i + seg - 1) / seg;
  const long long gz = res_i * segs_a;
  if (gz > 65535 || gy > 65535 || gx > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      (size_t)ring_words(stride, tile_b) * sizeof(unsigned int);
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const auto launch = [&](auto kernel) -> cudaError_t {
    // as much shared memory per SM as the card has: resident blocks hide
    // the copies' latency
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && smem > 48 * 1024)
      // the largest ring any stride needs, so concurrent callers never
      // lower it
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(ring_words(kTileK, tile_b) * sizeof(unsigned int)));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const unsigned int*)in, (unsigned int*)out, ni, nj, nk, stride,
        scale, dx, seg, segs_a, tiles_b);
    return cudaGetLastError();
  };
  return (int)(rows == 2 ? launch(vdt_round_kernel<2>)
                         : launch(vdt_round_kernel<1>));
}
