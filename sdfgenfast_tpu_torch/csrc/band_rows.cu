// K2: narrow-band tile evaluation over CSR candidate segments.
//
// Replaces sdfgenfast_tpu/ops/band_pallas.py::_band_kernel (wrapper
// band_rows_pallas). One block per active 8x8x8 tile, one thread per cell.
// The tile's candidate segment pair[off[a] .. off[a] + cnt[a]) is walked in
// ascending order; per candidate the affine coefficients (edge projections,
// barycentric gradients, unit normal) are built once, cooperatively, into
// shared memory, and every cell then evaluates the same point-triangle
// distance as the Pallas kernel (plane distance for barycentric-inside cells,
// clamped-edge difference form otherwise). A strict '<' keeps the earliest
// (lowest-id) candidate among exact d2 ties, matching the Pallas chunk
// reduction. Per cell the kernel writes phi (or `upper` when no candidate is
// below upper^2), the winner's triangle id (-1 for none) and the closest
// point p - dd (FAR for none) into row ids[a] of five (T+1, 512) row arrays.
//
// TPU artefacts dropped: the 0x40000000 id bias (a TPU denormal-flush
// workaround; ids are plain int32 here), the (P, 128) lane-padded pair
// table and its kcap DMA window (the kernel reads the (M, 9) grid-local
// vertex table by candidate id) and the sentinel row (ids >= M are skipped).
//
// Bound on the H100: arithmetic. Each (cell, candidate) pair costs ~90 FP32
// operations against 4-byte shared-memory reads of the staged coefficients;
// device-memory traffic is the 9 floats per candidate plus 20 bytes per cell
// written. Staging the coefficients once per candidate (instead of per cell)
// removes ~60% of the per-pair work; the rest is the distance itself.
// Built with --fmad=false so products and sums round like the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kCells = 512;   // 8x8x8 cells per tile, one thread each
constexpr int kChunk = 64;    // candidates whose coefficients are staged at once
constexpr float kFar = 3e18f; // closest-point fill for cells without a winner

// staged per-candidate coefficients (structure of arrays in shared memory)
enum Coef {
  BX, BY, BZ, CX, CY, CZ,
  WABX, WABY, WABZ, EABX, EABY, EABZ, EAB0,
  WACX, WACY, WACZ, EACX, EACY, EACZ, EAC0,
  WBCX, WBCY, WBCZ, EBCX, EBCY, EBCZ, EBC0,
  G23X, G23Y, G23Z, G23C, G31X, G31Y, G31Z, G31C,
  NX, NY, NZ, H0, DEGEN,
  kNumCoef
};

__device__ __forceinline__ void edge_coef(
    float x1x, float x1y, float x1z, float x2x, float x2y, float x2z,
    float (*s)[kChunk], int w0, int q) {
  // s_raw = dot(x2 - p, x2 - x1) / |x2 - x1|^2 written as e.p + e0
  float wx = x1x - x2x, wy = x1y - x2y, wz = x1z - x2z;
  float m2 = wx * wx + wy * wy + wz * wz;
  float inv = 1.0f / fmaxf(m2, 1e-30f);
  s[w0 + 0][q] = wx;
  s[w0 + 1][q] = wy;
  s[w0 + 2][q] = wz;
  s[w0 + 3][q] = wx * inv;
  s[w0 + 4][q] = wy * inv;
  s[w0 + 5][q] = wz * inv;
  s[w0 + 6][q] = -(x2x * wx + x2y * wy + x2z * wz) * inv;
}

__device__ __forceinline__ void stage_candidate(const float* __restrict__ v,
                                                float (*s)[kChunk], int q) {
  float ax = v[0], ay = v[1], az = v[2];
  float bx = v[3], by = v[4], bz = v[5];
  float cx = v[6], cy = v[7], cz = v[8];
  s[BX][q] = bx; s[BY][q] = by; s[BZ][q] = bz;
  s[CX][q] = cx; s[CY][q] = cy; s[CZ][q] = cz;
  edge_coef(ax, ay, az, bx, by, bz, s, WABX, q);
  edge_coef(ax, ay, az, cx, cy, cz, s, WACX, q);
  edge_coef(bx, by, bz, cx, cy, cz, s, WBCX, q);

  float x13x = ax - cx, x13y = ay - cy, x13z = az - cz;
  float x23x = bx - cx, x23y = by - cy, x23z = bz - cz;
  float m13 = x13x * x13x + x13y * x13y + x13z * x13z;
  float m23 = x23x * x23x + x23y * x23y + x23z * x23z;
  float d = x13x * x23x + x13y * x23y + x13z * x23z;
  float invdet = 1.0f / fmaxf(m13 * m23 - d * d, 1e-30f);
  float g23x = invdet * (m23 * x13x - d * x23x);
  float g23y = invdet * (m23 * x13y - d * x23y);
  float g23z = invdet * (m23 * x13z - d * x23z);
  float g31x = invdet * (m13 * x23x - d * x13x);
  float g31y = invdet * (m13 * x23y - d * x13y);
  float g31z = invdet * (m13 * x23z - d * x13z);
  s[G23X][q] = g23x; s[G23Y][q] = g23y; s[G23Z][q] = g23z;
  s[G23C][q] = -(g23x * cx + g23y * cy + g23z * cz);
  s[G31X][q] = g31x; s[G31Y][q] = g31y; s[G31Z][q] = g31z;
  s[G31C][q] = -(g31x * cx + g31y * cy + g31z * cz);

  float crx = x13y * x23z - x13z * x23y;
  float cry = x13z * x23x - x13x * x23z;
  float crz = x13x * x23y - x13y * x23x;
  float cr2 = crx * crx + cry * cry + crz * crz;
  float rn = rsqrtf(fmaxf(cr2, 1e-37f));
  float nx = crx * rn, ny = cry * rn, nz = crz * rn;
  s[NX][q] = nx; s[NY][q] = ny; s[NZ][q] = nz;
  s[H0][q] = -(nx * cx + ny * cy + nz * cz);
  s[DEGEN][q] = cr2 <= 1e-30f ? 1.0f : 0.0f;
}

struct EdgeResult {
  float d2, ddx, ddy, ddz;
};

__device__ __forceinline__ EdgeResult edge_d2(float (*s)[kChunk], int w0,
                                              int q, float x, float y, float z,
                                              float ux, float uy, float uz) {
  float wx = s[w0 + 0][q], wy = s[w0 + 1][q], wz = s[w0 + 2][q];
  float t = s[w0 + 3][q] * x + s[w0 + 4][q] * y + s[w0 + 5][q] * z +
            s[w0 + 6][q];
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  EdgeResult r;
  r.ddx = ux - t * wx;
  r.ddy = uy - t * wy;
  r.ddz = uz - t * wz;
  r.d2 = r.ddx * r.ddx + r.ddy * r.ddy + r.ddz * r.ddz;
  return r;
}

__global__ void __launch_bounds__(kCells)
band_rows_kernel(const float* __restrict__ tri9, int num_tris,
                 const int* __restrict__ pair, const int* __restrict__ ids,
                 const int* __restrict__ off, const int* __restrict__ cnt,
                 int ntj, int ntk, int dims_sum, float dx,
                 float* __restrict__ phi, int* __restrict__ tid,
                 float* __restrict__ cpx, float* __restrict__ cpy,
                 float* __restrict__ cpz) {
  __shared__ float s[kNumCoef][kChunk];
  __shared__ int s_id[kChunk];

  const int a = blockIdx.x;
  const int c = threadIdx.x;
  const int t = ids[a];
  const int tk = t % ntk;
  const int tj = (t / ntk) % ntj;
  const int ti = t / (ntk * ntj);
  const float x = (float)(ti * 8 + c / 64) * dx;
  const float y = (float)(tj * 8 + (c / 8) % 8) * dx;
  const float z = (float)(tk * 8 + c % 8) * dx;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_id = -1;
  float bdx = 0.0f, bdy = 0.0f, bdz = 0.0f;

  const int start = off[a];
  const int n = cnt[a];
  for (int base = 0; base < n; base += kChunk) {
    const int q_n = min(kChunk, n - base);
    __syncthreads();  // previous chunk fully consumed
    if (c < q_n) {
      const int id = pair[start + base + c];
      s_id[c] = id;
      if (id >= 0 && id < num_tris) stage_candidate(tri9 + 9LL * id, s, c);
    }
    __syncthreads();
    for (int q = 0; q < q_n; ++q) {
      const int id = s_id[q];
      if (id < 0 || id >= num_tris) continue;  // sentinel padding never wins
      const float nx = s[NX][q], ny = s[NY][q], nz = s[NZ][q];
      const float h = nx * x + ny * y + nz * z + s[H0][q];
      const float w23 = s[G23X][q] * x + s[G23Y][q] * y + s[G23Z][q] * z +
                        s[G23C][q];
      const float w31 = s[G31X][q] * x + s[G31Y][q] * y + s[G31Z][q] * z +
                        s[G31C][q];
      const float w12 = 1.0f - w23 - w31;
      const bool inside =
          (fminf(fminf(w23, w31), w12) >= 0.0f) && (s[DEGEN][q] == 0.0f);

      const float ubx = x - s[BX][q], uby = y - s[BY][q], ubz = z - s[BZ][q];
      const float ucx = x - s[CX][q], ucy = y - s[CY][q], ucz = z - s[CZ][q];
      const EdgeResult ab = edge_d2(s, WABX, q, x, y, z, ubx, uby, ubz);
      const EdgeResult ac = edge_d2(s, WACX, q, x, y, z, ucx, ucy, ucz);
      const EdgeResult bc = edge_d2(s, WBCX, q, x, y, z, ucx, ucy, ucz);

      float d2;
      float ddx, ddy, ddz;
      if (inside) {
        d2 = h * h;
        ddx = h * nx;
        ddy = h * ny;
        ddz = h * nz;
      } else {
        d2 = fminf(ab.d2, fminf(ac.d2, bc.d2));
        const bool ab_best = (ab.d2 <= ac.d2) && (ab.d2 <= bc.d2);
        const bool ac_best = !ab_best && (ac.d2 <= bc.d2);
        const EdgeResult& e = ab_best ? ab : (ac_best ? ac : bc);
        ddx = e.ddx;
        ddy = e.ddy;
        ddz = e.ddz;
      }
      if (d2 < best) {
        best = d2;
        best_id = id;
        bdx = ddx;
        bdy = ddy;
        bdz = ddz;
      }
    }
  }

  const float upper = (float)dims_sum * dx;  // makelevelset3.cpp:197
  const bool has = best < upper * upper;
  const long long o = (long long)t * kCells + c;
  phi[o] = has ? sqrtf(best) : upper;
  tid[o] = has ? best_id : -1;
  cpx[o] = has ? x - bdx : kFar;
  cpy[o] = has ? y - bdy : kFar;
  cpz[o] = has ? z - bdz : kFar;
}

}  // namespace

extern "C" int sdf_band_rows(const float* tri9, int num_tris, const int* pair,
                             const int* ids, const int* off, const int* cnt,
                             int num_active, int ntj, int ntk, int dims_sum,
                             float dx, float* phi, int* tid, float* cpx,
                             float* cpy, float* cpz, void* stream) {
  if (num_active > 0) {
    band_rows_kernel<<<num_active, kCells, 0, (cudaStream_t)stream>>>(
        tri9, num_tris, pair, ids, off, cnt, ntj, ntk, dims_sum, dx, phi, tid,
        cpx, cpy, cpz);
  }
  return (int)cudaGetLastError();
}
