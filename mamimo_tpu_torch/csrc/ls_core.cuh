// The body of the v1 LS kernel (ls_v1.cu), its only user: one 128 x 128
// tile of the DFT-select GEMM (the mma.sync main loop of mma_tile.cuh)
// followed by the Walsh-Hadamard despread, with the store left to the
// caller. The two serving LS kernels (ls_v2.cu, ls_pair.cu) run on the
// Hopper body of ls_sm90.cuh instead.
//
//   z[s,n,c] = sum_t x[s, n*sym_len + cp + t] * A[c,t]   (complex)
//   h[s,j,c] = sum_n P[j,n] * z[s,n,c]                    (P Sylvester +-1)
//
// * The complex DFT-select is ONE real bf16 GEMM with f32 accumulation:
//   rows r = s*nt + n, K = [xr | xi] over the fft samples only (the CP
//   is skipped by the address arithmetic, not by zero rows), and
//   B = [[Ar, Ai], [-Ai, Ar]] of shape (2*fft, 2*cpad): output column
//   g < cpad is the real part of carrier g, g >= cpad the imaginary part
//   of carrier g - cpad. Columns of carriers >= C are zero in B.
// * The despread is not a matmul: with a Sylvester P it is a fast
//   Walsh-Hadamard transform along the nt rows of each sample. A 128-row
//   block tile holds whole samples, so the tile is staged in shared
//   memory as f32 and log2(nt) add/subtract butterfly stages run per
//   column; z never reaches device memory.
#pragma once

#include "mma_tile.cuh"

namespace mamimo {

constexpr int LS_EPITCH = g128::BN + 4;  // f32 epilogue tile pitch

// Block (blockIdx.x, blockIdx.y) computes output columns
// [128*blockIdx.x, +128) of rows [128*blockIdx.y, +128); rows at or past
// S*nt read as zero, so the tile's samples past S come out as exact
// zeros. For every sample sl of the tile and every column, after the
// butterflies, calls
//
//   store(s, plane, c, v)
//
// with s the global sample, plane 0 (real) or 1 (imaginary), c the
// padded carrier index (< cpad) and v the sample's nt despread values at
// v[j * LS_EPITCH], j = 0..nt-1. Neighbouring threads get neighbouring c.
template <class Store>
__device__ __forceinline__ void ls_tile(const bf16* __restrict__ planes,
                                        const bf16* __restrict__ bmat,
                                        int S, int nt, int sym_len, int cp,
                                        int fft, int cpad, Store store) {
  using namespace g128;
  static_assert(BM * LS_EPITCH * 4 <= SMEM_BYTES,
                "epilogue tile must fit in the ring buffers");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = S * nt;
  const long long plane_stride = (long long)M * sym_len;

  auto a_src = [&](int row, int k, bool& ok) -> const bf16* {
    const int gr = m0 + row;
    ok = gr < M;
    if (!ok) return planes;
    const int plane = k >= fft;
    const int t = k - plane * fft;
    return planes + plane * plane_stride + (long long)gr * sym_len + cp + t;
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  gemm128_mainloop(acc, smem, a_src, bmat, 2LL * cpad, n0, 2 * fft);

  // stage the z tile (f32) in shared memory, reusing the ring buffers
  float* sE = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + g, col = wn + j * 8 + q;
      sE[row * LS_EPITCH + col] = acc[i][j][0];
      sE[row * LS_EPITCH + col + 1] = acc[i][j][1];
      sE[(row + 8) * LS_EPITCH + col] = acc[i][j][2];
      sE[(row + 8) * LS_EPITCH + col + 1] = acc[i][j][3];
    }
  __syncthreads();

  // Walsh-Hadamard despread along each sample's nt rows; one thread per
  // (sample, column), neighbouring threads on neighbouring columns.
  const int col = tid % BN;
  const int gcol = n0 + col;
  const int plane = gcol >= cpad;
  const int c = gcol - plane * cpad;
  const int spt = BM / nt;
  for (int sl = tid / BN; sl < spt; sl += THREADS / BN) {
    float* v = sE + sl * nt * LS_EPITCH + col;
    for (int h = 1; h < nt; h <<= 1) {
      for (int i = 0; i < nt / 2; ++i) {
        const int lo = (i / h) * 2 * h + (i % h), hi = lo + h;
        const float a = v[lo * LS_EPITCH], b = v[hi * LS_EPITCH];
        v[lo * LS_EPITCH] = a + b;
        v[hi * LS_EPITCH] = a - b;
      }
    }
    store(m0 / nt + sl, plane, c, static_cast<const float*>(v));
  }
}

// Grid of an LS kernel whose tiles cover `rows` rows (dynamic shared
// memory: g128::SMEM_BYTES).
inline dim3 ls_grid(int rows, int cpad) {
  return dim3((2 * cpad) / g128::BN, (rows + g128::BM - 1) / g128::BM);
}

}  // namespace mamimo
