// LS channel estimate from the canonical flat planes, one kernel.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_planes_pallas_v2 (body _planes_kernel_v2). Same function:
//
//   z[s,n,c] = sum_t x[s, n*sym_len + cp + t] * A[c,t]   (complex)
//   h[s,j,c] = sum_n P[j,n] * z[s,n,c]                    (P Sylvester +-1)
//
// with A the selected-bin DFT scaled by 1/(nltf*ltf_c).
//
// Design for the card:
// * The complex DFT-select is ONE real bf16 GEMM with f32 accumulation:
//   rows r = s*nt + n, K = [xr | xi] over the fft samples only (the CP
//   is skipped by the address arithmetic, not by zero rows), and
//   B = [[Ar, Ai], [-Ai, Ar]] of shape (2*fft, 2*cpad).
// * The despread is not a matmul: with a Sylvester P it is a fast
//   Walsh-Hadamard transform along the nt rows of each sample. A 128-row
//   block tile holds whole samples, so the epilogue stages the f32 tile
//   in shared memory and runs log2(nt) add/subtract butterfly stages per
//   column; z never reaches device memory.
// * Output is the dense (2, S, nt, C) f32 planes, no carrier padding.
//
// Bound on an H100 at the serving shape (S = 4096, nt = 32): the bf16
// input read (134 MB: the 256 FFT samples of each 320-sample symbol, the
// CP is never read) plus the f32 output write (245 MB) against 3.35 TB/s
// is about 0.113 ms; the GEMM is about 63 GFLOP (0.06 ms at the bf16
// tensor-core peak), so it is memory-bound.
#include "mma_tile.cuh"

using namespace mamimo;

namespace {

constexpr int EPITCH = g128::BN + 4;  // f32 epilogue tile pitch

__global__ void __launch_bounds__(g128::THREADS, 2)
    ls_planes_v2_kernel(const bf16* __restrict__ planes,
                        const bf16* __restrict__ bmat,
                        float* __restrict__ out, int S, int nt, int C,
                        int sym_len, int cp, int fft, int cpad) {
  using namespace g128;
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
      sE[row * EPITCH + col] = acc[i][j][0];
      sE[row * EPITCH + col + 1] = acc[i][j][1];
      sE[(row + 8) * EPITCH + col] = acc[i][j][2];
      sE[(row + 8) * EPITCH + col + 1] = acc[i][j][3];
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
    float* v = sE + sl * nt * EPITCH + col;
    for (int h = 1; h < nt; h <<= 1) {
      for (int i = 0; i < nt / 2; ++i) {
        const int lo = (i / h) * 2 * h + (i % h), hi = lo + h;
        const float a = v[lo * EPITCH], b = v[hi * EPITCH];
        v[lo * EPITCH] = a + b;
        v[hi * EPITCH] = a - b;
      }
    }
    const int s = m0 / nt + sl;
    if (s < S && c < C) {
      float* o = out + ((long long)plane * S + s) * nt * C + c;
      for (int j = 0; j < nt; ++j) o[(long long)j * C] = v[j * EPITCH];
    }
  }
}

}  // namespace

extern "C" {

// planes (2, S, nt*sym_len) bf16; bmat (2*fft, 2*cpad) bf16;
// out (2, S, nt, C) f32. Returns the CUDA error code of the launch.
int ls_planes_v2_launch(const void* planes, const void* bmat, void* out,
                        int S, int nt, int C, int sym_len, int cp, int fft,
                        int cpad, void* stream) {
  const int smem = g128::SMEM_BYTES;
  static_assert(g128::BM * EPITCH * 4 <= g128::SMEM_BYTES,
                "epilogue tile must fit in the ring buffers");
  cudaError_t e = cudaFuncSetAttribute(
      ls_planes_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((2 * cpad) / g128::BN, (S * nt + g128::BM - 1) / g128::BM);
  ls_planes_v2_kernel<<<grid, g128::THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)planes, (const bf16*)bmat, (float*)out, S, nt, C, sym_len,
      cp, fft, cpad);
  return (int)cudaGetLastError();
}

const char* ls_planes_v2_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
