// Per-pair LS channel estimate, written straight into the time-major
// complex layout (B, C, nt, nr).
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_estimate_pallas (body _kernel). Per (packet b, rx r) pair the TPU
// kernel despreads Y = P x over the nt symbols (CP dropped) and then
// DFT-selects est = A Y^T with four real dots. Despread and DFT-select
// act on different axes, so their order does not change the result: this
// kernel runs the GEMM and Walsh-Hadamard body of ls_core.cuh (shared
// with ls_v2.cu and ls_v1.cu) on the pairs' rows as bf16 planes
// (2, B*nr, len_ltf), sample s = b*nr + r, which the wrapper makes from
// the complex input in one pass. Only the store is this file's.
//
// Store: out is complex64 viewed as float pairs; the value of sample s,
// symbol j, carrier c goes to element ((b*C + c)*nt + j)*nr + r, real
// part for plane 0 and imaginary part for plane 1. A column block lies
// in one plane (cpad is a multiple of 128). After the butterflies the
// block's despread tile stays in shared memory, and the block writes it
// cooperatively with the sample index fastest, then j, then c: at BS32
// (nt = 32, nr = 4) a 128-row tile is exactly one packet, so a warp
// writes every other float of 256 contiguous bytes instead of 32
// scattered floats. Any nr is correct; smaller configs coalesce less.
//
// Bound on an H100 at the bench shape (1024 packets, S = 4096 pairs,
// nt = 32): the bf16 planes' FFT samples are read once (134 MB, the CP is
// never read) and 245 MB of complex64 written: about 0.113 ms at
// 3.35 TB/s. The GEMM is about 63 GFLOP (0.064 ms at the bf16
// tensor-core peak), so it is memory-bound, like ls_v2.
#include "ls_core.cuh"

using namespace mamimo;

namespace {

__global__ void __launch_bounds__(g128::THREADS, 2)
    ls_pair_kernel(const bf16* __restrict__ planes,
                   const bf16* __restrict__ bmat, float* __restrict__ out,
                   int S, int nr, int nt, int log_nt, int C, int sym_len,
                   int cp, int fft, int cpad) {
  ls_tile(planes, bmat, S, nt, sym_len, cp, fft, cpad,
          [](int, int, int, const float*) {});
  __syncthreads();

  extern __shared__ __align__(16) unsigned char smem[];
  const float* sE = reinterpret_cast<const float*>(smem);
  const int n0 = blockIdx.x * g128::BN;
  const int plane = n0 >= cpad;
  const int c0 = n0 - plane * cpad;
  const int log_spt = 7 - log_nt;  // samples per 128-row tile
  const int spt = 1 << log_spt;
  const int s0 = blockIdx.y * spt;
  const int total = g128::BN << 7;  // 128 columns x 128 rows
  for (int k = threadIdx.x; k < total; k += g128::THREADS) {
    const int sl = k & (spt - 1);
    const int j = (k >> log_spt) & (nt - 1);
    const int cl = k >> 7;
    const int s = s0 + sl, c = c0 + cl;
    if (s >= S || c >= C) continue;
    const int b = s / nr, r = s - b * nr;
    out[2 * ((((long long)b * C + c) * nt + j) * nr + r) + plane] =
        sE[(sl * nt + j) * LS_EPITCH + cl];
  }
}

}  // namespace

extern "C" {

// planes (2, S, nt*sym_len) bf16 with S = B*nr; bmat (2*fft, 2*cpad)
// bf16; out (B, C, nt, nr) complex64 as floats. nt a power of 2 <= 128.
// Returns the CUDA error code of the launch.
int ls_pair_launch(const void* planes, const void* bmat, void* out, int S,
                   int nr, int nt, int C, int sym_len, int cp, int fft,
                   int cpad, void* stream) {
  const int smem = g128::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ls_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int log_nt = 0;
  while ((1 << log_nt) < nt) ++log_nt;
  ls_pair_kernel<<<ls_grid(S * nt, cpad), g128::THREADS, smem,
                   (cudaStream_t)stream>>>(
      (const bf16*)planes, (const bf16*)bmat, (float*)out, S, nr, nt, log_nt,
      C, sym_len, cp, fft, cpad);
  return (int)cudaGetLastError();
}

const char* ls_pair_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
