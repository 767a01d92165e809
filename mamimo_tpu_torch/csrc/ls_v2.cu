// LS channel estimate from the canonical flat planes, dense output, in
// full mode or as one rank's partial of the sequence-sharded estimate.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_planes_pallas_v2 (body _planes_kernel_v2): the DFT-select GEMM and
// Walsh-Hadamard despread of ls_core.cuh, with A the selected-bin DFT
// scaled by 1/(nltf*ltf_c). This file is only the epilogue: the dense
// (2, S, nt, C) f32 planes, no carrier padding.
//
// Sequence-sharded mode (the TPU kernel's rectangular K = I (x)
// P[:, local cols], parallel/sharded.py::sharded_ls_pallas_v2 mode
// "seq"): rank i of n holds loc = nt/n symbols per sample, and its
// partial is h = P[:, i*loc:(i+1)*loc] z. The Sylvester P is
// H_n (x) H_loc, so P[a*loc + b, i*loc + m] = H_n[a, i] H_loc[b, m] with
// H_n[a, i] = (-1)^popcount(a & i): ls_tile runs with loc rows per sample
// (w = H_loc z) and the store writes row a*loc + b as H_n[a, i] * w[b].
// No K matrix exists; full mode is loc = nt, rank 0.
//
// Bound on an H100 at the serving shape (S = 4096, nt = 32): the bf16
// input read (134 MB: the 256 FFT samples of each 320-sample symbol, the
// CP is never read) plus the f32 output write (245 MB) against 3.35 TB/s
// is about 0.113 ms; the GEMM is about 63 GFLOP (0.06 ms at the bf16
// tensor-core peak), so it is memory-bound. A seq rank reads 1/n of the
// input and still writes the whole (2, S, nt, C) partial, so it is
// output-bound (the JAX design: a psum of full partials).
#include "ls_core.cuh"

using namespace mamimo;

namespace {

__global__ void __launch_bounds__(g128::THREADS, 2)
    ls_planes_v2_kernel(const bf16* __restrict__ planes,
                        const bf16* __restrict__ bmat,
                        float* __restrict__ out, int S, int nt, int loc,
                        int rank, int C, int sym_len, int cp, int fft,
                        int cpad) {
  ls_tile(planes, bmat, S, loc, sym_len, cp, fft, cpad,
          [&](int s, int plane, int c, const float* v) {
            if (s >= S || c >= C) return;
            float* o = out + ((long long)plane * S + s) * nt * C + c;
            for (int a = 0; a < nt / loc; ++a) {
              const float sign = (__popc(a & rank) & 1) ? -1.f : 1.f;
              for (int b = 0; b < loc; ++b)
                o[(long long)(a * loc + b) * C] = sign * v[b * LS_EPITCH];
            }
          });
}

}  // namespace

extern "C" {

// planes (2, S, loc*sym_len) bf16, the rank's contiguous symbols;
// bmat (2*fft, 2*cpad) bf16; out (2, S, nt, C) f32. Full mode: loc = nt,
// rank = 0. Returns the CUDA error code of the launch.
int ls_planes_v2_launch(const void* planes, const void* bmat, void* out,
                        int S, int nt, int loc, int rank, int C, int sym_len,
                        int cp, int fft, int cpad, void* stream) {
  const int smem = g128::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ls_planes_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ls_planes_v2_kernel<<<ls_grid(S * loc, cpad), g128::THREADS, smem,
                        (cudaStream_t)stream>>>(
      (const bf16*)planes, (const bf16*)bmat, (float*)out, S, nt, loc, rank,
      C, sym_len, cp, fft, cpad);
  return (int)cudaGetLastError();
}

const char* ls_planes_v2_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
