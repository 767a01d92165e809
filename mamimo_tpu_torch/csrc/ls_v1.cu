// LS channel estimate from the canonical flat planes, padded raw output.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_planes_pallas (v1, body _planes_kernel). The TPU kernel runs four
// real dots against separate Ar, Ai planes (sym_len x Cp, the CP as zero
// rows) and despreads with a block-diagonal K = I (x) P matmul; this
// kernel computes the same function with the GEMM and Walsh-Hadamard
// body of ls_core.cuh, shared with ls_v2.cu. Only the epilogue differs:
// it writes the TPU kernel's raw serving form, two planes
//
//   hr, hi : (rows_out, cpad) in f32 or bf16, row s*nt + j, lane c,
//
// with rows_out = round_up(S, block_samples) * nt and cpad =
// round_up(C, 128). The pad lanes (c >= C) are zero because B's columns
// there are zero; the pad rows (samples S..) are zero because their A
// rows read as zero. The grid covers rows_out, so every pad row is
// written by the kernel and nothing is zeroed beforehand.
//
// Bound on an H100 at the bench shape (S = 4096, nt = 32, cpad = 256):
// it reads the 256 FFT samples of each symbol (134 MB bf16, the CP is
// never read) and writes 2 x 131072 x 256 values: 134 MB in bf16 (about
// 0.080 ms at 3.35 TB/s) or 268 MB in f32 (about 0.120 ms). The GEMM is
// about 69 GFLOP (0.07 ms at the bf16 tensor-core peak), so it is
// memory-bound; the design keeps z in shared memory and writes each
// output value once, from threads on neighbouring lanes.
#include "ls_core.cuh"

using namespace mamimo;

namespace {

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

template <class T>
__global__ void __launch_bounds__(g128::THREADS, 2)
    ls_planes_v1_kernel(const bf16* __restrict__ planes,
                        const bf16* __restrict__ bmat, T* __restrict__ hr,
                        T* __restrict__ hi, int S, int s_out, int nt,
                        int sym_len, int cp, int fft, int cpad) {
  ls_tile(planes, bmat, S, nt, sym_len, cp, fft, cpad,
          [&](int s, int plane, int c, const float* v) {
            if (s >= s_out) return;
            T* o = (plane ? hi : hr) + (long long)s * nt * cpad + c;
            for (int j = 0; j < nt; ++j)
              o[(long long)j * cpad] = from_f32<T>(v[j * LS_EPITCH]);
          });
}

template <class T>
int launch(const void* planes, const void* bmat, void* hr, void* hi, int S,
           int s_out, int nt, int sym_len, int cp, int fft, int cpad,
           cudaStream_t stream) {
  const int smem = g128::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ls_planes_v1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  ls_planes_v1_kernel<T><<<ls_grid(s_out * nt, cpad), g128::THREADS, smem,
                           stream>>>((const bf16*)planes, (const bf16*)bmat,
                                     (T*)hr, (T*)hi, S, s_out, nt, sym_len,
                                     cp, fft, cpad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// planes (2, S, nt*sym_len) bf16; bmat (2*fft, 2*cpad) bf16; hr, hi
// (s_out*nt, cpad) each, bf16 when out_bf16 != 0 else f32; s_out >= S.
// Returns the CUDA error code of the launch.
int ls_planes_v1_launch(const void* planes, const void* bmat, void* hr,
                        void* hi, int S, int s_out, int nt, int sym_len,
                        int cp, int fft, int cpad, int out_bf16,
                        void* stream) {
  if (out_bf16)
    return launch<bf16>(planes, bmat, hr, hi, S, s_out, nt, sym_len, cp, fft,
                        cpad, (cudaStream_t)stream);
  return launch<float>(planes, bmat, hr, hi, S, s_out, nt, sym_len, cp, fft,
                       cpad, (cudaStream_t)stream);
}

const char* ls_planes_v1_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
