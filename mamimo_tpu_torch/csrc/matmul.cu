// The float32 mode of the GEMM on Hopper: C = A @ B with A (M, K) and B
// (K, N) f32, f32 accumulation, C (M, N) stored as f32 or rounded to
// bf16 (the wrapper's out_dtype).
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas
// (body _mm_kernel) in its f32 mode; its bf16 mode is matmul_bf16.cu,
// its int8 mode int8_mm.cu. B is taken transposed, Bt (N, K), so that
// both operands are K-major (the only layout wgmma reads a TF32 B
// operand in).
//
// * f32 (mm_tf32x3_kernel): float32 accuracy from three TF32 products
//   (gemm_sm90.cuh, wgmma_3xtf32_rs: -90 dB or better against the
//   float32 product, where one TF32 pass is about -60 dB), on
//   gemm_sm90.cuh's float32 body gemm_tf32x3 (persistent 128 x 128 tiles,
//   Bt's TF32 parts multicast to 2-block clusters, A split in
//   registers, stretches of K summed in fresh accumulators and added in
//   registers), the stores from registers. Bt's parts come from
//   tf32_split.cu, launched per call by the wrapper (matmul_float). The
//   TF32 peak is 495 TFLOP/s; counted once, (4096, 10240) @ (10240,
//   1024) and (131072, 1024) @ (1024, 1024) are 0.17 ms and 0.56 ms of
//   products, and the three products triple that.
//
// Ragged M, N and K come from TMA's zero fill (K needs only the 16-byte
// row pitch, K % 4 == 0); the stores are masked.
#include <stdint.h>

#include "gemm_sm90.cuh"

using namespace mamimo::sm90;

namespace {

// C[row, col], C[row, col + 1] (col even), masked to M x N.
template <class T>
__device__ __forceinline__ void store_pair(T* __restrict__ C, int M, int N,
                                           int row, int col, float v0,
                                           float v1) {
  if (row >= M || col >= N) return;
  T* p = C + (long long)row * N + col;
  if (col + 1 < N && (N & 1) == 0) {      // vector stores stay aligned
    put2(p, v0, v1);
  } else {
    put1(p, v0);
    if (col + 1 < N) put1(p + 1, v1);
  }
}

// A through map ma, Bt's TF32 parts (2, N, K) through map mb (plane =
// part).
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    mm_tf32x3_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     T* __restrict__ C, int M, int N, int K) {
  gemm_tf32x3(&ma, &mb, M, N, 1, K,
              [&](int, int row, int col, float v0, float v1) {
                store_pair(C, M, N, row, col, v0, v1);
              });
}

}  // namespace

extern "C" {

// a (M, K) f32 (K % 4 == 0) and bt Bt's TF32 parts (2, N, K) f32
// (tf32_split), row-major and 16-byte aligned; mode bit 1 set (float32
// operands; the bf16 mode is matmul_bf16.cu's); c (M, N), bf16 with mode
// bit 0, else f32. M, N, K >= 1. Returns the CUDA error code of the
// launch (or ERR_TENSOR_MAP).
int mm_float_launch(const void* a, const void* bt, void* c, int M, int N,
                    int K, int mode, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (mode != 2 && mode != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap ma, mb;
  if (make_map_f32(&ma, a, K, M, 1, 128, K) ||
      make_map_f32(&mb, bt, K, N, 2, TF_SLICE_ROWS, K))
    return ERR_TENSOR_MAP;
  if (mode & 1)
    return launch_tf32x3(mm_tf32x3_kernel<__nv_bfloat16>, M, N, 1, st, ma,
                         mb, (__nv_bfloat16*)c, M, N, K);
  return launch_tf32x3(mm_tf32x3_kernel<float>, M, N, 1, st, ma, mb,
                       (float*)c, M, N, K);
}

const char* mm_float_error_string(int e) { return error_string(e); }

}  // extern "C"
