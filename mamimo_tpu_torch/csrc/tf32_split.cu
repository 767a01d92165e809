// The TF32 split of a float32 tensor: x (outer, inner) -> out (outer, 2,
// inner), out[o][0] the high part hi = x rounded to TF32 and out[o][1]
// the low part lo = (x - hi) rounded to TF32 (gemm_sm90.cuh, split_tf32:
// cvt.rna.tf32.f32, to nearest with ties away from zero, the low 13 bits
// zero). hi + lo holds 22 of x's 24 bits; the float32 (3xTF32) bodies
// take a.b as hi.hi + hi.lo + lo.hi.
//
// Replaces no TPU kernel: the TPU's matrix unit takes float32 operands as
// they are (the Pallas kernels' dot_dtype=float32), and on an H100 the
// float32 products run as three TF32 products. This kernel splits the
// constant operands once, where the weight-preparing functions make the
// K-major weights (prepare_factored_weights, prepare_mlp_infer_weights
// with dot_dtype float32), and per call for matmul_float's Bt, so that
// the GEMM and tail bodies load both parts by TMA and split nothing of
// them in shared memory (gemm_sm90.cuh gemm_tf32x3, tail_sm90.cuh
// layers23_f32).
//
// Bound on an H100: memory, 4 bytes read and 8 written an element (the
// mlp_infer layer-1 weight, 1024 x 10272: 126 MB, 0.038 ms at 3.35
// TB/s). A grid-stride loop of one element a thread, coalesced on both
// sides.
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

__global__ void tf32_split_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, long long outer,
                                  long long inner) {
  const long long n = outer * inner;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long o = i / inner, j = i - o * inner;
    float hi, lo;
    mamimo::sm90::split_tf32(x[i], hi, lo);
    out[2 * o * inner + j] = hi;
    out[(2 * o + 1) * inner + j] = lo;
  }
}

}  // namespace

extern "C" {

// x (outer, inner) f32 -> out (outer, 2, inner) f32, outer, inner >= 1.
// Returns the CUDA error code of the launch.
int tf32_split_launch(const void* x, void* out, long long outer,
                      long long inner, void* stream) {
  if (outer < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  const long long n = outer * inner;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  tf32_split_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, outer, inner);
  return (int)cudaGetLastError();
}

const char* tf32_split_error_string(int e) {
  return mamimo::sm90::error_string(e);
}

}  // extern "C"
