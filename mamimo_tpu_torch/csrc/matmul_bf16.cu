// The bf16 mode of the GEMM on Hopper: C = A @ B with A (M, K) and B (K,
// N) bf16, f32 accumulation, C (M, N) stored as f32 or rounded to bf16
// (the wrapper's out_dtype).
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas
// (body _mm_kernel) in its bf16 mode; its float32 mode is matmul.cu, its
// int8 mode int8_mm.cu.
//
// mm_bf16_kernel: mm_sm90.cuh's gemm_coop (128 x 256 tiles, B multicast
// to 2-block clusters), its DIRECT epilogue for an f32 C and its STAGED
// one (TMA stores) for a bf16 C, the wrapper's choice
// (int8_mm.py::staged_epilogue, mode bit 3). B is read as JAX passes it,
// (K, N) row-major (MN-major, wgmma's transpose bit), with mode bit 2;
// without it as Bt (N, K) (K-major, matmul_float's operand). Bound on an
// H100 at (4096, 10240) @ (10240, 1024): 85.9 GFLOP, 0.087 ms at 989
// TFLOP/s, against 113 MB of operands and output (0.034 ms):
// operation-bound; at (131072, 1024) @ (1024, 1024): 0.28 ms of products
// against 805 MB (0.24 ms) in f32 out.
//
// Ragged M, N and K come from TMA's zero fill (K % 8 == 0 for the 16-byte
// row pitch; an MN-major B also N % 8 == 0); the stores are masked.
#include <stdint.h>

#include <type_traits>

#include "mm_sm90.cuh"

using namespace mamimo::sm90;
namespace mm = mamimo::mm;

namespace {

// C[row, col .. col + 3] (col % 4 == 0), masked to M x N.
template <class T>
__device__ __forceinline__ void store_quad(T* __restrict__ C, int M, int N,
                                           int row, int col, float4 v) {
  if (row >= M || col >= N) return;
  T* p = C + (long long)row * N + col;
  if ((N & 3) == 0)                       // vector stores stay aligned
    mm::put4(p, v);
  else
    mm::putn(p, v, N - col < 4 ? N - col : 4, (N & 1) == 0);
}

// A through map ma, B through mb: BMN, B (K, N) (mm::make_b_map); else
// Bt (N, K) (mm::make_bt_map); EPI mm::STAGED (T bf16) stores through the
// map mc (mm::make_c_map), mm::DIRECT row pieces from registers.
template <class T, bool BMN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    mm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   const __grid_constant__ CUtensorMap mc, T* __restrict__ C,
                   int M, int N, int K) {
  if constexpr (EPI == mm::STAGED) {
    static_assert(std::is_same_v<T, __nv_bfloat16>, "STAGED stores bf16");
    mm::gemm_coop<BMN, EPI>(
        &ma, &mb, &mc, M, N, 1, K,
        [](int, int, int, float v0, float v1) { return make_float2(v0, v1); });
  } else {
    mm::gemm_coop<BMN>(&ma, &mb, &mc, M, N, 1, K,
                       [&](int, int row, int col, float4 v) {
                         store_quad(C, M, N, row, col, v);
                       });
  }
}

}  // namespace

extern "C" {

// a (M, K) and bt (N, K) bf16, row-major and 16-byte aligned (K % 8 ==
// 0); with mode bit 2 bt is B itself, (K, N) row-major (N % 8 == 0); c
// (M, N), bf16 with mode bit 0, else f32; mode bit 3 (with bit 0: c
// 16-byte aligned, N % 8 == 0) the STAGED epilogue, else DIRECT. M, N, K
// >= 1. Returns the CUDA error code of the launch (or ERR_TENSOR_MAP).
int mm_bf16_launch(const void* a, const void* bt, void* c, int M, int N,
                   int K, int mode, void* stream) {
  const bool bf16_out = mode & 1, bmn = mode & 4, staged = mode & 8;
  if (M < 1 || N < 1 || K < 1 || mode < 0 || mode > 13 || (mode & 2) ||
      (bmn && (N & 7)) || (staged && (!bf16_out || (N & 7))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap ma, mb, mc = {};
  if (mm::make_a_map(&ma, a, K, M, 1) ||
      (bmn ? mm::make_b_map(&mb, bt, K, N, 1)
           : mm::make_bt_map(&mb, bt, K, N, 1)) ||
      (staged && mm::make_c_map(&mc, c, M, N, 1)))
    return ERR_TENSOR_MAP;
  auto go = [&](auto kernel, auto* out, auto epi) {
    return mm::launch<decltype(epi)::value>(kernel, M, N, 1, st, ma, mb, mc,
                                            out, M, N, K);
  };
  using D = std::integral_constant<int, mm::DIRECT>;
  using S = std::integral_constant<int, mm::STAGED>;
  __nv_bfloat16* cb = (__nv_bfloat16*)c;
  float* cf = (float*)c;
  if (staged)
    return bmn ? go(mm_bf16_kernel<__nv_bfloat16, true, mm::STAGED>, cb, S())
               : go(mm_bf16_kernel<__nv_bfloat16, false, mm::STAGED>, cb, S());
  if (bf16_out)
    return bmn ? go(mm_bf16_kernel<__nv_bfloat16, true, mm::DIRECT>, cb, D())
               : go(mm_bf16_kernel<__nv_bfloat16, false, mm::DIRECT>, cb, D());
  return bmn ? go(mm_bf16_kernel<float, true, mm::DIRECT>, cf, D())
             : go(mm_bf16_kernel<float, false, mm::DIRECT>, cf, D());
}

const char* mm_bf16_error_string(int e) { return error_string(e); }

}  // extern "C"
