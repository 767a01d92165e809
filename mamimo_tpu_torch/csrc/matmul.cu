// The bf16 and float32 modes of the GEMM on Hopper: C = A @ B with A (M,
// K) and B (K, N) bf16 or f32, f32 accumulation, C (M, N) stored as f32
// or rounded to bf16 (the wrapper's out_dtype).
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas
// (body _mm_kernel) in its bf16 and f32 modes; its int8 mode is
// int8_mm.cu. As there, B is taken transposed, Bt (N, K), so that both
// operands are K-major (the only layout wgmma reads TF32 operands in).
//
// * bf16 (mm_bf16_kernel): gemm_sm90.cuh's persistent walk as it is (128
//   x 256 tiles, k-step 64, a 4-stage TMA ring, B multicast to 2-block
//   clusters, wgmma m64n256k16), each accumulator pair stored from
//   registers. Bound on an H100 at (4096, 10240) @ (10240, 1024): 85.9
//   GFLOP, 0.087 ms at 989 TFLOP/s, against 113 MB of operands and
//   output (0.034 ms): operation-bound; at (131072, 1024) @ (1024, 1024):
//   0.28 ms of products against 805 MB (0.24 ms) in f32 out.
// * f32 (mm_tf32x3_kernel): float32 accuracy from three TF32 products
//   (gemm_sm90.cuh, wgmma_3xtf32: -90 dB or better against the float32
//   product, where one TF32 pass is about -60 dB). A simple body, one
//   128 x 128 tile a block, no cluster: one producer thread loads A's
//   and Bt's k-step of 32 f32 (2 x 16 KB) by TMA into a 3-stage ring;
//   each stage also holds the two operands' low parts (2 x 16 KB). The
//   two consumer warpgroups (rows 0-63 and 64-127 of the tile) split
//   their half of A's and of Bt's k-step in place into TF32 high parts
//   and write the low parts beside them (fence.proxy.async, then a named
//   barrier over both warpgroups), then run the three m64n128k8 products
//   of each k-step into a fresh accumulator, added to the running sum in
//   float32 in registers (the tensor cores' additions truncate:
//   gemm_sm90.cuh, wgmma_3xtf32). The TF32 peak is 495 TFLOP/s; counted
//   once, the shapes above are 0.17 ms and 0.56 ms of products, and the
//   three products triple that. Speed is later work.
//
// Ragged M, N and K come from TMA's zero fill (K needs only the 16-byte
// row pitch: K % 8 == 0 in bf16, K % 4 == 0 in f32); the stores are
// masked.
#include <stdint.h>

#include "gemm_sm90.cuh"

using namespace mamimo::sm90;

namespace {

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  // round to nearest even, as torch's float32 -> bfloat16 cast
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void put1(float* p, float a) { *p = a; }

__device__ __forceinline__ void put1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

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

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    mm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb, T* __restrict__ C,
                   int M, int N, int K) {
  gemm_persistent(&ma, &mb, M, N, 1, K,
                  [&](int, int row, int col, float v0, float v1) {
                    store_pair(C, M, N, row, col, v0, v1);
                  });
}

constexpr int TF_STAGES = 3;
constexpr int TF_K = 32;                   // f32 k of a stage: 128 bytes
constexpr int TF_TILE = 128 * TF_K * 4;    // 128 rows of a k-step: 16 KB
constexpr int TF_HALF4 = TF_TILE / 32;     // float4 in 64 rows of it
// a stage: A, Bt, then their low parts
constexpr int TF_STAGE = 4 * TF_TILE;
constexpr int TF_SMEM = TF_STAGES * TF_STAGE + 8 * 2 * TF_STAGES + 1024;
static_assert(TF_SMEM <= 232448, "more shared memory than a block has");

// Block (x, y): the tile of C at rows 128y, columns 128x.
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    mm_tf32x3_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     T* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + TF_STAGES * TF_STAGE;
  const uint32_t empty = full + 8 * TF_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  const int KT = (K + TF_K - 1) / TF_K;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);      // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % TF_STAGES;
        const uint32_t st = ring + s * TF_STAGE;
        mbar_wait(empty + 8 * s, ((kt / TF_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * TF_TILE);
        tma_load_3d(st, &ma, full + 8 * s, kt * TF_K, m0, 0);
        tma_load_3d(st + TF_TILE, &mb, full + 8 * s, kt * TF_K, n0, 0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  // acc: the sum so far, in float32 in registers; part: one k-step's
  // products, summed by the tensor cores (gemm_sm90.cuh, wgmma_3xtf32)
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % TF_STAGES;
    const uint32_t st = ring + s * TF_STAGE;
    mbar_wait(full + 8 * s, (kt / TF_STAGES) & 1);
    // this warpgroup's 64 rows of A and of Bt: high parts in place, low
    // parts 2 tiles further (the products that last read this stage's
    // low parts released it before the producer loaded it again)
    float4* const p = reinterpret_cast<float4*>(smem_raw + (st - raw));
    split_tf32_smem(p + w * TF_HALF4, p + 2 * (TF_TILE / 16) + w * TF_HALF4,
                    TF_HALF4, tid, 128);
    split_tf32_smem(p + TF_TILE / 16 + w * TF_HALF4,
                    p + 3 * (TF_TILE / 16) + w * TF_HALF4, TF_HALF4, tid, 128);
    fence_proxy_async();
    bar_sync(1, 256);                   // both halves of Bt are split
    const uint32_t a = st + w * (TF_TILE / 2), b = st + TF_TILE;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TF_K / 8; ++kk)
      wgmma_3xtf32<1>(part, desc_sw128(a + kk * 32),
                      desc_sw128(a + 2 * TF_TILE + kk * 32),
                      desc_sw128(b + kk * 32),
                      desc_sw128(b + 2 * TF_TILE + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    if (tid == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  // d[4j + e]: row 16 * warp + lane / 4 + 8 * (e / 2) of the warpgroup's
  // 64, column 8j + 2 * (lane % 4) + e % 2
  const int r = m0 + 64 * w + 16 * warp + lane / 4;
  const int q = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store_pair(C, M, N, r, q + 8 * j, acc[4 * j], acc[4 * j + 1]);
    store_pair(C, M, N, r + 8, q + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <class T>
int launch_tf32x3(const CUtensorMap& ma, const CUtensorMap& mb, void* c,
                  int M, int N, int K, cudaStream_t stream) {
  const int gy = (M + 127) / 128, gx = (N + 127) / 128;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mm_tf32x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TF_SMEM);
  if (e != cudaSuccess) return (int)e;
  mm_tf32x3_kernel<T><<<dim3(gx, gy), THREADS, TF_SMEM, stream>>>(
      ma, mb, (T*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K), bt (N, K), row-major and 16-byte aligned: bf16 (K % 8 == 0),
// or f32 (K % 4 == 0) with mode bit 1; c (M, N), bf16 with mode bit 0,
// else f32. M, N, K >= 1. Returns the CUDA error code of the launch (or
// ERR_TENSOR_MAP).
int mm_float_launch(const void* a, const void* bt, void* c, int M, int N,
                    int K, int mode, void* stream) {
  if (M < 1 || N < 1 || K < 1 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap ma, mb;
  if (mode & 2) {
    if (make_map_f32(&ma, a, K, M, 1, 128, K) ||
        make_map_f32(&mb, bt, K, N, 1, 128, K))
      return ERR_TENSOR_MAP;
    return (mode & 1) ? launch_tf32x3<__nv_bfloat16>(ma, mb, c, M, N, K, st)
                      : launch_tf32x3<float>(ma, mb, c, M, N, K, st);
  }
  if (make_map(&ma, a, K, M, 1, BM, K) ||
      make_map(&mb, bt, K, N, 1, B_SLICE_ROWS, K))
    return ERR_TENSOR_MAP;
  if (mode & 1)
    return launch(mm_bf16_kernel<__nv_bfloat16>, M, N, 1, st, ma, mb,
                  (__nv_bfloat16*)c, M, N, K);
  return launch(mm_bf16_kernel<float>, M, N, 1, st, ma, mb, (float*)c, M, N,
                K);
}

const char* mm_float_error_string(int e) { return error_string(e); }

}  // extern "C"
