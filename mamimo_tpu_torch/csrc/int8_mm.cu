// int8 GEMM with int32 accumulation on the tensor cores.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas
// (body _mm_kernel), int8 mode: C = A @ B, A (M, K) s8, B (K, N) s8,
// C (M, N) s32. The TPU kernel keeps all of B resident in VMEM (up to
// 10 MB for layer 1 of the DNN) and streams A in row blocks; a block on
// the card has at most 227 KB of shared memory, so here both operands
// stream through a cp.async ring in 64-deep k tiles.
//
// Design for the card:
// * B is taken transposed, Bt (N, K) row-major, so that both operands are
//   K-contiguous: the same non-transposing ldmatrix (16-byte rows read as
//   pairs of bytes) then yields the A and the B fragments of
//   mma.sync.m16n8k32.s32.s8.s8.s32. The public wrapper keeps B (K, N);
//   the caller that owns the weights makes the transposed copy once.
// * 128 x 128 block tile, 8 warps as 2 x 4, each a 64 x 32 warp tile of
//   4 x 4 m16n8 accumulators (int32, in registers); 4-stage ring of
//   (128 + 128) x 64-byte tiles, 80-byte rows so that ldmatrix is
//   conflict-free.
// * Ragged M, the N edge (234 for layer 3) and K % 64 != 0 are masked by
//   zero-filling cp.async (zeros add nothing to an integer sum) and by the
//   store; K must be a multiple of 16 so each 16-byte copy is whole.
// * Sums are exact: |a*b| <= 2^14 and K < 2^17 keep them inside int32.
//
// Bound on an H100 at the serving shapes, per plane, S = 4096:
//   layer 1 (4096, 10240) @ (10240, 1024): 85.9 G ops, 0.043 ms at
//           1979 T int8 ops/s — operation-bound;
//   layer 2 (131072, 1024) @ (1024, 1024): 134 MB in + 537 MB int32 out,
//           0.20 ms at 3.35 TB/s — byte-bound;
//   layer 3 (131072, 1024) @ (1024, 234): 134 MB in + 123 MB out,
//           0.077 ms — byte-bound.
// mma.sync reaches a fraction of the int8 peak (wgmma is the way to the
// rest); the byte-bound layers are limited by the int32 output write,
// which each warp writes as 8-byte stores, four lanes per row.
#include <stdint.h>

#include "mma_tile.cuh"

using namespace mamimo;

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 256;
constexpr int PITCH = BK + 16;  // bytes per smem row
constexpr int A_STAGE = BM * PITCH, B_STAGE = BN * PITCH;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);

__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 2)
    int8_mm_kernel(const int8_t* __restrict__ A,
                   const int8_t* __restrict__ Bt, int32_t* __restrict__ C,
                   int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  int8_t* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK;

  // each operand tile is 128 rows x 4 chunks of 16 bytes: 2 per thread
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const int gm = m0 + row, gn = n0 + row;
      const bool oka = gm < M && gk < K, okb = gn < N && gk < K;
      cp_async16(sA + stage * A_STAGE + row * PITCH + kc,
                 oka ? A + (long long)gm * K + gk : A, oka);
      cp_async16(sB + stage * B_STAGE + row * PITCH + kc,
                 okb ? Bt + (long long)gn * K + gk : Bt, okb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();
  }
  // ldmatrix addresses of this lane: A rows 0-15 at byte 0 (lanes 0-15)
  // or 16 (lanes 16-31) give a0..a3; B rows n 0-7 / 8-15 at byte 0 / 16
  // give b0, b1 of two n8 tiles.
  const int a_row = lane & 15, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk * BK);
    cp_async_commit();
    const int8_t* a = sA + (kt % STAGES) * A_STAGE + wm * PITCH;
    const int8_t* b = sB + (kt % STAGES) * B_STAGE + wn * PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], a + (i * 16 + a_row) * PITCH + kk + a_col);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, b + (j * 8 + b_row) * PITCH + kk + b_col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_s8_16832(acc[i][j], af[i], bfr[0], bfr[1]);
          mma_s8_16832(acc[i][j + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool pairs = (N & 1) == 0;  // int2 stores stay 8-byte aligned
  auto store = [&](int row, int col, int v0, int v1) {
    if (row >= M || col >= N) return;
    int32_t* p = C + (long long)row * N + col;
    if (col + 1 >= N) {
      p[0] = v0;
    } else if (pairs) {
      *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
      p[0] = v0;
      p[1] = v1;
    }
  };
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + i * 16 + g, col = n0 + wn + j * 8 + q;
      store(row, col, acc[i][j][0], acc[i][j][1]);
      store(row + 8, col, acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace

extern "C" {

// a (M, K) s8, bt (N, K) s8, c (M, N) s32, all row-major and 16-byte
// aligned; K % 16 == 0. Returns the CUDA error code of the launch.
int int8_mm_launch(const void* a, const void* bt, void* c, int M, int N,
                   int K, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)bt, (int32_t*)c, M, N, K);
  return (int)cudaGetLastError();
}

const char* int8_mm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
