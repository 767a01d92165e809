// Tile-level building blocks shared by the port's hand-written kernels:
// cp.async copies into shared memory, ldmatrix fragment loads and the
// bf16 m16n8k16 tensor-core product (mma.sync, f32 accumulation), plus
// one 128x128x32 block-tile GEMM main loop used by the v1 LS kernel
// (ls_core.cuh); the int8 GEMM uses the copy and fragment helpers.
//
// Built for sm_90a. mma.sync reaches a fraction of Hopper's wgmma rate;
// the layer-1 GEMMs, the MLP tails and the serving LS kernels moved to
// TMA + wgmma (gemm_sm90.cuh, tail_sm90.cuh, ls_sm90.cuh), and these two
// kernels are next in line.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mamimo {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy; pred == false writes 16 zero bytes and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a warp tile: acc[MT][NT] (16x8 tiles) += A @ B where
// A points at the warp tile's first row and k column (row-major bf16,
// pitch lda elements) and B at its k row and first column (row-major
// [k][n] bf16, pitch ldb). Accumulator layout of tile (i, j): c[0..1] at
// row 16i + lane/4, cols 8j + 2(lane%4) + {0,1}; c[2..3] 8 rows lower.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MT][NT][4],
                                             const bf16* A, int lda,
                                             const bf16* B, int ldb,
                                             int lane) {
  static_assert(NT % 2 == 0, "NT must be even");
  const int r = lane & 15;
  const int cofs = (lane >> 4) * 8;
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) ldsm_x4(af[i], A + (i * 16 + r) * lda + cofs);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bfr[4];
    ldsm_x4_trans(bfr, B + r * ldb + j * 8 + cofs);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_bf16_16816(acc[i][j], af[i], bfr[0], bfr[1]);
      mma_bf16_16816(acc[i][j + 1], af[i], bfr[2], bfr[3]);
    }
  }
}

// ---------------------------------------------------------------------
// 128x128 block tile, k-step 32, 256 threads (8 warps as 2 x 4, each a
// 64x32 warp tile), STAGES-deep cp.async ring.
// ---------------------------------------------------------------------
namespace g128 {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 256;
constexpr int APITCH = BK + 8;  // 80-byte rows: ldmatrix conflict-free
constexpr int BPITCH = BN + 8;  // 272-byte rows
constexpr int A_STAGE = BM * APITCH;
constexpr int B_STAGE = BK * BPITCH;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
}  // namespace g128

// acc += A[m0:m0+128, 0:K] @ B[0:K, n0:n0+128] for this block.
// a_src(row, k) gives the global address of the 8 bf16 A values at tile
// row `row` (0..127) and global k column `k` (a multiple of 8) and
// whether they exist (rows past the end read as zero). B is row-major
// with ldb columns and holds every (k, n) the block touches.
template <class ASrc>
__device__ __forceinline__ void gemm128_mainloop(float (&acc)[4][4][4],
                                                 unsigned char* smem,
                                                 ASrc a_src, const bf16* B,
                                                 long long ldb, int n0,
                                                 int K) {
  using namespace g128;
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int KT = K / BK;

  auto load_stage = [&](int stage, int k0) {
    bf16* a = sA + stage * A_STAGE;
    bf16* b = sB + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, kc = (c & 3) * 8;
      bool ok;
      const bf16* src = a_src(row, k0 + kc, ok);
      cp_async16(a + row * APITCH + kc, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 4, nc = (c & 15) * 8;
      cp_async16(b + row * BPITCH + nc, B + (k0 + row) * ldb + n0 + nc,
                 true);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk * BK);
    cp_async_commit();
    const bf16* a = sA + (kt % STAGES) * A_STAGE + wm * APITCH;
    const bf16* b = sB + (kt % STAGES) * B_STAGE + wn;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      warp_mma_k16<4, 4>(acc, a + kk * 16, APITCH, b + kk * 16 * BPITCH,
                         BPITCH, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace mamimo
