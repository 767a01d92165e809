// Layers 2 and 3 of the CSI MLP for one block of 64 rows, with both
// activations kept on chip; shared by the factored tail kernel
// (fused_factored.cu), which builds the rows of h from the shared
// layer-1 projection, and the materialized-input MLP (mlp_infer.cu),
// which loads them from the layer-1 kernel's output:
//
//   h2 = relu(h @ W2 + b2) * a2 + c2            (64 x H2, bf16 on chip)
//   y  = h2 @ W3                                 (64 x 256, f32 registers)
//
// h is 64 x H1 bf16 in shared memory; W2 (H1, H2) and W3 (H2, 256, the
// carriers zero-padded) are bf16, b2, a2, c2 f32. The B operands of both
// products stream through ONE cp.async ring, in the order they are
// consumed: for each 128-column chunk of W2, its H1/64 k-tiles (64 x 128)
// and then the chunk's 4 W3 k-tiles (32 x 256). Every ring step is one
// k-step of either product (32 mma per warp), so the ring prefetches
// TSTAGES-1 steps ahead across chunk boundaries. Each h2 chunk goes
// through its bias, ReLU and affine into shared memory and is consumed
// by the chunk's W3 steps; neither h nor h2 reaches device memory.
#pragma once

#include "mma_tile.cuh"

// Phase cuts for tools/probe_tail.py, which times the factored tail
// kernel built with -DTAIL_CUT=<bits> (its answers are then wrong): 1
// skips building h, 2 the ring loop, 4 the layer-3 products, 8 the
// layer-2 products. The default, 0, is the kernel.
#ifndef TAIL_CUT
#define TAIL_CUT 0
#endif

namespace mamimo {
namespace tail {
constexpr int TBM = 64;       // rows per block
constexpr int NC = 128;       // W2 column chunk = layer-3 k chunk
constexpr int TBK2 = 64;      // k rows of a W2 tile
constexpr int TBK3 = 32;      // k rows of a W3 tile
constexpr int TSTAGES = 4;    // cp.async ring depth
constexpr int OPP = 256;      // padded output width (round_up(C, 128))
constexpr int THREADS = 256;
constexpr int W2P = NC + 8;   // pitches: rows 16 bytes off a 128-byte
constexpr int H2P = NC + 8;   // multiple, so ldmatrix is conflict-free
constexpr int W3P = OPP + 8;
// a ring stage holds one W2 tile (64 x 128) or one W3 tile (32 x 256)
constexpr int RING_STAGE =
    TBK2 * W2P > TBK3 * W3P ? TBK2 * W2P : TBK3 * W3P;

// Dynamic shared memory of a block: h (pitch H1 + 8), the ring, h2.
__host__ __device__ inline int smem_bytes(int H1) {
  return 2 * (TBM * (H1 + 8) + TSTAGES * RING_STAGE + TBM * H2P);
}
}  // namespace tail

// Runs layers 2 and 3 of the block's 64 rows into accy (zeroed here).
// fill_h(sH, pitch) must write all 64 x H1 values of h (bf16, rows past
// the data as zeros) into sH; it runs while the ring's first loads are in
// flight, and the loop's first barrier publishes it. H1 % 64 == 0,
// H2 % 128 == 0. accy holds the 64 x 256 tile of y (no bias): warp w has
// rows wm = (w >> 2) * 32 and columns wn = (w & 3) * 64; its tile (i, j)
// holds rows wm + 16i + lane/4 (c[0..1]) and 8 below (c[2..3]), columns
// wn + 8j + 2(lane%4) + {0, 1}.
template <class FillH>
__device__ __forceinline__ void tail_layers23(
    float (&accy)[2][8][4], const bf16* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ a2,
    const float* __restrict__ c2, const bf16* __restrict__ w3, int H1,
    int H2, FillH fill_h) {
  using namespace tail;
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = H1 + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem);
  bf16* ring = sH + TBM * HP;
  bf16* sH2 = ring + TSTAGES * RING_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KT = H1 / TBK2;          // W2 k-steps per chunk
  constexpr int K3 = NC / TBK3;      // W3 k-steps per chunk
  const int IPC = KT + K3;           // ring steps per chunk
  const int NIT = (H2 / NC) * IPC;

  auto load = [&](int stage, int it) {
    bf16* dst = ring + stage * RING_STAGE;
    const int chunk = it / IPC, r = it - chunk * IPC;
    if (r < KT) {                    // W2[r*64 .. +64, chunk*128 .. +128]
#pragma unroll
      for (int i = 0; i < (TBK2 * NC / 8) / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int row = c / (NC / 8), cc = (c % (NC / 8)) * 8;
        cp_async16(dst + row * W2P + cc,
                   w2 + (long long)(r * TBK2 + row) * H2 + chunk * NC + cc,
                   true);
      }
    } else {                         // W3[chunk*128 + (r-KT)*32 .. +32, :]
      const int k0 = chunk * NC + (r - KT) * TBK3;
#pragma unroll
      for (int i = 0; i < (TBK3 * OPP / 8) / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int row = c / (OPP / 8), cc = (c % (OPP / 8)) * 8;
        cp_async16(dst + row * W3P + cc,
                   w3 + (long long)(k0 + row) * OPP + cc, true);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < NIT) load(s, s);
    cp_async_commit();
  }

  if (!(TAIL_CUT & 1)) fill_h(sH, HP);

  // warp tiles (8 warps as 2 x 4): layer 2 32x32 of the 64x128 chunk,
  // layer 3 32x64 of the 64x256 output
  const int wm = (warp >> 2) * 32;
  const int wn2 = (warp & 3) * 32;
  const int wn3 = (warp & 3) * 64;
  const int g = lane >> 2, q = (lane & 3) * 2;

  float acc2[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accy[i][j][e] = 0.f;
  }

  for (int it = 0; !(TAIL_CUT & 2) && it < NIT; ++it) {
    // the barrier also publishes sH (first step) and the h2 chunk (first
    // W3 step of each chunk)
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();
    const int nx = it + TSTAGES - 1;
    if (nx < NIT) load(nx % TSTAGES, nx);
    cp_async_commit();

    const bf16* b = ring + (it % TSTAGES) * RING_STAGE;
    const int chunk = it / IPC, r = it - chunk * IPC;
    if (r < KT) {
      const bf16* a = sH + wm * HP + r * TBK2;
#pragma unroll
      for (int kk = 0; kk < TBK2 / 16; ++kk)
        if (!(TAIL_CUT & 8))
          warp_mma_k16<2, 4>(acc2, a + kk * 16, HP, b + kk * 16 * W2P + wn2,
                             W2P, lane);
      if (r == KT - 1) {
        // h2 chunk: bias, ReLU, affine (f32) -> bf16 in shared memory
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = wm + i * 16 + g, col = wn2 + j * 8 + q;
            const int kc = chunk * NC + col;
            const float bb0 = b2[kc], bb1 = b2[kc + 1];
            const float aa0 = a2[kc], aa1 = a2[kc + 1];
            const float cc0 = c2[kc], cc1 = c2[kc + 1];
            *reinterpret_cast<__nv_bfloat162*>(sH2 + row * H2P + col) =
                __floats2bfloat162_rn(
                    fmaxf(acc2[i][j][0] + bb0, 0.f) * aa0 + cc0,
                    fmaxf(acc2[i][j][1] + bb1, 0.f) * aa1 + cc1);
            *reinterpret_cast<__nv_bfloat162*>(sH2 + (row + 8) * H2P + col) =
                __floats2bfloat162_rn(
                    fmaxf(acc2[i][j][2] + bb0, 0.f) * aa0 + cc0,
                    fmaxf(acc2[i][j][3] + bb1, 0.f) * aa1 + cc1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
          }
      }
    } else {
      const bf16* a = sH2 + wm * H2P + (r - KT) * TBK3;
#pragma unroll
      for (int kk = 0; kk < TBK3 / 16; ++kk)
        if (!(TAIL_CUT & 4))
          warp_mma_k16<2, 8>(accy, a + kk * 16, H2P, b + kk * 16 * W3P + wn3,
                             W3P, lane);
    }
  }
  cp_async_wait<0>();
}

}  // namespace mamimo
