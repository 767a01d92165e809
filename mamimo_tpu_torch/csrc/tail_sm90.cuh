// Layers 2 and 3 of the CSI MLP for one block of 64 rows on Hopper, with
// both activations kept on chip. One body serves two kernels: the
// factored tail (fused_factored.cu, factored_tail_kernel), whose threads
// build the rows of h from the shared layer-1 projection, and the
// materialized-input tail (mlp_infer.cu, mlp_tail_kernel), which loads
// them by TMA from the layer-1 kernel's output:
//
//   h2 = bf16(relu(h @ W2 + b2) * a2 + c2)       (64 x H2, registers)
//   y  = h2 @ W3                                  (64 x 256, registers)
//
// Replaces the layer-2/3 halves of the TPU kernels
// mamimo_tpu/ops/pallas/fused_factored.py::fused_factored_planes and
// mamimo_tpu/ops/pallas/mlp_infer.py::mlp_infer_pallas, which keep h and
// h2 in VMEM; here neither reaches device memory either.
//
// Bound on an H100 (989 TFLOP/s bf16): compute. 64 rows a block give each
// weight element 128 FLOP, so a block that streamed W2 and W3 (2.6 MB at
// H = 1024) on its own would need about 15 TB/s of L2 at the peak rate.
// The design:
//
// * h (64 x H1 bf16, 128 KB at H1 = 1024) sits in shared memory as K-major
//   64-column slabs in the 128-byte-swizzle layout that wgmma reads
//   (desc_sw128): TMA writes it so for the materialized tail (zero rows
//   past M), the factored tail's threads write the same XOR pattern and
//   publish it with a proxy fence and a barrier.
// * W2 and W3 arrive K-major (w2t = W2^T (H2, H1), w3t = padded W3^T
//   (256, H2), kept by the weight-preparing functions) through one ring
//   of STAGES 16 KB stages (128 rows x 64 k), in the order they are
//   consumed: for each 128-column chunk of W2, its H1/64 k-tiles, then
//   four W3 tiles (k half w of the chunk, n half 0/1). One producer
//   thread issues every TMA load; "full"/"empty" mbarriers order the ring
//   and no __syncthreads() runs in the loop.
// * Clusters of CL blocks own different rows (or heads) and share every
//   weight tile: each block loads 1/CL of a stage and multicasts it to
//   all, so L2 delivers each tile once per cluster. A stage is free again
//   once both consumer warpgroups of every block have released it.
// * Two consumer warpgroups split each chunk: warpgroup w takes its
//   columns w*64 .. +64 (wgmma m64n64k16, A = h, B = its half of the W2
//   tile), turns the 64 x 64 f32 result into h2 (bias, ReLU, affine,
//   bf16) in registers, already in the layout of wgmma's register A
//   operand, and runs layer 3 on its k half of the chunk (m64n128k16,
//   A from registers, two n halves): y stays in 128 f32 registers a
//   thread. At the end the two partial y are summed through the drained
//   ring, each warpgroup finishing and storing 128 of the 256 columns.
// * setmaxnreg moves registers from the producer (40) to the consumers
//   (232).
// * h is whole in shared memory, so H1 <= MAX_RESIDENT (1024). Wider rows
//   (and every bf16 factored_rows_tail, mlp_infer's tail above 1024
//   units) run as two GEMMs on mm_sm90.cuh instead: a mode here that
//   brought h in one 64-column slab a stage beside its W2 tile read each
//   slab once per 128 columns of W2, 44 KB into an SM a million
//   multiply-adds, and ran near 40% of the products' rate (PERF.md).
#pragma once

#include "gemm_sm90.cuh"

// Phase cuts for tools/probe_tail.py, which times the tails built with
// -DTAIL_CUT=<bits> (their answers are then wrong): 1 skips building h
// (factored tail; in the float32 body the TF32 split of h in
// registers), 2 the layer-2 products, 4 the layer-3 products. The
// default, 0, is the kernel.
#ifndef TAIL_CUT
#define TAIL_CUT 0
#endif
// Blocks of a cluster sharing each weight tile (2 or 4).
#ifndef TAIL_CLUSTER
#define TAIL_CLUSTER 2
#endif

namespace mamimo {

using bf16 = __nv_bfloat16;

namespace tail {

using namespace sm90;

constexpr int ROWS = 64;                   // rows of a block (wgmma M)
constexpr int NC = 128;                    // W2 column chunk = W3 k chunk
constexpr int KB = 64;                     // k of a stage: 128 bytes
constexpr int OPP = 256;                   // padded output width
constexpr int STAGES = 6;
constexpr int STAGE_BYTES = NC * KB * 2;   // 16 KB
constexpr int SLAB_BYTES = ROWS * KB * 2;  // 8 KB: 64 rows x 64 k of h
constexpr int THREADS = 384;               // producer + 2 consumer wgs
constexpr int MAX_RESIDENT = 1024;         // widest h kept whole
constexpr int CL = TAIL_CLUSTER;
constexpr int SLICE_ROWS = NC / CL;        // a block's rows of a stage
constexpr int SLICE_BYTES = STAGE_BYTES / CL;
static_assert(CL == 1 || CL == 2 || CL == 4, "TAIL_CLUSTER is 1, 2 or 4");
// the two partial y halves (2 x 32 KB) are summed in the drained ring
static_assert(STAGES * STAGE_BYTES >= 2 * 64 * 128 * 4, "ring too small");

// Bytes of the h region: all of h.
__host__ __device__ inline int h_bytes(int H1) { return ROWS * H1 * 2; }

// Dynamic shared memory of a block: the h region, the ring, 2 * STAGES +
// 1 mbarriers, and room to align h to 1024 bytes.
inline int smem_bytes(int H1) {
  return h_bytes(H1) + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1) + 1024;
}

// Byte offset of h's element (row r, 16-byte column chunk kc) in the
// swizzled slab layout (what TMA writes with SWIZZLE_128B).
__device__ __forceinline__ uint32_t h_offset(int r, int kc) {
  return (kc >> 3) * SLAB_BYTES + r * 128 + (((kc & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Layers 2 and 3 for the block's 64 rows. W2 and W3 come through the
// maps mw2 (w2t, box KB x SLICE_ROWS) and mw3 (w3t, same box) at plane z;
// b2, a2, c2 (H2) f32. With LOAD_H, h is the boxes at rows h_row0.. of
// plane z of the map mh (box KB x ROWS); else fill_h(h, i) runs on each
// consumer thread i < 256 and must write all 64 x H1 values of h (bf16,
// h_offset layout, rows past the data as zeros). store(row, col, v0, v1)
// then receives y (no bias) for rows < 64 and even columns col < 256,
// two columns at a time. H1 % 128 == 0, H1 <= MAX_RESIDENT, H2 % 128 ==
// 0. Launch through launch(); nothing may follow the call in the kernel.
template <bool LOAD_H, class FillH, class Store>
__device__ __forceinline__ void layers23(
    const CUtensorMap* mh, int h_row0, const CUtensorMap* mw2,
    const CUtensorMap* mw3, int z, int H1, int H2,
    const float* __restrict__ b2, const float* __restrict__ a2,
    const float* __restrict__ c2, FillH&& fill_h, Store&& store) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t sh = (raw + 1023u) & ~1023u;
  const uint32_t ring = sh + h_bytes(H1);
  const uint32_t full = ring + STAGES * STAGE_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t hfull = empty + 8 * STAGES;
  unsigned char* gsh = smem_raw + (sh - raw);
  float* gring = reinterpret_cast<float*>(smem_raw + (ring - raw));

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int KT = H1 / KB;              // W2 stages of a chunk
  const int SPC = KT + 4;              // stages of a chunk
  const int NIT = (H2 / NC) * SPC;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // both consumer warpgroups of every block of the cluster
      mbar_init(empty + 8 * s, 2 * CL);
    }
    mbar_init(hfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      if constexpr (LOAD_H) {
        mbar_expect_tx(hfull, ROWS * H1 * 2);
        for (int k = 0; k < KT; ++k)
          tma_load_3d(sh + k * SLAB_BYTES, mh, hfull, k * KB, h_row0, z);
      }
      const uint16_t all = (uint16_t)((1u << CL) - 1);
      for (int it = 0; it < NIT; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int c = it / SPC, r = it - c * SPC;
        const uint32_t dst = ring + s * STAGE_BYTES + rank * SLICE_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        if (r < KT)    // W2[r*64 .., c*128 + ..] as w2t rows c*128 + ..
          tma_load_3d_multicast(dst, mw2, full + 8 * s, r * KB,
                                c * NC + rank * SLICE_ROWS, z, all);
        else           // W3 k half (r-KT)/2 of chunk c, n half (r-KT)%2
          tma_load_3d_multicast(dst, mw3, full + 8 * s,
                                c * NC + ((r - KT) >> 1) * KB,
                                ((r - KT) & 1) * NC + rank * SLICE_ROWS, z,
                                all);
      }
      // stay until every block of the cluster has released each stage's
      // last use: no block may exit while another still arrives on its
      // barriers
      for (int i = NIT > STAGES ? NIT - STAGES : 0; i < NIT; ++i)
        mbar_wait(empty + 8 * (i % STAGES), (i / STAGES) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = (lane % 4) * 2;
  if constexpr (LOAD_H) {
    mbar_wait(hfull, 0);
  } else {
    if (!(TAIL_CUT & 1)) fill_h(gsh, threadIdx.x - 128);
    fence_proxy_async();
    bar_sync(1, 256);
  }
  // stage i is free here and in the other blocks of the cluster
  auto release = [&](int i) {
    if (tid == 0)
#pragma unroll
      for (int c = 0; c < CL; ++c)
        mbar_arrive_cluster(empty + 8 * (i % STAGES), c);
  };

  float y0[64], y1[64], acc[32];
  uint32_t af[4][4] = {};
#pragma unroll
  for (int i = 0; i < 64; ++i) y0[i] = y1[i] = 0.f;
  // one W3 tile (128 n x 64 k at smem b) into y
  auto layer3 = [&](float(&y)[64], uint32_t b) {
    fence_acc(y);
    wgmma_fence();
    if (!(TAIL_CUT & 4)) {
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        wgmma_m64n128k16_rs(y, af[kk], desc_sw128(b + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(y);
    fence_u32(af);
  };
  // Each stage is released as soon as this warpgroup's products on it
  // are done: the loads, not the products, set the pace (TMA latency
  // over the bytes the ring holds), so a stage held while the next one
  // is awaited would cost the ring one slot.
  int it = 0;
  for (int c = 0; c < H2 / NC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // layer 2: acc = h @ W2[:, c*128 + w*64 .. +64]
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = sh + kt * SLAB_BYTES;      // h's slab kt
      const uint32_t b = ring + s * STAGE_BYTES + w * (STAGE_BYTES / 2);
      fence_acc(acc);
      wgmma_fence();
      if (!(TAIL_CUT & 2)) {
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk)
          wgmma_m64n64k16(acc, desc_sw128(a + kk * 32),
                          desc_sw128(b + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      release(it);
    }
    // h2 chunk in registers, as layer 3's A fragments: accumulator tile
    // j (columns 8j ..) is half of k16 slice j / 2
    const int col0 = c * NC + w * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j + q;
      const float bb0 = b2[col], bb1 = b2[col + 1];
      const float aa0 = a2[col], aa1 = a2[col + 1];
      const float cc0 = c2[col], cc1 = c2[col + 1];
      af[j / 2][(j % 2) * 2] =
          pack_bf16(fmaxf(acc[4 * j] + bb0, 0.f) * aa0 + cc0,
                    fmaxf(acc[4 * j + 1] + bb1, 0.f) * aa1 + cc1);
      af[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(fmaxf(acc[4 * j + 2] + bb0, 0.f) * aa0 + cc0,
                    fmaxf(acc[4 * j + 3] + bb1, 0.f) * aa1 + cc1);
    }
    // layer 3: y[:, n half] += h2[:, w's k half] @ W3 tile; the other
    // warpgroup's tiles are only waited for and released
    for (int j = 0; j < 4; ++j, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      if ((j >> 1) == w) {
        const uint32_t b = ring + s * STAGE_BYTES;
        if (j & 1)
          layer3(y1, b);
        else
          layer3(y0, b);
      }
      release(it);
    }
  }

  // sum the partial y: warpgroup 0 finishes columns 0..127, warpgroup 1
  // columns 128..255; each hands the other half through the ring, which
  // every TMA write has reached (each consumer waited on every stage)
  bar_sync(1, 256);
  float* mine = gring + w * (64 * 128);
  float* theirs = gring + (1 - w) * (64 * 128);
  if (w == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) mine[i * 128 + tid] = y1[i];
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) mine[i * 128 + tid] = y0[i];
  }
  bar_sync(1, 256);
  const int row = warp * 16 + g;
  if (w == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) y0[i] += theirs[i * 128 + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      store(row, 8 * j + q, y0[4 * j], y0[4 * j + 1]);
      store(row + 8, 8 * j + q, y0[4 * j + 2], y0[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) y1[i] += theirs[i * 128 + tid];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      store(row, NC + 8 * j + q, y1[4 * j], y1[4 * j + 1]);
      store(row + 8, NC + 8 * j + q, y1[4 * j + 2], y1[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------
// The float32 mode (3xTF32): layers 2 and 3 at float32 accuracy on
// float32 rows h, for both tails that load h (factored_rows_tail, the
// materialized MLP's tail):
//
//   h2 = relu(h @ W2 + b2) * a2 + c2              (64 x H2, float32)
//   y  = h2 @ W3                                  (64 x 256, registers)
//
// W2's and W3's TF32 parts are split once, when the weights are
// prepared (tf32_split.cu): a stage holds one 32-wide k-step of the
// block's 64-row h slab (8 KB, TMA) and both parts of a 128-row W tile
// (2 x 16 KB, TMA multicast to the cluster as in layers23): 40 KB, 4
// stages. No thread splits or writes a weight. Layer 2 takes h from
// registers: each consumer loads its A fragment of the slab and splits
// it there (lds_split_tf32; wgmma's RS form of m64n64k8 .tf32), so the
// two warpgroups share no barrier in layer 2, and each releases a stage
// once its own products on it are done (kstep_3xtf32_rs keeps one group
// in flight; early_release frees a held stage before waiting for one
// that has not arrived). Its sums run in stretches of F_STRETCH k-steps
// into a fresh accumulator, added in float32 in registers (the tensor
// cores' additions truncate). Warpgroup w computes columns w*64.. of
// each W2 chunk and then y's columns w*128.. (m64n128k8) over the whole
// chunk, so y needs no sum across the warpgroups; the chunk of h2 (bias,
// ReLU, affine in registers) that layer 3 needs is both warpgroups'
// columns, so it is split into its parts and staged in shared memory (2
// x 32 KB, SW128 slabs of 32 k) between two named barriers, and layer 3
// reads it there as A (a register-A layer 3 would need all 128 columns
// of h2 in each warpgroup's registers). The W3 tiles of a chunk (w3t
// rows n half * 128.., k-step of 32) come in the order n half 0, 1 of
// k-step 0, then of k-step 1, ...; a warpgroup uses those of its own
// half and only waits for and releases the others. 64 rows a block: 128 (two
// warpgroups on one W tile) would need y's 64 x 256 in each
// warpgroup's registers beside its stretch accumulator. Measured on an
// H100 (tools/probe_tail.py --f32, PERF.md): without early_release 25%
// slower; 1-block clusters within 3%, 4-block ones 11% slower; stretches
// of 2 k-steps 2% faster than the GEMMs' 8 and 5 dB more accurate.
// ---------------------------------------------------------------------
constexpr int KF = 32;                      // f32 k of a stage: 128 bytes
constexpr int F_SLAB = ROWS * KF * 4;       // 8 KB: 64 rows x 32 k of h
constexpr int F_W = NC * KF * 4;            // 16 KB: one part of a W tile
constexpr int F_SLICE = F_W / CL;           // a block's share of a part
constexpr int F_STAGE = F_SLAB + 2 * F_W;   // 40 KB: h slab, W hi, W lo
constexpr int F_STAGES = 4;
constexpr int F_STRETCH = 2;                // layer 2's k-steps a stretch
constexpr int F_H2 = ROWS * NC * 4;         // 32 KB: an h2 chunk, one part
constexpr int F_W3_TILES = (OPP / NC) * (NC / KF);   // W3 tiles a chunk
// the ring, the staged h2 chunk (both parts), 2 x F_STAGES mbarriers,
// and room to align the ring to 1024 bytes
constexpr int F_SMEM =
    F_STAGES * F_STAGE + 2 * F_H2 + 8 * 2 * F_STAGES + 1024;
static_assert(F_SMEM <= 232448, "more shared memory than a block has");
static_assert(OPP / NC == 2, "warpgroup w stores y's columns w*128..");

// Layers 2 and 3 in float32 for the block's 64 rows: h is the boxes at
// rows h_row0.. of plane zh of the f32 map mh (box KF x ROWS); W2's and
// W3's TF32 high and low parts are planes 2 zw and 2 zw + 1 of the f32
// maps mw2 (w2t's parts (.., 2, H2, H1), box KF x SLICE_ROWS) and mw3
// (w3t's parts (.., 2, 256, H2), same box); b2, a2, c2 (H2) f32.
// store(row, col, v0, v1) receives y (no bias) for rows < 64 and even
// columns col < 256, two columns at a time. H1 % 32 == 0, H2 % 128 ==
// 0. Launch through launch() with F_SMEM bytes; nothing may follow the
// call in the kernel.
template <class Store>
__device__ __forceinline__ void layers23_f32(
    const CUtensorMap* mh, int h_row0, int zh, const CUtensorMap* mw2,
    const CUtensorMap* mw3, int zw, int H1, int H2,
    const float* __restrict__ b2, const float* __restrict__ a2,
    const float* __restrict__ c2, Store&& store) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t h2s = ring + F_STAGES * F_STAGE;   // high part, then low
  const uint32_t full = h2s + 2 * F_H2;
  const uint32_t empty = full + 8 * F_STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int KT = H1 / KF;                 // layer-2 stages of a chunk
  const int SPC = KT + F_W3_TILES;        // stages of a chunk
  const int NIT = (H2 / NC) * SPC;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // both consumer warpgroups of every block of the cluster
      mbar_init(empty + 8 * s, 2 * CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const uint16_t all = (uint16_t)((1u << CL) - 1);
      for (int it = 0; it < NIT; ++it) {
        const int s = it % F_STAGES;
        mbar_wait(empty + 8 * s, ((it / F_STAGES) & 1) ^ 1);
        const int c = it / SPC, r = it - c * SPC;
        const uint32_t st = ring + s * F_STAGE;
        const uint32_t wdst = st + F_SLAB + rank * F_SLICE;
        int k, n;                     // the W tile's k and row of w2t/w3t
        const CUtensorMap* mw;
        if (r < KT) {  // W2[r*32 .., c*128 + ..] as w2t rows, h's slab r
          mbar_expect_tx(full + 8 * s, F_SLAB + 2 * F_W);
          tma_load_3d(st, mh, full + 8 * s, r * KF, h_row0, zh);
          mw = mw2;
          k = r * KF;
          n = c * NC;
        } else {       // W3 tile j: n half j % 2, k-step j / 2 of chunk c
          const int j = r - KT;
          mbar_expect_tx(full + 8 * s, 2 * F_W);
          mw = mw3;
          k = c * NC + (j >> 1) * KF;
          n = (j & 1) * NC;
        }
        n += rank * SLICE_ROWS;
        tma_load_3d_multicast(wdst, mw, full + 8 * s, k, n, 2 * zw, all);
        tma_load_3d_multicast(wdst + F_W, mw, full + 8 * s, k, n,
                              2 * zw + 1, all);
      }
      // stay until every block of the cluster has released each stage's
      // last use
      for (int i = NIT > F_STAGES ? NIT - F_STAGES : 0; i < NIT; ++i)
        mbar_wait(empty + 8 * (i % F_STAGES), (i / F_STAGES) & 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4, tq = lane % 4, q = 2 * tq;
  unsigned char* const h2p = smem_raw + (h2s - raw);
  auto release = [&](int i) {
    if (tid == 0)
#pragma unroll
      for (int c = 0; c < CL; ++c)
        mbar_arrive_cluster(empty + 8 * (i % F_STAGES), c);
  };
  // y: this warpgroup's 128 output columns
  float y[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) y[i] = 0.f;
  TfA A = {};
  int it = 0;
  for (int c = 0; c < H2 / NC; ++c) {
    // layer 2: acc = h @ W2[:, c*128 + w*64 .. +64]; part: a stretch's
    // products, summed by the tensor cores
    float acc[32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
    bool fresh = true;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % F_STAGES;
      const uint32_t st = ring + s * F_STAGE;
      const bool held = early_release(part, A, !fresh, full + 8 * s,
                                      (it / F_STAGES) & 1,
                                      [&] { release(it - 1); });
      mbar_wait(full + 8 * s, (it / F_STAGES) & 1);
      const uint32_t b = st + F_SLAB + w * (F_W / 2);
      kstep_3xtf32_rs<!(TAIL_CUT & 1), !(TAIL_CUT & 2)>(
          part, A, smem_raw + (st - raw), row, tq, b, b + F_W, !fresh,
          [&] {
            if (held) release(it - 1);
          });
      fresh = tf_stretch_end<F_STRETCH>(kt, KT, w);
      if (fresh) {
        drain_3xtf32(part, A);
        release(it);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
      }
    }
    // h2's chunk columns w*64 .. +64 (bias, ReLU, affine), split and
    // staged as slabs 2w, 2w + 1 of h2s (the swizzled layout of a TMA
    // box), once both warpgroups' layer-3 products on the last chunk's
    // h2 are done
    bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = w * 64 + 8 * j + q;          // column in the chunk
      const int col = c * NC + k;
      const float bb0 = b2[col], bb1 = b2[col + 1];
      const float aa0 = a2[col], aa1 = a2[col + 1];
      const float cc0 = c2[col], cc1 = c2[col + 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {             // rows row, row + 8
        const int rr = row + 8 * e;
        float h0, l0, h1, l1;
        split_tf32(fmaxf(acc[4 * j + 2 * e] + bb0, 0.f) * aa0 + cc0, h0, l0);
        split_tf32(fmaxf(acc[4 * j + 2 * e + 1] + bb1, 0.f) * aa1 + cc1, h1,
                   l1);
        const uint32_t off = (k >> 5) * F_SLAB + rr * 128 +
                             ((((k & 31) >> 2) ^ (rr & 7)) << 4) +
                             (k & 3) * 4;
        *reinterpret_cast<float2*>(h2p + off) = make_float2(h0, h1);
        *reinterpret_cast<float2*>(h2p + F_H2 + off) = make_float2(l0, l1);
      }
    }
    fence_proxy_async();
    bar_sync(1, 256);
    // layer 3: part3 = h2 chunk @ W3[chunk, w*128 .. +128], one commit
    // group a W3 tile, the one before it retired as the next is issued
    float part3[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part3[i] = 0.f;
    int mine = -1;                // this warpgroup's tile in flight
    for (int j = 0; j < F_W3_TILES; ++j, ++it) {
      const int s = it % F_STAGES;
      const uint32_t st = ring + s * F_STAGE;
      // as early_release: free the tile in flight before a wait
      if (mine >= 0 && !mbar_test(full + 8 * s, (it / F_STAGES) & 1)) {
        wgmma_wait<0>();
        fence_acc(part3);
        release(mine);
        mine = -1;
      }
      mbar_wait(full + 8 * s, (it / F_STAGES) & 1);
      if ((j & 1) != w) {
        release(it);
        continue;
      }
      const int k3 = j >> 1;
      const uint32_t a = h2s + k3 * F_SLAB, b = st + F_SLAB;
      fence_acc(part3);
      wgmma_fence();
      if (!(TAIL_CUT & 4)) {
#pragma unroll
        for (int kk = 0; kk < KF / 8; ++kk)
          wgmma_3xtf32<1>(part3, desc_sw128(a + kk * 32),
                          desc_sw128(a + F_H2 + kk * 32),
                          desc_sw128(b + kk * 32),
                          desc_sw128(b + F_W + kk * 32), k3 > 0 || kk > 0);
      }
      wgmma_commit();
      fence_acc(part3);
      wgmma_wait<1>();
      fence_acc(part3);
      if (mine >= 0) release(mine);
      mine = it;
    }
    wgmma_wait<0>();
    fence_acc(part3);
    if (mine >= 0) release(mine);
#pragma unroll
    for (int i = 0; i < 64; ++i) y[i] += part3[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store(row, w * NC + 8 * j + q, y[4 * j], y[4 * j + 1]);
    store(row + 8, w * NC + 8 * j + q, y[4 * j + 2], y[4 * j + 3]);
  }
}

// Launches a kernel built on layers23: clusters of CL blocks of THREADS
// threads along x (grid.x % CL == 0), smem bytes of dynamic shared
// memory. Returns a cudaError_t code.
template <class... Params, class... Args>
inline int launch(void (*kernel)(Params...), dim3 grid, int smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tail
}  // namespace mamimo
