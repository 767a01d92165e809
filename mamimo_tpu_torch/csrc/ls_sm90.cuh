// The Hopper LS body of the port's three LS kernels: ls_v2.cu
// (ls_planes_v2_kernel, dense planes, full and sequence-sharded mode),
// ls_v1.cu (ls_planes_v1_kernel, the raw padded (hr, hi) planes) and
// ls_pair.cu (ls_pair_kernel, the per-pair complex64 layout).
//
//   z[s,n,c] = sum_t x[s, n*sym_len + cp + t] * A[c,t]   (complex)
//   h[s,j,c] = sum_n P[j,n] * z[s,n,c]                    (P Sylvester +-1)
//
// Replaces the LS body of the TPU kernels mamimo_tpu/ops/pallas/
// fused_ls.py::ls_planes_pallas_v2, ::ls_planes_pallas and
// ::ls_estimate_pallas. For bf16 input (ls_body; float32 input runs
// ls_body_f32, below, at float32 accuracy) the complex
// DFT-select is one real bf16 GEMM with f32 accumulation over K = [xr |
// xi], the fft samples of each symbol (the CP is skipped by the load's
// coordinate), against the constants Bt = [[Ar, -Ai], [Ai, Ar]] (2*cpad,
// 2*fft), K-major, its rows permuted (ops/kernels/fused_ls.py::
// ls_sm90_row_order): rows 128q .. 128q+63 are the real parts of
// carriers 64q .. 64q+63, rows 128q+64 .. 128q+127 their imaginary parts.
//
// Bound on an H100 at the bench shape (S = 4096, nt = 32): memory, 134 MB
// of bf16 input and 245 MB of f32 output, about 0.113 ms at 3.35 TB/s;
// the GEMM is about 69 GFLOP (0.07 ms at 989 TFLOP/s). The design:
//
// * Clusters of CL = 2*cpad/128 blocks (4 at BS32), one block an SM.
//   Block rank q holds slab q of Bt (128 columns = 64 carriers, real and
//   imaginary, x 2*fft: 128 KB at fft = 256) in shared memory for its
//   whole life, loaded once by TMA. The input reaches each SM once per
//   tile of its cluster (CL x 134 MB over the card), where the mma.sync
//   body these kernels replaced read each input tile once per column
//   block and B once per tile (1.07 GB).
// * A tile is SPT = 128/loc samples x loc symbols (128 GEMM rows). At
//   loc = 256 (NH = 2, a template parameter, so that loc <= 128 runs
//   the code it always ran) a tile is part a (0 or 1) of a sample's
//   output rows, a*128 .. a*128 + 127: P_256 is Sylvester, [[P_128, P_128], [P_128, -P_128]],
//   so h[a*128 + b] = (P_128 (z_lo + (-1)^a z_hi))[b], z_lo / z_hi the
//   DFT-select of symbols 0..127 / 128..255. The tile's k-steps run over
//   both symbol halves into one accumulator, the second half's products
//   with A scaled by (-1)^a (wgmma's imm-scale-a), and the 128-symbol
//   despread follows: the combine costs no pass and no buffer, and each
//   output row is written once; the input is read by both halves' tiles
//   (the second read mostly from L2). One
//   producer thread loads it in k-steps of 64 (16 KB) into a ring of
//   STAGES stages, as 16 boxes of 8 rows each multicast to the cluster
//   (each block loads 16/CL of them) through a 4-d map (sym_len, loc
//   symbols, S samples, 2 planes) whose box is bs symbols x 8/bs samples,
//   bs = 2 (1 for loc = 1, 8 for loc >= 64), symbols fastest.
// * The product is transposed: wgmma m64n128k16 with A = the slab (M =
//   the block's 128 columns, as two 64-row sets: set 0 real, set 1
//   imaginary) and B = the tile (N = its 128 rows). In the accumulator,
//   d[4j + 2h + e] holds carrier 16*warp + 8h + lane/4 of the set at
//   tile row 8j + 2*(lane%4) + e, and box j's row 2*(lane%4) + e is symbol
//   bit 0 = e and sample bits = lane%4 (bs = 2). So the despread of up to
//   32 symbols (bit 0 = e, bits 1.. = bits of j) runs on the f32
//   accumulators inside the thread, without a shuffle, a barrier or
//   shared memory; loc >= 64 adds two shuffle stages (xor 1, 2). The real
//   and imaginary part of a value sit at the same index of the two sets.
// * Two consumer warpgroups take the cluster's tiles in turns
//   (ping-pong): one runs its epilogue (despread and stores: the pair
//   layout's straight from registers, the planes' of ls_v2 and ls_v1
//   through the warpgroup's two 8 KB staging buffers) while the other
//   runs its products. Each releases a stage as soon as its own products on it
//   are done; the producer runs ahead across tile boundaries.
#pragma once

#include "gemm_sm90.cuh"

// Phase cuts for tools/probe_ls.py, which times the kernels built with
// -DLS_CUT=<bits> (their answers are then wrong): 1 skips the products,
// 2 the despread, 4 the global stores, 8 the float32 mode's TF32 split of
// the input, 32 all of the float32 mode's loads (each stage is marked
// full as it is freed). The default, 0, is the kernel.
#ifndef LS_CUT
#define LS_CUT 0
#endif

namespace mamimo {
namespace ls90 {

using namespace sm90;

constexpr int TILE = 128;                  // GEMM rows of a tile
constexpr int KB = 64;                     // k of a stage: 128 bytes
constexpr int KMAX = 512;                  // 2*fft <= 512
// stages of the input ring: the most that fit beside the resident slab
// and the staging buffers
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = TILE * KB * 2;            // 16 KB
constexpr int KBLOCK_BYTES = 128 * KB * 2;            // a slab's k-block
constexpr int B_BYTES = (KMAX / KB) * KBLOCK_BYTES;   // 128 KB
constexpr int THREADS = 384;               // producer + 2 consumer wgs
// a staging buffer: 32 tile rows x 64 carriers f32; two per warpgroup
constexpr int STG_ROWS = 32;
constexpr int STG_FLOATS = STG_ROWS * 64;
constexpr int SMEM_BYTES = B_BYTES + STAGES * STAGE_BYTES +
                           4 * STG_FLOATS * 4 + 8 * (2 * STAGES + 3) + 1024;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block has");

__device__ __forceinline__ int cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}

// TMA: the box at (c0, c1, c2, c3) of a 4-d map written at dst of every
// CTA in `mask` of the cluster, each completing its bytes on its own
// mbarrier at offset bar.
__device__ __forceinline__ void tma_load_4d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// d (64 x 128, f32) += SA * A (64 x 16) @ B (128 x 16)^T, both from
// shared memory, SA = 1 or -1 (imm-scale-a); d's fragment layout is that
// of m64n256k16 over 128 columns.
template <int SA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  static_assert(SA == 1 || SA == -1, "imm-scale-a is 1 or -1");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, %67, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(SA));
}

// The tiles of S samples of 2^log_loc symbols: 128 rows each.
__host__ __device__ __forceinline__ int tiles(int S, int log_loc) {
  if (log_loc > 7) return S << (log_loc - 7);
  const int spt = 1 << (7 - log_loc);
  return (S + spt - 1) / spt;
}

// log2 of the symbols of a box: 1 (2 symbols x 4 samples), 0 for one
// symbol a sample (8 samples), 3 when a tile holds fewer than 4 samples
// (loc >= 64: 8 symbols of one sample).
__host__ __device__ __forceinline__ int box_log_symbols(int log_loc) {
  return log_loc == 0 ? 0 : (log_loc <= 5 ? 1 : 3);
}

// Where tile row n (0 .. 127; box n / 8, row n % 8 of it) lies, for a
// tile of 2^log_loc <= 128 symbols a sample: symbol `sym` of the tile's
// sample `smp` (0 .. 128/loc - 1). A consumer thread's value 4j + 2h + e
// sits at tile row 8j + 2*(lane%4) + e.
__device__ __forceinline__ void row_coords(int n, int log_loc, int& smp,
                                           int& sym) {
  const int log_bs = box_log_symbols(log_loc);
  const int rib = n & 7, j = n >> 3;
  const int nsb = log_loc - log_bs;          // log2 of symbol blocks
  const int a = j & ((1 << nsb) - 1), bb = j >> nsb;
  sym = (a << log_bs) + (rib & ((1 << log_bs) - 1));
  smp = (bb << (3 - log_bs)) + (rib >> log_bs);
}

// Element (row, col) of a staging buffer (STG_ROWS x 64 f32): the column's
// 8-float blocks XOR-swizzled by row bits 1-2, so that a warp writing one
// accumulator value (8 carriers x 4 rows 2 apart) and a warp reading a
// row as float2 both hit 32 different banks.
__device__ __forceinline__ int stg_index(int row, int col) {
  return row * 64 + (col ^ (((row >> 1) & 3) << 3));
}

// The Walsh-Hadamard transform over the symbols of each sample, on one
// set of a thread's accumulators (the value at a symbol whose bit k is 0
// becomes lo + hi, the one whose bit k is 1 lo - hi): symbol bit 0 is e;
// with boxes of 2 symbols, bits 1 .. log_loc - 1 are bits 0 .. of j; with
// boxes of 8, bits 1 and 2 are lane bits 0 and 1 and bits 3 .. are bits
// 0 .. of j.
__device__ __forceinline__ void despread(float (&d)[64], int log_loc,
                                         int lane) {
  const int log_bs = box_log_symbols(log_loc);
  if (log_loc >= 1) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float a = d[i], b = d[i + 1];
      d[i] = a + b;
      d[i + 1] = a - b;
    }
  }
  if (log_bs == 3) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const bool hi = (lane >> b) & 1;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = __shfl_xor_sync(0xffffffffu, d[i], 1 << b);
        d[i] = hi ? p - d[i] : d[i] + p;
      }
    }
  }
  const int jbits = log_loc - log_bs;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < jbits) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j & (1 << k)) continue;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float a = d[4 * j + x], b = d[4 * (j | (1 << k)) + x];
          d[4 * j + x] = a + b;
          d[4 * (j | (1 << k)) + x] = a - b;
        }
      }
    }
  }
}

// The body. ma: 4-d map of the planes (sym_len, loc, S, 2), box KB x bs x
// 8/bs x 1, SW128; mb: 2-d map (as 3-d, one plane) of the permuted Bt
// (2*fft, 2*cpad rows), box KB x 128, SW128 (make_maps). loc = 2^log_loc
// <= 128 with NH = 1, or loc = 128 NH with NH symbol halves a tile (see
// the header), fft % 64 == 0, 2*fft <= KMAX. The two consumer warpgroups
// take the cluster's tiles in turns: warpgroup w the tiles u = w, w + 2,
// ... of the cluster's sequence, all 128 rows and all 128 columns of
// each. After a tile's products and despread each of its threads calls
//
//   epi.template store<NH>(acc0, acc1, s0, sym0, warp, lane, stg, bar)
//
// with acc0 / acc1 the real / imaginary set, s0 the tile's first sample
// and sym0 its first output symbol (0 with NH = 1, 128 * part with NH =
// 2; row_coords over min(loc, 128) symbols gives the rest), the block's
// carriers starting at 64 *
// cluster rank, and the warpgroup's two staging buffers (stg, 2 x
// STG_FLOATS) and named barrier (bar, 128 threads) for an epilogue that
// stages its stores. Launch through launch(); nothing may follow the call in
// the kernel (the producer and consumer paths never rejoin).
template <int NH, class Epi>
__device__ __forceinline__ void ls_body(const CUtensorMap* ma,
                                        const CUtensorMap* mb, int S,
                                        int log_loc, int fft, int cp,
                                        Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;    // the resident Bt slab
  const uint32_t ring = sb + B_BYTES;
  const uint32_t stg = ring + STAGES * STAGE_BYTES;   // 2 per warpgroup
  const uint32_t full = stg + 4 * STG_FLOATS * 4;     // STAGES x 8 bytes
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t bfull = empty + 8 * STAGES;
  const uint32_t done = bfull + 8;                    // 2 x 8 bytes

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cl = cluster_ctas();
  const int cid = cluster_index(), ncl = cluster_count();
  // a tile: 2^log_tl symbols of 2^log_spt samples, or part t % NH of
  // sample t / NH; its k-steps run over the NH symbol halves of 128
  static_assert(NH == 1 || NH == 2, "one or two symbol halves a tile");
  const int log_tl = NH == 1 ? log_loc : 7;
  const int NK0 = 2 * fft / KB;                   // k-steps of a half
  const int NK = NH * NK0;                        // k-steps of a tile
  const int log_spt = 7 - log_tl;                 // samples of a tile
  const int T = tiles(S, log_loc);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
      // the consuming warpgroup of every block: each stage holds boxes
      // multicast by all of them
      mbar_init(empty + 8 * s, cl);
    }
    mbar_init(bfull, 1);
    mbar_init(done, 1);
    mbar_init(done + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      // the block's slab of Bt, once
      mbar_expect_tx(bfull, NK0 * KBLOCK_BYTES);
      for (int kb = 0; kb < NK0; ++kb)
        tma_load_3d(sb + kb * KBLOCK_BYTES, mb, bfull, kb * KB, rank * 128,
                    0);
      const int log_bs = box_log_symbols(log_tl);
      const int nsb = log_tl - log_bs;       // log2 of symbol blocks
      const int boxes = 16 / cl;             // boxes a block loads a stage
      const uint16_t all = (uint16_t)((1u << cl) - 1);
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        const int s0 = (t / NH) << log_spt;  // the tile's first sample
        for (int half = 0; half < NH; ++half)
        for (int k0 = 0; k0 < NK0; ++k0, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          const int plane = k0 >= NK0 / 2;
          const int col = cp + (k0 - plane * (NK0 / 2)) * KB;
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          for (int q = 0; q < boxes; ++q) {
            const int g = rank * boxes + q;  // box g: tile rows 8g ..
            const int a = g & ((1 << nsb) - 1), bb = g >> nsb;
            tma_load_4d_multicast(
                ring + s * STAGE_BYTES + g * 1024, ma, full + 8 * s, col,
                (a << log_bs) + (half << 7), s0 + (bb << (3 - log_bs)),
                plane, all);
          }
        }
      }
      // stay until every block of the cluster has released each stage's
      // last use: no block may exit while another still arrives on its
      // barriers or multicasts into it
      for (int j = 0; j < STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % STAGES), ((it / STAGES) & 1) ^ 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  // stage i is free here and in the other blocks of the cluster
  auto release = [&](int i) {
    if (tid == 0)
      for (int c = 0; c < cl; ++c)
        mbar_arrive_cluster(empty + 8 * (i % STAGES), c);
  };
  mbar_wait(bfull, 0);
  for (int u = w, t = cid + w * ncl; t < T; u += 2, t += 2 * ncl) {
    // Wait until the other warpgroup has taken every stage of tile u - 1:
    // then each stage's earlier passes have completed, and the parity
    // waits below cannot mistake a pass two back for the one awaited.
    if (u > 0) mbar_wait(done + 8 * (1 - w), ((u - 1) / 2) & 1);
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int half = 0; half < NH; ++half)
    for (int k0 = 0; k0 < NK0; ++k0) {
      const int it = u * NK + half * NK0 + k0;
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = sb + k0 * KBLOCK_BYTES;
      const uint32_t b = ring + s * STAGE_BYTES;
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
      if (!(LS_CUT & 1)) {
        // symbol half `half` enters output part t % NH with the sign
        // P_2[t % NH, half] = (-1)^(part & half)
        if (NH > 1 && ((t % NH) & half)) {
#pragma unroll
          for (int kk = 0; kk < KB / 16; ++kk) {
            wgmma_m64n128k16<-1>(acc0, desc_sw128(a + kk * 32),
                                 desc_sw128(b + kk * 32));
            wgmma_m64n128k16<-1>(
                acc1, desc_sw128(a + KBLOCK_BYTES / 2 + kk * 32),
                desc_sw128(b + kk * 32));
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KB / 16; ++kk) {
            wgmma_m64n128k16<1>(acc0, desc_sw128(a + kk * 32),
                                desc_sw128(b + kk * 32));
            wgmma_m64n128k16<1>(
                acc1, desc_sw128(a + KBLOCK_BYTES / 2 + kk * 32),
                desc_sw128(b + kk * 32));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      release(it);
    }
    if (tid == 0) mbar_arrive(done + 8 * w);   // tile u's stages are taken
    if (!(LS_CUT & 2)) {
      despread(acc0, log_tl, lane);
      despread(acc1, log_tl, lane);
    }
    epi.template store<NH>(acc0, acc1, (t / NH) << log_spt, (t % NH) << 7,
                           warp, lane,
              reinterpret_cast<float*>(smem_raw + (stg - raw)) +
                  2 * STG_FLOATS * w,
              1 + w);
  }
}

// ---------------------------------------------------------------------
// The float32 mode (float32 planes, float32 constants): the same tiles,
// clusters, despread and epilogues, with the DFT product at float32
// accuracy as three TF32 products (gemm_sm90.cuh, wgmma_3xtf32).
//
// A float32 slab of Bt, or its high and low parts (2 x 256 KB at fft =
// 256), does not fit beside the ring, so nothing is resident: a stage
// holds the input's k-step of 32 f32 (16 KB, multicast to the cluster as
// in ls_body), room for its TF32 low part (16 KB) and the block's k-step
// of the constants' two parts (2 x 16 KB, each block its own 128 rows,
// loaded from L2, where the 2 MB of constants stay); F_STAGES stages.
// The constants come split from the host (fused_ls.py::
// ls_sm90_constants(dtype=float32): planes 0 and 1 of a (2, 2*cpad,
// 2*fft) tensor). bf16 planes never reach this body.
//
// The input's split runs on its own warps, beside the products: warps 1-3
// of the producer warpgroup (F_SPLITTERS threads, at its 40 registers)
// split each stage as it lands, the high part in place and the low part
// into the stage (TF32 rounding in integer operations), then
// fence.proxy.async and arrive on the stage's `split` mbarrier, which is
// what the consumers wait on. A consumer only issues wgmma and releases
// each stage once its products on it are done; its last k-step of a tile
// hands the products over to the other consumer as soon as that stage is
// taken. Who splits does not change the products or their order: the
// answers are those of a split in the consumer, bit for bit.
//
// Bound on an H100 at the bench shape (S = 4096, nt = 32): 268 MB of f32
// input (the fft samples) and 245 MB of f32 output, about 0.153 ms at
// 3.35 TB/s, against 69 GFLOP counted once at the TF32 peak of 495
// TFLOP/s (0.139 ms): memory-bound as counted. The three products make
// 207 GFLOP of tensor-core work (0.42 ms at the TF32 peak), so this
// design is product-bound at best. Measured for kernel 1 on an H100 80GB
// HBM3 at 700 W (tools/probe_ls.py, PERF.md): the products alone (no
// loads, split, despread or stores) 0.64 ms, the loads and the split
// alone 0.34 ms, the kernel 0.76 ms, where the earlier body, which ran
// the split between the loads and the products, took 1.08 ms.
// ---------------------------------------------------------------------
constexpr int KF = 32;                                 // f32 k of a stage
constexpr int F_STAGES = 3;
constexpr int F_X_BYTES = TILE * KF * 4;               // 16 KB
constexpr int F_B_BYTES = 128 * KF * 4;                // 16 KB a part
// a stage: the input's k-step (its high part once split), its low part,
// the constants' high and low parts; TMA writes all but the low part
constexpr int F_STAGE_BYTES = 2 * F_X_BYTES + 2 * F_B_BYTES;
constexpr int F_LOAD_BYTES = F_X_BYTES + 2 * F_B_BYTES;
constexpr int F_SPLITTERS = 96;            // warps 1-3 of the producer wg
constexpr int F_SMEM_BYTES = F_STAGES * F_STAGE_BYTES + 4 * STG_FLOATS * 4 +
                             8 * (3 * F_STAGES + 2) + 1024;
static_assert(F_SMEM_BYTES <= 232448, "more shared memory than a block has");

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 for every finite x: half a TF32 step added to the
// magnitude's bits, the low 13 bits cleared (the split kernel's plain
// version, ops/kernels/util.py, is held to cvt.rna bit for bit on the
// card; in the splitters 13% faster than cvt.rna on an H100, PERF.md).
// Finite x only: the carry can take a NaN's payload into the sign.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The low part of v: d = v - tf32_rna(v) rounded the same way. d is
// finite, or, where v is not finite, the canonical NaN 0x7fffffff,
// which the carry would turn into -0: the signed min keeps it a NaN and
// leaves every finite d as it is. So a non-finite sample reaches the
// estimate as NaN (its high part may be +-0), as through cvt.rna.
__device__ __forceinline__ float tf32_rna_lo(float d) {
  const int m = min((int)__float_as_uint(d), 0x7fffefff);
  return __uint_as_float(((uint32_t)m + 0x1000u) & 0xffffe000u);
}

// A splitter's share of a stage's input x (F_X_BYTES / 16 float4):
// float4 j, j + F_SPLITTERS, ... into their TF32 high parts in place and
// their low parts to lo at the same index.
__device__ __forceinline__ void split_stage(float4* x, float4* lo, int j) {
  for (int i = j; i < F_X_BYTES / 16; i += F_SPLITTERS) {
    const float4 v = x[i];
    float4 h, l;
    h.x = tf32_rna(v.x);
    h.y = tf32_rna(v.y);
    h.z = tf32_rna(v.z);
    h.w = tf32_rna(v.w);
    l.x = tf32_rna_lo(v.x - h.x);
    l.y = tf32_rna_lo(v.y - h.y);
    l.z = tf32_rna_lo(v.z - h.z);
    l.w = tf32_rna_lo(v.w - h.w);
    x[i] = h;
    lo[i] = l;
  }
}

// ls_body for float32 planes: ma a 4-d FLOAT32 map of the planes (box KF
// x bs x 8/bs x 1, SW128), mb a 3-d FLOAT32 map of the split constants
// (2*fft, 2*cpad rows, 2 parts; box KF x 128 x 1) (make_maps_f32). The
// tiles, the ping-pong of the consumer warpgroups and the call of
// epi.store are those of ls_body; launch with launch<F_SMEM_BYTES>.
template <int NH, class Epi>
__device__ __forceinline__ void ls_body_f32(const CUtensorMap* ma,
                                            const CUtensorMap* mb, int S,
                                            int log_loc, int fft, int cp,
                                            Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t stg = ring + F_STAGES * F_STAGE_BYTES;  // 2 per warpgroup
  const uint32_t full = stg + 4 * STG_FLOATS * 4;        // F_STAGES x 8
  const uint32_t split = full + 8 * F_STAGES;            // F_STAGES x 8
  const uint32_t empty = split + 8 * F_STAGES;
  const uint32_t done = empty + 8 * F_STAGES;            // 2 x 8 bytes

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cl = cluster_ctas();
  const int cid = cluster_index(), ncl = cluster_count();
  static_assert(NH == 1 || NH == 2, "one or two symbol halves a tile");
  const int log_tl = NH == 1 ? log_loc : 7;
  const int NK0 = 2 * fft / KF;                   // k-steps of a half
  const int NK = NH * NK0;                        // k-steps of a tile
  const int log_spt = 7 - log_tl;
  const int T = tiles(S, log_loc);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(split + 8 * s, F_SPLITTERS);
      mbar_init(empty + 8 * s, cl);
    }
    mbar_init(done, 1);
    mbar_init(done + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const int log_bs = box_log_symbols(log_tl);
      const int nsb = log_tl - log_bs;
      const int boxes = 16 / cl;
      const uint16_t all = (uint16_t)((1u << cl) - 1);
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        const int s0 = (t / NH) << log_spt;
        for (int half = 0; half < NH; ++half)
        for (int k0 = 0; k0 < NK0; ++k0, ++it) {
          const int s = it % F_STAGES;
          const uint32_t st = ring + s * F_STAGE_BYTES;
          mbar_wait(empty + 8 * s, ((it / F_STAGES) & 1) ^ 1);
          if (LS_CUT & 32) {
            mbar_arrive(full + 8 * s);
            continue;
          }
          const int plane = k0 >= NK0 / 2;
          const int col = cp + (k0 - plane * (NK0 / 2)) * KF;
          mbar_expect_tx(full + 8 * s, F_LOAD_BYTES);
          for (int q = 0; q < boxes; ++q) {
            const int g = rank * boxes + q;
            const int a = g & ((1 << nsb) - 1), bb = g >> nsb;
            tma_load_4d_multicast(
                st + g * 1024, ma, full + 8 * s, col,
                (a << log_bs) + (half << 7), s0 + (bb << (3 - log_bs)),
                plane, all);
          }
          // the block's 128 rows of the constants' k-step, both parts
          const uint32_t c = st + 2 * F_X_BYTES;
          tma_load_3d(c, mb, full + 8 * s, k0 * KF, rank * 128, 0);
          tma_load_3d(c + F_B_BYTES, mb, full + 8 * s, k0 * KF, rank * 128,
                      1);
        }
      }
      for (int j = 0; j < F_STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % F_STAGES), ((it / F_STAGES) & 1) ^ 1);
    } else if (tid >= 32) {
      // the splitters: every k-step of the cluster's tiles, in the ring's
      // order; a stage cannot land again before its split has been
      // consumed, so the parity waits cannot mistake an earlier pass
      const int n = (T - cid + ncl - 1) / ncl * NK;
      for (int it = 0; it < n; ++it) {
        const int s = it % F_STAGES;
        const uint32_t st = ring + s * F_STAGE_BYTES;
        mbar_wait(full + 8 * s, (it / F_STAGES) & 1);
        if (!(LS_CUT & 8))
          split_stage(reinterpret_cast<float4*>(smem_raw + (st - raw)),
                      reinterpret_cast<float4*>(smem_raw +
                                                (st + F_X_BYTES - raw)),
                      tid - 32);
        fence_proxy_async();
        mbar_arrive(split + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  auto release = [&](int i) {
    if (tid == 0)
      for (int c = 0; c < cl; ++c)
        mbar_arrive_cluster(empty + 8 * (i % F_STAGES), c);
  };
  for (int u = w, t = cid + w * ncl; t < T; u += 2, t += 2 * ncl) {
    // Wait until the other warpgroup has taken every stage of tile u - 1
    // (waited for its split): then each stage's earlier passes have
    // completed, and the parity waits below cannot mistake a pass two
    // back for the one awaited.
    if (u > 0) mbar_wait(done + 8 * (1 - w), ((u - 1) / 2) & 1);
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int half = 0; half < NH; ++half)
    for (int k0 = 0; k0 < NK0; ++k0) {
      const int it = u * NK + half * NK0 + k0;
      const int s = it % F_STAGES;
      const uint32_t st = ring + s * F_STAGE_BYTES;
      mbar_wait(split + 8 * s, (it / F_STAGES) & 1);
      // tile u's last stage is taken: the other warpgroup may start
      if (half == NH - 1 && k0 == NK0 - 1 && tid == 0)
        mbar_arrive(done + 8 * w);
      const uint32_t lo = st + F_X_BYTES;
      const uint32_t ah = st + 2 * F_X_BYTES, al = ah + F_B_BYTES;
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
      if (!(LS_CUT & 1)) {
        // symbol half `half` enters output part t % NH with the sign
        // P_2[t % NH, half] = (-1)^(part & half)
        if (NH > 1 && ((t % NH) & half)) {
#pragma unroll
          for (int kk = 0; kk < KF / 8; ++kk) {
            wgmma_3xtf32<-1>(acc0, desc_sw128(ah + kk * 32),
                             desc_sw128(al + kk * 32),
                             desc_sw128(st + kk * 32),
                             desc_sw128(lo + kk * 32));
            wgmma_3xtf32<-1>(acc1, desc_sw128(ah + F_B_BYTES / 2 + kk * 32),
                             desc_sw128(al + F_B_BYTES / 2 + kk * 32),
                             desc_sw128(st + kk * 32),
                             desc_sw128(lo + kk * 32));
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KF / 8; ++kk) {
            wgmma_3xtf32<1>(acc0, desc_sw128(ah + kk * 32),
                            desc_sw128(al + kk * 32),
                            desc_sw128(st + kk * 32),
                            desc_sw128(lo + kk * 32));
            wgmma_3xtf32<1>(acc1, desc_sw128(ah + F_B_BYTES / 2 + kk * 32),
                            desc_sw128(al + F_B_BYTES / 2 + kk * 32),
                            desc_sw128(st + kk * 32),
                            desc_sw128(lo + kk * 32));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      release(it);
    }
    if (!(LS_CUT & 2)) {
      despread(acc0, log_tl, lane);
      despread(acc1, log_tl, lane);
    }
    epi.template store<NH>(acc0, acc1, (t / NH) << log_spt, (t % NH) << 7,
                           warp, lane,
                           reinterpret_cast<float*>(smem_raw + (stg - raw)) +
                               2 * STG_FLOATS * w,
                           1 + w);
  }
}

// Launches a kernel built on ls_body (SMEM = SMEM_BYTES) or ls_body_f32
// (SMEM = F_SMEM_BYTES) for `tiles` tiles: clusters of cl blocks of
// THREADS threads with SMEM bytes of dynamic shared memory, as many
// clusters as fit on the device at once (cudaOccupancyMaxActiveClusters,
// asked once per kernel signature, SMEM and cluster size: kernels of one
// signature, such as ls_v2.cu's variants, share the answer, which holds
// because every kernel on either body runs one block an SM) and never
// more than there are tiles. Returns a cudaError_t code.
template <int SMEM = SMEM_BYTES, class... Params, class... Args>
inline int launch(void (*kernel)(Params...), int cl, int tiles,
                  cudaStream_t stream, Args... args) {
  if (cl < 1 || cl > 8 || tiles < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident[9] = {};  // clusters that fit, by cluster size
  if (resident[cl] == 0) {
    e = cudaOccupancyMaxActiveClusters(&resident[cl], (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (resident[cl] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  cfg.gridDim =
      dim3(cl * (tiles < resident[cl] ? tiles : resident[cl]), 1, 1);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The two tensor maps of an LS kernel (planes: S samples of loc symbols
// of sym_len bf16, two planes, 16-byte aligned; bt: the permuted
// constants); returns 0 or ERR_TENSOR_MAP.
inline int make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* planes,
                     const void* bt, int S, int log_loc, int sym_len,
                     int fft, int cpad) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const int bs = 1 << box_log_symbols(log_loc), loc = 1 << log_loc;
  const cuuint64_t row = (cuuint64_t)sym_len * 2;      // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)sym_len, (cuuint64_t)loc,
                              (cuuint64_t)S, 2};
  const cuuint64_t strides[3] = {row, row * loc, row * loc * S};
  const cuuint32_t box[4] = {(cuuint32_t)KB, (cuuint32_t)bs,
                             (cuuint32_t)(8 / bs), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(planes),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP;
  return make_map(mb, bt, 2 * fft, 2 * cpad, 1, 128, 2 * fft);
}

// make_maps for ls_body_f32: the planes as FLOAT32 (S samples of loc
// symbols of sym_len f32, two planes, 16-byte aligned), box KF x bs x
// 8/bs x 1; bt32 the split constants (2, 2*cpad, 2*fft) f32, box KF x
// 128 x 1. Returns 0 or ERR_TENSOR_MAP.
inline int make_maps_f32(CUtensorMap* ma, CUtensorMap* mb, const void* planes,
                         const void* bt32, int S, int log_loc, int sym_len,
                         int fft, int cpad) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const int bs = 1 << box_log_symbols(log_loc), loc = 1 << log_loc;
  const cuuint64_t row = (cuuint64_t)sym_len * 4;      // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)sym_len, (cuuint64_t)loc,
                              (cuuint64_t)S, 2};
  const cuuint64_t strides[3] = {row, row * loc, row * loc * S};
  const cuuint32_t box[4] = {(cuuint32_t)KF, (cuuint32_t)bs,
                             (cuuint32_t)(8 / bs), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(planes),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP;
  return make_map_f32(mb, bt32, 2 * fft, 2 * cpad, 2, 128, 2 * fft);
}

}  // namespace ls90
}  // namespace mamimo
