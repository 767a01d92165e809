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
// * A tile is SPT = 128/loc samples x loc symbols (128 GEMM rows). One
//   producer thread loads it in k-steps of 64 (16 KB) into a ring of
//   STAGES stages, as 16 boxes of 8 rows each multicast to the cluster
//   (each block loads 16/CL of them) through a 4-d map (sym_len, loc
//   symbols, S samples, 2 planes) whose box is bs symbols x 8/bs samples,
//   bs = 2 (1 for loc = 1, 8 for loc >= 64), symbols fastest.
// * At loc = 256 (NH = 2, a template parameter; ls_body_halves) a unit is
//   one sample, both of its output halves a = 0 and 1 (rows a*128 ..
//   a*128 + 127): P_256 is Sylvester, [[P_128, P_128], [P_128, -P_128]],
//   so h[a*128 + b] = (P_128 (z_lo + (-1)^a z_hi))[b], z_lo / z_hi the
//   DFT-select of symbols 0..127 / 128..255. Each consumer warpgroup takes
//   one set of the block's columns (real or imaginary) of the sample from
//   the same ring stages and accumulates z_lo and z_hi apart; h_0 = z_lo +
//   z_hi and h_1 = z_lo - z_hi follow in registers, the 128-symbol despread
//   on each, and the warpgroups swap halves through shared memory, so that
//   warpgroup a stores half a. The sample's input enters each SM of the
//   cluster once and each product runs once: the body before it took a
//   tile per half, whose k-steps ran over both symbol halves, so each SM
//   took the input in twice and ran every product twice, and the products
//   set its time (PERF.md). The float32 mode takes the same schedule
//   (ls_body_f32_halves), and so do all three stores. The pair store's
//   (8-byte pieces 32 bytes apart) ran slower on it than on the tile
//   body, whose other warpgroup's products overlapped it (PERF.md).
// * Any num_tx up to 2048, and symbols whose rows TMA cannot stride
//   (NH = 0, the general instantiation; NH = 1 keeps the code it ran
//   before it, NH = 2 runs ls_body_halves): a tile is part p of nh =
//   loc/128 parts of a sample (or, at loc <= 128, whole samples as
//   above). P_{128 nh} = H_nh (x)
//   H_128, so part p's rows are the 128-symbol despread of Z_p = sum_v
//   H_nh[p, v] Y_v, H_nh[p, v] = (-1)^popcount(p & v), Y_v the DFT-select
//   input of part v. At loc >= 512 (`parts`) the input is Z itself,
//   written by the part transform (ls_parts.cu) with each symbol fft
//   samples on an aligned row, and a tile's k-steps run over Z_p alone:
//   the products and reads of one part a tile, as at NH = 1. Below that
//   (loc 256 with a symbol off the 16-byte grid) the tile's k-steps run
//   over both parts v, each with its sign (wgmma's imm-scale-a), into
//   one accumulator. A seq rank's partial needs no other sign: part
//   p_hi*nl + p_lo of the whole estimate is H_n[p_hi, rank] times part
//   p_lo of the rank's own, which the epilogues already store n times
//   with those signs. The output is written once. Why `parts` runs on
//   the general body and not on the NH = 1 body over S nl samples of 128
//   symbols: that would put each tile's rows in the right place for
//   kernels 1 and 3 in full mode only, while a seq rank's copies and the
//   pair layout need the part's offset, which the general body's
//   epilogues already take (Rows, sym0 = part << 7); one flag in the
//   general body serves all three kernels and both modes. A map row
//   must start on 16 bytes, and a symbol of sym_len samples does not
//   when sym_len * esize % 16 != 0 (a cyclic prefix that is not a
//   multiple of 8, e.g. NR's 18 at a 256-point FFT; at loc <= 256, as
//   the part transform's output is aligned): then one row of the map
//   spans g = 2^log_g symbols (group_log) and a box's rows step g
//   symbols. Within a tile the rows then hold the symbols in a rotated
//   order, v = q + m * 2^(log_tl - log_g) for symbol m + g q; the
//   Walsh-Hadamard transform commutes with a permutation of the index
//   bits, so the despread runs unchanged on the rotated order and the
//   epilogue maps each row back (Rows::at). A box must also start on 16
//   bytes (a TMA load whose inner
//   start is off that grid faults: tools' probe on an H100, PERF.md), so
//   symbol m's fft samples are loaded unswizzled from their start rounded
//   down, with the next 16 bytes as a second box beside the stage, and
//   warps 1-3 of the producer warpgroup shift each row by the offset and
//   write it back in place in the SW128 layout of a TMA load (shifted),
//   fenced for the async proxy; the consumers wait on a `ready` barrier
//   (the float32 body's splitters shift and split in one pass). The
//   second boxes take the ring's last stage, so that ring is one stage
//   shorter.
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
//   are done; the producer runs ahead across tile boundaries. At NH = 2
//   both take the same sample: products and epilogues run together, and
//   the producer fills the ring during the epilogues.
#pragma once

#include "gemm_sm90.cuh"

// Phase cuts for tools/probe_ls.py, which times the kernels built with
// -DLS_CUT=<bits> (their answers are then wrong): 1 skips the products,
// 2 the despread, 4 the global stores, 8 the float32 mode's TF32 split of
// the input and, in the shifted layout, the shift of both modes, 32 all of
// the float32 mode's loads (each stage is marked full as it is freed). The
// default, 0, is the kernel.
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
// the 16 bytes after each row of a stage's 16 boxes (the shifted layout),
// and the threads that shift a stage (warps 1-3 of the producer wg)
constexpr int SIDE_BYTES = 16 * 8 * 16;
constexpr int SHIFTERS = 96;

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

// log2 of the symbols that one row of the input's tensor map spans: the
// least g with g * sym_len * esize a multiple of 16 bytes, TMA's rule for
// a stride (0 for an aligned symbol; at most 3 for bf16, 2 for f32)
__host__ __device__ __forceinline__ int group_log(int sym_len, int esize) {
  int lg = 0;
  while (((sym_len * esize) << lg) % 16) ++lg;
  return lg;
}

// log2 of the symbols a box of the general body holds (NH = 0): that of
// box_log_symbols for a tile of 2^log_tl symbols a sample, but no more
// than the 2^(log_tl - log_g) symbols of one map row a tile holds
__host__ __device__ __forceinline__ int box_log(int log_tl, int log_g) {
  const int b = box_log_symbols(log_tl);
  return b < log_tl - log_g ? b : log_tl - log_g;
}

// Where tile row n lies in the general body: the tile's sample smp and
// the symbol sym of that sample (0 .. loc - 1). Boxes hold 2^log_bs
// consecutive rotated symbols v of a tile's 2^log_tl (as row_coords), and
// v of the tile of symbols sym0 .. sym0 + 2^log_tl - 1 is symbol sym0 +
// (v >> tq) + ((v & (2^tq - 1)) << log_g), tq = log_tl - log_g.
struct Rows {
  int log_tl, log_bs, log_g, sym0;

  __device__ __forceinline__ void at(int n, int& smp, int& sym) const {
    const int rib = n & 7, j = n >> 3;
    const int nsb = log_tl - log_bs;         // log2 of symbol blocks
    const int a = j & ((1 << nsb) - 1), bb = j >> nsb;
    const int v = (a << log_bs) + (rib & ((1 << log_bs) - 1));
    const int tq = log_tl - log_g;
    smp = (bb << (3 - log_bs)) + (rib >> log_bs);
    sym = sym0 + (v >> tq) + ((v & ((1 << tq) - 1)) << log_g);
  }
};

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
// 0 .. of j (despread). despread_boxes takes the boxes' layout: pair
// (symbol bit 0 is e), quad (bits 1 and 2 are lane bits 0 and 1), then
// jbits bits of j; with boxes of one symbol every symbol bit is in j.
__device__ __forceinline__ void despread_boxes(float (&d)[64], bool pair,
                                               bool quad, int jbits,
                                               int lane) {
  if (pair) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float a = d[i], b = d[i + 1];
      d[i] = a + b;
      d[i + 1] = a - b;
    }
  }
  if (quad) {
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

__device__ __forceinline__ void despread(float (&d)[64], int log_loc,
                                         int lane) {
  const int log_bs = box_log_symbols(log_loc);
  despread_boxes(d, log_loc >= 1, log_bs == 3, log_loc - log_bs, lane);
}

// The 16 bytes at byte offset db (0 .. 15) of the 32 bytes a, b.
__device__ __forceinline__ uint4 shift16(uint4 a, uint4 b, int db) {
  uint32_t w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w, w4 = b.x, w5 = b.y,
           w6 = b.z, w7 = b.w;
  if (db & 8) {
    w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7;
  }
  if (db & 4) {
    w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5;
  }
  const int sh = (db & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// The shifted layout: a shifter's share (t = 0 .. 95, warps 1-3 of the
// producer warpgroup) of a stage whose 128 rows were loaded unswizzled
// from an aligned start (st + 128 row, the next 16 bytes at sd + 16 row):
// 16-byte chunk c of row `row` is the row shifted by off(box) bytes,
// handed to put(row, slot, chunk) with slot = c ^ (row & 7), its place in
// the SW128 layout. A warp takes 4 rows at a time, 8 lanes a row; every
// lane of the warp reads before any writes.
template <class Off, class Put>
__device__ __forceinline__ void shift_stage(const unsigned char* st,
                                            const unsigned char* sd, int t,
                                            Off off, Put put) {
  const int lane = t & 31, c = lane & 7;
  for (int r4 = t >> 5; r4 < TILE / 4; r4 += SHIFTERS / 32) {
    const int row = 4 * r4 + (lane >> 3);
    const uint4 a = *reinterpret_cast<const uint4*>(st + 128 * row + 16 * c);
    const uint4 b = c < 7 ? *reinterpret_cast<const uint4*>(
                                st + 128 * row + 16 * (c + 1))
                          : *reinterpret_cast<const uint4*>(sd + 16 * row);
    const uint4 v = shift16(a, b, off(row >> 3));
    __syncwarp();
    put(row, c ^ (row & 7), v);
  }
}

// The tile body (ls_body below). ma: 4-d map of the planes (sym_len,
// loc, S, 2), box KB x bs x 8/bs x 1, SW128; mb: 2-d map (as 3-d, one
// plane) of the permuted Bt (2*fft, 2*cpad rows), box KB x 128, SW128
// (make_maps). loc = 2^log_loc <= 128 with NH = 1; or, with NH = 0, any loc <= 256 and the map (sym_len g, loc / g, S, 2) of
// make_maps(..., log_g), g = 2^log_g <= min(loc, 128),
// whose box holds 2^box_log(log_tl, log_g) of a row's symbols; or, with
// NH = 0 and `parts`, loc = 512 .. 2048 and the map of the part
// transform's Z (ls_parts.cu: sym_len = fft, cp = 0, log_g = 0). fft % 64
// == 0, 2*fft <= KMAX. The two consumer warpgroups
// take the cluster's tiles in turns: warpgroup w the tiles u = w, w + 2,
// ... of the cluster's sequence, all 128 rows and all 128 columns of
// each. After a tile's products and despread each of its threads calls
//
//   epi.template store<NH>(acc0, acc1, s0, sym0, warp, lane, stg, bar, rows)
//
// with acc0 / acc1 the real / imaginary set, s0 the tile's first sample
// and sym0 its first output symbol (0 with NH = 1, row_coords over loc
// symbols giving the rest; with NH = 0, 128 * part or 0, and rows.at
// gives sample and symbol), the block's
// carriers starting at 64 *
// cluster rank, and the warpgroup's two staging buffers (stg, 2 x
// STG_FLOATS) and named barrier (bar, 128 threads) for an epilogue that
// stages its stores. Launch through launch(); nothing may follow the call in
// the kernel (the producer and consumer paths never rejoin).
template <int NH, class Epi>
__device__ __forceinline__ void ls_body_tiles(const CUtensorMap* ma,
                                              const CUtensorMap* mb, int S,
                                              int log_loc, int fft, int cp,
                                              Epi& epi, int sym_len,
                                              int log_g,
                                              const CUtensorMap* ms,
                                              bool parts) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;    // the resident Bt slab
  const uint32_t ring = sb + B_BYTES;
  const uint32_t stg = ring + STAGES * STAGE_BYTES;   // 2 per warpgroup
  const uint32_t full = stg + 4 * STG_FLOATS * 4;     // STAGES x 8 bytes
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t bfull = empty + 8 * STAGES;
  const uint32_t done = bfull + 8;                    // 2 x 8 bytes
  // the shifted layout (NH = 0, map rows of several symbols): a ring of
  // nst = STAGES - 1 stages, the last stage's room holding their second
  // boxes (SIDE_BYTES each) and `ready` barriers (the consumers' wait)
  const bool shift = NH == 0 && log_g > 0;
  const int nst = shift ? STAGES - 1 : STAGES;
  const uint32_t side = ring + (STAGES - 1) * STAGE_BYTES;
  const uint32_t ready = side + (STAGES - 1) * SIDE_BYTES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cl = cluster_ctas();
  const int cid = cluster_index(), ncl = cluster_count();
  // a tile: 2^log_tl symbols of 2^log_spt samples, or part t % nh of
  // sample t / nh; its k-steps run over the nh symbol parts of 128
  static_assert(NH == 0 || NH == 1, "one 128-symbol half a tile, or 0: "
                                     "any at run time");
  const int log_nh = log_loc > 7 ? log_loc - 7 : 0;  // NH = 0 only
  const int nh = NH ? NH : 1 << log_nh;
  const int log_tl = NH == 1 ? log_loc : (log_nh ? 7 : log_loc);
  const int log_bs = box_log(log_tl, log_g);      // NH = 0 only
  const int NK0 = 2 * fft / KB;                   // k-steps of a half
  // symbol parts a tile's k-steps run over: one of Z with `parts`
  const int nrun = parts ? 1 : nh;
  const int NK = nrun * NK0;                      // k-steps of a tile
  const int log_spt = 7 - log_tl;                 // samples of a tile
  const int T = tiles(S, log_loc);
  auto sample = [&](int t) {                      // the tile's sample
    if constexpr (NH == 0) return t >> log_nh;
    else return t / NH;
  };
  auto part = [&](int t) {                        // its part of it
    if constexpr (NH == 0) return t & ((1 << log_nh) - 1);
    else return t % NH;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
      // the consuming warpgroup of every block: each stage holds boxes
      // multicast by all of them
      mbar_init(empty + 8 * s, cl);
    }
    if (shift)
      for (int s = 0; s < nst; ++s) mbar_init(ready + 8 * s, SHIFTERS);
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
      const int lbs = NH ? box_log_symbols(log_tl) : log_bs;
      const int nsb = log_tl - lbs;          // log2 of symbol blocks
      const int boxes = 16 / cl;             // boxes a block loads a stage
      const uint16_t all = (uint16_t)((1u << cl) - 1);
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        const int s0 = sample(t) << log_spt;  // the tile's first sample
        for (int i = 0; i < nrun; ++i)
        for (int k0 = 0; k0 < NK0; ++k0, ++it) {
          const int half = parts ? part(t) : i;
          const int s = it % nst;
          mbar_wait(empty + 8 * s, ((it / nst) & 1) ^ 1);
          const int plane = k0 >= NK0 / 2;
          const int col = cp + (k0 - plane * (NK0 / 2)) * KB;
          mbar_expect_tx(full + 8 * s,
                         STAGE_BYTES + (shift ? SIDE_BYTES : 0));
          for (int q = 0; q < boxes; ++q) {
            const int g = rank * boxes + q;  // box g: tile rows 8g ..
            const int a = g & ((1 << nsb) - 1), bb = g >> nsb;
            if constexpr (NH == 0) {
              // rotated symbols v .. of part `half`: symbol m + 2^log_g q
              // of the part, map row q of it, at m's offset o in the row
              // (shifted: from o rounded down to 8, and 8 more beside)
              const int v = a << lbs, tq = log_tl - log_g;
              const int o = (v >> tq) * sym_len + col;
              const int c1 = (half << (7 - log_g)) + (v & ((1 << tq) - 1));
              const int c2 = s0 + (bb << (3 - lbs));
              tma_load_4d_multicast(ring + s * STAGE_BYTES + g * 1024, ma,
                                    full + 8 * s, shift ? o & ~7 : o, c1, c2,
                                    plane, all);
              if (shift)
                tma_load_4d_multicast(side + s * SIDE_BYTES + g * 128, ms,
                                      full + 8 * s, (o & ~7) + KB, c1, c2,
                                      plane, all);
            } else {
              tma_load_4d_multicast(
                  ring + s * STAGE_BYTES + g * 1024, ma, full + 8 * s, col,
                  (a << lbs) + (half << 7), s0 + (bb << (3 - lbs)),
                  plane, all);
            }
          }
        }
      }
      // stay until every block of the cluster has released each stage's
      // last use: no block may exit while another still arrives on its
      // barriers or multicasts into it
      for (int j = 0; j < nst; ++j, ++it)
        mbar_wait(empty + 8 * (it % nst), ((it / nst) & 1) ^ 1);
    } else if (shift && tid >= 32) {
      // the shifters: every k-step of the cluster's tiles, in the ring's
      // order; a stage cannot land again before the consumers, who wait
      // for its `ready`, release it
      const int n = (T - cid + ncl - 1) / ncl * NK;
      const int tq = log_tl - log_g;
      for (int it = 0; it < n; ++it) {
        const int s = it % nst, k0 = it % NK0;
        const int col = cp + (k0 % (NK0 / 2)) * KB;
        mbar_wait(full + 8 * s, (it / nst) & 1);
        unsigned char* st = smem_raw + (ring + s * STAGE_BYTES - raw);
        if (!(LS_CUT & 8))
          shift_stage(
              st, smem_raw + (side + s * SIDE_BYTES - raw), tid - 32,
              [&](int g) {
                const int v = (g & ((1 << (log_tl - log_bs)) - 1))
                              << log_bs;
                return (((v >> tq) * sym_len + col) & 7) * 2;
              },
              [&](int row, int slot, uint4 x) {
                *reinterpret_cast<uint4*>(st + 128 * row + 16 * slot) = x;
              });
        fence_proxy_async();
        mbar_arrive(ready + 8 * s);
      }
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
        mbar_arrive_cluster(empty + 8 * (i % nst), c);
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
    for (int i = 0; i < nrun; ++i)
    for (int k0 = 0; k0 < NK0; ++k0) {
      const int it = u * NK + i * NK0 + k0;
      const int s = it % nst;
      mbar_wait((shift ? ready : full) + 8 * s, (it / nst) & 1);
      const uint32_t a = sb + k0 * KBLOCK_BYTES;
      const uint32_t b = ring + s * STAGE_BYTES;
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
      if (!(LS_CUT & 1)) {
        // symbol part i enters output part p = part(t) with the sign
        // H_nh[p, i] = (-1)^popcount(p & i); Z_p with +1
        if (NH == 0 && !parts && __popc(part(t) & i) & 1) {
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
      if constexpr (NH == 0) {
        despread_boxes(acc0, log_bs >= 1, log_bs == 3, log_tl - log_bs,
                       lane);
        despread_boxes(acc1, log_bs >= 1, log_bs == 3, log_tl - log_bs,
                       lane);
      } else {
        despread(acc0, log_tl, lane);
        despread(acc1, log_tl, lane);
      }
    }
    epi.template store<NH>(acc0, acc1, sample(t) << log_spt, part(t) << 7,
                           warp, lane,
              reinterpret_cast<float*>(smem_raw + (stg - raw)) +
                  2 * STG_FLOATS * w,
              1 + w, Rows{log_tl, log_bs, log_g, part(t) << 7});
  }
}

// A k-step of ls_body_halves: k-step it of the cluster's sequence (its
// stage it % STAGES) against the slab's k-block at a, 4 products into z;
// then the stage is released in every block of the cluster.
__device__ __forceinline__ void halves_kstep(float (&z)[64], int it,
                                             uint32_t a, uint32_t ring,
                                             uint32_t full, uint32_t empty,
                                             int tid, int cl) {
  const int s = it % STAGES;
  mbar_wait(full + 8 * s, (it / STAGES) & 1);
  const uint32_t b = ring + s * STAGE_BYTES;
  fence_acc(z);
  wgmma_fence();
  if (!(LS_CUT & 1)) {
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      wgmma_m64n128k16<1>(z, desc_sw128(a + kk * 32),
                          desc_sw128(b + kk * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(z);
  if (tid == 0)
    for (int c = 0; c < cl; ++c) mbar_arrive_cluster(empty + 8 * s, c);
}

// ls_body_halves' swap: x's values into this warpgroup's staging buffers
// (mine, 2 x STG_FLOATS), the other's (other) at the same fragment places
// into x, in two rounds of 32 values a thread (float4 q of a round at q *
// 128 + tid: no bank conflict) between 256-thread barriers (named
// barrier 3). First the warpgroup's own barrier (1 + w): its last
// epilogue has read its staging buffers.
__device__ __forceinline__ void swap_halves(float (&x)[64], float* mine,
                                            const float* other, int w,
                                            int tid) {
  bar_sync(1 + w, 128);
  float4* const m4 = reinterpret_cast<float4*>(mine);
  const float4* const o4 = reinterpret_cast<const float4*>(other);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      m4[q * 128 + tid] =
          make_float4(x[32 * r + 4 * q], x[32 * r + 4 * q + 1],
                      x[32 * r + 4 * q + 2], x[32 * r + 4 * q + 3]);
    bar_sync(3, 256);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = o4[q * 128 + tid];
      x[32 * r + 4 * q] = v.x;
      x[32 * r + 4 * q + 1] = v.y;
      x[32 * r + 4 * q + 2] = v.z;
      x[32 * r + 4 * q + 3] = v.w;
    }
    bar_sync(3, 256);            // both have read before either writes
  }
}

// ls_body_halves' loads of one k-step: k-step k0 (of NK0, K columns
// each) of symbol half i of sample t, the block's 16 / cl boxes (box g:
// stage rows 8g .. 8g + 7, symbols 8g .. of the half) into the stage at
// st, multicast to the cluster, completing on bar.
__device__ __forceinline__ void halves_load(uint32_t st, const CUtensorMap* ma,
                                            uint32_t bar, int k0, int NK0,
                                            int K, int cp, int i, int t,
                                            uint32_t rank, int cl) {
  const int plane = k0 >= NK0 / 2;
  const int col = cp + (k0 - plane * (NK0 / 2)) * K;
  const int boxes = 16 / cl;                 // boxes a block loads a stage
  const uint16_t all = (uint16_t)((1u << cl) - 1);
  for (int q = 0; q < boxes; ++q) {
    const int g = rank * boxes + q;
    tma_load_4d_multicast(st + g * 1024, ma, bar, col, 8 * g + (i << 7), t,
                          plane, all);
  }
}

// ls_body_halves' consumers, warpgroup w = 0 (real) or 1 (imaginary) of
// the block: for the cluster's u-th sample t, z_lo over its k-steps 2u
// NK0 .. and z_hi over the next NK0 (kstep(z, it, k0): k-step it of the
// cluster's sequence, k0 of its half, products into z), then h_0 = z_lo
// + z_hi and h_1 = z_lo - z_hi and each one's despread; warpgroup 0 hands
// h_1's real part to warpgroup 1 for h_0's imaginary part, through their
// staging buffers (base: 2 x STG_FLOATS a warpgroup; 32 KB, two rounds of
// 16 KB each way, between 256-thread barriers), and warpgroup w calls
// epi.store<2> for half a = w (sym0 = 128 w), as ls_body_tiles calls it
// for a tile.
template <class Epi, class KStep>
__device__ __forceinline__ void halves_consume(int S, int NK0, float* base,
                                               Epi& epi, KStep&& kstep) {
  const int w = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int cid = cluster_index(), ncl = cluster_count();
  float* const mine = base + 2 * STG_FLOATS * w;
  const float* const other = base + 2 * STG_FLOATS * (1 - w);
  for (int u = 0, t = cid; t < S; ++u, t += ncl) {
    float lo[64], hi[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) lo[i] = hi[i] = 0.f;
    for (int k0 = 0; k0 < NK0; ++k0) kstep(lo, 2 * u * NK0 + k0, k0);
    for (int k0 = 0; k0 < NK0; ++k0) kstep(hi, (2 * u + 1) * NK0 + k0, k0);
    if (!(LS_CUT & 2)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float l = lo[i], h = hi[i];
        lo[i] = l + h;                  // h_0
        hi[i] = l - h;                  // h_1
      }
      despread(lo, 7, lane);
      despread(hi, 7, lane);
    }
    // warpgroup 0: (h_0 real, h_1 real) -> (h_0 real, h_0 imaginary);
    // warpgroup 1: (h_0 imaginary, h_1 imaginary) -> (h_1 real, h_1
    // imaginary)
    if (w == 0)
      swap_halves(hi, mine, other, w, tid);
    else
      swap_halves(lo, mine, other, w, tid);
    epi.template store<2>(lo, hi, t, w << 7, warp, lane, mine, 1 + w,
                          Rows{7, 3, 0, w << 7});
  }
}

// The body at loc = 256 (NH = 2; see the header): maps as ls_body_tiles'
// at log_loc = 8. One sample a unit, cluster c the samples c, c + (number
// of clusters), ...; per sample 2 NK0 k-steps, symbol half i = 0 then 1
// (halves_load). Warpgroup w takes the slab's set w of every stage (4
// products a k-step); a stage is released by both warpgroups of every
// block of the cluster; halves_consume combines, despreads and stores.
template <class Epi>
__device__ __forceinline__ void ls_body_halves(const CUtensorMap* ma,
                                               const CUtensorMap* mb, int S,
                                               int fft, int cp, Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;    // the resident Bt slab
  const uint32_t ring = sb + B_BYTES;
  const uint32_t stg = ring + STAGES * STAGE_BYTES;   // 2 per warpgroup
  const uint32_t full = stg + 4 * STG_FLOATS * 4;     // STAGES x 8 bytes
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t bfull = empty + 8 * STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cl = cluster_ctas();
  const int cid = cluster_index(), ncl = cluster_count();
  const int NK0 = 2 * fft / KB;                   // k-steps of a half

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
      // both consumer warpgroups of every block of the cluster
      mbar_init(empty + 8 * s, 2 * cl);
    }
    mbar_init(bfull, 1);
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
      int it = 0;
      for (int t = cid; t < S; t += ncl)
        for (int i = 0; i < 2; ++i)
          for (int k0 = 0; k0 < NK0; ++k0, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, STAGE_BYTES);
            halves_load(ring + s * STAGE_BYTES, ma, full + 8 * s, k0, NK0,
                        KB, cp, i, t, rank, cl);
          }
      // stay until every block of the cluster has released each stage's
      // last use
      for (int j = 0; j < STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % STAGES), ((it / STAGES) & 1) ^ 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the warpgroup's set of the slab
  const uint32_t aset = sb + (wg - 1) * (KBLOCK_BYTES / 2);
  mbar_wait(bfull, 0);
  halves_consume(S, NK0, reinterpret_cast<float*>(smem_raw + (stg - raw)),
                 epi, [&](float (&z)[64], int it, int k0) {
                   halves_kstep(z, it, aset + k0 * KBLOCK_BYTES, ring, full,
                                empty, tid, cl);
                 });
}

// The LS body: ls_body_halves at NH = 2, else ls_body_tiles.
template <int NH, class Epi>
__device__ __forceinline__ void ls_body(const CUtensorMap* ma,
                                        const CUtensorMap* mb, int S,
                                        int log_loc, int fft, int cp,
                                        Epi& epi, int sym_len = 0,
                                        int log_g = 0,
                                        const CUtensorMap* ms = nullptr,
                                        bool parts = false) {
  if constexpr (NH == 2)
    ls_body_halves(ma, mb, S, fft, cp, epi);
  else
    ls_body_tiles<NH>(ma, mb, S, log_loc, fft, cp, epi, sym_len, log_g, ms,
                      parts);
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
// answers are those of a split in the consumer, bit for bit. At loc 256
// (NH = 2) the consumers take one sample together, a set each
// (ls_body_f32_halves, as ls_body_halves): the Nt 256 products, 3 TF32
// passes each, are then single (PERF.md).
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

// ls_body_tiles for float32 planes at NH = 0 and 1 (NH = 2 runs
// ls_body_f32_halves): ma a 4-d FLOAT32 map of the planes (box KF x bs x
// 8/bs x 1, SW128), mb a 3-d FLOAT32 map of the split constants (2*fft,
// 2*cpad rows, 2 parts; box KF x 128 x 1) (make_maps_f32). The tiles,
// the ping-pong of the consumer warpgroups and the call of epi.store are
// those of ls_body_tiles; launch with launch<F_SMEM_BYTES>.
template <int NH, class Epi>
__device__ __forceinline__ void ls_body_f32_tiles(const CUtensorMap* ma,
                                                  const CUtensorMap* mb,
                                                  int S, int log_loc, int fft,
                                                  int cp, Epi& epi,
                                                  int sym_len, int log_g,
                                                  const CUtensorMap* ms,
                                                  bool parts) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t stg = ring + F_STAGES * F_STAGE_BYTES;  // 2 per warpgroup
  const uint32_t full = stg + 4 * STG_FLOATS * 4;        // F_STAGES x 8
  const uint32_t split = full + 8 * F_STAGES;            // F_STAGES x 8
  const uint32_t empty = split + 8 * F_STAGES;
  const uint32_t done = empty + 8 * F_STAGES;            // 2 x 8 bytes
  // the shifted layout (ls_body): a ring of F_STAGES - 1 stages, the
  // last stage's room holding their second boxes; the splitters shift
  // and split in one pass
  const bool shift = NH == 0 && log_g > 0;
  const int nst = shift ? F_STAGES - 1 : F_STAGES;
  const uint32_t side = ring + (F_STAGES - 1) * F_STAGE_BYTES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cl = cluster_ctas();
  const int cid = cluster_index(), ncl = cluster_count();
  static_assert(NH == 0 || NH == 1, "one 128-symbol half a tile, or 0: "
                                     "any at run time");
  const int log_nh = log_loc > 7 ? log_loc - 7 : 0;  // NH = 0 only
  const int nh = NH ? NH : 1 << log_nh;
  const int log_tl = NH == 1 ? log_loc : (log_nh ? 7 : log_loc);
  const int log_bs = box_log(log_tl, log_g);      // NH = 0 only
  const int NK0 = 2 * fft / KF;                   // k-steps of a half
  // symbol parts a tile's k-steps run over: one of Z with `parts`
  const int nrun = parts ? 1 : nh;
  const int NK = nrun * NK0;                      // k-steps of a tile
  const int log_spt = 7 - log_tl;
  const int T = tiles(S, log_loc);
  auto sample = [&](int t) {
    if constexpr (NH == 0) return t >> log_nh;
    else return t / NH;
  };
  auto part = [&](int t) {
    if constexpr (NH == 0) return t & ((1 << log_nh) - 1);
    else return t % NH;
  };

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
      const int lbs = NH ? box_log_symbols(log_tl) : log_bs;
      const int nsb = log_tl - lbs;
      const int boxes = 16 / cl;
      const uint16_t all = (uint16_t)((1u << cl) - 1);
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        const int s0 = sample(t) << log_spt;
        for (int i = 0; i < nrun; ++i)
        for (int k0 = 0; k0 < NK0; ++k0, ++it) {
          const int half = parts ? part(t) : i;
          const int s = it % nst;
          const uint32_t st = ring + s * F_STAGE_BYTES;
          mbar_wait(empty + 8 * s, ((it / nst) & 1) ^ 1);
          if (LS_CUT & 32) {
            mbar_arrive(full + 8 * s);
            continue;
          }
          const int plane = k0 >= NK0 / 2;
          const int col = cp + (k0 - plane * (NK0 / 2)) * KF;
          mbar_expect_tx(full + 8 * s,
                         F_LOAD_BYTES + (shift ? SIDE_BYTES : 0));
          for (int q = 0; q < boxes; ++q) {
            const int g = rank * boxes + q;
            const int a = g & ((1 << nsb) - 1), bb = g >> nsb;
            if constexpr (NH == 0) {
              const int v = a << lbs, tq = log_tl - log_g;
              const int o = (v >> tq) * sym_len + col;
              const int c1 = (half << (7 - log_g)) + (v & ((1 << tq) - 1));
              const int c2 = s0 + (bb << (3 - lbs));
              tma_load_4d_multicast(st + g * 1024, ma, full + 8 * s,
                                    shift ? o & ~3 : o, c1, c2, plane, all);
              if (shift)
                tma_load_4d_multicast(side + s * SIDE_BYTES + g * 128, ms,
                                      full + 8 * s, (o & ~3) + KF, c1, c2,
                                      plane, all);
            } else {
              tma_load_4d_multicast(
                  st + g * 1024, ma, full + 8 * s, col,
                  (a << lbs) + (half << 7), s0 + (bb << (3 - lbs)),
                  plane, all);
            }
          }
          // the block's 128 rows of the constants' k-step, both parts
          const uint32_t c = st + 2 * F_X_BYTES;
          tma_load_3d(c, mb, full + 8 * s, k0 * KF, rank * 128, 0);
          tma_load_3d(c + F_B_BYTES, mb, full + 8 * s, k0 * KF, rank * 128,
                      1);
        }
      }
      for (int j = 0; j < nst; ++j, ++it)
        mbar_wait(empty + 8 * (it % nst), ((it / nst) & 1) ^ 1);
    } else if (tid >= 32) {
      // the splitters: every k-step of the cluster's tiles, in the ring's
      // order; a stage cannot land again before its split has been
      // consumed, so the parity waits cannot mistake an earlier pass
      const int n = (T - cid + ncl - 1) / ncl * NK;
      for (int it = 0; it < n; ++it) {
        const int s = it % nst;
        const uint32_t st = ring + s * F_STAGE_BYTES;
        mbar_wait(full + 8 * s, (it / nst) & 1);
        if (shift && !(LS_CUT & 8)) {
          // shift and split: the high part in place, the low part beside
          const int k0 = it % NK0, tq = log_tl - log_g;
          const int col = cp + (k0 % (NK0 / 2)) * KF;
          unsigned char* x = smem_raw + (st - raw);
          shift_stage(
              x, smem_raw + (side + s * SIDE_BYTES - raw), tid - 32,
              [&](int g) {
                const int v = (g & ((1 << (log_tl - log_bs)) - 1))
                              << log_bs;
                return (((v >> tq) * sym_len + col) & 3) * 4;
              },
              [&](int row, int slot, uint4 w) {
                const float4 f = *reinterpret_cast<const float4*>(&w);
                float4 h, l;
                h.x = tf32_rna(f.x);
                h.y = tf32_rna(f.y);
                h.z = tf32_rna(f.z);
                h.w = tf32_rna(f.w);
                l.x = tf32_rna_lo(f.x - h.x);
                l.y = tf32_rna_lo(f.y - h.y);
                l.z = tf32_rna_lo(f.z - h.z);
                l.w = tf32_rna_lo(f.w - h.w);
                const int at = 128 * row + 16 * slot;
                *reinterpret_cast<float4*>(x + at) = h;
                *reinterpret_cast<float4*>(x + F_X_BYTES + at) = l;
              });
        } else if (!shift && !(LS_CUT & 8)) {
          split_stage(reinterpret_cast<float4*>(smem_raw + (st - raw)),
                      reinterpret_cast<float4*>(smem_raw +
                                                (st + F_X_BYTES - raw)),
                      tid - 32);
        }
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
        mbar_arrive_cluster(empty + 8 * (i % nst), c);
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
    for (int i = 0; i < nrun; ++i)
    for (int k0 = 0; k0 < NK0; ++k0) {
      const int it = u * NK + i * NK0 + k0;
      const int s = it % nst;
      const uint32_t st = ring + s * F_STAGE_BYTES;
      mbar_wait(split + 8 * s, (it / nst) & 1);
      // tile u's last stage is taken: the other warpgroup may start
      if (i == nrun - 1 && k0 == NK0 - 1 && tid == 0)
        mbar_arrive(done + 8 * w);
      const uint32_t lo = st + F_X_BYTES;
      const uint32_t ah = st + 2 * F_X_BYTES, al = ah + F_B_BYTES;
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
      if (!(LS_CUT & 1)) {
        // symbol part i enters output part p = part(t) with the sign
        // H_nh[p, i] = (-1)^popcount(p & i); Z_p with +1
        if (NH == 0 && !parts && __popc(part(t) & i) & 1) {
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
      if constexpr (NH == 0) {
        despread_boxes(acc0, log_bs >= 1, log_bs == 3, log_tl - log_bs,
                       lane);
        despread_boxes(acc1, log_bs >= 1, log_bs == 3, log_tl - log_bs,
                       lane);
      } else {
        despread(acc0, log_tl, lane);
        despread(acc1, log_tl, lane);
      }
    }
    epi.template store<NH>(acc0, acc1, sample(t) << log_spt, part(t) << 7,
                           warp, lane,
                           reinterpret_cast<float*>(smem_raw + (stg - raw)) +
                               2 * STG_FLOATS * w,
                           1 + w, Rows{log_tl, log_bs, log_g, part(t) << 7});
  }
}

// A k-step of ls_body_f32_halves: k-step it of the cluster's sequence,
// its stage st (split: the input's TF32 high part in place, the low part
// F_X_BYTES on; the constants' two parts after them, the set's 64 rows
// at set * F_B_BYTES / 2), 4 x 3 TF32 products into z; then the stage is
// released in every block of the cluster.
__device__ __forceinline__ void f32_halves_kstep(float (&z)[64], int it,
                                                 uint32_t ring, int set,
                                                 uint32_t split,
                                                 uint32_t empty, int tid,
                                                 int cl) {
  const int s = it % F_STAGES;
  const uint32_t st = ring + s * F_STAGE_BYTES;
  mbar_wait(split + 8 * s, (it / F_STAGES) & 1);
  const uint32_t lo = st + F_X_BYTES;
  const uint32_t ah = st + 2 * F_X_BYTES + set * (F_B_BYTES / 2);
  const uint32_t al = ah + F_B_BYTES;
  fence_acc(z);
  wgmma_fence();
  if (!(LS_CUT & 1)) {
#pragma unroll
    for (int kk = 0; kk < KF / 8; ++kk)
      wgmma_3xtf32<1>(z, desc_sw128(ah + kk * 32), desc_sw128(al + kk * 32),
                      desc_sw128(st + kk * 32), desc_sw128(lo + kk * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(z);
  if (tid == 0)
    for (int c = 0; c < cl; ++c) mbar_arrive_cluster(empty + 8 * s, c);
}

// ls_body_halves for float32 planes (maps as ls_body_f32_tiles' at
// log_loc = 8): one sample a unit, its stages loaded by halves_load with
// the constants' k-step beside, warpgroup w set w of the constants' rows
// from the same split stages (halves_consume: the sums, the despread, the
// swap and the stores of ls_body_halves). The splitters (warps 1-3 of
// the producer warpgroup) split every stage as in ls_body_f32_tiles.
template <class Epi>
__device__ __forceinline__ void ls_body_f32_halves(const CUtensorMap* ma,
                                                   const CUtensorMap* mb,
                                                   int S, int fft, int cp,
                                                   Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t stg = ring + F_STAGES * F_STAGE_BYTES;  // 2 per warpgroup
  const uint32_t full = stg + 4 * STG_FLOATS * 4;        // F_STAGES x 8
  const uint32_t split = full + 8 * F_STAGES;            // F_STAGES x 8
  const uint32_t empty = split + 8 * F_STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cl = cluster_ctas();
  const int cid = cluster_index(), ncl = cluster_count();
  const int NK0 = 2 * fft / KF;                   // k-steps of a half
  const int NK = 2 * NK0;                         // k-steps of a sample

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(split + 8 * s, F_SPLITTERS);
      // both consumer warpgroups of every block of the cluster
      mbar_init(empty + 8 * s, 2 * cl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int t = cid; t < S; t += ncl)
        for (int i = 0; i < 2; ++i)
          for (int k0 = 0; k0 < NK0; ++k0, ++it) {
            const int s = it % F_STAGES;
            const uint32_t st = ring + s * F_STAGE_BYTES;
            mbar_wait(empty + 8 * s, ((it / F_STAGES) & 1) ^ 1);
            if (LS_CUT & 32) {
              mbar_arrive(full + 8 * s);
              continue;
            }
            mbar_expect_tx(full + 8 * s, F_LOAD_BYTES);
            halves_load(st, ma, full + 8 * s, k0, NK0, KF, cp, i, t, rank,
                        cl);
            // the block's 128 rows of the constants' k-step, both parts
            const uint32_t c = st + 2 * F_X_BYTES;
            tma_load_3d(c, mb, full + 8 * s, k0 * KF, rank * 128, 0);
            tma_load_3d(c + F_B_BYTES, mb, full + 8 * s, k0 * KF,
                        rank * 128, 1);
          }
      for (int j = 0; j < F_STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % F_STAGES), ((it / F_STAGES) & 1) ^ 1);
    } else if (tid >= 32) {
      // the splitters: every k-step of the cluster's samples, in order
      const int n = (S - cid + ncl - 1) / ncl * NK;
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
  halves_consume(S, NK0, reinterpret_cast<float*>(smem_raw + (stg - raw)),
                 epi, [&](float (&z)[64], int it, int) {
                   f32_halves_kstep(z, it, ring, wg - 1, split, empty, tid,
                                    cl);
                 });
}

// The float32 LS body: ls_body_f32_halves at NH = 2, else
// ls_body_f32_tiles.
template <int NH, class Epi>
__device__ __forceinline__ void ls_body_f32(const CUtensorMap* ma,
                                            const CUtensorMap* mb, int S,
                                            int log_loc, int fft, int cp,
                                            Epi& epi, int sym_len = 0,
                                            int log_g = 0,
                                            const CUtensorMap* ms = nullptr,
                                            bool parts = false) {
  if constexpr (NH == 2)
    ls_body_f32_halves(ma, mb, S, fft, cp, epi);
  else
    ls_body_f32_tiles<NH>(ma, mb, S, log_loc, fft, cp, epi, sym_len, log_g,
                          ms, parts);
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

// The input's map of an LS kernel: S samples of loc = 2^log_loc symbols
// of sym_len elements of esize bytes, two planes, 16-byte aligned; a row
// of the map spans 2^log_g symbols (group_log; 0 for the NH = 1 and 2
// bodies), box `box0` elements x bs rows x 8/bs samples x 1, bs =
// 2^box_log(min(log_loc, 7), log_g) (that of box_log_symbols at log_g =
// 0); returns 0 or ERR_TENSOR_MAP.
inline int make_input_map(CUtensorMap* ma, CUtensorMapDataType type,
                          int esize, int box0, const void* planes, int S,
                          int log_loc, int sym_len, int log_g,
                          CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const int bs = 1 << box_log(log_loc < 7 ? log_loc : 7, log_g);
  const cuuint64_t loc = 1ull << log_loc;
  const cuuint64_t row = (cuuint64_t)sym_len * esize;  // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)sym_len << log_g, loc >> log_g,
                              (cuuint64_t)S, 2};
  const cuuint64_t strides[3] = {row << log_g, row * loc, row * loc * S};
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)bs,
                             (cuuint32_t)(8 / bs), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(ma, type, 4, const_cast<void*>(planes), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// The maps of the planes: ma, box `box0` elements, SW128, or with log_g
// > 0 (the shifted layout) unswizzled, and ms the second boxes beside it
// (16 bytes); returns 0 or ERR_TENSOR_MAP.
inline int make_planes_maps(CUtensorMap* ma, CUtensorMap* ms,
                            CUtensorMapDataType type, int esize, int box0,
                            const void* planes, int S, int log_loc,
                            int sym_len, int log_g) {
  if (log_g == 0)
    return make_input_map(ma, type, esize, box0, planes, S, log_loc, sym_len,
                          0, CU_TENSOR_MAP_SWIZZLE_128B);
  if (ms == nullptr ||
      make_input_map(ms, type, esize, 16 / esize, planes, S, log_loc,
                     sym_len, log_g, CU_TENSOR_MAP_SWIZZLE_NONE))
    return ERR_TENSOR_MAP;
  return make_input_map(ma, type, esize, box0, planes, S, log_loc, sym_len,
                        log_g, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The tensor maps of an LS kernel (planes: S samples of loc symbols of
// sym_len bf16, two planes, 16-byte aligned, rows of 2^log_g symbols, ms
// their second boxes where log_g > 0; bt: the permuted constants);
// returns 0 or ERR_TENSOR_MAP.
inline int make_maps(CUtensorMap* ma, CUtensorMap* mb, const void* planes,
                     const void* bt, int S, int log_loc, int sym_len,
                     int fft, int cpad, int log_g = 0,
                     CUtensorMap* ms = nullptr) {
  if (make_planes_maps(ma, ms, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, KB,
                       planes, S, log_loc, sym_len, log_g))
    return ERR_TENSOR_MAP;
  return make_map(mb, bt, 2 * fft, 2 * cpad, 1, 128, 2 * fft);
}


// make_maps for ls_body_f32: the planes as FLOAT32 (S samples of loc
// symbols of sym_len f32, two planes, 16-byte aligned, rows of 2^log_g
// symbols), box KF x bs x 8/bs x 1; bt32 the split constants (2, 2*cpad,
// 2*fft) f32, box KF x 128 x 1. Returns 0 or ERR_TENSOR_MAP.
inline int make_maps_f32(CUtensorMap* ma, CUtensorMap* mb, const void* planes,
                         const void* bt32, int S, int log_loc, int sym_len,
                         int fft, int cpad, int log_g = 0,
                         CUtensorMap* ms = nullptr) {
  if (make_planes_maps(ma, ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, KF,
                       planes, S, log_loc, sym_len, log_g))
    return ERR_TENSOR_MAP;
  return make_map_f32(mb, bt32, 2 * fft, 2 * cpad, 2, 128, 2 * fft);
}

// The symbol layout an LS launch needs: log_g (group_log of sym_len at
// esize bytes) and whether the NH = 0 body runs it (a group, or `parts`).
// Returns false for shapes no body takes: loc above 256 without the part
// transform's input (`parts`, loc 512 .. 2048, aligned rows), `parts`
// below 512, or a group of more symbols than a tile holds of a sample.
inline bool layout(int log_loc, int sym_len, int esize, bool parts,
                   int& log_g, bool& general) {
  log_g = group_log(sym_len, esize);
  general = parts || log_g > 0;
  if (parts) return log_loc >= 9 && log_loc <= 11 && log_g == 0;
  return log_loc <= 8 && log_g <= (log_loc < 7 ? log_loc : 7);
}

}  // namespace ls90
}  // namespace mamimo
