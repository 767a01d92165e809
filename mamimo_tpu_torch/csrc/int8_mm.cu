// int8 GEMM with int32 accumulation on Hopper: TMA into an mbarrier ring
// fed by a producer thread, and wgmma m64nNk32.s32.s8.s8 (IGMMA).
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/int8_mm.py::matmul_pallas
// (body _mm_kernel), int8 mode: C = A @ B, A (M, K) s8, B (K, N) s8,
// C (M, N) s32. The TPU kernel keeps all of B resident in VMEM and
// streams A in row blocks. B is taken transposed here, Bt (N, K), so that
// both operands are K-major, the only layout wgmma reads 8-bit operands
// in: a 128-byte SW128 row is one k-step of 128 int8, and its k32 slices
// are 32-byte steps, as the bf16 k16 slices of gemm_sm90.cuh. The tensor
// maps are UINT8 (the bytes are copied, not converted; zero fill is int8
// zero). Sums are exact: |a*b| <= 2^14 and K < 2^17 keep them inside
// int32.
//
// Bound on an H100 at the int8 DNN's shapes, per plane, S = 4096:
//   layer 1 (4096, 10240) @ (10240, 1024): 85.9 G ops, 0.043 ms at
//           1979 T int8 ops/s — operation-bound;
//   layer 2 (131072, 1024) @ (1024, 1024): 134 MB in + 537 MB int32 out,
//           0.20 ms at 3.35 TB/s — byte-bound (the output write);
//   layer 3 (131072, 1024) @ (1024, 234): 134 MB in + 123 MB out,
//           0.077 ms — byte-bound.
// What such loops are paced by on this card is the bytes each SM takes
// in and, for layers 2 and 3, the int32 stores. Two bodies, picked by K:
//
// * K <= KMAX (1024; layers 2 and 3): a resident slab. Each block holds
//   128 rows of Bt (128 output columns x K, up to 128 KB) in shared
//   memory for its whole life, loaded once by TMA, and streams 128-row
//   A tiles through a SLAB_STAGES-deep ring of 16 KB k-steps; so the SMs
//   take in A once per 128 output columns (8 x 134 MB for layer 2, 2 x
//   134 MB for layer 3, rows of Bt past N zero-filled) plus one slab a
//   block. The two consumer warpgroups take the block's tiles in turns
//   (ping-pong, ordered by an mbarrier pair as in ls_sm90.cuh): each
//   runs two m64n128k32 products a k32 slice (tile rows 0-63 and
//   64-127, 128 int32 accumulators a thread), releases each stage as
//   soon as its own products on it are done, and stores its tile while
//   the other warpgroup multiplies. Each warp stages 8 of its rows at a
//   time in its own 4 KB buffer and writes them as whole 512-byte row
//   pieces (int4 a lane; int2 for layer 3's 936-byte rows): stored
//   straight from registers, 8 rows x 32 bytes a warp instruction, the
//   936-byte rows' runs straddle sectors and layer 3 took twice as long
//   (PERF.md).
// * K > KMAX (layer 1): gemm_sm90.cuh's persistent walk with int8
//   operands. 128 x 256 tiles, k-step 128, both operands through its
//   4-stage ring of 48 KB, B multicast to 2-block clusters, two
//   consumer warpgroups of 64 rows each (m64n256k32, 128 int32
//   accumulators a thread): 384 bytes of operands into an SM per 128 x
//   256 x 1 of work, where 128 x 128 tiles take 512. Layer 1's output
//   is 17 MB, so its epilogue is not overlapped.
//
// Ragged M, N and K come from TMA's zero fill of out-of-bounds elements
// (K needs only be a multiple of 16 for the 16-byte row pitch); the
// epilogues mask their stores.
#include <stdint.h>

#include "gemm_sm90.cuh"

// Phase cuts for tools/probe_int8.py, which times the kernel built with
// -DINT8_CUT=<bits> (its answers are then wrong): 1 skips the products,
// 2 the global stores (3: the loads alone). The default, 0, is the kernel.
#ifndef INT8_CUT
#define INT8_CUT 0
#endif

using namespace mamimo::sm90;

namespace {

constexpr int KB = 128;                  // int8 k of a stage: 128 bytes
constexpr int KMAX = 1024;               // the largest resident slab's K
constexpr int TILE_BYTES = 128 * KB;     // 128 rows of one k-step, 16 KB
constexpr int SLAB_STAGES = 4;           // the most that fit beside the
                                         // slab and the staging buffers
// a consumer warp's staging buffer: 8 rows of a tile's 128 s32 columns,
// rows 132 words apart (an int2 write of 8 rows x 8 columns and an int4
// read of a row are then both conflict-free)
constexpr int STG_PITCH = 132;
constexpr int STG_WORDS = 8 * STG_PITCH;
constexpr int SLAB_SMEM = (KMAX / KB) * TILE_BYTES +
                          SLAB_STAGES * TILE_BYTES + 8 * STG_WORDS * 4 +
                          8 * (2 * SLAB_STAGES + 3) + 1024;
static_assert(SLAB_SMEM <= 232448, "more shared memory than a block has");
// the streamed body's stage is gemm_sm90.cuh's: A 128 x 128 B, B 256 x 128
static_assert(A_BYTES == TILE_BYTES && B_BYTES == 2 * TILE_BYTES,
              "the int8 stage must match gemm_sm90.cuh's ring");

// Keeps the compiler from moving other accesses of the accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 of the warpgroup, s32) += A (64 x 32) @ B (128 x 32)^T, s8,
// both K-major in shared memory (desc_sw128). Fragment layout (as the f32
// one): d[4j + e] is row 16 * warp + lane / 4 + 8 * (e / 2), column
// 8j + 2 * (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, s32) += A (64 x 32) @ B (256 x 32)^T, s8; the same layout.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Eight rows of a warp's part of a tile, staged in its buffer (row i:
// words i * STG_PITCH ..), as whole row pieces of C at rows row0 + i and
// columns n0 .. n0 + 127: one 512-byte piece a warp instruction where
// N % 4 == 0 (int4 a lane), else int2 pairs or single words; masked to
// M x N.
__device__ __forceinline__ void store_rows(int32_t* __restrict__ C, int M,
                                           int N, int row0, int n0,
                                           const int* stg, int lane) {
  if (INT8_CUT & 2) return;
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + i;
    if (row >= M) break;
    int32_t* c = C + (long long)row * N + n0;
    const int* v = stg + i * STG_PITCH;
    if ((N & 3) == 0) {
      if (n0 + 4 * lane < N)
        *reinterpret_cast<int4*>(c + 4 * lane) =
            *reinterpret_cast<const int4*>(v + 4 * lane);
    } else if ((N & 1) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (n0 + 64 * h + 2 * lane < N)
          *reinterpret_cast<int2*>(c + 64 * h + 2 * lane) =
              *reinterpret_cast<const int2*>(v + 64 * h + 2 * lane);
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (n0 + 32 * h + lane < N) c[32 * h + lane] = v[32 * h + lane];
    }
  }
}

// One int2 pair of C at (row, col), col even, masked to M x N.
__device__ __forceinline__ void store_pair(int32_t* __restrict__ C, int M,
                                           int N, int row, int col, int v0,
                                           int v1) {
  if ((INT8_CUT & 2) || row >= M || col >= N) return;
  int32_t* p = C + (long long)row * N + col;
  if (col + 1 >= N) {
    p[0] = v0;
  } else if ((N & 1) == 0) {            // int2 stores stay 8-byte aligned
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  } else {
    p[0] = v0;
    p[1] = v1;
  }
}

// K <= KMAX. Block b owns the slab b % NS of Bt (NS = ceil(N / 128)) and
// the 128-row tiles b / NS, b / NS + per_slab, ... of A; warpgroup w of
// its consumers takes the tiles u = w, w + 2, ... of that sequence.
__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kernel_slab(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        int32_t* __restrict__ C, int M, int N, int K,
                        int per_slab) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sb = (saddr(smem_raw) + 1023u) & ~1023u;  // the slab
  const uint32_t ring = sb + (KMAX / KB) * TILE_BYTES;
  const uint32_t stg = ring + SLAB_STAGES * TILE_BYTES;  // 8 warps' buffers
  const uint32_t full = stg + 8 * STG_WORDS * 4;
  const uint32_t empty = full + 8 * SLAB_STAGES;
  const uint32_t bfull = empty + 8 * SLAB_STAGES;
  const uint32_t done = bfull + 8;                         // 2 x 8 bytes
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int ns = (N + 127) / 128;
  const int slab = blockIdx.x % ns, first = blockIdx.x / ns;
  const int T = (M + 127) / 128, NK = (K + KB - 1) / KB;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SLAB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty + 8 * s, 1);      // the warpgroup that consumed it
    }
    mbar_init(bfull, 1);
    mbar_init(done, 1);
    mbar_init(done + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      // the block's slab of Bt, once
      mbar_expect_tx(bfull, NK * TILE_BYTES);
      for (int kb = 0; kb < NK; ++kb)
        tma_load_3d(sb + kb * TILE_BYTES, &mb, bfull, kb * KB, slab * 128, 0);
      int it = 0;    // k-steps over the block's tiles: stage it % STAGES
      for (int t = first; t < T; t += per_slab)
        for (int kt = 0; kt < NK; ++kt, ++it) {
          const int s = it % SLAB_STAGES;
          mbar_wait(empty + 8 * s, ((it / SLAB_STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, TILE_BYTES);
          tma_load_3d(ring + s * TILE_BYTES, &ma, full + 8 * s, kt * KB,
                      t * 128, 0);
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int q = 2 * (lane % 4);
  int* buf = reinterpret_cast<int*>(
                 smem_raw + (stg - saddr(smem_raw))) +
             (4 * w + warp) * STG_WORDS;
  mbar_wait(bfull, 0);
  for (int u = w, t = first + w * per_slab; t < T;
       u += 2, t += 2 * per_slab) {
    // Wait until the other warpgroup has taken every stage of tile u - 1:
    // then each stage's earlier passes have completed, and the parity
    // waits below cannot mistake a pass two back for the one awaited.
    if (u > 0) mbar_wait(done + 8 * (1 - w), ((u - 1) / 2) & 1);
    int acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
    for (int kt = 0; kt < NK; ++kt) {
      const int it = u * NK + kt;
      const int s = it % SLAB_STAGES;
      mbar_wait(full + 8 * s, (it / SLAB_STAGES) & 1);
      const uint32_t a = ring + s * TILE_BYTES;
      const uint32_t b = sb + kt * TILE_BYTES;
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
      if (!(INT8_CUT & 1)) {
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
          wgmma_m64n128k32(acc0, desc_sw128(a + kk * 32),
                           desc_sw128(b + kk * 32));
          wgmma_m64n128k32(acc1, desc_sw128(a + 64 * KB + kk * 32),
                           desc_sw128(b + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc0);
      fence_acc(acc1);
      if (tid == 0) mbar_arrive(empty + 8 * s);   // this stage is free
    }
    if (tid == 0) mbar_arrive(done + 8 * w);     // tile u's stages are taken
    // The warp's rows, 16 * warp .. + 15 of each 64-row half, in four
    // rounds of 8 (half h, e / 2 = hi): values 4j + 2hi + {0, 1} at row
    // lane / 4, columns 8j + q, q + 1 of the round; no other warp reads
    // the buffer, so __syncwarp orders its writes and reads.
    const int m0 = t * 128 + 16 * warp, n0 = slab * 128;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __syncwarp();                 // the last round's reads are done
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v0 = h ? acc1[4 * j + 2 * hi] : acc0[4 * j + 2 * hi];
          const int v1 =
              h ? acc1[4 * j + 2 * hi + 1] : acc0[4 * j + 2 * hi + 1];
          *reinterpret_cast<int2*>(buf + (lane / 4) * STG_PITCH + 8 * j + q) =
              make_int2(v0, v1);
        }
        __syncwarp();
        store_rows(C, M, N, m0 + 64 * h + 8 * hi, n0, buf, lane);
      }
    }
  }
}

// K > KMAX: gemm_sm90.cuh's persistent walk (gemm_persistent) with int8
// operands, a 128-byte k-step and s32 accumulators; cluster c takes the
// tile groups c, c + (number of clusters), ... (group g: N-tile g % ntn,
// then the group of CLUSTER M-tiles), CTA rank r the group's M-tile r.
__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kernel_ring(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        int32_t* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (saddr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // STAGES x 8 bytes
  const uint32_t empty = full + STAGES * 8;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cid = cluster_index(), ncl = cluster_count();
  const int KT = (K + KB - 1) / KB;
  const int ntn = (N + BN - 1) / BN;
  const int ntg = ((M + BM - 1) / BM + CLUSTER - 1) / CLUSTER;
  const int T = ntn * ntg;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // one arrival per consumer warpgroup of every CTA of the cluster:
      // each stage holds B slices written by all of them
      mbar_init(empty + 8 * s, 2 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        const int n0 = (t % ntn) * BN;
        const int m0 = ((t / ntn) * CLUSTER + rank) * BM;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t a = ring + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          tma_load_3d(a, &ma, full + 8 * s, kt * KB, m0, 0);
          // this CTA's half of the B tile, into every CTA of the cluster
          tma_load_3d_multicast(a + A_BYTES + rank * B_SLICE, &mb,
                                full + 8 * s, kt * KB,
                                n0 + rank * B_SLICE_ROWS, 0,
                                (uint16_t)((1u << CLUSTER) - 1));
        }
      }
      // stay until every CTA of the cluster has released each stage's
      // last use: no CTA may exit while another still arrives on its
      // barriers
      for (int j = 0; j < STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % STAGES), ((it / STAGES) & 1) ^ 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int r = cw * 64 + 16 * warp + lane / 4, q = 2 * (lane % 4);
  int it = 0;
  for (int t = cid; t < T; t += ncl) {
    const int n0 = (t % ntn) * BN;
    const int m0 = ((t / ntn) * CLUSTER + rank) * BM;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = ring + s * STAGE_BYTES + cw * (64 * KB);
      const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
      fence_acc(acc);
      wgmma_fence();
      if (!(INT8_CUT & 1)) {
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          wgmma_m64n256k32(acc, desc_sw128(a + kk * 32),
                           desc_sw128(b + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      // this stage is free here and in the other CTA of the cluster
      if (tid == 0)
#pragma unroll
        for (int c = 0; c < CLUSTER; ++c)
          mbar_arrive_cluster(empty + 8 * s, c);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      store_pair(C, M, N, m0 + r, n0 + 8 * j + q, acc[4 * j],
                 acc[4 * j + 1]);
      store_pair(C, M, N, m0 + r + 8, n0 + 8 * j + q, acc[4 * j + 2],
                 acc[4 * j + 3]);
    }
  }
}

// A 2-d map (as 3-d, one plane) of `rows` rows of `inner` int8, packed
// (inner % 16 == 0, ptr 16-byte aligned), box 128 bytes x 128 rows,
// SW128; elements outside read as zero. Returns 0 or ERR_TENSOR_MAP.
int make_map_s8(CUtensorMap* map, const void* ptr, int inner, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)inner,
                                 (cuuint64_t)inner * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)KB, 128, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// The resident-slab launch: ceil(N / 128) slabs, as many blocks for each
// as fit on the device at once beside the other slabs' (one block an SM;
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once), never more
// than there are tiles. Returns a cudaError_t code.
int launch_slab(const CUtensorMap& ma, const CUtensorMap& mb, int32_t* c,
                int M, int N, int K, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_mm_kernel_slab, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SLAB_SMEM);
  if (e != cudaSuccess) return (int)e;
  static int resident = 0;  // blocks that fit on the device at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, int8_mm_kernel_slab, THREADS, SLAB_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int ns = (N + 127) / 128, tiles = (M + 127) / 128;
  int per_slab = resident / ns;
  if (per_slab < 1) per_slab = 1;
  if (per_slab > tiles) per_slab = tiles;
  int8_mm_kernel_slab<<<ns * per_slab, THREADS, SLAB_SMEM, stream>>>(
      ma, mb, c, M, N, K, per_slab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K) s8, bt (N, K) s8, c (M, N) s32, all row-major and 16-byte
// aligned; K % 16 == 0, M, N >= 1. Returns the CUDA error code of the
// launch (or ERR_TENSOR_MAP).
int int8_mm_launch(const void* a, const void* bt, void* c, int M, int N,
                   int K, void* stream) {
  CUtensorMap ma, mb;
  if (make_map_s8(&ma, a, K, M) || make_map_s8(&mb, bt, K, N))
    return ERR_TENSOR_MAP;
  if (K <= KMAX)
    return launch_slab(ma, mb, (int32_t*)c, M, N, K, (cudaStream_t)stream);
  return launch(int8_mm_kernel_ring, M, N, 1, (cudaStream_t)stream, ma, mb,
                (int32_t*)c, M, N, K);
}

const char* int8_mm_error_string(int e) { return error_string(e); }

}  // extern "C"
