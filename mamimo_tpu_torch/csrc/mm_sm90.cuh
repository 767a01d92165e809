// The GEMM walk of the port's bf16 GEMMs other than layer 1: C = A @ B
// with A (M, K) bf16 K-major and B either K-major (Bt (N, K), as the
// weight-preparing functions keep it) or MN-major (B (K, N) row-major, as
// JAX passes it), f32 accumulation, and an epilogue functor.
//
// Serves the bf16 mode of matmul_bf16.cu (the TPU kernel mamimo_tpu/ops/
// pallas/int8_mm.py::matmul_pallas), the two-GEMM route of the DNN
// tails (rows_gemms below, launched by fused_factored.cu and
// mlp_infer.cu: the last hidden layer with its bias/ReLU/affine
// epilogue, then the output layer) and, with the same kernel
// (rows_gemm_kernel), the bf16 dense layers of the per-head rows route
// (fused_factored.cu's factored_dense_launch: the hidden layers between
// the first and the last, or at depth 1 the output layer): the layer-2/3
// halves of mamimo_tpu/ops/pallas/fused_factored.py::fused_factored_planes
// and mlp_infer.py::mlp_infer_pallas.
//
// Bound on an H100 (989 TFLOP/s bf16): the products at every shape it
// serves, but what measured on the card (tools/probe_gemm.py, PERF.md) is
// the epilogue: gemm_sm90.cuh's persistent walk stored each tile from
// registers as accumulator pairs (a warp instruction 8 rows x 32 bytes of
// f32, or 8 x 4 bytes of bf16: half sectors), every SM at the same point
// of its tile, and no product ran meanwhile. gemm_coop keeps that walk's
// main loop and changes the rest:
//
// * Tile 128 x 256, k-step BK = 64 (128 bytes of bf16), a TMA ring of 48
//   KB stages and one producer thread; two consumer warpgroups of 64 rows
//   each (m64n256k16, 128 f32 accumulators a thread); clusters of 2
//   blocks take two row tiles of one column tile and multicast the halves
//   of the B tile; a persistent grid walks the tile groups, the ring
//   running on across tiles.
// * B K-major: TMA boxes of BK x 128 rows of Bt in the SW128 layout of
//   desc_sw128. B MN-major: TMA boxes of 64 columns x BK rows of k
//   (128-byte rows of 64 bf16 at one k, SW128), four side by side 8 KB
//   apart, read by wgmma with its transpose bit (a 16-bit operand may be
//   MN-major) through the MN-major SW128 descriptor desc_mn (CUTLASS's
//   canonical MN layout: 64-element column blocks LBO = 8 KB apart, 8-row
//   k groups SBO = 1024 B apart; the other assignment reads garbage), k16
//   slice kk 2048 B further. So B (K, N) is read as it lies in memory.
// * The tile's first product starts its accumulators (wgmma scale-d = 0):
//   no thread writes them between products.
// * Two epilogues (Epilogue): DIRECT stages 8 rows x 128 columns of a
//   warp's accumulators at a time in its own buffer and hands the kernel
//   row pieces, 4 columns a lane (512 contiguous bytes of f32 a warp
//   instruction); STAGED writes the warpgroup's rows as bf16 into 32 KB
//   of SW128 boxes that TMA stores while the products of the next tile
//   run, which leaves room for a ring of 3 stages instead of 4. STAGED
//   serves a bf16 C; an f32 C takes DIRECT (staged, it needs two rounds
//   a tile on the shallower ring and ran slower on the card: PERF.md).
// * Ragged M, N and K come from TMA's zero fill (the maps carry the true
//   sizes; rows of 16-byte multiples: K % 8 == 0, and N % 8 == 0 for an
//   MN-major B); the epilogues mask, TMA stores clip.
//
// A ping-pong walk (the consumer warpgroups taking whole 64 x 256 tiles
// in turns) was measured too and ran slower: one warpgroup's products at
// a time, on 40 KB of operands a million multiply-adds against the
// cooperative tile's 24 (PERF.md).
#pragma once

#include "gemm_sm90.cuh"

// Phase cuts for tools/probe_gemm.py (answers then wrong), bits: 1 skips
// the products, 2 the epilogue (3 leaves the loads). The default, 0, is
// the kernel.
#ifndef MM_CUT
#define MM_CUT 0
#endif

namespace mamimo {
namespace mm {

using namespace sm90;

constexpr int BK = 64;                   // k of a stage: 128 bytes of bf16
constexpr int MN_BOX = 64;               // columns of an MN-major B box

// Shared-memory descriptor of an MN-major bf16 tile in the 128-byte
// swizzle: 128-byte rows of 64 elements at one k, 8-row k groups 1024 B
// apart (SBO), 64-element column blocks 8 KB apart (LBO: one TMA box of
// 64 columns x BK rows each), layout SW128; 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(MN_BOX * BK * 2 >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

// d (64 x 256, f32) += A (64 x 16, K-major) @ B (256 x 16)^T, B K-major
// (TB = 0) or MN-major (TB = 1, wgmma's transpose bit); the fragment
// layout of gemm_sm90.cuh's wgmma_m64n256k16.
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int keep = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(keep), "n"(TB));
}

// gemm_coop's tile, cluster and k-step stage, and the staging of its
// direct epilogue: a consumer warp's buffer holds 8 rows x 128 f32
// columns, rows STG_PITCH floats apart (16-byte aligned rows; the float2
// writes of the accumulator pairs meet at most two to a bank)
constexpr int CM = 128, CN = 256, C_CL = 2;
constexpr int C_A = CM * BK * 2, C_B = CN * BK * 2;   // 16 KB, 32 KB
constexpr int C_STAGE = C_A + C_B;
constexpr int STG_PITCH = 132;
constexpr int STG_WARP = 8 * STG_PITCH;               // floats a warp

// The two epilogues. DIRECT: row pieces from a staging buffer a warp,
// stored by the kernel's functor; a 4-stage ring. STAGED: each
// warpgroup writes its 64 rows x 256 columns as bf16 into 32 KB of shared
// memory, in the SW128 boxes of a TMA store map (64 rows x 64 columns),
// which TMA stores while the warpgroup goes on (C's rows need 16-byte
// pitches); a tile first waits until the last tile's stores have read
// the buffer. Its 64 KB leave room for a 3-stage ring.
enum Epilogue { DIRECT = 0, STAGED = 1 };

template <int EPI>
struct Coop {
  static constexpr int STAGES = EPI == DIRECT ? 4 : 3;
  static constexpr int STG_BYTES = EPI == DIRECT ? 8 * STG_WARP * 4 : 65536;
  // the ring, the staging, 2 x STAGES mbarriers, room to align
  static constexpr int SMEM =
      STAGES * C_STAGE + STG_BYTES + 8 * 2 * STAGES + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block has");
};

// TMA store of the box at smem src to (c0, c1, c2) of the 3-d map, in the
// calling thread's bulk group; commit the group; wait until at most N
// groups are still reading shared memory (READ) or still writing.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// C(z) = A(z) @ B(z) over k in [0, K) for an M x N output of each plane
// z < Z: A plane z of the map ma (box BK x CM: make_a_map), B plane z of
// mb (BMN = false: Bt, box BK x CN / C_CL rows, make_bt_map; BMN = true:
// B, box 64 columns x BK rows, make_b_map). A persistent grid of
// clusters walks the groups of C_CL row tiles of one column tile
// (column tile fastest, then the row-tile group, then the plane): cluster
// c takes groups c, c + (number of clusters), ..., block rank r the
// group's row tile r. After each tile:
// * DIRECT: every consumer lane calls f(z, row, col, v) for 32 row
//   pieces: v holds C[row, col .. col + 3] (col % 4 == 0; row and col
//   may lie past M and N); mc is unused;
// * STAGED: f(z, row, col, v0, v1) turns each pair of accumulators (col
//   even) into the float2 stored as bf16 at C[row, col .. col + 1]
//   through the map mc (make_c_map: rows M, columns N, Z planes; what
//   lies past them is not written).
// Launch through launch<EPI>(); nothing may follow the call in the
// kernel.
template <bool BMN, int EPI = DIRECT, class F>
__device__ __forceinline__ void gemm_coop(const CUtensorMap* ma,
                                          const CUtensorMap* mb,
                                          const CUtensorMap* mc, int M,
                                          int N, int Z, int K, F&& f) {
  constexpr int STAGES = Coop<EPI>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t stg = ring + STAGES * C_STAGE;
  const uint32_t full = stg + Coop<EPI>::STG_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cid = cluster_index(), ncl = cluster_count();
  const int KT = (K + BK - 1) / BK;
  const int ntn = (N + CN - 1) / CN;
  const int ntg = ((M + CM - 1) / CM + C_CL - 1) / C_CL;
  const int tiles = ntn * ntg * Z;
  auto coords = [&](int t, int& m0, int& n0, int& z) {
    n0 = (t % ntn) * CN;
    t /= ntn;
    m0 = ((t % ntg) * C_CL + rank) * CM;
    z = t / ntg;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);     // the producer's expect_tx
      // both consumer warpgroups of every block of the cluster
      mbar_init(empty + 8 * s, 2 * C_CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const uint16_t all = (uint16_t)((1u << C_CL) - 1);
      int it = 0;
      for (int t = cid; t < tiles; t += ncl) {
        int m0, n0, z;
        coords(t, m0, n0, z);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t st = ring + s * C_STAGE;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, C_STAGE);
          tma_load_3d(st, ma, full + 8 * s, kt * BK, m0, z);
          // this block's share of the B tile, into both blocks
          if constexpr (BMN) {
#pragma unroll
            for (int j = 0; j < CN / MN_BOX / C_CL; ++j) {
              const int b = rank * (CN / MN_BOX / C_CL) + j;
              tma_load_3d_multicast(st + C_A + b * (MN_BOX * BK * 2), mb,
                                    full + 8 * s, n0 + b * MN_BOX, kt * BK,
                                    z, all);
            }
          } else {
            tma_load_3d_multicast(st + C_A + rank * (C_B / C_CL), mb,
                                  full + 8 * s, kt * BK,
                                  n0 + rank * (CN / C_CL), z, all);
          }
        }
      }
      // stay until every block of the cluster has released each stage's
      // last use: no block may exit while another still arrives on its
      // barriers
      for (int j = 0; j < STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % STAGES), ((it / STAGES) & 1) ^ 1);
    }
    return;
  }

  // consumers: warpgroup 1 rows 0..63 of each tile, warpgroup 2 64..127
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int q = (lane % 4) * 2;
  // the stage of k-step i is free here and in the other block
  auto release = [&](int i) {
    if (tid == 0)
#pragma unroll
      for (int c = 0; c < C_CL; ++c)
        mbar_arrive_cluster(empty + 8 * (i % STAGES), c);
  };
  int it = 0;
  for (int t = cid; t < tiles; t += ncl) {
    int m0, n0, z;
    coords(t, m0, n0, z);
    float acc[128];
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = ring + s * C_STAGE + cw * (64 * BK * 2);
      const uint32_t b = ring + s * C_STAGE + C_A;
      fence_acc(acc);
      wgmma_fence();
      if (!(MM_CUT & 1)) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_n256<BMN>(acc, desc_sw128(a + kk * 32),
                          BMN ? desc_mn(b + kk * 16 * 128)
                              : desc_sw128(b + kk * 32),
                          kt > 0 || kk > 0);
      }
      wgmma_commit();
      fence_acc(acc);
      // the previous k-step's group is done: release its stage
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0) release(it - 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(it - 1);
    if (MM_CUT & 2) continue;
    // acc[4j + e] is row 16 * warp + lane / 4 + 8 (e / 2) of the
    // warpgroup's 64, column 8j + q + e % 2
    if constexpr (EPI == STAGED) {
      // The warpgroup's 64 rows x 256 columns as 4 boxes of 64 rows x 64
      // columns (128 bytes; the 16-byte chunk c of row r at chunk c ^ (r
      // & 7)) in its 32 KB
      const uint32_t wbase = stg + cw * 32768;
      unsigned char* wp = smem_raw + (wbase - raw);
      // the last tile's stores have read the buffer (their issuing thread
      // waited), then the warpgroup's barrier
      if (tid == 0) bulk_wait<0, true>();
      bar_sync(2 + cw, 128);
#pragma unroll
      for (int j = 0; j < CN / 8; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = 16 * warp + lane / 4 + 8 * hi, c = 8 * j + q;
          const float2 v = f(z, m0 + 64 * cw + r, n0 + c,
                             acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
          const int cb = (c % 64) * 2;              // byte in the box row
          const uint32_t off = (c / 64) * (64 * 128) + r * 128 +
                               (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15);
          put2(reinterpret_cast<__nv_bfloat16*>(wp + off), v.x, v.y);
        }
      fence_proxy_async();
      bar_sync(2 + cw, 128);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < CN / 64; ++bx)
          tma_store_3d(mc, wbase + bx * (64 * 128), n0 + bx * 64,
                       m0 + 64 * cw, z);
        bulk_commit();
      }
    } else {
      // The warp's rows 16 * warp .. + 15 of the warpgroup's 64, in four
      // rounds of 8 rows x 128 columns (e / 2 = hi: rows + 8 hi; h:
      // columns 128 h ..). No other warp touches its buffer, so
      // __syncwarp orders its writes and reads.
      float* buf = reinterpret_cast<float*>(smem_raw + (stg - raw)) +
                   (4 * cw + warp) * STG_WARP;
      const int r0 = m0 + 64 * cw + 16 * warp;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __syncwarp();               // the last round's reads are done
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int e = 4 * (16 * h + j) + 2 * hi;
            *reinterpret_cast<float2*>(buf + (lane / 4) * STG_PITCH +
                                       8 * j + q) =
                make_float2(acc[e], acc[e + 1]);
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i)
            f(z, r0 + 8 * hi + i, n0 + 128 * h + 4 * lane,
              *reinterpret_cast<const float4*>(buf + i * STG_PITCH +
                                               4 * lane));
        }
      }
    }
  }
  // the last tile's stores are written before the block may end
  if constexpr (EPI == STAGED)
    if (tid == 0) bulk_wait<0, false>();
}

// Launches a kernel built on gemm_coop<., EPI> for an M x N output over
// Z planes: its tile groups, one a cluster of C_CL blocks, as many
// clusters as fit on the card. Returns a cudaError_t code.
template <int EPI = DIRECT, class... Params, class... Args>
inline int launch(void (*kernel)(Params...), int M, int N, int Z,
                  cudaStream_t stream, Args... args) {
  const long long groups = (long long)(((M + CM - 1) / CM + C_CL - 1) /
                                       C_CL) *
                           ((N + CN - 1) / CN) * Z;
  return launch_units<C_CL, Coop<EPI>::SMEM>(kernel, groups, stream,
                                            args...);
}

// Stores of a row piece's values as f32, or rounded to bf16 to nearest
// even: put4 four (p 16-byte aligned in f32, 8 in bf16); putn the first
// n <= 4 at p, as pairs where `pairs` (p then 2-element aligned).
__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y),
                       b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <class T>
__device__ __forceinline__ void putn(T* p, float4 v, int n, bool pairs) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  if (pairs) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      if (i + 1 < n)
        put2(p + i, x[i], x[i + 1]);
      else if (i < n)
        put1(p + i, x[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) put1(p + i, x[i]);
  }
}

// gemm_coop's maps (bf16, row pitch = the inner size): A (planes x rows
// x K, box BK x CM), Bt (planes x N x K, box BK x CN / C_CL), B (planes x
// K x N, box 64 columns x BK rows).
inline int make_a_map(CUtensorMap* map, const void* ptr, int K, int rows,
                      int planes) {
  return make_map(map, ptr, K, rows, planes, CM, K);
}

inline int make_bt_map(CUtensorMap* map, const void* ptr, int K, int N,
                       int planes) {
  return make_map(map, ptr, K, N, planes, CN / C_CL, K);
}

inline int make_b_map(CUtensorMap* map, const void* ptr, int K, int N,
                      int planes) {
  return make_map(map, ptr, N, K, planes, BK, N);
}

// The STAGED epilogue's map of C (planes x M x N of bf16, row pitch N:
// N % 8 == 0), box 64 columns x 64 rows, SW128.
inline int make_c_map(CUtensorMap* map, void* ptr, int M, int N,
                      int planes) {
  return make_map(map, ptr, N, M, planes, 64, N);
}

// The DNN tails' two-GEMM route (bf16 rows: fused_factored.py::
// rows_tail_route, mlp_infer.py::tail_route) and bf16 factored_dense, one
// layer of Z planes on gemm_coop: h (Z, M, K) bf16 through map mx
// (make_a_map), wt (Z, N, K) through mw (make_bt_map); b, a, c f32, plane
// p's at p * ldb. OUT: y = (v + b)[..., :C] as T, (Z, M, C) (the output
// layer; DIRECT row pieces, C's rows need not be 16-byte multiples; b's
// first C values a plane are all it reads); else a hidden layer's rows
// bf16(relu(v + b) * a + c) (Z, M, N) through the map my (make_c_map;
// STAGED; b, a and c are read at the N columns of each plane, N % 128 ==
// 0). A fused tail's 64-row block reads each W
// tile per 64 rows, and above 1024 units each row's slab of h once per
// 128 columns of W2; the GEMM's 128 x 256 tiles take 24 KB into an SM a
// million multiply-adds, and the hidden rows' round trip through device
// memory (Z x M x N bf16, written and read once) runs beside the
// products.
template <bool OUT, class T = float>
__global__ void __launch_bounds__(THREADS, 1)
    rows_gemm_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw,
                     const __grid_constant__ CUtensorMap my,
                     const float* __restrict__ b, const float* __restrict__ a,
                     const float* __restrict__ c, void* __restrict__ y,
                     int M, int N, int Z, int K, int C, int ldb) {
  if constexpr (OUT) {
    gemm_coop<false>(
        &mx, &mw, &my, M, N, Z, K, [&](int p, int row, int col, float4 v) {
          if (row >= M || col >= C) return;
          const float* bp = b + (long long)p * ldb;
          const int n = C - col < 4 ? C - col : 4;
          const float4 o =
              make_float4(v.x + bp[col], v.y + bp[col + (n > 1)],
                          v.z + bp[col + 2 * (n > 2)],
                          v.w + bp[col + 3 * (n > 3)]);
          T* yp = reinterpret_cast<T*>(y) + ((long long)p * M + row) * C +
                  col;
          if ((C & 3) == 0)
            put4(yp, o);
          else
            putn(yp, o, n, (C & 1) == 0);
        });
  } else {
    gemm_coop<false, STAGED>(
        &mx, &mw, &my, M, N, Z, K,
        [&](int p, int, int col, float v0, float v1) {
          // the tile's columns past N are not stored: read nothing there
          if (col >= N) return make_float2(0.f, 0.f);
          const int j = p * ldb + col;
          return make_float2(fmaxf(v0 + b[j], 0.f) * a[j] + c[j],
                             fmaxf(v1 + b[j + 1], 0.f) * a[j + 1] + c[j + 1]);
        });
  }
}

// The two-GEMM route of a DNN tail over Z planes: h (Z, M, H1), w2t (Z,
// H2, H1) and w3t (Z, 256, H2) (the output layer's weights transposed,
// padded to 256 rows) bf16, 16-byte aligned, H1 % 8 == 0, H2 % 128 ==
// 0; b2, a2, c2 (Z, H2) f32; b3 f32, plane p's C values at p * ldb3. The
// last hidden layer's rows bf16(relu(h @ w2 + b2) a2 + c2) go into h2
// (Z, M, H2) bf16 (16-byte aligned), then y (Z, M, C) = (h2 @ w3 +
// b3)[..., :C] as T (C <= 256), each a GEMM (rows_gemm_kernel). Returns
// a cudaError_t code (or ERR_TENSOR_MAP).
template <class T>
inline int rows_gemms(const void* h, const void* w2t, const float* b2,
                      const float* a2, const float* c2, const void* w3t,
                      const float* b3, T* y, void* h2, int M, int H1,
                      int H2, int C, int Z, int ldb3, cudaStream_t st) {
  if (C > CN) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw, my;
  int rc = make_a_map(&mx, h, H1, M, Z);
  if (rc == 0) rc = make_bt_map(&mw, w2t, H1, H2, Z);
  if (rc == 0) rc = make_c_map(&my, h2, M, H2, Z);
  if (rc == 0)
    rc = launch<STAGED>(rows_gemm_kernel<false>, M, H2, Z, st, mx, mw, my,
                        b2, a2, c2, h2, M, H2, Z, H1, 0, H2);
  if (rc == 0) rc = make_a_map(&mx, h2, H2, M, Z);
  if (rc == 0) rc = make_bt_map(&mw, w3t, H2, CN, Z);
  if (rc != 0) return rc;
  return launch(rows_gemm_kernel<true, T>, M, CN, Z, st, mx, mw, my, b3, b3,
                b3, y, M, CN, Z, H2, C, ldb3);
}

}  // namespace mm
}  // namespace mamimo
