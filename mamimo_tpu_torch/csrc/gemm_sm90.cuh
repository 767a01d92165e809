// Hopper GEMM main loop of the port's two layer-1 GEMMs: TMA loads into
// a ring of shared-memory stages ordered by mbarriers, and wgmma
// (m64n256k16, bf16 -> f32) from shared memory.
//
// Serves the layer-1 products of two TPU kernels:
//   mamimo_tpu/ops/pallas/fused_factored.py::fused_factored_planes
//     (fused_factored.cu, factored_sig_proj_kernel: out[p] = x[p] @ W1[p]);
//   mamimo_tpu/ops/pallas/mlp_infer.py::mlp_infer_pallas
//     (mlp_infer.cu, mlp_layer1_kernel: h1 = bf16(relu(x @ W1 + b1) s1 + t1)).
//
// Bound on an H100 (989 TFLOP/s bf16): both are deep, compute-bound
// GEMMs. factored_sig_proj at S = 4096: 2 x 4096 x 10240 x 1024, 172 GFLOP
// (0.174 ms) against 0.24 GB of operands and output (0.073 ms at
// 3.35 TB/s); mlp_infer_layer1 at M = 131072: 131072 x 10272 x 1024, 2.76
// TFLOP (2.79 ms) against 3.0 GB (0.89 ms). The main loop is the whole
// cost, so it is built from what Hopper offers for it:
//
// * Block tile 128 x 256, k-step 64 (128 bytes of bf16), 384 threads:
//   warpgroup 0 is the producer, warpgroups 1 and 2 the consumers, each
//   owning 64 rows of the tile (128 f32 accumulators a thread).
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232).
// * One producer thread issues cp.async.bulk.tensor (TMA) for the A tile
//   (128 x 64) and the B tile (256 x 64) of each k-step into a STAGES-deep
//   ring, with expect_tx on the stage's "full" mbarrier; the consumers
//   release a stage on its "empty" mbarrier once the wgmma reading it has
//   completed. No thread computes an address and there is no
//   __syncthreads() in the loop.
// * Clusters of CLUSTER = 2 blocks take two M-tiles of one N-tile: each
//   block loads half of the B tile and multicasts it to both, so a block
//   reads 32 KB of a k-step's 48 KB from L2 instead of 48 (an odd last
//   M-tile is paired with one past M, which reads zeros). A stage is free
//   again once the consumers of both blocks have released it.
// * A persistent grid, as many clusters as fit on the card (one block per
//   SM), walks the tiles; the ring runs on across tile boundaries, so the
//   producer loads the next tile while the consumers run the epilogue of
//   this one.
// * Both operands are K-major (A is x, B is W1 transposed, kept by the
//   weight-preparing functions as w1t), loaded with 128-byte swizzle;
//   one shared-memory descriptor form (SW128, 1024-byte 8-row groups)
//   serves both, and the k16 slices of a stage are 32-byte steps of its
//   start address.
// * Each k-step's four wgmma form one group; wgmma.wait_group 1 keeps
//   that group in flight while the next stage's wait and issue proceed.
// * Ragged edges come from TMA's zero fill of out-of-bounds elements: rows
//   past M, columns past N (BN = 256 over N % 128 == 0) and the K tail
//   (the maps carry the true K, which need only be a multiple of 8 for the
//   16-byte row pitch). The epilogue masks its stores.
//
// The tensor maps are made on the host (make_map) through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPointByVersion
// (cudaGetDriverEntryPoint before CUDA 12.5) so the library needs no
// -lcuda, and passed as __grid_constant__ parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mamimo {
namespace sm90 {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 384;             // producer + 2 consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;     // 16 KB
constexpr int B_BYTES = BN * BK * 2;     // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the ring, its 2 x STAGES barriers, and room to align the ring to 1024
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int ACC = BN / 2;              // f32 accumulators a consumer thread
// CTAs of a cluster: they take consecutive M-tiles of one N-tile, and each
// loads 1/CLUSTER of the shared B tile and multicasts it to all of them
constexpr int CLUSTER = 2;
constexpr int B_SLICE_ROWS = BN / CLUSTER;
constexpr int B_SLICE = B_BYTES / CLUSTER;
// returned by make_map (and the launch functions) when the driver refuses
// a tensor map; no cudaError_t has this value
constexpr int ERR_TENSOR_MAP = 100000;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed. A wait
// that lasts about 9 s (2^34 cycles) can only be a lost arrival: it traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

// Whether the barrier's phase of this parity has completed, without
// waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Arrives on the mbarrier at shared offset `bar` of CTA `cta` of the
// cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// This CTA's rank in its cluster, the cluster's index in the grid, and the
// number of clusters (1-d clusters along x).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-d map into shared memory at dst,
// completing its bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The same box written at dst of every CTA in `mask` of the cluster, each
// completing its bytes on its own mbarrier at offset bar.
__device__ __forceinline__ void tma_load_3d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving other accesses of the accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma operands, TMA) once a barrier has been passed.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory matrix descriptor of a K-major bf16 tile stored as
// 128-byte rows with the 128-byte swizzle (what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B): start address >> 4, leading offset 16 B
// (unused by this layout), 8-row groups 1024 B apart, layout SW128.
// The tile must start on a 1024-byte boundary (base offset 0); a k16
// slice starts 32 bytes further per slice.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// d (64 x 256 of the warpgroup, f32) += A (64 x 16) @ B (256 x 16)^T.
// Fragment layout: d[4j + e] is row 16 * warp + lane / 4 + 8 * (e / 2),
// column 8j + 2 * (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC],
                                                 uint64_t da, uint64_t db) {
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
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// The two shapes of the MLP tails (tail_sm90.cuh). d (64 x 64, f32) +=
// A (64 x 16) @ B (64 x 16)^T, both from shared memory; d's fragment
// layout is that of m64n256k16 over 64 columns.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 from registers) @ B (128 x 16)^T.
// a[] holds the thread's A fragment: a[0] row 16 * warp + lane / 4,
// columns 2 * (lane % 4) + {0, 1}; a[1] the same 8 rows below; a[2], a[3]
// as a[0], a[1] 8 columns right (the accumulator layout of an m64n16
// product, so an f32 accumulator converts in place to an A operand).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------
// float32 products at float32 accuracy on the tensor cores (3xTF32):
// each operand is split into a TF32 high part and a TF32 low part,
// x = hi + lo with |lo| <= 2^-11 |x|, and a.b is taken as hi.hi +
// hi.lo + lo.hi. The dropped lo.lo and the rounding of lo are about
// 2^-22 of each product: NMSE near -120 dB, where one TF32 pass is near
// -60 dB. Serves the LS kernels' float32 mode (ls_sm90.cuh,
// ls_body_f32, both operands from shared memory), the float32 GEMM body
// gemm_tf32x3 below (matmul.cu, fused_factored.cu, mlp_infer.cu) and the
// float32 tail (tail_sm90.cuh, layers23_f32). Those two take the
// constant operand's parts split once (tf32_split.cu) and split the
// other operand in registers: wgmma takes a TF32 A from registers (the
// RS forms below; CUTLASS's cute/arch/mma_sm90_gmma.hpp has them as
// MMA_64xNx8_F32TF32TF32_RS_TN) and a TF32 B only from shared memory,
// K-major.
// ---------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as a
// float whose low 13 bits are zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// x = hi + lo, both TF32 values; hi - x is exact (Sterbenz), so lo
// carries the next 11 bits of x.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// d (64 x 128, f32) = SA * A (64 x 8) @ B (128 x 8)^T + (keep ? d : 0),
// TF32, both K-major from shared memory in the SW128 layout of
// desc_sw128 (a k8 slice of f32 is 32 bytes, as a k16 slice of bf16), SA
// = 1 or -1 (imm-scale-a); d's fragment layout is that of m64n128k16.
template <int SA>
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t da,
                                                     uint64_t db,
                                                     int keep = 1) {
  static_assert(SA == 1 || SA == -1, "imm-scale-a is 1 or -1");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, %67, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(keep), "n"(SA));
}

// The three TF32 products of one k8 slice: d = SA (a_hi b_hi + a_hi b_lo
// + a_lo b_hi) + (keep ? d : 0), the small terms first.
//
// The tensor cores add into d with truncation, an error of one sign:
// over long sums it grows with the number of additions (3xTF32 over K =
// 10240 in one accumulator read -83 dB against float64 on an H100 80GB
// HBM3 at 700 W, chip_smoke.py's phase 5m; -128 dB summed per k-step).
// A long product therefore sums each stretch of K into a fresh d (keep =
// 0 for its first slice) and adds the stretches in float32 in registers
// (gemm_tf32x3, layers23_f32); the LS kernels' sums (K = 512 a symbol
// half) stay in one.
template <int SA>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[64], uint64_t a_hi,
                                             uint64_t a_lo, uint64_t b_hi,
                                             uint64_t b_lo, int keep = 1) {
  wgmma_m64n128k8_tf32<SA>(d, a_lo, b_hi, keep);
  wgmma_m64n128k8_tf32<SA>(d, a_hi, b_lo);
  wgmma_m64n128k8_tf32<SA>(d, a_hi, b_hi);
}

// The register-A forms of the TF32 products: d (64 x N, f32) = SA * A
// (64 x 8, TF32 from registers) @ B (N x 8)^T + (keep ? d : 0), B
// K-major from shared memory (desc_sw128). a[] is the thread's A
// fragment as lds_split_tf32 loads it. PTX has these forms for .tf32
// (CUTLASS's cute/arch/mma_sm90_gmma.hpp names them
// MMA_64xNx8_F32TF32TF32_RS_TN); their registers must stay untouched
// until the product's wgmma group has completed (fence_u32 after the
// wait that retires it).
template <int SA>
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db,
                                                        int keep = 1) {
  static_assert(SA == 1 || SA == -1, "imm-scale-a is 1 or -1");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, %70, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep),
        "n"(SA));
}

// The m64n64k8 register-A form (d 64 x 64, f32; the fragment layout of
// m64n256k16 over 64 columns), for the float32 tail's layer 2.
template <int SA>
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db,
                                                       int keep = 1) {
  static_assert(SA == 1 || SA == -1, "imm-scale-a is 1 or -1");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep),
        "n"(SA));
}

// The three TF32 products of one k8 slice with A's parts in registers:
// d = SA (a_lo b_hi + a_hi b_lo + a_hi b_hi) + (keep ? d : 0).
template <int SA>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[64],
                                                const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4],
                                                uint64_t b_hi, uint64_t b_lo,
                                                int keep = 1) {
  wgmma_m64n128k8_tf32_rs<SA>(d, al, b_hi, keep);
  wgmma_m64n128k8_tf32_rs<SA>(d, ah, b_lo);
  wgmma_m64n128k8_tf32_rs<SA>(d, ah, b_hi);
}

template <int SA>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[32],
                                                const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4],
                                                uint64_t b_hi, uint64_t b_lo,
                                                int keep = 1) {
  wgmma_m64n64k8_tf32_rs<SA>(d, al, b_hi, keep);
  wgmma_m64n64k8_tf32_rs<SA>(d, ah, b_lo);
  wgmma_m64n64k8_tf32_rs<SA>(d, ah, b_hi);
}

// Keeps the compiler from reusing registers of an A fragment that an
// asynchronous product may still read.
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The thread's register-A fragment of k8 slice kk of a 64-row f32 tile
// at p in shared memory (K-major, 128-byte rows in the SW128 layout TMA
// writes, 1024-byte aligned), split into its TF32 parts (SPLIT; else hi
// the values as they are and lo zero). The fragment of an m64nNk8 .tf32
// product: a[0] row r0 = 16 * warp + lane / 4, column 8 kk + lane % 4
// (t); a[1] row r0 + 8 (1024 bytes on); a[2], a[3] as a[0], a[1] four
// columns right (the next 16-byte chunk). The XOR of each chunk with
// r0 & 7 spreads a warp's 32 loads over the 32 banks.
template <bool SPLIT = true>
__device__ __forceinline__ void lds_split_tf32(const unsigned char* p, int r0,
                                               int t, int kk,
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  const unsigned char* row = p + r0 * 128 + 4 * t;
  const int x = r0 & 7;
  const uint32_t c0 = ((2 * kk) ^ x) << 4, c1 = ((2 * kk + 1) ^ x) << 4;
  const float v[4] = {*reinterpret_cast<const float*>(row + c0),
                      *reinterpret_cast<const float*>(row + 1024 + c0),
                      *reinterpret_cast<const float*>(row + c1),
                      *reinterpret_cast<const float*>(row + 1024 + c1)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (SPLIT) {
      float h, l;
      split_tf32(v[i], h, l);
      hi[i] = __float_as_uint(h);
      lo[i] = __float_as_uint(l);
    } else {
      hi[i] = __float_as_uint(v[i]);
      lo[i] = 0u;
    }
  }
}

// Stretches of K: a float32 body sums each stretch of k-steps of 32 into
// a fresh accumulator (keep = 0 for its first product) and adds it to
// the running sum in float32 in registers, since the tensor cores'
// additions truncate (wgmma_3xtf32). TF_STRETCH is gemm_tf32x3's (the
// float32 tail has its own, tail_sm90.cuh's F_STRETCH), each chosen on
// an H100 by time against error (tools/probe_gemm.py and probe_tail.py
// --f32 build copies of these sources with other lengths; PERF.md):
// against 8, stretches of 4 cost the longest-K GEMM 5% and of 2 13-30%.
constexpr int TF_STRETCH = 8;
// Phase cuts of gemm_tf32x3 for tools/probe_gemm.py, which times the
// float32 GEMMs built with -DGEMM_CUT=<bits> (their answers are then
// wrong): 1 skips A's TF32 split in registers, 2 the products. The
// default, 0, is the kernel.
#ifndef GEMM_CUT
#define GEMM_CUT 0
#endif

// Whether k-step kt (of KT) of consumer warpgroup w ends a stretch of
// STRETCH k-steps. The second warpgroup's stretches are offset by half a
// stretch, so the two never drain their products at the same k-step.
template <int STRETCH = TF_STRETCH>
__device__ __forceinline__ bool tf_stretch_end(int kt, int KT, int w) {
  static_assert(STRETCH >= 2 && STRETCH % 2 == 0,
                "a stretch is an even number of k-steps");
  return kt == KT - 1 || (kt + 1 + w * (STRETCH / 2)) % STRETCH == 0;
}

// The A registers of a register-A 3xTF32 k-step: two buffers (one per
// commit group) of two k8 slices, high and low parts.
struct TfA {
  uint32_t h[2][2][4], l[2][2][4];
};

// One commit group of kstep_3xtf32_rs: k8 slices 2 BUF and 2 BUF + 1 of
// the k-step into A's buffer BUF, their products issued and committed;
// then wgmma_wait<1> retires the group before it and frees the other
// buffer's registers.
template <int BUF, bool SPLIT, bool MMA, int N>
__device__ __forceinline__ void group_3xtf32_rs(float (&d)[N], TfA& A,
                                                const unsigned char* a,
                                                int r0, int t, uint32_t bh,
                                                uint32_t bl, int keep) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    lds_split_tf32<SPLIT>(a, r0, t, 2 * BUF + j, A.h[BUF][j], A.l[BUF][j]);
  fence_acc(d);
  wgmma_fence();
  if constexpr (MMA) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_3xtf32_rs<1>(d, A.h[BUF][j], A.l[BUF][j],
                         desc_sw128(bh + (2 * BUF + j) * 32),
                         desc_sw128(bl + (2 * BUF + j) * 32),
                         j == 0 ? keep : 1);
  }
  wgmma_commit();
  fence_acc(d);
  wgmma_wait<1>();
  fence_acc(d);
  fence_u32(A.h[1 - BUF]);
  fence_u32(A.l[1 - BUF]);
}

// One k-step of 32 of d += A @ B^T in 3xTF32, A's 64 rows from the f32
// tile at a in shared memory (this warpgroup's, split in registers by
// lds_split_tf32), B's high and low parts K-major at bh and bl (SW128,
// N rows). Two commit groups, k8 slices 0-1 and 2-3 (group_3xtf32_rs),
// each loading into its own buffer of A while the group before it runs.
// So the previous k-step's products are done when `retired` runs (after
// group 0's issue), and this k-step's group 1 is the only one left in
// flight on return (drain_3xtf32 retires it). keep = 0 starts d afresh.
// MMA = false skips the products (a phase cut for the probes). One
// group a k-step (both buffers alternating between k-steps, a whole
// k-step in flight) measured 8% slower in the GEMM on an H100 (PERF.md).
template <bool SPLIT = true, bool MMA = true, int N, class F>
__device__ __forceinline__ void kstep_3xtf32_rs(float (&d)[N], TfA& A,
                                                const unsigned char* a,
                                                int r0, int t, uint32_t bh,
                                                uint32_t bl, int keep,
                                                F&& retired) {
  group_3xtf32_rs<0, SPLIT, MMA>(d, A, a, r0, t, bh, bl, keep);
  retired();
  group_3xtf32_rs<1, SPLIT, MMA>(d, A, a, r0, t, bh, bl, 1);
}

// Retires every product in flight (kstep_3xtf32_rs's last group).
template <int N>
__device__ __forceinline__ void drain_3xtf32(float (&d)[N], TfA& A) {
  wgmma_wait<0>();
  fence_acc(d);
  fence_u32(A.h[0]);
  fence_u32(A.l[0]);
  fence_u32(A.h[1]);
  fence_u32(A.l[1]);
}

// Before waiting for a k-step's stage (full barrier `bar`, phase
// parity): when the previous k-step's stage is still held (its last
// group may run) and this one has not arrived, retire the products and
// run `release` for the held stage, so that the producer can refill it
// while this warpgroup waits (the ring would otherwise keep a stage
// whose products are done). Returns whether the stage is still held.
template <int N, class F>
__device__ __forceinline__ bool early_release(float (&d)[N], TfA& A,
                                              bool held, uint32_t bar,
                                              uint32_t parity, F&& release) {
  if (held && !mbar_test(bar, parity)) {
    drain_3xtf32(d, A);
    release();
    return false;
  }
  return held;
}

// Stores of one or two adjacent f32 values as f32, or rounded to bf16 to
// nearest even (as torch's float32 -> bfloat16 cast); p two-element
// aligned for put2.
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void put1(float* p, float a) { *p = a; }

__device__ __forceinline__ void put1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// ---------------------------------------------------------------------
// The float32 GEMM body (3xTF32), C(z) = A(z) @ B(z)^T, both operands
// float32 and K-major, B's TF32 parts split once beforehand (the
// weight-preparing functions; matmul_float per call) by tf32_split.cu:
//
// * Block tile 128 x 128, k-step 32 (128 bytes of f32), 384 threads:
//   warpgroup 0 the producer, warpgroups 1 and 2 the consumers, each
//   owning 64 rows of the tile. A stage holds A's 128 rows (16 KB) and
//   both parts of Bt's 128 rows (2 x 16 KB); 4 stages.
// * A is split in registers: each consumer loads its A fragment from the
//   stage and splits it (lds_split_tf32, cvt.rna as before), and wgmma
//   takes A from registers (the RS form of m64n128k8 .tf32) and Bt's
//   parts from shared memory. No thread writes shared memory in the
//   loop and the two consumers share no barrier: each releases a stage
//   once its own products on it are done (kstep_3xtf32_rs keeps one
//   commit group in flight across k-steps), and before it waits for a
//   stage that has not arrived it retires its products and releases the
//   stage it holds (early_release), so the ring refills while it waits.
// * Each stretch of TF_STRETCH k-steps sums into a fresh accumulator,
//   added in float32 in registers (the tensor cores' additions
//   truncate); the consumers' stretches are offset by half a stretch.
// * A persistent grid of clusters of TF_CLUSTER = 2 blocks walks groups
//   of two M-tiles of one N-tile, as gemm_persistent: each block loads
//   half of each part of the Bt tile and multicasts it to both; the ring
//   runs on across tiles, so one tile's epilogue overlaps the next one's
//   loads.
// * The split walk (SPLIT, launch_tf32x3_split), as gemm_persistent's:
//   where the tile groups cannot fill the card (layer 1 at small M and
//   long K), K's KT k-steps are cut into `splits` ranges of ks =
//   ceil(KT / splits) (none empty: the caller's duty), and the units
//   (N-tile, M-tile group, plane z, range j) each sum their range and hand
//   epi the plane j * Z + z of the caller's workspace of partials. A range
//   starts in a fresh accumulator, its stretches count its own k-steps
//   (the consumers' half-stretch offset from the range's start), and it
//   ends on a drained stretch. At one M-tile (M <= 128) the units take
//   clusters of CL = 1 block, which load both parts of their whole Bt
//   tile themselves, so no block runs on the zero rows past M.
// Ragged M, N and K come from TMA's zero fill (K % 4 == 0 for the
// 16-byte row pitch); the epilogue masks its stores. The bound on an
// H100 is the tensor cores: three TF32 products a multiply-add, so at
// most a third of the 495 TFLOP/s TF32 peak counting each once; the
// loads (A and both parts of Bt, 48 KB a k-step) come close to what an
// SM takes in from L2 in the products' time. Measured on an H100
// (tools/probe_gemm.py, PERF.md): without early_release the body is 20%
// slower, with 1 or 4 blocks a cluster 40-70%, with the two consumers
// issuing their groups in turns (ping-pong) 23%.
// ---------------------------------------------------------------------
constexpr int TF_CLUSTER = 2;     // blocks of a cluster sharing each Bt tile
constexpr int TF_STAGES = 4;
constexpr int TF_K = 32;                   // f32 k of a stage: 128 bytes
constexpr int TF_TILE = 128 * TF_K * 4;    // 128 rows of a k-step: 16 KB
constexpr int TF_SLICE_ROWS = 128 / TF_CLUSTER;  // a block's rows of a part
constexpr int TF_SLICE = TF_TILE / TF_CLUSTER;
// a stage: A, Bt's high part, Bt's low part
constexpr int TF_STAGE = 3 * TF_TILE;
constexpr int TF_SMEM = TF_STAGES * TF_STAGE + 8 * 2 * TF_STAGES + 1024;
static_assert(TF_SMEM <= 232448, "more shared memory than a block has");

// C(z) = A(z) @ B(z)^T over k in [0, K) for z < Z: A (M x K) plane z of
// the f32 map ma (box 32 x 128), B's TF32 high part plane 2z and low part
// plane 2z + 1 of the f32 map mb (box 32 x TF_SLICE_ROWS; tf32_split's
// (..., 2, N, K) layout), in 128 x 128 tiles walked as gemm_persistent
// walks its own. After each tile every consumer thread calls epi(z, row,
// col, v0, v1) for each of its pairs of adjacent accumulators (columns
// col, col + 1; col even; row and col may lie past M and N); the split
// walk (SPLIT) hands it the plane j * Z + z of range j instead. Launch
// through launch_tf32x3() (launch_tf32x3_split<CL>() for the split walk);
// nothing may follow the call in the kernel.
template <int CL = TF_CLUSTER, bool SPLIT = false, class Epi>
__device__ __forceinline__ void gemm_tf32x3(const CUtensorMap* ma,
                                            const CUtensorMap* mb, int M,
                                            int N, int Z, int K, Epi&& epi,
                                            int splits = 1) {
  static_assert(CL == TF_CLUSTER || CL == 1, "pairs of M-tiles, or none");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = saddr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + TF_STAGES * TF_STAGE;
  const uint32_t empty = full + 8 * TF_STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cid = cluster_index(), ncl = cluster_count();
  const int KT = (K + TF_K - 1) / TF_K;
  const int ntn = (N + 127) / 128;
  const int ntg = ((M + 127) / 128 + CL - 1) / CL;
  const int ks = SPLIT ? (KT + splits - 1) / splits : KT;
  const int T = ntn * ntg * Z * (SPLIT ? splits : 1);
  // tile t: its corner, its plane z, the plane zo of epi, its k-steps
  auto coords = [&](int t, int& m0, int& n0, int& z, int& zo, int& kb,
                    int& ke) {
    n0 = (t % ntn) * 128;
    t /= ntn;
    m0 = ((t % ntg) * CL + rank) * 128;
    z = zo = t / ntg;
    kb = 0;
    ke = KT;
    if constexpr (SPLIT) {
      z = zo % Z;
      kb = zo / Z * ks;
      ke = kb + ks < KT ? kb + ks : KT;
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);       // the producer's expect_tx
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
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        int m0, n0, z, zo, kb, ke;
        coords(t, m0, n0, z, zo, kb, ke);
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % TF_STAGES;
          const uint32_t st = ring + s * TF_STAGE;
          mbar_wait(empty + 8 * s, ((it / TF_STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, TF_STAGE);
          tma_load_3d(st, ma, full + 8 * s, kt * TF_K, m0, z);
          if constexpr (CL == 1) {
            // both slices of each part of the Bt tile
#pragma unroll
            for (int h = 0; h < TF_CLUSTER; ++h) {
              const int nb = n0 + h * TF_SLICE_ROWS;
              tma_load_3d(st + TF_TILE + h * TF_SLICE, mb, full + 8 * s,
                          kt * TF_K, nb, 2 * z);
              tma_load_3d(st + 2 * TF_TILE + h * TF_SLICE, mb, full + 8 * s,
                          kt * TF_K, nb, 2 * z + 1);
            }
          } else {
            // this block's slice of each part of Bt, into both blocks
            const int nb = n0 + rank * TF_SLICE_ROWS;
            tma_load_3d_multicast(st + TF_TILE + rank * TF_SLICE, mb,
                                  full + 8 * s, kt * TF_K, nb, 2 * z, all);
            tma_load_3d_multicast(st + 2 * TF_TILE + rank * TF_SLICE, mb,
                                  full + 8 * s, kt * TF_K, nb, 2 * z + 1,
                                  all);
          }
        }
      }
      // stay until every block of the cluster has released each stage's
      // last use
      for (int j = 0; j < TF_STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % TF_STAGES), ((it / TF_STAGES) & 1) ^ 1);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, tq = lane % 4;
  // the stage of k-step i is free here and in the other block
  auto release = [&](int i) {
    if (tid == 0)
#pragma unroll
      for (int c = 0; c < CL; ++c)
        mbar_arrive_cluster(empty + 8 * (i % TF_STAGES), c);
  };
  TfA A = {};
  int it = 0;
  for (int t = cid; t < T; t += ncl) {
    int m0, n0, z, zo, kb, ke;
    coords(t, m0, n0, z, zo, kb, ke);
    // acc: the sum so far, in float32 in registers; part: this stretch's
    // products, summed by the tensor cores
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    bool fresh = true;           // the next k-step starts a stretch
    for (int kt = kb; kt < ke; ++kt, ++it) {
      const int s = it % TF_STAGES;
      const uint32_t st = ring + s * TF_STAGE;
      // the previous k-step's stage, unless its stretch end released it
      const bool held = early_release(part, A, !fresh, full + 8 * s,
                                      (it / TF_STAGES) & 1,
                                      [&] { release(it - 1); });
      mbar_wait(full + 8 * s, (it / TF_STAGES) & 1);
      kstep_3xtf32_rs<!(GEMM_CUT & 1), !(GEMM_CUT & 2)>(
          part, A, smem_raw + (st - raw) + w * (TF_TILE / 2), r0, tq,
          st + TF_TILE, st + 2 * TF_TILE, !fresh, [&] {
            if (held) release(it - 1);
          });
      // the range's own k-steps: a stretch ends at its last one
      fresh = tf_stretch_end(kt - kb, ke - kb, w);
      if (fresh) {
        drain_3xtf32(part, A);
        release(it);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    }
    // d[4j + e]: row 16 * warp + lane / 4 + 8 * (e / 2) of the
    // warpgroup's 64, column 8j + 2 * (lane % 4) + e % 2
    const int r = m0 + 64 * w + r0;
    const int q = n0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      epi(zo, r, q + 8 * j, acc[4 * j], acc[4 * j + 1]);
      epi(zo, r + 8, q + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// C(z) = A(z) @ B(z)^T over k in [0, K) for z < Z, A (M x K) and B
// (N x K) the planes of the 3-d maps ma (box BK x BM) and mb (box BK x
// B_SLICE_ROWS) (make_map), in 128 x 256 tiles. A persistent grid of
// clusters walks groups of CLUSTER M-tiles of one N-tile: cluster c takes
// groups c, c + (number of clusters), ... (group g: N-tile g % ntn, then
// M-tile group, then plane), and CTA rank r of the cluster the group's
// M-tile r; one tile's epilogue overlaps the producer's first loads of
// the next. After each tile's main loop every consumer thread calls
// epi(z, row, col, v0, v1) for each of its pairs of adjacent accumulators
// (columns col, col + 1; col even; row and col may lie past M and N).
// Launch through launch(); nothing may follow the call in the kernel (the
// producer and consumer paths never rejoin).
//
// The split walk (SPLIT, launch_split): where the tile groups are too few
// to fill the card (the bf16 layer 1 at small M and long K; gemm_tf32x3
// walks its float32 mode the same way), K's KT k-steps are cut into
// `splits` ranges of ks = ceil(KT / splits) (every range non-empty: the
// caller's duty), and the units (N-tile, M-tile group, plane z, range j)
// each sum their range in fresh accumulators and hand epi the plane j * Z
// + z: the caller's workspace of per-range partials, which it sums
// afterwards in a fixed order. With one M-tile (M <= 128) the units take
// clusters of CL = 1 block, which load their whole B tile themselves
// (nothing to share), so no block loads the zero rows past M of an
// M-tile pair; with more, pairs of M-tiles share B as above.
template <int CL = CLUSTER, bool SPLIT = false, class Epi>
__device__ __forceinline__ void gemm_persistent(const CUtensorMap* ma,
                                                const CUtensorMap* mb, int M,
                                                int N, int Z, int K,
                                                Epi&& epi, int splits = 1) {
  static_assert(CL == CLUSTER || CL == 1, "pairs of M-tiles, or none");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (saddr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // STAGES x 8 bytes
  const uint32_t empty = full + STAGES * 8;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cid = cluster_index(), ncl = cluster_count();
  const int KT = (K + BK - 1) / BK;
  const int ntn = (N + BN - 1) / BN;
  const int ntg = ((M + BM - 1) / BM + CL - 1) / CL;
  const int ks = SPLIT ? (KT + splits - 1) / splits : KT;
  const int T = ntn * ntg * Z * (SPLIT ? splits : 1);
  // tile t: its corner, its plane z, the plane zo of epi, its k-steps
  auto coords = [&](int t, int& m0, int& n0, int& z, int& zo, int& kb,
                    int& ke) {
    n0 = (t % ntn) * BN;
    t /= ntn;
    m0 = ((t % ntg) * CL + rank) * BM;
    z = zo = t / ntg;
    kb = 0;
    ke = KT;
    if constexpr (SPLIT) {
      z = zo % Z;
      kb = zo / Z * ks;
      ke = kb + ks < KT ? kb + ks : KT;
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx
      // one arrival per consumer warpgroup of every CTA of the cluster:
      // each stage holds B slices written by all of them
      mbar_init(empty + 8 * s, 2 * CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every barrier of the cluster is set before any CTA loads or arrives
  cluster_sync();

  // `it` counts k-steps over all of the block's tiles: stage it % STAGES,
  // pass it / STAGES over the ring
  if (wg == 0) {
    // producer: one thread keeps the ring full, across tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int t = cid; t < T; t += ncl) {
        int m0, n0, z, zo, kb, ke;
        coords(t, m0, n0, z, zo, kb, ke);
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % STAGES;
          // the first pass over the ring finds every stage free
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          const uint32_t a = ring + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          tma_load_3d(a, ma, full + 8 * s, kt * BK, m0, z);
          if constexpr (CL == 1) {
            // the whole B tile, both slices
            for (int h = 0; h < CLUSTER; ++h)
              tma_load_3d(a + A_BYTES + h * B_SLICE, mb, full + 8 * s,
                          kt * BK, n0 + h * B_SLICE_ROWS, z);
          } else {
            // this CTA's slice of B, into every CTA of the cluster
            tma_load_3d_multicast(a + A_BYTES + rank * B_SLICE, mb,
                                  full + 8 * s, kt * BK,
                                  n0 + rank * B_SLICE_ROWS, z,
                                  (uint16_t)((1u << CLUSTER) - 1));
          }
        }
      }
      // stay until every stage's last use is released by every CTA of
      // the cluster: no CTA may exit while another still arrives on its
      // barriers
      for (int j = 0; j < STAGES; ++j, ++it)
        mbar_wait(empty + 8 * (it % STAGES), ((it / STAGES) & 1) ^ 1);
    }
  } else {
    // consumers: warpgroup 1 rows 0..63 of each tile, warpgroup 2 64..127
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int r = cw * 64 + warp * 16 + lane / 4, q = (lane % 4) * 2;
    // the stage of k-step i is free here and in the other CTAs
    auto release = [&](int i) {
      if (tid == 0)
#pragma unroll
        for (int c = 0; c < CL; ++c)
          mbar_arrive_cluster(empty + 8 * (i % STAGES), c);
    };
    int it = 0;
    for (int t = cid; t < T; t += ncl) {
      int m0, n0, z, zo, kb, ke;
      coords(t, m0, n0, z, zo, kb, ke);
      float acc[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      for (int kt = kb; kt < ke; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const uint32_t a = ring + s * STAGE_BYTES + cw * (64 * BK * 2);
        const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16(acc, desc_sw128(a + kk * 32),
                           desc_sw128(b + kk * 32));
        wgmma_commit();
        fence_acc(acc);
        // the previous k-step's group is done: release its stage
        wgmma_wait<1>();
        fence_acc(acc);
        if (kt > kb) release(it - 1);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(it - 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        epi(zo, m0 + r, n0 + 8 * j + q, acc[4 * j], acc[4 * j + 1]);
        epi(zo, m0 + r + 8, n0 + 8 * j + q, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-d map of bf16 data: `planes` planes of `rows` rows, each row
// `inner` elements long at a pitch of `pitch` elements (inner <= pitch,
// pitch % 8 == 0, ptr 16-byte aligned). Its box is BK x box_rows x 1 with
// the 128-byte swizzle; elements outside [0, inner) x [0, rows) read as
// zero. Returns 0 or ERR_TENSOR_MAP.
inline int make_map(CUtensorMap* map, const void* ptr, int inner, int rows,
                    int planes, int box_rows, long long pitch) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2,
                                 (cuuint64_t)pitch * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// make_map's float32 form: the same 3-d map of `planes` planes of `rows`
// rows of `inner` f32 at a pitch of `pitch` elements (pitch % 4 == 0),
// box 32 elements (128 bytes) x box_rows x 1, SW128, zero fill.
inline int make_map_f32(CUtensorMap* map, const void* ptr, int inner,
                        int rows, int planes, int box_rows, long long pitch) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 4,
                                 (cuuint64_t)pitch * 4 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Launches `units` units of a kernel on gemm_persistent or gemm_tf32x3:
// clusters of CL blocks of THREADS threads with SMEM bytes of dynamic
// shared memory, as many clusters as fit on the device at once
// (cudaOccupancyMaxActiveClusters, asked once per kernel signature, CL
// and SMEM; every kernel on these bodies runs one block an SM) and never
// more than there are units. Returns a cudaError_t code.
template <int CL, int SMEM, class... Params, class... Args>
inline int launch_units(void (*kernel)(Params...), long long units,
                        cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;  // clusters that fit on the device at once
  if (resident == 0) {
    e = cudaOccupancyMaxActiveClusters(&resident, (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3(CL * (int)(units < resident ? units : resident), 1, 1);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Launches a kernel built on gemm_persistent for an M x N output over Z
// planes: its tile groups (CLUSTER M-tiles of one N-tile of a plane), one
// a cluster of CLUSTER blocks. Returns a cudaError_t code.
template <class... Params, class... Args>
inline int launch(void (*kernel)(Params...), int M, int N, int Z,
                  cudaStream_t stream, Args... args) {
  const long long groups = (long long)(((M + BM - 1) / BM + CLUSTER - 1) /
                                       CLUSTER) *
                           ((N + BN - 1) / BN) * Z;
  return launch_units<CLUSTER, SMEM_BYTES>(kernel, groups, stream, args...);
}

// Launches a kernel built on gemm_persistent<CL, true> (the split walk)
// for an M x N output over Z planes and `splits` ranges of K: its units
// (group of CL M-tiles, N-tile, plane, range), one a cluster of CL
// blocks. Returns a cudaError_t code.
template <int CL, class... Params, class... Args>
inline int launch_split(void (*kernel)(Params...), int M, int N, int Z,
                        int splits, cudaStream_t stream, Args... args) {
  const long long units = (long long)(((M + BM - 1) / BM + CL - 1) / CL) *
                          ((N + BN - 1) / BN) * Z * splits;
  return launch_units<CL, SMEM_BYTES>(kernel, units, stream, args...);
}

// Launches a kernel built on gemm_tf32x3 for an M x N output over Z
// planes: as launch(), with 128 x 128 tiles and TF_SMEM of dynamic
// shared memory. Returns a cudaError_t code.
template <class... Params, class... Args>
inline int launch_tf32x3(void (*kernel)(Params...), int M, int N, int Z,
                         cudaStream_t stream, Args... args) {
  const long long groups =
      (long long)(((M + 127) / 128 + TF_CLUSTER - 1) / TF_CLUSTER) *
      ((N + 127) / 128) * Z;
  return launch_units<TF_CLUSTER, TF_SMEM>(kernel, groups, stream, args...);
}

// Launches a kernel built on gemm_tf32x3<CL, true> (the split walk) for
// an M x N output over Z planes and `splits` ranges of K: its units (group
// of CL M-tiles, N-tile, plane, range), one a cluster of CL blocks.
// Returns a cudaError_t code.
template <int CL, class... Params, class... Args>
inline int launch_tf32x3_split(void (*kernel)(Params...), int M, int N,
                               int Z, int splits, cudaStream_t stream,
                               Args... args) {
  const long long units = (long long)(((M + 127) / 128 + CL - 1) / CL) *
                          ((N + 127) / 128) * Z * splits;
  return launch_units<CL, TF_SMEM>(kernel, units, stream, args...);
}

// Error text of a launch function's return code.
inline const char* error_string(int e) {
  if (e == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map (or is missing)";
  return cudaGetErrorString((cudaError_t)e);
}

}  // namespace sm90
}  // namespace mamimo
