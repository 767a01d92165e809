// Fused 3-layer MLP inference on the materialized input, two kernels.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/mlp_infer.py::
// mlp_infer_pallas (body _kernel), one plane per call:
//
//   h1 = bf16(relu(x @ W1 + b1) * s1 + t1)         (M, H1)
//   h2 = bf16(relu(h1 @ W2 + b2) * s2 + t2)        (M, H2), on chip
//   y  = h2 @ W3 + b3                              (M, C) f32
//
// with the BN folded into the post-ReLU affines (s, t)
// (fold_bn_into_dense); bf16 operands, f32 accumulation.
//
// Design for the card:
// * mlp_layer1_kernel: the K-streamed layer-1 GEMM on the Hopper main
//   loop of gemm_sm90.cuh (TMA ring, mbarriers, wgmma; 128 x 256 tiles).
//   Its B operand is w1t = W1 transposed (H1, Kp), kept by
//   prepare_mlp_infer_weights, so both operands are K-major. The TPU
//   kernel kept a (256, 1024) f32 accumulator in VMEM across its K grid
//   and ran layers 2-3 in the last step; a Hopper block has 227 KB of
//   shared memory, so the epilogue applies bias, ReLU, the affine and the
//   bf16 rounding (which the TPU kernel also applies before its second
//   dot) and writes h1 to device memory. x is not padded: the tensor maps
//   carry the true in_dim (in_dim % 8 == 0 for the 16-byte row pitch), so
//   rows past M and the K tail read as zero.
// * mlp_tail_kernel: 64 rows of h1 per block, loaded by TMA into shared
//   memory in wgmma's swizzled layout (rows past M read as zero), then
//   the Hopper tail of tail_sm90.cuh (shared with the factored tail
//   kernel): W2 and W3 K-major (w2t, w3t of prepare_mlp_infer_weights)
//   by TMA multicast to a cluster of blocks with neighbouring rows, wgmma,
//   h2 never in device memory. C <= 256 is masked. Up to H1 = 1024.
// * Above H1 = 1024 (bf16): mlp_tail_gemms_launch, two GEMMs on
//   mm_sm90.cuh's walk (mm::rows_gemms): h2 = bf16(relu(h1 @ W2 +
//   b2) s2 + t2) through device memory, its rows staged in shared memory
//   and stored by TMA while the next tile's products run, then y. A
//   streamed tail that brought h1's slabs beside W2's tiles read each
//   slab once per 128 columns of W2 and ran near 40% of the products'
//   rate (PERF.md).
//
// The float32 mode (a tree of float32 weights: JAX's dot_dtype=float32,
// every product on float32 operands) takes x as float32, as it is, and
// keeps h1 float32: mlp_layer1_f32_kernel on gemm_sm90.cuh's float32 body
// gemm_tf32x3 (3xTF32 on wgmma) with the same epilogue, mlp_tail_f32_kernel
// on tail_sm90.cuh's layers23_f32 (h1 streamed slab by slab, h2 staged
// in shared memory). The launch functions' mode bit 1 selects it.
//
// Bound on an H100 at the bench shape (S = 4096 pairs, 32 heads: M =
// 131072 rows, in_dim 10272, H 1024/1024, C = 234), per plane: 2.76
// TFLOP of layer 1 (2.79 ms at the 989 TFLOP/s bf16 peak) against 2.7 GB
// of x (0.80 ms at 3.35 TB/s); layers 2-3 0.34 TFLOP (0.34 ms). It is
// compute-bound; h1's round trip (268 MB written, read once) adds about
// 0.16 ms of traffic per plane.
#include "mm_sm90.cuh"
#include "tail_sm90.cuh"

using namespace mamimo;

namespace {

// h1 = bf16(relu(x @ w1 + b1) * s1 + t1); x (M, K) bf16 through map mx,
// w1t (H1, Kp) bf16 through map mw (make_map, both with the true K).
__global__ void __launch_bounds__(sm90::THREADS, 1)
    mlp_layer1_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw,
                      const float* __restrict__ b1,
                      const float* __restrict__ s1,
                      const float* __restrict__ t1, bf16* __restrict__ h1,
                      int M, int K, int H1) {
  sm90::gemm_persistent(
      &mx, &mw, M, H1, 1, K, [&](int, int row, int col, float v0, float v1) {
        if (row >= M || col >= H1) return;
        *reinterpret_cast<__nv_bfloat162*>(h1 + (long long)row * H1 + col) =
            __floats2bfloat162_rn(
                fmaxf(v0 + b1[col], 0.f) * s1[col] + t1[col],
                fmaxf(v1 + b1[col + 1], 0.f) * s1[col + 1] + t1[col + 1]);
      });
}

// The float32 mode: h1 = relu(x @ w1 + b1) * s1 + t1 f32; x (M, K) f32
// through map mx (make_map_f32, box 32 x 128), w1t's TF32 parts (2, H1,
// Kp) f32 through map mw (box 32 x TF_SLICE_ROWS, plane = part).
__global__ void __launch_bounds__(sm90::THREADS, 1)
    mlp_layer1_f32_kernel(const __grid_constant__ CUtensorMap mx,
                          const __grid_constant__ CUtensorMap mw,
                          const float* __restrict__ b1,
                          const float* __restrict__ s1,
                          const float* __restrict__ t1,
                          float* __restrict__ h1, int M, int K, int H1) {
  sm90::gemm_tf32x3(
      &mx, &mw, M, H1, 1, K, [&](int, int row, int col, float v0, float v1) {
        if (row >= M || col >= H1) return;
        sm90::put2(h1 + (long long)row * H1 + col,
                   fmaxf(v0 + b1[col], 0.f) * s1[col] + t1[col],
                   fmaxf(v1 + b1[col + 1], 0.f) * s1[col + 1] + t1[col + 1]);
      });
}

// y + b3 -> y[m][col .. col + 1] for m < M, col < C.
__device__ __forceinline__ void store_row(float* __restrict__ y,
                                          const float* __restrict__ b3,
                                          int M, int C, int m, int col,
                                          float v0, float v1) {
  if (m >= M || col >= C) return;
  float* o = y + (long long)m * C + col;
  if ((C & 1) == 0) {
    *reinterpret_cast<float2*>(o) =
        make_float2(v0 + b3[col], v1 + b3[col + 1]);
  } else {
    o[0] = v0 + b3[col];
    if (col + 1 < C) o[1] = v1 + b3[col + 1];
  }
}

// y = (relu(h1 @ w2 + b2) * s2 + t2) @ w3 + b3 for 64 rows of h1 per
// block (blocks past M pad the last cluster and store nothing); h1, w2t
// (H2, H1) and w3t (256, H2) through the maps mh, mw2, mw3; b3 (C).
__global__ void __launch_bounds__(tail::THREADS, 1)
    mlp_tail_kernel(const __grid_constant__ CUtensorMap mh,
                    const __grid_constant__ CUtensorMap mw2,
                    const __grid_constant__ CUtensorMap mw3,
                    const float* __restrict__ b2,
                    const float* __restrict__ s2,
                    const float* __restrict__ t2,
                    const float* __restrict__ b3, float* __restrict__ y,
                    int M, int H1, int H2, int C) {
  const int m0 = blockIdx.x * tail::ROWS;
  tail::layers23<true>(
      &mh, m0, &mw2, &mw3, 0, H1, H2, b2, s2, t2,
      [](unsigned char*, int, int, int) {},
      [&](int row, int col, float v0, float v1) {
        store_row(y, b3, M, C, m0 + row, col, v0, v1);
      });
}

// The float32 mode of mlp_tail_kernel: h1 (M, H1) f32 through map mh (box
// 32 x 64), the TF32 parts of w2t and w3t (2, H2, H1), (2, 256, H2) f32
// through mw2, mw3 (plane = part); tail::layers23_f32.
__global__ void __launch_bounds__(tail::THREADS, 1)
    mlp_tail_f32_kernel(const __grid_constant__ CUtensorMap mh,
                        const __grid_constant__ CUtensorMap mw2,
                        const __grid_constant__ CUtensorMap mw3,
                        const float* __restrict__ b2,
                        const float* __restrict__ s2,
                        const float* __restrict__ t2,
                        const float* __restrict__ b3, float* __restrict__ y,
                        int M, int H1, int H2, int C) {
  const int m0 = blockIdx.x * tail::ROWS;
  tail::layers23_f32(&mh, m0, 0, &mw2, &mw3, 0, H1, H2, b2, s2, t2,
                     [&](int row, int col, float v0, float v1) {
                       store_row(y, b3, M, C, m0 + row, col, v0, v1);
                     });
}

}  // namespace

extern "C" {

// x (M, K), w1t (H1, Kp) (W1 transposed, columns past K zero): bf16 (K %
// 8 == 0, Kp % 8 == 0), h1 (M, H1) bf16; or with mode 2 (the float32
// mode) x f32 (K % 4 == 0, Kp % 4 == 0), w1t the TF32 parts of W1
// transposed, (2, H1, Kp) f32 (tf32_split), h1 f32. b1, s1, t1 (H1) f32. Kp
// >= K, H1 % 128 == 0, x and w1t 16-byte aligned.
int mlp_layer1_launch(const void* x, const void* w1t, const void* b1,
                      const void* s1, const void* t1, void* h1, int M, int K,
                      int Kp, int H1, int mode, void* stream) {
  CUtensorMap mx, mw;
  if (mode == 2) {
    if (sm90::make_map_f32(&mx, x, K, M, 1, 128, K) ||
        sm90::make_map_f32(&mw, w1t, K, H1, 2, sm90::TF_SLICE_ROWS, Kp))
      return sm90::ERR_TENSOR_MAP;
    return sm90::launch_tf32x3(mlp_layer1_f32_kernel, M, H1, 1,
                               (cudaStream_t)stream, mx, mw,
                               (const float*)b1, (const float*)s1,
                               (const float*)t1, (float*)h1, M, K, H1);
  }
  if (mode != 0) return (int)cudaErrorInvalidValue;
  int rc = sm90::make_map(&mx, x, K, M, 1, sm90::BM, K);
  if (rc == 0)
    rc = sm90::make_map(&mw, w1t, K, H1, 1, sm90::B_SLICE_ROWS, Kp);
  if (rc != 0) return rc;
  return sm90::launch(mlp_layer1_kernel, M, H1, 1, (cudaStream_t)stream, mx,
                      mw, (const float*)b1, (const float*)s1,
                      (const float*)t1, (bf16*)h1, M, K, H1);
}

// The tail's two-GEMM route: h1 (M, H1), w2t (H2, H1), w3t (256, H2)
// bf16 (16-byte aligned, H1 % 8 == 0, H2 % 128 == 0); b2, s2, t2 (H2)
// f32; b3 (C) f32. h2 = bf16(relu(h1 @ w2 + b2) s2 + t2) goes into h2
// (M, H2) bf16 (16-byte aligned), then y (M, C) = h2 @ w3 + b3 f32 (C <=
// 256): mm::rows_gemms on one plane.
int mlp_tail_gemms_launch(const void* h1, const void* w2t, const void* b2,
                          const void* s2, const void* t2, const void* w3t,
                          const void* b3, void* y, void* h2, int M, int H1,
                          int H2, int C, void* stream) {
  return mm::rows_gemms(h1, w2t, (const float*)b2, (const float*)s2,
                        (const float*)t2, w3t, (const float*)b3, (float*)y,
                        h2, M, H1, H2, C, 1, 0, (cudaStream_t)stream);
}

// h1 (M, H1), w2t (H2, H1) (W2 transposed), w3t (256, H2) (padded W3
// transposed): bf16; or with mode 2 (the float32 mode) h1 f32 and w2t,
// w3t their TF32 parts (2, H2, H1), (2, 256, H2) f32 (tf32_split); b2, s2, t2
// (H2) f32; b3 (C) f32; y (M, C) f32. H1, H2 % 128 == 0 (bf16 h1 up to
// H1 = 1024, kept whole; wider ones take mlp_tail_gemms_launch; f32 h1
// streams), C <= 256; h1, w2t, w3t 16-byte aligned.
int mlp_tail_launch(const void* h1, const void* w2t, const void* b2,
                    const void* s2, const void* t2, const void* w3t,
                    const void* b3, void* y, int M, int H1, int H2, int C,
                    int mode, void* stream) {
  CUtensorMap mh, mw2, mw3;
  const int blocks = (M + tail::ROWS - 1) / tail::ROWS;
  const dim3 grid((blocks + tail::CL - 1) / tail::CL * tail::CL, 1, 1);
  if (mode == 2) {
    if (sm90::make_map_f32(&mh, h1, H1, M, 1, tail::ROWS, H1) ||
        sm90::make_map_f32(&mw2, w2t, H1, H2, 2, tail::SLICE_ROWS, H1) ||
        sm90::make_map_f32(&mw3, w3t, H2, tail::OPP, 2, tail::SLICE_ROWS,
                           H2))
      return sm90::ERR_TENSOR_MAP;
    return tail::launch(mlp_tail_f32_kernel, grid, tail::F_SMEM,
                        (cudaStream_t)stream, mh, mw2, mw3, (const float*)b2,
                        (const float*)s2, (const float*)t2, (const float*)b3,
                        (float*)y, M, H1, H2, C);
  }
  if (mode != 0 || H1 > tail::MAX_RESIDENT)
    return (int)cudaErrorInvalidValue;
  int rc = sm90::make_map(&mh, h1, H1, M, 1, tail::ROWS, H1);
  if (rc == 0)
    rc = sm90::make_map(&mw2, w2t, H1, H2, 1, tail::SLICE_ROWS, H1);
  if (rc == 0)
    rc = sm90::make_map(&mw3, w3t, H2, tail::OPP, 1, tail::SLICE_ROWS, H2);
  if (rc != 0) return rc;
  return tail::launch(mlp_tail_kernel, grid, tail::smem_bytes(H1),
                      (cudaStream_t)stream, mh, mw2, mw3, (const float*)b2,
                      (const float*)s2, (const float*)t2, (const float*)b3,
                      (float*)y, M, H1, H2, C);
}

const char* mlp_infer_error_string(int e) {
  return sm90::error_string(e);
}

}  // extern "C"
