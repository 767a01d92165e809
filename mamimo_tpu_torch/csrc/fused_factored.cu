// Fused factored all-pairs DNN, two kernels.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_factored.py::
// fused_factored_planes (_one_plane -> pallas_call, body _kernel). Per
// plane p of the stacked real/imag model:
//
//   sig_proj = x @ W1[:L]                                     (S, H)
//   h[s,t]   = relu(sig_proj[s] + hb[t]) * a1 + c1             (S, nt, H)
//   h2[s,t]  = relu(h[s,t] @ W2 + b2) * a2 + c2                (S, nt, H)
//   y[s,t]   = h2[s,t] @ W3 + b3                               (S, nt, C)
//
// hb, a*, c*, b* are f32 (prepare_factored_weights); W1, W2, W3 and the
// products' operands are bf16 with f32 accumulation.
//
// Design for the card:
// * factored_sig_proj_kernel: the layer-1 GEMM on the Hopper main loop of
//   gemm_sm90.cuh (TMA ring, mbarriers, wgmma; 128 x 256 tiles). Its
//   B operand is w1t = W1[:L] transposed (2, H, L), kept by
//   prepare_factored_weights, so both operands are K-major. Its f32
//   output is S x H per plane, small next to the (S*nt) x H activations
//   that follow; the epilogue stores it straight from the accumulators.
// * factored_tail_kernel: one block owns 64 samples of one head t. It
//   builds h in shared memory (bf16), then walks W2 in 128-column chunks:
//   each chunk's h2 = h @ W2[:, chunk] goes through its bias, ReLU and BN
//   affine into shared memory, and y += h2_chunk @ W3[chunk] accumulates
//   in registers (the W2/W3 ring of mlp_tail.cuh, shared with the
//   materialized-input MLP of mlp_infer.cu). h and h2 never reach device
//   memory; y is written straight into the rx-major (2, S, nt, C) layout.
//
// Bound on an H100 at the serving shape (S = 4096, nt = 32, L = 10240,
// H = 1024, C = 234): about 848 GFLOP (172 layer 1, 550 layer 2, 126
// layer 3), 0.86 ms at the 989 TFLOP/s bf16 tensor-core peak; it is
// compute-bound (inputs, weights and output are about 0.5 GB).
#include "gemm_sm90.cuh"
#include "mlp_tail.cuh"

using namespace mamimo;

namespace {

// ---------------------------------------------------------------------
// layer 1: out[p] = x[p] @ w1[p], x (2, S, L) bf16 through map mx, w1t
// (2, H, L) bf16 through map mw (make_map), out (2, S, H) f32
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(sm90::THREADS, 1)
    factored_sig_proj_kernel(const __grid_constant__ CUtensorMap mx,
                             const __grid_constant__ CUtensorMap mw,
                             float* __restrict__ out, int S, int L, int H) {
  sm90::gemm_persistent(
      &mx, &mw, S, H, 2, L, [&](int p, int row, int col, float v0, float v1) {
        if (row < S && col < H)
          *reinterpret_cast<float2*>(out + ((long long)p * S + row) * H +
                                     col) = make_float2(v0, v1);
      });
}

// ---------------------------------------------------------------------
// heads, layers 2 and 3
// ---------------------------------------------------------------------
// One block: 64 samples s0.. of head t of plane p. It builds h in shared
// memory and runs the W2/W3 ring of mlp_tail.cuh (tail_layers23).
__global__ void __launch_bounds__(tail::THREADS, 1)
    factored_tail_kernel(const float* __restrict__ sp,
                         const float* __restrict__ hb,
                         const float* __restrict__ a1,
                         const float* __restrict__ c1,
                         const bf16* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ a2,
                         const float* __restrict__ c2,
                         const bf16* __restrict__ w3,
                         const float* __restrict__ b3,
                         float* __restrict__ out, int S, int nt, int H,
                         int C) {
  using namespace tail;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, s0 = blockIdx.y * TBM, p = blockIdx.z;
  sp += (long long)p * S * H;
  hb += ((long long)p * nt + t) * H;
  a1 += (long long)p * H;
  c1 += (long long)p * H;
  w2 += (long long)p * H * H;
  b2 += (long long)p * H;
  a2 += (long long)p * H;
  c2 += (long long)p * H;
  w3 += (long long)p * H * OPP;
  b3 += (long long)p * OPP;

  float accy[2][8][4];
  // h = relu(sig_proj + hb[t]) * a1 + c1, bf16, rows past S are zero
  tail_layers23(accy, w2, b2, a2, c2, w3, H, H, [&](bf16* sH, int HP) {
#pragma unroll 4
    for (int idx = tid * 4; idx < TBM * H; idx += THREADS * 4) {
      const int r = idx / H, k = idx - r * H;
      const int s = s0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < S) {
        const float4 x =
            *reinterpret_cast<const float4*>(sp + (long long)s * H + k);
        const float4 b = *reinterpret_cast<const float4*>(hb + k);
        const float4 a = *reinterpret_cast<const float4*>(a1 + k);
        const float4 c = *reinterpret_cast<const float4*>(c1 + k);
        v.x = fmaxf(x.x + b.x, 0.f) * a.x + c.x;
        v.y = fmaxf(x.y + b.y, 0.f) * a.y + c.y;
        v.z = fmaxf(x.z + b.z, 0.f) * a.z + c.z;
        v.w = fmaxf(x.w + b.w, 0.f) * a.w + c.w;
      }
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(sH + r * HP + k);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  });

  // y + b3 -> out[p][s][t][c], c < C
  const int wm = (warp >> 2) * 32, wn3 = (warp & 3) * 64;
  const int g = lane >> 2, q = (lane & 3) * 2;
  float* op = out + (long long)p * S * nt * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = wn3 + j * 8 + q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s0 + wm + i * 16 + g + hh * 8;
        if (s >= S) continue;
        float* o = op + ((long long)s * nt + t) * C;
        if (col < C) o[col] = accy[i][j][2 * hh] + b3[col];
        if (col + 1 < C) o[col + 1] = accy[i][j][2 * hh + 1] + b3[col + 1];
      }
    }
}

}  // namespace

extern "C" {

// x (2, S, L) bf16; w1t (2, H, L) bf16 (W1[:L] transposed); out (2, S, H)
// f32. L % 8 == 0, H % 128 == 0, x and w1t 16-byte aligned.
int factored_sig_proj_launch(const void* x, const void* w1t, void* out,
                             int S, int L, int H, void* stream) {
  CUtensorMap mx, mw;
  int rc = sm90::make_map(&mx, x, L, S, 2, sm90::BM, L);
  if (rc == 0)
    rc = sm90::make_map(&mw, w1t, L, H, 2, sm90::B_SLICE_ROWS, L);
  if (rc != 0) return rc;
  return sm90::launch(factored_sig_proj_kernel, S, H, 2,
                      (cudaStream_t)stream, mx, mw, (float*)out, S, L, H);
}

// sp (2, S, H) f32; hb (2, nt, H) f32; a1, c1, b2, a2, c2 (2, H) f32;
// w2 (2, H, H) bf16; w3 (2, H, 256) bf16; b3 (2, 256) f32;
// out (2, S, nt, C) f32.
int factored_tail_launch(const void* sp, const void* hb, const void* a1,
                         const void* c1, const void* w2, const void* b2,
                         const void* a2, const void* c2, const void* w3,
                         const void* b3, void* out, int S, int nt, int H,
                         int C, void* stream) {
  const int smem = tail::smem_bytes(H);
  cudaError_t e = cudaFuncSetAttribute(
      factored_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nt, (S + tail::TBM - 1) / tail::TBM, 2);
  factored_tail_kernel<<<grid, tail::THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)sp, (const float*)hb, (const float*)a1, (const float*)c1,
      (const bf16*)w2, (const float*)b2, (const float*)a2, (const float*)c2,
      (const bf16*)w3, (const float*)b3, (float*)out, S, nt, H, C);
  return (int)cudaGetLastError();
}

const char* fused_factored_error_string(int e) {
  return sm90::error_string(e);
}

}  // extern "C"
