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
// * factored_sig_proj_kernel: the layer-1 GEMM, a 128x128 bf16 tile GEMM
//   (mma.sync, cp.async ring). Its f32 output is S x H per plane, small
//   next to the (S*nt) x H activations that follow.
// * factored_tail_kernel: one block owns 64 samples of one head t. It
//   builds h in shared memory (bf16), then walks W2 in 128-column chunks:
//   each chunk's h2 = h @ W2[:, chunk] goes through its bias, ReLU and BN
//   affine into shared memory, and y += h2_chunk @ W3[chunk] accumulates
//   in registers. h and h2 never reach device memory; y is written
//   straight into the rx-major (2, S, nt, C) layout.
//
// Bound on an H100 at the serving shape (S = 4096, nt = 32, L = 10240,
// H = 1024, C = 234): about 848 GFLOP (172 layer 1, 550 layer 2, 126
// layer 3), 0.86 ms at the 989 TFLOP/s bf16 tensor-core peak; it is
// compute-bound (inputs, weights and output are about 0.5 GB).
#include "mma_tile.cuh"

using namespace mamimo;

namespace {

// ---------------------------------------------------------------------
// layer 1: out[p] = x[p] @ w1[p], x (2, S, L) bf16, w1 (2, L, H) bf16
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(g128::THREADS, 2)
    factored_sig_proj_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w1,
                             float* __restrict__ out, int S, int L, int H) {
  using namespace g128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, p = blockIdx.z;
  const bf16* xp = x + (long long)p * S * L;
  const bf16* wp = w1 + (long long)p * L * H;
  float* op = out + (long long)p * S * H;

  auto a_src = [&](int row, int k, bool& ok) -> const bf16* {
    const int gr = m0 + row;
    ok = gr < S;
    return ok ? xp + (long long)gr * L + k : xp;
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  gemm128_mainloop(acc, smem, a_src, wp, H, n0, L);

  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + i * 16 + g, col = n0 + wn + j * 8 + q;
      if (row < S)
        *reinterpret_cast<float2*>(op + (long long)row * H + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < S)
        *reinterpret_cast<float2*>(op + (long long)(row + 8) * H + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// ---------------------------------------------------------------------
// heads, layers 2 and 3
// ---------------------------------------------------------------------
// Phase cuts for tools/probe_tail.py, which times the tail kernel built
// with -DTAIL_CUT=<bits> (its answers are then wrong): 1 skips building h,
// 2 the ring loop, 4 the layer-3 products, 8 the layer-2 products. The
// default, 0, is the kernel.
#ifndef TAIL_CUT
#define TAIL_CUT 0
#endif

constexpr int TBM = 64;       // samples per block (one head)
constexpr int NC = 128;       // W2 column chunk = layer-3 k chunk
constexpr int TBK2 = 64;      // k rows of a W2 tile
constexpr int TBK3 = 32;      // k rows of a W3 tile
constexpr int TSTAGES = 4;    // cp.async ring depth
constexpr int OPP = 256;      // padded output width (round_up(C, 128))
constexpr int TTHREADS = 256;
constexpr int W2P = NC + 8;   // pitches: rows 16 bytes off a 128-byte
constexpr int H2P = NC + 8;   // multiple, so ldmatrix is conflict-free
constexpr int W3P = OPP + 8;
// a ring stage holds one W2 tile (64 x 128) or one W3 tile (32 x 256)
constexpr int RING_STAGE =
    TBK2 * W2P > TBK3 * W3P ? TBK2 * W2P : TBK3 * W3P;

__host__ __device__ inline int tail_smem_bytes(int H) {
  return 2 * (TBM * (H + 8) + TSTAGES * RING_STAGE + TBM * H2P);
}

// One block: 64 samples s0.. of head t of plane p. The B operands of
// both products stream through ONE cp.async ring, in the order they are
// consumed: for each 128-column chunk of W2, its H/64 k-tiles
// (64 x 128) and then the chunk's 4 W3 k-tiles (32 x 256). Every ring
// step is one k-step of either product (32 mma per warp), so the ring
// prefetches TSTAGES-1 steps ahead across chunk boundaries.
__global__ void __launch_bounds__(TTHREADS, 1)
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = H + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem);
  bf16* ring = sH + TBM * HP;
  bf16* sH2 = ring + TSTAGES * RING_STAGE;

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

  const int KT = H / TBK2;           // W2 k-steps per chunk
  constexpr int K3 = NC / TBK3;      // W3 k-steps per chunk
  const int IPC = KT + K3;           // ring steps per chunk
  const int NIT = (H / NC) * IPC;

  auto load = [&](int stage, int it) {
    bf16* dst = ring + stage * RING_STAGE;
    const int chunk = it / IPC, r = it - chunk * IPC;
    if (r < KT) {                    // W2[r*64 .. +64, chunk*128 .. +128]
#pragma unroll
      for (int i = 0; i < (TBK2 * NC / 8) / TTHREADS; ++i) {
        const int c = tid + i * TTHREADS;
        const int row = c / (NC / 8), cc = (c % (NC / 8)) * 8;
        cp_async16(dst + row * W2P + cc,
                   w2 + (long long)(r * TBK2 + row) * H + chunk * NC + cc,
                   true);
      }
    } else {                         // W3[chunk*128 + (r-KT)*32 .. +32, :]
      const int k0 = chunk * NC + (r - KT) * TBK3;
#pragma unroll
      for (int i = 0; i < (TBK3 * OPP / 8) / TTHREADS; ++i) {
        const int c = tid + i * TTHREADS;
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

  // h = relu(sig_proj + hb[t]) * a1 + c1, bf16, rows past S are zero
#pragma unroll 4
  for (int idx = tid * 4; !(TAIL_CUT & 1) && idx < TBM * H;
       idx += TTHREADS * 4) {
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

  // warp tiles (8 warps as 2 x 4): layer 2 32x32 of the 64x128 chunk,
  // layer 3 32x64 of the 64x256 output
  const int wm = (warp >> 2) * 32;
  const int wn2 = (warp & 3) * 32;
  const int wn3 = (warp & 3) * 64;
  const int g = lane >> 2, q = (lane & 3) * 2;

  float acc2[2][4][4];
  float accy[2][8][4];
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
        // h2 chunk: bias, ReLU, BN affine (f32) -> bf16 in shared memory
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

  // y + b3 -> out[p][s][t][c], c < C
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

// x (2, S, L) bf16; w1 (2, L, H) bf16; out (2, S, H) f32.
int factored_sig_proj_launch(const void* x, const void* w1, void* out, int S,
                             int L, int H, void* stream) {
  const int smem = g128::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      factored_sig_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / g128::BN, (S + g128::BM - 1) / g128::BM, 2);
  factored_sig_proj_kernel<<<grid, g128::THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (float*)out, S, L, H);
  return (int)cudaGetLastError();
}

// sp (2, S, H) f32; hb (2, nt, H) f32; a1, c1, b2, a2, c2 (2, H) f32;
// w2 (2, H, H) bf16; w3 (2, H, 256) bf16; b3 (2, 256) f32;
// out (2, S, nt, C) f32.
int factored_tail_launch(const void* sp, const void* hb, const void* a1,
                         const void* c1, const void* w2, const void* b2,
                         const void* a2, const void* c2, const void* w3,
                         const void* b3, void* out, int S, int nt, int H,
                         int C, void* stream) {
  const int smem = tail_smem_bytes(H);
  cudaError_t e = cudaFuncSetAttribute(
      factored_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nt, (S + TBM - 1) / TBM, 2);
  factored_tail_kernel<<<grid, TTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)sp, (const float*)hb, (const float*)a1, (const float*)c1,
      (const bf16*)w2, (const float*)b2, (const float*)a2, (const float*)c2,
      (const bf16*)w3, (const float*)b3, (float*)out, S, nt, H, C);
  return (int)cudaGetLastError();
}

const char* fused_factored_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
