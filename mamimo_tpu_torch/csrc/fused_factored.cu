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
//   Where its tile groups cannot fill the card (few rows, long K: Nt >=
//   512), factored_sig_proj_split_kernel splits K instead (below).
// * factored_tail_kernel: one block owns 64 samples of one head t; the
//   blocks of a cluster take neighbouring heads of the same samples (they
//   read the same sig_proj rows and share every W2/W3 tile by TMA
//   multicast). Its threads build h in shared memory (bf16, in the
//   swizzled layout wgmma reads), then the Hopper tail of tail_sm90.cuh
//   (shared with the materialized-input MLP of mlp_infer.cu) walks W2 in
//   128-column chunks: each chunk's h2 = h @ W2[:, chunk] goes through its
//   bias, ReLU and BN affine in registers, and y += h2_chunk @ W3[chunk]
//   accumulates in registers. h and h2 never reach device memory; y is
//   written straight into the rx-major (2, S, nt, C) layout. W2 and W3
//   are read K-major from w2t and w3t (prepare_factored_weights). It
//   serves H1 <= 1024, where h fits in shared memory.
// * Other depths and wider layers (the TPU kernel takes two hidden
//   layers only; the JAX serving call runs any depth in XLA):
//   factored_heads_kernel writes the per-head rows h0 = relu(sig_proj +
//   hb) a1 + c1 (2, S*nt, H1) bf16 to device memory;
//   factored_dense_launch runs each hidden layer after the first but the
//   last (bf16 rows out, staged in shared memory and stored by TMA while
//   the next tile's products run), or at depth 1 the output layer (f32
//   or bf16 row pieces), on mm_sm90.cuh's walk (mm::rows_gemm_kernel,
//   the tails' GEMM; its own kernel on gemm_sm90.cuh's persistent walk
//   stored accumulator pairs from registers after each tile's products,
//   PERF.md section 6, row 2d);
//   factored_rows_gemms_launch runs the last hidden layer and the output
//   as two GEMMs on that walk (mm::rows_gemms): the last hidden layer's
//   rows through device memory. It
//   replaces a fused tail on tail_sm90.cuh (TMA-loaded rows, the hidden
//   activation on chip, streamed slab by slab above 1024 units), which
//   took 1.5-2.0x as long on an H100 at every width served (PERF.md);
//   that tail had replaced building h slab by slab inside factored_tail
//   at depth 2 (11% of its bound at H 2048).
//
// The float32 mode (float32 weights from prepare_factored_weights(...,
// dot_dtype=float32): JAX's dot_dtype=float32, the TPU kernel's products
// on float32 operands) runs every layer at float32 accuracy as 3xTF32 on
// wgmma (gemm_sm90.cuh, wgmma_3xtf32_rs), always through the per-head rows,
// which stay float32 as JAX keeps h in float32: factored_sig_proj_f32_
// kernel and factored_dense_f32_kernel on gemm_sm90.cuh's float32 body
// gemm_tf32x3 (plain, hidden-layer and output epilogues; layer 1 with K
// split across the card where its tiles cannot fill it,
// factored_sig_proj_split_f32_kernel on gemm_tf32x3's split walk, as the
// bf16 layer 1), factored_heads_f32_kernel (elementwise),
// factored_rows_tail_f32_kernel on tail_sm90.cuh's layers23_f32. Their
// K-major weights come as TF32 high and low parts, split once by
// prepare_factored_weights (tf32_split.cu); the rows are split in
// registers. The output stores
// of the tails and of factored_dense's output layer also come rounded to
// bf16 (out_dtype bfloat16, as the TPU kernel's default), to nearest
// even: the float32 result rounded. The launch functions take a mode:
// bit 0 the bf16 store, bit 1 float32 operands.
//
// Bound on an H100 at the serving shape (S = 4096, nt = 32, L = 10240,
// H = 1024, C = 234): about 848 GFLOP (172 layer 1, 550 layer 2, 126
// layer 3), 0.86 ms at the 989 TFLOP/s bf16 tensor-core peak; it is
// compute-bound (inputs, weights and output are about 0.5 GB).
#include "mm_sm90.cuh"
#include "tail_sm90.cuh"

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

// Layer 1 where its 128 x 256 tile groups are too few to fill the card
// (the issue at Nt >= 512, where K = L = 320 Nt is long and M = S rows a
// plane is small: at Nt 1024, S = 128, 8 tile groups of two M-tiles, one
// of them past M, for 132 SMs, each streaming a whole N-tile of W1 over
// K): gemm_persistent's split walk, K cut into `splits` ranges (the
// wrapper's plan, fused_factored.py::sig_proj_splits), one cluster a
// unit (M-tile group, N-tile, plane, range): CL = 1 block at one M-tile
// (no block on the zero rows past M), else a pair of M-tiles sharing the
// B tile (at Nt 512, S = 512, one block a unit read 3.9 GB from L2 and
// took 0.71 ms on an H100). Each writes its float32 partial to ws
// (splits, 2, S, H). split_sum_kernel then sums the partials in range
// order into out: deterministic, no atomics, and each range's truncating
// tensor-core additions run over K / splits only. Bound: W1's bytes
// (1.34 GB at Nt 1024, 0.40 ms at 3.35 TB/s), which the units read once
// between them; the partials add 2 x splits x S x H x 4 bytes (16.8 MB
// at that shape, written once and read once). The float32 mode splits
// the same way on gemm_tf32x3 (factored_sig_proj_split_f32_kernel below;
// 128 x 128 tiles: at Nt 1024, S = 128, 16 one-block units where one
// range ran on 16 SMs): its epilogue is a plain store as this one's.
template <int CL>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    factored_sig_proj_split_kernel(const __grid_constant__ CUtensorMap mx,
                                   const __grid_constant__ CUtensorMap mw,
                                   float* __restrict__ ws, int S, int L,
                                   int H, int splits) {
  sm90::gemm_persistent<CL, true>(
      &mx, &mw, S, H, 2, L,
      [&](int p, int row, int col, float v0, float v1) {
        if (row < S && col < H)
          *reinterpret_cast<float2*>(ws + ((long long)p * S + row) * H +
                                     col) = make_float2(v0, v1);
      },
      splits);
}

// out[i] = ws[i] + ws[n + i] + ... + ws[(splits - 1) n + i], added in
// that order in float32, four floats a thread (n = 4 n4 floats).
__global__ void __launch_bounds__(256)
    split_sum_kernel(const float4* __restrict__ ws, float4* __restrict__ out,
                     long long n4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = ws[i];
  for (int j = 1; j < splits; ++j) {
    const float4 b = ws[j * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

// The float32 mode: x (2, S, L) f32 through map mx (make_map_f32, box
// 32 x 128), w1t's TF32 parts (2, 2, H, L) f32 through map mw (box 32 x
// TF_SLICE_ROWS, plane 2p + part); out (2, S, H) f32.
__global__ void __launch_bounds__(sm90::THREADS, 1)
    factored_sig_proj_f32_kernel(const __grid_constant__ CUtensorMap mx,
                                 const __grid_constant__ CUtensorMap mw,
                                 float* __restrict__ out, int S, int L,
                                 int H) {
  sm90::gemm_tf32x3(
      &mx, &mw, S, H, 2, L, [&](int p, int row, int col, float v0, float v1) {
        if (row < S && col < H)
          sm90::put2(out + ((long long)p * S + row) * H + col, v0, v1);
      });
}

// The float32 mode with K split across the card: gemm_tf32x3's split
// walk on the maps of factored_sig_proj_f32_kernel, each range's float32
// partial into ws (splits, 2, S, H), summed by split_sum_kernel. Both TF32
// parts of W1 are read (5.37 GB at Nt 1024: 1.60 ms at 3.35 TB/s, twice
// the float32 W1's bytes); CL = 1 at one M-tile.
template <int CL>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    factored_sig_proj_split_f32_kernel(const __grid_constant__ CUtensorMap mx,
                                       const __grid_constant__ CUtensorMap mw,
                                       float* __restrict__ ws, int S, int L,
                                       int H, int splits) {
  sm90::gemm_tf32x3<CL, true>(
      &mx, &mw, S, H, 2, L,
      [&](int p, int row, int col, float v0, float v1) {
        if (row < S && col < H)
          sm90::put2(ws + ((long long)p * S + row) * H + col, v0, v1);
      },
      splits);
}

// ---------------------------------------------------------------------
// heads, layers 2 and 3
// ---------------------------------------------------------------------
// y + b3 (b3 one plane's) -> o[row * C + col], col < C, as T (f32, or
// bf16 rounded to nearest even)
template <class T>
__device__ __forceinline__ void store_y(T* o, const float* b3, int C,
                                       int col, float v0, float v1) {
  if (col >= C) return;
  o += col;
  if ((C & 1) == 0) {
    sm90::put2(o, v0 + b3[col], v1 + b3[col + 1]);
  } else {
    sm90::put1(o, v0 + b3[col]);
    if (col + 1 < C) sm90::put1(o + 1, v1 + b3[col + 1]);
  }
}

// One block: 64 samples s0.. of head t of plane p (heads t >= nt pad the
// last cluster: they load their share of the weights and store nothing).
// It builds h in shared memory and runs tail::layers23; w2t (2, H2, H1)
// and w3t (2, 256, H2) come through the maps mw2 and mw3; b3 (2, ldb3);
// out (2, S, nt, C) as T.
template <class T>
__global__ void __launch_bounds__(tail::THREADS, 1)
    factored_tail_kernel(const __grid_constant__ CUtensorMap mw2,
                         const __grid_constant__ CUtensorMap mw3,
                         const float* __restrict__ sp,
                         const float* __restrict__ hb,
                         const float* __restrict__ a1,
                         const float* __restrict__ c1,
                         const float* __restrict__ b2,
                         const float* __restrict__ a2,
                         const float* __restrict__ c2,
                         const float* __restrict__ b3,
                         T* __restrict__ out, int S, int nt, int H1,
                         int H2, int C, int ldb3) {
  using namespace tail;
  const int t = blockIdx.x, s0 = blockIdx.y * ROWS, p = blockIdx.z;
  const bool head = t < nt;
  sp += (long long)p * S * H1;
  hb += ((long long)p * nt + (head ? t : 0)) * H1;
  a1 += (long long)p * H1;
  c1 += (long long)p * H1;
  b2 += (long long)p * H2;
  a2 += (long long)p * H2;
  c2 += (long long)p * H2;
  b3 += (long long)p * ldb3;
  T* op = out + (long long)p * S * nt * C;

  tail::layers23<false>(
      nullptr, 0, &mw2, &mw3, p, H1, H2, b2, a2, c2,
      // h = relu(sig_proj + hb[t]) * a1 + c1, bf16; rows past S zero
      [&](unsigned char* sh, int i) {
        const int vpr = H1 / 8;          // 16-byte chunks of an h row
        // ROWS * vpr is a multiple of 4 * 256: four chunks a thread per
        // pass, their sig_proj loads issued together
        for (int idx0 = i; idx0 < ROWS * vpr; idx0 += 4 * 256) {
          float4 x[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int idx = idx0 + u * 256, r = idx / vpr;
            const int k = (idx - r * vpr) * 8, s = s0 + r;
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            const float4* src =
                reinterpret_cast<const float4*>(sp + (long long)s * H1 + k);
            x[u][0] = (s < S && head) ? __ldg(src) : z;
            x[u][1] = (s < S && head) ? __ldg(src + 1) : z;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int idx = idx0 + u * 256, r = idx / vpr;
            const int kc = idx - r * vpr, k = kc * 8, s = s0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (s < S && head) {
              const float4* b = reinterpret_cast<const float4*>(hb + k);
              const float4* a = reinterpret_cast<const float4*>(a1 + k);
              const float4* c = reinterpret_cast<const float4*>(c1 + k);
              uint32_t* o = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4 xx = x[u][h], bb = b[h], aa = a[h], cc = c[h];
                o[2 * h] =
                    pack_bf16(fmaxf(xx.x + bb.x, 0.f) * aa.x + cc.x,
                              fmaxf(xx.y + bb.y, 0.f) * aa.y + cc.y);
                o[2 * h + 1] =
                    pack_bf16(fmaxf(xx.z + bb.z, 0.f) * aa.z + cc.z,
                              fmaxf(xx.w + bb.w, 0.f) * aa.w + cc.w);
              }
            }
            *reinterpret_cast<uint4*>(sh + h_offset(r, kc)) = v;
          }
        }
      },
      // y + b3 -> out[p][s][t][c], c < C
      [&](int row, int col, float v0, float v1) {
        const int s = s0 + row;
        if (head && s < S)
          store_y(op + ((long long)s * nt + t) * C, b3, C, col, v0, v1);
      });
}

// ---------------------------------------------------------------------
// depths other than 2, and layers above 1024 units: the per-head rows
// in device memory
// ---------------------------------------------------------------------
// h0[p][s*nt + t] = bf16(relu(sp[p][s] + hb[p][t]) * a1[p] + c1[p]):
// sp (2, S, H) f32, hb (2, nt, H), a1, c1 (2, H); h0 (2, S*nt, H) bf16.
// Bound on an H100: the bytes, 2 S nt H bf16 written and sp read once
// (0.17 ms at S = 4096, nt = 32, H = 1024, 3.35 TB/s). A warp takes one
// (plane, sample, 256-column chunk): lane l keeps columns 256 j + 8 l ..
// + 7 of the sample's sig_proj row, of a1 and of c1 in registers and
// walks the heads t = 0 .. nt - 1, reading hb[p][t]'s 32 bytes (from L1:
// a block's HEADS_WARPS warps take consecutive samples of one chunk and
// plane) and writing 16 bytes. So the warp writes each row's chunk as one
// 512-byte piece, rows s*nt + t in order, its offsets stepped by H and
// never divided (the grid-stride kernel it replaces did five 64-bit
// divisions and loaded 128 bytes a 16-byte store: 49% of the bound).
constexpr int HEADS_WARPS = 8;        // samples of a block
constexpr int HEADS_CHUNK = 256;      // columns of a warp: 8 a lane

__global__ void __launch_bounds__(32 * HEADS_WARPS)
    factored_heads_kernel(const float* __restrict__ sp,
                          const float* __restrict__ hb,
                          const float* __restrict__ a1,
                          const float* __restrict__ c1,
                          bf16* __restrict__ h0, int S, int nt, int H) {
  const int p = blockIdx.z;
  const int k = blockIdx.y * HEADS_CHUNK + 8 * (threadIdx.x % 32);
  const int s = blockIdx.x * HEADS_WARPS + threadIdx.x / 32;
  if (s >= S || k >= H) return;
  const long long ps = (long long)p * S + s;   // the sample's sig_proj row
  const float4* xp = reinterpret_cast<const float4*>(sp + ps * H + k);
  const long long pk = (long long)p * H + k;    // a1's and c1's columns
  const float4* ap = reinterpret_cast<const float4*>(a1 + pk);
  const float4* cp = reinterpret_cast<const float4*>(c1 + pk);
  const float4 x[2] = {__ldg(xp), __ldg(xp + 1)};
  const float4 a[2] = {__ldg(ap), __ldg(ap + 1)};
  const float4 c[2] = {__ldg(cp), __ldg(cp + 1)};
  const float* b = hb + (long long)p * nt * H + k;     // head t's columns
  bf16* o = h0 + ps * nt * H + k;                      // row s*nt + t's
#pragma unroll 4
  for (int t = 0; t < nt; ++t, b += H, o += H) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 xx = x[h], aa = a[h], cc = c[h],
                   bb = __ldg(reinterpret_cast<const float4*>(b) + h);
      w[2 * h] = tail::pack_bf16(fmaxf(xx.x + bb.x, 0.f) * aa.x + cc.x,
                                 fmaxf(xx.y + bb.y, 0.f) * aa.y + cc.y);
      w[2 * h + 1] = tail::pack_bf16(fmaxf(xx.z + bb.z, 0.f) * aa.z + cc.z,
                                     fmaxf(xx.w + bb.w, 0.f) * aa.w + cc.w);
    }
    *reinterpret_cast<uint4*>(o) = v;
  }
}

// The float32 mode: h0[p][s*nt + t] = relu(sp[p][s] + hb[p][t]) * a1[p]
// + c1[p] as f32 rows (2, S*nt, H). One thread writes 4 columns (16
// bytes), rows in order.
__global__ void factored_heads_f32_kernel(const float* __restrict__ sp,
                                          const float* __restrict__ hb,
                                          const float* __restrict__ a1,
                                          const float* __restrict__ c1,
                                          float* __restrict__ h0, int S,
                                          int nt, int H) {
  const int vpr = H / 4;
  const long long n = 2LL * S * nt * vpr;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(idx % vpr) * 4;
    const long long row = idx / vpr;           // (p * S + s) * nt + t
    const int t = (int)(row % nt);
    const long long ps = row / nt;             // p * S + s
    const int p = (int)(ps / S);
    const float4 x = __ldg(reinterpret_cast<const float4*>(sp + ps * H + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(
        hb + ((long long)p * nt + t) * H + k));
    const float4 a =
        __ldg(reinterpret_cast<const float4*>(a1 + (long long)p * H + k));
    const float4 c =
        __ldg(reinterpret_cast<const float4*>(c1 + (long long)p * H + k));
    *reinterpret_cast<float4*>(h0 + row * H + k) =
        make_float4(fmaxf(x.x + b.x, 0.f) * a.x + c.x,
                    fmaxf(x.y + b.y, 0.f) * a.y + c.y,
                    fmaxf(x.z + b.z, 0.f) * a.z + c.z,
                    fmaxf(x.w + b.w, 0.f) * a.w + c.w);
  }
}

// One dense layer of both planes in the float32 mode (the bf16 mode runs
// mm::rows_gemm_kernel, factored_dense_launch): v = h[p] @ W[p], h (2, M,
// K) f32 through map mx (make_map_f32, box 32 x 128), wt's TF32 parts (2,
// 2, N, K) f32 through map mw (box 32 x TF_SLICE_ROWS, plane 2p + part).
// OUT: y = v + b as T for col < C (y (2, M, C)); else f32 rows relu(v +
// b) * a + c (2, M, N). b, a, c (2, ldb) f32.
template <bool OUT, class T>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    factored_dense_f32_kernel(const __grid_constant__ CUtensorMap mx,
                              const __grid_constant__ CUtensorMap mw,
                              const float* __restrict__ b,
                              const float* __restrict__ a,
                              const float* __restrict__ c,
                              void* __restrict__ y, int M, int N, int K,
                              int C, int ldb) {
  sm90::gemm_tf32x3(
      &mx, &mw, M, N, 2, K, [&](int p, int row, int col, float v0, float v1) {
        if (row >= M || col >= N) return;
        const long long r = (long long)p * M + row;
        const int j = p * ldb + col;
        if constexpr (OUT) {
          store_y(reinterpret_cast<T*>(y) + r * C, b + p * ldb, C, col,
                  v0, v1);
        } else {
          sm90::put2(reinterpret_cast<float*>(y) + r * N + col,
                     fmaxf(v0 + b[j], 0.f) * a[j] + c[j],
                     fmaxf(v1 + b[j + 1], 0.f) * a[j + 1] + c[j + 1]);
        }
      });
}

// The float32 mode: h (2, M, H1) f32 through map mh (box 32 x 64), the
// TF32 parts of w2t (2, 2, H2, H1) and of w3t (2, 2, 256, H2) f32
// through mw2, mw3 (box 32 x SLICE_ROWS, plane 2p + part);
// tail::layers23_f32 on 64 rows m0.. of plane blockIdx.z.
template <class T>
__global__ void __launch_bounds__(tail::THREADS, 1)
    factored_rows_tail_f32_kernel(const __grid_constant__ CUtensorMap mh,
                                  const __grid_constant__ CUtensorMap mw2,
                                  const __grid_constant__ CUtensorMap mw3,
                                  const float* __restrict__ b2,
                                  const float* __restrict__ a2,
                                  const float* __restrict__ c2,
                                  const float* __restrict__ b3,
                                  T* __restrict__ y, int M, int H1, int H2,
                                  int C, int ldb3) {
  const int m0 = blockIdx.x * tail::ROWS, p = blockIdx.z;
  b2 += (long long)p * H2;
  a2 += (long long)p * H2;
  c2 += (long long)p * H2;
  b3 += (long long)p * ldb3;
  T* yp = y + (long long)p * M * C;
  tail::layers23_f32(&mh, m0, p, &mw2, &mw3, p, H1, H2, b2, a2, c2,
                     [&](int row, int col, float v0, float v1) {
                       const int m = m0 + row;
                       if (m < M)
                         store_y(yp + (long long)m * C, b3, C, col, v0, v1);
                     });
}

}  // namespace

// The launch functions' mode: bit 0 stores the output rounded to bf16,
// bit 1 takes float32 operands (the float32 mode). Each returns a CUDA
// error code (or sm90::ERR_TENSOR_MAP).
constexpr int MODE_BF16_OUT = 1, MODE_F32 = 2;

extern "C" {

// x (2, S, L), w1t (2, H, L) (W1[:L] transposed): bf16 (L % 8 == 0); or
// with MODE_F32 x f32 (L % 4 == 0) and w1t the TF32 parts of W1[:L]
// transposed, (2, 2, H, L) f32 (tf32_split); out (2, S, H) f32. H % 128
// == 0, x and w1t 16-byte aligned. splits > 1: the split walk into ws
// (splits, 2, S, H) f32, 16-byte aligned, then the sum into out; every
// range of ceil(KT / splits) k-steps must hold one (KT = ceil(L / 64) in
// bf16, ceil(L / 32) in the float32 mode). splits 0 or 1: one range, ws
// unused.
int factored_sig_proj_launch(const void* x, const void* w1t, void* out,
                             int S, int L, int H, int mode, void* ws,
                             int splits, void* stream) {
  if (mode != 0 && mode != MODE_F32) return (int)cudaErrorInvalidValue;
  const bool f32 = mode == MODE_F32;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap mx, mw;
  int rc;
  if (f32) {
    if (sm90::make_map_f32(&mx, x, L, S, 2, 128, L) ||
        sm90::make_map_f32(&mw, w1t, L, H, 4, sm90::TF_SLICE_ROWS, L))
      return sm90::ERR_TENSOR_MAP;
    if (splits <= 1)
      return sm90::launch_tf32x3(factored_sig_proj_f32_kernel, S, H, 2, st,
                                 mx, mw, (float*)out, S, L, H);
  } else {
    rc = sm90::make_map(&mx, x, L, S, 2, sm90::BM, L);
    if (rc == 0)
      rc = sm90::make_map(&mw, w1t, L, H, 2, sm90::B_SLICE_ROWS, L);
    if (rc != 0) return rc;
    if (splits <= 1)
      return sm90::launch(factored_sig_proj_kernel, S, H, 2, st, mx, mw,
                          (float*)out, S, L, H);
  }
  const int bk = f32 ? sm90::TF_K : sm90::BK;
  const int KT = (L + bk - 1) / bk;
  if ((splits - 1) * ((KT + splits - 1) / splits) >= KT)
    return (int)cudaErrorInvalidValue;                 // an empty range
  float* w = (float*)ws;
  if (f32)
    rc = S <= 128 ? sm90::launch_tf32x3_split<1>(
                        factored_sig_proj_split_f32_kernel<1>, S, H, 2,
                        splits, st, mx, mw, w, S, L, H, splits)
                  : sm90::launch_tf32x3_split<sm90::TF_CLUSTER>(
                        factored_sig_proj_split_f32_kernel<sm90::TF_CLUSTER>,
                        S, H, 2, splits, st, mx, mw, w, S, L, H, splits);
  else
    rc = S <= sm90::BM
             ? sm90::launch_split<1>(factored_sig_proj_split_kernel<1>, S,
                                     H, 2, splits, st, mx, mw, w, S, L, H,
                                     splits)
             : sm90::launch_split<sm90::CLUSTER>(
                   factored_sig_proj_split_kernel<sm90::CLUSTER>, S, H, 2,
                   splits, st, mx, mw, w, S, L, H, splits);
  if (rc != 0) return rc;
  const long long n4 = 2LL * S * H / 4;
  split_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      (const float4*)ws, (float4*)out, n4, splits);
  return (int)cudaGetLastError();
}

// sp (2, S, H1) f32; hb (2, nt, H1) f32; a1, c1 (2, H1) f32; w2t (2, H2,
// H1) bf16 (W2 transposed); b2, a2, c2 (2, H2) f32; w3t (2, 256, H2)
// bf16 (padded W3 transposed); b3 (2, ldb3) f32; out (2, S, nt, C) f32,
// or bf16 with MODE_BF16_OUT. H1, H2 % 128 == 0, H1 <= 1024 (h is kept
// whole), C <= 256, w2t and w3t 16-byte aligned. bf16 weights only.
int factored_tail_launch(const void* sp, const void* hb, const void* a1,
                         const void* c1, const void* w2t, const void* b2,
                         const void* a2, const void* c2, const void* w3t,
                         const void* b3, void* out, int S, int nt, int H1,
                         int H2, int C, int ldb3, int mode, void* stream) {
  if (H1 > tail::MAX_RESIDENT || (mode & ~MODE_BF16_OUT))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mw2, mw3;
  int rc = sm90::make_map(&mw2, w2t, H1, H2, 2, tail::SLICE_ROWS, H1);
  if (rc == 0)
    rc = sm90::make_map(&mw3, w3t, H2, tail::OPP, 2, tail::SLICE_ROWS, H2);
  if (rc != 0) return rc;
  const dim3 grid((nt + tail::CL - 1) / tail::CL * tail::CL,
                  (S + tail::ROWS - 1) / tail::ROWS, 2);
  const int smem = tail::smem_bytes(H1);
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode & MODE_BF16_OUT)
    return tail::launch(factored_tail_kernel<bf16>, grid, smem, st, mw2, mw3,
                        (const float*)sp, (const float*)hb,
                        (const float*)a1, (const float*)c1,
                        (const float*)b2, (const float*)a2,
                        (const float*)c2, (const float*)b3, (bf16*)out, S,
                        nt, H1, H2, C, ldb3);
  return tail::launch(factored_tail_kernel<float>, grid, smem, st, mw2, mw3,
                      (const float*)sp, (const float*)hb, (const float*)a1,
                      (const float*)c1, (const float*)b2, (const float*)a2,
                      (const float*)c2, (const float*)b3, (float*)out, S, nt,
                      H1, H2, C, ldb3);
}

// sp (2, S, H) f32; hb (2, nt, H) f32; a1, c1 (2, H) f32; h0 (2, S*nt,
// H) bf16 (H % 8 == 0), or f32 with MODE_F32 (H % 4 == 0); all 16-byte
// aligned.
int factored_heads_launch(const void* sp, const void* hb, const void* a1,
                          const void* c1, void* h0, int S, int nt, int H,
                          int mode, void* stream) {
  if (mode != 0 && mode != MODE_F32) return (int)cudaErrorInvalidValue;
  if (mode == MODE_F32) {
    const long long n = 2LL * S * nt * (H / 4);  // 4 columns a thread
    const int threads = 256;
    const long long want = (n + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    factored_heads_f32_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)sp, (const float*)hb, (const float*)a1,
        (const float*)c1, (float*)h0, S, nt, H);
  } else {
    // a block: HEADS_WARPS samples x one chunk of one plane
    const dim3 grid((S + HEADS_WARPS - 1) / HEADS_WARPS,
                    (H + HEADS_CHUNK - 1) / HEADS_CHUNK, 2);
    factored_heads_kernel<<<grid, 32 * HEADS_WARPS, 0,
                            (cudaStream_t)stream>>>(
        (const float*)sp, (const float*)hb, (const float*)a1,
        (const float*)c1, (bf16*)h0, S, nt, H);
  }
  return (int)cudaGetLastError();
}

// h (2, M, K), wt (2, N, K) (W transposed): bf16 (K % 8 == 0); or with
// MODE_F32 h f32 (K % 4 == 0) and wt the TF32 parts of W transposed, (2,
// 2, N, K) f32 (tf32_split); b, a, c (2, ldb) f32 (a, c unused for the
// output layer). out_layer: y (2, M, C) f32, or bf16 with MODE_BF16_OUT;
// else y the next hidden rows (2, M, N) in the operands' type (C
// unused). N % 128 == 0, h, wt and y 16-byte aligned. The hidden
// layer's epilogue reads N values of b, a and c a plane, the output
// layer's C values of b.
int factored_dense_launch(const void* h, const void* wt, const void* b,
                          const void* a, const void* c, void* y, int M,
                          int N, int K, int C, int ldb, int out_layer,
                          int mode, void* stream) {
  if (mode < 0 || mode > 3 || (!out_layer && (mode & MODE_BF16_OUT)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fb = (const float*)b, *fa = (const float*)a,
              *fc = (const float*)c;
  CUtensorMap mx, mw;
  if (mode & MODE_F32) {
    if (sm90::make_map_f32(&mx, h, K, M, 2, 128, K) ||
        sm90::make_map_f32(&mw, wt, K, N, 4, sm90::TF_SLICE_ROWS, K))
      return sm90::ERR_TENSOR_MAP;
    if (!out_layer)
      return sm90::launch_tf32x3(factored_dense_f32_kernel<false, float>, M,
                                 N, 2, st, mx, mw, fb, fa, fc, y, M, N, K, C,
                                 ldb);
    if (mode & MODE_BF16_OUT)
      return sm90::launch_tf32x3(factored_dense_f32_kernel<true, bf16>, M, N,
                                 2, st, mx, mw, fb, fa, fc, y, M, N, K, C,
                                 ldb);
    return sm90::launch_tf32x3(factored_dense_f32_kernel<true, float>, M, N,
                               2, st, mx, mw, fb, fa, fc, y, M, N, K, C, ldb);
  }
  // bf16: the tails' GEMM on mm_sm90.cuh's walk, the hidden rows staged
  // and stored by TMA, the output layer's in row pieces (its map of y is
  // unused: mx stands in)
  CUtensorMap my;
  int rc = mm::make_a_map(&mx, h, K, M, 2);
  if (rc == 0) rc = mm::make_bt_map(&mw, wt, K, N, 2);
  if (rc == 0 && !out_layer) rc = mm::make_c_map(&my, y, M, N, 2);
  if (rc != 0) return rc;
  if (!out_layer)
    return mm::launch<mm::STAGED>(mm::rows_gemm_kernel<false>, M, N, 2, st,
                                  mx, mw, my, fb, fa, fc, y, M, N, 2, K, 0,
                                  ldb);
  if (mode & MODE_BF16_OUT)
    return mm::launch(mm::rows_gemm_kernel<true, bf16>, M, N, 2, st, mx, mw,
                      mx, fb, fa, fc, y, M, N, 2, K, C, ldb);
  return mm::launch(mm::rows_gemm_kernel<true, float>, M, N, 2, st, mx, mw,
                    mx, fb, fa, fc, y, M, N, 2, K, C, ldb);
}

// factored_rows_tail's two-GEMM route: h (2, M, H1), w2t (2, H2, H1),
// w3t (2, 256, H2) bf16 (16-byte aligned, H1 % 8 == 0, H2 % 128 == 0);
// b2, a2, c2 (2, H2) f32; b3 (2, ldb3) f32. The last hidden layer's rows
// bf16(relu(h @ w2 + b2) a2 + c2) go into h2 (2, M, H2) bf16 (16-byte
// aligned), then y (2, M, C) = (h2 @ w3 + b3)[..., :C] f32, or bf16 with
// MODE_BF16_OUT (C <= 256): mm::rows_gemms on the two planes.
int factored_rows_gemms_launch(const void* h, const void* w2t,
                               const void* b2, const void* a2,
                               const void* c2, const void* w3t,
                               const void* b3, void* y, void* h2, int M,
                               int H1, int H2, int C, int ldb3, int mode,
                               void* stream) {
  if (mode < 0 || mode > MODE_BF16_OUT) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fb2 = (const float*)b2, *fa2 = (const float*)a2,
              *fc2 = (const float*)c2, *fb3 = (const float*)b3;
  if (mode & MODE_BF16_OUT)
    return mm::rows_gemms(h, w2t, fb2, fa2, fc2, w3t, fb3, (bf16*)y, h2, M,
                          H1, H2, C, 2, ldb3, st);
  return mm::rows_gemms(h, w2t, fb2, fa2, fc2, w3t, fb3, (float*)y, h2, M,
                        H1, H2, C, 2, ldb3, st);
}

// The float32 mode of factored_rows_tail (bf16 rows take
// factored_rows_gemms_launch): h (2, M, H1) f32 and w2t, w3t the TF32
// parts (2, 2, H2, H1) and (2, 2, 256, H2) f32 (tf32_split); b2, a2, c2
// (2, H2) f32; b3 (2, ldb3) f32; y (2, M, C) f32, or bf16 with
// MODE_BF16_OUT. mode must hold MODE_F32. H1 % 32 == 0, H2 % 128 == 0,
// C <= 256, h, w2t and w3t 16-byte aligned.
int factored_rows_tail_launch(const void* h, const void* w2t, const void* b2,
                              const void* a2, const void* c2,
                              const void* w3t, const void* b3, void* y,
                              int M, int H1, int H2, int C, int ldb3,
                              int mode, void* stream) {
  if (mode != MODE_F32 && mode != (MODE_F32 | MODE_BF16_OUT))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fb2 = (const float*)b2, *fa2 = (const float*)a2,
              *fc2 = (const float*)c2, *fb3 = (const float*)b3;
  const int blocks = (M + tail::ROWS - 1) / tail::ROWS;
  const dim3 grid((blocks + tail::CL - 1) / tail::CL * tail::CL, 1, 2);
  CUtensorMap mh, mw2, mw3;
  if (sm90::make_map_f32(&mh, h, H1, M, 2, tail::ROWS, H1) ||
      sm90::make_map_f32(&mw2, w2t, H1, H2, 4, tail::SLICE_ROWS, H1) ||
      sm90::make_map_f32(&mw3, w3t, H2, tail::OPP, 4, tail::SLICE_ROWS, H2))
    return sm90::ERR_TENSOR_MAP;
  if (mode & MODE_BF16_OUT)
    return tail::launch(factored_rows_tail_f32_kernel<bf16>, grid,
                        tail::F_SMEM, st, mh, mw2, mw3, fb2, fa2, fc2, fb3,
                        (bf16*)y, M, H1, H2, C, ldb3);
  return tail::launch(factored_rows_tail_f32_kernel<float>, grid,
                      tail::F_SMEM, st, mh, mw2, mw3, fb2, fa2, fc2, fb3,
                      (float*)y, M, H1, H2, C, ldb3);
}

const char* fused_factored_error_string(int e) {
  return sm90::error_string(e);
}

}  // extern "C"
