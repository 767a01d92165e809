// LS channel estimate from the canonical flat planes, dense output, in
// full mode or as one rank's partial of the sequence-sharded estimate;
// float32 or bfloat16 output, optionally with per-tile sums of h^2.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_planes_pallas_v2 (body _planes_kernel_v2): the DFT-select GEMM and
// Walsh-Hadamard despread of ls_sm90.cuh, with A the selected-bin DFT
// scaled by 1/(nltf*ltf_c). This file is only the store: the dense
// (2, S, nt, C) planes, no carrier padding, in T (float or bf16), and
// with SSQ the sums of h^2 per tile.
//
// Sequence-sharded mode (the TPU kernel's rectangular K = I (x)
// P[:, local cols], parallel/sharded.py::sharded_ls_pallas_v2 mode
// "seq"): rank i of n holds loc = nt/n symbols per sample, and its
// partial is h = P[:, i*loc:(i+1)*loc] z. The Sylvester P is
// H_n (x) H_loc, so P[a*loc + b, i*loc + m] = H_n[a, i] H_loc[b, m] with
// H_n[a, i] = (-1)^popcount(a & i): the body despreads loc rows per
// sample (w = H_loc z) and the store writes row a*loc + b as
// H_n[a, i] * w[b]. No K matrix exists; full mode is loc = nt, rank 0.
//
// Sums of h^2 (the TPU kernel's with_ssq, its benchmark checksum): ssq
// (tiles, 2, C) f32, row t the column sums over tile t's stored rows of
// each plane (at loc = 128 nh, nh = 2 .. 8, tile t holds rows p*128 ..
// +127, p = t % nh, of sample t / nh, and of a seq rank the n copies
// a*loc + p*128 .. +127 of them), taken from the f32 accumulators before
// any bf16 rounding.
// Each block writes its own 64 carriers of the row; a warp owns 16
// carriers, so the sum is each thread's 32 squares in a fixed order, then
// two xor shuffles over the 4 lanes of a carrier: deterministic, no
// atomics. A seq rank stores each despread value n times (once per a), so
// its sums are n * sum w^2. The TPU layout (n_blocks, 8, 2*Cp), broadcast
// over 8 sublanes, is not copied.
//
// Bound on an H100 at the serving shape (S = 4096, nt = 32): the bf16
// input read (134 MB: the 256 FFT samples of each 320-sample symbol, the
// CP is never read) plus the output write (245 MB in f32, 123 MB in bf16,
// plus 1.9 MB of sums) against 3.35 TB/s is about 0.113 ms in f32 and
// 0.077 ms in bf16; the GEMM is about 69 GFLOP (0.07 ms at the bf16
// tensor-core peak), so it is memory-bound. A seq rank reads 1/n of the
// input and still writes the whole (2, S, nt, C) partial, so it is
// output-bound (the JAX design: a psum of full partials).
//
// Store: through the warpgroup's staging buffers, so that a warp writes
// the block's 64 carriers of one output row as one contiguous piece (256
// bytes as 32 float2 in f32, 128 bytes as 32 bf16x2 in bf16; the 936- or
// 468-byte row pitch is not a multiple of 16, so no TMA store can write
// them). Straight from the accumulators a warp would write 4 runs of 32
// bytes, and the kernel takes twice as long (PERF.md). The variants are
// template parameters of one epilogue (V2Epi<T, SSQ>); the float32
// variant without sums is the store of the earlier single-variant kernel.
//
// Any loc up to 2048 and a symbol of any length (ls_planes_v2_any_kernel,
// ls90::ls_body<0>, launched where the NH = 1 and 2 kernels do not
// apply): the same stores, each row's symbol from ls90::Rows. At loc >=
// 512 it reads the part transform's Z (ls_parts.cu, mode bit 3), one part
// a tile; a seq rank's stores already give each part's rows the sign
// H_n[a, rank] of the rank's parts in the whole estimate. At Nt 512, S =
// 512 the bytes bound it at about 0.23 ms (the input's fft samples read
// once, the f32 output written once), the pre-pass apart.
//
// Float32 planes run the float32 mode (ls_planes_v2_f32_kernel on
// ls90::ls_body_f32, the same stores): 268 MB of f32 input at the bench
// shape, bound 0.153 ms with the f32 store.
#include "ls_sm90.cuh"

using namespace mamimo;

namespace {

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  // round to nearest even, as torch's float32 -> bfloat16 cast
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void put1(float* p, float a) { *p = a; }

__device__ __forceinline__ void put1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

template <class T, bool SSQ>
struct V2Epi {
  T* __restrict__ out;
  float* __restrict__ ssq;   // (tiles, 2, C) when SSQ, else unused
  int S, nt, log_loc, rank, C, c0;

  // Eight rounds a tile: per set (plane) and 32-row group, the threads
  // put their values (carrier c0 + 16*warp + 8h + lane/4 at tile row
  // 8j + 2*(lane%4) + e) into a staging buffer, then each warp writes
  // whole staged rows, lane l carriers 2l and 2l + 1, as row a*loc + sym
  // with H_n[a, rank] (ls90::row_coords gives sample and symbol, or
  // rows.at with NH = 0). NH: 128-symbol halves a tile (ls90::ls_body).
  template <int NH>
  __device__ __forceinline__ void store(const float (&acc0)[64],
                                        const float (&acc1)[64], int s0,
                                        int sym0, int warp, int lane,
                                        float* stg, int bar,
                                        const ls90::Rows& rows) {
    if constexpr (SSQ) {
      // tiles in order of (sample group, part of a sample)
      const int tile = NH == 1 || (NH == 0 && log_loc <= 7)
                           ? s0 >> (7 - log_loc)
                           : (s0 << (log_loc - 7)) + (sym0 >> 7);
      sums(acc0, 0, tile, warp, lane);
      sums(acc1, 1, tile, warp, lane);
    }
    rounds<NH>(acc0, 0, s0, sym0, warp, lane, stg, bar, rows);
    rounds<NH>(acc1, 1, s0, sym0, warp, lane, stg, bar, rows);
  }

  // Row `tile` of ssq, this thread's carriers of one set: its 32 values
  // of each carrier squared and summed in order, then summed over the 4
  // lanes of the carrier (lane bits 0-1) by two xor shuffles, which
  // leave every lane the same sum. Rows of samples >= S are zero (the
  // load's zero fill), and n copies of each value are stored.
  __device__ __forceinline__ void sums(const float (&acc)[64], int plane,
                                       int tile, int warp, int lane) {
    float p[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * j + 2 * h + e];
          p[h] = fmaf(v, v, p[h]);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 1);
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 2);
    }
    if (lane & 3) return;
    const float copies = (float)(nt >> log_loc);
    float* row = ssq + ((long long)tile * 2 + plane) * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 16 * warp + 8 * h + lane / 4;
      if (c < C) row[c] = copies * p[h];
    }
  }

  template <int NH>
  __device__ __forceinline__ void rounds(const float (&acc)[64], int plane,
                                         int s0, int sym0, int warp,
                                         int lane, float* stg, int bar,
                                         const ls90::Rows& rows) {
    const int loc = 1 << log_loc, n = nt >> log_loc;
    const int log_tl = NH == 1 ? log_loc : 7;       // symbols of a tile
    // row sym0 of sample 0 (sym0 is 0 with one half a tile; rows.at
    // counts it with NH = 0)
    T* const base = NH == 2 ? out + (long long)sym0 * C : out;
    const long long step = (long long)loc * C;
    const int c = c0 + 2 * lane;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      // the other buffer was read before the last barrier
      float* buf = stg + (g & 1) * ls90::STG_FLOATS;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            buf[ls90::stg_index(8 * jj + 2 * (lane & 3) + e,
                                16 * warp + 8 * h + lane / 4)] =
                acc[4 * (4 * g + jj) + 2 * h + e];
      sm90::bar_sync(bar, 128);
      if ((LS_CUT & 4) && S >= 0) continue;
#pragma unroll 2
      for (int k = 0; k < ls90::STG_ROWS / 4; ++k) {
        const int row = warp + 4 * k;
        const float2 v = *reinterpret_cast<const float2*>(
            buf + ls90::stg_index(row, 2 * lane));
        int smp, sym;
        if constexpr (NH == 0)
          rows.at(32 * g + row, smp, sym);
        else
          ls90::row_coords(32 * g + row, log_tl, smp, sym);
        const int s = s0 + smp;
        if (s >= S || c >= C) continue;
        T* o = base + (((long long)plane * S + s) * nt + sym) * C + c;
        for (int a = 0; a < n; ++a) {
          const float sg = (__popc(a & rank) & 1) ? -1.f : 1.f;
          if ((C & 1) == 0) {
            put2(o + a * step, sg * v.x, sg * v.y);
          } else {
            put1(o + a * step, sg * v.x);
            if (c + 1 < C) put1(o + a * step + 1, sg * v.y);
          }
        }
      }
    }
  }
};

// NH: 128-symbol halves a tile (2 at loc = 256, else 1)
template <class T, bool SSQ, int NH>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v2_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        T* __restrict__ out, float* __restrict__ ssq, int S,
                        int nt, int log_loc, int rank, int C, int cp,
                        int fft) {
  V2Epi<T, SSQ> epi{out, ssq, S, nt, log_loc, rank, C,
                    64 * (int)sm90::cluster_rank()};
  ls90::ls_body<NH>(&ma, &mb, S, log_loc, fft, cp, epi);
}

// The float32 mode: float32 planes and the split float32 constants, the
// DFT product at float32 accuracy (ls90::ls_body_f32); the same stores.
template <class T, bool SSQ, int NH>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v2_f32_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mb,
                            T* __restrict__ out, float* __restrict__ ssq,
                            int S, int nt, int log_loc, int rank, int C,
                            int cp, int fft) {
  V2Epi<T, SSQ> epi{out, ssq, S, nt, log_loc, rank, C,
                    64 * (int)sm90::cluster_rank()};
  ls90::ls_body_f32<NH>(&ma, &mb, S, log_loc, fft, cp, epi);
}

// Any loc <= 1024 and symbols of any length (ls90::ls_body<0>: 128-symbol
// parts and map rows of 2^log_g symbols at run time), in both modes.
template <class T, bool SSQ>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v2_any_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mb,
                            const __grid_constant__ CUtensorMap ms,
                            T* __restrict__ out, float* __restrict__ ssq,
                            int S, int nt, int log_loc, int rank, int C,
                            int cp, int fft, int sym_len, int log_g,
                            int parts) {
  V2Epi<T, SSQ> epi{out, ssq, S, nt, log_loc, rank, C,
                    64 * (int)sm90::cluster_rank()};
  ls90::ls_body<0>(&ma, &mb, S, log_loc, fft, cp, epi, sym_len, log_g, &ms,
                   parts);
}

template <class T, bool SSQ>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v2_any_f32_kernel(const __grid_constant__ CUtensorMap ma,
                                const __grid_constant__ CUtensorMap mb,
                                const __grid_constant__ CUtensorMap ms,
                                T* __restrict__ out, float* __restrict__ ssq,
                                int S, int nt, int log_loc, int rank, int C,
                                int cp, int fft, int sym_len, int log_g,
                                int parts) {
  V2Epi<T, SSQ> epi{out, ssq, S, nt, log_loc, rank, C,
                    64 * (int)sm90::cluster_rank()};
  ls90::ls_body_f32<0>(&ma, &mb, S, log_loc, fft, cp, epi, sym_len, log_g,
                       &ms, parts);
}

template <class T, bool SSQ, bool F32>
int launch_v2(const CUtensorMap& ma, const CUtensorMap& mb,
              const CUtensorMap& ms, void* out, void* ssq, int S, int nt,
              int log_loc, int rank, int C, int cp, int fft, int cpad,
              int sym_len, int log_g, bool general, int parts,
              cudaStream_t stream) {
  const int cl = 2 * cpad / 128, tiles = ls90::tiles(S, log_loc);
  if (general) {
    if constexpr (F32)
      return ls90::launch<ls90::F_SMEM_BYTES>(
          ls_planes_v2_any_f32_kernel<T, SSQ>, cl, tiles, stream, ma, mb,
          ms, (T*)out, (float*)ssq, S, nt, log_loc, rank, C, cp, fft,
          sym_len, log_g, parts);
    else
      return ls90::launch(ls_planes_v2_any_kernel<T, SSQ>, cl, tiles,
                          stream, ma, mb, ms, (T*)out, (float*)ssq, S, nt,
                          log_loc, rank, C, cp, fft, sym_len, log_g, parts);
  }
  if constexpr (F32) {
    auto kernel = log_loc > 7 ? ls_planes_v2_f32_kernel<T, SSQ, 2>
                              : ls_planes_v2_f32_kernel<T, SSQ, 1>;
    return ls90::launch<ls90::F_SMEM_BYTES>(kernel, cl, tiles, stream, ma,
                                            mb, (T*)out, (float*)ssq, S, nt,
                                            log_loc, rank, C, cp, fft);
  } else {
    auto kernel = log_loc > 7 ? ls_planes_v2_kernel<T, SSQ, 2>
                              : ls_planes_v2_kernel<T, SSQ, 1>;
    return ls90::launch(kernel, cl, tiles, stream, ma, mb, (T*)out,
                        (float*)ssq, S, nt, log_loc, rank, C, cp, fft);
  }
}

template <bool F32, class... A>
int launch_v2_mode(int store, A... a) {
  switch (store) {
    case 0:
      return launch_v2<float, false, F32>(a...);
    case 1:
      return launch_v2<__nv_bfloat16, false, F32>(a...);
    case 2:
      return launch_v2<float, true, F32>(a...);
    case 3:
      return launch_v2<__nv_bfloat16, true, F32>(a...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// planes (2, S, loc*sym_len), the rank's contiguous symbols, 16-byte
// aligned: bf16 with bt (2*cpad, 2*fft) bf16, the permuted K-major
// constants, or with mode bit 2 f32 with bt (2, 2*cpad, 2*fft) f32, their
// split TF32 high and low parts (fused_ls.py::ls_sm90_constants); out
// (2, S, nt, C), bf16 when mode bit 0 is set, else f32; with mode bit 1,
// ssq (tiles(S, log2 loc), 2, C) f32, else unused. Full mode: loc = nt,
// rank = 0. loc a power of 2 <= 256 and at least the 2^group_log(sym_len,
// esize) symbols of a map row (any sym_len at loc >= 8); or with mode bit
// 3 (`parts`) loc 512 .. 2048 and planes the part transform's Z (ls_parts
// .cu), sym_len = fft, cp = 0. fft % 64 == 0, fft <= 256, cpad 128, 256 or
// 512. Returns the CUDA error code of the launch (or sm90::ERR_TENSOR_MAP).
int ls_planes_v2_launch(const void* planes, const void* bt, void* out,
                        void* ssq, int S, int nt, int loc, int rank, int C,
                        int sym_len, int cp, int fft, int cpad, int mode,
                        void* stream) {
  int log_loc = 0;
  while ((1 << log_loc) < loc) ++log_loc;
  const bool f32 = mode & 4;
  const int parts = (mode >> 3) & 1;
  int log_g;
  bool general;
  if (mode < 0 || mode > 15 ||
      !ls90::layout(log_loc, sym_len, f32 ? 4 : 2, parts, log_g, general))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb, ms = {};
  if (f32 ? ls90::make_maps_f32(&ma, &mb, planes, bt, S, log_loc, sym_len,
                                fft, cpad, log_g, &ms)
          : ls90::make_maps(&ma, &mb, planes, bt, S, log_loc, sym_len, fft,
                            cpad, log_g, &ms))
    return sm90::ERR_TENSOR_MAP;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return launch_v2_mode<true>(mode & 3, ma, mb, ms, out, ssq, S, nt,
                                log_loc, rank, C, cp, fft, cpad, sym_len,
                                log_g, general, parts, st);
  return launch_v2_mode<false>(mode & 3, ma, mb, ms, out, ssq, S, nt,
                               log_loc, rank, C, cp, fft, cpad, sym_len,
                               log_g, general, parts, st);
}

const char* ls_planes_v2_error_string(int e) {
  return sm90::error_string(e);
}

}  // extern "C"
