// Per-pair LS channel estimate, written straight into the time-major
// complex layout (B, C, nt, nr).
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_estimate_pallas (body _kernel). Per (packet b, rx r) pair the TPU
// kernel despreads Y = P x over the nt symbols (CP dropped) and then
// DFT-selects est = A Y^T with four real dots. Despread and DFT-select
// act on different axes, so their order does not change the result: this
// kernel runs the GEMM and Walsh-Hadamard body of ls_sm90.cuh (shared
// with ls_v2.cu) on the pairs' rows as bf16 planes (2, B*nr, len_ltf),
// sample s = b*nr + r, which the wrapper makes from the complex input in
// one pass. Only the store is this file's.
//
// Store: out is complex64; the value of sample s, symbol j, carrier c is
// element ((b*C + c)*nt + j)*nr + r. A block owns the real and the
// imaginary column of each of its 64 carriers (the permuted constants),
// so every complex value is written whole, as one float2, straight from
// the accumulators (the real and imaginary part sit at the same index of
// the two sets). At BS32 (nt = 32, nr = 4) a tile is one packet and the
// 4 lanes of a quad hold its 4 rx of one symbol and carrier: each quad
// writes one whole 32-byte sector, a warp 8. Any nr is correct; other
// configs fill sectors less.
//
// Bound on an H100 at the bench shape (1024 packets, S = 4096 pairs,
// nt = 32): the bf16 planes' FFT samples are read once (134 MB, the CP is
// never read) and 245 MB of complex64 written: about 0.113 ms at
// 3.35 TB/s. The GEMM is about 69 GFLOP (0.07 ms at the bf16 tensor-core
// peak), so it is memory-bound, like ls_v2.
//
// ls_estimate_pallas passes float32 pair planes (complex64 rx, as the TPU
// kernel computes in float32): the float32 mode, ls_pair_f32_kernel on
// ls90::ls_body_f32, the same store; 268 MB of f32 input, bound 0.153 ms.
// Any nt up to 2048 and symbols of any length: ls_pair_any_kernel
// (ls90::ls_body<0>), the same store; at nt >= 512 on the part
// transform's Z (ls_parts.cu), one part a tile (the store's symbol offset
// part << 7 from ls90::Rows).
#include "ls_sm90.cuh"

using namespace mamimo;

namespace {

struct PairEpi {
  float* __restrict__ out;
  int S, nr, nt, log_nt, C, c0;

  // value 4j + 2h + e of the two sets: carrier c0 + 16*warp + 8h + lane/4
  // at tile row 8j + 2*(lane%4) + e (ls90::row_coords gives its sample
  // and symbol), as one complex; needs no staging
  // NH: 128-symbol halves a tile (ls90::ls_body; 0: rows.at)
  template <int NH>
  __device__ __forceinline__ void store(const float (&acc0)[64],
                                        const float (&acc1)[64], int s0,
                                        int sym0, int warp, int lane, float*,
                                        int, const ls90::Rows& rows) {
    if ((LS_CUT & 4) && S >= 0) return;
    const int log_tl = NH == 1 ? log_nt : 7;        // symbols of a tile
    // symbol sym0 (0 with one half a tile; rows.at counts it with NH = 0)
    float* const base = NH == 2 ? out + 2LL * sym0 * nr : out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 16 * warp + 8 * h + lane / 4;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int smp, sym;
          if constexpr (NH == 0)
            rows.at(8 * j + 2 * (lane & 3) + e, smp, sym);
          else
            ls90::row_coords(8 * j + 2 * (lane & 3) + e, log_tl, smp, sym);
          const int s = s0 + smp;
          if (s >= S) continue;
          const int b = s / nr, r = s - b * nr;
          *reinterpret_cast<float2*>(
              base + 2 * ((((long long)b * C + c) * nt + sym) * nr + r)) =
              make_float2(acc0[4 * j + 2 * h + e], acc1[4 * j + 2 * h + e]);
        }
    }
  }
};

// NH: 128-symbol halves a tile (2 at nt = 256, else 1)
template <int NH>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_pair_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   float* __restrict__ out, int S, int nr, int nt,
                   int log_nt, int C, int cp, int fft) {
  PairEpi epi{out, S, nr, nt, log_nt, C, 64 * (int)sm90::cluster_rank()};
  ls90::ls_body<NH>(&ma, &mb, S, log_nt, fft, cp, epi);
}

// The float32 mode: float32 pair planes and the split float32
// constants, the DFT product at float32 accuracy (ls90::ls_body_f32).
template <int NH>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_pair_f32_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb,
                       float* __restrict__ out, int S, int nr, int nt,
                       int log_nt, int C, int cp, int fft) {
  PairEpi epi{out, S, nr, nt, log_nt, C, 64 * (int)sm90::cluster_rank()};
  ls90::ls_body_f32<NH>(&ma, &mb, S, log_nt, fft, cp, epi);
}

// Any nt <= 1024 and symbols of any length (ls90::ls_body<0>), both modes.
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_pair_any_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb,
                       const __grid_constant__ CUtensorMap ms,
                       float* __restrict__ out, int S, int nr, int nt,
                       int log_nt, int C, int cp, int fft, int sym_len,
                       int log_g, int parts) {
  PairEpi epi{out, S, nr, nt, log_nt, C, 64 * (int)sm90::cluster_rank()};
  ls90::ls_body<0>(&ma, &mb, S, log_nt, fft, cp, epi, sym_len, log_g, &ms,
                   parts);
}

__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_pair_any_f32_kernel(const __grid_constant__ CUtensorMap ma,
                           const __grid_constant__ CUtensorMap mb,
                           const __grid_constant__ CUtensorMap ms,
                           float* __restrict__ out, int S, int nr, int nt,
                           int log_nt, int C, int cp, int fft, int sym_len,
                           int log_g, int parts) {
  PairEpi epi{out, S, nr, nt, log_nt, C, 64 * (int)sm90::cluster_rank()};
  ls90::ls_body_f32<0>(&ma, &mb, S, log_nt, fft, cp, epi, sym_len, log_g,
                       &ms, parts);
}

}  // namespace

extern "C" {

// planes (2, S, nt*sym_len) with S = B*nr, 16-byte aligned: bf16 with bt
// (2*cpad, 2*fft) bf16, the permuted K-major constants, or with in_f32
// f32 with bt (2, 2*cpad, 2*fft) f32, their split TF32 high and low
// parts (fused_ls.py::ls_sm90_constants); out (B, C, nt, nr) complex64
// as floats. mode bit 0: f32 planes. nt a power of 2 <= 256 and at least
// the 2^group_log(sym_len, esize) symbols of a map row (any sym_len at nt
// >= 8); or with mode bit 1 (`parts`) nt 512 .. 2048 and planes the part
// transform's Z (ls_parts.cu), sym_len = fft, cp = 0. fft % 64 == 0, fft
// <= 256, cpad 128, 256 or 512. Returns the CUDA error code of the launch
// (or sm90::ERR_TENSOR_MAP).
int ls_pair_launch(const void* planes, const void* bt, void* out, int S,
                   int nr, int nt, int C, int sym_len, int cp, int fft,
                   int cpad, int mode, void* stream) {
  int log_nt = 0;
  while ((1 << log_nt) < nt) ++log_nt;
  const int in_f32 = mode & 1, parts = (mode >> 1) & 1;
  int log_g;
  bool general;
  if (mode < 0 || mode > 3 ||
      !ls90::layout(log_nt, sym_len, in_f32 ? 4 : 2, parts, log_g, general))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb, ms = {};
  if (in_f32 ? ls90::make_maps_f32(&ma, &mb, planes, bt, S, log_nt, sym_len,
                                   fft, cpad, log_g, &ms)
             : ls90::make_maps(&ma, &mb, planes, bt, S, log_nt, sym_len, fft,
                               cpad, log_g, &ms))
    return sm90::ERR_TENSOR_MAP;
  const int cl = 2 * cpad / 128, tiles = ls90::tiles(S, log_nt);
  cudaStream_t st = (cudaStream_t)stream;
  if (general && in_f32)
    return ls90::launch<ls90::F_SMEM_BYTES>(
        ls_pair_any_f32_kernel, cl, tiles, st, ma, mb, ms, (float*)out, S,
        nr, nt, log_nt, C, cp, fft, sym_len, log_g, parts);
  if (general)
    return ls90::launch(ls_pair_any_kernel, cl, tiles, st, ma, mb, ms,
                        (float*)out, S, nr, nt, log_nt, C, cp, fft, sym_len,
                        log_g, parts);
  if (in_f32)
    return ls90::launch<ls90::F_SMEM_BYTES>(
        log_nt > 7 ? ls_pair_f32_kernel<2> : ls_pair_f32_kernel<1>, cl,
        tiles, st, ma, mb, (float*)out, S, nr, nt, log_nt, C, cp, fft);
  return ls90::launch(log_nt > 7 ? ls_pair_kernel<2> : ls_pair_kernel<1>,
                      cl, tiles, st, ma, mb, (float*)out, S, nr, nt, log_nt,
                      C, cp, fft);
}

const char* ls_pair_error_string(int e) { return sm90::error_string(e); }

}  // extern "C"
