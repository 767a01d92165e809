// LS channel estimate from the canonical flat planes, padded raw output.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_planes_pallas (v1, body _planes_kernel). The TPU kernel runs four
// real dots against separate Ar, Ai planes (sym_len x Cp, the CP as zero
// rows) and despreads with a block-diagonal K = I (x) P matmul; this
// kernel computes the same function with the GEMM and Walsh-Hadamard
// body of ls_sm90.cuh, shared with ls_v2.cu and ls_pair.cu. Only the
// store is this file's: the TPU kernel's raw serving form, two planes
//
//   hr, hi : (s_out*nt, cpad) in f32 or bf16, row s*nt + j, lane c,
//
// with s_out = round_up(S, block_samples) and cpad = round_up(C, 128).
// The pad lanes (c >= C) are zero because the rows of the constants for
// those carriers are zero; the pad rows (samples S .. s_out - 1) are zero
// because the body walks s_out samples over a map of S samples, whose
// zero fill gives their input. Every pad row is written by the kernel;
// nothing is zeroed beforehand.
//
// Bound on an H100 at the bench shape (S = 4096, nt = 32, cpad = 256):
// it reads the 256 FFT samples of each symbol (134 MB bf16, the CP is
// never read) and writes 2 x 131072 x 256 values: 134 MB in bf16 (about
// 0.080 ms at 3.35 TB/s) or 268 MB in f32 (about 0.120 ms). The GEMM is
// about 69 GFLOP (0.07 ms at the bf16 tensor-core peak), so it is
// memory-bound.
//
// Store: block rank q owns carriers 64q .. 64q + 63, so it writes lanes
// 64q .. 64q + 63 of every row of both planes: set 0 (real) into hr, set
// 1 (imaginary) into hi. Through the warpgroup's staging buffers, as
// ls_v2.cu, so that a warp writes a row's 64 lanes as one contiguous
// piece (256 bytes in f32, 128 in bf16): whole sectors.
//
// Float32 planes run the float32 mode (ls_planes_v1_f32_kernel on
// ls90::ls_body_f32, the same stores): 268 MB of f32 input, bound 0.160
// ms with the raw f32 store. Any nt up to 2048 and symbols of any length:
// ls_planes_v1_any_kernel (ls90::ls_body<0>), the same stores; at nt >=
// 512 on the part transform's Z (ls_parts.cu, mode bit 2), one part a
// tile.
#include "ls_sm90.cuh"

using namespace mamimo;

namespace {

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  // round to nearest, as __float2bfloat16
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <class T>
struct V1Epi {
  T* __restrict__ hr;
  T* __restrict__ hi;
  int s_out, nt, log_nt, cpad, c0;

  // NH: 128-symbol halves a tile (ls90::ls_body; 0: rows.at)
  template <int NH>
  __device__ __forceinline__ void store(const float (&acc0)[64],
                                        const float (&acc1)[64], int s0,
                                        int sym0, int warp, int lane,
                                        float* stg, int bar,
                                        const ls90::Rows& rows) {
    rounds<NH>(acc0, hr, s0, sym0, warp, lane, stg, bar, rows);
    rounds<NH>(acc1, hi, s0, sym0, warp, lane, stg, bar, rows);
  }

  // Four rounds a set: per 32-row group, the threads put their values
  // (carrier c0 + 16*warp + 8h + lane/4 at tile row 8j + 2*(lane%4) + e)
  // into a staging buffer, then each warp writes whole staged rows, lane
  // l lanes c0 + 2l and c0 + 2l + 1, as row s*nt + sym (ls90::row_coords
  // gives sample and symbol); rows of samples >= s_out are not written.
  template <int NH>
  __device__ __forceinline__ void rounds(const float (&acc)[64], T* out,
                                         int s0, int sym0, int warp,
                                         int lane, float* stg, int bar,
                                         const ls90::Rows& rows) {
    const int log_tl = NH == 1 ? log_nt : 7;        // symbols of a tile
    // row sym0 of sample 0 (sym0 is 0 with one half a tile)
    if constexpr (NH > 1) out += (long long)sym0 * cpad;
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
      if ((LS_CUT & 4) && s_out >= 0) continue;
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
        if (s >= s_out) continue;
        put2(out + ((long long)s * nt + sym) * cpad + c0 + 2 * lane, v.x,
             v.y);
      }
    }
  }
};

// NH: 128-symbol halves a tile (2 at nt = 256, else 1)
template <class T, int NH>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v1_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        T* __restrict__ hr, T* __restrict__ hi, int s_out,
                        int nt, int log_nt, int cpad, int cp, int fft) {
  V1Epi<T> epi{hr, hi, s_out, nt, log_nt, cpad,
               64 * (int)sm90::cluster_rank()};
  // s_out samples over the map's S: the tiles past S read zeros
  ls90::ls_body<NH>(&ma, &mb, s_out, log_nt, fft, cp, epi);
}

// The float32 mode: float32 planes and the split float32 constants, the
// DFT product at float32 accuracy (ls90::ls_body_f32); the same stores.
template <class T, int NH>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v1_f32_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mb,
                            T* __restrict__ hr, T* __restrict__ hi,
                            int s_out, int nt, int log_nt, int cpad, int cp,
                            int fft) {
  V1Epi<T> epi{hr, hi, s_out, nt, log_nt, cpad,
               64 * (int)sm90::cluster_rank()};
  ls90::ls_body_f32<NH>(&ma, &mb, s_out, log_nt, fft, cp, epi);
}

// Any nt <= 1024 and symbols of any length (ls90::ls_body<0>), both modes.
template <class T>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v1_any_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mb,
                            const __grid_constant__ CUtensorMap ms,
                            T* __restrict__ hr, T* __restrict__ hi,
                            int s_out, int nt, int log_nt, int cpad, int cp,
                            int fft, int sym_len, int log_g, int parts) {
  V1Epi<T> epi{hr, hi, s_out, nt, log_nt, cpad,
               64 * (int)sm90::cluster_rank()};
  ls90::ls_body<0>(&ma, &mb, s_out, log_nt, fft, cp, epi, sym_len, log_g,
                   &ms, parts);
}

template <class T>
__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v1_any_f32_kernel(const __grid_constant__ CUtensorMap ma,
                                const __grid_constant__ CUtensorMap mb,
                                const __grid_constant__ CUtensorMap ms,
                                T* __restrict__ hr, T* __restrict__ hi,
                                int s_out, int nt, int log_nt, int cpad,
                                int cp, int fft, int sym_len, int log_g,
                                int parts) {
  V1Epi<T> epi{hr, hi, s_out, nt, log_nt, cpad,
               64 * (int)sm90::cluster_rank()};
  ls90::ls_body_f32<0>(&ma, &mb, s_out, log_nt, fft, cp, epi, sym_len,
                       log_g, &ms, parts);
}

template <class T, bool F32>
int launch_v1(const CUtensorMap& ma, const CUtensorMap& mb,
              const CUtensorMap& ms, void* hr, void* hi, int s_out, int nt,
              int log_nt, int cpad, int cp, int fft, int sym_len, int log_g,
              bool general, int parts, cudaStream_t stream) {
  const int cl = 2 * cpad / 128, tiles = ls90::tiles(s_out, log_nt);
  const bool two = log_nt > 7;
  if (general) {
    if constexpr (F32)
      return ls90::launch<ls90::F_SMEM_BYTES>(
          ls_planes_v1_any_f32_kernel<T>, cl, tiles, stream, ma, mb, ms,
          (T*)hr, (T*)hi, s_out, nt, log_nt, cpad, cp, fft, sym_len, log_g,
          parts);
    else
      return ls90::launch(ls_planes_v1_any_kernel<T>, cl, tiles, stream, ma,
                          mb, ms, (T*)hr, (T*)hi, s_out, nt, log_nt, cpad,
                          cp, fft, sym_len, log_g, parts);
  }
  if constexpr (F32)
    return ls90::launch<ls90::F_SMEM_BYTES>(
        two ? ls_planes_v1_f32_kernel<T, 2> : ls_planes_v1_f32_kernel<T, 1>,
        cl, tiles, stream, ma, mb, (T*)hr, (T*)hi, s_out, nt, log_nt, cpad,
        cp, fft);
  else
    return ls90::launch(two ? ls_planes_v1_kernel<T, 2>
                            : ls_planes_v1_kernel<T, 1>,
                        cl, tiles, stream, ma, mb, (T*)hr, (T*)hi, s_out, nt,
                        log_nt, cpad, cp, fft);
}

}  // namespace

extern "C" {

// planes (2, S, nt*sym_len), 16-byte aligned: bf16 with bt (2*cpad,
// 2*fft) bf16, the permuted K-major constants, or with mode bit 1 f32
// with bt (2, 2*cpad, 2*fft) f32, their split TF32 high and low parts
// (fused_ls.py::ls_sm90_constants); hr, hi (s_out*nt, cpad) each, bf16
// when mode bit 0 is set else f32; s_out >= S >= 1. nt a power of 2 <=
// 256 and at least the 2^group_log(sym_len, esize) symbols of a map row
// (any sym_len at nt >= 8); or with mode bit 2 (`parts`) nt 512 .. 2048
// and planes the part transform's Z (ls_parts.cu), sym_len = fft, cp = 0.
// fft % 64 == 0, fft <= 256, cpad 128, 256 or 512. Returns the CUDA error
// code of the launch (or sm90::ERR_TENSOR_MAP).
int ls_planes_v1_launch(const void* planes, const void* bt, void* hr,
                        void* hi, int S, int s_out, int nt, int sym_len,
                        int cp, int fft, int cpad, int mode, void* stream) {
  int log_nt = 0;
  while ((1 << log_nt) < nt) ++log_nt;
  const bool f32 = mode & 2;
  const int parts = (mode >> 2) & 1;
  int log_g;
  bool general;
  if (mode < 0 || mode > 7 ||
      !ls90::layout(log_nt, sym_len, f32 ? 4 : 2, parts, log_g, general))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb, ms = {};
  if (f32 ? ls90::make_maps_f32(&ma, &mb, planes, bt, S, log_nt, sym_len,
                                fft, cpad, log_g, &ms)
          : ls90::make_maps(&ma, &mb, planes, bt, S, log_nt, sym_len, fft,
                            cpad, log_g, &ms))
    return sm90::ERR_TENSOR_MAP;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode & 3) {
    case 0:
      return launch_v1<float, false>(ma, mb, ms, hr, hi, s_out, nt, log_nt,
                                     cpad, cp, fft, sym_len, log_g, general,
                                     parts, st);
    case 1:
      return launch_v1<__nv_bfloat16, false>(ma, mb, ms, hr, hi, s_out, nt,
                                             log_nt, cpad, cp, fft, sym_len,
                                             log_g, general, parts, st);
    case 2:
      return launch_v1<float, true>(ma, mb, ms, hr, hi, s_out, nt, log_nt,
                                    cpad, cp, fft, sym_len, log_g, general,
                                    parts, st);
    default:
      return launch_v1<__nv_bfloat16, true>(ma, mb, ms, hr, hi, s_out, nt,
                                            log_nt, cpad, cp, fft, sym_len,
                                            log_g, general, parts, st);
  }
}

const char* ls_planes_v1_error_string(int e) {
  return sm90::error_string(e);
}

}  // extern "C"
