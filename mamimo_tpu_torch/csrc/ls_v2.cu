// LS channel estimate from the canonical flat planes, dense output, in
// full mode or as one rank's partial of the sequence-sharded estimate.
//
// Replaces the TPU kernel mamimo_tpu/ops/pallas/fused_ls.py::
// ls_planes_pallas_v2 (body _planes_kernel_v2): the DFT-select GEMM and
// Walsh-Hadamard despread of ls_sm90.cuh, with A the selected-bin DFT
// scaled by 1/(nltf*ltf_c). This file is only the store: the dense
// (2, S, nt, C) f32 planes, no carrier padding.
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
// Bound on an H100 at the serving shape (S = 4096, nt = 32): the bf16
// input read (134 MB: the 256 FFT samples of each 320-sample symbol, the
// CP is never read) plus the f32 output write (245 MB) against 3.35 TB/s
// is about 0.113 ms; the GEMM is about 69 GFLOP (0.07 ms at the bf16
// tensor-core peak), so it is memory-bound. A seq rank reads 1/n of the
// input and still writes the whole (2, S, nt, C) partial, so it is
// output-bound (the JAX design: a psum of full partials).
//
// Store: through the warpgroup's staging buffers, so that a warp writes
// the block's 64 carriers of one output row as 256 contiguous bytes (32
// float2; the 936-byte row pitch is not a multiple of 16, so no TMA
// store can write them). Straight from the accumulators a warp would
// write 4 runs of 32 bytes, and the kernel takes twice as long (PERF.md).
#include "ls_sm90.cuh"

using namespace mamimo;

namespace {

struct V2Epi {
  float* __restrict__ out;
  int S, nt, log_loc, rank, C, c0;

  // Eight rounds a tile: per set (plane) and 32-row group, the threads
  // put their values (carrier c0 + 16*warp + 8h + lane/4 at tile row
  // 8j + 2*(lane%4) + e) into a staging buffer, then each warp writes
  // whole staged rows, lane l carriers 2l and 2l + 1, as row a*loc + sym
  // with H_n[a, rank] (ls90::row_coords gives sample and symbol).
  __device__ __forceinline__ void store(const float (&acc0)[64],
                                        const float (&acc1)[64], int s0,
                                        int warp, int lane, float* stg,
                                        int bar) {
    rounds(acc0, 0, s0, warp, lane, stg, bar);
    rounds(acc1, 1, s0, warp, lane, stg, bar);
  }

  __device__ __forceinline__ void rounds(const float (&acc)[64], int plane,
                                         int s0, int warp, int lane,
                                         float* stg, int bar) {
    const int loc = 1 << log_loc, n = nt >> log_loc;
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
        ls90::row_coords(32 * g + row, log_loc, smp, sym);
        const int s = s0 + smp;
        if (s >= S || c >= C) continue;
        float* o = out + (((long long)plane * S + s) * nt + sym) * C + c;
        for (int a = 0; a < n; ++a) {
          const float sg = (__popc(a & rank) & 1) ? -1.f : 1.f;
          if ((C & 1) == 0) {
            *reinterpret_cast<float2*>(o + a * step) =
                make_float2(sg * v.x, sg * v.y);
          } else {
            o[a * step] = sg * v.x;
            if (c + 1 < C) o[a * step + 1] = sg * v.y;
          }
        }
      }
    }
  }
};

__global__ void __launch_bounds__(ls90::THREADS, 1)
    ls_planes_v2_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        float* __restrict__ out, int S, int nt, int log_loc,
                        int rank, int C, int cp, int fft) {
  V2Epi epi{out, S, nt, log_loc, rank, C, 64 * (int)sm90::cluster_rank()};
  ls90::ls_body(&ma, &mb, S, log_loc, fft, cp, epi);
}

}  // namespace

extern "C" {

// planes (2, S, loc*sym_len) bf16, the rank's contiguous symbols, 16-byte
// aligned; bt (2*cpad, 2*fft) bf16, the permuted K-major constants
// (fused_ls.py::ls_sm90_constants); out (2, S, nt, C) f32. Full mode:
// loc = nt, rank = 0. loc a power of 2 <= 128, fft % 64 == 0, fft <= 256,
// sym_len % 8 == 0, cpad 128, 256 or 512. Returns the CUDA error code of
// the launch (or sm90::ERR_TENSOR_MAP).
int ls_planes_v2_launch(const void* planes, const void* bt, void* out,
                        int S, int nt, int loc, int rank, int C, int sym_len,
                        int cp, int fft, int cpad, void* stream) {
  int log_loc = 0;
  while ((1 << log_loc) < loc) ++log_loc;
  CUtensorMap ma, mb;
  if (ls90::make_maps(&ma, &mb, planes, bt, S, log_loc, sym_len, fft, cpad))
    return sm90::ERR_TENSOR_MAP;
  return ls90::launch(ls_planes_v2_kernel, 2 * cpad / 128,
                      ls90::tiles(S, log_loc), (cudaStream_t)stream, ma, mb,
                      (float*)out, S, nt, log_loc, rank, C, cp, fft);
}

const char* ls_planes_v2_error_string(int e) {
  return sm90::error_string(e);
}

}  // extern "C"
