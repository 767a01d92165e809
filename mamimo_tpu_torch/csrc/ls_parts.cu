// The LS kernels' part transform: above 256 Tx antennas, the Walsh-
// Hadamard transform over a sample's 128-symbol parts, taken before the
// DFT-select so that each tile of the LS body runs one part.
//
// Replaces no TPU kernel by itself: it is the first pass of kernels 1, 3
// and 4 (ls_v2.cu, ls_v1.cu, ls_pair.cu, which replace mamimo_tpu/ops/
// pallas/fused_ls.py::ls_planes_pallas_v2, ::ls_planes_pallas and
// ::ls_estimate_pallas) at loc = 128 nl symbols a sample, nl = 4 .. 16.
// There P_loc = H_nl (x) H_128, so the estimate's rows p*128 + b are
//
//   h[p*128 + b] = sum_m H_128[b, m] DFT(Z_p[m]),
//   Z_p = sum_v H_nl[p, v] Y_v,   H_nl[p, v] = (-1)^popcount(p & v),
//
// Y_v part v's 128 symbols with the cyclic prefix dropped. This kernel
// writes Z; the LS body (ls_sm90.cuh, ls_body<0> with `parts`) then runs
// the DFT-select and the 128-symbol despread of one part a tile, K = 2 fft
// a tile, where it ran all nl parts, each with its sign (nl times the
// products and the input's reads).
//
// Layout: planes (2, S, loc * sym_len) in T (bf16 or f32), any cp_length;
// z (2, S, nl, 128, fft) in T: each symbol fft samples on a 16-byte
// aligned row, so the body needs no shifted layout at any cyclic prefix.
// The sum is taken in float32 in the order v = 0, 1, ..., nl - 1 (each
// term added or subtracted), then rounded once to T (to nearest even for
// bf16): the plain version (fused_ls.py::_ls_parts_plain) does the same
// operations, so the two agree bit for bit.
//
// Bound on an H100: bytes, an elementwise pass. It reads each symbol's fft
// samples once (the CP is never read: a symbol's fft samples start on a
// 16-byte boundary at any cp_length that is a multiple of 8 bf16) and
// writes Z once: at Nt 1024, S = 128, bf16, 134 MB each way, about 0.080
// ms at 3.35 TB/s; nl <= 16 additions an element against 295 operations a
// byte of the card's balance. The design: one thread a 16-byte chunk of
// one symbol row m of one sample, the same chunk of all nl parts (nl
// independent 16-byte loads in flight, the nl sums in registers), so a
// warp reads and writes whole 512-byte rows; a block is 256 / ch rows of
// ch = fft * esize / 16 threads. A chunk whose start is off
// the 16-byte grid (a cyclic prefix that is not a multiple of 8 bf16 or
// 4 f32, e.g. NR's 18) is read as the two aligned 16-byte blocks around
// it and shifted (ls90::shift16); neighbouring threads share those
// blocks in L1.
//
// The wrapper allocates z whole (torch.empty), no chunking: at Nt 1024,
// S = 4096, bf16 that is 4.3 GB beside the 5.4 GB input and 7.8 GB
// output.
#include "ls_sm90.cuh"

using namespace mamimo;

namespace {

__device__ __forceinline__ void unpack(uint4 w, float (&f)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack(uint4 w, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16*) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return w;
}

__device__ __forceinline__ uint4 pack(const float (&f)[4], float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// Thread (x, y) of block b: chunk c = x (16 bytes, E elements; blockDim.x
// = ch = fft / E) of symbol row b * blockDim.y + y over the rows (plane,
// sample, m), 2 * S * 128 of them: no index division. SHIFT: some chunks
// start off the 16-byte grid (each is then the two aligned blocks around
// it, shifted; an aligned one reads its own block twice, never past the
// planes' end). The loads carry no branch, so the nl of them can all be
// in flight at once.
template <class T, int NL, bool SHIFT>
__global__ void __launch_bounds__(256)
    ls_parts_kernel(const T* __restrict__ planes, T* __restrict__ z, int S,
                    int sym_len, int cp) {
  constexpr int E = 16 / sizeof(T);
  const int ch = blockDim.x, c = threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= 2LL * S * 128) return;
  const int m = (int)(row & 127);
  const long long ps = row >> 7;                   // plane * S + s
  const unsigned char* base = reinterpret_cast<const unsigned char*>(planes);
  float acc[NL][E];
#pragma unroll
  for (int p = 0; p < NL; ++p)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[p][e] = 0.f;
#pragma unroll
  for (int v = 0; v < NL; ++v) {
    const long long b =
        ((ps * (NL * 128) + v * 128 + m) * sym_len + cp + c * E) *
        (long long)sizeof(T);
    const int db = (int)(b & 15);
    const uint4* a = reinterpret_cast<const uint4*>(base + (b - db));
    uint4 w = a[0];
    if constexpr (SHIFT) w = ls90::shift16(w, a[db != 0], db);
    float y[E];
    unpack(w, y, planes);
#pragma unroll
    for (int p = 0; p < NL; ++p)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[p][e] = __popc(p & v) & 1 ? acc[p][e] - y[e] : acc[p][e] + y[e];
  }
  uint4* out = reinterpret_cast<uint4*>(z);
#pragma unroll
  for (int p = 0; p < NL; ++p)
    out[((ps * NL + p) * 128 + m) * ch + c] = pack(acc[p], z);
}

template <class T, int NL>
int launch(const void* planes, void* z, int S, int sym_len, int cp, int fft,
           cudaStream_t stream) {
  const int ch = fft / (16 / (int)sizeof(T)), rows = 256 / ch;
  const long long blocks = (2LL * S * 128 + rows - 1) / rows;
  const bool shift = (sym_len * sizeof(T)) % 16 || (cp * sizeof(T)) % 16;
  auto kernel =
      shift ? ls_parts_kernel<T, NL, true> : ls_parts_kernel<T, NL, false>;
  kernel<<<(unsigned)blocks, dim3(ch, rows), 0, stream>>>(
      (const T*)planes, (T*)z, S, sym_len, cp);
  return (int)cudaGetLastError();
}

template <class T>
int launch_nl(int nl, const void* planes, void* z, int S, int sym_len,
              int cp, int fft, cudaStream_t st) {
  switch (nl) {
    case 4:
      return launch<T, 4>(planes, z, S, sym_len, cp, fft, st);
    case 8:
      return launch<T, 8>(planes, z, S, sym_len, cp, fft, st);
    case 16:
      return launch<T, 16>(planes, z, S, sym_len, cp, fft, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// planes (2, S, loc*sym_len), bf16 or with f32 set float32, 16-byte
// aligned; z (2, S, loc*fft) of the same type, 16-byte aligned. loc = 512,
// 1024 or 2048 (nl = 4, 8, 16 parts), fft % 64 == 0, fft <= 256, S >= 1.
// Returns the CUDA error code of the launch.
int ls_parts_launch(const void* planes, void* z, int S, int loc, int sym_len,
                    int cp, int fft, int f32, void* stream) {
  if (S < 1 || fft % 64 || fft > 256 || loc % 128 || cp < 0 ||
      sym_len < cp + fft)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nl = loc / 128;
  return f32 ? launch_nl<float>(nl, planes, z, S, sym_len, cp, fft, st)
             : launch_nl<__nv_bfloat16>(nl, planes, z, S, sym_len, cp, fft,
                                        st);
}

const char* ls_parts_error_string(int e) { return sm90::error_string(e); }

}  // extern "C"
