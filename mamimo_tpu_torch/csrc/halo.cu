// Overlap-save extended block of one rank of the sequence-parallel
// channel convolution, with the halo put straight into the right
// neighbour's block.
//
// Replaces the TPU kernel mamimo_tpu/parallel/rdma_halo.py::
// halo_exchange_pallas (body _halo_kernel). Per rank, x is the rank's
// (2, chunk, nt) f32 planes and its extended block is
// (2, halo + chunk, nt) = [left neighbour's last halo rows | x]:
//
//   out_self[p, halo + t, :]           = x[p, t, :]      every row t
//   out_right[p, t - (chunk - halo), :] = x[p, t, :]      t >= chunk - halo
//   out_self[p, 0:halo, :]             = 0                rank 0 only
//
// out_right is the right neighbour's block, or null on the last rank:
// the put is a plain global store through a pointer that may live on
// another card (peer access enabled by halo_enable_peer). The TPU kernel
// ring-copies and zeroes device 0's halo after the copy arrives; here the
// last rank skips its wrap-around put, so nothing races the zeroing.
//
// There is no barrier and no flag inside the kernel: on one card the
// ranks' launches run one after another, so a kernel that waited on a
// neighbour would never end. The host orders the launches instead
// (parallel/rdma_halo.py): all blocks are allocated before any launch,
// and a neighbour's stream waits on an event recorded after the put.
//
// Bound on an H100: bytes. Each tail row is loaded once and stored
// twice; a rank reads 2*chunk*nt*4 B and its block is written once,
// 2*(halo + chunk)*nt*4 B (1.57 MB per rank at BS32 on 4 ranks, about
// 0.5 us at 3.35 TB/s), so a launch's fixed cost sets its time. The
// copy is grid-stride and 16 bytes per thread where nt % 4 == 0 and the
// pointers are 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& v) { v = 0.f; }

// nv: elements of type V per row (nt / 4 for float4, nt for float).
template <class V>
__global__ void halo_kernel(const V* __restrict__ x, V* __restrict__ out_self,
                            V* __restrict__ out_right, long long chunk,
                            long long halo, long long nv, int is_first) {
  const long long ext = halo + chunk;
  const long long n_x = 2 * chunk * nv;               // body copies
  const long long n_z = is_first ? 2 * halo * nv : 0;  // rank-0 zero halo
  const long long tail0 = chunk - halo;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_x + n_z; i += stride) {
    if (i < n_x) {
      const long long p = i / (chunk * nv);
      const long long r = i - p * chunk * nv;  // t * nv + j
      const V v = x[i];
      out_self[(p * ext + halo) * nv + r] = v;
      if (out_right != nullptr && r >= tail0 * nv)
        out_right[p * ext * nv + r - tail0 * nv] = v;
    } else {
      const long long k = i - n_x;  // p * halo * nv + t * nv + j
      const long long p = k / (halo * nv);
      V z;
      zero(z);
      out_self[p * ext * nv + (k - p * halo * nv)] = z;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class V>
cudaError_t launch(const void* x, void* out_self, void* out_right, int chunk,
                   int halo, long long nv, int is_first, cudaStream_t s) {
  const long long total = 2LL * chunk * nv + (is_first ? 2LL * halo * nv : 0);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  halo_kernel<V><<<(int)blocks, threads, 0, s>>>(
      (const V*)x, (V*)out_self, (V*)out_right, chunk, halo, nv, is_first);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (2, chunk, nt) f32; out_self (2, halo + chunk, nt) f32 on the same
// device; out_right the right neighbour's block or null. chunk > 0.
// Returns the CUDA error code of the launch.
int halo_exchange_launch(const void* x, void* out_self, void* out_right,
                         int chunk, int halo, int nt, int is_first,
                         void* stream) {
  const bool vec = nt % 4 == 0 && aligned16(x) && aligned16(out_self) &&
                   (out_right == nullptr || aligned16(out_right));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      vec ? launch<float4>(x, out_self, out_right, chunk, halo, nt / 4,
                           is_first, s)
          : launch<float>(x, out_self, out_right, chunk, halo, nt, is_first, s);
  return (int)e;
}

// Let kernels on `device` store into memory on `peer`. Returns 0 when
// they can (already enabled included), a CUDA error code otherwise
// (cudaErrorPeerAccessUnsupported when the cards cannot reach each
// other). Restores the calling thread's current device.
int halo_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: already enabled is what we want
    e = cudaSuccess;
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}

const char* halo_exchange_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
