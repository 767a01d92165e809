// Overlap-save extended blocks of the sequence-parallel channel
// convolution, every rank of one card in one launch, each rank's halo
// put straight into its right neighbour's block.
//
// Replaces the TPU kernel mamimo_tpu/parallel/rdma_halo.py::
// halo_exchange_pallas (body _halo_kernel). Per rank, x is the rank's
// (planes, chunk, w) f32 rows and its extended block is
// (planes, halo + chunk, w) = [left neighbour's last halo rows | x]:
//
//   out_self[p, halo + t, :]            = x[p, t, :]     every row t
//   out_right[p, t - (chunk - halo), :] = x[p, t, :]     t >= chunk - halo
//   out_self[p, 0:halo, :]              = 0              rank 0 only
//
// planes = 2, w = nt for the JAX contract's (2, chunk, nt) planes;
// planes = 1, w = 2 nt for a (chunk, nt) complex64 chunk (its rows as
// floats), so the sharded convolution needs no planes round trip.
// out_right is the right neighbour's block, or null on the last rank: a
// plain global store through a pointer that may live on another card
// (peer access enabled by halo_enable_peer). The last rank makes no
// wrap-around put, so nothing races rank 0's zeros.
//
// One launch per card: a grid of (row tiles, the card's ranks, planes)
// over a rank table passed by value (up to HALO_MAX_RANKS ranks a
// card). Ranks that share a card need no ordering: rank r + 1's blocks
// write only its body rows, rank r's put only r + 1's halo rows.
// Between cards, the JAX kernel's two semaphores become flags in a small
// per-card signal buffer (allocated once by the wrapper), each holding
// the epoch of the call that last set it, so nothing is ever reset:
//
//   barrier  the receiver's blocks store "ready, e" into the putter's
//            memory as they start (the receiver's stream has then
//            finished everything before this call, so its block is
//            free); the putter's blocks that hold tail rows wait for it
//            before their put;
//   recv_sem each putting block fences at system scope and counts
//            itself done; the last one release-stores "arrived, e" into
//            the receiver's memory, and the receiver's kernel does not
//            finish before one of its threads has acquired it.
//
// Every block posts "ready" (not only the first), so a card whose SMs
// are all held by waiting put blocks still posts it. Every wait is
// bounded: after HALO_SPIN_NS it prints what it waited for and traps, so
// a lost flag fails the run instead of hanging it.
//
// Bound on an H100: bytes. Each x row is loaded once and stored once,
// tail rows twice (self and right); at BS32 on 4 ranks (chunk 2800,
// halo 511, nt 32) one exchange reads 2.87 MB and writes 3.39 MB,
// about 1.9 us at 3.35 TB/s. A tile is one row per thread group
// (THREADS / (w / 4) rows of 16-byte columns, 4 KB at nt = 32), so one
// exchange at that shape is 832 blocks, about one full wave of 132 SMs
// at 8 blocks each. The body copy and the tail put come from one load.
// 16-byte loads and stores where w % 4 == 0 and every pointer is
// 16-byte aligned, 4-byte ones otherwise; no division per element (a
// thread's row and column come from one division at its start). TMA and
// wgmma have nothing to do here: this is a 6 MB copy.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define HALO_MAX_RANKS 8
#define HALO_SPIN_NS 10000000000ULL  // 10 s

// One rank of the card's table (the layout of _CSlot in
// parallel/rdma_halo.py; at namespace scope, since the C launch
// function takes it). Flag pointers are null where the neighbour is on
// this card or missing.
struct HaloSlot {
  const void* x;                     // (planes, chunk, w) f32
  void* out_self;                    // (planes, halo + chunk, w) f32
  void* out_right;                   // right neighbour's block, or null
  unsigned long long* ready_wait;    // putter: set by the right card
  unsigned long long* arrived_post;  // putter: on the right card
  unsigned long long* puts_done;     // putter: its finished put blocks
  unsigned long long* ready_post;    // receiver: on the left card
  unsigned long long* arrived_wait;  // receiver: set by the left card
  int is_first;                      // zeros in its own halo rows
  int rank;                          // along the mesh axis (messages)
};

struct HaloTable {
  HaloSlot s[HALO_MAX_RANKS];
};

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag holds this call's epoch (or a later one); trap after
// HALO_SPIN_NS.
__device__ void wait_flag(const unsigned long long* flag,
                          unsigned long long epoch, const char* what,
                          int rank) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire_sys(flag) < epoch) {
    __nanosleep(256);
    if (now_ns() - t0 > HALO_SPIN_NS) {
      printf("halo_card_kernel: rank %d waited 10 s for %s of epoch %llu "
             "(flag holds %llu); trapping\n",
             rank, what, epoch, ld_acquire_sys(flag));
      __trap();
    }
  }
}

__device__ __forceinline__ void zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& v) { v = 0.f; }

// V: float4 (wv = w / 4) or float (wv = w). A block covers rstep rows of
// one plane of one rank; thread t takes row t / cstep and columns
// t % cstep, t % cstep + cstep, ...
template <class V>
__global__ void __launch_bounds__(THREADS)
    halo_card_kernel(const __grid_constant__ HaloTable t, int n_slots,
                     int chunk, int halo, int wv, int cstep, int rstep,
                     int n_put, unsigned long long epoch) {
  if (threadIdx.x == 0)
    for (int j = 0; j < n_slots; ++j)
      if (t.s[j].ready_post != nullptr)
        st_release_sys(t.s[j].ready_post, epoch);
  const HaloSlot& s = t.s[blockIdx.y];
  const int p = blockIdx.z;
  const int ext = halo + chunk;
  const int o0 = blockIdx.x * rstep;
  const int o1 = min(o0 + rstep, ext);
  const bool puts = s.out_right != nullptr && o1 > chunk;
  const bool remote = puts && s.ready_wait != nullptr;
  if (remote) {  // barrier: the right card's block is free
    if (threadIdx.x == 0) wait_flag(s.ready_wait, epoch, "ready", s.rank);
    __syncthreads();
  }
  const int r = threadIdx.x / cstep;
  const int o = o0 + r;
  if (r < rstep && o < o1 && (o >= halo || s.is_first)) {
    V* dst = static_cast<V*>(s.out_self) + ((size_t)p * ext + o) * wv;
    if (o < halo) {
      V z;
      zero(z);
      for (int c = threadIdx.x % cstep; c < wv; c += cstep) dst[c] = z;
    } else {
      const V* src =
          static_cast<const V*>(s.x) + ((size_t)p * chunk + o - halo) * wv;
      V* put = puts && o >= chunk
                   ? static_cast<V*>(s.out_right) +
                         ((size_t)p * ext + o - chunk) * wv
                   : nullptr;
      for (int c = threadIdx.x % cstep; c < wv; c += cstep) {
        const V v = __ldg(src + c);
        dst[c] = v;
        if (put != nullptr) put[c] = v;
      }
    }
  }
  if (remote) {  // recv_sem: the last put block of this rank posts arrival
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(s.puts_done, 1ULL) + 1 == (unsigned long long)n_put) {
      *s.puts_done = 0;  // the next call (stream-ordered) counts anew
      __threadfence_system();
      st_release_sys(s.arrived_post, epoch);
    }
  }
  if (s.arrived_wait != nullptr && blockIdx.x == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    wait_flag(s.arrived_wait, epoch, "arrival", s.rank);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// One card's launch: slots[0..n) the card's ranks (host memory, copied
// into the kernel's parameters), each x (planes, chunk, w) f32 and
// out_self (planes, halo + chunk, w) f32 on `device`, out_right the
// right neighbour's block or null. epoch: this call's, the same for
// every card's launch of one exchange. chunk > 0. Returns the CUDA
// error code of the launch (cudaErrorInvalidValue for a bad table).
int halo_card_launch(const HaloSlot* slots, int n, int planes, int chunk,
                     int halo, int w, unsigned long long epoch, int device,
                     void* stream) {
  if (n < 1 || n > HALO_MAX_RANKS || planes < 1 || chunk < 1 || halo < 0 ||
      halo > chunk || w < 1)
    return (int)cudaErrorInvalidValue;
  HaloTable t = {};
  bool vec = w % 4 == 0;
  for (int i = 0; i < n; ++i) {
    t.s[i] = slots[i];
    if (halo == 0) {  // nothing to put, nothing to wait for
      t.s[i].out_right = nullptr;
      t.s[i].ready_wait = t.s[i].arrived_post = t.s[i].puts_done = nullptr;
      t.s[i].ready_post = t.s[i].arrived_wait = nullptr;
    }
    vec = vec && aligned16(t.s[i].x) && aligned16(t.s[i].out_self) &&
          (t.s[i].out_right == nullptr || aligned16(t.s[i].out_right));
  }
  const int wv = vec ? w / 4 : w;
  const int cstep = wv < THREADS ? wv : THREADS;
  const int rstep = THREADS / cstep;
  const int ext = halo + chunk;
  const int tiles = (ext + rstep - 1) / rstep;
  // the blocks holding rows >= chunk: tiles floor(chunk / rstep) .. last
  const int n_put = halo > 0 ? planes * (tiles - chunk / rstep) : 0;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess)
    return (int)e;
  const dim3 grid(tiles, n, planes);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    halo_card_kernel<float4><<<grid, THREADS, 0, s>>>(
        t, n, chunk, halo, wv, cstep, rstep, n_put, epoch);
  else
    halo_card_kernel<float><<<grid, THREADS, 0, s>>>(
        t, n, chunk, halo, wv, cstep, rstep, n_put, epoch);
  e = cudaGetLastError();
  if (prev != device) {
    const cudaError_t r = cudaSetDevice(prev);
    if (e == cudaSuccess) e = r;
  }
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
