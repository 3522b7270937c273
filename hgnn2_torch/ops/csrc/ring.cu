// Ring all-reduce over S rank buffers on one card (sm_90a): kernel K5.
//
// K5  ring_allreduce  replaces hgnn2_tpu/ops/pallas/ring.py:_ring_kernel
//     For S rank buffers x_r of n floats, every rank ends with
//       out_r = ((x_r + x_{r-1}) + x_{r-2}) + ... + x_{r-S+1}  (mod S),
//     the order of the TPU kernel's hop schedule: on hop h a rank adds
//     the block that started h ranks to its left.
//
// Here the ranks are buffers on one device (the port's single-device
// mesh), so every rank's input stays readable for the whole call and the
// TPU kernel's hop schedule, with its send and receive slots, is
// needless copying. One launch reads the S inputs once, in ring order:
// a thread takes one float4 (or one float) index i, issues all S loads
// x_0[i] .. x_{S-1}[i] before any add, so they are in flight together,
// and for each rank r forms acc = x_r, acc = acc + x_{r-h} for h = 1 ..
// S - 1, then stores out_r[i]. S is a template parameter (2..8), so the
// loops unroll and the S values live in registers. Adds only, rounded
// one by one (__fadd_rn), in the plain twin's order, so the two agree
// bit for bit.
//
// What bounds it on an H100: the function's minimum, 2*S*n*4 bytes (each
// input read once, each output written once), which is what this kernel
// moves; S*(S-1)*n adds are far below the card's rate. At the packed
// path's widths (n = V*F, V ~ 11k, F <= 16: at most 43k float4s a rank)
// one launch is latency, not bytes; the grid gives every SM work.
//
// Ranks in several processes, on one card or on several, cannot pass
// their inputs as pointers of one process: ring_reduce_rank below (K5
// across processes) reads them from slots mapped over CUDA IPC.
//
// 16-byte loads and stores (float4) when every pointer is 16-byte
// aligned, with a scalar tail; scalar otherwise. The entry points have a
// plain C interface (loaded with ctypes); the two kernels' entries launch
// once on the given stream, allocate nothing, and return
// cudaGetLastError(). Only hgnn2_ipc_alloc allocates (the slots).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRanks = 8;

struct RingArgs {
  const float* in[kMaxRanks];  // rank r's input
  float* out[kMaxRanks];       // rank r's output
};

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// Every rank's sum at one index: x holds the S ranks' values there.
template <int S, typename T>
__device__ __forceinline__ void reduce_store(const RingArgs& a, const T (&x)[S],
                                             long long j) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
    T acc = x[r];
#pragma unroll
    for (int h = 1; h < S; ++h) acc = add(acc, x[(r - h + S) % S]);
    reinterpret_cast<T*>(a.out[r])[j] = acc;
  }
}

template <int S, bool kVec>
__global__ void __launch_bounds__(kThreads)
ring_allreduce(RingArgs a, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      float4 x[S];
#pragma unroll
      for (int r = 0; r < S; ++r)
        x[r] = __ldg(reinterpret_cast<const float4*>(a.in[r]) + j);
      reduce_store<S>(a, x, j);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float x[S];
#pragma unroll
    for (int r = 0; r < S; ++r) x[r] = __ldg(a.in[r] + j);
    reduce_store<S>(a, x, j);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// One thread a float4 (or a float), at most 2^20 blocks: grid-stride beyond.
dim3 grid_of(long long n, bool vec) {
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks);
}

template <int S>
void launch(const RingArgs& a, long long n, bool vec, cudaStream_t s) {
  const dim3 grid = grid_of(n, vec), block(kThreads);
  if (vec)
    ring_allreduce<S, true><<<grid, block, 0, s>>>(a, n);
  else
    ring_allreduce<S, false><<<grid, block, 0, s>>>(a, n);
}

// ---------------------------------------------------------------------------
// K5 across processes: one rank a process, this rank's sum only.
//
// Each process owns a slot buffer of its own cudaMalloc (hgnn2_ipc_alloc;
// not PyTorch's caching allocator, whose tensors sit at offsets inside
// larger blocks, while an IPC handle covers a whole cudaMalloc block),
// exports its cudaIpcMemHandle_t, and opens every peer's handle with
// lazy peer access, so it holds device pointers to the S ranks' slots,
// on one card (processes sharing it) or on peer cards. A call copies the
// rank's partial into its slot; once every process has (a stream sync,
// then a host barrier: ops/ring.py:ProcessRing), one launch reads the S
// slots and writes this rank's output only,
//   out_r = ((x_r + x_{r-1}) + x_{r-2}) + ... + x_{r-S+1}  (mod S),
// rank r's adds in rank r's order, as the one-device kernel forms them,
// so process r is bit-equal to ring_psum_reference(parts)[r]. The entry
// point takes the S pointers in rank order and passes them in this
// rank's ring order (in[h] = x_{r-h}), so the loops unroll over
// compile-time indices and the S values stay in registers.
//
// The slots are written by other processes between launches, so the
// loads go to L2 and not through L1 (__ldcg). No flag on the device
// orders the processes: S processes sharing one card time-slice it, and
// a kernel that spun on a peer's flag would wait for a context switch.
//
// Bound: (S + 1) * n * 4 bytes a process (S slots read once, one output
// written once); S - 1 adds an element are far below the card's rate.
// 16-byte loads and stores when every pointer is 16-byte aligned (the
// slots always are), with a scalar tail; scalar otherwise.

struct RankArgs {
  const float* in[kMaxRanks];  // in[h]: the slot of rank r - h (mod S)
  float* out;                  // rank r's output
};

template <int S, bool kVec>
__global__ void __launch_bounds__(kThreads)
ring_reduce_rank(RankArgs a, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      float4 x[S];
#pragma unroll
      for (int h = 0; h < S; ++h)
        x[h] = __ldcg(reinterpret_cast<const float4*>(a.in[h]) + j);
      float4 acc = x[0];
#pragma unroll
      for (int h = 1; h < S; ++h) acc = add(acc, x[h]);
      reinterpret_cast<float4*>(a.out)[j] = acc;
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float x[S];
#pragma unroll
    for (int h = 0; h < S; ++h) x[h] = __ldcg(a.in[h] + j);
    float acc = x[0];
#pragma unroll
    for (int h = 1; h < S; ++h) acc = add(acc, x[h]);
    a.out[j] = acc;
  }
}

template <int S>
void launch_rank(const RankArgs& a, long long n, bool vec, cudaStream_t s) {
  const dim3 grid = grid_of(n, vec), block(kThreads);
  if (vec)
    ring_reduce_rank<S, true><<<grid, block, 0, s>>>(a, n);
  else
    ring_reduce_rank<S, false><<<grid, block, 0, s>>>(a, n);
}

// The calling thread's current device set to `device` for a scope, then
// restored, so the IPC entries act on the ring's card whatever the
// caller's current device.
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// in[r], out[r]: S device pointers to n floats each; the outputs must not
// overlap the inputs. One launch.
extern "C" int hgnn2_ring_allreduce(const void* const* in, void* const* out,
                                    int S, long long n, void* stream) {
  if (S < 2 || S > kMaxRanks || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RingArgs a = {};
  bool vec = true;
  for (int r = 0; r < S; ++r) {
    a.in[r] = static_cast<const float*>(in[r]);
    a.out[r] = static_cast<float*>(out[r]);
    vec = vec && aligned16(in[r]) && aligned16(out[r]);
  }
  switch (S) {
#define CASE(SS) \
  case SS: launch<SS>(a, n, vec, s); break;
    CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaGetLastError();
}

// in[k]: rank k's slot (S device pointers to n floats each, rank order,
// any of them mapped from another process); out: rank r's output, n
// floats, overlapping no slot. One launch.
extern "C" int hgnn2_ring_reduce_rank(const void* const* in, void* out, int S,
                                      int r, long long n, void* stream) {
  if (S < 2 || S > kMaxRanks || r < 0 || r >= S || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RankArgs a = {};
  a.out = static_cast<float*>(out);
  bool vec = aligned16(out);
  for (int h = 0; h < S; ++h) {
    a.in[h] = static_cast<const float*>(in[(r - h + S) % S]);
    vec = vec && aligned16(a.in[h]);
  }
  switch (S) {
#define CASE(SS) \
  case SS: launch_rank<SS>(a, n, vec, s); break;
    CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaGetLastError();
}

// The slot buffers and their IPC handles. Each entry returns the CUDA
// error code (0 on success).

extern "C" int hgnn2_ipc_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}

// *ptr = a new block of `bytes` on `device`, outside any caching allocator.
extern "C" int hgnn2_ipc_alloc(int device, long long bytes, void** ptr) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaMalloc(ptr, (size_t)bytes);
}

// handle (hgnn2_ipc_handle_bytes() bytes) = the IPC handle of a block of
// hgnn2_ipc_alloc, for another process to open.
extern "C" int hgnn2_ipc_export(int device, void* ptr, void* handle) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return (int)err;
}

// *ptr = this process's mapping of another process's block. A process
// cannot open its own handle: it uses its own pointer.
extern "C" int hgnn2_ipc_open(int device, const void* handle, void** ptr) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Unmaps a block of hgnn2_ipc_open; every peer closes before the owner
// frees (a barrier between the two).
extern "C" int hgnn2_ipc_close(int device, void* ptr) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int hgnn2_ipc_free(int device, void* ptr) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaFree(ptr);
}

// bytes from src to dst on the device, on `stream` (a rank's partial into
// its slot). Asynchronous: the caller synchronizes the stream.
extern "C" int hgnn2_ipc_copy(void* dst, const void* src, long long bytes,
                              void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes,
                              cudaMemcpyDeviceToDevice,
                              static_cast<cudaStream_t>(stream));
}
