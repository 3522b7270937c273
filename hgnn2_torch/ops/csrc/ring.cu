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
// Ranks on several cards (the multi-device slice) cannot read each
// other's inputs like this: they need another design (the TPU kernel's
// slots over peer-mapped buffers, or NCCL).
//
// 16-byte loads and stores (float4) when every pointer is 16-byte
// aligned, with a scalar tail; scalar otherwise. The entry point has a
// plain C interface (loaded with ctypes), launches once on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

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

template <int S>
void launch(const RingArgs& a, long long n, bool vec, cudaStream_t s) {
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks), block(kThreads);
  if (vec)
    ring_allreduce<S, true><<<grid, block, 0, s>>>(a, n);
  else
    ring_allreduce<S, false><<<grid, block, 0, s>>>(a, n);
}

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
