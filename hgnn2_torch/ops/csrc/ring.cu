// Ring all-reduce over S rank buffers on one card (sm_90a): kernel K5.
//
// K5  ring_hop  replaces hgnn2_tpu/ops/pallas/ring.py:_ring_kernel
//     For S rank buffers x_r of n floats, every rank ends with
//       out_r = ((x_r + x_{r-1}) + x_{r-2}) + ... + x_{r-S+1}  (mod S),
//     the order of the TPU kernel's hop schedule: on each of the S - 1
//     hops a rank forwards the block it received on the previous hop
//     (its own block on hop 0) to its right neighbour, into the other of
//     two slots, and adds the incoming block into its output.
//
// Here the ranks are buffers on one device (the port's single-device
// mesh), so a remote copy is a read of the left rank's send slot. One
// launch per hop, blockIdx.y the rank; stream order separates the hops,
// and the two slots keep a hop's reads (slot h % 2) and writes (slot
// (h + 1) % 2) apart, so there are no flags or spins. Hop 0 reads the
// ranks' inputs in place of slot 0 and writes out_r = x_r + x_{r-1}
// without a prior copy; the last hop writes no slot (nothing reads it).
// Adds only, in the same order as the plain twin, so the two agree bit
// for bit.
//
// What bounds it on an H100: the function's minimum is 2*S*n*4 bytes
// (each input read once, each output written once). The schedule moves
// about 16*n bytes per rank per hop (read the left slot and out, write
// out and the own slot), 16*n*S*(S-1) in all: 6x the minimum at S = 4.
// At the packed path's widths (n = V*F, V ~ 11k, F <= 16) a hop is a few
// microseconds of launch, not of bytes.
//
// 16-byte loads and stores (float4) when every pointer is 16-byte
// aligned, with a scalar tail; scalar otherwise. The entry point has a
// plain C interface (loaded with ctypes), launches the S - 1 hops on the
// given stream, allocates nothing, and returns cudaGetLastError() after
// each launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 8;

struct HopArgs {
  const float* send[kMaxRanks];  // rank r's send slot (hop 0: its input)
  const float* own[kMaxRanks];   // hop 0: rank r's input, else unused
  float* recv[kMaxRanks];        // rank r's receive slot (null: last hop)
  float* out[kMaxRanks];         // rank r's output
};

template <bool kFirst, bool kVec>
__global__ void __launch_bounds__(kThreads)
ring_hop(HopArgs a, int S, long long n) {
  const int r = blockIdx.y;
  const int left = (r + S - 1) % S;
  const float* __restrict__ src = a.send[left];
  const float* __restrict__ own = a.own[r];
  float* __restrict__ recv = a.recv[r];
  float* __restrict__ out = a.out[r];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4* o4 = reinterpret_cast<const float4*>(kFirst ? own : out);
    float4* d4 = reinterpret_cast<float4*>(out);
    float4* r4 = reinterpret_cast<float4*>(recv);
    for (long long j = i; j < n4; j += stride) {
      const float4 v = s4[j];
      const float4 acc = o4[j];
      if (recv) r4[j] = v;
      d4[j] = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z,
                          acc.w + v.w);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    const float v = src[j];
    const float acc = kFirst ? own[j] : out[j];
    if (recv) recv[j] = v;
    out[j] = acc + v;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <bool kFirst>
void launch(const HopArgs& a, int S, long long n, bool vec, cudaStream_t s) {
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // grid-stride beyond
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)S), block(kThreads);
  if (vec)
    ring_hop<kFirst, true><<<grid, block, 0, s>>>(a, S, n);
  else
    ring_hop<kFirst, false><<<grid, block, 0, s>>>(a, S, n);
}

}  // namespace

// in[r], out[r]: S device pointers to n floats each. slots: 2*S*n floats
// of scratch (slot k of rank r at (k*S + r)*n); unused when S == 2.
// Launches S - 1 kernels.
extern "C" int hgnn2_ring_allreduce(const void* const* in, void* const* out,
                                    void* slots, int S, long long n,
                                    void* stream) {
  if (S < 2 || S > kMaxRanks || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* slot = static_cast<float*>(slots);
  bool vec = aligned16(slots);
  for (int r = 0; r < S; ++r) vec = vec && aligned16(in[r]) && aligned16(out[r]);
  for (int h = 0; h < S - 1; ++h) {
    HopArgs a = {};
    const bool last = h == S - 2;
    for (int r = 0; r < S; ++r) {
      a.send[r] = h == 0 ? static_cast<const float*>(in[r])
                         : slot + ((long long)(h % 2) * S + r) * n;
      a.own[r] = static_cast<const float*>(in[r]);
      a.recv[r] = last ? nullptr : slot + ((long long)((h + 1) % 2) * S + r) * n;
      a.out[r] = static_cast<float*>(out[r]);
    }
    if (h == 0)
      launch<true>(a, S, n, vec, s);
    else
      launch<false>(a, S, n, vec, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
