// The padding-aware batch norm's train-mode forward and backward for Hopper
// (sm_90a), one launch each: nn/layers.py:MaskedBatchNorm on a float32
// input without pooled statistics.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the batch norm's sums and
// elementwise ops with their neighbours, so the JAX package needs none. On
// the H100 the same function composed of PyTorch ops is 26 launches forward
// and 27 backward, each replayed one by one, and the GNN step is
// launch-bound; these two kernels take their place.
//
// h is viewed as (R, F) rows and the mask as (R,). The forward is the
// composition's float32 two-pass math:
//   x = h m;  count = max(sum m, 1);  mean = sum x / count
//   std = sqrt(eps + sum ((x - mean) m)^2 / count)
//   out = scale ((x - mean) / std) + bias, times m when mask_out
//   running <- keep batch + momentum running  (keep = 1 - momentum)
// Each elementwise step rounds on its own (__fmul_rn, __fdiv_rn, ...), as
// the composition's separate kernels do: from the same statistics the two
// give the same bits, and only the order of the sums differs.
// The backward, with d = x - mean and gm = g m (g when not mask_out), per
// feature P = sum gm, Q = sum gm d and C = sum d m^2:
//   g_bias = P, g_scale = Q / std (each summed over F for a 0-d scale)
//   a = scale / std, b = scale Q / (std^3 count),
//   k = (scale P / std - b C) / count
//   g_h = (a gm - b d m^2 - k) m
// (ops/bn_fused.py:backward_reference is the same formula in PyTorch.)
//
// What bounds them on an H100: a GNN batch norm is R = 16,384 or 32,768
// rows of F = 2, 128-256 KB in and as much out, about 0.1 us of HBM time.
// The launch (about 2 us in a run) bounds them, and after it the latency of
// the dependent steps: load, reduce across the grid, reduce again, write.
// So each direction is one launch of one thread-block cluster of 16 blocks
// (the non-portable size, which the H100 grants; a launch it refuses
// raises). Each block loads its rows once into registers (float2 loads
// where F and the pointers allow), sums per feature through warp shuffles and a tree in
// shared memory, and the cluster adds the blocks' sums through distributed
// shared memory in rank order, so every block holds the same totals and a
// run gives the same bits each time (no atomics). Then it normalises from
// its registers and writes once. Block 0 writes the saved statistics and
// the running buffers (forward), g_scale and g_bias (backward).
//
// Any shape runs: an input whose rows do not fit the cluster's registers,
// or whose F / VEC exceeds a block's threads (feature tiles), takes the
// looped instantiation, which reads h (and g) from memory in each pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRegFloats = 16;  // a thread's register tile: rows x VEC floats
constexpr int kCtas = 16;       // the blocks of the launch's one cluster

__device__ __forceinline__ int pow2_floor(int x) {
  return 1 << (31 - __clz(x));
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A block's threads as (slot, lane): lane l covers the VEC features from
// (v0 + l) VEC of the feature tile starting at group v0; slot s covers the
// rows rank * slots + s + k * ctas * slots, k = 0, 1, ...
struct Geometry {
  int nv;        // VEC-wide feature groups a row: F / VEC
  int lanes;     // lanes a tile: min(nv, kThreads)
  int slots;     // row slots: the largest power of two with slots lanes <= kThreads
  bool shuffle;  // lanes is a power of two <= 32: a warp's slots fold by shuffles
  __device__ Geometry(int F, int vec) {
    nv = F / vec;
    lanes = nv < kThreads ? nv : kThreads;
    slots = pow2_floor(kThreads / lanes);
    shuffle = lanes <= 32 && (lanes & (lanes - 1)) == 0;
  }
};

// Sums the threads' NQ x VEC partial sums over the block's slots, then over
// the cluster's blocks in rank order: afterwards tot[q][l VEC + j] holds
// the cluster's sum for lane l, element j, equal in every block. A block's
// next reduction must use another red buffer than this one: the other
// blocks may still read this one until they reach the next cluster.sync.
template <int NQ, int VEC>
__device__ __forceinline__ void cluster_sum(float (&v)[NQ][VEC],
                                            float (*red)[kThreads * VEC],
                                            float (*tot)[kThreads * VEC],
                                            const Geometry& g,
                                            cg::cluster_group& cluster) {
  const int t = threadIdx.x;
  int groups;
  if (g.shuffle) {
    for (int off = 16; off >= g.lanes; off >>= 1) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          v[q][j] += __shfl_xor_sync(0xffffffffu, v[q][j], off);
    }
    if ((t & 31) < g.lanes) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[q][((t >> 5) * g.lanes + (t & 31)) * VEC + j] = v[q][j];
    }
    groups = kThreads / 32;
  } else {
    if (t < g.slots * g.lanes) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int j = 0; j < VEC; ++j) red[q][t * VEC + j] = v[q][j];
    }
    groups = g.slots;
  }
  __syncthreads();
  for (int s = groups >> 1; s > 0; s >>= 1) {
    if (t < s * g.lanes) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[q][t * VEC + j] += red[q][(t + s * g.lanes) * VEC + j];
    }
    __syncthreads();
  }
  cluster.sync();
  // every block's value is loaded before the first add, so the reads of
  // the other blocks' shared memory overlap instead of queueing
  for (int e = t; e < g.lanes * VEC; e += kThreads) {
    float part[NQ][kCtas];
#pragma unroll
    for (int r = 0; r < kCtas; ++r)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        part[q][r] = cluster.map_shared_rank(&red[q][0], r)[e];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kCtas; ++r) acc += part[q][r];
      tot[q][e] = acc;
    }
  }
  __syncthreads();
}

// One launch of one cluster. CACHED: the input's rows fit the threads'
// registers (ITEMS rows a thread) and F / VEC fits one tile.
template <int VEC, bool CACHED>
__global__ void __launch_bounds__(kThreads)
bn_forward(const float* __restrict__ h, const float* __restrict__ m,
           const float* __restrict__ scale, const float* __restrict__ bias,
           float* __restrict__ out, float* __restrict__ stats,
           float* __restrict__ run_mean, float* __restrict__ run_std, int R,
           int F, int scalar_affine, int mask_out, float eps, float keep,
           float momentum) {
  constexpr int ITEMS = CACHED ? kRegFloats / VEC : 1;
  __shared__ float redA[2][kThreads * VEC], totA[2][kThreads * VEC];
  __shared__ float redB[1][kThreads * VEC], totB[1][kThreads * VEC];
  cg::cluster_group cluster = cg::this_cluster();
  const Geometry g(F, VEC);
  const int t = threadIdx.x, rank = (int)cluster.block_rank();
  const int slot = t / g.lanes, lane = t % g.lanes;
  const int stride = kCtas * g.slots;
  const int r0 = rank * g.slots + slot;
  const bool active = slot < g.slots;
  float xs[ITEMS][VEC], ms[ITEMS];  // CACHED: this thread's rows of h m and m
  float count = 1.f;
  for (int v0 = 0; v0 < g.nv; v0 += g.lanes) {
    const int v = v0 + lane, col = v * VEC;
    const bool on = active && v < g.nv;
    // pass 1: the sum of x = h m, and (tile 0, lane 0) of m
    float s[2][VEC] = {};
    if constexpr (CACHED) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int r = r0 + k * stride;
        ms[k] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) xs[k][j] = 0.f;
        if (on && r < R) {
          float hv[VEC];
          load<VEC>(h + (size_t)r * F + col, hv);
          ms[k] = __ldg(m + r);
#pragma unroll
          for (int j = 0; j < VEC; ++j) xs[k][j] = __fmul_rn(hv[j], ms[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        s[1][0] += ms[k];
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[0][j] += xs[k][j];
      }
    } else {
      for (int r = r0; on && r < R; r += stride) {
        float hv[VEC];
        load<VEC>(h + (size_t)r * F + col, hv);
        const float mv = __ldg(m + r);
        s[1][0] += mv;
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[0][j] += __fmul_rn(hv[j], mv);
      }
    }
    if (v0 != 0 || lane != 0) s[1][0] = 0.f;
    cluster_sum<2, VEC>(s, redA, totA, g, cluster);
    if (v0 == 0) count = fmaxf(totA[1][0], 1.f);
    float mean[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) mean[j] = __fdiv_rn(totA[0][lane * VEC + j], count);

    // pass 2: the sum of squared masked deviations
    float q[1][VEC] = {};
    if constexpr (CACHED) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float e = __fmul_rn(__fsub_rn(xs[k][j], mean[j]), ms[k]);
          q[0][j] += __fmul_rn(e, e);
        }
    } else {
      for (int r = r0; on && r < R; r += stride) {
        float hv[VEC];
        load<VEC>(h + (size_t)r * F + col, hv);
        const float mv = __ldg(m + r);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float e = __fmul_rn(__fsub_rn(__fmul_rn(hv[j], mv), mean[j]), mv);
          q[0][j] += __fmul_rn(e, e);
        }
      }
    }
    cluster_sum<1, VEC>(q, redB, totB, g, cluster);
    float sd[VEC], sc[VEC], bi[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sd[j] = __fsqrt_rn(__fadd_rn(eps, __fdiv_rn(totB[0][lane * VEC + j], count)));
      sc[j] = scalar_affine ? scale[0] : (on ? scale[col + j] : 0.f);
      bi[j] = scalar_affine ? bias[0] : (on ? bias[col + j] : 0.f);
    }

    // normalise and write
    if constexpr (CACHED) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int r = r0 + k * stride;
        if (on && r < R) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float y = __fdiv_rn(__fsub_rn(xs[k][j], mean[j]), sd[j]);
            o[j] = __fadd_rn(__fmul_rn(sc[j], y), bi[j]);
            if (mask_out) o[j] = __fmul_rn(o[j], ms[k]);
          }
          store<VEC>(out + (size_t)r * F + col, o);
        }
      }
    } else {
      for (int r = r0; on && r < R; r += stride) {
        float hv[VEC], o[VEC];
        load<VEC>(h + (size_t)r * F + col, hv);
        const float mv = __ldg(m + r);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float y = __fdiv_rn(__fsub_rn(__fmul_rn(hv[j], mv), mean[j]), sd[j]);
          o[j] = __fadd_rn(__fmul_rn(sc[j], y), bi[j]);
          if (mask_out) o[j] = __fmul_rn(o[j], mv);
        }
        store<VEC>(out + (size_t)r * F + col, o);
      }
    }

    // block 0: the saved statistics and the running buffers
    if (rank == 0 && slot == 0 && on) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int f = col + j;
        stats[f] = mean[j];
        stats[F + f] = sd[j];
        run_mean[f] = __fadd_rn(__fmul_rn(keep, mean[j]), __fmul_rn(momentum, run_mean[f]));
        run_std[f] = __fadd_rn(__fmul_rn(keep, sd[j]), __fmul_rn(momentum, run_std[f]));
      }
    }
  }
  if (rank == 0 && t == 0) stats[2 * F] = count;
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int VEC, bool CACHED>
__global__ void __launch_bounds__(kThreads)
bn_backward(const float* __restrict__ gout, const float* __restrict__ h,
            const float* __restrict__ m, const float* __restrict__ scale,
            const float* __restrict__ stats, float* __restrict__ gh,
            float* __restrict__ gscale, float* __restrict__ gbias, int R, int F,
            int scalar_affine, int mask_out) {
  constexpr int ITEMS = CACHED ? kRegFloats / VEC : 1;
  // the reductions alternate between two buffers from tile to tile
  __shared__ float red[2][3][kThreads * VEC], tot[3][kThreads * VEC];
  cg::cluster_group cluster = cg::this_cluster();
  const Geometry g(F, VEC);
  const int t = threadIdx.x, rank = (int)cluster.block_rank();
  const int slot = t / g.lanes, lane = t % g.lanes;
  const int stride = kCtas * g.slots;
  const int r0 = rank * g.slots + slot;
  const bool active = slot < g.slots;
  const float count = stats[2 * F];
  float ds[ITEMS][VEC], gs[ITEMS][VEC], ms[ITEMS];  // CACHED: d, gm and m
  float sum_scale = 0.f, sum_bias = 0.f;  // 0-d scale: block 0's thread 0
  int tile = 0;
  for (int v0 = 0; v0 < g.nv; v0 += g.lanes, ++tile) {
    const int v = v0 + lane, col = v * VEC;
    const bool on = active && v < g.nv;
    float mean[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) mean[j] = on ? stats[col + j] : 0.f;
    // one pass: P, Q and C
    float s[3][VEC] = {};
    if constexpr (CACHED) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int r = r0 + k * stride;
        ms[k] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) ds[k][j] = gs[k][j] = 0.f;
        if (on && r < R) {
          float hv[VEC], gv[VEC];
          load<VEC>(h + (size_t)r * F + col, hv);
          load<VEC>(gout + (size_t)r * F + col, gv);
          ms[k] = __ldg(m + r);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            ds[k][j] = hv[j] * ms[k] - mean[j];
            gs[k][j] = mask_out ? gv[j] * ms[k] : gv[j];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[0][j] += gs[k][j];
          s[1][j] += gs[k][j] * ds[k][j];
          s[2][j] += ds[k][j] * ms[k] * ms[k];
        }
    } else {
      for (int r = r0; on && r < R; r += stride) {
        float hv[VEC], gv[VEC];
        load<VEC>(h + (size_t)r * F + col, hv);
        load<VEC>(gout + (size_t)r * F + col, gv);
        const float mv = __ldg(m + r);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = hv[j] * mv - mean[j];
          const float gm = mask_out ? gv[j] * mv : gv[j];
          s[0][j] += gm;
          s[1][j] += gm * d;
          s[2][j] += d * mv * mv;
        }
      }
    }
    cluster_sum<3, VEC>(s, red[tile & 1], tot, g, cluster);

    // per feature: a, b and k of g_h = (a gm - b d m^2 - k) m
    float a[VEC], b[VEC], kk[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int e = lane * VEC + j;
      const float sd = on ? stats[F + col + j] : 1.f;
      const float sc = scalar_affine ? scale[0] : (on ? scale[col + j] : 0.f);
      a[j] = sc / sd;
      b[j] = sc * tot[1][e] / (sd * sd * sd * count);
      kk[j] = (sc * tot[0][e] / sd - b[j] * tot[2][e]) / count;
    }
    if constexpr (CACHED) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int r = r0 + k * stride;
        if (on && r < R) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            o[j] = (a[j] * gs[k][j] - b[j] * ds[k][j] * ms[k] * ms[k] - kk[j]) * ms[k];
          store<VEC>(gh + (size_t)r * F + col, o);
        }
      }
    } else {
      for (int r = r0; on && r < R; r += stride) {
        float hv[VEC], gv[VEC], o[VEC];
        load<VEC>(h + (size_t)r * F + col, hv);
        load<VEC>(gout + (size_t)r * F + col, gv);
        const float mv = __ldg(m + r);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = hv[j] * mv - mean[j];
          const float gm = mask_out ? gv[j] * mv : gv[j];
          o[j] = (a[j] * gm - b[j] * d * mv * mv - kk[j]) * mv;
        }
        store<VEC>(gh + (size_t)r * F + col, o);
      }
    }

    // block 0: g_scale and g_bias
    if (rank == 0) {
      if (!scalar_affine && slot == 0 && on) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int e = lane * VEC + j;
          gscale[col + j] = tot[1][e] / stats[F + col + j];
          gbias[col + j] = tot[0][e];
        }
      } else if (scalar_affine && t == 0) {
        const int n = min(g.lanes * VEC, F - v0 * VEC);
        for (int e = 0; e < n; ++e) {
          sum_scale += tot[1][e] / stats[F + v0 * VEC + e];
          sum_bias += tot[0][e];
        }
      }
    }
  }
  if (scalar_affine && rank == 0 && t == 0) {
    gscale[0] = sum_scale;
    gbias[0] = sum_bias;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The VEC a launch takes: 2 where F and every pointer's address allow
// float2 accesses of rows, else 1.
int pick_vec(int F, uintptr_t addr_bits) {
  return F % 2 == 0 && (addr_bits & 7) == 0 ? 2 : 1;
}

// Whether the rows of (R, F) fit the cluster's registers at this VEC and
// F / VEC fits one feature tile (as the kernels' Geometry lays them out).
bool fits_registers(int R, int F, int vec) {
  const int nv = F / vec;
  if (nv > kThreads) return false;
  int slots = 1;
  while (2 * slots * nv <= kThreads) slots *= 2;
  const long long rows = (long long)kCtas * slots;
  return (R + rows - 1) / rows <= kRegFloats / vec;
}

using FwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, float*, float*, int,
                           int, int, int, float, float, float);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           int, int, int, int);

FwdKernel fwd_kernel(int vec, bool cached) {
  if (vec == 2) return cached ? bn_forward<2, true> : bn_forward<2, false>;
  return cached ? bn_forward<1, true> : bn_forward<1, false>;
}

BwdKernel bwd_kernel(int vec, bool cached) {
  if (vec == 2) return cached ? bn_backward<2, true> : bn_backward<2, false>;
  return cached ? bn_backward<1, true> : bn_backward<1, false>;
}

bool g_ready = false;

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Allows each kernel the non-portable cluster of 16 blocks, once (a call
// that is no stream work, made before any capture): 0, or the CUDA error.
extern "C" int hgnn2_bn_init() {
  for (int vec = 1; vec <= 2; ++vec)
    for (int cached = 0; cached < 2; ++cached) {
      const void* kernels[2] = {(const void*)fwd_kernel(vec, cached),
                                (const void*)bwd_kernel(vec, cached)};
      for (const void* k : kernels) {
        const cudaError_t err = cudaFuncSetAttribute(
            k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
      }
    }
  g_ready = true;
  return 0;
}

// h, out (R, F); m (R,); scale, bias (F,) or one float (scalar_affine);
// stats (2F + 1): the batch mean, std and the clamped count; run_mean,
// run_std (F,) updated in place. keep = 1 - momentum.
extern "C" int hgnn2_bn_forward(const void* h, const void* m,
                                const void* scale, const void* bias, void* out,
                                void* stats, void* run_mean, void* run_std,
                                int R, int F, int scalar_affine, int mask_out,
                                float eps, float keep, float momentum,
                                void* stream) {
  if (!g_ready || F < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const int vec = pick_vec(F, (uintptr_t)h | (uintptr_t)out);
  return launch(fwd_kernel(vec, fits_registers(R, F, vec)),
                static_cast<cudaStream_t>(stream), static_cast<const float*>(h),
                static_cast<const float*>(m), static_cast<const float*>(scale),
                static_cast<const float*>(bias), static_cast<float*>(out),
                static_cast<float*>(stats), static_cast<float*>(run_mean),
                static_cast<float*>(run_std), R, F, scalar_affine, mask_out,
                eps, keep, momentum);
}

// g, h, g_h (R, F); m (R,); scale (F,) or one float; stats as the forward
// wrote them; g_scale, g_bias shaped as scale.
extern "C" int hgnn2_bn_backward(const void* g, const void* h, const void* m,
                                 const void* scale, const void* stats,
                                 void* g_h, void* g_scale, void* g_bias, int R,
                                 int F, int scalar_affine, int mask_out,
                                 void* stream) {
  if (!g_ready || F < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const int vec = pick_vec(F, (uintptr_t)g | (uintptr_t)h | (uintptr_t)g_h);
  return launch(bwd_kernel(vec, fits_registers(R, F, vec)),
                static_cast<cudaStream_t>(stream), static_cast<const float*>(g),
                static_cast<const float*>(h), static_cast<const float*>(m),
                static_cast<const float*>(scale),
                static_cast<const float*>(stats), static_cast<float*>(g_h),
                static_cast<float*>(g_scale), static_cast<float*>(g_bias), R, F,
                scalar_affine, mask_out);
}
