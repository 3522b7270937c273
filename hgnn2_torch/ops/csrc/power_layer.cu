// GNNSimple's power layer in train mode for Hopper (sm_90a), one launch
// each way: nn/layers.py:PowerLayer on float32 inputs without the GRU or
// pooled statistics, i.e. graph_op, both convolutions, the ReLUs and the
// padding-aware batch norm.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the layer's matmul, its
// elementwise ops and the batch norm's sums with their neighbours, so the
// JAX package needs none. On the H100 the same layer composed of PyTorch
// ops is about 34 launches forward and backward, each a few microseconds on
// a few hundred kilobytes, and the GNN step is launch-bound; these two
// kernels take their place.
//
// Per graph of N node slots, x (N, Fi), A_j = A^(2^(j-1)) (N, N), deg (N),
// m_id the node mask of graph_op's identity block and m the batch norm's
// mask, H = H2 / 2 the width of each convolution, K = (J + 2) Fi:
//   x1  = [x m_id | deg x | A_1 x | ... | A_J x]             (N, K)
//   pre = x1 Wc^T + bc,  Wc = [W2; W1] (H2, K), bc = [b2; b1]
//   z   = relu(pre)   (= [relu(cv2(x1)) | relu(cv1(x1))], the concat)
//   out = BN(z, m)    (ops/csrc/bn_fused.cu's two-pass math: per feature
//         count = max(sum m, 1), mean = sum z m / count,
//         std = sqrt(eps + sum ((z m - mean) m)^2 / count),
//         out = scale ((z m - mean) / std) + bias, times m when mask_out,
//         running <- keep batch + momentum running; each of those
//         elementwise steps rounds on its own, as in bn_fused.cu)
// The forward saves z and the statistics (2 H2 + 1: mean, std, count).
// The backward takes the output's gradient g and, with bn_fused.cu's
// formula, the gradient of z; then gp = g_z where z > 0 (the ReLUs);
// u_j = A_j^T gp (each graph's transpose, A not assumed symmetric), and
//   dWc[:, blk 0] = sum gp^T (x m_id),  dWc[:, blk 1] = sum gp^T (deg x),
//   dWc[:, blk j+1] = sum u_j^T x,      dbc = sum gp
//   dx = m_id (gp Wc)[blk 0] + deg (gp Wc)[blk 1] + sum_j u_j Wc[:, blk j+1]
// (sum_n gp[n] (A x)[n] = sum_m u[m] x[m], so x1 is never rebuilt), and the
// batch norm's g_scale and g_bias. ops/power_layer.py holds the same
// functions in PyTorch (composed, backward_reference).
//
// What bounds them on an H100: at the GNN cell's shapes (1,024 graphs of 16
// or 32 slots, Fi = 5 or 2, H2 = 2) a call reads the (B, N, N) adjacency,
// 1-4 MB, and a few hundred kilobytes of states: 0.3-1.4 us of HBM time.
// The launch (about 2 us in a run) and then the latency of the dependent
// steps bound them: stage A and x, reduce across the grid, write. One
// cluster of 16 SMs (bn_fused.cu's design) takes about 14 us to pull 4 MB
// of A through shared memory, so the per-graph work is spread over C <=
// kMaxClusters clusters of 16 blocks of 256 threads (the non-portable size,
// which the H100 grants), and the grid-wide steps are taken without a grid
// barrier:
//   forward: each cluster computes z for its graphs and its part of the
//     batch norm's first sums; the last cluster to finish (a counter in
//     device memory) adds the C parts in cluster order, then alone takes
//     the second pass, the output and the statistics over every row;
//   backward: every cluster takes the batch norm's sums over every row
//     (each the same sums in the same order), then gp, A^T gp, dx and its
//     blocks' dW parts for its graphs; the last block to finish (a second
//     counter) adds the 16 C blocks' parts in order.
// Within a cluster, sums run through distributed shared memory in rank
// order. Atomics touch only the counters, so a run gives the same bits
// each time. Launches of one entry on one device must not overlap: they
// share its counter, which the last cluster or block puts back to 0.
//
// The grid's 16 C blocks take slots of gpb = ceil(B / (16 C)) consecutive
// graphs (Tile), so no graph's rows are split. A block streams them in
// chunks of G = 256 / N graphs, one thread a node slot, through a ring of up
// to kMaxStages chunk stages in shared memory filled by cp.async (16-byte
// copies of A's rows, issued at the start of the forward and after the
// first loads of the backward): each A row padded to N + 4 floats and each
// graph's tile to 16 mod 32 floats, so that a thread's float4 reads of its
// own row (forward) and a warp's reads of one column (backward) hit
// distinct banks at N = 16 and 32. The backward keeps the block's rows of
// gp in shared memory. Fi, J and H2 are template parameters, so each row's
// x1, pre and dW parts live in registers.
//
// The entries have a plain C interface (loaded with ctypes), launch once on
// the given stream, allocate nothing, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtas = 16;          // the blocks of a cluster
constexpr int kMaxClusters = 8;    // clusters of a launch
constexpr int kMaxN = 32;          // node slots a graph
constexpr int kMaxBlockRows = 4096;  // rows of gp a block keeps in shared memory
constexpr int kTailRows = 16;      // rows a thread of the last cluster holds
constexpr int kMaxRows = kTailRows * kCtas * kThreads;  // B N
constexpr int kMaxStages = 3;
constexpr int kSmemMax = 232448;   // shared memory a block can use (227 KB)
constexpr int kStaticReserve = 8192;  // bytes left for static shared memory

// how many clusters (forward) or blocks (backward) of a launch have
// finished their part (see above)
__device__ unsigned int g_forward_done = 0, g_backward_done = 0;

// float offset of a graph's tile: v rounded up to 16 mod 32, so that two
// graphs sharing a warp (N = 16) start on opposite half-banks
__host__ __device__ constexpr int pad_tile(int v) {
  return v + (((16 - v % 32) % 32) + 32) % 32;
}

// the floats of an x row in shared memory: Fi padded to a vector width
__host__ __device__ constexpr int x_width(int fi) {
  return fi <= 1 ? 1 : fi <= 2 ? 2 : fi <= 4 ? 4 : 8;
}

template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  } else if constexpr (W == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = p[i];
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = v[i];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

// A block's graphs, its chunks and its stage layout (floats). The grid's
// graphs are cut into 16 C slots of gpb graphs; block `rank` of cluster ci
// takes slot rank C + ci, so that block `rank` of every cluster can read
// the slots rank C + k, k < C, in the same order, its own among them.
struct Tile {
  int N, G, ld, a_tile, x_tile, stage;
  int gpb, g0, nb, chunks;
  __device__ Tile(int B, int N_, int J, int xw, bool with_x) {
    N = N_;
    G = kThreads / N;
    ld = N + 4;
    a_tile = pad_tile(J * N * ld);
    x_tile = with_x ? pad_tile(N * xw) : 0;
    stage = G * (a_tile + x_tile);
    const int clusters = (int)gridDim.x / kCtas;
    gpb = (B + (int)gridDim.x - 1) / (int)gridDim.x;
    g0 = ((int)blockIdx.x % kCtas * clusters + (int)blockIdx.x / kCtas) * gpb;
    nb = max(0, min(B - g0, gpb));
    chunks = (nb + G - 1) / G;
  }
};

template <int W>
__device__ __forceinline__ void load_nc(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (W == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __ldg(p + i);
  }
}

template <int W>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (W == 2) {
    const float2 a = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __ldcg(p + i);
  }
}

// Rank 0 has written its cluster's part to device memory: counts the
// cluster as done and tells every block of the cluster whether it was the
// last of the launch's clusters. Every thread of every block calls it.
__device__ __forceinline__ bool last_cluster(unsigned int* done, int clusters,
                                             int* flag,
                                             cg::cluster_group& cluster) {
  if (cluster.block_rank() == 0) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      *flag = atomicAdd(done, 1u) == (unsigned int)(clusters - 1);
      __threadfence();
    }
  }
  cluster.sync();
  return *cluster.map_shared_rank(flag, 0) != 0;
}

// Issues chunk c's copies into stage buffer `st` (nothing past the block's
// graphs) and commits them as one group: A's rows (16-byte copies, each
// padded row at ld), then, when x is given, x's rows at their vector width.
template <int FI, int J>
__device__ __forceinline__ void issue_chunk(const Tile& tl, int c, float* st,
                                            const float* __restrict__ A,
                                            const float* __restrict__ x) {
  constexpr int XW = x_width(FI);
  const int t = threadIdx.x;
  if (c < tl.chunks) {
    const int N = tl.N, q4 = N / 4;
    const int gfirst = tl.g0 + c * tl.G;
    const int gc = min(tl.G, tl.nb - c * tl.G);
    const float* a_src = A + (size_t)gfirst * J * N * N;
    const int n_a = gc * J * N * q4;
    for (int e = t; e < n_a; e += kThreads) {
      const int q = e / q4, i4 = e - q * q4;  // q = (gl J + j) N + n
      const int gl = q / (J * N), row = q - gl * J * N;
      cp_async16(st + gl * tl.a_tile + row * tl.ld + 4 * i4, a_src + 4 * (size_t)e);
    }
    if (x != nullptr) {
      float* xs = st + tl.G * tl.a_tile;
      const float* x_src = x + (size_t)gfirst * N * FI;
      const int n_x = gc * N * FI;
      for (int e = t; e < n_x; e += kThreads) {
        const int node = e / FI, f = e - node * FI;
        const int gl = node / N, m = node - gl * N;
        cp_async4(xs + gl * tl.x_tile + m * XW + f, x_src + e);
      }
    }
  }
  cp_commit();
}

// Sums each thread's NV values over the block (warp butterflies, then the
// warps in order): thread e < NV returns the block's sum of value e.
template <int NV>
__device__ __forceinline__ float block_sum(float (&v)[NV], float* wred) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) wred[warp * NV + i] = v[i];
  }
  __syncthreads();
  float acc = 0.f;
  if (t < NV) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += wred[w * NV + t];
  }
  return acc;
}

// block_sum into part[NV], then over the cluster's blocks in rank order
// into tot[NV], equal in every block (only rank 0's unless all_blocks).
// Each call site must pass its own `part`: the other blocks may still
// read the last one.
template <int NV>
__device__ __forceinline__ void cluster_sum(float (&v)[NV], float* wred,
                                            float* part, float* tot,
                                            cg::cluster_group& cluster,
                                            bool all_blocks) {
  static_assert(NV <= kThreads, "one value a thread");
  const int t = threadIdx.x;
  const float b = block_sum<NV>(v, wred);
  if (t < NV) part[t] = b;
  cluster.sync();
  if (all_blocks || cluster.block_rank() == 0) {
    for (int e = t; e < NV; e += kThreads) {
      float p[kCtas];
#pragma unroll
      for (int r = 0; r < kCtas; ++r) p[r] = cluster.map_shared_rank(part, r)[e];
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kCtas; ++r) acc += p[r];
      tot[e] = acc;
    }
  }
  __syncthreads();
}

template <int FI, int J, int H2>
__global__ void __launch_bounds__(kThreads)
power_forward(const float* __restrict__ x, const float* __restrict__ A,
              const float* __restrict__ deg, const float* __restrict__ mid,
              const float* __restrict__ mbn, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ scale,
              const float* __restrict__ bias, float* __restrict__ out,
              float* __restrict__ zsave, float* __restrict__ stats,
              float* __restrict__ run_mean, float* __restrict__ run_std,
              float* __restrict__ parts, int B, int N, int scalar_affine,
              int mask_out, float eps, float keep, float momentum,
              int stages) {
  constexpr int K = (J + 2) * FI, H = H2 / 2, XW = x_width(FI);
  extern __shared__ __align__(16) float smem[];
  __shared__ float wred[kWarps * (H2 + 1)];
  __shared__ float part1[H2 + 1], tot1[H2 + 1], part2[H2], tot2[H2];
  __shared__ int flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, rank = (int)cluster.block_rank();
  const int clusters = (int)gridDim.x / kCtas, ci = (int)blockIdx.x / kCtas;
  const Tile tl(B, N, J, XW, true);
  for (int c = 0; c < stages; ++c)
    issue_chunk<FI, J>(tl, c, smem + c * tl.stage, A, x);
  // what the last cluster's end reads, loaded now, off its critical path
  float sc[H2], bi[H2], rm0 = 0.f, rs0 = 0.f;
#pragma unroll
  for (int c = 0; c < H2; ++c) {
    sc[c] = scalar_affine ? scale[0] : scale[c];
    bi[c] = scalar_affine ? bias[0] : bias[c];
  }
  if (t < H2) {
    rm0 = run_mean[t];
    rs0 = run_std[t];
  }

  float wc[H2][K], bc[H2];  // [cv2; cv1]
#pragma unroll
  for (int c = 0; c < H2; ++c) {
    const float* w = c < H ? w2 + c * K : w1 + (c - H) * K;
    bc[c] = c < H ? b2[c] : b1[c - H];
#pragma unroll
    for (int k = 0; k < K; ++k) wc[c][k] = w[k];
  }

  // each chunk: x1, pre and z of one row a thread, and the batch norm's
  // first sums (z m and m) over the thread's rows
  float s1[H2 + 1] = {};
  const int gl = t / N, n = t - gl * N;
  for (int c = 0; c < tl.chunks; ++c) {
    cp_wait(stages - 1);
    __syncthreads();
    const float* st = smem + (c % stages) * tl.stage;
    const int gc = min(tl.G, tl.nb - c * tl.G);
    if (gl < gc) {
      const size_t r = (size_t)(tl.g0 + c * tl.G + gl) * N + n;
      const float* at = st + gl * tl.a_tile + n * tl.ld;
      const float* xg = st + tl.G * tl.a_tile + gl * tl.x_tile;
      float ax[J][FI] = {};
      for (int m0 = 0; m0 < N; m0 += 4) {
        float a[J][4];
#pragma unroll
        for (int j = 0; j < J; ++j) load_vec<4>(at + j * N * tl.ld + m0, a[j]);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          float xv[XW];
          load_vec<XW>(xg + (m0 + mm) * XW, xv);
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int f = 0; f < FI; ++f) ax[j][f] = fmaf(a[j][mm], xv[f], ax[j][f]);
        }
      }
      float xo[XW];
      load_vec<XW>(xg + n * XW, xo);
      const float mi = __ldg(mid + r), d = __ldg(deg + r), mv = __ldg(mbn + r);
      float x1[K];
#pragma unroll
      for (int f = 0; f < FI; ++f) {
        x1[f] = __fmul_rn(xo[f], mi);
        x1[FI + f] = __fmul_rn(d, xo[f]);
#pragma unroll
        for (int j = 0; j < J; ++j) x1[(2 + j) * FI + f] = ax[j][f];
      }
      float z[H2];
#pragma unroll
      for (int c2 = 0; c2 < H2; ++c2) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(wc[c2][k], x1[k], acc);
        const float pre = __fadd_rn(acc, bc[c2]);
        z[c2] = pre > 0.f || pre != pre ? pre : 0.f;  // relu, NaN kept
        s1[c2] += __fmul_rn(z[c2], mv);
      }
      s1[H2] += mv;
      store_vec<H2>(zsave + r * H2, z);
    }
    __syncthreads();
    issue_chunk<FI, J>(tl, c + stages, smem + (c % stages) * tl.stage, A, x);
  }
  cp_wait(0);

  // the cluster's first sums to device memory; the last cluster goes on
  __threadfence();  // this thread's z, before the cluster is counted done
  cluster_sum<H2 + 1>(s1, wred, part1, tot1, cluster, false);
  if (rank == 0 && t <= H2) parts[ci * (H2 + 1) + t] = tot1[t];
  if (!last_cluster(&g_forward_done, clusters, &flag, cluster)) {
    cluster.sync();  // rank 0's flag is read before it leaves
    return;
  }

  // the last cluster: the batch norm over every row (bn_fused.cu's math),
  // each thread's rows held in registers from one load
  const int R = B * N, stride = kCtas * kThreads, r0 = rank * kThreads + t;
  float zc[kTailRows][H2], mc[kTailRows];
#pragma unroll
  for (int i = 0; i < kTailRows; ++i) {
    const int r = r0 + i * stride;
    mc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < H2; ++c) zc[i][c] = 0.f;
    if (r < R) {
      load_cg<H2>(zsave + (size_t)r * H2, zc[i]);
      mc[i] = __ldg(mbn + r);
    }
  }
  if (t <= H2) {
    float acc = 0.f;
    for (int q = 0; q < clusters; ++q) acc += __ldcg(parts + q * (H2 + 1) + t);
    tot1[t] = acc;
  }
  __syncthreads();
  const float count = fmaxf(tot1[H2], 1.f);
  float mean[H2];
#pragma unroll
  for (int c = 0; c < H2; ++c) mean[c] = __fdiv_rn(tot1[c], count);
  float s2[H2] = {};
#pragma unroll
  for (int i = 0; i < kTailRows; ++i)
#pragma unroll
    for (int c = 0; c < H2; ++c) {
      const float e = __fmul_rn(__fsub_rn(__fmul_rn(zc[i][c], mc[i]), mean[c]), mc[i]);
      if (r0 + i * stride < R) s2[c] += __fmul_rn(e, e);
    }
  cluster_sum<H2>(s2, wred, part2, tot2, cluster, true);
  float sd[H2];
#pragma unroll
  for (int c = 0; c < H2; ++c)
    sd[c] = __fsqrt_rn(__fadd_rn(eps, __fdiv_rn(tot2[c], count)));
#pragma unroll
  for (int i = 0; i < kTailRows; ++i) {
    const int r = r0 + i * stride;
    if (r < R) {
      float o[H2];
#pragma unroll
      for (int c = 0; c < H2; ++c) {
        const float y = __fdiv_rn(__fsub_rn(__fmul_rn(zc[i][c], mc[i]), mean[c]), sd[c]);
        o[c] = __fadd_rn(__fmul_rn(sc[c], y), bi[c]);
        if (mask_out) o[c] = __fmul_rn(o[c], mc[i]);
      }
      store_vec<H2>(out + (size_t)r * H2, o);
    }
  }
  if (rank == 0 && t < H2) {
    stats[t] = mean[t];
    stats[H2 + t] = sd[t];
    run_mean[t] = __fadd_rn(__fmul_rn(keep, mean[t]), __fmul_rn(momentum, rm0));
    run_std[t] = __fadd_rn(__fmul_rn(keep, sd[t]), __fmul_rn(momentum, rs0));
  }
  if (rank == 0 && t == 0) {
    stats[2 * H2] = count;
    g_forward_done = 0;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int FI, int J, int H2>
__global__ void __launch_bounds__(kThreads)
power_backward(const float* __restrict__ g, const float* __restrict__ x,
               const float* __restrict__ A, const float* __restrict__ deg,
               const float* __restrict__ mid, const float* __restrict__ mbn,
               const float* __restrict__ w1, const float* __restrict__ w2,
               const float* __restrict__ scale, const float* __restrict__ zsave,
               const float* __restrict__ stats, float* __restrict__ dx,
               float* __restrict__ gw1, float* __restrict__ gb1,
               float* __restrict__ gw2, float* __restrict__ gb2,
               float* __restrict__ gscale, float* __restrict__ gbias,
               float* __restrict__ parts, int B, int N, int scalar_affine,
               int mask_out, int stages) {
  constexpr int K = (J + 2) * FI, H = H2 / 2, NW = H2 * K + H2;
  extern __shared__ __align__(16) float smem[];
  __shared__ float wred[kWarps * NW];
  __shared__ float part1[3 * H2], tot1[3 * H2];
  __shared__ int flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, rank = (int)cluster.block_rank();
  const int clusters = (int)gridDim.x / kCtas;
  const Tile tl(B, N, J, 0, false);
  float* gps = smem + stages * tl.stage;  // the block's gp, graph tiles of N rows
  const int gp_tile = pad_tile(N * H2);

  // the batch norm's sums over every row, in every cluster alike (block
  // `rank` reads the slots rank C + k in order; its own rows stay in L1):
  // P = sum gm, Q = sum gm d, C = sum d m^2
  const int R = B * N;
  const float count = stats[2 * H2];
  float mean[H2];
#pragma unroll
  for (int c = 0; c < H2; ++c) mean[c] = stats[c];
  float s1[3 * H2] = {};
  for (int k = 0; k < clusters; ++k) {
    const int lo = (rank * clusters + k) * tl.gpb * N;
    const int hi = min(R, lo + tl.gpb * N);
    for (int r = lo + t; r < hi; r += kThreads) {
      float zv[H2], gv[H2];
      load_nc<H2>(zsave + (size_t)r * H2, zv);
      load_nc<H2>(g + (size_t)r * H2, gv);
      const float mv = __ldg(mbn + r);
#pragma unroll
      for (int c = 0; c < H2; ++c) {
        const float d = zv[c] * mv - mean[c];
        const float gm = mask_out ? gv[c] * mv : gv[c];
        s1[c] += gm;
        s1[H2 + c] += gm * d;
        s1[2 * H2 + c] += d * mv * mv;
      }
    }
  }
  // A's copies go out after those loads, so as not to queue them, and
  // land during the cluster's sum and gp
  for (int c = 0; c < stages; ++c)
    issue_chunk<FI, J>(tl, c, smem + c * tl.stage, A, nullptr);
  cluster_sum<3 * H2>(s1, wred, part1, tot1, cluster, true);
  float a[H2], b[H2], kk[H2];
#pragma unroll
  for (int c = 0; c < H2; ++c) {
    const float sd = stats[H2 + c];
    const float sc = scalar_affine ? scale[0] : scale[c];
    a[c] = sc / sd;
    b[c] = sc * tot1[H2 + c] / (sd * sd * sd * count);
    kk[c] = (sc * tot1[c] / sd - b[c] * tot1[2 * H2 + c]) / count;
  }
  // the block's rows: g_z = (a gm - b d m^2 - k) m, then the ReLUs' gate,
  // gp = g_z where z > 0
  const size_t rb = (size_t)tl.g0 * N;
  for (int rl = t; rl < tl.nb * N; rl += kThreads) {
    float zv[H2], gv[H2], o[H2];
    load_nc<H2>(zsave + (rb + rl) * H2, zv);
    load_nc<H2>(g + (rb + rl) * H2, gv);
    const float mv = __ldg(mbn + rb + rl);
#pragma unroll
    for (int c = 0; c < H2; ++c) {
      const float d = zv[c] * mv - mean[c];
      const float gm = mask_out ? gv[c] * mv : gv[c];
      const float gz = (a[c] * gm - b[c] * d * mv * mv - kk[c]) * mv;
      o[c] = zv[c] <= 0.f ? 0.f : gz;
    }
    const int gi = rl / N;
    store_vec<H2>(gps + gi * gp_tile + (rl - gi * N) * H2, o);
  }

  float wc[H2][K];
#pragma unroll
  for (int c = 0; c < H2; ++c) {
    const float* w = c < H ? w2 + c * K : w1 + (c - H) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) wc[c][k] = w[k];
  }

  // each chunk: thread (graph, node m) takes u_j = (A_j^T gp)[m], its dW
  // parts and dx[m]
  float acc[H2][K] = {}, db[H2] = {};
  const int gl = t / N, m = t - gl * N;
  for (int c = 0; c < tl.chunks; ++c) {
    cp_wait(stages - 1);
    __syncthreads();
    const float* st = smem + (c % stages) * tl.stage;
    const int gc = min(tl.G, tl.nb - c * tl.G);
    if (gl < gc) {
      const int gi = c * tl.G + gl;  // the block's graph
      const float* gpg = gps + gi * gp_tile;
      const float* ag = st + gl * tl.a_tile + m;
      float u[J][H2] = {};
      for (int nn = 0; nn < N; ++nn) {
        float gv[H2];
        load_vec<H2>(gpg + nn * H2, gv);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float av = ag[(j * N + nn) * tl.ld];
#pragma unroll
          for (int c2 = 0; c2 < H2; ++c2) u[j][c2] = fmaf(av, gv[c2], u[j][c2]);
        }
      }
      const size_t r = rb + (size_t)gi * N + m;
      float go[H2], xo[FI];
      load_vec<H2>(gpg + m * H2, go);
#pragma unroll
      for (int f = 0; f < FI; ++f) xo[f] = __ldg(x + r * FI + f);
      const float mi = __ldg(mid + r), d = __ldg(deg + r);
      float xm[FI], xd[FI];
#pragma unroll
      for (int f = 0; f < FI; ++f) {
        xm[f] = __fmul_rn(xo[f], mi);
        xd[f] = __fmul_rn(d, xo[f]);
      }
#pragma unroll
      for (int c2 = 0; c2 < H2; ++c2) {
        db[c2] += go[c2];
#pragma unroll
        for (int f = 0; f < FI; ++f) {
          acc[c2][f] = fmaf(go[c2], xm[f], acc[c2][f]);
          acc[c2][FI + f] = fmaf(go[c2], xd[f], acc[c2][FI + f]);
#pragma unroll
          for (int j = 0; j < J; ++j)
            acc[c2][(2 + j) * FI + f] = fmaf(u[j][c2], xo[f], acc[c2][(2 + j) * FI + f]);
        }
      }
      if (dx != nullptr) {
#pragma unroll
        for (int f = 0; f < FI; ++f) {
          float di = 0.f, dd = 0.f, da = 0.f;
#pragma unroll
          for (int c2 = 0; c2 < H2; ++c2) {
            di = fmaf(go[c2], wc[c2][f], di);
            dd = fmaf(go[c2], wc[c2][FI + f], dd);
#pragma unroll
            for (int j = 0; j < J; ++j) da = fmaf(u[j][c2], wc[c2][(2 + j) * FI + f], da);
          }
          dx[r * FI + f] = __fadd_rn(__fadd_rn(__fmul_rn(mi, di), __fmul_rn(d, dd)), da);
        }
      }
    }
    __syncthreads();
    issue_chunk<FI, J>(tl, c + stages, smem + (c % stages) * tl.stage, A, nullptr);
  }
  cp_wait(0);

  // the block's dW and db to device memory; the last block of the grid
  // adds the blocks' parts in order and writes them, g_scale and g_bias
  float v[NW];
#pragma unroll
  for (int c = 0; c < H2; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[c * K + k] = acc[c][k];
    v[H2 * K + c] = db[c];
  }
  const float bsum = block_sum<NW>(v, wred);
  if (t < NW) {
    parts[blockIdx.x * NW + t] = bsum;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) {
    flag = atomicAdd(&g_backward_done, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (flag) {
    // value e by warp e % 8: lane l adds the parts of blocks l, l + 32, ...
    // (all loaded at once), then the lanes fold by butterflies; the order
    // is fixed and the sums stay short
    const int lane = t & 31, nb = (int)gridDim.x;
    for (int e = t >> 5; e < NW; e += kWarps) {
      float p[kMaxClusters * kCtas / 32];
#pragma unroll
      for (int i = 0; i < kMaxClusters * kCtas / 32; ++i) {
        const int q = lane + 32 * i;
        p[i] = q < nb ? __ldcg(parts + q * NW + e) : 0.f;
      }
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxClusters * kCtas / 32; ++i) s += p[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane != 0) continue;
      if (e < H2 * K) {
        const int c = e / K, k = e - c * K;
        if (c < H) gw2[c * K + k] = s;
        else gw1[(c - H) * K + k] = s;
      } else if (e - H2 * K < H) {
        gb2[e - H2 * K] = s;
      } else {
        gb1[e - H2 * K - H] = s;
      }
    }
    if (!scalar_affine && t < H2) {
      gscale[t] = tot1[H2 + t] / stats[H2 + t];
      gbias[t] = tot1[t];
    } else if (scalar_affine && t == 0) {
      float ss = 0.f, sb = 0.f;
      for (int c = 0; c < H2; ++c) {
        ss += tot1[H2 + c] / stats[H2 + c];
        sb += tot1[c];
      }
      gscale[0] = ss;
      gbias[0] = sb;
    }
    if (t == 0) g_backward_done = 0;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

using FwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           float*, float*, float*, int, int, int, int, float,
                           float, float, int);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           float*, float*, float*, float*, float*, int, int,
                           int, int, int);

// The instantiations: Fi in {2, 4, 5}, J in {1, 2}, H2 in {2, 4}
// (ops/power_layer.py:KERNEL_SHAPES says the same).
#define HGNN2_POWER_SHAPES(X) \
  X(2, 1, 2) X(2, 1, 4) X(2, 2, 2) X(2, 2, 4) \
  X(4, 1, 2) X(4, 1, 4) X(4, 2, 2) X(4, 2, 4) \
  X(5, 1, 2) X(5, 1, 4) X(5, 2, 2) X(5, 2, 4)

FwdKernel fwd_kernel(int fi, int J, int h2) {
#define HGNN2_PICK(FI, JJ, HH) \
  if (fi == FI && J == JJ && h2 == HH) return power_forward<FI, JJ, HH>;
  HGNN2_POWER_SHAPES(HGNN2_PICK)
#undef HGNN2_PICK
  return nullptr;
}

BwdKernel bwd_kernel(int fi, int J, int h2) {
#define HGNN2_PICK(FI, JJ, HH) \
  if (fi == FI && J == JJ && h2 == HH) return power_backward<FI, JJ, HH>;
  HGNN2_POWER_SHAPES(HGNN2_PICK)
#undef HGNN2_PICK
  return nullptr;
}

// The clusters of a launch: enough for one chunk a block, at most
// kMaxClusters (ops/power_layer.py:clusters).
int clusters_for(int B, int N) {
  const int G = kThreads / N;
  const int c = (B + kCtas * G - 1) / (kCtas * G);
  return c < 1 ? 1 : c > kMaxClusters ? kMaxClusters : c;
}

// The ring's stages and the dynamic shared memory (bytes) of a launch, as
// the kernels lay it out; stages 0 where even one stage does not fit.
void plan(int B, int N, int fi, int J, int h2, bool forward, int* stages,
          int* smem) {
  const int G = kThreads / N, ld = N + 4;
  const int stage =
      G * (pad_tile(J * N * ld) + (forward ? pad_tile(N * x_width(fi)) : 0));
  const int blocks = kCtas * clusters_for(B, N);
  const int gpb = (B + blocks - 1) / blocks;
  const int chunks = (gpb + G - 1) / G;
  const long long fixed = forward ? 0 : (long long)gpb * pad_tile(N * h2);
  const long long budget = (kSmemMax - kStaticReserve) / 4 - fixed;
  int s = (int)(budget / stage);
  s = s > kMaxStages ? kMaxStages : s;
  s = s > chunks ? chunks : s;
  if (chunks == 0) s = 1;
  *stages = s < 1 ? 0 : s;
  *smem = (int)(4 * ((long long)(*stages) * stage + fixed));
}

bool g_ready = false;

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int clusters, int smem,
           cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int allow(const void* k) {
  cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax - (int)fa.sharedSizeBytes);
  return (int)err;
}

bool shape_ok(int B, int N, int fi, int J, int h2) {
  if (B < 1 || N < 4 || N > kMaxN || N % 4 != 0 || fwd_kernel(fi, J, h2) == nullptr)
    return false;
  const int blocks = kCtas * clusters_for(B, N);
  return (long long)B * N <= kMaxRows &&
         (long long)((B + blocks - 1) / blocks) * N <= kMaxBlockRows;
}

}  // namespace

// Allows every kernel the non-portable cluster of 16 blocks and all the
// dynamic shared memory its static part leaves, once (a call that is no
// stream work, made before any capture): 0, or the CUDA error.
extern "C" int hgnn2_power_init() {
#define HGNN2_ALLOW(FI, JJ, HH)                                        \
  if (int e = allow((const void*)power_forward<FI, JJ, HH>)) return e; \
  if (int e = allow((const void*)power_backward<FI, JJ, HH>)) return e;
  HGNN2_POWER_SHAPES(HGNN2_ALLOW)
#undef HGNN2_ALLOW
  g_ready = true;
  return 0;
}

// x (B, N, Fi); A (B, J, N, N), 16-byte aligned; deg, m_id, m (B, N);
// w1, w2 (H, K), b1, b2 (H); scale, bias (H2) or one float (scalar_affine);
// out, z (B, N, H2); stats (2 H2 + 1): the batch mean, std and the clamped
// count; run_mean, run_std (H2) updated in place; parts a scratch of
// clusters x (H2 + 1) floats (ops/power_layer.py:clusters). keep =
// 1 - momentum.
extern "C" int hgnn2_power_forward(
    const void* x, const void* A, const void* deg, const void* mid,
    const void* mbn, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* scale, const void* bias, void* out, void* z,
    void* stats, void* run_mean, void* run_std, void* parts, int B, int N,
    int fi, int J, int h2, int scalar_affine, int mask_out, float eps,
    float keep, float momentum, void* stream) {
  if (!g_ready || !shape_ok(B, N, fi, J, h2) || ((uintptr_t)A & 15))
    return (int)cudaErrorInvalidValue;
  int stages, smem;
  plan(B, N, fi, J, h2, true, &stages, &smem);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  return launch(fwd_kernel(fi, J, h2), clusters_for(B, N), smem,
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(x), static_cast<const float*>(A),
                static_cast<const float*>(deg), static_cast<const float*>(mid),
                static_cast<const float*>(mbn), static_cast<const float*>(w1),
                static_cast<const float*>(b1), static_cast<const float*>(w2),
                static_cast<const float*>(b2), static_cast<const float*>(scale),
                static_cast<const float*>(bias), static_cast<float*>(out),
                static_cast<float*>(z), static_cast<float*>(stats),
                static_cast<float*>(run_mean), static_cast<float*>(run_std),
                static_cast<float*>(parts), B, N, scalar_affine, mask_out, eps,
                keep, momentum, stages);
}

// g, z (B, N, H2) (z and stats as the forward wrote them); the forward's
// x, A, deg, m_id, m, w1, w2 and scale; dx (B, N, Fi) or null (not
// written); g_w1, g_w2 (H, K), g_b1, g_b2 (H); g_scale, g_bias shaped as
// scale; parts a scratch of 16 clusters x (H2 K + H2) floats.
extern "C" int hgnn2_power_backward(
    const void* g, const void* x, const void* A, const void* deg,
    const void* mid, const void* mbn, const void* w1, const void* w2,
    const void* scale, const void* z, const void* stats, void* dx,
    void* g_w1, void* g_b1, void* g_w2, void* g_b2, void* g_scale,
    void* g_bias, void* parts, int B, int N, int fi, int J, int h2,
    int scalar_affine, int mask_out, void* stream) {
  if (!g_ready || !shape_ok(B, N, fi, J, h2) || ((uintptr_t)A & 15))
    return (int)cudaErrorInvalidValue;
  int stages, smem;
  plan(B, N, fi, J, h2, false, &stages, &smem);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  return launch(bwd_kernel(fi, J, h2), clusters_for(B, N), smem,
                static_cast<cudaStream_t>(stream),
                static_cast<const float*>(g), static_cast<const float*>(x),
                static_cast<const float*>(A), static_cast<const float*>(deg),
                static_cast<const float*>(mid), static_cast<const float*>(mbn),
                static_cast<const float*>(w1), static_cast<const float*>(w2),
                static_cast<const float*>(scale), static_cast<const float*>(z),
                static_cast<const float*>(stats), static_cast<float*>(dx),
                static_cast<float*>(g_w1), static_cast<float*>(g_b1),
                static_cast<float*>(g_w2), static_cast<float*>(g_b2),
                static_cast<float*>(g_scale), static_cast<float*>(g_bias),
                static_cast<float*>(parts), B, N, scalar_affine, mask_out,
                stages);
}
