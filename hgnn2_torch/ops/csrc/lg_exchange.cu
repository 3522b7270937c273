// The line-graph exchange of nn/bundles.py:DenseBundle in index form, for
// Hopper (sm_90a): [Pm xl | Pd xl], [Pm^T x | Pd^T x] and the
// non-backtracking apply, forward and backward, one launch each.
//
// Replaces no TPU kernel: the JAX package applies the exchange as products
// with one-hot (B, N, M) scatter matrices (hgnn2_tpu/ops/dense.py), which
// XLA fuses on the TPU. On the H100 those products are cuBLAS batched GEMVs
// that read the whole of S (4.2 MB at 2,048 graphs of 16 node and 32 edge
// slots, 16.8 MB at 32/64) to move one or two floats an edge; here the same
// sums are taken over each graph's index arrays.
//
// Per graph of N node and M edge slots, edge e = (src e -> dst e), rev e its
// reverse, m_e = emask[e] (0 at padded edges), w_e its weight:
//   to_nodes, pair: out[n] = [A + D | A - D],  A = sum_{src e = n} m_e in[e],
//                   D = sum_{dst e = n} m_e in[e]            ([Pm xl | Pd xl])
//   to_nodes, sum:  out[n] = sum_{src e = n} m_e (g_m + g_d)[e]
//                          + sum_{dst e = n} m_e (g_m - g_d)[e]
//                   (the backward of to_edges, pair; g = [g_m | g_d])
//   to_edges, pair: out[e] = [a + c | a - c],  a = m_e x[src e], c = m_e x[dst e]
//                   ([Pm^T x | Pd^T x])
//   to_edges, sum:  out[e] = m_e (g_m + g_d)[src e] + m_e (g_m - g_d)[dst e]
//                   (the backward of to_nodes, pair)
//   nb_forward:     (AL xl)[e] = m_e Y[dst e] - w_{rev e} xl[rev e],
//                   Y[n] = sum_{src e = n} m_e (w_e xl[e]);
//                   full: [xl m_e | dl_e xl | AL xl], lg_graph_op's output at J = 1
//   nb_backward:    g_xl[e] = w_e (m_e G[src e]) - sum_{rev e' = e} g[e'] w_e,
//                   G[n] = sum_{dst e = n} m_e g[e];
//                   full: g = [g_id | g_dl | g], plus m_e g_id[e] + dl_e g_dl[e]
// Each product and sum rounds on its own (__fmul_rn, __fadd_rn), as the
// composition's separate kernels do; a gather's one nonzero term is exact
// in a one-hot product, so only the order of the segment sums differs from
// the composition. The segment sums run over a graph's edges in ascending
// order, with no atomics: a run gives the same bits each time. An index out
// of range (src, dst outside [0, N), rev outside [0, M)) adds nothing.
// Padded edges keep the composition's values: their rev is 0, so
// (AL xl)[e] = -w_0 xl[0] there, and their gradient flows back into edge 0.
// (ops/lg_exchange.py holds the same functions in PyTorch.)
//
// What bounds them on an H100: at the line-graph cell's shapes (2,048 graphs,
// N/M = 16/32 or 32/64, F = 1, 2 or 5) a call reads and writes 0.3-3 MB of
// indices and features, at most about 1 us of HBM time, and its work is a few
// adds an edge; the launch, about 2 us in a run, bounds them. So each is one
// launch that keeps every step on chip. A block takes G consecutive graphs
// (about kThreads (node or edge, feature) items; ops/lg_exchange.py picks G)
// and stages their index rows and input rows in shared memory with coalesced
// loads: the G graphs' rows are one contiguous run of each array. Each thread
// then takes items and scans its graph's edges in shared memory, where all
// threads of a graph read the same word (a broadcast). The NB kernels run two
// phases in one block: the node sums into shared memory, a barrier, then the
// edge rows. to_edges gathers at most two rows an output and stages nothing:
// one thread an output element. A graph whose rows do not fit kSmemBytes takes
// the looped instantiation (G = 0 at the entry): one graph a block, reading
// device memory, the NB node sums in a scratch buffer the wrapper allocates.
//
// The entries have a plain C interface (loaded with ctypes), launch once on
// the given stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;        // the staged kernels' block
constexpr int kGatherThreads = 256;  // to_edges' block
constexpr size_t kSmemBytes = 48 * 1024;

__device__ __forceinline__ bool in_range(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// Copies count words from device memory to shared memory, the block's
// threads on consecutive words.
template <typename T>
__device__ __forceinline__ void stage(T* to, const T* __restrict__ from,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) to[i] = from[i];
}

// Copies columns [off, off + F) of rows of ld floats, packed F a row.
__device__ __forceinline__ void stage_cols(float* to,
                                           const float* __restrict__ from,
                                           int rows, int ld, int off, int F) {
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F;
    to[i] = from[(size_t)r * ld + off + (i - r * F)];
  }
}

// Edges -> nodes (segment sums over src and dst). PAIR: in (B, M, F), out
// (B, N, 2F); else in (B, M, 2F), out (B, N, F). Shared memory, STAGED:
// src, dst [G M] ints, emask [G M], in [G M fi] floats.
template <bool PAIR, bool STAGED>
__global__ void __launch_bounds__(kThreads)
lg_to_nodes(const int* __restrict__ src, const int* __restrict__ dst,
            const float* __restrict__ emask, const float* __restrict__ in,
            float* __restrict__ out, int B, int N, int M, int F, int G) {
  extern __shared__ int smem[];
  const int fi = PAIR ? F : 2 * F;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const size_t e0 = (size_t)b0 * M;
  const int* s = src + e0;
  const int* d = dst + e0;
  const float* em = emask + e0;
  const float* x = in + e0 * fi;
  if constexpr (STAGED) {
    int* ss = smem;
    int* sd = ss + G * M;
    float* sem = reinterpret_cast<float*>(sd + G * M);
    float* sx = sem + G * M;
    stage(ss, s, nb * M);
    stage(sd, d, nb * M);
    stage(sem, em, nb * M);
    stage(sx, x, nb * M * fi);
    __syncthreads();
    s = ss;
    d = sd;
    em = sem;
    x = sx;
  }
  const int per = N * F;
  for (int it = threadIdx.x; it < nb * per; it += blockDim.x) {
    const int gi = it / per, r = it - gi * per, n = r / F, f = r - n * F;
    const int* gs = s + gi * M;
    const int* gd = d + gi * M;
    const float* ge = em + gi * M;
    const float* gx = x + (size_t)gi * M * fi;
    float a = 0.f, c = 0.f;
    for (int e = 0; e < M; ++e) {
      const int se = gs[e], de = gd[e];
      if (se != n && de != n) continue;
      float u, v;
      if constexpr (PAIR) {
        u = v = __fmul_rn(ge[e], gx[e * fi + f]);
      } else {
        const float gm = gx[e * fi + f], gdv = gx[e * fi + F + f];
        u = __fmul_rn(ge[e], __fadd_rn(gm, gdv));
        v = __fmul_rn(ge[e], __fsub_rn(gm, gdv));
      }
      if (se == n) a = __fadd_rn(a, u);
      if (de == n) c = __fadd_rn(c, v);
    }
    if constexpr (PAIR) {
      float* o = out + ((size_t)(b0 + gi) * N + n) * 2 * F;
      o[f] = __fadd_rn(a, c);
      o[F + f] = __fsub_rn(a, c);
    } else {
      out[((size_t)(b0 + gi) * N + n) * F + f] = __fadd_rn(a, c);
    }
  }
}

// Nodes -> edges (gathers), one thread an output element. PAIR: in x
// (B, N, F), out (B, M, 2F); else in g (B, N, 2F), out (B, M, F).
template <bool PAIR>
__global__ void __launch_bounds__(kGatherThreads)
lg_to_edges(const int* __restrict__ src, const int* __restrict__ dst,
            const float* __restrict__ emask, const float* __restrict__ in,
            float* __restrict__ out, int B, int N, int M, int F) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * M * F) return;
  const size_t be = i / F;  // the edge row b M + e
  const int f = (int)(i - be * F);
  const int fi = PAIR ? F : 2 * F;
  const float* x = in + (be / M) * N * fi;
  const int s = src[be], d = dst[be];
  const float m = emask[be];
  if constexpr (PAIR) {
    const float a = __fmul_rn(m, in_range(s, N) ? x[s * fi + f] : 0.f);
    const float c = __fmul_rn(m, in_range(d, N) ? x[d * fi + f] : 0.f);
    out[be * 2 * F + f] = __fadd_rn(a, c);
    out[be * 2 * F + F + f] = __fsub_rn(a, c);
  } else {
    const float ga = in_range(s, N) ? __fadd_rn(x[s * fi + f], x[s * fi + F + f]) : 0.f;
    const float gb = in_range(d, N) ? __fsub_rn(x[d * fi + f], x[d * fi + F + f]) : 0.f;
    out[be * F + f] = __fadd_rn(__fmul_rn(m, ga), __fmul_rn(m, gb));
  }
}

// The NB kernels' shared memory, STAGED: src, dst, rev [G M] ints, emask, w
// [G M], the edge rows [G M F] and the node sums [G N F] floats.
struct NbShared {
  const int *src, *dst, *rev;
  const float *emask, *w, *rows;
  float* nodes;
  int ld;  // the edge rows' stride
};

// Points a block's NB arrays at its G graphs: staged copies in shared
// memory (rows' columns [off, off + F) of each ld-float row), or the
// graphs' rows in device memory and the node sums in scratch.
template <bool STAGED>
__device__ __forceinline__ NbShared nb_arrays(
    const int* src, const int* dst, const int* rev, const float* emask,
    const float* w, const float* rows, int ld, int off, float* scratch, int b0,
    int nb, int G, int N, int M, int F) {
  const size_t e0 = (size_t)b0 * M;
  if constexpr (STAGED) {
    extern __shared__ int smem[];
    int* ss = smem;
    int* sd = ss + G * M;
    int* sr = sd + G * M;
    float* sem = reinterpret_cast<float*>(sr + G * M);
    float* sw = sem + G * M;
    float* sx = sw + G * M;
    stage(ss, src + e0, nb * M);
    stage(sd, dst + e0, nb * M);
    stage(sr, rev + e0, nb * M);
    stage(sem, emask + e0, nb * M);
    stage(sw, w + e0, nb * M);
    stage_cols(sx, rows + e0 * ld, nb * M, ld, off, F);
    __syncthreads();
    return {ss, sd, sr, sem, sw, sx, sx + G * M * F, F};
  } else {
    return {src + e0, dst + e0, rev + e0, emask + e0, w + e0,
            rows + e0 * ld + off, scratch + (size_t)b0 * N * F, ld};
  }
}

// xl (B, M, F); out (B, M, 3F) when full (dl (B, M) read), else (B, M, F).
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
lg_nb_forward(const int* __restrict__ src, const int* __restrict__ dst,
              const int* __restrict__ rev, const float* __restrict__ emask,
              const float* __restrict__ w, const float* __restrict__ dl,
              const float* __restrict__ xl, float* __restrict__ out,
              float* scratch, int B, int N, int M, int F, int G, int full) {
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const NbShared a = nb_arrays<STAGED>(src, dst, rev, emask, w, xl, F, 0,
                                       scratch, b0, nb, G, N, M, F);
  // phase 1: Y[n] = sum_{src e = n} m_e (w_e xl[e])
  const int pn = N * F;
  for (int it = threadIdx.x; it < nb * pn; it += blockDim.x) {
    const int gi = it / pn, r = it - gi * pn, n = r / F, f = r - n * F;
    const int* gs = a.src + gi * M;
    const float* ge = a.emask + gi * M;
    const float* gw = a.w + gi * M;
    const float* gx = a.rows + (size_t)gi * M * a.ld;
    float acc = 0.f;
    for (int e = 0; e < M; ++e)
      if (gs[e] == n)
        acc = __fadd_rn(acc, __fmul_rn(ge[e], __fmul_rn(gw[e], gx[e * a.ld + f])));
    a.nodes[gi * pn + r] = acc;
  }
  __syncthreads();
  // phase 2: the edge rows
  const int pm = M * F, fo = full ? 3 * F : F;
  for (int it = threadIdx.x; it < nb * pm; it += blockDim.x) {
    const int gi = it / pm, r = it - gi * pm, e = r / F, f = r - e * F;
    const float* gw = a.w + gi * M;
    const float* gx = a.rows + (size_t)gi * M * a.ld;
    const int de = a.dst[gi * M + e], re = a.rev[gi * M + e];
    const float m = a.emask[gi * M + e], xv = gx[e * a.ld + f];
    const float y = in_range(de, N) ? a.nodes[gi * pn + de * F + f] : 0.f;
    const float back = in_range(re, M) ? __fmul_rn(gw[re], gx[re * a.ld + f]) : 0.f;
    const float al = __fsub_rn(__fmul_rn(m, y), back);
    const size_t row = (size_t)(b0 + gi) * M + e;
    if (full) {
      float* o = out + row * fo;
      o[f] = __fmul_rn(xv, m);
      o[F + f] = __fmul_rn(dl[row], xv);
      o[2 * F + f] = al;
    } else {
      out[row * F + f] = al;
    }
  }
}

// g (B, M, 3F) when full ([g_id | g_dl | g], dl (B, M) read), else
// (B, M, F); out g_xl (B, M, F).
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
lg_nb_backward(const int* __restrict__ src, const int* __restrict__ dst,
               const int* __restrict__ rev, const float* __restrict__ emask,
               const float* __restrict__ w, const float* __restrict__ dl,
               const float* __restrict__ g, float* __restrict__ out,
               float* scratch, int B, int N, int M, int F, int G, int full) {
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const int fg = full ? 3 * F : F;
  const NbShared a = nb_arrays<STAGED>(src, dst, rev, emask, w, g, fg,
                                       full ? 2 * F : 0, scratch, b0, nb, G,
                                       N, M, F);
  // phase 1: G[n] = sum_{dst e = n} m_e g[e]
  const int pn = N * F;
  for (int it = threadIdx.x; it < nb * pn; it += blockDim.x) {
    const int gi = it / pn, r = it - gi * pn, n = r / F, f = r - n * F;
    const int* gd = a.dst + gi * M;
    const float* ge = a.emask + gi * M;
    const float* gg = a.rows + (size_t)gi * M * a.ld;
    float acc = 0.f;
    for (int e = 0; e < M; ++e)
      if (gd[e] == n) acc = __fadd_rn(acc, __fmul_rn(ge[e], gg[e * a.ld + f]));
    a.nodes[gi * pn + r] = acc;
  }
  __syncthreads();
  // phase 2: g_xl[e] = w_e (m_e G[src e]) - sum_{rev e' = e} g[e'] w_e
  const int pm = M * F;
  for (int it = threadIdx.x; it < nb * pm; it += blockDim.x) {
    const int gi = it / pm, r = it - gi * pm, e = r / F, f = r - e * F;
    const int* gr = a.rev + gi * M;
    const float* gg = a.rows + (size_t)gi * M * a.ld;
    const int se = a.src[gi * M + e];
    const float m = a.emask[gi * M + e], we = a.w[gi * M + e];
    float back = 0.f;
    for (int e2 = 0; e2 < M; ++e2)
      if (gr[e2] == e) back = __fadd_rn(back, __fmul_rn(gg[e2 * a.ld + f], we));
    const float gs = in_range(se, N) ? a.nodes[gi * pn + se * F + f] : 0.f;
    float res = __fsub_rn(__fmul_rn(we, __fmul_rn(m, gs)), back);
    const size_t row = (size_t)(b0 + gi) * M + e;
    if (full) {
      const float* gi_row = g + row * fg;
      res = __fadd_rn(__fadd_rn(__fmul_rn(m, gi_row[f]),
                                __fmul_rn(dl[row], gi_row[F + f])),
                      res);
    }
    out[row * F + f] = res;
  }
}

// Shared-memory bytes of G staged graphs (ops/lg_exchange.py:_graph_words).
size_t to_nodes_smem(int G, int M, int fi) {
  return 4ull * G * (3ull * M + (size_t)M * fi);
}

size_t nb_smem(int G, int N, int M, int F) {
  return 4ull * G * (5ull * M + (size_t)M * F + (size_t)N * F);
}

bool bad_shape(int B, int N, int M, int F, int G) {
  return B < 0 || N < 1 || M < 0 || F < 1 || G < 0;
}

int launched() { return (int)cudaGetLastError(); }

// The grid of G graphs a block (G = 0: one graph a block, looped).
int blocks(int B, int G) { return G > 0 ? (B + G - 1) / G : B; }

}  // namespace

// pair: in (B, M, F) -> out (B, N, 2F); else in (B, M, 2F) -> out (B, N, F).
// src, dst (B, M) int32, emask (B, M). G graphs a block, 0: looped.
extern "C" int hgnn2_lg_to_nodes(const void* src, const void* dst,
                                 const void* emask, const void* in, void* out,
                                 int B, int N, int M, int F, int pair, int G,
                                 void* stream) {
  if (bad_shape(B, N, M, F, G)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = G > 0 ? to_nodes_smem(G, M, pair ? F : 2 * F) : 0;
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const int*>(src);
  const auto* d = static_cast<const int*>(dst);
  const auto* m = static_cast<const float*>(emask);
  const auto* x = static_cast<const float*>(in);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int g = G > 0 ? G : 1;
  if (pair) {
    if (G > 0)
      lg_to_nodes<true, true><<<blocks(B, G), kThreads, smem, st>>>(s, d, m, x, o, B, N, M, F, g);
    else
      lg_to_nodes<true, false><<<B, kThreads, 0, st>>>(s, d, m, x, o, B, N, M, F, g);
  } else {
    if (G > 0)
      lg_to_nodes<false, true><<<blocks(B, G), kThreads, smem, st>>>(s, d, m, x, o, B, N, M, F, g);
    else
      lg_to_nodes<false, false><<<B, kThreads, 0, st>>>(s, d, m, x, o, B, N, M, F, g);
  }
  return launched();
}

// pair: in x (B, N, F) -> out (B, M, 2F); else in g (B, N, 2F) -> out
// (B, M, F).
extern "C" int hgnn2_lg_to_edges(const void* src, const void* dst,
                                 const void* emask, const void* in, void* out,
                                 int B, int N, int M, int F, int pair,
                                 void* stream) {
  if (bad_shape(B, N, M, F, 0)) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * M * F;
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + kGatherThreads - 1) / kGatherThreads);
  const auto* s = static_cast<const int*>(src);
  const auto* d = static_cast<const int*>(dst);
  const auto* m = static_cast<const float*>(emask);
  const auto* x = static_cast<const float*>(in);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (pair)
    lg_to_edges<true><<<grid, kGatherThreads, 0, st>>>(s, d, m, x, o, B, N, M, F);
  else
    lg_to_edges<false><<<grid, kGatherThreads, 0, st>>>(s, d, m, x, o, B, N, M, F);
  return launched();
}

namespace {

using NbKernel = void (*)(const int*, const int*, const int*, const float*,
                          const float*, const float*, const float*, float*,
                          float*, int, int, int, int, int, int);

int nb_launch(NbKernel staged, NbKernel looped, const void* src,
              const void* dst, const void* rev, const void* emask,
              const void* w, const void* dl, const void* in, void* out,
              void* scratch, int B, int N, int M, int F, int full, int G,
              void* stream) {
  if (bad_shape(B, N, M, F, G) || (full && dl == nullptr) ||
      (G == 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  const size_t smem = G > 0 ? nb_smem(G, N, M, F) : 0;
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  (G > 0 ? staged : looped)<<<blocks(B, G), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(rev), static_cast<const float*>(emask),
      static_cast<const float*>(w), static_cast<const float*>(dl),
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<float*>(scratch), B, N, M, F, G > 0 ? G : 1, full);
  return launched();
}

}  // namespace

// xl (B, M, F) -> out (B, M, 3F) [xl m | dl xl | AL xl] when full, else
// (B, M, F) AL xl. rev (B, M) int32; w, dl (B, M) (dl only when full).
// scratch (B, N, F) floats when G = 0 (looped), else unused.
extern "C" int hgnn2_lg_nb_forward(const void* src, const void* dst,
                                   const void* rev, const void* emask,
                                   const void* w, const void* dl,
                                   const void* xl, void* out, void* scratch,
                                   int B, int N, int M, int F, int full, int G,
                                   void* stream) {
  return nb_launch(lg_nb_forward<true>, lg_nb_forward<false>, src, dst, rev,
                   emask, w, dl, xl, out, scratch, B, N, M, F, full, G, stream);
}

// g (B, M, 3F) when full, else (B, M, F) -> g_xl (B, M, F); the rest as
// hgnn2_lg_nb_forward.
extern "C" int hgnn2_lg_nb_backward(const void* src, const void* dst,
                                    const void* rev, const void* emask,
                                    const void* w, const void* dl,
                                    const void* g, void* out, void* scratch,
                                    int B, int N, int M, int F, int full, int G,
                                    void* stream) {
  return nb_launch(lg_nb_backward<true>, lg_nb_backward<false>, src, dst, rev,
                   emask, w, dl, g, out, scratch, B, N, M, F, full, G, stream);
}
