// Fused CCN promotion + contraction kernels for Hopper (sm_90a): the
// forward kernels K1 and K3, and their backward kernels K2 and K4.
//
// K1  ccn1d_forward  replaces hgnn2_tpu/ops/pallas/ccn_fused.py:_kernel_1d
//     out[v, a, c]     = row[a] = sum_k T[k, a, c]
//     out[v, k, C + c] = col[k] = sum_a T[k, a, c]
//     with T[k, a, c] = f[nbr[v,k], chi[v,k,a], c], 0 where chi = -1.
// K3  ccn2d_forward  replaces hgnn2_tpu/ops/pallas/ccn_fused.py:_kernel
//     out[v, i, j, ch*C + c] = channel ch of contract_18 applied to
//     T_k[a, b, c] = f[nbr[v,k], chi[v,k,a], chi[v,k,b], c] (0 where either
//     index is -1), folded into the 18 channels one k at a time: the
//     (V, K, K, K, C) promotion tensor is never written.
// K2  ccn1d_backward replaces hgnn2_tpu/ops/pallas/ccn_fused.py:_bwd_kernel_1d
//     df[u, p, c] = sum_j (g[n, chi[u,j,p], c] + g[n, rslot[u,j], C + c])
//     with n = nbr[u,j], over slots j with rslot and chi entry valid.
// K4  ccn2d_backward replaces hgnn2_tpu/ops/pallas/ccn_fused.py:_bwd_kernel
//     and its XLA prologue contract_18_transpose_parts
//     (hgnn2_tpu/ops/contractions.py:295, called at
//     hgnn2_tpu/ops/pallas/ccn_fused.py:470)
//     df[u, p, q, c] = sum_j gbar[n, r, chi[u,j,p], chi[u,j,q], c], with
//     n = nbr[u,j], r = rslot[u,j] and gbar[n,k,a,b] = d_sk[n,a,b]
//     + d_rb[n,k,a] + [a == b] d_diag[n,k,a] + [b == k] d_kakT[n,k,a],
//     where the four parts of contract_18's adjoint are formed from
//     g (V, K, K, 18C) inside the kernel: neither they nor gbar are written.
// Both backward kernels are gathers: chi is symmetric across an edge, so
// the promotion's adjoint is enumerated from the receiving vertex's side
// and no two threads write one address (no atomics).
//
// What bounds them on an H100 (reckoned from byte counts, f32):
//   K3 writes V*K*K*18C*4 bytes and reads about a tenth of that: at
//   V = 16384, K = 5 that is 147 MB at C = 5 and 59 MB at C = 2, i.e.
//   about 44 us and 18 us at the data sheet's 3.35 TB/s. It is bound by
//   its output write; the arithmetic (O(K^3 C) adds per vertex) is tiny.
//   K1 moves about 6.9 MB at C = 5 (chi, nbr, f, out): about 2 us.
//   K2 moves about 4.3 MB at C = 2 (g, chi, nbr, rslot, df): about 1.3 us.
//   K4 reads g (V*K*K*18C*4 bytes: 59 MB at C = 2, 147 MB at C = 5) and
//   the tables and writes df: about 65 MB and 158 MB, i.e. 19 us and
//   47 us. All four do O(K^2 C) to O(K^3 C) adds per vertex: bytes bound
//   them.
//   The backward kernels' gathers hit the same rows as the forward's
//   (graphs are contiguous in the vertex axis), so they read mostly L2.
//
// All four read neighbour rows straight from their input by index
// (graphs are small and contiguous in the vertex axis, so the reads
// mostly hit L2): no halo window and no graph-size limit. An index of -1
// (or any index out of range) contributes an exact 0 and is never read
// at. K is a template parameter (1..8) so every loop over K unrolls.
//
// K1, K2: one thread per (vertex, slot, channel) -- at the serving
// bucket (V = 16384, K = 5) 409,600 threads at C = 5 and 163,840 at
// C = 2, five times as many as one thread per (vertex, channel), so
// every SM is busy and each thread's chain is short: it loads its slot's
// neighbour n (K2: and rslot r) and its K chi entries (the C threads of
// a slot read the same words: one transaction a warp), then issues its K
// gathers (K1: f[n, chi[v,k,a], c]; K2: g's row half at chi[u,j,p] and
// col half at r) together. K1's thread sums col[k] from its own K values
// and writes them to shared memory; after one __syncthreads the thread
// of slot k sums row[a = k] over its vertex's K slots there, so no
// thread holds a K x K tile. K2's thread writes slot j's share of
// df[u, p] for every p, and the thread of slot j then sums df[u, p = j]
// over the slots. A padding slot (n or r out of range) reads no f or g.
// Each thread stores its own floats in the output's order: consecutive
// lanes write consecutive channels (K1: a row and a col float, C apart).
// A block owns Vt vertices and Ct channels, Vt * K * Ct <= 256 threads
// (ops/ccn_fused.py:_k12_tile); Ct < C only where K * C > 256. Tried on
// the H100 and slower (PERF.md): tiles that staged the gathers or the
// output in shared memory (16-byte stores) or the tables, a window of
// neighbour rows in shared memory, 2 to 4 items or channels a thread
// (fewer threads, but more registers and so fewer threads an SM), one
// thread per output float with no shared memory, and L1-bypassing loads.
//
// K4: one thread per (vertex u, slot j, channel c), as K2. Its bound is
// the one read of g, so the design writes nothing else: the TPU's two
// steps (XLA forms the four (V, K, K, C) parts, then the kernel gathers
// them) would write 13 MB at C = 2 and read it back, in two launches.
// The thread loads its slot's neighbour n, n's slot r of u, and u's chi
// row, and forms from n's g the parts that slot needs (NbrParts): the
// masked sums of n's row r and diagonal, of row a for each chi entry a,
// and the elementwise terms at [r][a] and [a][b]; a padding slot (n or r
// out of range) reads no g. It writes the slot's share of df[u] (K^2
// floats) to shared memory; after one barrier the thread of slot j sums
// the pairs (p, q) = j, j + K, ... over the slots in order. A row of g is
// read by up to K vertices, its neighbours; graphs are contiguous in the
// vertex axis, so most re-reads can come from L2. Every sum is formed
// with the plain versions' operations in their order (each product and
// add rounded on its own, no fused multiply-add), so df equals
// promote_2d_bwd(contract_18_transpose(g)) bit for bit, at any K. A
// block has at most 128 threads and K^2 floats of shared memory a
// thread, 32 KB at K = 8 (ops/ccn_fused.py:_k4_tile); where K * C > 128
// the channels split over blocks. Tried on the H100 and slower (PERF.md):
// a prologue kernel that stages g in shared memory and writes the four
// parts, followed by a gather of them with one thread per (u, p, c) or
// per output float; and one thread per (u, p, c) forming the parts from g.
//
// K3: a block owns a tile of Vt vertices and Ct channels (Ct = C unless
// the tile would not fit shared memory; the wrapper's _k3_tile picks
// both and the shared-memory size, so there is no limit on C or on V).
// Its output is what bounds it, so the design is about the stores:
//   A. reductions: one thread per (vertex, row a, channel) reads
//      f[nbr[v,k], chi[v,k,a], chi[v,k,b], c] over k and b (all K^2
//      loads independent, so they overlap) and writes the 4K values of
//      its row -- sum_k T_k[a, b] (as [b][a]) and, per k, sum_b T_k[a, b],
//      T_k[a, a] and T_k[a, k] -- to shared memory, laid out
//      [v][part][K][a][c] so that neighbouring threads hit neighbouring
//      banks. K accumulators a thread, not 4 K^2: no spills at any K.
//   B. per-vertex sums over those: sab, skb, tr_ab, c11 (K each) and
//      tot, sum_kkb, tr_sum, t_xxx, into shared memory.
//   C1. one thread per (vertex, i, j, channel) forms the 18 channels
//      as contract_18 does, compat included, and stages them in shared
//      memory in the output's own layout.
//   C2. with Ct = C the staged tile is one contiguous run of
//      Vt*K*K*18*C floats in device memory too: threads copy it out in
//      16-byte stores with a streaming hint (the output cannot stay in
//      the 50 MB L2), consecutive lanes on consecutive addresses, so a
//      warp writes 512 contiguous bytes an instruction. Vt is even, so
//      every tile starts 16-byte aligned; a ragged end, a channel tile
//      (Ct < C: runs of Ct floats) or a misaligned start copy floats.
//      (A TMA bulk copy of the staged tile by one thread, and stores
//      without the streaming hint, were both slower on the H100.)
// __syncthreads() separates the table loads and the phases; each phase
// is a loop over its items with the block's stride, so no phase depends
// on the block size.
//
// The entry points have a plain C interface (loaded with ctypes). They
// launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

// The tables from make_ccn_batch hold -1 or an index in range. Any other
// index also contributes 0, so a malformed table never reads outside f.
__device__ __forceinline__ bool in_range(int i, int n) {
  return (unsigned)i < (unsigned)n;
}

// ---- K1 and K2 ----

// Threads of a K1 or K2 block: Vt * K * Ct of them, at most this many
// (ops/ccn_fused.py:_k12_tile chooses the tile).
constexpr int kK12MaxThreads = 256;

template <int K>
__global__ void __launch_bounds__(kK12MaxThreads)
ccn1d_forward(const int* __restrict__ chi, const int* __restrict__ nbr,
              const float* __restrict__ f, float* __restrict__ out,
              int V, int C, int Vt, int Ct) {
  extern __shared__ float k12_smem[];  // T[v][k][a][c] of the tile
  const int t = threadIdx.x;
  const int c = t % Ct, vk = t / Ct;  // thread (v, k, c), vk = v * K + k
  const int v0 = blockIdx.x * Vt, gc = blockIdx.y * Ct + c;
  const long long gvk = (long long)v0 * K + vk;
  const bool active = v0 + vk / K < V && gc < C;
  float* tk = k12_smem + vk * K * Ct + c;  // T[v][k][a][c] at tk[a * Ct]
  float col = 0.f;
  if (active) {
    const int n = __ldg(nbr + gvk);
    int p[K];
#pragma unroll
    for (int a = 0; a < K; ++a) p[a] = __ldg(chi + gvk * K + a);
    const bool n_ok = in_range(n, V);
    const float* f_n = f + (long long)(n_ok ? n : 0) * K * C + gc;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float val = n_ok && in_range(p[a], K) ? __ldg(f_n + p[a] * C) : 0.f;
      tk[a * Ct] = val;
      col += val;
    }
  }
  __syncthreads();
  if (!active) return;
  // row[a = k] = sum over the slots y of T[v][y][k][c]
  const int v = vk / K, k = vk % K;
  const float* ty = k12_smem + (v * K * K + k) * Ct + c;
  float row = 0.f;
#pragma unroll
  for (int y = 0; y < K; ++y) row += ty[y * K * Ct];
  float* o = out + gvk * 2 * C + gc;
  o[0] = row;
  o[C] = col;
}

// ---- K3 ----

constexpr int kK3Threads = 256;
constexpr int kChannels = 18;  // contract_18's channel blocks

// Shared memory of a K3 block, in 4-byte words per vertex: the staged
// output, 18 K^2 channels; the reductions, four K x K parts -- [0] sk
// as [b][a], [1] rb[k][a], [2] diag[k][a], [3] colk[k][a] -- then four
// K-vectors (sab, skb, tr_ab, c11) indexed by i, then four scalars (tot,
// sum_kkb, tr_sum, t_xxx), all times the tile's channels; and the
// tables: chi (K x K), nbr, row_mask (K each) and deg.
template <int K>
struct K3Slots {
  static constexpr int kPart = K * K;
  static constexpr int kRow = 4 * K * K;
  static constexpr int kScalar = 4 * K * K + 4 * K;
  static constexpr int kCount = 4 * K * K + 4 * K + 4;
  static constexpr int kTable = K * K + 2 * K + 1;
  // words of a vertex at ct channels
  static constexpr long long words(int ct) {
    return (long long)(kChannels * K * K + kCount) * ct + kTable;
  }
};

// Unsigned division by a block-uniform d, exact for e * d < 2^32 (a
// tile's output fits shared memory, so every index and divisor here is
// below 2^16): e / d == umulhi(e, ceil(2^32 / d)), d == 1 passed through.
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(unsigned d_)
      : d(d_), m(d_ > 1 ? 0xFFFFFFFFu / d_ + 1u : 0u) {}
  __device__ __forceinline__ unsigned div(unsigned e) const {
    return d > 1 ? __umulhi(e, m) : e;
  }
};

template <int K>
__global__ void __launch_bounds__(kK3Threads)
ccn2d_forward(const int* __restrict__ chi, const int* __restrict__ nbr,
              const float* __restrict__ f, const float* __restrict__ deg,
              const float* __restrict__ row_mask, float* __restrict__ out,
              int V, int C, int Vt, int Ct, int compat) {
  using L = K3Slots<K>;
  constexpr int P = L::kPart, NS = L::kCount, KK = K * K;
  constexpr int Q = L::kRow, Z = L::kScalar;
  extern __shared__ float4 k3_smem[];
  const unsigned tid = threadIdx.x, nthreads = blockDim.x;
  const int v0 = blockIdx.x * Vt, c0 = blockIdx.y * Ct;
  const int nv = min(Vt, V - v0), ct = min(Ct, C - c0);
  // staged output [v][i][j][ch][c] first (16-byte aligned), then the
  // reductions [v][slot][c] and the tables
  float* stage = reinterpret_cast<float*>(k3_smem);
  float* red = stage + Vt * kChannels * KK * Ct;
  int* chi_s = reinterpret_cast<int*>(red + Vt * NS * Ct);  // -1: out of range
  int* nbr_s = chi_s + Vt * KK;                              // -1: out of range
  float* mask_s = reinterpret_cast<float*>(nbr_s + Vt * K);
  float* deg_s = mask_s + Vt * K;
  const FastDiv div_c(ct);

  for (unsigned t = tid; t < (unsigned)(nv * KK); t += nthreads) {
    const int p = chi[(long long)v0 * KK + t];
    chi_s[t] = in_range(p, K) ? p : -1;
  }
  for (unsigned t = tid; t < (unsigned)(nv * K); t += nthreads) {
    const int u = nbr[(long long)v0 * K + t];
    nbr_s[t] = in_range(u, V) ? u : -1;
    mask_s[t] = row_mask[(long long)v0 * K + t];
  }
  for (unsigned t = tid; t < (unsigned)nv; t += nthreads) deg_s[t] = deg[v0 + t];
  __syncthreads();

  // A: one item per (v, a, c): the 4K reductions of row a. All K^2
  // loads of f are independent, so the loops unroll and they overlap.
  for (unsigned t = tid; t < (unsigned)(nv * K * ct); t += nthreads) {
    const unsigned vc = div_c.div(t);
    const int c = t - vc * ct, a = vc % K, v = vc / K;
    const int* chi_v = chi_s + v * KK;
    float* red_v = red + v * NS * ct + c;  // slot s at red_v[s * ct]
    float sk[K];
#pragma unroll
    for (int b = 0; b < K; ++b) sk[b] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = nbr_s[v * K + k];
      const int ia = u >= 0 ? chi_v[k * K + a] : -1;
      const float* f_row =
          f + (((long long)max(u, 0) * K + max(ia, 0)) * K) * C + c0 + c;
      float rsum = 0.f, dg = 0.f, ck = 0.f;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const int ib = chi_v[k * K + b];
        const float val = ia >= 0 && ib >= 0 ? __ldg(f_row + ib * C) : 0.f;
        sk[b] += val;
        rsum += val;
        if (b == a) dg = val;
        if (b == k) ck = val;
      }
      red_v[(P + k * K + a) * ct] = rsum;
      red_v[(2 * P + k * K + a) * ct] = dg;
      red_v[(3 * P + k * K + a) * ct] = ck;
    }
#pragma unroll
    for (int b = 0; b < K; ++b) red_v[(b * K + a) * ct] = sk[b];
  }
  __syncthreads();

  // B: one item per (v, i, c), i < K: the K-vectors at i; i == K: the
  // scalars (the same sums as contract_18 takes, in its grouping)
  for (unsigned t = tid; t < (unsigned)(nv * (K + 1) * ct); t += nthreads) {
    const unsigned vc = div_c.div(t);
    const int c = t - vc * ct, i = vc % (K + 1), v = vc / (K + 1);
    float* red_v = red + v * NS * ct + c;
    auto at = [&](int slot) { return red_v[slot * ct]; };
    if (i < K) {
      float s_ab = 0.f, s_kb = 0.f, s_tr = 0.f, s_11 = 0.f;
#pragma unroll
      for (int x = 0; x < K; ++x) {
        s_ab += at(P + i * K + x);      // sum_a rb[k=i][a]
        s_kb += at(P + x * K + i);      // sum_k rb[k][a=i]
        s_tr += at(2 * P + i * K + x);  // sum_a diag[k=i][a]
        s_11 += at(3 * P + x * K + i);  // sum_k colk[k][a=i]
      }
      red_v[(Q + i) * ct] = s_ab;
      red_v[(Q + K + i) * ct] = s_kb;
      red_v[(Q + 2 * K + i) * ct] = s_tr;
      red_v[(Q + 3 * K + i) * ct] = s_11;
    } else {
      float tot = 0.f, sum_kkb = 0.f, tr_sum = 0.f, t_xxx = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float s_ab = 0.f, s_tr = 0.f;
#pragma unroll
        for (int x = 0; x < K; ++x) {
          s_ab += at(P + k * K + x);
          s_tr += at(2 * P + k * K + x);
        }
        tot += s_ab;
        tr_sum += s_tr;
        sum_kkb += at(P + k * K + k);
        t_xxx += at(2 * P + k * K + k);
      }
      red_v[Z * ct] = tot;
      red_v[(Z + 1) * ct] = sum_kkb;
      red_v[(Z + 2) * ct] = tr_sum;
      red_v[(Z + 3) * ct] = t_xxx;
    }
  }
  __syncthreads();

  // C1: one item per (v, i, j, c): the 18 channels exactly as
  // contract_18 forms them (deg and row_mask broadcasts, diag_embed =
  // delta_ij * val * m[i]), staged in the output's own layout
  for (unsigned t = tid; t < (unsigned)(nv * KK * ct); t += nthreads) {
    const unsigned vij = div_c.div(t);
    const int c = t - vij * ct, v = vij / KK, i = (vij % KK) / K, j = vij % K;
    const float* red_v = red + v * NS * ct + c;
    auto at = [&](int slot) { return red_v[slot * ct]; };
    const float n = deg_s[v], mj = mask_s[v * K + j];
    const float eye_m = i == j ? mj : 0.f;
    const float rb = at(P + i * K + j), sk = at(j * K + i);
    const float c1 = n * rb;
    float* o = stage + vij * kChannels * ct + c;  // channel ch at o[ch * ct]
    o[0] = c1;
    o[ct] = at(Q + i) * mj;              // sab
    o[2 * ct] = n * sk;
    o[3 * ct] = at(Q + K + i) * mj;      // skb
    o[4 * ct] = at(Z) * eye_m;           // tot
    o[5 * ct] = rb;                      // c6
    if (compat) {
#pragma unroll
      for (int ch = 6; ch < 15; ++ch) o[ch * ct] = c1;
    } else {
      o[6 * ct] = c1;
      o[7 * ct] = at(Q + 2 * K + i) * mj;  // tr_ab
      o[8 * ct] = rb;
      o[9 * ct] = sk;
      o[10 * ct] = at(Q + 3 * K + i) * mj;  // c11
      o[11 * ct] = at(P + j * K + i);       // rb[j][i]
      o[12 * ct] = sk;
      o[13 * ct] = at(Z + 1) * eye_m;       // sum_kkb
      o[14 * ct] = at(Z + 2) * eye_m;       // tr_sum
    }
    o[15 * ct] = at(2 * P + i * K + j);     // diag[i][j] = T_i[j, j]
    o[16 * ct] = at(3 * P + j * K + i);     // colk[j][i] = T_j[i, j]
    o[17 * ct] = at(Z + 3) * eye_m;         // t_xxx
  }
  __syncthreads();

  // C2: the staged tile to the output. With ct == C it is one contiguous
  // run: 16-byte copies, consecutive lanes on consecutive addresses.
  const unsigned n_out = nv * KK * kChannels * ct;
  float* tile = out + (long long)v0 * KK * kChannels * C;
  unsigned first_scalar = 0;
  if (ct == C && (reinterpret_cast<unsigned long long>(tile) & 15u) == 0) {
    for (unsigned q = tid; q < n_out / 4; q += nthreads)
      __stcs(reinterpret_cast<float4*>(tile) + q, k3_smem[q]);
    first_scalar = n_out / 4 * 4;
  }
  for (unsigned e = first_scalar + tid; e < n_out; e += nthreads) {
    const unsigned row = div_c.div(e), c = e - row * ct;  // row: (v, i, j, ch)
    __stcs(tile + (long long)row * C + c0 + c, stage[e]);
  }
}

template <int K>
__global__ void __launch_bounds__(kK12MaxThreads)
ccn1d_backward(const int* __restrict__ chi, const int* __restrict__ rslot,
               const int* __restrict__ nbr, const float* __restrict__ g,
               float* __restrict__ df, int V, int C, int Vt, int Ct) {
  extern __shared__ float k12_smem[];  // slot j's share of df[u][p][c]: [u][j][p][c]
  const int t = threadIdx.x;
  const int c = t % Ct, uj = t / Ct;  // thread (u, j, c), uj = u * K + j
  const int u0 = blockIdx.x * Vt, gc = blockIdx.y * Ct + c;
  const long long guj = (long long)u0 * K + uj;
  const bool active = u0 + uj / K < V && gc < C;
  float* sj = k12_smem + uj * K * Ct + c;  // slot j's share at sj[p * Ct]
  if (active) {
    const int n = __ldg(nbr + guj), r = __ldg(rslot + guj);
    int a[K];
#pragma unroll
    for (int p = 0; p < K; ++p) a[p] = __ldg(chi + guj * K + p);
    const bool ok = in_range(n, V) && in_range(r, K);
    const long long C2 = 2 * (long long)C;
    const float* g_n = g + (long long)(ok ? n : 0) * K * C2 + gc;  // [a][row C | col C]
    const float col = ok ? __ldg(g_n + r * C2 + C) : 0.f;
#pragma unroll
    for (int p = 0; p < K; ++p)
      sj[p * Ct] = ok && in_range(a[p], K) ? __ldg(g_n + a[p] * C2) + col : 0.f;
  }
  __syncthreads();
  if (!active) return;
  // df[u][p = j][c] = sum over the slots y of their shares at p
  const int u = uj / K, j = uj % K;
  const float* sy = k12_smem + (u * K * K + j) * Ct + c;
  float s = 0.f;
#pragma unroll
  for (int y = 0; y < K; ++y) s += sy[y * K * Ct];
  df[guj * C + gc] = s;
}

// ---- K4 ----

// Threads of a K4 block: Vt * K * Ct of them, at most this many
// (ops/ccn_fused.py:_k4_tile chooses the tile).
constexpr int kK4MaxThreads = 128;

// The adjoint of contract_18 at neighbour n and its slot r of the
// receiving vertex, formed from n's g: the four parts of
// contract_18_transpose_parts at [r][a] (d_rb, d_diag, d_kakT) and [a][b]
// (d_sk), with the same f32 operations in the same order (the masked sums
// over y from y = 0, every product and add rounded on its own: no fused
// multiply-add), so they equal the plain version's bit for bit.
template <int K>
struct NbrParts {
  const float* g;  // g[n][x][y][ch * C + c] at g[((x * K + y) * 18 + ch) * C]
  const float* m;  // row_mask[n]
  int C, compat, r;
  // deg[n]; the masked row sums of blocks 1 and 7 at row r; the masked
  // diagonal sums of blocks 4, 13, 14 and 17
  float dn, s1r, s7r, d4, d13, d14, d17;

  // the channel block's offset ch * C apart from the row's, so the
  // unrolled loops share each row's address (about 10 % faster on the H100
  // than one offset ((x * K + y) * 18 + ch) * C a load)
  __device__ float at(int x, int y, int ch) const {
    return __ldg(g + (long long)(x * K + y) * kChannels * C + (long long)ch * C);
  }
  __device__ float row_sum(int x, int ch) const {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < K; ++y) s = __fadd_rn(s, __fmul_rn(at(x, y, ch), __ldg(m + y)));
    return s;
  }
  __device__ float diag_sum(int ch) const {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < K; ++y) s = __fadd_rn(s, __fmul_rn(at(y, y, ch), __ldg(m + y)));
    return s;
  }
  __device__ NbrParts(const float* g_n, const float* m_n, float deg_n, int C_,
                      int compat_, int r_)
      : g(g_n), m(m_n), C(C_), compat(compat_), r(r_), dn(deg_n) {
    s1r = row_sum(r, 1);
    d4 = diag_sum(4);
    d17 = diag_sum(17);
    s7r = d13 = d14 = 0.f;
    if (!compat) {
      s7r = row_sum(r, 7);
      d13 = diag_sum(13);
      d14 = diag_sum(14);
    }
  }
  // d_rb, d_diag and d_kakT at [r][a]
  __device__ void row(int a, float& rb, float& dg, float& kk) const {
    const float s3a = row_sum(a, 3);
    if (compat) {  // the middle channels were [c6] + [c1] x 9
      float c1 = 0.f;
#pragma unroll
      for (int ch = 6; ch < 15; ++ch) c1 = __fadd_rn(c1, at(r, a, ch));
      c1 = __fadd_rn(at(r, a, 0), c1);
      rb = __fadd_rn(__fmul_rn(dn, c1), at(r, a, 5));
      rb = __fadd_rn(__fadd_rn(__fadd_rn(rb, s1r), s3a), d4);
      dg = at(r, a, 15);
      kk = at(a, r, 16);
    } else {
      const float c1 = __fadd_rn(at(r, a, 0), at(r, a, 6));
      const float c6 = __fadd_rn(at(r, a, 5), at(r, a, 8));
      rb = __fadd_rn(__fmul_rn(dn, c1), c6);
      rb = __fadd_rn(__fadd_rn(__fadd_rn(rb, s1r), s3a), at(a, r, 11));
      if (r == a) rb = __fadd_rn(rb, d13);
      rb = __fadd_rn(rb, d4);
      dg = __fadd_rn(__fadd_rn(at(r, a, 15), s7r), d14);
      kk = __fadd_rn(at(a, r, 16), row_sum(a, 10));
    }
    if (r == a) dg = __fadd_rn(dg, d17);
  }
  // d_sk at [a][b]
  __device__ float sk(int a, int b) const {
    float v = __fmul_rn(dn, at(a, b, 2));
    if (!compat) v = __fadd_rn(__fadd_rn(v, at(a, b, 9)), at(a, b, 12));
    return v;
  }
};

// The bound is twice the block's 128 threads: under a 128-thread bound
// ptxas spilled at K = 7.
template <int K>
__global__ void __launch_bounds__(2 * kK4MaxThreads)
ccn2d_backward(const int* __restrict__ chi, const int* __restrict__ rslot,
               const int* __restrict__ nbr, const float* __restrict__ g,
               const float* __restrict__ deg, const float* __restrict__ row_mask,
               float* __restrict__ df, int V, int C, int Vt, int Ct, int compat) {
  constexpr int KK = K * K;
  extern __shared__ float k4_smem[];  // slot j's share of df[u][p][q][c]: [u][j][p][q][c]
  const int t = threadIdx.x;
  const int c = t % Ct, uj = t / Ct;  // thread (u, j, c), uj = u * K + j
  const int u0 = blockIdx.x * Vt, gc = blockIdx.y * Ct + c;
  const long long guj = (long long)u0 * K + uj;
  const bool active = u0 + uj / K < V && gc < C;
  float* sj = k4_smem + uj * KK * Ct + c;  // slot j's share at sj[(p * K + q) * Ct]
  if (active) {
    const int n = __ldg(nbr + guj), r = __ldg(rslot + guj);
    int a[K];
#pragma unroll
    for (int p = 0; p < K; ++p) a[p] = __ldg(chi + guj * K + p);
    if (in_range(n, V) && in_range(r, K)) {
      const NbrParts<K> nb(g + (long long)n * KK * kChannels * C + gc,
                           row_mask + (long long)n * K, __ldg(deg + n), C, compat, r);
      // gbar[n, r, a_p, a_q] = d_sk[a_p][a_q] + d_rb[r][a_p]
      //   + [a_p == a_q] d_diag[r][a_p] + [a_q == r] d_kakT[r][a_p]
#pragma unroll
      for (int p = 0; p < K; ++p) {
        const bool pv = in_range(a[p], K);
        float rb = 0.f, dg = 0.f, kk = 0.f;
        if (pv) nb.row(a[p], rb, dg, kk);
#pragma unroll
        for (int q = 0; q < K; ++q) {
          float val = 0.f;
          if (pv && in_range(a[q], K)) {
            val = __fadd_rn(nb.sk(a[p], a[q]), rb);
            if (a[q] == a[p]) val = __fadd_rn(val, dg);
            if (a[q] == r) val = __fadd_rn(val, kk);
          }
          sj[(p * K + q) * Ct] = val;
        }
      }
    } else {  // a padding slot reads no g
#pragma unroll
      for (int pq = 0; pq < KK; ++pq) sj[pq * Ct] = 0.f;
    }
  }
  __syncthreads();
  if (!active) return;
  // df[u][p][q][c] = sum over the slots y, in order, of their shares; the
  // thread of slot j takes the K pairs (p, q) = j, j + K, ...
  const int u = uj / K, j = uj % K;
  const float* su = k4_smem + u * K * KK * Ct + c;  // slot y's at su[y * KK * Ct]
  for (int pq = j; pq < KK; pq += K) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < K; ++y) s = __fadd_rn(s, su[(y * KK + pq) * Ct]);
    df[((long long)(u0 + u) * KK + pq) * C + gc] = s;
  }
}

__global__ void noop() {}

// The grid and block of a K1 or K2 launch of tile Vt x Ct; its dynamic
// shared memory holds T (or the slots' shares) of the tile, Vt K K Ct
// floats, at most 8 KB.
int k12_config(int V, int C, int K, int Vt, int Ct, int smem, dim3* grid,
               unsigned* block) {
  const long long threads = (long long)Vt * K * Ct;
  if (Vt < 1 || Ct < 1 || Ct > C || threads > kK12MaxThreads ||
      smem < 4 * threads * K)
    return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)((V + Vt - 1) / Vt), (unsigned)((C + Ct - 1) / Ct));
  *block = (unsigned)threads;
  return 0;
}

template <int K>
int k1_launch(const int* ci, const int* ni, const float* fi, float* o, int V,
              int C, int Vt, int Ct, int smem, cudaStream_t s) {
  dim3 grid;
  unsigned block;
  const int err = k12_config(V, C, K, Vt, Ct, smem, &grid, &block);
  if (err) return err;
  ccn1d_forward<K><<<grid, block, smem, s>>>(ci, ni, fi, o, V, C, Vt, Ct);
  return (int)cudaGetLastError();
}

template <int K>
int k2_launch(const int* ci, const int* ri, const int* ni, const float* gi,
              float* o, int V, int C, int Vt, int Ct, int smem, cudaStream_t s) {
  dim3 grid;
  unsigned block;
  const int err = k12_config(V, C, K, Vt, Ct, smem, &grid, &block);
  if (err) return err;
  ccn1d_backward<K><<<grid, block, smem, s>>>(ci, ri, ni, gi, o, V, C, Vt, Ct);
  return (int)cudaGetLastError();
}

}  // namespace

// A kernel that does nothing, on a grid of the given size: what a launch
// costs without work (timed by chip_smoke.py, never by the port).
extern "C" int hgnn2_noop(int blocks, int threads, void* stream) {
  noop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Vt vertices and Ct channels a block, smem bytes of dynamic shared
// memory (ops/ccn_fused.py:_k12_tile chooses them).
extern "C" int hgnn2_ccn1d_forward(const void* chi, const void* nbr,
                                   const void* f, void* out, int V, int K,
                                   int C, int Vt, int Ct, int smem,
                                   void* stream) {
  if ((long long)V * C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ni = static_cast<const int*>(nbr);
  const float* fi = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  switch (K) {
#define CASE(KK) \
  case KK: return k1_launch<KK>(ci, ni, fi, o, V, C, Vt, Ct, smem, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Vt vertices and Ct channels a block, smem bytes of dynamic shared
// memory (ops/ccn_fused.py:_k3_tile chooses them).
extern "C" int hgnn2_ccn2d_forward(const void* chi, const void* nbr,
                                   const void* f, const void* deg,
                                   const void* row_mask, void* out, int V,
                                   int K, int C, int compat, int Vt, int Ct,
                                   int smem, void* stream) {
  if ((long long)V * C == 0) return 0;
  if (Vt < 1 || Ct < 1 || Ct > C) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((V + Vt - 1) / Vt), (unsigned)((C + Ct - 1) / Ct));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ni = static_cast<const int*>(nbr);
  const float* fi = static_cast<const float*>(f);
  const float* di = static_cast<const float*>(deg);
  const float* mi = static_cast<const float*>(row_mask);
  float* o = static_cast<float*>(out);
  switch (K) {
#define CASE(KK)                                                           \
  case KK: {                                                               \
    /* the block's indices stay below 2^16 (FastDiv's range) */            \
    if (smem < 4 * Vt * K3Slots<KK>::words(Ct) ||                          \
        (long long)Vt * KK * KK * kChannels * Ct >= 65536)                 \
      return (int)cudaErrorInvalidValue;                                   \
    if (smem > 48 * 1024) {                                                \
      const cudaError_t err = cudaFuncSetAttribute(                        \
          ccn2d_forward<KK>, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
          smem);                                                           \
      if (err != cudaSuccess) return (int)err;                             \
    }                                                                      \
    ccn2d_forward<KK><<<grid, kK3Threads, smem, s>>>(ci, ni, fi, di, mi, o, \
                                                     V, C, Vt, Ct, compat); \
    break;                                                                 \
  }
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Vt vertices and Ct channels a block, smem bytes of dynamic shared
// memory (ops/ccn_fused.py:_k12_tile chooses them).
extern "C" int hgnn2_ccn1d_backward(const void* chi, const void* rslot,
                                    const void* nbr, const void* g, void* df,
                                    int V, int K, int C, int Vt, int Ct,
                                    int smem, void* stream) {
  if ((long long)V * C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ri = static_cast<const int*>(rslot);
  const int* ni = static_cast<const int*>(nbr);
  const float* gi = static_cast<const float*>(g);
  float* o = static_cast<float*>(df);
  switch (K) {
#define CASE(KK) \
  case KK: return k2_launch<KK>(ci, ri, ni, gi, o, V, C, Vt, Ct, smem, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Vt vertices and Ct channels a block, smem bytes of dynamic shared
// memory (ops/ccn_fused.py:_k4_tile chooses them).
extern "C" int hgnn2_ccn2d_backward(const void* chi, const void* rslot,
                                    const void* nbr, const void* g,
                                    const void* deg, const void* row_mask,
                                    void* df, int V, int K, int C, int compat,
                                    int Vt, int Ct, int smem, void* stream) {
  if ((long long)V * C == 0) return 0;
  const long long threads = (long long)Vt * K * Ct;
  if (Vt < 1 || Ct < 1 || Ct > C || threads > kK4MaxThreads ||
      smem < 4 * threads * K * K)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((V + Vt - 1) / Vt), (unsigned)((C + Ct - 1) / Ct));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ri = static_cast<const int*>(rslot);
  const int* ni = static_cast<const int*>(nbr);
  const float* gi = static_cast<const float*>(g);
  const float* di = static_cast<const float*>(deg);
  const float* mi = static_cast<const float*>(row_mask);
  float* o = static_cast<float*>(df);
  switch (K) {
#define CASE(KK)                                                          \
  case KK:                                                                \
    ccn2d_backward<KK><<<grid, (unsigned)threads, smem, s>>>(             \
        ci, ri, ni, gi, di, mi, o, V, C, Vt, Ct, compat);                 \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
