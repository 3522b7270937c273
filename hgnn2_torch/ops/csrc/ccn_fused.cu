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
//     df[u, p, q, c] = sum_j gbar[n, r, chi[u,j,p], chi[u,j,q], c], with
//     n = nbr[u,j], r = rslot[u,j] and gbar[n,k,a,b] = d_sk[n,a,b]
//     + d_rb[n,k,a] + [a == b] d_diag[n,k,a] + [b == k] d_kakT[n,k,a]
//     read from the four parts of contract_18_transpose_parts.
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
//   K4 reads the four parts (4 V K^2 C floats) and the tables and writes
//   df: about 19 MB at C = 2 and 43 MB at C = 5, i.e. 6 us and 13 us.
//   All four do O(K^2 C) to O(K^3 C) adds per vertex: bytes bound them.
//   The backward kernels' gathers hit the same rows as the forward's
//   (graphs are contiguous in the vertex axis), so they read mostly L2.
//
// Design: every vertex is independent, so one thread owns one (vertex,
// channel) pair, t = v*C + c, and there is no cross-thread reduction.
// Neighbouring threads read neighbouring channels of the same gathered
// row of f and write neighbouring channels of the same output row. The
// neighbour rows are read straight from f by index (graphs are small and
// contiguous in the vertex axis, so the reads mostly hit L2); no halo
// window and no graph-size limit. An index of -1 contributes an exact 0
// and f is never read at it. K is a template parameter (1..8) so every
// loop over K unrolls and the per-vertex partial sums live in registers.
// K3 keeps four K x K accumulators (sk, rb, diag, colk): 100 floats at
// K = 5, 256 at K = 8, where they spill to local memory. That is accepted
// in this first version; the output write still dominates. K2 keeps K
// and K4 K x K accumulators (25 floats at K = 5, 64 at K = 8); both loop
// over the K slots j of u, load n, r and u's chi row once per slot, and
// skip a slot whose n or r is out of range, so a padding slot costs no
// read of g. In K4 the d_rb term does not depend on q, so an invalid q is
// gated explicitly like an invalid p (the Pallas kernel's qv).
//
// The entry points have a plain C interface (loaded with ctypes). They
// launch on the given stream, allocate nothing, and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The tables from make_ccn_batch hold -1 or an index in range. Any other
// index also contributes 0, so a malformed table never reads outside f.
__device__ __forceinline__ bool in_range(int i, int n) {
  return (unsigned)i < (unsigned)n;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
ccn1d_forward(const int* __restrict__ chi, const int* __restrict__ nbr,
              const float* __restrict__ f, float* __restrict__ out,
              int V, int C) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * C) return;
  const int v = (int)(t / C);
  const int c = (int)(t % C);
  const int* chi_v = chi + (long long)v * K * K;
  const int* nbr_v = nbr + (long long)v * K;
  float* out_v = out + (long long)v * K * 2 * C + c;

  float row[K];
#pragma unroll
  for (int a = 0; a < K; ++a) row[a] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = nbr_v[k];
    const bool u_ok = in_range(u, V);
    const float* f_n = f + (long long)(u_ok ? u : 0) * K * C + c;
    float col = 0.f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const int p = chi_v[k * K + a];
      const float val = u_ok && in_range(p, K) ? f_n[p * C] : 0.f;
      row[a] += val;
      col += val;
    }
    out_v[k * 2 * C + C] = col;
  }
#pragma unroll
  for (int a = 0; a < K; ++a) out_v[a * 2 * C] = row[a];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
ccn2d_forward(const int* __restrict__ chi, const int* __restrict__ nbr,
              const float* __restrict__ f, const float* __restrict__ deg,
              const float* __restrict__ row_mask, float* __restrict__ out,
              int V, int C, int compat) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * C) return;
  const int v = (int)(t / C);
  const int c = (int)(t % C);
  const int* chi_v = chi + (long long)v * K * K;
  const int* nbr_v = nbr + (long long)v * K;

  float sk[K][K];    // sum_k T_k[a, b]
  float rb[K][K];    // [k][a]: sum_b T_k[a, b]
  float diag[K][K];  // [k][a]: T_k[a, a]
  float colk[K][K];  // [k][a]: T_k[a, k]
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int b = 0; b < K; ++b) sk[a][b] = 0.f;

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = nbr_v[k];
    const bool u_ok = in_range(u, V);
    const float* f_n = f + (long long)(u_ok ? u : 0) * K * K * C + c;
    int ia[K];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const int p = chi_v[k * K + a];
      ia[a] = u_ok && in_range(p, K) ? p : -1;
    }
#pragma unroll
    for (int a = 0; a < K; ++a) {
      float rsum = 0.f;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const float val = (ia[a] >= 0 && ia[b] >= 0)
                              ? f_n[(ia[a] * K + ia[b]) * C] : 0.f;
        sk[a][b] += val;
        rsum += val;
        if (b == a) diag[k][a] = val;
        if (b == k) colk[k][a] = val;
      }
      rb[k][a] = rsum;
    }
  }

  // Epilogue: the reductions every channel reads, then the 18 channels
  // exactly as contract_18 forms them (deg and row_mask broadcasts,
  // diag_embed = delta_ij * val * m[i]).
  const float n = deg[v];
  float m[K], sab[K], skb[K], tr_ab[K], c11[K];
#pragma unroll
  for (int y = 0; y < K; ++y) m[y] = row_mask[(long long)v * K + y];
  float tot = 0.f, sum_kkb = 0.f, t_xxx = 0.f, tr_sum = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s_ab = 0.f, s_kb = 0.f, s_tr = 0.f, s_11 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s_ab += rb[i][j];    // sum_a rb[k=i][a]
      s_kb += rb[j][i];    // sum_k rb[k][a=i]
      s_tr += diag[i][j];  // sum_a diag[k=i][a]
      s_11 += colk[j][i];  // sum_k colk[k][a=i]
    }
    sab[i] = s_ab;
    skb[i] = s_kb;
    tr_ab[i] = s_tr;
    c11[i] = s_11;
    tot += s_ab;
    tr_sum += s_tr;
    sum_kkb += rb[i][i];
    t_xxx += diag[i][i];
  }

  const int C18 = 18 * C;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float* o = out + (((long long)v * K + i) * K + j) * C18 + c;
      const float eye_m = i == j ? m[i] : 0.f;
      const float c1 = n * rb[i][j];
      const float c6 = rb[i][j];
      o[0 * C] = c1;
      o[1 * C] = sab[i] * m[j];
      o[2 * C] = n * sk[i][j];
      o[3 * C] = skb[i] * m[j];
      o[4 * C] = tot * eye_m;
      o[5 * C] = c6;
      if (compat) {
#pragma unroll
        for (int ch = 6; ch < 15; ++ch) o[ch * C] = c1;
      } else {
        o[6 * C] = c1;
        o[7 * C] = tr_ab[i] * m[j];
        o[8 * C] = c6;
        o[9 * C] = sk[i][j];
        o[10 * C] = c11[i] * m[j];
        o[11 * C] = rb[j][i];
        o[12 * C] = sk[i][j];
        o[13 * C] = sum_kkb * eye_m;
        o[14 * C] = tr_sum * eye_m;
      }
      o[15 * C] = diag[i][j];
      o[16 * C] = colk[j][i];
      o[17 * C] = t_xxx * eye_m;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
ccn1d_backward(const int* __restrict__ chi, const int* __restrict__ rslot,
               const int* __restrict__ nbr, const float* __restrict__ g,
               float* __restrict__ df, int V, int C) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * C) return;
  const int u = (int)(t / C);
  const int c = (int)(t % C);
  const int* chi_u = chi + (long long)u * K * K;
  const int* rslot_u = rslot + (long long)u * K;
  const int* nbr_u = nbr + (long long)u * K;
  const int C2 = 2 * C;

  float acc[K];
#pragma unroll
  for (int p = 0; p < K; ++p) acc[p] = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = nbr_u[j];
    const int r = rslot_u[j];
    if (!in_range(n, V) || !in_range(r, K)) continue;
    const float* g_n = g + (long long)n * K * C2 + c;  // [a][row C | col C]
    const float col = g_n[r * C2 + C];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const int a = chi_u[j * K + p];
      if (in_range(a, K)) acc[p] += g_n[a * C2] + col;
    }
  }
  float* df_u = df + (long long)u * K * C + c;
#pragma unroll
  for (int p = 0; p < K; ++p) df_u[p * C] = acc[p];
}

template <int K>
__global__ void __launch_bounds__(kThreads)
ccn2d_backward(const int* __restrict__ chi, const int* __restrict__ rslot,
               const int* __restrict__ nbr, const float* __restrict__ d_sk,
               const float* __restrict__ d_rb,
               const float* __restrict__ d_diag,
               const float* __restrict__ d_kakT, float* __restrict__ df,
               int V, int C) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * C) return;
  const int u = (int)(t / C);
  const int c = (int)(t % C);
  const int* chi_u = chi + (long long)u * K * K;
  const int* rslot_u = rslot + (long long)u * K;
  const int* nbr_u = nbr + (long long)u * K;
  const int KC = K * C;

  float acc[K][K];
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int q = 0; q < K; ++q) acc[p][q] = 0.f;

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = nbr_u[j];
    const int r = rslot_u[j];
    if (!in_range(n, V) || !in_range(r, K)) continue;
    const long long base = (long long)n * K * KC + c;
    const float* sk_n = d_sk + base;           // [a][b]
    const float* rb_nr = d_rb + base + r * KC;  // [a], row k = r
    const float* dg_nr = d_diag + base + r * KC;
    const float* kk_nr = d_kakT + base + r * KC;
    int ia[K];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const int a = chi_u[j * K + p];
      ia[p] = in_range(a, K) ? a : -1;
    }
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (ia[p] < 0) continue;
      const float rb = rb_nr[ia[p] * C];
      const float dg = dg_nr[ia[p] * C];
      const float kk = kk_nr[ia[p] * C];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (ia[q] < 0) continue;
        float val = sk_n[(ia[p] * K + ia[q]) * C] + rb;
        if (ia[p] == ia[q]) val += dg;
        if (ia[q] == r) val += kk;
        acc[p][q] += val;
      }
    }
  }
  float* df_u = df + (long long)u * K * KC + c;
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int q = 0; q < K; ++q) df_u[(p * K + q) * C] = acc[p][q];
}

inline unsigned blocks_for(int V, int C) {
  return (unsigned)(((long long)V * C + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int hgnn2_ccn1d_forward(const void* chi, const void* nbr,
                                   const void* f, void* out, int V, int K,
                                   int C, void* stream) {
  if ((long long)V * C == 0) return 0;
  const dim3 grid(blocks_for(V, C)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ni = static_cast<const int*>(nbr);
  const float* fi = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  switch (K) {
#define CASE(KK) \
  case KK: ccn1d_forward<KK><<<grid, block, 0, s>>>(ci, ni, fi, o, V, C); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hgnn2_ccn2d_forward(const void* chi, const void* nbr,
                                   const void* f, const void* deg,
                                   const void* row_mask, void* out, int V,
                                   int K, int C, int compat, void* stream) {
  if ((long long)V * C == 0) return 0;
  const dim3 grid(blocks_for(V, C)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ni = static_cast<const int*>(nbr);
  const float* fi = static_cast<const float*>(f);
  const float* di = static_cast<const float*>(deg);
  const float* mi = static_cast<const float*>(row_mask);
  float* o = static_cast<float*>(out);
  switch (K) {
#define CASE(KK)                                                        \
  case KK:                                                              \
    ccn2d_forward<KK><<<grid, block, 0, s>>>(ci, ni, fi, di, mi, o, V, \
                                             C, compat);                \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hgnn2_ccn1d_backward(const void* chi, const void* rslot,
                                    const void* nbr, const void* g, void* df,
                                    int V, int K, int C, void* stream) {
  if ((long long)V * C == 0) return 0;
  const dim3 grid(blocks_for(V, C)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ri = static_cast<const int*>(rslot);
  const int* ni = static_cast<const int*>(nbr);
  const float* gi = static_cast<const float*>(g);
  float* o = static_cast<float*>(df);
  switch (K) {
#define CASE(KK)                                                       \
  case KK:                                                             \
    ccn1d_backward<KK><<<grid, block, 0, s>>>(ci, ri, ni, gi, o, V, C); \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hgnn2_ccn2d_backward(const void* chi, const void* rslot,
                                    const void* nbr, const void* d_sk,
                                    const void* d_rb, const void* d_diag,
                                    const void* d_kakT, void* df, int V,
                                    int K, int C, void* stream) {
  if ((long long)V * C == 0) return 0;
  const dim3 grid(blocks_for(V, C)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(chi);
  const int* ri = static_cast<const int*>(rslot);
  const int* ni = static_cast<const int*>(nbr);
  const float* sk = static_cast<const float*>(d_sk);
  const float* rb = static_cast<const float*>(d_rb);
  const float* dg = static_cast<const float*>(d_diag);
  const float* kk = static_cast<const float*>(d_kakT);
  float* o = static_cast<float*>(df);
  switch (K) {
#define CASE(KK)                                                        \
  case KK:                                                              \
    ccn2d_backward<KK><<<grid, block, 0, s>>>(ci, ri, ni, sk, rb, dg, kk, \
                                              o, V, C);                 \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
