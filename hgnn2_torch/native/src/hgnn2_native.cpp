// Native host-side preprocessing for hgnn2_torch (the same source as
// hgnn2_tpu/native/src/hgnn2_native.cpp).
//
// The card executes the model math; this library covers the host-side
// data-preparation hot spots that are per-sample Python loops otherwise
// (the CCN chi tables, O(N^2 d^2) in Python; the line graph's O(N^2) edge
// scan):
//
//   * build_line_graph:  adjacency -> directed edge list (src, dst, w, rev)
//     with interleaved forward/reverse pairs (intended semantics, see
//     hgnn2_torch/operators.py).
//   * build_chi_tables:  CSR neighbor lists -> the (V, K, K) int32 chi
//     index table (chi rows are partial permutations; -1 = no match) +
//     neighbor/degree/row-mask arrays consumed by CCNBatch.
//   * parse_xyz_atoms:   bulk float parsing of dsgdb9nsd atom blocks
//     (handles the '*^' exponent notation).
//
// Exposed as a plain C ABI for ctypes; hgnn2_torch.native falls back to the
// numpy implementations when the shared library cannot be built.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>

extern "C" {

// Scan the strict upper triangle of A (n x n, row-major) and emit directed
// edges in interleaved (forward, reverse) order. Returns M = 2E. Arrays
// src/dst/rev must hold at least capacity entries; returns -1 if exceeded.
int64_t build_line_graph(const float* A, int64_t n, int64_t capacity,
                         int32_t* src, int32_t* dst, float* w, int32_t* rev) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = A + i * n;
    for (int64_t j = i + 1; j < n; ++j) {
      float a = row[j];
      if (a != 0.0f) {
        if (m + 2 > capacity) return -1;
        src[m] = (int32_t)i; dst[m] = (int32_t)j; w[m] = a; rev[m] = (int32_t)(m + 1);
        src[m + 1] = (int32_t)j; dst[m + 1] = (int32_t)i; w[m + 1] = a;
        rev[m + 1] = (int32_t)m;
        m += 2;
      }
    }
  }
  return m;
}

// Build the CCN chi index tables for one graph whose neighbor lists are
// given in CSR form (offsets length n+1, lists sorted ascending). chi rows
// are partial permutations (neighbor lists are duplicate-free), so the
// dense one-hot is never built. Writes into the GLOBAL output arrays at
// vertex offset v0 (flattened (V, K, ...) layout):
//   chi_idx (V, K, K)  int32: chi_idx[v,k,a] = b iff
//                      list_v[a] == list_{list_v[k]}[b], else left as-is
//                      (caller pre-fills with -1)
//   rslot   (V, K)     int32: slot of i in list_{list_v[k]}, else left
//                      as-is (caller pre-fills with -1); drives the
//                      gather-form promotion VJP
//   nbr     (V, K)     global vertex ids (list + v0), padding left as-is
//   deg     (V,)       list lengths
//   rmask   (V, K)     1.0 where slot < deg
// Returns 0 on success, -1 if any degree exceeds K.
int32_t build_chi_tables(const int32_t* offsets, const int32_t* lists,
                         int64_t n, int64_t K, int64_t v0,
                         int32_t* chi_idx, int32_t* rslot, int32_t* nbr,
                         float* deg, float* rmask) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t start = offsets[i], end = offsets[i + 1];
    int64_t d = end - start;
    if (d > K) return -1;
    int64_t v = v0 + i;
    deg[v] = (float)d;
    const int32_t* li = lists + start;
    for (int64_t k = 0; k < d; ++k) {
      nbr[v * K + k] = li[k] + (int32_t)v0;
      rmask[v * K + k] = 1.0f;
    }
    int32_t* ci_v = chi_idx + v * K * K;
    for (int64_t k = 0; k < d; ++k) {
      int32_t j = li[k];
      int64_t js = offsets[j], je = offsets[j + 1];
      const int32_t* lj = lists + js;
      int64_t dj = je - js;
      int32_t* ci_vk = ci_v + k * K;
      // merge-intersect two sorted lists: ci[a] = b iff li[a] == lj[b];
      // the slot of i itself in lj is rslot (i in lj iff the graph is
      // symmetric, which make_ccn_batch's A + I and symmetric A guarantee)
      int64_t a = 0, b = 0;
      while (a < d && b < dj) {
        if (li[a] == lj[b]) {
          ci_vk[a] = (int32_t)b;
          ++a; ++b;
        } else if (li[a] < lj[b]) {
          ++a;
        } else {
          ++b;
        }
      }
      for (int64_t lo = 0, hi = dj; lo < hi;) {
        int64_t mid = (lo + hi) / 2;
        if (lj[mid] < (int32_t)i) {
          lo = mid + 1;
        } else {
          if (lj[mid] == (int32_t)i) rslot[v * K + k] = (int32_t)mid;
          hi = mid;
        }
      }
    }
  }
  return 0;
}

// Parse na lines of a dsgdb9nsd atom block: "<symbol> x y z charge" with
// '*^' float exponents. text is the raw bytes of the block; writes coords
// (na,3), charges (na,), and the element symbol's first char + second char
// into symbols (na, 2). Returns number of atoms parsed or -1 on error.
static double parse_float_tok(const char* s, char** endp) {
  // handle 1.234*^-5 and .*^ notation by rewriting into a small buffer
  char buf[64];
  int64_t k = 0;
  const char* p = s;
  while (*p == ' ' || *p == '\t') ++p;
  while (*p && *p != ' ' && *p != '\t' && *p != '\n' && k < 62) {
    if (*p == '*' && *(p + 1) == '^') {
      buf[k++] = 'e';
      p += 2;
    } else if (*p == '.' && *(p + 1) == '*' && *(p + 2) == '^') {
      buf[k++] = 'e';
      p += 3;
    } else {
      buf[k++] = *p++;
    }
  }
  buf[k] = 0;
  *endp = (char*)p;
  return strtod(buf, nullptr);
}

int64_t parse_xyz_atoms(const char* text, int64_t na,
                        char* symbols, float* coords, float* charges) {
  const char* p = text;
  for (int64_t i = 0; i < na; ++i) {
    while (*p == ' ' || *p == '\t' || *p == '\n') ++p;
    if (!*p) return -1;
    symbols[i * 2] = *p;
    symbols[i * 2 + 1] = ' ';
    ++p;
    if (*p && *p != ' ' && *p != '\t') { symbols[i * 2 + 1] = *p; ++p; }
    char* end;
    for (int64_t c = 0; c < 3; ++c) {
      coords[i * 3 + c] = (float)parse_float_tok(p, &end);
      p = end;
    }
    charges[i] = (float)parse_float_tok(p, &end);
    p = end;
    while (*p && *p != '\n') ++p;
  }
  return na;
}

}  // extern "C"
