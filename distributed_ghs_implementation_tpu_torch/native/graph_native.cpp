// Native graph ingestion: RMAT generation, dedup, DIMACS parsing, CSR build,
// and the rank solver's host passes.
//
// The port's copy of the JAX package's native/graph_native.cpp; the code is
// the same but for this note and the JAX package's level-2 pass (each
// fragment's first cross rank), which the port runs on the card instead. The
// host-side graph construction and the rank solver's host passes run here at
// RMAT-24 scale, where NumPy is the bottleneck. Exposed through a C ABI for ctypes, with no pybind11 dependency.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC graph_native.cpp -o libgraph_native.so
// (distributed_ghs_implementation_tpu_torch/graphs/native.py compiles it at
// first use into build/native/ and raises when the build fails.)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// splitmix64: tiny, high-quality, seedable per-edge generator so results are
// independent of thread count (deterministic parallel generation).
inline uint64_t splitmix64(uint64_t& x) {
  x += 0x9e3779b97f4a7c15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline double u01(uint64_t& s) {
  return (splitmix64(s) >> 11) * 0x1.0p-53;
}

}  // namespace

extern "C" {

// Graph500-style RMAT: fills u/v/w (caller-allocated, length m).
// Deterministic in (seed); parallel over edges.
void rmat_generate(int scale, int64_t m, uint64_t seed, double a, double b,
                   double c, int64_t wlow, int64_t whigh, int64_t* u,
                   int64_t* v, int64_t* w) {
  const double d = 1.0 - a - b - c;
  const double p_src = a + b;  // P(src bit = 0)
  const double p_dst_given_src0 = (a + b) > 0 ? b / (a + b) : 0.0;
  const double p_dst_given_src1 = (c + d) > 0 ? d / (c + d) : 0.0;
  const int64_t wspan = whigh - wlow + 1;
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < m; ++e) {
    uint64_t s = seed * 0x9e3779b97f4a7c15ULL + (uint64_t)e * 0xda942042e4dd58b5ULL;
    splitmix64(s);  // warm up
    int64_t uu = 0, vv = 0;
    for (int bit = 0; bit < scale; ++bit) {
      const bool src_bit = u01(s) >= p_src;
      const double p_dst = src_bit ? p_dst_given_src1 : p_dst_given_src0;
      const bool dst_bit = u01(s) < p_dst;
      uu = (uu << 1) | (int64_t)src_bit;
      vv = (vv << 1) | (int64_t)dst_bit;
    }
    u[e] = uu;
    v[e] = vv;
    w[e] = wlow + (int64_t)(splitmix64(s) % (uint64_t)wspan);
  }
}

// Canonicalize (lo, hi), drop self-loops, dedup keeping the min weight per
// pair. In-place; returns the new edge count.
int64_t dedup_edges(int64_t m, int64_t n, int64_t* u, int64_t* v, int64_t* w) {
  struct Rec {
    int64_t code;
    int64_t w;
  };
  std::vector<Rec> recs;
  recs.reserve((size_t)m);
  for (int64_t e = 0; e < m; ++e) {
    const int64_t lo = u[e] < v[e] ? u[e] : v[e];
    const int64_t hi = u[e] < v[e] ? v[e] : u[e];
    if (lo == hi) continue;  // self-loop
    recs.push_back({lo * n + hi, w[e]});
  }
  std::sort(recs.begin(), recs.end(), [](const Rec& x, const Rec& y) {
    return x.code < y.code || (x.code == y.code && x.w < y.w);
  });
  int64_t out = 0;
  for (size_t i = 0; i < recs.size(); ++i) {
    if (i == 0 || recs[i].code != recs[i - 1].code) {
      u[out] = recs[i].code / n;
      v[out] = recs[i].code % n;
      w[out] = recs[i].w;
      ++out;
    }
  }
  return out;
}

// DIMACS .gr parser ("p sp N M" header, "a u v w" arcs, 1-indexed).
// Two-phase via cap: pass cap=0 to get the arc count (and n via n_out),
// then call again with arrays of that capacity. Returns arcs written (or
// total arcs if cap==0); -1 on I/O error.
int64_t dimacs_parse(const char* path, int64_t* n_out, int64_t* u, int64_t* v,
                     int64_t* w, int64_t cap) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[256];
  int64_t count = 0;
  *n_out = 0;
  while (std::fgets(line, sizeof line, f)) {
    // A line longer than the buffer would leave its tail to be misread as a
    // fresh record (desyncing the two-phase count/fill passes); consume the
    // remainder so each physical line is parsed exactly once.
    if (!std::strchr(line, '\n') && !std::feof(f)) {
      int ch;
      while ((ch = std::fgetc(f)) != EOF && ch != '\n') {
      }
    }
    if (line[0] == 'p') {
      long long n = 0, m = 0;
      std::sscanf(line, "p %*s %lld %lld", &n, &m);
      *n_out = (int64_t)n;
    } else if (line[0] == 'a') {
      long long aa, bb, ww;
      if (std::sscanf(line, "a %lld %lld %lld", &aa, &bb, &ww) == 3) {
        if (cap > 0) {
          if (count >= cap) break;
          u[count] = (int64_t)aa - 1;
          v[count] = (int64_t)bb - 1;
          w[count] = (int64_t)ww;
        }
        ++count;
      }
    }
  }
  std::fclose(f);
  return count;
}

// Rank-sorted CSR over directed slots: like build_csr but each row is sorted
// ascending by the per-edge rank (the kernel's total order), carrying the
// rank instead of the weight. Counting sort by src then per-row std::sort —
// O(E + sum_v d_v log d_v). Feeds Graph.ell_buckets at RMAT-22+ scale where
// the NumPy lexsort path takes minutes.
void build_rank_csr(int64_t n, int64_t m, const int64_t* u, const int64_t* v,
                    const int64_t* rank, int64_t* indptr, int64_t* adj_dst,
                    int64_t* adj_rank) {
  std::memset(indptr, 0, sizeof(int64_t) * (size_t)(n + 1));
  for (int64_t e = 0; e < m; ++e) {
    ++indptr[u[e] + 1];
    ++indptr[v[e] + 1];
  }
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
  std::vector<int64_t> cursor(indptr, indptr + n);
  for (int64_t e = 0; e < m; ++e) {
    int64_t cu = cursor[u[e]]++;
    adj_dst[cu] = v[e];
    adj_rank[cu] = rank[e];
    int64_t cv = cursor[v[e]]++;
    adj_dst[cv] = u[e];
    adj_rank[cv] = rank[e];
  }
  struct Pair {
    int64_t rank, dst;
  };
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t vtx = 0; vtx < n; ++vtx) {
    const int64_t s = indptr[vtx], e = indptr[vtx + 1];
    if (e - s < 2) continue;
    std::vector<Pair> row((size_t)(e - s));
    for (int64_t i = s; i < e; ++i) row[(size_t)(i - s)] = {adj_rank[i], adj_dst[i]};
    std::sort(row.begin(), row.end(),
              [](const Pair& a, const Pair& b) { return a.rank < b.rank; });
    for (int64_t i = s; i < e; ++i) {
      adj_rank[i] = row[(size_t)(i - s)].rank;
      adj_dst[i] = row[(size_t)(i - s)].dst;
    }
  }
}

// Per-vertex minimum incident rank: one O(m) pass over rank-ordered endpoint
// arrays (ra[r], rb[r] = endpoints of the rank-r edge). out has n entries,
// INT32_MAX sentinel for isolated vertices. This IS Boruvka level 1 (every
// incident edge is outgoing at level 0), done on the host for free.
void first_rank(int64_t n, int64_t m, const int64_t* ra, const int64_t* rb,
                int32_t* out) {
  const int32_t kMax = 0x7fffffff;
  for (int64_t v = 0; v < n; ++v) out[v] = kMax;
  for (int64_t r = 0; r < m; ++r) {
    if (out[ra[r]] == kMax) out[ra[r]] = (int32_t)r;
    if (out[rb[r]] == kMax) out[rb[r]] = (int32_t)r;
  }
}

// int64-rank variant for the sharded rank64 path (rank spaces past 2^31;
// the int32 first_rank's (int32_t)r cast would overflow there).
void first_rank64(int64_t n, int64_t m, const int64_t* ra, const int64_t* rb,
                  int64_t* out) {
  const int64_t kMax = 0x7fffffffffffffffLL;
  for (int64_t v = 0; v < n; ++v) out[v] = kMax;
  for (int64_t r = 0; r < m; ++r) {
    if (out[ra[r]] == kMax) out[ra[r]] = r;
    if (out[rb[r]] == kMax) out[rb[r]] = r;
  }
}

// int32 variant over already-built rank endpoints (the prep fast path reuses
// the padded ra/rb it just produced instead of re-gathering from u/v).
void first_rank_i32(int64_t n, int64_t m, const int32_t* ra, const int32_t* rb,
                    int32_t* out) {
  const int32_t kMax = 0x7fffffff;
  for (int64_t v = 0; v < n; ++v) out[v] = kMax;
  for (int64_t r = 0; r < m; ++r) {
    if (out[ra[r]] == kMax) out[ra[r]] = (int32_t)r;
    if (out[rb[r]] == kMax) out[rb[r]] = (int32_t)r;
  }
}

// int32 endpoints, int64 rank output: the rank64 staging path reuses the
// padded int32 ra/rb it just built (ranks exceed int32 there, vertex ids
// never do) instead of re-gathering int64 endpoints from u/v.
void first_rank_i32e64(int64_t n, int64_t m, const int32_t* ra,
                       const int32_t* rb, int64_t* out) {
  const int64_t kMax = 0x7fffffffffffffffLL;
  for (int64_t v = 0; v < n; ++v) out[v] = kMax;
  for (int64_t r = 0; r < m; ++r) {
    if (out[ra[r]] == kMax) out[ra[r]] = r;
    if (out[rb[r]] == kMax) out[rb[r]] = r;
  }
}

// Fused rank-endpoint build: ra[r] = (int32)u[order[r]], rb likewise, with the
// tail zero-padded to size_pad. One pass, int32 writes — replaces two int64
// NumPy fancy-gathers plus casts plus pad copies (the pre-transfer critical
// path of prep: the ra/rb staging cannot start before these arrays exist).
void rank_endpoints_i32(int64_t m, int64_t size_pad, const int64_t* order,
                        const int64_t* u, const int64_t* v, int32_t* ra,
                        int32_t* rb) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < m; ++r) {
    const int64_t e = order[r];
    ra[r] = (int32_t)u[e];
    rb[r] = (int32_t)v[e];
  }
  if (size_pad > m) {
    std::memset(ra + m, 0, (size_t)(size_pad - m) * sizeof(int32_t));
    std::memset(rb + m, 0, (size_t)(size_pad - m) * sizeof(int32_t));
  }
}

// rank_endpoints_i32 fused with the 24-bit planar wire packing: one pass
// emits the int32 endpoint arrays (the host levels consume them) AND the
// six little-endian byte-planes of the packed transfer buffer
// (planes[k*size_pad + r] = byte k of ra[r] for k<3, of rb[r] for k>=3) —
// replacing a separate strided re-read/re-write of both arrays on prep's
// pre-transfer critical path. Caller guarantees endpoint ids < 2^24.
void rank_endpoints_i32_planes(int64_t m, int64_t size_pad,
                               const int64_t* order, const int64_t* u,
                               const int64_t* v, int32_t* ra, int32_t* rb,
                               uint8_t* planes) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < m; ++r) {
    const int64_t e = order[r];
    const uint32_t a = (uint32_t)u[e];
    const uint32_t b = (uint32_t)v[e];
    ra[r] = (int32_t)a;
    rb[r] = (int32_t)b;
    planes[r] = (uint8_t)(a & 0xff);
    planes[size_pad + r] = (uint8_t)((a >> 8) & 0xff);
    planes[2 * size_pad + r] = (uint8_t)((a >> 16) & 0xff);
    planes[3 * size_pad + r] = (uint8_t)(b & 0xff);
    planes[4 * size_pad + r] = (uint8_t)((b >> 8) & 0xff);
    planes[5 * size_pad + r] = (uint8_t)((b >> 16) & 0xff);
  }
  if (size_pad > m) {
    const size_t pad = (size_t)(size_pad - m);
    std::memset(ra + m, 0, pad * sizeof(int32_t));
    std::memset(rb + m, 0, pad * sizeof(int32_t));
    for (int k = 0; k < 6; ++k)
      std::memset(planes + (size_t)k * size_pad + m, 0, pad);
  }
}

// Kruskal MSF over edges in ascending (weight, edge id) order — the oracle
// fast path: the rank order already exists natively, so one union-find pass
// verifies a solve at C speed (SciPy's csgraph oracle costs ~890 s at
// RMAT-24; this is O(m alpha(n))). Writes [total_weight, edge_count] to out.
static int64_t uf_find(int64_t* p, int64_t x) {
  while (p[x] != x) {
    p[x] = p[p[x]];  // path halving
    x = p[x];
  }
  return x;
}

// Full Kruskal SOLVE over edges in the given (weight, edge id) order:
// emits the chosen edge ids (ascending rank order) and the final
// per-vertex component label (fully path-compressed). Validates `order`
// instead of trusting it: the solver under test consumes the SAME
// precomputed order, so an independent check must prove (a) the order is
// a permutation of [0, m) and (b) weights are non-decreasing along it —
// given both, the result is the true unique MSF regardless of how ties
// were broken. Returns the MSF edge count, or -1 on a corrupt order.
int64_t kruskal_msf_solve(int64_t n, int64_t m, const int64_t* order,
                          const int64_t* u, const int64_t* v,
                          const int64_t* w, int64_t* out_edges,
                          int64_t* labels) {
  std::vector<int64_t> parent((size_t)n);
  for (int64_t i = 0; i < n; ++i) parent[i] = i;
  std::vector<uint8_t> seen((size_t)m, 0);
  int64_t count = 0, prev_w = 0;
  for (int64_t r = 0; r < m; ++r) {
    const int64_t e = order[r];
    if (e < 0 || e >= m || seen[e] || (r > 0 && w[e] < prev_w)) return -1;
    seen[e] = 1;
    prev_w = w[e];
    const int64_t ru = uf_find(parent.data(), u[e]);
    const int64_t rv = uf_find(parent.data(), v[e]);
    if (ru == rv) continue;
    parent[ru] = rv;
    out_edges[count++] = e;
  }
  for (int64_t i = 0; i < n; ++i) labels[i] = uf_find(parent.data(), i);
  return count;
}

// Weight-only oracle form: one body with kruskal_msf_solve (a divergence
// between the oracle and the host solve would be the quiet kind of bug —
// share the loop). Writes [total_weight, edge_count]; edge_count = -1 on
// a corrupt order (caller falls back to the independently-sorted SciPy
// oracle).
void kruskal_msf(int64_t n, int64_t m, const int64_t* order, const int64_t* u,
                 const int64_t* v, const int64_t* w, int64_t* out) {
  std::vector<int64_t> edges((size_t)(n > 0 ? n : 1));
  std::vector<int64_t> labels((size_t)(n > 0 ? n : 1));
  const int64_t count =
      kruskal_msf_solve(n, m, order, u, v, w, edges.data(), labels.data());
  if (count < 0) {
    out[0] = 0;
    out[1] = -1;
    return;
  }
  int64_t total = 0;
  for (int64_t i = 0; i < count; ++i) total += w[edges[i]];
  out[0] = total;
  out[1] = count;
}

// Stable counting sort of edge ids by integer weight (ranks ascending by
// (weight, edge id)) for small weight ranges — the lexsort that dominates
// host prep at RMAT-24 scale becomes O(m + range).
// Returns 1 on success, 0 when the range is too large (caller falls back).
int rank_order_counting(int64_t m, const int64_t* w, int64_t wlow,
                        int64_t whigh, int64_t* order) {
  const int64_t range = whigh - wlow + 1;
  if (range <= 0 || range > (1 << 22)) return 0;
  std::vector<int64_t> count((size_t)range + 1, 0);
  for (int64_t e = 0; e < m; ++e) ++count[w[e] - wlow + 1];
  for (int64_t i = 0; i < range; ++i) count[i + 1] += count[i];
  for (int64_t e = 0; e < m; ++e) order[count[w[e] - wlow]++] = e;
  return 1;
}

// CSR over directed slots from undirected edges: indptr has n+1 entries;
// adj_dst/adj_w have 2m entries. Counting sort, O(n + m).
void build_csr(int64_t n, int64_t m, const int64_t* u, const int64_t* v,
               const int64_t* w, int64_t* indptr, int64_t* adj_dst,
               int64_t* adj_w) {
  std::memset(indptr, 0, sizeof(int64_t) * (size_t)(n + 1));
  for (int64_t e = 0; e < m; ++e) {
    ++indptr[u[e] + 1];
    ++indptr[v[e] + 1];
  }
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
  std::vector<int64_t> cursor(indptr, indptr + n);
  for (int64_t e = 0; e < m; ++e) {
    int64_t cu = cursor[u[e]]++;
    adj_dst[cu] = v[e];
    adj_w[cu] = w[e];
    int64_t cv = cursor[v[e]]++;
    adj_dst[cv] = u[e];
    adj_w[cv] = w[e];
  }
}

}  // extern "C"
