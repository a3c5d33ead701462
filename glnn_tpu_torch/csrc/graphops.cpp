// Host-side graph operations of the ingest path: the stable sort behind
// every CSR the port builds, CSR from COO, symmetrisation, connected
// components, node-induced subgraphs and the label propagation of the
// locality relabel.
//
// The same algorithms, and so the same arrays, as the six host entry points
// of the JAX package's library (native/graphops.cpp: sort_edges,
// coo_to_csr, to_bidirected, connected_components, induced_subgraph,
// label_propagation). They run once at ingest on the host, so each is a
// single pass, or a sort, with no allocation beyond what it states, at the
// 100M+ edge scale of ogbn-products. Bound with ctypes by
// glnn_tpu_torch/native/__init__.py, which checks every id's range before
// it passes a pointer here.
//
// ABI: plain C functions over caller-allocated int64 buffers. Each returns
// 0, or the count it states.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Stable counting sort of e edges by key (values in [0, n)); writes the
// permutation to order_out (e slots).
int64_t sort_edges(int64_t e, const int64_t* key, int64_t n,
                   int64_t* order_out) {
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) count[key[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) count[v + 1] += count[v];
  for (int64_t i = 0; i < e; ++i) order_out[count[key[i]]++] = i;
  return 0;
}

// CSR from COO: indptr_out has n+1 slots, indices_out e slots (dst values
// in row order, each row's in edge order).
int64_t coo_to_csr(int64_t n, int64_t e, const int64_t* src,
                   const int64_t* dst, int64_t* indptr_out,
                   int64_t* indices_out) {
  std::memset(indptr_out, 0, sizeof(int64_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) indptr_out[src[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) indptr_out[v + 1] += indptr_out[v];
  std::vector<int64_t> cursor(indptr_out, indptr_out + n);
  for (int64_t i = 0; i < e; ++i) indices_out[cursor[src[i]]++] = dst[i];
  return 0;
}

// Symmetrise and deduplicate, sorted by the key src * n + dst. src_out and
// dst_out hold 2e slots; returns the number of unique edges written.
int64_t to_bidirected(int64_t n, int64_t e, const int64_t* src,
                      const int64_t* dst, int64_t* src_out,
                      int64_t* dst_out) {
  std::vector<uint64_t> keys(2 * (size_t)e);
  const uint64_t un = (uint64_t)n;
  for (int64_t i = 0; i < e; ++i) {
    keys[2 * i] = (uint64_t)src[i] * un + (uint64_t)dst[i];
    keys[2 * i + 1] = (uint64_t)dst[i] * un + (uint64_t)src[i];
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  int64_t m = (int64_t)keys.size();
  for (int64_t i = 0; i < m; ++i) {
    src_out[i] = (int64_t)(keys[i] / un);
    dst_out[i] = (int64_t)(keys[i] % un);
  }
  return m;
}

// Weakly connected components by union-find with path halving. comp_out
// (n slots) numbers the components 0..k-1 in the order of each one's first
// node; returns k.
int64_t connected_components(int64_t n, int64_t e, const int64_t* src,
                             const int64_t* dst, int64_t* comp_out) {
  std::vector<int64_t> parent(n);
  std::iota(parent.begin(), parent.end(), 0);
  auto find = [&](int64_t v) {
    while (parent[v] != v) {
      parent[v] = parent[parent[v]];
      v = parent[v];
    }
    return v;
  };
  for (int64_t i = 0; i < e; ++i) {
    int64_t a = find(src[i]), b = find(dst[i]);
    if (a != b) parent[a] = b;
  }
  std::vector<int64_t> label(n, -1);
  int64_t k = 0;
  for (int64_t v = 0; v < n; ++v) {
    int64_t r = find(v);
    if (label[r] < 0) label[r] = k++;
    comp_out[v] = label[r];
  }
  return k;
}

// The edges with both ends in idx (k distinct ids), relabelled so that new
// id i is idx[i], in their original order. new_id: n scratch slots;
// src_out and dst_out: e slots; returns the number of kept edges.
int64_t induced_subgraph(int64_t n, int64_t e, const int64_t* src,
                         const int64_t* dst, int64_t k, const int64_t* idx,
                         int64_t* new_id, int64_t* src_out,
                         int64_t* dst_out) {
  for (int64_t v = 0; v < n; ++v) new_id[v] = -1;
  for (int64_t i = 0; i < k; ++i) new_id[idx[i]] = i;
  int64_t m = 0;
  for (int64_t i = 0; i < e; ++i) {
    int64_t a = new_id[src[i]], b = new_id[dst[i]];
    if (a >= 0 && b >= 0) {
      src_out[m] = a;
      dst_out[m] = b;
      ++m;
    }
  }
  return m;
}

// Synchronous label propagation over the symmetrised edge set: labels start
// as node ids; each sweep every node with a neighbour adopts the most
// frequent label among its neighbours (ties to the smallest label); stops
// after `iters` sweeps, or after the first sweep in which fewer than 0.1%
// of the nodes changed. labels_out: n slots. Returns the sweeps run. Builds
// a symmetrised CSR of 2e int64 entries; each sweep sorts every node's
// neighbour labels, O(E log deg).
int64_t label_propagation(int64_t n, int64_t e, const int64_t* src,
                          const int64_t* dst, int64_t iters,
                          int64_t* labels_out) {
  std::vector<int64_t> indptr(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    indptr[src[i] + 1]++;
    indptr[dst[i] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
  std::vector<int64_t> indices(2 * (size_t)e);
  std::vector<int64_t> cursor(indptr.begin(), indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    indices[cursor[src[i]]++] = dst[i];
    indices[cursor[dst[i]]++] = src[i];
  }

  std::vector<int64_t> prev(n), scratch;
  for (int64_t v = 0; v < n; ++v) labels_out[v] = v;
  int64_t sweep = 0;
  for (; sweep < iters; ++sweep) {
    std::copy(labels_out, labels_out + n, prev.begin());
    int64_t changed = 0;
    for (int64_t v = 0; v < n; ++v) {
      int64_t lo = indptr[v], hi = indptr[v + 1];
      if (hi == lo) continue;
      scratch.resize(hi - lo);
      for (int64_t j = lo; j < hi; ++j) scratch[j - lo] = prev[indices[j]];
      std::sort(scratch.begin(), scratch.end());
      int64_t best = scratch[0], best_cnt = 0, cnt = 1;
      for (size_t j = 1; j <= scratch.size(); ++j) {
        if (j < scratch.size() && scratch[j] == scratch[j - 1]) {
          ++cnt;
        } else {
          if (cnt > best_cnt) {
            best_cnt = cnt;
            best = scratch[j - 1];
          }
          cnt = 1;
        }
      }
      if (best != labels_out[v]) ++changed;
      labels_out[v] = best;
    }
    if (changed * 1000 < n) {
      ++sweep;
      break;
    }
  }
  return sweep;
}

}  // extern "C"
