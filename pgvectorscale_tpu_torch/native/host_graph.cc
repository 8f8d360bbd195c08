// Host-side graph runtime: BFS reachability, orphan repair, degree stats,
// and CSR conversion over the flat adjacency table (the port's copy of the
// JAX package's native/host_graph.cc).
//
// The device path is PyTorch and CUDA; these host-side graph loops are
// pointer chasing, which Python is 100-1000x too slow for at the scales the
// index targets, so they live in C++.
//
// Reference parity notes:
// - bfs_reachable  <-> debug_count_reachable_nodes
//                      (src/access_method/graph/debugging.rs:12-50)
// - repair_orphans <-> the orphan-detection path of Graph::insert
//                      (src/access_method/graph/mod.rs:706-716), upgraded
//                      from warn-only to repair.
//
// ABI: plain C, loaded via ctypes.  Adjacency layout: int32[n][r] row-major,
// INVALID_ID (-1) padded.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int32_t kInvalid = -1;
}

extern "C" {

// Mark all nodes reachable from `start` by directed BFS.  `seen` is a
// caller-allocated uint8[n], zero-initialized by this function.
void pgvs_bfs_reachable(const int32_t* adj, int64_t n, int64_t r,
                        int32_t start, uint8_t* seen) {
  std::memset(seen, 0, static_cast<size_t>(n));
  if (start < 0 || start >= n || n == 0) return;
  std::vector<int32_t> frontier;
  std::vector<int32_t> next;
  frontier.reserve(1024);
  next.reserve(1024);
  seen[start] = 1;
  frontier.push_back(start);
  while (!frontier.empty()) {
    next.clear();
    for (int32_t u : frontier) {
      const int32_t* row = adj + static_cast<int64_t>(u) * r;
      for (int64_t j = 0; j < r; ++j) {
        int32_t v = row[j];
        if (v < 0 || v >= n) continue;
        if (!seen[v]) {
          seen[v] = 1;
          next.push_back(v);
        }
      }
    }
    frontier.swap(next);
  }
}

// Force reachability of every node from `start` by adding backlinks from
// reachable hosts (preferring each orphan's own nearest forward neighbor).
// Mutates `adj` in place.  Returns the number of forced edges, or -1 on
// invalid input.
int64_t pgvs_repair_orphans(int32_t* adj, int64_t n, int64_t r,
                            int32_t start) {
  if (start < 0 || start >= n || n == 0 || r <= 0) return 0;
  std::vector<uint8_t> seen(static_cast<size_t>(n));
  int64_t forced_total = 0;
  auto free_slot = [&](int32_t node) -> int64_t {
    const int32_t* row = adj + static_cast<int64_t>(node) * r;
    for (int64_t j = 0; j < r; ++j)
      if (row[j] == kInvalid) return j;
    return -1;
  };
  for (int round = 0; round < 64; ++round) {
    pgvs_bfs_reachable(adj, n, r, start, seen.data());
    bool any_orphan = false;
    bool progress = false;
    // Chain: the previously repaired orphan is the fallback host for the
    // next one — its row usually has free slots, so repairs never fight
    // over the same full row.
    int32_t chain_prev = kInvalid;
    for (int64_t u = 0; u < n; ++u) {
      if (seen[u]) continue;
      any_orphan = true;
      // Preferred host: u's nearest reachable forward neighbor with a
      // free slot (keeps the detour short and lossless).
      int32_t host = kInvalid;
      int32_t host_full = kInvalid;
      const int32_t* urow = adj + u * r;
      for (int64_t j = 0; j < r; ++j) {
        int32_t w = urow[j];
        if (w < 0 || w >= n || !seen[w]) continue;
        if (free_slot(w) >= 0) {
          host = w;
          break;
        }
        if (host_full == kInvalid) host_full = w;
      }
      if (host == kInvalid && chain_prev != kInvalid &&
          free_slot(chain_prev) >= 0) {
        host = chain_prev;
      }
      if (host == kInvalid) host = host_full;
      if (host == kInvalid) host = start;
      if (host == static_cast<int32_t>(u)) continue;
      int32_t* hrow = adj + static_cast<int64_t>(host) * r;
      int64_t slot = free_slot(host);
      if (slot < 0) slot = r - 1;  // overwrite the farthest edge
      hrow[slot] = static_cast<int32_t>(u);
      seen[u] = 1;  // exact: host is reachable, so u now is too
      chain_prev = static_cast<int32_t>(u);
      ++forced_total;
      progress = true;
    }
    if (!any_orphan || !progress) break;
  }
  return forced_total;
}

// Out-degree per node: deg[i] = count of valid entries in row i.
void pgvs_degrees(const int32_t* adj, int64_t n, int64_t r, int32_t* deg) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = adj + i * r;
    int32_t d = 0;
    for (int64_t j = 0; j < r; ++j) d += (row[j] != kInvalid);
    deg[i] = d;
  }
}

// In-degree per node over valid edges.
void pgvs_in_degrees(const int32_t* adj, int64_t n, int64_t r,
                     int32_t* indeg) {
  std::memset(indeg, 0, static_cast<size_t>(n) * sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = adj + i * r;
    for (int64_t j = 0; j < r; ++j) {
      int32_t v = row[j];
      if (v >= 0 && v < n) ++indeg[v];
    }
  }
}

// Convert the padded adjacency into CSR (indptr int64[n+1], indices int32).
// Returns the number of edges written; call with indices==nullptr to size.
int64_t pgvs_to_csr(const int32_t* adj, int64_t n, int64_t r,
                    int64_t* indptr, int32_t* indices) {
  int64_t e = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (indptr) indptr[i] = e;
    const int32_t* row = adj + i * r;
    for (int64_t j = 0; j < r; ++j) {
      int32_t v = row[j];
      if (v == kInvalid) continue;
      if (indices) indices[e] = v;
      ++e;
    }
  }
  if (indptr) indptr[n] = e;
  return e;
}

}  // extern "C"
