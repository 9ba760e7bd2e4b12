// Native grid-topology table builder.
//
// TPU-native analog of the reference's native grid-initialization path
// (reference: src/share/cube_mod.F90:1432 CubeTopology — GridVertex/GridEdge
// connectivity; src/share/dof_mod.F90:67 global_dof / :322 CreateUniqueIndex;
// src/share/schedule_mod.F90:36 genEdgeSched put/get maps).  Instead of edge
// buffers and communication schedules, the TPU design needs one set of
// static tables: for every (element, GLL point) slot, the coincident partner
// slots (DSS = masked gathers), the element neighbor list (limiter min/max),
// and the unique-point owner map (history ncol / norms).  Building those
// tables is pure host-side integer work that scales with the grid
// (NE120 = 1.4M slots), which is why it is native C++ like the reference's
// grid init is native Fortran; grid/cubesphere.py holds a
// numpy fallback with identical output.
//
// Point identity is geometric: slots whose unit-sphere coordinates coincide
// within a quantum are grouped by union-find over two offset quantization
// lattices (offsets 0 and quantum/2), which provably groups any pair closer
// than quantum/4 while never grouping pairs farther than 2*quantum apart.
// Group ids are canonicalized by first-occurrence order so gid[uniq_src[g]]
// == g and the output is independent of hash iteration order.
//
// Build: g++ -O2 -shared -fPIC -o _gridtables.so gridtables.cpp
// ABI: a single C function, ctypes-friendly (see native/__init__.py).

#include <cstdint>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  int64_t a, b, c;
  bool operator==(const Key& o) const { return a == o.a && b == o.b && c == o.c; }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t v : {(uint64_t)k.a, (uint64_t)k.b, (uint64_t)k.c}) {
      h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return (size_t)h;
  }
};

struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(int64_t n) : parent(n) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t i) {
    int64_t root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) {
      int64_t next = parent[i];
      parent[i] = root;
      i = next;
    }
    return root;
  }
  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra != rb) parent[rb] = ra;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success; negative error codes otherwise.
//   -1: a grid point has multiplicity > 4 (grouping too coarse)
//   -2: an element has > 8 neighbors (grouping too coarse/fine)
int64_t build_point_tables(
    const double* xyz,        // [n, 3] unit-sphere coordinates per slot
    int64_t n,                // number of slots = E * np * np
    int64_t np2,              // slots per element (np*np = 16)
    double quantum,           // coincidence quantum (<< grid spacing)
    int32_t* gid_out,         // [n]
    int32_t* part_idx_out,    // [n, 3] partner slots (self-padded)
    uint8_t* part_mask_out,   // [n, 3]
    int32_t* nbr_out,         // [E, 9] neighbor elements (self first,
                              //        self-padded)
    int64_t* uniq_src_out,    // [n] first slot per gid (first ngid valid)
    int64_t* ngid_out) {      // number of unique points
  const int64_t E = n / np2;
  UnionFind uf(n);

  // two-pass offset quantization
  for (int pass = 0; pass < 2; ++pass) {
    const double off = pass == 0 ? 0.0 : 0.5 * quantum;
    std::unordered_map<Key, int64_t, KeyHash> first;
    first.reserve((size_t)n * 2);
    for (int64_t i = 0; i < n; ++i) {
      Key k{(int64_t)std::floor((xyz[3 * i + 0] + off) / quantum),
            (int64_t)std::floor((xyz[3 * i + 1] + off) / quantum),
            (int64_t)std::floor((xyz[3 * i + 2] + off) / quantum)};
      auto it = first.find(k);
      if (it == first.end()) {
        first.emplace(k, i);
      } else {
        uf.unite(it->second, i);
      }
    }
  }

  // canonical gid: number groups by first occurrence in slot order
  std::vector<int32_t> gid_of_root(n, -1);
  int64_t ngid = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = uf.find(i);
    if (gid_of_root[r] < 0) {
      gid_of_root[r] = (int32_t)ngid;
      uniq_src_out[ngid] = i;
      ++ngid;
    }
    gid_out[i] = gid_of_root[r];
  }
  *ngid_out = ngid;

  // group members in increasing slot order (counting sort by gid)
  std::vector<int64_t> count(ngid + 1, 0);
  for (int64_t i = 0; i < n; ++i) count[gid_out[i] + 1]++;
  for (int64_t g = 0; g < ngid; ++g) count[g + 1] += count[g];
  std::vector<int64_t> members(n);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; ++i) members[cursor[gid_out[i]]++] = i;
  }

  // partner table: per slot, the other (<= 3) slots in its group
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      part_idx_out[3 * i + c] = (int32_t)i;
      part_mask_out[3 * i + c] = 0;
    }
  }
  for (int64_t g = 0; g < ngid; ++g) {
    const int64_t lo = count[g], hi = count[g + 1];
    if (hi - lo > 4) return -1;
    for (int64_t s = lo; s < hi; ++s) {
      int c = 0;
      for (int64_t t = lo; t < hi; ++t) {
        if (t == s) continue;
        part_idx_out[3 * members[s] + c] = (int32_t)members[t];
        part_mask_out[3 * members[s] + c] = 1;
        ++c;
      }
    }
  }

  // element neighbor table (elements sharing >= 1 point; self first,
  // remaining slots self-padded; sorted ascending like the numpy path)
  for (int64_t e = 0; e < E; ++e) {
    for (int c = 0; c < 9; ++c) nbr_out[9 * e + c] = (int32_t)e;
  }
  std::vector<int32_t> nnbr(E, 0);
  std::vector<int32_t> elems;
  for (int64_t g = 0; g < ngid; ++g) {
    const int64_t lo = count[g], hi = count[g + 1];
    if (hi - lo < 2) continue;
    elems.clear();
    for (int64_t s = lo; s < hi; ++s) {
      int32_t e = (int32_t)(members[s] / np2);
      bool seen = false;
      for (int32_t x : elems) seen |= (x == e);
      if (!seen) elems.push_back(e);
    }
    for (int32_t e : elems) {
      for (int32_t o : elems) {
        if (o == e) continue;
        int32_t* row = nbr_out + 9 * e + 1;
        bool seen = false;
        for (int c = 0; c < nnbr[e]; ++c) seen |= (row[c] == o);
        if (!seen) {
          if (nnbr[e] >= 8) return -2;
          row[nnbr[e]++] = o;
        }
      }
    }
  }
  // sort each neighbor list ascending (matches numpy `sorted(set)`)
  for (int64_t e = 0; e < E; ++e) {
    int32_t* row = nbr_out + 9 * e + 1;
    for (int a = 1; a < nnbr[e]; ++a) {
      int32_t v = row[a];
      int b = a - 1;
      while (b >= 0 && row[b] > v) { row[b + 1] = row[b]; --b; }
      row[b + 1] = v;
    }
  }
  return 0;
}

}  // extern "C"
