// Native setup core: the host-side mesh/DoF machinery that the reference
// consumes from deal.II's C++ library (L1/L2 setup). The device execution
// path is JAX/XLA; this library accelerates the trace-time setup pass:
//
//  - hn_balance_flags: one 2:1-balance sweep over the active forest
//    (face + edge 1-irregularity, deal.II's rule) using a hash set of
//    packed (level, coord) keys.
//  - hn_dof_unique: entity-key dedup for DoF enumeration — sorts (key1,key2)
//    pairs and assigns dense global ids.
//
// Exposed with a plain C ABI for ctypes; built via native/Makefile.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_set>
#include <vector>

namespace {

inline int64_t pack_key(int dim, int64_t level, const int64_t *coord) {
  int64_t key = level;
  for (int d = 0; d < dim; ++d) key = (key << 16) | coord[d];
  return key;
}

}  // namespace

extern "C" {

// ABI version of this library. Bump on any signature/dtype change (the
// ctypes loader refuses to use a library with a different version — a
// stale .so with int64 gid outputs would otherwise overrun the int32
// buffers the loader now passes).
int64_t hn_abi_version() { return 2; }

// One balance iteration. Returns the number of flagged cells; flags[i] = 1
// where the active cell must be refined (it is >= 2 levels coarser than a
// face/edge neighbor). Arrays: level[n], coord[n*dim] (C order).
int64_t hn_balance_flags(int32_t dim, int64_t n, const int64_t *level,
                         const int64_t *coord, uint8_t *flags) {
  std::unordered_set<int64_t> active;
  active.reserve(static_cast<size_t>(n) * 2);
  std::vector<int64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    keys[i] = pack_key(dim, level[i], coord + i * dim);
    active.insert(keys[i]);
  }
  // key -> active index
  // (store index via a second pass: map from key to i using sorted vector)
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return keys[a] < keys[b]; });
  std::vector<int64_t> sorted_keys(n);
  for (int64_t i = 0; i < n; ++i) sorted_keys[i] = keys[order[i]];

  auto find_index = [&](int64_t key) -> int64_t {
    auto it = std::lower_bound(sorted_keys.begin(), sorted_keys.end(), key);
    if (it == sorted_keys.end() || *it != key) return -1;
    return order[it - sorted_keys.begin()];
  };

  // neighbor probe offsets: faces; in 3D also edges
  std::vector<std::array<int64_t, 3>> offsets;
  for (int d = 0; d < dim; ++d)
    for (int s = -1; s <= 1; s += 2) {
      std::array<int64_t, 3> o{0, 0, 0};
      o[d] = s;
      offsets.push_back(o);
    }
  if (dim == 3) {
    for (int e = 0; e < 3; ++e) {
      int a = (e == 0) ? 1 : 0, b = (e == 2) ? 1 : 2;
      for (int sa = -1; sa <= 1; sa += 2)
        for (int sb = -1; sb <= 1; sb += 2) {
          std::array<int64_t, 3> o{0, 0, 0};
          o[a] = sa;
          o[b] = sb;
          offsets.push_back(o);
        }
    }
  }

  std::memset(flags, 0, n);
  int64_t n_flagged = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t l = level[i];
    const int64_t lim = int64_t(1) << l;
    for (const auto &off : offsets) {
      int64_t nb[3];
      bool inside = true;
      for (int d = 0; d < dim; ++d) {
        nb[d] = coord[i * dim + d] + off[d];
        if (nb[d] < 0 || nb[d] >= lim) {
          inside = false;
          break;
        }
      }
      if (!inside) continue;
      // ancestors at levels l-2 .. 0 covering the neighbor slot
      for (int64_t up = 2; up <= l; ++up) {
        int64_t anc[3];
        for (int d = 0; d < dim; ++d) anc[d] = nb[d] >> up;
        const int64_t key = pack_key(dim, l - up, anc);
        if (active.count(key)) {
          const int64_t j = find_index(key);
          if (j >= 0 && !flags[j]) {
            flags[j] = 1;
            ++n_flagged;
          }
        }
      }
    }
  }
  return n_flagged;
}

namespace {

struct KeyEntry {
  int64_t k1, k2;
  int64_t idx;
};

// Shared dedup core: sort (k1, k2, idx) entries BY VALUE (the earlier
// index-indirect std::sort was cache-hostile: 2 random reads per comparison
// made the nref=8 DoF pass take minutes instead of seconds). gid_out is
// int32: dof counts stay < 2^31 (1.1e9 at quadrant nref=9 p=4) and the
// host's fresh-page faults past ~9 GB RSS run at ~20-40 MB/s, so halving
// the output (and every downstream cell_dofs array) is a wall-clock win.
int64_t assign_dense_ids(std::vector<KeyEntry> &entries, int32_t *gid_out) {
  std::sort(entries.begin(), entries.end(),
            [](const KeyEntry &a, const KeyEntry &b) {
              if (a.k1 != b.k1) return a.k1 < b.k1;
              return a.k2 < b.k2;
            });
  int64_t next = -1, prev1 = 0, prev2 = 0;
  bool first = true;
  for (const auto &e : entries) {
    if (first || e.k1 != prev1 || e.k2 != prev2) {
      ++next;
      prev1 = e.k1;
      prev2 = e.k2;
      first = false;
    }
    gid_out[e.idx] = static_cast<int32_t>(next);
  }
  return next + 1;
}

}  // namespace

// Entity-key dedup: assigns dense ids by sorted (key1, key2); returns n_dofs.
int64_t hn_dof_unique(int64_t n, const int64_t *key1, const int64_t *key2,
                      int32_t *gid_out) {
  std::vector<KeyEntry> entries(n);
  for (int64_t i = 0; i < n; ++i) entries[i] = {key1[i], key2[i], i};
  return assign_dense_ids(entries, gid_out);
}

// Full DoF distribution, per-entity-class: every lattice node belongs to
// one of 2^dim classes by which axes are interior (0<ia<p). Within a class
// the entity identity is (per-axis coordinate, per-interior-axis lattice
// index, cell level if any axis is interior) — vertices are shared purely
// by position across levels, interior entities only between equal-extent
// (same-level) entities, exactly the sharing rule of
// dof_handler._distribute. Packed into ONE int64:
//   coords: 16 bits per axis (lmax <= 15), ia: 4 bits per axis (p <= 15),
//   level: 4 bits (0 for the vertex class) -> <= 48+12+4 = 64 bits.
// Each class is sorted and densely numbered independently with a running
// offset; peak transient memory is the LARGEST class (~40% of the old
// all-in-one entry array at p=4), keeping nref>=8 setups under the host's
// ~9 GB fresh-fault cliff (utils/hostmem.py). Returns n_dofs, or -1 on
// unsupported inputs (caller falls back to NumPy).
int64_t hn_distribute_dofs(int32_t dim, int32_t p, int64_t n_cells,
                           const int64_t *level, const int64_t *coord,
                           int32_t *gid_out) {
  if (dim < 1 || dim > 3 || p < 1 || p > 15) return -1;
  int64_t lmax = 0;
  for (int64_t i = 0; i < n_cells; ++i) lmax = std::max(lmax, level[i]);
  if (lmax > 15) return -1;

  const int n1 = p + 1;
  int64_t n_loc = 1;
  for (int d = 0; d < dim; ++d) n_loc *= n1;

  struct CKey {
    uint64_t key;
    int64_t idx;
  };

  // per-axis lattice index decomposition of local slot l (x fastest)
  std::vector<int> lat(static_cast<size_t>(n_loc) * dim);
  for (int64_t l = 0; l < n_loc; ++l) {
    int64_t rem = l;
    for (int a = 0; a < dim; ++a) {
      lat[l * dim + a] = static_cast<int>(rem % n1);
      rem /= n1;
    }
  }

  int64_t next_gid = 0;
  std::vector<CKey> entries;
  for (int cls = 0; cls < (1 << dim); ++cls) {
    // slots of this class
    std::vector<int64_t> slots;
    for (int64_t l = 0; l < n_loc; ++l) {
      int c = 0;
      for (int a = 0; a < dim; ++a) {
        const int ia = lat[l * dim + a];
        if (ia > 0 && ia < p) c |= 1 << a;
      }
      if (c == cls) slots.push_back(l);
    }
    if (slots.empty()) continue;
    const int64_t m = static_cast<int64_t>(slots.size());
    entries.clear();
    entries.resize(static_cast<size_t>(n_cells) * m);
    for (int64_t i = 0; i < n_cells; ++i) {
      const int64_t lv = level[i];
      const int64_t sz = int64_t(1) << (lmax - lv);
      int64_t base[3] = {0, 0, 0};
      for (int d = 0; d < dim; ++d) base[d] = coord[i * dim + d] * sz;
      for (int64_t s = 0; s < m; ++s) {
        const int64_t l = slots[s];
        uint64_t key = 0;
        uint64_t iabits = 0;
        for (int a = 0; a < dim; ++a) {
          const int ia = lat[l * dim + a];
          int64_t ca;
          int ib;
          if (ia == 0) {
            ca = base[a];
            ib = 0;
          } else if (ia == p) {
            ca = base[a] + sz;
            ib = 0;
          } else {
            ca = base[a];
            ib = ia;
          }
          key = (key << 16) | static_cast<uint64_t>(ca);
          iabits = (iabits << 4) | static_cast<uint64_t>(ib);
        }
        key = (key << (4 * dim)) | iabits;
        key = (key << 4) | (cls ? static_cast<uint64_t>(lv) : 0);
        entries[static_cast<size_t>(i) * m + s] = {key, i * n_loc + l};
      }
    }
    std::sort(entries.begin(), entries.end(),
              [](const CKey &a, const CKey &b) { return a.key < b.key; });
    uint64_t prev = 0;
    bool first = true;
    int64_t gid = next_gid - 1;
    for (const auto &e : entries) {
      if (first || e.key != prev) {
        ++gid;
        prev = e.key;
        first = false;
      }
      gid_out[e.idx] = static_cast<int32_t>(gid);
    }
    next_gid = gid + 1;
  }
  return next_gid;
}

}  // extern "C"
