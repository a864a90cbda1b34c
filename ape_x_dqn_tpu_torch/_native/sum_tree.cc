// Native sum-tree core for the host prioritized replay.
//
// The port's own copy of ape_x_dqn_tpu/_native/sum_tree.cc, unchanged in
// its arithmetic: host code, not a device kernel.  Its float64 sums run in
// the same order as the numpy SumTree's (parent = left + right of the final
// children), so both trees hold bit-identical nodes after the same writes.
//
// C ABI (consumed via ctypes from ape_x_dqn_tpu_torch/replay/native.py):
//   - flat array of 2*leaf_base float64 nodes, leaf i at leaf_base+i
//   - st_set:    batched leaf write + upward path propagation, last write wins
//   - st_sample: batched inverse-CDF descent (one branch per level per item)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 at first use into build/native/
// (driven by replay/native.py, named by a hash of source and flags).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct SumTree {
  int64_t capacity;
  int64_t leaf_base;  // power of two >= capacity
  std::vector<double> tree;  // size 2*leaf_base, tree[1] = total mass
};

int64_t next_pow2(int64_t n) {
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* st_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  auto* t = new SumTree();
  t->capacity = capacity;
  t->leaf_base = next_pow2(capacity);
  t->tree.assign(2 * t->leaf_base, 0.0);
  return t;
}

void st_destroy(void* handle) { delete static_cast<SumTree*>(handle); }

double st_total(void* handle) {
  return static_cast<SumTree*>(handle)->tree[1];
}

double st_max(void* handle) {
  auto* t = static_cast<SumTree*>(handle);
  double m = 0.0;
  for (int64_t i = 0; i < t->capacity; ++i) {
    double v = t->tree[t->leaf_base + i];
    if (v > m) m = v;
  }
  return m;
}

// Batched write: returns 0 on success, -1 on out-of-range index, -2 on a
// negative/non-finite priority.  Last write wins for duplicate indices
// (leaves written first, then each touched path re-summed bottom-up).
int32_t st_set(void* handle, int64_t n, const int64_t* indices,
               const double* priorities) {
  auto* t = static_cast<SumTree*>(handle);
  for (int64_t k = 0; k < n; ++k) {
    if (indices[k] < 0 || indices[k] >= t->capacity) return -1;
    if (!(priorities[k] >= 0.0) || priorities[k] != priorities[k]) return -2;
  }
  for (int64_t k = 0; k < n; ++k) {
    t->tree[t->leaf_base + indices[k]] = priorities[k];
  }
  // Propagate each touched path; parent = left + right is recomputed from
  // both children so duplicate indices cannot double-count.
  for (int64_t k = 0; k < n; ++k) {
    int64_t node = (t->leaf_base + indices[k]) >> 1;
    while (node >= 1) {
      t->tree[node] = t->tree[2 * node] + t->tree[2 * node + 1];
      node >>= 1;
    }
  }
  return 0;
}

void st_get(void* handle, int64_t n, const int64_t* indices, double* out) {
  auto* t = static_cast<SumTree*>(handle);
  for (int64_t k = 0; k < n; ++k) out[k] = t->tree[t->leaf_base + indices[k]];
}

// Batched inverse-CDF descent.  Targets must lie in [0, total); results are
// clamped to [0, capacity-1] against float round-off at interval edges.
void st_sample(void* handle, int64_t n, const double* targets, int64_t* out) {
  auto* t = static_cast<SumTree*>(handle);
  for (int64_t k = 0; k < n; ++k) {
    double target = targets[k];
    int64_t node = 1;
    while (node < t->leaf_base) {
      int64_t left = 2 * node;
      double left_mass = t->tree[left];
      if (target >= left_mass) {
        target -= left_mass;
        node = left + 1;
      } else {
        node = left;
      }
    }
    int64_t leaf = node - t->leaf_base;
    if (leaf >= t->capacity) leaf = t->capacity - 1;
    if (leaf < 0) leaf = 0;
    out[k] = leaf;
  }
}

}  // extern "C"
