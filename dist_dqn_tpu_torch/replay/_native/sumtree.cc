// Prioritized-replay sum-tree, native (C++): the port's own copy of
// dist_dqn_tpu/replay/_native/sumtree.cc, which adds <cstddef> for size_t
// (g++ 12 rejects the reference's copy without it).
//
// The Ape-X replay shard keeps its priority mass in a flat binary sum-tree
// in host memory. This tree serves the learner's per-grad-step path:
// sample(batch) before every train step and set(batch) for inserts and
// priority write-backs.
//
// Writes propagate deltas: each leaf write adds (new - old) along its root
// path, applied item by item, so duplicate indices in one batch compose.
// Float64 deltas drift from the exact subtree sums over very many writes,
// so writes are counted and the Python wrapper calls rebuild() (an exact
// bottom-up recompute) on a coarse schedule.
//
// Sampling descends each query on its own (u >= left ? right : left), with
// the numpy tree's tie rule, so the two trees are exchangeable.
//
// Built with g++ by actors/transport.py build_native_lib into
// build/dist_dqn_tpu_torch/ and loaded with ctypes (replay/host.py).
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct Tree {
  int64_t capacity = 1;  // padded to a power of two
  int depth = 0;
  std::vector<double> node;  // 1-based heap layout, node[1] = total
  uint64_t writes = 0;       // leaf writes since last rebuild
};

}  // namespace

extern "C" {

void* dqn_tree_create(int64_t capacity) {
  auto* t = new Tree();
  while (t->capacity < capacity) {
    t->capacity *= 2;
    t->depth += 1;
  }
  t->node.assign(2 * t->capacity, 0.0);
  return t;
}

void dqn_tree_destroy(void* h) { delete static_cast<Tree*>(h); }

double dqn_tree_total(void* h) { return static_cast<Tree*>(h)->node[1]; }

uint64_t dqn_tree_writes(void* h) { return static_cast<Tree*>(h)->writes; }

void dqn_tree_get(void* h, const int64_t* idx, double* out, int64_t n) {
  auto* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = t->node[idx[i] + t->capacity];
}

void dqn_tree_set(void* h, const int64_t* idx, const double* vals,
                  int64_t n) {
  auto* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t pos = idx[i] + t->capacity;
    const double delta = vals[i] - t->node[pos];
    t->node[pos] = vals[i];
    for (pos >>= 1; pos >= 1; pos >>= 1) t->node[pos] += delta;
  }
  t->writes += static_cast<uint64_t>(n);
}

// Exact bottom-up recompute of every interior node; resets the write count.
void dqn_tree_rebuild(void* h) {
  auto* t = static_cast<Tree*>(h);
  for (int64_t p = t->capacity - 1; p >= 1; --p)
    t->node[p] = t->node[2 * p] + t->node[2 * p + 1];
  t->writes = 0;
}

// Exact state serialization (checkpoint/resume): dump/load the full node
// heap plus the write counter. Delta propagation makes interior sums
// PATH-DEPENDENT (bounded fp drift), so a resumed tree rebuilt from leaf
// values alone would differ from the live one in the last ulp — enough to
// break a bit-identical resume pin. Serializing the heap preserves the
// drift (and, via the counter, the periodic-rebuild cadence) exactly.
void dqn_tree_dump(void* h, double* nodes, uint64_t* writes) {
  auto* t = static_cast<Tree*>(h);
  for (size_t i = 0; i < t->node.size(); ++i) nodes[i] = t->node[i];
  *writes = t->writes;
}

void dqn_tree_load(void* h, const double* nodes, uint64_t writes) {
  auto* t = static_cast<Tree*>(h);
  for (size_t i = 0; i < t->node.size(); ++i) t->node[i] = nodes[i];
  t->writes = writes;
}

void dqn_tree_sample(void* h, const double* mass, int64_t* out, int64_t n) {
  auto* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) {
    double u = mass[i];
    int64_t pos = 1;
    for (int d = 0; d < t->depth; ++d) {
      const int64_t left = 2 * pos;
      const double lmass = t->node[left];
      const bool right = u >= lmass;
      u -= right ? lmass : 0.0;
      pos = left + (right ? 1 : 0);
    }
    out[i] = pos - t->capacity;
  }
}

}  // extern "C"
