// scikit-learn's BestSplitter feature draws (tree/_splitter.pyx,
// node_split_best), replayed for many trees in one call: the xorshift
// rand_r of utils/_random.pxd and the in-place Fisher-Yates over each
// tree's features array with its constant-feature bookkeeping.  Host code
// for odin_tpu_torch/bay/vi/estimators.py's SplitterDrawsBatch, which
// keeps a Python version of the same loop.
#include <cstdint>

namespace {

constexpr uint32_t kRandRMax = 2147483647u;  // RAND_R_MAX

inline int64_t rand_int(int64_t low, int64_t high, uint32_t* state) {
  uint32_t s = *state;
  if (s == 0) s = 1;  // DEFAULT_SEED
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  *state = s;
  return low + static_cast<int64_t>(s % (kRandRMax + 1u)) % (high - low);
}

inline void swap(int64_t* a, int64_t i, int64_t j) {
  int64_t t = a[i];
  a[i] = a[j];
  a[j] = t;
}

}  // namespace

extern "C" {

// For each of the m trees `rows`: one node's visit with n_known[i]
// inherited constant features and constant[i, f] true where feature f is
// constant in the node.  Writes the non-constant features in visit order to
// visited[i, :n_visited[i]] and the node's constant count to n_total[i];
// the tree's state, features and constant_features change in place.
void splitter_visit_many(int64_t m, const int64_t* rows, uint32_t* states,
                         int64_t* features, int64_t* constant_features,
                         int64_t d, const int64_t* n_known,
                         const uint8_t* constant, int64_t max_features,
                         int64_t* visited, int64_t* n_visited,
                         int64_t* n_total) {
  for (int64_t i = 0; i < m; ++i) {
    const int64_t t = rows[i];
    uint32_t* state = states + t;
    int64_t* feat = features + t * d;
    int64_t* cfeat = constant_features + t * d;
    const uint8_t* cst = constant + i * d;
    int64_t* out = visited + i * d;
    const int64_t known = n_known[i];
    int64_t f_i = d, drawn = 0, found = 0, seen = 0, total = known, nv = 0;
    while (f_i > total && (seen < max_features || seen <= found + drawn)) {
      ++seen;
      int64_t f_j = rand_int(drawn, f_i - found, state);
      if (f_j < known) {
        swap(feat, drawn, f_j);
        ++drawn;
        continue;
      }
      f_j += found;
      if (cst[feat[f_j]]) {
        swap(feat, f_j, total);
        ++found;
        ++total;
        continue;
      }
      --f_i;
      swap(feat, f_i, f_j);
      out[nv++] = feat[f_i];
    }
    for (int64_t k = 0; k < known; ++k) feat[k] = cfeat[k];
    for (int64_t k = 0; k < found; ++k) cfeat[known + k] = feat[known + k];
    n_visited[i] = nv;
    n_total[i] = total;
  }
}

}  // extern "C"
