// Native TFCE engine: batched threshold-free cluster enhancement over meshes.
//
// Replaces the reference's per-threshold Python dict cluster merger
// (reference analyses/cluster_analysis.py:15-75,248-312) for the
// 10k-permutation null sweep, where the Python implementation is the
// pipeline's dominant host cost.
//
// Algorithm: one descending-threshold pass per map with a union-find whose
// component membership is resolved lazily through a Kruskal dendrogram:
//   * every vertex is a leaf; every union creates a virtual node;
//   * at each threshold level, the per-component TFCE contribution
//     (extent^E * thresh^H * dh) is added to the component's current top
//     node, NOT to every member vertex;
//   * after the sweep, one top-down pass over the dendrogram pushes the
//     accumulated contributions to the leaves.
// Per map: O(E alpha(V) + V + T*C_live) instead of the naive O(T*E).
//
// Semantics preserved exactly (validated against the scipy backend in
// tests/test_torch_tfce.py):
//   - an edge is active at threshold t iff BOTH endpoint values are >= t;
//   - a cluster's vertex set is vertices incident to >= 1 active edge;
//   - isolated vertices with value > t (strict) receive the singleton
//     contribution (num_vertices extents mode only);
//   - thresholds are arange(dh, max+dh, dh); dh==0 -> max/100;
//   - NaN/inf/<=0 max -> zero map; NaN values never activate.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Dendrogram {
  // union-find over "nodes": 0..V-1 leaves, V.. virtual merge nodes
  std::vector<int32_t> uf_parent;   // union-find parent (path compressed)
  std::vector<int32_t> tree_parent; // dendrogram parent (for final push-down)
  std::vector<double> acc;          // contribution accumulated at this node
  std::vector<int32_t> comp_count;  // vertices in component (top nodes only)
  std::vector<double> comp_extent;  // edge-length extent (top nodes only)
  int32_t next_node;

  explicit Dendrogram(int32_t v)
      : uf_parent(2 * v), tree_parent(2 * v, -1), acc(2 * v, 0.0),
        comp_count(2 * v, 0), comp_extent(2 * v, 0.0), next_node(v) {
    for (int32_t i = 0; i < 2 * v; ++i) uf_parent[i] = i;
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (uf_parent[root] != root) root = uf_parent[root];
    while (uf_parent[x] != root) {
      int32_t nxt = uf_parent[x];
      uf_parent[x] = root;
      x = nxt;
    }
    return root;
  }
};

// One TFCE map. values: [v]; edges: [e][2]; lengths nullable.
void tfce_single(const float* values, int32_t v, const int32_t* edges,
                 const float* lengths, int32_t e, double H, double E,
                 double dh, int extent_mode, float* out) {
  std::memset(out, 0, sizeof(float) * v);

  double max_score = -INFINITY;
  for (int32_t i = 0; i < v; ++i) {
    float x = values[i];
    if (!std::isnan(x) && x > max_score) max_score = x;
  }
  if (!std::isfinite(max_score) || max_score <= 0.0) return;

  double step = (dh == 0.0) ? max_score / 100.0 : dh;
  // thresholds ascending: step, 2*step, ... (np.arange(step, max+step, step))
  int32_t n_levels = 0;
  {
    // replicate np.arange length semantics: ceil((stop - start)/step) with
    // stop = max + step
    double span = (max_score + step) - step;
    n_levels = (int32_t)std::ceil(span / step);
    if (n_levels < 0) n_levels = 0;
    // guard float edge: arange excludes values >= stop
    while (n_levels > 0 && step + (n_levels - 1) * step >= max_score + step)
      --n_levels;
    while (step + n_levels * step < max_score + step) ++n_levels;
  }
  if (n_levels <= 0) return;

  // level of a value x = number of thresholds t=k*step (k>=1) with x >= t,
  // i.e. floor(x/step) clamped to n_levels.  Edge active at levels
  // 1..level(min endpoints); vertex strictly-above at levels 1..ceil-ish:
  // x > t  <=>  k < x/step, count = ceil(x/step) - 1 ... computed per level
  // by comparison to avoid float-division edge cases; we precompute instead
  // sorted orders.

  // Precompute per-edge activation level & per-vertex levels.
  std::vector<int32_t> edge_level(e);
  std::vector<double> thresholds(n_levels + 1);
  for (int32_t k = 1; k <= n_levels; ++k) thresholds[k] = step * k;

  auto level_geq = [&](double x) {
    // number of thresholds with x >= t
    if (std::isnan(x) || x < thresholds[1]) return (int32_t)0;
    int32_t k = (int32_t)std::floor(x / step);
    if (k > n_levels) k = n_levels;
    // float-guard: ensure x >= thresholds[k], x < thresholds[k+1]
    while (k > 0 && x < thresholds[k]) --k;
    while (k < n_levels && x >= thresholds[k + 1]) ++k;
    return k;
  };
  auto level_gt = [&](double x) {
    // number of thresholds with x > t
    if (std::isnan(x) || x <= thresholds[1]) return (int32_t)0;
    int32_t k = (int32_t)std::floor(x / step);
    if (k > n_levels) k = n_levels;
    while (k > 0 && x <= thresholds[k]) --k;
    while (k < n_levels && x > thresholds[k + 1]) ++k;
    return k;
  };

  for (int32_t i = 0; i < e; ++i) {
    float a = values[edges[2 * i]], b = values[edges[2 * i + 1]];
    if (std::isnan(a) || std::isnan(b)) {
      edge_level[i] = 0;
    } else {
      edge_level[i] = level_geq(std::min(a, b));
    }
  }

  // bucket edges by activation level (descending processing)
  std::vector<int32_t> bucket_start(n_levels + 2, 0);
  for (int32_t i = 0; i < e; ++i) bucket_start[edge_level[i]]++;
  // prefix sums so bucket of level L occupies [start[L], start[L+1])
  {
    std::vector<int32_t> counts = bucket_start;
    int32_t run = 0;
    for (int32_t l = 0; l <= n_levels + 1; ++l) {
      bucket_start[l] = run;
      run += counts[l];
    }
  }
  std::vector<int32_t> edge_order(e);
  {
    std::vector<int32_t> cursor(bucket_start.begin(), bucket_start.end());
    for (int32_t i = 0; i < e; ++i) edge_order[cursor[edge_level[i]]++] = i;
  }

  Dendrogram d(v);
  std::vector<int32_t> live_roots;   // top nodes of current components
  live_roots.reserve(1024);
  std::vector<int32_t> vertex_join_level(v, 0); // level at which vertex joins a component
  std::vector<char> in_component(v, 0);

  // process levels descending; components grow as threshold drops
  for (int32_t lvl = n_levels; lvl >= 1; --lvl) {
    // activate edges of this level
    for (int32_t bi = bucket_start[lvl]; bi < bucket_start[lvl + 1]; ++bi) {
      int32_t ei = edge_order[bi];
      int32_t a = edges[2 * ei], b = edges[2 * ei + 1];
      double len = lengths ? (double)lengths[ei] : 0.0;
      if (!in_component[a]) { in_component[a] = 1; vertex_join_level[a] = lvl; }
      if (!in_component[b]) { in_component[b] = 1; vertex_join_level[b] = lvl; }
      int32_t ra = d.find(a), rb = d.find(b);
      if (ra == rb) {
        d.comp_extent[ra] += len;
        continue;
      }
      // create a virtual merge node
      int32_t m = d.next_node++;
      d.tree_parent[ra] = m;
      d.tree_parent[rb] = m;
      d.uf_parent[ra] = m;
      d.uf_parent[rb] = m;
      int32_t ca = (ra < v) ? 1 : d.comp_count[ra];
      int32_t cb = (rb < v) ? 1 : d.comp_count[rb];
      d.comp_count[m] = ca + cb;
      d.comp_extent[m] = d.comp_extent[ra] + d.comp_extent[rb] + len;
      // maintain live root list lazily: push m, stale entries filtered below
      live_roots.push_back(m);
    }

    // per-component contribution at this level
    double th = thresholds[lvl];
    double th_pow = std::pow(th, H) * step;
    // compact live_roots: keep only current roots
    int32_t w = 0;
    for (int32_t r : live_roots)
      if (d.uf_parent[r] == r) live_roots[w++] = r;
    live_roots.resize(w);
    for (int32_t r : live_roots) {
      double extent = (extent_mode == 0) ? (double)d.comp_count[r] : d.comp_extent[r];
      d.acc[r] += std::pow(extent, E) * th_pow;
    }
  }

  // push dendrogram accumulations down to leaves
  // nodes were created in increasing id order; parents always have larger ids
  for (int32_t n = d.next_node - 1; n >= 0; --n) {
    int32_t p = d.tree_parent[n];
    if (p >= 0) d.acc[n] += d.acc[p];
  }
  for (int32_t i = 0; i < v; ++i) out[i] = (float)d.acc[i];

  // singleton contributions (num_vertices mode): value > t while not yet in a
  // component.  A vertex is out of any component at levels
  // (vertex_join_level, level_gt(value)]  (strictly above threshold).
  if (extent_mode == 0) {
    // prefix sums of th^H * step over levels
    std::vector<double> pref(n_levels + 1, 0.0);
    for (int32_t k = 1; k <= n_levels; ++k)
      pref[k] = pref[k - 1] + std::pow(thresholds[k], H) * step;
    for (int32_t i = 0; i < v; ++i) {
      int32_t hi = level_gt(values[i]);          // active at levels 1..hi
      int32_t lo = in_component[i] ? vertex_join_level[i] : 0; // joins at lo
      if (hi > lo) out[i] += (float)(pref[hi] - pref[lo]);
    }
  }
}

}  // namespace

extern "C" {

int tfce_batch(const float* values, int n_maps, int v, const int32_t* edges,
               const float* lengths, int e, double H, double E, double dh,
               int extent_mode, float* out, int n_threads) {
  if (n_maps <= 0 || v <= 0) return 1;
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? (int)hc : 1;
  }
  n_threads = std::min(n_threads, n_maps);

  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_maps) break;
      tfce_single(values + (size_t)i * v, v, edges, lengths, e, H, E, dh,
                  extent_mode, out + (size_t)i * v);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
