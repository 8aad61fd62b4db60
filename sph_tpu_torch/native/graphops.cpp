// Native host-side graph restructuring ops.
//
// The TPU compute path (kNN matmuls, walks, similarity products, gradient
// descent) lives in XLA; what remains on the host is irregular
// restructuring work — exactly the part the reference implements in C++
// with Boost/OpenMP (GraphUtils.cpp symmetrizeGraph, connected-component
// labeling, the sorted node merges of SparseMatrixAlgorithms.cpp).  These
// C implementations replace the vectorized-numpy fallbacks for large N.
//
// C ABI for ctypes; build: see sph_tpu/native/__init__.py (g++ -O3 -shared).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Union-find with path halving + union by size.
// Labels are normalized to first-occurrence order (matching
// sph_tpu.ops.graph._normalize_labels).
// ---------------------------------------------------------------------

static int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];  // path halving
        x = parent[x];
    }
    return x;
}

// Weak connected components over a padded [n, k] adjacency (pad < 0).
// Returns the number of components; writes labels[n].
int64_t weak_components(int64_t n, int64_t k, const int32_t* indices,
                        int64_t* labels) {
    std::vector<int64_t> parent(n);
    std::vector<int64_t> size(n, 1);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;

    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = indices + i * k;
        for (int64_t j = 0; j < k; ++j) {
            int32_t t = row[j];
            if (t < 0 || t == i) continue;
            if (t >= n) return -1;  // out-of-domain id: caller falls back
            int64_t ra = uf_find(parent, i);
            int64_t rb = uf_find(parent, t);
            if (ra == rb) continue;
            if (size[ra] < size[rb]) std::swap(ra, rb);
            parent[rb] = ra;
            size[ra] += size[rb];
        }
    }

    // first-occurrence normalization
    std::vector<int64_t> remap(n, -1);
    int64_t next = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = uf_find(parent, i);
        if (remap[r] < 0) remap[r] = next++;
        labels[i] = remap[r];
    }
    return next;
}

// Weak CC over an explicit edge list (the per-level merge graph,
// reference: ImageHierarchy.cpp:468-471).
int64_t edge_list_components(int64_t n, int64_t m, const int64_t* src,
                             const int64_t* dst, int64_t* labels) {
    std::vector<int64_t> parent(n);
    std::vector<int64_t> size(n, 1);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
    for (int64_t e = 0; e < m; ++e) {
        if (src[e] < 0 || src[e] >= n || dst[e] < 0 || dst[e] >= n)
            return -1;  // out-of-domain id: caller falls back
        int64_t ra = uf_find(parent, src[e]);
        int64_t rb = uf_find(parent, dst[e]);
        if (ra == rb) continue;
        if (size[ra] < size[rb]) std::swap(ra, rb);
        parent[rb] = ra;
        size[ra] += size[rb];
    }
    std::vector<int64_t> remap(n, -1);
    int64_t next = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = uf_find(parent, i);
        if (remap[r] < 0) remap[r] = next++;
        labels[i] = remap[r];
    }
    return next;
}

// ---------------------------------------------------------------------
// Graph symmetrization (undirected union, min-distance dedup).
// Two-phase: phase 1 computes per-row output degrees (excluding the self
// slot), phase 2 fills padded [n, max_deg + 1] outputs with the self edge
// first and the rest sorted ascending by distance.
// (Reference semantics: GraphUtils.cpp symmetrizeGraph.)
// ---------------------------------------------------------------------

struct Edge { int64_t a, b; float d; };

// thread_local: ctypes releases the GIL, so concurrent symmetrize calls on
// different threads must not share (or race on) one edge cache.
static std::vector<Edge>& cached_edges() {
    thread_local std::vector<Edge> edges;
    return edges;
}

// fingerprint of the graph the cache was built from (guards against a
// fill call ever consuming edges from a different degrees call; within a
// thread the Python wrapper always pairs degrees+fill back-to-back)
static int64_t& cached_n() { thread_local int64_t v = -1; return v; }
static int64_t& cached_k() { thread_local int64_t v = -1; return v; }

// Returns false when a neighbor id is outside [0, n) (malformed padded
// graph) so callers can fall back instead of corrupting memory.
static bool collect_canonical_edges(int64_t n, int64_t k,
                                    const int32_t* indices,
                                    const float* distances,
                                    std::vector<Edge>& out) {
    out.clear();
    out.reserve(static_cast<size_t>(n) * k);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = indices + i * k;
        const float* drow = distances + i * k;
        for (int64_t j = 0; j < k; ++j) {
            int32_t t = row[j];
            if (t < 0 || t == i) continue;
            if (t >= n) { out.clear(); return false; }
            Edge e;
            e.a = std::min<int64_t>(i, t);
            e.b = std::max<int64_t>(i, t);
            e.d = drow[j];
            out.push_back(e);
        }
    }
    std::sort(out.begin(), out.end(), [](const Edge& x, const Edge& y) {
        if (x.a != y.a) return x.a < y.a;
        if (x.b != y.b) return x.b < y.b;
        return x.d < y.d;
    });
    // dedup keeping min distance (list sorted so first of each (a,b) wins)
    size_t w = 0;
    for (size_t r = 0; r < out.size(); ++r) {
        if (w > 0 && out[w - 1].a == out[r].a && out[w - 1].b == out[r].b)
            continue;
        out[w++] = out[r];
    }
    out.resize(w);
    return true;
}

// Phase 1: returns max degree, or -1 on out-of-domain neighbor ids;
// writes degrees[n] (neighbor counts excluding self).
int64_t symmetrize_degrees(int64_t n, int64_t k, const int32_t* indices,
                           const float* distances, int64_t* degrees) {
    // Phase 1 caches the sorted, deduped edge list for the immediately
    // following symmetrize_fill call (the wrapper always pairs them);
    // avoids collecting + sorting the edges twice.
    std::vector<Edge>& edges = cached_edges();
    if (!collect_canonical_edges(n, k, indices, distances, edges)) {
        cached_n() = -1;
        cached_k() = -1;
        return -1;
    }
    cached_n() = n;
    cached_k() = k;
    std::memset(degrees, 0, sizeof(int64_t) * n);
    for (const Edge& e : edges) {
        degrees[e.a]++;
        degrees[e.b]++;
    }
    int64_t mx = 0;
    for (int64_t i = 0; i < n; ++i) mx = std::max(mx, degrees[i]);
    return mx;
}

// Phase 2: fills out_idx/out_dist of shape [n, width] (width >= max_deg+1
// or the caller's cap) with self first, neighbors ascending by distance,
// pads at -1/+inf.
void symmetrize_fill(int64_t n, int64_t k, const int32_t* indices,
                     const float* distances, int64_t width,
                     int32_t* out_idx, float* out_dist,
                     int32_t* out_counts) {
    std::vector<Edge>& edges = cached_edges();
    if (edges.empty() || cached_n() != n || cached_k() != k) {
        if (!collect_canonical_edges(n, k, indices, distances, edges)) {
            // malformed input: emit an all-pad result rather than OOB reads
            // (the wrapper rejects via symmetrize_degrees before this)
            const float inf = std::numeric_limits<float>::infinity();
            for (int64_t i = 0; i < n; ++i) {
                int32_t* oi = out_idx + i * width;
                float* od = out_dist + i * width;
                oi[0] = static_cast<int32_t>(i);
                od[0] = 0.0f;
                for (int64_t j = 1; j < width; ++j) {
                    oi[j] = -1;
                    od[j] = inf;
                }
                out_counts[i] = 1;
            }
            cached_n() = -1;
            cached_k() = -1;
            return;
        }
    }
    cached_n() = -1;
    cached_k() = -1;

    // flat counting-sort layout by row (no per-row vectors)
    std::vector<int64_t> deg(static_cast<size_t>(n), 0);
    for (const Edge& e : edges) { deg[e.a]++; deg[e.b]++; }
    std::vector<int64_t> off(static_cast<size_t>(n) + 1, 0);
    for (int64_t i = 0; i < n; ++i) off[i + 1] = off[i] + deg[i];
    struct DC { float d; int32_t c; };
    std::vector<DC> flat(static_cast<size_t>(off[n]));
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (const Edge& e : edges) {
        flat[cur[e.a]++] = {e.d, static_cast<int32_t>(e.b)};
        flat[cur[e.b]++] = {e.d, static_cast<int32_t>(e.a)};
    }
    edges.clear();
    edges.shrink_to_fit();

    const float inf = std::numeric_limits<float>::infinity();
    for (int64_t i = 0; i < n; ++i) {
        int32_t* oi = out_idx + i * width;
        float* od = out_dist + i * width;
        DC* lo = flat.data() + off[i];
        DC* hi = flat.data() + off[i + 1];
        std::sort(lo, hi, [](const DC& x, const DC& y) {
            return x.d < y.d || (x.d == y.d && x.c < y.c);
        });
        oi[0] = static_cast<int32_t>(i);
        od[0] = 0.0f;
        int64_t c = std::min<int64_t>(hi - lo, width - 1);
        for (int64_t j = 0; j < c; ++j) {
            oi[1 + j] = lo[j].c;
            od[1 + j] = lo[j].d;
        }
        for (int64_t j = 1 + c; j < width; ++j) { oi[j] = -1; od[j] = inf; }
        out_counts[i] = static_cast<int32_t>(1 + c);
    }
}

// ---------------------------------------------------------------------
// Ragged -> padded packing of grouped (row, col, value) triples that are
// already sorted by row (the inner step of the sparse merges).
// ---------------------------------------------------------------------

void pack_rows(int64_t m, const int64_t* rows, const int32_t* cols,
               const float* vals, int64_t n, int64_t width,
               int32_t* out_idx, float* out_val) {
    for (int64_t i = 0; i < n * width; ++i) { out_idx[i] = -1; }
    std::memset(out_val, 0, sizeof(float) * n * width);
    int64_t pos = 0;
    for (int64_t r = 0; r < n && pos < m; ++r) {
        int64_t slot = 0;
        while (pos < m && rows[pos] == r) {
            if (slot < width) {
                out_idx[r * width + slot] = cols[pos];
                out_val[r * width + slot] = vals[pos];
                ++slot;
            }
            ++pos;
        }
    }
}

// ---------------------------------------------------------------------
// LSD radix argsort of non-negative int64 keys (the global sort inside
// the sparse merges; replaces numpy's introsort at ~3-4x throughput).
// 11-bit digits; passes above the key range are skipped.
// ---------------------------------------------------------------------

void argsort_i64(const int64_t* keys, int64_t n, int64_t* out_order) {
    if (n <= 0) return;
    int64_t maxk = 0;
    for (int64_t i = 0; i < n; ++i)
        if (keys[i] > maxk) maxk = keys[i];
    int idx_bits = 1;
    while ((int64_t(1) << idx_bits) < n) ++idx_bits;
    // composite = key << idx_bits | index -- sorting composites sorts by
    // (key, index), i.e. a stable argsort, with fully sequential radix
    // passes (no random gathers).  Fall back to std::sort if it overflows.
    bool fits = (maxk <= (std::numeric_limits<int64_t>::max() >> idx_bits));
    std::vector<uint64_t> a(static_cast<size_t>(n));
    if (fits) {
        const uint64_t idx_mask = (uint64_t(1) << idx_bits) - 1;
        for (int64_t i = 0; i < n; ++i)
            a[i] = (static_cast<uint64_t>(keys[i]) << idx_bits)
                   | static_cast<uint64_t>(i);
        uint64_t maxc = (static_cast<uint64_t>(maxk) << idx_bits) | idx_mask;
        const int bits = 11;
        const int64_t radix = int64_t(1) << bits;
        const uint64_t mask = radix - 1;
        std::vector<uint64_t> tmp(static_cast<size_t>(n));
        std::vector<int64_t> count(static_cast<size_t>(radix));
        uint64_t* src = a.data();
        uint64_t* dst = tmp.data();
        for (int shift = 0; (maxc >> shift) != 0; shift += bits) {
            std::fill(count.begin(), count.end(), 0);
            for (int64_t i = 0; i < n; ++i)
                ++count[(src[i] >> shift) & mask];
            int64_t sum = 0;
            for (int64_t d = 0; d < radix; ++d) {
                int64_t c = count[d];
                count[d] = sum;
                sum += c;
            }
            for (int64_t i = 0; i < n; ++i)
                dst[count[(src[i] >> shift) & mask]++] = src[i];
            std::swap(src, dst);
        }
        for (int64_t i = 0; i < n; ++i)
            out_order[i] = static_cast<int64_t>(src[i] & idx_mask);
    } else {
        for (int64_t i = 0; i < n; ++i)
            a[i] = static_cast<uint64_t>(i);
        std::stable_sort(a.begin(), a.end(),
                         [keys](uint64_t x, uint64_t y) {
                             return keys[x] < keys[y];
                         });
        for (int64_t i = 0; i < n; ++i)
            out_order[i] = static_cast<int64_t>(a[i]);
    }
}

// ---------------------------------------------------------------------
// Full sparse merge accumulation (the hot host op of the hierarchy):
// extract non-pad entries, key = parent_row * num_merged + parent_col,
// stable LSD radix on (key, weighted value) pairs, segment-sum in key
// order (bit-identical to numpy reduceat over the same stable order),
// divide by merged weights.  Returns the number of unique (row, col)
// entries written to out_*, or -1 when the key range would overflow
// (caller falls back to the numpy path).
// ---------------------------------------------------------------------

int64_t merge_sum(int64_t n, int64_t r, const int32_t* idx,
                  const float* val, const int64_t* parents,
                  int64_t num_merged, int weight_by_size,
                  int64_t* out_rows, int32_t* out_cols, float* out_vals) {
    if (num_merged <= 0) return 0;
    if (num_merged > (int64_t(1) << 31)) return -1;
    // overflow guard: key < num_merged^2 must fit int64
    long double maxkey = (long double)num_merged * num_merged;
    if (maxkey >= 9.2e18L) return -1;
    for (int64_t i = 0; i < n; ++i)
        if (parents[i] < 0 || parents[i] >= num_merged) return -1;

    struct KV { uint64_t k; float v; };
    std::vector<KV> kv;
    kv.reserve(static_cast<size_t>(n) * r / 2);

    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = idx + i * r;
        const float* vrow = val + i * r;
        float w = 1.0f;
        if (weight_by_size) {
            int64_t nnz = 0;
            for (int64_t j = 0; j < r; ++j)
                if (row[j] >= 0 && vrow[j] != 0.0f) ++nnz;
            w = static_cast<float>(nnz);
        }
        const uint64_t prow = static_cast<uint64_t>(parents[i])
                              * static_cast<uint64_t>(num_merged);
        for (int64_t j = 0; j < r; ++j) {
            if (row[j] < 0 || vrow[j] == 0.0f) continue;
            if (row[j] >= n) return -1;  // column outside parents domain
            KV e;
            e.k = prow + static_cast<uint64_t>(parents[row[j]]);
            e.v = vrow[j] * w;
            kv.push_back(e);
        }
    }
    const int64_t m = static_cast<int64_t>(kv.size());
    if (m == 0) return 0;

    // stable LSD radix on k (11-bit digits)
    uint64_t maxk = 0;
    for (const KV& e : kv) maxk = std::max(maxk, e.k);
    {
        const int bits = 11;
        const int64_t radix = int64_t(1) << bits;
        const uint64_t mask = radix - 1;
        std::vector<KV> tmp(kv.size());
        std::vector<int64_t> count(static_cast<size_t>(radix));
        KV* src = kv.data();
        KV* dst = tmp.data();
        for (int shift = 0; (maxk >> shift) != 0; shift += bits) {
            std::fill(count.begin(), count.end(), 0);
            for (int64_t i = 0; i < m; ++i)
                ++count[(src[i].k >> shift) & mask];
            int64_t sum = 0;
            for (int64_t d = 0; d < radix; ++d) {
                int64_t c = count[d];
                count[d] = sum;
                sum += c;
            }
            for (int64_t i = 0; i < m; ++i)
                dst[count[(src[i].k >> shift) & mask]++] = src[i];
            std::swap(src, dst);
        }
        if (src != kv.data())
            std::memcpy(kv.data(), src, sizeof(KV) * m);
    }

    // merged weights per parent
    std::vector<float> merged_w;
    if (weight_by_size) {
        merged_w.assign(static_cast<size_t>(num_merged), 0.0f);
        for (int64_t i = 0; i < n; ++i) {
            const int32_t* row = idx + i * r;
            const float* vrow = val + i * r;
            int64_t nnz = 0;
            for (int64_t j = 0; j < r; ++j)
                if (row[j] >= 0 && vrow[j] != 0.0f) ++nnz;
            merged_w[parents[i]] += static_cast<float>(nnz);
        }
    }

    // segment sums in stable key order (matches np.add.reduceat f32 order)
    int64_t out = 0;
    int64_t i = 0;
    while (i < m) {
        const uint64_t k = kv[i].k;
        float s = 0.0f;
        while (i < m && kv[i].k == k) { s += kv[i].v; ++i; }
        const int64_t prow = static_cast<int64_t>(
            k / static_cast<uint64_t>(num_merged));
        const int64_t pcol = static_cast<int64_t>(
            k % static_cast<uint64_t>(num_merged));
        if (weight_by_size) {
            float mw = merged_w[prow];
            s /= (mw > 1.0f ? mw : 1.0f);
        }
        out_rows[out] = prow;
        out_cols[out] = static_cast<int32_t>(pcol);
        out_vals[out] = s;
        ++out;
    }
    return out;
}

// Min-distance variant of merge_sum (mergeNodesDataDistances semantics:
// duplicate merged entries keep the smallest value).
int64_t merge_min(int64_t n, int64_t r, const int32_t* idx,
                  const float* val, const int64_t* parents,
                  int64_t num_merged,
                  int64_t* out_rows, int32_t* out_cols, float* out_vals) {
    if (num_merged <= 0) return 0;
    if (num_merged > (int64_t(1) << 31)) return -1;
    long double maxkey = (long double)num_merged * num_merged;
    if (maxkey >= 9.2e18L) return -1;
    for (int64_t i = 0; i < n; ++i)
        if (parents[i] < 0 || parents[i] >= num_merged) return -1;

    struct KV { uint64_t k; float v; };
    std::vector<KV> kv;
    kv.reserve(static_cast<size_t>(n) * r / 2);
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = idx + i * r;
        const float* vrow = val + i * r;
        const uint64_t prow = static_cast<uint64_t>(parents[i])
                              * static_cast<uint64_t>(num_merged);
        for (int64_t j = 0; j < r; ++j) {
            if (row[j] < 0 || vrow[j] == 0.0f) continue;
            if (row[j] >= n) return -1;  // column outside parents domain
            kv.push_back({prow + static_cast<uint64_t>(parents[row[j]]),
                          vrow[j]});
        }
    }
    const int64_t m = static_cast<int64_t>(kv.size());
    if (m == 0) return 0;
    uint64_t maxk = 0;
    for (const KV& e : kv) maxk = std::max(maxk, e.k);
    {
        const int bits = 11;
        const int64_t radix = int64_t(1) << bits;
        const uint64_t mask = radix - 1;
        std::vector<KV> tmp(kv.size());
        std::vector<int64_t> count(static_cast<size_t>(radix));
        KV* src = kv.data();
        KV* dst = tmp.data();
        for (int shift = 0; (maxk >> shift) != 0; shift += bits) {
            std::fill(count.begin(), count.end(), 0);
            for (int64_t i = 0; i < m; ++i)
                ++count[(src[i].k >> shift) & mask];
            int64_t sum = 0;
            for (int64_t d = 0; d < radix; ++d) {
                int64_t c = count[d];
                count[d] = sum;
                sum += c;
            }
            for (int64_t i = 0; i < m; ++i)
                dst[count[(src[i].k >> shift) & mask]++] = src[i];
            std::swap(src, dst);
        }
        if (src != kv.data())
            std::memcpy(kv.data(), src, sizeof(KV) * m);
    }
    int64_t out = 0;
    int64_t i = 0;
    while (i < m) {
        const uint64_t k = kv[i].k;
        float mn = kv[i].v;
        ++i;
        while (i < m && kv[i].k == k) {
            mn = std::min(mn, kv[i].v);
            ++i;
        }
        out_rows[out] = static_cast<int64_t>(
            k / static_cast<uint64_t>(num_merged));
        out_cols[out] = static_cast<int32_t>(
            k % static_cast<uint64_t>(num_merged));
        out_vals[out] = mn;
        ++out;
    }
    return out;
}

// ---------------------------------------------------------------------
// Sequential UMAP layout optimizer — the ground-truth oracle for the
// batched-epoch SGD in models/umap.py.  Faithful to the sequential
// semantics of the reference's umappp optimizer (EmbedUmap.cpp:233-269
// runs umappp's per-edge epoch loop; umap-learn's
// optimize_layout_euclidean has identical update rules): edges visited in
// order, per-edge epochs_per_sample schedule, move_other on the
// attractive pair, a scheduled number of negative samples per visit,
// gradient clip at +-4, linear alpha decay.  RNG is a SplitMix64-style
// mixer so results are reproducible across platforms.
// ---------------------------------------------------------------------

static inline uint64_t mix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

// emb: [n, 2] updated in place.  Edges (src, dst, eps=epochs_per_sample)
// must cover both directions (symmetric membership rows).
void umap_sequential(int64_t n, float* emb, int64_t m,
                     const int32_t* src, const int32_t* dst,
                     const float* eps, int64_t n_epochs, float a, float b,
                     float initial_alpha, int64_t neg_rate,
                     uint64_t seed) {
    std::vector<double> next_sample(eps, eps + m);
    std::vector<double> next_neg(m);
    std::vector<double> eps_neg(m);
    for (int64_t i = 0; i < m; ++i) {
        eps_neg[i] = eps[i] / static_cast<double>(neg_rate);
        next_neg[i] = eps_neg[i];
    }
    uint64_t rng = seed ? seed : 0x8a5cd789635d2dffULL;
    for (int64_t epoch = 0; epoch < n_epochs; ++epoch) {
        const float alpha = initial_alpha
            * (1.0f - static_cast<float>(epoch)
               / static_cast<float>(n_epochs));
        for (int64_t i = 0; i < m; ++i) {
            if (next_sample[i] > epoch) continue;
            const int64_t j = src[i];
            const int64_t k = dst[i];
            float* cur = emb + 2 * j;
            float* oth = emb + 2 * k;
            float dx = cur[0] - oth[0];
            float dy = cur[1] - oth[1];
            float d2 = dx * dx + dy * dy;
            if (d2 > 0.0f) {
                const float gc = (-2.0f * a * b * std::pow(d2, b - 1.0f))
                    / (a * std::pow(d2, b) + 1.0f);
                float gx = std::min(std::max(gc * dx, -4.0f), 4.0f);
                float gy = std::min(std::max(gc * dy, -4.0f), 4.0f);
                cur[0] += alpha * gx;
                cur[1] += alpha * gy;
                oth[0] -= alpha * gx;
                oth[1] -= alpha * gy;
            }
            next_sample[i] += eps[i];
            // umap-learn: int((epoch - epoch_of_next_negative_sample)
            //                  / epochs_per_negative_sample) — no +1
            const int64_t n_neg = static_cast<int64_t>(
                (epoch - next_neg[i]) / eps_neg[i]);
            for (int64_t p = 0; p < n_neg; ++p) {
                rng = mix64(rng);
                const int64_t t = static_cast<int64_t>(
                    rng % static_cast<uint64_t>(n));
                if (t == j) continue;
                const float* yn = emb + 2 * t;
                dx = cur[0] - yn[0];
                dy = cur[1] - yn[1];
                d2 = dx * dx + dy * dy;
                float gx;
                float gy;
                if (d2 > 0.0f) {
                    const float gc = (2.0f * b)
                        / ((0.001f + d2) * (a * std::pow(d2, b) + 1.0f));
                    gx = std::min(std::max(gc * dx, -4.0f), 4.0f);
                    gy = std::min(std::max(gc * dy, -4.0f), 4.0f);
                } else {
                    gx = 4.0f;
                    gy = 4.0f;
                }
                cur[0] += alpha * gx;
                cur[1] += alpha * gy;
            }
            next_neg[i] += n_neg * eps_neg[i];
        }
    }
}

// ---------------------------------------------------------------------
// LZ4 block-format codec — original implementation of the public block
// spec.  The reference LZ4-compresses every cache payload
// (sph/utils/FileIO.hpp:207-292 writeCompressedVecToBinaryBatches); this
// backs sph_tpu/utils/fileio.py.  Greedy matcher: 4-byte hashes into a
// 2^16-entry table, 16-bit offsets, spec end conditions (matches must
// not start within the last 12 bytes; the final 5+ bytes are literals).
// ---------------------------------------------------------------------

static inline uint32_t lz4_read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> 16;  // top 16 bits
}

// Worst-case compressed size for n input bytes.
int64_t lz4_compress_bound(int64_t n) {
    return n + n / 255 + 16;
}

// Compress src[0..n) into dst[0..cap); returns compressed size or -1 if
// dst is too small (callers size dst with lz4_compress_bound).
int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                     int64_t cap) {
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    const uint8_t* anchor = src;

    auto emit = [&](const uint8_t* lit, int64_t lit_len, int64_t off,
                    int64_t mlen) -> bool {
        // token + worst-case extended lengths + literals + offset
        int64_t need = 1 + lit_len / 255 + 1 + lit_len + 2
            + (mlen >= 0 ? mlen / 255 + 1 : 0);
        if (op + need > oend) return false;
        uint8_t* token = op++;
        if (lit_len >= 15) {
            *token = 15 << 4;
            int64_t rest = lit_len - 15;
            while (rest >= 255) { *op++ = 255; rest -= 255; }
            *op++ = static_cast<uint8_t>(rest);
        } else {
            *token = static_cast<uint8_t>(lit_len << 4);
        }
        std::memcpy(op, lit, static_cast<size_t>(lit_len));
        op += lit_len;
        if (mlen < 0) return true;  // final literal-only sequence
        *op++ = static_cast<uint8_t>(off & 0xff);
        *op++ = static_cast<uint8_t>((off >> 8) & 0xff);
        int64_t mtok = mlen - 4;  // minmatch = 4
        if (mtok >= 15) {
            *token |= 15;
            int64_t rest = mtok - 15;
            while (rest >= 255) { *op++ = 255; rest -= 255; }
            *op++ = static_cast<uint8_t>(rest);
        } else {
            *token |= static_cast<uint8_t>(mtok);
        }
        return true;
    };

    if (n >= 13) {  // below this everything is one literal run anyway
        const uint8_t* ip = src;
        const uint8_t* const mflimit = src + n - 12;   // last match start
        const uint8_t* const matchlimit = src + n - 5;  // last match byte
        std::vector<int32_t> table(1u << 16, -1);
        ip++;  // first byte can never match (no earlier data)
        while (ip < mflimit) {
            const uint32_t h = lz4_hash(lz4_read32(ip));
            const int32_t cand = table[h];
            table[h] = static_cast<int32_t>(ip - src);
            if (cand >= 0 && (ip - src) - cand <= 65535
                && lz4_read32(src + cand) == lz4_read32(ip)) {
                // extend backward over free literals
                const uint8_t* mp = src + cand;
                while (ip > anchor && mp > src && ip[-1] == mp[-1]) {
                    --ip;
                    --mp;
                }
                int64_t mlen = 4;
                while (ip + mlen < matchlimit && ip[mlen] == mp[mlen]) {
                    ++mlen;
                }
                if (!emit(anchor, ip - anchor, ip - mp, mlen)) return -1;
                ip += mlen;
                anchor = ip;
            } else {
                ++ip;
            }
        }
    }
    if (!emit(anchor, (src + n) - anchor, 0, -1)) return -1;
    return op - dst;
}

// Decompress src[0..n) into dst[0..cap); returns decompressed size or -1
// on malformed input (strict bounds checks — never reads/writes OOB).
int64_t lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;

    auto read_len = [&](int64_t base) -> int64_t {
        int64_t len = base;
        if (base == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                len += b;
            } while (b == 255);
        }
        return len;
    };

    while (ip < iend) {
        const uint8_t token = *ip++;
        int64_t lit = read_len(token >> 4);
        if (lit < 0 || ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, static_cast<size_t>(lit));
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // final literal-only sequence
        if (ip + 2 > iend) return -1;
        const int64_t off = ip[0] | (static_cast<int64_t>(ip[1]) << 8);
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = read_len(token & 15);
        if (mlen < 0) return -1;
        mlen += 4;
        if (op + mlen > oend) return -1;
        const uint8_t* mp = op - off;
        for (int64_t i = 0; i < mlen; ++i) op[i] = mp[i];  // may overlap
        op += mlen;
    }
    return op - dst;
}

}  // extern "C"
