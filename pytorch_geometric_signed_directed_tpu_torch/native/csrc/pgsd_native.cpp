// Native data-loading tier: fast signed edge-list parsing + coalescing.
//
// The reference parses CSV edge lists line-by-line in Python with a dict
// node map (torch_geometric_signed_directed/data/signed/SDGNN_real_data.py:
// 66-99) — fine for bitcoin-scale files, slow for slashdot/epinions
// (500k-700k lines).  This single-pass parser memory-maps the file,
// interns node ids, and emits int64/float32 arrays ready for the COO
// builders.  Exposed over a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC pgsd_native.cpp -o libpgsd_native.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

struct EdgeList {
    std::vector<int64_t> rows;
    std::vector<int64_t> cols;
    std::vector<float> weights;
    std::vector<std::string> names;  // node id -> original string
    int64_t num_nodes;
};

// ---------- CSV parsing ----------

void* pgsd_parse_csv(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf(size, '\0');
    if (size > 0 && std::fread(&buf[0], 1, size, f) != (size_t)size) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);

    auto* out = new EdgeList();
    out->rows.reserve(1 << 16);
    std::unordered_map<std::string, int64_t> node_map;
    node_map.reserve(1 << 16);

    const char* p = buf.data();
    const char* end = p + buf.size();
    std::string tok_a, tok_b;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        // split on first two commas
        const char* c1 = (const char*)memchr(p, ',', line_end - p);
        if (c1) {
            const char* c2 =
                (const char*)memchr(c1 + 1, ',', line_end - (c1 + 1));
            if (c2) {
                tok_a.assign(p, c1 - p);
                tok_b.assign(c1 + 1, c2 - (c1 + 1));
                // trim trailing \r from weight token implicitly via strtof
                float w = std::strtof(c2 + 1, nullptr);
                auto ins_a = node_map.emplace(tok_a, (int64_t)node_map.size());
                if (ins_a.second) out->names.push_back(tok_a);
                auto ins_b = node_map.emplace(tok_b, (int64_t)node_map.size());
                if (ins_b.second) out->names.push_back(tok_b);
                out->rows.push_back(ins_a.first->second);
                out->cols.push_back(ins_b.first->second);
                out->weights.push_back(w);
            }
        }
        p = line_end + 1;
    }
    out->num_nodes = (int64_t)node_map.size();
    return out;
}

int64_t pgsd_num_edges(void* h) {
    return h ? (int64_t)((EdgeList*)h)->rows.size() : -1;
}

int64_t pgsd_num_nodes(void* h) {
    return h ? ((EdgeList*)h)->num_nodes : -1;
}

void pgsd_fill(void* h, int64_t* rows, int64_t* cols, float* weights) {
    auto* e = (EdgeList*)h;
    std::memcpy(rows, e->rows.data(), e->rows.size() * sizeof(int64_t));
    std::memcpy(cols, e->cols.data(), e->cols.size() * sizeof(int64_t));
    std::memcpy(weights, e->weights.data(),
                e->weights.size() * sizeof(float));
}

// Write the node-name map as "name\tindex" lines; returns bytes needed
// when dst == nullptr.
int64_t pgsd_name_map(void* h, char* dst, int64_t cap) {
    auto* e = (EdgeList*)h;
    int64_t need = 0;
    for (size_t i = 0; i < e->names.size(); ++i)
        need += (int64_t)e->names[i].size() + 2 + 20;
    if (!dst) return need;
    char* q = dst;
    for (size_t i = 0; i < e->names.size(); ++i) {
        int wrote = std::snprintf(q, cap - (q - dst), "%s\t%zu\n",
                                  e->names[i].c_str(), i);
        q += wrote;
    }
    return q - dst;
}

void pgsd_free(void* h) { delete (EdgeList*)h; }

// ---------- coalesce: sort by (row, col), sum duplicate weights ----------

int64_t pgsd_coalesce(int64_t* rows, int64_t* cols, float* weights,
                      int64_t n, int64_t num_cols) {
    if (n == 0) return 0;
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return rows[a] != rows[b] ? rows[a] < rows[b] : cols[a] < cols[b];
    });
    std::vector<int64_t> r(n), c(n);
    std::vector<float> w(n);
    for (int64_t i = 0; i < n; ++i) {
        r[i] = rows[order[i]];
        c[i] = cols[order[i]];
        w[i] = weights[order[i]];
    }
    int64_t out = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (out > 0 && r[i] == rows[out - 1] && c[i] == cols[out - 1]) {
            weights[out - 1] += w[i];
        } else {
            rows[out] = r[i];
            cols[out] = c[i];
            weights[out] = w[i];
            ++out;
        }
    }
    return out;
}


// ---------- stable radix argsort (uint64 keys) ----------
//
// numpy's stable argsort (mergesort) on 16-32M int64 keys is the
// dominant cost of scatter-plan construction and edge coalescing at
// WikiTalk scale (SURVEY.md §6 workloads).  LSD radix with 11-bit
// digits is stable, O(passes * n), and bandwidth-bound: ~20x numpy on
// this image's cores.  Passes stop at the key's actual bit width.

namespace {

constexpr int RADIX_BITS = 11;
constexpr int RADIX_BUCKETS = 1 << RADIX_BITS;

// One stable LSD pass over [0, n), parallelized by contiguous thread
// ranges: per-thread digit histograms, then global offsets laid out
// digit-major / thread-minor (which preserves stability), then each
// thread scatters its own range in order.
void radix_pass_mt(const uint64_t* src_k, const int64_t* src_p,
                   uint64_t* dst_k, int64_t* dst_p, int64_t n, int shift,
                   int nthreads) {
    const int T = nthreads;
    std::vector<std::vector<int64_t>> hist(T,
        std::vector<int64_t>(RADIX_BUCKETS, 0));
    auto range = [&](int t) {
        int64_t lo = n * t / T, hi = n * (t + 1) / T;
        return std::pair<int64_t, int64_t>(lo, hi);
    };
    auto count = [&](int t) {
        auto [lo, hi] = range(t);
        auto& h = hist[t];
        for (int64_t i = lo; i < hi; ++i)
            ++h[(src_k[i] >> shift) & (RADIX_BUCKETS - 1)];
    };
    {
        std::vector<std::thread> ts;
        for (int t = 1; t < T; ++t) ts.emplace_back(count, t);
        count(0);
        for (auto& th : ts) th.join();
    }
    int64_t acc = 0;
    for (int b = 0; b < RADIX_BUCKETS; ++b)
        for (int t = 0; t < T; ++t) {
            int64_t h = hist[t][b];
            hist[t][b] = acc;
            acc += h;
        }
    auto scatter = [&](int t) {
        auto [lo, hi] = range(t);
        auto& h = hist[t];
        for (int64_t i = lo; i < hi; ++i) {
            int64_t d = h[(src_k[i] >> shift) & (RADIX_BUCKETS - 1)]++;
            dst_k[d] = src_k[i];
            dst_p[d] = src_p[i];
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < T; ++t) ts.emplace_back(scatter, t);
    scatter(0);
    for (auto& th : ts) th.join();
}

// Stable radix argsort; also leaves the sorted keys in ka/kb.  Returns
// which buffer holds the result (true -> b).
bool radix_argsort(const uint64_t* keys, int64_t n,
                   std::vector<uint64_t>& ka, std::vector<uint64_t>& kb,
                   std::vector<int64_t>& pa, std::vector<int64_t>& pb) {
    uint64_t max_key = 0;
    for (int64_t i = 0; i < n; ++i)
        if (keys[i] > max_key) max_key = keys[i];
    ka.assign(keys, keys + n);
    kb.resize(n);
    pa.resize(n);
    pb.resize(n);
    for (int64_t i = 0; i < n; ++i) pa[i] = i;
    unsigned hw = std::thread::hardware_concurrency();
    int T = (n >= (1 << 21) && hw > 1) ? (int)std::min(hw, 4u) : 1;
    int shift = 0;
    bool flip = false;
    while (shift == 0 || (shift < 64 && (max_key >> shift) != 0)) {
        const uint64_t* src_k = flip ? kb.data() : ka.data();
        uint64_t* dst_k = flip ? ka.data() : kb.data();
        const int64_t* src_p = flip ? pb.data() : pa.data();
        int64_t* dst_p = flip ? pa.data() : pb.data();
        radix_pass_mt(src_k, src_p, dst_k, dst_p, n, shift, T);
        flip = !flip;
        shift += RADIX_BITS;
    }
    return flip;
}

}  // namespace

void pgsd_argsort_u64(const uint64_t* keys, int64_t n, int64_t* perm_out) {
    if (n <= 0) return;
    std::vector<uint64_t> ka, kb;
    std::vector<int64_t> pa, pb;
    bool flip = radix_argsort(keys, n, ka, kb, pa, pb);
    const int64_t* res = flip ? pb.data() : pa.data();
    std::memcpy(perm_out, res, n * sizeof(int64_t));
}

// ---------- fused multi-value coalesce ----------
//
// Sort-by-key + sum-duplicates over NV value arrays in one native call:
// the numpy pipeline (argsort -> per-value fancy gather -> reduceat)
// walks the edge list 1 + 2*NV times through int64 temporaries; this
// does one threaded radix argsort and a single accumulate pass.  keys
// are modified in place to the m unique sorted keys; values ([nv, n]
// row-major float64 — double accumulation matches the numpy pipeline's
// precision for Laplacian weights, original row stride n) are
// overwritten in their leading m entries with the per-run sums.
// Returns m.

// ---------- fused magnetic symmetrization ----------
//
// The magnetic Laplacian's symmetrization (spectral/magnetic._symmetrize)
// concatenates both edge directions (2E int64 keys + 3x 2E float64
// values), sorts, and sums duplicate runs — ~23s of numpy/native time at
// WikiTalk scale, dominated by materializing the doubled arrays.  This
// fuses the whole step: both-direction keys are built on the fly
// (self-loops skipped), one threaded radix argsort runs over them, and
// the accumulate pass derives each entry's (sym, theta, abs) contribution
// from its payload index alone — no value arrays are ever doubled.
//
//   sym[m]   = sum over both dirs of w        (caller halves)
//   theta[m] = sum of +w (forward) / -w (reverse)
//   abs[m]   = sum of |w|                     (caller halves)
//
// out_* must have capacity 2*e.  Returns the number m of unique (i, j)
// pairs (i != j), sorted by i*n + j.

int64_t pgsd_symmetrize(const int64_t* row, const int64_t* col,
                        const double* w, int64_t e, int64_t n,
                        int64_t* out_row, int64_t* out_col,
                        double* out_sym, double* out_theta,
                        double* out_abs) {
    if (e <= 0) return 0;
    std::vector<uint64_t> keys;
    std::vector<int64_t> pay;  // < e: forward edge i; >= e: reverse of i-e
    keys.reserve(2 * e);
    pay.reserve(2 * e);
    for (int64_t i = 0; i < e; ++i) {
        if (row[i] == col[i]) continue;
        keys.push_back((uint64_t)row[i] * (uint64_t)n + (uint64_t)col[i]);
        pay.push_back(i);
        keys.push_back((uint64_t)col[i] * (uint64_t)n + (uint64_t)row[i]);
        pay.push_back(i + e);
    }
    const int64_t n2 = (int64_t)keys.size();
    if (n2 == 0) return 0;
    std::vector<uint64_t> ka, kb;
    std::vector<int64_t> pa, pb;
    bool flip = radix_argsort(keys.data(), n2, ka, kb, pa, pb);
    const uint64_t* ks = flip ? kb.data() : ka.data();
    const int64_t* perm = flip ? pb.data() : pa.data();

    int64_t m = -1;
    for (int64_t i = 0; i < n2; ++i) {
        if (i == 0 || ks[i] != ks[i - 1]) {
            ++m;
            out_row[m] = (int64_t)(ks[i] / (uint64_t)n);
            out_col[m] = (int64_t)(ks[i] % (uint64_t)n);
            out_sym[m] = out_theta[m] = out_abs[m] = 0.0;
        }
        const int64_t p = pay[perm[i]];
        const bool fwd = p < e;
        const double x = w[fwd ? p : p - e];
        out_sym[m] += x;
        out_theta[m] += fwd ? x : -x;
        out_abs[m] += std::abs(x);
    }
    return m + 1;
}

// ---------- fused sym-normalized magnetic Laplacian ----------
//
// The full host build of the sym-normalized (signed) magnetic Laplacian
// (spectral/magnetic._laplacian_core, normalization="sym"): fused
// symmetrization (above) + weighted degree + D^-1/2 A D^-1/2 + phase
// cos/sin + the [sorted off-diagonal edges; N diagonal entries] layout
// the downstream -I merge expects.  The numpy pipeline pays ~5 separate
// 16M-row float64 passes (gathers, cos/sin, concats) after coalescing;
// this emits w_re/w_im in one threaded pass.
//
//   w_re[k] = -dis[i]*(sym/2)*dis[j] * cos(2*pi*q*theta);  diag = 1
//   w_im[k] = -dis[i]*(sym/2)*dis[j] * sin(2*pi*q*theta);  diag = 0
//
// deg_mode: 0 -> deg weights = sym/2 (unsigned); 1 -> (|w_ij|+|w_ji|)/2
// (signed, absolute_degree=True); 2 -> |sym/2| (signed, False).
// out_* need capacity 2*e + n.  Returns m (off-diagonal count); caller
// reads m + n entries.

int64_t pgsd_magnetic_sym_lap(const int64_t* row, const int64_t* col,
                              const double* w, int64_t e, int64_t n,
                              double q, int64_t deg_mode,
                              int64_t* out_row, int64_t* out_col,
                              double* out_wre, double* out_wim) {
    std::vector<double> sym(e > 0 ? 2 * e : 0), theta(e > 0 ? 2 * e : 0),
        absv(e > 0 ? 2 * e : 0);
    int64_t m = pgsd_symmetrize(row, col, w, e, n, out_row, out_col,
                                sym.data(), theta.data(), absv.data());
    std::vector<double> dis(n, 0.0);
    for (int64_t k = 0; k < m; ++k) {
        double dw = deg_mode == 0 ? sym[k] / 2.0
                  : deg_mode == 1 ? absv[k] / 2.0
                                  : std::abs(sym[k] / 2.0);
        dis[out_row[k]] += dw;
    }
    for (int64_t i = 0; i < n; ++i)
        dis[i] = dis[i] > 0.0 ? 1.0 / std::sqrt(dis[i]) : 0.0;

    const double two_pi_q = 2.0 * M_PI * q;
    unsigned hw = std::thread::hardware_concurrency();
    int T = (m >= (1 << 21) && hw > 1) ? (int)std::min(hw, 4u) : 1;
    auto work = [&](int t) {
        int64_t lo = m * t / T, hi = m * (t + 1) / T;
        for (int64_t k = lo; k < hi; ++k) {
            double nw = -dis[out_row[k]] * (sym[k] / 2.0) * dis[out_col[k]];
            double ang = two_pi_q * theta[k];
            out_wre[k] = nw * std::cos(ang);
            out_wim[k] = nw * std::sin(ang);
        }
    };
    {
        std::vector<std::thread> ts;
        for (int t = 1; t < T; ++t) ts.emplace_back(work, t);
        work(0);
        for (auto& th : ts) th.join();
    }
    for (int64_t i = 0; i < n; ++i) {
        out_row[m + i] = i;
        out_col[m + i] = i;
        out_wre[m + i] = 1.0;
        out_wim[m + i] = 0.0;
    }
    return m;
}

int64_t pgsd_coalesce_fused(uint64_t* keys, double* values, int64_t n,
                            int64_t nv) {
    if (n <= 0) return 0;
    std::vector<uint64_t> ka, kb;
    std::vector<int64_t> pa, pb;
    bool flip = radix_argsort(keys, n, ka, kb, pa, pb);
    const uint64_t* ks = flip ? kb.data() : ka.data();
    const int64_t* perm = flip ? pb.data() : pa.data();

    std::vector<double> sums((size_t)nv * n);
    int64_t m = -1;
    for (int64_t i = 0; i < n; ++i) {
        const bool fresh = (i == 0 || ks[i] != ks[i - 1]);
        if (fresh) {
            ++m;
            keys[m] = ks[i];
        }
        const int64_t src = perm[i];
        for (int64_t v = 0; v < nv; ++v) {
            double x = values[v * n + src];
            if (fresh)
                sums[v * n + m] = x;
            else
                sums[v * n + m] += x;
        }
    }
    ++m;
    for (int64_t v = 0; v < nv; ++v)
        std::memcpy(values + v * n, sums.data() + v * n,
                    m * sizeof(double));
    return m;
}

// ---------- fused scatter-plan layout ----------
//
// The MXU scatter plan (ops/pallas/scatter_mxu._build_plan_host) lays
// edges out grouped by destination window, each (window[, group]) bin
// padded to chunk multiples — hot/cold grouped plans order all group-0
// chunks before group-1.  The numpy pipeline costs ~20s (ungrouped) /
// ~46s (grouped) at WikiTalk scale (22M edges), dominated by the
// composite-key argsort and eight 22M-row gather/scatter passes.  This
// builds the identical layout natively: the final edge order is one
// stable radix argsort by key
//     k = grp * (num_windows * window) + row          (grp-major)
// (for ngrp=1, k = row), which equals the numpy path's row-sort +
// (window,group)-key sort + chunk reorder; then one threaded pass
// writes perm/lr/gr bin by bin.  Handle-based two-phase API because
// the padded total is only known after the histogram.

struct PlanHandle {
    std::vector<uint64_t> keys_sorted;   // plan-source order
    std::vector<int64_t> sortperm;       // plan-source -> original edge
    std::vector<int64_t> bin_start;      // per nonempty bin, in key order
    std::vector<int64_t> bin_count;
    std::vector<int64_t> bin_id;         // grp * num_windows + win
    std::vector<int64_t> bin_dst;        // padded dst offset per bin
    int64_t e, num_rows, window, chunk, ngrp, num_windows;
    int64_t total, num_chunks, hot_chunks;
    bool identity;                       // input already in key order
};

void* pgsd_plan_build(const int64_t* row, const int8_t* group, int64_t e,
                      int64_t num_rows, int64_t window, int64_t chunk,
                      int64_t ngrp) {
    auto* h = new PlanHandle();
    h->e = e;
    h->num_rows = num_rows;
    h->window = window;
    h->chunk = chunk;
    h->ngrp = ngrp;
    const int64_t nr = num_rows > 0 ? num_rows : 1;
    h->num_windows = (nr + window - 1) / window;
    const uint64_t W = (uint64_t)h->num_windows * (uint64_t)window;

    auto key_at = [&](int64_t i) -> uint64_t {
        uint64_t k = (uint64_t)row[i];
        if (ngrp == 2 && group[i]) k += W;
        return k;
    };

    bool sorted = true;
    for (int64_t i = 1; i < e; ++i)
        if (key_at(i) < key_at(i - 1)) { sorted = false; break; }
    bool sorted_by_row = sorted;
    if (!sorted && ngrp == 2) {
        sorted_by_row = true;
        for (int64_t i = 1; i < e; ++i)
            if (row[i] < row[i - 1]) { sorted_by_row = false; break; }
    }
    h->identity = sorted;
    if (sorted) {
        h->keys_sorted.resize(e);
        for (int64_t i = 0; i < e; ++i) h->keys_sorted[i] = key_at(i);
    } else if (ngrp == 2 && sorted_by_row) {
        // group-major order over a row-sorted stream is a STABLE 2-way
        // partition — one O(E) pass instead of a full radix sort (the
        // Laplacian builders always emit row-sorted edges, so this is
        // the hot/cold col-split plan's common case)
        int64_t n0 = 0;
        for (int64_t i = 0; i < e; ++i)
            if (!group[i]) ++n0;
        h->keys_sorted.resize(e);
        h->sortperm.resize(e);
        int64_t c0 = 0, c1 = n0;
        for (int64_t i = 0; i < e; ++i) {
            if (!group[i]) {
                h->sortperm[c0] = i;
                h->keys_sorted[c0++] = (uint64_t)row[i];
            } else {
                h->sortperm[c1] = i;
                h->keys_sorted[c1++] = (uint64_t)row[i] + W;
            }
        }
    } else {
        std::vector<uint64_t> keys(e);
        for (int64_t i = 0; i < e; ++i) keys[i] = key_at(i);
        std::vector<uint64_t> ka, kb;
        std::vector<int64_t> pa, pb;
        bool flip = radix_argsort(keys.data(), e, ka, kb, pa, pb);
        h->keys_sorted = flip ? std::move(kb) : std::move(ka);
        h->sortperm = flip ? std::move(pb) : std::move(pa);
    }

    // bin runs over the sorted keys (bins are non-decreasing)
    int64_t dst = 0, chunks = 0, hot = 0;
    for (int64_t i = 0; i < e;) {
        const uint64_t k = h->keys_sorted[i];
        const int64_t grp = (int64_t)(k / W);
        const int64_t win = (int64_t)((k - (uint64_t)grp * W)
                                      / (uint64_t)window);
        int64_t j = i + 1;
        const uint64_t lo = ((uint64_t)grp * W
                             + (uint64_t)win * (uint64_t)window);
        const uint64_t hi = lo + (uint64_t)window;
        while (j < e && h->keys_sorted[j] < hi) ++j;
        const int64_t c = j - i;
        const int64_t nch = (c + chunk - 1) / chunk;
        h->bin_start.push_back(i);
        h->bin_count.push_back(c);
        h->bin_id.push_back(grp * h->num_windows + win);
        h->bin_dst.push_back(dst);
        dst += nch * chunk;
        chunks += nch;
        if (grp == 0 && ngrp == 2) hot += nch;
        i = j;
    }
    h->total = dst;
    h->num_chunks = chunks;
    h->hot_chunks = (ngrp == 2) ? hot : 0;
    if (e == 0) {  // one dummy padding chunk, matching the numpy path
        h->total = chunk;
        h->num_chunks = 1;
    }
    return h;
}

int64_t pgsd_plan_total(void* hp) { return ((PlanHandle*)hp)->total; }
int64_t pgsd_plan_chunks(void* hp) {
    return ((PlanHandle*)hp)->num_chunks;
}
int64_t pgsd_plan_hot_chunks(void* hp) {
    return ((PlanHandle*)hp)->hot_chunks;
}

void pgsd_plan_fill(void* hp, int64_t* perm, int32_t* lr, int32_t* gr,
                    int32_t* win, uint8_t* visited) {
    auto* h = (PlanHandle*)hp;
    const int64_t window = h->window, chunk = h->chunk;
    const uint64_t W = (uint64_t)h->num_windows * (uint64_t)window;
    std::memset(visited, 0, h->num_windows);
    if (h->e == 0) {
        for (int64_t i = 0; i < chunk; ++i) {
            perm[i] = -1;
            lr[i] = (int32_t)window;
            gr[i] = (int32_t)h->num_rows;
        }
        win[0] = 0;
        return;
    }
    const int64_t nb = (int64_t)h->bin_start.size();
    // win ids + visited (cheap, sequential over ~num_windows bins)
    int64_t cpos = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const int64_t nch = (h->bin_count[b] + chunk - 1) / chunk;
        const int32_t w = (int32_t)(h->bin_id[b] % h->num_windows);
        visited[w] = 1;
        for (int64_t c = 0; c < nch; ++c) win[cpos++] = w;
    }
    unsigned hw = std::thread::hardware_concurrency();
    const int T = (h->e >= (1 << 21) && hw > 1) ? (int)std::min(hw, 4u)
                                                : 1;
    auto fill_range = [&](int t) {
        const int64_t b0 = nb * t / T, b1 = nb * (t + 1) / T;
        for (int64_t b = b0; b < b1; ++b) {
            const int64_t s = h->bin_start[b], c = h->bin_count[b];
            const int64_t d = h->bin_dst[b];
            const int64_t padded = ((c + chunk - 1) / chunk) * chunk;
            for (int64_t j = 0; j < c; ++j) {
                const uint64_t k = h->keys_sorted[s + j];
                const int64_t grp = (int64_t)(k / W);
                const int64_t r = (int64_t)(k - (uint64_t)grp * W);
                perm[d + j] = h->identity ? (s + j) : h->sortperm[s + j];
                lr[d + j] = (int32_t)(r % window);
                gr[d + j] = (int32_t)r;
            }
            for (int64_t j = c; j < padded; ++j) {
                perm[d + j] = -1;
                lr[d + j] = (int32_t)window;
                gr[d + j] = (int32_t)h->num_rows;
            }
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < T; ++t) ts.emplace_back(fill_range, t);
    fill_range(0);
    for (auto& th : ts) th.join();
}

void pgsd_plan_free(void* hp) { delete (PlanHandle*)hp; }

// ---------- windowed degree histogram (geometry selection) ----------
//
// _pick_geometry's finest-window histogram (bincount of
// (row >> 7) * ngrp + grp over the edge list) costs ~3s of numpy
// passes at 22M edges; one threaded pass here.

void pgsd_window_hist(const int64_t* row, const int8_t* grp, int64_t e,
                      int64_t nbins, int64_t ngrp, int64_t* out) {
    unsigned hw = std::thread::hardware_concurrency();
    const int T = (e >= (1 << 21) && hw > 1) ? (int)std::min(hw, 4u) : 1;
    std::vector<std::vector<int64_t>> partial(
        T, std::vector<int64_t>(nbins, 0));
    auto run = [&](int t) {
        const int64_t lo = e * t / T, hi = e * (t + 1) / T;
        auto& h = partial[t];
        if (ngrp == 2 && grp) {
            for (int64_t i = lo; i < hi; ++i) {
                int64_t b = (row[i] >> 7) * 2 + (grp[i] ? 1 : 0);
                if (b >= 0 && b < nbins) ++h[b];
            }
        } else {
            for (int64_t i = lo; i < hi; ++i) {
                int64_t b = row[i] >> 7;
                if (b >= 0 && b < nbins) ++h[b];
            }
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < T; ++t) ts.emplace_back(run, t);
    run(0);
    for (auto& th : ts) th.join();
    for (int64_t b = 0; b < nbins; ++b) {
        int64_t acc = 0;
        for (int t = 0; t < T; ++t) acc += partial[t][b];
        out[b] = acc;
    }
}

// ---------- threaded permute-gather ----------
//
// permute_edge_data's per-array numpy fancy gather (out[i] =
// src[perm[i]] with -1 -> 0) costs ~1.2s per 24M-row array; this is the
// same gather, threaded, for 4- and 8-byte elements.

void pgsd_permute_gather(const int64_t* perm, int64_t total,
                         const char* src, char* out, int64_t elem_size) {
    unsigned hw = std::thread::hardware_concurrency();
    const int T = (total >= (1 << 21) && hw > 1) ? (int)std::min(hw, 4u)
                                                 : 1;
    auto run = [&](int t) {
        const int64_t lo = total * t / T, hi = total * (t + 1) / T;
        if (elem_size == 4) {
            const uint32_t* s = (const uint32_t*)src;
            uint32_t* o = (uint32_t*)out;
            for (int64_t i = lo; i < hi; ++i)
                o[i] = perm[i] >= 0 ? s[perm[i]] : 0u;
        } else {
            const uint64_t* s = (const uint64_t*)src;
            uint64_t* o = (uint64_t*)out;
            for (int64_t i = lo; i < hi; ++i)
                o[i] = perm[i] >= 0 ? s[perm[i]] : 0ull;
        }
    };
    std::vector<std::thread> ts;
    for (int t = 1; t < T; ++t) ts.emplace_back(run, t);
    run(0);
    for (auto& th : ts) th.join();
}

}  // extern "C"
