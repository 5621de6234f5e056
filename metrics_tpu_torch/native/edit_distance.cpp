// Native edit-distance core for the text metrics.
//
// Replaces the host-side Python/numpy dynamic program behind
// WER/CER/MER/WIL/WIP (ref functional/text/helper.py:333-350 — there a pure
// Python DP). Tokens are mapped to int32 ids in Python (strings never cross
// the boundary); the O(n*m) DP runs here over two rolling rows.
//
// Built lazily by metrics_tpu/native/__init__.py with:
//   g++ -O3 -shared -fPIC -o _build/libeditdist.so edit_distance.cpp
// and loaded via ctypes. No Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// Per-order n-gram overlap between two int32 symbol streams: for each
// n in 1..max_order, matching[n-1] = sum over distinct n-grams g of
// min(count_a(g), count_b(g)) — exactly `sum((Counter_a & Counter_b)
// .values())` of the chrF algorithm (ref functional/text/chrf.py:213-260;
// the reference computes it with per-sentence Python Counters). Symbols
// are int32 ids mapped in Python (chars as unicode codepoints, words via
// a dict), so strings never cross the boundary.
//
// Exactness without per-gram byte keys: order-n grams are identified by
// RANK DOUBLING — order-1 ranks are dense ids of the symbols over both
// streams; each next order re-ranks the pair (rank_{n-1}(i),
// symbol(i+n-1)) through one shared u64-keyed map, so two windows get
// the same rank iff their symbol sequences are identical (no lossy
// hashing, no string allocations). Counts are then plain dense arrays.
void tm_ngram_overlap(const int32_t* a, int64_t na, const int32_t* b, int64_t nb,
                      int32_t max_order, double* matching) {
    for (int32_t n = 0; n < max_order; ++n) matching[n] = 0.0;
    if (na <= 0 || nb <= 0) return;

    // dense symbol ids shared across both streams
    std::unordered_map<int32_t, int32_t> sym_id;
    sym_id.reserve(static_cast<size_t>(na + nb));
    std::vector<int32_t> da(static_cast<size_t>(na)), db(static_cast<size_t>(nb));
    auto dense_sym = [&sym_id](int32_t s) {
        auto it = sym_id.emplace(s, static_cast<int32_t>(sym_id.size()));
        return it.first->second;
    };
    for (int64_t i = 0; i < na; ++i) da[static_cast<size_t>(i)] = dense_sym(a[i]);
    for (int64_t i = 0; i < nb; ++i) db[static_cast<size_t>(i)] = dense_sym(b[i]);

    // ra/rb[i] = rank of the order-n gram starting at i (valid for i < w)
    std::vector<int32_t> ra(da), rb(db);
    int64_t n_ranks = static_cast<int64_t>(sym_id.size());
    std::unordered_map<uint64_t, int32_t> pair_id;
    std::vector<int64_t> cnt;
    for (int32_t n = 1; n <= max_order; ++n) {
        const int64_t wa = na - n + 1;
        const int64_t wb = nb - n + 1;
        if (wa <= 0 || wb <= 0) break;  // longer orders only get shorter
        if (n > 1) {
            pair_id.clear();
            pair_id.reserve(static_cast<size_t>(wa + wb));
            auto extend = [&pair_id](int32_t prev_rank, int32_t sym) {
                const uint64_t key =
                    (static_cast<uint64_t>(static_cast<uint32_t>(prev_rank)) << 32) |
                    static_cast<uint32_t>(sym);
                auto it = pair_id.emplace(key, static_cast<int32_t>(pair_id.size()));
                return it.first->second;
            };
            for (int64_t i = 0; i < wa; ++i)
                ra[static_cast<size_t>(i)] =
                    extend(ra[static_cast<size_t>(i)], da[static_cast<size_t>(i + n - 1)]);
            for (int64_t i = 0; i < wb; ++i)
                rb[static_cast<size_t>(i)] =
                    extend(rb[static_cast<size_t>(i)], db[static_cast<size_t>(i + n - 1)]);
            n_ranks = static_cast<int64_t>(pair_id.size());
        }
        cnt.assign(static_cast<size_t>(n_ranks), 0);
        for (int64_t i = 0; i < wa; ++i) ++cnt[static_cast<size_t>(ra[static_cast<size_t>(i)])];
        int64_t m = 0;
        for (int64_t i = 0; i < wb; ++i) {
            int64_t& c = cnt[static_cast<size_t>(rb[static_cast<size_t>(i)])];
            if (c > 0) {
                --c;
                ++m;
            }
        }
        matching[n - 1] = static_cast<double>(m);
    }
}

// Longest-common-subsequence LENGTH between id sequences (rolling rows) —
// the ROUGE-L hot loop (ref functional/text/rouge.py computes it with a
// per-cell Python DP).
int64_t tm_lcs(const int32_t* a, int64_t n, const int32_t* b, int64_t m) {
    if (n == 0 || m == 0) return 0;
    std::vector<int64_t> prev(static_cast<size_t>(m) + 1, 0), cur(static_cast<size_t>(m) + 1, 0);
    for (int64_t i = 1; i <= n; ++i) {
        const int32_t ai = a[i - 1];
        cur[0] = 0;
        for (int64_t j = 1; j <= m; ++j) {
            if (ai == b[j - 1]) {
                cur[static_cast<size_t>(j)] = prev[static_cast<size_t>(j - 1)] + 1;
            } else {
                const int64_t up = prev[static_cast<size_t>(j)];
                const int64_t left = cur[static_cast<size_t>(j - 1)];
                cur[static_cast<size_t>(j)] = up > left ? up : left;
            }
        }
        std::swap(prev, cur);
    }
    return prev[static_cast<size_t>(m)];
}

// LCS of pred sentence p vs ref sentence r with backtracking; ORs the
// LCS-covered ref positions into `covered` (uint8, length m) — the
// union-LCS step of summary-level ROUGE-Lsum. The backtrack tie-breaking
// replicates the Python implementation exactly (match-with-diagonal
// first, else move i when dp[i-1][j] >= dp[i][j-1], else move j), so the
// covered sets — not just their sizes — are identical.
void tm_lcs_union_mark(const int32_t* p, int64_t n, const int32_t* r, int64_t m,
                       uint8_t* covered) {
    if (n == 0 || m == 0) return;
    const size_t stride = static_cast<size_t>(m) + 1;
    std::vector<int32_t> dp(static_cast<size_t>(n + 1) * stride, 0);
    for (int64_t i = 1; i <= n; ++i) {
        const int32_t pi = p[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            const size_t ij = static_cast<size_t>(i) * stride + static_cast<size_t>(j);
            if (pi == r[j - 1]) {
                dp[ij] = dp[ij - stride - 1] + 1;
            } else {
                const int32_t up = dp[ij - stride];
                const int32_t left = dp[ij - 1];
                dp[ij] = up > left ? up : left;
            }
        }
    }
    int64_t i = n, j = m;
    while (i > 0 && j > 0) {
        const size_t ij = static_cast<size_t>(i) * stride + static_cast<size_t>(j);
        if (p[i - 1] == r[j - 1] && dp[ij] == dp[ij - stride - 1] + 1) {
            covered[j - 1] = 1;
            --i;
            --j;
        } else if (dp[ij - stride] >= dp[ij - 1]) {
            --i;
        } else {
            --j;
        }
    }
}

// Levenshtein distance between id sequences a[0:n) and b[0:m).
int64_t tm_levenshtein(const int32_t* a, int64_t n, const int32_t* b, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    // iterate over the shorter sequence in the inner loop for cache locality
    if (m > n) {
        std::swap(a, b);
        std::swap(n, m);
    }
    std::vector<int64_t> row(static_cast<size_t>(m) + 1);
    for (int64_t j = 0; j <= m; ++j) row[static_cast<size_t>(j)] = j;
    for (int64_t i = 1; i <= n; ++i) {
        int64_t diag = row[0];  // row[i-1][j-1]
        row[0] = i;
        const int32_t ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            const int64_t up = row[static_cast<size_t>(j)];  // row[i-1][j]
            const int64_t sub = diag + (ai != b[j - 1] ? 1 : 0);
            const int64_t del = up + 1;
            const int64_t ins = row[static_cast<size_t>(j - 1)] + 1;
            row[static_cast<size_t>(j)] = std::min(sub, std::min(del, ins));
            diag = up;
        }
    }
    return row[static_cast<size_t>(m)];
}

// Extended Edit Distance (Stanchev et al., WMT 2019) over codepoint ids.
// Same CDER-grid-with-long-jumps dynamic program as the Python reference
// (metrics_tpu/functional/text/eed.py:_eed_function); hyp/ref are unicode
// codepoints, space_id marks word boundaries where long jumps are allowed.
double tm_eed(const int32_t* hyp, int64_t n, const int32_t* ref, int64_t m,
              int32_t space_id, double alpha, double rho, double deletion,
              double insertion) {
    const double INF = 1e300;
    std::vector<double> row(static_cast<size_t>(n) + 1, 1.0);
    std::vector<double> next_row(static_cast<size_t>(n) + 1);
    std::vector<int64_t> visits(static_cast<size_t>(n) + 1, -1);
    row[0] = 0.0;

    for (int64_t w = 1; w <= m; ++w) {
        const int32_t ref_char = ref[w - 1];
        next_row[0] = row[0] + 1.0;
        for (int64_t i = 1; i <= n; ++i) {
            const double sub = row[static_cast<size_t>(i - 1)] + (hyp[i - 1] != ref_char ? 1.0 : 0.0);
            const double ins = row[static_cast<size_t>(i)] + insertion;
            const double del = next_row[static_cast<size_t>(i - 1)] + deletion;
            const double base = sub < ins ? sub : ins;
            next_row[static_cast<size_t>(i)] = del < base ? del : base;
        }
        int64_t min_index = 0;
        double min_val = INF;
        for (int64_t i = 0; i <= n; ++i) {
            if (next_row[static_cast<size_t>(i)] < min_val) {
                min_val = next_row[static_cast<size_t>(i)];
                min_index = i;
            }
        }
        visits[static_cast<size_t>(min_index)] += 1;
        if (ref_char == space_id) {
            const double jump = alpha + min_val;
            for (int64_t i = 0; i <= n; ++i) {
                if (jump < next_row[static_cast<size_t>(i)]) next_row[static_cast<size_t>(i)] = jump;
            }
        }
        row.swap(next_row);
    }

    int64_t visit_sum = 0;
    for (int64_t i = 0; i <= n; ++i) visit_sum += visits[static_cast<size_t>(i)] >= 0 ? visits[static_cast<size_t>(i)] : 1;
    const double coverage = rho * static_cast<double>(visit_sum);
    const double score = (row[static_cast<size_t>(n)] + coverage) / (static_cast<double>(m) + coverage);
    return score < 1.0 ? score : 1.0;
}

// Batched form: sequences are concatenated in a_flat/b_flat with CSR-style
// offset arrays of length num_pairs+1; distances land in out[0:num_pairs).
void tm_levenshtein_batch(const int32_t* a_flat, const int64_t* a_offsets,
                          const int32_t* b_flat, const int64_t* b_offsets,
                          int64_t num_pairs, int64_t* out) {
    for (int64_t p = 0; p < num_pairs; ++p) {
        out[p] = tm_levenshtein(a_flat + a_offsets[p], a_offsets[p + 1] - a_offsets[p],
                                b_flat + b_offsets[p], b_offsets[p + 1] - b_offsets[p]);
    }
}

// COCO greedy GT matching for one (image, class) across all IoU thresholds
// (ref detection/mean_ap.py:421-539 — there a per-threshold Python loop).
// `ious` is row-major (n_det x n_gt) with detections pre-sorted by score desc
// and gts pre-sorted ignored-last; outputs are row-major (n_thr x n_det).
void tm_coco_match(const double* ious, int64_t n_det, int64_t n_gt,
                   const uint8_t* gt_ignore, const double* thrs, int64_t n_thr,
                   uint8_t* det_matched, uint8_t* det_matched_ignored) {
    std::vector<uint8_t> gt_matched(static_cast<size_t>(n_gt));
    for (int64_t t = 0; t < n_thr; ++t) {
        std::fill(gt_matched.begin(), gt_matched.end(), 0);
        for (int64_t d = 0; d < n_det; ++d) {
            double best_iou = std::min(thrs[t], 1.0 - 1e-10);
            int64_t best_g = -1;
            for (int64_t g = 0; g < n_gt; ++g) {
                if (gt_matched[g]) continue;
                // gts are sorted valid-first: once a valid match exists,
                // stop before claiming an ignored gt
                if (best_g > -1 && !gt_ignore[best_g] && gt_ignore[g]) break;
                double v = ious[d * n_gt + g];
                if (v >= best_iou) { best_iou = v; best_g = g; }
            }
            if (best_g > -1) {
                det_matched[t * n_det + d] = 1;
                gt_matched[static_cast<size_t>(best_g)] = 1;
                det_matched_ignored[t * n_det + d] = gt_ignore[best_g];
            }
        }
    }
}

}  // extern "C"
