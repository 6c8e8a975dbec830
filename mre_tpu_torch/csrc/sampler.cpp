// sampler.cpp — native host-side KGE batch sampler and ranking accumulator.
//
// A fresh C++17 implementation of the capabilities of the reference's native
// core (OpenKE/openke/base/{Setting,Random,Triple,Reader,Corrupt,Test}.h and
// Base.cpp): reads the *2id.txt benchmark files, builds sorted triple
// indexes, serves multi-threaded training batches with exact filtered
// corruption (complement order-statistic sampling — no rejection loops), and
// accumulates link-prediction metrics. Exposes the same extern "C" ABI the
// reference's ctypes clients use, so it is a drop-in Base.so replacement.
//
// Design differences from the reference (intentional):
//   * std::vector / std::thread / per-thread std::mt19937_64 instead of raw
//     malloc + pthreads + a hand-rolled LCG;
//   * one CSR offset array per (entity) for the by-head/by-tail indexes;
//   * no globals-scattered-across-headers — a single translation unit.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared sampler.cpp -o sampler.so -pthread

#include <algorithm>
#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

using INT = int64_t;
using REAL = float;

namespace {

struct Triple {
    INT h, r, t;
    bool operator==(const Triple& o) const { return h == o.h && r == o.r && t == o.t; }
};

struct State {
    std::string in_path;
    INT work_threads = 8;
    bool bern = false;
    INT entity_total = 0, relation_total = 0;
    INT train_total = 0, valid_total = 0, test_total = 0, triple_total = 0;

    std::vector<Triple> train;            // as read (deduped, hrt-sorted)
    std::vector<Triple> by_head;          // sorted (h, r, t)
    std::vector<Triple> by_tail;          // sorted (t, r, h) order
    std::vector<Triple> by_pair;          // sorted (h, t, r) — relation corruption
    std::vector<INT> head_off, tail_off, pair_off;  // CSR offsets per entity
    std::vector<Triple> all_sorted;       // train+valid+test, (h, r, t) sorted
    std::vector<Triple> test_list, valid_list;
    std::vector<REAL> left_mean, right_mean;

    // kl_prob.txt softmax table for probability-weighted relation corruption
    // (Reader.h:25-50): row r holds R-1 entries for relations j != r.
    std::vector<REAL> prob;
    bool has_prob = false;

    // type constraints: per relation, sorted candidate entity lists
    std::vector<std::vector<INT>> head_type, tail_type;
    bool has_types = false;

    std::vector<std::mt19937_64> rngs;
    INT last_seed = 0;   // seed base for rng top-up in sampling()
};

State S;

bool cmp_hrt(const Triple& a, const Triple& b) {
    return a.h != b.h ? a.h < b.h : (a.r != b.r ? a.r < b.r : a.t < b.t);
}
bool cmp_trh(const Triple& a, const Triple& b) {
    return a.t != b.t ? a.t < b.t : (a.r != b.r ? a.r < b.r : a.h < b.h);
}
bool cmp_htr(const Triple& a, const Triple& b) {
    return a.h != b.h ? a.h < b.h : (a.t != b.t ? a.t < b.t : a.r < b.r);
}

std::vector<Triple> read_triples(const std::string& file, INT* total_out) {
    std::vector<Triple> out;
    FILE* f = fopen(file.c_str(), "r");
    if (!f) { fprintf(stderr, "sampler.so: cannot open %s\n", file.c_str()); return out; }
    long long n = 0;
    if (fscanf(f, "%lld", &n) != 1) { fclose(f); return out; }
    out.reserve(n);
    for (long long i = 0; i < n; i++) {
        long long h, t, r;  // *2id.txt column order is (head, tail, relation)
        if (fscanf(f, "%lld%lld%lld", &h, &t, &r) != 3) break;
        out.push_back({(INT)h, (INT)r, (INT)t});
    }
    fclose(f);
    if (total_out) *total_out = (INT)out.size();
    return out;
}

INT read_count(const std::string& file) {
    FILE* f = fopen(file.c_str(), "r");
    if (!f) return 0;
    long long n = 0;
    if (fscanf(f, "%lld", &n) != 1) n = 0;
    fclose(f);
    return (INT)n;
}

void build_offsets(const std::vector<Triple>& sorted, std::vector<INT>& off, bool by_head) {
    off.assign(S.entity_total + 1, 0);
    for (const auto& tr : sorted) off[(by_head ? tr.h : tr.t) + 1]++;
    for (INT i = 0; i < S.entity_total; i++) off[i + 1] += off[i];
}

// Exact filtered corruption: uniform over {0..E-1} minus the true set for
// (anchor, r). The true candidates form a sorted sub-range of the by_head /
// by_tail index; the u-th allowed value is u + #{excluded s_i with s_i-i<=u},
// found by binary search (same complement order-statistic trick as the
// reference's Corrupt.h:7-83).
INT corrupt_filtered(INT tid, INT anchor, INT r, bool keep_head) {
    const auto& index = keep_head ? S.by_head : S.by_tail;
    const auto& off = keep_head ? S.head_off : S.tail_off;
    INT lo = off[anchor], hi = off[anchor + 1];
    // narrow to the relation sub-range
    auto rlo = std::lower_bound(index.begin() + lo, index.begin() + hi, r,
                                [](const Triple& a, INT rr) { return a.r < rr; });
    auto rhi = std::upper_bound(index.begin() + lo, index.begin() + hi, r,
                                [](INT rr, const Triple& a) { return rr < a.r; });
    INT k = (INT)(rhi - rlo);
    if (k >= S.entity_total) return anchor;  // every entity true: degenerate
    std::uniform_int_distribution<INT> dist(0, S.entity_total - k - 1);
    INT u = dist(S.rngs[tid]);
    // count excluded values s_i (sorted) with s_i - i <= u
    INT cl = 0, cr = k;  // first index with s_i - i > u
    while (cl < cr) {
        INT mid = (cl + cr) / 2;
        INT s = keep_head ? (rlo + mid)->t : (rlo + mid)->h;
        if (s - mid <= u) cl = mid + 1; else cr = mid;
    }
    return u + cl;
}

INT corrupt_unfiltered(INT tid, INT self) {
    if (S.entity_total <= 1) return self;    // single-entity KG: UB guard
    std::uniform_int_distribution<INT> dist(0, S.entity_total - 2);
    INT v = dist(S.rngs[tid]);
    return v < self ? v : v + 1;
}

// Relation corruption (Corrupt.h:86-163 capabilities). filter excludes every
// relation rr with (h, rr, t) in the train set; p samples the complement
// from the kl_prob softmax table instead of uniformly.
INT corrupt_rel_impl(INT tid, INT h, INT t, INT r, bool p, bool filter_flag) {
    if (!filter_flag) {
        std::uniform_int_distribution<INT> dist(0, S.relation_total - 2);
        INT v = dist(S.rngs[tid]);
        return v < r ? v : v + 1;
    }
    // true relations of (h, t): a sorted sub-range of the by-(h,t) index
    INT lo = S.pair_off[h], hi = S.pair_off[h + 1];
    auto plo = std::lower_bound(S.by_pair.begin() + lo, S.by_pair.begin() + hi, t,
                                [](const Triple& a, INT tt) { return a.t < tt; });
    auto phi = std::upper_bound(S.by_pair.begin() + lo, S.by_pair.begin() + hi, t,
                                [](INT tt, const Triple& a) { return tt < a.t; });
    INT k = (INT)(phi - plo);
    if (k >= S.relation_total) return r;  // every relation is true (degenerate)
    INT u;
    if (p && S.has_prob) {
        // weighted draw over the complement: walk the prob row (R-1 entries,
        // diagonal r removed), skipping true relations, and pick by cdf.
        const REAL* row = S.prob.data() + (size_t)r * (S.relation_total - 1);
        double total = 0;
        {
            INT ti = 0;
            for (INT j = 0; j < S.relation_total; j++) {
                while (ti < k && (plo + ti)->r < j) ti++;
                bool is_true = ti < k && (plo + ti)->r == j;
                if (is_true || j == r) continue;
                total += row[j < r ? j : j - 1];
            }
        }
        std::uniform_real_distribution<double> unif(0.0, 1.0);
        double m = unif(S.rngs[tid]) * (total > 0 ? total : 1.0);
        double acc = 0;
        INT ti = 0, pick_count = 0;
        u = -1;
        for (INT j = 0; j < S.relation_total; j++) {
            while (ti < k && (plo + ti)->r < j) ti++;
            bool is_true = ti < k && (plo + ti)->r == j;
            if (is_true) continue;   // complement index counts non-true rels
            if (u < 0) {
                acc += (j == r) ? 0.0 : row[j < r ? j : j - 1];
                // r itself is in the complement only if (h,r,t) is not a
                // train triple; its prob-table weight is 0 (no diagonal).
                if (acc >= m || pick_count == S.relation_total - k - 1) u = pick_count;
            }
            pick_count++;
        }
        if (u < 0) u = pick_count - 1;
    } else {
        std::uniform_int_distribution<INT> dist(0, S.relation_total - k - 1);
        u = dist(S.rngs[tid]);
    }
    // map complement index u back to a relation id: count excluded values
    // s_i (sorted true rels) with s_i - i <= u (same trick as entities).
    INT cl = 0, cr = k;
    while (cl < cr) {
        INT mid = (cl + cr) / 2;
        if ((plo + mid)->r - mid <= u) cl = mid + 1; else cr = mid;
    }
    return u + cl;
}

bool find_triple(INT h, INT r, INT t) {
    Triple key{h, r, t};
    auto it = std::lower_bound(S.all_sorted.begin(), S.all_sorted.end(), key, cmp_hrt);
    return it != S.all_sorted.end() && *it == key;
}

// Type-constrained tail corruption (Corrupt.h:179-195): draw from the
// relation's tail-type candidate set, rejecting known-true triples; after
// 1000 rejections fall back to exact filtered corruption over all entities.
INT corrupt_tc_tail(INT tid, INT h, INT r) {
    if (!S.has_types || S.tail_type[r].empty())
        return corrupt_filtered(tid, h, r, true);
    const auto& cands = S.tail_type[r];
    std::uniform_int_distribution<INT> dist(0, (INT)cands.size() - 1);
    for (int loop = 0; loop < 1000; loop++) {
        INT t = cands[dist(S.rngs[tid])];
        if (!find_triple(h, r, t)) return t;
    }
    return corrupt_filtered(tid, h, r, true);
}

// ---------------------------------------------------------------------------
// link-prediction metric accumulators (Test.h:65-327 semantics)
// ---------------------------------------------------------------------------
struct Accum {
    double rank = 0, reci = 0, h1 = 0, h3 = 0, h10 = 0;
    double n = 0;
    void add(INT below) {
        n += 1;
        rank += below + 1;
        reci += 1.0 / (below + 1);
        if (below < 1) h1 += 1;
        if (below < 3) h3 += 1;
        if (below < 10) h10 += 1;
    }
};
Accum l_raw, l_filt, r_raw, r_filt, l_raw_tc, l_filt_tc, r_raw_tc, r_filt_tc;
REAL link_mrr[2], link_mr[2], link_h10[2], link_h3[2], link_h1[2];

}  // namespace

extern "C" {

void setInPath(char* path) { S.in_path = path; }
void setWorkThreads(INT n) { S.work_threads = n; }
void setBern(INT flag) { S.bern = flag != 0; }
INT getWorkThreads() { return S.work_threads; }
INT getEntityTotal() { return S.entity_total; }
INT getRelationTotal() { return S.relation_total; }
INT getTrainTotal() { return S.train_total; }
INT getTestTotal() { return S.test_total; }
INT getValidTotal() { return S.valid_total; }
INT getTripleTotal() { return S.triple_total; }

void randReset() {
    S.rngs.clear();
    std::random_device rd;
    S.last_seed = (INT)rd();
    for (INT i = 0; i < S.work_threads; i++)
        S.rngs.emplace_back((unsigned long long)S.last_seed + i * 7919);
}

void setSeed(INT seed) {
    S.rngs.clear();
    S.last_seed = seed;
    for (INT i = 0; i < S.work_threads; i++) S.rngs.emplace_back(seed + i * 7919);
}

void importTrainFiles() {
    S.entity_total = read_count(S.in_path + "entity2id.txt");
    S.relation_total = read_count(S.in_path + "relation2id.txt");
    auto raw = read_triples(S.in_path + "train2id.txt", nullptr);
    std::sort(raw.begin(), raw.end(), cmp_hrt);
    raw.erase(std::unique(raw.begin(), raw.end()), raw.end());
    S.train = raw;
    S.train_total = (INT)raw.size();
    S.by_head = raw;  // already hrt-sorted
    S.by_tail = raw;
    std::sort(S.by_tail.begin(), S.by_tail.end(), cmp_trh);
    S.by_pair = raw;
    std::sort(S.by_pair.begin(), S.by_pair.end(), cmp_htr);
    build_offsets(S.by_head, S.head_off, true);
    build_offsets(S.by_tail, S.tail_off, false);
    build_offsets(S.by_pair, S.pair_off, true);

    // Bernoulli statistics per relation (Reader.h:141-158 semantics).
    std::vector<double> freq(S.relation_total, 0);
    std::vector<std::vector<INT>> heads(S.relation_total), tails(S.relation_total);
    for (const auto& tr : raw) {
        freq[tr.r] += 1;
        heads[tr.r].push_back(tr.h);
        tails[tr.r].push_back(tr.t);
    }
    S.left_mean.assign(S.relation_total, 0);
    S.right_mean.assign(S.relation_total, 0);
    for (INT r = 0; r < S.relation_total; r++) {
        auto uniq = [](std::vector<INT>& v) {
            std::sort(v.begin(), v.end());
            v.erase(std::unique(v.begin(), v.end()), v.end());
            return std::max<size_t>(v.size(), 1);
        };
        S.left_mean[r] = (REAL)(freq[r] / uniq(heads[r]));
        S.right_mean[r] = (REAL)(freq[r] / uniq(tails[r]));
    }
    if (S.rngs.empty()) randReset();
    S.all_sorted = S.train;  // until test files are imported
}

void importTestFiles() {
    S.test_list = read_triples(S.in_path + "test2id.txt", &S.test_total);
    S.valid_list = read_triples(S.in_path + "valid2id.txt", &S.valid_total);
    S.all_sorted = S.train;
    S.all_sorted.insert(S.all_sorted.end(), S.test_list.begin(), S.test_list.end());
    S.all_sorted.insert(S.all_sorted.end(), S.valid_list.begin(), S.valid_list.end());
    std::sort(S.all_sorted.begin(), S.all_sorted.end(), cmp_hrt);
    S.all_sorted.erase(std::unique(S.all_sorted.begin(), S.all_sorted.end()), S.all_sorted.end());
    S.triple_total = (INT)S.all_sorted.size();
}

// kl_prob.txt: relationTotal*(relationTotal-1) whitespace-separated floats;
// row r lists a divergence for every relation j != r. Converted per-row to
// softmax(exp(-x/temp)) weights (Reader.h:25-50 semantics).
void importProb(REAL temp) {
    S.prob.assign((size_t)S.relation_total * (S.relation_total - 1), 0.0f);
    S.has_prob = false;
    FILE* f = fopen((S.in_path + "kl_prob.txt").c_str(), "r");
    if (!f) { fprintf(stderr, "sampler.so: cannot open kl_prob.txt\n"); return; }
    for (auto& v : S.prob) {
        if (fscanf(f, "%f", &v) != 1) { fclose(f); return; }
    }
    fclose(f);
    for (INT r = 0; r < S.relation_total; r++) {
        REAL* row = S.prob.data() + (size_t)r * (S.relation_total - 1);
        double sum = 0;
        for (INT j = 0; j < S.relation_total - 1; j++) {
            row[j] = (REAL)std::exp(-row[j] / temp);
            sum += row[j];
        }
        for (INT j = 0; j < S.relation_total - 1; j++) row[j] = (REAL)(row[j] / sum);
    }
    S.has_prob = true;
}

void importTypeFiles() {
    S.head_type.assign(S.relation_total, {});
    S.tail_type.assign(S.relation_total, {});
    FILE* f = fopen((S.in_path + "type_constrain.txt").c_str(), "r");
    if (!f) return;
    long long n = 0;
    if (fscanf(f, "%lld", &n) != 1) { fclose(f); return; }
    for (long long i = 0; i < 2 * n; i++) {
        long long rel = 0, cnt = 0;
        if (fscanf(f, "%lld%lld", &rel, &cnt) != 2) {
            fprintf(stderr, "sampler.so: truncated type_constrain.txt "
                            "(entry %lld of %lld)\n", i, 2 * n);
            fclose(f);
            return;  // refuse the partial table (has_types stays false)
        }
        std::vector<INT> ids(cnt);
        bool ok = true;
        for (long long j = 0; j < cnt; j++) {
            long long e;
            if (fscanf(f, "%lld", &e) != 1) { ok = false; break; }
            ids[j] = (INT)e;
        }
        if (!ok || rel < 0 || rel >= S.relation_total) {
            // a stale/mismatched file must never index out of bounds or
            // leave the token stream desynced — reject the whole table
            fprintf(stderr, "sampler.so: bad type_constrain.txt entry "
                            "(rel %lld of %lld relations)\n",
                    rel, (long long)S.relation_total);
            fclose(f);
            return;
        }
        std::sort(ids.begin(), ids.end());
        // lines alternate: head candidates then tail candidates per relation
        if (i % 2 == 0) S.head_type[rel] = std::move(ids);
        else S.tail_type[rel] = std::move(ids);
    }
    fclose(f);
    S.has_types = true;
}

// OpenKE sampling ABI: batch arrays hold batchSize positives followed by
// negRate blocks of batchSize corruptions each (Base.cpp:104-146 layout).
void sampling(INT* batch_h, INT* batch_t, INT* batch_r, REAL* batch_y,
              INT batch_size, INT neg_rate, INT neg_rel_rate, INT mode,
              bool filter_flag, bool p, bool val_loss) {
    INT n_threads = std::max<INT>(S.work_threads, 1);
    // setWorkThreads may legally be called after randReset/setSeed (the ABI
    // allows any order) — make sure every thread has an rng. Top-up streams
    // derive from the last seed so runs with different setSeed values never
    // share corruption streams on late-added threads.
    while ((INT)S.rngs.size() < n_threads)
        S.rngs.emplace_back((unsigned long long)S.last_seed
                            + 0x9e3779b97f4a7c15ull
                            + S.rngs.size() * 7919);
    if (val_loss) {
        // validation-loss batches (Base.cpp:149-160): positives straight
        // from the valid list, no corruption.
        INT n = std::max<INT>(S.valid_total, 1);
        for (INT b = 0; b < batch_size; b++) {
            const Triple& tr = S.valid_list.empty() ? S.train[b % S.train_total]
                                                    : S.valid_list[b % n];
            batch_h[b] = tr.h; batch_t[b] = tr.t; batch_r[b] = tr.r; batch_y[b] = 1;
        }
        return;
    }
    auto worker = [&](INT tid) {
        INT chunk = (batch_size + n_threads - 1) / n_threads;
        INT lef = tid * chunk, rig = std::min(batch_size, (tid + 1) * chunk);
        std::uniform_int_distribution<INT> pick(0, std::max<INT>(S.train_total, 1) - 1);
        if (S.train_total <= 0) return;      // nothing to sample
        std::uniform_real_distribution<double> unif(0.0, 1.0);
        for (INT b = lef; b < rig; b++) {
            const Triple& tr = S.train[pick(S.rngs[tid])];
            batch_h[b] = tr.h; batch_t[b] = tr.t; batch_r[b] = tr.r; batch_y[b] = 1;
            INT last = batch_size;
            for (INT k = 0; k < neg_rate; k++) {
                bool replace_tail;
                if (mode == 0) {
                    double prob = 0.5;
                    if (S.bern)
                        prob = S.right_mean[tr.r] / (S.right_mean[tr.r] + S.left_mean[tr.r]);
                    replace_tail = unif(S.rngs[tid]) < prob;
                } else {
                    replace_tail = mode != -1;
                }
                // Base.cpp parity quirk: the reference reads filter_flag
                // into a local (Base.cpp:91) but every corrupt_* call uses
                // the default filter_flag=true — training corruption is
                // ALWAYS exact-filtered and p always honored, regardless of
                // the flag. The standalone corruptRel/corruptTypeTail ABI
                // hooks still honor filter_flag (Corrupt.h semantics).
                (void)filter_flag;
                if (replace_tail) {
                    batch_h[b + last] = tr.h;
                    batch_t[b + last] = corrupt_filtered(tid, tr.h, tr.r, true);
                } else {
                    batch_h[b + last] = corrupt_filtered(tid, tr.t, tr.r, false);
                    batch_t[b + last] = tr.t;
                }
                batch_r[b + last] = tr.r;
                batch_y[b + last] = -1;
                last += batch_size;
            }
            for (INT k = 0; k < neg_rel_rate; k++) {
                batch_h[b + last] = tr.h;
                batch_t[b + last] = tr.t;
                batch_r[b + last] = corrupt_rel_impl(tid, tr.h, tr.t, tr.r, p, true);
                batch_y[b + last] = -1;
                last += batch_size;
            }
        }
    };
    std::vector<std::thread> threads;
    for (INT i = 0; i < n_threads; i++) threads.emplace_back(worker, i);
    for (auto& th : threads) th.join();
}

// Direct corruption hooks (thread 0 rng) for parity tests and external
// callers; mirror Corrupt.h corrupt_rel / corrupt entry points.
INT corruptRel(INT h, INT t, INT r, bool p, bool filter_flag) {
    if (S.rngs.empty()) randReset();
    return corrupt_rel_impl(0, h, t, r, p, filter_flag);
}

INT corruptTypeTail(INT h, INT r) {
    if (S.rngs.empty()) randReset();
    return corrupt_tc_tail(0, h, r);
}

INT hasProb() { return S.has_prob ? 1 : 0; }
INT hasTypes() { return S.has_types ? 1 : 0; }

void initTest() {
    l_raw = l_filt = r_raw = r_filt = Accum{};
    l_raw_tc = l_filt_tc = r_raw_tc = r_filt_tc = Accum{};
}

void getHeadBatch(INT* ph, INT* pt, INT* pr, INT index) {
    const Triple& tr = S.test_list[index];
    for (INT i = 0; i < S.entity_total; i++) { ph[i] = i; pt[i] = tr.t; pr[i] = tr.r; }
}

void getTailBatch(INT* ph, INT* pt, INT* pr, INT index) {
    const Triple& tr = S.test_list[index];
    for (INT i = 0; i < S.entity_total; i++) { ph[i] = tr.h; pt[i] = i; pr[i] = tr.r; }
}

// con: lower-is-better scores for all entities as candidate heads.
void testHead(REAL* con, INT index, bool type_constrain) {
    const Triple& tr = S.test_list[index];
    REAL truth = con[tr.h];
    INT below = 0, below_f = 0, below_tc = 0, below_ftc = 0;
    const std::vector<INT>* types = (type_constrain && S.has_types) ? &S.head_type[tr.r] : nullptr;
    size_t ti = 0;
    for (INT j = 0; j < S.entity_total; j++) {
        if (j == tr.h) continue;
        bool better = con[j] < truth;
        bool in_type = false;
        if (types) {
            while (ti < types->size() && (*types)[ti] < j) ti++;
            in_type = ti < types->size() && (*types)[ti] == j;
        }
        if (better) {
            below++;
            bool known = find_triple(j, tr.r, tr.t);
            if (!known) below_f++;
            if (in_type) {
                below_tc++;
                if (!known) below_ftc++;
            }
        }
    }
    l_raw.add(below);
    l_filt.add(below_f);
    if (types) { l_raw_tc.add(below_tc); l_filt_tc.add(below_ftc); }
}

void testTail(REAL* con, INT index, bool type_constrain) {
    const Triple& tr = S.test_list[index];
    REAL truth = con[tr.t];
    INT below = 0, below_f = 0, below_tc = 0, below_ftc = 0;
    const std::vector<INT>* types = (type_constrain && S.has_types) ? &S.tail_type[tr.r] : nullptr;
    size_t ti = 0;
    for (INT j = 0; j < S.entity_total; j++) {
        if (j == tr.t) continue;
        bool better = con[j] < truth;
        bool in_type = false;
        if (types) {
            while (ti < types->size() && (*types)[ti] < j) ti++;
            in_type = ti < types->size() && (*types)[ti] == j;
        }
        if (better) {
            below++;
            bool known = find_triple(tr.h, tr.r, j);
            if (!known) below_f++;
            if (in_type) {
                below_tc++;
                if (!known) below_ftc++;
            }
        }
    }
    r_raw.add(below);
    r_filt.add(below_f);
    if (types) { r_raw_tc.add(below_tc); r_filt_tc.add(below_ftc); }
}

void test_link_prediction(bool type_constrain) {
    const Accum& lr = type_constrain ? l_raw_tc : l_raw;
    const Accum& lf = type_constrain ? l_filt_tc : l_filt;
    const Accum& rr = type_constrain ? r_raw_tc : r_raw;
    const Accum& rf = type_constrain ? r_filt_tc : r_filt;
    double n = std::max(lr.n, 1.0);
    // index 0 = raw averaged l/r, index 1 = filtered averaged l/r
    link_mrr[0] = (REAL)((lr.reci + rr.reci) / (2 * n));
    link_mr[0] = (REAL)((lr.rank + rr.rank) / (2 * n));
    link_h10[0] = (REAL)((lr.h10 + rr.h10) / (2 * n));
    link_h3[0] = (REAL)((lr.h3 + rr.h3) / (2 * n));
    link_h1[0] = (REAL)((lr.h1 + rr.h1) / (2 * n));
    link_mrr[1] = (REAL)((lf.reci + rf.reci) / (2 * n));
    link_mr[1] = (REAL)((lf.rank + rf.rank) / (2 * n));
    link_h10[1] = (REAL)((lf.h10 + rf.h10) / (2 * n));
    link_h3[1] = (REAL)((lf.h3 + rf.h3) / (2 * n));
    link_h1[1] = (REAL)((lf.h1 + rf.h1) / (2 * n));
    printf("metric      | raw       | filtered\n");
    printf("MRR         | %f | %f\n", link_mrr[0], link_mrr[1]);
    printf("MR          | %f | %f\n", link_mr[0], link_mr[1]);
    printf("Hits@10     | %f | %f\n", link_h10[0], link_h10[1]);
    printf("Hits@3      | %f | %f\n", link_h3[0], link_h3[1]);
    printf("Hits@1      | %f | %f\n", link_h1[0], link_h1[1]);
}

// Getters take the type_constrain flag like the reference's (the constrain
// choice was already applied inside test_link_prediction) and return the
// *filtered* metric — the value OpenKE's README table reports.
REAL getTestLinkMRR(INT) { return link_mrr[1]; }
REAL getTestLinkMR(INT) { return link_mr[1]; }
REAL getTestLinkHit10(INT) { return link_h10[1]; }
REAL getTestLinkHit3(INT) { return link_h3[1]; }
REAL getTestLinkHit1(INT) { return link_h1[1]; }
REAL getTestLinkMRRRaw() { return link_mrr[0]; }
REAL getTestLinkMRRaw() { return link_mr[0]; }
REAL getTestLinkHit10Raw() { return link_h10[0]; }

}  // extern "C"
