// Native planning kernels of cotengra_tpu_torch (host C++).
//
// The port's own copy of the JAX package's ``ops/native/kernels.cpp``,
// with the same C ABI and the same arithmetic, so that a seeded call gives
// the same path, stats or partition in both packages. C++ equivalents of
// the reference's Rust `cotengrust` extension (SURVEY.md §2.9): greedy
// contraction search, batched random-greedy with flops tracking and early
// abort, and optimal bitmask dynamic programming with a doubling cost-cap
// sieve (arXiv:1304.6112); then the compressed (chi-capped) hypergraph
// replay and the multilevel hypergraph partitioner (ctgpart). Exposed
// through a plain C ABI consumed via ctypes; built with g++ at first use
// into build/cotengra_tpu_torch/ (ops/_build.py).
//
// Contraction model (identical to the Python fallbacks in
// pathfinders/basic.py): each term is a sorted vector of (index, count)
// pairs; an index is contracted away exactly when its accumulated count
// reaches its total appearance count (inputs containing it + 1 if in the
// output). Sizes/flops are tracked in double (log-free products).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <queue>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using std::size_t;

struct Leg {
    int ix;
    int cnt;
};

using Legs = std::vector<Leg>;

// ---------------------------------------------------------------- rng --

struct Rng {
    std::mt19937_64 gen;
    explicit Rng(uint64_t seed) : gen(seed) {}
    double uniform() {
        return std::uniform_real_distribution<double>(0.0, 1.0)(gen);
    }
    double uniform(double lo, double hi) {
        return std::uniform_real_distribution<double>(lo, hi)(gen);
    }
    double gumbel() {
        double u = uniform();
        if (u <= 0.0) u = 1e-300;
        double e = -std::log(u);  // exponential(1)
        if (e <= 0.0) e = 1e-300;
        return -std::log(e);
    }
    int randint(int n) {  // [0, n)
        return (int)std::uniform_int_distribution<int64_t>(0, n - 1)(gen);
    }
};

// ------------------------------------------------------------ problem --

struct Problem {
    // static
    std::vector<double> sizes;        // per index
    std::vector<int> appearances;     // per index
    int n_inputs = 0;

    // dynamic graph state
    std::unordered_map<int, Legs> terms;                // node -> legs
    std::unordered_map<int, std::vector<int>> edges;    // ix -> nodes
    int ssa = 0;
    std::vector<std::pair<int, int>> path;  // (i, j); j==-1 single step
    bool track_flops = false;
    double flops = 0.0;
    double flops_limit = std::numeric_limits<double>::infinity();
};

void edges_remove(Problem& P, int ix, int node) {
    auto it = P.edges.find(ix);
    if (it == P.edges.end()) return;
    auto& v = it->second;
    v.erase(std::remove(v.begin(), v.end(), node), v.end());
    if (v.empty()) P.edges.erase(it);
}

Legs pop_node(Problem& P, int i) {
    Legs legs = std::move(P.terms[i]);
    P.terms.erase(i);
    // dedupe ix removal (legs sorted, may contain dup ix entries)
    int prev = -1;
    for (auto& l : legs) {
        if (l.ix != prev) edges_remove(P, l.ix, i);
        prev = l.ix;
    }
    return legs;
}

int add_node(Problem& P, Legs legs) {
    int i = P.ssa++;
    int prev = -1;
    for (auto& l : legs) {
        if (l.ix != prev) P.edges[l.ix].push_back(i);
        prev = l.ix;
    }
    P.terms.emplace(i, std::move(legs));
    return i;
}

double legs_size(const Legs& legs, const std::vector<double>& sizes) {
    double s = 1.0;
    for (auto& l : legs) s *= sizes[l.ix];
    return s;
}

double pair_flops(const Legs& a, const Legs& b,
                  const std::vector<double>& sizes) {
    // product over the union of indices
    double f = 1.0;
    size_t ia = 0, ib = 0;
    int prev = -1;
    while (ia < a.size() || ib < b.size()) {
        int ix;
        if (ib == b.size() || (ia < a.size() && a[ia].ix <= b[ib].ix)) {
            ix = a[ia++].ix;
        } else {
            ix = b[ib++].ix;
        }
        if (ix != prev) f *= sizes[ix];
        prev = ix;
    }
    return f;
}

Legs merge_legs(const Legs& a, const Legs& b,
                const std::vector<int>& appearances) {
    Legs out;
    out.reserve(a.size() + b.size());
    size_t ia = 0, ib = 0;
    while (ia < a.size() && ib < b.size()) {
        if (a[ia].ix < b[ib].ix) {
            out.push_back(a[ia++]);
        } else if (a[ia].ix > b[ib].ix) {
            out.push_back(b[ib++]);
        } else {
            int c = a[ia].cnt + b[ib].cnt;
            if (c != appearances[a[ia].ix]) out.push_back({a[ia].ix, c});
            ++ia;
            ++ib;
        }
    }
    while (ia < a.size()) out.push_back(a[ia++]);
    while (ib < b.size()) out.push_back(b[ib++]);
    return out;
}

int contract_nodes(Problem& P, int i, int j) {
    Legs li = pop_node(P, i);
    Legs lj = pop_node(P, j);
    if (P.track_flops) P.flops += pair_flops(li, lj, P.sizes);
    Legs lk = merge_legs(li, lj, P.appearances);
    int k = add_node(P, std::move(lk));
    P.path.push_back({i, j});
    return k;
}

// --------------------------------------------------------- simplify --

void simplify_batch(Problem& P) {
    std::vector<int> to_remove;
    for (auto& [ix, nodes] : P.edges) {
        if ((int)nodes.size() >= (int)P.terms.size()) to_remove.push_back(ix);
    }
    for (int ix : to_remove) {
        auto nodes = P.edges[ix];
        P.edges.erase(ix);
        for (int i : nodes) {
            Legs& legs = P.terms[i];
            legs.erase(std::remove_if(legs.begin(), legs.end(),
                                      [ix](const Leg& l) { return l.ix == ix; }),
                       legs.end());
        }
    }
}

void simplify_single_terms(Problem& P) {
    std::vector<int> nodes;
    nodes.reserve(P.terms.size());
    for (auto& kv : P.terms) nodes.push_back(kv.first);
    std::sort(nodes.begin(), nodes.end());
    for (int i : nodes) {
        const Legs& legs = P.terms[i];
        bool foldable = false;
        int prev = -1;
        for (auto& l : legs) {
            if (l.ix == prev || l.cnt == P.appearances[l.ix]) {
                foldable = true;
                break;
            }
            prev = l.ix;
        }
        if (!foldable) continue;
        Legs old = pop_node(P, i);
        // merge duplicates, drop fully-reduced
        Legs merged;
        for (auto& l : old) {
            if (!merged.empty() && merged.back().ix == l.ix)
                merged.back().cnt += l.cnt;
            else
                merged.push_back(l);
        }
        Legs fresh;
        for (auto& l : merged)
            if (l.cnt != P.appearances[l.ix]) fresh.push_back(l);
        add_node(P, std::move(fresh));
        P.path.push_back({i, -1});
    }
}

void simplify_scalars(Problem& P) {
    std::vector<int> scalars;
    int jmin = -1;
    std::pair<size_t, int> jbest{SIZE_MAX, INT32_MAX};
    for (auto& [i, legs] : P.terms) {
        if (legs.empty()) {
            scalars.push_back(i);
        } else if (std::make_pair(legs.size(), (size_t)i) <
                   std::make_pair(jbest.first, (size_t)jbest.second)) {
            jbest = {legs.size(), i};
            jmin = i;
        }
    }
    if (scalars.empty()) return;
    std::sort(scalars.begin(), scalars.end());
    if (jmin >= 0) scalars.push_back(jmin);
    int cur = scalars[0];
    for (size_t k = 1; k < scalars.size(); ++k)
        cur = contract_nodes(P, cur, scalars[k]);
}

void simplify_hadamard(Problem& P) {
    std::map<std::vector<int>, std::vector<int>> groups;
    for (auto& [i, legs] : P.terms) {
        std::vector<int> key;
        int prev = -1;
        for (auto& l : legs) {
            if (l.ix != prev) key.push_back(l.ix);
            prev = l.ix;
        }
        groups[key].push_back(i);
    }
    for (auto& [key, group] : groups) {
        auto g = group;
        while (g.size() > 1) {
            int a = g.back();
            g.pop_back();
            int b = g.back();
            g.pop_back();
            g.push_back(contract_nodes(P, a, b));
        }
    }
}

void simplify(Problem& P) {
    simplify_batch(P);
    bool again = true;
    while (again) {
        simplify_single_terms(P);
        simplify_scalars(P);
        int before = P.ssa;
        simplify_hadamard(P);
        again = before != P.ssa;
    }
}

// ------------------------------------------------------------ greedy --

bool optimize_greedy_core(Problem& P, double costmod, double temperature,
                          int max_neighbors, Rng& rng) {
    auto local_score = [&](double sa, double sb, double sab) -> double {
        double x = sab / costmod - (sa + sb) * costmod;
        if (temperature == 0.0) return x;
        if (x > 0) return std::log(x) - temperature * rng.gumbel();
        if (x < 0) return -std::log(-x) - temperature * rng.gumbel();
        return -temperature * rng.gumbel();
    };

    std::unordered_map<int, double> node_size;
    node_size.reserve(P.terms.size() * 2);
    for (auto& [i, legs] : P.terms) node_size[i] = legs_size(legs, P.sizes);

    struct Cand {
        int i, j;
        double ksize;
        Legs klegs;
    };
    using QEntry = std::pair<double, int>;
    std::priority_queue<QEntry, std::vector<QEntry>, std::greater<QEntry>> queue;
    std::unordered_map<int, Cand> cands;
    int cid = 0;

    auto push = [&](int i, int j) {
        Legs klegs = merge_legs(P.terms[i], P.terms[j], P.appearances);
        double ksize = legs_size(klegs, P.sizes);
        double s = local_score(node_size[i], node_size[j], ksize);
        cands.emplace(cid, Cand{i, j, ksize, std::move(klegs)});
        queue.push({s, cid});
        ++cid;
    };

    for (auto& [ix, nodes] : P.edges) {
        if (max_neighbors && (int)nodes.size() > max_neighbors) continue;
        for (size_t a = 0; a < nodes.size(); ++a)
            for (size_t b = a + 1; b < nodes.size(); ++b)
                push(nodes[a], nodes[b]);
    }

    while (!queue.empty()) {
        auto [s, c0] = queue.top();
        queue.pop();
        auto it = cands.find(c0);
        if (it == cands.end()) continue;
        Cand cand = std::move(it->second);
        cands.erase(it);
        if (!P.terms.count(cand.i) || !P.terms.count(cand.j)) continue;

        Legs li = pop_node(P, cand.i);
        Legs lj = pop_node(P, cand.j);
        if (P.track_flops) {
            P.flops += pair_flops(li, lj, P.sizes);
            if (P.flops >= P.flops_limit) return false;
        }
        int k = add_node(P, std::move(cand.klegs));
        P.path.push_back({cand.i, cand.j});
        node_size[k] = cand.ksize;

        // neighbors of k
        std::unordered_set<int> seen;
        seen.insert(k);
        const Legs& klegs2 = P.terms[k];
        int prev = -1;
        for (auto& l : klegs2) {
            if (l.ix == prev) continue;
            prev = l.ix;
            auto eit = P.edges.find(l.ix);
            if (eit == P.edges.end()) continue;
            auto& nodes = eit->second;
            if (max_neighbors && (int)nodes.size() > max_neighbors) continue;
            for (int nb : nodes) {
                if (seen.insert(nb).second) push(k, nb);
            }
        }
    }
    return true;
}

void finalize_by_size(Problem& P) {
    if (P.terms.size() <= 1) return;
    using E = std::pair<double, int>;
    std::priority_queue<E, std::vector<E>, std::greater<E>> q;
    for (auto& [i, legs] : P.terms) q.push({legs_size(legs, P.sizes), i});
    while (q.size() > 1) {
        auto [sa, a] = q.top();
        q.pop();
        auto [sb, b] = q.top();
        q.pop();
        int k = contract_nodes(P, a, b);
        q.push({legs_size(P.terms[k], P.sizes), k});
    }
}

// --------------------------------------------------------- optimal DP --

// minimize codes: 0=flops 1=max 2=size 3=write 4=combo 5=limit
double dp_cost(int code, double factor, Legs& temp,
               const std::vector<int>& appearances,
               const std::vector<double>& sizes, double si, double sj) {
    double cost = 1.0, size = 1.0;
    Legs kept;
    kept.reserve(temp.size());
    for (auto& l : temp) {
        double d = sizes[l.ix];
        cost *= d;
        if (l.cnt != appearances[l.ix]) {
            kept.push_back(l);
            size *= d;
        }
    }
    temp = std::move(kept);
    switch (code) {
        case 0: return si + sj + cost;
        case 1: return std::max(std::max(si, sj), cost);
        case 2: return std::max(std::max(si, sj), size);
        case 3: return si + sj + size;
        case 4: return si + sj + (cost + factor * size);
        default: return si + sj + std::max(cost, factor * size);
    }
}

struct SubInfo {
    Legs legs;
    double score;
    std::vector<std::pair<uint64_t, uint64_t>> path;
};

bool optimize_optimal_component(Problem& P, const std::vector<int>& where,
                                int code, double factor, double cost_cap,
                                bool search_outer) {
    int nterms = (int)where.size();
    if (nterms > 62) return false;  // bitmask limit; DP infeasible anyway

    std::vector<std::unordered_map<uint64_t, SubInfo>> best(nterms + 1);
    std::unordered_map<uint64_t, int> bit_to_node;
    for (int b = 0; b < nterms; ++b) {
        uint64_t bit = 1ULL << b;
        bit_to_node[bit] = where[b];
        best[1][bit] = {P.terms[where[b]], 0.0, {}};
    }

    while (best[nterms].empty()) {
        for (int m = 2; m <= nterms; ++m) {
            auto& best_m = best[m];
            for (int k = 1; k <= m / 2; ++k) {
                auto& A = best[k];
                auto& B = best[m - k];
                for (auto ai = A.begin(); ai != A.end(); ++ai) {
                    auto bi = (k == m - k) ? std::next(ai) : B.begin();
                    auto bend = (k == m - k) ? A.end() : B.end();
                    for (; bi != bend; ++bi) {
                        uint64_t sg_i = ai->first, sg_j = bi->first;
                        if (sg_i & sg_j) continue;
                        const Legs& li = ai->second.legs;
                        const Legs& lj = bi->second.legs;

                        Legs temp;
                        temp.reserve(li.size() + lj.size());
                        size_t ip = 0, jp = 0;
                        bool disjoint = !search_outer;
                        while (ip < li.size() && jp < lj.size()) {
                            if (li[ip].ix < lj[jp].ix) {
                                temp.push_back(li[ip++]);
                            } else if (li[ip].ix > lj[jp].ix) {
                                temp.push_back(lj[jp++]);
                            } else {
                                temp.push_back(
                                    {li[ip].ix, li[ip].cnt + lj[jp].cnt});
                                ++ip;
                                ++jp;
                                disjoint = false;
                            }
                        }
                        if (disjoint) continue;
                        while (ip < li.size()) temp.push_back(li[ip++]);
                        while (jp < lj.size()) temp.push_back(lj[jp++]);

                        double ns = dp_cost(code, factor, temp, P.appearances,
                                            P.sizes, ai->second.score,
                                            bi->second.score);
                        if (ns > cost_cap) continue;
                        uint64_t sg_k = sg_i | sg_j;
                        auto cur = best_m.find(sg_k);
                        if (cur == best_m.end() || ns < cur->second.score) {
                            SubInfo info;
                            info.legs = std::move(temp);
                            info.score = ns;
                            info.path = ai->second.path;
                            info.path.insert(info.path.end(),
                                             bi->second.path.begin(),
                                             bi->second.path.end());
                            info.path.push_back({sg_i, sg_j});
                            best_m[sg_k] = std::move(info);
                        }
                    }
                }
            }
        }
        cost_cap *= 2.0;
        if (!std::isfinite(cost_cap)) return false;
    }

    auto& final_info = best[nterms].begin()->second;
    for (auto& [sg_i, sg_j] : final_info.path) {
        int i = bit_to_node[sg_i];
        int j = bit_to_node[sg_j];
        int k = contract_nodes(P, i, j);
        bit_to_node[sg_i | sg_j] = k;
    }
    return true;
}

std::vector<std::vector<int>> components(Problem& P) {
    std::unordered_set<int> remaining;
    for (auto& kv : P.terms) remaining.insert(kv.first);
    std::vector<std::vector<int>> comps;
    while (!remaining.empty()) {
        int s = *remaining.begin();
        std::vector<int> comp{s};
        std::unordered_set<int> inc{s};
        std::vector<int> stack{s};
        remaining.erase(s);
        while (!stack.empty()) {
            int i = stack.back();
            stack.pop_back();
            for (auto& l : P.terms[i]) {
                auto it = P.edges.find(l.ix);
                if (it == P.edges.end()) continue;
                for (int j : it->second) {
                    if (j != i && inc.insert(j).second) {
                        comp.push_back(j);
                        stack.push_back(j);
                        remaining.erase(j);
                    }
                }
            }
        }
        std::sort(comp.begin(), comp.end());
        comps.push_back(std::move(comp));
    }
    std::sort(comps.begin(), comps.end());
    return comps;
}

// -------------------------------------------------------- marshalling --

Problem build_problem(int n_terms, const int* term_offsets,
                      const int* term_inds, int n_inds, const double* sizes,
                      const int* output_inds, int n_output) {
    Problem P;
    P.n_inputs = n_terms;
    P.sizes.assign(sizes, sizes + n_inds);
    P.appearances.assign(n_inds, 0);

    for (int i = 0; i < n_terms; ++i) {
        Legs legs;
        for (int p = term_offsets[i]; p < term_offsets[i + 1]; ++p) {
            int ix = term_inds[p];
            if (P.sizes[ix] == 1.0) continue;  // strip size-1
            legs.push_back({ix, 1});
            P.appearances[ix]++;
        }
        std::sort(legs.begin(), legs.end(),
                  [](const Leg& a, const Leg& b) { return a.ix < b.ix; });
        // register edges (dedup)
        int prev = -1;
        for (auto& l : legs) {
            if (l.ix != prev) P.edges[l.ix].push_back(i);
            prev = l.ix;
        }
        P.terms.emplace(i, std::move(legs));
    }
    for (int o = 0; o < n_output; ++o) {
        int ix = output_inds[o];
        if (P.sizes[ix] != 1.0) P.appearances[ix]++;
    }
    P.ssa = n_terms;
    return P;
}

int write_path(const Problem& P, int* out_path) {
    int n = (int)P.path.size();
    for (int s = 0; s < n; ++s) {
        out_path[2 * s] = P.path[s].first;
        out_path[2 * s + 1] = P.path[s].second;
    }
    return n;
}

}  // namespace

extern "C" {

// returns number of path steps written (pairs; second == -1 for single
// steps), or -1 on error
int ctg_optimize_greedy(int n_terms, const int* term_offsets,
                        const int* term_inds, int n_inds,
                        const double* sizes, const int* output_inds,
                        int n_output, double costmod, double temperature,
                        int max_neighbors, int do_simplify,
                        uint64_t seed, int* out_path) {
    try {
        Problem P = build_problem(n_terms, term_offsets, term_inds, n_inds,
                                  sizes, output_inds, n_output);
        Rng rng(seed);
        if (do_simplify) simplify(P);
        optimize_greedy_core(P, costmod, temperature, max_neighbors, rng);
        finalize_by_size(P);
        return write_path(P, out_path);
    } catch (...) {
        return -1;
    }
}

// batched random greedy: samples costmod ~ U(range) and temperature ~
// logU(range) per trial, tracks flops, early-aborts losing trials.
// Returns path length; *out_log10_flops gets the best trial's log10 flops.
int ctg_optimize_random_greedy(int n_terms, const int* term_offsets,
                               const int* term_inds, int n_inds,
                               const double* sizes, const int* output_inds,
                               int n_output, int ntrials, double costmod_lo,
                               double costmod_hi, double temp_lo,
                               double temp_hi, int max_neighbors,
                               int do_simplify, uint64_t seed,
                               int* out_path, double* out_log10_flops) {
    try {
        Problem base = build_problem(n_terms, term_offsets, term_inds,
                                     n_inds, sizes, output_inds, n_output);
        Rng rng(seed);
        base.track_flops = true;  // include simplification-step flops
        if (do_simplify) simplify(base);

        double best_flops = std::numeric_limits<double>::infinity();
        std::vector<std::pair<int, int>> best_path;

        for (int t = 0; t < ntrials; ++t) {
            Problem P = base;  // copy (keeps base's simplify flops)
            P.flops_limit = best_flops;
            double cm = rng.uniform(costmod_lo, costmod_hi);
            double tp;
            if (temp_lo == temp_hi) {
                tp = temp_lo;
            } else {
                double llo = std::log(std::max(temp_lo, 1e-9));
                double lhi = std::log(std::max(temp_hi, 1e-9));
                tp = std::exp(rng.uniform(llo, lhi));
            }
            bool ok = optimize_greedy_core(P, cm, tp, max_neighbors, rng);
            if (!ok) continue;
            finalize_by_size(P);
            if (P.flops < best_flops) {
                best_flops = P.flops;
                best_path = P.path;
            }
        }

        if (best_path.empty()) {
            Problem P = base;
            optimize_greedy_core(P, 1.0, 0.0, max_neighbors, rng);
            finalize_by_size(P);
            best_flops = P.flops;
            best_path = P.path;
        }

        *out_log10_flops = std::log10(std::max(best_flops, 1.0));
        int n = (int)best_path.size();
        for (int s = 0; s < n; ++s) {
            out_path[2 * s] = best_path[s].first;
            out_path[2 * s + 1] = best_path[s].second;
        }
        return n;
    } catch (...) {
        return -1;
    }
}

// minimize codes: 0=flops 1=max 2=size 3=write 4=combo 5=limit
// returns path length, or -1 on error, -2 if a component exceeds the
// 62-term bitmask limit (caller should fall back to Python)
int ctg_optimize_optimal(int n_terms, const int* term_offsets,
                         const int* term_inds, int n_inds,
                         const double* sizes, const int* output_inds,
                         int n_output, int minimize_code, double factor,
                         double cost_cap, int search_outer, int do_simplify,
                         int* out_path) {
    try {
        Problem P = build_problem(n_terms, term_offsets, term_inds, n_inds,
                                  sizes, output_inds, n_output);
        if (do_simplify) simplify(P);
        for (auto& comp : components(P)) {
            if (comp.size() < 2) continue;
            if (!optimize_optimal_component(P, comp, minimize_code, factor,
                                            cost_cap, search_outer != 0))
                return -2;
        }
        finalize_by_size(P);
        return write_path(P, out_path);
    } catch (...) {
        return -1;
    }
}

}  // extern "C"

// ------------------------------------------------------- compressed replay --
//
// Native equivalent of the reference's Rust HyperGraph extension used for
// the compressed-cost hot loop (SURVEY.md §2.9: contract / compress /
// node_size / neighborhood ops): replay a contraction order on a mutable
// hypergraph with chi-capped multibond compression, accumulating
// flops / write / max_size / peak_size exactly as the Python
// CompressedStatsTracker does.

namespace {

struct HG {
    // edge id -> (sorted) node ids; node id -> edge ids
    std::unordered_map<int, std::vector<int>> enodes;
    std::unordered_map<int, std::vector<int>> nedges;
    std::vector<double> esize;
    std::unordered_set<int> output_edges;

    double edge_size(int e) const { return esize[e]; }

    double node_size(int n) const {
        double s = 1.0;
        for (int e : nedges.at(n)) s *= esize[e];
        return s;
    }

    double neighborhood_size(const std::vector<int>& nodes) const {
        std::unordered_set<int> hood;
        for (int n : nodes)
            for (int e : nedges.at(n))
                for (int nn : enodes.at(e)) hood.insert(nn);
        double s = 0.0;
        for (int n : hood) s += node_size(n);
        return s;
    }

    double contract_pair_cost(int i, int j) const {
        std::unordered_set<int> seen;
        double c = 1.0;
        for (int e : nedges.at(i))
            if (seen.insert(e).second) c *= esize[e];
        for (int e : nedges.at(j))
            if (seen.insert(e).second) c *= esize[e];
        return c;
    }

    double neighborhood_compress_cost(
        double chi, const std::vector<int>& nodes) const {
        std::unordered_set<int> region;
        for (int n : nodes)
            for (int e : nedges.at(n)) region.insert(e);
        std::unordered_set<int> node_set(nodes.begin(), nodes.end());
        // group edges by incident node set
        std::map<std::vector<int>, std::vector<int>> groups;
        for (int e : region) {
            if (output_edges.count(e)) continue;
            std::vector<int> key = enodes.at(e);
            std::sort(key.begin(), key.end());
            groups[key].push_back(e);
        }
        double C = 0.0;
        for (auto& [key, group] : groups) {
            // skip bonds fully inside the region
            bool inside = key.size() == node_set.size();
            if (inside) {
                for (int n : key)
                    if (!node_set.count(n)) { inside = false; break; }
            }
            if (inside) continue;
            double da = 1.0;
            for (int e : group) da *= esize[e];
            if (da > chi) {
                for (int n : key) {
                    double db = 1.0;
                    std::unordered_set<int> gset(group.begin(), group.end());
                    for (int e : nedges.at(n))
                        if (!gset.count(e)) db *= esize[e];
                    double lo = std::min(da, db), hi = std::max(da, db);
                    C += lo * lo * hi;
                }
            }
        }
        return C;
    }

    void remove_edge(int e) {
        for (int n : enodes.at(e)) {
            auto& v = nedges.at(n);
            v.erase(std::remove(v.begin(), v.end(), e), v.end());
        }
        enodes.erase(e);
    }

    int contract(int i, int j, int new_id) {
        // collect unique edges of i and j
        std::vector<int> all;
        for (int e : nedges.at(i)) all.push_back(e);
        for (int e : nedges.at(j)) all.push_back(e);
        std::sort(all.begin(), all.end());
        all.erase(std::unique(all.begin(), all.end()), all.end());
        // detach i and j from their edges
        for (int nid : {i, j}) {
            for (int e : nedges.at(nid)) {
                auto& v = enodes.at(e);
                v.erase(std::remove(v.begin(), v.end(), nid), v.end());
            }
            nedges.erase(nid);
        }
        std::vector<int> keep;
        for (int e : all) {
            if (!enodes.at(e).empty() || output_edges.count(e)) {
                keep.push_back(e);
                enodes.at(e).push_back(new_id);
            } else {
                enodes.erase(e);
            }
        }
        nedges[new_id] = std::move(keep);
        return new_id;
    }

    void compress(double chi, const std::vector<int>& edges) {
        std::map<std::vector<int>, std::vector<int>> groups;
        std::unordered_set<int> seen;
        for (int e : edges) {
            if (!seen.insert(e).second) continue;
            if (output_edges.count(e) || !enodes.count(e)) continue;
            std::vector<int> key = enodes.at(e);
            std::sort(key.begin(), key.end());
            groups[key].push_back(e);
        }
        for (auto& [key, group] : groups) {
            if (group.size() > 1) {
                double new_size = 1.0;
                for (int e : group) new_size *= esize[e];
                int keep = group[0];
                for (size_t k = 1; k < group.size(); ++k)
                    remove_edge(group[k]);
                esize[keep] = std::min(new_size, chi);
            }
        }
    }
};

}  // namespace

extern "C" {

// replay a contraction order with chi-capped compression; writes
// [flops, write, max_size, peak_size] into out4. Node ids: leaves
// 0..n_terms-1, step k produces node n_terms+k. Returns 0 on success.
int ctg_compressed_stats(
    int n_terms, const int* term_offsets, const int* term_inds,
    int n_inds, const double* sizes, const int* output_inds,
    int n_output, const int* order_pairs, int n_steps, double chi,
    int compress_late, double* out4) {
    try {
        HG hg;
        hg.esize.assign(sizes, sizes + n_inds);
        for (int i = 0; i < n_terms; ++i) {
            std::vector<int> es;
            for (int p = term_offsets[i]; p < term_offsets[i + 1]; ++p) {
                es.push_back(term_inds[p]);
                hg.enodes[term_inds[p]].push_back(i);
            }
            hg.nedges[i] = std::move(es);
        }
        for (int o = 0; o < n_output; ++o)
            hg.output_edges.insert(output_inds[o]);

        // tracker state (mirrors CompressedStatsTracker exactly)
        double total_size = 0.0, max_size = 0.0;
        for (auto& [n, _] : hg.nedges) {
            double s = hg.node_size(n);
            max_size = std::max(max_size, s);
            total_size += s;
        }
        double write = total_size, peak_size = total_size, flops = 0.0;

        for (int k = 0; k < n_steps; ++k) {
            int li = order_pairs[2 * k];
            int ri = order_pairs[2 * k + 1];
            int pid = n_terms + k;
            double size_change = 0.0, flops_change = 0.0;

            if (compress_late) {
                std::vector<int> lr{li, ri};
                size_change -= hg.neighborhood_size(lr);
                flops_change += hg.neighborhood_compress_cost(chi, lr);
                // copy: compress mutates the node's edge list
                std::vector<int> le = hg.nedges.at(li);
                hg.compress(chi, le);
                std::vector<int> re = hg.nedges.at(ri);
                hg.compress(chi, re);
                size_change += hg.neighborhood_size(lr);
            }

            size_change -= hg.node_size(li) + hg.node_size(ri);
            flops_change += hg.contract_pair_cost(li, ri);
            hg.contract(li, ri, pid);
            double contracted_size = hg.node_size(pid);
            size_change += contracted_size;
            double total_post = total_size + size_change;

            if (!compress_late) {
                std::vector<int> pp{pid};
                size_change -= hg.neighborhood_size(pp);
                flops_change += hg.neighborhood_compress_cost(chi, pp);
                std::vector<int> pe = hg.nedges.at(pid);
                hg.compress(chi, pe);
                size_change += hg.neighborhood_size(pp);
            }

            max_size = std::max(max_size, contracted_size);
            peak_size = std::max(peak_size, total_post);
            total_size += size_change;
            flops += flops_change;
            write += contracted_size;
        }

        out4[0] = flops;
        out4[1] = write;
        out4[2] = max_size;
        out4[3] = peak_size;
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multilevel hypergraph partitioner (the in-house kahypar-quality slot).
//
// Reference obligation: SURVEY.md 2.9 / path_kahypar.py:50-146 - the
// reference links the kahypar C++ library, which is no dependency here,
// so this implements the same multilevel recipe natively:
//   coarsening  : heavy-connectivity matching (score = sum w(e)/(|e|-1))
//   initial     : randomized greedy region growing (several tries)
//   refinement  : 2-way hyperedge FM with per-pass rollback
//   k-way       : recursive bisection with proportional target weights
// ---------------------------------------------------------------------------

namespace ctgpart {

struct XorShift {
    unsigned long long s;
    explicit XorShift(unsigned long long seed) : s(seed ? seed : 88172645463325252ULL) {}
    unsigned long long next() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
    }
    // uniform in [0, n)
    int below(int n) { return (int)(next() % (unsigned long long)n); }
    double uniform() { return (double)(next() >> 11) * (1.0 / 9007199254740992.0); }
};

struct HG {
    int nv = 0, ne = 0;
    std::vector<long long> eptr;      // ne+1
    std::vector<int> pins;            // eptr[ne]
    std::vector<double> ew;           // ne
    std::vector<double> nw;           // nv
    // node -> incident edges CSR
    std::vector<long long> vptr;
    std::vector<int> vedges;

    void build_incidence() {
        vptr.assign(nv + 1, 0);
        for (int e = 0; e < ne; ++e)
            for (long long p = eptr[e]; p < eptr[e + 1]; ++p)
                vptr[pins[p] + 1]++;
        for (int v = 0; v < nv; ++v) vptr[v + 1] += vptr[v];
        vedges.assign(vptr[nv], 0);
        std::vector<long long> cur(vptr.begin(), vptr.end() - 1);
        for (int e = 0; e < ne; ++e)
            for (long long p = eptr[e]; p < eptr[e + 1]; ++p)
                vedges[cur[pins[p]]++] = e;
    }
    double total_weight() const {
        double t = 0; for (double w : nw) t += w; return t;
    }
};

// 2-way FM refinement of `part` (0/1 per node). Target weight of part 0
// is w0t with tolerance eps (relative to total).
static double fm_refine(const HG& g, std::vector<int>& part,
                        double w0t, double eps, int max_passes,
                        XorShift& rng) {
    const double total = g.total_weight();
    const double lo = w0t - eps * total, hi = w0t + eps * total;
    std::vector<int> cnt0(g.ne), cnt1(g.ne);
    auto recount = [&]() {
        std::fill(cnt0.begin(), cnt0.end(), 0);
        std::fill(cnt1.begin(), cnt1.end(), 0);
        for (int e = 0; e < g.ne; ++e)
            for (long long p = g.eptr[e]; p < g.eptr[e + 1]; ++p)
                (part[g.pins[p]] ? cnt1[e] : cnt0[e])++;
    };
    recount();
    double w0 = 0;
    for (int v = 0; v < g.nv; ++v) if (!part[v]) w0 += g.nw[v];
    auto cut_of = [&]() {
        double c = 0;
        for (int e = 0; e < g.ne; ++e)
            if (cnt0[e] > 0 && cnt1[e] > 0) c += g.ew[e];
        return c;
    };
    double cut = cut_of();

    auto gain_of = [&](int v) {
        double gval = 0;
        int from = part[v];
        for (long long q = g.vptr[v]; q < g.vptr[v + 1]; ++q) {
            int e = g.vedges[q];
            int cf = from ? cnt1[e] : cnt0[e];
            int ct = from ? cnt0[e] : cnt1[e];
            if (cf == 1) gval += g.ew[e];
            if (ct == 0) gval -= g.ew[e];
        }
        return gval;
    };

    for (int pass = 0; pass < max_passes; ++pass) {
        // lazy max-heap of (gain, v); stale entries skipped
        std::vector<std::pair<double, int>> heap;
        heap.reserve(g.nv);
        std::vector<double> cached(g.nv);
        std::vector<char> locked(g.nv, 0);
        for (int v = 0; v < g.nv; ++v) {
            cached[v] = gain_of(v);
            heap.push_back({cached[v] + 1e-9 * rng.uniform(), v});
        }
        std::make_heap(heap.begin(), heap.end());
        std::vector<int> moved;
        moved.reserve(g.nv);
        double best_delta = 0, delta = 0;
        int best_len = 0;
        while (!heap.empty()) {
            std::pop_heap(heap.begin(), heap.end());
            auto [gv, v] = heap.back();
            heap.pop_back();
            if (locked[v]) continue;
            if (gv - 1e-6 > cached[v] + 1e-6) continue;  // stale high
            int from = part[v];
            // balance check
            double nw0 = w0 + (from == 0 ? -g.nw[v] : g.nw[v]);
            if (nw0 < lo || nw0 > hi) continue;
            // apply move
            locked[v] = 1;
            double realg = gain_of(v);
            part[v] = 1 - from;
            w0 = nw0;
            delta += realg;
            moved.push_back(v);
            for (long long q = g.vptr[v]; q < g.vptr[v + 1]; ++q) {
                int e = g.vedges[q];
                if (from == 0) { cnt0[e]--; cnt1[e]++; }
                else { cnt1[e]--; cnt0[e]++; }
                // re-push neighbors with refreshed gains
                for (long long p = g.eptr[e]; p < g.eptr[e + 1]; ++p) {
                    int u = g.pins[p];
                    if (!locked[u]) {
                        cached[u] = gain_of(u);
                        heap.push_back({cached[u] + 1e-9 * rng.uniform(), u});
                        std::push_heap(heap.begin(), heap.end());
                    }
                }
            }
            if (delta > best_delta + 1e-12) {
                best_delta = delta;
                best_len = (int)moved.size();
            }
        }
        // roll back past the best prefix
        for (int i = (int)moved.size() - 1; i >= best_len; --i) {
            int v = moved[i];
            int from = part[v];
            part[v] = 1 - from;
            w0 += (from == 0 ? -g.nw[v] : g.nw[v]);
            for (long long q = g.vptr[v]; q < g.vptr[v + 1]; ++q) {
                int e = g.vedges[q];
                if (from == 0) { cnt0[e]--; cnt1[e]++; }
                else { cnt1[e]--; cnt0[e]++; }
            }
        }
        cut -= best_delta;
        if (best_delta <= 1e-12) break;
    }
    return cut;
}

// one coarsening level by heavy-connectivity matching; returns the
// coarse graph and the node map (fine -> coarse). When `part` is
// given, only nodes on the same side may match (V-cycle constraint:
// the current partition projects exactly onto the coarse graph).
static bool coarsen(const HG& g, HG& cg, std::vector<int>& cmap,
                    XorShift& rng,
                    const std::vector<int>* part = nullptr) {
    cmap.assign(g.nv, -1);
    std::vector<int> order(g.nv);
    for (int v = 0; v < g.nv; ++v) order[v] = v;
    for (int v = g.nv - 1; v > 0; --v)
        std::swap(order[v], order[rng.below(v + 1)]);
    std::vector<double> score(g.nv, 0.0);
    std::vector<int> touched;
    int nc = 0;
    for (int oi = 0; oi < g.nv; ++oi) {
        int u = order[oi];
        if (cmap[u] >= 0) continue;
        // score unmatched neighbors
        touched.clear();
        for (long long q = g.vptr[u]; q < g.vptr[u + 1]; ++q) {
            int e = g.vedges[q];
            long long sz = g.eptr[e + 1] - g.eptr[e];
            if (sz < 2) continue;
            double s = g.ew[e] / (double)(sz - 1);
            for (long long p = g.eptr[e]; p < g.eptr[e + 1]; ++p) {
                int v = g.pins[p];
                if (v == u || cmap[v] >= 0) continue;
                if (part && (*part)[v] != (*part)[u]) continue;
                if (score[v] == 0.0) touched.push_back(v);
                score[v] += s;
            }
        }
        int best = -1;
        double bs = 0;
        for (int v : touched) {
            // mildly prefer light partners (keeps weights balanced)
            double s = score[v] / (1.0 + 0.1 * g.nw[v]);
            if (s > bs) { bs = s; best = v; }
            score[v] = 0.0;
        }
        cmap[u] = nc;
        if (best >= 0) cmap[best] = nc;
        nc++;
    }
    if (nc >= g.nv) return false;  // nothing matched
    cg.nv = nc;
    cg.nw.assign(nc, 0.0);
    for (int v = 0; v < g.nv; ++v) cg.nw[cmap[v]] += g.nw[v];
    // edges: remap pins, dedupe within edge, drop singles, merge
    // identical pin sets by hashing
    cg.eptr.clear(); cg.pins.clear(); cg.ew.clear();
    cg.eptr.push_back(0);
    std::unordered_map<unsigned long long, std::vector<int>> bucket;
    std::vector<int> tmp;
    for (int e = 0; e < g.ne; ++e) {
        tmp.clear();
        for (long long p = g.eptr[e]; p < g.eptr[e + 1]; ++p)
            tmp.push_back(cmap[g.pins[p]]);
        std::sort(tmp.begin(), tmp.end());
        tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
        if ((int)tmp.size() < 2) continue;
        unsigned long long h = 1469598103934665603ULL;
        for (int v : tmp) {
            h ^= (unsigned long long)(v + 1);
            h *= 1099511628211ULL;
        }
        bool merged = false;
        auto it = bucket.find(h);
        if (it != bucket.end()) {
            for (int ce : it->second) {
                long long a = cg.eptr[ce], b = cg.eptr[ce + 1];
                if (b - a == (long long)tmp.size() &&
                    std::equal(tmp.begin(), tmp.end(),
                               cg.pins.begin() + a)) {
                    cg.ew[ce] += g.ew[e];
                    merged = true;
                    break;
                }
            }
        }
        if (!merged) {
            int ce = (int)cg.ew.size();
            for (int v : tmp) cg.pins.push_back(v);
            cg.eptr.push_back((long long)cg.pins.size());
            cg.ew.push_back(g.ew[e]);
            bucket[h].push_back(ce);
        }
    }
    cg.ne = (int)cg.ew.size();
    cg.build_incidence();
    return true;
}

// greedy region growing: grow part 0 from a random seed to weight w0t
static void grow_initial(const HG& g, std::vector<int>& part,
                         double w0t, XorShift& rng) {
    part.assign(g.nv, 1);
    if (g.nv == 0) return;
    std::vector<double> conn(g.nv, 0.0);
    std::vector<char> in0(g.nv, 0);
    std::vector<int> cnt_in0(g.ne, 0);
    double w0 = 0;
    int start = rng.below(g.nv);
    int cur = start;
    while (w0 < w0t) {
        in0[cur] = 1;
        part[cur] = 0;
        w0 += g.nw[cur];
        for (long long q = g.vptr[cur]; q < g.vptr[cur + 1]; ++q) {
            int e = g.vedges[q];
            cnt_in0[e]++;
            long long sz = g.eptr[e + 1] - g.eptr[e];
            double s = g.ew[e] / (double)(sz > 1 ? sz - 1 : 1);
            for (long long p = g.eptr[e]; p < g.eptr[e + 1]; ++p) {
                int v = g.pins[p];
                if (!in0[v]) conn[v] += s;
            }
        }
        if (w0 >= w0t) break;
        int best = -1;
        double bs = -1;
        for (int v = 0; v < g.nv; ++v)
            if (!in0[v] && conn[v] > bs) { bs = conn[v]; best = v; }
        if (best < 0 || bs <= 0) {
            // disconnected: jump to a random unassigned node
            best = -1;
            for (int t = 0; t < g.nv; ++t) {
                int v = rng.below(g.nv);
                if (!in0[v]) { best = v; break; }
            }
            if (best < 0) {
                for (int v = 0; v < g.nv; ++v)
                    if (!in0[v]) { best = v; break; }
            }
            if (best < 0) break;
        }
        cur = best;
    }
}

// multilevel 2-way partition; returns cut value
static double bisect(const HG& g0, std::vector<int>& part,
                     double frac0, double eps, XorShift& rng) {
    const int COARSE_LIMIT = 64;
    double total = g0.total_weight();
    double w0t = frac0 * total;

    // ---- initial multilevel pass ------------------------------------
    std::vector<HG> levels;
    std::vector<std::vector<int>> maps;
    levels.push_back(g0);
    while (levels.back().nv > COARSE_LIMIT) {
        HG cg;
        std::vector<int> cmap;
        if (!coarsen(levels.back(), cg, cmap, rng)) break;
        if (cg.nv > (int)(0.95 * levels.back().nv)) break;  // stalled
        levels.push_back(std::move(cg));
        maps.push_back(std::move(cmap));
    }
    HG& cg = levels.back();

    // several initial tries + FM, keep best
    std::vector<int> bestp;
    double bestcut = -1;
    for (int t = 0; t < 32; ++t) {
        std::vector<int> p;
        grow_initial(cg, p, w0t, rng);
        double c = fm_refine(cg, p, w0t, eps, 6, rng);
        if (bestcut < 0 || c < bestcut) { bestcut = c; bestp = p; }
    }
    part = bestp;
    // uncoarsen + refine
    for (int lvl = (int)maps.size() - 1; lvl >= 0; --lvl) {
        std::vector<int> fine(levels[lvl].nv);
        for (int v = 0; v < levels[lvl].nv; ++v)
            fine[v] = part[maps[lvl][v]];
        part = std::move(fine);
        bestcut = fm_refine(levels[lvl], part, w0t, eps, 4, rng);
    }

    // ---- V-cycles: re-coarsen under the partition constraint --------
    // (matching only within sides, so the cut projects exactly), then
    // refine back down. Each cycle sees a different random matching,
    // giving FM fresh coarse-grain moves - the standard kahypar-style
    // quality iteration.
    for (int vc = 0; vc < 3; ++vc) {
        std::vector<HG> lv;
        std::vector<std::vector<int>> mp;
        std::vector<std::vector<int>> pl;
        lv.push_back(g0);
        pl.push_back(part);
        while (lv.back().nv > COARSE_LIMIT) {
            HG cgi;
            std::vector<int> cmap;
            if (!coarsen(lv.back(), cgi, cmap, rng, &pl.back()))
                break;
            if (cgi.nv > (int)(0.95 * lv.back().nv)) break;
            std::vector<int> cpart(cgi.nv, 0);
            for (int v = 0; v < lv.back().nv; ++v)
                cpart[cmap[v]] = pl.back()[v];
            lv.push_back(std::move(cgi));
            mp.push_back(std::move(cmap));
            pl.push_back(std::move(cpart));
        }
        std::vector<int> p = pl.back();
        fm_refine(lv.back(), p, w0t, eps, 6, rng);
        double cut = -1;
        for (int lvl = (int)mp.size() - 1; lvl >= 0; --lvl) {
            std::vector<int> fine(lv[lvl].nv);
            for (int v = 0; v < lv[lvl].nv; ++v)
                fine[v] = p[mp[lvl][v]];
            p = std::move(fine);
            cut = fm_refine(lv[lvl], p, w0t, eps, 4, rng);
        }
        if (cut < 0)
            cut = fm_refine(g0, p, w0t, eps, 1, rng);
        if (cut < bestcut - 1e-12) {
            bestcut = cut;
            part = std::move(p);
        } else {
            break;  // converged
        }
    }
    return bestcut;
}

// recursive k-way
static void kway(const HG& g, std::vector<int>& membership, int k,
                 double eps, XorShift& rng, int id_base) {
    membership.assign(g.nv, id_base);
    if (k <= 1 || g.nv <= 1) {
        return;
    }
    int k0 = (k + 1) / 2, k1 = k - k0;
    double frac0 = (double)k0 / (double)k;
    std::vector<int> part;
    bisect(g, part, frac0, eps, rng);
    // split into two sub-hypergraphs
    for (int side = 0; side < 2; ++side) {
        HG sg;
        std::vector<int> local(g.nv, -1);
        for (int v = 0; v < g.nv; ++v)
            if (part[v] == side) {
                local[v] = sg.nv++;
            }
        sg.nw.resize(sg.nv);
        for (int v = 0; v < g.nv; ++v)
            if (local[v] >= 0) sg.nw[local[v]] = g.nw[v];
        sg.eptr.push_back(0);
        std::vector<int> tmp;
        for (int e = 0; e < g.ne; ++e) {
            tmp.clear();
            for (long long p = g.eptr[e]; p < g.eptr[e + 1]; ++p) {
                int v = g.pins[p];
                if (local[v] >= 0) tmp.push_back(local[v]);
            }
            if ((int)tmp.size() < 2) continue;
            for (int v : tmp) sg.pins.push_back(v);
            sg.eptr.push_back((long long)sg.pins.size());
            sg.ew.push_back(g.ew[e]);
        }
        sg.ne = (int)sg.ew.size();
        sg.build_incidence();
        std::vector<int> subm;
        int kk = side == 0 ? k0 : k1;
        int base = side == 0 ? id_base : id_base + k0;
        kway(sg, subm, kk, eps, rng, base);
        for (int v = 0; v < g.nv; ++v)
            if (part[v] == side && local[v] >= 0)
                membership[v] = subm[local[v]];
    }
}

}  // namespace ctgpart

extern "C" int ctg_partition(
    int n_nodes, int n_edges,
    const long long* eptr, const int* pins,
    const double* edge_w, const double* node_w,
    int k, double eps, unsigned long long seed,
    int* out_membership) {
    try {
        ctgpart::HG g;
        using ctgpart::XorShift;
        g.nv = n_nodes;
        g.ne = n_edges;
        g.eptr.assign(eptr, eptr + n_edges + 1);
        g.pins.assign(pins, pins + eptr[n_edges]);
        g.ew.assign(edge_w, edge_w + n_edges);
        g.nw.assign(node_w, node_w + n_nodes);
        g.build_incidence();
        XorShift rng(seed);
        std::vector<int> membership(n_nodes, 0);
        ctgpart::kway(g, membership, k, eps, rng, 0);
        for (int v = 0; v < n_nodes; ++v) out_membership[v] = membership[v];
        return 0;
    } catch (...) {
        return -1;
    }
}

