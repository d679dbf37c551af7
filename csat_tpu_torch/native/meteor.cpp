// METEOR scorer, native implementation (exact + Porter-stem alignment,
// METEOR-1.5 English parameters; classic 2005 exact-match mode retained).
//
// The reference runs METEOR as a JVM subprocess over a stdio line protocol
// (valid_metrices/meteor/meteor.py:192-290 there, jar absent).
// This library provides the same capability natively. Semantics are held
// identical to csat_tpu_torch/metrics/meteor.py by differential tests:
//
//   * one-to-one alignment maximizing (matches, module weight, -chunks)
//     lexicographically via branch-and-bound (adjacent-first, exact-before-
//     stem ordering; on node-cap the best *complete* solution found so far
//     is used, so the (matches, chunks) pair is always consistent);
//   * METEOR-1.5 English parameters alpha=.85 beta=.2 gamma=.6 delta=.75,
//     module weights exact=1.0 stem=0.6 synonym=0.8, content/function-word
//     weighting; the synonym table (stem-indexed groups) is fed at load
//     time from csat_tpu_torch/metrics/synonyms_en.txt via meteor_set_synonyms_c;
//   * Porter (1980) stemmer (the jar uses Snowball English — documented
//     delta in the Python module docstring).
//
// Inputs arrive pre-normalized (lowercase, punctuation split) from the
// Python wrapper as whitespace-joined UTF-8 token strings.
//
// Exposed via a C ABI for ctypes:
//   double meteor_score_c(const char* hyp, const char* ref, int v15)
//
// The code is the JAX package's csat_tpu/native/meteor.cpp, comments aside.
//
// Build:  g++ -O2 -shared -fPIC -o libmeteor.so meteor.cpp
// (csat_tpu_torch/native/__init__.py builds it on first use)

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double ALPHA = 0.85, BETA = 0.2, GAMMA = 0.6, DELTA = 0.75;
constexpr double W_EXACT = 1.0, W_STEM = 0.6, W_SYN = 0.8;
// integer module weights (x5) inside the alignment search so weight ties
// are exact — mirrors csat_tpu_torch/metrics/meteor.py WI_EXACT/WI_STEM/WI_SYN.
// Stage order mirrors the jar: exact → stem → synonym (a stem-equal pair
// is claimed by the stem module even when the words also share a group).
constexpr int WI_EXACT = 5, WI_STEM = 3, WI_SYN = 4, WI_SCALE = 5;

std::vector<std::string> tokenize(const char* s) {
    std::vector<std::string> out;
    std::istringstream iss(s);
    std::string tok;
    while (iss >> tok) out.push_back(tok);
    return out;
}

const std::set<std::string>& function_words() {
    // mirror of csat_tpu_torch/metrics/meteor.py FUNCTION_WORDS
    static const std::set<std::string> words = [] {
        const char* raw =
            "a an the and or but nor so yet for of in on at by to from with "
            "without into onto upon about above below under over between "
            "among through during before after since until against within "
            "along across behind beyond near off out up down is am are was "
            "were be been being do does did done have has had having will "
            "would shall should can could may might must ought i you he she "
            "it we they me him her us them my your his its our their mine "
            "yours hers ours theirs this that these those who whom whose "
            "which what as if then than when while where why how not no any "
            "some each every either neither both all most more less few much "
            "many own same such only very too also just there here "
            ". , ; : ! ? ' \" ` ( ) [ ] { } - -- ... </s> <s> <pad> <unk> "
            "<???>";
        std::set<std::string> w;
        for (const auto& t : tokenize(raw)) w.insert(t);
        return w;
    }();
    return words;
}

// ------------------------------------------------------------------
// Porter (1980) stemmer — mirror of csat_tpu_torch/metrics/meteor.py
// ------------------------------------------------------------------

bool is_cons(const std::string& w, int i) {
    char c = w[i];
    if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
    if (c == 'y') return i == 0 || !is_cons(w, i - 1);
    return true;
}

int measure(const std::string& stem) {
    int m = 0;
    bool prev_v = false;
    for (int i = 0; i < (int)stem.size(); ++i) {
        bool v = !is_cons(stem, i);
        if (!v && prev_v) ++m;  // count v->c transitions
        prev_v = v;
    }
    return m;
}

bool has_vowel(const std::string& stem) {
    for (int i = 0; i < (int)stem.size(); ++i)
        if (!is_cons(stem, i)) return true;
    return false;
}

bool ends_double_cons(const std::string& w) {
    int n = (int)w.size();
    return n >= 2 && w[n - 1] == w[n - 2] && is_cons(w, n - 1);
}

bool ends_cvc(const std::string& w) {
    int n = (int)w.size();
    if (n < 3) return false;
    if (!(is_cons(w, n - 3) && !is_cons(w, n - 2) && is_cons(w, n - 1)))
        return false;
    char c = w[n - 1];
    return c != 'w' && c != 'x' && c != 'y';
}

bool ends_with(const std::string& w, const std::string& suf) {
    return w.size() >= suf.size() &&
           w.compare(w.size() - suf.size(), suf.size(), suf) == 0;
}

bool all_alpha(const std::string& w) {
    for (char c : w)
        if (c < 'a' || c > 'z') return false;
    return true;
}

std::string porter_stem(const std::string& word) {
    std::string w = word;
    if (w.size() <= 2 || !all_alpha(w)) return w;

    // Step 1a
    if (ends_with(w, "sses")) w.resize(w.size() - 2);
    else if (ends_with(w, "ies")) w.resize(w.size() - 2);
    else if (ends_with(w, "ss")) {}
    else if (ends_with(w, "s")) w.resize(w.size() - 1);

    // Step 1b
    bool flag_1b = false;
    if (ends_with(w, "eed")) {
        if (measure(w.substr(0, w.size() - 3)) > 0) w.resize(w.size() - 1);
    } else if (ends_with(w, "ed")) {
        if (has_vowel(w.substr(0, w.size() - 2))) {
            w.resize(w.size() - 2);
            flag_1b = true;
        }
    } else if (ends_with(w, "ing")) {
        if (has_vowel(w.substr(0, w.size() - 3))) {
            w.resize(w.size() - 3);
            flag_1b = true;
        }
    }
    if (flag_1b) {
        if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz"))
            w += "e";
        else if (ends_double_cons(w) && !ends_with(w, "l") &&
                 !ends_with(w, "s") && !ends_with(w, "z"))
            w.resize(w.size() - 1);
        else if (measure(w) == 1 && ends_cvc(w))
            w += "e";
    }

    // Step 1c
    if (ends_with(w, "y") && has_vowel(w.substr(0, w.size() - 1)))
        w[w.size() - 1] = 'i';

    // Step 2
    static const std::pair<const char*, const char*> step2[] = {
        {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"},
        {"anci", "ance"}, {"izer", "ize"}, {"abli", "able"}, {"alli", "al"},
        {"entli", "ent"}, {"eli", "e"}, {"ousli", "ous"}, {"ization", "ize"},
        {"ation", "ate"}, {"ator", "ate"}, {"alism", "al"},
        {"iveness", "ive"}, {"fulness", "ful"}, {"ousness", "ous"},
        {"aliti", "al"}, {"iviti", "ive"}, {"biliti", "ble"}};
    for (const auto& [suf, rep] : step2) {
        if (ends_with(w, suf)) {
            std::string stem = w.substr(0, w.size() - strlen(suf));
            if (measure(stem) > 0) w = stem + rep;
            break;
        }
    }

    // Step 3
    static const std::pair<const char*, const char*> step3[] = {
        {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
        {"ical", "ic"}, {"ful", ""}, {"ness", ""}};
    for (const auto& [suf, rep] : step3) {
        if (ends_with(w, suf)) {
            std::string stem = w.substr(0, w.size() - strlen(suf));
            if (measure(stem) > 0) w = stem + rep;
            break;
        }
    }

    // Step 4 (longest suffix first, mirroring the Python sort)
    static const std::vector<std::string> step4 = [] {
        std::vector<std::string> s = {"al",   "ance", "ence", "er",  "ic",
                                      "able", "ible", "ant",  "ement", "ment",
                                      "ent",  "ion",  "ou",   "ism", "ate",
                                      "iti",  "ous",  "ive",  "ize"};
        std::stable_sort(s.begin(), s.end(),
                         [](const std::string& a, const std::string& b) {
                             return a.size() > b.size();
                         });
        return s;
    }();
    for (const auto& suf : step4) {
        if (ends_with(w, suf)) {
            std::string stem = w.substr(0, w.size() - suf.size());
            if (measure(stem) > 1) {
                if (suf == "ion" &&
                    !(ends_with(stem, "s") || ends_with(stem, "t")))
                    break;
                w = stem;
            }
            break;
        }
    }

    // Step 5a
    if (ends_with(w, "e")) {
        std::string stem = w.substr(0, w.size() - 1);
        int m = measure(stem);
        if (m > 1 || (m == 1 && !ends_cvc(stem))) w = stem;
    }
    // Step 5b
    if (measure(w) > 1 && ends_double_cons(w) && ends_with(w, "l"))
        w.resize(w.size() - 1);
    return w;
}

// ------------------------------------------------------------------
// Synonym table (stage 3) — stem-indexed groups fed once from Python
// via meteor_set_synonyms_c (single source of truth: synonyms_en.txt)
// ------------------------------------------------------------------

std::unordered_map<std::string, std::vector<int>>& synonym_index() {
    static std::unordered_map<std::string, std::vector<int>> index;
    return index;
}

void set_synonyms(const char* data) {
    auto& index = synonym_index();
    index.clear();
    std::istringstream iss(data);
    std::string line;
    int gid = 0;
    while (std::getline(iss, line)) {
        if (line.empty() || line[0] == '#') continue;
        std::istringstream ls(line);
        std::string word;
        bool any = false;
        while (ls >> word) {
            index[porter_stem(word)].push_back(gid);
            any = true;
        }
        if (any) ++gid;
    }
    for (auto& [k, v] : index) {
        std::sort(v.begin(), v.end());
        v.erase(std::unique(v.begin(), v.end()), v.end());
    }
}

bool groups_intersect(const std::vector<int>& a, const std::vector<int>& b) {
    size_t i = 0, j = 0;
    while (i < a.size() && j < b.size()) {
        if (a[i] == b[j]) return true;
        if (a[i] < b[j]) ++i; else ++j;
    }
    return false;
}

// ------------------------------------------------------------------
// Alignment: max matches, then max weight, then min chunks
// ------------------------------------------------------------------

struct Pair3 {
    int i, j;
    int w;  // integer module weight (x5); divide by WI_SCALE for scoring
};

struct Aligner {
    const std::vector<std::string>& hyp;
    const std::vector<std::string>& ref;
    std::vector<std::vector<std::pair<int, int>>> edges;
    std::vector<char> used;
    std::vector<Pair3> cur;
    long node_cap, nodes = 0;

    bool have_best = false;
    int best_matches = 0, best_chunks = 0;
    long best_weight = 0;
    std::vector<Pair3> best_pairs;

    Aligner(const std::vector<std::string>& h, const std::vector<std::string>& r,
            bool use_stem, long cap)
        : hyp(h), ref(r), node_cap(cap) {
        std::vector<std::string> hs, rs;
        std::vector<const std::vector<int>*> hg, rg;
        static const std::vector<int> kNoGroups;
        if (use_stem) {
            const auto& index = synonym_index();
            auto lookup = [&](const std::string& stem) {
                auto it = index.find(stem);
                return it == index.end() ? &kNoGroups : &it->second;
            };
            for (const auto& t : h) hs.push_back(porter_stem(t));
            for (const auto& t : r) rs.push_back(porter_stem(t));
            for (const auto& s : hs) hg.push_back(lookup(s));
            for (const auto& s : rs) rg.push_back(lookup(s));
        }
        edges.resize(h.size());
        for (size_t i = 0; i < h.size(); ++i)
            for (size_t j = 0; j < r.size(); ++j) {
                if (h[i] == r[j])
                    edges[i].push_back({(int)j, WI_EXACT});
                else if (use_stem && hs[i] == rs[j])
                    edges[i].push_back({(int)j, WI_STEM});
                else if (use_stem && groups_intersect(*hg[i], *rg[j]))
                    edges[i].push_back({(int)j, WI_SYN});
            }
        used.assign(r.size(), 0);
    }

    bool candidate_better(int m, long w, int ch) const {
        if (!have_best) return true;
        if (m != best_matches) return m > best_matches;
        if (w != best_weight) return w > best_weight;
        return ch < best_chunks;
    }

    void dfs(int i, int matches, long weight, int chunks, int prev) {
        if (nodes > node_cap) return;
        int rem = (int)hyp.size() - i;
        if (have_best) {
            if (matches + rem < best_matches) return;
            if (matches + rem == best_matches &&
                weight + rem * WI_EXACT < best_weight)
                return;
            if (matches + rem == best_matches &&
                weight + rem * WI_EXACT == best_weight && chunks >= best_chunks)
                return;
        }
        if (i == (int)hyp.size()) {
            if (candidate_better(matches, weight, chunks)) {
                have_best = true;
                best_matches = matches;
                best_weight = weight;
                best_chunks = chunks;
                best_pairs = cur;
            }
            return;
        }
        ++nodes;
        std::vector<std::pair<int, int>> cands;
        for (const auto& e : edges[i])
            if (!used[e.first]) cands.push_back(e);
        std::stable_sort(cands.begin(), cands.end(),
                         [&](const std::pair<int, int>& a,
                             const std::pair<int, int>& b) {
                             bool aa = a.first != prev + 1, bb = b.first != prev + 1;
                             if (aa != bb) return aa < bb;
                             if (a.second != b.second) return a.second > b.second;
                             return a.first < b.first;
                         });
        for (const auto& [j, w] : cands) {
            used[j] = 1;
            cur.push_back({i, j, w});
            dfs(i + 1, matches + 1, weight + w,
                chunks + (j != prev + 1 ? 1 : 0), j);
            cur.pop_back();
            used[j] = 0;
        }
        dfs(i + 1, matches, weight, chunks, -2);
    }

    // iterative adjacent-first greedy pass — the long-input path, mirror
    // of csat_tpu_torch/metrics/meteor.py _greedy_align
    void run_greedy() {
        std::fill(used.begin(), used.end(), 0);
        best_pairs.clear();
        best_weight = 0;
        best_chunks = 0;
        int prev = -2;
        for (int i = 0; i < (int)hyp.size(); ++i) {
            std::vector<std::pair<int, int>> cands;
            for (const auto& e : edges[i])
                if (!used[e.first]) cands.push_back(e);
            std::stable_sort(cands.begin(), cands.end(),
                             [&](const std::pair<int, int>& a,
                                 const std::pair<int, int>& b) {
                                 bool aa = a.first != prev + 1,
                                      bb = b.first != prev + 1;
                                 if (aa != bb) return aa < bb;
                                 if (a.second != b.second)
                                     return a.second > b.second;
                                 return a.first < b.first;
                             });
            if (cands.empty()) {
                prev = -2;
                continue;
            }
            auto [j, w] = cands[0];
            used[j] = 1;
            best_pairs.push_back({i, j, w});
            best_chunks += j != prev + 1 ? 1 : 0;
            best_weight += w;
            prev = j;
        }
        best_matches = (int)best_pairs.size();
        have_best = true;
    }

    void run() {
        if (hyp.size() > 256 || ref.size() > 256)
            run_greedy();
        else
            dfs(0, 0, 0.0, 0, -2);
    }
};

double content_weight(const std::string& tok) {
    return function_words().count(tok) ? 1.0 - DELTA : DELTA;
}

}  // namespace

extern "C" {

// Load/replace the synonym table (whitespace-separated groups, one per
// line, '#' comments). Called once by the Python loader with the contents
// of csat_tpu_torch/metrics/synonyms_en.txt. NOT thread-safe vs concurrent
// scoring — call before the first meteor_score_c.
void meteor_set_synonyms_c(const char* data) { set_synonyms(data); }

double meteor_score_c(const char* hyp_s, const char* ref_s, int v15) {
    auto hyp = tokenize(hyp_s);
    auto ref = tokenize(ref_s);
    if (hyp.empty() || ref.empty()) return 0.0;
    Aligner a(hyp, ref, /*use_stem=*/v15 != 0, 30000);
    a.run();
    int m = a.best_matches;
    if (m == 0) return 0.0;
    if (v15) {
        double wl_h = 0, wl_r = 0, wm_h = 0, wm_r = 0;
        for (const auto& t : hyp) wl_h += content_weight(t);
        for (const auto& t : ref) wl_r += content_weight(t);
        for (const auto& pr : a.best_pairs) {
            double w = (double)pr.w / WI_SCALE;
            wm_h += w * content_weight(hyp[pr.i]);
            wm_r += w * content_weight(ref[pr.j]);
        }
        double p = wl_h > 0 ? wm_h / wl_h : 0.0;
        double r = wl_r > 0 ? wm_r / wl_r : 0.0;
        if (p + r == 0.0) return 0.0;
        double fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r);
        double frag = (double)a.best_chunks / m;
        return fmean * (1.0 - GAMMA * std::pow(frag, BETA));
    }
    double p = (double)m / hyp.size();
    double r = (double)m / ref.size();
    double fmean = 10.0 * p * r / (r + 9.0 * p);
    double frac = (double)a.best_chunks / m;
    return fmean * (1.0 - 0.5 * frac * frac * frac);
}

}  // extern "C"
