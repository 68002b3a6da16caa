// Native BM25 inverted-index core (C ABI, loaded via ctypes).
//
// The reference embeds tantivy (Rust, SIMD-heavy) for its full-text engine;
// this is the rebuild's native equivalent: analysis chain (simple tokenizer,
// lowercase, English stopwords), staged commits, and BM25 (k1=1.2, b=0.75)
// scoring under tantivy-QueryParser boolean semantics — bare terms SHOULD,
// `+term` MUST, `-term` MUST_NOT, `"quoted text"` phrase (terms adjacent in
// order, positions are post-stopword-filter indices; phrase scoring follows
// Lucene's PhraseQuery: tf = phrase frequency, idf = summed member idfs).
// The Python InvertedIndex in fts/__init__.py is the behavior-identical
// fallback when no C++ toolchain is available.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr double K1 = 1.2;
constexpr double B = 0.75;

const std::unordered_set<std::string>& stopwords() {
    static const std::unordered_set<std::string> kStopwords = {
        "a", "an", "and", "are", "as", "at", "be", "but", "by", "for",
        "if", "in", "into", "is", "it", "no", "not", "of", "on", "or",
        "such", "that", "the", "their", "then", "there", "these", "they",
        "this", "to", "was", "will", "with"};
    return kStopwords;
}

// Simple tokenizer over UTF-8: ASCII alphanumerics lowercase; any multibyte
// sequence counts as word material (mirrors a unicode \w class closely
// enough for the analysis-chain contract).
std::vector<std::string> analyze(const char* text) {
    std::vector<std::string> out;
    std::string cur;
    for (const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
         *p; ++p) {
        unsigned char c = *p;
        if (c < 128) {
            if (std::isalnum(c)) {
                cur.push_back(static_cast<char>(std::tolower(c)));
            } else {
                if (!cur.empty() && !stopwords().count(cur)) out.push_back(cur);
                cur.clear();
            }
        } else {
            cur.push_back(static_cast<char>(c));
        }
    }
    if (!cur.empty() && !stopwords().count(cur)) out.push_back(cur);
    return out;
}

struct Clause {
    int occur = 0;  // -1 MUST_NOT, 0 SHOULD, +1 MUST
    std::vector<std::string> terms;
    bool is_phrase = false;
};

// Query string -> clause list; bare multi-token fragments expand to one
// clause per token, quoted fragments stay one phrase clause.
std::vector<Clause> parse_query(const char* query) {
    std::vector<Clause> out;
    const std::string q(query);
    size_t i = 0, n = q.size();
    while (i < n) {
        while (i < n && std::isspace(static_cast<unsigned char>(q[i]))) ++i;
        if (i >= n) break;
        int occur = 0;
        if (q[i] == '+') {
            occur = 1;
            ++i;
        } else if (q[i] == '-') {
            occur = -1;
            ++i;
        }
        if (i < n && q[i] == '"') {
            size_t j = q.find('"', i + 1);
            if (j == std::string::npos) j = n;
            auto terms = analyze(q.substr(i + 1, j - i - 1).c_str());
            i = (j < n) ? j + 1 : n;
            if (!terms.empty()) out.push_back({occur, std::move(terms), true});
        } else {
            size_t j = i;
            while (j < n && !std::isspace(static_cast<unsigned char>(q[j]))) ++j;
            for (auto& t : analyze(q.substr(i, j - i).c_str())) {
                out.push_back({occur, {t}, false});
            }
            i = j;
        }
    }
    return out;
}

using Plist = std::unordered_map<int64_t, std::vector<int32_t>>;

struct Index {
    // committed state, term-interned: term string -> stable id; postings
    // indexed by id (term -> doc -> positions, post-stopword indices).
    // doc_terms remembers each doc's unique term ids so removal walks
    // O(|doc|) postings instead of the whole vocabulary — the difference
    // between O(1)-ish and O(vocab) per delete under CDC churn.
    std::unordered_map<std::string, uint32_t> term_ids;
    std::vector<std::string> term_str;
    std::vector<Plist> postings;
    std::unordered_map<int64_t, std::vector<uint32_t>> doc_terms;
    std::unordered_map<int64_t, int32_t> doc_len;
    int64_t total_len = 0;
    // staged state
    std::unordered_map<int64_t, std::string> pending_add;
    std::unordered_set<int64_t> pending_del;

    uint32_t intern(const std::string& t) {
        auto [it, inserted] =
            term_ids.emplace(t, static_cast<uint32_t>(term_str.size()));
        if (inserted) {
            term_str.push_back(t);
            postings.emplace_back();
        }
        return it->second;
    }

    // nullptr when the term is unknown or currently has no documents
    // (interned ids outlive their last document, like a segment dictionary)
    const Plist* find_postings(const std::string& t) const {
        auto it = term_ids.find(t);
        if (it == term_ids.end()) return nullptr;
        const Plist& m = postings[it->second];
        return m.empty() ? nullptr : &m;
    }

    void remove_doc(int64_t doc_id) {
        auto it = doc_len.find(doc_id);
        if (it == doc_len.end()) return;
        total_len -= it->second;
        doc_len.erase(it);
        auto dt = doc_terms.find(doc_id);
        if (dt != doc_terms.end()) {
            for (uint32_t tid : dt->second) postings[tid].erase(doc_id);
            doc_terms.erase(dt);
        }
    }

    int64_t commit() {
        int64_t n = static_cast<int64_t>(pending_add.size() + pending_del.size());
        for (int64_t doc_id : pending_del) remove_doc(doc_id);
        for (auto& [doc_id, body] : pending_add) {
            remove_doc(doc_id);
            auto tokens = analyze(body.c_str());
            auto& terms = doc_terms[doc_id];
            terms.clear();
            for (size_t pos = 0; pos < tokens.size(); ++pos) {
                uint32_t tid = intern(tokens[pos]);
                auto& positions = postings[tid][doc_id];
                if (positions.empty()) terms.push_back(tid);
                positions.push_back(static_cast<int32_t>(pos));
            }
            doc_len[doc_id] = static_cast<int32_t>(tokens.size());
            total_len += static_cast<int64_t>(tokens.size());
        }
        pending_add.clear();
        pending_del.clear();
        return n;
    }

    double bm25(double idf, int32_t tf, int64_t doc_id, double avg_len) {
        double dl = doc_len[doc_id];
        double denom =
            avg_len > 0 ? tf + K1 * (1 - B + B * dl / avg_len) : tf + K1;
        return idf * (tf * (K1 + 1)) / denom;
    }

    std::unordered_map<int64_t, double> match_clause(const Clause& c, int64_t n,
                                                     double avg_len) {
        std::unordered_map<int64_t, double> out;
        if (!c.is_phrase || c.terms.size() == 1) {
            const Plist* plist = find_postings(c.terms[0]);
            if (plist == nullptr) return out;
            double df = static_cast<double>(plist->size());
            double idf = std::log(1.0 + (n - df + 0.5) / (df + 0.5));
            for (auto& [doc_id, positions] : *plist) {
                out[doc_id] = bm25(
                    idf, static_cast<int32_t>(positions.size()), doc_id,
                    avg_len);
            }
            return out;
        }
        // phrase: every term present at consecutive positions, in order
        std::vector<const Plist*> plists;
        for (auto& t : c.terms) {
            const Plist* plist = find_postings(t);
            if (plist == nullptr) return out;
            plists.push_back(plist);
        }
        double idf = 0.0;
        for (auto* p : plists) {
            double df = static_cast<double>(p->size());
            idf += std::log(1.0 + (n - df + 0.5) / (df + 0.5));
        }
        const auto* smallest = *std::min_element(
            plists.begin(), plists.end(),
            [](auto* a, auto* b) { return a->size() < b->size(); });
        for (auto& [doc_id, _] : *smallest) {
            std::vector<const std::vector<int32_t>*> docpos;
            bool all = true;
            for (auto* p : plists) {
                auto dit = p->find(doc_id);
                if (dit == p->end()) {
                    all = false;
                    break;
                }
                docpos.push_back(&dit->second);
            }
            if (!all) continue;
            std::vector<std::unordered_set<int32_t>> rest;
            for (size_t t = 1; t < docpos.size(); ++t) {
                rest.emplace_back(docpos[t]->begin(), docpos[t]->end());
            }
            int32_t tf = 0;
            for (int32_t p0 : *docpos[0]) {
                bool hit = true;
                for (size_t o = 0; o < rest.size(); ++o) {
                    if (!rest[o].count(p0 + static_cast<int32_t>(o) + 1)) {
                        hit = false;
                        break;
                    }
                }
                if (hit) ++tf;
            }
            if (tf) out[doc_id] = bm25(idf, tf, doc_id, avg_len);
        }
        return out;
    }

    int64_t search(const char* query, int32_t limit, int64_t* out_ids,
                   float* out_scores) {
        int64_t n = static_cast<int64_t>(doc_len.size());
        if (n == 0 || limit <= 0) return 0;
        double avg_len = n ? static_cast<double>(total_len) / n : 0.0;
        std::vector<std::unordered_map<int64_t, double>> pos_scores;
        std::vector<std::unordered_set<int64_t>> must_sets;
        std::unordered_set<int64_t> banned;
        for (auto& clause : parse_query(query)) {
            auto matches = match_clause(clause, n, avg_len);
            if (clause.occur < 0) {
                for (auto& [doc_id, _] : matches) banned.insert(doc_id);
            } else {
                if (clause.occur > 0) {
                    std::unordered_set<int64_t> s;
                    for (auto& [doc_id, _] : matches) s.insert(doc_id);
                    must_sets.push_back(std::move(s));
                }
                pos_scores.push_back(std::move(matches));
            }
        }
        if (pos_scores.empty()) return 0;
        std::unordered_set<int64_t> allowed;
        if (!must_sets.empty()) {
            allowed = must_sets[0];
            for (size_t i = 1; i < must_sets.size(); ++i) {
                for (auto it = allowed.begin(); it != allowed.end();) {
                    if (!must_sets[i].count(*it)) {
                        it = allowed.erase(it);
                    } else {
                        ++it;
                    }
                }
            }
        } else {
            for (auto& m : pos_scores) {
                for (auto& [doc_id, _] : m) allowed.insert(doc_id);
            }
        }
        for (int64_t doc_id : banned) allowed.erase(doc_id);
        std::unordered_map<int64_t, double> scores;
        for (auto& m : pos_scores) {
            for (auto& [doc_id, s] : m) {
                if (allowed.count(doc_id)) scores[doc_id] += s;
            }
        }
        std::vector<std::pair<int64_t, double>> ranked(scores.begin(),
                                                       scores.end());
        auto better = [](const std::pair<int64_t, double>& a,
                         const std::pair<int64_t, double>& b) {
            if (a.second != b.second) return a.second > b.second;
            return a.first < b.first;
        };
        int64_t count = std::min<int64_t>(limit, ranked.size());
        if (static_cast<int64_t>(ranked.size()) > count) {
            // partial selection: matches can be 1000x the limit
            std::nth_element(ranked.begin(), ranked.begin() + count,
                             ranked.end(), better);
            ranked.resize(count);
        }
        std::sort(ranked.begin(), ranked.end(), better);
        for (int64_t i = 0; i < count; ++i) {
            out_ids[i] = ranked[i].first;
            out_scores[i] = static_cast<float>(ranked[i].second);
        }
        return count;
    }

    int64_t size_bytes() const {
        int64_t total = 0;
        for (size_t i = 0; i < postings.size(); ++i) {
            if (postings[i].empty()) continue;  // retired dictionary entry
            total += static_cast<int64_t>(term_str[i].size()) + 48;
            for (auto& [_, positions] : postings[i]) {
                total += 16 + 4 * static_cast<int64_t>(positions.size());
            }
        }
        total += 16 * static_cast<int64_t>(doc_len.size());
        return total;
    }
};

}  // namespace

extern "C" {

void* fts_create() { return new Index(); }

void fts_destroy(void* h) { delete static_cast<Index*>(h); }

void fts_add_document(void* h, int64_t doc_id, const char* body) {
    auto* idx = static_cast<Index*>(h);
    idx->pending_del.erase(doc_id);
    idx->pending_add[doc_id] = body;
}

void fts_delete_document(void* h, int64_t doc_id) {
    auto* idx = static_cast<Index*>(h);
    idx->pending_add.erase(doc_id);
    idx->pending_del.insert(doc_id);
}

int64_t fts_uncommitted(void* h) {
    auto* idx = static_cast<Index*>(h);
    return static_cast<int64_t>(idx->pending_add.size() + idx->pending_del.size());
}

int64_t fts_commit(void* h) { return static_cast<Index*>(h)->commit(); }

int64_t fts_num_docs(void* h) {
    return static_cast<int64_t>(static_cast<Index*>(h)->doc_len.size());
}

int64_t fts_search(void* h, const char* query, int32_t limit, int64_t* out_ids,
                   float* out_scores) {
    return static_cast<Index*>(h)->search(query, limit, out_ids, out_scores);
}

int64_t fts_size_bytes(void* h) {
    return static_cast<Index*>(h)->size_bytes();
}

}  // extern "C"
