// Byte-level BPE: trainer + encoder. A copy of the JAX package's
// yoho_tpu/native/bpe.cpp for the port's YOHO tokenizer.
//
// Algorithm contract (must match yoho_tpu_torch/text/bpe.py exactly):
//  * pre-tokenize on ASCII whitespace; each word gets one leading ' ';
//  * id layout [specials][256 bytes][merges];
//  * training picks the most frequent pair, ties by (left, right) ascending,
//    skipping merges whose byte length exceeds max_token_len, stopping when
//    the best count < 2;
//  * incremental pair-count updates in the same left-to-right order;
//  * encoding applies the lowest-rank merge first, all occurrences
//    left-to-right.
//
// Model format: "YOHOBPE v1\nspecials K\n<K lines>\nmerges R\n<R 'a b' lines>\n"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<int32_t, int32_t>& p) const {
        return std::hash<int64_t>()(((int64_t)p.first << 32) | (uint32_t)p.second);
    }
};

using Pair = std::pair<int32_t, int32_t>;

bool is_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' || c == '\v';
}

std::vector<std::string> pretokenize(const uint8_t* text, int64_t len) {
    std::vector<std::string> words;
    int64_t i = 0;
    while (i < len) {
        while (i < len && is_ws(text[i])) ++i;
        if (i >= len) break;
        std::string w(1, ' ');
        while (i < len && !is_ws(text[i])) w.push_back((char)text[i++]);
        words.push_back(std::move(w));
    }
    return words;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Trainer
// ---------------------------------------------------------------------------
int64_t yoho_bpe_train(const uint8_t* corpus, int64_t corpus_len, int32_t vocab_size,
                       int32_t max_token_len, const char* specials_joined,
                       char** model_out) {
    int32_t n_special = 0;
    std::vector<std::string> specials;
    {
        const char* p = specials_joined;
        while (p && *p) {
            const char* nl = strchr(p, '\n');
            if (nl) {
                specials.emplace_back(p, nl - p);
                p = nl + 1;
            } else {
                specials.emplace_back(p);
                break;
            }
        }
        n_special = (int32_t)specials.size();
    }
    const int32_t byte_base = n_special;
    const int32_t merge_base = n_special + 256;
    const int64_t target_merges = (int64_t)vocab_size - merge_base;
    if (target_merges < 0) return -1;

    // Word frequencies.
    std::unordered_map<std::string, int64_t> word_freq;
    for (auto& w : pretokenize(corpus, corpus_len)) word_freq[w] += 1;

    std::vector<std::vector<int32_t>> words;
    std::vector<int64_t> freqs;
    words.reserve(word_freq.size());
    for (auto& kv : word_freq) {
        std::vector<int32_t> ids;
        ids.reserve(kv.first.size());
        for (unsigned char c : kv.first) ids.push_back(byte_base + (int32_t)c);
        words.push_back(std::move(ids));
        freqs.push_back(kv.second);
    }

    std::unordered_map<int32_t, int32_t> token_len;
    for (int b = 0; b < 256; ++b) token_len[byte_base + b] = 1;

    std::unordered_map<Pair, int64_t, PairHash> pair_counts;
    for (size_t wi = 0; wi < words.size(); ++wi) {
        auto& ids = words[wi];
        for (size_t i = 0; i + 1 < ids.size(); ++i)
            pair_counts[{ids[i], ids[i + 1]}] += freqs[wi];
    }

    std::vector<Pair> merges;
    merges.reserve(target_merges);

    while ((int64_t)merges.size() < target_merges && !pair_counts.empty()) {
        Pair best{-1, -1};
        int64_t best_count = 1;
        bool found = false;
        for (auto& kv : pair_counts) {
            if (kv.second < best_count) continue;
            auto it_a = token_len.find(kv.first.first);
            auto it_b = token_len.find(kv.first.second);
            int32_t blen = it_a->second + it_b->second;
            if (blen > max_token_len) continue;
            if (kv.second > best_count || (kv.second == best_count && found &&
                                           kv.first < best)) {
                best = kv.first;
                best_count = kv.second;
                found = true;
            } else if (!found && kv.second > 1) {
                best = kv.first;
                best_count = kv.second;
                found = true;
            }
        }
        if (!found) break;
        const int32_t new_id = merge_base + (int32_t)merges.size();
        merges.push_back(best);
        token_len[new_id] = token_len[best.first] + token_len[best.second];

        const int32_t a = best.first, b = best.second;
        for (size_t wi = 0; wi < words.size(); ++wi) {
            auto& ids = words[wi];
            if (ids.size() < 2) continue;
            const int64_t f = freqs[wi];
            size_t i = 0;
            while (i + 1 < ids.size()) {
                if (ids[i] == a && ids[i + 1] == b) {
                    if (i > 0) {
                        pair_counts[{ids[i - 1], a}] -= f;
                        pair_counts[{ids[i - 1], new_id}] += f;
                    }
                    if (i + 2 < ids.size()) {
                        int32_t nxt = ids[i + 2];
                        pair_counts[{b, nxt}] -= f;
                        pair_counts[{new_id, nxt}] += f;
                    }
                    ids.erase(ids.begin() + i, ids.begin() + i + 2);
                    ids.insert(ids.begin() + i, new_id);
                } else {
                    ++i;
                }
            }
        }
        pair_counts.erase(best);
        // Periodic cleanup of exhausted pairs.
        if (pair_counts.size() > 4 * words.size()) {
            for (auto it = pair_counts.begin(); it != pair_counts.end();) {
                if (it->second <= 0)
                    it = pair_counts.erase(it);
                else
                    ++it;
            }
        }
    }

    // Serialize.
    std::string out = "YOHOBPE v1\nspecials " + std::to_string(n_special) + "\n";
    for (auto& s : specials) out += s + "\n";
    out += "merges " + std::to_string(merges.size()) + "\n";
    for (auto& m : merges)
        out += std::to_string(m.first) + " " + std::to_string(m.second) + "\n";

    char* buf = (char*)malloc(out.size() + 1);
    if (!buf) return -1;
    memcpy(buf, out.data(), out.size());
    buf[out.size()] = 0;
    *model_out = buf;
    return (int64_t)out.size();
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------
struct BpeModel {
    int32_t n_special = 0;
    int32_t byte_base = 0;
    int32_t merge_base = 0;
    std::unordered_map<Pair, int32_t, PairHash> rank;  // pair -> merge index
};

void* yoho_bpe_load(const char* model_text, int64_t len) {
    std::string data(model_text, (size_t)len);
    auto* m = new BpeModel();
    size_t pos = 0;
    auto next_line = [&](std::string& out) -> bool {
        if (pos >= data.size()) return false;
        size_t nl = data.find('\n', pos);
        if (nl == std::string::npos) nl = data.size();
        out = data.substr(pos, nl - pos);
        pos = nl + 1;
        return true;
    };
    std::string line;
    if (!next_line(line) || line != "YOHOBPE v1") { delete m; return nullptr; }
    if (!next_line(line) || sscanf(line.c_str(), "specials %d", &m->n_special) != 1) {
        delete m; return nullptr;
    }
    for (int i = 0; i < m->n_special; ++i)
        if (!next_line(line)) { delete m; return nullptr; }
    int32_t n_merges = 0;
    if (!next_line(line) || sscanf(line.c_str(), "merges %d", &n_merges) != 1) {
        delete m; return nullptr;
    }
    m->byte_base = m->n_special;
    m->merge_base = m->n_special + 256;
    for (int r = 0; r < n_merges; ++r) {
        if (!next_line(line)) { delete m; return nullptr; }
        int32_t a, b;
        if (sscanf(line.c_str(), "%d %d", &a, &b) != 2) { delete m; return nullptr; }
        m->rank[{a, b}] = r;
    }
    return m;
}

void yoho_bpe_free_model(void* h) { delete (BpeModel*)h; }

int64_t yoho_bpe_encode(void* h, const uint8_t* text, int64_t len, int32_t** ids_out) {
    auto* m = (BpeModel*)h;
    std::vector<int32_t> out;
    std::vector<int32_t> ids;
    for (auto& w : pretokenize(text, len)) {
        ids.clear();
        ids.reserve(w.size());
        for (unsigned char c : w) ids.push_back(m->byte_base + (int32_t)c);
        while (ids.size() > 1) {
            // One scan finds both the minimum rank AND its pair (the
            // rank->pair mapping is unique, so recording the argmin is
            // exactly the pair a second recovery scan would return).
            int32_t best_rank = -1;
            Pair pair{-1, -1};
            for (size_t i = 0; i + 1 < ids.size(); ++i) {
                auto it = m->rank.find({ids[i], ids[i + 1]});
                if (it != m->rank.end() &&
                    (best_rank < 0 || it->second < best_rank)) {
                    best_rank = it->second;
                    pair = {ids[i], ids[i + 1]};
                }
            }
            if (best_rank < 0) break;
            const int32_t merged = m->merge_base + best_rank;
            std::vector<int32_t> nxt;
            nxt.reserve(ids.size());
            size_t i = 0;
            while (i < ids.size()) {
                if (i + 1 < ids.size() && ids[i] == pair.first && ids[i + 1] == pair.second) {
                    nxt.push_back(merged);
                    i += 2;
                } else {
                    nxt.push_back(ids[i]);
                    i += 1;
                }
            }
            ids.swap(nxt);
        }
        out.insert(out.end(), ids.begin(), ids.end());
    }
    int32_t* buf = (int32_t*)malloc(sizeof(int32_t) * (out.size() ? out.size() : 1));
    if (!buf) return -1;
    memcpy(buf, out.data(), sizeof(int32_t) * out.size());
    *ids_out = buf;
    return (int64_t)out.size();
}

}  // extern "C"
