// Fast WordPiece batch encoder (C++), the native hot path of the host
// input pipeline and the greedy text attack's candidate re-tokenization
// (reference greedy_attack_vilt.py:549-551 re-tokenizes B*n_candidates
// sentences per loop).
//
// Scope: ASCII fast path with exact parity to the Python
// WordPieceTokenizer (rmcl_tpu_torch/data/tokenizer.py) for ASCII text —
// lowercase, punctuation split, greedy longest-match-first WordPiece,
// special-token pass-through.  Texts containing non-ASCII bytes are the
// caller's job to route to the Python implementation (captions are
// overwhelmingly ASCII).
//
// Interface: C ABI for ctypes.  No Python.h dependency.

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> table;
    int32_t pad_id = 0, unk_id = 1, cls_id = 2, sep_id = 3, mask_id = 4;
    int max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// Greedy longest-match WordPiece of one lowercase word.
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>* out) {
    if ((int)word.size() > v.max_chars_per_word) {
        out->push_back(v.unk_id);
        return;
    }
    size_t start = 0;
    std::vector<int32_t> pieces;
    while (start < word.size()) {
        size_t end = word.size();
        int32_t cur = -1;
        std::string piece;
        while (start < end) {
            piece.assign(word, start, end - start);
            if (start > 0) piece = "##" + piece;
            auto it = v.table.find(piece);
            if (it != v.table.end()) { cur = it->second; break; }
            end--;
        }
        if (cur < 0) {
            out->push_back(v.unk_id);
            return;
        }
        pieces.push_back(cur);
        start = end;
    }
    out->insert(out->end(), pieces.begin(), pieces.end());
}

const char* kSpecials[] = {"[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"};

// Tokenize one text into ids (no CLS/SEP), honoring special tokens.
void tokenize(const Vocab& v, const char* text, size_t len,
              std::vector<int32_t>* ids) {
    size_t i = 0;
    std::string word;
    auto flush_word = [&]() {
        if (!word.empty()) {
            wordpiece(v, word, ids);
            word.clear();
        }
    };
    while (i < len) {
        // special-token pass-through (uppercase match, as written)
        bool matched = false;
        if (text[i] == '[') {
            for (const char* sp : kSpecials) {
                size_t sl = std::strlen(sp);
                if (i + sl <= len && std::strncmp(text + i, sp, sl) == 0) {
                    flush_word();
                    ids->push_back(v.table.at(sp));
                    i += sl;
                    matched = true;
                    break;
                }
            }
        }
        if (matched) continue;
        unsigned char c = (unsigned char)text[i];
        if (is_ws(c)) {
            flush_word();
        } else if (is_ascii_punct(c)) {
            flush_word();
            std::string p(1, (char)c);
            wordpiece(v, p, ids);
        } else {
            word.push_back((char)(c >= 'A' && c <= 'Z' ? c + 32 : c));
        }
        i++;
    }
    flush_word();
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path) {
    std::ifstream f(vocab_path);
    if (!f.good()) return nullptr;
    auto* v = new Vocab();
    std::string line;
    int32_t idx = 0;
    while (std::getline(f, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        v->table.emplace(line, idx++);
    }
    auto find = [&](const char* s, int32_t dflt) {
        auto it = v->table.find(s);
        return it == v->table.end() ? dflt : it->second;
    };
    v->pad_id = find("[PAD]", 0);
    v->unk_id = find("[UNK]", 1);
    v->cls_id = find("[CLS]", 2);
    v->sep_id = find("[SEP]", 3);
    v->mask_id = find("[MASK]", 4);
    return v;
}

void wp_free(void* h) { delete static_cast<Vocab*>(h); }

int32_t wp_vocab_size(void* h) {
    return (int32_t)static_cast<Vocab*>(h)->table.size();
}

// Returns 1 if all bytes of `text` are ASCII (safe for the fast path).
int32_t wp_is_ascii(const char* text, int64_t len) {
    for (int64_t i = 0; i < len; i++)
        if ((unsigned char)text[i] >= 128) return 0;
    return 1;
}

// Encode n texts (concatenated, NUL-separated) into (n, max_len) int32
// ids + attention mask, CLS/SEP added, truncated to max_len-2 inner
// tokens, padded with PAD.  Returns 0 on success.
int32_t wp_encode_batch(void* h, const char* texts, const int64_t* offsets,
                        int32_t n, int32_t max_len,
                        int32_t* ids_out, int32_t* mask_out) {
    auto* v = static_cast<Vocab*>(h);
    std::vector<int32_t> toks;
    for (int32_t b = 0; b < n; b++) {
        toks.clear();
        const char* t = texts + offsets[b];
        size_t len = (size_t)(offsets[b + 1] - offsets[b]);
        tokenize(*v, t, len, &toks);
        int32_t inner = (int32_t)toks.size();
        if (inner > max_len - 2) inner = max_len - 2;
        int32_t* ids = ids_out + (int64_t)b * max_len;
        int32_t* mask = mask_out + (int64_t)b * max_len;
        ids[0] = v->cls_id;
        for (int32_t j = 0; j < inner; j++) ids[1 + j] = toks[j];
        ids[1 + inner] = v->sep_id;
        int32_t used = inner + 2;
        for (int32_t j = 0; j < used; j++) mask[j] = 1;
        for (int32_t j = used; j < max_len; j++) {
            ids[j] = v->pad_id;
            mask[j] = 0;
        }
    }
    return 0;
}

}  // extern "C"
