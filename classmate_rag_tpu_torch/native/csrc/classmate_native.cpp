// Native host-side kernels for classmate_rag_tpu.
//
// The TPU owns the compute path (JAX/XLA/Pallas); this library owns the
// host-side ingest hot loops the reference left to Python regex + dict ops:
//
// 1. BM25 tokenization — UTF-8 scan of latin letters (diacritics
//    preserved), lowercasing (ASCII + Latin-1 supplement), per-language
//    stopword removal, 1-char token drop. Semantics match
//    classmate_rag_tpu/index/lexical.py's tokenize() exactly (which
//    mirrors the reference tokenizer, rag/retrieval/bm25.py:34-70); a
//    parity test fuzzes the two against each other.
// 2. Batch term packing — the index-build hot loop: per-document term
//    frequency counting, top-width selection (stable, highest-tf wins,
//    first-seen breaks ties), vocabulary interning (insertion order
//    identical to lexical.pack_tokens so term ids match the Python
//    path bit for bit), fixed-width emission. The interner is owned
//    here; Python mirrors newly created terms after each batch.
//
// C ABI (ctypes-friendly); Build: native/build.sh (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_set<std::string> stop_en;
  std::unordered_set<std::string> stop_it;
};

// Is (cp) a letter the reference regex [A-Za-zÀ-ÖØ-öø-ÿ] accepts?
// Works on Unicode code points (we decode UTF-8 below).
inline bool is_token_cp(uint32_t cp) {
  if ((cp >= 'A' && cp <= 'Z') || (cp >= 'a' && cp <= 'z')) return true;
  if (cp >= 0xC0 && cp <= 0xD6) return true;   // À-Ö
  if (cp >= 0xD8 && cp <= 0xF6) return true;   // Ø-ö
  if (cp >= 0xF8 && cp <= 0xFF) return true;   // ø-ÿ
  return false;
}

// Lowercase within the accepted ranges (ASCII + Latin-1 letters).
inline uint32_t lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 0x20;
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 0x20;  // À-Þ minus ×
  return cp;
}

// Append a code point as UTF-8.
inline void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else {  // all our letters are < 0x800
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Decode the next UTF-8 code point; advances i. Invalid bytes yield 0xFFFD.
inline uint32_t next_cp(const uint8_t* s, int64_t len, int64_t& i) {
  uint8_t b0 = s[i];
  if (b0 < 0x80) { i += 1; return b0; }
  if ((b0 >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((b0 & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2;
    return cp;
  }
  if ((b0 >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((b0 & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                  (s[i + 2] & 0x3F);
    i += 3;
    return cp;
  }
  if ((b0 >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((b0 & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4;
    return cp;
  }
  i += 1;
  return 0xFFFD;
}

}  // namespace

extern "C" {

void* tokenizer_create(const char** stop_en, int n_en,
                       const char** stop_it, int n_it) {
  auto* tok = new Tokenizer();
  for (int i = 0; i < n_en; ++i) tok->stop_en.insert(stop_en[i]);
  for (int i = 0; i < n_it; ++i) tok->stop_it.insert(stop_it[i]);
  return tok;
}

void tokenizer_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Tokenize `text` (UTF-8, text_len bytes). Kept tokens are written
// space-joined into out (capacity out_cap). Returns the number of bytes
// written, or -(needed_bytes) when the buffer is too small.
int64_t tokenize_join(void* handle, const char* text, int64_t text_len,
                      int lang_it, char* out, int64_t out_cap) {
  const auto* tok = static_cast<const Tokenizer*>(handle);
  const auto& stops = lang_it ? tok->stop_it : tok->stop_en;
  const uint8_t* s = reinterpret_cast<const uint8_t*>(text);

  std::string result;
  result.reserve(static_cast<size_t>(text_len));
  std::string current;
  current.reserve(64);

  auto flush = [&]() {
    // Reference semantics: drop 1-char tokens and stopwords.
    if (current.size() > 1 ||
        (current.size() == 1 && false)) {  // 1 byte == 1 char here only for ASCII
      // A 2-byte UTF-8 accented char is still one character; check chars.
      // Count characters quickly: ASCII bytes count 1, lead bytes count 1.
      int chars = 0;
      for (unsigned char c : current)
        if ((c & 0xC0) != 0x80) ++chars;
      if (chars > 1 && stops.find(current) == stops.end()) {
        if (!result.empty()) result.push_back(' ');
        result += current;
      }
    }
    current.clear();
  };

  int64_t i = 0;
  while (i < text_len) {
    uint32_t cp = next_cp(s, text_len, i);
    if (is_token_cp(cp)) {
      append_utf8(current, lower_cp(cp));
    } else if (!current.empty()) {
      flush();
    }
  }
  if (!current.empty()) flush();

  int64_t n = static_cast<int64_t>(result.size());
  if (n > out_cap) return -n;
  std::memcpy(out, result.data(), static_cast<size_t>(n));
  return n;
}

// ---------------------------------------------------------------------------
// Batch term packer / vocabulary interner
// ---------------------------------------------------------------------------

struct Packer {
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> terms;  // id -> term
};

void* packer_create() { return new Packer(); }

void packer_destroy(void* handle) { delete static_cast<Packer*>(handle); }

int32_t packer_vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<Packer*>(handle)->terms.size());
}

// Pack a batch of pre-tokenized documents.
//
// `blob` holds every document's tokens space-joined, documents separated
// by '\n' (an empty segment = empty document); exactly n_docs segments.
// Writes term_ids (i32, n_docs*width, -1 padded), tfs (u8, zero padded),
// doc_len (f32). Semantics identical to lexical.pack_tokens: per-doc tf
// counts in first-seen order; when distinct terms exceed `width` a STABLE
// sort by descending tf picks the winners (first-seen breaks ties); terms
// intern into the shared vocabulary in packed order; tf clamps at 255;
// doc_len counts ALL tokens. Returns 0 on success, -1 on malformed input
// (wrong segment count).
int32_t packer_pack_batch(void* handle, const char* blob, int64_t blob_len,
                          int32_t n_docs, int32_t width,
                          int32_t* term_ids, uint8_t* tfs, float* doc_len) {
  auto* p = static_cast<Packer*>(handle);
  const char* s = blob;
  const char* end = blob + blob_len;

  // Per-doc scratch, reused across the batch.
  std::unordered_map<std::string_view, int32_t> counts;
  std::vector<std::string_view> first_seen;
  std::vector<int32_t> order;

  for (int32_t d = 0; d < n_docs; ++d) {
    if (s > end) return -1;
    const char* nl = static_cast<const char*>(
        memchr(s, '\n', static_cast<size_t>(end - s)));
    const char* doc_end = nl ? nl : end;
    if (!nl && d != n_docs - 1) return -1;

    counts.clear();
    first_seen.clear();
    int64_t n_tokens = 0;
    const char* t = s;
    while (t < doc_end) {
      const char* sp = static_cast<const char*>(
          memchr(t, ' ', static_cast<size_t>(doc_end - t)));
      const char* tok_end = sp ? sp : doc_end;
      if (tok_end > t) {
        std::string_view tok(t, static_cast<size_t>(tok_end - t));
        ++n_tokens;
        auto it = counts.find(tok);
        if (it == counts.end()) {
          counts.emplace(tok, 1);
          first_seen.push_back(tok);
        } else {
          ++it->second;
        }
      }
      t = tok_end + 1;
    }
    doc_len[d] = static_cast<float>(n_tokens);

    int32_t n_distinct = static_cast<int32_t>(first_seen.size());
    order.resize(static_cast<size_t>(n_distinct));
    for (int32_t i = 0; i < n_distinct; ++i) order[static_cast<size_t>(i)] = i;
    if (n_distinct > width) {
      // Stable sort by -tf: first-seen order breaks ties, matching
      // Python's list.sort(key=-tf) on first-seen-ordered items.
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) {
                         return counts[first_seen[static_cast<size_t>(a)]] >
                                counts[first_seen[static_cast<size_t>(b)]];
                       });
      order.resize(static_cast<size_t>(width));
    }

    int32_t* row_ids = term_ids + static_cast<int64_t>(d) * width;
    uint8_t* row_tfs = tfs + static_cast<int64_t>(d) * width;
    for (int32_t j = 0; j < width; ++j) {
      row_ids[j] = -1;
      row_tfs[j] = 0;
    }
    int32_t n_emit = static_cast<int32_t>(order.size());
    for (int32_t j = 0; j < n_emit; ++j) {
      std::string_view tok = first_seen[static_cast<size_t>(order[j])];
      std::string key(tok);
      auto it = p->vocab.find(key);
      int32_t tid;
      if (it == p->vocab.end()) {
        tid = static_cast<int32_t>(p->terms.size());
        p->vocab.emplace(key, tid);
        p->terms.push_back(std::move(key));
      } else {
        tid = it->second;
      }
      int32_t tf = counts[tok];
      row_ids[j] = tid;
      row_tfs[j] = static_cast<uint8_t>(tf > 255 ? 255 : tf);
    }
    s = doc_end + 1;
  }
  return 0;
}

// Import terms (a '\n'-joined blob) appending to the interner in order —
// used to seed a fresh packer from a restored vocabulary. Returns the new
// vocab size, or -1 if a term already exists (id mismatch risk).
int32_t packer_import_terms(void* handle, const char* blob, int64_t blob_len) {
  auto* p = static_cast<Packer*>(handle);
  const char* s = blob;
  const char* end = blob + blob_len;
  while (s < end) {
    const char* nl = static_cast<const char*>(
        memchr(s, '\n', static_cast<size_t>(end - s)));
    const char* term_end = nl ? nl : end;
    std::string term(s, static_cast<size_t>(term_end - s));
    if (!term.empty()) {
      if (p->vocab.count(term)) return -1;
      int32_t tid = static_cast<int32_t>(p->terms.size());
      p->vocab.emplace(term, tid);
      p->terms.push_back(std::move(term));
    }
    if (!nl) break;
    s = nl + 1;
  }
  return static_cast<int32_t>(p->terms.size());
}

// Export terms with ids in [start, vocab_size) as a '\n'-joined blob.
// Returns bytes written, or -(needed) when the buffer is too small.
int64_t packer_export_terms(void* handle, int32_t start, char* out,
                            int64_t out_cap) {
  const auto* p = static_cast<const Packer*>(handle);
  int64_t need = 0;
  int32_t n = static_cast<int32_t>(p->terms.size());
  for (int32_t i = start; i < n; ++i) {
    need += static_cast<int64_t>(p->terms[static_cast<size_t>(i)].size());
    if (i + 1 < n) ++need;
  }
  if (need > out_cap) return -need;
  char* w = out;
  for (int32_t i = start; i < n; ++i) {
    const std::string& t = p->terms[static_cast<size_t>(i)];
    std::memcpy(w, t.data(), t.size());
    w += t.size();
    if (i + 1 < n) *w++ = '\n';
  }
  return w - out;
}

}  // extern "C"
