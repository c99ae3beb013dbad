// Native corpus tokenizer: word-level vocabulary build + encode in one pass.
//
// A copy of saturn_tpu/native/tokenize.cpp (only comments differ), so
// both packages give the same ids and vocabulary files for one corpus.
//
// The reference's data pipeline tokenized WikiText with torchtext's native
// tokenizer/vocab machinery and cached the id stream
// (examples/wikitext103/dataloaders/dataloaders.py:70-84). This is the
// in-tree native equivalent: lowercase word/punctuation split, frequency-
// ranked vocabulary capped at max_vocab (id 0 = pad, 1 = <unk>), greedy
// encode of every token to int32 ids. The Python side caches the result as
// .npz, so this runs once per corpus.
//
// Protocol (ctypes-friendly): call with out_ids == NULL to get the required
// token count; allocate; call again to fill. Negative returns are errors.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <mutex>
#include <utility>
#include <string>
#include <unordered_map>
#include <vector>

#include <sys/stat.h>

namespace {

bool read_file(const char* path, std::string& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  const size_t got = n ? std::fread(&out[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

// ASCII-only classifiers: the std::ctype functions are locale-dependent (a
// non-C LC_CTYPE classifies bytes >= 0x80 as alnum), which would diverge
// from the plain Python version's ASCII regex and poison the .npz cache. These
// match `[a-z0-9]` / `\s` after ASCII lowercasing exactly, per byte.
inline bool ascii_alnum_lower(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}
inline unsigned char ascii_lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
}
inline bool ascii_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

// One fully-encoded corpus, cached between the count call and the fill
// call of the two-call ctypes protocol — without it both calls redo the
// whole split/count/rank (and a token stream kept as a vector of 100M+
// std::strings is ~3 GB of allocator traffic at WikiText-103 scale; the
// interned stream below is 4 bytes/token).
struct Encoded {
  std::string path;
  int max_vocab = 0;
  long file_size = -1;
  double file_mtime = -1.0;
  std::vector<int32_t> ids;          // final vocab ids, ready to copy out
  std::vector<std::string> words;    // ranked vocab (ids 2..keep+1)
  int vocab_size = 0;
  bool valid = false;
};

// (size, mtime) of a file — the cache staleness key; (-1, -1) if stat fails.
void stat_file(const char* path, long* size, double* mtime) {
  *size = -1;
  *mtime = -1.0;
  struct stat st;
  if (::stat(path, &st) == 0) {
    *size = static_cast<long>(st.st_size);
    *mtime = static_cast<double>(st.st_mtim.tv_sec) +
             1e-9 * static_cast<double>(st.st_mtim.tv_nsec);
  }
}

// Single pass: intern tokens to dense first-occurrence ids, count, rank,
// then remap the dense stream to vocab ids. Tie-break parity with the
// plain Python version: intern order IS first-occurrence order.
bool build_encoded(const char* path, int max_vocab, Encoded& out) {
  std::string text;
  if (!read_file(path, text)) return false;

  std::unordered_map<std::string, int32_t> intern;
  intern.reserve(1 << 16);
  std::vector<long> counts;
  std::vector<const std::string*> words;  // dense id -> token text
  std::vector<int32_t> dense;
  dense.reserve(text.size() / 5 + 16);

  std::string cur;
  auto emit = [&](const std::string& tok) {
    auto it = intern.find(tok);
    int32_t id;
    if (it == intern.end()) {
      id = static_cast<int32_t>(intern.size());
      auto ins = intern.emplace(tok, id);
      counts.push_back(0);
      words.push_back(&ins.first->first);
    } else {
      id = it->second;
    }
    ++counts[id];
    dense.push_back(id);
  };
  std::string punct(1, '\0');
  for (unsigned char raw : text) {
    const unsigned char c = ascii_lower(raw);
    if (ascii_alnum_lower(c)) {
      cur.push_back(static_cast<char>(c));
    } else {
      if (!cur.empty()) {
        emit(cur);
        cur.clear();
      }
      if (!ascii_space(c)) {
        punct[0] = static_cast<char>(c);
        emit(punct);
      }
    }
  }
  if (!cur.empty()) emit(cur);

  // Rank by (count desc, first occurrence asc == dense id asc).
  const size_t u = counts.size();
  std::vector<int32_t> order(u);
  for (size_t i = 0; i < u; ++i) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (counts[a] != counts[b]) return counts[a] > counts[b];
    return a < b;
  });
  const size_t keep = std::min(u, static_cast<size_t>(max_vocab - 2));
  std::vector<int32_t> remap(u, 1);  // default <unk>
  out.words.clear();
  out.words.reserve(keep);
  for (size_t r = 0; r < keep; ++r) {
    remap[order[r]] = static_cast<int32_t>(r + 2);
    out.words.push_back(*words[order[r]]);
  }

  out.ids.resize(dense.size());
  for (size_t i = 0; i < dense.size(); ++i) out.ids[i] = remap[dense[i]];
  out.path = path;
  out.max_vocab = max_vocab;
  out.file_size = static_cast<long>(text.size());
  out.vocab_size = static_cast<int>(keep + 2);
  out.valid = true;
  return true;
}

std::mutex g_cache_mu;
// Cache keyed per (path, max_vocab): interleaved count/fill call pairs for
// different corpora (or vocab caps) must not invalidate each other — the
// single-slot version silently reverted to two full builds per encode in
// exactly that pattern. Entries are erased on fill, so only unpaired count
// calls linger; the size cap bounds worst-case resident id streams
// (~4 B/token each) if a caller counts many corpora and never fills.
// Least recently used first out: the list runs from the newest use to the
// oldest, a hit moves its entry to the front and an insert past the cap
// drops the back.
constexpr size_t kCacheCap = 4;
using CacheKey = std::pair<std::string, int>;
std::list<std::pair<CacheKey, Encoded>> g_cache;

std::list<std::pair<CacheKey, Encoded>>::iterator cache_find(const CacheKey& key) {
  return std::find_if(g_cache.begin(), g_cache.end(),
                      [&](const std::pair<CacheKey, Encoded>& e) { return e.first == key; });
}

}  // namespace

extern "C" {

// Returns the corpus token count (>= 0) or a negative error code
// (-1 unreadable file, -2 bad args). When out_ids is non-NULL it must hold
// out_capacity entries; encoding stops short if the capacity is too small.
long word_tokenize_file(const char* path, int max_vocab,
                        const char* vocab_out_path, int32_t* out_ids,
                        long out_capacity, int* out_vocab_size) {
  if (!path || max_vocab < 3) return -2;
  if (out_ids && out_capacity < 0) return -2;  // memcpy below must not
  //                                              underflow to a huge size_t
  // The Python wrapper calls count (out_ids == NULL) then fill; the cache
  // makes the pair cost ONE build. Freshness is checked on (file size,
  // mtime) so a corpus rewritten between an unpaired count call and a
  // later call re-builds — size alone misses same-length rewrites.
  long cur_size;
  double cur_mtime;
  stat_file(path, &cur_size, &cur_mtime);
  const CacheKey key{path, max_vocab};

  Encoded local;
  Encoded* enc = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_cache_mu);
    auto it = cache_find(key);
    if (it != g_cache.end()) {
      if (it->second.valid && it->second.file_size == cur_size &&
          it->second.file_mtime == cur_mtime) {
        if (!out_ids) {
          g_cache.splice(g_cache.begin(), g_cache, it);  // the newest use
          return static_cast<long>(it->second.ids.size());
        }
        // Fill call: take ownership so the entry frees on return and the
        // build below never runs.
        local = std::move(it->second);
        g_cache.erase(it);
        enc = &local;
      } else {
        // Stale (corpus rewritten since the count call): free the old
        // ~4 B/token stream now, not at process exit.
        g_cache.erase(it);
      }
    }
  }
  if (!enc) {
    // Build OUTSIDE the lock: concurrent encodes of unrelated corpora must
    // not serialize behind each other's multi-second builds. Two threads
    // racing on the SAME key both build; the insert below keeps one.
    if (!build_encoded(path, max_vocab, local)) return -1;
    local.file_size = cur_size;
    local.file_mtime = cur_mtime;
    enc = &local;
    if (!out_ids) {
      const long n = static_cast<long>(local.ids.size());
      std::lock_guard<std::mutex> lock(g_cache_mu);
      auto same = cache_find(key);  // a racing build of the same key
      if (same != g_cache.end()) g_cache.erase(same);
      if (g_cache.size() >= kCacheCap) g_cache.pop_back();
      g_cache.emplace_front(key, std::move(local));
      return n;
    }
  }
  const long n = static_cast<long>(enc->ids.size());
  if (!out_ids) return n;

  if (out_vocab_size) *out_vocab_size = enc->vocab_size;
  if (vocab_out_path && vocab_out_path[0]) {
    FILE* vf = std::fopen(vocab_out_path, "wb");
    if (vf) {
      std::fputs("<pad>\n<unk>\n", vf);
      for (const auto& w : enc->words)
        std::fprintf(vf, "%s\n", w.c_str());
      std::fclose(vf);
    }
  }
  const long m = std::min(n, out_capacity);
  std::memcpy(out_ids, enc->ids.data(), sizeof(int32_t) * m);
  return n;  // `local` frees the ~4B/token stream on return
}

}  // extern "C"
