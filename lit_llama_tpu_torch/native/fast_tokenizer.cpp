// Fast SentencePiece-compatible encoder (BPE + unigram), C core.
//
// The reference's tokenizer is the sentencepiece C++ library
// (lit_llama/tokenizer.py:8); this is our native equivalent: the Python side
// parses the model proto (data/sp_model.py) and hands the piece table to this
// library, which does the hot per-document encode work for dataset
// preparation (scripts/prepare_redpajama.py tokenizes ~1T tokens).
//
// Semantics mirror data/sp_model.py exactly (tests assert parity):
//  * normalize: collapse whitespace runs, optional dummy prefix, escape
//    spaces to U+2581;
//  * BPE: repeatedly merge the adjacent pair whose concatenation is the
//    highest-scoring piece, leftmost on ties (priority queue + linked list,
//    O(n log n) vs the pure-Python O(n^2) rescan);
//  * unigram: Viterbi with unk penalty (min_score - 10);
//  * unknown runs collapse to one unk id, or byte-fallback pieces.
//
// Build: g++ -O2 -shared -fPIC (see native/build.py). No external deps.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNormal = 1;
constexpr int kUnknown = 2;
constexpr int kControl = 3;
constexpr int kUserDefined = 4;
constexpr int kByte = 6;

const char kWs[] = "\xe2\x96\x81";  // U+2581

struct Tokenizer {
  std::vector<std::string> pieces;
  std::vector<float> scores;
  std::vector<int> types;
  std::unordered_map<std::string, int> encode_vocab;  // NORMAL | USER_DEFINED
  int byte_ids[256];
  int model_type = 1;  // 1 unigram, 2 bpe
  int unk_id = 0;
  bool byte_fallback = false;
  bool add_dummy_prefix = true;
  bool remove_extra_ws = true;
  float min_score = 0.f;
  size_t max_piece_len = 1;
};

// ---------------------------------------------------------------------------

std::string normalize(const Tokenizer& t, const char* text) {
  std::string s(text);
  std::string out;
  out.reserve(s.size() + 8);
  if (t.remove_extra_ws) {
    // strip + collapse runs of ASCII space (0x20) ONLY — sentencepiece
    // preserves \n/\t/etc. for byte fallback (<0x0A>); must match the
    // pure-Python path in data/sp_model.py::_normalize exactly.
    std::string collapsed;
    bool in_ws = true;  // leading ws dropped
    for (char c : s) {
      bool ws = c == ' ';
      if (ws) {
        if (!in_ws) collapsed.push_back(' ');
        in_ws = true;
      } else {
        collapsed.push_back(c);
        in_ws = false;
      }
    }
    while (!collapsed.empty() && collapsed.back() == ' ') collapsed.pop_back();
    s = std::move(collapsed);
  }
  if (t.add_dummy_prefix && !s.empty()) s = " " + s;
  for (char c : s) {
    if (c == ' ')
      out += kWs;
    else
      out.push_back(c);
  }
  return out;
}

// UTF-8 char boundaries
std::vector<uint32_t> char_starts(const std::string& s) {
  std::vector<uint32_t> starts;
  for (uint32_t i = 0; i < s.size();) {
    starts.push_back(i);
    unsigned char c = s[i];
    int n = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    i += n;
  }
  starts.push_back((uint32_t)s.size());
  return starts;
}

void resolve_symbol(const Tokenizer& t, const std::string& sym, bool& prev_unk,
                    std::vector<int>& out) {
  auto it = t.encode_vocab.find(sym);
  if (it != t.encode_vocab.end()) {
    out.push_back(it->second);
    prev_unk = false;
  } else if (t.byte_fallback) {
    for (unsigned char b : sym) out.push_back(t.byte_ids[b]);
    prev_unk = false;
  } else {
    if (!prev_unk) out.push_back(t.unk_id);
    prev_unk = true;
  }
}

// -- BPE --------------------------------------------------------------------

struct Sym {
  uint32_t begin, end;  // byte range in normalized string
  int prev, next;       // linked list
  bool alive;
};

struct Cand {
  float score;
  uint32_t pos;  // left symbol begin (stable tie-break: leftmost wins)
  int left;      // symbol index at push time
  uint32_t left_begin, left_end, right_end;  // for staleness check
};

struct CandCmp {
  bool operator()(const Cand& a, const Cand& b) const {
    if (a.score != b.score) return a.score < b.score;  // max-heap by score
    return a.pos > b.pos;                              // then leftmost
  }
};

void bpe_encode(const Tokenizer& t, const std::string& s, std::vector<int>& out) {
  auto starts = char_starts(s);
  int n = (int)starts.size() - 1;
  if (n == 0) return;
  std::vector<Sym> syms(n);
  for (int i = 0; i < n; i++)
    syms[i] = {starts[i], starts[i + 1], i - 1, (i + 1 < n) ? i + 1 : -1, true};

  std::priority_queue<Cand, std::vector<Cand>, CandCmp> pq;
  auto try_push = [&](int li) {
    if (li < 0) return;
    const Sym& l = syms[li];
    if (!l.alive || l.next < 0) return;
    const Sym& r = syms[l.next];
    std::string merged = s.substr(l.begin, r.end - l.begin);
    auto it = t.encode_vocab.find(merged);
    if (it == t.encode_vocab.end()) return;
    pq.push({t.scores[it->second], l.begin, li, l.begin, l.end, r.end});
  };
  for (int i = 0; i < n; i++) try_push(i);

  while (!pq.empty()) {
    Cand c = pq.top();
    pq.pop();
    Sym& l = syms[c.left];
    if (!l.alive || l.begin != c.left_begin || l.end != c.left_end || l.next < 0)
      continue;
    Sym& r = syms[l.next];
    if (r.end != c.right_end) continue;
    // merge r into l
    l.end = r.end;
    r.alive = false;
    l.next = r.next;
    if (r.next >= 0) syms[r.next].prev = c.left;
    try_push(l.prev);
    try_push(c.left);
  }

  bool prev_unk = false;
  for (int i = 0; i >= 0 && i < n;) {
    if (!syms[i].alive) { i++; continue; }
    resolve_symbol(t, s.substr(syms[i].begin, syms[i].end - syms[i].begin),
                   prev_unk, out);
    i = syms[i].next < 0 ? n : syms[i].next;
  }
}

// -- unigram ----------------------------------------------------------------

void unigram_encode(const Tokenizer& t, const std::string& s, std::vector<int>& out) {
  auto starts = char_starts(s);
  int n = (int)starts.size() - 1;
  if (n == 0) return;
  const float kNegInf = -1e30f;
  float unk_score = t.min_score - 10.0f;
  std::vector<float> best(n + 1, kNegInf);
  std::vector<int> back(n + 1, 0);
  best[0] = 0.f;
  for (int i = 1; i <= n; i++) {
    for (int j = i - 1; j >= 0; j--) {
      uint32_t blen = starts[i] - starts[j];
      if (blen > t.max_piece_len && i - j > 1) break;
      if (best[j] == kNegInf) continue;
      std::string sub = s.substr(starts[j], blen);
      auto it = t.encode_vocab.find(sub);
      float cand;
      if (it != t.encode_vocab.end())
        cand = best[j] + t.scores[it->second];
      else if (i - j == 1)
        cand = best[j] + unk_score;
      else
        continue;
      if (cand > best[i]) {
        best[i] = cand;
        back[i] = j;
      }
    }
  }
  std::vector<std::pair<int, int>> segs;
  for (int i = n; i > 0; i = back[i]) segs.push_back({back[i], i});
  bool prev_unk = false;
  for (auto it = segs.rbegin(); it != segs.rend(); ++it)
    resolve_symbol(t, s.substr(starts[it->first], starts[it->second] - starts[it->first]),
                   prev_unk, out);
}

}  // namespace

// ---------------------------------------------------------------------------

extern "C" {

void* tok_create(const char** piece_strs, const float* scores, const int* types,
                 int n, int model_type, int unk_id, int byte_fallback,
                 int add_dummy_prefix, int remove_extra_ws) {
  auto* t = new Tokenizer();
  t->pieces.reserve(n);
  t->model_type = model_type;
  t->unk_id = unk_id;
  t->byte_fallback = byte_fallback != 0;
  t->add_dummy_prefix = add_dummy_prefix != 0;
  t->remove_extra_ws = remove_extra_ws != 0;
  for (int i = 0; i < 256; i++) t->byte_ids[i] = unk_id;
  bool any_normal = false;
  for (int i = 0; i < n; i++) {
    t->pieces.emplace_back(piece_strs[i]);
    t->scores.push_back(scores[i]);
    t->types.push_back(types[i]);
    const std::string& p = t->pieces.back();
    if (types[i] == kNormal || types[i] == kUserDefined) {
      t->encode_vocab.emplace(p, i);
      if (p.size() > t->max_piece_len) t->max_piece_len = p.size();
    }
    if (types[i] == kNormal) {
      if (!any_normal || scores[i] < t->min_score) t->min_score = scores[i];
      any_normal = true;
    }
    if (types[i] == kByte && p.size() == 6) {  // "<0xAB>"
      int v = (int)strtol(p.substr(3, 2).c_str(), nullptr, 16);
      t->byte_ids[v & 0xFF] = i;
    }
  }
  return t;
}

void tok_free(void* h) { delete (Tokenizer*)h; }

// Returns number of tokens (may exceed out_cap: call again with larger buffer).
int tok_encode(void* h, const char* text, int32_t* out, int out_cap) {
  auto* t = (Tokenizer*)h;
  std::string s = normalize(*t, text);
  std::vector<int> ids;
  ids.reserve(s.size() / 3 + 8);
  if (t->model_type == 2)
    bpe_encode(*t, s, ids);
  else
    unigram_encode(*t, s, ids);
  int n = (int)ids.size();
  for (int i = 0; i < n && i < out_cap; i++) out[i] = ids[i];
  return n;
}
}
