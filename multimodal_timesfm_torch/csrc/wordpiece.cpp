// Fast WordPiece tokenizer (C++), used by the offline text-embedding cache.
//
// Native counterpart of multimodal_timesfm_torch/text/tokenizer.py: the cache
// build (python -m multimodal_timesfm_torch.time_mmd.cache) tokenizes tens of
// thousands of report texts; the Python WordPiece loop is the host-side hot spot. This
// library implements the same pipeline — clean, lowercase, Latin accent
// fold, punctuation/CJK split, greedy longest-match WordPiece — over UTF-8,
// exposed via a C ABI consumed with ctypes (no pybind11 in this image).
//
// Parity domain: matches the Python implementation exactly on ASCII and
// Latin-1/Latin-Extended-A text (the Time-MMD corpus). Texts containing
// combining marks outside that range may tokenize differently (full NFD
// needs Unicode tables); callers can force the Python path for those.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t pad = 0, unk = 1, cls = 2, sep = 3;
  int32_t max_chars_per_word = 100;
};

// --- UTF-8 iteration ---------------------------------------------------

// Decode one codepoint starting at s[i]; advances i. Invalid bytes yield
// the replacement char and advance by 1.
uint32_t decode(const std::string_view s, size_t& i) {
  const unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < s.size()) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < s.size()) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < s.size()) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return 0xFFFD;
}

void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) { out.push_back(char(cp)); }
  else if (cp < 0x800) {
    out.push_back(char(0xC0 | (cp >> 6)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(char(0xE0 | (cp >> 12)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(char(0xF0 | (cp >> 18)));
    out.push_back(char(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  }
}

// --- character classes (mirrors tokenizer.py rules) ---------------------

bool is_whitespace(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' ||
         cp == 0x00A0 || (cp >= 0x2000 && cp <= 0x200A) || cp == 0x202F ||
         cp == 0x205F || cp == 0x3000;
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  if (cp < 0x20 || cp == 0x7F || (cp >= 0x80 && cp <= 0x9F)) return true;  // Cc
  // Cf format chars (HF drops all C* categories): soft hyphen, bidi marks,
  // zero-width chars, BOM, interlinear annotation, arabic format chars.
  return cp == 0xAD || (cp >= 0x600 && cp <= 0x605) || cp == 0x61C ||
         cp == 0x6DD || cp == 0x70F || cp == 0x8E2 || cp == 0x180E ||
         (cp >= 0x200B && cp <= 0x200F) || (cp >= 0x202A && cp <= 0x202E) ||
         (cp >= 0x2060 && cp <= 0x2064) || (cp >= 0x2066 && cp <= 0x206F) ||
         cp == 0xFEFF || (cp >= 0xFFF9 && cp <= 0xFFFB);
}

bool is_punct(uint32_t cp) {
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  // Latin-1 punctuation (P* categories)
  if (cp == 0xA1 || cp == 0xA7 || cp == 0xAB || cp == 0xB6 || cp == 0xB7 ||
      cp == 0xBB || cp == 0xBF)
    return true;
  // common general-punctuation / CJK ranges (P* categories)
  if ((cp >= 0x2010 && cp <= 0x2027) || (cp >= 0x2030 && cp <= 0x205E) ||
      (cp >= 0x2E00 && cp <= 0x2E7F) ||
      (cp >= 0x3001 && cp <= 0x3003) || (cp >= 0x3008 && cp <= 0x3011) ||
      (cp >= 0x3014 && cp <= 0x301F) || cp == 0x30FB)
    return true;
  // fullwidth forms: only the P-category members (excludes ＄＋＜＝＞＾｀｜～)
  if (cp >= 0xFF01 && cp <= 0xFF65) {
    switch (cp) {
      case 0xFF04: case 0xFF0B: case 0xFF1C: case 0xFF1D: case 0xFF1E:
      case 0xFF3E: case 0xFF40: case 0xFF5C: case 0xFF5E:
        return false;
      default:
        return (cp <= 0xFF0F) || (cp >= 0xFF1A && cp <= 0xFF20) ||
               (cp >= 0xFF3B && cp <= 0xFF40) || (cp >= 0xFF5B && cp <= 0xFF65);
    }
  }
  return false;
}

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// Lowercase + NFD-accent-fold for ASCII / Latin-1 / Latin-Extended-A,
// matching python's `token.lower()` -> NFD -> drop-combining-marks exactly
// on these ranges (non-decomposable letters keep their lowercase form).
// Returns 0 to drop the char (standalone combining mark).
uint32_t fold(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0x0300 && cp <= 0x036F) return 0;  // combining marks (post-NFD)
  if (cp >= 0xC0 && cp <= 0xFF) {  // Latin-1 Supplement
    static const uint32_t base[64] = {
        // U+00C0..U+00DF (uppercase row; lowered first)
        'a','a','a','a','a','a',0xE6,'c','e','e','e','e','i','i','i','i',
        0xF0,'n','o','o','o','o','o',0xD7,0xF8,'u','u','u','u','y',0xFE,0xDF,
        // U+00E0..U+00FF
        'a','a','a','a','a','a',0xE6,'c','e','e','e','e','i','i','i','i',
        0xF0,'n','o','o','o','o','o',0xF7,0xF8,'u','u','u','u','y',0xFE,'y'};
    return base[cp - 0xC0];
  }
  if (cp >= 0x100 && cp <= 0x17F) {  // Latin Extended-A
    static const uint16_t base[128] = {
        'a','a','a','a','a','a',                    // 0x100-0x105 A-ogonek etc
        'c','c','c','c','c','c','c','c',            // 0x106-0x10D
        'd','d',                                    // 0x10E-0x10F D-caron
        0x111,0x111,                                // 0x110-0x111 D-stroke (no NFD)
        'e','e','e','e','e','e','e','e','e','e',    // 0x112-0x11B
        'g','g','g','g','g','g','g','g',            // 0x11C-0x123
        'h','h',                                    // 0x124-0x125
        0x127,0x127,                                // 0x126-0x127 H-stroke
        'i','i','i','i','i','i','i','i',            // 0x128-0x12F
        'i',0x131,                                  // 0x130 I-dot, 0x131 dotless i
        0x133,0x133,                                // 0x132-0x133 IJ ligature
        'j','j',                                    // 0x134-0x135
        'k','k',0x138,                              // 0x136-0x138 (kra)
        'l','l','l','l','l','l',                    // 0x139-0x13E
        0x140,0x140,                                // 0x13F-0x140 L-middle-dot (NFKD only)
        0x142,0x142,                                // 0x141-0x142 L-stroke
        'n','n','n','n','n','n',                    // 0x143-0x148
        0x149,                                      // 0x149 n-apostrophe
        0x14B,0x14B,                                // 0x14A-0x14B eng
        'o','o','o','o','o','o',                    // 0x14C-0x151
        0x153,0x153,                                // 0x152-0x153 OE ligature
        'r','r','r','r','r','r',                    // 0x154-0x159
        's','s','s','s','s','s','s','s',            // 0x15A-0x161
        't','t','t','t',                            // 0x162-0x165
        0x167,0x167,                                // 0x166-0x167 T-stroke
        'u','u','u','u','u','u','u','u','u','u','u','u',  // 0x168-0x173
        'w','w',                                    // 0x174-0x175
        'y','y','y',                                // 0x176-0x178 (Y-diaeresis)
        'z','z','z','z','z','z',                    // 0x179-0x17E
        0x17F};                                     // 0x17F long s
    return base[cp - 0x100];
  }
  return cp;
}

// basic tokenization: returns word tokens (UTF-8 strings)
std::vector<std::string> basic_tokenize(std::string_view text) {
  std::vector<std::string> out;
  std::string current;
  auto flush = [&]() {
    if (!current.empty()) { out.push_back(current); current.clear(); }
  };
  size_t i = 0;
  while (i < text.size()) {
    uint32_t cp = decode(text, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) { flush(); continue; }
    if (is_cjk(cp)) { flush(); std::string s; append_utf8(s, cp); out.push_back(s); continue; }
    cp = fold(cp);
    if (cp == 0) continue;
    if (is_punct(cp)) { flush(); std::string s; append_utf8(s, cp); out.push_back(s); continue; }
    append_utf8(current, cp);
  }
  flush();
  return out;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_text) {
  auto* v = new Vocab();
  std::string_view sv(vocab_text);
  size_t start = 0;
  int32_t idx = 0;
  while (start <= sv.size()) {
    size_t end = sv.find('\n', start);
    if (end == std::string_view::npos) end = sv.size();
    std::string token(sv.substr(start, end - start));
    if (!token.empty()) {
      if (token == "[PAD]") v->pad = idx;
      else if (token == "[UNK]") v->unk = idx;
      else if (token == "[CLS]") v->cls = idx;
      else if (token == "[SEP]") v->sep = idx;
      // assignment (not emplace): duplicate vocab tokens resolve
      // last-occurrence-wins, matching the Python tokenizer's dict load
      // (and HF BertTokenizer's load_vocab)
      v->map[std::move(token)] = idx;
      ++idx;
    } else if (end < sv.size()) {
      ++idx;  // preserve line numbering for empty lines
    }
    if (end == sv.size()) break;
    start = end + 1;
  }
  return v;
}

void wp_destroy(void* h) { delete static_cast<Vocab*>(h); }

// Encode `text` into out[0..max_len); returns the number of ids written.
int32_t wp_encode(void* h, const char* text, int32_t max_len, int32_t* out) {
  const Vocab& v = *static_cast<Vocab*>(h);
  int32_t n = 0;
  if (max_len < 2) return 0;
  out[n++] = v.cls;

  for (const std::string& word : basic_tokenize(text)) {
    if (n >= max_len - 1) break;
    // codepoint boundary offsets
    std::vector<size_t> bounds;
    {
      size_t i = 0;
      while (i < word.size()) { bounds.push_back(i); decode(word, i); }
      bounds.push_back(word.size());
    }
    if ((int32_t)bounds.size() - 1 > v.max_chars_per_word) {
      out[n++] = v.unk;
      continue;
    }
    std::vector<int32_t> piece_ids;
    size_t start = 0;  // index into bounds
    bool bad = false;
    while (start + 1 < bounds.size()) {
      size_t end = bounds.size() - 1;
      int32_t cur = -1;
      size_t cur_end = start;
      while (start < end) {
        std::string sub;
        if (start > 0) sub = "##";
        sub.append(word, bounds[start], bounds[end] - bounds[start]);
        auto it = v.map.find(sub);
        if (it != v.map.end()) { cur = it->second; cur_end = end; break; }
        --end;
      }
      if (cur < 0) { bad = true; break; }
      piece_ids.push_back(cur);
      start = cur_end;
    }
    if (bad) { out[n++] = v.unk; continue; }
    for (int32_t id : piece_ids) {
      if (n >= max_len - 1) break;
      out[n++] = id;
    }
  }
  out[n++] = v.sep;
  return n;
}

}  // extern "C"
