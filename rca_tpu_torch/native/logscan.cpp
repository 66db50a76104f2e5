// Native multi-pattern log scanner (the hot host-side op of feature
// extraction).  Counts non-overlapping matches of N pattern classes, each an
// ordered list of alternatives, mirroring Python re.findall alternation
// semantics (leftmost position, first matching branch, consume the span).
//
// Pattern mini-language (compiled by rca_tpu_torch/native/__init__.py):
//   ordinary byte        literal (spec is pre-lowercased for CI classes)
//   \x01                 exactly one ASCII digit
//   \x02                 one or more word chars [A-Za-z0-9_] (max-munch)
//   \x03                 zero or more whitespace chars
//   \x04                 exactly one whitespace char
//   \x06                 greedy any-chars-within-line, must be followed by a
//                        literal tail: consumes up to the LAST occurrence of
//                        that tail on the current line (mirrors greedy `.*`)
//
// Per-alternative flags: bit0 = whole-word boundary at both ends,
// bit1 = case-sensitive (match against the original text, not the
// lowercased copy).
//
// Serialized spec: classes joined by '\x1e'; alternatives joined by '\x1f';
// each alternative = one flags byte ('0' + flags) followed by pattern bytes.
//
// Exposed C ABI:
//   rca_scan(text, len, counts_out)     counts per class into int32[n]
//   rca_load_spec(spec, len) -> n       compile the spec (process-global)

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline bool is_word(unsigned char c) {
    return std::isalnum(c) || c == '_';
}

struct Alt {
    std::string pat;   // token string
    bool word_bound;
    bool case_sensitive;
};

struct Class {
    std::vector<Alt> alts;
    bool first[256] = {false};  // possible first bytes in lowercased text
};

// Mark the possible first bytes of pattern p (from token k) into `first`,
// as seen in the lowercased text (case-sensitive alts fold to lowercase —
// a sound over-approximation since lower[i] == tolower(orig[i])).
void mark_first_bytes(const std::string& p, size_t k, bool* first) {
    if (k >= p.size()) return;
    unsigned char tok = p[k];
    if (tok == 0x01) {
        for (unsigned char c = '0'; c <= '9'; ++c) first[c] = true;
    } else if (tok == 0x02) {
        for (int c = 0; c < 256; ++c)
            if (is_word((unsigned char)c)) first[c] = true;
    } else if (tok == 0x03) {
        for (int c = 0; c < 256; ++c)
            if (std::isspace(c) && c != '\n') first[c] = true;
        mark_first_bytes(p, k + 1, first);  // \x03 may match empty
    } else if (tok == 0x04) {
        for (int c = 0; c < 256; ++c)
            if (std::isspace(c)) first[c] = true;
    } else if (tok == 0x06) {
        for (int c = 0; c < 256; ++c) first[c] = true;
    } else {
        first[std::tolower(tok)] = true;
    }
}

std::vector<Class> g_classes;

// Try to match one alternative at text[pos..]; returns match end or -1.
// `lower` is the lowercased text, `orig` the original; both share length n.
long match_at(const Alt& alt, const char* lower, const char* orig, long n,
              long pos) {
    const char* text = alt.case_sensitive ? orig : lower;
    if (alt.word_bound && pos > 0 && is_word(text[pos - 1])) return -1;
    long i = pos;
    const std::string& p = alt.pat;
    for (size_t k = 0; k < p.size(); ++k) {
        unsigned char tok = p[k];
        if (tok == 0x01) {                      // one digit
            if (i >= n || !std::isdigit((unsigned char)text[i])) return -1;
            ++i;
        } else if (tok == 0x02) {               // 1+ word chars
            long start = i;
            while (i < n && is_word(text[i])) ++i;
            if (i == start) return -1;
        } else if (tok == 0x03) {               // 0+ whitespace
            while (i < n && std::isspace((unsigned char)text[i]) &&
                   text[i] != '\n')
                ++i;
        } else if (tok == 0x04) {               // exactly 1 whitespace
            if (i >= n || !std::isspace((unsigned char)text[i])) return -1;
            ++i;
        } else if (tok == 0x06) {               // greedy .* then literal tail
            std::string tail = p.substr(k + 1);
            if (tail.empty()) return -1;
            long line_end = i;
            while (line_end < n && text[line_end] != '\n') ++line_end;
            // last occurrence of tail in [i, line_end)
            long best = -1;
            long limit = line_end - (long)tail.size();
            for (long j = i; j <= limit; ++j) {
                if (std::memcmp(text + j, tail.data(), tail.size()) == 0)
                    best = j;
            }
            if (best < 0) return -1;
            i = best + (long)tail.size();
            k = p.size();  // tail consumed the rest of the pattern
            break;
        } else {                                // literal byte
            if (i >= n || text[i] != (char)tok) return -1;
            ++i;
        }
    }
    if (alt.word_bound && i < n && is_word(text[i])) return -1;
    return i;
}

}  // namespace

extern "C" {

// Compile the serialized spec; returns the number of classes (or -1).
int rca_load_spec(const char* spec, long len) {
    g_classes.clear();
    std::string s(spec, (size_t)len);
    size_t start = 0;
    while (start <= s.size()) {
        size_t end = s.find('\x1e', start);
        if (end == std::string::npos) end = s.size();
        std::string cls = s.substr(start, end - start);
        Class c;
        size_t a = 0;
        while (a <= cls.size() && !cls.empty()) {
            size_t b = cls.find('\x1f', a);
            if (b == std::string::npos) b = cls.size();
            std::string alt = cls.substr(a, b - a);
            if (!alt.empty()) {
                int flags = alt[0] - '0';
                Alt rec;
                rec.word_bound = flags & 1;
                rec.case_sensitive = flags & 2;
                rec.pat = alt.substr(1);
                mark_first_bytes(rec.pat, 0, c.first);
                c.alts.push_back(rec);
            }
            if (b == cls.size()) break;
            a = b + 1;
        }
        g_classes.push_back(c);
        if (end == s.size()) break;
        start = end + 1;
    }
    return (int)g_classes.size();
}

// Count matches for every class into counts[0..n_classes).
int rca_scan(const char* text, long n, int32_t* counts) {
    std::string lower((size_t)n, '\0');
    for (long i = 0; i < n; ++i)
        lower[(size_t)i] = (char)std::tolower((unsigned char)text[i]);
    const char* lo = lower.data();

    for (size_t ci = 0; ci < g_classes.size(); ++ci) {
        const Class& cls = g_classes[ci];
        int32_t count = 0;
        long pos = 0;
        while (pos < n) {
            if (!cls.first[(unsigned char)lo[pos]]) {  // fast reject
                ++pos;
                continue;
            }
            long end = -1;
            for (const Alt& alt : cls.alts) {
                end = match_at(alt, lo, text, n, pos);
                if (end >= 0) break;
            }
            if (end >= 0 && end > pos) {
                ++count;
                pos = end;
            } else {
                ++pos;
            }
        }
        counts[ci] = count;
    }
    return 0;
}

}  // extern "C"
