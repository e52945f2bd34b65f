// OpenEXR PIZ Huffman coder (ImfHuf.cpp byte format), C ABI for ctypes;
// port of libyafaray_tpu/io/cpp/exr_huf.cpp, built by ops/_build.py
// `load_host` into the package's _build/ directory.
//
// Reference role: the upstream image handler links libIlmImf whose PIZ
// codec uses this canonical-Huffman format (SURVEY §2.12).  Implemented
// from the published OpenEXR format: 20-byte header (im, iM, tableLength,
// nBits, reserved — little-endian u32), 6-bit packed code-length table
// with zero-run codes 59..63, MSB-first bitstream with a run-length
// pseudo-symbol (code index iM, 8-bit run counts).
//
// The exact Huffman *length assignment* is not format-relevant (both
// sides rebuild canonical codes from the serialized lengths), so this
// uses a plain heap build with a rebuild-on-overflow cap at 58 bits.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int HUF_ENCSIZE = 65537;  // 2^16 data symbols + 1 RLE symbol
constexpr int MAX_CODE_LEN = 58;
constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;
constexpr int LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN;

struct BitWriter {
    uint8_t* out;
    uint8_t* p;
    uint64_t c = 0;
    int lc = 0;
    explicit BitWriter(uint8_t* o) : out(o), p(o) {}
    void write(int nbits, uint64_t bits) {
        c = (c << nbits) | bits;
        lc += nbits;
        while (lc >= 8) {
            lc -= 8;
            *p++ = static_cast<uint8_t>(c >> lc);
        }
    }
    long flushCount() const { return (p - out) * 8 + lc; }
    void pad() {
        if (lc) *p++ = static_cast<uint8_t>(c << (8 - lc));
        lc = 0;
    }
};

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t c = 0;
    int lc = 0;
    BitReader(const uint8_t* b, long n) : p(b), end(b + n) {}
    // ensure at least n bits buffered (zero-fill past end)
    void fill(int n) {
        while (lc < n) {
            c = (c << 8) | (p < end ? *p++ : 0);
            lc += 8;
        }
    }
    uint64_t peek(int n) {
        fill(n);
        return (c >> (lc - n)) & ((1ull << n) - 1);
    }
    void skip(int n) { lc -= n; }
    uint64_t read(int n) {
        uint64_t v = peek(n);
        skip(n);
        return v;
    }
};

// ---- code length construction (heap; cap 58 via freq scaling) ----------
void buildLengths(std::vector<uint64_t>& frq, std::vector<int>& len) {
    for (;;) {
        using Node = std::pair<uint64_t, int>;  // (freq, tree index)
        std::priority_queue<Node, std::vector<Node>, std::greater<Node>> q;
        int nsym = 0;
        std::vector<int> parent(2 * HUF_ENCSIZE, -1);
        int next = HUF_ENCSIZE;
        for (int i = 0; i < HUF_ENCSIZE; ++i)
            if (frq[i]) {
                q.push({frq[i], i});
                ++nsym;
            }
        std::fill(len.begin(), len.end(), 0);
        if (nsym == 0) return;
        if (nsym == 1) {
            len[q.top().second] = 1;
            return;
        }
        while (q.size() > 1) {
            Node a = q.top(); q.pop();
            Node b = q.top(); q.pop();
            parent[a.second] = next;
            parent[b.second] = next;
            q.push({a.first + b.first, next});
            ++next;
        }
        int maxLen = 0;
        for (int i = 0; i < HUF_ENCSIZE; ++i) {
            if (!frq[i]) continue;
            int l = 0;
            for (int j = i; parent[j] >= 0; j = parent[j]) ++l;
            len[i] = l;
            if (l > maxLen) maxLen = l;
        }
        if (maxLen <= MAX_CODE_LEN) return;
        for (int i = 0; i < HUF_ENCSIZE; ++i)
            if (frq[i]) frq[i] = (frq[i] >> 1) | 1;
    }
}

// ---- canonical codes from lengths (hufCanonicalCodeTable) ---------------
void canonicalCodes(const std::vector<int>& len,
                    std::vector<uint64_t>& code) {
    uint64_t n[MAX_CODE_LEN + 1] = {0};
    for (int i = 0; i < HUF_ENCSIZE; ++i) n[len[i]]++;
    uint64_t c = 0;
    for (int i = MAX_CODE_LEN; i > 0; --i) {
        uint64_t nc = (c + n[i]) >> 1;
        n[i] = c;
        c = nc;
    }
    for (int i = 0; i < HUF_ENCSIZE; ++i)
        code[i] = len[i] ? n[len[i]]++ : 0;
}

void put32(uint8_t* p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}
uint32_t get32(const uint8_t* p) {
    return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16)
         | (uint32_t(p[3]) << 24);
}

}  // namespace

extern "C" {

// returns compressed byte count, or -1 on overflow of `cap`
long lyt_huf_compress(const uint16_t* raw, long n, uint8_t* out, long cap) {
    if (n == 0) return 0;
    std::vector<uint64_t> frq(HUF_ENCSIZE, 0);
    for (long i = 0; i < n; ++i) frq[raw[i]]++;
    // RLE pseudo-symbol: one past the largest data symbol
    int iM = 0;
    for (int i = 0; i < HUF_ENCSIZE - 1; ++i)
        if (frq[i]) iM = i;
    iM += 1;
    frq[iM] = 1;
    int im = 0;
    while (!frq[im]) ++im;

    std::vector<int> len(HUF_ENCSIZE, 0);
    buildLengths(frq, len);
    std::vector<uint64_t> code(HUF_ENCSIZE, 0);
    canonicalCodes(len, code);

    if (cap < 20 + 2 * n + 4096) return -1;  // conservative
    uint8_t* tableStart = out + 20;
    // ---- pack code-length table (hufPackEncTable) ----
    BitWriter tw(tableStart);
    for (int i = im; i <= iM; ++i) {
        int l = len[i];
        if (l == 0) {
            int zerun = 1;
            while (i + zerun <= iM && zerun < LONGEST_LONG_RUN
                   && len[i + zerun] == 0)
                ++zerun;
            if (zerun >= 2) {
                if (zerun >= SHORTEST_LONG_RUN) {
                    tw.write(6, LONG_ZEROCODE_RUN);
                    tw.write(8, zerun - SHORTEST_LONG_RUN);
                } else {
                    tw.write(6, SHORT_ZEROCODE_RUN + zerun - 2);
                }
                i += zerun - 1;
                continue;
            }
        }
        tw.write(6, l);
    }
    tw.pad();
    long tableLength = tw.p - tableStart;

    // ---- encode data (hufEncode) ----
    BitWriter dw(tableStart + tableLength);
    uint64_t rlcCode = code[iM];
    int rlcLen = len[iM];
    auto sendCode = [&](int sym, int runCount) {
        uint64_t sCode = code[sym];
        int sLen = len[sym];
        if (runCount > 0
            && sLen + rlcLen + 8 < sLen * (runCount + 1)) {
            dw.write(sLen, sCode);
            dw.write(rlcLen, rlcCode);
            dw.write(8, runCount);
        } else {
            for (int k = 0; k <= runCount; ++k) dw.write(sLen, sCode);
        }
    };
    int cur = raw[0];
    int run = 0;
    for (long i = 1; i < n; ++i) {
        if (raw[i] == cur && run < 255) {
            ++run;
        } else {
            sendCode(cur, run);
            cur = raw[i];
            run = 0;
        }
    }
    sendCode(cur, run);
    long nBits = dw.flushCount();
    dw.pad();
    long dataLength = dw.p - (tableStart + tableLength);

    put32(out, im);
    put32(out + 4, iM);
    put32(out + 8, (uint32_t)tableLength);
    put32(out + 12, (uint32_t)nBits);
    put32(out + 16, 0);
    long total = 20 + tableLength + dataLength;
    return (total <= cap) ? total : -1;
}

// returns 0 on success
int lyt_huf_decompress(const uint8_t* in, long nin, uint16_t* out,
                       long nout) {
    if (nout == 0) return 0;
    if (nin < 20) return -1;
    uint32_t im = get32(in);
    uint32_t iM = get32(in + 4);
    uint32_t nBits = get32(in + 12);
    if (im >= HUF_ENCSIZE || iM >= HUF_ENCSIZE || im > iM) return -2;
    const uint8_t* tp = in + 20;

    // ---- unpack code-length table ----
    std::vector<int> len(HUF_ENCSIZE, 0);
    BitReader tr(tp, nin - 20);
    for (uint32_t i = im; i <= iM;) {
        int l = (int)tr.read(6);
        if (l == LONG_ZEROCODE_RUN) {
            int zerun = (int)tr.read(8) + SHORTEST_LONG_RUN;
            while (zerun-- && i <= iM) len[i++] = 0;
        } else if (l >= SHORT_ZEROCODE_RUN) {
            int zerun = l - SHORT_ZEROCODE_RUN + 2;
            while (zerun-- && i <= iM) len[i++] = 0;
        } else {
            len[i++] = l;
        }
    }
    long tableBytes = (tr.p - tp) - (tr.lc / 8);
    // header's tableLength field is authoritative for the data offset
    uint32_t tableLength = get32(in + 8);
    (void)tableBytes;
    std::vector<uint64_t> code(HUF_ENCSIZE, 0);
    canonicalCodes(len, code);

    // ---- decode tables: 14-bit fast path + long-code list ----
    constexpr int DECBITS = 14;
    std::vector<uint32_t> fast(1 << DECBITS, 0);  // (sym<<8)|len
    struct LongCode { uint64_t code; int len; int sym; };
    std::vector<LongCode> longs;
    for (int s = 0; s < HUF_ENCSIZE; ++s) {
        int l = len[s];
        if (!l) continue;
        if (l <= DECBITS) {
            uint32_t base = (uint32_t)(code[s] << (DECBITS - l));
            uint32_t cnt = 1u << (DECBITS - l);
            for (uint32_t k = 0; k < cnt; ++k)
                fast[base + k] = ((uint32_t)s << 8) | (uint32_t)l;
        } else {
            longs.push_back({code[s], l, s});
        }
    }

    BitReader dr(tp + tableLength, nin - 20 - tableLength);
    long outPos = 0;
    long bitsLeft = nBits;
    int prev = -1;
    while (outPos < nout && bitsLeft > 0) {
        uint32_t f = fast[(uint32_t)dr.peek(DECBITS)];
        int sym, l;
        if (f) {
            sym = (int)(f >> 8);
            l = (int)(f & 0xff);
            dr.skip(l);
        } else {
            sym = -1;
            l = 0;
            for (const auto& lc : longs) {
                if ((uint64_t)dr.peek(lc.len) == lc.code) {
                    sym = lc.sym;
                    l = lc.len;
                    break;
                }
            }
            if (sym < 0) return -3;
            dr.skip(l);
        }
        bitsLeft -= l;
        if (sym == (int)iM) {  // RLE: repeat previous
            if (prev < 0) return -4;
            int run = (int)dr.read(8);
            bitsLeft -= 8;
            for (int k = 0; k < run && outPos < nout; ++k)
                out[outPos++] = (uint16_t)prev;
        } else {
            out[outPos++] = (uint16_t)sym;
            prev = sym;
        }
    }
    return (outPos == nout) ? 0 : -5;
}

}  // extern "C"
