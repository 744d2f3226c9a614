// FASTQ/FASTA(.gz) parser (host IO native path, the reference's needletail
// role).  The file's inflated bytes come in pieces from an Inflater while the
// caller's thread splits them into lines and records, so decompression
// overlaps with the parse and with whatever the caller does between chunks.
// A chunk is returned as concatenated sequence / quality / header buffers
// with offsets; the Python wrapper slices them into records.
//
// The Inflater has two paths.  The one-thread path is a thread of its own
// that reads the file through gzread (gzip members one after another, or a
// plain file as it is) in blocks of kBlock.  The parallel path (pugz,
// Kerbiriou & Chikhi 2019; rapidgzip, Knespel & Brunst 2023) takes a gzip
// file of at least two chunks when the caller gives it two workers or more:
// the compressed bytes are cut into chunks of `chunk` bytes and worker i
// inflates chunk i.  Chunk 0 starts at the gzip header, through zlib.  Every
// other chunk starts at the first bit at or past its first where a dynamic
// block header that zlib would take (code-length, literal/length and
// distance codes that zlib accepts, an end-of-block code), or a stored one
// with LEN == ~NLEN, begins, and that block and the next decode.  The 32 KiB
// window before that bit is unknown: Guess decodes into 16-bit symbols, a
// byte or the window position a back-reference reached (a marker), until
// the last 32 KiB of output hold no marker; then zlib goes on with them as
// its window.  A worker decodes past its chunk's end to the first block
// that starts at or past it; member ends (trailer, next header, a fresh
// window) are handled inside a chunk.
//
// INVARIANT: a speculative chunk is used only when the previous chunk's real
// decode lands on its start bit, a block boundary.  Where the real decode
// passes that bit without landing on it, or the chunk found no start, the
// sequencer decodes the chunk itself with zlib from where the real decode
// stands.  So every byte handed out is the real decode of the file, each
// marker replaced from the real window: a false start costs time, never
// bytes.  Each member's CRC-32 and ISIZE are checked, the per-chunk CRCs
// joined by crc32_combine.  A byte is handed out only once the real decode
// has checked the stream kHorizon bytes past it, or to the file's end: as
// far as gzread reads ahead of a block it returns (kBlock, its 2 MiB
// buffer), the stream is known good.  Where the parallel path meets
// anything it cannot place (a bad CRC, a truncated member, a header it does
// not know), gzread takes the file from its start with the bytes already
// handed out skipped, so the caller gets the one-thread path's bytes, byte
// for byte.
// Built by savont_tpu_torch/ops/native_build.py.
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct ParseState {
    std::string seqs, quals, headers;
    std::vector<int64_t> seq_off{0}, qual_off{0}, head_off{0};
    int64_t n_records = 0;
};

constexpr size_t kBlock = 4 << 20;  // bytes a block of the one-thread path, and the most a piece hands out
constexpr int kBlocks = 4;          // blocks at most, in flight between the one-thread path and the caller
constexpr unsigned kGzBuffer = 1 << 20;  // gzbuffer: gzread inflates up to twice this ahead of a block
// how far past a byte the parallel path checks the stream before handing the
// byte out: the block gzread returns it in, its 2 MiB buffer, and room for
// the headers and trailers gzread checks before it would write again
constexpr size_t kHorizon = kBlock + 4 * (size_t)kGzBuffer;
constexpr int64_t kChunk = 4 << 20;  // compressed bytes a chunk of the parallel path
constexpr size_t kWin = 32768;       // deflate's window
constexpr int kTries = 8;            // speculative starts a chunk tries that decode and then fail
constexpr uint64_t kNone = UINT64_MAX;

// A piece of inflated text: n bytes at p, kept alive by buf.
struct Block {
    std::shared_ptr<char> buf;
    const char* p = nullptr;
    size_t n = 0;
    bool pooled = false;  // a kBlock buffer of the one-thread path, to be filled again
};

// ---- the bits of a gzip file ------------------------------------------------

inline uint32_t le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }

// the byte after a gzip member header at byte p, or 0 if it is none zlib takes
size_t gzip_header(const uint8_t* in, size_t n, size_t p) {
    if (p + 10 > n || in[p] != 0x1f || in[p + 1] != 0x8b || in[p + 2] != 8) return 0;
    unsigned flg = in[p + 3];
    if (flg & 0xe0) return 0;
    size_t q = p + 10;
    if (flg & 4) {  // FEXTRA
        if (q + 2 > n) return 0;
        q += 2 + (in[q] | in[q + 1] << 8);
        if (q > n) return 0;
    }
    for (unsigned f : {8u, 16u}) {  // FNAME, FCOMMENT: zero-terminated
        if (!(flg & f)) continue;
        const void* z = memchr(in + q, 0, n - q);
        if (!z) return 0;
        q = (const uint8_t*)z - in + 1;
    }
    if (flg & 2) {  // FHCRC
        if (q + 2 > n || (crc32(0, in + p, (uInt)(q - p)) & 0xffff) != (unsigned)(in[q] | in[q + 1] << 8))
            return 0;
        q += 2;
    }
    return q;
}

// ---- a run of decoded output ---------------------------------------------

// A part of one member inside an Out: bytes [off, off + len); crc is the
// CRC-32 of [crc_from, off + len) (bytes before crc_from are a chunk's
// guessed prefix, filled in later); ends: the member's trailer follows, with
// its CRC and ISIZE.
struct Segment {
    size_t off, len, crc_from;
    uint32_t crc;
    bool ends;
    uint32_t tcrc, tlen;
};

// A malloc'd buffer of T that grows.
template <class T>
struct Grow {
    T* p = nullptr;
    size_t n = 0, cap = 0;
    Grow() = default;
    Grow(const Grow&) = delete;
    ~Grow() { free(p); }
    bool room(size_t k) {
        if (cap - n >= k) return true;
        size_t c = std::max(n + k, cap + cap / 2);
        T* q = (T*)realloc(p, c * sizeof(T));
        if (!q) return false;
        p = q;
        cap = c;
        return true;
    }
};

// Output of a decode, with its members' segments.
struct Out : Grow<char> {
    std::vector<Segment> segs;
    // the buffer, for the pieces handed out of it (this Out is left empty)
    std::shared_ptr<char> release() {
        if (n < cap) {
            char* q = (char*)realloc(p, std::max<size_t>(n, 1));
            if (q) p = q;
        }
        std::shared_ptr<char> b(p, free);
        p = nullptr;
        n = cap = 0;
        return b;
    }
};

// Output of a decode with the window unknown: v < 256 is a byte, v >= 256
// window byte v - 256 (window byte j lies kWin - j bytes before the start).
using Out16 = Grow<uint16_t>;

// after a member's last block, its trailer at byte p: the trailer's CRC and
// ISIZE, and the next member's first block (*next) or the end (*eof: the
// file ends, or what follows is no gzip header, which gzread ignores);
// false where the trailer is cut short or the next header is none zlib takes
bool member_end(const uint8_t* in, size_t n, size_t p, uint32_t* tcrc, uint32_t* tlen,
                size_t* next, bool* eof) {
    if (p + 8 > n) return false;
    *tcrc = le32(in + p);
    *tlen = le32(in + p + 4);
    p += 8;
    *eof = n - p < 2 || in[p] != 0x1f || in[p + 1] != 0x8b;
    if (*eof) return true;
    *next = gzip_header(in, n, p);
    return *next != 0;
}

// ---- deflate with the window unknown -----------------------------------

// A Huffman table entry: the symbol's value, its code's length in bits, and
// op: kLit (val a byte), kLen (val a length or distance base, extra bits in
// op >> 4), kEob, kSub (a subtable at val of op >> 4 index bits), kBad.
struct HEntry {
    uint16_t val;
    uint8_t bits, op;
};
enum : uint8_t { kLit = 0, kLen = 1, kEob = 2, kSub = 3, kBad = 4 };
constexpr int kLitRoot = 10, kDistRoot = 8, kClRoot = 7;
constexpr size_t kLitTab = (1 << kLitRoot) + 288 * (1 << (15 - kLitRoot));
constexpr size_t kDistTab = (1 << kDistRoot) + 32 * (1 << (15 - kDistRoot));

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
                                193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

enum TabKind { kCodes, kLens, kDists };

// The table of a code given by its lengths; false where zlib's inflate_table
// refuses it: over-subscribed, or incomplete unless it is one code of length
// 1 (or, for distances, no code at all).  The code-length code must be
// complete: zlib takes no other.
bool build_table(const uint8_t* lens, int n, TabKind kind, int root, HEntry* tab) {
    int count[16] = {0};
    for (int i = 0; i < n; ++i) count[lens[i]]++;
    count[0] = 0;
    int longest = 0, left = 1;
    for (int len = 1; len <= 15; ++len) {
        if (count[len]) longest = len;
        left = (left << 1) - count[len];
        if (left < 0) return false;
    }
    if (left > 0 && (kind == kCodes || longest > 1)) return false;
    const HEntry bad = {0, 1, kBad};
    for (int f = 0; f < (1 << root); ++f) tab[f] = bad;
    int next[16], sub_bits = longest > root ? longest - root : 0;
    for (int len = 1, code = 0; len <= 15; ++len) {
        code = (code + count[len - 1]) << 1;
        next[len] = code;
    }
    int sub_of[1 << kLitRoot];
    for (int f = 0; f < (1 << root); ++f) sub_of[f] = -1;
    int sub_next = 1 << root;
    for (int s = 0; s < n; ++s) {
        int len = lens[s];
        if (!len) continue;
        HEntry e = {(uint16_t)s, (uint8_t)len, kLit};
        if (kind == kLens) {
            if (s == 256) e.op = kEob;
            else if (s > 256 && s < 286) e = {kLenBase[s - 257], (uint8_t)len, (uint8_t)(kLen | kLenExtra[s - 257] << 4)};
            else if (s >= 286) e.op = kBad;
        } else if (kind == kDists) {
            e = s < 30 ? HEntry{kDistBase[s], (uint8_t)len, (uint8_t)(kLen | kDistExtra[s] << 4)} : HEntry{0, (uint8_t)len, kBad};
        }
        int code = next[len]++, rev = 0;
        for (int i = 0; i < len; ++i) rev |= ((code >> i) & 1) << (len - 1 - i);
        if (len <= root) {
            for (int f = rev; f < (1 << root); f += 1 << len) tab[f] = e;
            continue;
        }
        int prefix = rev & ((1 << root) - 1);
        if (sub_of[prefix] < 0) {
            sub_of[prefix] = sub_next;
            tab[prefix] = {(uint16_t)sub_next, (uint8_t)root, (uint8_t)(kSub | sub_bits << 4)};
            for (int f = 0; f < (1 << sub_bits); ++f) tab[sub_next + f] = bad;
            sub_next += 1 << sub_bits;
        }
        for (int f = rev >> root; f < (1 << sub_bits); f += 1 << (len - root)) tab[sub_of[prefix] + f] = e;
    }
    return true;
}

struct FixedTables {
    HEntry lit[kLitTab], dist[kDistTab];
    FixedTables() {
        uint8_t l[288], d[32];
        for (int s = 0; s < 288; ++s) l[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
        for (int s = 0; s < 32; ++s) d[s] = 5;
        build_table(l, 288, kLens, kLitRoot, lit);
        build_table(d, 32, kDists, kDistRoot, dist);
    }
};
const FixedTables& fixed_tables() {
    static const FixedTables t;
    return t;
}

// Raw deflate from a block start with the window unknown, a block at a
// time, into 16-bit symbols; as strict as zlib's inflate on everything but
// the window (how far back a distance may reach is checked when the window
// is known).
class Guess {
  public:
    Guess(const uint8_t* in, size_t n) : in_(in), n_(n) {}
    void start(uint64_t bit) {
        ip_ = (size_t)(bit >> 3);
        bb_ = 0;
        bc_ = 0;
        refill();
        drop((int)(bit & 7));
        last_marker_ = kNone;
    }
    uint64_t bit() const { return (uint64_t)ip_ * 8 - bc_; }
    // whether a dynamic block header zlib would take, or a stored one whose
    // LEN is ~NLEN, starts at this bit (a fixed block is no start to look for)
    bool header_at(uint64_t bit) {
        start(bit);
        int type = (int)(bb_ >> 1) & 3;
        drop(3);
        size_t p;
        unsigned len;
        return type == 2 ? dynamic() : type == 0 && stored_len(&p, &len);
    }
    // where the last window byte was written (kNone: nowhere); a copy may be
    // taken for one, so this errs late
    size_t last_marker() const { return last_marker_; }

    // one block into w; *final: it was the member's last; false where zlib
    // fails, or the file ends before the block does
    bool block(Out16& w, bool* final) {
        refill();
        *final = bb_ & 1;
        int type = (int)(bb_ >> 1) & 3;
        drop(3);
        bool ok;
        if (type == 0) {
            ok = stored(w);
        } else if (type == 1) {
            ok = codes(fixed_tables().lit, fixed_tables().dist, w);
        } else if (type == 2) {
            ok = dynamic() && codes(lit_, dist_, w);
        } else {
            ok = false;
        }
        return ok && bit() <= (uint64_t)n_ * 8;
    }

  private:
    void refill() {
        if (ip_ + 8 <= n_) {
            uint64_t v;
            memcpy(&v, in_ + ip_, 8);
            bb_ |= v << bc_;
            ip_ += (63 - bc_) >> 3;
            bc_ |= 56;
        } else {
            while (bc_ <= 56) {  // past the end, zeros: block() then fails
                bb_ |= (uint64_t)(ip_ < n_ ? in_[ip_] : 0) << bc_;
                ++ip_;
                bc_ += 8;
            }
        }
    }
    void drop(int k) {
        bb_ >>= k;
        bc_ -= k;
    }

    // a stored block's bytes: *len of them from byte *p
    bool stored_len(size_t* p, unsigned* len) {
        size_t q = (size_t)((bit() + 7) >> 3);
        if (q + 4 > n_) return false;
        *len = in_[q] | in_[q + 1] << 8;
        *p = q + 4;
        return *len == (~(in_[q + 2] | in_[q + 3] << 8) & 0xffffu) && *p + *len <= n_;
    }
    bool stored(Out16& w) {
        size_t p;
        unsigned len;
        if (!stored_len(&p, &len) || !w.room(len)) return false;
        for (unsigned k = 0; k < len; ++k) w.p[w.n + k] = in_[p + k];
        w.n += len;
        ip_ = p + len;
        bb_ = 0;
        bc_ = 0;
        refill();
        return true;
    }

    bool dynamic() {
        refill();
        int nlen = (int)(bb_ & 31) + 257, ndist = (int)((bb_ >> 5) & 31) + 1, ncode = (int)((bb_ >> 10) & 15) + 4;
        drop(14);
        if (nlen > 286 || ndist > 30) return false;
        static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        uint8_t cl[19] = {0};
        for (int i = 0; i < ncode; ++i) {
            if (bc_ < 3) refill();
            cl[order[i]] = bb_ & 7;
            drop(3);
        }
        HEntry ct[1 << kClRoot];
        if (!build_table(cl, 19, kCodes, kClRoot, ct)) return false;
        uint8_t lens[320];
        int have = 0, total = nlen + ndist;
        while (have < total) {
            if (bc_ < 14) refill();
            HEntry e = ct[bb_ & ((1 << kClRoot) - 1)];
            drop(e.bits);
            int sym = e.val;
            if (sym < 16) {
                lens[have++] = (uint8_t)sym;
                continue;
            }
            int rep;
            uint8_t val = 0;
            if (sym == 16) {
                if (have == 0) return false;
                val = lens[have - 1];
                rep = 3 + (int)(bb_ & 3);
                drop(2);
            } else if (sym == 17) {
                rep = 3 + (int)(bb_ & 7);
                drop(3);
            } else {
                rep = 11 + (int)(bb_ & 127);
                drop(7);
            }
            if (have + rep > total) return false;
            memset(lens + have, val, rep);
            have += rep;
        }
        if (lens[256] == 0) return false;
        return build_table(lens, nlen, kLens, kLitRoot, lit_) && build_table(lens + nlen, ndist, kDists, kDistRoot, dist_);
    }

    // a block's codes up to its end-of-block
    bool codes(const HEntry* lt, const HEntry* dt, Out16& w) {
        uint64_t bb = bb_;
        int bc = bc_;
        size_t ip = ip_, n = w.n, lastm = last_marker_;
        uint16_t* out = w.p;
        bool ok = false;
        while (true) {
            if (w.cap - n < 262) {
                w.n = n;
                if (!w.room(1 << 16)) break;
                out = w.p;
            }
            if (bc < 48) {
                if (ip + 8 <= n_) {
                    uint64_t v;
                    memcpy(&v, in_ + ip, 8);
                    bb |= v << bc;
                    ip += (63 - bc) >> 3;
                    bc |= 56;
                } else {
                    if (ip > n_ + 8) break;  // far past the end: the file ends short
                    while (bc <= 56) {
                        bb |= (uint64_t)(ip < n_ ? in_[ip] : 0) << bc;
                        ++ip;
                        bc += 8;
                    }
                }
            }
            HEntry e = lt[bb & ((1u << kLitRoot) - 1)];
            if ((e.op & 15) == kSub) e = lt[e.val + ((bb >> kLitRoot) & ((1u << (e.op >> 4)) - 1))];
            bb >>= e.bits;
            bc -= e.bits;
            int op = e.op & 15;
            if (op == kLit) {
                out[n++] = e.val;
                continue;
            }
            if (op != kLen) {
                ok = op == kEob;
                break;
            }
            int extra = e.op >> 4;
            size_t len = e.val + (bb & ((1u << extra) - 1));
            bb >>= extra;
            bc -= extra;
            HEntry d = dt[bb & ((1u << kDistRoot) - 1)];
            if ((d.op & 15) == kSub) d = dt[d.val + ((bb >> kDistRoot) & ((1u << (d.op >> 4)) - 1))];
            bb >>= d.bits;
            bc -= d.bits;
            if ((d.op & 15) != kLen) break;
            extra = d.op >> 4;
            size_t dist = d.val + (bb & ((1u << extra) - 1));
            bb >>= extra;
            bc -= extra;
            uint16_t* to = out + n;
            if (dist > n) {  // into the window before the start (at most kWin back)
                for (size_t k = 0; k < len; ++k) {
                    size_t at = n + k;
                    to[k] = at >= dist ? out[at - dist] : (uint16_t)(256 + kWin + at - dist);
                }
                lastm = n + len - 1;
            } else if (dist >= 4) {
                const uint16_t* from = to - dist;
                uint64_t any = 0;
                for (size_t k = 0; k < len; k += 4) {
                    uint64_t v;
                    memcpy(&v, from + k, 8);
                    memcpy(to + k, &v, 8);
                    any |= v;
                }
                if (any & 0xff00ff00ff00ff00ull) lastm = n + len - 1;
            } else {
                const uint16_t* from = to - dist;
                uint16_t any = 0;
                for (size_t k = 0; k < len; ++k) any |= to[k] = from[k];
                if (any & 0xff00) lastm = n + len - 1;
            }
            n += len;
        }
        w.n = n;
        bb_ = bb;
        bc_ = bc;
        ip_ = ip;
        last_marker_ = lastm;
        return ok;
    }

    const uint8_t* in_;
    size_t n_;
    size_t ip_ = 0;  // the next byte for the bit buffer
    uint64_t bb_ = 0;
    int bc_ = 0;  // bits in bb_
    size_t last_marker_ = kNone;
    HEntry lit_[kLitTab], dist_[kDistTab];
};

// ---- deflate with the window known --------------------------------------

// Raw deflate through zlib over a whole gzip file, members and all.
class Engine {
  public:
    enum Res { STOP, END, MORE, FAIL };

    Engine(const uint8_t* in, size_t n, const std::atomic<bool>* abort) : in_(in), n_(n), abort_(abort) {
        memset(&z_, 0, sizeof z_);
        ok_ = inflateInit2(&z_, -15) == Z_OK;
    }
    ~Engine() { inflateEnd(&z_); }
    bool ok() const { return ok_; }

    // start at the first block of a member whose header starts at byte p
    // (a new segment); false if the header is none zlib takes
    bool at_header(size_t p) {
        size_t q = gzip_header(in_, n_, p);
        if (!q) return false;
        inflateReset(&z_);
        pos_ = q;
        seg_open_ = eof_ = false;
        return true;
    }
    // start at a block header at this bit, after wlen bytes of window
    void at_block(uint64_t bit, const char* win, size_t wlen) {
        inflateReset(&z_);
        size_t b = (size_t)(bit >> 3);
        int r = (int)(bit & 7);
        if (r) {
            inflatePrime(&z_, 8 - r, in_[b] >> r);
            ++b;
        }
        pos_ = b;
        if (wlen) inflateSetDictionary(&z_, (const Bytef*)win, (uInt)wlen);
        seg_open_ = eof_ = false;
    }
    // where the decode stopped: the block start (STOP), the file's end (END)
    uint64_t bit() const { return bit_; }

    // Decode into o until a block starts at or past bit `stop` (STOP), to
    // the end of the file's last member (END), or until o holds max_out
    // bytes (MORE; a run may go on from there); FAIL where zlib or the
    // framing fails, or the file ends short.
    Res run(Out& o, uint64_t stop, size_t max_out) {
        if (!seg_open_) open_seg(o);
        size_t lim = stop == kNone ? n_ : (size_t)std::min<uint64_t>(n_, stop >> 3);
        while (true) {
            if (abort_ && abort_->load(std::memory_order_relaxed)) return FAIL;
            if (o.n >= max_out) {
                close_seg(o, false, 0, 0);
                return MORE;
            }
            // below the byte before `stop`, no block can start at or past it:
            // inflate without stopping at each block there
            bool near = stop != kNone && pos_ + 1 >= lim;
            size_t avail = std::min<size_t>(near || stop == kNone ? n_ - pos_ : lim - 1 - pos_, 1u << 30);
            size_t slice = std::min<size_t>(kSlice, max_out - o.n);
            if (!o.room(slice)) return FAIL;
            z_.next_in = (Bytef*)(in_ + pos_);
            z_.avail_in = (uInt)avail;
            z_.next_out = (Bytef*)(o.p + o.n);
            z_.avail_out = (uInt)slice;
            int ret = inflate(&z_, near ? Z_BLOCK : Z_NO_FLUSH);
            size_t made = slice - z_.avail_out, used = avail - z_.avail_in;
            int dt = z_.data_type;
            crc_ = crc32(crc_, (const Bytef*)o.p + o.n, (uInt)made);
            o.n += made;
            pos_ += used;
            if (ret == Z_STREAM_END) {
                uint32_t tcrc, tlen;
                size_t next;
                if (!member_end(in_, n_, pos_, &tcrc, &tlen, &next, &eof_)) return FAIL;
                close_seg(o, true, tcrc, tlen);
                if (eof_) {
                    bit_ = (uint64_t)n_ * 8;
                    return END;
                }
                inflateReset(&z_);
                pos_ = next;
                open_seg(o);
                if (stop != kNone && (uint64_t)pos_ * 8 >= stop) {
                    bit_ = (uint64_t)pos_ * 8;
                    close_seg(o, false, 0, 0);
                    return STOP;
                }
                continue;
            }
            if (ret != Z_OK && ret != Z_BUF_ERROR) return FAIL;
            if (near && (dt & 128)) {  // a block has ended (an end-of-block code may take no new byte)
                if (dt & 64) continue;  // the member's last: its trailer follows
                uint64_t b = (uint64_t)pos_ * 8 - (dt & 7);  // and another block starts
                if (b >= stop) {
                    bit_ = b;
                    close_seg(o, false, 0, 0);
                    return STOP;
                }
                continue;
            }
            if (made == 0 && used == 0 && (near || stop == kNone)) return FAIL;  // the file ends short
        }
    }

  private:
    static constexpr size_t kSlice = 256 << 10;

    void open_seg(const Out& o) {
        seg_open_ = true;
        seg_off_ = crc_from_ = o.n;
        crc_ = crc32(0, nullptr, 0);
    }
    void close_seg(Out& o, bool ends, uint32_t tcrc, uint32_t tlen) {
        o.segs.push_back({seg_off_, o.n - seg_off_, crc_from_, crc_, ends, tcrc, tlen});
        seg_open_ = false;
    }

    const uint8_t* in_;
    size_t n_;
    const std::atomic<bool>* abort_;
    z_stream z_;
    bool ok_ = true;
    size_t pos_ = 0;  // the stream's next input byte
    uint64_t bit_ = 0;
    bool eof_ = false, seg_open_ = false;
    size_t seg_off_ = 0, crc_from_ = 0;
    uint32_t crc_ = 0;
};

// A worker's chunk: where it started (kNone: no start found), whether it
// decoded cleanly from there to a block start at or past the next chunk
// (end) or to the file's end (eof), its output, and the guessed prefix of
// it (the first w.n bytes of out, filled in from w once the window before
// the chunk is known).
struct Chunk {
    uint64_t start = kNone, end = 0;
    bool usable = false, eof = false;
    Out out;
    Out16 w;
};

// The file's inflated bytes in pieces, made by threads of their own.
class Inflater {
  public:
    Inflater(const char* path, int threads, int64_t chunk) : path_(path ? path : "") {
        if (!path) return;
        if (chunk <= 0) chunk = kChunk;
        chunk_ = (uint64_t)std::min<int64_t>(chunk, (int64_t)1 << 30);
        int hw = (int)std::max(1u, std::thread::hardware_concurrency());
        int workers = std::min(threads, hw) - 1;
        if (workers >= 2 && map()) {
            n_chunks_ = (map_len_ + chunk_ - 1) / chunk_;
            if (n_chunks_ >= 2 && map_len_ >= 2 && map_[0] == 0x1f && map_[1] == 0x8b) {
                workers_ = (int)std::min<uint64_t>(workers, n_chunks_);
                ok_ = true;
                results_.resize(n_chunks_);
                seq_ = std::thread([this] { sequence(); });
                for (int w = 0; w < workers_; ++w) pool_.emplace_back([this] { work(); });
                return;
            }
            unmap();
        }
        gz_ = gzopen(path, "rb");
        if (!gz_) return;
        gzbuffer(gz_, kGzBuffer);
        ok_ = true;
        exact_ = true;
        seq_ = std::thread([this] { serial(gz_, 0); });
    }
    ~Inflater() {
        {
            std::lock_guard<std::mutex> g(m_);
            stop_ = wstop_ = true;
        }
        cv_.notify_all();
        if (seq_.joinable()) seq_.join();
        for (auto& t : pool_) t.join();
        if (gz_) gzclose(gz_);
        unmap();
    }
    bool ok() const { return ok_; }

    // workers of the parallel path (0 where the one-thread path reads),
    // chunks that started speculatively and were verified, chunks the real
    // decode went through itself, and whether gzread took over
    void counts(int64_t* out) {
        std::lock_guard<std::mutex> g(m_);
        out[0] = workers_;
        out[1] = spec_;
        out[2] = redo_;
        out[3] = fallback_;
    }

    // The next piece; false at the end of the file.  The piece handed out
    // before (b) goes back to the one-thread path to be filled again.
    bool next(Block& b) {
        std::shared_ptr<char> old = std::move(b.buf);  // freed after the lock is let go
        bool pooled = b.pooled;
        b = Block();
        std::unique_lock<std::mutex> g(m_);
        if (old && pooled) free_.push_back(std::move(old));
        cv_.notify_all();
        cv_.wait(g, [this] { return stop_ || can_take() || (done_ && ready_.empty()); });
        if (!can_take()) return false;
        Block& f = ready_.front();
        size_t take = std::min(f.n, kBlock);
        b.buf = f.buf;
        b.p = f.p;
        b.n = take;
        b.pooled = f.pooled;
        f.p += take;
        f.n -= take;
        if (f.n == 0) ready_.pop_front();
        delivered_ += take;
        return true;
    }

  private:
    bool can_take() const {
        return !ready_.empty() &&
               (exact_ || delivered_ + std::min(ready_.front().n, kBlock) + kHorizon <= validated_);
    }

    // the one-thread path: gzread in blocks of kBlock, the first `skip` bytes dropped
    void serial(gzFile f, uint64_t skip) {
        while (true) {
            std::shared_ptr<char> buf;
            {
                std::unique_lock<std::mutex> g(m_);
                cv_.wait(g, [this] { return !free_.empty() || made_ < kBlocks || stop_; });
                if (stop_) return;
                if (free_.empty()) {
                    buf.reset(new char[kBlock], std::default_delete<char[]>());
                    ++made_;
                } else {
                    buf = std::move(free_.back());
                    free_.pop_back();
                }
            }
            // a read error ends the stream as the end of the file does
            int n = gzread(f, buf.get(), (unsigned)kBlock);
            std::lock_guard<std::mutex> g(m_);
            if (n <= 0) {
                done_ = true;
                cv_.notify_all();
                return;
            }
            size_t off = (size_t)std::min<uint64_t>(skip, (uint64_t)n);
            skip -= off;
            if (off == (size_t)n) {
                free_.push_back(std::move(buf));
                continue;
            }
            ready_.push_back({buf, buf.get() + off, (size_t)n - off, true});
            cv_.notify_all();
        }
    }

    bool map() {
        int fd = open(path_.c_str(), O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode) || st.st_size < 2) {
            close(fd);
            return false;
        }
        void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
        close(fd);
        if (p == MAP_FAILED) return false;
        map_ = (const uint8_t*)p;
        map_len_ = (size_t)st.st_size;
        return true;
    }
    void unmap() {
        if (map_) munmap((void*)map_, map_len_);
        map_ = nullptr;
    }

    // ---- the parallel path ----

    void work() {
        Engine e(map_, map_len_, &wstop_);
        std::unique_ptr<Guess> g(new Guess(map_, map_len_));
        while (true) {
            uint64_t i;
            {
                std::unique_lock<std::mutex> lk(m_);
                // at most workers + 1 chunks taken ahead of the one the sequencer waits for
                cv_.wait(lk, [this] { return wstop_ || taken_ == n_chunks_ || taken_ <= seq_next_ + workers_; });
                if (wstop_ || taken_ == n_chunks_) return;
                i = taken_++;
            }
            std::unique_ptr<Chunk> c(new Chunk);
            if (e.ok()) decode(e, *g, i, *c);
            std::lock_guard<std::mutex> lk(m_);
            results_[i] = std::move(c);
            cv_.notify_all();
        }
    }

    // chunk i: from the gzip header (i = 0) or the first block start in the
    // chunk that decodes with the window unknown, to the first block start
    // at or past the next chunk
    void decode(Engine& e, Guess& g, uint64_t i, Chunk& c) {
        uint64_t first = i * chunk_ * 8, stop = i + 1 < n_chunks_ ? first + chunk_ * 8 : kNone;
        uint64_t last = stop == kNone ? (uint64_t)map_len_ * 8 : stop;
        size_t cap = std::max<size_t>(64 << 20, 16 * chunk_);
        Engine::Res r = Engine::FAIL;
        if (i == 0) {
            if (!c.out.room(std::min<size_t>(cap, 4 * chunk_ + (64 << 10))) || !e.at_header(0)) return;
            c.start = 0;
            r = e.run(c.out, stop, cap);
            c.end = e.bit();
        } else {
            // a start whose decode fails later was false too: the scan goes
            // on past it, a few times at most
            for (int tries = 0; tries < kTries && r == Engine::FAIL; ++tries) {
                bool final = false;
                uint64_t s = first;
                for (c.start = kNone; s < last && !wstop_.load(std::memory_order_relaxed); ++s) {
                    if (!g.header_at(s)) continue;
                    // the block decodes, and so does the next, unless the
                    // chunk ends between them
                    c.w.n = 0;
                    g.start(s);
                    bool ok = g.block(c.w, &final);
                    if (ok && !final && g.bit() < last) ok = g.block(c.w, &final);
                    if (!ok || (final && !spec_end(g.bit()))) continue;
                    c.start = s;
                    break;
                }
                if (c.start == kNone) return;
                c.out.n = 0;
                c.out.segs.clear();
                r = guess_on(e, g, c, stop, cap, final);
                first = s + 1;
            }
        }
        c.usable = r == Engine::STOP || r == Engine::END;
        c.eof = r == Engine::END;
    }

    // whether a speculative member's last block, ending at this bit, is
    // followed by a trailer and the file's end or a member header: bytes
    // that gzread would take for trailing garbage, the real decode judges
    bool spec_end(uint64_t bit) {
        uint32_t tcrc, tlen;
        size_t p = (size_t)((bit + 7) >> 3), next;
        bool eof;
        return member_end(map_, map_len_, p, &tcrc, &tlen, &next, &eof) && (!eof || p + 8 == map_len_);
    }

    // a chunk's decode with the window unknown, a block at a time, until a
    // block starts at or past `stop`; zlib goes on where the last 32 KiB
    // hold no window byte, or where the member ends
    Engine::Res guess_on(Engine& e, Guess& g, Chunk& c, uint64_t stop, size_t cap, bool final) {
        Out& o = c.out;
        Out16& w = c.w;
        while (!wstop_.load(std::memory_order_relaxed)) {
            // the guessed bytes close a segment of their own (filled in and
            // put in the member's CRC by the sequencer), where the chunk
            // ends, its member ends, or zlib goes on
            uint64_t b = g.bit();
            size_t lm = g.last_marker();
            bool handoff = w.n >= kWin && (lm == kNone || w.n - lm - 1 >= kWin);
            uint32_t tcrc = 0, tlen = 0;
            size_t p = (size_t)((b + 7) >> 3), next = 0;
            bool eof = false;
            if (final && (!spec_end(b) || !member_end(map_, map_len_, p, &tcrc, &tlen, &next, &eof)))
                return Engine::FAIL;
            if (final || (stop != kNone && b >= stop) || handoff) {
                if (!o.room(w.n + (64 << 10))) return Engine::FAIL;
                o.n = w.n;
                o.segs.push_back({0, w.n, w.n, 0, final, tcrc, tlen});
            }
            if (final) {  // zlib on the next member
                c.end = eof ? (uint64_t)map_len_ * 8 : (uint64_t)next * 8;
                if (eof) return Engine::END;
                if (stop != kNone && c.end >= stop) return Engine::STOP;
                if (!e.at_header(p + 8)) return Engine::FAIL;
            } else if (stop != kNone && b >= stop) {
                c.end = b;
                return Engine::STOP;
            } else if (handoff) {  // the last 32 KiB hold no window byte: they are the real window
                char win[kWin];
                for (size_t k = 0; k < kWin; ++k) win[k] = (char)w.p[w.n - kWin + k];
                e.at_block(b, win, kWin);
            } else {
                if (w.n >= cap) return Engine::MORE;
                if (!g.block(w, &final)) return Engine::FAIL;
                continue;
            }
            Engine::Res r = e.run(o, stop, cap);
            c.end = e.bit();
            return r;
        }
        return Engine::FAIL;
    }

    // The real decode, in file order: each chunk's speculative start is
    // taken where the real decode lands on it, else the chunk is decoded
    // here from where the real decode stands.
    void sequence() {
        Engine real(map_, map_len_, &stop_);
        bool ok = real.ok();
        for (uint64_t i = 0; ok && i < n_chunks_ && !eof_; ++i) {
            std::unique_ptr<Chunk> c;
            {
                std::unique_lock<std::mutex> g(m_);
                cv_.wait(g, [&] { return stop_ || results_[i]; });
                if (stop_) return;
                c = std::move(results_[i]);
                seq_next_ = i + 1;
            }
            cv_.notify_all();
            uint64_t next = i + 1 < n_chunks_ ? (i + 1) * chunk_ * 8 : kNone;
            bool spec = false;
            if (i == 0 ? c->usable : c->start != kNone && bit_ <= c->start) {
                if (bit_ < c->start) ok = decode_to(real, c->start);  // the previous decode runs on to it
                if (ok && !eof_ && bit_ == c->start && c->usable && resolve(*c)) {
                    ok = append(c->out) && wait_room();
                    bit_ = c->end;
                    eof_ = c->eof;
                    spec = true;
                }
            }
            if (ok && !spec && !eof_) ok = decode_to(real, next);
            if (i > 0) {
                std::lock_guard<std::mutex> g(m_);
                (spec ? spec_ : redo_)++;
            }
        }
        if (stop_) return;
        if (ok && eof_) {
            std::lock_guard<std::mutex> g(m_);
            exact_ = done_ = wstop_ = true;
            cv_.notify_all();
            return;
        }
        fall_back();
    }

    // the real decode from bit_ (the gzip header where nothing is decoded
    // yet) to the first block start at or past `stop` (kNone: the end)
    bool decode_to(Engine& e, uint64_t stop) {
        if (eof_ || (stop != kNone && bit_ >= stop)) return true;
        if (!started_) {
            if (!e.at_header(0)) return false;
            started_ = true;
        } else {
            e.at_block(bit_, win_.data(), win_.size());
        }
        while (true) {
            Out o;
            if (!o.room(kBlock)) return false;
            Engine::Res r = e.run(o, stop, kBlock);
            if (r == Engine::FAIL || !append(o) || !wait_room()) return false;
            if (r == Engine::STOP) {
                bit_ = e.bit();
                return true;
            }
            if (r == Engine::END) {
                eof_ = true;
                return true;
            }
        }
    }

    // a chunk's guessed prefix into bytes, its window bytes from the window
    // before it; false where one reaches past the start of its member (zlib
    // would fail there)
    bool resolve(Chunk& c) {
        size_t m = c.w.n, wn = win_.size();
        if (!m) return true;
        uint8_t* t = table_.get();  // t[v]: v's byte
        for (int v = 0; v < 256; ++v) t[v] = (uint8_t)v;
        memcpy(t + 256 + kWin - wn, win_.data(), wn);
        const uint16_t* w = c.w.p;
        if (wn < kWin) {
            for (size_t k = 0; k < m; ++k)
                if (w[k] >= 256 && w[k] < 256 + kWin - wn) return false;
        }
        uint8_t* o = (uint8_t*)c.out.p;
        for (size_t k = 0; k < m; ++k) o[k] = t[w[k]];
        return true;
    }

    // a decode's output after the stream so far: its members' CRCs and
    // lengths checked, its pieces ready for the caller
    bool append(Out& o) {
        std::shared_ptr<char> buf = o.release();
        std::vector<Segment> segs;
        segs.swap(o.segs);
        started_ = true;
        for (const Segment& s : segs) {
            const char* b = buf.get() + s.off;
            uint32_t c = s.crc;
            if (s.crc_from > s.off)
                c = crc32_combine(crc32(0, (const Bytef*)b, (uInt)(s.crc_from - s.off)), s.crc,
                                  (z_off_t)(s.off + s.len - s.crc_from));
            mcrc_ = crc32_combine(mcrc_, c, (z_off_t)s.len);
            mlen_ += s.len;
            if (s.len >= kWin) {
                win_.assign(b + s.len - kWin, kWin);
            } else {
                win_.append(b, s.len);
                if (win_.size() > kWin) win_.erase(0, win_.size() - kWin);
            }
            if (s.len) {
                std::lock_guard<std::mutex> g(m_);
                ready_.push_back({buf, b, s.len});
                validated_ += s.len;
                cv_.notify_all();
            }
            if (s.ends) {
                if (mcrc_ != s.tcrc || (uint32_t)mlen_ != s.tlen) return false;
                mcrc_ = 0;
                mlen_ = 0;
                win_.clear();
            }
        }
        return true;
    }

    // wait while the caller has more than enough checked bytes in hand
    bool wait_room() {
        std::unique_lock<std::mutex> g(m_);
        cv_.wait(g, [this] { return stop_ || validated_ - delivered_ <= kHorizon + 2 * kBlock; });
        return !stop_;
    }

    // gzread from the start of the file, the bytes handed out skipped
    void fall_back() {
        uint64_t skip;
        {
            std::lock_guard<std::mutex> g(m_);
            if (stop_) return;
            ready_.clear();
            exact_ = true;
            fallback_ = 1;
            skip = delivered_;
            wstop_ = true;
        }
        cv_.notify_all();
        gzFile f = gzopen(path_.c_str(), "rb");
        if (!f) {
            std::lock_guard<std::mutex> g(m_);
            done_ = true;
            cv_.notify_all();
            return;
        }
        gzbuffer(f, kGzBuffer);
        serial(f, skip);
        gzclose(f);
    }

    std::string path_;
    bool ok_ = false;
    gzFile gz_ = nullptr;
    const uint8_t* map_ = nullptr;
    size_t map_len_ = 0;
    uint64_t chunk_ = kChunk, n_chunks_ = 0;
    int workers_ = 0;
    std::thread seq_;  // the one-thread path, or the sequencer
    std::vector<std::thread> pool_;

    std::mutex m_;
    std::condition_variable cv_;
    std::atomic<bool> stop_{false};
    std::atomic<bool> wstop_{false};  // the workers end (the real decode is done, or gzread took over)
    // pieces for the caller
    std::deque<Block> ready_;
    std::vector<std::shared_ptr<char>> free_;
    int made_ = 0;
    bool exact_ = false, done_ = false;
    uint64_t validated_ = 0, delivered_ = 0;
    // the parallel path's chunks, and the real decode's place
    std::vector<std::unique_ptr<Chunk>> results_;
    uint64_t taken_ = 0, seq_next_ = 0;
    int64_t spec_ = 0, redo_ = 0, fallback_ = 0;
    uint64_t bit_ = 0;  // sequencer only: the block start the real decode stands at
    bool started_ = false, eof_ = false;
    std::string win_;     // the current member's last bytes, up to kWin
    std::unique_ptr<uint8_t[]> table_{new uint8_t[256 + kWin]};
    uint32_t mcrc_ = 0;   // its CRC-32 and length so far
    uint64_t mlen_ = 0;
};

// Lines of the inflated text, without their '\n' and one '\r' before it.
// A line is a view into the current piece, or into `carry_` where it runs
// across pieces; it stays valid until the next call.
class Lines {
  public:
    Lines(const char* path, int threads, int64_t chunk) : in_(path, threads, chunk) {}
    bool ok() const { return in_.ok(); }
    void counts(int64_t* out) { in_.counts(out); }
    bool next(const char*& p, size_t& n) {
        carry_.clear();
        while (true) {
            if (pos_ == block_.n) {
                if (done_ || !in_.next(block_)) {
                    done_ = true;
                    pos_ = block_.n = 0;
                    if (carry_.empty()) return false;
                    return view(carry_.data(), carry_.size(), p, n);  // last line, no '\n'
                }
                pos_ = 0;
            }
            const char* b = block_.p + pos_;
            const char* nl = (const char*)memchr(b, '\n', block_.n - pos_);
            if (nl == nullptr) {
                carry_.append(b, block_.n - pos_);
                pos_ = block_.n;
                continue;
            }
            size_t k = (size_t)(nl - b);
            pos_ += k + 1;
            if (carry_.empty()) return view(b, k, p, n);
            carry_.append(b, k);
            return view(carry_.data(), carry_.size(), p, n);
        }
    }

  private:
    static bool view(const char* b, size_t k, const char*& p, size_t& n) {
        if (k > 0 && b[k - 1] == '\r') --k;
        p = b;
        n = k;
        return true;
    }

    Inflater in_;
    Block block_;
    std::string carry_;
    size_t pos_ = 0;
    bool done_ = false;
};

void close_record(ParseState& st) {
    st.head_off.push_back((int64_t)st.headers.size());
    st.seq_off.push_back((int64_t)st.seqs.size());
    st.qual_off.push_back((int64_t)st.quals.size());
    st.n_records++;
}

// Incremental stream over one file: fastx_next() parses up to max_records
// at a time so ingestion can pipeline with downstream counting (the
// reference's 3-stage channel: parse thread -> batch -> consume,
// seq_parse.rs:87-122).
struct FastxStream {
    Lines lines;
    int mode = 0;  // 0 = empty file, 1 = FASTQ, 2 = FASTA
    std::string pending;  // FASTQ: next '@' line; FASTA: next '>' header
    bool pending_valid = false;
    bool done = false;
    FastxStream(const char* path, int threads, int64_t chunk) : lines(path, threads, chunk) {}
};

}  // namespace

extern "C" {

// Open a stream; nullptr on IO failure or unrecognized leading byte.
// threads: the caller's thread budget (a gzip file of two chunks or more is
// inflated by threads - 1 workers where that is 2 or more); chunk: the
// parallel path's compressed bytes a chunk (<= 0: 4 MiB).
void* fastx_open(const char* path, int threads, int64_t chunk) {
    auto* s = new FastxStream(path, threads, chunk);
    if (!s->lines.ok()) {
        delete s;
        return nullptr;
    }
    const char* p;
    size_t n;
    if (!s->lines.next(p, n)) {
        s->mode = 0;  // empty file: zero records, matches fastx_parse
        s->done = true;
        return s;
    }
    if (n > 0 && p[0] == '@') {
        s->mode = 1;
    } else if (n > 0 && p[0] == '>') {
        s->mode = 2;
    } else {
        delete s;
        return nullptr;
    }
    s->pending.assign(p, n);
    s->pending_valid = true;
    return s;
}

// Parse up to max_records more records; returns a ParseState chunk handle
// (fastx_seq_buf &co apply), possibly with 0 records at EOF.
void* fastx_next(void* sh, int64_t max_records) {
    auto* s = (FastxStream*)sh;
    auto* st = new ParseState();
    if (s->done) return st;
    const char* p;
    size_t n;
    if (s->mode == 1) {
        // FASTQ: pending holds the next record's '@' line; a record that
        // lacks its sequence, '+' or quality line is dropped
        while (st->n_records < max_records) {
            if (!s->pending_valid) {
                s->done = true;
                break;
            }
            s->pending_valid = false;
            size_t seq0 = st->seqs.size();
            if (!s->lines.next(p, n)) {
                s->done = true;
                break;
            }
            st->seqs.append(p, n);
            if (!s->lines.next(p, n) || !s->lines.next(p, n)) {
                st->seqs.resize(seq0);
                s->done = true;
                break;
            }
            st->quals.append(p, n);
            if (!s->pending.empty()) st->headers.append(s->pending, 1, std::string::npos);
            close_record(*st);
            if (s->lines.next(p, n)) {
                s->pending.assign(p, n);
                s->pending_valid = true;
            } else {
                s->done = true;
            }
        }
    } else if (s->mode == 2) {
        // FASTA: pending holds the next record's '>' header
        while (st->n_records < max_records && s->pending_valid) {
            st->headers.append(s->pending, 1, std::string::npos);
            s->pending_valid = false;
            while (s->lines.next(p, n)) {
                if (n > 0 && p[0] == '>') {
                    s->pending.assign(p, n);
                    s->pending_valid = true;
                    break;
                }
                st->seqs.append(p, n);
            }
            close_record(*st);
            if (!s->pending_valid) s->done = true;
        }
    }
    return st;
}

// The stream's inflate counts so far: workers of the parallel path (0 where
// it is not used), chunks started speculatively and verified, chunks the
// real decode went through itself, and 1 where gzread took over.
void fastx_inflate_counts(void* sh, int64_t* out) { ((FastxStream*)sh)->lines.counts(out); }

void fastx_close(void* sh) { delete (FastxStream*)sh; }

// Parse the whole file; returns an opaque handle (or nullptr).
// One-shot form of the stream above (identical record semantics), on the
// one-thread path.
void* fastx_parse(const char* path) {
    void* s = fastx_open(path, 1, 0);
    if (!s) return nullptr;
    void* chunk = fastx_next(s, INT64_MAX);
    fastx_close(s);
    return chunk;
}

int64_t fastx_n_records(void* h) { return ((ParseState*)h)->n_records; }
const char* fastx_seq_buf(void* h) { return ((ParseState*)h)->seqs.data(); }
const char* fastx_qual_buf(void* h) { return ((ParseState*)h)->quals.data(); }
const char* fastx_head_buf(void* h) { return ((ParseState*)h)->headers.data(); }
const int64_t* fastx_seq_off(void* h) { return ((ParseState*)h)->seq_off.data(); }
const int64_t* fastx_qual_off(void* h) { return ((ParseState*)h)->qual_off.data(); }
const int64_t* fastx_head_off(void* h) { return ((ParseState*)h)->head_off.data(); }
void fastx_free(void* h) { delete (ParseState*)h; }

}  // extern "C"
