// FASTQ/FASTA(.gz) parser (host IO native path, the reference's needletail
// role).  A thread of the stream's own inflates the file through zlib into
// large blocks while the caller's thread splits them into lines and records,
// so decompression overlaps with the parse and with whatever the caller does
// between chunks.  A chunk is returned as concatenated sequence / quality /
// header buffers with offsets; the Python wrapper slices them into records.
// Built by savont_tpu_torch/ops/native_build.py.
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
#include <zlib.h>

namespace {

struct ParseState {
    std::string seqs, quals, headers;
    std::vector<int64_t> seq_off{0}, qual_off{0}, head_off{0};
    int64_t n_records = 0;
};

constexpr size_t kBlock = 4 << 20;  // bytes a block of inflated text
constexpr int kBlocks = 4;          // blocks at most, in flight between the two threads

struct Block {
    std::unique_ptr<char[]> data;
    size_t n = 0;  // bytes of data that hold text
};

// The file's inflated bytes in blocks, made by a thread of their own
// (gzread: gzip members one after another, or a plain file as it is).
// Blocks are allocated as the thread first needs them and then reused.
class Inflater {
  public:
    explicit Inflater(const char* path) : f_(gzopen(path, "rb")) {
        if (!f_) return;
        gzbuffer(f_, 1 << 20);
        thread_ = std::thread([this] { run(); });
    }
    ~Inflater() {
        if (!f_) return;
        {
            std::lock_guard<std::mutex> g(m_);
            stop_ = true;
        }
        cv_.notify_all();
        thread_.join();
        gzclose(f_);
    }
    bool ok() const { return f_ != nullptr; }

    // The next block; false at the end of the file.  The block handed out
    // before (b, unless it holds none) goes back to the inflating thread.
    bool next(Block& b) {
        std::unique_lock<std::mutex> g(m_);
        if (b.data) free_.push_back(std::move(b));
        cv_.notify_all();
        cv_.wait(g, [this] { return !full_.empty() || eof_; });
        if (full_.empty()) return false;
        b = std::move(full_.front());
        full_.pop_front();
        return true;
    }

  private:
    void run() {
        while (true) {
            Block b;
            {
                std::unique_lock<std::mutex> g(m_);
                cv_.wait(g, [this] { return !free_.empty() || made_ < kBlocks || stop_; });
                if (stop_) return;
                if (free_.empty()) {
                    b.data.reset(new char[kBlock]);
                    ++made_;
                } else {
                    b = std::move(free_.back());
                    free_.pop_back();
                }
            }
            // a read error ends the stream as the end of the file does
            int n = gzread(f_, b.data.get(), (unsigned)kBlock);
            std::lock_guard<std::mutex> g(m_);
            if (n <= 0) {
                eof_ = true;
                cv_.notify_all();
                return;
            }
            b.n = (size_t)n;
            full_.push_back(std::move(b));
            cv_.notify_all();
        }
    }

    gzFile f_;
    std::thread thread_;
    std::mutex m_;
    std::condition_variable cv_;
    std::vector<Block> free_;
    std::deque<Block> full_;
    int made_ = 0;
    bool eof_ = false, stop_ = false;
};

// Lines of the inflated text, without their '\n' and one '\r' before it.
// A line is a view into the current block, or into `carry_` where it runs
// across blocks; it stays valid until the next call.
class Lines {
  public:
    explicit Lines(const char* path) : in_(path) {}
    bool ok() const { return in_.ok(); }
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
            const char* b = block_.data.get() + pos_;
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
    explicit FastxStream(const char* path) : lines(path) {}
};

}  // namespace

extern "C" {

// Open a stream; nullptr on IO failure or unrecognized leading byte.
void* fastx_open(const char* path) {
    auto* s = new FastxStream(path);
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

void fastx_close(void* sh) { delete (FastxStream*)sh; }

// Parse the whole file; returns an opaque handle (or nullptr).
// One-shot form of the stream above (identical record semantics).
void* fastx_parse(const char* path) {
    void* s = fastx_open(path);
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
