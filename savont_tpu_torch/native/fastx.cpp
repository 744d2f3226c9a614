// FASTQ/FASTA(.gz) parser (host IO native path, the reference's needletail
// role).  Streams the file through zlib and returns concatenated
// sequence/quality/header buffers with offsets; the Python wrapper slices
// them into records.  Built by savont_tpu_torch/ops/native_build.py.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct ParseState {
    std::string seqs, quals, headers;
    std::vector<int64_t> seq_off{0}, qual_off{0}, head_off{0};
    int64_t n_records = 0;
};

// line-buffered gz reader
class GzLines {
  public:
    explicit GzLines(const char* path) : f_(gzopen(path, "rb")) {
        gzbuffer(f_, 1 << 20);
    }
    ~GzLines() {
        if (f_) gzclose(f_);
    }
    bool ok() const { return f_ != nullptr; }
    bool next(std::string& line) {
        line.clear();
        if (!f_) return false;
        char buf[1 << 16];
        while (true) {
            if (gzgets(f_, buf, sizeof(buf)) == nullptr) return !line.empty();
            line += buf;
            if (!line.empty() && line.back() == '\n') {
                line.pop_back();
                if (!line.empty() && line.back() == '\r') line.pop_back();
                return true;
            }
        }
    }

  private:
    gzFile f_;
};

void push(ParseState& st, const std::string& head, const std::string& seq, const std::string& qual) {
    st.headers += head;
    st.head_off.push_back((int64_t)st.headers.size());
    st.seqs += seq;
    st.seq_off.push_back((int64_t)st.seqs.size());
    st.quals += qual;
    st.qual_off.push_back((int64_t)st.quals.size());
    st.n_records++;
}

// Incremental stream over one file: fastx_next() parses up to max_records
// at a time so ingestion can pipeline with downstream counting (the
// reference's 3-stage channel: parse thread -> batch -> consume,
// seq_parse.rs:87-122).
struct FastxStream {
    GzLines gz;
    int mode = 0;  // 0 = empty file, 1 = FASTQ, 2 = FASTA
    std::string pending;  // FASTQ: next '@' line; FASTA: next '>' header
    bool pending_valid = false;
    bool done = false;
    explicit FastxStream(const char* path) : gz(path) {}
};

}  // namespace

extern "C" {

// Open a stream; nullptr on IO failure or unrecognized leading byte.
void* fastx_open(const char* path) {
    auto* s = new FastxStream(path);
    if (!s->gz.ok()) {
        delete s;
        return nullptr;
    }
    std::string line;
    if (!s->gz.next(line)) {
        s->mode = 0;  // empty file: zero records, matches fastx_parse
        s->done = true;
        return s;
    }
    if (!line.empty() && line[0] == '@') {
        s->mode = 1;
    } else if (!line.empty() && line[0] == '>') {
        s->mode = 2;
    } else {
        delete s;
        return nullptr;
    }
    s->pending = line;
    s->pending_valid = true;
    return s;
}

// Parse up to max_records more records; returns a ParseState chunk handle
// (fastx_seq_buf &co apply), possibly with 0 records at EOF.
void* fastx_next(void* sh, int64_t max_records) {
    auto* s = (FastxStream*)sh;
    auto* st = new ParseState();
    if (s->done) return st;
    std::string line;
    if (s->mode == 1) {
        // FASTQ: pending holds the next record's '@' line
        std::string seq, plus, qual;
        while (st->n_records < max_records) {
            if (!s->pending_valid) {
                s->done = true;
                break;
            }
            std::string head = s->pending.substr(1);
            s->pending_valid = false;
            if (!s->gz.next(seq) || !s->gz.next(plus) || !s->gz.next(qual)) {
                s->done = true;
                break;
            }
            push(*st, head, seq, qual);
            if (s->gz.next(line)) {
                s->pending = line;
                s->pending_valid = true;
            } else {
                s->done = true;
            }
        }
    } else if (s->mode == 2) {
        // FASTA: pending holds the next record's '>' header
        std::string seq;
        while (st->n_records < max_records && s->pending_valid) {
            std::string head = s->pending.substr(1);
            s->pending_valid = false;
            seq.clear();
            while (s->gz.next(line)) {
                if (!line.empty() && line[0] == '>') {
                    s->pending = line;
                    s->pending_valid = true;
                    break;
                }
                seq += line;
            }
            push(*st, head, seq, "");
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
