// Batched pileup accumulation: walk each read's packed CIGAR against its
// consensus and scatter base/del/insertion counts directly into the
// per-consensus count matrices (the sufficient statistics of
// savont_tpu_torch/pipeline/pileup.py; semantics of reference alignment.rs:520-564).
//
// The NumPy path expands every CIGAR into ~30M-element per-base streams
// (ops/tpos/qpos/levels...) and bincounts them — memory-bound at 20k+ reads.
// Here each job walks its runs serially in registers and increments the
// output counters in place; parallelism is over consensuses (each thread
// owns whole consensuses, so writes never race).
//
// Packed CIGAR: u32 = (length << 4) | op, op 0=M 1=I 2=D, coordinates on the
// ORIENTED query (caller pre-orients seq/qual/hp for strand -1).
#include <cstdint>
#include <omp.h>

static inline int qlevel(uint8_t q, int nq) {
    int v = ((int)q - 33) / 3;  // == numpy floor-div after the >=0 clamp
    if (v < 0) v = 0;
    if (v > nq - 1) v = nq - 1;
    return v;
}

// Quality-weighted consensus vote accumulation (stage4_consensus.py
// _vote_consensus): per template position, summed ASCII-quality weights for
// each base (A/C/G/T), for deletions, and total coverage.  Weights are
// integer ASCII values, so int64 accumulation equals the NumPy float64
// bincount exactly (all sums < 2^53).  Like the vote's NumPy path, CIGARs
// are trusted to stay in bounds (they come from alignments of these exact
// sequences); a defensive per-base guard keeps stray runs from corrupting
// memory (such runs would have crashed the NumPy bincount instead).
extern "C" void vote_accum_batch(
    const uint8_t* seq_cat, const int64_t* s_off,     // per job (n_jobs+1)
    const uint8_t* qual_cat,                          // same offsets as seq
    const uint32_t* cig_cat, const int64_t* cig_off,  // per job (n_jobs+1)
    const int64_t* t0, const int64_t* q0,             // per job
    const int64_t* job_off,                           // per cluster (n_cons+1)
    int64_t n_cons,
    const int64_t* tmpl_off,                          // per cluster (n_cons+1)
    const int8_t* code_tab,                           // 256: base byte -> 0..3 / -1
    int64_t* base_w,  // tmpl_off[n_cons] * 4
    int64_t* del_w,   // tmpl_off[n_cons]
    int64_t* cov_w,   // tmpl_off[n_cons]
    int32_t n_threads) {
    const int nt_ = (n_threads > 0) ? n_threads
                    : (n_cons > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel for schedule(dynamic) num_threads(nt_)
    for (int64_t c = 0; c < n_cons; c++) {
        const int64_t L = tmpl_off[c + 1] - tmpl_off[c];
        int64_t* bw = base_w + tmpl_off[c] * 4;
        int64_t* dw = del_w + tmpl_off[c];
        int64_t* cw = cov_w + tmpl_off[c];
        for (int64_t j = job_off[c]; j < job_off[c + 1]; j++) {
            const uint8_t* seq = seq_cat + s_off[j];
            const uint8_t* qual = qual_cat + s_off[j];
            const int64_t slen = s_off[j + 1] - s_off[j];
            int64_t tpos = t0[j], qpos = q0[j];
            for (int64_t r = cig_off[j]; r < cig_off[j + 1]; r++) {
                const uint32_t v = cig_cat[r];
                const int64_t len = (int64_t)(v >> 4);
                const uint32_t op = v & 0xF;
                if (op == 0) {  // M
                    for (int64_t i = 0; i < len; i++) {
                        const int64_t t = tpos + i, q = qpos + i;
                        if (t < 0 || t >= L || q < 0 || q >= slen) continue;
                        const int64_t w = (int64_t)qual[q];
                        const int cd = code_tab[seq[q]];
                        if (cd >= 0) bw[t * 4 + cd] += w;
                        cw[t] += w;
                    }
                    tpos += len;
                    qpos += len;
                } else if (op == 1) {  // I: no per-base weight (run handled in Python)
                    qpos += len;
                } else {  // D: every base weighted by the run-start quality
                    int64_t qd = qpos;
                    if (qd > slen - 1) qd = slen - 1;
                    const int64_t w = (qd >= 0) ? (int64_t)qual[qd] : 0;
                    for (int64_t i = 0; i < len; i++) {
                        const int64_t t = tpos + i;
                        if (t >= 0 && t < L) {
                            dw[t] += w;
                            cw[t] += w;
                        }
                    }
                    tpos += len;
                }
            }
        }
    }
}

extern "C" void pileup_accum_batch(
    const uint8_t* seq_cat, const int64_t* s_off,      // per job (n_jobs+1)
    const uint8_t* qual_cat,                           // same offsets as seq
    const uint8_t* hp_cat,                             // nullable, same offsets
    const uint32_t* cig_cat, const int64_t* cig_off,   // per job (n_jobs+1)
    const int64_t* t0, const int64_t* q0,              // per job
    const int64_t* job_off,                            // per consensus (n_cons+1)
    int64_t n_cons,
    const uint8_t* ref_cat, const int64_t* ref_off,    // per consensus (n_cons+1)
    int32_t nq,
    int64_t* bq,       // ref_off[n_cons] * nq * 2
    int64_t* dels,     // ref_off[n_cons]
    int64_t* ins_q,    // ref_off[n_cons] * nq
    int64_t* hp_hist,  // ref_off[n_cons] * 64, nullable
    int32_t n_threads) {
    const int nt_ = (n_threads > 0) ? n_threads
                    : (n_cons > 1 ? omp_get_max_threads() : 1);
#pragma omp parallel for schedule(dynamic) num_threads(nt_)
    for (int64_t c = 0; c < n_cons; c++) {
        const int64_t L = ref_off[c + 1] - ref_off[c];
        const uint8_t* ref = ref_cat + ref_off[c];
        int64_t* bqc = bq + ref_off[c] * nq * 2;
        int64_t* delc = dels + ref_off[c];
        int64_t* insc = ins_q + ref_off[c] * nq;
        int64_t* hpc = hp_hist ? hp_hist + ref_off[c] * 64 : nullptr;
        for (int64_t j = job_off[c]; j < job_off[c + 1]; j++) {
            const uint8_t* seq = seq_cat + s_off[j];
            const uint8_t* qual = qual_cat + s_off[j];
            const uint8_t* hp = hp_cat ? hp_cat + s_off[j] : nullptr;
            const int64_t slen = s_off[j + 1] - s_off[j];
            int64_t tpos = t0[j], qpos = q0[j];
            for (int64_t r = cig_off[j]; r < cig_off[j + 1]; r++) {
                const uint32_t v = cig_cat[r];
                const int64_t len = (int64_t)(v >> 4);
                const uint32_t op = v & 0xF;
                if (op == 0) {  // M: per-base, bounds-checked like the vector path
                    for (int64_t i = 0; i < len; i++) {
                        const int64_t t = tpos + i, q = qpos + i;
                        if (t < L && q < slen) {
                            const int lvl = qlevel(qual[q], nq);
                            const int isr = (seq[q] == ref[t]) ? 1 : 0;
                            bqc[(t * nq + lvl) * 2 + isr]++;
                            if (hpc) {
                                int hv = hp[q];
                                if (hv > 63) hv = 63;
                                hpc[t * 64 + hv]++;
                            }
                        }
                    }
                    tpos += len;
                    qpos += len;
                } else if (op == 1) {  // I: one event per run, first-base quality
                    if (tpos > 0 && tpos - 1 < L && qpos + len <= slen)
                        insc[(tpos - 1) * nq + qlevel(qual[qpos], nq)]++;
                    qpos += len;
                } else {  // D
                    for (int64_t i = 0; i < len; i++) {
                        const int64_t t = tpos + i;
                        if (t < L) delc[t]++;
                    }
                    tpos += len;
                }
            }
        }
    }
}

// ── Stage-5 adjusted-error counting (alignment.rs:101-188) ─────────────────
// Exact semantic twin of pipeline/stage5_merge.calculate_adjusted_errors:
// per job, walk the packed CIGAR once against the RAW ASCII sequences.
// Replaces the NumPy batch path's per-base M-run expansion (~1.5 GB of
// index streams at the 100k-read all-vs-all) and the per-indel-run Python
// loop.  Parity is test-pinned against the NumPy twin.

static inline bool hp_context(const uint8_t* s, int64_t n, int64_t pos) {
    // run of length > 2 within +-2 of pos (_has_homopolymer_context, w=2)
    if (n == 0) return false;
    int64_t start = pos - 2; if (start < 0) start = 0;
    int64_t end = pos + 3; if (end > n) end = n;
    if (end <= start + 2) return false;
    int64_t stop = end - 2; if (stop < start) stop = start;
    for (int64_t i = start; i < stop; i++) {
        if (i + 2 < n && s[i] == s[i + 1] && s[i] == s[i + 2]) return true;
    }
    return false;
}

extern "C" void adjusted_errors_batch(
    const uint32_t* cig_cat, const int64_t* cig_off,   // per job (n+1)
    const uint8_t* q_cat, const int64_t* q_off, const int64_t* q_len,
    const uint8_t* t_cat, const int64_t* t_off, const int64_t* t_len,
    const int64_t* q_start, const int64_t* t_start,
    int64_t n, int64_t buf, int64_t* errors, int threads)
{
    const int nt_ = (threads > 0) ? threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic, 16) num_threads(nt_)
    for (int64_t j = 0; j < n; j++) {
        const uint8_t* q = q_cat + q_off[j];
        const uint8_t* t = t_cat + t_off[j];
        const int64_t qlen = q_len[j], tlen = t_len[j];
        int64_t qp = q_start[j], tp = t_start[j];
        int64_t err = 0;
        for (int64_t r = cig_off[j]; r < cig_off[j + 1]; r++) {
            const int64_t len = (int64_t)(cig_cat[r] >> 4);
            const int op = (int)(cig_cat[r] & 0xF);
            if (op == 0) {  // M: mismatches outside the end buffer, no Ns
                for (int64_t i = 0; i < len; i++) {
                    const int64_t qi = qp + i, ti = tp + i;
                    if (qi < qlen && ti < tlen) {
                        const uint8_t qb = q[qi], tb = t[ti];
                        if (qb != tb && qb != 'N' && tb != 'N'
                            && qi > buf && qi + buf < qlen) err++;
                    }
                }
                qp += len; tp += len;
            } else if (op == 1) {  // I
                const bool in_hp = hp_context(q, qlen, qp) || hp_context(t, tlen, tp);
                if (!in_hp && qp > buf && qp + len + buf < qlen)
                    err += (len < 10) ? 1 : len;
                qp += len;
            } else {  // D (and, like the NumPy twin, any other non-M op)
                const bool in_hp = hp_context(q, qlen, qp) || hp_context(t, tlen, tp);
                if (!in_hp && tp > buf && tp + len + buf < tlen)
                    err += (len < 10) ? 1 : len;
                // NumPy twin: q advances for op != 2, t for op != 1
                if (op != 2) qp += len;
                tp += len;
            }
        }
        errors[j] = err;
    }
}
