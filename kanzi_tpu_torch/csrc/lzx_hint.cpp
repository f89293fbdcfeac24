// LZ/LZX forward parse that reads the LZ match pass's hints.
//
// The same parse as native/lzx.cpp's kz_lzx_forward (a copy of its
// recurrences: the repeat distances, the literal-run accelerator srcInc,
// the lookahead searches, the back extension, the anchor), with the same
// output bytes, fed by the match pass of kanzi_tpu_torch/ops/lz.py
// (kernel K on a card): for every position i, prev[i], the latest j < i
// whose window hashes to i's bucket (-1 for none), and lcp[i], the common
// prefix of the block at i and at prev[i], capped at CAP.
//
// The native parse keeps a hash table of the latest *inserted* position
// of each bucket; it reads it at each visited position (and at the one or
// two lookahead positions), and writes it at each visited and each
// match-covered position. Every position is inserted except those the
// accelerator jumps over (srcInc >> 6, "skipped") and not covered by a
// later match's back extension. The table is written in increasing order
// of position, so at every read it holds the largest inserted position
// of the bucket below the one read. Hence, in "dense mode":
//
// - where prev[x] is inserted, the table's candidate for x is prev[x], and
//   lcp[x] decides mem_eq4(x, prev[x]) and find_match(x, prev[x], ...)
//   without reading the block there (lcp < CAP is exact; the stride loop
//   rounds it down to a multiple of 8; at CAP the loop resumes from CAP);
// - the parse writes no table at a visit or a covered position: it
//   extends a range of positions inserted but not yet in the table
//   ("pending"), and marks the skipped positions in a bitmap;
// - where prev[x] is marked, the candidate is the latest inserted
//   position below it: the table's, where no pending position lies below
//   prev[x]; else the first inserted one down the bucket's chain (prev of
//   prev), at most MAX_WALK steps. Past that, or once the walks since the
//   last flush cost more than writing the pending range, the pending
//   range goes into the table (in increasing order, so each bucket ends
//   at its largest inserted position) and the parse enters table mode.
//
// In "table mode" the parse reads and writes the table as the native one
// does (in incompressible stretches prev mostly points at skipped
// positions, and the native cost is one table access a visit), and marks
// its skips only when a match may insert them again. It returns to dense
// mode after EXIT_RUN visits in a row whose prev is inserted.
//
// In a run of misses before any skip, one test a position decides that
// no candidate can match (the repeat distances' 4 bytes, lcp >= 4, prev
// not marked); the first position that may match takes the full visit.
//
// With check set, the native table runs beside the derived candidates
// and every read and every lcp decision is compared with the native
// parse's (stats[CHECKED..LCP_MISS]); the tests run every corpus so.
//
// Build: g++ -O3 -shared -fPIC lzx_hint.cpp -o liblzx_hint.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t HASH_SEED = 0x1E35A7BD;
constexpr int MAX_DISTANCE1 = (1 << 16) - 2;
constexpr int MAX_DISTANCE2 = (1 << 24) - 2;
constexpr int MIN_BLOCK_LENGTH = 24;
constexpr int64_t MAX_MATCH = 65535 + 254 + 4;
constexpr int MAX_WALK = 8;      // chain steps a candidate
constexpr int WALK_COST = 32;    // a chain step's cost in flushed positions
constexpr int EXIT_RUN = 16;     // table mode: visits to leave it
constexpr int CHUNK_LOG = 12;    // the bitmap's summary: 4 KiB chunks

// every lambda of the parse inlined, so that the state they capture by
// reference stays in registers (g++ keeps some out of line otherwise)
#define INLINE __attribute__((always_inline))

// stats[] slots (kanzi_tpu_torch/utils/native.py LZX_HINT_STATS)
enum {
    CHECKED,       // table reads compared with the native table (check)
    TABLE_MISS,    // ... that differed
    LCP_MISS,      // lcp decisions that differed from the byte compares
    DENSE_VISITS,  // visits whose candidate came from prev
    TABLE_VISITS,  // visits in table mode
    FLUSHES,       // pending ranges written into the table
    FLUSHED,       // positions written by them
    LCP_DECIDED,   // compares decided by lcp alone
    CAP_RESUMED,   // stride loops resumed from CAP
    UNMARKED,      // skipped positions inserted by a back extension
    REP_MATCHES,   // matches found at a repeat distance
    MARKED_PREV,   // dense-mode reads whose prev was not inserted
    WALKS,         // ... that walked down the bucket's chain
    RUN_VISITS,    // visits of a run of misses tested at once
    N_STATS
};

inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;  // little-endian hosts only (x86/arm64)
}

inline void emit_length(uint8_t*& p, int length) {
    if (length < 254) {
        *p++ = (uint8_t)length;
    } else if (length < 65536 + 254) {
        int l = length - 254;
        *p++ = 0xFE;
        *p++ = (uint8_t)(l >> 8);
        *p++ = (uint8_t)l;
    } else {
        int l = length - 255;
        *p++ = 0xFF;
        *p++ = (uint8_t)(l >> 16);
        *p++ = (uint8_t)(l >> 8);
        *p++ = (uint8_t)l;
    }
}

struct Scratch {
    std::vector<uint8_t> streams;   // tokens, match bytes, match lengths
    std::vector<int32_t> table;     // the hash table, written lazily
    std::vector<int32_t> native;    // the native table (check only)
    std::vector<uint64_t> marks;    // positions not inserted
    std::vector<uint8_t> chunks;    // 4 KiB chunks that hold a mark
    std::vector<int64_t> skipped;   // table mode: skips not yet marked
};

Scratch& scratch() {
    static thread_local Scratch s;
    return s;
}

template <bool CHECK>
int64_t forward_hinted(const uint8_t* src, int64_t count, int hash_log,
                       int min_match, const int32_t* prev,
                       const uint8_t* lcp,
                       int64_t cap, uint8_t* dst, int64_t dst_cap,
                       int64_t* stats) {
    if (count < MIN_BLOCK_LENGTH) return -1;
    int64_t st[N_STATS] = {};
    auto done = [&](int64_t r) INLINE {
        for (int i = 0; i < N_STATS; i++) stats[i] += st[i];
        return r;
    };
    const int hash_rshift = 64 - hash_log;
    const int64_t src_end = count - 16 - 2;
    const int max_dist =
        (src_end < 4 * MAX_DISTANCE1) ? MAX_DISTANCE1 : MAX_DISTANCE2;
    int flags = (max_dist == MAX_DISTANCE1) ? 0 : 1;
    flags |= ((min_match - 2) & 0x07) << 1;
    const int64_t max_match = MAX_MATCH;

    Scratch& s = scratch();
    if ((int64_t)s.streams.size() < 3 * count + 64)
        s.streams.resize(3 * count + 64);
    s.table.resize((size_t)1 << hash_log);
    s.marks.resize((size_t)(count >> 6) + 2);
    s.chunks.resize((size_t)(count >> CHUNK_LOG) + 2);
    if (CHECK) s.native.assign((size_t)1 << hash_log, 0);
    int32_t* table = s.table.data();
    uint64_t* marks = s.marks.data();
    uint8_t* chunks = s.chunks.data();
    std::vector<int64_t>& skipped = s.skipped;
    skipped.clear();
    int32_t* ntab = CHECK ? s.native.data() : nullptr;

    uint8_t* lit = dst + 13;
    uint8_t* tk0 = s.streams.data();
    uint8_t* mb0 = tk0 + count + 16;
    uint8_t* ml0 = tk0 + 2 * count + 32;
    uint8_t* lp = lit;
    uint8_t* tk = tk0;
    uint8_t* mb = mb0;
    uint8_t* ml = ml0;

    auto hash_at = [&](int64_t i) INLINE -> uint32_t {
        return (uint32_t)(((read64(src + i) << 24) * HASH_SEED)
                          >> hash_rshift);
    };
    auto find_match = [&](int64_t a, int64_t b, int64_t max_len,
                          int64_t n) INLINE -> int64_t {
        while (n + 8 <= max_len) {
            uint64_t d = read64(src + a + n) ^ read64(src + b + n);
            if (d) return n + (__builtin_ctzll(d) >> 3);
            n += 8;
        }
        return n;
    };
    auto mem_eq4 = [&](int64_t a, int64_t b) INLINE -> bool {
        uint32_t x, y;
        memcpy(&x, src + a, 4);
        memcpy(&y, src + b, 4);
        return x == y;
    };
    // find_match(a, prev[a], max_len) from lcp[a]
    auto hinted_match = [&](int64_t a, int64_t b, int64_t max_len) INLINE
            -> int64_t {
        int64_t l = lcp[a];
        int64_t fs = max_len & ~(int64_t)7;
        int64_t got;
        if (l < cap) {
            got = l < fs ? l : fs;
        } else if (fs <= cap) {
            got = fs;
        } else {
            st[CAP_RESUMED]++;
            got = find_match(a, b, max_len, cap);
        }
        if (CHECK && got != find_match(a, b, max_len, 0)) st[LCP_MISS]++;
        return got;
    };

    // the bitmap of positions that are not inserted, zeroed at first use,
    // and a byte a 4 KiB chunk that may hold one (a line of L1 for 128
    // KiB of the block), read first
    bool any_marks = false;
    auto marked = [&](int64_t p) INLINE -> bool {
        return chunks[p >> CHUNK_LOG]
               && ((marks[p >> 6] >> (p & 63)) & 1);
    };
    // the bits [lo, hi) of the bitmap, word by word: f(word, mask)
    auto each_word = [&](int64_t lo, int64_t hi, auto f) INLINE {
        while (lo < hi) {
            int64_t w = lo >> 6, end = (w + 1) << 6;
            if (end > hi) end = hi;
            uint64_t m = (end - lo == 64) ? ~(uint64_t)0
                         : (((uint64_t)1 << (end - lo)) - 1) << (lo & 63);
            f(marks[w], m);
            lo = end;
        }
    };
    auto set_marks = [&](int64_t lo, int64_t hi) INLINE {
        if (hi > src_end + 1) hi = src_end + 1;   // no later read below it
        if (lo >= hi) return;
        if (!any_marks) {
            memset(marks, 0, s.marks.size() * 8);
            memset(chunks, 0, s.chunks.size());
            any_marks = true;
        }
        int64_t w0 = lo >> 6, w1 = (hi - 1) >> 6;
        uint64_t m0 = ~(uint64_t)0 << (lo & 63);
        uint64_t m1 = ~(uint64_t)0 >> (63 - ((hi - 1) & 63));
        if (w0 == w1) {
            marks[w0] |= m0 & m1;
        } else {
            marks[w0] |= m0;
            for (int64_t w = w0 + 1; w < w1; w++) marks[w] = ~(uint64_t)0;
            marks[w1] |= m1;
        }
        for (int64_t c = lo >> CHUNK_LOG; c <= (hi - 1) >> CHUNK_LOG; c++)
            chunks[c] = 1;
    };
    // table mode reads no mark: its skips are marked when it ends or a
    // match may insert skipped positions again
    auto mark_skipped = [&]() INLINE {
        for (size_t i = 0; i < skipped.size(); i += 2)
            set_marks(skipped[i], skipped[i + 1]);
        skipped.clear();
    };
    auto clear_marks = [&](int64_t lo, int64_t hi) INLINE {
        mark_skipped();
        if (!any_marks) return;
        each_word(lo, hi, [&](uint64_t& w, uint64_t m) {
            st[UNMARKED] += __builtin_popcountll(w & m);
            w &= ~m;
        });
    };

    // inserted positions not yet written into the table lie in
    // [plo, pend), npend of them (the others there are marked)
    bool table_live = false, table_mode = false;
    int64_t plo = 0, pend = 0, npend = 0;
    int64_t walked = 0;   // chain steps since the last flush
    auto flush = [&]() INLINE {
        if (!table_live) {
            memset(table, 0, ((size_t)1 << hash_log) * 4);
            table_live = true;
        }
        walked = 0;
        if (plo >= pend) return;
        st[FLUSHES]++;
        if (!any_marks) {
            st[FLUSHED] += pend - plo;
            for (int64_t p = plo; p < pend; p++)
                table[hash_at(p)] = (int32_t)p;
        } else {
            each_word(plo, pend, [&](uint64_t& w, uint64_t m) {
                int64_t base = (int64_t)(&w - marks) << 6;
                st[FLUSHED] += __builtin_popcountll(m & ~w);
                for (uint64_t u = m & ~w; u; u &= u - 1) {
                    int64_t p = base + __builtin_ctzll(u);
                    table[hash_at(p)] = (int32_t)p;
                }
            });
        }
        plo = pend;
        npend = 0;
    };
    // positions [lo, hi) inserted, none of them in the table's pending
    // range yet but for the ones a back extension re-inserts
    auto insert_range = [&](int64_t lo, int64_t hi) INLINE {
        if (CHECK) {
            for (int64_t p = lo; p < hi; p++) ntab[hash_at(p)] = (int32_t)p;
        }
        if (table_mode) {
            for (int64_t p = lo; p < hi; p++) table[hash_at(p)] = (int32_t)p;
            return;
        }
        if (plo >= pend) {
            plo = lo;
            pend = hi;
        } else {
            if (lo < plo) plo = lo;
            if (hi > pend) pend = hi;
        }
        npend += hi - lo;
    };
    auto insert = [&](int64_t p) INLINE { insert_range(p, p + 1); };
    // the table's candidate for x before x is inserted; *hinted when it
    // is prev[x], whose lcp then decides the compares
    auto candidate = [&](int64_t x, bool* hinted) INLINE -> int64_t {
        int64_t ref;
        *hinted = false;
        if (table_mode) {
            ref = table[hash_at(x)];
        } else if ((ref = prev[x]) < 0) {
            ref = 0;                   // an empty bucket reads 0
        } else if (__builtin_expect(!any_marks || !marked(ref), 1)) {
            *hinted = true;
        } else if (ref < plo || plo >= pend) {
            // the latest inserted position below prev[x]: no pending
            // position lies below it, so the table holds it (no position
            // of the bucket lies between it and x)
            st[MARKED_PREV]++;
            if (!table_live) flush();
            ref = table[hash_at(x)];
        } else {
            // the same, with pending positions below prev[x]: down the
            // chain of the bucket's positions, at most MAX_WALK of them.
            // Past that, or once the steps walked since the last flush
            // cost more than writing the pending range would, the table,
            // exact once the pending range is in it
            st[MARKED_PREV]++;
            st[WALKS]++;
            int steps = 0;
            do {
                ref = prev[ref];
                ++steps;
            } while (ref >= 0 && marked(ref) && steps < MAX_WALK);
            walked += steps;
            if (ref >= 0 && marked(ref)) {
                flush();
                table_mode = true;
                ref = table[hash_at(x)];
            } else {
                if (ref < 0) ref = 0;
                if (walked * WALK_COST > npend) {
                    flush();
                    table_mode = true;
                }
            }
        }
        if (CHECK) {
            st[CHECKED]++;
            if (ref != ntab[hash_at(x)]) st[TABLE_MISS]++;
        }
        return ref;
    };
    // a lookahead candidate ref of a: its match length where the native
    // parse's offset compare passes, else -1 (it is then not taken)
    auto lookahead = [&](int64_t a, int64_t ref, bool hinted,
                         int64_t best_len, int64_t max_len) INLINE -> int64_t {
        int64_t got;
        if (hinted && lcp[a] < cap) {
            // the offset compare covers bytes best_len - 3 .. best_len;
            // where lcp is below best_len + 1 the match is shorter than
            // best_len whether the compare passes or not
            int64_t l = lcp[a];
            int64_t fs = max_len & ~(int64_t)7;
            got = l >= best_len + 1 ? (l < fs ? l : fs) : -1;
            st[LCP_DECIDED]++;
        } else if (hinted && best_len + 1 <= cap) {
            got = hinted_match(a, ref, max_len);
        } else if (mem_eq4(a + best_len - 3, ref + best_len - 3)) {
            got = hinted ? hinted_match(a, ref, max_len)
                         : find_match(a, ref, max_len, 0);
        } else {
            got = -1;
        }
        if (CHECK) {
            int64_t want = mem_eq4(a + best_len - 3, ref + best_len - 3)
                               ? find_match(a, ref, max_len, 0) : -1;
            if ((got >= best_len) != (want >= best_len)
                    || (got >= best_len && got != want))
                st[LCP_MISS]++;
        }
        return got;
    };

    // a repeat distance's candidate ref of a; lcp decides where it is
    // prev[a]
    auto rep_eq4 = [&](int64_t a, int64_t ref) INLINE -> bool {
        if (ref != prev[a]) return mem_eq4(a, ref);
        st[LCP_DECIDED]++;
        if (CHECK && (lcp[a] >= 4) != mem_eq4(a, ref)) st[LCP_MISS]++;
        return lcp[a] >= 4;
    };
    auto rep_match = [&](int64_t a, int64_t ref) INLINE -> int64_t {
        int64_t c = src_end - a;
        c = c < max_match ? c : max_match;
        return ref == prev[a] ? hinted_match(a, ref, c)
                              : find_match(a, ref, c, 0);
    };

    int64_t src_idx = 0, anchor = 0;
    int64_t repd[2] = {count, count};
    int rep_idx = 0;
    int64_t src_inc = 0;
    int clean = 0;        // table mode: visits in a row whose prev is inserted

    while (src_idx < src_end) {
        if (!table_mode && rep_idx == 0 && src_inc < 64) {
            // within a run of misses and before any skip: the visits that
            // no candidate can match (repeat distances, prev by lcp), one
            // test a position; the first that may match, or whose prev is
            // marked, takes the full visit below
            const int64_t first = src_idx;
            int64_t stop = first + 64 - src_inc;
            if (stop > src_end) stop = src_end;
            int64_t p = first;
            for (; p < stop; p++) {
                int64_t lo = p - max_dist;
                lo = lo < 0 ? 0 : lo;
                int64_t q = prev[p];
                int64_t a0 = p + 1 - repd[0], a1 = p + 1 - repd[1];
                uint32_t w, w0, w1;
                memcpy(&w, src + p + 1, 4);
                memcpy(&w0, src + (a0 > lo ? a0 : 0), 4);
                memcpy(&w1, src + (a1 > lo ? a1 : 0), 4);
                bool may = ((q > lo) & (lcp[p] >= 4)) | ((a0 > lo) & (w0 == w))
                           | ((a1 > lo) & (w1 == w));
                if (may || (any_marks && q >= 0 && marked(q))) break;
                if (CHECK) {
                    st[CHECKED]++;
                    if ((q < 0 ? 0 : q) != ntab[hash_at(p)]) st[TABLE_MISS]++;
                    ntab[hash_at(p)] = (int32_t)p;
                }
            }
            if (p > first) {
                st[DENSE_VISITS] += p - first;
                st[RUN_VISITS] += p - first;
                insert_range(first, p);
                src_inc += p - first;
                src_idx = p;
                if (src_idx >= src_end) break;
            }
        }
        const int64_t visit = src_idx;
        int64_t best_len = 0;
        int64_t src_idx1 = src_idx + 1;
        int64_t ref = src_idx1 - repd[rep_idx];
        int64_t min_ref = src_idx - max_dist;
        if (min_ref < 0) min_ref = 0;
        if (__builtin_expect(table_mode, 0) && src_inc < 64) {
            // back to the hints after a run of visits whose prev is
            // inserted (the table is exact, nothing pending)
            int64_t q = prev[src_idx];
            if (q >= 0 && marked(q)) {
                clean = 0;
            } else if (++clean >= EXIT_RUN) {
                mark_skipped();
                table_mode = false;
                clean = 0;
            }
        }
        st[table_mode ? TABLE_VISITS : DENSE_VISITS]++;

        if (ref > min_ref && rep_eq4(src_idx1, ref)) {
            best_len = rep_match(src_idx1, ref);
        } else {
            ref = src_idx1 - repd[rep_idx ^ 1];
            if (ref > min_ref && rep_eq4(src_idx1, ref))
                best_len = rep_match(src_idx1, ref);
        }

        if (best_len < min_match) {
            // the native parse reads the table at the visit, then
            // inserts it, before the repeat-distance compares above;
            // nothing reads the table between the two
            bool hinted;
            ref = candidate(src_idx, &hinted);
            insert(src_idx);
            if (ref > min_ref) {
                int64_t c = src_end - src_idx;
                c = c < max_match ? c : max_match;
                if (hinted) {
                    st[LCP_DECIDED]++;
                    if (CHECK && (lcp[src_idx] >= 4)
                            != mem_eq4(src_idx, ref))
                        st[LCP_MISS]++;
                    if (lcp[src_idx] >= 4)
                        best_len = hinted_match(src_idx, ref, c);
                } else if (mem_eq4(src_idx, ref)) {
                    best_len = find_match(src_idx, ref, c, 0);
                }
            }
            if (best_len < min_match) {
                int64_t skip = src_inc >> 6;
                if (skip && table_mode) {
                    skipped.push_back(src_idx1);
                    skipped.push_back(src_idx1 + skip);
                } else if (skip) {
                    set_marks(src_idx1, src_idx1 + skip);
                }
                src_idx = src_idx1 + skip;
                src_inc++;
                rep_idx = 0;
                continue;
            }
            if ((src_idx - ref != repd[0]) && (src_idx - ref != repd[1])) {
                bool h1;
                int64_t ref1 = candidate(src_idx1, &h1);
                insert(src_idx1);
                if (ref1 > min_ref + 1) {
                    int64_t c = src_end - src_idx1;
                    int64_t bl1 = lookahead(src_idx1, ref1, h1, best_len,
                                            c < max_match ? c : max_match);
                    if (bl1 >= best_len) {
                        ref = ref1;
                        best_len = bl1;
                        src_idx = src_idx1;
                    }
                }
                if (hash_log >= 19) {  // LZX extra search
                    int64_t src_idx2 = src_idx1 + 1;
                    bool h2;
                    int64_t ref2 = candidate(src_idx2, &h2);
                    insert(src_idx2);
                    if (ref2 > min_ref + 2) {
                        int64_t c = src_end - src_idx2;
                        int64_t bl2 = lookahead(
                            src_idx2, ref2, h2, best_len,
                            c < max_match ? c : max_match);
                        if (bl2 >= best_len) {
                            ref = ref2;
                            best_len = bl2;
                            src_idx = src_idx2;
                        }
                    }
                }
            }
            while (src_idx > anchor && ref > min_ref
                   && src[src_idx - 1] == src[ref - 1]) {
                best_len++;
                ref--;
                src_idx--;
            }
            // a match found at c is at most 65792 long (find_match's last
            // stride), so the clamp moves its start back-extended by k to
            // at most c - 1: onto a position the parse passed, inserted
            // or marked already
            if (best_len > max_match) {
                ref += best_len - max_match;
                src_idx += best_len - max_match;
                best_len = max_match;
            }
        } else {
            insert(src_idx);
            st[REP_MATCHES]++;
            if (best_len >= max_match || src[src_idx] != src[ref - 1]) {
                src_idx++;
                insert(src_idx);
            } else {
                best_len++;
                ref--;
            }
        }

        src_inc = 0;
        int64_t dist = src_idx - ref;
        int token, mlen_th;
        if (dist == repd[0]) {
            token = 0x00;
            mlen_th = 3;
        } else if (dist == repd[1]) {
            token = 0x04;
            mlen_th = 3;
        } else {
            if (dist >= 65536) *mb++ = (uint8_t)(dist >> 16);
            if (dist >= 256) *mb++ = (uint8_t)(dist >> 8);
            *mb++ = (uint8_t)dist;
            int inc = 1 + (dist >= 256 ? 1 : 0) + (dist >= 65536 ? 1 : 0);
            token = inc << 3;
            mlen_th = 7;
        }

        int64_t mlen = best_len - min_match;
        if (mlen >= mlen_th) {
            token += mlen_th;
            emit_length(ml, (int)(mlen - mlen_th));
        } else {
            token += (int)mlen;
        }
        repd[1] = repd[0];
        repd[0] = dist;
        rep_idx = 1;

        int64_t lit_len = src_idx - anchor;
        if (lit_len == 0) {
            *tk++ = (uint8_t)token;
        } else {
            if (lit_len >= 7) {
                if (lit_len >= (1 << 24)) return done(-1);
                *tk++ = (uint8_t)((7 << 5) | token);
                emit_length(lp, (int)(lit_len - 7));
            } else {
                *tk++ = (uint8_t)((lit_len << 5) | token);
            }
            // 16 bytes at a time, past the run where dst has room (the
            // next literals overwrite it; src has 16 bytes after src_end)
            if (lp + lit_len + 16 <= dst + dst_cap) {
                for (int64_t i = 0; i < lit_len; i += 16)
                    memcpy(lp + i, src + anchor + i, 16);
            } else {
                memcpy(lp, src + anchor, (size_t)lit_len);
            }
            lp += lit_len;
        }

        // the covered positions, inserted; those a back extension
        // reached below the visit may have been skipped
        anchor = src_idx + best_len;
        clear_marks(src_idx + 1, anchor < visit ? anchor : visit);
        insert_range(src_idx + 1, anchor);
        src_idx = anchor;
    }

    // last literals
    int64_t lit_len = count - anchor;
    int64_t dst_idx = 13 + (lp - lit);
    if (dst_idx + lit_len + (tk - tk0) + (mb - mb0) + (ml - ml0) >= count) {
        return done(-1);
    }
    if (lit_len >= 7) {
        *tk++ = (uint8_t)(7 << 5);
        emit_length(lp, (int)(lit_len - 7));
    } else {
        *tk++ = (uint8_t)(lit_len << 5);
    }
    memcpy(lp, src + anchor, (size_t)lit_len);
    lp += lit_len;

    int64_t lit_end = 13 + (lp - lit);
    int64_t tk_len = tk - tk0;
    int64_t mb_len = mb - mb0;
    int64_t ml_len = ml - ml0;
    uint32_t le = (uint32_t)lit_end, tl = (uint32_t)tk_len,
             mbl = (uint32_t)mb_len;
    memcpy(dst, &le, 4);
    memcpy(dst + 4, &tl, 4);
    memcpy(dst + 8, &mbl, 4);
    dst[12] = (uint8_t)flags;
    int64_t total = lit_end + tk_len + mb_len + ml_len;
    if (total > count - (count / 100) || total > dst_cap) return done(-1);
    memcpy(dst + lit_end, tk0, (size_t)tk_len);
    memcpy(dst + lit_end + tk_len, mb0, (size_t)mb_len);
    memcpy(dst + lit_end + tk_len + mb_len, ml0, (size_t)ml_len);
    return done(total);
}

}  // namespace

extern "C" {

// The LZ (hash_log 16) / LZX (19) forward transform of src[count], the
// same bytes as kz_lzx_forward: returns the output length, or -1 when
// the transform must be skipped. prev[count] and lcp[count] are the
// match pass's over this block at this hash_log (lcp capped at cap, a
// multiple of 8 below 256). dst capacity must be >=
// max_encoded_length(count). stats: N_STATS int64 counters, zeroed by the
// caller. check nonzero runs the native table beside the hints and
// counts every difference (stats[1], stats[2]); it is for the tests.
int64_t kz_lzx_forward_hinted(const uint8_t* src, int64_t count,
                              int hash_log, int min_match,
                              const int32_t* prev, const uint8_t* lcp,
                              int cap, uint8_t* dst, int64_t dst_cap,
                              int64_t* stats, int check) {
    if (hash_log < 1 || hash_log > 24 || cap < 8 || cap > 248 || (cap & 7))
        return -2;
    return check ? forward_hinted<true>(src, count, hash_log, min_match,
                                        prev, lcp, cap, dst, dst_cap, stats)
                 : forward_hinted<false>(src, count, hash_log, min_match,
                                         prev, lcp, cap, dst, dst_cap,
                                         stats);
}

int kz_lzx_hint_stats() { return N_STATS; }

}  // extern "C"
