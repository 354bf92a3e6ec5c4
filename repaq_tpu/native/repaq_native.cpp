// Native host kernels for the sequential byte-stream codecs.
//
// These implement the exact .rfq token-stream semantics (same algorithms as
// the numpy formulations in repaq_tpu/codec/kernels_np.py; both are
// cross-checked against the scalar oracle). C++ is used for the scans that
// resist vectorization: greedy gap/run emission, varint-style token
// boundary detection, and the first-match PE overlap search.
//
// Exposed via ctypes (see repaq_tpu/codec/_native.py). Build: make.

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>

#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#include <immintrin.h>
#define REPAQ_AVX512_VBMI 1
#endif

extern "C" {

// Gap/run position stream for one symbol (reference rfqcodec.cpp:625-710).
// If mask != nullptr, marks matched positions (by-column quality escapes
// depend on it). Returns bytes written.
int64_t positions_encode(const uint8_t* data, int64_t n, uint8_t q,
                         uint8_t* out, uint8_t* mask) {
    int64_t buf_len = 0;
    int64_t last = -1;
    int64_t cur = 0;
    while (cur < n) {
        // SIMD skip to the next match: target symbols (N bases, sparse
        // quality bins) are typically <1% of the stream
        const uint8_t* hit =
            (const uint8_t*)memchr(data + cur, q, (size_t)(n - cur));
        if (!hit) return buf_len;
        cur = hit - data;
        if (mask) mask[cur] = 1;
        if (cur - last == 1 && cur > 1) {
            int64_t run = 1;
            while (cur + run != n && run < 32 && data[cur + run] == q) run++;
            if (mask) memset(mask + cur, 1, (size_t)run);
            out[buf_len++] = (uint8_t)((run - 1) | 0xC0);
            cur += run;
            last = cur - 1;
            continue;
        }
        int64_t d = cur - last;
        if (d <= 128) {
            out[buf_len++] = (uint8_t)(d - 1);
        } else if (d <= (1 << 14)) {
            int64_t v = d - 1;
            out[buf_len++] = (uint8_t)((v >> 8) | 0x80);
            out[buf_len++] = (uint8_t)(v & 0xFF);
        } else {
            int64_t v = d - 1;
            out[buf_len++] = (uint8_t)((v >> 24) | 0xE0);
            out[buf_len++] = (uint8_t)((v >> 16) & 0xFF);
            out[buf_len++] = (uint8_t)((v >> 8) & 0xFF);
            out[buf_len++] = (uint8_t)(v & 0xFF);
        }
        last = cur;
        cur++;
    }
    return buf_len;
}

// Positions of symbol q decoded from a gap/run stream; returns count.
int64_t positions_decode(const uint8_t* buf, int64_t buf_len, int64_t* out) {
    int64_t consumed = 0, last = -1, cnt = 0;
    while (consumed < buf_len) {
        uint8_t b0 = buf[consumed];
        if ((b0 & 0x80) == 0) {
            last += b0 + 1;
            out[cnt++] = last;
            consumed += 1;
        } else if ((b0 & 0x40) == 0) {
            last += (((int64_t)(b0 & 0x3F) << 8) | buf[consumed + 1]) + 1;
            out[cnt++] = last;
            consumed += 2;
        } else if ((b0 & 0x20) == 0) {
            int64_t run = (b0 & 0x1F) + 1;
            for (int64_t i = 0; i < run; i++) out[cnt++] = ++last;
            consumed += 1;
        } else {
            int64_t d = ((int64_t)(b0 & 0x1F) << 24) |
                        ((int64_t)buf[consumed + 1] << 16) |
                        ((int64_t)buf[consumed + 2] << 8) | buf[consumed + 3];
            last += d + 1;
            out[cnt++] = last;
            consumed += 4;
        }
    }
    return cnt;
}

// Scatter-decode one bin's stream directly into the target array
// (bounds-unchecked like the reference; valid streams stay in range).
void positions_scatter(const uint8_t* buf, int64_t buf_len, uint8_t q,
                       uint8_t* target) {
    int64_t consumed = 0, last = -1;
    while (consumed < buf_len) {
        uint8_t b0 = buf[consumed];
        if ((b0 & 0x80) == 0) {
            last += b0 + 1;
            target[last] = q;
            consumed += 1;
        } else if ((b0 & 0x40) == 0) {
            last += (((int64_t)(b0 & 0x3F) << 8) | buf[consumed + 1]) + 1;
            target[last] = q;
            consumed += 2;
        } else if ((b0 & 0x20) == 0) {
            int64_t run = (b0 & 0x1F) + 1;
            for (int64_t i = 0; i < run; i++) target[++last] = q;
            consumed += 1;
        } else {
            int64_t d = ((int64_t)(b0 & 0x1F) << 24) |
                        ((int64_t)buf[consumed + 1] << 16) |
                        ((int64_t)buf[consumed + 2] << 8) | buf[consumed + 3];
            last += d + 1;
            target[last] = q;
            consumed += 4;
        }
    }
}

// Full by-column quality encode: u32le per-bin lengths, per-bin streams,
// escape records (reference rfqcodec.cpp:712-765). Returns bytes written.
// scratch must hold n bytes (mask).
int64_t qualcol_encode(const uint8_t* qual, int64_t n, const uint8_t* bins,
                       int32_t nbins, uint8_t major, uint8_t* out,
                       uint8_t* scratch) {
    memset(scratch, 0, (size_t)n);
    int64_t pos = 4LL * nbins;
    for (int32_t b = 0; b < nbins; b++) {
        int64_t len = positions_encode(qual, n, bins[b], out + pos, scratch);
        out[4 * b + 0] = (uint8_t)(len & 0xFF);
        out[4 * b + 1] = (uint8_t)((len >> 8) & 0xFF);
        out[4 * b + 2] = (uint8_t)((len >> 16) & 0xFF);
        out[4 * b + 3] = (uint8_t)((len >> 24) & 0xFF);
        pos += len;
    }
    for (int64_t i = 0; i < n; i++) {
        if (!scratch[i] && qual[i] != major) {
            out[pos++] = qual[i];
            uint32_t p = (uint32_t)i;
            out[pos++] = (uint8_t)(p & 0xFF);
            out[pos++] = (uint8_t)((p >> 8) & 0xFF);
            out[pos++] = (uint8_t)((p >> 16) & 0xFF);
            out[pos++] = (uint8_t)((p >> 24) & 0xFF);
        }
    }
    return pos;
}

// Single-pass by-column quality encode. Equivalent byte-for-byte to the
// per-bin scans (each bin's stream depends only on its own match
// positions) but touches the chunk once: per-bin (last, pending-run) state
// machines emit into pre-sized segments, then segments are compacted into
// the wire layout. bin_of: 256-entry LUT mapping qual byte -> bin index,
// 0xFE for the major qual, 0xFF for out-of-table (escape record).
// Returns total bytes written.
int64_t qualcol_encode_sp(const uint8_t* qual, int64_t n, const uint8_t* bins,
                          int32_t nbins, const uint8_t* bin_of, uint8_t* out,
                          uint8_t* scratch) {
    // the major-run fast path is valid only when the major char maps to
    // 0xFE (it can instead be a real bin when it doubles as the N-base
    // qual, reference rfqheader.cpp:308-320)
    int major_char = -1;
    for (int c = 0; c < 256; c++) {
        if (bin_of[c] == 0xFE) {
            major_char = c;
            break;
        }
    }
    // pass 1: match counts per bin -> segment capacities (<=4 bytes/match),
    // plus a BRANCHLESS compaction of the non-major positions (chunk
    // positions fit u32 — the wire escape records already assume it).
    // Real quality data interleaves major runs with scattered non-major
    // bytes; a per-byte major/non-major branch mispredicts on every
    // transition, so pass 1 has no branches at all (4-way counters break
    // store-to-load forwarding on constant runs) and pass 2 only ever
    // touches the ~10-40% non-major positions.
    int64_t counts4[4][256];
    memset(counts4, 0, sizeof(counts4));
    int32_t* posbuf = (int32_t*)scratch;
    int64_t nm = 0;  // non-major count (== posbuf length)
    if (major_char >= 0) {
        uint8_t mc = (uint8_t)major_char;
        // the per-byte LUT + counter increment on major bytes is most of
        // pass 1 when the major dominates; when it doesn't, the fused
        // single pass wins. Pick by a strided sample of the major
        // fraction (break-even ~0.57 major).
        int64_t step = n > 65536 ? n >> 16 : 1;
        int64_t smaj = 0, scnt = 0;
        for (int64_t i = 0; i < n; i += step, scnt++)
            smaj += (qual[i] == mc);
        if (smaj * 7 >= scnt * 4) {
            // compact first, then histogram only the compacted
            // non-major positions
            int64_t i = 0;
#ifdef REPAQ_AVX512_VBMI
            // 16 positions per vpcompressd step
            const __m128i mcv = _mm_set1_epi8((char)mc);
            const __m512i lane = _mm512_set_epi32(
                15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
            for (; i + 16 <= n; i += 16) {
                __m128i b = _mm_loadu_si128((const __m128i*)(qual + i));
                __mmask16 m = _mm_cmpneq_epi8_mask(b, mcv);
                __m512i idx =
                    _mm512_add_epi32(lane, _mm512_set1_epi32((int)i));
                _mm512_mask_compressstoreu_epi32(posbuf + nm, m, idx);
                nm += __builtin_popcount((unsigned)m);
            }
#endif
            for (; i < n; i++) {
                posbuf[nm] = (int32_t)i;
                nm += (qual[i] != mc);
            }
            for (int64_t j = 0; j < nm; j++)
                counts4[j & 3][bin_of[qual[posbuf[j]]]]++;
        } else {
            for (int64_t i = 0; i < n; i++) {
                uint8_t q = qual[i];
                posbuf[nm] = (int32_t)i;
                nm += (q != mc);
                counts4[i & 3][bin_of[q]]++;
            }
        }
    } else {
        for (int64_t i = 0; i < n; i++) {
            posbuf[nm++] = (int32_t)i;
            counts4[i & 3][bin_of[qual[i]]]++;
        }
    }
    int64_t counts[256];
    for (int v = 0; v < 256; v++)
        counts[v] = counts4[0][v] + counts4[1][v] + counts4[2][v]
                    + counts4[3][v];
    int64_t seg_off[129];
    int64_t off = 4 * n;  // segment area sits after posbuf
    for (int32_t b = 0; b < nbins; b++) {
        seg_off[b] = off;
        off += 4 * counts[b] + 8;
    }
    seg_off[nbins] = off;  // escape segment
    uint8_t* esc = scratch + off;

    int64_t last[128];
    int32_t pending[128];
    int64_t pos[128];
    for (int32_t b = 0; b < nbins; b++) {
        last[b] = -1;
        pending[b] = 0;
        pos[b] = seg_off[b];
    }
    int64_t esc_len = 0;

    // pass 2: token emission over the compacted non-major positions
    // only. Quality dips run down COLUMNS, so ~90% of real-data tokens
    // extend a run in the SAME bin as the previous token — keeping the
    // active bin's (last, pending, pos) in registers turns the per-token
    // read-modify-write of last[b]/pending[b] (a ~5-cycle
    // store-forwarding chain between consecutive same-bin tokens) into
    // single-cycle register ops; bin switches spill/reload.
    int32_t cur_b = -1;
    int64_t cur_last = 0, cur_pos = 0;
    int32_t cur_pending = 0;
    for (int64_t j = 0; j < nm; j++) {
        int64_t i = posbuf[j];
        uint8_t b = bin_of[qual[i]];
        if (b == 0xFF) {          // escape record
            esc[esc_len++] = qual[i];
            uint32_t p = (uint32_t)i;
            esc[esc_len++] = (uint8_t)(p & 0xFF);
            esc[esc_len++] = (uint8_t)((p >> 8) & 0xFF);
            esc[esc_len++] = (uint8_t)((p >> 16) & 0xFF);
            esc[esc_len++] = (uint8_t)((p >> 24) & 0xFF);
            continue;
        }
        if ((int32_t)b != cur_b) {
            if (cur_b >= 0) {
                last[cur_b] = cur_last;
                pending[cur_b] = cur_pending;
                pos[cur_b] = cur_pos;
            }
            cur_b = b;
            cur_last = last[b];
            cur_pending = pending[b];
            cur_pos = pos[b];
        }
        int64_t d = i - cur_last;
        if (d == 1 && i > 1) {
            if (++cur_pending == 32) {
                scratch[cur_pos++] = (uint8_t)0xDF;  // 0xC0 | 31
                cur_pending = 0;
            }
        } else {
            if (cur_pending) {
                scratch[cur_pos++] = (uint8_t)((cur_pending - 1) | 0xC0);
                cur_pending = 0;
            }
            int64_t v = d - 1;
            if (d <= 128) {
                scratch[cur_pos++] = (uint8_t)v;
            } else if (d <= (1 << 14)) {
                scratch[cur_pos++] = (uint8_t)((v >> 8) | 0x80);
                scratch[cur_pos++] = (uint8_t)(v & 0xFF);
            } else {
                scratch[cur_pos++] = (uint8_t)((v >> 24) | 0xE0);
                scratch[cur_pos++] = (uint8_t)((v >> 16) & 0xFF);
                scratch[cur_pos++] = (uint8_t)((v >> 8) & 0xFF);
                scratch[cur_pos++] = (uint8_t)(v & 0xFF);
            }
        }
        cur_last = i;
    }
    if (cur_b >= 0) {
        last[cur_b] = cur_last;
        pending[cur_b] = cur_pending;
        pos[cur_b] = cur_pos;
    }
    for (int32_t b = 0; b < nbins; b++) {
        if (pending[b]) scratch[pos[b]++] = (uint8_t)((pending[b] - 1) | 0xC0);
    }

    // compact: u32le length table, streams, escapes
    int64_t w = 4LL * nbins;
    for (int32_t b = 0; b < nbins; b++) {
        int64_t len = pos[b] - seg_off[b];
        out[4 * b + 0] = (uint8_t)(len & 0xFF);
        out[4 * b + 1] = (uint8_t)((len >> 8) & 0xFF);
        out[4 * b + 2] = (uint8_t)((len >> 16) & 0xFF);
        out[4 * b + 3] = (uint8_t)((len >> 24) & 0xFF);
        memcpy(out + w, scratch + seg_off[b], (size_t)len);
        w += len;
    }
    memcpy(out + w, esc, (size_t)esc_len);
    return w + esc_len;
}

// Full by-column quality decode incl. escapes into a major-prefilled array.
void qualcol_decode(const uint8_t* buf, int64_t buf_len, const uint8_t* bins,
                    int32_t nbins, uint8_t* qual, int64_t n) {
    int64_t consumed = 4LL * nbins;
    for (int32_t b = 0; b < nbins; b++) {
        uint32_t len = (uint32_t)buf[4 * b] | ((uint32_t)buf[4 * b + 1] << 8) |
                       ((uint32_t)buf[4 * b + 2] << 16) |
                       ((uint32_t)buf[4 * b + 3] << 24);
        positions_scatter(buf + consumed, len, bins[b], qual);
        consumed += len;
    }
    while (consumed + 4 < buf_len) {
        uint8_t q = buf[consumed++];
        uint32_t p = (uint32_t)buf[consumed] | ((uint32_t)buf[consumed + 1] << 8) |
                     ((uint32_t)buf[consumed + 2] << 16) |
                     ((uint32_t)buf[consumed + 3] << 24);
        consumed += 4;
        if (p < (uint64_t)n) qual[p] = q;
    }
}

// Coordinate coder (reference rfqcodec.cpp:1262-1389).
// Returns bytes written, or -1 if a value exceeds 2^21-1.
int64_t coords_encode(const int64_t* vals, int64_t n, uint8_t* out) {
    int64_t last = 1000, buf_len = 0;
    int32_t repeat = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t v = vals[i];
        if (repeat > 0 && (v != last || repeat == 32)) {
            out[buf_len++] = (uint8_t)((repeat - 1) | 0xC0);
            repeat = 0;
        }
        if (v == last) {
            repeat++;
            continue;
        }
        int64_t diff = v - last;
        last = v;
        if (diff > 0 && diff <= 64) {
            out[buf_len++] = (uint8_t)((diff - 1) | 0x80);
            continue;
        }
        if (v <= 32767) {
            out[buf_len++] = (uint8_t)(v >> 8);
            out[buf_len++] = (uint8_t)(v & 0xFF);
        } else if (v < (1 << 21)) {
            out[buf_len++] = (uint8_t)((v >> 16) | 0xE0);
            out[buf_len++] = (uint8_t)((v >> 8) & 0xFF);
            out[buf_len++] = (uint8_t)(v & 0xFF);
        } else {
            return -1;
        }
    }
    if (repeat > 0) out[buf_len++] = (uint8_t)((repeat - 1) | 0xC0);
    return buf_len;
}

int64_t coords_decode(const uint8_t* buf, int64_t buf_len, int64_t* out,
                      int64_t num) {
    int64_t last = 1000, consumed = 0, decoded = 0;
    while (consumed < buf_len && decoded < num) {
        uint8_t b0 = buf[consumed++];
        if ((b0 & 0x80) == 0) {
            last = ((int64_t)b0 << 8) | buf[consumed++];
            out[decoded++] = last;
        } else if ((b0 & 0x40) == 0) {
            last += (b0 & 0x3F) + 1;
            out[decoded++] = last;
        } else if ((b0 & 0x20) == 0) {
            int32_t rep = (b0 & 0x1F) + 1;
            for (int32_t i = 0; i < rep && decoded < num; i++) out[decoded++] = last;
        } else {
            last = ((int64_t)(b0 & 0x1F) << 16) | ((int64_t)buf[consumed] << 8) |
                   buf[consumed + 1];
            consumed += 2;
            out[decoded++] = last;
        }
    }
    return decoded;
}

// Token boundary walk: out gets indices where tokens start, given per-byte
// token length (valid only at start bytes). Returns token count.
int64_t token_starts(const int64_t* lens, int64_t n, int64_t* out) {
    int64_t i = 0, cnt = 0;
    while (i < n) {
        out[cnt++] = i;
        i += lens[i];
    }
    return cnt;
}

// First-match PE overlap (reference rfqcodec.cpp:1391-1438): r1/r2 are
// (pairs, L1)/(pairs, L2) row-major; out gets +o forward / -o backward / 0.
#ifdef REPAQ_AVX512_VBMI
// First match of `needle`'s prefix against `hay`'s suffixes, smallest
// overlap o in [12, minlen] first (identical order to the scalar scan):
// masked vpcmpeqb tests needle[0..2] at 64 candidate addresses,
// candidates are visited high-address-first (= ascending o), then the
// scalar 8-byte word + memcmp confirm.
static inline int64_t overlap_scan_avx(const uint8_t* hay, int64_t hl,
                                       const uint8_t* needle,
                                       int64_t minlen) {
    int64_t lo = hl - minlen, hi = hl - 12;
    int64_t span = hi - lo + 1;
    if (span <= 0) return 0;
    uint64_t n8;
    memcpy(&n8, needle, 8);
    // 3-byte prefilter: a candidate must match needle[0..2], not just
    // needle[0] — on 4-letter base data a 1-byte filter passes ~1/4 of
    // the ~139 offsets to the scalar confirm loop (~35 bit-extract +
    // 8-byte-compare iterations per direction); three bytes cut that to
    // ~2 for two extra shifted loads per block. All loads are masked to
    // the live candidate lanes (masked-off lanes never fault), so every
    // touched byte is base+j+2 <= hi+2 = hl-10 for an active lane j —
    // in-row even for minlen < 64, where the old unmasked 64-byte load
    // could read past the last row of the matrix. needle[0..2] is
    // in-bounds: minlen >= 12.
    const __m512i fb0 = _mm512_set1_epi8((char)needle[0]);
    const __m512i fb1 = _mm512_set1_epi8((char)needle[1]);
    const __m512i fb2 = _mm512_set1_epi8((char)needle[2]);
    int64_t done = 0;
    while (done < span) {
        int64_t cnt = span - done < 64 ? span - done : 64;
        int64_t base = hi - done - cnt + 1;
        __mmask64 valid =
            cnt == 64 ? ~0ULL : ((1ULL << cnt) - 1);
        // three INDEPENDENT load+compare chains (ANDed at the end):
        // gating load j+1 on mask j serialized ~15-cycle k-register
        // round trips per stage and tripled the scan latency
        __mmask64 m0 = _mm512_mask_cmpeq_epi8_mask(
            valid, _mm512_maskz_loadu_epi8(valid, hay + base), fb0);
        __mmask64 m1 = _mm512_mask_cmpeq_epi8_mask(
            valid, _mm512_maskz_loadu_epi8(valid, hay + base + 1), fb1);
        __mmask64 m2 = _mm512_mask_cmpeq_epi8_mask(
            valid, _mm512_maskz_loadu_epi8(valid, hay + base + 2), fb2);
        __mmask64 m = m0 & m1 & m2;
        while (m) {
            int i = 63 - __builtin_clzll((unsigned long long)m);
            uint64_t w;
            memcpy(&w, hay + base + i, 8);
            int64_t o = hl - (base + i);
            if (w == n8 &&
                memcmp(hay + base + i, needle, (size_t)o) == 0)
                return o;
            m &= ~(1ULL << i);
        }
        done += cnt;
    }
    return 0;
}
#endif

// Strided variant: rows live inside larger buffers (a at a_base + p *
// a_stride, b at b_base + p * b_stride) so callers can scan the reader's
// interleaved seq layout and a packed revcomp buffer directly — no
// (pairs, L) gather matrices. Same first-match semantics as
// overlap_pairs.
void overlap_pairs2(const uint8_t* a_flat, int64_t a_base, int64_t a_stride,
                    const uint8_t* b_flat, int64_t b_base, int64_t b_stride,
                    int64_t pairs, int64_t l1, int64_t l2, int64_t* out) {
    int64_t minlen = l1 < l2 ? l1 : l2;
    for (int64_t p = 0; p < pairs; p++) {
        const uint8_t* a = a_flat + a_base + p * a_stride;
        const uint8_t* b = b_flat + b_base + p * b_stride;
        int64_t found = 0;
#ifdef REPAQ_AVX512_VBMI
        found = overlap_scan_avx(a, l1, b, minlen);
        if (!found) found = -overlap_scan_avx(b, l2, a, minlen);
#else
        if (minlen < 12) {
            out[p] = 0;
            continue;
        }
        uint64_t b8, a8;
        memcpy(&b8, b, 8);
        for (int64_t o = 12; o <= minlen; o++) {
            uint64_t w;
            memcpy(&w, a + l1 - o, 8);
            if (w != b8) continue;
            if (memcmp(a + l1 - o, b, (size_t)o) == 0) {
                found = o;
                break;
            }
        }
        if (!found) {
            memcpy(&a8, a, 8);
            for (int64_t o = 12; o <= minlen; o++) {
                uint64_t w;
                memcpy(&w, b + l2 - o, 8);
                if (w != a8) continue;
                if (memcmp(b + l2 - o, a, (size_t)o) == 0) {
                    found = -o;
                    break;
                }
            }
        }
#endif
        out[p] = found;
    }
}

void overlap_pairs(const uint8_t* r1, const uint8_t* r2, int64_t pairs,
                   int64_t l1, int64_t l2, int64_t* out) {
    overlap_pairs2(r1, 0, l1, r2, 0, l2, pairs, l1, l2, out);
}

// Per-row-starts variant: row p of side a begins at a_flat + a_starts[p]
// (rows embedded at arbitrary offsets — e.g. seq lines inside the mapped
// FASTQ input, where name lengths make the spacing non-uniform).
void overlap_pairsx(const uint8_t* a_flat, const int64_t* a_starts,
                    const uint8_t* b_flat, const int64_t* b_starts,
                    int64_t pairs, int64_t l1, int64_t l2, int64_t* out) {
    int64_t minlen = l1 < l2 ? l1 : l2;
    for (int64_t p = 0; p < pairs; p++) {
        const uint8_t* a = a_flat + a_starts[p];
        const uint8_t* b = b_flat + b_starts[p];
        int64_t found = 0;
#ifdef REPAQ_AVX512_VBMI
        found = overlap_scan_avx(a, l1, b, minlen);
        if (!found) found = -overlap_scan_avx(b, l2, a, minlen);
#else
        if (minlen < 12) {
            out[p] = 0;
            continue;
        }
        uint64_t b8, a8;
        memcpy(&b8, b, 8);
        for (int64_t o = 12; o <= minlen; o++) {
            uint64_t w;
            memcpy(&w, a + l1 - o, 8);
            if (w != b8) continue;
            if (memcmp(a + l1 - o, b, (size_t)o) == 0) {
                found = o;
                break;
            }
        }
        if (!found) {
            memcpy(&a8, a, 8);
            for (int64_t o = 12; o <= minlen; o++) {
                uint64_t w;
                memcpy(&w, b + l2 - o, 8);
                if (w != a8) continue;
                if (memcmp(b + l2 - o, a, (size_t)o) == 0) {
                    found = -o;
                    break;
                }
            }
        }
#endif
        out[p] = found;
    }
}

// Short-slice copy: the gather/assembly passes move tens of millions of
// 1-200 byte fields per file, where glibc memcpy's dispatch overhead is
// comparable to the copy itself. Full 64-byte vectors plus one masked
// load/store tail (masked lanes never fault) — exact, no overrun.
static inline void copy_small(uint8_t* d, const uint8_t* s, int64_t l) {
#ifdef REPAQ_AVX512_VBMI
    while (l >= 64) {
        _mm512_storeu_si512(d, _mm512_loadu_si512(s));
        d += 64;
        s += 64;
        l -= 64;
    }
    if (l) {
        __mmask64 m = (((__mmask64)1) << l) - 1;
        _mm512_mask_storeu_epi8(d, m, _mm512_maskz_loadu_epi8(m, s));
    }
#else
    memcpy(d, s, (size_t)l);
#endif
}

// Batched slice copy: dst[dst_starts[i] : +lens[i]] = src[src_starts[i] : +lens[i]].
// Backs both ragged gathers (dst offsets = prefix sums) and scatters.
void copy_slices(const uint8_t* src, const int64_t* src_starts, uint8_t* dst,
                 const int64_t* dst_starts, const int64_t* lens, int64_t n) {
    for (int64_t i = 0; i < n; i++)
        copy_small(dst + dst_starts[i], src + src_starts[i], lens[i]);
}

// Fused PE interleave (io/fastq.py _consume_pairs): scatter all four
// fields of both mates record-by-record, so each source buffer is read
// ONCE sequentially — the per-field copy_slices formulation swept the
// same source cache lines four times (record fields share lines at
// typical 60-150 byte field sizes). ls/le are the 4-lines-per-record
// line tables (index 4p+j); dj holds the interleaved field-j output
// offsets (dj[2p] mate 1, dj[2p+1] mate 2, i.e. the prefix-sum array).
// Two-field variant (line indices ja/jb of the 4-line record): used when
// the seq/qual fields stay as lazy spans into the mapped input and only
// names + strands materialize.
void pe_interleave2(const uint8_t* f1, const int64_t* ls1, const int64_t* le1,
                    const uint8_t* f2, const int64_t* ls2, const int64_t* le2,
                    int64_t k, int64_t ja, uint8_t* outa, const int64_t* da,
                    int64_t jb, uint8_t* outb, const int64_t* db) {
    for (int64_t p = 0; p < k; p++) {
        int64_t b = 4 * p;
        copy_small(outa + da[2 * p], f1 + ls1[b + ja],
                   le1[b + ja] - ls1[b + ja]);
        copy_small(outb + db[2 * p], f1 + ls1[b + jb],
                   le1[b + jb] - ls1[b + jb]);
        copy_small(outa + da[2 * p + 1], f2 + ls2[b + ja],
                   le2[b + ja] - ls2[b + ja]);
        copy_small(outb + db[2 * p + 1], f2 + ls2[b + jb],
                   le2[b + jb] - ls2[b + jb]);
    }
}

void pe_interleave(const uint8_t* f1, const int64_t* ls1, const int64_t* le1,
                   const uint8_t* f2, const int64_t* ls2, const int64_t* le2,
                   int64_t k, uint8_t* out0, const int64_t* d0, uint8_t* out1,
                   const int64_t* d1, uint8_t* out2, const int64_t* d2,
                   uint8_t* out3, const int64_t* d3) {
    uint8_t* outs[4] = {out0, out1, out2, out3};
    const int64_t* ds[4] = {d0, d1, d2, d3};
    for (int64_t p = 0; p < k; p++) {
        int64_t b = 4 * p;
        for (int j = 0; j < 4; j++)
            copy_small(outs[j] + ds[j][2 * p], f1 + ls1[b + j],
                       le1[b + j] - ls1[b + j]);
        for (int j = 0; j < 4; j++)
            copy_small(outs[j] + ds[j][2 * p + 1], f2 + ls2[b + j],
                       le2[b + j] - ls2[b + j]);
    }
}

// Compact rANS frequency-table parse (codec/rans_np.py parse_table —
// byte-identical semantics incl. the error taxonomy). Returns the new
// offset, or -1 truncated, -2 symbol list not ascending, -3 bitmap
// count mismatch, -4 frequency sum corrupt.
int64_t rans_parse_table(const uint8_t* buf, int64_t len, int64_t off,
                         int64_t scale, int64_t* freqs) {
    memset(freqs, 0, 256 * sizeof(int64_t));
    if (len - off < 1) return -1;
    int npresent = buf[off] + 1;
    off++;
    uint8_t syms[256];
    int ns = 0;
    if (npresent == 256) {
        for (int i = 0; i < 256; i++) syms[i] = (uint8_t)i;
        ns = 256;
    } else if (npresent <= 32) {
        if (len - off < npresent) return -1;
        for (int i = 0; i < npresent; i++) syms[i] = buf[off + i];
        off += npresent;
        ns = npresent;
        for (int i = 1; i < ns; i++)
            if (syms[i] <= syms[i - 1]) return -2;
    } else {
        if (len - off < 32) return -1;
        for (int b = 0; b < 32; b++) {
            unsigned m = buf[off + b];
            while (m) {
                int bit = __builtin_ctz(m);
                syms[ns++] = (uint8_t)(8 * b + bit);
                m &= m - 1;
            }
        }
        off += 32;
        if (ns != npresent) return -3;
    }
    int64_t total = 0;
    for (int i = 0; i < ns - 1; i++) {
        if (len - off < 1) return -1;
        int64_t v = buf[off++];
        if (v & 0x80) {
            if (len - off < 1) return -1;
            v = (v & 0x7F) | ((int64_t)buf[off++] << 7);
        }
        freqs[syms[i]] = v + 1;
        total += v + 1;
    }
    if (ns == 0 || total >= scale) return -4;
    freqs[syms[ns - 1]] = scale - total;
    return off;
}

// Name2 chunk predicates (codec/vectorized.py
// _compute_name2_same_and_interleave, reference rfqcodec.cpp:233-270)
// without gather matrices: eq_first[i] = name2_i == name2_0 (length +
// bytes); pair_ok[p] = name2_{2p} with byte diff_pos substituted by
// diff_char (when diff_char != 0 and diff_pos < len) equals
// name2_{2p+1}. Caller applies the reference's sequential degradation
// logic on top.
void name2_predicates(const uint8_t* flat, const int64_t* starts,
                      const int64_t* lens, int64_t n, int64_t diff_pos,
                      int diff_char, uint8_t* eq_first, uint8_t* pair_ok) {
    const uint8_t* first = flat + starts[0];
    int64_t len0 = lens[0];
    for (int64_t i = 0; i < n; i++) {
        eq_first[i] =
            lens[i] == len0 &&
            (len0 == 0 || !memcmp(flat + starts[i], first, (size_t)len0));
    }
    for (int64_t p = 0; p < n / 2; p++) {
        int64_t la = lens[2 * p], lb = lens[2 * p + 1];
        if (la != lb) {
            pair_ok[p] = 0;
            continue;
        }
        const uint8_t* a = flat + starts[2 * p];
        const uint8_t* b = flat + starts[2 * p + 1];
        if (diff_char != 0 && diff_pos < la) {
            pair_ok[p] =
                (diff_pos == 0 || !memcmp(a, b, (size_t)diff_pos)) &&
                b[diff_pos] == (uint8_t)diff_char &&
                !memcmp(a + diff_pos + 1, b + diff_pos + 1,
                        (size_t)(la - diff_pos - 1));
        } else {
            pair_ok[p] = !memcmp(a, b, (size_t)la);
        }
    }
}

// All-slices-identical predicate (codec/vectorized.py _all_same_content,
// the "same name / same strand" chunk flags, rfqcodec.cpp:171-287): each
// slice memcmp'd against slice 0 with early exit — no (n, L) gather
// matrix materialized.
int64_t all_same_slices(const uint8_t* flat, const int64_t* starts,
                        int64_t n, int64_t L) {
    const uint8_t* first = flat + starts[0];
    for (int64_t i = 1; i < n; i++)
        if (memcmp(flat + starts[i], first, (size_t)L)) return 0;
    return 1;
}

// Newline scan for the fast FASTQ reader (io/fastq.py _scan_new): one
// memchr-driven pass replaces a bytearray slice copy plus three whole-
// buffer probes ('\r' search, '\n\n' search, flatnonzero). Scans
// [probe_start, end) for danger bytes (any '\r', or two adjacent '\n' —
// the quirk inputs that force the exact scalar reader), records the
// positions of newlines at offsets >= start into out (absolute buffer
// offsets), and returns the count, or -1 if a danger byte was seen.
// probe_start <= start includes at most the one byte before start so a
// "\n\n" straddling the previous scan seam is still caught (mirrors the
// numpy path's probe window).
int64_t scan_newlines(const uint8_t* buf, int64_t probe_start, int64_t start,
                      int64_t end, int64_t* out) {
    if (end <= probe_start) return 0;
#ifdef REPAQ_AVX512_VBMI
    // One fused pass: each 64-byte block answers the '\r' probe, the
    // adjacent-'\n' probe (bit j & bit j-1, with a carry bit joining
    // blocks), and yields the newline positions from the compare mask —
    // memchr per ~90-byte FASTQ line paid its dispatch cost once per
    // line, plus a second whole-window memchr for '\r'.
    int64_t prev = -2;
    for (int64_t i = probe_start; i < start; i++) {
        uint8_t c = buf[i];
        if (c == '\r') return -1;
        if (c == '\n') {
            if (i == prev + 1) return -1;
            prev = i;
        }
    }
    const __m512i nl = _mm512_set1_epi8('\n');
    const __m512i cr = _mm512_set1_epi8('\r');
    uint64_t carry = (prev == start - 1) ? 1ULL : 0ULL;
    int64_t count = 0;
    int64_t i = start;
    // 4 blocks per iteration: the '\r' probe and the adjacent-'\n' probe
    // each collapse to one test per 256 bytes, and the four position
    // masks extract with independent loop bodies (at FASTQ line lengths
    // most blocks carry 0-2 newlines, so the k-register round trips per
    // block dominated the 1-block loop)
    for (; i + 256 <= end; i += 256) {
        __m512i v0 = _mm512_loadu_si512(buf + i);
        __m512i v1 = _mm512_loadu_si512(buf + i + 64);
        __m512i v2 = _mm512_loadu_si512(buf + i + 128);
        __m512i v3 = _mm512_loadu_si512(buf + i + 192);
        __mmask64 c0 = _mm512_cmpeq_epi8_mask(v0, cr);
        __mmask64 c1 = _mm512_cmpeq_epi8_mask(v1, cr);
        __mmask64 c2 = _mm512_cmpeq_epi8_mask(v2, cr);
        __mmask64 c3 = _mm512_cmpeq_epi8_mask(v3, cr);
        if ((c0 | c1) | (c2 | c3)) return -1;
        uint64_t m0 = _mm512_cmpeq_epi8_mask(v0, nl);
        uint64_t m1 = _mm512_cmpeq_epi8_mask(v1, nl);
        uint64_t m2 = _mm512_cmpeq_epi8_mask(v2, nl);
        uint64_t m3 = _mm512_cmpeq_epi8_mask(v3, nl);
        uint64_t adj = (m0 & ((m0 << 1) | carry)) |
                       (m1 & ((m1 << 1) | (m0 >> 63))) |
                       (m2 & ((m2 << 1) | (m1 >> 63))) |
                       (m3 & ((m3 << 1) | (m2 >> 63)));
        if (adj) return -1;
        carry = m3 >> 63;
        while (m0) {
            out[count++] = i + __builtin_ctzll(m0);
            m0 &= m0 - 1;
        }
        while (m1) {
            out[count++] = i + 64 + __builtin_ctzll(m1);
            m1 &= m1 - 1;
        }
        while (m2) {
            out[count++] = i + 128 + __builtin_ctzll(m2);
            m2 &= m2 - 1;
        }
        while (m3) {
            out[count++] = i + 192 + __builtin_ctzll(m3);
            m3 &= m3 - 1;
        }
    }
    for (; i + 64 <= end; i += 64) {
        __m512i v = _mm512_loadu_si512(buf + i);
        if (_mm512_cmpeq_epi8_mask(v, cr)) return -1;
        uint64_t m = _mm512_cmpeq_epi8_mask(v, nl);
        if (m & ((m << 1) | carry)) return -1;
        carry = m >> 63;
        while (m) {
            int b = __builtin_ctzll(m);
            out[count++] = i + b;
            m &= m - 1;
        }
    }
    if (i < end) {
        __mmask64 valid = (1ULL << (end - i)) - 1;
        __m512i v = _mm512_maskz_loadu_epi8(valid, buf + i);
        if (_mm512_mask_cmpeq_epi8_mask(valid, v, cr)) return -1;
        uint64_t m = _mm512_mask_cmpeq_epi8_mask(valid, v, nl);
        if (m & ((m << 1) | carry)) return -1;
        while (m) {
            int b = __builtin_ctzll(m);
            out[count++] = i + b;
            m &= m - 1;
        }
    }
    return count;
#else
    if (memchr(buf + probe_start, '\r', (size_t)(end - probe_start)))
        return -1;
    int64_t prev = -2;
    for (int64_t i = probe_start; i < start; i++)
        if (buf[i] == '\n') prev = i;
    int64_t count = 0;
    const uint8_t* p = buf + start;
    const uint8_t* e = buf + end;
    while (p < e) {
        const uint8_t* q =
            (const uint8_t*)memchr(p, '\n', (size_t)(e - p));
        if (!q) break;
        int64_t pos = q - buf;
        if (pos == prev + 1) return -1;
        prev = pos;
        out[count++] = pos;
        p = q + 1;
    }
    return count;
#endif
}

// Reverse-copy each slice (dst slice i = reversed src slice i), optionally
// mapping bytes through a 256-entry table (revcomp); table==nullptr copies.
// On AVX-512 VBMI hosts the 64-byte body of each slice runs as one vpermb
// reverse plus a 4x vpermb / 2-blend 256-entry lookup (the revcomp path is
// hot in BOTH directions: odd-mate revcomp on encode, un-revcomp on
// decode); sub-64-byte tails stay scalar.
void reverse_slices(const uint8_t* src, const int64_t* src_starts, uint8_t* dst,
                    const int64_t* dst_starts, const int64_t* lens, int64_t n,
                    const uint8_t* table) {
#ifdef REPAQ_AVX512_VBMI
    const __m512i rev_idx = _mm512_set_epi8(
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
        19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
        36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
        53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63);
    __m512i t0{}, t1{}, t2{}, t3{};
    const __m512i b6 = _mm512_set1_epi8(0x40);
    const __m512i b7 = _mm512_set1_epi8((char)0x80);
    if (table) {
        t0 = _mm512_loadu_si512(table);
        t1 = _mm512_loadu_si512(table + 64);
        t2 = _mm512_loadu_si512(table + 128);
        t3 = _mm512_loadu_si512(table + 192);
    }
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* s = src + src_starts[i];
        uint8_t* d = dst + dst_starts[i];
        int64_t L = lens[i];
        int64_t j = 0;
        for (; j + 64 <= L; j += 64) {
            __m512i v = _mm512_loadu_si512(s + L - j - 64);
            v = _mm512_permutexvar_epi8(rev_idx, v);
            if (table) {
                // vpermb indexes by the low 6 bits; bits 6/7 select the
                // table quarter
                __m512i r0 = _mm512_permutexvar_epi8(v, t0);
                __m512i r1 = _mm512_permutexvar_epi8(v, t1);
                __m512i r2 = _mm512_permutexvar_epi8(v, t2);
                __m512i r3 = _mm512_permutexvar_epi8(v, t3);
                __mmask64 m6 = _mm512_test_epi8_mask(v, b6);
                __mmask64 m7 = _mm512_test_epi8_mask(v, b7);
                v = _mm512_mask_blend_epi8(
                    m7, _mm512_mask_blend_epi8(m6, r0, r1),
                    _mm512_mask_blend_epi8(m6, r2, r3));
            }
            _mm512_storeu_si512(d + j, v);
        }
        if (table) {
            for (; j < L; j++) d[j] = table[s[L - 1 - j]];
        } else {
            for (; j < L; j++) d[j] = s[L - 1 - j];
        }
    }
#else
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* s = src + src_starts[i];
        uint8_t* d = dst + dst_starts[i];
        int64_t L = lens[i];
        if (table) {
            for (int64_t j = 0; j < L; j++) d[j] = table[s[L - 1 - j]];
        } else {
            for (int64_t j = 0; j < L; j++) d[j] = s[L - 1 - j];
        }
    }
#endif
}

// Fused PE decode restore (codec/vectorized.py decode_chunk): row r of
// dst is the concatenation of its 3 pieces (overlap expansion: R1-tail /
// stored span / R1-head) for even rows, and the reverse-complement of
// that concatenation for odd rows — emitted as rc(p3)+rc(p2)+rc(p1), so
// the gather-expand pass and the copy-then-reverse un-revcomp pass
// collapse into ONE write of the chunk.
void scatter_pieces_rc(const uint8_t* src, const int64_t* p_starts,
                       const int64_t* p_lens, int64_t n_rows, uint8_t* dst,
                       const int64_t* dst_off, const uint8_t* table) {
#ifdef REPAQ_AVX512_VBMI
    const __m512i rev_idx = _mm512_set_epi8(
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
        19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
        36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
        53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63);
    const __m512i b6 = _mm512_set1_epi8(0x40);
    const __m512i b7 = _mm512_set1_epi8((char)0x80);
    const __m512i t0 = _mm512_loadu_si512(table);
    const __m512i t1 = _mm512_loadu_si512(table + 64);
    const __m512i t2 = _mm512_loadu_si512(table + 128);
    const __m512i t3 = _mm512_loadu_si512(table + 192);
    for (int64_t r = 0; r < n_rows; r++) {
        uint8_t* d = dst + dst_off[r];
        if ((r & 1) == 0) {
            for (int j = 0; j < 3; j++) {
                int64_t p = 3 * r + j;
                copy_small(d, src + p_starts[p], p_lens[p]);
                d += p_lens[p];
            }
        } else {
            for (int j = 2; j >= 0; j--) {
                int64_t p = 3 * r + j;
                const uint8_t* s = src + p_starts[p];
                int64_t L = p_lens[p];
                int64_t k = 0;
                for (; k + 64 <= L; k += 64) {
                    __m512i v = _mm512_loadu_si512(s + L - k - 64);
                    v = _mm512_permutexvar_epi8(rev_idx, v);
                    __m512i r0 = _mm512_permutexvar_epi8(v, t0);
                    __m512i r1 = _mm512_permutexvar_epi8(v, t1);
                    __m512i r2 = _mm512_permutexvar_epi8(v, t2);
                    __m512i r3 = _mm512_permutexvar_epi8(v, t3);
                    __mmask64 m6 = _mm512_test_epi8_mask(v, b6);
                    __mmask64 m7 = _mm512_test_epi8_mask(v, b7);
                    v = _mm512_mask_blend_epi8(
                        m7, _mm512_mask_blend_epi8(m6, r0, r1),
                        _mm512_mask_blend_epi8(m6, r2, r3));
                    _mm512_storeu_si512(d + k, v);
                }
                for (; k < L; k++) d[k] = table[s[L - 1 - k]];
                d += L;
            }
        }
    }
#else
    for (int64_t r = 0; r < n_rows; r++) {
        uint8_t* d = dst + dst_off[r];
        if ((r & 1) == 0) {
            for (int j = 0; j < 3; j++) {
                int64_t p = 3 * r + j;
                memcpy(d, src + p_starts[p], (size_t)p_lens[p]);
                d += p_lens[p];
            }
        } else {
            for (int j = 2; j >= 0; j--) {
                int64_t p = 3 * r + j;
                const uint8_t* s = src + p_starts[p];
                int64_t L = p_lens[p];
                for (int64_t k = 0; k < L; k++) d[k] = table[s[L - 1 - k]];
                d += L;
            }
        }
    }
#endif
}

// One-pass header-statistics scan (format/header.py quality_stats — the
// host mirror of the reference's first-chunk scan, rfqheader.cpp
// makeQualityTable): byte histograms of seq and qual plus the N-quality
// relations in a single memory-bandwidth pass instead of six numpy
// sweeps. out_meta (int64[4]): [first_invalid_byte or -1, first_n_qual
// or -1, n_qual_differs, nonn_after_matches].
void quality_scan(const uint8_t* seq, const uint8_t* qual, int64_t n,
                  int64_t* seq_hist, int64_t* qual_hist,
                  int64_t* out_meta) {
    // magic-static init: thread-safe (the old check-then-write lazy init
    // was a C++ data race under concurrent worker threads — TSAN r5)
    struct OkTab { bool ok[256]; };
    static const OkTab okt = [] {
        OkTab t{};
        t.ok['A'] = t.ok['T'] = t.ok['C'] = t.ok['G'] = t.ok['N'] = true;
        return t;
    }();
    const bool* ok = okt.ok;
    // 4 sub-histograms per stream break the store-forwarding dependency
    // on runs of equal bytes (quality data is mostly one value)
    int64_t hs[4][256], hq[4][256];
    memset(hs, 0, sizeof(hs));
    memset(hq, 0, sizeof(hq));
    int64_t first_invalid = -1, fq = -1;
    int64_t differs = 0, nonn_after = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t s = seq[i], q = qual[i];
        hs[i & 3][s]++;
        hq[i & 3][q]++;
        if (__builtin_expect(!ok[s], 0)) {
            if (first_invalid < 0) first_invalid = s;
        }
        if (__builtin_expect(s == 'N', 0)) {
            if (fq < 0) fq = q;
            else differs |= (q != fq);
        } else if (fq >= 0) {
            nonn_after |= (q == fq);
        }
    }
    for (int v = 0; v < 256; v++) {
        seq_hist[v] = hs[0][v] + hs[1][v] + hs[2][v] + hs[3][v];
        qual_hist[v] = hq[0][v] + hq[1][v] + hq[2][v] + hq[3][v];
    }
    out_meta[0] = first_invalid;
    out_meta[1] = fq;
    out_meta[2] = differs;
    out_meta[3] = nonn_after;
}

// Reassemble read names: name1 [":"+lane][":"+tile][":"+x][":"+y][name2]
// (reference rfqcodec.cpp:1156-1231; mirrors codec/names.py build_names).
// Any of lane/tile/x/y/name2 may be null. Fills out_off[n+1]; returns
// total bytes written.
static inline int64_t write_dec(uint8_t* p, uint64_t v) {
    static const char D2[] =
        "00010203040506070809101112131415161718192021222324"
        "25262728293031323334353637383940414243444546474849"
        "50515253545556575859606162636465666768697071727374"
        "75767778798081828384858687888990919293949596979899";
    uint8_t tmp[24];
    int k = 24;
    while (v >= 100) {  // two digits per division
        unsigned r = (unsigned)(v % 100);
        v /= 100;
        tmp[--k] = (uint8_t)D2[2 * r + 1];
        tmp[--k] = (uint8_t)D2[2 * r];
    }
    if (v >= 10) {
        tmp[--k] = (uint8_t)D2[2 * v + 1];
        tmp[--k] = (uint8_t)D2[2 * v];
    } else {
        tmp[--k] = (uint8_t)('0' + v);
    }
    int n = 24 - k;
    memcpy(p, tmp + k, (size_t)n);
    return n;
}

int64_t format_names(const uint8_t* n1_flat, const int64_t* n1_starts,
                     const int64_t* n1_lens, const int64_t* lane,
                     const int64_t* tile, const int64_t* x, const int64_t* y,
                     const uint8_t* n2_flat, const int64_t* n2_starts,
                     const int64_t* n2_lens, int64_t n, uint8_t* out,
                     int64_t* out_off) {
    const int64_t* fields[4] = {lane, tile, x, y};
    int64_t w = 0;
    for (int64_t i = 0; i < n; i++) {
        out_off[i] = w;
        memcpy(out + w, n1_flat + n1_starts[i], (size_t)n1_lens[i]);
        w += n1_lens[i];
        for (int f = 0; f < 4; f++) {
            if (fields[f]) {
                out[w++] = ':';
                w += write_dec(out + w, (uint64_t)fields[f][i]);
            }
        }
        if (n2_flat) {
            memcpy(out + w, n2_flat + n2_starts[i], (size_t)n2_lens[i]);
            w += n2_lens[i];
        }
    }
    out_off[n] = w;
    return w;
}

// Assemble 'name\nseq\nstrand\nqual\n' FASTQ records (the '@' is part of
// the stored name) for the reads selected by idx (idx == nullptr: all n
// in order) in ONE pass — replaces a gather-subset copy followed by four
// scatter passes and a final tobytes copy on the decode hot path.
// Returns bytes written.
int64_t assemble_fastq(const uint8_t* name_flat, const int64_t* name_off,
                       const uint8_t* seq_flat, const int64_t* seq_off,
                       const uint8_t* strand_flat, const int64_t* strand_off,
                       const uint8_t* qual_flat, const int64_t* qual_off,
                       const int64_t* idx, int64_t nidx, uint8_t* out) {
    int64_t w = 0;
    for (int64_t k = 0; k < nidx; k++) {
        int64_t i = idx ? idx[k] : k;
        int64_t l;
        l = name_off[i + 1] - name_off[i];
        copy_small(out + w, name_flat + name_off[i], l);
        w += l;
        out[w++] = '\n';
        l = seq_off[i + 1] - seq_off[i];
        copy_small(out + w, seq_flat + seq_off[i], l);
        w += l;
        out[w++] = '\n';
        l = strand_off[i + 1] - strand_off[i];
        copy_small(out + w, strand_flat + strand_off[i], l);
        w += l;
        out[w++] = '\n';
        l = qual_off[i + 1] - qual_off[i];
        copy_small(out + w, qual_flat + qual_off[i], l);
        w += l;
        out[w++] = '\n';
    }
    return w;
}

// 2-bit base pack/unpack (reference rfqcodec.cpp:588-609, 832-853).
void pack_2bit(const uint8_t* seq, int64_t n, uint8_t* out) {
    // magic-static: workers call this concurrently (TSAN r5)
    struct Tab { uint8_t t[256]; };
    static const Tab tab = [] {
        Tab x{};
        x.t['G'] = 0; x.t['A'] = 1; x.t['T'] = 2; x.t['C'] = 3;
        return x;
    }();
    const uint8_t* table = tab.t;
    int64_t nb = n / 4;
    int64_t b = 0;
#ifdef REPAQ_AVX512_VBMI
    // 64 bases -> 16 packed bytes: vpermb classify on the low 6 bits,
    // exactness restored by rebuilding the canonical char and masking
    // mismatches to 0 (scalar table maps every non-GATC byte to 0);
    // then 2-bit fields combine via multiply-add pairs and the 16
    // low bytes gather out with one vpermb.
    {
        static const uint8_t GATC[4] = {'G', 'A', 'T', 'C'};
        uint8_t cls[64];
        memset(cls, 0, 64);
        cls['G' & 63] = 0; cls['A' & 63] = 1;
        cls['T' & 63] = 2; cls['C' & 63] = 3;
        const __m512i vcls = _mm512_loadu_si512(cls);
        uint8_t chr[64];
        for (int i = 0; i < 64; i++) chr[i] = GATC[i & 3];
        const __m512i vchr = _mm512_loadu_si512(chr);
        const __m512i w14 = _mm512_set1_epi16(0x0401);   // bytes [1, 4]
        const __m512i w116 = _mm512_set1_epi32(0x00100001);  // u16 [1, 16]
        uint8_t gidx[64];
        memset(gidx, 0, 64);
        for (int i = 0; i < 16; i++) gidx[i] = (uint8_t)(4 * i);
        const __m512i vg = _mm512_loadu_si512(gidx);
        for (; b + 16 <= nb; b += 16) {
            __m512i v = _mm512_loadu_si512(seq + 4 * b);
            __m512i code = _mm512_permutexvar_epi8(v, vcls);
            __mmask64 ok = _mm512_cmpeq_epi8_mask(
                _mm512_permutexvar_epi8(code, vchr), v);
            code = _mm512_maskz_mov_epi8(ok, code);
            __m512i p = _mm512_maddubs_epi16(code, w14);
            p = _mm512_madd_epi16(p, w116);
            p = _mm512_permutexvar_epi8(vg, p);
            _mm_storeu_si128((__m128i*)(out + b),
                             _mm512_castsi512_si128(p));
        }
    }
#endif
    for (; b < nb; b++) {
        const uint8_t* s = seq + 4 * b;
        out[b] = (uint8_t)(table[s[0]] | (table[s[1]] << 2)
                           | (table[s[2]] << 4) | (table[s[3]] << 6));
    }
    if (n & 3) {
        uint8_t acc = 0;
        for (int64_t i = nb * 4; i < n; i++)
            acc |= (uint8_t)(table[seq[i]] << ((i & 3) * 2));
        out[nb] = acc;
    }
}

void unpack_2bit(const uint8_t* buf, int64_t nbytes, uint8_t* out,
                 int64_t length) {
    static const char base[4] = {'G', 'A', 'T', 'C'};
    // 256-entry packed-byte -> 4-base-chars table: one u32 store per
    // input byte instead of four shift/mask/LUT steps
    struct WTab { uint32_t w[256]; };
    // magic-static: decode workers call this concurrently (TSAN r5)
    static const WTab wt = [] {
        WTab x{};
        for (int v = 0; v < 256; v++) {
            uint8_t c[4];
            for (int k = 0; k < 4; k++) c[k] = (uint8_t)base[(v >> (2 * k)) & 3];
            memcpy(&x.w[v], c, 4);
        }
        return x;
    }();
    const uint32_t* word = wt.w;
    int64_t avail = nbytes * 4 < length ? nbytes * 4 : length;
    int64_t nb4 = avail / 4;
    int64_t b = 0;
#ifdef REPAQ_AVX512_VBMI
    // 16 packed bytes -> 64 bases: replicate each byte 4x (vpermb),
    // vpmultishiftqb pulls each output's 2-bit field to the bottom
    // (offset 8*j + 2*(j&3) per qword position, wrap bits masked off),
    // and a final vpermb maps code -> base char.
    {
        uint8_t ridx[64];
        for (int i = 0; i < 64; i++) ridx[i] = (uint8_t)(i >> 2);
        const __m512i vr = _mm512_loadu_si512(ridx);
        uint8_t sh[64];
        for (int i = 0; i < 64; i++)
            sh[i] = (uint8_t)(8 * (i & 7) + 2 * (i & 3));
        const __m512i vsh = _mm512_loadu_si512(sh);
        uint8_t chr[64];
        for (int i = 0; i < 64; i++) chr[i] = (uint8_t)base[i & 3];
        const __m512i vchr = _mm512_loadu_si512(chr);
        const __m512i three = _mm512_set1_epi8(3);
        for (; b + 16 <= nb4; b += 16) {
            __m512i v = _mm512_castsi128_si512(
                _mm_loadu_si128((const __m128i*)(buf + b)));
            v = _mm512_permutexvar_epi8(vr, v);
            v = _mm512_multishift_epi64_epi8(vsh, v);
            v = _mm512_and_si512(v, three);
            v = _mm512_permutexvar_epi8(v, vchr);
            _mm512_storeu_si512(out + 4 * b, v);
        }
    }
#endif
    for (; b < nb4; b++)
        memcpy(out + 4 * b, &word[buf[b]], 4);
    for (int64_t i = nb4 * 4; i < avail; i++)
        out[i] = (uint8_t)base[(buf[i >> 2] >> ((i & 3) * 2)) & 3];
    for (int64_t i = avail; i < length; i++) out[i] = 'N';
}

// C `atoi` over [starts, ends) spans with the exact semantics of
// repaq_tpu.util.c_atoi (reference fastqmeta.cpp:40): skip leading
// whitespace, optional sign, digits; POSITIVE values saturate at INT64_MAX
// before the int32 truncation (glibc strtol behavior), negative values
// wrap in full precision mod 2^32 (matching the python oracle exactly).
void atoi_spans(const uint8_t* flat, const int64_t* starts,
                const int64_t* ends, int64_t n, int64_t* out) {
    const int64_t I64MAX = 0x7FFFFFFFFFFFFFFFLL;
    for (int64_t k = 0; k < n; k++) {
        int64_t i = starts[k], e = ends[k];
        while (i < e) {
            uint8_t c = flat[i];
            if (c == ' ' || (c >= '\t' && c <= '\r')) i++;
            else break;
        }
        int sign = 1;
        if (i < e && (flat[i] == '+' || flat[i] == '-')) {
            if (flat[i] == '-') sign = -1;
            i++;
        }
        uint64_t acc = 0;          // wrapping accumulator (mod 2^64)
        unsigned __int128 mag = 0; // clamped magnitude for saturation test
        const unsigned __int128 CLAMP = ((unsigned __int128)1) << 70;
        while (i < e && flat[i] >= '0' && flat[i] <= '9') {
            uint32_t d = flat[i] - '0';
            acc = acc * 10u + d;
            if (mag < CLAMP) mag = mag * 10 + d;
            i++;
        }
        uint32_t low;
        if (sign > 0 && mag > (unsigned __int128)I64MAX) {
            low = 0xFFFFFFFFu;  // INT64_MAX truncated to int32 = -1
        } else if (sign > 0) {
            low = (uint32_t)acc;
        } else {
            low = (uint32_t)(0u - (uint32_t)acc);
        }
        out[k] = (int64_t)(int32_t)low;
    }
}

// ---------------------------------------------------------------------------
// Interleaved rANS (the .rfqz second entropy stage; exact semantics of
// repaq_tpu/codec/rans_np.py: 32-bit state, 16-bit renorm, 12-bit scale).
// Lanes are independent; the invariant state in [2^16, 2^32) gives at most
// one renorm word per symbol in both directions.
// ---------------------------------------------------------------------------

// Encode all lanes. data: n bytes; lane_off: (lanes+1) slice bounds;
// freq/cum: 256 (order 0) or 256*256 (order 1, row = prev byte context)
// int32 tables; out: payload buffer (cap >= 2n + 4*lanes); counts: per-lane
// payload byte counts. Returns total payload bytes.
// One lane encoded from an explicit resume point (shared by the scalar
// path and the SIMD groups' tails). Appends renorm words to *words.
static inline uint32_t rans_encode_lane(
    const uint8_t* data, int64_t lo, int64_t p_start, uint32_t state,
    const int32_t* freq, const int32_t* cum, int32_t order,
    uint16_t* words, int64_t* nw) {
    for (int64_t p = p_start; p >= lo; p--) {
        uint8_t sym = data[p];
        uint32_t ctx = (order && p > lo) ? data[p - 1] : 0u;
        const int32_t* f_row = order ? freq + (size_t)ctx * 256 : freq;
        const int32_t* c_row = order ? cum + (size_t)ctx * 256 : cum;
        uint32_t f = (uint32_t)f_row[sym];
        uint32_t c = (uint32_t)c_row[sym];
        if ((state >> 20) >= f) {
            words[(*nw)++] = (uint16_t)(state & 0xFFFF);
            state >>= 16;
        }
        state = ((state / f) << 12) + (state % f) + c;
    }
    return state;
}

int64_t rans_encode(const uint8_t* data, int64_t n, const int64_t* lane_off,
                    int64_t lanes, const int32_t* freq, const int32_t* cum,
                    int32_t order, uint8_t* out, int64_t* counts) {
    (void)n;
#ifdef REPAQ_AVX512_VBMI
    // 16 lanes encode in lockstep. One backward qword gather per 8 lanes
    // yields both data[p] and data[p-1] (symbol + order-1 context); a
    // gathered u64 entry (mlo<<32 | mhi<<30 | l<<26 | f<<13 | c) carries
    // the Granlund-Montgomery 33-bit reciprocal, so the per-symbol
    // division runs as multiply+shift in 64-bit lanes — exact for every
    // state < 2^32 (verified over the renorm-bounded domain). Lanes
    // finish on the exact scalar body when p drops below the safe gather
    // window or their span runs out.
    if (lanes >= 16 && n >= 64) {
        int64_t n_ctx = order ? 256 : 1;
        uint64_t* table =
            (uint64_t*)malloc((size_t)n_ctx * 256 * sizeof(uint64_t));
        if (table) {
            for (int64_t ctx = 0; ctx < n_ctx; ctx++) {
                const int32_t* fr = freq + ctx * 256;
                const int32_t* cu = cum + ctx * 256;
                for (int s = 0; s < 256; s++) {
                    uint64_t f = (uint64_t)(uint32_t)fr[s];
                    uint64_t c = (uint64_t)((uint32_t)cu[s] & 0x1FFF);
                    uint64_t l = 0, mlo = 0, mhi = 0;
                    if (f) {
                        while (((uint64_t)1 << l) < f) l++;
                        unsigned __int128 m =
                            (((unsigned __int128)1 << (32 + l)) + f - 1)
                            / f;
                        mlo = (uint64_t)(m & 0xFFFFFFFFull);
                        mhi = (uint64_t)(m >> 32);  // 0 or 1
                    }
                    table[ctx * 256 + s] = (mlo << 32) | (mhi << 30) |
                                           (l << 26) | ((f & 0x1FFF) << 13)
                                           | c;
                }
            }
            int64_t total = 0;
            int64_t li = 0;
            const __m512i m13 = _mm512_set1_epi64(0x1FFF);
            const __m512i m16 = _mm512_set1_epi64(0xFFFF);
            for (; li + 16 <= lanes; li += 16) {
                int64_t spans[16], lo[16], hi[16];
                int64_t min_span = INT64_MAX, min_hi = INT64_MAX;
                int64_t wcap = 0;
                for (int k = 0; k < 16; k++) {
                    lo[k] = lane_off[li + k];
                    hi[k] = lane_off[li + k + 1];
                    spans[k] = hi[k] - lo[k];
                    if (spans[k] < min_span) min_span = spans[k];
                    if (hi[k] < min_hi) min_hi = hi[k];
                    wcap += spans[k] > 0 ? spans[k] : 1;
                }
                uint16_t* wbuf = new uint16_t[(size_t)wcap];
                uint16_t* words[16];
                int64_t nw[16];
                {
                    int64_t woff = 0;
                    for (int k = 0; k < 16; k++) {
                        words[k] = wbuf + woff;
                        woff += spans[k] > 0 ? spans[k] : 1;
                        nw[k] = 0;
                    }
                }
                // SIMD steps s = 0 .. s_max: needs p_k-7 >= 0 for the
                // qword gather and p_k > lo_k for context validity
                int64_t s_max = min_span - 2;
                if (min_hi - 8 < s_max) s_max = min_hi - 8;
                uint64_t st[8], pv[8];
                __m512i vstate[2], vp[2];
                for (int h = 0; h < 2; h++) {
                    for (int k = 0; k < 8; k++) {
                        st[k] = 1u << 16;
                        pv[k] = (uint64_t)(hi[8 * h + k] - 1);
                    }
                    vstate[h] = _mm512_loadu_si512(st);
                    vp[h] = _mm512_loadu_si512(pv);
                }
                int64_t s = 0;
                for (; s <= s_max; s++) {
                    for (int h = 0; h < 2; h++) {
                        // data[p-7 .. p] in one qword gather per lane
                        __m512i w = _mm512_i64gather_epi64(
                            _mm512_add_epi64(
                                vp[h], _mm512_set1_epi64(-7)),
                            data, 1);
                        __m512i sym = _mm512_srli_epi64(w, 56);
                        __m512i idx = sym;
                        if (order) {
                            __m512i ctx = _mm512_and_si512(
                                _mm512_srli_epi64(w, 48),
                                _mm512_set1_epi64(0xFF));
                            idx = _mm512_add_epi64(
                                _mm512_slli_epi64(ctx, 8), sym);
                        }
                        __m512i e =
                            _mm512_i64gather_epi64(idx, table, 8);
                        __m512i c = _mm512_and_si512(e, m13);
                        __m512i f = _mm512_and_si512(
                            _mm512_srli_epi64(e, 13), m13);
                        __m512i l = _mm512_and_si512(
                            _mm512_srli_epi64(e, 26),
                            _mm512_set1_epi64(0xF));
                        __m512i mhi = _mm512_and_si512(
                            _mm512_srli_epi64(e, 30),
                            _mm512_set1_epi64(1));
                        __m512i mlo = _mm512_srli_epi64(e, 32);
                        // renorm: (state >> 20) >= f
                        __mmask8 need = _mm512_cmpge_epu64_mask(
                            _mm512_srli_epi64(vstate[h], 20), f);
                        if (need) {
                            uint64_t tmp[8];
                            _mm512_storeu_si512(tmp, _mm512_and_si512(
                                vstate[h], m16));
                            for (int k = 0; k < 8; k++)
                                if ((need >> k) & 1) {
                                    int lane = 8 * h + k;
                                    words[lane][nw[lane]++] =
                                        (uint16_t)tmp[k];
                                }
                            vstate[h] = _mm512_mask_srli_epi64(
                                vstate[h], need, vstate[h], 16);
                        }
                        // q = ((state*mlo)>>32 + state*mhi) >> l
                        __m512i t = _mm512_add_epi64(
                            _mm512_srli_epi64(
                                _mm512_mul_epu32(vstate[h], mlo), 32),
                            _mm512_mul_epu32(vstate[h], mhi));
                        __m512i q = _mm512_srlv_epi64(t, l);
                        __m512i r = _mm512_sub_epi64(
                            vstate[h], _mm512_mul_epu32(q, f));
                        vstate[h] = _mm512_add_epi64(
                            _mm512_add_epi64(
                                _mm512_slli_epi64(q, 12), r),
                            c);
                        vp[h] = _mm512_add_epi64(
                            vp[h], _mm512_set1_epi64(-1));
                    }
                }
                // scalar tails from the exact lane states
                for (int h = 0; h < 2; h++) {
                    _mm512_storeu_si512(st, vstate[h]);
                    _mm512_storeu_si512(pv, vp[h]);
                    for (int k = 0; k < 8; k++) {
                        int lane = 8 * h + k;
                        uint32_t state = rans_encode_lane(
                            data, lo[lane], (int64_t)pv[k],
                            (uint32_t)st[k], freq, cum, order,
                            words[lane], &nw[lane]);
                        uint8_t* dst = out + total;
                        dst[0] = (uint8_t)(state & 0xFF);
                        dst[1] = (uint8_t)((state >> 8) & 0xFF);
                        dst[2] = (uint8_t)((state >> 16) & 0xFF);
                        dst[3] = (uint8_t)((state >> 24) & 0xFF);
                        int64_t b = 4;
                        for (int64_t j = nw[lane] - 1; j >= 0; j--) {
                            dst[b++] = (uint8_t)(words[lane][j] >> 8);
                            dst[b++] = (uint8_t)(words[lane][j] & 0xFF);
                        }
                        counts[li + lane] = b;
                        total += b;
                    }
                }
                delete[] wbuf;
            }
            for (; li < lanes; li++) {
                int64_t lo = lane_off[li], hi = lane_off[li + 1];
                int64_t max_words = hi - lo;
                uint16_t* words =
                    new uint16_t[(size_t)(max_words > 0 ? max_words : 1)];
                int64_t nw = 0;
                uint32_t state = rans_encode_lane(
                    data, lo, hi - 1, 1u << 16, freq, cum, order, words,
                    &nw);
                uint8_t* dst = out + total;
                dst[0] = (uint8_t)(state & 0xFF);
                dst[1] = (uint8_t)((state >> 8) & 0xFF);
                dst[2] = (uint8_t)((state >> 16) & 0xFF);
                dst[3] = (uint8_t)((state >> 24) & 0xFF);
                int64_t b = 4;
                for (int64_t k = nw - 1; k >= 0; k--) {
                    dst[b++] = (uint8_t)(words[k] >> 8);
                    dst[b++] = (uint8_t)(words[k] & 0xFF);
                }
                counts[li] = b;
                total += b;
                delete[] words;
            }
            free(table);
            return total;
        }
    }
#endif
    int64_t total = 0;
    // scratch for one lane's words (encoder order)
    for (int64_t li = 0; li < lanes; li++) {
        int64_t lo = lane_off[li], hi = lane_off[li + 1];
        int64_t max_words = hi - lo;
        uint16_t* words = new uint16_t[(size_t)(max_words > 0 ? max_words : 1)];
        int64_t nw = 0;
        uint32_t state = rans_encode_lane(data, lo, hi - 1, 1u << 16, freq,
                                          cum, order, words, &nw);
        uint8_t* dst = out + total;
        dst[0] = (uint8_t)(state & 0xFF);
        dst[1] = (uint8_t)((state >> 8) & 0xFF);
        dst[2] = (uint8_t)((state >> 16) & 0xFF);
        dst[3] = (uint8_t)((state >> 24) & 0xFF);
        int64_t b = 4;
        for (int64_t k = nw - 1; k >= 0; k--) {  // decode order, hi byte first
            dst[b++] = (uint8_t)(words[k] >> 8);
            dst[b++] = (uint8_t)(words[k] & 0xFF);
        }
        counts[li] = b;
        total += b;
        delete[] words;
    }
    return total;
}

// Decode all lanes. payload: flat per-lane image; lane_counts: per-lane
// payload bytes; sym_lut: 4096 (order 0) or 256*4096 (order 1) u8;
// out: n bytes.
// One lane decoded from an explicit resume point (the scalar body shared
// by the reference path and the SIMD groups' tails).
static inline void rans_decode_lane(
    const uint8_t* src, int64_t avail, uint32_t state, int64_t ptr,
    uint32_t prev, int64_t p, int64_t p_end, const int32_t* freq,
    const int32_t* cum, const uint8_t* sym_lut, int32_t order,
    uint8_t* out) {
    for (; p < p_end; p++) {
        uint32_t slot = state & 0xFFF;
        uint8_t sym;
        uint32_t f, c;
        if (order) {
            sym = sym_lut[(size_t)prev * 4096 + slot];
            f = (uint32_t)freq[(size_t)prev * 256 + sym];
            c = (uint32_t)cum[(size_t)prev * 256 + sym];
        } else {
            sym = sym_lut[slot];
            f = (uint32_t)freq[sym];
            c = (uint32_t)cum[sym];
        }
        state = f * (state >> 12) + slot - c;
        if (state < (1u << 16) && ptr < avail) {
            state = (state << 16) | ((uint32_t)src[ptr] << 8) |
                    (uint32_t)src[ptr + 1];
            ptr += 2;
        }
        out[p] = sym;
        prev = sym;
    }
}

void rans_decode(const uint8_t* payload, const int64_t* lane_counts,
                 int64_t lanes, const int64_t* lane_off, const int32_t* freq,
                 const int32_t* cum, const uint8_t* sym_lut, int32_t order,
                 uint8_t* out) {
#ifdef REPAQ_AVX512_VBMI
    // 16 lanes decode in lockstep: one vpgatherdd against a fused
    // ((f-1)<<20 | c<<8 | sym) u32 table answers symbol, frequency and
    // cumulative in a single load, the state recurrence runs in vector
    // registers, and renorm words gather straight from the payload.
    // Each lane's output span is contiguous, so the 16 symbols per step
    // store as plain byte writes. Lanes leave the SIMD loop when their
    // input tail is within one gather of the lane end (or their span is
    // done) and finish on the exact scalar body above — bit-identical
    // states by construction.
    int64_t total_payload = 0;
    for (int64_t li = 0; li < lanes; li++) total_payload += lane_counts[li];
    if (lanes >= 16 && total_payload < (int64_t)1 << 31) {
        int64_t n_ctx = order ? 256 : 1;
        uint64_t* table =
            (uint64_t*)malloc((size_t)n_ctx * 4096 * sizeof(uint64_t));
        if (table) {
            // exact mirror of the scalar lookups (sym via sym_lut, f/c by
            // that symbol) so SIMD and scalar decode identically even on
            // corrupt tables: f << 32 | c << 16 | sym, every field exact
            // (a 32-bit packing cannot hold f in 0..4096 plus c and sym)
            for (int64_t ctx = 0; ctx < n_ctx; ctx++) {
                const int32_t* fr = freq + ctx * 256;
                const int32_t* cu = cum + ctx * 256;
                const uint8_t* sl = sym_lut + ctx * 4096;
                uint64_t* row = table + ctx * 4096;
                for (int slot = 0; slot < 4096; slot++) {
                    uint8_t s = sl[slot];
                    row[slot] = ((uint64_t)(uint32_t)fr[s] << 32) |
                                ((uint64_t)((uint32_t)cu[s] & 0xFFFF)
                                 << 16) |
                                (uint64_t)s;
                }
            }
            int64_t start = 0;
            int64_t li = 0;
            std::vector<int64_t> starts(lanes);
            for (int64_t k = 0; k < lanes; k++) {
                starts[k] = start;
                start += lane_counts[k];
            }
            const __m512i m12 = _mm512_set1_epi32(0xFFF);
            const __m512i m8 = _mm512_set1_epi32(0xFF);
            const __m512i two = _mm512_set1_epi32(2);
            const __m512i four = _mm512_set1_epi32(4);
            const __m512i renorm_lim = _mm512_set1_epi32(1 << 16);
            for (; li + 16 <= lanes; li += 16) {
                uint32_t st[16], pr[16];
                int32_t pt[16], en[16];
                int64_t pos[16], pend[16];
                int64_t nsimd = INT64_MAX;
                for (int k = 0; k < 16; k++) {
                    const uint8_t* src = payload + starts[li + k];
                    st[k] = (uint32_t)src[0] | ((uint32_t)src[1] << 8) |
                            ((uint32_t)src[2] << 16) |
                            ((uint32_t)src[3] << 24);
                    pt[k] = (int32_t)(starts[li + k] + 4);
                    en[k] = (int32_t)(starts[li + k] + lane_counts[li + k]);
                    pos[k] = lane_off[li + k];
                    pend[k] = lane_off[li + k + 1];
                    pr[k] = 0;
                    int64_t span = pend[k] - pos[k];
                    if (span < nsimd) nsimd = span;
                }
                __m512i vstate = _mm512_loadu_si512(st);
                __m512i vptr = _mm512_loadu_si512(pt);
                __m512i vend = _mm512_loadu_si512(en);
                __m512i vprev = _mm512_setzero_si512();
                int64_t step = 0;
                for (; step < nsimd; step++) {
                    // every lane must keep a full 4-byte renorm gather
                    // in-bounds; drop to scalar for the tail otherwise
                    __mmask16 safe = _mm512_cmple_epi32_mask(
                        _mm512_add_epi32(vptr, four), vend);
                    if (safe != 0xFFFF) break;
                    __m512i slot = _mm512_and_si512(vstate, m12);
                    __m512i idx = order
                        ? _mm512_or_si512(_mm512_slli_epi32(vprev, 12), slot)
                        : slot;
                    __m512i elo = _mm512_i64gather_epi64(
                        _mm512_cvtepu32_epi64(
                            _mm512_castsi512_si256(idx)),
                        table, 8);
                    __m512i ehi = _mm512_i64gather_epi64(
                        _mm512_cvtepu32_epi64(
                            _mm512_extracti64x4_epi64(idx, 1)),
                        table, 8);
                    __m512i f = _mm512_inserti64x4(
                        _mm512_castsi256_si512(_mm512_cvtepi64_epi32(
                            _mm512_srli_epi64(elo, 32))),
                        _mm512_cvtepi64_epi32(_mm512_srli_epi64(ehi, 32)),
                        1);
                    __m512i csym = _mm512_inserti64x4(
                        _mm512_castsi256_si512(_mm512_cvtepi64_epi32(elo)),
                        _mm512_cvtepi64_epi32(ehi), 1);
                    __m512i c = _mm512_srli_epi32(csym, 16);
                    __m512i sym = _mm512_and_si512(csym, m8);
                    vstate = _mm512_add_epi32(
                        _mm512_sub_epi32(
                            _mm512_mullo_epi32(
                                f, _mm512_srli_epi32(vstate, 12)),
                            c),
                        slot);
                    __mmask16 need =
                        _mm512_cmplt_epu32_mask(vstate, renorm_lim);
                    if (need) {
                        __m512i w = _mm512_mask_i32gather_epi32(
                            _mm512_setzero_si512(), need, vptr, payload, 1);
                        __m512i word = _mm512_or_si512(
                            _mm512_slli_epi32(_mm512_and_si512(w, m8), 8),
                            _mm512_and_si512(_mm512_srli_epi32(w, 8), m8));
                        vstate = _mm512_mask_blend_epi32(
                            need, vstate,
                            _mm512_or_si512(_mm512_slli_epi32(vstate, 16),
                                            word));
                        vptr = _mm512_mask_add_epi32(vptr, need, vptr, two);
                    }
                    uint8_t syms[16];
                    _mm_storeu_si128((__m128i*)syms,
                                     _mm512_cvtepi32_epi8(sym));
                    for (int k = 0; k < 16; k++)
                        out[pos[k] + step] = syms[k];
                    vprev = sym;
                }
                // scalar tails from the exact lane states
                _mm512_storeu_si512(st, vstate);
                _mm512_storeu_si512(pt, vptr);
                uint32_t prtmp[16];
                _mm512_storeu_si512(prtmp, vprev);
                for (int k = 0; k < 16; k++) {
                    rans_decode_lane(
                        payload + starts[li + k],
                        lane_counts[li + k], st[k],
                        (int64_t)pt[k] - starts[li + k], prtmp[k],
                        pos[k] + step, pend[k], freq, cum, sym_lut, order,
                        out);
                }
            }
            // lanes not in a full group of 16
            for (; li < lanes; li++) {
                const uint8_t* src = payload + starts[li];
                uint32_t state = (uint32_t)src[0] | ((uint32_t)src[1] << 8) |
                                 ((uint32_t)src[2] << 16) |
                                 ((uint32_t)src[3] << 24);
                rans_decode_lane(src, lane_counts[li], state, 4, 0,
                                 lane_off[li], lane_off[li + 1], freq, cum,
                                 sym_lut, order, out);
            }
            free(table);
            return;
        }
    }
#endif
    int64_t start = 0;
    for (int64_t li = 0; li < lanes; li++) {
        const uint8_t* src = payload + start;
        int64_t avail = lane_counts[li];
        uint32_t state = (uint32_t)src[0] | ((uint32_t)src[1] << 8) |
                         ((uint32_t)src[2] << 16) | ((uint32_t)src[3] << 24);
        rans_decode_lane(src, avail, state, 4, 0, lane_off[li],
                         lane_off[li + 1], freq, cum, sym_lut, order, out);
        start += avail;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy hash-chain LZ parse/expand for the .rfqz second stage.
//
// The rANS stage cannot touch cross-read redundancy (sequencing coverage
// puts every genome position in ~N reads), which is exactly what the
// reference's external xz exploits on the 2-bit-packed seq stream. This
// parser runs over the UNPACKED base stream so matches are found at any
// alignment (packed bytes only match when reads overlap with equal phase
// mod 4 — 3/4 of matches are invisible to byte-level LZ).
//
// Tokens: (lit_len, match_len, dist) triples; a final token may have
// match_len == 0. Greedy longest-match with a bounded chain walk.
// ---------------------------------------------------------------------------

namespace lz {

constexpr int HASH_BITS = 21;
constexpr int64_t HSIZE = (int64_t)1 << HASH_BITS;
// chain depth and the rep-skip gate are env-tunable for tradeoff scans
// (REPAQ_LZ_MAXCHAIN / REPAQ_LZ_REPGOOD); defaults match the shipped
// parse. Same env => same tokens: thread-count invariance is untouched.
static int lz_maxchain() {
    // magic-static init: thread-safe under the multithreaded window parse
    static const int v = [] {
        const char* e = getenv("REPAQ_LZ_MAXCHAIN");
        int x = e ? atoi(e) : 32;
        return x < 1 ? 1 : x;
    }();
    return v;
}
static int lz_repgood() {
    static const int v = [] {
        const char* e = getenv("REPAQ_LZ_REPGOOD");
        int x = e ? atoi(e) : 48;
        return x < 1 ? 1 : x;
    }();
    return v;
}
constexpr int64_t HB = 12;        // bytes hashed
constexpr int64_t WINDOW = 8 << 20;  // fixed parse-window size (see below)

static inline uint32_t hash_at(const uint8_t* data, int64_t i) {
    uint64_t h = 0;
    memcpy(&h, data + i, 8);
    uint32_t h2;
    memcpy(&h2, data + i + 8, 4);
    h = h * 0x9E3779B185EBCA87ull ^ (uint64_t)h2 * 0xC2B2AE3D27D4EB4Full;
    return (uint32_t)(h >> (64 - HASH_BITS));
}

// 8-bytes-at-a-time common-prefix length (pure reads, so self-overlapping
// rep matches compare identically to the byte-serial loop). At coverage
// depth the average seq match is >100 bases — this is ~5x faster than
// byte stepping and dominates parse time.
static inline int64_t extend_match(const uint8_t* a, const uint8_t* b,
                                   int64_t lim) {
    int64_t l = 0;
    // the first 16 bytes stay 8-byte XOR steps: most probes (failed
    // chain candidates, rep misses at error boundaries) die here and a
    // vector setup would be pure overhead
    for (int k = 0; k < 2 && l + 8 <= lim; k++) {
        uint64_t x, y;
        memcpy(&x, a + l, 8);
        memcpy(&y, b + l, 8);
        uint64_t d = x ^ y;
        if (d) return l + (__builtin_ctzll(d) >> 3);
        l += 8;
    }
#ifdef REPAQ_AVX512_VBMI
    // a probe that survived 16 bytes is a real match; coverage data
    // makes them multi-hundred-base, where 64-byte compares pay
    if (l == 16) {
        while (l + 64 <= lim) {
            __m512i va = _mm512_loadu_si512(a + l);
            __m512i vb = _mm512_loadu_si512(b + l);
            uint64_t ne = _mm512_cmpneq_epi8_mask(va, vb);
            if (ne) return l + (int64_t)__builtin_ctzll(ne);
            l += 64;
        }
    }
#endif
    while (l + 8 <= lim) {
        uint64_t x, y;
        memcpy(&x, a + l, 8);
        memcpy(&y, b + l, 8);
        uint64_t d = x ^ y;
        if (d) return l + (__builtin_ctzll(d) >> 3);
        l += 8;
    }
    while (l < lim && a[l] == b[l]) l++;
    return l;
}

struct Tok { int64_t lit, ml, dist; };

// Grid-chain storage is COMPACT (ADVICE r3: the per-byte int32 prev
// array peaked at ~640 MB for 96M history + 64M section). Grid inserts
// only happen at j = 0,5,10,.. while j < parse_from, then jc, jc+3,..
// (jc = first multiple of 5 >= parse_from), so prev links are stored
// indexed by grid SLOT: ~n/5 + n/3 entries instead of n. Chain values
// stay absolute positions; only the array indexing changes, so token
// streams are bit-identical to the dense layout.
static inline int64_t grid_jc(int64_t parse_from) {
    return ((parse_from + 4) / 5) * 5;
}
static inline int64_t grid_slot(int64_t c, int64_t jc, int64_t nd) {
    return c < jc ? c / 5 : nd + (c - jc) / 3;
}

// --- candidate table ------------------------------------------------------
// ChainTab: the grid chain entered via a per-window head snapshot. A
// bucket-row alternative (8-16 independent candidates per cache line)
// was measured and rejected — see the round-4 LZ decision record in
// ARCHITECTURE.md: at ratio parity it gains only ~15% and needs 64 MB
// table snapshots per window.
struct ChainTab {
    std::vector<int32_t> head_v;
    std::vector<int32_t> prev_own;
    const int32_t* prev_shared;
    int64_t p0, jc, nd;
    ChainTab(const int32_t* snapshot_head, const int32_t* shared,
             int64_t p0_, int64_t parse_from, int64_t w_end)
        : head_v(snapshot_head, snapshot_head + HSIZE),
          prev_own(w_end - p0_, -1), prev_shared(shared), p0(p0_),
          jc(grid_jc(parse_from)), nd(grid_jc(parse_from) / 5) {}
    static inline uint32_t hash(const uint8_t* data, int64_t i) {
        return hash_at(data, i);
    }
    inline int64_t prev_of(int64_t c) const {
        return c >= p0 ? prev_own[c - p0]
                       : prev_shared[grid_slot(c, jc, nd)];
    }
    inline void insert(uint32_t h, int64_t j) {
        prev_own[j - p0] = head_v[h];
        head_v[h] = (int32_t)j;
    }
    inline void probe(const uint8_t* data, int64_t at, uint32_t h,
                      int64_t lim, int64_t& best_len, int64_t& best_pos) {
        int64_t cand = head_v[h];
        int walked = 0;
        const int maxchain = lz_maxchain();
        while (cand >= 0 && walked < maxchain) {
            // extend only if it beats best: check the byte at best_len
            // (best_len < lim guards the probe when a prior candidate
            // already matched to the limit — UB past it)
            if (best_len < lim && cand + best_len < at &&
                data[cand + best_len] == data[at + best_len]) {
                int64_t l = extend_match(data + cand, data + at, lim);
                if (l > best_len) { best_len = l; best_pos = cand; }
                if (best_len >= 96) break;  // good enough: stop paying
            }
            cand = prev_of(cand);
            walked++;
        }
    }
};

// Parse one fixed window [w_begin, w_end). The candidate tables are the
// full-prefix GRID chain (prev_shared: every position j < w_begin,
// inserted in ascending order — deterministic) entered through this
// window's head snapshot, plus the window's own incremental inserts in a
// private overlay. Matches never extend past w_end. Everything here is a
// pure function of (data, w_begin, w_end), so the token stream is
// byte-identical for ANY thread count or schedule.
template <class TAB>
static void parse_window_t(const uint8_t* data, int64_t n,
                           int64_t min_match, int64_t w_begin, int64_t w_end,
                           int64_t parse_from, TAB& T,
                           std::vector<Tok>& out) {
    // parse_from > w_begin: dictionary mode — bytes before parse_from are
    // match SOURCE only (the table covers them via this window's
    // snapshot, taken at parse_from); tokens start there.
    int64_t p0 = parse_from > w_begin ? parse_from : w_begin;

    // LZMA-style rep-distance slots: sequencing errors chop long genome
    // matches into (match, 1-2 error bases, match-at-SAME-distance)
    // runs; re-using a recent distance costs ~0 bits after the MTF dist
    // transform in the serializer, so rep matches are accepted down to
    // REP_MIN and preferred over slightly-longer fresh-distance matches.
    // State is window-local => still thread-count invariant.
    constexpr int NREP = 4;
    constexpr int64_t REP_MIN = 8;
    // one-step lazy matching (round 4): matches shorter than LAZY_GOOD
    // are held one position; if i+1 finds a better one, the byte at i
    // joins the literal run (a 2-bit base for MODE_SEQLZ) and the longer
    // match wins. Coverage data is exactly where this pays: 20-40 reads
    // cover each locus, each ending at different error positions, and
    // greedy often anchors one base too early.
    constexpr int64_t LAZY_GOOD = 64;
    int64_t rep[NREP] = {0, 0, 0, 0};

    int64_t i = p0, lit_start = p0;
    int64_t miss_run = 0;  // LZ4-style skip acceleration through deserts
    int64_t ins_hi = -1;   // highest chain-inserted position (no dupes:
                           // re-inserting a position would self-loop)
    int64_t pend_i = -1, pend_len = 0, pend_pos = -1;
    bool pend_rep = false;

    // candidate search at position `at` (rep probes first, then the
    // bounded chain walk); returns acceptance, fills (len, pos, is_rep)
    auto find_at = [&](int64_t at, uint32_t h, int64_t lim, int64_t& len,
                       int64_t& posn, bool& is_rep) -> bool {
        int64_t rep_len = 0, rep_dist = 0;
        // issue the four probe loads independently first: rep distances
        // span megabytes on coverage data, so each first byte is a cache
        // miss — four parallel misses instead of four serialized
        // extend_match calls is most of the probe cost. A zero-length
        // extend never beats rep_len >= 0, so the first-byte reject is
        // output-identical.
        uint8_t c0[NREP];
        bool ok_r[NREP];
        for (int r = 0; r < NREP; r++) {
            int64_t d = rep[r];
            ok_r[r] = d > 0 && at - d >= 0;
            c0[r] = ok_r[r] ? data[at - d] : 0;
        }
        uint8_t ca = data[at];
        for (int r = 0; r < NREP; r++) {
            if (!ok_r[r] || c0[r] != ca) continue;
            int64_t d = rep[r];
            int64_t l = extend_match(data + at - d, data + at, lim);
            if (l > rep_len) { rep_len = l; rep_dist = d; }
        }
        int64_t best_len = 0, best_pos = -1;
        if (rep_len < lz_repgood()) {
            T.probe(data, at, h, lim, best_len, best_pos);
        }
        // a rep match is ~3 dist bytes cheaper than a fresh one: take it
        // unless the fresh match is substantially longer
        bool use_rep = rep_len >= REP_MIN && rep_len + 12 >= best_len;
        if (use_rep) { len = rep_len; posn = at - rep_dist; is_rep = true; }
        else { len = best_len; posn = best_pos; is_rep = false; }
        return use_rep || best_len >= min_match;
    };

    auto emit = [&](int64_t at, int64_t mlen, int64_t mpos) {
        int64_t dist = at - mpos;
        // move-to-front the used distance into the rep slots
        int hit = NREP - 1;
        for (int r = 0; r < NREP; r++) {
            if (rep[r] == dist) { hit = r; break; }
        }
        for (int r = hit; r > 0; r--) rep[r] = rep[r - 1];
        rep[0] = dist;
        out.push_back({at - lit_start, mlen, dist});
        // sparse insertion inside the match keeps the chain useful
        // without quadratic insert cost (ins_hi skips positions the lazy
        // step already inserted)
        int64_t end = at + mlen;
        for (int64_t j = at + 1; j + HB <= n && j < end; j += 5) {
            if (j <= ins_hi) continue;
            T.insert(TAB::hash(data, j), j);
            ins_hi = j;
        }
        i = end;
        lit_start = i;
        miss_run = 0;
        pend_i = -1;
    };

    while (i < w_end && i + HB <= n) {
        uint32_t h = TAB::hash(data, i);
        int64_t lim = (w_end < n ? w_end : n) - i;  // no cross-window tail
        int64_t len, posn;
        bool is_rep;
        bool ok = find_at(i, h, lim, len, posn, is_rep);
        if (i > ins_hi) {
            T.insert(h, i);
            ins_hi = i;
        }
        if (pend_i >= 0) {
            // rep matches carry the same +3-byte advantage here that
            // acceptance gives them, so a pending rep isn't displaced by
            // a marginally longer fresh-distance match
            if (ok && len + (is_rep ? 3 : 0) >
                          pend_len + (pend_rep ? 3 : 0)) {
                pend_i = i; pend_len = len; pend_pos = posn;
                pend_rep = is_rep;
                i += 1;
            } else {
                emit(pend_i, pend_len, pend_pos);
            }
            continue;
        }
        if (ok) {
            if (len >= LAZY_GOOD) {
                emit(i, len, posn);
            } else {
                pend_i = i; pend_len = len; pend_pos = posn;
                pend_rep = is_rep;
                i += 1;
            }
        } else {
            // long literal deserts step faster; resets on any match so
            // compressible regions keep full resolution
            int64_t sk = miss_run++ >> 7;
            i += 1 + (sk > 3 ? 3 : sk);
        }
    }
    if (pend_i >= 0) emit(pend_i, pend_len, pend_pos);
    if (lit_start < w_end || (p0 == 0 && out.empty() && w_end >= n)) {
        out.push_back({w_end - lit_start, 0, 0});
    }
}

static void parse_window(const uint8_t* data, int64_t n, int64_t min_match,
                         int64_t w_begin, int64_t w_end, int64_t parse_from,
                         const int32_t* snapshot_head,
                         const int32_t* prev_shared,
                         std::vector<Tok>& out) {
    int64_t p0 = parse_from > w_begin ? parse_from : w_begin;
    ChainTab T(snapshot_head, prev_shared, p0, parse_from, w_end);
    parse_window_t(data, n, min_match, w_begin, w_end, parse_from, T, out);
}


}  // namespace lz

extern "C" {

// data: n bytes; emits up to cap tokens. Returns token count, or -1 when
// the token arrays would overflow (caller retries with bigger arrays).
//
// Round 3: the parse is WINDOWED and multi-threaded. One serial pass
// builds the full-data grid chain (prev_shared, ascending insertion) and
// snapshots the head table at each fixed 8M window boundary; each window
// then parses independently against its snapshot (full-prefix match
// reach) with matches capped at the window end. The window structure is
// fixed — 1 thread and 16 threads produce byte-identical token streams —
// and windows run on std::thread workers (REPAQ_LZ_THREADS overrides the
// hardware count). The serial fraction is the grid pass (~3 ns/byte).
// parse_from: bytes before it are dictionary (match source, no tokens);
// the emitted tokens cover exactly [parse_from, n).
int64_t lz_parse(const uint8_t* data, int64_t n, int64_t min_match,
                 int64_t* lit_lens, int64_t* match_lens, int64_t* dists,
                 int64_t cap, int64_t parse_from) {
    using namespace lz;
    if (parse_from < 0) parse_from = 0;
    if (n <= parse_from) {
        if (cap < 1) return -1;
        lit_lens[0] = 0; match_lens[0] = 0; dists[0] = 0;
        return 1;
    }
    int64_t nwin = (n + WINDOW - 1) / WINDOW;
    int64_t first_w = parse_from / WINDOW;

    // serial grid pass: shared prev chain + head snapshot per window.
    // Compact slot-indexed storage (see grid_slot): ~n/5 dictionary +
    // ~n/3 parse-region entries instead of one int32 per byte.
    // REPAQ_LZ_DEBUG=1: phase timing to stderr (grid build vs parse)
    struct DbgClock {
        bool on;
        std::chrono::steady_clock::time_point t0;
        DbgClock() : on(getenv("REPAQ_LZ_DEBUG") != nullptr),
                     t0(std::chrono::steady_clock::now()) {}
        double lap() {
            auto t1 = std::chrono::steady_clock::now();
            double s = std::chrono::duration<double>(t1 - t0).count();
            t0 = t1;
            return s;
        }
    } dbg;

    const int64_t jc = grid_jc(parse_from), nd = jc / 5;
    const int64_t nslots = nd + (n > jc ? (n - jc) / 3 + 1 : 0);
    std::vector<int32_t> prev_shared(nslots, -1);
    std::vector<std::vector<int32_t>> snapshots(nwin);
    {
        std::vector<int32_t> head_v(HSIZE, -1);
        int32_t* head = head_v.data();
        int64_t next_snap = 0;
        // stride-3 grid: every-position insertion makes chains ~2-5x
        // denser than the old parse-policy ones and the MAXCHAIN walks
        // proportionally slower (about half the parse speed) for ~0.1%
        // token gain; stride 3 restores the speed at negligible ratio cost
        // dictionary region (j < parse_from) gets stride 5: its chain
        // entries are cache-cold at walk time, so density there is the
        // dominant parse cost with a large history
        int64_t j = 0;
        while (j + HB <= n) {
            while (next_snap < nwin &&
                   j >= std::max(next_snap * WINDOW, parse_from)) {
                snapshots[next_snap].assign(head, head + HSIZE);
                next_snap++;
            }
            uint32_t h = hash_at(data, j);
            prev_shared[grid_slot(j, jc, nd)] = head[h];
            head[h] = (int32_t)j;
            j += (j < parse_from) ? 5 : 3;
        }
        while (next_snap < nwin) {
            snapshots[next_snap].assign(head, head + HSIZE);
            next_snap++;
        }
    }

    if (dbg.on)
        fprintf(stderr, "[lz] n=%lld from=%lld grid=%.3fs\n",
                (long long)n, (long long)parse_from, dbg.lap());

    std::vector<std::vector<Tok>> toks(nwin);
    int nthreads = (int)std::thread::hardware_concurrency();
    if (const char* env = getenv("REPAQ_LZ_THREADS")) {
        int v = atoi(env);
        if (v > 0) nthreads = v;
    }
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if ((int64_t)nthreads > nwin - first_w) nthreads = (int)(nwin - first_w);
    if (nthreads < 1) nthreads = 1;

    std::atomic<int64_t> next_w(first_w);
    auto worker = [&]() {
        for (;;) {
            int64_t w = next_w.fetch_add(1);
            if (w >= nwin) return;
            int64_t b = w * WINDOW;
            int64_t e = std::min(n, b + WINDOW);
            parse_window(data, n, min_match, b, e, parse_from,
                         snapshots[w].data(), prev_shared.data(), toks[w]);
        }
    };
    if (nthreads == 1) {
        worker();
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < nthreads; t++) ths.emplace_back(worker);
        for (auto& t : ths) t.join();
    }

    if (dbg.on)
        fprintf(stderr, "[lz]   parse=%.3fs threads=%d\n", dbg.lap(),
                nthreads);

    int64_t ntok = 0;
    for (int64_t w = first_w; w < nwin; w++) {
        for (const auto& t : toks[w]) {
            if (ntok >= cap) return -1;
            lit_lens[ntok] = t.lit;
            match_lens[ntok] = t.ml;
            dists[ntok] = t.dist;
            ntok++;
        }
    }
    if (ntok == 0) {
        if (cap < 1) return -1;
        lit_lens[0] = n - parse_from; match_lens[0] = 0; dists[0] = 0;
        ntok = 1;
    }
    return ntok;
}

// MTF rep-distance transform over a token dist sequence (both directions;
// the decoder mirrors the encoder's 4-slot move-to-front state, so the
// transform is self-contained in the token stream — no window coupling).
// Codes: 0..3 = recent-distance slot, d+4 = fresh distance d. Tokens with
// match_len == 0 carry no distance and are skipped. In-place.
void lz_dist_mtf(int64_t* dd, const int64_t* ml, int64_t ntok, int encode) {
    int64_t slots[4] = {0, 0, 0, 0};
    for (int64_t t = 0; t < ntok; t++) {
        if (ml[t] == 0) continue;
        int64_t d;
        if (encode) {
            d = dd[t];
            int hit = -1;
            for (int r = 0; r < 4; r++) {
                if (slots[r] == d) { hit = r; break; }
            }
            dd[t] = hit >= 0 ? hit : d + 4;
        } else {
            int64_t v = dd[t];
            d = (v < 4) ? slots[v] : v - 4;
            dd[t] = d;
        }
        int upto = 3;
        for (int r = 0; r < 4; r++) {
            if (slots[r] == d) { upto = r; break; }
        }
        for (int r = upto; r > 0; r--) slots[r] = slots[r - 1];
        slots[0] = d;
    }
}

// Expand tokens back: literals come from `lits`, matches copy from the
// already-produced output (overlapping copies byte-by-byte, LZ77 rules).
// Returns bytes produced, or -1 on malformed input (OOB dist/overrun).
// start: expansion begins at out[start]; out[0:start) is a pre-filled
// dictionary that match distances may reach into. Returns bytes produced
// AFTER start, or -1 on malformed input.
int64_t lz_expand(const int64_t* lit_lens, const int64_t* match_lens,
                  const int64_t* dists, int64_t ntok, const uint8_t* lits,
                  int64_t nlits, uint8_t* out, int64_t out_cap,
                  int64_t start) {
    int64_t o = start, lp = 0;
    for (int64_t t = 0; t < ntok; t++) {
        int64_t ll = lit_lens[t], ml = match_lens[t], d = dists[t];
        if (ll < 0 || ml < 0 || lp + ll > nlits || o + ll + ml > out_cap)
            return -1;
        memcpy(out + o, lits + lp, ll);
        lp += ll;
        o += ll;
        if (ml) {
            if (d <= 0 || d > o) return -1;
            const uint8_t* src = out + o - d;
            uint8_t* dst = out + o;
            if (d >= ml) {
                memcpy(dst, src, ml);
            } else {
                for (int64_t j = 0; j < ml; j++) dst[j] = src[j];
            }
            o += ml;
        }
    }
    return o - start;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Illumina name parsing (reference fastqmeta.cpp:22-80), one pass per name.
// Exact port of the scalar state machine in repaq_tpu/meta.py (including
// the overwrite behaviors for 4-6 colons followed by a space); cross-
// checked against both the scalar and the numpy event-algebra parsers in
// tests/test_vectorized.py.
// ---------------------------------------------------------------------------

extern "C" {

static int64_t atoi_span_one(const uint8_t* flat, int64_t i, int64_t e) {
    const int64_t I64MAX = 0x7FFFFFFFFFFFFFFFLL;
    while (i < e) {
        uint8_t c = flat[i];
        if (c == ' ' || (c >= '\t' && c <= '\r')) i++;
        else break;
    }
    int sign = 1;
    if (i < e && (flat[i] == '+' || flat[i] == '-')) {
        if (flat[i] == '-') sign = -1;
        i++;
    }
    uint64_t acc = 0;
    unsigned __int128 mag = 0;
    const unsigned __int128 CLAMP = ((unsigned __int128)1) << 70;
    while (i < e && flat[i] >= '0' && flat[i] <= '9') {
        uint32_t d = flat[i] - '0';
        acc = acc * 10u + d;
        if (mag < CLAMP) mag = mag * 10 + d;
        i++;
    }
    uint32_t low;
    if (sign > 0 && mag > (unsigned __int128)I64MAX) {
        low = 0xFFFFFFFFu;  // INT64_MAX truncated to int32 = -1
    } else if (sign > 0) {
        low = (uint32_t)acc;
    } else {
        low = (uint32_t)(0u - (uint32_t)acc);
    }
    return (int64_t)(int32_t)low;
}

// out: (n, 9) int64 rows =
//   [illumina, lane, tile, x, y, name1_start, name1_len, name2_start,
//    name2_len]; starts absolute into flat.
void parse_names_batch(const uint8_t* flat, const int64_t* off, int64_t n,
                       int64_t* out) {
    for (int64_t k = 0; k < n; k++) {
        int64_t s = off[k], e = off[k + 1];
        int64_t len = e - s;
        int colon = 0;
        int64_t last_colon_pos = 0;
        int64_t coords_start_at = 0, coords_end_at = 0;
        int64_t lane = 0, tile = 0, x = 0, y = 0;
#ifdef REPAQ_AVX512_VBMI
        if (len <= 64) {
            // one masked load + two compares give every ':' / ' ' event;
            // the state machine then steps event to event instead of
            // byte to byte (identical decisions to the scalar loop)
            __mmask64 valid = len == 64 ? ~0ULL : ((1ULL << len) - 1);
            __m512i v = _mm512_maskz_loadu_epi8(valid, flat + s);
            __mmask64 mc = _mm512_mask_cmpeq_epi8_mask(
                valid, v, _mm512_set1_epi8(':'));
            __mmask64 msp = _mm512_mask_cmpeq_epi8_mask(
                valid, v, _mm512_set1_epi8(' '));
            __mmask64 ev = mc | msp;
            while (ev) {
                int64_t i = __builtin_ctzll((unsigned long long)ev);
                int is_colon = (mc >> i) & 1;
                if (is_colon) colon++;
                if (colon >= 4 && colon <= 7) {
                    int64_t val = atoi_span_one(
                        flat, s + last_colon_pos + 1, s + i);
                    if (is_colon) {
                        if (colon == 4) {
                            lane = val;
                            coords_start_at = last_colon_pos + 1;
                        } else if (colon == 5) {
                            tile = val;
                        } else if (colon == 6) {
                            x = val;
                        } else if (colon == 7) {
                            y = val;
                        }
                    } else {
                        if (colon == 4) {
                            lane = val;
                            coords_start_at = last_colon_pos + 1;
                        } else if (colon == 5) {
                            tile = val;
                        } else if (colon == 6) {
                            y = val;
                        } else if (colon == 7) {
                            y = val;
                        }
                    }
                }
                if (is_colon) last_colon_pos = i;
                if (!is_colon || colon == 7) {
                    coords_end_at = i;
                    break;
                }
                ev &= ev - 1;
            }
            goto emit;
        }
#endif
        for (int64_t i = 0; i < len; i++) {
            uint8_t c = flat[s + i];
            int is_colon = c == ':';
            int is_space = c == ' ';
            if (is_colon) colon++;
            if (is_colon || is_space) {
                if (colon >= 4 && colon <= 7) {
                    int64_t val = atoi_span_one(
                        flat, s + last_colon_pos + 1, s + i);
                    if (colon == 4) {
                        lane = val;
                        coords_start_at = last_colon_pos + 1;
                    } else if (colon == 5) {
                        tile = val;
                    } else if (colon == 6) {
                        if (is_colon) x = val;
                    } else if (colon == 7) {
                        y = val;
                    }
                    if (is_space && colon == 6) y = val;
                }
            }
            if (is_colon) last_colon_pos = i;
            if (is_space || (is_colon && colon == 7)) {
                coords_end_at = i;
                break;
            }
        }
#ifdef REPAQ_AVX512_VBMI
    emit:;
#endif
        int64_t* row = out + 9 * k;
        if (coords_start_at > 0 && coords_end_at > 0) {
            row[0] = 1;
            row[1] = lane & 0xFF;
            row[2] = tile & 0xFFFF;
            row[3] = x & 0xFFFFFFFFLL;
            row[4] = y & 0xFFFFFFFFLL;
            row[5] = s;
            row[6] = coords_start_at - 1;
            row[7] = s + coords_end_at;
            row[8] = e - (s + coords_end_at);
        } else {
            row[0] = 0;
            row[1] = row[2] = row[3] = row[4] = 0;
            row[5] = s;
            row[6] = len;
            row[7] = e;
            row[8] = 0;
        }
    }
}

}  // extern "C"
