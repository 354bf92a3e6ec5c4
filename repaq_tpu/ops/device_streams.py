"""JAX device kernels for the .rfq token coders (encode side).

Everything here is jit-compatible, static-shape, and byte-exact with the
host kernels in repaq_tpu.codec.kernels_np (cross-checked in
tests/test_device.py). The sequential reference coders are reformulated as
data-parallel passes:

- run segmentation via cummax / suffix-cummin scans,
- per-element token byte counts + prefix sums for output offsets,
- byte emission as a GATHER over the output index space (for output slot k,
  binary-search the emitting element and byte lane), so compaction is
  expressed as out[k] = planes[element(k), lane(k)] instead of
  out.at[off].set(...).

Output buffers are padded to static shapes; true lengths are returned as
scalars and compact prefixes are fetched with the int32-bitcast helper in
repaq_tpu.ops.transfer so device->host traffic stays proportional to the
compressed size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _exclusive_cumsum(x):
    c = jnp.cumsum(x)
    return c, (c[-1] if x.shape[0] else jnp.int32(0))  # inclusive, total


def _cummax(x):
    return jax.lax.cummax(x)


def _suffix_min(x):
    return jnp.flip(jax.lax.cummin(jnp.flip(x)))


# emission layout-sort strategy threshold: outputs below this pack
# (offset << 8 | byte) into one int32 key; at or above it the offsets ride
# a two-operand lax.sort (tests lower it to force the wide path on small
# fixtures)
_WIDE_THRESHOLD = 1 << 23


def _sorted_stream(offs: list, bytes_: list, out_size: int, total,
                   wide: bool):
    """Shared tail of the emission compactors: lay candidate bytes out by
    destination offset with ONE sort and slice the stream prefix.

    offs/bytes_: matching lists of i32 offset / i32 byte arrays (invalid
    lanes carry offset INT32_MAX). wide=False packs (offset << 8 | byte)
    into one int32 key (out_size must stay < 2^23); wide=True runs a
    two-operand lax.sort with the byte as payload — ~25% more sort
    traffic, but offsets range to 2^31, which is what lets encode blocks
    grow past 8 MB of output."""
    inf = jnp.int32(2**31 - 1)
    if not wide:
        keys = jnp.concatenate([
            jnp.where(o == inf, inf, (o << 8) | b)
            for o, b in zip(offs, bytes_)
        ]) if len(offs) > 1 else jnp.where(
            offs[0] == inf, inf, (offs[0] << 8) | bytes_[0]
        )
        srt = jnp.sort(keys)
        if srt.shape[0] < out_size:
            srt = jnp.concatenate(
                [srt, jnp.full(out_size - srt.shape[0], inf, jnp.int32)]
            )
        vals = srt[:out_size] & 0xFF
    else:
        all_off = offs[0] if len(offs) == 1 else jnp.concatenate(offs)
        all_b = bytes_[0] if len(bytes_) == 1 else jnp.concatenate(bytes_)
        so, sb = jax.lax.sort((all_off, all_b), num_keys=1)
        if so.shape[0] < out_size:
            sb = jnp.concatenate(
                [sb, jnp.zeros(out_size - sb.shape[0], sb.dtype)]
            )
        vals = sb[:out_size] & 0xFF
    k = jnp.arange(out_size, dtype=jnp.int32)
    return jnp.where(k < total, vals, 0).astype(jnp.uint8), total


def _emit_sort(planes: jnp.ndarray, counts: jnp.ndarray, out_size: int,
               offsets: jnp.ndarray | None = None,
               total: jnp.ndarray | None = None,
               multi_cap: int | None = None,
               extra_keys: jnp.ndarray | None = None):
    """Sort-based stream compaction for variable-width token emission:
    each candidate byte is keyed by its dest offset (packed
    (offset << 8 | byte) below 2^23 output bytes; a two-operand lax.sort
    beyond — see _sorted_stream), one sort lays the stream out, and the
    prefix is the stream.

    The sort is the dominant cost, so its key count is kept near n instead
    of n*W: every element contributes at most its FIRST byte as a dense
    key; elements emitting >=2 bytes are compacted (sort-slice with a
    static bound) and contribute their remaining W-1 lanes from the small
    compacted set. multi_cap must be a TRUE upper bound on the number of
    multi-byte elements — for the gap coders it is structural: a 2-byte gap
    token consumes >128 positions of span, so there are < n/128 of them
    per stream (see callers).

    planes: (n, W) uint8 candidate bytes; counts: (n,) int32 emitted bytes
    per element (0..W); offsets: optional precomputed per-element dest
    offsets (exclusive prefix sum of counts when None). extra_keys:
    optional extra pre-built (offset<<8|byte) keys to interleave (e.g. a
    length table; their offsets must stay < 2^23 — true for the tiny
    tables that use this hook). Returns (out, total_len).
    """
    n, w = planes.shape
    wide = out_size >= _WIDE_THRESHOLD
    assert out_size < (1 << 30), "emission output beyond int32 offsets"
    explicit_total = total is not None
    if offsets is None:
        cum, derived = _exclusive_cumsum(counts)
        offsets = cum - counts
        if not explicit_total:
            total = derived
    elif not explicit_total:
        total = offsets[-1] + counts[-1] if n else jnp.int32(0)
    inf = jnp.int32(2**31 - 1)
    offs = [jnp.where(counts >= 1, offsets, inf)]
    bytes_ = [planes[:, 0].astype(jnp.int32)]
    if multi_cap is None:
        multi_cap = n
    multi_cap = min(multi_cap, n)
    if w > 1 and multi_cap > 0:
        # compact multi-byte elements by sort-slice
        i_n = jnp.arange(n, dtype=jnp.int32)
        midx = jnp.sort(jnp.where(counts >= 2, i_n, jnp.int32(n)))[:multi_cap]
        mcounts = jnp.concatenate([counts, jnp.zeros(1, jnp.int32)])[midx]
        moff = jnp.concatenate([offsets, jnp.zeros(1, offsets.dtype)])[midx]
        mplanes = jnp.concatenate(
            [planes, jnp.zeros((1, w), planes.dtype)]
        )[midx]
        lanes = jnp.arange(1, w, dtype=jnp.int32)[None, :]
        mvalid = lanes < mcounts[:, None]
        offs.append(
            jnp.where(mvalid, moff[:, None] + lanes, inf).reshape(-1)
        )
        bytes_.append(mplanes[:, 1:].astype(jnp.int32).reshape(-1))
    if extra_keys is not None:
        inf_mask = extra_keys == inf
        offs.append(jnp.where(inf_mask, inf, extra_keys >> 8))
        bytes_.append(extra_keys & 0xFF)
        if not explicit_total:
            total = total + extra_keys.shape[0]
    return _sorted_stream(offs, bytes_, out_size, total, wide)


_emit_gather = _emit_sort  # compaction strategy alias


def _emit_sort_pay(b0: jnp.ndarray, counts: jnp.ndarray, out_size: int,
                   offsets: jnp.ndarray, total, multi_cap: int,
                   fields: jnp.ndarray, w: int,
                   extra=None,
                   first_mask: jnp.ndarray | None = None):
    """_emit_sort_lazy with the multi-byte token FIELDS carried through
    the compaction sort as a payload operand instead of gathered
    afterwards (the lazy path's five ~multi_cap-sized gathers become one
    two-operand lax.sort).

    fields: (n,) int32 = (delta << 2) | ttype for gap/run tokens —
    everything the tail lanes need (ttype 0/1/2 = 1/2/4-byte token).
    Elements with counts >= 2 are compacted by sorting (key = dest
    offset, payload = fields); tail byte values and lane offsets are then
    pure elementwise functions of the sorted pair. Token order within
    the compacted set is dest order — irrelevant, every byte lands at an
    absolute offset. Escape tokens (5-byte, ttype 3) are NOT supported
    here — callers with escapes use _emit_sort_lazy."""
    wide = out_size >= _WIDE_THRESHOLD
    assert out_size < (1 << 30), "emission output beyond int32 offsets"
    inf = jnp.int32(2**31 - 1)
    n = b0.shape[0]
    multi_cap = max(1, min(multi_cap, n))
    first = counts >= 1 if first_mask is None else first_mask
    mkey = jnp.where(counts >= 2, offsets, inf)
    skey, sfield = jax.lax.sort((mkey, fields), num_keys=1)
    skey = skey[:multi_cap]
    sfield = sfield[:multi_cap]
    svalid = skey < inf
    st = sfield & 3
    v = (sfield >> 2) - 1
    scount = jnp.where(st == 1, 2, jnp.where(st == 2, 4, 1))
    b1 = jnp.where(st == 1, v & 0xFF,
                   jnp.where(st == 2, (v >> 16) & 0xFF, 0))
    b2 = jnp.where(st == 2, (v >> 8) & 0xFF, 0)
    b3 = jnp.where(st == 2, v & 0xFF, 0)
    lanes = jnp.arange(1, w, dtype=jnp.int32)[None, :]
    mvalid = svalid[:, None] & (lanes < scount[:, None])
    offs = [jnp.where(first, offsets, inf),
            jnp.where(mvalid, skey[:, None] + lanes, inf).reshape(-1)]
    tail_bytes = jnp.stack([b1, b2, b3][: w - 1], axis=1)
    bytes_ = [b0.astype(jnp.int32), tail_bytes.reshape(-1)]
    if extra is not None:
        offs.insert(0, extra[0])
        bytes_.insert(0, extra[1])
    return _sorted_stream(offs, bytes_, out_size, total, wide)


def _emit_sort_lazy(b0: jnp.ndarray, counts: jnp.ndarray, out_size: int,
                    offsets: jnp.ndarray, total, multi_cap: int,
                    tail_fn, w: int,
                    extra=None,
                    first_mask: jnp.ndarray | None = None):
    """_emit_sort without ever materializing dense (n, W) byte planes.

    The dense pass computes only each element's FIRST byte (b0) — one fused
    elementwise chain. Elements emitting >= 2 bytes are compacted by
    sort-slice to multi_cap entries and their remaining lanes come from
    tail_fn(midx) -> (multi_cap, w-1) int32 planes computed from a handful
    of small gathers. Cuts the HBM traffic of the emission stage from
    ~W passes over n to ~2.

    extra: optional (e_off i32, e_byte i32) arrays of extra bytes to
    interleave (length tables, escape records); invalid entries carry
    offset INT32_MAX. out_size >= 2^23 switches the layout sort to the
    two-operand form (offsets past the packed-key range — see
    _sorted_stream).
    """
    n = b0.shape[0]
    wide = out_size >= _WIDE_THRESHOLD
    assert out_size < (1 << 30), "emission output beyond int32 offsets"
    inf = jnp.int32(2**31 - 1)
    first = counts >= 1 if first_mask is None else first_mask
    multi_cap = max(1, min(multi_cap, n))
    i_n = jnp.arange(n, dtype=jnp.int32)
    midx = jnp.sort(jnp.where(counts >= 2, i_n, jnp.int32(n)))[:multi_cap]
    mcounts = jnp.concatenate([counts, jnp.zeros(1, jnp.int32)])[midx]
    moff = jnp.concatenate([offsets, jnp.zeros(1, offsets.dtype)])[midx]
    tail = tail_fn(midx)  # (multi_cap, w-1) int32
    lanes = jnp.arange(1, w, dtype=jnp.int32)[None, :]
    mvalid = lanes < mcounts[:, None]
    offs = [jnp.where(first, offsets, inf),
            jnp.where(mvalid, moff[:, None] + lanes, inf).reshape(-1)]
    bytes_ = [b0.astype(jnp.int32), tail.reshape(-1)]
    if extra is not None:
        offs.insert(0, extra[0])
        bytes_.insert(0, extra[1])
    return _sorted_stream(offs, bytes_, out_size, total, wide)


def _gather1(arr: jnp.ndarray, idx: jnp.ndarray, fill=0):
    """Gather with one sentinel row appended (idx == len(arr) -> fill)."""
    ext = jnp.concatenate([arr, jnp.full(1, fill, arr.dtype)])
    return ext[idx]


def _classify_stream_positions(g_pos: jnp.ndarray, seg_start: jnp.ndarray,
                               is_stream: jnp.ndarray):
    """Gap/run token classification (reference rfqcodec.cpp:625-710) over
    grouped match positions.

    g_pos: (m,) match positions, increasing within each segment; seg_start
    marks each segment's first element (the coder state `last` restarts at
    -1 there); is_stream masks real stream elements (False entries emit
    nothing). Returns (delta, emits_run, covered, g1, g2, g4).
    """
    m = g_pos.shape[0]
    i = jnp.arange(m, dtype=jnp.int32)
    prev_pos = jnp.concatenate([jnp.array([-1], dtype=jnp.int32), g_pos[:-1]])
    delta = jnp.where(seg_start, g_pos + 1, g_pos - prev_pos)
    adj = is_stream & (delta == 1) & (g_pos > 1)
    adj_prev = jnp.concatenate([jnp.array([False]), adj[:-1]])
    run_start = adj & ~adj_prev
    rs_idx = _cummax(jnp.where(run_start, i, -1))
    off_in_run = jnp.where(adj, i - rs_idx, 0)
    nonadj_pos = jnp.where(~adj, i, m)
    end_idx = _suffix_min(nonadj_pos)
    run_len = jnp.where(adj, end_idx - rs_idx, 0)
    emits_run = adj & (off_in_run % 32 == 0)
    covered = jnp.minimum(32, run_len - off_in_run)
    gap = is_stream & ~adj
    g1 = gap & (delta <= 128)
    g2 = gap & (delta > 128) & (delta <= (1 << 14))
    g4 = gap & (delta > (1 << 14))
    return delta, emits_run, covered, g1, g2, g4


def _stream_b0(delta, emits_run, covered, g1, g2, g4):
    """(b0 (m,) i32 first token byte, counts (m,) i32, ttype (m,) i32) for
    pure gap/run streams; ttype: 0 = 1-byte, 1 = 2-byte gap, 2 = 4-byte."""
    counts = (
        g1.astype(jnp.int32)
        + 2 * g2.astype(jnp.int32)
        + 4 * g4.astype(jnp.int32)
        + emits_run.astype(jnp.int32)
    )
    v = delta - 1
    b0 = jnp.where(
        g1,
        v,
        jnp.where(
            g2,
            (v >> 8) | 0x80,
            jnp.where(
                g4,
                (v >> 24) | 0xE0,
                jnp.where(emits_run, (covered - 1) | 0xC0, 0),
            ),
        ),
    ).astype(jnp.int32)
    ttype = jnp.where(g2, 1, jnp.where(g4, 2, 0)).astype(jnp.int32)
    return b0, counts, ttype


def _stream_tail_fn(delta, ttype):
    """tail_fn for _emit_sort_lazy over pure gap/run streams (lanes 1-3)."""

    def tail(midx):
        t = _gather1(ttype, midx)
        v = _gather1(delta, midx) - 1
        b1 = jnp.where(t == 1, v & 0xFF, jnp.where(t == 2, (v >> 16) & 0xFF, 0))
        b2 = jnp.where(t == 2, (v >> 8) & 0xFF, 0)
        b3 = jnp.where(t == 2, v & 0xFF, 0)
        return jnp.stack([b1, b2, b3], axis=1).astype(jnp.int32)

    return tail


def encode_positions_from_mask(mask: jnp.ndarray, out_size: int,
                               pos_cap: int | None = None):
    """Gap/run stream for the True positions of mask; (out, length).

    pos_cap: static upper bound on the number of True positions. Defaults
    to n (always safe). The N-position stream is typically ~1% dense, so a
    tight bound (exact count is known host-side) shrinks every downstream
    pass from n to pos_cap. multi_cap is structural: a 2-byte token has gap
    delta >= 129 and a 4-byte one >= 16385; deltas sum to <= n, so there
    are < n/64 multi-byte tokens."""
    n = mask.shape[0]
    if pos_cap is None:
        pos_cap = n
    pos_cap = max(1, min(pos_cap, n))
    i = jnp.arange(pos_cap, dtype=jnp.int32)
    if n % 4 == 0 and pos_cap * 8 < n:
        # sparse mask: compact at 4-byte WORD granularity first, so the
        # big sort runs over n/4 keys instead of n (the N mask is ~0.1%
        # dense on real data). Each set byte lands in a distinct
        # word at worst, so pos_cap words cover pos_cap positions.
        m4 = mask.reshape(-1, 4)
        nw = m4.shape[0]
        i_w = jnp.arange(nw, dtype=jnp.int32)
        widx = jnp.sort(jnp.where(m4.any(axis=1), i_w, jnp.int32(nw)))
        widx = widx[:pos_cap]
        mb = jnp.concatenate([m4, jnp.zeros((1, 4), m4.dtype)])[widx]
        cand = widx[:, None] * 4 + jnp.arange(4, dtype=jnp.int32)[None, :]
        keys = jnp.where(mb, cand, jnp.int32(n)).reshape(-1)
        g_pos = jnp.sort(keys)[:pos_cap]
    else:
        i_n = jnp.arange(n, dtype=jnp.int32)
        g_pos = jnp.sort(jnp.where(mask, i_n, jnp.int32(n)))[:pos_cap]
    return _positions_from_gpos(g_pos, n, out_size, pos_cap)


def _positions_from_gpos(g_pos, n: int, out_size: int, pos_cap: int):
    """Shared tail of the position-stream encoders: classify the sorted
    (pos_cap,) candidate positions (n = invalid fill) and emit."""
    i = jnp.arange(pos_cap, dtype=jnp.int32)
    is_stream = g_pos < n
    seg_start = i == 0
    delta, emits_run, covered, g1, g2, g4 = _classify_stream_positions(
        g_pos, seg_start, is_stream
    )
    b0, counts, ttype = _stream_b0(delta, emits_run, covered, g1, g2, g4)
    cum, total = _exclusive_cumsum(counts)
    return _emit_sort_pay(
        b0, counts, out_size, cum - counts, total,
        min(pos_cap, n // 64 + 4), fields=(delta << 2) | ttype, w=4,
    )


def encode_positions_from_meta32(meta32: jnp.ndarray, n: int, out_size: int,
                                 pos_cap: int | None = None):
    """encode_positions_from_mask over the frontend's word-packed meta
    stream (bit 7 of each byte = N flag) — no byte-level relayout; the
    word compaction tests all four flag bits with one AND."""
    nw = meta32.shape[0]
    if pos_cap is None:
        pos_cap = n
    pos_cap = max(1, min(pos_cap, n))
    # compaction granularity: a GROUP of 4 words (16 bases) when the mask
    # is very sparse — the compaction sort then runs over nw/4 keys
    # instead of nw; groups containing an N <= npos <=
    # pos_cap, so a pos_cap-group slice never drops one (same argument
    # as the word granularity)
    if nw % 4 == 0 and 32 * pos_cap < n:
        ng = nw // 4
        m4 = meta32.reshape(ng, 4)
        i_g = jnp.arange(ng, dtype=jnp.int32)
        has_g = ((m4 & jnp.uint32(0x80808080)) != 0).any(axis=1)
        gidx = jnp.sort(jnp.where(has_g, i_g, jnp.int32(ng)))[:pos_cap]
        mg = jnp.concatenate([m4, jnp.zeros((1, 4), m4.dtype)])[gidx]
        lanes = jnp.arange(16, dtype=jnp.int32)[None, :]
        mb = ((mg[:, lanes[0] // 4] >> (8 * (lanes % 4) + 7)) & 1) == 1
        cand = gidx[:, None] * 16 + lanes
        keys = jnp.where(mb & (cand < n), cand, jnp.int32(n)).reshape(-1)
        g_pos = jnp.sort(keys)[:pos_cap]
        return _positions_from_gpos(g_pos, n, out_size, pos_cap)
    i_w = jnp.arange(nw, dtype=jnp.int32)
    has = (meta32 & jnp.uint32(0x80808080)) != 0
    widx = jnp.sort(jnp.where(has, i_w, jnp.int32(nw)))[:pos_cap]
    mw = jnp.concatenate([meta32, jnp.zeros(1, meta32.dtype)])[widx]
    lanes = jnp.arange(4, dtype=jnp.int32)[None, :]
    mb = ((mw[:, None] >> (8 * lanes + 7)) & 1) == 1
    cand = widx[:, None] * 4 + lanes
    keys = jnp.where(mb & (cand < n), cand, jnp.int32(n)).reshape(-1)
    g_pos = jnp.sort(keys)[:pos_cap]
    return _positions_from_gpos(g_pos, n, out_size, pos_cap)


def qualcol_encode_device(qual: jnp.ndarray, bins: jnp.ndarray, major: jnp.ndarray,
                          in_table: jnp.ndarray, esc_cap: int | None = None,
                          nonmajor_cap: int | None = None,
                          out_size: int | None = None,
                          meta32: jnp.ndarray | None = None,
                          qual32: jnp.ndarray | None = None,
                          n: int | None = None):
    """Full by-column quality encode (reference rfqcodec.cpp:712-765):
    u32le per-bin lengths, concatenated per-bin streams, 5-byte escape
    records — compacted on device in one gather pass.

    qual: (n,) uint8; bins: (B,) uint8 (static B); in_table: (256,) bool.
    esc_cap: static upper bound on the number of escape records (quality
    chars outside the header table). nonmajor_cap: static upper bound on
    positions whose qual is NOT the major qual (those are the only ones
    that emit anything). Both default to n (always safe); callers that
    know exact counts (the host computes both from the chunk histogram in
    one pass) should pass tight bucketed bounds — the grouping sort,
    classification scans, and emission sort all shrink from n to
    nonmajor_cap (typically 20-50% of n for Illumina data).
    Word-packed path: meta32/qual32/n — the frontend's word-packed meta
    stream (encode_frontend_meta32). Grouping-sort keys are built per
    byte LANE of the u32 words (4 fused planes + concat, order-free ahead
    of the sort), so no byte-level relayout is materialized.
    Returns (out: (4B + n + 8,) uint8, total_len).
    """
    if n is None:
        n = qual.shape[0]
    nbins = bins.shape[0]
    if esc_cap is None:
        esc_cap = n
    if nonmajor_cap is None:
        nonmajor_cap = n
    nonmajor_cap = max(1, min(nonmajor_cap, n))

    # ONE sort both groups the emitting positions (bid <= B) by bin AND
    # compacts away the major-qual ones: key = bid << 24 | pos, major
    # pushed to +inf, then slice the first nonmajor_cap entries. The
    # power-of-two stride keeps the unpack to shifts/ands. 24 position
    # bits + 7 bin bits fill int32 exactly (bid <= nbins+1 < 127), so
    # blocks reach 16 Mbase (emission offsets ride the two-operand sort
    # beyond 2^23).
    m = nonmajor_cap
    assert n < (1 << 24) and nbins + 2 < 127, (
        "qualcol device path needs n < 2^24 (the bid<<24|pos key "
        "packing); split the block"
    )
    i = jnp.arange(m, dtype=jnp.int32)
    if meta32 is not None:
        j4 = 4 * jnp.arange(meta32.shape[0], dtype=jnp.int32)
        planes = []
        for k in range(4):
            bid_k = ((meta32 >> (8 * k)) & 0x7F).astype(jnp.int32)
            pos_k = j4 + k
            planes.append(jnp.where(
                (bid_k <= nbins) & (pos_k < n),
                (bid_k << 24) | pos_k, jnp.int32(2**31 - 1),
            ))
        keys_g = jnp.concatenate(planes)
    else:
        # LUT: qual byte -> bin ordinal; escapes get pseudo-bin B (they
        # follow the streams in wire order), the major qual gets B+1
        # (dropped)
        bin_idx = jnp.where(
            in_table, jnp.int32(nbins + 1), jnp.int32(nbins)
        )
        bin_idx = bin_idx.at[bins].set(jnp.arange(nbins, dtype=jnp.int32))
        bid = bin_idx[qual]  # 0..B-1 stream, B escape, B+1 major
        i_n = jnp.arange(n, dtype=jnp.int32)
        keys_g = jnp.where(
            bid <= nbins, (bid.astype(jnp.int32) << 24) | i_n,
            jnp.int32(2**31 - 1),
        )
    grouped = jnp.sort(keys_g)[:m]
    g_bid = grouped >> 24  # fill entries -> > nbins
    g_pos = grouped & ((1 << 24) - 1)
    is_stream = g_bid < nbins
    is_esc = g_bid == nbins

    seg_start = jnp.concatenate(
        [jnp.array([True]), g_bid[1:] != g_bid[:-1]]
    )
    delta, emits_run, covered, g1, g2, g4 = _classify_stream_positions(
        g_pos, seg_start, is_stream
    )

    b0, counts, ttype = _stream_b0(delta, emits_run, covered, g1, g2, g4)
    counts = counts + 5 * is_esc.astype(jnp.int32)
    ttype = jnp.where(is_esc, 3, ttype)

    # destinations: bins (then escapes) are grouped contiguously in wire
    # order, so the global exclusive prefix sum of counts IS the stream
    # offset after the 4B length table
    cum = jnp.cumsum(counts)
    dest = 4 * nbins + (cum - counts)
    total = 4 * nbins + (cum[-1] if m else 0)

    # escape records start with the raw qual char — gather it only for the
    # (rare) escapes rather than densely; their first-byte keys join the
    # extras, their position bytes flow through the multi-byte tail path.
    # esc_cap == 0 (host PROVED no out-of-table quals in this chunk, the
    # common case) skips the whole compaction sort.
    if esc_cap == 0:
        esc_off = jnp.zeros(0, dtype=jnp.int32)
        esc_byte = jnp.zeros(0, dtype=jnp.int32)
    else:
        i_m = jnp.arange(m, dtype=jnp.int32)
        eidx = jnp.sort(jnp.where(is_esc, i_m, jnp.int32(m)))[
            : max(1, min(esc_cap, m))
        ]
        e_pos = _gather1(g_pos, eidx, fill=0)
        e_dest = _gather1(dest, eidx, fill=-1)
        e_valid = _gather1(is_esc.astype(jnp.int32), eidx) == 1
        if meta32 is not None:
            ep = jnp.clip(e_pos, 0, n - 1)
            ew = qual32[ep >> 2]
            esc_byte = ((ew >> (8 * (ep & 3))) & 0xFF).astype(jnp.int32)
        else:
            esc_byte = qual[jnp.clip(e_pos, 0, n - 1)].astype(jnp.int32)
        esc_off = jnp.where(e_valid, e_dest, jnp.int32(2**31 - 1))

    def tail(midx):
        t = _gather1(ttype, midx)
        v = _gather1(delta, midx) - 1
        p = _gather1(g_pos, midx)
        b1 = jnp.where(
            t == 1, v & 0xFF,
            jnp.where(t == 2, (v >> 16) & 0xFF,
                      jnp.where(t == 3, p & 0xFF, 0)),
        )
        b2 = jnp.where(
            t == 2, (v >> 8) & 0xFF, jnp.where(t == 3, (p >> 8) & 0xFF, 0)
        )
        b3 = jnp.where(
            t == 2, v & 0xFF, jnp.where(t == 3, (p >> 16) & 0xFF, 0)
        )
        if esc_cap == 0:
            # no escape records: tokens max out at 4-byte gaps (3 tail
            # lanes); the 5th byte lane only ever carries escape positions
            return jnp.stack([b1, b2, b3], axis=1).astype(jnp.int32)
        b4 = jnp.where(t == 3, (p >> 24) & 0xFF, 0)
        return jnp.stack([b1, b2, b3, b4], axis=1).astype(jnp.int32)

    # per-bin lengths for the u32le table. g_bid is SORTED (the grouping
    # sort), so each bin is a contiguous run: its byte length is a
    # difference of the counts prefix sum at the run boundaries — two
    # tiny gathers instead of segment_sum's scatter-add over m
    bounds = jnp.searchsorted(
        g_bid, jnp.arange(nbins + 1, dtype=g_bid.dtype), side="left"
    )
    cumz = jnp.concatenate([jnp.zeros(1, cum.dtype), cum])
    lens = cumz[bounds[1:]] - cumz[bounds[:-1]]
    lens_u32 = lens.astype(jnp.uint32)
    hdr = jnp.stack(
        [lens_u32 & 0xFF, (lens_u32 >> 8) & 0xFF,
         (lens_u32 >> 16) & 0xFF, (lens_u32 >> 24) & 0xFF],
        axis=1,
    ).astype(jnp.int32).reshape(-1)
    hdr_off = jnp.arange(4 * nbins, dtype=jnp.int32)

    # structural bound on multi-byte elements: per bin the gap deltas sum
    # to <= n, so 2-byte gaps (< n/128 per bin) and 4-byte gaps
    # (< n/16384 per bin) are rare; escapes (5-byte) are bounded by
    # esc_cap (exact count known host-side; defaults to n = fully
    # general). esc_cap == 0 (the common host-proven case) also drops the
    # emission width to the 4-byte gap-token max — fewer tail lanes in
    # the layout sort.
    multi_cap = min(
        nonmajor_cap,
        nbins * (n // 128 + n // 16384 + 8) + esc_cap,
    )
    w = 4 if esc_cap == 0 else 5
    if out_size is None:
        out_size = 4 * nbins + n + 8
    # callers with an exact host-side stream-size bound (the engine's
    # qfetch) shrink the emission buffer from ~n to the compressed size
    if esc_cap == 0:
        # no escapes (the host-proven common case): the multi-byte fields
        # ride the compaction sort as payload — no serializing gathers
        out, _ = _emit_sort_pay(
            b0, counts, out_size, dest, total, multi_cap,
            fields=(delta << 2) | ttype, w=w,
            extra=(hdr_off, hdr),
            first_mask=counts >= 1,
        )
        return out, total
    out, _ = _emit_sort_lazy(
        b0, counts, out_size, dest, total, multi_cap, tail, w=w,
        extra=(jnp.concatenate([hdr_off, esc_off]),
               jnp.concatenate([hdr, esc_byte])),
        first_mask=(counts >= 1) & ~is_esc,
    )
    return out, total


def coords_encode_device(values: jnp.ndarray, out_size: int,
                         n_valid: jnp.ndarray | None = None):
    """Coordinate coder (reference rfqcodec.cpp:1262-1330) on device.
    values: (n,) int32; out_size >= 3n + 8. n_valid: optional traced count
    of real entries — entries at i >= n_valid emit nothing and terminate
    repeat runs, so one compiled shape serves any chunk size up to n
    (the production engine pads to bucketed shapes). Returns (out, length).
    """
    n = values.shape[0]
    v = values.astype(jnp.int32)
    i = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.array([1000], dtype=jnp.int32), v[:-1]])
    diff = v - prev
    is_rep = diff == 0
    is_delta = (diff > 0) & (diff <= 64)
    is_abs2 = ~is_rep & ~is_delta & (v <= 32767)
    is_abs3 = ~is_rep & ~is_delta & (v > 32767)
    if n_valid is not None:
        valid = i < n_valid
        # padded entries must not extend a trailing repeat run (is_rep
        # False makes them run boundaries) nor emit any token
        is_rep = is_rep & valid
        is_delta = is_delta & valid
        is_abs2 = is_abs2 & valid
        is_abs3 = is_abs3 & valid

    rep_prev = jnp.concatenate([jnp.array([False]), is_rep[:-1]])
    rep_start = is_rep & ~rep_prev
    rs_idx = _cummax(jnp.where(rep_start, i, -1))
    off_in_rep = jnp.where(is_rep, i - rs_idx, 0)
    nonrep_pos = jnp.where(~is_rep, i, n)
    end_idx = _suffix_min(nonrep_pos)
    rep_len = jnp.where(is_rep, end_idx - rs_idx, 0)

    kk = off_in_rep + 1
    full32 = is_rep & (kk % 32 == 0)
    is_last = is_rep & (kk == rep_len) & (rep_len % 32 != 0)

    counts = (
        is_delta.astype(jnp.int32)
        + 2 * is_abs2.astype(jnp.int32)
        + 3 * is_abs3.astype(jnp.int32)
        + full32.astype(jnp.int32)
        + is_last.astype(jnp.int32)
    )
    rem = rep_len % 32
    vu = v.astype(jnp.uint32)
    first_b = jnp.where(
        full32,
        jnp.uint32(0xC0 | 31),
        jnp.where(
            is_last,
            (rem - 1).astype(jnp.uint32) | 0xC0,
            jnp.where(
                is_delta,
                (diff - 1).astype(jnp.uint32) | 0x80,
                jnp.where(is_abs2, vu >> 8, jnp.where(is_abs3, (vu >> 16) | 0xE0, 0)),
            ),
        ),
    )
    second_b = jnp.where(is_abs2, vu & 0xFF, jnp.where(is_abs3, (vu >> 8) & 0xFF, 0))
    third_b = jnp.where(is_abs3, vu & 0xFF, 0)
    planes = jnp.stack([first_b, second_b, third_b], axis=1).astype(jnp.uint8)
    return _emit_gather(planes, counts, out_size)


def coords_encode2_device(values2: jnp.ndarray, out_cap: int,
                          n_valid: jnp.ndarray | None = None):
    """Both coordinate streams (X and Y) of a chunk in ONE pass: the two
    coders are independent instances of the same grammar, so batching the
    scans on axis 1 and giving each row its own output region in one
    emission sort halves the fixed per-stream costs.

    values2: (2, B) int32 (row 0 = X, row 1 = Y); per-row bytes identical
    to coords_encode_device. Returns (out (2*out_cap,) u8 — X stream at
    [0, x_len), Y stream at [out_cap, out_cap + y_len) — x_len, y_len).
    """
    R, n = values2.shape
    v = values2.astype(jnp.int32)
    i = jnp.arange(n, dtype=jnp.int32)[None, :]
    prev = jnp.concatenate(
        [jnp.full((R, 1), 1000, jnp.int32), v[:, :-1]], axis=1
    )
    diff = v - prev
    is_rep = diff == 0
    is_delta = (diff > 0) & (diff <= 64)
    is_abs2 = ~is_rep & ~is_delta & (v <= 32767)
    is_abs3 = ~is_rep & ~is_delta & (v > 32767)
    if n_valid is not None:
        valid = i < n_valid
        is_rep = is_rep & valid
        is_delta = is_delta & valid
        is_abs2 = is_abs2 & valid
        is_abs3 = is_abs3 & valid

    rep_prev = jnp.concatenate(
        [jnp.zeros((R, 1), bool), is_rep[:, :-1]], axis=1
    )
    rep_start = is_rep & ~rep_prev
    rs_idx = jax.lax.cummax(jnp.where(rep_start, i, -1), axis=1)
    off_in_rep = jnp.where(is_rep, i - rs_idx, 0)
    nonrep_pos = jnp.where(~is_rep, i, n)
    end_idx = jnp.flip(
        jax.lax.cummin(jnp.flip(nonrep_pos, axis=1), axis=1), axis=1
    )
    rep_len = jnp.where(is_rep, end_idx - rs_idx, 0)

    kk = off_in_rep + 1
    full32 = is_rep & (kk % 32 == 0)
    is_last = is_rep & (kk == rep_len) & (rep_len % 32 != 0)

    counts = (
        is_delta.astype(jnp.int32)
        + 2 * is_abs2.astype(jnp.int32)
        + 3 * is_abs3.astype(jnp.int32)
        + full32.astype(jnp.int32)
        + is_last.astype(jnp.int32)
    )
    rem = rep_len % 32
    vu = v.astype(jnp.uint32)
    first_b = jnp.where(
        full32,
        jnp.uint32(0xC0 | 31),
        jnp.where(
            is_last,
            (rem - 1).astype(jnp.uint32) | 0xC0,
            jnp.where(
                is_delta,
                (diff - 1).astype(jnp.uint32) | 0x80,
                jnp.where(is_abs2, vu >> 8,
                          jnp.where(is_abs3, (vu >> 16) | 0xE0, 0)),
            ),
        ),
    )
    second_b = jnp.where(is_abs2, vu & 0xFF,
                         jnp.where(is_abs3, (vu >> 8) & 0xFF, 0))
    third_b = jnp.where(is_abs3, vu & 0xFF, 0)

    cum = jnp.cumsum(counts, axis=1)
    totals = cum[:, -1]
    row_base = (out_cap * jnp.arange(R, dtype=jnp.int32))[:, None]
    offsets = row_base + cum - counts
    planes = jnp.stack(
        [first_b, second_b, third_b], axis=2
    ).astype(jnp.uint8).reshape(R * n, 3)
    # the layout sort places bytes by RANK, which equals the offset only
    # when every slot below the total is covered — fill each row's tail
    # [total_row, out_cap) with zero-byte filler keys so the two regions
    # stay hole-free (also reproduces the per-call zero padding)
    inf = jnp.int32(2**31 - 1)
    kk = jnp.arange(out_cap, dtype=jnp.int32)[None, :]
    filler = jnp.where(
        kk >= totals[:, None], ((row_base + kk) << 8), inf
    ).reshape(-1)
    out, _ = _emit_sort(
        planes, counts.reshape(-1), R * out_cap,
        offsets=offsets.reshape(-1), total=jnp.int32(R * out_cap),
        extra_keys=filler,
    )
    assert R == 2
    return out, totals[0], totals[1]


# ---------------------------------------------------------------------------
# decode side
# ---------------------------------------------------------------------------


def _apply_map4(m: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """out = m[..., s] for a 4-state map, unrolled into selects."""
    return jnp.where(
        s == 0, m[..., 0],
        jnp.where(s == 1, m[..., 1], jnp.where(s == 2, m[..., 2], m[..., 3])),
    )


def token_start_mask(lens: jnp.ndarray, force_start: jnp.ndarray | None = None):
    """Token boundary detection as a blocked parallel FSM scan.

    The stream grammar (tokens of 1/2/4 or 1/2/3 bytes, width determined by
    the first byte) is a 4-state machine: state = bytes remaining of the
    current token. Each byte contributes the map m(s) = lens[i]-1 if s==0
    else s-1; composing the maps walks the stream. force_start marks
    positions where a new token must begin regardless of state (per-bin
    stream boundaries).

    Three-level structure chosen for both runtime and compile time: a
    flat associative_scan over n elements traces ~2*log2(n) copies of the
    16-select composition (minutes of XLA compile); instead a K-step
    lax.scan composes byte maps WITHIN blocks (one small loop body), a tiny
    associative_scan runs across the n/K block maps, and a second K-step
    scan replays states inside each block.

    lens: (n,) int32 token length IF a token started at that byte.
    Returns bool (n,) start mask.
    """
    n = lens.shape[0]
    K = 64
    pad = (-n) % K
    s4 = jnp.arange(4, dtype=jnp.int32)[None, :]
    maps = jnp.where(s4 == 0, lens[:, None] - 1, s4 - 1).astype(jnp.int32)
    maps = jnp.clip(maps, 0, 3)
    if force_start is not None:
        forced = jnp.clip(lens[:, None] - 1, 0, 3) * jnp.ones_like(s4)
        maps = jnp.where(force_start[:, None], forced, maps)
    if pad:  # pad with "len 1" maps; padded tail is trimmed from the mask
        tail = jnp.broadcast_to(
            jnp.maximum(jnp.arange(4, dtype=jnp.int32) - 1, 0)[None, :],
            (pad, 4),
        )
        maps = jnp.concatenate([maps, tail])
    nb = (n + pad) // K
    bmaps = maps.reshape(nb, K, 4)

    # block-composed maps: scan K byte maps through an identity carry
    def comp_step(carry, mk):
        # carry: (nb, 4) prefix map; mk: (nb, 4) this byte's map
        out = jnp.stack(
            [_apply_map4(mk, carry[:, j]) for j in range(4)], axis=-1
        )
        return out, None

    # derive the identity carry FROM the data (x*0 + iota) so it carries
    # the same varying-manual-axes type as the scanned maps under
    # shard_map (a replicated literal carry fails lax.scan's vma check)
    ident = bmaps[:, 0, :] * 0 + jnp.arange(4, dtype=jnp.int32)[None, :]
    block_map, _ = jax.lax.scan(
        comp_step, ident, jnp.moveaxis(bmaps, 1, 0), unroll=8
    )

    def compose(a, b):  # tiny: runs over nb elements only
        return jnp.stack(
            [_apply_map4(b, a[..., j]) for j in range(4)], axis=-1
        )

    prefix = jax.lax.associative_scan(compose, block_map)
    entry = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), prefix[:-1, 0]]
    )  # state entering each block when the stream starts at state 0

    # replay within blocks: emit the start mask column by column
    def replay_step(state, mk):
        starts_col = state == 0
        return _apply_map4(mk, state), starts_col

    _, cols = jax.lax.scan(
        replay_step, entry, jnp.moveaxis(bmaps, 1, 0), unroll=8
    )
    starts = jnp.moveaxis(cols, 0, 1).reshape(-1)[:n]
    if force_start is not None:
        starts = starts | force_start
    return starts


def _stream_lens_device(buf: jnp.ndarray) -> jnp.ndarray:
    """Per-byte token length for the gap/run stream grammar (valid only at
    token starts): 0xxxxxxx=1, 10xxxxxx=2, 110xxxxx=1, 111xxxxx=4."""
    b = buf.astype(jnp.int32)
    return jnp.where(
        b < 0x80, 1, jnp.where(b < 0xC0, 2, jnp.where(b < 0xE0, 1, 4))
    )


def decode_positions_device(buf: jnp.ndarray, valid_len: jnp.ndarray,
                            max_positions: int, force_start=None,
                            valid_begin=0, starts=None):
    """Decode a gap/run stream (reference rfqcodec.cpp:957-1007) on device.

    buf: (m,) uint8 stream padded with >=4 zero bytes beyond valid_len;
    tokens live in [valid_begin, valid_len). Returns (positions:
    (max_positions,) int32 padded with -1, count). Restart semantics:
    positions/state reset wherever force_start is True (used to decode all
    per-bin streams in one pass; each segment's `last` restarts at -1).
    starts: optional precomputed token-start mask (the FSM is the dominant
    cost; qualcol decode shares one mask across its two uses).
    """
    m = buf.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    in_range = (idx >= valid_begin) & (idx < valid_len)
    if starts is None:
        lens = jnp.where(in_range, _stream_lens_device(buf), 1)
        starts = token_start_mask(lens, force_start) & in_range

    b0 = buf.astype(jnp.int32)
    nxt1 = jnp.roll(buf, -1).astype(jnp.int32)
    nxt2 = jnp.roll(buf, -2).astype(jnp.int32)
    nxt3 = jnp.roll(buf, -3).astype(jnp.int32)
    is_gap1 = b0 < 0x80
    is_gap2 = (b0 >= 0x80) & (b0 < 0xC0)
    is_run = (b0 >= 0xC0) & (b0 < 0xE0)
    is_gap4 = b0 >= 0xE0
    dist = jnp.where(
        is_gap1,
        b0 + 1,
        jnp.where(
            is_gap2,
            (((b0 & 0x3F) << 8) | nxt1) + 1,
            jnp.where(
                is_gap4,
                (((b0 & 0x1F) << 24) | (nxt1 << 16) | (nxt2 << 8) | nxt3) + 1,
                1,  # run tokens advance by 1 per covered position
            ),
        ),
    )
    npos_tok = jnp.where(starts, jnp.where(is_run, (b0 & 0x1F) + 1, 1), 0)

    # expand tokens to per-position deltas: delta=dist at each token's first
    # position, 1 within runs; positions = segmented cumsum of deltas - 1
    cum_pos = jnp.cumsum(npos_tok)
    count = cum_pos[-1] if m else jnp.int32(0)
    first_slot = cum_pos - npos_tok  # output slot of each token's 1st pos
    deltas = jnp.ones(max_positions + 1, dtype=jnp.int32)
    slot = jnp.where(starts, jnp.minimum(first_slot, max_positions), max_positions)
    deltas = deltas.at[slot].set(jnp.where(starts, dist, 1), mode="drop")
    # segment resets: if force_start begins a new bin segment, the running
    # position restarts at -1 -> make that slot's delta absolute
    if force_start is not None:
        seg_first = starts & force_start
        seg_slot = jnp.where(
            seg_first, jnp.minimum(first_slot, max_positions), max_positions
        )
        # mark segment-first slots; positions are rebuilt per segment below
        seg_mark = jnp.zeros(max_positions + 1, dtype=jnp.int32)
        seg_mark = seg_mark.at[seg_slot].set(
            jnp.where(seg_first, 1, 0), mode="drop"
        )
        # segmented cumsum: subtract the running total at each segment start
        raw = jnp.cumsum(deltas[:max_positions])
        seg_id = jnp.cumsum(seg_mark[:max_positions])
        # value of raw just before each segment start
        seg_base = jnp.where(seg_mark[:max_positions] == 1,
                             raw - deltas[:max_positions], 0)
        seg_base = jax.lax.cummax(seg_base)
        positions = raw - seg_base - 1
    else:
        positions = jnp.cumsum(deltas[:max_positions]) - 1
    k = jnp.arange(max_positions, dtype=jnp.int32)
    positions = jnp.where(k < count, positions, -1)
    return positions, count


def qualcol_decode_device(buf: jnp.ndarray, nbins: int, bins: jnp.ndarray,
                          major: jnp.ndarray, length: int,
                          total_len: jnp.ndarray,
                          tok_cap: int | None = None,
                          pos_cap: int | None = None,
                          esc_cap: int | None = None,
                          run_cap: int | None = None):
    """By-column quality decode (reference rfqcodec.cpp:1009-1047) on
    device, in COMPACT token/slot space (the decode dual of the encode
    side's sort-based emission):

    1. one token-FSM pass over the concatenated per-bin streams
       (token_start_mask; boundaries force restarts),
    2. token compaction by a payload-carrying sort (the sorted stream
       index doubles as wire order == slot order),
    3. all per-token work (type, gap distance, run coverage, bin id,
       segmented position arithmetic) in (tok_cap,)-space,
    4. slot-space position reconstruction WITHOUT per-position scatter
       chains: each token's covered positions are affine in the slot
       index, so scattering the per-token DELTA of the packed
       ((first_pos - slot_start + length) << 6 | bin) value at each
       token's first slot and running one cumsum rebuilds every
       position+bin pair (piecewise-constant fill-forward == cumsum of
       boundary deltas),
    5. ONE scatter of (position -> bin char) plus the escape records into
       the major-filled output.

    The big-space (length,) work is one fill and one scatter.

    buf: (m,) uint8 (4*nbins length table + streams + escapes), padded
    with >=5 zero bytes; total_len: scalar true qual_buf size. tok_cap /
    pos_cap / esc_cap: static TRUE bounds on token / emitted-position /
    escape-record counts (the engine computes them exactly host-side; the
    defaults are safe structural bounds). Returns qual (length,) uint8.
    """
    m = buf.shape[0]
    if tok_cap is None:
        tok_cap = m
    if pos_cap is None:
        pos_cap = min(length, 32 * m)
    if esc_cap is None:
        esc_cap = m // 5 + 1
    tok_cap = max(1, min(tok_cap, m))
    pos_cap = max(1, min(pos_cap, length))
    # (pos_first - slot_start + length) < 2*length < 2^25, shifted by 6
    # bin bits fills int32 exactly -> 16 Mbase blocks decode on device too
    assert length < (1 << 24) and nbins < 64, (
        "qualcol decode packs (pos_delta + length) << 6 | bin into int32; "
        "length %d / nbins %d out of range" % (length, nbins)
    )
    lens_table = (
        buf[0 : 4 * nbins : 4].astype(jnp.int32)
        | (buf[1 : 4 * nbins + 1 : 4].astype(jnp.int32) << 8)
        | (buf[2 : 4 * nbins + 2 : 4].astype(jnp.int32) << 16)
        | (buf[3 : 4 * nbins + 3 : 4].astype(jnp.int32) << 24)
    )
    cum_lens = jnp.cumsum(lens_table)
    stream_begin = 4 * nbins + cum_lens - lens_table  # (B,)
    stream_end = 4 * nbins + cum_lens[-1]

    idx = jnp.arange(m, dtype=jnp.int32)
    in_streams = (idx >= 4 * nbins) & (idx < stream_end)
    force = jnp.zeros(m + 1, dtype=bool)
    force = force.at[jnp.minimum(stream_begin, m)].set(True, mode="drop")
    force = force[:m] & in_streams

    lens_dev = jnp.where(in_streams, _stream_lens_device(buf), 1)
    starts = token_start_mask(lens_dev, force) & in_streams

    # dense 4-byte little-endian window per byte (tokens are <= 4 bytes);
    # carried through the compaction sort as payload — no gather
    w32 = (
        buf.astype(jnp.int32)
        | (jnp.roll(buf, -1).astype(jnp.int32) << 8)
        | (jnp.roll(buf, -2).astype(jnp.int32) << 16)
        | (jnp.roll(buf, -3).astype(jnp.int32) << 24)
    )
    inf = jnp.int32(2**31 - 1)
    keys = jnp.where(starts, idx, inf)
    tok_i, tok_w = jax.lax.sort((keys, w32), num_keys=1)
    tok_i = tok_i[:tok_cap]
    tok_w = tok_w[:tok_cap]
    valid = tok_i < inf

    # token classification (reference rfqcodec.cpp:957-1007 grammar)
    b0 = tok_w & 0xFF
    b1 = (tok_w >> 8) & 0xFF
    b2 = (tok_w >> 16) & 0xFF
    b3 = (tok_w >> 24) & 0xFF
    is_gap1 = b0 < 0x80
    is_gap2 = (b0 >= 0x80) & (b0 < 0xC0)
    is_run = (b0 >= 0xC0) & (b0 < 0xE0)
    is_gap4 = b0 >= 0xE0
    dist = jnp.where(
        is_gap1, b0 + 1,
        jnp.where(
            is_gap2, (((b0 & 0x3F) << 8) | b1) + 1,
            jnp.where(
                is_gap4,
                (((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3) + 1,
                1,  # run tokens advance by 1 per covered position
            ),
        ),
    )
    npos = jnp.where(valid, jnp.where(is_run, (b0 & 0x1F) + 1, 1), 0)
    adv = jnp.where(valid, dist + npos - 1, 0)

    # bin id per token + segment starts (per-bin `last` restarts at -1).
    # Small palettes: a compare-sum over the (B,) boundary table fuses
    # into one elementwise pass; searchsorted lowers to a gather loop.
    if nbins <= 16:
        tok_bin = jnp.zeros(tok_i.shape[0], dtype=jnp.int32)
        for bb in range(1, nbins):
            tok_bin = tok_bin + (tok_i >= stream_begin[bb]).astype(jnp.int32)
    else:
        tok_bin = jnp.clip(
            jnp.searchsorted(stream_begin, tok_i, side="right") - 1,
            0, nbins - 1,
        ).astype(jnp.int32)
    seg_start = jnp.concatenate(
        [jnp.ones(1, bool), tok_bin[1:] != tok_bin[:-1]]
    )
    raw = jnp.cumsum(adv)
    seg_base = jax.lax.cummax(jnp.where(seg_start, raw - adv, 0))
    pos_end = raw - seg_base - 1
    pos_first = pos_end - npos + 1

    if run_cap is not None:
        # scatter DIRECTLY from token space with u8 .set — most tokens
        # cover exactly ONE position; tokens covering >= 2 (runs, their
        # count bounded by pos_cnt - tok_cnt, host-known) extend via a
        # small compacted (run, 4-lane, 31) grid. Replaces the slot-space
        # delta-scatter + cumsum + position scatter: ONE ~tok-sized
        # scatter instead of two ~pos-sized ones.
        # Run-heavy chunks (2-bin RTA data) must keep the legacy path —
        # callers gate run_cap on (pos - tok) staying small.
        if nbins <= 16:
            val_t = jnp.full(tok_i.shape[0], bins[0], dtype=jnp.uint8)
            for j in range(1, nbins):
                val_t = jnp.where(tok_bin == j, bins[j], val_t)
        else:
            val_t = bins[tok_bin]
        ok_t = valid & (npos >= 1) & (pos_first >= 0) & (
            pos_first < length)
        qual = jnp.full(length, major, dtype=jnp.uint8)
        qual = qual.at[jnp.where(ok_t, pos_first, length)].set(
            val_t, mode="drop")
        # run extension: 4-granule compaction of tokens with npos >= 2
        m_tok = tok_i.shape[0]
        pad4 = (-m_tok) % 4
        rmask_f = valid & (npos >= 2)
        pos_first_p, npos_p, val_t_p = pos_first, npos, val_t
        if pad4:
            zi = jnp.zeros(pad4, jnp.int32)
            rmask_f = jnp.concatenate([rmask_f, jnp.zeros(pad4, bool)])
            pos_first_p = jnp.concatenate([pos_first_p, zi])
            npos_p = jnp.concatenate([npos_p, zi])
            val_t_p = jnp.concatenate(
                [val_t_p, jnp.zeros(pad4, val_t_p.dtype)])
        m_tok += pad4
        run_cap_eff = max(1, min(run_cap, m_tok // 4 + 1))
        rmask = rmask_f.reshape(-1, 4)
        ng = rmask.shape[0]
        i_g = jnp.arange(ng, dtype=jnp.int32)
        g_has = rmask.any(axis=1)
        gidx = jnp.sort(jnp.where(g_has, i_g, jnp.int32(ng)))[
            :run_cap_eff]

        def _g4(x, fill):
            return jnp.concatenate(
                [x.reshape(-1, 4),
                 jnp.full((1, 4), fill, x.dtype)])[gidx]

        rp = _g4(pos_first_p, 0)
        rn = _g4(npos_p, 0)
        rv = _g4(val_t_p, 0)
        rm = _g4(rmask_f.astype(jnp.int32), 0) == 1
        lanes31 = jnp.arange(1, 32, dtype=jnp.int32)[None, None, :]
        cand = rp[:, :, None] + lanes31
        cv = rm[:, :, None] & (lanes31 < rn[:, :, None]) & (
            cand >= 0) & (cand < length)
        qual = qual.at[jnp.where(cv, cand, length).reshape(-1)].set(
            jnp.broadcast_to(rv[:, :, None], cv.shape).reshape(-1),
            mode="drop")
        if esc_cap > 0:
            esc_idx = jnp.arange(esc_cap, dtype=jnp.int32)
            rec = stream_end + 5 * esc_idx
            rec_ok = (rec + 4) < total_len
            recc = jnp.minimum(rec, m - 5)
            we = jnp.concatenate([w32, jnp.zeros(3, jnp.int32)])[recc]
            ch = (we & 0xFF).astype(jnp.uint8)
            pos = ((we >> 8) & 0xFFFFFF) | (
                buf[jnp.minimum(recc + 4, m - 1)].astype(jnp.int32) << 24
            )
            ok = rec_ok & (pos < length)
            qual = qual.at[jnp.where(ok, pos, length)].set(
                jnp.where(ok, ch, 0), mode="drop"
            )
        return qual

    cum_np = jnp.cumsum(npos)
    slot_start = cum_np - npos
    c_total = cum_np[-1] if tok_cap else jnp.int32(0)

    # packed per-token constant: positions covered by token j are
    # pos_first + (k - slot_start) for slot k, so (pos_first - slot_start)
    # is constant per token; pack the bin id into the low 6 bits
    a2 = ((pos_first - slot_start + length) << 6) | tok_bin
    d = a2 - jnp.concatenate([jnp.zeros(1, jnp.int32), a2[:-1]])
    sidx = jnp.where(valid & (npos >= 1),
                     jnp.minimum(slot_start, pos_cap), jnp.int32(pos_cap))
    dslots = jnp.zeros(pos_cap + 1, dtype=jnp.int32)
    dslots = dslots.at[sidx].set(d, mode="drop")[:pos_cap]
    a2_k = jnp.cumsum(dslots)
    k = jnp.arange(pos_cap, dtype=jnp.int32)
    pos_k = (a2_k >> 6) - length + k
    bin_k = a2_k & 63
    if nbins <= 16:
        val_k = jnp.full(pos_cap, bins[0], dtype=jnp.uint8)
        for j in range(1, nbins):
            val_k = jnp.where(bin_k == j, bins[j], val_k)
    else:
        val_k = bins[bin_k]
    ok_k = (k < c_total) & (pos_k >= 0) & (pos_k < length)
    tgt = jnp.where(ok_k, pos_k, length)
    qual = jnp.full(length, major, dtype=jnp.uint8)
    qual = qual.at[tgt].set(val_k, mode="drop")

    # escapes: 5-byte records in [stream_end, total_len); positions are
    # disjoint from the streams', so order doesn't matter
    if esc_cap > 0:
        esc_idx = jnp.arange(esc_cap, dtype=jnp.int32)
        rec = stream_end + 5 * esc_idx
        rec_ok = (rec + 4) < total_len
        recc = jnp.minimum(rec, m - 5)
        we = jnp.concatenate([w32, jnp.zeros(3, jnp.int32)])[recc]
        ch = (we & 0xFF).astype(jnp.uint8)
        pos = ((we >> 8) & 0xFFFFFF) | (
            buf[jnp.minimum(recc + 4, m - 1)].astype(jnp.int32) << 24
        )
        ok = rec_ok & (pos < length)
        qual = qual.at[jnp.where(ok, pos, length)].set(
            jnp.where(ok, ch, 0), mode="drop"
        )
    return qual


def pack_2bit_device(seq: jnp.ndarray) -> jnp.ndarray:
    """(n,) uint8 bases -> (n/4,) packed (n must be a multiple of 4; pad
    with 'G' upstream). G=0 A=1 T=2 C=3, low bits first."""
    table = np.zeros(256, dtype=np.uint8)
    table[ord("A")] = 1
    table[ord("T")] = 2
    table[ord("C")] = 3
    vals = jnp.asarray(table)[seq]
    v = vals.reshape(-1, 4)
    return (v[:, 0] | (v[:, 1] << 2) | (v[:, 2] << 4) | (v[:, 3] << 6)).astype(
        jnp.uint8
    )


def encode_frontend_meta32(seq32: jnp.ndarray, qual32: jnp.ndarray,
                           bins: jnp.ndarray, major) -> tuple[
                               jnp.ndarray, jnp.ndarray]:
    """Encode front end over word-packed input: 2-bit pack, N flag and
    quality-bin id in one elementwise pass (XLA fuses it into a single
    read of seq+qual and a single write of packed+meta).

    seq32/qual32: (nw,) u32 LITTLE-ENDIAN words of the seq/qual bytes (a
    free numpy '<u4' view on the host), so byte k of word j is position
    4j+k. bins: (B,) palette minus the major qual (B <= 63); major: its
    own scalar. Returns (packed (nw,) u8, meta32 (nw,) u32): meta byte k
    of word j holds the bin id of position 4j+k in bits 0-6 (0..B-1
    palette stream, B escape, B+1 major) and the N flag in bit 7.
    """
    nbins = int(bins.shape[0])
    assert nbins <= 63, nbins  # bin ids 0..B+1 must fit the 7 meta bits
    bins = bins.astype(jnp.uint32)
    major = jnp.asarray(major).astype(jnp.uint32)
    packed = jnp.zeros_like(seq32)
    meta = jnp.zeros_like(seq32)
    for k in range(4):
        b = (seq32 >> (8 * k)) & 0xFF
        code = (jnp.where(b == ord("A"), 1, 0) + jnp.where(b == ord("T"), 2, 0)
                + jnp.where(b == ord("C"), 3, 0)).astype(jnp.uint32)
        packed = packed | (code << (2 * k))
        q = (qual32 >> (8 * k)) & 0xFF
        ib = jnp.full_like(q, nbins)  # escape unless a palette entry matches
        for j in range(nbins):
            ib = jnp.where(q == bins[j], jnp.uint32(j), ib)
        ib = jnp.where(q == major, jnp.uint32(nbins + 1), ib)
        ib = ib | jnp.where(b == ord("N"), jnp.uint32(0x80), 0)
        meta = meta | (ib << (8 * k))
    return packed.astype(jnp.uint8), meta


def unpack_2bit_device(buf: jnp.ndarray) -> jnp.ndarray:
    """(m,) packed -> (4m,) base chars."""
    base = jnp.asarray(np.frombuffer(b"GATC", dtype=np.uint8))
    b = buf[:, None]
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    codes = (b >> shifts) & 3
    return base[codes.reshape(-1)]


def revcomp_device(seqs: jnp.ndarray) -> jnp.ndarray:
    """(R, L) uint8 -> reverse complement along axis 1 (non-ACGT -> N)."""
    comp = np.full(256, ord("N"), dtype=np.uint8)
    for a, b in zip(b"AaTtCcGg", b"TTAAGGCC"):
        comp[a] = b
    return jnp.asarray(comp)[jnp.flip(seqs, axis=1)]


def qual_histogram_device(qual: jnp.ndarray) -> jnp.ndarray:
    """(n,) uint8 -> (128,) int32 counts (header quality table input)."""
    return jnp.bincount(qual.astype(jnp.int32), length=128)


# ---------------------------------------------------------------------------
# PE overlap search (reference rfqcodec.cpp:1391-1438) on device
# ---------------------------------------------------------------------------

_OV_MIN = 12
_OV_BASE1 = np.uint32(0x01000193)  # FNV-ish odd bases (invertible mod 2^32)
_OV_BASE2 = np.uint32(0x9E3779B1)


def _u32_inv(a: int) -> int:
    """Multiplicative inverse of an odd a modulo 2^32 (Newton iteration)."""
    x = a
    for _ in range(5):
        x = (x * (2 - a * x)) & 0xFFFFFFFF
    return x


def _poly_prefix_hash(b: jnp.ndarray, base: np.uint32) -> jnp.ndarray:
    """h(o) = sum_{j<o} b[:, j] * base^(o-1-j) mod 2^32 for every o, with
    two cumulative passes: h(o) = base^(o-1) * cumsum(b[:, j] * inv^j)."""
    p, L = b.shape
    inv = np.uint32(_u32_inv(int(base)))
    invp = np.empty(L, dtype=np.uint32)
    powp = np.empty(L, dtype=np.uint32)
    x = y = np.uint32(1)
    for j in range(L):
        invp[j] = x
        powp[j] = y
        x = np.uint32((int(x) * int(inv)) & 0xFFFFFFFF)
        y = np.uint32((int(y) * int(base)) & 0xFFFFFFFF)
    terms = b.astype(jnp.uint32) * jnp.asarray(invp)[None, :]
    return jnp.cumsum(terms, axis=1, dtype=jnp.uint32) * jnp.asarray(powp)[None, :]


def _suffix_hash(a: jnp.ndarray, base: np.uint32, minlen: int) -> jnp.ndarray:
    """h(o) = sum_{j=1..o} a[:, La-j] * base^(j-1) mod 2^32, o = 1..minlen."""
    powp = np.empty(minlen, dtype=np.uint32)
    y = np.uint32(1)
    for j in range(minlen):
        powp[j] = y
        y = np.uint32((int(y) * int(base)) & 0xFFFFFFFF)
    tail = jnp.flip(a[:, a.shape[1] - minlen :], axis=1).astype(jnp.uint32)
    return jnp.cumsum(tail * jnp.asarray(powp)[None, :], axis=1,
                      dtype=jnp.uint32)


def _first_candidate_device(a: jnp.ndarray, b: jnp.ndarray, minlen: int):
    """Smallest o in [12, minlen] with double-hash match of a's suffix and
    b's prefix; 0 when none."""
    hs1 = _suffix_hash(a, _OV_BASE1, minlen)
    hp1 = _poly_prefix_hash(b[:, :minlen], _OV_BASE1)
    hs2 = _suffix_hash(a, _OV_BASE2, minlen)
    hp2 = _poly_prefix_hash(b[:, :minlen], _OV_BASE2)
    o = jnp.arange(1, minlen + 1, dtype=jnp.int32)[None, :]
    hit = (hs1 == hp1) & (hs2 == hp2) & (o >= _OV_MIN)
    first = jnp.min(jnp.where(hit, o, jnp.int32(minlen + 1)), axis=1)
    return jnp.where(first > minlen, 0, first)


def _verify_overlap_device(a: jnp.ndarray, b: jnp.ndarray, o: jnp.ndarray,
                           minlen: int) -> jnp.ndarray:
    """Exact check a[:, La-o:] == b[:, :o] (masked; o == 0 -> False)."""
    La = a.shape[1]
    cols = jnp.arange(minlen, dtype=jnp.int32)[None, :]
    valid = cols < o[:, None]
    idx = jnp.clip(La - o[:, None] + cols, 0, La - 1)
    eq = (jnp.take_along_axis(a, idx, axis=1) == b[:, :minlen]) | ~valid
    return eq.all(axis=1) & (o > 0)


def overlap_pairs_device(r1: jnp.ndarray, r2: jnp.ndarray):
    """First exact overlap per pair on device (reference semantics: +o
    forward r1-suffix/r2-prefix, then -o backward, first match from o=12
    upward; 0 none). r2 must already be reverse-complemented.

    Returns (ov (p,) int32, collision (p,) bool). A True collision flag
    means the first DOUBLE-HASH candidate failed exact verification
    (probability ~2^-64 per candidate); those rows must take the host
    scalar path to preserve first-match semantics. Cross-checked against
    the host search in tests/test_device.py.
    """
    p, L1 = r1.shape
    L2 = r2.shape[1]
    minlen = min(L1, L2)
    if minlen < _OV_MIN or p == 0:
        return jnp.zeros(p, jnp.int32), jnp.zeros(p, bool)
    fwd = _first_candidate_device(r1, r2, minlen)
    okf = _verify_overlap_device(r1, r2, fwd, minlen)
    bwd = _first_candidate_device(r2, r1, minlen)
    okb = _verify_overlap_device(r2, r1, bwd, minlen)
    ov = jnp.where(okf, fwd, jnp.where(okb, -bwd, 0))
    collision = (~okf & (fwd > 0)) | (~okf & ~okb & (bwd > 0))
    return ov.astype(jnp.int32), collision
