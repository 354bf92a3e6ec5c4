"""Device (JAX) interleaved-rANS kernels — the device path of the `.rfqz`
second entropy stage. Byte-exact with the host oracle codec/rans_np.py
(cross-checked in tests/test_rans.py).

Shape of the computation: L independent rANS lanes advance in lockstep
through a (steps, lanes) symbol grid via ONE lax.scan per direction. The
coder constants (32-bit state, 16-bit renorm, 12-bit scale) give the key
invariant that makes the lockstep kernel exact and fixed-shape:

    state in [2^16, 2^32)  =>  at most ONE u16 renorm word per lane per
    step, on both encode and decode.

so the scan body is pure elementwise math plus one gather, with no
data-dependent inner loops. Encode output words are compacted into the
container's per-lane payload layout by the same sort-based emission used
for the .rfq token streams.

Requires n to be a multiple of lanes (the rfqz writer picks block sizes
that are; ragged tails take the host oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codec import rans_np

SCALE_BITS = rans_np.SCALE_BITS
SCALE = rans_np.SCALE
RANS_L = rans_np.RANS_L


def _cmp_lookup(slot: jnp.ndarray, cum257: jnp.ndarray):
    """(sym, freq, cum) for each slot via broadcast compare-reduce against
    the 257-entry cumulative table ((n, 256) compares + reductions instead
    of a data-dependent gather). Exact for zero-frequency symbols (their
    cum duplicates collapse)."""
    cum_lo = cum257[None, :256]
    ge = slot[:, None] >= cum_lo
    sym = jnp.sum(ge, axis=1).astype(jnp.int32) - 1
    c = jnp.max(jnp.where(ge, cum_lo, 0), axis=1)
    hi = cum257[None, 1:]
    gt = slot[:, None] < hi
    cnext = jnp.min(jnp.where(gt, hi, jnp.int32(SCALE)), axis=1)
    return sym, (cnext - c).astype(jnp.uint32), c.astype(jnp.uint32)


def _cmp_lookup_compact(slot: jnp.ndarray, bounds: jnp.ndarray,
                        syms: jnp.ndarray, S: int):
    """(sym, freq, cum) via compare-select against the COMPACT boundary
    table of the S present symbols (S static, typically 4-16 for rfqz
    streams) — the dense 256-wide compare-reduce costs 256/S times more
    work for the same answer. bounds: (S+1,) i32 cumulative starts +
    SCALE; syms: (S,) i32. Both TRACED so different sections of the same
    shape reuse one executable."""
    ge = slot[:, None] >= bounds[None, :S]  # (lanes, S)
    sym = jnp.zeros(slot.shape, jnp.int32) + syms[0]
    for j in range(1, S):
        sym = sym + jnp.where(ge[:, j], syms[j] - syms[j - 1], 0)
    c = jnp.max(jnp.where(ge, bounds[None, :S], 0), axis=1)
    hi = bounds[None, 1:]
    cnext = jnp.min(jnp.where(slot[:, None] < hi, hi, jnp.int32(SCALE)),
                    axis=1)
    return sym, (cnext - c).astype(jnp.uint32), c.astype(jnp.uint32)


def _cmp_lookup_compact_rows(slot: jnp.ndarray, brows_t: jnp.ndarray,
                             S: int):
    """_cmp_lookup_compact with a PER-LANE bounds row — the order-1
    compact path selects each lane's row by its previous-symbol ordinal,
    so the whole context-dependent table lookup stays in compare-select
    land (no (256, SCALE) gathers). brows_t is LANE-LAST (S+1, lanes), so
    every op runs along the long lane axis. Returns (sym_ordinal, freq,
    cum)."""
    ge = slot[None, :] >= brows_t[:S]  # (S, lanes)
    sym_ord = jnp.sum(ge[1:].astype(jnp.int32), axis=0)
    c = jnp.max(jnp.where(ge, brows_t[:S], 0), axis=0)
    hi = brows_t[1:]
    cnext = jnp.min(jnp.where(slot[None, :] < hi, hi, jnp.int32(SCALE)),
                    axis=0)
    return sym_ord, (cnext - c).astype(jnp.uint32), c.astype(jnp.uint32)


def _select_fc(gi: jnp.ndarray, syms: jnp.ndarray, f_of_sym: jnp.ndarray,
               c_of_sym: jnp.ndarray, S: int):
    """(freq, cum) per symbol via compare-select over the S present
    symbols — replaces two 256-LUT gathers over the whole grid. Tables
    traced; only S is static."""
    f = jnp.zeros(gi.shape, jnp.uint32)
    c = jnp.zeros(gi.shape, jnp.uint32)
    for j in range(S):
        hit = gi == syms[j]
        f = jnp.where(hit, f_of_sym[j].astype(jnp.uint32), f)
        c = jnp.where(hit, c_of_sym[j].astype(jnp.uint32), c)
    return f, c


def _grid_of(data: jnp.ndarray, lanes: int) -> jnp.ndarray:
    """(n,) -> (steps, lanes): lane i owns the contiguous slice
    data[i*steps:(i+1)*steps] (n % lanes == 0), matching
    rans_np.lane_slices for the equal-split case."""
    n = data.shape[0]
    assert n % lanes == 0, "device rANS needs n %% lanes == 0"
    return data.reshape(lanes, n // lanes).T


def rans_encode_device(data: jnp.ndarray, freq_lut: jnp.ndarray,
                       cum_lut: jnp.ndarray, lanes: int, order: int):
    """Encode (n,) u8 with per-symbol tables.

    freq_lut/cum_lut: (256,) int32 for order-0, (256, 256) for order-1
    (row = previous byte's context). Returns (words (steps, lanes) u16 in
    ENCODER order (k ascending == symbols processed in reverse), emit mask
    (steps, lanes) bool, final states (lanes,) u32).
    """
    grid = _grid_of(data, lanes)
    steps = grid.shape[0]
    gi = grid.astype(jnp.int32)
    if order == 0:
        f_of = freq_lut[gi]
        c_of = cum_lut[gi]
    else:
        prev = jnp.concatenate(
            [jnp.zeros((1, lanes), jnp.int32), gi[:-1]], axis=0
        )
        f_of = freq_lut[prev, gi]
        c_of = cum_lut[prev, gi]

    def step(state, fc):
        f, c = fc
        f = f.astype(jnp.uint32)
        c = c.astype(jnp.uint32)
        # renorm: state >= f << 20, computed shift-first to dodge overflow
        emit = (state >> jnp.uint32(20)) >= f
        word = (state & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        state = jnp.where(emit, state >> jnp.uint32(16), state)
        state = (
            (state // f) << jnp.uint32(SCALE_BITS)
        ) + (state % f) + c
        return state, (word, emit)

    # init derived from the data (x*0 + L) so the carry has the same
    # varying-manual-axes type as the scanned tables under shard_map.
    # unroll: the body is a handful of elementwise ops over `lanes`
    # values — per-iteration scan overhead dominates at 4096 lanes, and
    # unrolling 8 symbols per iteration amortizes it without changing the
    # per-lane symbol order (bytes identical).
    init = (gi[0] * 0 + RANS_L).astype(jnp.uint32)
    final, (words, emits) = jax.lax.scan(
        step, init, (f_of[::-1], c_of[::-1]), unroll=8
    )
    return words, emits, final


def rans_encode_payload_device(data: jnp.ndarray, freq_lut, cum_lut,
                               lanes: int, order: int, out_cap: int):
    """Full device encode to the container's payload image: per-lane
    [4B final state LE][u16 words in decode order], lanes back-to-back.
    Returns (payload (out_cap,) u8 zero-padded, lane_counts (lanes,) i32
    bytes per lane, total i32)."""
    words, emits, final = rans_encode_device(
        data, freq_lut, cum_lut, lanes, order
    )
    steps = words.shape[0]
    wcount = jnp.sum(emits, axis=0).astype(jnp.int32)  # words per lane
    lane_bytes = 4 + 2 * wcount
    lane_start = jnp.cumsum(lane_bytes) - lane_bytes
    total = jnp.sum(lane_bytes)

    # word emitted at scan index k in lane i sits at decode position
    # (wcount[i]-1-rank) where rank = #emits before k in that lane
    rank = jnp.cumsum(emits.astype(jnp.int32), axis=0) - 1
    dpos = wcount[None, :] - 1 - rank
    dest = lane_start[None, :] + 4 + 2 * dpos  # byte offset of hi byte

    # sort (dest, byte) PAIRS with a stable two-operand sort: packing
    # (dest << 8 | byte) into one int32 would overflow for payloads over
    # 2^23 bytes (16MB sections routinely exceed that)
    inf = jnp.int32(2**31 - 1)
    w32 = words.astype(jnp.int32)
    hi_keys = jnp.where(emits, dest, inf).reshape(-1)
    hi_vals = (w32 >> 8).astype(jnp.uint8).reshape(-1)
    lo_keys = jnp.where(emits, dest + 1, inf).reshape(-1)
    lo_vals = (w32 & 0xFF).astype(jnp.uint8).reshape(-1)

    st = final.astype(jnp.int32)
    b = jnp.arange(4, dtype=jnp.int32)[None, :]
    state_keys = (lane_start[:, None] + b).reshape(-1)
    state_vals = ((st[:, None] >> (8 * b)) & 0xFF).astype(jnp.uint8).reshape(-1)

    keys = jnp.concatenate([hi_keys, lo_keys, state_keys])
    vals = jnp.concatenate([hi_vals, lo_vals, state_vals])
    _sk, sv = jax.lax.sort((keys, vals), num_keys=1)
    take = min(out_cap, sv.shape[0])
    out = jnp.zeros(out_cap, dtype=jnp.uint8)
    out = out.at[:take].set(sv[:take])
    k = jnp.arange(out_cap, dtype=jnp.int32)
    out = jnp.where(k < total, out, 0).astype(jnp.uint8)
    return out, lane_bytes, total


def rans_encode_o0_image(data: jnp.ndarray, syms: jnp.ndarray,
                         f_present: jnp.ndarray, c_present: jnp.ndarray,
                         lanes: int, maxw_cap: int, S: int):
    """Fast order-0 encode to a PER-LANE image (host does the trivial
    span concatenation): compare-select tables (no 256-LUT gathers) and a
    batched per-COLUMN sort that lays each lane's emitted words out in
    decode order — the flat 2n-key global sort of the general path was the
    dominant cost. Returns (state_img (lanes,4) u8, word_img
    (lanes, 2*maxw_cap) u8, wcount (lanes,) i32). Lanes whose word count
    exceeds maxw_cap must take the general path (host checks wcount)."""
    grid = _grid_of(data, lanes)
    gi = grid.astype(jnp.int32)
    f_of, c_of = _select_fc(gi, syms, f_present, c_present, S)

    def step(state, fc):
        f, c = fc
        emit = (state >> jnp.uint32(20)) >= f
        word = (state & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        state = jnp.where(emit, state >> jnp.uint32(16), state)
        state = ((state // f) << jnp.uint32(SCALE_BITS)) + (state % f) + c
        return state, (word, emit)

    init = (gi[0] * 0 + RANS_L).astype(jnp.uint32)
    final, (words, emits) = jax.lax.scan(
        step, init, (f_of[::-1], c_of[::-1]), unroll=8
    )
    wcount = jnp.sum(emits, axis=0).astype(jnp.int32)
    rank = jnp.cumsum(emits.astype(jnp.int32), axis=0) - 1
    dpos = wcount[None, :] - 1 - rank
    key = jnp.where(emits, dpos, jnp.int32(2**31 - 1))
    _sk, sw = jax.lax.sort(
        (key, words.astype(jnp.int32)), dimension=0, num_keys=1
    )
    sw = sw[:maxw_cap]  # rows past the per-lane word count are inf-keyed
    hi = ((sw >> 8) & 0xFF).astype(jnp.uint8)
    lo = (sw & 0xFF).astype(jnp.uint8)
    word_img = jnp.stack([hi, lo], axis=2).transpose(1, 0, 2).reshape(
        lanes, 2 * maxw_cap
    )
    st = final.astype(jnp.uint32)
    b = jnp.arange(4, dtype=jnp.uint32) * 8
    state_img = ((st[:, None] >> b[None, :]) & 0xFF).astype(jnp.uint8)
    return state_img, word_img, wcount


def rans_decode_device(payload: jnp.ndarray, lane_counts: jnp.ndarray,
                       sym_lut: jnp.ndarray, freq_lut, cum_lut,
                       lanes: int, steps: int, order: int,
                       compact: tuple | None = None,
                       compact1: tuple | None = None):
    """Decode to a (steps, lanes) symbol grid (= data.reshape(lanes,
    steps).T). payload: flat per-lane image as produced above, padded with
    >= 2 zero bytes; sym_lut: (SCALE,) u8 for order-0 / (256, SCALE) for
    order-1. compact: optional (syms (S,) traced, bounds (S+1,) traced,
    S static) for the order-0 compare-select fast path (S-wide instead of
    256-wide). compact1: optional (syms (S,) traced, B (S+1, S+1) traced
    per-context-ordinal bounds rows, ctx0 traced initial context ordinal,
    S static) for the order-1 compare-select path — context = previous
    symbol, which the chain already produces as an ORDINAL, so row
    selection is S+1 masked adds instead of a (256, SCALE) gather
    (round-3, VERDICT r2 item 7)."""
    lane_start = jnp.cumsum(lane_counts) - lane_counts
    s0 = lane_start
    state = (
        payload[s0].astype(jnp.uint32)
        | (payload[s0 + 1].astype(jnp.uint32) << jnp.uint32(8))
        | (payload[s0 + 2].astype(jnp.uint32) << jnp.uint32(16))
        | (payload[s0 + 3].astype(jnp.uint32) << jnp.uint32(24))
    )
    # every lane span is 4 + 2w bytes, so every word read is 2-aligned:
    # gather ONE u16 per renorm instead of two bytes (the per-step payload
    # gather is the decode scan's dominant cost)
    pad = (-payload.shape[0]) % 2
    p_even = (
        jnp.concatenate([payload, jnp.zeros(pad, jnp.uint8)]) if pad
        else payload
    )
    p16 = jax.lax.bitcast_convert_type(
        p_even.reshape(-1, 2), jnp.uint16
    ).reshape(-1)
    ptr = (s0 + 4).astype(jnp.int32)
    prev0 = (state * 0).astype(jnp.int32)  # data-derived: shard_map vma
    mask = jnp.uint32(SCALE - 1)

    if order == 0:
        cum257 = jnp.concatenate(
            [cum_lut.astype(jnp.int32),
             jnp.full(1, SCALE, dtype=jnp.int32)]
        )
        if compact is not None:
            c_syms, c_bounds, c_S = compact
    if compact1 is not None:
        c1_syms, c1_B, c1_ctx0, c1_S = compact1

    def step(carry, _):
        state, ptr, prev = carry
        slot = (state & mask).astype(jnp.int32)
        if order == 0:
            if compact is not None:
                sym, f, c = _cmp_lookup_compact(slot, c_bounds, c_syms, c_S)
            else:
                sym, f, c = _cmp_lookup(slot, cum257)
        elif compact1 is not None:
            # prev carries the context ORDINAL; pick its bounds row with
            # masked adds (lane-last layout), then the same
            # compare-select chain as order-0
            brows_t = jnp.zeros((c1_S + 1, slot.shape[0]), jnp.int32)
            for t in range(c1_B.shape[0]):
                brows_t = brows_t + jnp.where(
                    (prev == t)[None, :], c1_B[t][:, None], 0
                )
            sym, f, c = _cmp_lookup_compact_rows(slot, brows_t, c1_S)
        else:
            sym = sym_lut[prev, slot].astype(jnp.int32)
            f = freq_lut[prev, sym].astype(jnp.uint32)
            c = cum_lut[prev, sym].astype(jnp.uint32)
        state = f * (state >> jnp.uint32(SCALE_BITS)) + (state & mask) - c
        need = state < jnp.uint32(RANS_L)
        w16 = p16[ptr >> 1].astype(jnp.uint32)  # LE view; stream is hi,lo
        word = ((w16 & 0xFF) << jnp.uint32(8)) | (w16 >> jnp.uint32(8))
        state = jnp.where(need, (state << jnp.uint32(16)) | word, state)
        ptr = jnp.where(need, ptr + 2, ptr)
        return (state, ptr, sym), sym.astype(jnp.uint8)

    init_prev = prev0 if compact1 is None else prev0 + c1_ctx0
    (_s, _p, _pr), grid = jax.lax.scan(
        step, (state, ptr, init_prev), None, length=steps, unroll=8
    )
    if compact1 is not None:
        # grid holds symbol ORDINALS; map to byte values once (S selects
        # over the whole grid, outside the scan)
        g = grid.astype(jnp.int32)
        vals = jnp.zeros_like(g) + c1_syms[0]
        for j in range(1, c1_S):
            vals = jnp.where(g == j, c1_syms[j], vals)
        grid = vals.astype(jnp.uint8)
    return grid  # (steps, lanes)


# ---------------------------------------------------------------------------
# section-level drivers, byte-compatible with rans_np.encode_section
# ---------------------------------------------------------------------------


def decode_sections_o0_batch(payloads, lane_counts, syms, bounds,
                             lanes: int, steps: int, S: int):
    """vmap-batched order-0 decode of K equal-shape sections: the decode
    scan is latency-bound on its per-step renorm gather, and batching K
    sections turns K small gathers into one K-times-wider gather per step
    — near-linear speedup in K. payloads (K, pcap) u8 (even pcap),
    lane_counts (K, lanes) i32, syms (K, S) i32, bounds (K, S+1) i32.
    Returns (K, steps, lanes) u8 symbol grids."""
    dummy = jnp.zeros(1, jnp.int32)

    def one(p, lc, s, b):
        return rans_decode_device(
            p, lc, dummy, dummy, dummy, lanes=lanes, steps=steps,
            order=0, compact=(s, b, S),
        )

    return jax.vmap(one)(payloads, lane_counts, syms, bounds)


def build_luts_grid(grid: np.ndarray, order: int):
    """Tables from a (steps, lanes) grid (lane-aware order-1 contexts)."""
    head = bytearray()
    if order == 0:
        counts = np.bincount(grid.reshape(-1), minlength=256)
        freqs = rans_np.quantize_freqs(counts)
        head += rans_np.serialize_table(freqs)
        cum = np.zeros(256, dtype=np.int64)
        cum[1:] = np.cumsum(freqs)[:-1]
        sym = np.repeat(np.arange(256, dtype=np.uint8), freqs)
        return bytes(head), freqs.astype(np.int32), cum.astype(np.int32), sym
    prev = np.zeros_like(grid)
    prev[1:] = grid[:-1]
    ctx_counts = np.bincount(
        (prev.reshape(-1).astype(np.int64) << 8) | grid.reshape(-1),
        minlength=65536,
    ).reshape(256, 256)
    freqs = np.zeros((256, 256), dtype=np.int64)
    sym = np.zeros((256, SCALE), dtype=np.uint8)
    for c in range(256):
        if ctx_counts[c].any():
            freqs[c] = rans_np.quantize_freqs(ctx_counts[c])
            sym[c] = np.repeat(np.arange(256, dtype=np.uint8), freqs[c])
    head += rans_np.pack_ctx_tables(freqs)
    cum = np.zeros((256, 256), dtype=np.int64)
    cum[:, 1:] = np.cumsum(freqs, axis=1)[:, :-1]
    return bytes(head), freqs.astype(np.int32), cum.astype(np.int32), sym


class _LruCache:
    """Bounded jit-executable cache: a long-running process over
    heterogeneous section shapes must not grow XLA compile memory without
    bound (round-2 advisor). 32 entries covers every shape a normal run
    mints (shapes are pow2-bucketed); eviction only costs a recompile."""

    def __init__(self, cap: int = 32):
        self.cap = cap
        self._d: dict = {}

    def get(self, key):
        v = self._d.get(key)
        if v is not None:  # refresh recency
            self._d.pop(key)
            self._d[key] = v
        return v

    def __setitem__(self, key, v):
        self._d.pop(key, None)
        while len(self._d) >= self.cap:
            self._d.pop(next(iter(self._d)))
        self._d[key] = v


_FAST_CACHE = _LruCache()


def _bucket_pow2(x: int, lo: int = 16) -> int:
    c = lo
    while c < x:
        c *= 2
    return c


def encode_section_device(data, order: int = 0,
                          lanes: int = rans_np.DEFAULT_LANES) -> bytes:
    """Drop-in for rans_np.encode_section (same bytes) running the scan on
    the accelerator. Falls back to the host oracle for ragged tails.
    Order-0 sections with a small alphabet take the compare-select +
    column-sort fast path (rans_encode_o0_image)."""
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    n = arr.shape[0]
    lanes = max(1, min(lanes, max(1, n)))
    if n == 0 or n % lanes != 0:
        return rans_np.encode_section(arr, order=order, lanes=lanes)
    grid = arr.reshape(lanes, n // lanes).T
    head = bytearray()
    head.append(order)
    head += int(n).to_bytes(4, "little")
    head += int(lanes).to_bytes(2, "little")
    tbl, freqs, cum, _sym = build_luts_grid(grid, order)
    head += tbl

    syms_np = np.flatnonzero(freqs) if order == 0 else None
    if order == 0 and 1 <= syms_np.shape[0] <= 32:
        body = _encode_o0_fast(arr, freqs, cum, syms_np, lanes)
        if body is not None:
            return bytes(head) + body

    out_cap = 2 * n + 4 * lanes + 8  # true worst case: one word per symbol
    payload, lane_bytes, total = jax.jit(
        rans_encode_payload_device,
        static_argnames=("lanes", "order", "out_cap"),
    )(arr, jnp.asarray(freqs), jnp.asarray(cum), lanes=lanes, order=order,
      out_cap=out_cap)
    total = int(total)
    counts = np.asarray(lane_bytes).astype("<u4")
    body = bytearray()
    body += int(total).to_bytes(4, "little")
    body += counts.tobytes()
    body += np.asarray(payload[:total]).tobytes()
    return bytes(head) + bytes(body)


def _encode_o0_fast(arr: np.ndarray, freqs: np.ndarray, cum: np.ndarray,
                    syms_np: np.ndarray, lanes: int) -> bytes | None:
    """Order-0 fast path: device emits per-lane word images in decode
    order; host concatenates the spans (trivial memcpy work). Returns the
    section body, or None when the word-cap guess was exceeded (caller
    takes the general path)."""
    from ..codec.blocks import gather_slices

    n = arr.shape[0]
    S = int(syms_np.shape[0])
    steps = n // lanes
    # expected words/lane from the exact entropy of the quantized model;
    # pad generously — a miss only means one retry via the general path
    p = freqs[syms_np] / SCALE
    bits = float(-(p * np.log2(p)).sum()) * n
    avg_w = bits / 16.0 / lanes
    maxw_cap = min(_bucket_pow2(int(avg_w * 1.7) + 24), steps)
    key = ("o0img", n, lanes, S, maxw_cap)
    fn = _FAST_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            lambda d, s, f, c: rans_encode_o0_image(
                d, s, f, c, lanes, maxw_cap, S
            )
        )
        _FAST_CACHE[key] = fn
    f_present = freqs[syms_np].astype(np.int32)
    c_present = cum[syms_np].astype(np.int32)
    state_img, word_img, wcount = fn(
        jnp.asarray(arr), jnp.asarray(syms_np.astype(np.int32)),
        jnp.asarray(f_present), jnp.asarray(c_present),
    )
    wcount = np.asarray(wcount)
    if int(wcount.max(initial=0)) > maxw_cap:
        return None
    state_img = np.asarray(state_img)
    word_img = np.asarray(word_img)
    img = np.concatenate([state_img, word_img], axis=1)
    row = img.shape[1]
    lens = 4 + 2 * wcount.astype(np.int64)
    starts = np.arange(lanes, dtype=np.int64) * row
    payload = gather_slices(img.reshape(-1), starts, lens)
    body = bytearray()
    body += int(payload.shape[0]).to_bytes(4, "little")
    body += lens.astype("<u4").tobytes()
    body += payload.tobytes()
    return bytes(body)


def decode_section_device(buf, off: int = 0) -> tuple[bytes, int]:
    """Drop-in for rans_np.decode_section with the scan on device."""
    buf = memoryview(buf)
    order = buf[off]
    n = int.from_bytes(buf[off + 1 : off + 5], "little")
    lanes = int.from_bytes(buf[off + 5 : off + 7], "little")
    off += 7
    if n == 0:
        return b"", off + 4
    if n % lanes != 0:
        return rans_np.decode_section(buf, off - 7)

    if order == 0:
        freqs, off = rans_np.parse_table(buf, off)
        cum = np.zeros(256, dtype=np.int64)
        cum[1:] = np.cumsum(freqs)[:-1]
        sym = np.repeat(np.arange(256, dtype=np.uint8), freqs)
        freqs_d, cum_d, sym_d = freqs.astype(np.int32), cum.astype(np.int32), sym
    else:
        freqs, off = rans_np.unpack_ctx_tables(buf, off)
        sym = np.zeros((256, SCALE), dtype=np.uint8)
        for c in range(256):
            if freqs[c].any():
                sym[c] = np.repeat(np.arange(256, dtype=np.uint8), freqs[c])
        cum = np.zeros((256, 256), dtype=np.int64)
        cum[:, 1:] = np.cumsum(freqs, axis=1)[:, :-1]
        freqs_d, cum_d, sym_d = freqs.astype(np.int32), cum.astype(np.int32), sym

    payload_len = int.from_bytes(buf[off : off + 4], "little")
    off += 4
    if off + 4 * lanes + payload_len > len(buf):
        raise ValueError("rANS section truncated")
    lane_counts = np.frombuffer(buf, dtype="<u4", count=lanes, offset=off).astype(
        np.int32
    )
    off += 4 * lanes
    payload = np.frombuffer(buf, dtype=np.uint8, count=payload_len, offset=off)
    off += payload_len
    # same trust boundary as the host decoder: validate before gathers
    # (clamping backends would otherwise return garbage without an error)
    if int(lane_counts.sum()) != payload_len or (lane_counts < 4).any() or (
        ((lane_counts - 4) % 2) != 0
    ).any():
        raise ValueError("rANS section lane table corrupt")
    # bucket the payload length so every section of a shape class reuses
    # one compiled decode executable
    pcap = _bucket_pow2(payload.shape[0] + 2, lo=4096)
    payload_pad = np.zeros(pcap, np.uint8)
    payload_pad[: payload.shape[0]] = payload
    steps = n // lanes
    syms_np = np.flatnonzero(freqs) if order == 0 else None
    if order == 0 and 1 <= syms_np.shape[0] <= 32:
        # compact compare-select decode: S-wide instead of 256-wide
        S = int(syms_np.shape[0])
        key = ("o0dec", pcap, lanes, steps, S)
        fn = _FAST_CACHE.get(key)
        if fn is None:
            dummy = jnp.zeros(1, jnp.int32)

            def make(lanes=lanes, steps=steps, S=S):
                def run(payload, counts, syms, bounds):
                    return rans_decode_device(
                        payload, counts, dummy, dummy, dummy,
                        lanes=lanes, steps=steps, order=0,
                        compact=(syms, bounds, S),
                    )
                return jax.jit(run)

            fn = make()
            _FAST_CACHE[key] = fn
        bounds = np.concatenate(
            [cum[syms_np], np.array([SCALE])]
        ).astype(np.int32)
        grid = fn(
            jnp.asarray(payload_pad), jnp.asarray(lane_counts),
            jnp.asarray(syms_np.astype(np.int32)), jnp.asarray(bounds),
        )
    elif order == 1 and 1 <= int(
        (union := np.flatnonzero(freqs.any(axis=0))).shape[0]
    ) <= 16:
        # order-1 compact path: context-partitioned bounds rows selected
        # by the previous symbol's ORDINAL — no (256, SCALE) gathers
        A = union
        S = int(A.shape[0])
        B = np.zeros((S + 1, S + 1), dtype=np.int32)
        for t in range(S):
            B[t, :S] = cum[A[t]][A]
            B[t, S] = SCALE
        if 0 in A:
            ctx0 = int(np.flatnonzero(A == 0)[0])
        else:
            B[S, :S] = cum[0][A]
            B[S, S] = SCALE
            ctx0 = S
        key = ("o1dec", pcap, lanes, steps, S)
        fn = _FAST_CACHE.get(key)
        if fn is None:
            dummy = jnp.zeros(1, jnp.int32)

            def make1(lanes=lanes, steps=steps, S=S):
                def run(payload, counts, syms, Bm, c0):
                    return rans_decode_device(
                        payload, counts, dummy, dummy, dummy,
                        lanes=lanes, steps=steps, order=1,
                        compact1=(syms, Bm, c0, S),
                    )
                return jax.jit(run)

            fn = make1()
            _FAST_CACHE[key] = fn
        grid = fn(
            jnp.asarray(payload_pad), jnp.asarray(lane_counts),
            jnp.asarray(A.astype(np.int32)), jnp.asarray(B),
            jnp.int32(ctx0),
        )
    else:
        grid = jax.jit(
            rans_decode_device,
            static_argnames=("lanes", "steps", "order"),
        )(
            jnp.asarray(payload_pad), jnp.asarray(lane_counts),
            jnp.asarray(sym_d), jnp.asarray(freqs_d), jnp.asarray(cum_d),
            lanes=lanes, steps=steps, order=order,
        )
    return np.asarray(grid).T.reshape(-1).tobytes(), off
