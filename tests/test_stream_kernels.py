"""The device codec's elementwise front end, base unpack and token FSM
(ops/device_streams.py) against the host kernels, byte for byte, at the
lengths where padding and block edges matter."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repaq_tpu.codec import kernels_np as K  # noqa: E402
from repaq_tpu.ops import device_streams as D  # noqa: E402

SIZES = [4, 512, 513, 4096, 100_000, 262_144]
BINS = np.frombuffer(b"#,:", dtype=np.uint8)  # palette minus the major
MAJOR = ord("F")


def _rand_seq(n, seed, n_frac=0.02):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8), size=n)
    seq[rng.random(n) < n_frac] = ord("N")
    return seq


def _rand_qual(n, seed):
    rng = np.random.default_rng(seed + 1)
    qual = rng.choice(np.frombuffer(b"FFFF::,,#", dtype=np.uint8), size=n)
    qual[rng.random(n) < 0.001] = ord("!")  # escapes: outside the palette
    return qual


def _want_meta(seq, qual):
    """Meta byte per base: bin id (0..B-1 palette, B escape, B+1 major)
    in bits 0-6, N flag in bit 7 — the LUT construction of
    qualcol_encode_device."""
    nb = len(BINS)
    lut = np.full(256, nb, dtype=np.uint8)
    lut[BINS] = np.arange(nb)
    lut[MAJOR] = nb + 1
    return lut[qual] | ((seq == ord("N")).astype(np.uint8) << 7)


def _frontend(seq, qual):
    """Engine layout: pad to whole u32 words with 'G' / the major qual,
    run the word-packed front end, return (packed, meta bytes) for the
    first n bases."""
    n = seq.shape[0]
    pad = (-n) % 4
    s = np.concatenate([seq, np.full(pad, ord("G"), np.uint8)])
    q = np.concatenate([qual, np.full(pad, MAJOR, np.uint8)])
    packed, meta32 = jax.jit(D.encode_frontend_meta32)(
        jnp.asarray(s.view("<u4")), jnp.asarray(q.view("<u4")),
        jnp.asarray(BINS), jnp.uint8(MAJOR),
    )
    meta = np.asarray(meta32).view(np.uint8)[:n]
    return np.asarray(packed)[: (n + 3) // 4], meta


@pytest.mark.parametrize("n", SIZES)
def test_frontend_matches_host(n):
    seq, qual = _rand_seq(n, seed=n), _rand_qual(n, seed=n)
    packed, meta = _frontend(seq, qual)
    assert packed.tobytes() == K.pack_2bit(seq).tobytes()
    assert meta.tobytes() == _want_meta(seq, qual).tobytes()


def test_frontend_nonmultiple_length_pads_with_code_zero():
    """A 777-base chunk: the 'G' word padding packs to the reference's
    zero-padded final byte and classifies as major (dropped)."""
    n = 777
    seq, qual = _rand_seq(n, seed=5), _rand_qual(n, seed=5)
    packed, meta = _frontend(seq, qual)
    assert packed.shape[0] == (n + 3) // 4
    assert packed[-1] >> 2 == 0  # bases past n are code 0
    assert meta.tobytes() == _want_meta(seq, qual).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_pack_matches_host(n):
    seq = _rand_seq(n, seed=n)
    padded = np.concatenate([seq, np.full((-n) % 4, ord("G"), np.uint8)])
    got = np.asarray(jax.jit(D.pack_2bit_device)(jnp.asarray(padded)))
    assert got.tobytes() == K.pack_2bit(seq).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_unpack_matches_host(n):
    packed = K.pack_2bit(_rand_seq(n, seed=n, n_frac=0.0))
    got = np.asarray(jax.jit(D.unpack_2bit_device)(jnp.asarray(packed)))
    assert got.tobytes() == K.unpack_2bit(packed, 4 * packed.shape[0]).tobytes()


def _host_starts(lens, force):
    """Token starts by a serial walk: each forced byte restarts the
    grammar, otherwise a token of lens[i] bytes starts where the last
    one ended."""
    starts = np.zeros(lens.shape[0], dtype=bool)
    nxt = 0
    for i in range(lens.shape[0]):
        if force[i] or i == nxt:
            starts[i] = True
            nxt = i + int(lens[i])
    return starts


@pytest.mark.parametrize("n", SIZES)
def test_token_fsm_matches_serial_walk(n):
    rng = np.random.default_rng(n)
    lens = rng.choice([1, 1, 2, 4], size=n).astype(np.int32)
    force = rng.random(n) < 0.002
    got = np.asarray(jax.jit(D.token_start_mask)(
        jnp.asarray(lens), jnp.asarray(force)))
    assert np.array_equal(got, _host_starts(lens, force))


def test_token_fsm_without_forced_restarts():
    rng = np.random.default_rng(1)
    lens = rng.choice([1, 2, 4], size=5000).astype(np.int32)
    want = _host_starts(lens, np.zeros(5000, bool))
    got = np.asarray(D.token_start_mask(jnp.asarray(lens)))
    assert np.array_equal(got, want)


# (lens, force) at lengths around the scan's 64-byte blocks: tokens that
# straddle a block edge, restarts on every edge and on every byte
BLOCK_EDGE_CASES = {
    "4-byte tokens, 130 bytes": (np.full(130, 4), np.zeros(130, bool)),
    "2-byte tokens, 127 bytes": (np.full(127, 2), np.zeros(127, bool)),
    "restart every block, 193 bytes": (
        np.full(193, 4), np.arange(193) % 64 == 0),
    "restart mid-token, 65 bytes": (np.full(65, 4), np.arange(65) == 62),
    "restart every byte, 64 bytes": (np.full(64, 4), np.ones(64, bool)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_EDGE_CASES))
def test_token_fsm_block_edges(case):
    lens, force = BLOCK_EDGE_CASES[case]
    lens = lens.astype(np.int32)
    got = np.asarray(jax.jit(D.token_start_mask)(
        jnp.asarray(lens), jnp.asarray(force)))
    assert np.array_equal(got, _host_starts(lens, force))


def test_token_fsm_forced_restarts_on_qual_stream():
    """A real by-column qual stream: every bin stream restarts the
    grammar at its first byte; the device mask equals the host kernels'
    token walk of each bin stream."""
    rng = np.random.default_rng(9)
    qual = rng.choice(np.frombuffer(b"FFF:FFF,F:#", np.uint8), size=50_000)
    buf = K.encode_qual_by_col(qual, BINS, MAJOR)
    nb = len(BINS)
    seg_lens = buf[: 4 * nb].view("<u4").astype(np.int64)
    stream = buf[4 * nb : 4 * nb + int(seg_lens.sum())]
    force = np.zeros(stream.shape[0], dtype=bool)
    want = []
    off = 0
    for ln in seg_lens:
        force[off] = True
        seg = stream[off : off + ln]
        want.append(K._token_starts(seg, K._stream_token_lens(seg)) + off)
        off += int(ln)
    lens = K._stream_token_lens(stream).astype(np.int32)
    got = np.asarray(jax.jit(D.token_start_mask)(
        jnp.asarray(lens), jnp.asarray(force)))
    assert np.array_equal(np.flatnonzero(got), np.concatenate(want))


def test_device_blocks_roundtrip():
    """device_encode_block / device_decode_block (the mesh step's kernel
    stack) roundtrip a block with Ns, escapes-free palette quals."""
    from repaq_tpu.parallel.mesh import device_decode_block, device_encode_block

    rng = np.random.default_rng(0)
    B, L = 64, 64
    seq = rng.choice(np.frombuffer(b"GATCN", dtype=np.uint8), size=(B, L))
    qual = rng.choice(np.frombuffer(b"FF:,#", dtype=np.uint8), size=(B, L))
    xs = rng.integers(1000, 4000, size=B).astype(np.int32)
    ys = rng.integers(1000, 4000, size=B).astype(np.int32)
    in_table = np.zeros(256, dtype=bool)
    in_table[BINS] = True
    in_table[MAJOR] = True
    o = device_encode_block(seq, qual, xs, ys, BINS, jnp.uint8(MAJOR),
                            in_table)
    o = {k: np.asarray(v) for k, v in o.items()}
    assert o["packed"].tobytes() == K.pack_2bit(seq.reshape(-1)).tobytes()
    s2, q2 = device_decode_block(
        o["packed"], o["qual"], int(o["qual_len"]), o["npos"],
        int(o["npos_len"]), BINS, jnp.uint8(MAJOR), B, L,
    )
    assert np.array_equal(np.asarray(s2), seq)
    assert np.array_equal(np.asarray(q2), qual)
