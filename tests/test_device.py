"""Device (JAX) kernels vs host kernels: byte-exact equivalence on the CPU
backend (conftest forces JAX_PLATFORMS=cpu with 8 virtual devices)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repaq_tpu.codec import kernels_np as K  # noqa: E402
from repaq_tpu.format.header import RfqHeader  # noqa: E402
from repaq_tpu.ops import device_streams as D  # noqa: E402


# fixed shapes so jit caches across trials (False-padding a mask does not
# change its byte stream)
_N = 1 << 15


@jax.jit
def _enc_mask(m):
    return D.encode_positions_from_mask(m, _N // 2 + 8)


def _run_mask(mask: np.ndarray) -> bytes:
    padded = np.zeros(_N, dtype=bool)
    padded[: mask.shape[0]] = mask
    out, ln = _enc_mask(jnp.asarray(padded))
    return bytes(np.asarray(out)[: int(ln)])


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 0.95, 1.0])
def test_positions_stream_device(density):
    rng = np.random.default_rng(int(density * 100) + 1)
    for n in (1, 7, 100, 5000):
        mask = rng.random(n) < density
        want = K.encode_positions(np.flatnonzero(mask))
        assert _run_mask(mask) == want.tobytes(), (n, density)


def test_positions_long_gaps_device():
    for gap in (127, 128, 129, 16384, 16385, 30000):
        mask = np.zeros(gap + 40, dtype=bool)
        mask[gap] = True
        mask[gap + 1] = True
        mask[gap + 5 : gap + 40] = True
        want = K.encode_positions(np.flatnonzero(mask))
        assert _run_mask(mask) == want.tobytes(), gap


def test_qualcol_device():
    rng = np.random.default_rng(5)
    for trial in range(4):
        n = 4000  # fixed shape; padding with the major qual is a no-op
        table = rng.choice(
            np.arange(33, 90, dtype=np.uint8), size=int(rng.integers(2, 7)),
            replace=False,
        )
        qual = rng.choice(table, size=n)
        if trial % 2:
            qual[rng.integers(0, n, size=3)] = 100  # escapes
        h = RfqHeader()
        seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8), size=n)
        h.make_quality_table(seq, np.sort(table.repeat(2)))
        bins = h.normal_qual_buf()
        want = K.encode_qual_by_col(qual, bins, h.major_qual())
        in_table = np.zeros(256, dtype=bool)
        in_table[bins] = True
        in_table[h.major_qual()] = True
        out, ln = jax.jit(D.qualcol_encode_device)(
            jnp.asarray(qual), jnp.asarray(bins), jnp.uint8(h.major_qual()),
            jnp.asarray(in_table),
        )
        got = np.asarray(out)[: int(ln)]
        assert bytes(got) == want.tobytes(), trial


@jax.jit
def _enc_coords(v):
    return D.coords_encode_device(v, 3 * v.shape[0] + 8)


def test_coords_device():
    rng = np.random.default_rng(9)
    for trial in range(4):
        n = 800
        vals = []
        last = 1000
        for _ in range(n):
            r = rng.random()
            if r < 0.35:
                vals.append(last)
            elif r < 0.65:
                last = last + int(rng.integers(1, 65))
                vals.append(last)
            else:
                last = int(rng.integers(0, 1 << 21))
                vals.append(last)
        vals = np.array(vals, dtype=np.int64)
        want = K.encode_coords(vals)
        out, ln = _enc_coords(jnp.asarray(vals.astype(np.int32)))
        assert bytes(np.asarray(out)[: int(ln)]) == want.tobytes(), trial
    # long repeats incl. 32-groups
    vals = np.array([1000] * 100 + [5] * 33 + [6, 6, 6] + list(range(7, 100)),
                    dtype=np.int64)
    want = K.encode_coords(vals)
    out, ln = D.coords_encode_device(jnp.asarray(vals.astype(np.int32)),
                                     3 * vals.shape[0] + 8)
    assert bytes(np.asarray(out)[: int(ln)]) == want.tobytes()


def test_pack_unpack_device():
    rng = np.random.default_rng(3)
    seq = rng.choice(np.frombuffer(b"GATCN", dtype=np.uint8), size=4096)
    want = K.pack_2bit(seq)
    got = np.asarray(D.pack_2bit_device(jnp.asarray(seq)))
    assert bytes(got) == want.tobytes()
    back = np.asarray(D.unpack_2bit_device(jnp.asarray(got)))
    assert bytes(back) == K.unpack_2bit(want, 4096).tobytes()


def test_revcomp_device():
    rng = np.random.default_rng(4)
    seqs = rng.choice(np.frombuffer(b"GATCN", dtype=np.uint8), size=(16, 100))
    got = np.asarray(D.revcomp_device(jnp.asarray(seqs)))
    from repaq_tpu.codec.oracle import reverse_complement

    for i in range(16):
        assert bytes(got[i]) == reverse_complement(seqs[i].tobytes())


def test_histogram_device():
    rng = np.random.default_rng(6)
    qual = rng.integers(33, 90, size=10000).astype(np.uint8)
    got = np.asarray(D.qual_histogram_device(jnp.asarray(qual)))
    want = np.bincount(qual, minlength=128)[:128]
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# decode side
# ---------------------------------------------------------------------------


def test_decode_positions_device():
    rng = np.random.default_rng(8)
    for density in (0.02, 0.3, 0.95):
        n = 6000
        mask = rng.random(n) < density
        enc = K.encode_positions(np.flatnonzero(mask))
        buf = np.zeros(enc.shape[0] + 8, dtype=np.uint8)
        buf[: enc.shape[0]] = enc
        pos, cnt = D.decode_positions_device(
            jnp.asarray(buf), jnp.int32(enc.shape[0]), n
        )
        want = np.flatnonzero(mask)
        assert int(cnt) == want.shape[0]
        assert np.array_equal(np.asarray(pos)[: want.shape[0]], want)


def test_qualcol_decode_device():
    rng = np.random.default_rng(15)
    for trial in range(4):
        n = 3000
        table = rng.choice(
            np.arange(33, 90, dtype=np.uint8), size=5, replace=False
        )
        qual = rng.choice(table, size=n)
        if trial % 2:
            qual[rng.integers(0, n, size=4)] = 100  # escapes
        h = RfqHeader()
        seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8), size=n)
        h.make_quality_table(seq, np.sort(table.repeat(2)))
        bins = h.normal_qual_buf()
        enc = K.encode_qual_by_col(qual, bins, h.major_qual())
        buf = np.zeros(enc.shape[0] + 8, dtype=np.uint8)
        buf[: enc.shape[0]] = enc
        got = D.qualcol_decode_device(
            jnp.asarray(buf), len(bins), jnp.asarray(bins),
            jnp.uint8(h.major_qual()), n, jnp.int32(enc.shape[0]),
        )
        want = K.decode_qual_by_col(enc, bins, h.major_qual(), n)
        assert np.asarray(got).tobytes() == want.tobytes(), trial


def test_overlap_pairs_device_matches_host():
    """Device overlap search (double-u32-hash candidates + exact masked
    verify) must agree with the host hash search / scalar oracle."""
    import numpy as np

    from repaq_tpu.codec.vectorized import _overlap_pairs
    from repaq_tpu.ops.device_streams import overlap_pairs_device

    rng = np.random.default_rng(0)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    P, L = 512, 100
    r1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(P, L))
    r2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(P, L))
    # craft forward overlaps (r2 here is the already-revcomped mate)
    for i in range(0, P, 3):
        o = int(rng.integers(12, L + 1))
        r2[i, :o] = r1[i, L - o :]
    # craft backward overlaps
    for i in range(1, P, 5):
        o = int(rng.integers(12, L + 1))
        r2[i, L - o :] = r1[i, :o]
    # N's inside some overlap windows (still exact matches when equal)
    r1[7, L - 30 :] = ord("N")
    r2[7, :30] = ord("N")

    want = _overlap_pairs(r1, r2)
    ov, collision = overlap_pairs_device(r1, r2)
    assert not np.asarray(collision).any()
    assert np.array_equal(np.asarray(ov), want)

    # unequal lengths + too-short reads
    r1s = r1[:, :40]
    r2s = r2[:, :64]
    want = _overlap_pairs(r1s, r2s)
    ov, collision = overlap_pairs_device(r1s, r2s)
    assert not np.asarray(collision).any()
    assert np.array_equal(np.asarray(ov), want)

    tiny = r1[:, :8]
    ov, collision = overlap_pairs_device(tiny, tiny)
    assert np.asarray(ov).sum() == 0


def test_emission_wide_path_matches_host(monkeypatch):
    """The two-operand (offset, byte) layout sort — engaged when the
    emission output exceeds _WIDE_THRESHOLD, i.e. >8 MB streams from
    16 Mbase blocks (round 4) — must be byte-exact with the host kernels.
    Forced here by dropping the threshold so small fixtures take it."""
    monkeypatch.setattr(D, "_WIDE_THRESHOLD", 64)
    rng = np.random.default_rng(11)

    # qualcol (lazy emitter with header-table + escape extras)
    n = 4000
    table = np.array([40, 50, 60], dtype=np.uint8)
    qual = rng.choice(table, size=n)
    qual[rng.integers(0, n, size=5)] = 101  # escapes
    h = RfqHeader()
    seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8), size=n)
    h.make_quality_table(seq, np.sort(table.repeat(3)))
    bins = h.normal_qual_buf()
    want = K.encode_qual_by_col(qual, bins, h.major_qual())
    in_table = np.zeros(256, dtype=bool)
    in_table[bins] = True
    in_table[h.major_qual()] = True
    out, ln = jax.jit(D.qualcol_encode_device)(
        jnp.asarray(qual), jnp.asarray(bins), jnp.uint8(h.major_qual()),
        jnp.asarray(in_table),
    )
    assert bytes(np.asarray(out)[: int(ln)]) == want.tobytes()

    # positions stream (lazy emitter, no extras)
    for density in (0.02, 0.5):
        mask = rng.random(3000) < density
        want_p = K.encode_positions(np.flatnonzero(mask))
        o2, l2 = jax.jit(
            lambda m: D.encode_positions_from_mask(m, 3000 // 2 + 8)
        )(jnp.asarray(mask))
        assert bytes(np.asarray(o2)[: int(l2)]) == want_p.tobytes()

    # coords (dense-planes emitter)
    vals = np.concatenate([
        np.full(40, 1234), np.arange(2000, 2100),
        rng.integers(1, 200000, size=500),
    ]).astype(np.int32)
    want_c = K.encode_coords(vals.astype(np.int64))
    o3, l3 = jax.jit(
        lambda v: D.coords_encode_device(v, 3 * v.shape[0] + 8)
    )(jnp.asarray(vals))
    assert bytes(np.asarray(o3)[: int(l3)]) == want_c.tobytes()


def test_frontend_meta32_path_matches_host():
    """The word-packed frontend path (encode_frontend_meta32 +
    qualcol/npos consuming meta32 directly) must produce byte-exact
    streams vs the host kernels."""
    rng = np.random.default_rng(3)
    n = 8192  # multiple of 512
    table = np.array([35, 44, 58], dtype=np.uint8)
    major = np.uint8(70)
    qual = rng.choice(np.concatenate([table, np.full(18, major)]), size=n)
    qual[rng.integers(0, n, size=4)] = 99  # escapes
    seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8), size=n)
    nmask = rng.random(n) < 0.01
    seq[nmask] = ord("N")

    want_q = K.encode_qual_by_col(qual, table, int(major))
    want_np = K.encode_positions(np.flatnonzero(seq == ord("N")))
    want_packed = K.pack_2bit(np.where(seq == ord("N"), ord("G"), seq))

    s32 = jnp.asarray(seq.view("<u4"))
    q32 = jnp.asarray(qual.view("<u4"))

    @jax.jit
    def step(s32_, q32_):
        packed, meta32 = D.encode_frontend_meta32(
            s32_, q32_, jnp.asarray(table), jnp.uint32(major)
        )
        qo, ql = D.qualcol_encode_device(
            None, jnp.asarray(table), major, None,
            esc_cap=16, meta32=meta32, qual32=q32_, n=n,
        )
        no, nl = D.encode_positions_from_meta32(meta32, n, n // 2 + 8,
                                                pos_cap=256)
        return packed, qo, ql, no, nl

    packed, qo, ql, no, nl = step(s32, q32)
    assert bytes(np.asarray(packed)) == want_packed.tobytes()
    assert bytes(np.asarray(qo)[: int(ql)]) == want_q.tobytes()
    assert bytes(np.asarray(no)[: int(nl)]) == want_np.tobytes()
