"""The production device engine (codec/device_engine.py) must be
byte-identical to the host engine on every chunk it claims, fall back
transparently otherwise, and roundtrip through the real CLI pipelines.
Runs on the CPU backend; the GPU pass of the same engine runs in
chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

from repaq_tpu.codec import vectorized
from repaq_tpu.codec.blocks import ReadBlock, lens_to_offsets
from repaq_tpu.codec.device_engine import DeviceEngine
from repaq_tpu.codec.names import build_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_block(n, L, seed=0, illumina=True, nfrac=0.01, esc=False,
              pe_overlap=0.0):
    rng = np.random.default_rng(seed)
    seqs = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(n, L))
    quals = rng.choice(np.frombuffer(b"FFF,:#", dtype=np.uint8), size=(n, L))
    nmask = rng.random((n, L)) < nfrac
    seqs[nmask] = ord("N")
    quals[nmask] = ord("#")
    if esc:
        # a char outside the first-chunk palette (forces escape records)
        quals[0, : L // 8] = ord("!")
    if pe_overlap > 0:
        comp = np.zeros(256, dtype=np.uint8)
        for a, b in zip(b"ACGTN", b"TGCAN"):
            comp[a] = b
        ov_rows = np.flatnonzero(rng.random(n // 2) < pe_overlap)
        for p in ov_rows:
            o = int(rng.integers(20, L - 5))
            r2rc = np.concatenate([seqs[2 * p, L - o :], seqs[2 * p + 1, : L - o]])
            seqs[2 * p + 1] = comp[r2rc][::-1]
    xs = rng.integers(1000, 40000, size=n).astype(np.int64)
    ys = rng.integers(1000, 40000, size=n).astype(np.int64)
    if pe_overlap > 0:  # pairs share coords like real interleaved data
        xs[1::2] = xs[0::2]
        ys[1::2] = ys[0::2]
    if illumina:
        pre = b"@SIM:1:FCX:2:1101"
        n2 = b" 1:N:0:ATCCGA"
        name_flat, name_off = build_names(
            n,
            np.frombuffer(pre, dtype=np.uint8),
            np.zeros(n, dtype=np.int64),
            np.full(n, len(pre), dtype=np.int64),
            None, None, xs, ys,
            np.frombuffer(n2 + n2.replace(b" 1:", b" 2:"), dtype=np.uint8),
            np.where(np.arange(n) % 2 == 1, len(n2), 0).astype(np.int64)
            if pe_overlap > 0 else np.zeros(n, dtype=np.int64),
            np.full(n, len(n2), dtype=np.int64),
        )
    else:
        names = [b"@read_%06d_bgi" % i for i in range(n)]
        name_flat = np.frombuffer(b"".join(names), dtype=np.uint8)
        name_off = lens_to_offsets(
            np.array([len(x) for x in names], dtype=np.int64)
        )
    lens = np.full(n, L, dtype=np.int64)
    off = lens_to_offsets(lens)
    strand = np.full(n, ord("+"), dtype=np.uint8)
    return ReadBlock(
        n, name_flat, name_off, seqs.reshape(-1), off, strand,
        lens_to_offsets(np.ones(n, dtype=np.int64)), quals.reshape(-1),
        off.copy(),
    )


@pytest.fixture(scope="module")
def eng():
    return DeviceEngine(min_bases=0)


@pytest.mark.parametrize("illumina", [True, False])
@pytest.mark.parametrize("nfrac", [0.0, 0.02])
def test_se_encode_byte_identical(eng, illumina, nfrac):
    block = _mk_block(600, 101, seed=3, illumina=illumina, nfrac=nfrac)
    header = vectorized.make_header_se(block)
    want = vectorized.encode_chunk(header, block, False)
    got = eng.encode_chunk(header, block, False)
    assert eng.stats["device_chunks"] >= 1
    assert got.to_bytes() == want.to_bytes()


def test_se_escape_records(eng):
    """Out-of-palette qual chars appearing after the header chunk."""
    first = _mk_block(400, 80, seed=5)
    header = vectorized.make_header_se(first)
    block = _mk_block(400, 80, seed=6, esc=True)
    want = vectorized.encode_chunk(header, block, False)
    got = eng.encode_chunk(header, block, False)
    assert got.to_bytes() == want.to_bytes()


def test_pe_interleaved_overlap_byte_identical(eng):
    block = _mk_block(600, 96, seed=7, pe_overlap=0.5)
    header = vectorized.make_header_pe(block)
    assert header.encode_pe_by_overlap()
    want = vectorized.encode_chunk(header, block, True)
    got = eng.encode_chunk(header, block, True)
    assert got.to_bytes() == want.to_bytes()
    assert eng.stats["device_chunks"] >= 1


def test_decode_byte_identical(eng):
    for seed, pe, ov in ((11, False, 0.0), (12, True, 0.6)):
        block = _mk_block(500, 90, seed=seed, pe_overlap=ov)
        mk = vectorized.make_header_pe if pe else vectorized.make_header_se
        header = mk(block)
        chunk = vectorized.encode_chunk(header, block, pe)
        want = vectorized.decode_chunk(header, chunk)
        got = eng.decode_chunk(header, chunk)
        assert got.n == want.n
        for f in ("name_flat", "seq_flat", "strand_flat", "qual_flat",
                  "seq_off", "name_off"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert eng.stats["device_decodes"] >= 1


def test_ragged_se_encodes_on_device(eng):
    """Ragged SE chunks take the DEVICE path since round 3 (the flat
    streams are position-addressed — only the PE grid needs uniform
    lengths), byte-identical to the host engine, and roundtrip."""
    block = _mk_block(300, 70, seed=13)
    lens = np.diff(block.seq_off).copy()
    lens[5] -= 3
    lens[17] -= 9
    off = lens_to_offsets(lens)
    ragged = ReadBlock(
        block.n, block.name_flat, block.name_off,
        np.concatenate([
            block.seq_flat[s : s + l]
            for s, l in zip(block.seq_off[:-1], lens)
        ]),
        off, block.strand_flat, block.strand_off,
        np.concatenate([
            block.qual_flat[s : s + l]
            for s, l in zip(block.qual_off[:-1], lens)
        ]),
        off.copy(),
    )
    header = vectorized.make_header_se(ragged)
    before = eng.stats["device_chunks"]
    want = vectorized.encode_chunk(header, ragged, False)
    got = eng.encode_chunk(header, ragged, False)
    assert eng.stats["device_chunks"] == before + 1
    assert got.to_bytes() == want.to_bytes()
    back = eng.decode_chunk(header, got)
    assert np.array_equal(back.seq_flat, ragged.seq_flat)
    assert np.array_equal(back.qual_flat, ragged.qual_flat)


def test_cli_device_engine_golden(tmp_path):
    """Full CLI with --engine device forced onto small fixtures must still
    emit the reference encoder's exact bytes and roundtrip."""
    fx = os.path.join(REPO, "tests", "fixtures")
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPAQ_DEVICE_MIN_BASES="0",
               PYTHONPATH=REPO)
    import gzip

    for base, golden, pe in (
        ("se_big", "se_big.ref.k100.rfq", False),
        ("pe_big", "pe_big.ref.k100.rfq", True),
    ):
        if pe:
            f1 = tmp_path / "r1.fq"
            f2 = tmp_path / "r2.fq"
            f1.write_bytes(gzip.open(os.path.join(fx, base + "_R1.fq.gz")).read())
            f2.write_bytes(gzip.open(os.path.join(fx, base + "_R2.fq.gz")).read())
            args = ["-c", "-i", str(f1), "-I", str(f2)]
        else:
            f1 = tmp_path / "in.fq"
            f1.write_bytes(gzip.open(os.path.join(fx, base + ".fq.gz")).read())
            args = ["-c", "-i", str(f1)]
        out = tmp_path / (base + ".rfq")
        r = subprocess.run(
            [sys.executable, "-m", "repaq_tpu.cli", *args, "-o", str(out),
             "-k", "100", "--engine", "device"],
            env=env, capture_output=True, text=True,
        )
        assert r.returncode == 0, r.stderr
        with open(os.path.join(fx, golden), "rb") as f:
            assert out.read_bytes() == f.read(), base
        # decode with the device engine too
        if pe:
            d1, d2 = tmp_path / "d1.fq", tmp_path / "d2.fq"
            r = subprocess.run(
                [sys.executable, "-m", "repaq_tpu.cli", "-d", "-i", str(out),
                 "-o", str(d1), "-O", str(d2), "--engine", "device"],
                env=env, capture_output=True, text=True,
            )
            assert r.returncode == 0, r.stderr
            assert d1.read_bytes() == f1.read_bytes()
            assert d2.read_bytes() == f2.read_bytes()
        else:
            d1 = tmp_path / "d.fq"
            r = subprocess.run(
                [sys.executable, "-m", "repaq_tpu.cli", "-d", "-i", str(out),
                 "-o", str(d1), "--engine", "device"],
                env=env, capture_output=True, text=True,
            )
            assert r.returncode == 0, r.stderr
            assert d1.read_bytes() == f1.read_bytes()


def test_device_quality_stats_header_identical(eng):
    """On-device histogram + N-policy reductions must yield the identical
    header bytes (reference rfqheader.cpp:130-237 policy)."""
    cases = [
        _mk_block(700, 120, seed=31, nfrac=0.02),   # many Ns, shared # qual
        _mk_block(700, 120, seed=32, nfrac=0.0),    # no Ns
        _mk_block(700, 120, seed=33, nfrac=0.0005), # <100 Ns -> npos anyway
    ]
    for block in cases:
        want = vectorized.make_header_se(block)
        got = vectorized.make_header_se(block, stats_fn=eng.quality_stats)
        assert got.to_bytes() == want.to_bytes()
    pe = _mk_block(600, 96, seed=34, pe_overlap=0.5, nfrac=0.01)
    want = vectorized.make_header_pe(pe)
    got = vectorized.make_header_pe(pe, stats_fn=eng.quality_stats)
    assert got.to_bytes() == want.to_bytes()
    assert got.support_interleaved == want.support_interleaved


def test_device_quality_stats_nbasequal_policy(eng):
    """Unique N-qual with >=100 Ns must pick the nBaseQual path (no npos
    stream) through the device stats too."""
    block = _mk_block(800, 120, seed=35, nfrac=0.02)
    # force: all N quals '#', and no non-N position ever uses '#'
    seqs = block.seq_flat.copy()
    quals = block.qual_flat.copy()
    quals[quals == ord("#")] = ord(",")
    nm = seqs == ord("N")
    assert nm.sum() >= 100
    quals[nm] = ord("#")
    block2 = ReadBlock(
        block.n, block.name_flat, block.name_off, seqs, block.seq_off,
        block.strand_flat, block.strand_off, quals, block.qual_off,
    )
    want = vectorized.make_header_se(block2)
    assert not want.encode_n_pos() and want.n_base_qual == ord("#")
    got = vectorized.make_header_se(block2, stats_fn=eng.quality_stats)
    assert got.to_bytes() == want.to_bytes()


def test_oversized_many_bin_chunk_never_aborts():
    """VERDICT r1 item 10: a chunk past the device-size limit (the
    emission sort's 2^23 dest packing) with many quality bins must take
    the host path transparently — byte-identical output, no assert."""
    eng2 = DeviceEngine(min_bases=0, max_bases=50_000)  # tiny limit
    rng = np.random.default_rng(41)
    n, L = 1200, 60  # 72k bases > max_bases
    quals64 = np.arange(33, 33 + 60, dtype=np.uint8)  # ~60 distinct bins
    block = _mk_block(n, L, seed=41)
    q = rng.choice(quals64, size=n * L).astype(np.uint8)
    big = ReadBlock(
        block.n, block.name_flat, block.name_off, block.seq_flat,
        block.seq_off, block.strand_flat, block.strand_off, q,
        block.qual_off,
    )
    header = vectorized.make_header_se(big)
    before = eng2.stats["host_chunks"]
    want = vectorized.encode_chunk(header, big, False)
    got = eng2.encode_chunk(header, big, False)
    assert eng2.stats["host_chunks"] == before + 1  # fell back, no abort
    assert got.to_bytes() == want.to_bytes()
    # decode side same boundary
    dec = eng2.decode_chunk(header, got)
    assert np.array_equal(dec.qual_flat, big.qual_flat)


def test_device_boundary_chunk_exact():
    """A chunk exactly at the device eligibility boundary encodes on
    device; one base over goes host — both byte-identical."""
    eng2 = DeviceEngine(min_bases=0, max_bases=30_000)
    at = _mk_block(300, 100, seed=42)       # exactly 30k bases
    over = _mk_block(301, 100, seed=42)     # 30.1k
    header = vectorized.make_header_se(at)
    d0 = eng2.stats["device_chunks"]
    got_at = eng2.encode_chunk(header, at, False)
    assert eng2.stats["device_chunks"] == d0 + 1
    h0 = eng2.stats["host_chunks"]
    header2 = vectorized.make_header_se(over)
    got_over = eng2.encode_chunk(header2, over, False)
    assert eng2.stats["host_chunks"] == h0 + 1
    assert got_at.to_bytes() == vectorized.encode_chunk(header, at, False).to_bytes()
    assert got_over.to_bytes() == vectorized.encode_chunk(header2, over, False).to_bytes()


def test_cli_device_engine_rfqz(tmp_path):
    """--engine device with a .rfqz target runs the device rANS for the
    second stage too; roundtrip must be lossless."""
    import gzip

    fx = os.path.join(REPO, "tests", "fixtures")
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPAQ_DEVICE_MIN_BASES="0",
               PYTHONPATH=REPO)
    f1 = tmp_path / "in.fq"
    f1.write_bytes(gzip.open(os.path.join(fx, "se_big.fq.gz")).read())
    out = tmp_path / "o.rfqz"
    r = subprocess.run(
        [sys.executable, "-m", "repaq_tpu.cli", "-c", "-i", str(f1), "-o",
         str(out), "--engine", "device"],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    back = tmp_path / "b.fq"
    r = subprocess.run(
        [sys.executable, "-m", "repaq_tpu.cli", "-d", "-i", str(out), "-o",
         str(back)],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    assert back.read_bytes() == f1.read_bytes()


def test_ragged_decode_on_device(eng):
    """Non-interleaved chunks with ragged read lengths decode on device
    (flat streams need no per-read geometry)."""
    rng = np.random.default_rng(51)
    reads = []
    from repaq_tpu.codec.oracle import FastqRead

    for i in range(400):
        L = int(rng.integers(40, 160))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        qual = bytes(rng.choice(np.frombuffer(b"FF:,#", np.uint8), size=L))
        reads.append(FastqRead(b"@SIM:1:F:2:1101:%d:%d 1:N:0:AT" % (i, i), seq, b"+", qual))
    block = ReadBlock.from_reads(reads)
    header = vectorized.make_header_se(block)
    chunk = vectorized.encode_chunk(header, block, False)
    before = eng.stats["device_decodes"]
    got = eng.decode_chunk(header, chunk)
    assert eng.stats["device_decodes"] == before + 1
    want = vectorized.decode_chunk(header, chunk)
    for f in ("name_flat", "seq_flat", "qual_flat", "seq_off"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_decode_shape_churn_bounded(eng):
    """A corpus with per-chunk varying quality statistics must compile a
    BOUNDED number of decode executables: caps are quantized to chunk
    geometry fractions, and after _MAX_DECODE_SHAPES distinct shapes the
    engine clamps to one universal shape (VERDICT r2 item 8)."""
    rng = np.random.default_rng(5)
    header = None
    for i in range(12):
        # sweep nonmajor density so every chunk's stream sizes differ
        frac = 0.02 + 0.08 * i
        b, L = 220, 64
        base = _mk_block(b, L, seed=100 + i, nfrac=0.0)
        qual = np.where(
            rng.random(b * L) < frac,
            rng.choice(np.frombuffer(b"#:,", np.uint8), size=b * L),
            np.uint8(ord("F")),
        ).astype(np.uint8)
        block = ReadBlock(
            b, base.name_flat, base.name_off, base.seq_flat, base.seq_off,
            base.strand_flat, base.strand_off, qual, base.qual_off,
        )
        if header is None:
            header = vectorized.make_header_se(block)
        chunk = eng.encode_chunk(header, block, False)
        back = eng.decode_chunk(header, chunk)
        assert np.array_equal(back.qual_flat, qual)
    n_dec = len(eng._dec_cache)
    assert n_dec <= eng._MAX_DECODE_SHAPES + 1, n_dec


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lands
    in the checkout's git-ignored .jax_cache directory."""
    import types

    from repaq_tpu.codec import device_engine as de

    if env_set:
        want = str(tmp_path / "xla")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(REPO, ".jax_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    assert de.compile_cache_dir() == want

    settings = {}
    fake_jax = types.SimpleNamespace(config=types.SimpleNamespace(
        update=lambda k, v: settings.__setitem__(k, v)))
    monkeypatch.setattr(de, "_CACHE_ENABLED", False)
    monkeypatch.delenv("REPAQ_NO_COMPILE_CACHE", raising=False)
    de._enable_compile_cache(fake_jax)
    assert settings["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)


def test_engine_records_compiles_once_per_shape():
    """Each executable compiles once (ahead of time, timed) and serves
    every later chunk of its shape."""
    eng = DeviceEngine(min_bases=0)
    block = _mk_block(512, 100, seed=3, illumina=False)
    header = vectorized.make_header_se(block)
    want = vectorized.encode_chunk(header, block).to_bytes()
    for _ in range(2):
        assert eng.encode_chunk(header, block).to_bytes() == want
    assert eng.stats["device_chunks"] == 2
    assert len(eng.compile_seconds) == len(eng._enc_cache) >= 1
    assert all(s > 0 for s in eng.compile_seconds.values())


def test_engine_threads_compile_once_and_count_every_chunk():
    """Codec worker threads share one engine: each shape compiles once and
    no chunk count is lost (more threads than cores, short switch
    interval)."""
    import threading

    eng = DeviceEngine(min_bases=0)
    jits = []

    class CountingJax:
        def __getattr__(self, name):
            return getattr(eng_jax, name)

        def jit(self, fn):
            jits.append(fn)
            return eng_jax.jit(fn)

    eng_jax = eng._jax
    eng._jax = CountingJax()
    block = _mk_block(256, 80, seed=5, illumina=False)
    header = vectorized.make_header_se(block)
    want = vectorized.encode_chunk(header, block).to_bytes()
    n_threads = 2 * (os.cpu_count() or 1) + 2
    results = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda: results.append(
            eng.encode_chunk(header, block).to_bytes()))
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == [want] * n_threads
    assert eng.stats["device_chunks"] == n_threads
    assert len(jits) == len(eng._enc_cache) == len(eng.compile_seconds)
