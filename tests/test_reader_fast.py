"""Fast-reader internals: the native newline scanner and the fused PE
interleave gather must agree byte-for-byte with their pure-numpy
fallbacks on adversarial inputs (reference fastqreader.cpp semantics are
proven separately by the golden/interop suites; these tests pin the two
round-4 host fast paths to the fallback behavior)."""

import numpy as np
import pytest

from repaq_tpu.codec import _native
from repaq_tpu.io import fastq as fq

@pytest.fixture
def native():
    """Skips, at run time, where the native library is unavailable."""
    if not _native.available():
        pytest.skip("native library unavailable")


def _numpy_scan(buf: bytes, probe_start: int, start: int):
    """The pre-native _scan_new logic, as a reference."""
    probe = buf[probe_start:]
    if b"\r" in probe or b"\n\n" in probe:
        return None
    new = np.frombuffer(buf, dtype=np.uint8, count=len(buf) - start,
                        offset=start)
    return np.flatnonzero(new == ord("\n")) + start


def test_scan_newlines_matches_numpy_fuzz(native):
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"AC\nGT", dtype=np.uint8)
    danger = np.frombuffer(b"\r\n", dtype=np.uint8)
    for trial in range(300):
        n = int(rng.integers(1, 400))
        buf = rng.choice(alphabet, size=n).astype(np.uint8)
        if trial % 3 == 0 and n > 2:
            # inject danger bytes (CR or adjacent newlines)
            k = int(rng.integers(1, 4))
            pos = rng.integers(0, n, size=k)
            buf[pos] = rng.choice(danger, size=k)
        raw = buf.tobytes()
        start = int(rng.integers(0, n))
        probe_start = max(start - 1, 0)
        want = _numpy_scan(raw, probe_start, start)
        got = _native.scan_newlines(buf, probe_start, start, n)
        if want is None:
            # the numpy probe sees danger anywhere in [probe_start, end);
            # so must the native scan
            assert got is None, (trial, raw)
        else:
            assert got is not None, (trial, raw)
            np.testing.assert_array_equal(got, want)


def test_scan_newlines_seam_cases(native):
    # '\n\n' straddling the seam: first '\n' is the probe byte
    buf = np.frombuffer(b"AC\n\nGT", dtype=np.uint8)
    assert _native.scan_newlines(buf, 2, 3, 6) is None
    # seam after the pair: probe window [3,6) has a single '\n', no
    # danger — the previous scan's window already saw the '\n\n'
    assert _native.scan_newlines(buf, 3, 4, 6).size == 0
    # CR anywhere in the probed window is danger
    buf = np.frombuffer(b"ACGT\rA", dtype=np.uint8)
    assert _native.scan_newlines(buf, 0, 0, 6) is None
    # clean window: positions are absolute
    buf = np.frombuffer(b"A\nCC\nG", dtype=np.uint8)
    got = _native.scan_newlines(buf, 0, 0, 6)
    np.testing.assert_array_equal(got, [1, 4])
    # empty window
    assert _native.scan_newlines(buf, 3, 3, 3).size == 0


def _rand_pe_files(tmp_path, rng, n_pairs, crlf=False, tail_no_nl=False):
    paths = []
    for mate in (1, 2):
        recs = []
        for i in range(n_pairs):
            L = int(rng.integers(1, 40))
            seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                                   size=L))
            qual = bytes(rng.integers(33, 74, size=L, dtype=np.uint8))
            name = b"@r%d/%d" % (i, mate)
            recs.append(b"%s\n%s\n+\n%s\n" % (name, seq, qual))
        data = b"".join(recs)
        if tail_no_nl:
            data = data[:-1]
        p = tmp_path / ("pe_R%d.fq" % mate)
        p.write_bytes(data)
        paths.append(str(p))
    return paths


def test_fused_pair_consume_matches_fallback(native, tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    for trial in range(8):
        n = int(rng.integers(1, 60))
        p1, p2 = _rand_pe_files(tmp_path, rng, n, tail_no_nl=(trial % 3 == 0))
        budget = int(rng.integers(20, 400))

        def read_all(use_native):
            if not use_native:
                monkeypatch.setattr(_native, "available", lambda: False)
            else:
                monkeypatch.undo()
            rp = fq.FastqReaderPair(p1, p2)
            blocks = []
            while True:
                blk, f1, f2 = rp.read_pair_block(budget)
                if blk is None or blk.n == 0:
                    break
                blocks.append((blk, f1, f2))
            rp.left.close()
            if rp.right:
                rp.right.close()
            return blocks

        a = read_all(True)
        b = read_all(False)
        assert len(a) == len(b)
        for (ba, fa1, fa2), (bb, fb1, fb2) in zip(a, b):
            assert (fa1, fa2) == (fb1, fb2)
            assert ba.n == bb.n
            for fld in ("name", "seq", "strand", "qual"):
                np.testing.assert_array_equal(
                    getattr(ba, fld + "_flat"), getattr(bb, fld + "_flat"))
                np.testing.assert_array_equal(
                    getattr(ba, fld + "_off"), getattr(bb, fld + "_off"))


def test_single_unterminated_record_roundtrips(tmp_path):
    """A file that is exactly one record with no trailing newline has
    zero fully-terminated rows (count_term == 0) — this crashed the bulk
    reader's line-table arithmetic before round 4 (verified byte-exact
    against the reference binary after the fix)."""
    from repaq_tpu import pipeline

    src = tmp_path / "one.fq"
    src.write_bytes(b"@r0\nACGT\n+\nIIII")
    rfq = tmp_path / "one.rfq"
    back = tmp_path / "back.fq"
    pipeline.compress_se(str(src), str(rfq))
    pipeline.decompress(str(rfq), str(back))
    assert back.read_bytes() == src.read_bytes()


def test_name2_predicates_match_oracle_semantics(native):
    """eq_first / pair_ok vs a direct rendering of oracle.py:495-521
    (substitution only when diff_pos < len; empty name2s compare equal)."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        n = 2 * int(rng.integers(1, 20))
        lens = rng.integers(0, 6, size=n).astype(np.int64)
        if rng.random() < 0.3:
            lens[:] = lens[0]  # homogeneous case
        flat = rng.integers(65, 68, size=int(lens.sum()) + 1,
                            dtype=np.uint8)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        diff_pos = int(rng.integers(0, 5))
        diff_char = int(rng.choice([0, 66]))
        eq_first, pair_ok = _native.name2_predicates(
            flat, starts, lens, diff_pos, diff_char)

        def nm(i):
            return flat[starts[i]: starts[i] + lens[i]].tobytes()

        for i in range(n):
            assert eq_first[i] == (nm(i) == nm(0))
        for p in range(n // 2):
            a = bytearray(nm(2 * p))
            b = nm(2 * p + 1)
            if diff_char != 0 and diff_pos < len(a):
                a[diff_pos] = diff_char
            assert pair_ok[p] == (bytes(a) == b), (p, a, b)


def test_all_same_slices_matches_gather(native):
    rng = np.random.default_rng(3)
    for _ in range(100):
        n = int(rng.integers(1, 50))
        L = int(rng.integers(1, 12))
        flat = rng.integers(0, 4, size=n * L + 8, dtype=np.uint8)
        starts = (np.arange(n, dtype=np.int64) * L)
        if rng.random() < 0.5:
            flat[: n * L] = np.tile(flat[:L], n)  # force all-same
        want = bool(
            (flat[: n * L].reshape(n, L) == flat[:L]).all()
        )
        assert _native.all_same_slices(flat, starts, L) == want


def _read_scalar_ground_truth(path):
    """Exact reference semantics: the scalar record reader from offset 0."""
    r = fq.FastqReader(path)
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


@pytest.mark.parametrize("no_mmap", [False, True])
def test_consume_boundary_empty_line_at_block_edge(tmp_path, monkeypatch,
                                                   no_mmap):
    """'\\n\\n' straddling a consume boundary that lands exactly on the
    1MB fetch frontier: the danger probe used to skip consumed bytes, so
    the fast path treated the second newline as a fresh line terminator
    instead of dropping to the exact scalar reader (which, per the
    reference's block-frame skip gate, surfaces an empty line and stops
    the file there)."""
    if no_mmap:
        monkeypatch.setenv("REPAQ_TPU_NO_MMAP", "1")
    # each record exactly 1024 bytes -> 1024 records == FQ_BUF_SIZE
    name = b"@" + b"n" * 818
    seq = b"A" * 100
    qual = b"I" * 100
    rec = name + b"\n" + seq + b"\n+\n" + qual + b"\n"
    assert len(rec) == 1024
    path = tmp_path / "edge.fq"
    path.write_bytes(rec * 1024 + b"\n" + rec)

    want = _read_scalar_ground_truth(str(path))
    assert len(want) == 1024  # reference dies at the empty line

    r = fq.FastqReader(str(path))
    blk, _ = r.read_block(max_records=1024)
    assert blk is not None and blk.n == 1024
    blk2, _ = r.read_block(max_records=4)
    assert blk2 is None  # not a phantom 1025th record
    r.close()


@pytest.mark.parametrize("budget", [64, 1000, 300000])
def test_mmap_reader_matches_bytearray_reader(tmp_path, monkeypatch, budget):
    """The mmap window reader and the readinto/bytearray reader must
    produce identical block sequences and flag timing on multi-MB
    corpora, including unterminated tails."""
    rng = np.random.default_rng(23)
    for trial in range(3):
        recs = []
        total = 0
        lim = int(2.5 * fq.FQ_BUF_SIZE)
        while total < lim:
            L = int(rng.integers(1, 260))
            nm = b"@r" + str(len(recs)).encode()
            sq = rng.choice(
                np.frombuffer(b"ACGTN", dtype=np.uint8), size=L
            ).tobytes()
            ql = rng.choice(
                np.frombuffer(b"FF::,#", dtype=np.uint8), size=L
            ).tobytes()
            r = nm + b"\n" + sq + b"\n+\n" + ql + b"\n"
            recs.append(r)
            total += len(r)
        data = b"".join(recs)
        if trial % 2:
            data = data[:-1]  # no trailing newline
        path = tmp_path / ("eq%d.fq" % trial)
        path.write_bytes(data)

        def read_all():
            r = fq.FastqReader(str(path))
            out = []
            while True:
                blk, flag = r.read_block(budget_bases=budget)
                if blk is None:
                    out.append((None, flag))
                    break
                out.append(
                    (
                        (
                            blk.n,
                            blk.name_flat.tobytes(),
                            blk.seq_flat.tobytes(),
                            blk.qual_flat.tobytes(),
                            blk.name_off.tobytes(),
                        ),
                        flag,
                    )
                )
            r.close()
            return out

        monkeypatch.delenv("REPAQ_TPU_NO_MMAP", raising=False)
        a = read_all()
        monkeypatch.setenv("REPAQ_TPU_NO_MMAP", "1")
        b = read_all()
        assert a == b


def test_scatter_pieces_rc_matches_numpy(native):
    """Fused decode restore kernel: even rows concatenate their 3 pieces,
    odd rows emit the reverse-complement of the concatenation — checked
    against the direct numpy construction on random piece tables."""
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    rng = np.random.default_rng(41)
    for trial in range(50):
        n_rows = int(rng.integers(2, 40)) & ~1
        src = rng.choice(
            np.frombuffer(b"ACGTN", dtype=np.uint8), size=4096
        ).astype(np.uint8)
        p_starts = np.zeros(3 * n_rows, dtype=np.int64)
        p_lens = np.zeros(3 * n_rows, dtype=np.int64)
        for p in range(3 * n_rows):
            L = int(rng.integers(0, 140))
            p_lens[p] = L
            p_starts[p] = int(rng.integers(0, 4096 - max(L, 1)))
        row_lens = p_lens.reshape(-1, 3).sum(axis=1)
        dst_off = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(row_lens, out=dst_off[1:])
        dst = np.empty(int(dst_off[-1]), dtype=np.uint8)
        _native.scatter_pieces_rc(src, p_starts, p_lens, dst, dst_off, comp)
        for r in range(n_rows):
            pieces = [
                src[p_starts[3 * r + j]: p_starts[3 * r + j] + p_lens[3 * r + j]]
                for j in range(3)
            ]
            row = np.concatenate(pieces) if pieces else np.empty(0, np.uint8)
            if r % 2 == 1:
                row = comp[row][::-1]
            np.testing.assert_array_equal(
                dst[dst_off[r]: dst_off[r + 1]], row, err_msg=f"row {r}"
            )
