"""The AVX-512 kernel fast paths are compile-time guarded; other hosts
get the scalar bodies from the Makefile's no-march fallback. This builds
that generic variant and cross-checks every #ifdef'd kernel against the
production library on fuzz inputs, so a divergence between the SIMD and
scalar formulations can't ship silently."""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repaq_tpu.codec import _native

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "repaq_tpu", "native", "repaq_native.cpp",
)

@pytest.fixture(scope="module")
def scalar_lib(tmp_path_factory):
    # decided here, not at import: every test worker collects the same
    # tests whether or not the library is built yet
    if not _native.available() or shutil.which("g++") is None:
        pytest.skip("native library or compiler unavailable")
    out = tmp_path_factory.mktemp("noavx") / "libscalar.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread",
         "-o", str(out), SRC],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    lib.reverse_slices.restype = None
    lib.reverse_slices.argtypes = [vp, vp, vp, vp, vp, i64, vp]
    lib.pack_2bit.restype = None
    lib.pack_2bit.argtypes = [vp, i64, vp]
    lib.unpack_2bit.restype = None
    lib.unpack_2bit.argtypes = [vp, i64, vp, i64]
    lib.overlap_pairs.restype = None
    lib.overlap_pairs.argtypes = [vp, vp, i64, i64, i64, vp]
    lib.parse_names_batch.restype = None
    lib.parse_names_batch.argtypes = [vp, vp, i64, vp]
    return lib


def test_reverse_slices_scalar_equivalence(scalar_lib):
    rng = np.random.default_rng(21)
    for trial in range(60):
        n = int(rng.integers(1, 12))
        lens = rng.integers(0, 300, size=n).astype(np.int64)
        src = rng.integers(0, 256, size=int(lens.sum()) + 4, dtype=np.uint8)
        ss = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=ss[1:])
        table = (rng.permutation(256).astype(np.uint8)
                 if trial % 2 else None)
        a = np.zeros(src.shape[0], np.uint8)
        b = np.zeros(src.shape[0], np.uint8)
        _native.reverse_slices(src, ss, a, ss, lens, table)
        scalar_lib.reverse_slices(
            src.ctypes.data, ss.ctypes.data, b.ctypes.data, ss.ctypes.data,
            lens.ctypes.data, n,
            table.ctypes.data if table is not None else None,
        )
        np.testing.assert_array_equal(a, b)


def test_pack_unpack_scalar_equivalence(scalar_lib):
    rng = np.random.default_rng(22)
    for _ in range(60):
        n = int(rng.integers(0, 600))
        seq = rng.integers(0, 256, size=n, dtype=np.uint8)
        a = _native.pack_2bit(seq)
        b = np.empty((n + 3) // 4, dtype=np.uint8)
        scalar_lib.pack_2bit(seq.ctypes.data, n, b.ctypes.data)
        np.testing.assert_array_equal(a, b)
        L = int(rng.integers(0, 4 * a.shape[0] + 8))
        ua = _native.unpack_2bit(a, L)
        ub = np.empty(L, dtype=np.uint8)
        scalar_lib.unpack_2bit(a.ctypes.data, a.shape[0], ub.ctypes.data, L)
        np.testing.assert_array_equal(ua, ub)


def test_overlap_scalar_equivalence(scalar_lib):
    rng = np.random.default_rng(23)
    for _ in range(60):
        p = int(rng.integers(1, 6))
        l1 = int(rng.integers(1, 170))
        l2 = int(rng.integers(1, 170))
        r1 = rng.integers(65, 69, size=(p, l1), dtype=np.uint8)
        r2 = rng.integers(65, 69, size=(p, l2), dtype=np.uint8)
        for i in range(p):
            if rng.random() < 0.5 and min(l1, l2) > 14:
                o = int(rng.integers(12, min(l1, l2) + 1))
                if rng.random() < 0.5:
                    r2[i, :o] = r1[i, l1 - o:]
                else:
                    r1[i, :o] = r2[i, l2 - o:]
        a = _native.overlap_pairs(r1, r2)
        b = np.zeros(p, dtype=np.int64)
        scalar_lib.overlap_pairs(
            np.ascontiguousarray(r1).ctypes.data,
            np.ascontiguousarray(r2).ctypes.data, p, l1, l2, b.ctypes.data,
        )
        np.testing.assert_array_equal(a, b)


def test_rans_scalar_equivalence(scalar_lib):
    """Encode bytes and decode output of the SIMD rANS must equal the
    generic build's for skewed alphabets across lane counts/orders."""
    import ctypes

    from repaq_tpu.codec.rans_np import (
        _cum_from_freqs, lane_slices, quantize_freqs,
    )

    i64, vp, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32
    scalar_lib.rans_encode.restype = i64
    scalar_lib.rans_encode.argtypes = [vp, i64, vp, i64, vp, vp, i32, vp,
                                       vp]
    rng = np.random.default_rng(31)
    for trial in range(25):
        n = int(rng.integers(16, 20000))
        S = int(rng.integers(1, 20))
        syms = rng.choice(256, size=S, replace=False)
        p = rng.dirichlet(np.full(S, 0.15))
        data = rng.choice(syms, size=n, p=p).astype(np.uint8)
        lanes = int(rng.choice([16, 17, 48]))
        offs = np.ascontiguousarray(lane_slices(n, lanes))
        freqs = quantize_freqs(np.bincount(data, minlength=256))
        fr = np.ascontiguousarray(freqs.astype(np.int32))
        cu = np.ascontiguousarray(
            _cum_from_freqs(freqs)[:256].astype(np.int32))
        a_out = np.empty(6 * n + 64 * lanes, np.uint8)
        b_out = np.empty(6 * n + 64 * lanes, np.uint8)
        a_cnt = np.zeros(lanes, np.int64)
        b_cnt = np.zeros(lanes, np.int64)
        lib = ctypes.CDLL(_native._SO)
        lib.rans_encode.restype = i64
        lib.rans_encode.argtypes = scalar_lib.rans_encode.argtypes
        ta = lib.rans_encode(data.ctypes.data, n, offs.ctypes.data, lanes,
                             fr.ctypes.data, cu.ctypes.data, 0,
                             a_out.ctypes.data, a_cnt.ctypes.data)
        tb = scalar_lib.rans_encode(
            data.ctypes.data, n, offs.ctypes.data, lanes, fr.ctypes.data,
            cu.ctypes.data, 0, b_out.ctypes.data, b_cnt.ctypes.data)
        assert ta == tb
        np.testing.assert_array_equal(a_cnt, b_cnt)
        np.testing.assert_array_equal(a_out[:ta], b_out[:tb])


def test_parse_names_scalar_equivalence(scalar_lib):
    rng = np.random.default_rng(24)
    names = []
    for i in range(3000):
        kind = i % 4
        if kind == 0:
            names.append(b"@A0:%d:HX:1:1101:%d:%d 1:N:0:AC" % (i, i, i * 2))
        elif kind == 1:
            names.append(b"@V300078982L1C001R00%d" % i)
        elif kind == 2:
            names.append(b"@x" * (40 + i % 30))  # long / degenerate
        else:
            names.append(b"@a:b:c:d:%d:%d:%d tail" % (i, i, i))
    flat = np.frombuffer(b"".join(names), dtype=np.uint8)
    off = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in names], out=off[1:])
    a = _native.parse_names_batch(flat, off)
    b = np.empty((len(names), 9), dtype=np.int64)
    scalar_lib.parse_names_batch(
        np.ascontiguousarray(flat).ctypes.data, off.ctypes.data,
        len(names), b.ctypes.data,
    )
    np.testing.assert_array_equal(a, b)


def test_concurrent_builds_never_expose_a_partial_library(tmp_path):
    """Several processes building the same library at once (test workers
    importing together) each write a private temporary file and rename
    it into place: every reader sees either no file or a whole one."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no compiler")
    target = str(tmp_path / "lib.so")
    code = ("import sys; from repaq_tpu.codec import _native; "
            "sys.exit(0 if _native._build(sys.argv[1]) else 1)")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(SRC)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", code, target], env=env)
             for _ in range(4)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    lib = ctypes.CDLL(target)
    lib.pack_2bit.restype = None
    lib.pack_2bit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p]
    seq = np.frombuffer(b"GATCGATCA", dtype=np.uint8)
    out = np.empty(3, dtype=np.uint8)
    lib.pack_2bit(seq.ctypes.data, seq.shape[0], out.ctypes.data)
    from repaq_tpu.codec import kernels_np

    np.testing.assert_array_equal(out, kernels_np.pack_2bit(seq))
    assert os.listdir(tmp_path) == ["lib.so"]  # no temporary file left
