"""ctypes bindings for the native (C++) host kernels.

The sequential byte-stream coders (gap/run emission, token walks, overlap
search) are the parts of the codec that resist host vectorization;
librepaq_native provides them at memory speed with the exact reference
semantics. Every entry point has a numpy/Python fallback in kernels_np, and
the test suite runs both paths.

Build: on first use, from repaq_tpu/native/repaq_native.cpp into the
git-ignored build/native/ directory of the checkout. The library's name
carries a hash of the source, the Makefile and the host CPU's feature
flags, so a checkout copied to another machine builds its own
(-march=native) library instead of loading one that may not run there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading

import numpy as np

_LIB = None
_TRIED = False

_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "native")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def _library_path() -> str:
    h = hashlib.sha256()
    for name in ("repaq_native.cpp", "Makefile"):
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(_cpu_flags())
    return os.path.join(_BUILD_DIR,
                        "librepaq_native-%s.so" % h.hexdigest()[:16])


def _build(path: str) -> bool:
    """Compile to a temporary name and rename into place, so concurrent
    importers (test workers, codec processes) never load a half-written
    library. Returns False, after saying why on stderr, if it fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        subprocess.run(
            ["make", "-s", "-C", _DIR, "OUT=%s" % tmp],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        print("repaq_tpu: native host library build failed (%s); using the "
              "numpy kernels. %s"
              % (e, detail.decode(errors="replace")[-2000:]), file=sys.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_SO = None  # the loaded library's path, set on first use
_LOAD_LOCK = threading.Lock()

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


_TLS = threading.local()


def _scratch(key: str, nbytes: int) -> np.ndarray:
    """Grow-only per-thread scratch buffers: the encode kernels need
    O(chunk) work space per call, and re-allocating tens of MB per chunk
    costs more in page faults than the kernels themselves."""
    buf = getattr(_TLS, key, None)
    if buf is None or buf.shape[0] < nbytes:
        buf = np.empty(max(nbytes, 1 << 20), dtype=np.uint8)
        setattr(_TLS, key, buf)
    return buf


def _load():
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:  # one build and load, however many threads ask first
        return _load_once()


def _load_once():
    global _LIB, _TRIED, _SO
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("REPAQ_TPU_NO_NATIVE"):
        return None
    _SO = _library_path()
    if not os.path.exists(_SO) and not _build(_SO):
        return None
    lib = ctypes.CDLL(_SO)
    # per-chunk entry points take raw pointer ints (c_void_p):
    # data_as(POINTER(..)) costs ~2 us per pointer argument in
    # marshalling, which showed up at ~8% of encode and ~14% of decode
    # wall at nova scale. Every wrapper binds its arrays to locals so the
    # buffers outlive the call. (The per-SECTION rANS/LZ entry points
    # keep typed pointers — a handful of calls per file.)
    _vp = ctypes.c_void_p
    lib.positions_encode.restype = _i64
    lib.positions_encode.argtypes = [_vp, _i64, ctypes.c_uint8, _vp, _vp]
    lib.positions_decode.restype = _i64
    lib.positions_decode.argtypes = [_vp, _i64, _vp]
    lib.positions_scatter.restype = None
    lib.positions_scatter.argtypes = [_vp, _i64, ctypes.c_uint8, _vp]
    lib.qualcol_encode.restype = _i64
    lib.qualcol_encode.argtypes = [_vp, _i64, _vp, _i32, ctypes.c_uint8, _vp, _vp]
    lib.qualcol_encode_sp.restype = _i64
    lib.qualcol_encode_sp.argtypes = [_vp, _i64, _vp, _i32, _vp, _vp, _vp]
    lib.qualcol_decode.restype = None
    lib.qualcol_decode.argtypes = [_vp, _i64, _vp, _i32, _vp, _i64]
    lib.coords_encode.restype = _i64
    lib.coords_encode.argtypes = [_vp, _i64, _vp]
    lib.coords_decode.restype = _i64
    lib.coords_decode.argtypes = [_vp, _i64, _vp, _i64]
    lib.token_starts.restype = _i64
    lib.token_starts.argtypes = [_vp, _i64, _vp]
    lib.overlap_pairs.restype = None
    lib.overlap_pairs.argtypes = [_vp, _vp, _i64, _i64, _i64, _vp]
    lib.overlap_pairs2.restype = None
    lib.overlap_pairs2.argtypes = [
        _vp, _i64, _i64, _vp, _i64, _i64, _i64, _i64, _i64, _vp,
    ]
    lib.overlap_pairsx.restype = None
    lib.overlap_pairsx.argtypes = [
        _vp, _vp, _vp, _vp, _i64, _i64, _i64, _vp,
    ]
    lib.pe_interleave2.restype = None
    lib.pe_interleave2.argtypes = [
        _vp, _vp, _vp, _vp, _vp, _vp, _i64,
        _i64, _vp, _vp, _i64, _vp, _vp,
    ]
    lib.scatter_pieces_rc.restype = None
    lib.scatter_pieces_rc.argtypes = [
        _vp, _vp, _vp, _i64, _vp, _vp, _vp,
    ]
    lib.copy_slices.restype = None
    lib.copy_slices.argtypes = [_vp, _vp, _vp, _vp, _vp, _i64]
    lib.pe_interleave.restype = None
    lib.pe_interleave.argtypes = [
        _vp, _vp, _vp, _vp, _vp, _vp, _i64,
        _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
    ]
    lib.scan_newlines.restype = _i64
    lib.scan_newlines.argtypes = [_vp, _i64, _i64, _i64, _vp]
    lib.all_same_slices.restype = _i64
    lib.all_same_slices.argtypes = [_vp, _vp, _i64, _i64]
    lib.name2_predicates.restype = None
    lib.name2_predicates.argtypes = [_vp, _vp, _vp, _i64, _i64,
                                     ctypes.c_int, _vp, _vp]
    lib.rans_parse_table.restype = _i64
    lib.rans_parse_table.argtypes = [_vp, _i64, _i64, _i64, _vp]
    lib.reverse_slices.restype = None
    lib.reverse_slices.argtypes = [_vp, _vp, _vp, _vp, _vp, _i64, _vp]
    lib.pack_2bit.restype = None
    lib.pack_2bit.argtypes = [_vp, _i64, _vp]
    lib.unpack_2bit.restype = None
    lib.unpack_2bit.argtypes = [_vp, _i64, _vp, _i64]
    lib.rans_encode.restype = _i64
    lib.rans_encode.argtypes = [_u8p, _i64, _i64p, _i64, _i32p, _i32p,
                                _i32, _u8p, _i64p]
    lib.rans_decode.restype = None
    lib.rans_decode.argtypes = [_u8p, _i64p, _i64, _i64p, _i32p, _i32p,
                                _u8p, _i32, _u8p]
    lib.atoi_spans.restype = None
    lib.atoi_spans.argtypes = [_vp, _vp, _vp, _i64, _vp]
    lib.parse_names_batch.restype = None
    lib.parse_names_batch.argtypes = [_vp, _vp, _i64, _vp]
    lib.lz_parse.restype = _i64
    lib.lz_parse.argtypes = [_u8p, _i64, _i64, _i64p, _i64p, _i64p, _i64,
                             _i64]
    lib.lz_expand.restype = _i64
    lib.lz_expand.argtypes = [_i64p, _i64p, _i64p, _i64, _u8p, _i64, _u8p,
                              _i64, _i64]
    lib.lz_dist_mtf.restype = None
    lib.lz_dist_mtf.argtypes = [_i64p, _i64p, _i64, ctypes.c_int]
    lib.quality_scan.restype = None
    lib.quality_scan.argtypes = [_vp, _vp, _i64, _vp, _vp, _vp]
    lib.assemble_fastq.restype = _i64
    lib.assemble_fastq.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp,
                                   _vp, _vp, _vp, _i64, _vp]
    lib.format_names.restype = _i64
    lib.format_names.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp,
                                 _vp, _vp, _vp, _vp, _i64, _vp,
                                 _vp]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def positions_encode(data: np.ndarray, q: int) -> np.ndarray:
    lib = _load()
    n = data.shape[0]
    out = _scratch("pe_out", n + 64)
    ln = lib.positions_encode(
        data.ctypes.data, n, q, out.ctypes.data, None
    )
    return out[:ln].copy()


def positions_decode(buf: np.ndarray) -> np.ndarray:
    lib = _load()
    # a 1-byte run token decodes to <=32 positions
    out = np.empty(buf.shape[0] * 32 + 1, dtype=np.int64)
    cnt = lib.positions_decode(buf.ctypes.data, buf.shape[0], out.ctypes.data)
    return out[:cnt]


def qualcol_encode(
    qual: np.ndarray, bins: np.ndarray, major: int
) -> np.ndarray:
    lib = _load()
    n = qual.shape[0]
    nbins = bins.shape[0]
    bins = np.ascontiguousarray(bins, dtype=np.uint8)
    # single-pass encoder: LUT qual byte -> bin ordinal; bins take
    # precedence over the major marker (the major may itself be a bin when
    # it doubles as the N-base qual, reference rfqheader.cpp:308-320)
    bin_of = np.full(256, 0xFF, dtype=np.uint8)
    bin_of[bins] = np.arange(nbins, dtype=np.uint8)
    if bin_of[major] == 0xFF:
        bin_of[major] = 0xFE
    out = _scratch("qc_out", 5 * n + 4 * nbins + 1024)
    # 4n posbuf (u32 non-major positions) + segments/escapes. Matches and
    # escapes split the non-major bytes, so 4*matches + 5*escapes <= 5n:
    # 9n total — kept tight because the first touch of a freshly grown
    # scratch page-faults, which dominates single-chunk workloads
    scratch = _scratch("qc_scr", 9 * n + 8 * nbins + 2048)
    ln = lib.qualcol_encode_sp(
        qual.ctypes.data, n, bins.ctypes.data, nbins, bin_of.ctypes.data,
        out.ctypes.data, scratch.ctypes.data,
    )
    return out[:ln].copy()


def qualcol_decode(
    buf: np.ndarray, bins: np.ndarray, major: int, length: int
) -> np.ndarray:
    lib = _load()
    qual = np.full(length, major, dtype=np.uint8)
    bins = np.ascontiguousarray(bins, dtype=np.uint8)
    lib.qualcol_decode(
        buf.ctypes.data, buf.shape[0], bins.ctypes.data, bins.shape[0],
        qual.ctypes.data, length,
    )
    return qual


def coords_encode(vals: np.ndarray) -> np.ndarray:
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    out = np.empty(vals.shape[0] * 3 + 8, dtype=np.uint8)
    ln = lib.coords_encode(vals.ctypes.data, vals.shape[0], out.ctypes.data)
    if ln < 0:
        from ..format.header import RfqFormatError

        bad = int(vals[vals >= (1 << 21)][0])
        raise RfqFormatError(
            "The X/Y coordinate cannot be larger than 2M, but we get: %d" % bad
        )
    return out[:ln]


def coords_decode(buf: np.ndarray, num: int) -> np.ndarray:
    lib = _load()
    out = np.zeros(num, dtype=np.int64)
    lib.coords_decode(buf.ctypes.data, buf.shape[0], out.ctypes.data, num)
    return out


def token_starts(lens: np.ndarray) -> np.ndarray:
    lib = _load()
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(lens.shape[0], dtype=np.int64)
    n = lib.token_starts(lens.ctypes.data, lens.shape[0], out.ctypes.data)
    return out[:n]


def overlap_pairs(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    lib = _load()
    p, l1 = r1.shape
    l2 = r2.shape[1]
    out = np.zeros(p, dtype=np.int64)
    r1 = np.ascontiguousarray(r1)
    r2 = np.ascontiguousarray(r2)
    lib.overlap_pairs(r1.ctypes.data, r2.ctypes.data, p, l1, l2, out.ctypes.data)
    return out


def overlap_pairs_starts(
    a_flat: np.ndarray,
    a_starts: np.ndarray,
    b_flat: np.ndarray,
    b_starts: np.ndarray,
    l1: int,
    l2: int,
) -> np.ndarray:
    """overlap_pairs with per-row start offsets on both sides (rows live
    at arbitrary positions inside larger flat buffers)."""
    lib = _load()
    a_starts = np.ascontiguousarray(a_starts, dtype=np.int64)
    b_starts = np.ascontiguousarray(b_starts, dtype=np.int64)
    pairs = a_starts.shape[0]
    out = np.zeros(pairs, dtype=np.int64)
    lib.overlap_pairsx(
        a_flat.ctypes.data, a_starts.ctypes.data,
        b_flat.ctypes.data, b_starts.ctypes.data,
        pairs, l1, l2, out.ctypes.data,
    )
    return out


def scatter_pieces_rc(
    src: np.ndarray,
    p_starts: np.ndarray,
    p_lens: np.ndarray,
    dst: np.ndarray,
    dst_off: np.ndarray,
    table: np.ndarray,
) -> None:
    """Fused PE decode restore: 3 pieces per row; even rows concatenate,
    odd rows emit the reverse-complement of the concatenation."""
    lib = _load()
    n_rows = dst_off.shape[0] - 1
    ps = np.ascontiguousarray(p_starts, dtype=np.int64)
    pl = np.ascontiguousarray(p_lens, dtype=np.int64)
    do = np.ascontiguousarray(dst_off, dtype=np.int64)
    tb = np.ascontiguousarray(table, dtype=np.uint8)
    lib.scatter_pieces_rc(
        src.ctypes.data, ps.ctypes.data, pl.ctypes.data, n_rows,
        dst.ctypes.data, do.ctypes.data, tb.ctypes.data,
    )


def pe_interleave_2fields(
    flat1: np.ndarray,
    ls1: np.ndarray,
    le1: np.ndarray,
    flat2: np.ndarray,
    ls2: np.ndarray,
    le2: np.ndarray,
    k: int,
    ja: int,
    fielda: tuple,
    jb: int,
    fieldb: tuple,
) -> None:
    """pe_interleave limited to line indices ja/jb of each 4-line record
    (the lazy-span reader materializes only names + strands)."""
    lib = _load()
    a1 = np.ascontiguousarray(ls1, dtype=np.int64)
    b1 = np.ascontiguousarray(le1, dtype=np.int64)
    a2 = np.ascontiguousarray(ls2, dtype=np.int64)
    b2 = np.ascontiguousarray(le2, dtype=np.int64)
    outa, offa = fielda
    outb, offb = fieldb
    offa = np.ascontiguousarray(offa, dtype=np.int64)
    offb = np.ascontiguousarray(offb, dtype=np.int64)
    lib.pe_interleave2(
        flat1.ctypes.data, a1.ctypes.data, b1.ctypes.data,
        flat2.ctypes.data, a2.ctypes.data, b2.ctypes.data, k,
        ja, outa.ctypes.data, offa.ctypes.data,
        jb, outb.ctypes.data, offb.ctypes.data,
    )


def copy_slices(
    src: np.ndarray,
    src_starts: np.ndarray,
    dst: np.ndarray,
    dst_starts: np.ndarray,
    lens: np.ndarray,
) -> None:
    lib = _load()
    # locals keep every buffer alive across the raw-pointer call
    ss = np.ascontiguousarray(src_starts, dtype=np.int64)
    ds = np.ascontiguousarray(dst_starts, dtype=np.int64)
    ln = np.ascontiguousarray(lens, dtype=np.int64)
    lib.copy_slices(
        src.ctypes.data, ss.ctypes.data, dst.ctypes.data, ds.ctypes.data,
        ln.ctypes.data, len(ln),
    )


def pe_interleave(
    flat1: np.ndarray,
    ls1: np.ndarray,
    le1: np.ndarray,
    flat2: np.ndarray,
    ls2: np.ndarray,
    le2: np.ndarray,
    k: int,
    fields: list,
) -> None:
    """Scatter all 4 fields of k record pairs from the two source
    buffers into interleaved outputs in ONE sequential pass per source.
    fields = [(out_j, off_j)] * 4 with off_j the (2k+1)-entry interleaved
    prefix-sum offsets for field j."""
    lib = _load()
    # locals keep every buffer alive across the raw-pointer call
    a1 = np.ascontiguousarray(ls1, dtype=np.int64)
    b1 = np.ascontiguousarray(le1, dtype=np.int64)
    a2 = np.ascontiguousarray(ls2, dtype=np.int64)
    b2 = np.ascontiguousarray(le2, dtype=np.int64)
    offs = [np.ascontiguousarray(off, dtype=np.int64) for _, off in fields]
    outs = [out for out, _ in fields]
    lib.pe_interleave(
        flat1.ctypes.data, a1.ctypes.data, b1.ctypes.data,
        flat2.ctypes.data, a2.ctypes.data, b2.ctypes.data, k,
        outs[0].ctypes.data, offs[0].ctypes.data,
        outs[1].ctypes.data, offs[1].ctypes.data,
        outs[2].ctypes.data, offs[2].ctypes.data,
        outs[3].ctypes.data, offs[3].ctypes.data,
    )


def all_same_slices(flat: np.ndarray, starts: np.ndarray, L: int) -> bool:
    """True iff flat[starts[i]:+L] == flat[starts[0]:+L] for all i
    (early-exit memcmp; no gather matrix)."""
    lib = _load()
    flat = np.ascontiguousarray(flat)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    return bool(
        lib.all_same_slices(
            flat.ctypes.data, starts.ctypes.data, starts.shape[0], L
        )
    )


def rans_parse_table(buf: np.ndarray, off: int, scale: int):
    """(freqs[256] int64, new_off) or a negative code in new_off:
    -1 truncated, -2 not ascending, -3 bitmap mismatch, -4 sum corrupt."""
    lib = _load()
    freqs = np.empty(256, dtype=np.int64)
    new_off = lib.rans_parse_table(
        buf.ctypes.data, buf.shape[0], off, scale, freqs.ctypes.data
    )
    return freqs, new_off


def name2_predicates(flat, starts, lens, diff_pos: int, diff_char: int):
    """(eq_first bool[n], pair_ok bool[n//2]) for the name2 chunk flags —
    per-slice memcmp, no gather matrices."""
    lib = _load()
    flat = np.ascontiguousarray(flat)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = starts.shape[0]
    eq_first = np.empty(n, dtype=np.uint8)
    pair_ok = np.empty(n // 2, dtype=np.uint8)
    lib.name2_predicates(
        flat.ctypes.data, starts.ctypes.data, lens.ctypes.data, n,
        diff_pos, diff_char, eq_first.ctypes.data, pair_ok.ctypes.data,
    )
    return eq_first.view(bool), pair_ok.view(bool)


def scan_newlines(
    buf: np.ndarray, probe_start: int, start: int, end: int
) -> np.ndarray | None:
    """Positions (absolute, int64) of '\\n' bytes in buf[start:end], or
    None if the window [probe_start, end) contains a danger byte ('\\r'
    or adjacent newlines) that forces the exact scalar reader."""
    lib = _load()
    # newlines can't be adjacent (that's the danger case), so at most
    # every other byte is one
    out = np.empty((end - start) // 2 + 2, dtype=np.int64)
    n = lib.scan_newlines(
        buf.ctypes.data, probe_start, start, end, out.ctypes.data
    )
    if n < 0:
        return None
    return out[:n]


def reverse_slices(
    src: np.ndarray,
    src_starts: np.ndarray,
    dst: np.ndarray,
    dst_starts: np.ndarray,
    lens: np.ndarray,
    table: np.ndarray | None,
) -> None:
    lib = _load()
    tbl = (
        np.ascontiguousarray(table, dtype=np.uint8)
        if table is not None
        else None
    )
    ss = np.ascontiguousarray(src_starts, dtype=np.int64)
    ds = np.ascontiguousarray(dst_starts, dtype=np.int64)
    ln = np.ascontiguousarray(lens, dtype=np.int64)
    lib.reverse_slices(
        src.ctypes.data, ss.ctypes.data, dst.ctypes.data, ds.ctypes.data,
        ln.ctypes.data, len(ln),
        tbl.ctypes.data if tbl is not None else None,
    )


def pack_2bit(seq: np.ndarray) -> np.ndarray:
    lib = _load()
    out = np.empty((seq.shape[0] + 3) // 4, dtype=np.uint8)
    lib.pack_2bit(seq.ctypes.data, seq.shape[0], out.ctypes.data)
    return out


def assemble_fastq(name_flat, name_off, seq_flat, seq_off, strand_flat,
                   strand_off, qual_flat, qual_off, idx, total: int):
    """One-pass FASTQ record assembly for the reads in idx (None = all).
    total must be the exact output byte count (callers compute it from
    the length sums). Returns a uint8 array of the records."""
    lib = _load()
    out = np.empty(total, dtype=np.uint8)
    if idx is None:
        nidx = name_off.shape[0] - 1
        ip = None
    else:
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        nidx = idx.shape[0]
        ip = idx.ctypes.data
    w = lib.assemble_fastq(
        name_flat.ctypes.data, name_off.ctypes.data,
        seq_flat.ctypes.data, seq_off.ctypes.data,
        strand_flat.ctypes.data, strand_off.ctypes.data,
        qual_flat.ctypes.data, qual_off.ctypes.data,
        ip, nidx, out.ctypes.data,
    )
    assert w == total, (w, total)
    return out


def format_names(n1_flat, n1_starts, n1_lens, lane, tile, x, y,
                 n2_flat, n2_starts, n2_lens, n: int):
    """Native name reassembly (codec/names.py build_names semantics).
    Returns (flat uint8 array, int64 offsets[n+1])."""
    lib = _load()

    def i64(a):
        return (None if a is None
                else np.ascontiguousarray(a, dtype=np.int64))

    # every converted array is BOUND to a local: a raw .ctypes.data int
    # does not keep its buffer alive the way data_as did
    n1_starts = i64(n1_starts)
    n1_lens = i64(n1_lens)
    n2_starts = i64(n2_starts)
    n2_lens = i64(n2_lens)
    lane, tile, x, y = i64(lane), i64(tile), i64(x), i64(y)
    cap = int(n1_lens.sum()) + 44 * n + 8
    if n2_lens is not None:
        cap += int(n2_lens.sum())
    out = np.empty(cap, dtype=np.uint8)
    off = np.empty(n + 1, dtype=np.int64)

    def p64(a):
        return None if a is None else a.ctypes.data

    w = lib.format_names(
        n1_flat.ctypes.data, n1_starts.ctypes.data,
        n1_lens.ctypes.data, p64(lane), p64(tile), p64(x), p64(y),
        None if n2_flat is None else n2_flat.ctypes.data,
        p64(n2_starts), p64(n2_lens), n, out.ctypes.data,
        off.ctypes.data,
    )
    return out[:w], off


def quality_scan(seq: np.ndarray, qual: np.ndarray):
    """One-pass header stats (format/header.quality_stats fast path):
    returns (seq_hist[256], qual_hist[256], meta[4]) where meta is
    [first_invalid_byte|-1, first_n_qual|-1, n_qual_differs,
    nonn_after_matches]."""
    lib = _load()
    seq_hist = np.zeros(256, dtype=np.int64)
    qual_hist = np.zeros(256, dtype=np.int64)
    meta = np.zeros(4, dtype=np.int64)
    lib.quality_scan(seq.ctypes.data, qual.ctypes.data, seq.shape[0],
                     seq_hist.ctypes.data, qual_hist.ctypes.data,
                     meta.ctypes.data)
    return seq_hist, qual_hist, meta


def unpack_2bit(buf: np.ndarray, length: int,
                out: np.ndarray | None = None) -> np.ndarray:
    """out (optional): caller-provided uint8 destination of >= length
    bytes (e.g. a rolling-history window) — avoids a transient allocation
    for multi-MB streams."""
    lib = _load()
    if out is None:
        out = np.empty(length, dtype=np.uint8)
    lib.unpack_2bit(buf.ctypes.data, buf.shape[0], out.ctypes.data, length)
    return out[:length]


def rans_encode(data: np.ndarray, lane_off: np.ndarray, freq: np.ndarray,
                cum: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved-rANS encode (exact rans_np semantics). data u8, lane_off
    i64 (lanes+1), freq/cum i32 flattened tables. Returns (payload, counts)."""
    lib = _load()
    lanes = lane_off.shape[0] - 1
    out = np.empty(2 * data.shape[0] + 4 * lanes + 8, dtype=np.uint8)
    counts = np.empty(lanes, dtype=np.int64)
    total = lib.rans_encode(
        _ptr(data, _u8p), data.shape[0], _ptr(lane_off, _i64p), lanes,
        _ptr(freq, _i32p), _ptr(cum, _i32p), order, _ptr(out, _u8p),
        _ptr(counts, _i64p),
    )
    return out[:total], counts


def rans_decode(payload: np.ndarray, lane_counts: np.ndarray,
                lane_off: np.ndarray, freq: np.ndarray, cum: np.ndarray,
                sym_lut: np.ndarray, order: int) -> np.ndarray:
    lib = _load()
    lanes = lane_off.shape[0] - 1
    out = np.empty(int(lane_off[-1]), dtype=np.uint8)
    lib.rans_decode(
        _ptr(payload, _u8p), _ptr(lane_counts, _i64p), lanes,
        _ptr(lane_off, _i64p), _ptr(freq, _i32p), _ptr(cum, _i32p),
        _ptr(sym_lut, _u8p), order, _ptr(out, _u8p),
    )
    return out


def parse_names_batch(flat: np.ndarray, off: np.ndarray) -> np.ndarray:
    """(n, 9) int64 rows: illumina, lane, tile, x, y, name1_start,
    name1_len, name2_start, name2_len (exact meta.py state machine)."""
    lib = _load()
    n = off.shape[0] - 1
    out = np.empty((n, 9), dtype=np.int64)
    off = np.ascontiguousarray(off, dtype=np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    lib.parse_names_batch(
        flat.ctypes.data, off.ctypes.data, n, out.ctypes.data
    )
    return out


def lz_parse(data: np.ndarray, min_match: int, parse_from: int = 0):
    """Greedy hash-chain LZ tokens over bytes: (lit_lens, match_lens,
    dists) int64 arrays; the final token may have match_len == 0.
    parse_from: bytes before it are dictionary — match source only, no
    token coverage (the SEQLZ cross-section history)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    cap = max(1024, (n - parse_from) // max(min_match, 1) + 16)
    while True:
        ll = np.empty(cap, dtype=np.int64)
        ml = np.empty(cap, dtype=np.int64)
        dd = np.empty(cap, dtype=np.int64)
        ntok = lib.lz_parse(
            _ptr(data, _u8p), n, min_match, _ptr(ll, _i64p),
            _ptr(ml, _i64p), _ptr(dd, _i64p), cap, parse_from,
        )
        if ntok >= 0:
            return ll[:ntok], ml[:ntok], dd[:ntok]
        cap *= 2


def lz_expand(lit_lens: np.ndarray, match_lens: np.ndarray,
              dists: np.ndarray, lits: np.ndarray, out_len: int,
              hist: np.ndarray | None = None,
              out: np.ndarray | None = None, start: int = 0) -> np.ndarray:
    """Token expansion; hist (optional) is a dictionary prefix match
    distances may reach into. Returns only the new out_len bytes.

    out/start (optional, exclusive with hist): expand in place into
    out[start : start + out_len] with out[:start] already holding the
    dictionary bytes (the rolling-history path — no transient
    hist-size + out-size allocation)."""
    lib = _load()
    if out is None:
        start = 0 if hist is None else int(hist.shape[0])
        out = np.empty(start + out_len, dtype=np.uint8)
        if start:
            out[:start] = hist
    else:
        assert hist is None and out.shape[0] >= start + out_len
    got = lib.lz_expand(
        _ptr(np.ascontiguousarray(lit_lens, np.int64), _i64p),
        _ptr(np.ascontiguousarray(match_lens, np.int64), _i64p),
        _ptr(np.ascontiguousarray(dists, np.int64), _i64p),
        lit_lens.shape[0],
        _ptr(np.ascontiguousarray(lits, np.uint8), _u8p), lits.shape[0],
        _ptr(out, _u8p), start + out_len, start,
    )
    if got != out_len:
        raise ValueError("LZ stream corrupt (expanded %d of %d)" % (got, out_len))
    return out[start : start + out_len]


def lz_dist_mtf(dd: np.ndarray, ml: np.ndarray, encode: bool) -> np.ndarray:
    """4-slot MTF rep-distance transform (in both directions); returns a
    new array. Falls back to a pure-python loop without the library —
    decode must work everywhere."""
    out = np.ascontiguousarray(dd, np.int64).copy()
    mlc = np.ascontiguousarray(ml, np.int64)
    lib = _load()
    if lib is not None:
        lib.lz_dist_mtf(_ptr(out, _i64p), _ptr(mlc, _i64p), out.shape[0],
                        1 if encode else 0)
        return out
    slots = [0, 0, 0, 0]
    for t in range(out.shape[0]):
        if mlc[t] == 0:
            continue
        if encode:
            d = int(out[t])
            out[t] = slots.index(d) if d in slots else d + 4
        else:
            v = int(out[t])
            d = slots[v] if v < 4 else v - 4
            out[t] = d
        if d in slots:
            slots.remove(d)
        slots.insert(0, d)
        del slots[4:]
    return out


def atoi_spans(flat: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """C atoi over spans (exact util.c_atoi semantics)."""
    lib = _load()
    n = starts.shape[0]
    out = np.empty(n, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    lib.atoi_spans(
        flat.ctypes.data, starts.ctypes.data, ends.ctypes.data, n,
        out.ctypes.data,
    )
    return out
