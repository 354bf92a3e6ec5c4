"""Structure-of-arrays chunk representation.

A ``ReadBlock`` is the fixed-layout array form of one chunk: flat uint8
buffers plus offset arrays. This is the canonical interface between the
FASTQ reader, the vectorized/device codecs, and the container writer — the
array-native replacement for the reference's vector<Read*> object graph
(reference read.h / repaq.cpp hot loops).
"""

from __future__ import annotations

import numpy as np

from .oracle import FastqRead


def gather_slices(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate buf[starts[i]:starts[i]+lens[i]] for all i (one gather)."""
    from . import _native

    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=buf.dtype)
    out_off = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=out_off[1:])
    if buf.dtype == np.uint8 and _native.available():
        buf = np.ascontiguousarray(buf)
        out = np.empty(total, dtype=np.uint8)
        _native.copy_slices(buf, starts, out, out_off, lens)
        return out
    idx = np.arange(total, dtype=np.int64) + np.repeat(
        starts.astype(np.int64) - out_off, lens
    )
    return buf[idx]


def scatter_slices(
    src: np.ndarray,
    dst: np.ndarray,
    dst_starts: np.ndarray,
    lens: np.ndarray,
    src_starts: np.ndarray | None = None,
) -> None:
    """dst[dst_starts[i]:+lens[i]] = consecutive (or src_starts-addressed)
    slices of src."""
    from . import _native

    lens = lens.astype(np.int64)
    if src_starts is None:
        src_starts = np.zeros(len(lens), dtype=np.int64)
        np.cumsum(lens[:-1], out=src_starts[1:])
    if dst.dtype == np.uint8 and src.dtype == np.uint8 and _native.available():
        _native.copy_slices(
            np.ascontiguousarray(src), src_starts, dst, dst_starts, lens
        )
        return
    total = int(lens.sum())
    if total == 0:
        return
    out_off = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=out_off[1:])
    idx = np.arange(total, dtype=np.int64) + np.repeat(
        dst_starts.astype(np.int64) - out_off, lens
    )
    sidx = np.arange(total, dtype=np.int64) + np.repeat(
        src_starts.astype(np.int64) - out_off, lens
    )
    dst[idx] = src[sidx]


def lens_to_offsets(lens: np.ndarray) -> np.ndarray:
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    return off


class PESpans:
    """Zero-copy PE source annotation (set by the reader's mmap fast
    path): absolute line starts of the seq/qual lines of each pair in the
    two source windows. Lets encode_chunk consume sequence and quality
    spans straight from the mapped input, so the block's packed
    seq_flat/qual_flat never materialize unless some other consumer
    (verify, header scan, fallback engine) asks for them."""

    __slots__ = ("src1", "src2", "seq_starts1", "seq_starts2",
                 "qual_starts1", "qual_starts2")

    def __init__(self, src1, src2, seq_starts1, seq_starts2,
                 qual_starts1, qual_starts2):
        self.src1 = src1
        self.src2 = src2
        self.seq_starts1 = seq_starts1
        self.seq_starts2 = seq_starts2
        self.qual_starts1 = qual_starts1
        self.qual_starts2 = qual_starts2


class ReadBlock:
    """Positional construction order matches the historical dataclass:
    (n, name_flat, name_off, seq_flat, seq_off, strand_flat, strand_off,
    qual_flat, qual_off). seq_flat/qual_flat are properties: when a
    PESpans annotation is attached (reader mmap fast path), they pass
    None at construction and materialize from the source windows on
    first access — every consumer other than the span-aware encoder sees
    the same packed arrays as before."""

    __slots__ = ("n", "name_flat", "name_off", "_seq_flat", "seq_off",
                 "strand_flat", "strand_off", "_qual_flat", "qual_off",
                 "pe_spans")

    def __init__(self, n, name_flat, name_off, seq_flat, seq_off,
                 strand_flat, strand_off, qual_flat, qual_off):
        self.n = n
        self.name_flat = name_flat
        self.name_off = name_off
        self._seq_flat = seq_flat
        self.seq_off = seq_off
        self.strand_flat = strand_flat
        self.strand_off = strand_off
        self._qual_flat = qual_flat
        self.qual_off = qual_off
        self.pe_spans = None

    def attach_pe_spans(self, spans: PESpans) -> None:
        """Mark seq_flat/qual_flat as lazily derivable from the source
        windows. Caller passes seq_flat=None, qual_flat=None."""
        self.pe_spans = spans

    @property
    def seq_flat(self) -> np.ndarray:
        if self._seq_flat is None and self.pe_spans is not None:
            sp = self.pe_spans
            from . import _native

            lens = np.diff(self.seq_off)
            out = np.empty(int(self.seq_off[-1]), dtype=np.uint8)
            dst = self.seq_off[:-1]
            _native.copy_slices(sp.src1, sp.seq_starts1, out,
                                dst[0::2], lens[0::2])
            _native.copy_slices(sp.src2, sp.seq_starts2, out,
                                dst[1::2], lens[1::2])
            self._seq_flat = out
        return self._seq_flat

    @seq_flat.setter
    def seq_flat(self, v) -> None:
        self._seq_flat = v

    @property
    def qual_flat(self) -> np.ndarray:
        if self._qual_flat is None and self.pe_spans is not None:
            sp = self.pe_spans
            from . import _native

            lens = np.diff(self.qual_off)
            out = np.empty(int(self.qual_off[-1]), dtype=np.uint8)
            dst = self.qual_off[:-1]
            _native.copy_slices(sp.src1, sp.qual_starts1, out,
                                dst[0::2], lens[0::2])
            _native.copy_slices(sp.src2, sp.qual_starts2, out,
                                dst[1::2], lens[1::2])
            self._qual_flat = out
        return self._qual_flat

    @qual_flat.setter
    def qual_flat(self, v) -> None:
        self._qual_flat = v

    @property
    def total_bases(self) -> int:
        return int(self.seq_off[-1])

    def seq_lens(self) -> np.ndarray:
        return np.diff(self.seq_off)

    @classmethod
    def from_reads(cls, reads: list[FastqRead]) -> "ReadBlock":
        def pack(items):
            lens = np.array([len(x) for x in items], dtype=np.int64)
            flat = np.frombuffer(b"".join(items), dtype=np.uint8)
            return flat, lens_to_offsets(lens)

        name_flat, name_off = pack([r.name for r in reads])
        seq_flat, seq_off = pack([r.seq for r in reads])
        strand_flat, strand_off = pack([r.strand for r in reads])
        qual_flat, qual_off = pack([r.qual for r in reads])
        return cls(
            len(reads),
            name_flat,
            name_off,
            seq_flat,
            seq_off,
            strand_flat,
            strand_off,
            qual_flat,
            qual_off,
        )

    def to_reads(self) -> list[FastqRead]:
        nb = self.name_flat.tobytes()
        sb = self.seq_flat.tobytes()
        tb = self.strand_flat.tobytes()
        qb = self.qual_flat.tobytes()
        out = []
        for i in range(self.n):
            out.append(
                FastqRead(
                    nb[self.name_off[i] : self.name_off[i + 1]],
                    sb[self.seq_off[i] : self.seq_off[i + 1]],
                    tb[self.strand_off[i] : self.strand_off[i + 1]],
                    qb[self.qual_off[i] : self.qual_off[i + 1]],
                )
            )
        return out

    def to_fastq_buf(self, indices: np.ndarray | None = None) -> np.ndarray:
        """uint8 array of '@name\\nseq\\n+\\nqual\\n' records for the reads
        in `indices` (None = all, in order). One native pass when the
        library is present — the decode hot path calls this with the
        even/odd PE split so no gather-subset intermediate block, scatter
        passes, or tobytes copy ever materialize."""
        from . import _native

        if _native.available():
            if indices is None:
                total = int(
                    self.name_off[-1] + self.seq_off[-1]
                    + self.strand_off[-1] + self.qual_off[-1] + 4 * self.n
                )
                idx = None
            else:
                idx = np.ascontiguousarray(indices, dtype=np.int64)
                total = int(
                    (np.diff(self.name_off)[idx]).sum()
                    + (np.diff(self.seq_off)[idx]).sum()
                    + (np.diff(self.strand_off)[idx]).sum()
                    + (np.diff(self.qual_off)[idx]).sum() + 4 * idx.shape[0]
                )
            return _native.assemble_fastq(
                self.name_flat, np.ascontiguousarray(self.name_off, np.int64),
                self.seq_flat, np.ascontiguousarray(self.seq_off, np.int64),
                self.strand_flat,
                np.ascontiguousarray(self.strand_off, np.int64),
                self.qual_flat, np.ascontiguousarray(self.qual_off, np.int64),
                idx, total,
            )
        blk = self if indices is None else self.take(np.asarray(indices))
        return blk._assemble_np()

    def to_fastq_bytes(self) -> bytes:
        """Assemble '@name\\nseq\\n+\\nqual\\n' records in one pass."""
        return self.to_fastq_buf().tobytes()

    def _assemble_np(self) -> np.ndarray:
        """numpy scatter-pass assembly (no-native fallback)."""
        name_lens = np.diff(self.name_off)
        seq_lens = np.diff(self.seq_off)
        strand_lens = np.diff(self.strand_off)
        qual_lens = np.diff(self.qual_off)
        rec_lens = name_lens + seq_lens + strand_lens + qual_lens + 4
        total = int(rec_lens.sum())
        out = np.empty(total, dtype=np.uint8)
        rec_off = lens_to_offsets(rec_lens)

        def put(flat, off, lens, dst_start):
            scatter_slices(flat, out, dst_start, lens, src_starts=off[:-1])

        nl = np.uint8(10)
        pos = rec_off[:-1]
        put(self.name_flat, self.name_off, name_lens, pos)
        pos = pos + name_lens
        out[pos] = nl
        pos = pos + 1
        put(self.seq_flat, self.seq_off, seq_lens, pos)
        pos = pos + seq_lens
        out[pos] = nl
        pos = pos + 1
        put(self.strand_flat, self.strand_off, strand_lens, pos)
        pos = pos + strand_lens
        out[pos] = nl
        pos = pos + 1
        put(self.qual_flat, self.qual_off, qual_lens, pos)
        pos = pos + qual_lens
        out[pos] = nl
        return out

    def take(self, indices: np.ndarray) -> "ReadBlock":
        """Sub-block of the given read indices (gather copy)."""
        def pick(flat, off):
            lens = (off[1:] - off[:-1])[indices]
            return gather_slices(flat, off[:-1][indices], lens), lens_to_offsets(lens)

        name_flat, name_off = pick(self.name_flat, self.name_off)
        seq_flat, seq_off = pick(self.seq_flat, self.seq_off)
        strand_flat, strand_off = pick(self.strand_flat, self.strand_off)
        qual_flat, qual_off = pick(self.qual_flat, self.qual_off)
        return ReadBlock(
            len(indices), name_flat, name_off, seq_flat, seq_off,
            strand_flat, strand_off, qual_flat, qual_off,
        )

    def interleave(self, other: "ReadBlock") -> "ReadBlock":
        """Interleave two blocks r1[0], r2[0], r1[1], r2[1], ..."""
        assert self.n == other.n

        def mix(flat_a, off_a, flat_b, off_b):
            lens_a = np.diff(off_a)
            lens_b = np.diff(off_b)
            lens = np.empty(self.n * 2, dtype=np.int64)
            lens[0::2] = lens_a
            lens[1::2] = lens_b
            off = lens_to_offsets(lens)
            out = np.empty(int(lens.sum()), dtype=flat_a.dtype)
            scatter_slices(flat_a, out, off[0:-1:2], lens_a, src_starts=off_a[:-1])
            scatter_slices(flat_b, out, off[1:-1:2], lens_b, src_starts=off_b[:-1])
            return out, off

        name_flat, name_off = mix(self.name_flat, self.name_off, other.name_flat, other.name_off)
        seq_flat, seq_off = mix(self.seq_flat, self.seq_off, other.seq_flat, other.seq_off)
        strand_flat, strand_off = mix(self.strand_flat, self.strand_off, other.strand_flat, other.strand_off)
        qual_flat, qual_off = mix(self.qual_flat, self.qual_off, other.qual_flat, other.qual_off)
        return ReadBlock(
            self.n * 2,
            name_flat,
            name_off,
            seq_flat,
            seq_off,
            strand_flat,
            strand_off,
            qual_flat,
            qual_off,
        )
