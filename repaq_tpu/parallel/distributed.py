"""Multi-host data-parallel compression.

The .rfq format's chunks are independent once the header is fixed, and the
header is a pure function of chunk 1 (reference repaq.cpp:553-566), so
multi-host scaling needs no communication at all beyond ordered assembly:

1. ``plan_chunks`` scans the input once (cheap newline/length pass, no
   encoding) and emits every chunk's byte range plus its
   no-trailing-newline flag — the flag timing is pure arithmetic over the
   reference reader's 1MB lazy-fetch behavior (io/fastq._flag_visible).
2. Every process derives the header independently from chunk 1 (bit
   identical by construction — no broadcast needed).
3. Each process encodes its contiguous chunk range to a part file;
   process 0 concatenates header + parts in order. On a multi-host GPU
   cluster the same plan feeds per-host device meshes (parallel/mesh) and
   the parts travel over jax.distributed collectives instead of files; the file transport
   here keeps the mechanism testable with OS processes.

Output bytes are identical to the serial pipeline for any process count
(tests/test_distributed.py proves it against the golden fixtures).

Plain (non-gz) inputs only — gzip streams cannot be seeked; gz inputs take
the serial path. Paired-end uses the same mechanism with a two-file plan
(one byte range per file per chunk, reference repaq.cpp:656-663 pair
accumulation).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..constants import (
    BIT_HAS_NO_LINE_BREAK_AT_END,
    BIT_HAS_NO_LINE_BREAK_AT_END_R2,
)
from ..format.chunk import RfqChunk
from ..format.header import RfqFormatError, RfqHeader
from ..io.fastq import FastqReader, FastqReaderPair
from ..pipeline import (
    EngineConfig,
    _Compressor,
    _decoded_fastq_stream,
    _pe_decode_job,
    _se_decode_job,
    get_engine,
)


@dataclass
class ChunkSpec:
    byte_start: int
    byte_end: int  # one past the chunk's last consumed byte
    n_reads: int
    no_line_break_flag: bool


def plan_chunks_sharded(
    path: str,
    chunk_size: int,
    num_processes: int,
    process_id: int,
    allgather,
) -> list[ChunkSpec] | None:
    """Rank-sharded twin of plan_chunks (VERDICT r3 #6: the replicated
    plan was the serial fraction of multi-host scaling). Each rank scans
    only ~1/R of the file's bytes for newlines; 4-line record parity comes
    from one allgather of per-slice newline counts, and the greedy chunk
    walk (first k records with >= chunk_size bases) runs as an R-round
    relay of a tiny carry (bases accumulated in the partial chunk at the
    slice boundary). Every rank returns the SAME full plan, byte-identical
    to plan_chunks.

    allgather: callable(np.ndarray int64 (k,)) -> (R, k) array — the only
    communication primitive needed (jaxdist passes
    multihost_utils.process_allgather; tests pass a threading stub).

    Returns None when the input needs the scalar reader's quirk handling
    (gz, CR bytes, empty lines, line count not divisible by 4) — callers
    fall back to the replicated plan_chunks, which resolves those exactly.
    """
    R = num_processes
    if path.endswith(".gz"):
        return None
    size = os.path.getsize(path)
    if size == 0:
        # every rank agrees without communication
        return []
    bounds = [size * r // R for r in range(R + 1)]
    lo, hi = bounds[process_id], bounds[process_id + 1]

    nl_parts: list[np.ndarray] = []
    bad = 0
    last_byte = 0
    prev_edge = b""
    with open(path, "rb") as f:
        f.seek(max(lo - 1, 0))
        pos = max(lo - 1, 0)
        while pos < hi:
            blk = f.read(min(8 << 20, hi - pos))
            if not blk:
                break
            arr = np.frombuffer(blk, dtype=np.uint8)
            if (arr == 13).any():
                bad = 1
                break
            seam = prev_edge + blk[:1]
            if b"\n\n" in blk or seam == b"\n\n" or (pos == 0 and blk[:1] == b"\n"):
                bad = 1
                break
            nl = np.flatnonzero(arr == 10).astype(np.int64) + pos
            # the first byte read may belong to the previous slice (the
            # seam probe): drop newlines before lo
            if nl.size and nl[0] < lo:
                nl = nl[nl >= lo]
            if nl.size:
                nl_parts.append(nl)
            prev_edge = blk[-1:]
            pos += len(blk)
        # read-ahead: up to 4 more newlines past the slice (records owned
        # by this rank may end in the next one)
        tail: list[int] = []
        if not bad:
            tpos = hi
            f.seek(hi)
            while len(tail) < 4 and tpos < size:
                blk = f.read(min(1 << 20, size - tpos))
                if not blk:
                    break
                if b"\r" in blk or b"\n\n" in blk or (
                    prev_edge + blk[:1] == b"\n\n"
                ):
                    bad = 1
                    break
                for off in np.flatnonzero(
                    np.frombuffer(blk, dtype=np.uint8) == 10
                ):
                    tail.append(tpos + int(off))
                    if len(tail) >= 4:
                        break
                prev_edge = blk[-1:]
                tpos += len(blk)
        if process_id == R - 1 and not bad:
            f.seek(size - 1)
            last_byte = f.read(1)[0]

    own_nl = (
        np.concatenate(nl_parts) if nl_parts else np.empty(0, np.int64)
    )
    if process_id == R - 1 and not bad and last_byte != 10:
        # missing trailing newline: treat EOF as the final line terminator
        own_nl = np.concatenate([own_nl, np.array([size], np.int64)])

    # exchange: [count, last_own_nl(+1, 0=none), bad, last_byte]
    info = allgather(np.array(
        [own_nl.shape[0],
         int(own_nl[-1]) + 1 if own_nl.shape[0] else 0,
         bad, last_byte], dtype=np.int64,
    ))
    counts = info[:, 0]
    if int(info[:, 2].sum()):
        return None
    total_lines = int(counts.sum())
    if total_lines % 4 != 0 or total_lines == 0:
        return None
    last_byte = int(info[R - 1, 3])
    base = int(counts[:process_id].sum())

    ext = np.concatenate([own_nl, np.array(tail, np.int64)])
    # records owned here: header-line newline (global line index 4m) falls
    # in [base, base + count)
    m_lo = -(-base // 4)
    m_hi = -(-(base + int(counts[process_id])) // 4)
    n_own = max(0, m_hi - m_lo)
    starved = 0
    if n_own:
        j = 4 * m_lo - base + np.arange(n_own, dtype=np.int64) * 4
        if int(j[-1]) + 3 >= ext.shape[0]:
            # tail starved (pathological line lengths past the slice)
            starved = 1
            cum = np.empty(0, np.int64)
            rec_end = np.empty(0, np.int64)
        else:
            bases = ext[j + 1] - ext[j] - 1
            # +1 consumes the newline; the virtual EOF terminator of a
            # file without a trailing newline must not overshoot the file
            rec_end = np.minimum(ext[j + 3] + 1, size)
            cum = np.cumsum(bases)
    else:
        cum = np.empty(0, np.int64)
        rec_end = np.empty(0, np.int64)
    # collective bail (a lone rank returning early would deadlock peers)
    if int(allgather(np.array([starved], np.int64))[:, 0].sum()):
        return None

    # greedy chunk walk as an R-round relay: entry carry = (bases, records)
    # already in the open chunk when the slice begins
    ends: list[int] = []
    nrecs: list[int] = []
    carry = np.zeros(2, dtype=np.int64)
    my_exit = None
    for r in range(R):
        if r == process_id:
            fill, cnt = int(carry[0]), int(carry[1])
            pos_i = 0
            cumprev = 0
            while pos_i < n_own:
                tgt = cumprev + (chunk_size - fill)
                jj = int(np.searchsorted(cum, tgt, side="left"))
                if jj >= n_own:
                    break
                ends.append(int(rec_end[jj]))
                nrecs.append(cnt + (jj - pos_i + 1))
                fill = 0
                cnt = 0
                cumprev = int(cum[jj])
                pos_i = jj + 1
            fill += int(cum[-1]) - cumprev if n_own else 0
            cnt += n_own - pos_i
            my_exit = np.array([fill, cnt], dtype=np.int64)
            carry = allgather(my_exit)[r]
        else:
            carry = allgather(np.zeros(2, dtype=np.int64))[r]
    # trailing partial chunk: closed by the last rank at EOF
    if process_id == R - 1 and int(carry[1]) > 0:
        ends.append(size)
        nrecs.append(int(carry[1]))

    # gather every rank's chunk list (tiny: 16 bytes per chunk)
    cnt_all = allgather(np.array([len(ends)], dtype=np.int64))[:, 0]
    max_c = int(cnt_all.max())
    if max_c == 0:
        return None
    padded = np.zeros(2 * max_c, dtype=np.int64)
    if ends:
        padded[: len(ends)] = ends
        padded[max_c : max_c + len(ends)] = nrecs
    allc = allgather(padded)

    plan: list[ChunkSpec] = []
    offset = 0
    blocks_total = max(1, -(-size // (1 << 20)))
    flag_from = (blocks_total - 1) * (1 << 20)
    for r in range(R):
        k = int(cnt_all[r])
        for i in range(k):
            end = int(allc[r, i])
            n = int(allc[r, max_c + i])
            # reference reader flag arithmetic (io/fastq._flag_visible):
            # set when the chunk's consume end lands in the file's final
            # 1MB buffer block and the file lacks a trailing newline
            flag = last_byte != 10 and end > flag_from
            plan.append(ChunkSpec(offset, end, n, flag))
            offset = end
    return plan


def plan_chunks(path: str, chunk_size: int = 1_000_000) -> list[ChunkSpec]:
    """One scanning pass: chunk boundaries + per-chunk flag state.

    Uses the reader's plan-only skip path (identical record selection, no
    field gathers) — every rank re-plans independently, so the planner's
    cost is the serial fraction of multi-host scaling and must stay far
    below the encode cost."""
    reader = FastqReader(path)
    plan: list[ChunkSpec] = []
    offset = 0
    while True:
        n, flag = reader.skip_block(budget_bases=chunk_size)
        if n == 0:
            break
        end = reader._gbase + min(reader._buf_used, reader._blen())
        plan.append(ChunkSpec(offset, end, n, flag))
        offset = end
    reader.close()
    return plan


def derive_header(path: str, chunk_size: int, engine: EngineConfig):
    """Header as a pure function of chunk 1 — every rank computes it
    locally and gets identical bytes (no broadcast needed)."""
    reader = FastqReader(path)
    block, _ = reader.read_block(budget_bases=chunk_size)
    reader.close()
    if block is None or block.n == 0:
        raise RfqFormatError(
            "failed to encode, please confirm the input FASTQ file is valid "
            "and not empty"
        )
    header = engine.make_header_se(block)
    return header


class _RangeReader(FastqReader):
    """FastqReader over a byte range of a plain file. The global offset
    base is preserved so the no-newline flag arithmetic stays exact."""

    def __init__(self, path: str, start: int, end: int, file_size: int,
                 last_byte: int):
        self._range_end = end
        self._file_size = file_size
        self._forced_last_byte = last_byte
        self._range_pos = start
        self._fh = open(path, "rb")
        self._fh.seek(start)
        # replicate FastqReader.__init__ manually (custom fetch + offsets)
        self.filename = path
        self.has_quality = True
        self.phred64 = False
        self._lpr = 4
        self.zipped = False
        self._file = self._fh
        self._buf = bytearray()
        self._buf_used = 0
        self._gbase = start
        self._eof = False
        self._total_size = start
        self._last_byte = 10
        self._scalar_mode = False
        self._dead = False
        import numpy as np

        self._nl = np.empty(0, dtype=np.int64)
        self._nl_parts = []
        self._scanned = 0
        self._nl_seam = False
        # bytearray mode only: the custom _fetch_block below reads the
        # byte range through the file handle
        self._mm = None
        self._mview = None
        self._fsize = 0
        self._fetched = 0
        self._fetch_block()

    def _fetch_block(self) -> None:
        want = min(1 << 20, self._range_end - self._range_pos)
        data = self._fh.read(want) if want > 0 else b""
        while 0 < len(data) < want:
            more = self._fh.read(want - len(data))
            if not more:
                break
            data += more
        self._range_pos += len(data)
        self._total_size += len(data)
        if len(data) < (1 << 20):
            self._eof = True
        self._buf += data

    def _flag_visible(self, e: int) -> bool:
        # flags come precomputed from the plan; range readers never decide
        return False


def encode_chunk_range(
    path: str,
    plan: list[ChunkSpec],
    lo: int,
    hi: int,
    header,
    header_bytes: bytes,
    out,
    engine: EngineConfig,
    chunk_size: int,
    workers: int = 1,
    verify: bool = False,
    fast_verify: bool = False,
) -> None:
    """Encode chunks plan[lo:hi] (already byte-delimited) to ``out``."""
    if lo >= hi:
        return
    reader = _range_reader_for(
        path, plan[lo].byte_start, plan[hi - 1].byte_end
    )
    comp = _Compressor(out, engine, verify, fast_verify, is_pe=False,
                       workers=workers)
    comp.header = header
    comp.header_bytes = header_bytes
    for spec in plan[lo:hi]:
        block, _ = reader.read_block(max_records=spec.n_reads)
        assert block is not None and block.n == spec.n_reads, (
            "chunk plan mismatch at bytes %d..%d" % (spec.byte_start, spec.byte_end)
        )
        comp.flush(block, spec.no_line_break_flag, False)
    comp.finish()
    reader.close()


@dataclass
class PairChunkSpec:
    byte_start1: int
    byte_end1: int
    byte_start2: int
    byte_end2: int
    n_pairs: int
    no_line_break_flag1: bool
    no_line_break_flag2: bool


def plan_pair_chunks(
    path1: str, path2: str = "", chunk_size: int = 1_000_000,
    interleaved: bool = False,
) -> list[PairChunkSpec]:
    """One scanning pass over both mates (or one interleaved stream):
    per-chunk byte ranges in each file plus the two trailing-newline flags
    (reference repaq.cpp:656-692 pair accumulation; flags :683-692)."""
    pair = FastqReaderPair(path1, path2, interleaved)
    plan: list[PairChunkSpec] = []
    off1 = off2 = 0
    while True:
        n_pairs, f1, f2 = pair.skip_pair_block(chunk_size)
        if n_pairs == 0:
            break
        r1 = pair.left
        end1 = r1._gbase + min(r1._buf_used, r1._blen())
        if interleaved:
            end2 = 0
        else:
            r2 = pair.right
            end2 = r2._gbase + min(r2._buf_used, r2._blen())
        plan.append(PairChunkSpec(off1, end1, off2, end2, n_pairs, f1, f2))
        off1, off2 = end1, end2
    pair.close()
    return plan


def derive_header_pe(path1: str, path2: str, chunk_size: int,
                     engine: EngineConfig, interleaved: bool = False):
    pair = FastqReaderPair(path1, path2, interleaved)
    block, _f1, _f2 = pair.read_pair_block(chunk_size)
    pair.close()
    if block is None or block.n == 0:
        raise RfqFormatError(
            "failed to encode, please confirm the input FASTQ file is valid "
            "and not empty"
        )
    return engine.make_header_pe(block)


def _range_reader_for(path: str, start: int, end: int) -> _RangeReader:
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(max(0, file_size - 1))
        last = f.read(1)
    return _RangeReader(path, start, end, file_size, last[0] if last else 10)


def encode_pair_chunk_range(
    path1: str,
    path2: str,
    plan: list[PairChunkSpec],
    lo: int,
    hi: int,
    header,
    header_bytes: bytes,
    out,
    engine: EngineConfig,
    workers: int = 1,
    interleaved: bool = False,
    verify: bool = False,
    fast_verify: bool = False,
) -> None:
    """Encode pair chunks plan[lo:hi] to ``out``."""
    if lo >= hi:
        return
    r1 = _range_reader_for(path1, plan[lo].byte_start1, plan[hi - 1].byte_end1)
    r2 = None
    if not interleaved:
        r2 = _range_reader_for(
            path2, plan[lo].byte_start2, plan[hi - 1].byte_end2
        )
    comp = _Compressor(out, engine, verify, fast_verify, is_pe=True,
                       workers=workers)
    comp.header = header
    comp.header_bytes = header_bytes
    for spec in plan[lo:hi]:
        if interleaved:
            block, _ = r1.read_block(max_records=2 * spec.n_pairs)
            assert block is not None and block.n == 2 * spec.n_pairs, (
                "interleaved chunk plan mismatch at %d..%d"
                % (spec.byte_start1, spec.byte_end1)
            )
        else:
            b1, _ = r1.read_block(max_records=spec.n_pairs)
            b2, _ = r2.read_block(max_records=spec.n_pairs)
            assert (
                b1 is not None and b2 is not None
                and b1.n == spec.n_pairs and b2.n == spec.n_pairs
            ), "pair chunk plan mismatch at %d..%d / %d..%d" % (
                spec.byte_start1, spec.byte_end1, spec.byte_start2,
                spec.byte_end2,
            )
            block = b1.interleave(b2)
        comp.flush(
            block, spec.no_line_break_flag1, spec.no_line_break_flag2
        )
    comp.finish()
    r1.close()
    if r2 is not None:
        r2.close()


def compress_pe_distributed(
    in1: str,
    in2: str,
    out1: str,
    chunk_size: int = 1_000_000,
    num_processes: int = 1,
    process_id: int = 0,
    engine: EngineConfig | None = None,
    workers: int = 1,
    assemble: bool = True,
    interleaved: bool = False,
    verify: bool = False,
    fast_verify: bool = False,
) -> str:
    """PE twin of compress_se_distributed: this rank encodes its chunk
    range to ``out1.part{pid}``; rank 0 assembles in order. With
    interleaved=True, in1 is a single R1/R2-interleaved stream and in2 is
    ignored."""
    engine = engine or get_engine()
    rfqz = out1.endswith(".rfqz")
    plan = plan_pair_chunks(in1, in2, chunk_size, interleaved)
    header = derive_header_pe(in1, in2, chunk_size, engine, interleaved)
    header_bytes = header.to_bytes()
    ranges = partition(len(plan), num_processes)
    lo, hi = ranges[process_id]
    part = "%s.part%d" % (out1, process_id)
    with open(part + ".tmp", "wb") as f:
        out = _part_sink(f, rfqz)
        encode_pair_chunk_range(
            in1, in2, plan, lo, hi, header, header_bytes, out, engine,
            workers, interleaved, verify=verify, fast_verify=fast_verify,
        )
        if out is not f:
            out.close()
    os.replace(part + ".tmp", part)  # completion is atomic for waiters
    if assemble and process_id == 0:
        assemble_parts(out1, header_bytes, num_processes, rfqz=rfqz)
    return part


def _part_sink(f, rfqz: bool):
    """Per-rank sink: raw .rfq bytes, or a bare .rfqz section stream
    (sections are self-delimiting, so rank parts concatenate into one
    container under a single magic+header — the second stage composes
    with sharding, reference main.cpp:134-159 composes xz the same way)."""
    if not rfqz:
        return f
    from ..format.rfqz import RfqzWriter

    return RfqzWriter(f, container_header=False)


def partition(n_chunks: int, n_processes: int) -> list[tuple[int, int]]:
    """Contiguous chunk ranges, remainder spread over the first ranks."""
    base = n_chunks // n_processes
    rem = n_chunks % n_processes
    ranges = []
    lo = 0
    for rank in range(n_processes):
        size = base + (1 if rank < rem else 0)
        ranges.append((lo, lo + size))
        lo += size
    return ranges


def compress_se_distributed(
    in1: str,
    out1: str,
    chunk_size: int = 1_000_000,
    num_processes: int = 1,
    process_id: int = 0,
    engine: EngineConfig | None = None,
    workers: int = 1,
    assemble: bool = True,
    verify: bool = False,
    fast_verify: bool = False,
) -> str:
    """Encode this process's chunk range to ``out1.part{pid}``; rank 0
    (with assemble=True, after all parts exist) concatenates header +
    parts into out1. Returns the part path written."""
    engine = engine or get_engine()
    rfqz = out1.endswith(".rfqz")
    plan = plan_chunks(in1, chunk_size)
    header = derive_header(in1, chunk_size, engine)
    header_bytes = header.to_bytes()
    ranges = partition(len(plan), num_processes)
    lo, hi = ranges[process_id]
    part = "%s.part%d" % (out1, process_id)
    with open(part + ".tmp", "wb") as f:
        out = _part_sink(f, rfqz)
        encode_chunk_range(
            in1, plan, lo, hi, header, header_bytes, out, engine, chunk_size,
            workers, verify=verify, fast_verify=fast_verify,
        )
        if out is not f:
            out.close()
    os.replace(part + ".tmp", part)  # completion is atomic for waiters
    if assemble and process_id == 0:
        assemble_parts(out1, header_bytes, num_processes, rfqz=rfqz)
    return part


@dataclass
class RfqChunkSpec:
    offset: int  # byte offset of the chunk record within the container
    reads: int
    flags: int


def plan_rfq_chunks(path: str) -> tuple[RfqHeader, list[RfqChunkSpec]]:
    """Chunk index of an .rfq container: one metadata-only pass.

    Chunks are self-delimiting (reference rfqchunk.cpp:161-227) but the
    wire ``size`` field is unreliable (format/chunk.py module docstring),
    so the scan parses each chunk's frame + length arrays and SEEKS over
    the payload buffers — an N-GB container costs only its metadata bytes.
    Every rank re-runs this independently: like the compress-side
    plan_chunks, the index is the (small) serial fraction of scaling."""
    with open(path, "rb") as f:
        header = RfqHeader.read(f)
        specs: list[RfqChunkSpec] = []
        while True:
            off = f.tell()
            c = RfqChunk.read(f, header, skip_payload=True)
            if c.reads == 0:
                break
            specs.append(RfqChunkSpec(off, c.reads, c.flags))
    return header, specs


def decompress_distributed(
    in1: str,
    out1: str,
    out2: str = "",
    num_processes: int = 1,
    process_id: int = 0,
    engine: EngineConfig | None = None,
    workers: int = 1,
    assemble: bool = True,
) -> str:
    """Multi-process decompress: this rank decodes its contiguous chunk
    range of the .rfq container to ``<out>.part<pid>`` FASTQ file(s);
    rank 0 (with assemble=True) concatenates the parts in order. Output
    bytes are identical to serial decompress for any process count.

    The decompress mirror of compress_se/pe_distributed — the reference
    has no parallel decompress, but the format makes it free: chunks
    decode independently, and the only cross-chunk state is the final
    chunk's no-trailing-newline trim, which the chunk index resolves
    up front (reference repaq.cpp:301-331)."""
    engine = engine or get_engine()
    header, specs = plan_rfq_chunks(in1)
    if out2 and not header.paired_end():
        raise RfqFormatError(
            "The input RFQ file was encoded by single-end FASTQ, you should "
            "not specify <out2>"
        )
    ranges = partition(len(specs), num_processes)
    lo, hi = ranges[process_id]
    owns_final = hi == len(specs) and hi > lo
    part1 = "%s.part%d" % (out1, process_id)
    part2 = "%s.part%d" % (out2, process_id) if out2 else ""
    job = (
        _pe_decode_job(engine, header) if out2
        else _se_decode_job(engine, header)
    )
    with open(part1 + ".tmp", "wb") as f1, (
        open(part2 + ".tmp", "wb") if out2 else open(os.devnull, "wb")
    ) as f2:
        if hi > lo:
            with open(in1, "rb") as src:
                src.seek(specs[lo].offset)
                for flags, n, strs, is_last in _decoded_fastq_stream(
                    src, header, job, workers, max_chunks=hi - lo
                ):
                    if n == 0:
                        break
                    final = is_last and owns_final
                    s1 = strs[0]
                    if final and (flags & BIT_HAS_NO_LINE_BREAK_AT_END):
                        s1 = s1[:-1]
                    f1.write(s1)
                    if out2:
                        s2 = strs[1]
                        if final and (flags & BIT_HAS_NO_LINE_BREAK_AT_END_R2):
                            s2 = s2[:-1]
                        f2.write(s2)
    os.replace(part1 + ".tmp", part1)  # completion is atomic for waiters
    if part2:
        os.replace(part2 + ".tmp", part2)
    if assemble and process_id == 0:
        assemble_fastq_parts(out1, num_processes)
        if out2:
            assemble_fastq_parts(out2, num_processes)
    return part1


def assemble_fastq_parts(out: str, num_processes: int) -> None:
    """Ordered concatenation of decompressed FASTQ parts (rank order ==
    chunk order); parts are removed after assembly."""
    with open(out, "wb") as dst:
        for pid in range(num_processes):
            part = "%s.part%d" % (out, pid)
            with open(part, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    dst.write(buf)
            os.remove(part)


def assemble_parts(out1: str, header_bytes: bytes, num_processes: int,
                   rfqz: bool = False) -> None:
    """Ordered concatenation: header, then each rank's part (rank order ==
    chunk order). Parts are removed after assembly. For .rfqz targets the
    container magic goes first and the .rfq header travels as its own
    section; rank parts are bare section streams."""
    with open(out1, "wb") as out:
        if rfqz:
            from ..format import rfqz as Z

            out.write(Z.MAGIC + bytes([Z.VERSION]))
            out.write(Z.encode_block(np.frombuffer(header_bytes, np.uint8)))
        else:
            out.write(header_bytes)
        for pid in range(num_processes):
            part = "%s.part%d" % (out1, pid)
            with open(part, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
            os.remove(part)
