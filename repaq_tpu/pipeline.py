"""Compress / decompress / compare drivers (block-native).

Mirrors the reference pipeline (reference repaq.cpp): chunk accumulation
until the base budget is reached, header inferred from the first chunk only,
per-chunk trailing-newline flags with one-chunk lookahead on decode, verify
modes, and the compare JSON verdict. All data moves as ReadBlock arrays —
no per-read objects on the hot path.

One deliberate divergence: the reference's PE decompress drops the lookahead
chunk when a no-line-break flag appears on a non-final chunk (reference
repaq.cpp:379-411 leaks it), losing reads; we carry the lookahead chunk into
the next iteration like the single-end path does (repaq.cpp:301-331).
"""

from __future__ import annotations

import io as _io
import json
import os
import sys
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

from .codec import oracle, vectorized
from .codec.blocks import ReadBlock
from .constants import (
    BIT_HAS_NO_LINE_BREAK_AT_END,
    BIT_HAS_NO_LINE_BREAK_AT_END_R2,
)
from .format.chunk import RfqChunk
from .format.header import RfqFormatError, RfqHeader
from .io.fastq import FastqReader, FastqReaderPair, Writer
from .profiling import NULL_TIMER, StageTimer


@dataclass
class EngineConfig:
    """Codec engine: block-level make_header/encode/decode callables."""

    make_header_se: Callable
    make_header_pe: Callable
    encode_chunk: Callable  # (header, block, is_pe) -> RfqChunk
    decode_chunk: Callable  # (header, chunk) -> ReadBlock
    name: str = "vectorized"


def _oracle_engine() -> EngineConfig:
    def mk_se(block):
        return oracle.make_header_se(block.to_reads())

    def mk_pe(block):
        reads = block.to_reads()
        return oracle.make_header_pe(list(zip(reads[0::2], reads[1::2])))

    def enc(header, block, is_pe):
        return oracle.encode_chunk(header, block.to_reads(), is_pe)

    def dec(header, chunk):
        return ReadBlock.from_reads(oracle.decode_chunk(header, chunk))

    return EngineConfig(mk_se, mk_pe, enc, dec, name="oracle")


def _accelerator_platform() -> str:
    """Platform of JAX's default device ('gpu', 'cpu', ...)."""
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return "cpu"  # pinned: answer without starting a backend
    import jax

    return jax.devices()[0].platform


def get_engine(name: str = "auto") -> EngineConfig:
    """Engine selection. 'auto' takes the device engine when JAX's default
    device is a GPU, else the vectorized host engine; REPAQ_ENGINE
    overrides 'auto' for deployment pinning. 'device' forces the JAX chunk
    codec on whatever backend JAX has."""
    if name == "auto":
        name = os.environ.get("REPAQ_ENGINE", "auto")
    if name == "auto":
        name = "device" if _accelerator_platform() == "gpu" else "vectorized"
    if name == "oracle":
        return _oracle_engine()
    if name == "device":
        from .codec.device_engine import make_engine_config

        return make_engine_config()
    return EngineConfig(
        make_header_se=vectorized.make_header_se,
        make_header_pe=vectorized.make_header_pe,
        encode_chunk=vectorized.encode_chunk,
        decode_chunk=vectorized.decode_chunk,
    )


def _blocks_equal(a: ReadBlock, b: ReadBlock) -> Optional[int]:
    """None if equal; else index of the first differing read."""
    if a.n == b.n and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in (
            "name_off",
            "seq_off",
            "strand_off",
            "qual_off",
            "name_flat",
            "seq_flat",
            "strand_flat",
            "qual_flat",
        )
    ):
        return None
    ra, rb = a.to_reads(), b.to_reads()
    for i in range(min(len(ra), len(rb))):
        if ra[i] != rb[i]:
            return i
    return min(len(ra), len(rb))


def _verify_chunk(
    header: RfqHeader,
    chunk_bytes: bytes,
    original: ReadBlock,
    engine: EngineConfig,
    header_bytes: bytes,
) -> bool:
    """Re-parse and fully decode an encoded chunk, comparing against the
    source block (reference repaq.cpp:430-528)."""
    header4check = RfqHeader.read(_io.BytesIO(header_bytes))
    header4check.support_interleaved = header.support_interleaved
    chunk = RfqChunk.read(_io.BytesIO(chunk_bytes), header4check)
    decoded = engine.decode_chunk(header4check, chunk)
    if decoded.n != original.n:
        raise RfqFormatError(
            "encoding error in chunk, the output will be wrong, quit now!"
        )
    bad = _blocks_equal(decoded, original)
    if bad is not None:
        got = decoded.to_reads()[bad]
        want = original.to_reads()[bad]
        print(
            "integrity check failure \nexpected: \n%s\ngot:\n%s"
            % (want.to_fastq().decode("latin1"), got.to_fastq().decode("latin1")),
            file=sys.stderr,
        )
        return False
    return True


def _open_out(out1: str, out_stream):
    if out_stream is not None:
        return out_stream, False
    if out1 in ("/dev/stdout", "-"):
        return sys.stdout.buffer, False
    return open(out1, "wb"), True


class _Compressor:
    """Chunk encoder with optional worker-thread data parallelism.

    Chunks are independent once the header is fixed (reference
    repaq.cpp:553-566), so with workers > 1 encode jobs run on a thread
    pool (the native kernels and numpy release the GIL) while writes stay
    ordered. Output bytes are identical for any worker count.
    """

    def __init__(self, out, engine, verify, fast_verify, is_pe,
                 timer=NULL_TIMER, workers: int = 1):
        self.out = out
        self.engine = engine
        self.verify = verify
        self.fast_verify = fast_verify
        self.is_pe = is_pe
        self.timer = timer
        self.header: Optional[RfqHeader] = None
        self.header_bytes = b""
        self.passnum = 0
        # stream-aligned entropy sections when the sink understands them
        # (.rfqz, format/rfqz.py) — same bytes, better section models
        self._segmented = hasattr(out, "write_segments")
        self.workers = max(1, workers)
        self._pool = None
        self._pending = None
        if self.workers > 1:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.workers)
            self._pending = deque()

    def _ensure_header(self, block: ReadBlock) -> None:
        if self.header is not None:
            return
        mk = (
            self.engine.make_header_pe if self.is_pe else self.engine.make_header_se
        )
        self.header = mk(block)
        if self.header is None:
            raise RfqFormatError(
                "failed to encode, please confirm the input FASTQ file is "
                "valid and not empty"
            )
        self.header_bytes = self.header.to_bytes()
        self.out.write(self.header_bytes)
        check = RfqHeader.read(_io.BytesIO(self.header_bytes))
        if not self.header.identical_with(check):
            raise RfqFormatError(
                "encoding error in header, the output will be wrong, quit now!"
            )

    def _encode(self, block: ReadBlock, flag_r1: bool, flag_r2: bool):
        chunk = self.engine.encode_chunk(self.header, block, self.is_pe)
        if chunk is None:
            return None
        if flag_r1:
            chunk.flags |= BIT_HAS_NO_LINE_BREAK_AT_END
        if self.is_pe and flag_r2:
            chunk.flags |= BIT_HAS_NO_LINE_BREAK_AT_END_R2
        if self._segmented:
            segs = chunk.to_segments()
            nbytes = sum(len(d) for _l, d in segs)
            # the joined image is only needed by the verify re-decode
            data = (
                b"".join(d for _l, d in segs)
                if (self.verify or self.fast_verify) else None
            )
            return data, segs, nbytes
        data = chunk.to_bytes()
        return data, None, len(data)

    def _emit(self, payload, block: ReadBlock) -> None:
        if payload is None:
            return
        data, segs, nbytes = payload
        with self.timer.stage("write", nbytes):
            if segs is not None:
                self.out.write_segments(segs)
            else:
                self.out.write(data)
        if self.verify or (self.fast_verify and self.passnum % 10 == 0):
            with self.timer.stage("verify"):
                _verify_chunk(
                    self.header, data, block, self.engine, self.header_bytes
                )
        self.passnum += 1

    def flush(self, block: ReadBlock, flag_r1: bool, flag_r2: bool) -> None:
        self._ensure_header(block)
        if self._pool is None:
            with self.timer.stage("encode", block.total_bases):
                data = self._encode(block, flag_r1, flag_r2)
            self._emit(data, block)
            return
        self._pending.append(
            (self._pool.submit(self._encode, block, flag_r1, flag_r2), block)
        )
        while len(self._pending) > self.workers + 2:
            fut, blk = self._pending.popleft()
            self._emit(fut.result(), blk)

    def finish(self) -> None:
        if self._pending:
            while self._pending:
                fut, blk = self._pending.popleft()
                self._emit(fut.result(), blk)
        if self._pool is not None:
            self._pool.shutdown()


def compress_se(
    in1: str,
    out1: str,
    chunk_size: int = 1_000_000,
    verify: bool = False,
    fast_verify: bool = False,
    engine: Optional[EngineConfig] = None,
    out_stream=None,
    profile: bool = False,
    workers: int = 1,
) -> None:
    engine = engine or get_engine()
    timer = StageTimer(profile)
    reader = FastqReader(in1)
    out, own = _open_out(out1, out_stream)
    comp = _Compressor(out, engine, verify, fast_verify, is_pe=False,
                       timer=timer, workers=workers)
    while True:
        with timer.stage("read"):
            block, flag = reader.read_block(budget_bases=chunk_size)
        if block is None or block.n == 0:
            break
        timer.bytes["read"] += block.total_bases
        comp.flush(block, flag, False)
    comp.finish()
    reader.close()
    timer.report("compress")
    if own:
        out.close()
    elif out is sys.stdout.buffer:
        out.flush()


def compress_pe(
    in1: str,
    in2: str,
    out1: str,
    chunk_size: int = 1_000_000,
    interleaved: bool = False,
    verify: bool = False,
    fast_verify: bool = False,
    engine: Optional[EngineConfig] = None,
    out_stream=None,
    profile: bool = False,
    workers: int = 1,
) -> None:
    engine = engine or get_engine()
    timer = StageTimer(profile)
    reader = FastqReaderPair(in1, in2, interleaved)
    out, own = _open_out(out1, out_stream)
    comp = _Compressor(out, engine, verify, fast_verify, is_pe=True,
                       timer=timer, workers=workers)
    while True:
        with timer.stage("read"):
            block, flag1, flag2 = reader.read_pair_block(chunk_size)
        if block is None or block.n == 0:
            break
        timer.bytes["read"] += block.total_bases
        comp.flush(block, flag1, flag2)
    comp.finish()
    reader.close()
    timer.report("compress")
    if own:
        out.close()
    elif out is sys.stdout.buffer:
        out.flush()


def _iter_chunks(stream, header: RfqHeader) -> Iterable[RfqChunk]:
    while True:
        chunk = RfqChunk.read(stream, header)
        if chunk.reads == 0:
            return
        yield chunk


def _open_in(in1: str, in_stream):
    if in_stream is not None:
        return in_stream, False
    if in1 in ("/dev/stdin", "-"):
        return sys.stdin.buffer, False
    return open(in1, "rb"), True


def _decoded_fastq_stream(stream, header: RfqHeader, job, workers: int,
                          max_chunks: int = -1):
    """Yield ``(flags, n, strs, is_last)`` per chunk in container order.

    ``job(chunk)`` decodes one chunk to ``(n_reads, strs)`` — chunks are
    independent once the header is parsed (reference rfqchunk.cpp:161-171
    self-delimiting records), so with workers > 1 the jobs run on a thread
    pool (numpy + native kernels release the GIL) while the chunk parse
    and ordered emission stay serial: output bytes are identical for any
    worker count — the decode mirror of _Compressor. The reference has no
    parallel decompress at all; BASELINE's metric is encode+decode.

    A one-chunk lookahead is always held so ``is_last`` is exact — the
    trailing-newline trim (reference repaq.cpp:301-331) applies only to
    the container's final chunk. ``max_chunks`` bounds the scan for the
    sharded range decoder."""
    from collections import deque

    pool = None
    depth = 1
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)
        depth = workers + 2
    pending: deque = deque()

    def result(item):
        chunk, fut = item
        n, strs = fut.result() if fut is not None else job(chunk)
        return chunk.flags, n, strs

    try:
        read_count = 0
        while max_chunks < 0 or read_count < max_chunks:
            chunk = RfqChunk.read(stream, header)
            if chunk.reads == 0:
                break
            read_count += 1
            pending.append(
                (chunk, pool.submit(job, chunk) if pool else None)
            )
            while len(pending) > depth:
                flags, n, strs = result(pending.popleft())
                yield flags, n, strs, False
        while pending:
            item = pending.popleft()
            flags, n, strs = result(item)
            yield flags, n, strs, not pending
    finally:
        if pool is not None:
            pool.shutdown()


def _se_decode_job(engine: EngineConfig, header: RfqHeader):
    def job(chunk):
        block = engine.decode_chunk(header, chunk)
        return block.n, (block.to_fastq_buf(),)

    return job


def _pe_decode_job(engine: EngineConfig, header: RfqHeader):
    def job(chunk):
        block = engine.decode_chunk(header, chunk)
        idx = np.arange(block.n)
        return block.n, (
            block.to_fastq_buf(idx[0::2]),
            block.to_fastq_buf(idx[1::2]),
        )

    return job


def decompress(
    in1: str,
    out1: str,
    engine: Optional[EngineConfig] = None,
    in_stream=None,
    workers: int = 1,
) -> None:
    """Single-output decompress; PE containers produce interleaved FASTQ
    (reference repaq.cpp:262-333)."""
    engine = engine or get_engine()
    stream, own = _open_in(in1, in_stream)
    writer = Writer(out1)
    header = RfqHeader.read(stream)

    job = _se_decode_job(engine, header)
    for flags, n, (outstr,), is_last in _decoded_fastq_stream(
        stream, header, job, workers
    ):
        if n == 0:
            break
        if is_last and (flags & BIT_HAS_NO_LINE_BREAK_AT_END):
            outstr = outstr[:-1]
        writer.write(outstr)
    writer.close()
    if own:
        stream.close()


def decompress_pe(
    in1: str,
    out1: str,
    out2: str,
    engine: Optional[EngineConfig] = None,
    in_stream=None,
    workers: int = 1,
) -> None:
    engine = engine or get_engine()
    stream, own = _open_in(in1, in_stream)
    writer1 = Writer(out1)
    writer2 = Writer(out2)
    header = RfqHeader.read(stream)
    if not header.paired_end():
        raise RfqFormatError(
            "The input RFQ file was encoded by single-end FASTQ, you should "
            "not specify <out2>"
        )

    job = _pe_decode_job(engine, header)
    for flags, n, (outstr1, outstr2), is_last in _decoded_fastq_stream(
        stream, header, job, workers
    ):
        if n == 0:
            break
        no_break1 = bool(flags & BIT_HAS_NO_LINE_BREAK_AT_END)
        no_break2 = bool(flags & BIT_HAS_NO_LINE_BREAK_AT_END_R2)
        writer1.write(outstr1[:-1] if (no_break1 and is_last) else outstr1)
        writer2.write(outstr2[:-1] if (no_break2 and is_last) else outstr2)
    writer1.close()
    writer2.close()
    if own:
        stream.close()


def _report_compare(
    passed: bool,
    msg: str,
    fq_reads: int,
    fq_bases: int,
    rfq_reads: int,
    rfq_bases: int,
    json_file: str = "",
    quiet: bool = False,
) -> dict:
    # exact reference layout (repaq.cpp:235-259)
    text = "{\n"
    text += '\t"result":"%s",\n' % ("passed" if passed else "failed")
    text += '\t"msg":"%s",\n' % msg
    text += '\t"fastq_reads":%d,\n' % fq_reads
    text += '\t"rfq_reads":%d,\n' % rfq_reads
    text += '\t"fastq_bases":%d,\n' % fq_bases
    text += '\t"rfq_bases":%d\n' % rfq_bases
    text += "}\n"
    if json_file:
        with open(json_file, "w") as f:
            f.write(text)
    if not quiet:
        sys.stdout.write(text)
    return json.loads(text)


_FIELD_LABELS = ("name", "sequence", "strand", "quality")


def _compare_read(got: oracle.FastqRead, want: oracle.FastqRead):
    for label, g, w in zip(
        _FIELD_LABELS, (got.name, got.seq, got.strand, got.qual),
        (want.name, want.seq, want.strand, want.qual),
    ):
        if g != w:
            return label, g, w
    return None


def compare(
    in1: str,
    rfq: str,
    json_file: str = "",
    engine: Optional[EngineConfig] = None,
    in_stream=None,
    quiet: bool = False,
) -> dict:
    """Read-by-read consistency check (reference repaq.cpp:36-128)."""
    engine = engine or get_engine()
    stream, _own = _open_in(rfq, in_stream)
    reader = FastqReader(in1)
    header = RfqHeader.read(stream)

    fq_reads = fq_bases = rfq_reads = rfq_bases = 0
    for chunk in _iter_chunks(stream, header):
        decoded = engine.decode_chunk(header, chunk)
        if decoded.n == 0:
            break
        fq_block, _flag = reader.read_block(max_records=decoded.n)
        n_fq = fq_block.n if fq_block is not None else 0
        seq_lens = decoded.seq_lens()
        if n_fq == decoded.n:
            bad = _blocks_equal(decoded, fq_block)
            if bad is None:
                rfq_reads += decoded.n
                rfq_bases += int(seq_lens.sum())
                fq_reads += decoded.n
                fq_bases += int(np.diff(fq_block.seq_off).sum())
                continue
        else:
            bad = n_fq  # first missing fastq read
        # slow path: account reads up to the mismatch like the reference
        got_reads = decoded.to_reads()
        fq_reads_list = fq_block.to_reads() if fq_block is not None else []
        for i in range(bad):
            rfq_reads += 1
            rfq_bases += len(got_reads[i].seq)
            fq_reads += 1
            fq_bases += len(fq_reads_list[i].seq)
        rfq_reads += 1
        rfq_bases += len(got_reads[bad].seq)
        if bad >= n_fq:
            msg = (
                "The RFQ file has more reads than the FASTQ file. The RFQ "
                "file has >= %d reads, while the FASTQ file only has %d reads"
                % (rfq_reads, fq_reads)
            )
            return _report_compare(
                False, msg, fq_reads, fq_bases, rfq_reads, rfq_bases, json_file,
                quiet,
            )
        fq_reads += 1
        fq_bases += len(fq_reads_list[bad].seq)
        label, g, w = _compare_read(got_reads[bad], fq_reads_list[bad])
        msg = (
            "The RFQ file and FASTQ file have different %s in the %d read. "
            "%s | %s" % (label, rfq_reads, g.decode("latin1"), w.decode("latin1"))
        )
        return _report_compare(
            False, msg, fq_reads, fq_bases, rfq_reads, rfq_bases, json_file, quiet
        )
    if reader.read() is not None:
        fq_reads += 1
        msg = (
            "The FASTQ file has more reads than the RFQ file. The FASTQ file "
            "has >= %d reads, while the RFQ file only has %d reads"
            % (fq_reads, rfq_reads)
        )
        return _report_compare(
            False, msg, fq_reads, fq_bases, rfq_reads, rfq_bases, json_file, quiet
        )
    return _report_compare(
        True, "", fq_reads, fq_bases, rfq_reads, rfq_bases, json_file, quiet
    )


def compare_pe(
    in1: str,
    in2: str,
    rfq: str,
    json_file: str = "",
    engine: Optional[EngineConfig] = None,
    in_stream=None,
    quiet: bool = False,
) -> dict:
    engine = engine or get_engine()
    stream, _own = _open_in(rfq, in_stream)
    r1 = FastqReader(in1)
    r2 = FastqReader(in2)
    header = RfqHeader.read(stream)

    fq_reads = fq_bases = rfq_reads = rfq_bases = 0
    for chunk in _iter_chunks(stream, header):
        decoded = engine.decode_chunk(header, chunk)
        if decoded.n == 0:
            break
        pairs = decoded.n // 2
        b1, _ = r1.read_block(max_records=pairs)
        b2, _ = r2.read_block(max_records=pairs)
        n1 = b1.n if b1 is not None else 0
        n2 = b2.n if b2 is not None else 0
        fq_block = None
        if n1 == pairs and n2 == pairs:
            fq_block = b1.interleave(b2)
            bad = _blocks_equal(decoded, fq_block)
            if bad is None:
                rfq_reads += decoded.n
                rfq_bases += int(decoded.seq_lens().sum())
                fq_reads += decoded.n
                fq_bases += int(np.diff(fq_block.seq_off).sum())
                continue
        else:
            bad = 2 * min(n1, n2)  # first read lacking a complete pair
        got_reads = decoded.to_reads()
        want_reads = fq_block.to_reads() if fq_block is not None else (
            [x for p in zip(b1.to_reads() if b1 else [], b2.to_reads() if b2 else []) for x in p]
        )
        for i in range(bad):
            rfq_reads += 1
            rfq_bases += len(got_reads[i].seq)
            fq_reads += 1
            fq_bases += len(want_reads[i].seq)
        rfq_reads += 1
        rfq_bases += len(got_reads[bad].seq)
        if bad >= len(want_reads):
            msg = (
                "The RFQ file has more reads than the FASTQ file. The RFQ "
                "file has >= %d pairs, while the FASTQ file only has %d pairs"
                % (rfq_reads // 2, fq_reads // 2)
            )
            return _report_compare(
                False, msg, fq_reads, fq_bases, rfq_reads, rfq_bases, json_file,
                quiet,
            )
        fq_reads += 1
        fq_bases += len(want_reads[bad].seq)
        label, g, w = _compare_read(got_reads[bad], want_reads[bad])
        msg = (
            "The RFQ file and FASTQ file have different %s in the %d pair. "
            "%s | %s"
            % (label, rfq_reads // 2, g.decode("latin1"), w.decode("latin1"))
        )
        return _report_compare(
            False, msg, fq_reads, fq_bases, rfq_reads, rfq_bases, json_file, quiet
        )
    if r1.read() is not None and r2.read() is not None:
        fq_reads += 1
        msg = (
            "The FASTQ file has more reads than the RFQ file. The FASTQ file "
            "has >= %d pairs, while the RFQ file only has %d pairs"
            % (fq_reads // 2, rfq_reads // 2)
        )
        return _report_compare(
            False, msg, fq_reads, fq_bases, rfq_reads, rfq_bases, json_file, quiet
        )
    return _report_compare(
        True, "", fq_reads, fq_bases, rfq_reads, rfq_bases, json_file, quiet
    )
