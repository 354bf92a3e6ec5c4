"""Reference-exact scalar codec.

This module is the executable specification: a direct, readable Python
rendering of the reference algorithms (reference rfqcodec.cpp) operating on
individual reads. It is used as the test oracle for the vectorized/device
paths and as the engine for small inputs; the production path is
``repaq_tpu.codec.vectorized``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    BIT_ENCODE_PE_BY_OVERLAP,
    BIT_HAS_LANE,
    BIT_HAS_NAME2,
    BIT_HAS_TILE,
    BIT_HAS_X,
    BIT_HAS_Y,
    BIT_LANE_SAME,
    BIT_NAME1_LEN_SAME,
    BIT_NAME1_SAME,
    BIT_NAME2_LEN_SAME,
    BIT_NAME2_SAME,
    BIT_PAIRED_END,
    BIT_PE_INTERLEAVED,
    BIT_READ_LEN_SAME,
    BIT_STRAND_LEN_SAME,
    BIT_STRAND_SAME,
    BIT_TILE_SAME,
    MIN_OVERLAP,
)
from ..format.chunk import RfqChunk
from ..format.header import RfqFormatError, RfqHeader
from ..meta import parse_name
from ..util import u32le

_REVCOMP = bytes.maketrans(b"AaTtCcGg", b"TTAAGGCC")


def reverse_complement(seq: bytes) -> bytes:
    """Reverse complement with non-ACGT mapping to N (reference read.cpp:77-115)."""
    out = bytearray(seq[::-1].translate(_REVCOMP))
    for i, b in enumerate(out):
        if b not in b"ATCG":
            out[i] = ord("N")
    return bytes(out)


@dataclass
class FastqRead:
    name: bytes
    seq: bytes
    strand: bytes
    qual: bytes

    def to_fastq(self) -> bytes:
        return b"%s\n%s\n%s\n%s\n" % (self.name, self.seq, self.strand, self.qual)

    def reverse_complemented(self) -> "FastqRead":
        return FastqRead(
            self.name, reverse_complement(self.seq), self.strand, self.qual[::-1]
        )


# ---------------------------------------------------------------------------
# header inference (reference rfqcodec.cpp:20-145)
# ---------------------------------------------------------------------------


def make_header_se(reads: list[FastqRead]) -> RfqHeader | None:
    if not reads:
        return None
    header = RfqHeader()
    has_ltxy = True
    max_len = 0
    for r in reads:
        has_ltxy &= parse_name(r.name).has_lane_tile_xy
        max_len = max(max_len, len(r.seq))
    if has_ltxy:
        header.flags |= (
            BIT_HAS_LANE | BIT_HAS_TILE | BIT_HAS_X | BIT_HAS_Y | BIT_HAS_NAME2
        )
    _make_quality_table(header, reads)
    _set_read_length_bytes(header, max_len)
    return header


def make_header_pe(pairs: list[tuple[FastqRead, FastqRead]]) -> RfqHeader | None:
    if not pairs:
        return None
    header = RfqHeader()
    has_ltxy = True
    max_len = 0
    support_interleaved = True
    name2_diff_pos = 0
    name2_diff_char = 0
    all_reads: list[FastqRead] = []

    for i, (r1, r2) in enumerate(pairs):
        all_reads.append(r1)
        all_reads.append(r2)
        m1 = parse_name(r1.name)
        m2 = parse_name(r2.name)
        has_ltxy &= m1.has_lane_tile_xy
        has_ltxy &= m2.has_lane_tile_xy
        max_len = max(max_len, len(r1.seq), len(r2.seq))

        if not has_ltxy:
            support_interleaved = False
        elif support_interleaved:
            if i == 0:
                if len(m1.name_part2) != len(m2.name_part2):
                    support_interleaved = False
                for p in range(len(m1.name_part2)):
                    if m1.name_part2[p] != m2.name_part2[p]:
                        name2_diff_pos = p
                        name2_diff_char = m2.name_part2[p]
                        break
            if len(m1.name_part2) < name2_diff_pos:
                support_interleaved = False
            else:
                replaced = bytearray(m1.name_part2)
                if name2_diff_char != 0 and name2_diff_pos < len(replaced):
                    replaced[name2_diff_pos] = name2_diff_char
                if bytes(replaced) != m2.name_part2:
                    support_interleaved = False

    if support_interleaved:
        header.support_interleaved = True
        header.name2_diff_pos = name2_diff_pos
        header.name2_diff_char = name2_diff_char
        header.flags |= BIT_ENCODE_PE_BY_OVERLAP

    _make_quality_table(header, all_reads)

    if has_ltxy:
        header.flags |= (
            BIT_HAS_LANE | BIT_HAS_TILE | BIT_HAS_X | BIT_HAS_Y | BIT_HAS_NAME2
        )
    header.flags |= BIT_PAIRED_END
    _set_read_length_bytes(header, max_len)
    return header


def _make_quality_table(header: RfqHeader, reads: list[FastqRead]) -> None:
    seq = np.frombuffer(b"".join(r.seq for r in reads), dtype=np.uint8)
    qual = np.frombuffer(b"".join(r.qual for r in reads), dtype=np.uint8)
    header.make_quality_table(seq, qual)


def _set_read_length_bytes(header: RfqHeader, max_len: int) -> None:
    # NOTE: reproduces the reference's dead `=4` branch (rfqcodec.cpp:48-53):
    # the >65535 assignment is immediately overwritten, so lengths >65535
    # get read_length_bytes=2 and are effectively unsupported.
    if max_len > 65535:
        header.read_length_bytes = 4
    if max_len > 255:
        header.read_length_bytes = 2
    else:
        header.read_length_bytes = 1


# ---------------------------------------------------------------------------
# token coders (reference rfqcodec.cpp:588-824, 1262-1438)
# ---------------------------------------------------------------------------


def pack_bases_2bit(seq: bytes) -> bytes:
    """2 bits/base, G=0 A=1 T=2 C=3, low bits first within each byte; N packs
    as 0 (reference rfqcodec.cpp:588-609)."""
    out = bytearray((len(seq) + 3) // 4)
    table = {ord("G"): 0, ord("A"): 1, ord("T"): 2, ord("C"): 3}
    for i, b in enumerate(seq):
        val = table.get(b, 0)
        out[i >> 2] |= val << ((i & 3) * 2)
    return bytes(out)


def unpack_bases_2bit(buf: bytes, length: int) -> bytearray:
    out = bytearray(b"N" * length)
    table = b"GATC"
    decoded = 0
    for byte in buf:
        for b in range(4):
            if decoded >= length:
                return out
            out[decoded] = table[(byte >> (b * 2)) & 3]
            decoded += 1
    return out


def encode_single_qual_by_col(
    qual: bytes, q: int, qual_mask: bytearray | None = None
) -> bytes:
    """Gap/run position stream for one quality bin (reference rfqcodec.cpp:625-710).

    Tokens: 0xxxxxxx gap 1..128 | 10xxxxxx+1B gap <=16384 | 110xxxxx run of
    1..32 consecutive matches (only when adjacent AND cur>1) | 111xxxxx+3B
    gap <=2^29.
    """
    out = bytearray()
    last = -1
    cur = 0
    n = len(qual)
    while cur < n:
        while qual[cur] != q:
            cur += 1
            if cur >= n:
                return bytes(out)
        if qual_mask is not None:
            qual_mask[cur] = 1
        if cur - last == 1 and cur > 1:
            run = 1
            while cur + run != n and run < 32 and qual[cur + run] == q:
                run += 1
            if qual_mask is not None:
                for k in range(cur, cur + run):
                    qual_mask[k] = 1
            out.append((run - 1) | 0xC0)
            cur += run
            last = cur - 1
            continue
        distance = cur - last
        if distance <= 128:
            out.append(distance - 1)
        elif distance <= (1 << 14):
            data = distance - 1
            out.append((data >> 8) | 0x80)
            out.append(data & 0xFF)
        else:
            data = distance - 1
            out.append((data >> 24) | 0xE0)
            out.append((data >> 16) & 0xFF)
            out.append((data >> 8) & 0xFF)
            out.append(data & 0xFF)
        last = cur
        cur += 1
    return bytes(out)


def decode_single_qual_by_col(buf: bytes, q: int, target: bytearray) -> None:
    """Scatter one bin's positions back (reference rfqcodec.cpp:957-1007)."""
    consumed = 0
    last = -1
    n = len(buf)
    while consumed < n:
        b0 = buf[consumed]
        if (b0 & 0x80) == 0:
            distance = b0 + 1
            target[last + distance] = q
            consumed += 1
            last += distance
        elif (b0 & 0x40) == 0:
            distance = (((b0 & 0x3F) << 8) | buf[consumed + 1]) + 1
            target[last + distance] = q
            consumed += 2
            last += distance
        elif (b0 & 0x20) == 0:
            run = (b0 & 0x1F) + 1
            for i in range(1, run + 1):
                target[i + last] = q
            consumed += 1
            last += run
        else:
            distance = (
                ((b0 & 0x1F) << 24)
                | (buf[consumed + 1] << 16)
                | (buf[consumed + 2] << 8)
                | buf[consumed + 3]
            ) + 1
            target[last + distance] = q
            consumed += 4
            last += distance


def encode_qual_by_col(header: RfqHeader, qual: bytes) -> bytes:
    """Per-bin streams + escape records (reference rfqcodec.cpp:712-765)."""
    bins = header.normal_qual_buf()
    mask = bytearray(len(qual))
    out = bytearray()
    streams = []
    for q in bins:
        streams.append(encode_single_qual_by_col(qual, int(q), mask))
    for s in streams:
        out += u32le(len(s))
    for s in streams:
        out += s
    mq = header.major_qual()
    for i, qv in enumerate(qual):
        if not mask[i] and qv != mq:
            out.append(qv)
            out += u32le(i)
    return bytes(out)


def decode_qual_by_col(header: RfqHeader, buf: bytes, qual: bytearray) -> None:
    bins = header.normal_qual_buf()
    nbins = len(bins)
    lens = [
        int.from_bytes(buf[4 * i : 4 * i + 4], "little") for i in range(nbins)
    ]
    consumed = 4 * nbins
    for q, ln in zip(bins, lens):
        decode_single_qual_by_col(buf[consumed : consumed + ln], int(q), qual)
        consumed += ln
    while consumed < len(buf):
        q = buf[consumed]
        pos = int.from_bytes(buf[consumed + 1 : consumed + 5], "little")
        consumed += 5
        if pos < len(qual):
            qual[pos] = q
    return None


def encode_qual_runlen(header: RfqHeader, qual: bytes) -> bytes:
    """Legacy run-length coder (reference rfqcodec.cpp:767-824). Unreachable
    for v2-encoded files (by-col always wins) but kept for parity/decode."""
    out = bytearray()
    mq = header.major_qual()
    mq_bits = header.major_qual_num_bits()
    nq_bits = header.normal_qual_num_bits
    mq_max = 1 << mq_bits
    nq_max = 1 << nq_bits
    cur_qual = qual[0]
    first = 0
    for i in range(1, len(qual)):
        q = qual[i]
        restart = q != cur_qual
        if not restart:
            if cur_qual == mq and i - first >= mq_max:
                restart = True
            if cur_qual != mq and i - first >= nq_max:
                restart = True
        if restart:
            num = i - first - 1
            bit = int(header.qual2bit[cur_qual])
            shift = (8 - mq_bits) if cur_qual == mq else (8 - nq_bits)
            out.append((bit | (num << shift)) & 0xFF)
            first = i
            cur_qual = q
    num = len(qual) - first - 1
    bit = int(header.qual2bit[cur_qual])
    shift = (8 - mq_bits) if cur_qual == mq else (8 - nq_bits)
    out.append((bit | (num << shift)) & 0xFF)
    return bytes(out)


def decode_qual_runlen(header: RfqHeader, buf: bytes, qual: bytearray) -> None:
    """Reference rfqcodec.cpp:919-955."""
    mq_bits = header.major_qual_num_bits()
    nq_bits = header.normal_qual_num_bits
    nq_mask = (1 << (8 - nq_bits)) - 1
    n_base_qual = header.n_base_qual
    length = len(qual)
    decoded = 0
    while decoded < length:
        for byte in buf:
            if byte & 0x01 == 0:
                q = 0
                num = byte >> (8 - mq_bits)
            else:
                q = byte & nq_mask
                num = byte >> (8 - nq_bits)
            num += 1
            qv = int(header.bit2qual[q])
            for fill in range(decoded, min(decoded + num, length)):
                qual[fill] = qv
            decoded += num
            if decoded >= length:
                break


def encode_coords(values: list[int]) -> bytes:
    """Delta/repeat/absolute coordinate coder (reference rfqcodec.cpp:1262-1330)."""
    last = 1000
    repeat = 0
    out = bytearray()
    for val in values:
        if repeat > 0 and (val != last or repeat == 32):
            out.append((repeat - 1) | 0xC0)
            repeat = 0
        if val == last:
            repeat += 1
            continue
        diff = val - last
        last = val
        if 0 < diff <= 64:
            out.append((diff - 1) | 0x80)
            continue
        if val <= 32767:
            out.append(val >> 8)
            out.append(val & 0xFF)
        elif val < (1 << 21):
            out.append((val >> 16) | 0xE0)
            out.append((val >> 8) & 0xFF)
            out.append(val & 0xFF)
        else:
            raise RfqFormatError(
                "The X/Y coordinate cannot be larger than 2M, but we get: %d" % val
            )
    if repeat > 0:
        out.append((repeat - 1) | 0xC0)
    return bytes(out)


def decode_coords(buf: bytes, num: int) -> list[int]:
    """Reference rfqcodec.cpp:1332-1389."""
    last = 1000
    out: list[int] = []
    consumed = 0
    n = len(buf)
    while consumed < n:
        b0 = buf[consumed]
        consumed += 1
        if (b0 & 0x80) == 0:
            val = (b0 << 8) | buf[consumed]
            consumed += 1
            out.append(val)
            last = val
        elif (b0 & 0x40) == 0:
            val = last + (b0 & 0x3F) + 1
            out.append(val)
            last = val
        elif (b0 & 0x20) == 0:
            rep = (b0 & 0x1F) + 1
            out.extend([last] * rep)
        else:
            val = ((b0 & 0x1F) << 16) | (buf[consumed] << 8) | buf[consumed + 1]
            consumed += 2
            out.append(val)
            last = val
    return out


def overlap(r1: bytes, r2: bytes) -> int:
    """First exact suffix/prefix overlap >= 12, forward then backward
    (reference rfqcodec.cpp:1391-1438). r2 is already reverse-complemented."""
    minlen = min(len(r1), len(r2))
    for o in range(MIN_OVERLAP, minlen + 1):
        if r1[len(r1) - o :] == r2[:o]:
            return o
    for o in range(MIN_OVERLAP, minlen + 1):
        if r2[len(r2) - o :] == r1[:o]:
            return -o
    return 0


# ---------------------------------------------------------------------------
# chunk encode (reference rfqcodec.cpp:163-586)
# ---------------------------------------------------------------------------


def encode_chunk(
    header: RfqHeader, reads: list[FastqRead], is_pe: bool = False
) -> RfqChunk | None:
    s = len(reads)
    if s == 0:
        return None

    metas = [parse_name(r.name) for r in reads]
    m0 = metas[0]
    r0 = reads[0]

    read_len0 = len(r0.seq)
    name1_len0 = len(m0.name_part1)
    name2_len0 = len(m0.name_part2)
    strand_len0 = len(r0.strand)
    strand0 = r0.strand
    lane0 = m0.lane
    tile0 = m0.tile
    name10 = m0.name_part1
    name20 = m0.name_part2

    read_len_same = True
    name1_len_same = True
    name2_len_same = True
    strand_len_same = True
    strand_same = True
    lane_same = True
    tile_same = True
    name1_same = True
    name2_same = True

    lane_buf = [0] * s
    tile_buf = [0] * s
    x_buf = [0] * s
    y_buf = [0] * s

    can_interleave = is_pe and header.support_interleaved
    encode_overlap = can_interleave and header.encode_pe_by_overlap()

    last_name2 = b""
    last_lane = last_tile = last_x = last_y = 0
    for i, (r, meta) in enumerate(zip(reads, metas)):
        rlen = len(r.seq)
        read_len_same &= read_len0 == rlen
        name1_len_same &= name1_len0 == len(meta.name_part1)
        name2_len_same &= name2_len0 == len(meta.name_part2)
        strand_len_same &= strand_len0 == len(r.strand)
        strand_same &= strand0 == r.strand
        lane_same &= lane0 == meta.lane
        tile_same &= tile0 == meta.tile
        name1_same &= name10 == meta.name_part1
        if not can_interleave:
            name2_same &= name20 == meta.name_part2
        else:
            if i % 2 == 1:
                replaced = bytearray(last_name2)
                if header.name2_diff_char != 0 and header.name2_diff_pos < len(
                    replaced
                ):
                    replaced[header.name2_diff_pos] = header.name2_diff_char
                if bytes(replaced) != meta.name_part2:
                    can_interleave = False
                    name2_same &= name20 == meta.name_part2
            else:
                last_name2 = meta.name_part2
                name2_same &= name20 == meta.name_part2

        lane_buf[i] = meta.lane
        tile_buf[i] = meta.tile
        x_buf[i] = meta.x
        y_buf[i] = meta.y

        if can_interleave:
            if i % 2 == 1:
                can_interleave &= last_lane == meta.lane
                can_interleave &= last_tile == meta.tile
                can_interleave &= last_x == meta.x
                can_interleave &= last_y == meta.y
            else:
                last_lane, last_tile = meta.lane, meta.tile
                last_x, last_y = meta.x, meta.y

    if can_interleave:
        lane_buf = [lane_buf[p * 2] for p in range(s // 2)]
        tile_buf = [tile_buf[p * 2] for p in range(s // 2)]
        x_buf = [x_buf[p * 2] for p in range(s // 2)]
        y_buf = [y_buf[p * 2] for p in range(s // 2)]

    # ---- pass 2: fill buffers ----
    read_len_parts = bytearray()
    name1_parts = bytearray()
    name2_parts = bytearray()
    strand_parts = bytearray()
    name1_len_parts = bytearray()
    name2_len_parts = bytearray()
    strand_len_parts = bytearray()
    seq_parts = bytearray()
    qual_parts = bytearray()
    overlap_bytes = bytearray(s // 2) if encode_overlap else bytearray()

    prev_seq = b""
    for i, (r, meta) in enumerate(zip(reads, metas)):
        seq = r.seq
        qual = r.qual
        rlen = len(seq)
        if not read_len_same:
            nb = header.read_length_bytes
            read_len_parts += (rlen & ((1 << (8 * nb)) - 1)).to_bytes(nb, "little")
        if not name1_same:
            name1_parts += meta.name_part1
            if not name1_len_same:
                name1_len_parts.append(len(meta.name_part1) & 0xFF)
        if not name2_same:
            name2_parts += meta.name_part2
            if not name2_len_same:
                name2_len_parts.append(len(meta.name_part2) & 0xFF)
        if not strand_same:
            strand_parts += r.strand
            if not strand_len_same:
                strand_len_parts.append(len(r.strand) & 0xFF)

        overlapped = 0
        if can_interleave and i % 2 == 1:
            seq = reverse_complement(seq)
            qual = qual[::-1]
            if encode_overlap:
                overlapped = overlap(prev_seq, seq)
                if overlapped + header.overlap_shift > 127:
                    overlapped = 0
                if overlapped + header.overlap_shift < -127:
                    overlapped = 0
                overlap_bytes[i // 2] = (overlapped + header.overlap_shift) & 0xFF

        if overlapped == 0:
            seq_parts += seq
        elif overlapped > 0:
            seq_parts += seq[overlapped:]
        else:
            seq_parts += seq[: rlen + overlapped]
        qual_parts += qual
        prev_seq = seq

    seq_concat = bytes(seq_parts)
    qual_concat = bytes(qual_parts)

    seq_encoded = pack_bases_2bit(seq_concat)
    if header.dont_encode_qual():
        qual_encoded = qual_concat
    elif header.encode_qual_by_col():
        qual_encoded = encode_qual_by_col(header, qual_concat)
    else:
        qual_encoded = encode_qual_runlen(header, qual_concat)

    npos_buf = b""
    if header.encode_n_pos():
        npos_buf = encode_single_qual_by_col(seq_concat, ord("N"), None)

    # ---- assemble chunk ----
    chunk = RfqChunk(header)
    chunk.reads = s
    if can_interleave:
        chunk.flags |= BIT_PE_INTERLEAVED
    if read_len_same:
        chunk.flags |= BIT_READ_LEN_SAME
    if name1_len_same:
        chunk.flags |= BIT_NAME1_LEN_SAME
    if name2_len_same:
        chunk.flags |= BIT_NAME2_LEN_SAME
    if strand_len_same:
        chunk.flags |= BIT_STRAND_LEN_SAME
    if strand_same:
        chunk.flags |= BIT_STRAND_SAME
    if lane_same:
        chunk.flags |= BIT_LANE_SAME
    if tile_same:
        chunk.flags |= BIT_TILE_SAME
    if name1_same:
        chunk.flags |= BIT_NAME1_SAME
    if name2_same:
        chunk.flags |= BIT_NAME2_SAME

    chunk.seq_buf_size = len(seq_encoded)
    chunk.qual_buf_size = len(qual_encoded)

    if read_len_same:
        nb = header.read_length_bytes
        chunk.read_len_buf = (read_len0 & ((1 << (8 * nb)) - 1)).to_bytes(nb, "little")
        chunk.read_len_buf_size = header.read_length_bytes
    else:
        chunk.read_len_buf = bytes(read_len_parts)
        chunk.read_len_buf_size = header.read_length_bytes * s

    if name1_len_same:
        chunk.name1_len_buf = bytes([name1_len0 & 0xFF])
        chunk.name1_len_buf_size = 1
    else:
        chunk.name1_len_buf = bytes(name1_len_parts)
        chunk.name1_len_buf_size = s

    if name2_len_same:
        chunk.name2_len_buf = bytes([name2_len0 & 0xFF])
        chunk.name2_len_buf_size = 1
    else:
        chunk.name2_len_buf = bytes(name2_len_parts)
        chunk.name2_len_buf_size = s

    if strand_len_same:
        chunk.strand_len_buf = bytes([strand_len0 & 0xFF])
        chunk.strand_len_buf_size = 1
    else:
        chunk.strand_len_buf = bytes(strand_len_parts)
        chunk.strand_len_buf_size = s

    if lane_same:
        chunk.lane_buf = bytes([lane0 & 0xFF])
        chunk.lane_buf_size = 1
    else:
        chunk.lane_buf = bytes(b & 0xFF for b in lane_buf)
        chunk.lane_buf_size = s // 2 if can_interleave else s

    if tile_same:
        chunk.tile_buf = (tile0 & 0xFFFF).to_bytes(2, "little")
        # QUIRK (reference rfqcodec.cpp:503-515): the tile branch stores its
        # byte count into the LANE size field and leaves tile size 0; the
        # stored chunk size inherits the error and must match byte-for-byte.
        chunk.lane_buf_size = 2
    else:
        chunk.tile_buf = b"".join(
            (t & 0xFFFF).to_bytes(2, "little") for t in tile_buf
        )
        chunk.lane_buf_size = 2 * (s // 2) if can_interleave else 2 * s
    chunk.tile_buf_size = 0

    if header.has_x():
        chunk.x_buf = encode_coords(x_buf)
        chunk.x_buf_size = len(chunk.x_buf)
    if header.has_y():
        chunk.y_buf = encode_coords(y_buf)
        chunk.y_buf_size = len(chunk.y_buf)

    if name1_same:
        chunk.name1_buf = name10
        chunk.name1_buf_size = name1_len0
    else:
        chunk.name1_buf = bytes(name1_parts)
        chunk.name1_buf_size = len(name1_parts)

    if name2_same:
        chunk.name2_buf = name20
        chunk.name2_buf_size = name2_len0
    else:
        chunk.name2_buf = bytes(name2_parts)
        chunk.name2_buf_size = len(name2_parts)

    if strand_same:
        chunk.strand_buf = strand0
        chunk.strand_buf_size = strand_len0
    else:
        chunk.strand_buf = bytes(strand_parts)
        chunk.strand_buf_size = len(strand_parts)

    chunk.seq_buf = seq_encoded
    chunk.qual_buf = qual_encoded
    if encode_overlap:
        chunk.overlap_buf = bytes(overlap_bytes)
    if header.encode_n_pos():
        chunk.npos_buf = npos_buf
        chunk.npos_buf_size = len(npos_buf)

    chunk.calc_total_buf_size()
    return chunk


def encode_chunk_pe(
    header: RfqHeader, pairs: list[tuple[FastqRead, FastqRead]]
) -> RfqChunk | None:
    reads: list[FastqRead] = []
    for r1, r2 in pairs:
        reads.append(r1)
        reads.append(r2)
    return encode_chunk(header, reads, is_pe=True)


# ---------------------------------------------------------------------------
# chunk decode (reference rfqcodec.cpp:1049-1260)
# ---------------------------------------------------------------------------


def decode_chunk(header: RfqHeader, chunk: RfqChunk) -> list[FastqRead]:
    if chunk.reads == 0:
        return []
    pe_interleaved = bool(chunk.flags & BIT_PE_INTERLEAVED)
    encode_overlap = pe_interleaved and header.encode_pe_by_overlap()

    read_lens = chunk.read_lengths()
    seq_len = int(read_lens.sum())

    seq = unpack_bases_2bit(chunk.seq_buf, seq_len)
    qual = bytearray([header.major_qual()]) * seq_len

    # N positions are recorded against the truncated (overlap-elided) stream,
    # so restore them BEFORE expanding overlaps (reference rfqcodec.cpp:855-858).
    if header.encode_n_pos():
        decode_single_qual_by_col(chunk.npos_buf, ord("N"), seq)

    if encode_overlap:
        src = bytes(seq)
        dst = bytearray(seq_len)
        src_pos = 0
        dst_pos = 0
        for r in range(chunk.reads):
            rlen = int(read_lens[r])
            if r % 2 == 0:
                dst[dst_pos : dst_pos + rlen] = src[src_pos : src_pos + rlen]
                dst_pos += rlen
                src_pos += rlen
            else:
                ov = chunk.overlap_buf[r // 2]
                ov = ov - 256 if ov >= 128 else ov
                ov -= header.overlap_shift
                if ov == 0:
                    dst[dst_pos : dst_pos + rlen] = src[src_pos : src_pos + rlen]
                    dst_pos += rlen
                    src_pos += rlen
                elif ov > 0:
                    dst[dst_pos : dst_pos + ov] = src[src_pos - ov : src_pos]
                    dst[dst_pos + ov : dst_pos + rlen] = src[
                        src_pos : src_pos + rlen - ov
                    ]
                    dst_pos += rlen
                    src_pos += rlen - ov
                else:
                    dst[dst_pos : dst_pos + rlen + ov] = src[
                        src_pos : src_pos + rlen + ov
                    ]
                    last_rlen = int(read_lens[r - 1])
                    dst[dst_pos + rlen + ov : dst_pos + rlen] = src[
                        src_pos - last_rlen : src_pos - last_rlen - ov
                    ]
                    dst_pos += rlen
                    src_pos += rlen + ov
        seq = dst

    if header.dont_encode_qual():
        qual[: chunk.qual_buf_size] = chunk.qual_buf
    elif header.encode_qual_by_col():
        decode_qual_by_col(header, chunk.qual_buf, qual)
    elif seq_len > 0:
        decode_qual_runlen(header, chunk.qual_buf, qual)

    if not header.encode_n_pos() and header.n_base_qual < 128:
        nq = header.n_base_qual
        for i in range(seq_len):
            if qual[i] == nq:
                seq[i] = ord("N")

    # ---- per-read reassembly ----
    name1_len0 = chunk.name1_len_buf[0]
    name10 = chunk.name1_buf[:name1_len0]
    strand_len0 = chunk.strand_len_buf[0]
    strand0 = chunk.strand_buf[:strand_len0]

    name2_len0 = 0
    name20 = b""
    lane0 = 0
    tile0 = 0
    if header.has_name2():
        name2_len0 = chunk.name2_len_buf[0]
        name20 = chunk.name2_buf[:name2_len0]
    if header.has_lane():
        lane0 = chunk.lane_buf[0]
    if header.has_tile():
        tile0 = int.from_bytes(chunk.tile_buf[0:2], "little")

    xy_num = chunk.reads // 2 if pe_interleaved else chunk.reads
    x_vals = [0] * xy_num
    y_vals = [0] * xy_num
    if header.has_x():
        x_vals = decode_coords(chunk.x_buf, xy_num)
    if header.has_y():
        y_vals = decode_coords(chunk.y_buf, xy_num)

    tiles = (
        np.frombuffer(chunk.tile_buf, dtype="<u2") if header.has_tile() else None
    )

    out: list[FastqRead] = []
    cur_name1 = 0
    cur_name2 = 0
    cur_strand = 0
    cur_seq = 0
    for r in range(chunk.reads):
        rlen = int(read_lens[r])
        sequence = bytes(seq[cur_seq : cur_seq + rlen])
        quality = bytes(qual[cur_seq : cur_seq + rlen])
        cur_seq += rlen

        if chunk.flags & BIT_NAME1_SAME:
            name1 = name10
        elif chunk.flags & BIT_NAME1_LEN_SAME:
            name1 = chunk.name1_buf[cur_name1 : cur_name1 + name1_len0]
            cur_name1 += name1_len0
        else:
            ln = chunk.name1_len_buf[r]
            name1 = chunk.name1_buf[cur_name1 : cur_name1 + ln]
            cur_name1 += ln

        parts = [name1]
        xy_pos = r // 2 if pe_interleaved else r
        if header.has_lane():
            lane = (
                lane0
                if (chunk.flags & BIT_LANE_SAME)
                else chunk.lane_buf[xy_pos]
            )
            parts.append(b":%d" % lane)
        if header.has_tile():
            tile = (
                tile0 if (chunk.flags & BIT_TILE_SAME) else int(tiles[xy_pos])
            )
            parts.append(b":%d" % tile)
        if header.has_x():
            parts.append(b":%d" % x_vals[xy_pos])
        if header.has_y():
            parts.append(b":%d" % y_vals[xy_pos])
        if header.has_name2():
            if chunk.flags & BIT_NAME2_SAME:
                name2 = name20
                if pe_interleaved and r % 2 == 1 and header.name2_diff_char != 0:
                    nb = bytearray(name2)
                    if header.name2_diff_pos < len(nb):
                        nb[header.name2_diff_pos] = header.name2_diff_char
                    name2 = bytes(nb)
            elif chunk.flags & BIT_NAME2_LEN_SAME:
                name2 = chunk.name2_buf[cur_name2 : cur_name2 + name2_len0]
                cur_name2 += name2_len0
            else:
                ln = chunk.name2_len_buf[r]
                name2 = chunk.name2_buf[cur_name2 : cur_name2 + ln]
                cur_name2 += ln
            parts.append(name2)
        name = b"".join(parts)

        if chunk.flags & BIT_STRAND_SAME:
            strand = strand0
        elif chunk.flags & BIT_STRAND_LEN_SAME:
            strand = chunk.strand_buf[cur_strand : cur_strand + strand_len0]
            cur_strand += strand_len0
        else:
            ln = chunk.strand_len_buf[r]
            strand = chunk.strand_buf[cur_strand : cur_strand + ln]
            cur_strand += ln

        read = FastqRead(name, sequence, strand, quality)
        if pe_interleaved and r % 2 == 1:
            read = read.reverse_complemented()
        out.append(read)
    return out
