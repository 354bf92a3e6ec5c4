"""Production multi-chip compress: chunks fanned across a jax.sharding
Mesh from the CLI (SURVEY §2.2 row 1 — the piece round 2 left test-only).

The .rfq format's chunks are independent once the header is fixed, so the
multi-chip axis is pure data parallelism: D consecutive uniform-length
chunks are padded to one shared (D*B_cap, L) batch and encoded by ONE
shard_map dispatch over the mesh's data axis (each device runs the full
chunk-codec kernel stack of parallel/mesh.device_encode_block on its own
chunk); the host assembles the returned streams into wire chunks in
order. Chunks the batch shape cannot take (ragged, tiny, shape change
mid-run, trailing partial batch) flush through the single-device engine —
bytes are identical either way, so the output equals the serial pipeline
byte-for-byte for ANY device count (tests/test_parallel.py proves it on
the 8-virtual-device CPU mesh; the same code runs unchanged on a real
multi-chip host).

PE interleaved inputs ride the same mechanism through
device_encode_pe_block (revcomp + overlap search + elision on every
device); decompress has its own batch decoder. Chunks that hit the rare
overlap-hash collision re-encode on the host path per chunk.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np

from ..codec import vectorized
from ..codec.blocks import ReadBlock
from ..constants import BIT_HAS_NO_LINE_BREAK_AT_END
from ..format.header import RfqFormatError, RfqHeader
from ..io.fastq import FastqReader
from ..pipeline import EngineConfig, _open_out, get_engine

_G = ord("G")


def _bucket(x: int, lo: int = 256) -> int:
    c = lo
    while c < x:
        if c + (c >> 1) >= x:
            return c + (c >> 1)
        c *= 2
    return c


class _MeshBatchEncoder:
    """Owns the mesh, the per-shape jitted shard_map steps, and the
    padded-batch marshalling."""

    def __init__(self, devices):
        import jax

        self._jax = jax
        from .mesh import make_mesh

        self.devices = list(devices)
        self.D = len(self.devices)
        self.mesh = make_mesh(self.devices)
        self._steps: dict = {}

    def _step_for(self, key):
        fn = self._steps.get(key)
        if fn is None:
            fn = self._build(key)
            self._steps[key] = fn
        return fn

    def _build(self, key):
        (b_cap, L, nm, esc, npc, qos, nos) = key
        jax = self._jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from .mesh import device_encode_block

        from jax import shard_map

        def step(seqs, quals, xs, ys, nv, bins, major, in_table):
            out = device_encode_block(
                seqs, quals, xs, ys, bins, major[0], in_table,
                esc_cap=esc, nonmajor_cap=nm, npos_cap=npc,
                qual_out_size=qos, npos_out_size=nos,
                check_counts=False, n_valid_reads=nv[0],
            )
            return {
                k: (v.reshape(1) if v.ndim == 0 else v)
                for k, v in out.items()
            }

        axis = "data"
        out_spec = {
            k: P(axis)
            for k in ("n_esc", "n_nonmajor", "n_npos", "packed", "qual",
                      "qual_len", "npos", "npos_len", "x", "x_len", "y",
                      "y_len")
        }
        sharded = shard_map(
            step, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                      P(), P(), P()),
            out_specs=out_spec,
        )
        return jax.jit(sharded)

    def encode_batch(self, header: RfqHeader, blocks: list, L: int):
        """Encode up to D uniform-(L) blocks -> list of RfqChunk, in
        order. Short batches (the common trailing case) ride along as
        zero-read padding devices whose outputs are dropped."""
        D = self.D
        assert 1 <= len(blocks) <= D
        analyses = [
            vectorized.analyze_chunk(header, b, False) for b in blocks
        ]
        b_cap = _bucket(max(b.n for b in blocks))
        has_xy = header.has_x()
        major = int(header.major_qual())
        in_tab = np.zeros(256, dtype=bool)
        in_tab[np.frombuffer(header.qual_buf, dtype=np.uint8)] = True

        nm = esc = npc = 0
        for b in blocks:
            qual = b.qual_flat
            nm = max(nm, int((qual != major).sum()))
            esc = max(esc, int((~in_tab[qual]).sum()))
            npc = max(npc, int((b.seq_flat == ord("N")).sum()))
        n_cap = b_cap * L
        nm_c = _bucket(nm, lo=1024)
        esc_c = 0 if esc == 0 else _bucket(esc, lo=8)
        np_c = _bucket(npc, lo=8)
        nbins = int(header.normal_qual_bins())
        qos = min(_bucket(4 * nbins + 4 * nm + 5 * esc + 8, lo=1024),
                  4 * nbins + n_cap + 8)
        nos = _bucket(min(4 * npc, npc + n_cap // 64) + 16, lo=64)
        if 4 * nbins + n_cap + 8 >= (1 << 23):
            return None  # past the emission-sort packing limit

        seqs = np.full((D * b_cap, L), _G, dtype=np.uint8)
        quals = np.full((D * b_cap, L), major, dtype=np.uint8)
        xs = np.zeros(D * b_cap, dtype=np.int32)
        ys = np.zeros(D * b_cap, dtype=np.int32)
        nv = np.zeros(D, dtype=np.int32)
        for d, (b, a) in enumerate(zip(blocks, analyses)):
            seqs[d * b_cap : d * b_cap + b.n] = b.seq_flat.reshape(b.n, L)
            quals[d * b_cap : d * b_cap + b.n] = b.qual_flat.reshape(b.n, L)
            if has_xy:
                xs[d * b_cap : d * b_cap + b.n] = a.xs
                ys[d * b_cap : d * b_cap + b.n] = a.ys
            nv[d] = b.n

        from .mesh import replicate, shard_blocks

        bins_dev = np.asarray(header.normal_qual_buf(), dtype=np.uint8)
        key = (b_cap, L, nm_c, esc_c, np_c, qos, nos)
        fn = self._step_for(key)
        out = fn(
            shard_blocks(self.mesh, seqs),
            shard_blocks(self.mesh, quals),
            shard_blocks(self.mesh, xs),
            shard_blocks(self.mesh, ys),
            shard_blocks(self.mesh, nv),
            replicate(self.mesh, bins_dev),
            replicate(self.mesh, np.array([major], dtype=np.uint8)),
            replicate(self.mesh, in_tab),
        )
        packed = np.asarray(out["packed"]).reshape(D, -1)
        qual_s = np.asarray(out["qual"]).reshape(D, -1)
        qual_l = np.asarray(out["qual_len"]).reshape(-1)
        npos_s = np.asarray(out["npos"]).reshape(D, -1)
        npos_l = np.asarray(out["npos_len"]).reshape(-1)
        x_s = np.asarray(out["x"]).reshape(D, -1)
        x_l = np.asarray(out["x_len"]).reshape(-1)
        y_s = np.asarray(out["y"]).reshape(D, -1)
        y_l = np.asarray(out["y_len"]).reshape(-1)

        chunks = []
        for d, (b, a) in enumerate(zip(blocks, analyses)):
            n = b.n * L
            chunks.append(vectorized.assemble_chunk(
                header, b, a, np.zeros(0, dtype=np.int64),
                packed[d, : (n + 3) // 4].tobytes(),
                qual_s[d, : qual_l[d]].tobytes(),
                npos_s[d, : npos_l[d]].tobytes()
                if header.encode_n_pos() else b"",
                x_bytes=x_s[d, : x_l[d]].tobytes() if has_xy else None,
                y_bytes=y_s[d, : y_l[d]].tobytes() if has_xy else None,
            ))
        return chunks


class _MeshBatchPEEncoder:
    """PE-interleaved twin of _MeshBatchEncoder: each device runs the
    full PE chunk pipeline (revcomp + overlap search + elision + stream
    kernels, parallel/mesh.device_encode_pe_block). A double-hash
    collision on any device (probability ~2^-64/pair) sends that chunk
    back to the host path to keep first-match semantics."""

    def __init__(self, devices):
        import jax

        self._jax = jax
        from .mesh import make_mesh

        self.devices = list(devices)
        self.D = len(self.devices)
        self.mesh = make_mesh(self.devices)
        self._steps: dict = {}

    def _step_for(self, key):
        fn = self._steps.get(key)
        if fn is None:
            (b_cap, L, nm, esc, npc, qos, nos, shift) = key
            jax = self._jax
            from jax.sharding import PartitionSpec as P

            from .mesh import device_encode_pe_block

            from jax import shard_map

            def step(seqs, quals, xs, ys, nv, npair, bins, major,
                     in_table):
                out = device_encode_pe_block(
                    seqs, quals, xs[0], ys[0], nv[0], npair[0], bins,
                    major[0],
                    in_table, shift, esc_cap=esc, nonmajor_cap=nm,
                    npos_cap=npc, qual_out_size=qos, npos_out_size=nos,
                )
                return {
                    k: (v.reshape(1) if v.ndim == 0 else v)
                    for k, v in out.items()
                }

            axis = "data"
            keys = ("n_esc", "n_nonmajor", "n_npos", "packed", "qual",
                    "qual_len", "npos", "npos_len", "x", "x_len", "y",
                    "y_len", "ov", "total_stored", "ncoll")
            sharded = shard_map(
                step, mesh=self.mesh,
                in_specs=(P(axis),) * 6 + (P(), P(), P()),
                out_specs={k: P(axis) for k in keys},
            )
            fn = jax.jit(sharded)
            self._steps[key] = fn
        return fn

    def encode_batch(self, header: RfqHeader, blocks: list, analyses,
                     L: int):
        D = self.D
        assert 1 <= len(blocks) <= D
        b_cap = _bucket(max(b.n for b in blocks))
        if b_cap % 2:
            b_cap += 1
        p_cap = b_cap // 2
        n_cap = b_cap * L
        has_xy = header.has_x()
        major = int(header.major_qual())
        in_tab = np.zeros(256, dtype=bool)
        in_tab[np.frombuffer(header.qual_buf, dtype=np.uint8)] = True
        nbins = int(header.normal_qual_bins())

        nm = esc = npc = 0
        for b in blocks:
            qual = b.qual_flat
            nm = max(nm, int((qual != major).sum()))
            esc = max(esc, int((~in_tab[qual]).sum()))
            npc = max(npc, int((b.seq_flat == ord("N")).sum()))
        nm_c = _bucket(nm, lo=1024)
        esc_c = 0 if esc == 0 else _bucket(esc, lo=8)
        np_c = _bucket(npc, lo=8)
        qos = min(_bucket(4 * nbins + 4 * nm + 5 * esc + 8, lo=1024),
                  4 * nbins + n_cap + 8)
        nos = _bucket(min(4 * npc, npc + n_cap // 64) + 16, lo=64)
        if 4 * nbins + n_cap + 8 >= (1 << 23):
            return None

        seqs = np.full((D * b_cap, L), _G, dtype=np.uint8)
        quals = np.full((D * b_cap, L), major, dtype=np.uint8)
        xs = np.zeros(D * p_cap, dtype=np.int32)
        ys = np.zeros(D * p_cap, dtype=np.int32)
        nv = np.zeros(D, dtype=np.int32)
        npair = np.zeros(D, dtype=np.int32)
        for d, (b, a) in enumerate(zip(blocks, analyses)):
            seqs[d * b_cap : d * b_cap + b.n] = b.seq_flat.reshape(b.n, L)
            quals[d * b_cap : d * b_cap + b.n] = b.qual_flat.reshape(b.n, L)
            if has_xy:
                xs[d * p_cap : d * p_cap + b.n // 2] = a.xs[0::2]
                ys[d * p_cap : d * p_cap + b.n // 2] = a.ys[0::2]
            nv[d] = b.n
            npair[d] = b.n // 2

        from .mesh import replicate, shard_blocks

        bins_dev = np.asarray(header.normal_qual_buf(), dtype=np.uint8)
        key = (b_cap, L, nm_c, esc_c, np_c, qos, nos,
               int(header.overlap_shift))
        fn = self._step_for(key)
        out = fn(
            shard_blocks(self.mesh, seqs),
            shard_blocks(self.mesh, quals),
            shard_blocks(self.mesh, xs.reshape(D, p_cap)),
            shard_blocks(self.mesh, ys.reshape(D, p_cap)),
            shard_blocks(self.mesh, nv),
            shard_blocks(self.mesh, npair),
            replicate(self.mesh, bins_dev),
            replicate(self.mesh, np.array([major], dtype=np.uint8)),
            replicate(self.mesh, in_tab),
        )
        packed = np.asarray(out["packed"]).reshape(D, -1)
        qual_s = np.asarray(out["qual"]).reshape(D, -1)
        qual_l = np.asarray(out["qual_len"]).reshape(-1)
        npos_s = np.asarray(out["npos"]).reshape(D, -1)
        npos_l = np.asarray(out["npos_len"]).reshape(-1)
        x_s = np.asarray(out["x"]).reshape(D, -1)
        x_l = np.asarray(out["x_len"]).reshape(-1)
        y_s = np.asarray(out["y"]).reshape(D, -1)
        y_l = np.asarray(out["y_len"]).reshape(-1)
        ov_s = np.asarray(out["ov"]).reshape(D, -1)
        tot_s = np.asarray(out["total_stored"]).reshape(-1)
        ncoll = np.asarray(out["ncoll"]).reshape(-1)

        chunks = []
        for d, (b, a) in enumerate(zip(blocks, analyses)):
            if ncoll[d] > 0:
                chunks.append(None)  # host re-encode (collision)
                continue
            pairs = b.n // 2
            ov = (
                ov_s[d, :pairs].view(np.int8).astype(np.int64)
                - header.overlap_shift
            )
            chunks.append(vectorized.assemble_chunk(
                header, b, a, ov,
                packed[d, : (int(tot_s[d]) + 3) // 4].tobytes(),
                qual_s[d, : qual_l[d]].tobytes(),
                npos_s[d, : npos_l[d]].tobytes()
                if header.encode_n_pos() else b"",
                x_bytes=x_s[d, : x_l[d]].tobytes() if has_xy else None,
                y_bytes=y_s[d, : y_l[d]].tobytes() if has_xy else None,
            ))
        return chunks


class _MeshBatchDecoder:
    """Decode counterpart of _MeshBatchEncoder: D chunks' compressed
    streams padded to shared caps, ONE shard_map dispatch, per-device
    (B_cap, L) seq/qual blocks back."""

    def __init__(self, devices):
        import jax

        self._jax = jax
        from .mesh import make_mesh

        self.devices = list(devices)
        self.D = len(self.devices)
        self.mesh = make_mesh(self.devices)
        self._steps: dict = {}

    def _step_for(self, key):
        fn = self._steps.get(key)
        if fn is None:
            (b_cap, L, pk_cap, qb_cap, nb_cap, np_c, qcaps) = key
            jax = self._jax
            from jax.sharding import PartitionSpec as P

            from .mesh import device_decode_block

            from jax import shard_map

            def step(packed, qb, ql, nb, nl, bins, major):
                seq, qual = device_decode_block(
                    packed[0], qb[0], ql[0], nb[0], nl[0], bins, major[0],
                    b_cap, L, np_cap=np_c,
                    qualcol_caps=qcaps,
                )
                return seq[None], qual[None]

            axis = "data"
            sharded = shard_map(
                step, mesh=self.mesh,
                in_specs=(P(axis),) * 5 + (P(), P()),
                out_specs=(P(axis), P(axis)),
            )
            fn = jax.jit(sharded)
            self._steps[key] = fn
        return fn

    def decode_batch(self, header: RfqHeader, chunks: list, L: int):
        """Decode up to D uniform-(L) chunks -> list of ReadBlock."""
        from ..codec import kernels_np as K
        from .mesh import replicate, shard_blocks

        D = self.D
        nbins = int(header.normal_qual_bins())
        b_cap = _bucket(max(c.reads for c in chunks))
        n_cap = b_cap * L

        def geo(x, lo=1024):
            for f in (16, 8, 4, 2, 1):
                c = max(lo, n_cap // f)
                if c >= x:
                    return c
            return n_cap + lo

        max_q = max(len(c.qual_buf) for c in chunks)
        max_np = max(len(c.npos_buf) for c in chunks)
        pk_cap = (n_cap + 3) // 4
        qb_cap = geo(max_q + 4 * nbins + 16)
        nb_cap = geo(max_np + 8, lo=64)
        np_c = geo(min(32 * max_np + 8, n_cap), lo=64)
        t = c_ = esc = 0
        for c in chunks:
            counts = K.qualcol_decode_counts(
                np.frombuffer(c.qual_buf, dtype=np.uint8), nbins
            )
            if counts is None:
                return None  # corrupt chunk: host decoder raises
            tt, cc, ee = counts
            t, c_, esc = max(t, tt), max(c_, cc), max(esc, ee)
        tok_cap = geo(t, lo=512)
        pos_cap = geo(c_, lo=512)
        if pos_cap == tok_cap:
            pos_cap += 4096  # equal shapes fuse catastrophically (r3)
        esc_cap = 0 if esc == 0 else geo(esc, lo=8)
        if 4 * nbins + qb_cap > (1 << 23):
            return None

        packed = np.zeros((D, pk_cap), dtype=np.uint8)
        qb = np.zeros((D, qb_cap), dtype=np.uint8)
        ql = np.zeros(D, dtype=np.int32)
        nb = np.zeros((D, nb_cap), dtype=np.uint8)
        nl = np.zeros(D, dtype=np.int32)
        for d, c in enumerate(chunks):
            packed[d, : len(c.seq_buf)] = np.frombuffer(c.seq_buf, np.uint8)
            qb[d, : len(c.qual_buf)] = np.frombuffer(c.qual_buf, np.uint8)
            ql[d] = len(c.qual_buf)
            if header.encode_n_pos() and c.npos_buf:
                nb[d, : len(c.npos_buf)] = np.frombuffer(
                    c.npos_buf, np.uint8
                )
                nl[d] = len(c.npos_buf)

        key = (b_cap, L, pk_cap, qb_cap, nb_cap, np_c,
               (tok_cap, pos_cap, esc_cap))
        fn = self._step_for(key)
        bins_dev = np.asarray(header.normal_qual_buf(), dtype=np.uint8)
        major = int(header.major_qual())
        seqs, quals = fn(
            shard_blocks(self.mesh, packed),
            shard_blocks(self.mesh, qb),
            shard_blocks(self.mesh, ql),
            shard_blocks(self.mesh, nb),
            shard_blocks(self.mesh, nl),
            replicate(self.mesh, bins_dev),
            replicate(self.mesh, np.array([major], dtype=np.uint8)),
        )
        seqs = np.asarray(seqs).reshape(D, b_cap, L)
        quals = np.asarray(quals).reshape(D, b_cap, L)
        nbq = int(header.n_base_qual)
        blocks = []
        for d, c in enumerate(chunks):
            seq = np.ascontiguousarray(seqs[d, : c.reads].reshape(-1))
            qual = np.ascontiguousarray(quals[d, : c.reads].reshape(-1))
            if not header.encode_n_pos() and nbq < 128:
                seq = np.where(qual == nbq, np.uint8(ord("N")), seq)
            lens = np.full(c.reads, L, dtype=np.int64)
            from ..codec.blocks import lens_to_offsets

            blocks.append(vectorized.assemble_block(
                header, c, c.reads, lens, lens_to_offsets(lens), seq, qual
            ))
        return blocks

    def decode_batch_pe(self, header: RfqHeader, chunks: list, L: int):
        """PE-interleaved batch decode: per-row expansion tables derived
        host-side from each chunk's overlap bytes, then one shard_map
        dispatch through device_decode_pe_block. Chunks whose stored-base
        accounting disagrees with the seq buffer (corruption) come back
        as None for the host fallback path."""
        from ..codec import kernels_np as K
        from ..codec.blocks import lens_to_offsets
        from .mesh import replicate, shard_blocks

        D = self.D
        nbins = int(header.normal_qual_bins())
        expand = header.encode_pe_by_overlap()
        b_cap = _bucket(max(c.reads for c in chunks))
        if b_cap % 2:
            b_cap += 1
        n_cap = b_cap * L
        flat_cap = n_cap + ((-n_cap) % 4)

        def geo(x, lo=1024):
            for f in (16, 8, 4, 2, 1):
                c = max(lo, n_cap // f)
                if c >= x:
                    return c
            return n_cap + lo

        stored_off = np.zeros((D, b_cap), dtype=np.int32)
        fwds = np.zeros((D, b_cap), dtype=np.int32)
        bwds = np.zeros((D, b_cap), dtype=np.int32)
        prevs = np.zeros((D, b_cap), dtype=np.int32)
        bad = [False] * len(chunks)
        for d, c in enumerate(chunks):
            b = c.reads
            if expand:
                ovb = np.frombuffer(c.overlap_buf, dtype=np.int8).astype(
                    np.int64
                )
                ov = ovb - header.overlap_shift
                stored = np.full(b, L, dtype=np.int64)
                stored[1::2] -= np.abs(ov)
                total_stored = int(stored.sum())
                off = (np.cumsum(stored) - stored).astype(np.int32)
                stored_off[d, :b] = off
                fwds[d, 1:b:2] = np.maximum(ov, 0)
                bwds[d, 1:b:2] = np.maximum(-ov, 0)
                prevs[d, 1:b:2] = off[0:b:2]
            else:
                total_stored = b * L
                off = np.arange(b, dtype=np.int32) * L
                stored_off[d, :b] = off
            if (total_stored + 3) // 4 != len(c.seq_buf):
                bad[d] = True

        max_q = max(len(c.qual_buf) for c in chunks)
        max_np = max(len(c.npos_buf) for c in chunks)
        pk_cap = (flat_cap + 3) // 4
        qb_cap = geo(max_q + 4 * nbins + 16)
        nb_cap = geo(max_np + 8, lo=64)
        np_c = geo(min(32 * max_np + 8, flat_cap), lo=64)
        t = c_ = esc = 0
        for c in chunks:
            counts = K.qualcol_decode_counts(
                np.frombuffer(c.qual_buf, dtype=np.uint8), nbins
            )
            if counts is None:
                return None  # corrupt chunk: host decoder raises
            tt, cc, ee = counts
            t, c_, esc = max(t, tt), max(c_, cc), max(esc, ee)
        tok_cap = geo(t, lo=512)
        pos_cap = geo(c_, lo=512)
        if pos_cap == tok_cap:
            pos_cap += 4096
        esc_cap = 0 if esc == 0 else geo(esc, lo=8)
        if 4 * nbins + qb_cap > (1 << 23):
            return None

        packed = np.zeros((D, pk_cap), dtype=np.uint8)
        qb = np.zeros((D, qb_cap), dtype=np.uint8)
        ql = np.zeros(D, dtype=np.int32)
        nb = np.zeros((D, nb_cap), dtype=np.uint8)
        nl = np.zeros(D, dtype=np.int32)
        for d, c in enumerate(chunks):
            packed[d, : len(c.seq_buf)] = np.frombuffer(c.seq_buf, np.uint8)
            qb[d, : len(c.qual_buf)] = np.frombuffer(c.qual_buf, np.uint8)
            ql[d] = len(c.qual_buf)
            if header.encode_n_pos() and c.npos_buf:
                nb[d, : len(c.npos_buf)] = np.frombuffer(
                    c.npos_buf, np.uint8
                )
                nl[d] = len(c.npos_buf)

        key = ("pe", b_cap, L, pk_cap, qb_cap, nb_cap, np_c,
               (tok_cap, pos_cap, esc_cap), expand,
               bool(header.encode_n_pos()), int(header.n_base_qual))
        fn = self._steps.get(key)
        if fn is None:
            fn = self._build_pe(key)
            self._steps[key] = fn
        bins_dev = np.asarray(header.normal_qual_buf(), dtype=np.uint8)
        major = int(header.major_qual())
        seqs, quals = fn(
            shard_blocks(self.mesh, packed),
            shard_blocks(self.mesh, qb),
            shard_blocks(self.mesh, ql),
            shard_blocks(self.mesh, nb),
            shard_blocks(self.mesh, nl),
            shard_blocks(self.mesh, stored_off),
            shard_blocks(self.mesh, fwds),
            shard_blocks(self.mesh, bwds),
            shard_blocks(self.mesh, prevs),
            replicate(self.mesh, bins_dev),
            replicate(self.mesh, np.array([major], dtype=np.uint8)),
        )
        seqs = np.asarray(seqs).reshape(D, b_cap, L)
        quals = np.asarray(quals).reshape(D, b_cap, L)
        blocks = []
        for d, c in enumerate(chunks):
            if bad[d]:
                blocks.append(None)
                continue
            seq = np.ascontiguousarray(seqs[d, : c.reads].reshape(-1))
            qual = np.ascontiguousarray(quals[d, : c.reads].reshape(-1))
            lens = np.full(c.reads, L, dtype=np.int64)
            blocks.append(vectorized.assemble_block(
                header, c, c.reads, lens, lens_to_offsets(lens), seq, qual
            ))
        return blocks

    def _build_pe(self, key):
        (_tag, b_cap, L, pk_cap, qb_cap, nb_cap, np_c, qcaps, expand,
         has_npos, nbq) = key
        jax = self._jax
        from jax.sharding import PartitionSpec as P

        from .mesh import device_decode_pe_block

        from jax import shard_map

        def step(packed, qbuf, ql, nbuf, nl, so, f, w, po, bins, major):
            seq, qual = device_decode_pe_block(
                packed[0], qbuf[0], ql[0], nbuf[0], nl[0], so[0], f[0],
                w[0], po[0], bins, major[0], b_cap, L, expand,
                np_cap=np_c, qualcol_caps=qcaps, nbq=nbq,
                has_npos=has_npos,
            )
            return seq[None], qual[None]

        axis = "data"
        sharded = shard_map(
            step, mesh=self.mesh,
            in_specs=(P(axis),) * 9 + (P(), P()),
            out_specs=(P(axis), P(axis)),
        )
        return jax.jit(sharded)


def compress_pe_mesh(
    in1: str,
    in2: str,
    out1: str,
    chunk_size: int = 1_000_000,
    interleaved: bool = False,
    engine: EngineConfig | None = None,
    out_stream=None,
    devices=None,
    verify: bool = False,
    fast_verify: bool = False,
) -> dict:
    """PE compress with interleaved chunks fanned over a device mesh
    (revcomp + overlap search + elision on every device); bytes identical
    to the serial pipeline. Chunks that degrade to non-interleaved
    encoding, are ragged, or hit an overlap-hash collision flush through
    the single-device engine in order. verify/fast_verify re-decode
    emitted chunks like the serial path (reference repaq.cpp:430-528)."""
    import jax

    from ..constants import (
        BIT_HAS_NO_LINE_BREAK_AT_END,
        BIT_HAS_NO_LINE_BREAK_AT_END_R2,
    )
    from ..io.fastq import FastqReaderPair

    devices = list(devices) if devices else list(jax.devices())
    engine = engine or get_engine("device")
    if len(devices) < 2:
        from .. import pipeline

        pipeline.compress_pe(in1, in2, out1, chunk_size=chunk_size,
                             interleaved=interleaved, engine=engine,
                             out_stream=out_stream, verify=verify,
                             fast_verify=fast_verify)
        return {"mesh_batches": 0, "fallback_chunks": -1}

    enc = _MeshBatchPEEncoder(devices)
    min_bases = int(os.environ.get("REPAQ_DEVICE_MIN_BASES", 128 << 10))
    max_bases = int(os.environ.get("REPAQ_DEVICE_MAX_BASES", 4 << 20))

    reader = FastqReaderPair(in1, in2, interleaved)
    out, own = _open_out(out1, out_stream)
    segmented = hasattr(out, "write_segments")
    stats = {"mesh_batches": 0, "fallback_chunks": 0}
    header: RfqHeader | None = None
    header_bytes = b""
    batch: list = []  # (block, analysis, flag1, flag2)
    batch_L = 0

    def ensure_header(block: ReadBlock) -> None:
        nonlocal header, header_bytes
        if header is not None:
            return
        header = engine.make_header_pe(block)
        if header is None:
            raise RfqFormatError(
                "failed to encode, please confirm the input FASTQ file is "
                "valid and not empty"
            )
        header_bytes = header.to_bytes()
        out.write(header_bytes)
        check = _io.BytesIO(header_bytes)
        h2 = RfqHeader.read(check)
        if not header.identical_with(h2):
            raise RfqFormatError(
                "encoding error in header, the output will be wrong, "
                "quit now!"
            )

    passnum = 0

    def emit(chunk, f1: bool, f2: bool, block: ReadBlock) -> None:
        nonlocal passnum
        if chunk is None:
            return
        if f1:
            chunk.flags |= BIT_HAS_NO_LINE_BREAK_AT_END
        if f2:
            chunk.flags |= BIT_HAS_NO_LINE_BREAK_AT_END_R2
        if segmented:
            out.write_segments(chunk.to_segments())
        else:
            out.write(chunk.to_bytes())
        if verify or (fast_verify and passnum % 10 == 0):
            from ..pipeline import _verify_chunk

            _verify_chunk(header, chunk.to_bytes(), block, engine,
                          header_bytes)
        passnum += 1

    def flush_batch() -> None:
        nonlocal batch
        if not batch:
            return
        blocks = [b for b, _a, _f1, _f2 in batch]
        analyses = [a for _b, a, _f1, _f2 in batch]
        chunks = enc.encode_batch(header, blocks, analyses, batch_L)
        if chunks is None:
            chunks = [None] * len(batch)
        got_mesh = any(c is not None for c in chunks)
        stats["mesh_batches"] += 1 if got_mesh else 0
        for (b, _a, f1, f2), c in zip(batch, chunks):
            if c is None:  # over-limit batch or per-chunk collision
                stats["fallback_chunks"] += 1
                c = engine.encode_chunk(header, b, True)
            emit(c, f1, f2, b)
        batch = []

    while True:
        block, flag1, flag2 = reader.read_pair_block(chunk_size)
        if block is None or block.n == 0:
            break
        ensure_header(block)
        a = vectorized.analyze_chunk(header, block, True)
        lens = block.seq_lens()
        L = int(lens[0]) if block.n else 0
        total = int(lens.sum())
        eligible = (
            a.can_interleave
            and a.encode_overlap
            and a.read_len_same
            and L > 0
            and block.n % 2 == 0
            and header.encode_qual_by_col()
            and min_bases <= total <= max_bases
            and header.has_x() == header.has_y()
        )
        if batch and (not eligible or L != batch_L):
            flush_batch()
        if eligible:
            batch_L = L
            batch.append((block, a, flag1, flag2))
            if len(batch) == enc.D:
                flush_batch()
        else:
            stats["fallback_chunks"] += 1
            emit(engine.encode_chunk(header, block, True), flag1, flag2,
                 block)
    flush_batch()
    reader.close()
    if own:
        out.close()
    return stats


def decompress_se_mesh(
    in1: str,
    out1: str,
    engine: EngineConfig | None = None,
    in_stream=None,
    devices=None,
    out2: str = "",
) -> dict:
    """Decompress with chunk decode fanned over a device mesh; output
    bytes identical to the serial pipeline. PE-interleaved / ragged /
    non-by-col chunks fall back to the single-device engine in order.
    With out2, a PE container splits even/odd reads into out1/out2
    exactly like pipeline.decompress_pe (reference repaq.cpp:335-414)."""
    import jax

    from ..constants import BIT_HAS_NO_LINE_BREAK_AT_END as _NL
    from ..constants import BIT_HAS_NO_LINE_BREAK_AT_END_R2 as _NL2
    from ..constants import BIT_PE_INTERLEAVED
    from ..format.chunk import RfqChunk
    from ..io.fastq import Writer
    from ..pipeline import _open_in

    devices = list(devices) if devices else list(jax.devices())
    engine = engine or get_engine("device")
    if len(devices) < 2:
        from .. import pipeline

        if out2:
            pipeline.decompress_pe(in1, out1, out2, engine=engine,
                                   in_stream=in_stream)
        else:
            pipeline.decompress(in1, out1, engine=engine,
                                in_stream=in_stream)
        return {"mesh_batches": 0, "fallback_chunks": -1}

    dec = _MeshBatchDecoder(devices)
    min_bases = int(os.environ.get("REPAQ_DEVICE_MIN_BASES", 128 << 10))
    max_bases = int(os.environ.get("REPAQ_DEVICE_MAX_BASES", 4 << 20))
    stream, own = _open_in(in1, in_stream)
    header = RfqHeader.read(stream)
    if out2 and not header.paired_end():
        raise RfqFormatError(
            "The input RFQ file was encoded by single-end FASTQ, you "
            "should not specify <out2>"
        )
    writer = Writer(out1)
    writer2 = Writer(out2) if out2 else None
    stats = {"mesh_batches": 0, "fallback_chunks": 0}

    pending: list = []  # (chunk, block-or-None) in container order
    batch_idx: list = []  # positions in pending awaiting the mesh
    batch_L = 0
    batch_pe = False

    def flush_mesh() -> None:
        nonlocal batch_idx
        if not batch_idx:
            return
        chunks = [pending[i][0] for i in batch_idx]
        if batch_pe:
            blocks = dec.decode_batch_pe(header, chunks, batch_L)
        else:
            blocks = dec.decode_batch(header, chunks, batch_L)
        if blocks is None:
            blocks = [None] * len(batch_idx)
        any_mesh = any(b is not None for b in blocks)
        stats["mesh_batches"] += 1 if any_mesh else 0
        for i, b in zip(batch_idx, blocks):
            if b is None:  # over-limit / corrupt-accounting: host path
                stats["fallback_chunks"] += 1
                b = engine.decode_chunk(header, pending[i][0])
            pending[i] = (pending[i][0], b)
        batch_idx = []

    def emit(upto: int, last_done: bool) -> None:
        """Write decoded pending[:upto]; is_last only for the container's
        true final chunk (the trailing-newline trim, reference
        repaq.cpp:301-331)."""
        nonlocal pending, batch_idx
        for j in range(upto):
            chunk, block = pending[j]
            is_last = last_done and j == upto - 1
            if writer2 is not None:
                idx = np.arange(block.n)
                o1 = block.to_fastq_buf(idx[0::2])
                o2 = block.to_fastq_buf(idx[1::2])
                if is_last and (chunk.flags & _NL):
                    o1 = o1[:-1]
                if is_last and (chunk.flags & _NL2):
                    o2 = o2[:-1]
                writer.write(o1)
                writer2.write(o2)
            else:
                outstr = block.to_fastq_buf()
                if is_last and (chunk.flags & _NL):
                    outstr = outstr[:-1]
                writer.write(outstr)
        pending = pending[upto:]
        batch_idx = [i - upto for i in batch_idx]

    def emit_safe() -> None:
        """Mid-stream emit: decoded chunks BEFORE the first pending batch
        member are provably non-final (chunks follow them); with no batch
        members pending, hold one back until we know the stream's end."""
        if batch_idx:
            emit(batch_idx[0], last_done=False)
        else:
            emit(max(0, len(pending) - 1), last_done=False)

    while True:
        chunk = RfqChunk.read(stream, header)
        if chunk.reads == 0:
            break
        lens = chunk.read_lengths()
        L = int(lens[0]) if chunk.reads else 0
        uniform = L > 0 and bool((lens == L).all())
        total = int(lens.astype(np.int64).sum())
        is_pe = bool(chunk.flags & BIT_PE_INTERLEAVED)
        eligible = (
            uniform
            and header.encode_qual_by_col()
            and (not is_pe or chunk.reads % 2 == 0)
            and min_bases <= total <= max_bases
        )
        if batch_idx and (
            not eligible or L != batch_L or is_pe != batch_pe
        ):
            flush_mesh()
        if eligible:
            batch_L = L
            batch_pe = is_pe
            pending.append((chunk, None))
            batch_idx.append(len(pending) - 1)
            if len(batch_idx) == dec.D:
                flush_mesh()
        else:
            stats["fallback_chunks"] += 1
            pending.append((chunk, engine.decode_chunk(header, chunk)))
        emit_safe()
    flush_mesh()
    emit(len(pending), last_done=True)
    writer.close()
    if writer2 is not None:
        writer2.close()
    if own:
        stream.close()
    return stats


def compress_se_mesh(
    in1: str,
    out1: str,
    chunk_size: int = 1_000_000,
    engine: EngineConfig | None = None,
    out_stream=None,
    devices=None,
    verify: bool = False,
    fast_verify: bool = False,
    force_mesh: bool = False,
) -> dict:
    """SE compress with chunks fanned over a device mesh; output bytes
    are identical to the serial pipeline. Returns stats (mesh batches /
    fallback chunks). Non-conforming chunks (ragged, shape change, tiny,
    trailing partial batch, non-by-col quality modes) flush through the
    single-device engine in order. verify/fast_verify re-decode emitted
    chunks exactly like the serial path (reference repaq.cpp:430-528).
    force_mesh: run the mesh machinery even on ONE device (a 1-device
    mesh is normally shorted to the serial pipeline) — used to isolate
    the batching/marshalling overhead on single-chip hosts."""
    import jax

    devices = list(devices) if devices else list(jax.devices())
    engine = engine or get_engine("device")
    if len(devices) < 2 and not force_mesh:
        from .. import pipeline

        pipeline.compress_se(in1, out1, chunk_size=chunk_size,
                             engine=engine, out_stream=out_stream,
                             verify=verify, fast_verify=fast_verify)
        return {"mesh_batches": 0, "fallback_chunks": -1}

    enc = _MeshBatchEncoder(devices)
    min_bases = int(os.environ.get("REPAQ_DEVICE_MIN_BASES", 128 << 10))
    max_bases = int(os.environ.get("REPAQ_DEVICE_MAX_BASES", 4 << 20))

    reader = FastqReader(in1)
    out, own = _open_out(out1, out_stream)
    segmented = hasattr(out, "write_segments")
    stats = {"mesh_batches": 0, "fallback_chunks": 0}
    header: RfqHeader | None = None
    header_bytes = b""
    batch: list = []  # (block, flag) of uniform length batch_L
    batch_L = 0

    def ensure_header(block: ReadBlock) -> None:
        nonlocal header, header_bytes
        if header is not None:
            return
        header = engine.make_header_se(block)
        if header is None:
            raise RfqFormatError(
                "failed to encode, please confirm the input FASTQ file is "
                "valid and not empty"
            )
        header_bytes = header.to_bytes()
        out.write(header_bytes)
        check = RfqHeader.read(_io.BytesIO(header_bytes))
        if not header.identical_with(check):
            raise RfqFormatError(
                "encoding error in header, the output will be wrong, "
                "quit now!"
            )

    passnum = 0

    def emit(chunk, flag: bool, block: ReadBlock) -> None:
        nonlocal passnum
        if chunk is None:
            return
        if flag:
            chunk.flags |= BIT_HAS_NO_LINE_BREAK_AT_END
        if segmented:
            out.write_segments(chunk.to_segments())
        else:
            out.write(chunk.to_bytes())
        if verify or (fast_verify and passnum % 10 == 0):
            from ..pipeline import _verify_chunk

            _verify_chunk(header, chunk.to_bytes(), block, engine,
                          header_bytes)
        passnum += 1

    def flush_batch() -> None:
        nonlocal batch
        if not batch:
            return
        blocks = [b for b, _f in batch]
        chunks = enc.encode_batch(header, blocks, batch_L)
        if chunks is None:  # over the emission-sort limit: per-chunk path
            for b, f in batch:
                stats["fallback_chunks"] += 1
                emit(engine.encode_chunk(header, b, False), f, b)
        else:
            stats["mesh_batches"] += 1
            for (b, f), c in zip(batch, chunks):
                emit(c, f, b)
        batch = []

    while True:
        block, flag = reader.read_block(budget_bases=chunk_size)
        if block is None or block.n == 0:
            break
        ensure_header(block)
        lens = block.seq_lens()
        L = int(lens[0]) if block.n else 0
        uniform = L > 0 and bool((lens == L).all())
        total = int(lens.sum())
        eligible = (
            uniform
            and header.encode_qual_by_col()
            and min_bases <= total <= max_bases
            and header.has_x() == header.has_y()
        )
        if not eligible or (batch and L != batch_L):
            flush_batch()
        if not eligible:
            stats["fallback_chunks"] += 1
            emit(engine.encode_chunk(header, block, False), flag, block)
            continue
        batch_L = L
        batch.append((block, flag))
        if len(batch) == enc.D:
            flush_batch()
    flush_batch()
    reader.close()
    # empty input: the serial pipeline writes an empty container too
    if own:
        out.close()
    return stats
