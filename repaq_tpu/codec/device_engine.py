"""Production device engine: the CLI-reachable codec path that runs the
JAX stream kernels (ops/device_streams.py) for the per-base work of every
chunk, with the host doing only string/container bookkeeping. This is the
accelerator counterpart of the reference's production codec (reference
rfqcodec.cpp:163-586 encode, 1049-1260 decode); byte output is identical
to the host engines (and therefore the reference).

Division of labor per chunk:
  device  2-bit pack, qual bin classify + by-col emission, N-position
          stream, X/Y coordinate streams, PE revcomp + overlap search +
          overlap-elision compaction (encode); unpack, by-col qual decode,
          N restore, overlap expansion, revcomp (decode)
  host    FASTQ parse, name metadata + all-same predicates, length/name
          buffers, container assembly — byte bookkeeping, not FLOPs

Static-shape strategy (XLA traces once per shape): chunk arrays are padded
to bucketed sizes — seq with 'G' (packs to the reference's zero padding),
qual with the major qual (classified major => emits nothing), coordinate
arrays with an n_valid mask — so a steady run compiles one encode and one
decode executable. The static caps demanded by the emission kernels
(esc/nonmajor/npos) are computed EXACTLY on host (one cheap pass) and
bucketed, making them hard bounds by construction.

Chunks the device path does not cover fall back to the host engine with
identical bytes: ragged read lengths, >64-bin raw/RLE quality modes, tiny
chunks (dispatch floor dominates), oversized chunks (the emission sort's
2^23 dest-offset packing caps blocks at ~4M bases), and the astronomically
rare PE overlap double-hash collision.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np

from ..format.chunk import RfqChunk
from ..format.header import RfqHeader
from . import vectorized
from .blocks import ReadBlock, lens_to_offsets

_G = ord("G")
_N = ord("N")

# 12 Mbase: within the 2^24 grouping/decode key packing even after
# bucketing (16M data would bucket past it); two-operand emission sorts
# carry the >2^23 output offsets.
_MAX_DEVICE_BASES = 12 << 20
_MIN_DEVICE_BASES = 128 << 10

# default persistent compile cache: one fixed, git-ignored directory in
# the checkout (a directory that moves never hits)
_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_CACHE_ENABLED = False


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's own
    .jax_cache directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE_DIR


def _enable_compile_cache(jax) -> None:
    """Persistent XLA compilation cache: the encode/decode executables are
    big graphs, but a steady corpus uses one shape per direction — cache
    them across CLI invocations. Opt out with REPAQ_NO_COMPILE_CACHE=1."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED or os.environ.get("REPAQ_NO_COMPILE_CACHE"):
        return
    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _CACHE_ENABLED = True


def _bucket(x: int, lo: int = 1024) -> int:
    """Smallest c >= x of the form 2^k or 1.5*2^k (>= lo): stable shapes
    with <= 33% padding waste."""
    c = lo
    while c < x:
        if c + (c >> 1) >= x:
            return c + (c >> 1)
        c *= 2
    return c


class DeviceEngine:
    """Stateful wrapper owning the jit caches and the device palette.

    One instance serves a whole CLI run; compiled executables are keyed by
    the static shape/cap tuple, so a uniform corpus compiles each step
    exactly once.
    """

    def __init__(self, min_bases: int = _MIN_DEVICE_BASES,
                 max_bases: int = _MAX_DEVICE_BASES):
        import jax  # deferred so host-only runs never touch jax

        self._jax = jax
        _enable_compile_cache(jax)
        self.min_bases = min_bases
        self.max_bases = max_bases
        self._enc_cache: dict = {}
        self._dec_cache: dict = {}
        self.compile_seconds: dict = {}
        self._compile_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._palette = None  # (bins_dev, major, in_table_dev) per header
        self._palette_key = None
        self.stats = {"device_chunks": 0, "host_chunks": 0,
                      "device_decodes": 0, "host_decodes": 0}

    # ------------------------------------------------------------------
    # palette upload (once per header)
    # ------------------------------------------------------------------

    def _palette_for(self, header: RfqHeader):
        key = bytes(header.qual_buf)
        if self._palette_key != key:
            jax = self._jax
            bins = header.normal_qual_buf()
            in_table = np.zeros(256, dtype=bool)
            in_table[np.frombuffer(header.qual_buf, dtype=np.uint8)] = True
            self._palette = (
                jax.device_put(np.asarray(bins, dtype=np.uint8)),
                int(header.major_qual()),
                jax.device_put(in_table),
            )
            self._palette_key = key
        return self._palette

    # ------------------------------------------------------------------
    # payload packing / fetch (one D2H transfer per step)
    # ------------------------------------------------------------------

    @staticmethod
    def _pack_payload(parts):
        """Concat u8 parts -> (rows, 512) u8: every stream of a step comes
        back in ONE device-to-host transfer."""
        import jax.numpy as jnp

        flat = jnp.concatenate(parts)
        pad = (-flat.shape[0]) % 512
        if pad:
            flat = jnp.concatenate([flat, jnp.zeros(pad, jnp.uint8)])
        return flat.reshape(-1, 512)

    @staticmethod
    def _lens_bytes(lens_i32):
        import jax

        return jax.lax.bitcast_convert_type(lens_i32, np.uint8).reshape(-1)

    @staticmethod
    def _fetch(payload) -> np.ndarray:
        return np.asarray(payload).view(np.uint8).reshape(-1)

    # ------------------------------------------------------------------
    # header inference (reference rfqheader.cpp:130-237 scan on device)
    # ------------------------------------------------------------------

    def quality_stats(self, block: ReadBlock) -> dict:
        """The first-chunk quality scan on device: sort-based histogram
        (sort+searchsorted) plus the order-dependent N-policy reductions
        in one dispatch. Host falls back for tiny chunks or invalid bases
        (the error path needs the offending char)."""
        n = int(block.qual_flat.shape[0])
        from ..format.header import quality_stats as host_stats

        if n == 0 or n < self.min_bases:
            return host_stats(block.seq_flat, block.qual_flat)
        jax = self._jax
        import jax.numpy as jnp

        n_cap = _bucket(n, lo=4096)

        def build(_key):
            def stats_step(seq, qual, n_valid):
                i = jnp.arange(n_cap, dtype=jnp.int32)
                valid = i < n_valid
                # histogram: sort quals (pad with 255) + searchsorted
                qs = jnp.sort(jnp.where(valid, qual, jnp.uint8(255)))
                bounds = jnp.searchsorted(
                    qs, jnp.arange(129, dtype=jnp.uint8)
                )
                counts = jnp.diff(bounds)
                qual_ge128 = (
                    jnp.sum(jnp.where(valid & (qual >= 128), 1, 0))
                )
                is_acgt = (
                    (seq == ord("A")) | (seq == ord("C"))
                    | (seq == ord("G")) | (seq == ord("T"))
                )
                nmask = (seq == _N) & valid
                invalid = jnp.sum(
                    jnp.where(valid & ~is_acgt & ~nmask, 1, 0)
                )
                n_count = jnp.sum(nmask.astype(jnp.int32))
                first_n = jnp.argmax(nmask)  # 0 when none; gated by count
                first_q = qual[first_n].astype(jnp.int32)
                n_qual_differs = jnp.sum(
                    jnp.where(nmask & (qual != qual[first_n]), 1, 0)
                )
                after = i >= first_n
                nonn_after = jnp.sum(
                    jnp.where(
                        valid & after & ~nmask & (qual == qual[first_n]),
                        1, 0,
                    )
                )
                scalars = jnp.stack(
                    [qual_ge128, invalid, n_count, first_q,
                     n_qual_differs, nonn_after]
                ).astype(jnp.int32)
                return counts.astype(jnp.int32), scalars

            return stats_step

        seq_pad = np.full(n_cap, _G, dtype=np.uint8)
        seq_pad[:n] = block.seq_flat
        qual_pad = np.zeros(n_cap, dtype=np.uint8)
        qual_pad[:n] = block.qual_flat
        counts, scalars = self._run(
            self._enc_cache, ("qstats", n_cap), build,
            (jax.device_put(seq_pad), jax.device_put(qual_pad), jnp.int32(n)),
        )
        counts = np.asarray(counts).astype(np.int64)
        ge128, invalid, n_count, first_q, ndiff, nonn = (
            int(v) for v in np.asarray(scalars)
        )
        if invalid > 0:
            # error path: the message needs the offending char class
            return host_stats(block.seq_flat, block.qual_flat)
        return {
            "empty": False,
            "qual_ge128": ge128 > 0,
            "invalid_lower": False,
            "invalid_other": False,
            "qual_counts": counts,
            "n_count": n_count,
            "first_n_qual": first_q if n_count else -1,
            "n_qual_differs": ndiff > 0,
            "nonn_after_matches": nonn > 0,
        }

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------

    def encode_chunk(self, header: RfqHeader, block: ReadBlock,
                     is_pe: bool = False) -> RfqChunk | None:
        if block.n == 0:
            return None
        a = vectorized.analyze_chunk(header, block, is_pe)
        n_total = int(a.seq_lens.sum())
        wants_pe = a.can_interleave and a.encode_overlap
        # the flat SE path is position-addressed — it only needs the
        # TOTAL length, so ragged chunks qualify (round 3; decode went
        # ragged in round 2). Only the PE interleave/overlap path works
        # in a (reads, L) grid and still needs uniform lengths.
        eligible = (
            header.encode_qual_by_col()
            and (not wants_pe
                 or (a.read_len_same and int(a.seq_lens[0]) > 0))
            and self.min_bases <= n_total
            and n_total <= self.max_bases
            and header.has_x() == header.has_y()
        )
        if not eligible:
            self._count("host_chunks")
            return vectorized.encode_chunk(header, block, is_pe)
        try:
            if wants_pe:
                chunk = self._encode_pe_device(header, block, a)
            else:
                chunk = self._encode_se_device(header, block, a)
        except _DeviceFallback:
            chunk = None
        if chunk is None:
            self._count("host_chunks")
            return vectorized.encode_chunk(header, block, is_pe)
        self._count("device_chunks")
        return chunk

    def _host_caps(self, header: RfqHeader, block: ReadBlock):
        """Exact stream-size precursors, one cheap host pass: these make
        the device kernels' static caps hard bounds by construction."""
        in_tab = np.zeros(256, dtype=bool)
        in_tab[np.frombuffer(header.qual_buf, dtype=np.uint8)] = True
        qual = block.qual_flat
        nonmajor = int((qual != header.major_qual()).sum())
        esc = int((~in_tab[qual]).sum())
        npos = int((block.seq_flat == _N).sum())
        return nonmajor, esc, npos

    def _encode_se_device(self, header, block, a) -> RfqChunk | None:
        """Non-interleaved chunks (SE, or PE that degraded): flat streams.
        Matches reference rfqcodec.cpp:163-586 minus the PE branches."""
        jax = self._jax
        import jax.numpy as jnp

        n = int(a.seq_lens.sum())
        b = block.n
        nonmajor, esc, npos = self._host_caps(header, block)
        bins_dev, major, table_dev = self._palette_for(header)
        nbins = int(header.normal_qual_bins())

        n_cap = _bucket(n, lo=4096)
        if n_cap >= (1 << 24):
            return None  # past the bid<<24|pos grouping-key packing
        b_cap = _bucket(b, lo=256)
        nm_cap = _bucket(nonmajor)
        # esc == 0 proven host-side skips the escape compaction sort
        esc_cap = 0 if esc == 0 else _bucket(esc, lo=8)
        np_cap = _bucket(npos, lo=8)
        # optimistic emission buffer: with dense non-major
        # positions (mean gap <= 16) virtually every token is 1 byte, so
        # ~1.25 bytes/token covers the stream and the buffer stays under
        # the 2^23 packed-key threshold (single-operand layout sort). An
        # overflow is detected by qual_len > qfetch and falls back to the
        # byte-identical host path; sparse-qual chunks keep the safe
        # 4-bytes/token bound so they never lose the device path.
        if nonmajor * 16 >= n_cap:
            qfetch = _bucket(
                4 * nbins + nonmajor + nonmajor // 4 + 5 * esc + 4096)
        else:
            qfetch = min(_bucket(4 * nbins + 4 * nonmajor + 5 * esc + 8),
                         4 * nbins + n_cap + 8)
        # positions stream bound: 1 byte per match + <n/128 two-byte gaps
        # + <n/16384 four-byte gaps (deltas sum to <= n)
        npfetch = _bucket(min(4 * npos, npos + n_cap // 64) + 16, lo=64)
        has_xy = header.has_x()
        # the N-position machinery costs a full n-size sort: skip it when
        # the header restores N via nBaseQual, or the chunk has no Ns
        want_npos = header.encode_n_pos() and npos > 0

        key = ("se", n_cap, b_cap, nbins, nm_cap, esc_cap, np_cap, qfetch,
               npfetch, has_xy, want_npos)

        seq_pad = np.full(n_cap, _G, dtype=np.uint8)
        seq_pad[:n] = block.seq_flat
        qual_pad = np.full(n_cap, major, dtype=np.uint8)
        qual_pad[:n] = block.qual_flat
        if has_xy:
            xs = np.zeros(b_cap, dtype=np.int32)
            ys = np.zeros(b_cap, dtype=np.int32)
            xs[:b] = a.xs
            ys[:b] = a.ys
        else:
            xs = ys = np.zeros(1, dtype=np.int32)

        # u32 views: the device sees word-packed seq/qual (a free numpy
        # view here; the front end works per byte lane of each word)
        payload = self._run(self._enc_cache, key, self._build_encode_se, (
            jax.device_put(seq_pad.view("<u4")),
            jax.device_put(qual_pad.view("<u4")),
            jax.device_put(xs), jax.device_put(ys),
            jnp.int32(b), bins_dev, jnp.uint8(major), table_dev,
        ))
        raw = self._fetch(payload)

        # layout mirrors _build_encode_se's concat order
        off = 0
        packed_all = raw[off : off + n_cap // 4]; off += n_cap // 4
        qual_all = raw[off : off + qfetch]; off += qfetch
        npos_all = raw[off : off + npfetch]; off += npfetch
        xy_sz = (3 * b_cap + 8) if has_xy else 0
        x_all = raw[off : off + xy_sz]; off += xy_sz
        y_all = raw[off : off + xy_sz]; off += xy_sz
        lens = raw[off : off + 16].view("<i4")
        qual_len, npos_len, x_len, y_len = (int(v) for v in lens)
        if qual_len > qfetch or npos_len > npfetch:
            return None  # optimistic qfetch overflow: host path (bytes identical)

        return vectorized.assemble_chunk(
            header, block, a, np.zeros(0, dtype=np.int64),
            packed_all[: (n + 3) // 4].tobytes(),
            qual_all[:qual_len].tobytes(),
            npos_all[:npos_len].tobytes() if header.encode_n_pos() else b"",
            x_bytes=x_all[:x_len].tobytes() if has_xy else None,
            y_bytes=y_all[:y_len].tobytes() if has_xy else None,
        )

    def _build_encode_se(self, key):
        (_tag, n_cap, b_cap, nbins, nm_cap, esc_cap, np_cap, qfetch,
         npfetch, has_xy, want_npos) = key
        import jax.numpy as jnp

        from ..ops.device_streams import (
            coords_encode2_device,
            encode_frontend_meta32,
            encode_positions_from_meta32,
            qualcol_encode_device,
        )

        def step(seq32, qual32, xs, ys, n_reads, bins, major, in_table):
            packed, meta32 = encode_frontend_meta32(seq32, qual32, bins,
                                                    major)
            packed = packed[: (n_cap + 3) // 4]
            qual_out, qual_len = qualcol_encode_device(
                None, bins, major, in_table, esc_cap=esc_cap,
                nonmajor_cap=nm_cap, out_size=qfetch,
                meta32=meta32, qual32=qual32, n=n_cap,
            )
            if want_npos:
                npos_out, npos_len = encode_positions_from_meta32(
                    meta32, n_cap, npfetch, pos_cap=np_cap
                )
            else:
                npos_out = jnp.zeros(npfetch, dtype=jnp.uint8)
                npos_len = jnp.int32(0)
            if has_xy:
                xy_out, x_len, y_len = coords_encode2_device(
                    jnp.stack([xs, ys]), 3 * b_cap + 8, n_valid=n_reads
                )
            else:
                xy_out = jnp.zeros(0, dtype=jnp.uint8)
                x_len = y_len = jnp.int32(0)
            lens = jnp.stack(
                [qual_len, npos_len, x_len, y_len]
            ).astype(jnp.int32)
            return self._pack_payload([
                packed, qual_out[:qfetch], npos_out, xy_out,
                self._lens_bytes(lens),
            ])

        return step

    # -- PE interleaved ------------------------------------------------

    def _encode_pe_device(self, header, block, a) -> RfqChunk | None:
        """PE interleaved chunks: revcomp + overlap search + elision
        compaction on device (reference rfqcodec.cpp:279-407, 1391-1438)."""
        jax = self._jax
        import jax.numpy as jnp

        L = int(a.seq_lens[0])
        b = block.n
        pairs = b // 2
        n = b * L
        nonmajor, esc, npos = self._host_caps(header, block)
        bins_dev, major, table_dev = self._palette_for(header)
        nbins = int(header.normal_qual_bins())

        b_cap = _bucket(b, lo=256)
        if b_cap % 2:
            b_cap += 1
        p_cap = b_cap // 2
        n_cap = b_cap * L
        if n_cap >= (1 << 24):
            return None  # past the bid<<24|pos grouping-key packing
        nm_cap = _bucket(nonmajor)
        # esc == 0 proven host-side skips the escape compaction sort
        esc_cap = 0 if esc == 0 else _bucket(esc, lo=8)
        np_cap = _bucket(npos, lo=8)
        # optimistic emission buffer: with dense non-major
        # positions (mean gap <= 16) virtually every token is 1 byte, so
        # ~1.25 bytes/token covers the stream and the buffer stays under
        # the 2^23 packed-key threshold (single-operand layout sort). An
        # overflow is detected by qual_len > qfetch and falls back to the
        # byte-identical host path; sparse-qual chunks keep the safe
        # 4-bytes/token bound so they never lose the device path.
        if nonmajor * 16 >= n_cap:
            qfetch = _bucket(
                4 * nbins + nonmajor + nonmajor // 4 + 5 * esc + 4096)
        else:
            qfetch = min(_bucket(4 * nbins + 4 * nonmajor + 5 * esc + 8),
                         4 * nbins + n_cap + 8)
        npfetch = _bucket(min(4 * npos, npos + n_cap // 64) + 16, lo=64)
        has_xy = header.has_x()
        want_npos = header.encode_n_pos() and npos > 0

        key = ("pe", b_cap, L, nbins, nm_cap, esc_cap, np_cap, qfetch,
               npfetch, has_xy, want_npos, int(header.overlap_shift))

        seq_mat = np.full((b_cap, L), _G, dtype=np.uint8)
        seq_mat[:b] = block.seq_flat.reshape(b, L)
        qual_mat = np.full((b_cap, L), major, dtype=np.uint8)
        qual_mat[:b] = block.qual_flat.reshape(b, L)
        if has_xy:
            xs = np.zeros(p_cap, dtype=np.int32)
            ys = np.zeros(p_cap, dtype=np.int32)
            xs[:pairs] = a.xs[0::2]
            ys[:pairs] = a.ys[0::2]
        else:
            xs = ys = np.zeros(1, dtype=np.int32)

        payload = self._run(self._enc_cache, key, self._build_encode_pe, (
            jax.device_put(seq_mat), jax.device_put(qual_mat),
            jax.device_put(xs), jax.device_put(ys),
            jnp.int32(b), jnp.int32(pairs),
            bins_dev, jnp.uint8(major), table_dev,
        ))
        raw = self._fetch(payload)

        pk_cap = (n_cap + 3) // 4
        off = 0
        packed_all = raw[off : off + pk_cap]; off += pk_cap
        qual_all = raw[off : off + qfetch]; off += qfetch
        npos_all = raw[off : off + npfetch]; off += npfetch
        xy_sz = (3 * p_cap + 8) if has_xy else 0
        x_all = raw[off : off + xy_sz]; off += xy_sz
        y_all = raw[off : off + xy_sz]; off += xy_sz
        ov_all = raw[off : off + p_cap]; off += p_cap
        lens = raw[off : off + 24].view("<i4")
        qual_len, npos_len, x_len, y_len, total_stored, ncoll = (
            int(v) for v in lens
        )
        if ncoll > 0:
            # double-hash collision in the overlap search (probability
            # ~2^-64 per pair): first-match semantics need the host search
            return None
        if qual_len > qfetch or npos_len > npfetch:
            return None

        ov = (
            ov_all[:pairs].view(np.int8).astype(np.int64)
            - header.overlap_shift
        )
        return vectorized.assemble_chunk(
            header, block, a, ov,
            packed_all[: (total_stored + 3) // 4].tobytes(),
            qual_all[:qual_len].tobytes(),
            npos_all[:npos_len].tobytes() if header.encode_n_pos() else b"",
            x_bytes=x_all[:x_len].tobytes() if has_xy else None,
            y_bytes=y_all[:y_len].tobytes() if has_xy else None,
        )

    def _build_encode_pe(self, key):
        (_tag, b_cap, L, nbins, nm_cap, esc_cap, np_cap, qfetch, npfetch,
         has_xy, want_npos, shift) = key
        jax = self._jax
        import jax.numpy as jnp

        from ..ops.device_streams import (
            coords_encode2_device,
            encode_positions_from_mask,
            overlap_pairs_device,
            pack_2bit_device,
            qualcol_encode_device,
        )

        p_cap = b_cap // 2
        n_cap = b_cap * L

        def comp(x):
            # alphabet is ACGTN (lowercase rejected at header build)
            return jnp.where(
                x == ord("A"), ord("T"),
                jnp.where(x == ord("T"), ord("A"),
                          jnp.where(x == ord("C"), ord("G"),
                                    jnp.where(x == ord("G"), ord("C"), x))),
            ).astype(jnp.uint8)

        def step(seq_mat, qual_mat, xs, ys, n_reads, n_pairs, bins, major,
                 in_table):
            odd = (jnp.arange(b_cap) % 2 == 1)[:, None]
            tseq = jnp.where(odd, comp(jnp.flip(seq_mat, axis=1)), seq_mat)
            tqual = jnp.where(odd, jnp.flip(qual_mat, axis=1), qual_mat)

            # overlap search (reference rfqcodec.cpp:1391-1438) + the
            # encode-side shift clamp (rfqcodec.cpp:379-382)
            ov, coll = overlap_pairs_device(tseq[0::2], tseq[1::2])
            pvalid = jnp.arange(p_cap) < n_pairs
            ov = jnp.where(pvalid, ov, 0)
            shifted = ov + shift
            ov = jnp.where((shifted > 127) | (shifted < -127), 0, ov)
            ncoll = jnp.sum((coll & pvalid).astype(jnp.int32))

            # per-row stored spans (elision: odd rows drop |ov| bases)
            aov = jnp.abs(ov)
            fwd = jnp.maximum(ov, 0)
            zeros_p = jnp.zeros(p_cap, dtype=jnp.int32)
            drop_row = jnp.stack([zeros_p, aov], axis=1).reshape(-1)
            start_row = jnp.stack([zeros_p, fwd], axis=1).reshape(-1)
            rvalid = jnp.arange(b_cap) < n_reads
            stored_row = jnp.where(rvalid, L - drop_row, 0)
            cum = jnp.cumsum(stored_row)
            dest_off = cum - stored_row
            total_stored = cum[-1]

            # compaction: two-operand sort by dest offset (dest can exceed
            # the 2^23 limit of the packed-key emission sort)
            i = jnp.arange(L, dtype=jnp.int32)[None, :]
            keep = (i >= start_row[:, None]) & (
                i < (start_row + stored_row)[:, None]
            )
            dest = dest_off[:, None] + i - start_row[:, None]
            keys = jnp.where(keep, dest, jnp.int32(2**31 - 1)).reshape(-1)
            vals = tseq.reshape(-1)
            _sk, sv = jax.lax.sort((keys, vals), num_keys=1)
            seq_concat = jnp.where(
                jnp.arange(n_cap) < total_stored, sv, jnp.uint8(_G)
            )

            # front end over the ELIDED seq + full qual; the 'G' tail
            # pads the final packed byte with zero codes, as the
            # reference does
            qual_flat = tqual.reshape(-1)
            seq4 = jnp.concatenate([
                seq_concat,
                jnp.full((-n_cap) % 4, _G, jnp.uint8),
            ])
            packed = pack_2bit_device(seq4)
            nmask = seq_concat == _N
            qual_out, qual_len = qualcol_encode_device(
                qual_flat, bins, major, in_table, esc_cap=esc_cap,
                nonmajor_cap=nm_cap, out_size=qfetch,
            )
            if want_npos:
                npos_out, npos_len = encode_positions_from_mask(
                    nmask, npfetch, pos_cap=np_cap
                )
            else:
                npos_out = jnp.zeros(npfetch, dtype=jnp.uint8)
                npos_len = jnp.int32(0)
            if has_xy:
                xy_out, x_len, y_len = coords_encode2_device(
                    jnp.stack([xs, ys]), 3 * p_cap + 8, n_valid=n_pairs
                )
            else:
                xy_out = jnp.zeros(0, dtype=jnp.uint8)
                x_len = y_len = jnp.int32(0)

            ov_store = ((ov + shift) & 0xFF).astype(jnp.uint8)
            lens = jnp.stack(
                [qual_len, npos_len, x_len, y_len, total_stored, ncoll]
            ).astype(jnp.int32)
            return self._pack_payload([
                packed, qual_out[:qfetch], npos_out, xy_out,
                ov_store, self._lens_bytes(lens),
            ])

        return step

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def decode_chunk(self, header: RfqHeader, chunk: RfqChunk) -> ReadBlock:
        from ..constants import BIT_PE_INTERLEAVED

        n = chunk.reads
        if n == 0:
            return ReadBlock.from_reads([])
        read_lens = chunk.read_lengths().astype(np.int64)
        L = int(read_lens[0])
        uniform = bool((read_lens == L).all())
        n_total = int(read_lens.sum())
        pe = bool(chunk.flags & BIT_PE_INTERLEAVED)
        # ragged chunks are fine on device when no PE interleave is in
        # play: the flat streams need no per-read geometry (only the PE
        # revcomp/expansion works in a (reads, L) grid)
        eligible = (
            header.encode_qual_by_col()
            and (uniform if pe else True)
            and n_total > 0
            and self.min_bases <= n_total <= self.max_bases
        )
        if not eligible:
            self._count("host_decodes")
            return vectorized.decode_chunk(header, chunk)
        if pe:
            block = self._decode_device(header, chunk, n, L)
        else:
            block = self._decode_device_flat(header, chunk, n, read_lens)
        if block is None:
            self._count("host_decodes")
            return vectorized.decode_chunk(header, chunk)
        self._count("device_decodes")
        return block

    def _decode_device_flat(self, header, chunk, b, read_lens) -> ReadBlock | None:
        """Non-interleaved decode (uniform OR ragged read lengths): the
        streams are position-addressed, so the flat kernels need only the
        total length; per-read offsets stay host-side for assembly
        (reference rfqcodec.cpp:1049-1260 minus the PE branches)."""
        jax = self._jax
        import jax.numpy as jnp

        n_total = int(read_lens.sum())
        if (n_total + 3) // 4 != len(chunk.seq_buf):
            return None  # corrupt container: let the host path error out
        nbins = int(header.normal_qual_bins())
        n_cap = _bucket(n_total, lo=4096)
        qual_len = len(chunk.qual_buf)
        npos_len = len(chunk.npos_buf) if header.encode_n_pos() else 0
        caps = self._decode_caps(n_cap, qual_len, npos_len, chunk, nbins)
        if caps is None:
            return None  # corrupt qual stream: host decoder raises
        qb_cap, nb_cap, np_cap, qcaps = caps
        if n_cap >= (1 << 24):
            return None  # past the (pos+length)<<6 decode packing

        key = ("decflat", n_cap, nbins, qb_cap, nb_cap, np_cap, qcaps,
               bool(header.encode_n_pos()), int(header.n_base_qual))

        pk_cap = n_cap // 4
        packed = np.zeros(pk_cap, dtype=np.uint8)
        packed[: len(chunk.seq_buf)] = np.frombuffer(
            chunk.seq_buf, dtype=np.uint8
        )
        qual_buf = np.zeros(qb_cap, dtype=np.uint8)
        qual_buf[:qual_len] = np.frombuffer(chunk.qual_buf, dtype=np.uint8)
        npos_buf = np.zeros(nb_cap, dtype=np.uint8)
        if npos_len:
            npos_buf[:npos_len] = np.frombuffer(
                chunk.npos_buf, dtype=np.uint8
            )
        bins_dev, major, _table = self._palette_for(header)
        payload = self._run(self._dec_cache, key, self._build_decode_flat, (
            jax.device_put(packed), jax.device_put(qual_buf),
            jnp.int32(qual_len), jax.device_put(npos_buf),
            jnp.int32(npos_len), bins_dev, jnp.uint8(major),
        ))
        raw = self._fetch(payload)
        seq = raw[:n_total].copy()
        qual = raw[n_cap : n_cap + n_total].copy()
        seq_off = lens_to_offsets(read_lens)
        return vectorized.assemble_block(
            header, chunk, b, read_lens, seq_off, seq, qual
        )

    # distinct decode shapes compiled before clamping to the universal
    # shape (a varied corpus must not keep minting executables)
    _MAX_DECODE_SHAPES = 4

    def _decode_caps(self, n_cap: int, qual_len: int, npos_len: int,
                     chunk, nbins: int):
        """All decode-side caps quantized to FRACTIONS of the chunk
        geometry (n_cap/16 .. n_cap) instead of their own pow2 buckets:
        at most ~5 values per geometry, so near-boundary corpora can't
        mint per-chunk executables (padding is compute slack — the
        kernels mask by true lengths). Once the run has compiled
        _MAX_DECODE_SHAPES distinct decode executables, everything clamps
        to the universal (largest) shape so no further compiles happen."""
        universal = len(self._dec_cache) >= self._MAX_DECODE_SHAPES

        def geo(x, lo=1024):
            if universal:
                return n_cap + lo
            # 1.5x mid-steps: the decode compaction sort scales with
            # these caps, and the coarse ladder padded an
            # ~0.7*n qual stream all the way to n
            for num, den in ((1, 16), (3, 32), (1, 8), (3, 16), (1, 4),
                             (3, 8), (1, 2), (3, 4), (1, 1)):
                c = max(lo, (n_cap * num) // den)
                if c >= x:
                    return c
            return n_cap + lo  # above n_cap (e.g. + table/record slack)

        qb_cap = geo(qual_len + 4 * nbins + 16)
        nb_cap = geo(npos_len + 8, lo=64)
        np_cap = geo(min(32 * npos_len + 8, n_cap), lo=64)
        if universal:
            tok_cap = n_cap + 8192  # tokens <= positions <= n
            pos_cap = n_cap + 4096
            esc_cap = qb_cap // 5 + 1
            run_cap = None  # legacy slot-space path (run count unknown)
        else:
            from . import kernels_np as K

            counts = K.qualcol_decode_counts(
                np.frombuffer(chunk.qual_buf, dtype=np.uint8), nbins
            )
            if counts is None:
                return None  # corrupt qual stream: host decoder raises
            t, c, esc = counts
            tok_cap = geo(t, lo=512)
            pos_cap = geo(c, lo=512)
            esc_cap = 0 if esc == 0 else geo(esc, lo=8)
            # run tokens (coverage >= 2) number exactly <= positions -
            # tokens; the token-space decode extends them via a
            # (run, 4, 31) grid — profitable while that grid stays small
            # relative to the slot-space scatters it replaces. Run-heavy
            # chunks (2-bin RTA-style data) keep the legacy path.
            run_cnt = max(0, c - t)
            if run_cnt * 31 <= max(4096, c):
                run_cap = geo(run_cnt + 2, lo=64)
            else:
                run_cap = None
        if pos_cap == tok_cap:
            # keep the token- and slot-space shapes distinct, so XLA does
            # not fuse the two pipelines into one loop
            pos_cap += 4096
        return qb_cap, nb_cap, np_cap, (tok_cap, pos_cap, esc_cap,
                                        run_cap)

    def _count(self, name: str) -> None:
        with self._stats_lock:  # codec worker threads share the counters
            self.stats[name] += 1

    def _run(self, cache: dict, key, build, args):
        """Run the executable for `key`, compiling build(key) ahead of
        time for these arguments on first use. Compile seconds land in
        self.compile_seconds[key]; the compiled executable stays in
        `cache` (its memory_analysis() is the step's device footprint)."""
        exe = cache.get(key)
        if exe is None:
            # one compile per key: codec worker threads wait for it
            with self._compile_lock:
                exe = cache.get(key)
                if exe is None:
                    if os.environ.get("REPAQ_PROFILE"):
                        print("repaq_tpu: compiling device executable %r"
                              % (key,), file=sys.stderr)
                    t0 = time.perf_counter()
                    exe = self._jax.jit(build(key)).lower(*args).compile()
                    self.compile_seconds[key] = time.perf_counter() - t0
                    cache[key] = exe
        return exe(*args)

    def _build_decode_flat(self, key):
        (_tag, n_cap, nbins, qb_cap, nb_cap, np_cap, qcaps, has_npos,
         nbq) = key
        import jax.numpy as jnp

        from ..ops.device_streams import (
            decode_positions_device,
            qualcol_decode_device,
            unpack_2bit_device,
        )

        tok_cap, pos_cap, esc_cap, run_cap = qcaps

        def step(packed, qual_buf, qual_len, npos_buf, npos_len, bins,
                 major):
            seq = unpack_2bit_device(packed)[:n_cap]
            if has_npos:
                pos, _cnt = decode_positions_device(
                    npos_buf, npos_len, np_cap
                )
                tgt = jnp.where(pos >= 0, pos, n_cap)
                seq = jnp.concatenate([seq, jnp.zeros(1, jnp.uint8)])
                seq = seq.at[tgt].set(_N, mode="drop")[:n_cap]
            qual = qualcol_decode_device(
                qual_buf, nbins, bins, major, n_cap, qual_len,
                tok_cap=tok_cap, pos_cap=pos_cap, esc_cap=esc_cap,
                run_cap=run_cap,
            )
            if not has_npos and nbq < 128:
                seq = jnp.where(qual == nbq, jnp.uint8(_N), seq)
            return self._pack_payload([seq, qual])

        return step

    def _decode_device(self, header, chunk, b, L) -> ReadBlock | None:
        jax = self._jax
        import jax.numpy as jnp

        from ..constants import BIT_PE_INTERLEAVED

        pe = bool(chunk.flags & BIT_PE_INTERLEAVED)
        expand = pe and header.encode_pe_by_overlap()
        nbins = int(header.normal_qual_bins())
        b_cap = _bucket(b, lo=256)
        if b_cap % 2:
            b_cap += 1
        n_cap = b_cap * L
        flat_cap = n_cap + ((-n_cap) % 4)

        # per-row expansion tables from the overlap bytes (host: tiny)
        if expand:
            ovb = np.frombuffer(chunk.overlap_buf, dtype=np.int8).astype(
                np.int64
            )
            ov = ovb - header.overlap_shift
            stored = np.full(b, L, dtype=np.int64)
            stored[1::2] -= np.abs(ov)
            total_stored = int(stored.sum())
        else:
            stored = np.full(b, L, dtype=np.int64)
            total_stored = b * L
        if (total_stored + 3) // 4 != len(chunk.seq_buf):
            return None  # corrupt container: let the host path error out

        qual_len = len(chunk.qual_buf)
        npos_len = len(chunk.npos_buf) if header.encode_n_pos() else 0
        caps = self._decode_caps(flat_cap, qual_len, npos_len, chunk, nbins)
        if caps is None:
            return None  # corrupt qual stream: host decoder raises
        qb_cap, nb_cap, np_cap, qcaps = caps
        np_cap = min(np_cap, flat_cap)
        if flat_cap >= (1 << 24):
            return None  # past the (pos+length)<<6 decode packing

        key = ("dec", b_cap, L, nbins, qb_cap, nb_cap, np_cap, qcaps,
               expand, pe, bool(header.encode_n_pos()),
               int(header.n_base_qual))

        pk_cap = (flat_cap + 3) // 4
        packed = np.zeros(pk_cap, dtype=np.uint8)
        packed[: len(chunk.seq_buf)] = np.frombuffer(
            chunk.seq_buf, dtype=np.uint8
        )
        qual_buf = np.zeros(qb_cap, dtype=np.uint8)
        qual_buf[:qual_len] = np.frombuffer(chunk.qual_buf, dtype=np.uint8)
        npos_buf = np.zeros(nb_cap, dtype=np.uint8)
        if npos_len:
            npos_buf[:npos_len] = np.frombuffer(
                chunk.npos_buf, dtype=np.uint8
            )

        stored_pad = np.zeros(b_cap, dtype=np.int64)
        stored_pad[:b] = stored
        off_pad = np.zeros(b_cap, dtype=np.int32)
        off_pad[:b] = (np.cumsum(stored_pad) - stored_pad)[:b]
        fwd_pad = np.zeros(b_cap, dtype=np.int32)
        bwd_pad = np.zeros(b_cap, dtype=np.int32)
        prev_pad = np.zeros(b_cap, dtype=np.int32)
        if expand:
            fwd_pad[1:b:2] = np.maximum(ov, 0)
            bwd_pad[1:b:2] = np.maximum(-ov, 0)
            prev_pad[1:b:2] = off_pad[0:b:2]

        bins_dev, major, _table = self._palette_for(header)
        payload = self._run(self._dec_cache, key, self._build_decode, (
            jax.device_put(packed), jax.device_put(qual_buf),
            jnp.int32(qual_len), jax.device_put(npos_buf),
            jnp.int32(npos_len), jax.device_put(off_pad),
            jax.device_put(fwd_pad), jax.device_put(bwd_pad),
            jax.device_put(prev_pad), bins_dev, jnp.uint8(major),
        ))
        raw = self._fetch(payload)
        n_total = b * L
        seq = raw[:n_total].copy()
        qual = raw[n_cap : n_cap + n_total].copy()
        seq_off = lens_to_offsets(np.full(b, L, dtype=np.int64))
        return vectorized.assemble_block(
            header, chunk, b, np.full(b, L, dtype=np.int64), seq_off, seq,
            qual,
        )

    def _build_decode(self, key):
        (_tag, b_cap, L, nbins, qb_cap, nb_cap, np_cap, qcaps, expand, pe,
         has_npos, nbq) = key
        tok_cap, pos_cap, esc_cap = qcaps[:3]
        import jax.numpy as jnp

        from ..ops.device_streams import (
            decode_positions_device,
            qualcol_decode_device,
            unpack_2bit_device,
        )

        n_cap = b_cap * L
        flat_cap = n_cap + ((-n_cap) % 4)

        def comp(x):
            return jnp.where(
                x == ord("A"), ord("T"),
                jnp.where(x == ord("T"), ord("A"),
                          jnp.where(x == ord("C"), ord("G"),
                                    jnp.where(x == ord("G"), ord("C"), x))),
            ).astype(jnp.uint8)

        def step(packed, qual_buf, qual_len, npos_buf, npos_len, stored_off,
                 fwd, bwd, prev_off, bins, major):
            seq = unpack_2bit_device(packed)[:flat_cap]
            if has_npos:
                pos, _cnt = decode_positions_device(
                    npos_buf, npos_len, np_cap
                )
                tgt = jnp.where(pos >= 0, pos, flat_cap)
                seq = jnp.concatenate([seq, jnp.zeros(1, jnp.uint8)])
                seq = seq.at[tgt].set(_N, mode="drop")[:flat_cap]
            if expand:
                # three-piece reconstruction (reference rfqcodec.cpp:860-901)
                # with every per-row scalar broadcast — elementwise src
                # computation plus ONE flat gather
                i = jnp.arange(L, dtype=jnp.int32)[None, :]
                so = stored_off[:, None]
                f = fwd[:, None]
                w = bwd[:, None]
                src_odd = jnp.where(
                    i < f,
                    so - f + i,
                    jnp.where(
                        i >= L - w, prev_off[:, None] + i - (L - w),
                        so + i - f,
                    ),
                )
                odd = (jnp.arange(b_cap) % 2 == 1)[:, None]
                src = jnp.where(odd, src_odd, so + i).reshape(-1)
                seq = seq[jnp.clip(src, 0, flat_cap - 1)]
            else:
                seq = seq[:n_cap]
            qual = qualcol_decode_device(
                qual_buf, nbins, bins, major, n_cap, qual_len,
                tok_cap=tok_cap, pos_cap=pos_cap, esc_cap=esc_cap,
            )
            if not has_npos and nbq < 128:
                seq = jnp.where(qual == nbq, jnp.uint8(_N), seq)
            if pe:
                odd = (jnp.arange(b_cap) % 2 == 1)[:, None]
                seq_mat = seq[:n_cap].reshape(b_cap, L)
                qual_mat = qual.reshape(b_cap, L)
                seq_mat = jnp.where(
                    odd, comp(jnp.flip(seq_mat, axis=1)), seq_mat
                )
                qual_mat = jnp.where(
                    odd, jnp.flip(qual_mat, axis=1), qual_mat
                )
                seq = seq_mat.reshape(-1)
                qual = qual_mat.reshape(-1)
            return self._pack_payload([seq[:n_cap], qual])

        return step


class _DeviceFallback(Exception):
    """Internal: chunk must take the host path."""


def make_engine_config():
    """EngineConfig for pipeline.get_engine('device'): header inference on
    host (reference rfqcodec.cpp:20-145 — one pass over the first chunk),
    chunk codec on device with byte-identical host fallback.
    REPAQ_DEVICE_MIN_BASES / REPAQ_DEVICE_MAX_BASES override the
    size window (tests force the device path on tiny fixtures)."""
    import os

    from ..pipeline import EngineConfig

    eng = DeviceEngine(
        min_bases=int(os.environ.get("REPAQ_DEVICE_MIN_BASES",
                                     _MIN_DEVICE_BASES)),
        max_bases=int(os.environ.get("REPAQ_DEVICE_MAX_BASES",
                                     _MAX_DEVICE_BASES)),
    )
    return EngineConfig(
        make_header_se=lambda b: vectorized.make_header_se(
            b, stats_fn=eng.quality_stats
        ),
        make_header_pe=lambda b: vectorized.make_header_pe(
            b, stats_fn=eng.quality_stats
        ),
        encode_chunk=eng.encode_chunk,
        decode_chunk=eng.decode_chunk,
        name="device",
    )
