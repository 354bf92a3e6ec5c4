"""Data-parallel device encode over a jax.sharding.Mesh.

The .rfq format makes chunks independent once the header (quality palette,
name template) is fixed (reference: header read once repaq.cpp:270-277,
chunks self-delimiting rfqchunk.cpp:161-171), so the natural multi-chip
layout is one mesh axis `data`, read blocks sharded across it, and the
small palette arrays replicated. Each device encodes its blocks; per-device
stream lengths are all-gathered so every device (and the writer host)
knows the container offsets for ordered assembly. TP/PP/SP/EP have no
analog here — there is no model to shard (SURVEY.md §2.2).

Blocks are fixed-shape (reads_per_block, read_len) u8 arrays — the padded
fast path for uniform-length Illumina data; ragged inputs take the host
path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_streams import (
    coords_encode_device,
    decode_positions_device,
    encode_positions_from_mask,
    pack_2bit_device,
    qualcol_decode_device,
    qualcol_encode_device,
    unpack_2bit_device,
)


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def device_encode_block(seqs, quals, xs, ys, bins, major, in_table,
                        esc_cap: int | None = None,
                        nonmajor_cap: int | None = None,
                        npos_cap: int | None = None,
                        qual_out_size: int | None = None,
                        npos_out_size: int | None = None,
                        check_counts: bool = True,
                        n_valid_reads=None):
    """Encode one fixed-shape block on one device.

    seqs/quals: (B, L) uint8 (read-major, matching the chunk concat order);
    xs/ys: (B,) int32; bins: (nbins,) uint8; major: scalar; in_table: (256,)
    bool. esc_cap/nonmajor_cap: static bounds on out-of-table quality chars
    and non-major-qual positions (see qualcol_encode_device); npos_cap:
    static bound on 'N' bases. All default to n = fully general; the host
    pipeline knows exact counts and passes tight buckets. The caps are HARD
    preconditions — grouped entries past a cap are silently dropped by the
    sort-slice compaction — so the result includes the true on-device
    counts ("n_esc", "n_nonmajor", "n_npos", one fused reduction each);
    callers passing non-exact caps must check counts <= caps before
    trusting the streams (the production engine computes exact counts
    host-side, making the caps exact by construction). Returns a dict of
    padded streams + true lengths.
    """
    b, l = seqs.shape
    n = b * l
    flat_seq = seqs.reshape(-1)
    flat_qual = quals.reshape(-1)
    # zero tail bytes pack to code 0, the reference's zero-padded final byte
    packed = pack_2bit_device(
        jnp.concatenate([flat_seq, jnp.zeros((-n) % 4, dtype=jnp.uint8)])
    )
    nmask = flat_seq == ord("N")
    qual_out, qual_len = qualcol_encode_device(
        flat_qual, bins, major, in_table, esc_cap=esc_cap,
        nonmajor_cap=nonmajor_cap, out_size=qual_out_size,
    )
    npos_out, npos_len = encode_positions_from_mask(
        nmask, npos_out_size or (n // 2 + 8), pos_cap=npos_cap
    )
    # n_valid_reads (traced, optional): rows past it are PADDING — they
    # emit nothing from the qual path (padded with the major qual) and
    # must not extend coordinate repeat runs (the mesh chunk batcher pads
    # every chunk to a shared (B_cap, L) shape)
    x_out, x_len = coords_encode_device(xs, 3 * b + 8,
                                        n_valid=n_valid_reads)
    y_out, y_len = coords_encode_device(ys, 3 * b + 8,
                                        n_valid=n_valid_reads)
    # true counts behind the static caps (cheap fused reductions) — lets
    # callers detect a cap violation instead of shipping a silently
    # truncated stream (ADVICE r1).
    if not check_counts:
        # caller proved the caps exact host-side (the production engine's
        # mode): skip three full-n reductions
        n_esc = n_nonmajor = n_npos = jnp.int32(-1)
    else:
        n_esc = jnp.sum(~in_table[flat_qual]).astype(jnp.int32)
        n_nonmajor = jnp.sum(flat_qual != major).astype(jnp.int32)
        n_npos = jnp.sum(nmask).astype(jnp.int32)
    return {
        "n_esc": n_esc,
        "n_nonmajor": n_nonmajor,
        "n_npos": n_npos,
        "packed": packed,
        "qual": qual_out,
        "qual_len": qual_len,
        "npos": npos_out,
        "npos_len": npos_len,
        "x": x_out,
        "x_len": x_len,
        "y": y_out,
        "y_len": y_len,
    }


def device_encode_pe_block(seq_mat, qual_mat, xs, ys, n_reads, n_pairs,
                           bins, major, in_table, overlap_shift: int,
                           esc_cap=None, nonmajor_cap=None, npos_cap=None,
                           qual_out_size=None, npos_out_size=None):
    """PE-interleaved encode of one fixed-shape block on one device:
    revcomp of odd rows, double-hash overlap search, elision compaction
    (two-operand sort), then the same stream kernels as the SE block —
    the shard_map-safe twin of codec/device_engine._build_encode_pe
    (reference rfqcodec.cpp:279-407, 1391-1438). seq_mat/qual_mat:
    (B, L) u8 with pairs interleaved row-wise; xs/ys: (B//2,) i32 per
    pair. Rows past n_reads are padding. Returns dict incl. the overlap
    bytes, total stored bases, and the collision count (a nonzero ncoll
    means the host must re-encode that chunk on the scalar path to keep
    first-match semantics)."""
    from ..ops.device_streams import overlap_pairs_device

    b_cap, L = seq_mat.shape
    p_cap = b_cap // 2
    n_cap = b_cap * L

    def comp(x):
        return jnp.where(
            x == ord("A"), ord("T"),
            jnp.where(x == ord("T"), ord("A"),
                      jnp.where(x == ord("C"), ord("G"),
                                jnp.where(x == ord("G"), ord("C"), x))),
        ).astype(jnp.uint8)

    odd = (jnp.arange(b_cap) % 2 == 1)[:, None]
    tseq = jnp.where(odd, comp(jnp.flip(seq_mat, axis=1)), seq_mat)
    tqual = jnp.where(odd, jnp.flip(qual_mat, axis=1), qual_mat)

    ov, coll = overlap_pairs_device(tseq[0::2], tseq[1::2])
    pvalid = jnp.arange(p_cap) < n_pairs
    ov = jnp.where(pvalid, ov, 0)
    shifted = ov + overlap_shift
    ov = jnp.where((shifted > 127) | (shifted < -127), 0, ov)
    ncoll = jnp.sum((coll & pvalid).astype(jnp.int32))

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

    i = jnp.arange(L, dtype=jnp.int32)[None, :]
    keep = (i >= start_row[:, None]) & (
        i < (start_row + stored_row)[:, None]
    )
    dest = dest_off[:, None] + i - start_row[:, None]
    keys = jnp.where(keep, dest, jnp.int32(2**31 - 1)).reshape(-1)
    _sk, sv = jax.lax.sort((keys, tseq.reshape(-1)), num_keys=1)
    seq_concat = jnp.where(
        jnp.arange(n_cap) < total_stored, sv, jnp.uint8(ord("G"))
    )

    out = device_encode_block(
        seq_concat.reshape(b_cap, L), tqual, xs, ys, bins, major,
        in_table, esc_cap=esc_cap,
        nonmajor_cap=nonmajor_cap, npos_cap=npos_cap,
        qual_out_size=qual_out_size, npos_out_size=npos_out_size,
        check_counts=False, n_valid_reads=n_pairs,
    )
    out["ov"] = ((ov + overlap_shift) & 0xFF).astype(jnp.uint8)
    out["total_stored"] = total_stored
    out["ncoll"] = ncoll
    return out


def device_decode_block(packed, qual_buf, qual_len, npos_buf, npos_len,
                        bins, major, reads, read_len,
                        np_cap: int | None = None,
                        qualcol_caps: tuple | None = None):
    """Decode one fixed-shape block on one device: 2-bit unpack, by-column
    quality reconstruction, N restoration from the position stream
    (reference rfqcodec.cpp:826-916 fixed-length path; overlap-elided PE
    blocks take the host path). np_cap / qualcol_caps: optional tight
    static caps (N positions; qual (tok, pos, esc) counts) as the
    production engine computes host-side — defaults are safe structural
    bounds sized by the buffers."""
    n = reads * read_len
    seq = unpack_2bit_device(packed)[:n]
    if np_cap is None:
        np_cap = min(n, 32 * npos_buf.shape[0])
    npos, _cnt = decode_positions_device(npos_buf, npos_len, np_cap)
    tgt = jnp.where(npos >= 0, npos, n)
    seq = jnp.concatenate([seq, jnp.zeros(1, dtype=jnp.uint8)])
    seq = seq.at[tgt].set(ord("N"), mode="drop")[:n]
    tok_cap, pos_cap, esc_cap = qualcol_caps or (None, None, None)
    qual = qualcol_decode_device(
        qual_buf, bins.shape[0], bins, major, n, qual_len,
        tok_cap=tok_cap, pos_cap=pos_cap, esc_cap=esc_cap,
    )
    return seq.reshape(reads, read_len), qual.reshape(reads, read_len)


def device_decode_pe_block(packed, qual_buf, qual_len, npos_buf, npos_len,
                           stored_off, fwd, bwd, prev_off, bins, major,
                           reads, read_len, expand: bool,
                           np_cap: int | None = None,
                           qualcol_caps: tuple | None = None,
                           nbq: int = 255, has_npos: bool = True):
    """PE-interleaved decode of one fixed-shape block on one device:
    unpack, N restore (in STORED coordinates), three-piece overlap
    expansion (reference rfqcodec.cpp:860-901) as elementwise source
    computation plus ONE flat gather, by-col qual decode, then odd-row
    un-revcomp. The shard_map-safe twin of
    codec/device_engine._build_decode. stored_off/fwd/bwd/prev_off: (B,)
    i32 per-row expansion tables the host derives from the chunk's
    overlap bytes."""
    b_cap, L = reads, read_len
    n = b_cap * L
    flat_cap = n + ((-n) % 4)

    def comp(x):
        return jnp.where(
            x == ord("A"), ord("T"),
            jnp.where(x == ord("T"), ord("A"),
                      jnp.where(x == ord("C"), ord("G"),
                                jnp.where(x == ord("G"), ord("C"), x))),
        ).astype(jnp.uint8)

    seq = unpack_2bit_device(packed)[:flat_cap]
    if has_npos:
        if np_cap is None:
            np_cap = min(flat_cap, 32 * npos_buf.shape[0])
        pos, _cnt = decode_positions_device(npos_buf, npos_len, np_cap)
        tgt = jnp.where(pos >= 0, pos, flat_cap)
        seq = jnp.concatenate([seq, jnp.zeros(1, jnp.uint8)])
        seq = seq.at[tgt].set(ord("N"), mode="drop")[:flat_cap]
    if expand:
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
        seq = seq[:n]
    tok_cap, pos_cap, esc_cap = qualcol_caps or (None, None, None)
    qual = qualcol_decode_device(
        qual_buf, bins.shape[0], bins, major, n, qual_len,
        tok_cap=tok_cap, pos_cap=pos_cap, esc_cap=esc_cap,
    )
    if not has_npos and nbq < 128:
        seq = jnp.where(qual == nbq, jnp.uint8(ord("N")), seq)
    odd = (jnp.arange(b_cap) % 2 == 1)[:, None]
    seq_mat = seq[:n].reshape(b_cap, L)
    qual_mat = qual.reshape(b_cap, L)
    seq_mat = jnp.where(odd, comp(jnp.flip(seq_mat, axis=1)), seq_mat)
    qual_mat = jnp.where(odd, jnp.flip(qual_mat, axis=1), qual_mat)
    return seq_mat, qual_mat


def make_sharded_encode_step(mesh: Mesh, axis: str = "data"):
    """jit-compiled SPMD encode step: blocks sharded over the mesh's data
    axis, palette replicated, per-device stream lengths all-gathered so
    every participant knows the global container offsets."""

    def step(seqs, quals, xs, ys, bins, major, in_table):
        out = device_encode_block(
            seqs, quals, xs, ys, bins, major[0], in_table
        )
        # shard_map concatenates along a leading axis: lift scalars to (1,)
        out = {
            k: (v.reshape(1) if v.ndim == 0 else v) for k, v in out.items()
        }
        lens = jnp.stack(
            [out["qual_len"][0], out["npos_len"][0], out["x_len"][0],
             out["y_len"][0]]
        )
        # every device learns all stream lengths -> container offsets
        # without a host round-trip
        all_lens = jax.lax.all_gather(lens, axis)  # (n_dev, 4)
        qual_off = jnp.cumsum(all_lens[:, 0]) - all_lens[:, 0]
        return out, all_lens[None], qual_off[None]

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(), P()),
        out_specs=(
            {
                "n_esc": P(axis),
                "n_nonmajor": P(axis),
                "n_npos": P(axis),
                "packed": P(axis),
                "qual": P(axis),
                "qual_len": P(axis),
                "npos": P(axis),
                "npos_len": P(axis),
                "x": P(axis),
                "x_len": P(axis),
                "y": P(axis),
                "y_len": P(axis),
            },
            P(axis),
            P(axis),
        ),
    )
    return jax.jit(sharded)


def make_sharded_decode_step(mesh: Mesh, reads: int, read_len: int,
                             axis: str = "data"):
    """SPMD decode step: each device decodes its own chunk's streams
    (packed bases + qual + npos buffers sharded over the data axis,
    palette replicated) back to (reads, read_len) seq/qual blocks. The
    inverse of make_sharded_encode_step — together they cover the full
    multi-chip codec path."""

    def step(packed, qual_buf, qual_len, npos_buf, npos_len, bins, major):
        seq, qual = device_decode_block(
            packed[0], qual_buf[0], qual_len[0], npos_buf[0], npos_len[0],
            bins, major[0], reads, read_len,
        )
        return seq[None], qual[None]

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis)),
    )
    return jax.jit(sharded)


def make_sharded_rans_step(mesh: Mesh, lanes: int, out_cap: int,
                           axis: str = "data"):
    """SPMD .rfqz second-stage step: every device entropy-codes its own
    section with the interleaved-rANS kernel (sections are self-contained,
    format/rfqz.py, so section-parallelism IS the scaling axis of the
    second stage). Section byte sizes are all-gathered so every
    participant knows the container offsets without a host round trip."""
    from ..ops.rans_device import rans_encode_payload_device

    def step(data, freq_lut, cum_lut):
        out, lane_bytes, total = rans_encode_payload_device(
            data[0], freq_lut, cum_lut, lanes, 0, out_cap
        )
        totals = jax.lax.all_gather(total, axis)
        return out[None], lane_bytes[None], totals[None]

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    return jax.jit(sharded)


def shard_blocks(mesh: Mesh, arr: np.ndarray, axis: str = "data"):
    return jax.device_put(arr, NamedSharding(mesh, P(axis)))


def replicate(mesh: Mesh, arr: np.ndarray):
    return jax.device_put(arr, NamedSharding(mesh, P()))
