"""Multi-host compression over jax.distributed collectives.

This is the multi-host transport for the byte-range sharding mechanism in
parallel/distributed.py (SURVEY §2.2 comm-backend row): instead of part
FILES on a shared filesystem, every process encodes its contiguous chunk
range in memory and the variable-length encoded bytes travel to the writer
process over the jax.distributed process group (NCCL across GPU hosts,
TCP on the CPU test mesh) with an ORDERED gather — rank order equals chunk
order, so the writer emits header + parts in gather order and the output
is byte-identical to the serial pipeline.

Design (mirrors the reference's single-writer container, main.cpp:134-159,
with the pipeline's no-communication header rule):
- no header broadcast: the header is a pure function of chunk 1, each rank
  recomputes it bit-identically (distributed.py:62-74)
- the only collectives are (1) an all-gather of part LENGTHS (fixed shape)
  and (2) slab-wise all-gathers of the padded part payloads — bounded
  memory regardless of part size
- fail-fast: any rank's exception kills the job (reference error_exit
  semantics)

Tested on a 2-process x 4-virtual-CPU-device mesh in
tests/test_jaxdist.py; the same code initializes across real hosts
(jax.distributed.initialize is backend-agnostic).
"""

from __future__ import annotations

import io as _io

import numpy as np

from ..pipeline import EngineConfig, get_engine
from . import distributed as dist

_SLAB = 8 << 20  # per-round gather payload per process


def _encode_my_part(
    in1: str,
    in2: str,
    chunk_size: int,
    num_processes: int,
    process_id: int,
    engine: EngineConfig,
    is_pe: bool,
    interleaved: bool,
    workers: int,
) -> tuple[bytes, bytes]:
    """(header_bytes, my encoded part bytes) — local work; the SE plan is
    rank-sharded over the process group (each rank scans ~1/R of the
    bytes; VERDICT r3 #6), with the replicated planner as the quirk-input
    fallback."""
    if is_pe:
        plan = dist.plan_pair_chunks(in1, in2, chunk_size, interleaved)
        header = dist.derive_header_pe(in1, in2, chunk_size, engine,
                                       interleaved)
    else:
        plan = None
        if num_processes > 1:
            from jax.experimental import multihost_utils

            plan = dist.plan_chunks_sharded(
                in1, chunk_size, num_processes, process_id,
                multihost_utils.process_allgather,
            )
        if plan is None:
            plan = dist.plan_chunks(in1, chunk_size)
        header = dist.derive_header(in1, chunk_size, engine)
    header_bytes = header.to_bytes()
    lo, hi = dist.partition(len(plan), num_processes)[process_id]
    buf = _io.BytesIO()
    if is_pe:
        dist.encode_pair_chunk_range(
            in1, in2, plan, lo, hi, header, header_bytes, buf, engine,
            workers, interleaved,
        )
    else:
        dist.encode_chunk_range(
            in1, plan, lo, hi, header, header_bytes, buf, engine,
            chunk_size, workers,
        )
    return header_bytes, buf.getvalue()


def gather_parts_ordered(part: bytes, num_processes: int,
                         process_id: int, out=None) -> int:
    """All ranks contribute their part; rank 0 writes them to ``out`` in
    rank order. Slab-wise so peak memory is O(num_processes * _SLAB), not
    O(total). Returns total bytes written (0 on non-writer ranks).

    The gather is jax.experimental.multihost_utils.process_allgather —
    a psum-of-one-hot under jit, riding the device interconnect on real
    hardware.
    """
    from jax.experimental import multihost_utils

    my_len = np.array([len(part)], dtype=np.int64)
    lens = multihost_utils.process_allgather(my_len).reshape(-1)
    max_len = int(lens.max())
    total = 0
    rounds = max(1, (max_len + _SLAB - 1) // _SLAB)
    mv = memoryview(part)
    for r in range(rounds):
        s = r * _SLAB
        slab = np.zeros(_SLAB, dtype=np.uint8)
        piece = mv[s : s + _SLAB]
        if len(piece):
            slab[: len(piece)] = np.frombuffer(piece, dtype=np.uint8)
        gathered = multihost_utils.process_allgather(slab)  # (nproc, _SLAB)
        if process_id == 0 and out is not None:
            for pid in range(num_processes):
                take = min(max(int(lens[pid]) - s, 0), _SLAB)
                if take:
                    # parts are streamed rank-major per slab round; the
                    # writer seeks so rank order == byte order
                    out.seek(_part_offset(lens, pid) + s)
                    out.write(gathered[pid, :take].tobytes())
                    total += take
    return total


def _part_offset(lens: np.ndarray, pid: int) -> int:
    return int(lens[:pid].sum())


def compress_distributed_jax(
    in1: str,
    out1: str,
    in2: str = "",
    chunk_size: int = 1_000_000,
    engine: EngineConfig | None = None,
    is_pe: bool = False,
    interleaved: bool = False,
    workers: int = 1,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timings: dict | None = None,
) -> None:
    """Full multi-process compress with jax.distributed transport.

    When coordinator/num_processes/process_id are given, initializes the
    process group here (idempotent if the caller already did). Rank 0
    writes ``out1``; other ranks write nothing. ``timings`` (optional
    dict) receives the phase split: plan+encode seconds, gather seconds,
    part bytes — the transport-overhead measurement the scaling bench
    reports at real part sizes.
    """
    import time as _time

    import jax

    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    num_processes = num_processes or jax.process_count()
    process_id = process_id if process_id is not None else jax.process_index()
    engine = engine or get_engine()

    t0 = _time.time()
    header_bytes, part = _encode_my_part(
        in1, in2, chunk_size, num_processes, process_id, engine, is_pe,
        interleaved, workers,
    )
    if timings is not None:
        timings["encode_s"] = _time.time() - t0
        timings["part_bytes"] = len(part)
        # separate rank-skew wait from transport: the first collective
        # blocks until the slowest rank arrives, so on a time-shared box
        # (or with any encode imbalance) it would otherwise be booked as
        # gather time. A zero-byte barrier absorbs the skew here.
        t0 = _time.time()
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("repaq_gather_start")
        timings["sync_s"] = _time.time() - t0
        t0 = _time.time()
    if process_id == 0:
        with open(out1, "wb") as f:
            f.write(header_bytes)
            base = len(header_bytes)

            class _Shifted:
                """File view whose offset 0 is the end of the header."""

                def seek(self, pos):
                    f.seek(base + pos)

                def write(self, b):
                    return f.write(b)

            gather_parts_ordered(part, num_processes, 0, _Shifted())
    else:
        gather_parts_ordered(part, num_processes, process_id, None)
    if timings is not None:
        timings["gather_s"] = _time.time() - t0
