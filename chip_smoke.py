#!/usr/bin/env python3
"""Smoke test of the device codec on NVIDIA GPUs, through the normal CLI.

    python chip_smoke.py          one GPU: kernels, goldens, e2e
    python chip_smoke.py --four   four GPUs: the --mesh_devices 4 path and
                                  the one-card output it is compared with

One process drives the card(s). Every phase compares bytes exactly (the
codec is integer-only): kernels against the host kernels in
repaq_tpu.codec.kernels_np, CLI output against the reference encoder's
goldens and against the host engine, roundtrips against the input. Any
failure raises, so the script exits non-zero and prints no result; it also
refuses to run when JAX's default device is not a GPU or when the
repaq_tpu package is not beside this file. The last line of a passing run
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Rates printed here are smoke readings, not benchmarks.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_SIZES = (1 << 20, 12 << 20)  # bucketed 1 Mbase (-k 1000) and 12 Mbase
E2E_PAIRS = 1_000_000

# (inputs, golden, -k) for every reference-encoded golden in tests/fixtures
GOLDENS = [
    (("se_illumina.fq",), "se_illumina.ref.rfq", 1000),
    (("se_bgi.fq",), "se_bgi.ref.rfq", 1000),
    (("se_nonl.fq",), "se_nonl.ref.rfq", 1000),
    (("se_varlen.fq",), "se_varlen.ref.rfq", 1000),
    (("se_crlf.fq",), "se_crlf.ref.rfq", 1000),
    (("se_big.fq",), "se_big.ref.k100.rfq", 100),
    (("se_manyq.fq",), "se_manyq.ref.k100.rfq", 100),
    (("se_fewn.fq",), "se_fewn.ref.k100.rfq", 100),
    (("se_big_nonl.fq",), "se_big_nonl.ref.k100.rfq", 100),
    (("pe_R1.fq", "pe_R2.fq"), "pe.ref.rfq", 1000),
    (("pe_nov_R1.fq", "pe_nov_R2.fq"), "pe_nov.ref.rfq", 1000),
    (("pe_big_R1.fq", "pe_big_R2.fq"), "pe_big.ref.k100.rfq", 100),
    (("pe_nl1.fq", "pe_nl2.fq"), "pe_nl.ref.rfq", 100),
]

CARD = "card not queried"


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, seconds: float, extra: str = "") -> None:
    """Every time is printed beside the card it was taken on."""
    log("  %-44s %10.3f ms%s  [%s]" % (label, seconds * 1e3, extra, CARD))


def query_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def import_package():
    if not os.path.isdir(os.path.join(REPO, "repaq_tpu")):
        raise SystemExit("chip_smoke.py: the repaq_tpu package is not "
                         "beside this script")
    sys.path.insert(0, REPO)
    import repaq_tpu  # noqa: F401


def require_platform(jax, platform: str, count: int) -> list:
    devs = jax.devices()
    if devs[0].platform != platform:
        raise SystemExit("chip_smoke.py needs a %s; JAX's default device "
                         "is %r" % (platform.upper(), devs[0].platform))
    if len(devs) < count:
        raise SystemExit("chip_smoke.py needs %d devices, JAX has %d"
                         % (count, len(devs)))
    return devs[:count]


# ---------------------------------------------------------------------------
# phase 1: kernels
# ---------------------------------------------------------------------------


def nova_bases(n: int, seed: int):
    """NovaSeq-shaped seq/qual bytes: 4-bin quality, ~0.2% N with '#'."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    qual = rng.choice(np.frombuffer(b"FFF:FFF,F:", np.uint8), size=n)
    nmask = rng.random(n) < 0.002
    seq[nmask] = ord("N")
    qual[nmask] = ord("#")
    return seq, qual


def _median_run(jax, exe, args, reps: int = 7) -> float:
    jax.block_until_ready(exe(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _compile(jax, fn, args):
    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


def _bound(nbytes: int) -> str:
    return " (bytes/3.35TB/s = %.3f ms)" % (nbytes / HBM_BYTES_PER_S * 1e3)


def _stream_reference(qual, bins, major):
    """A real by-column qual stream plus its token starts from the host
    kernels: lens per byte, forced restarts at bin-stream starts."""
    from repaq_tpu.codec import kernels_np as K

    buf = K.encode_qual_by_col(qual, bins, major)
    nb = bins.shape[0]
    seg_lens = buf[: 4 * nb].view("<u4").astype(np.int64)
    stream = buf[4 * nb : 4 * nb + int(seg_lens.sum())]
    lens = K._stream_token_lens(stream).astype(np.int32)
    force = np.zeros(stream.shape[0], bool)
    want = []
    off = 0
    for ln in seg_lens:
        if ln:
            force[off] = True
            seg = stream[off : off + ln]
            want.append(K._token_starts(seg, K._stream_token_lens(seg)) + off)
        off += int(ln)
    return lens, force, np.concatenate(want)


def phase_kernels(jax, sizes=KERNEL_SIZES):
    """Each device kernel of the codec's hot path, compiled for the card,
    compared exactly with kernels_np and timed (median of 7 warm runs):
    the elementwise front end, base unpack and decode token FSM, all plain
    JAX that XLA compiles."""
    import jax.numpy as jnp

    from repaq_tpu.codec import kernels_np as K
    from repaq_tpu.ops import device_streams as D

    bins = np.frombuffer(b"#,:", np.uint8)
    major = ord("F")
    lut = np.full(256, len(bins), np.uint8)
    lut[bins] = np.arange(len(bins))
    lut[major] = len(bins) + 1
    log("phase kernels")
    for n in sizes:
        seq, qual = nova_bases(n, seed=n)
        args = (jax.device_put(seq.view("<u4")),
                jax.device_put(qual.view("<u4")),
                jax.device_put(bins), jnp.uint8(major))
        exe, cs = _compile(jax, D.encode_frontend_meta32, args)
        packed, meta = exe(*args)
        assert np.asarray(packed).tobytes() == K.pack_2bit(seq).tobytes(), \
            "frontend packed differs at %d" % n
        want_meta = lut[qual] | ((seq == ord("N")).astype(np.uint8) << 7)
        assert np.asarray(meta).view(np.uint8).tobytes() == \
            want_meta.tobytes(), "frontend meta differs at %d" % n
        timed("frontend n=%d (compile %.2fs)" % (n, cs),
              _median_run(jax, exe, args), _bound(2 * n + n // 4 + n))

        packed = K.pack_2bit(seq)
        pd = jax.device_put(packed)
        exe, cs = _compile(jax, D.unpack_2bit_device, (pd,))
        assert np.asarray(exe(pd)).tobytes() == \
            K.unpack_2bit(packed, n).tobytes(), "unpack differs at %d" % n
        timed("unpack n=%d (compile %.2fs)" % (n, cs),
              _median_run(jax, exe, (pd,)), _bound(n // 4 + n))

        lens, force, want_starts = _stream_reference(qual, bins, major)
        args = (jax.device_put(lens), jax.device_put(force))
        exe, cs = _compile(jax, D.token_start_mask, args)
        got = np.flatnonzero(np.asarray(exe(*args)))
        assert np.array_equal(got, want_starts), \
            "token FSM differs at stream %d" % lens.shape[0]
        timed("token FSM m=%d (compile %.2fs)" % (lens.shape[0], cs),
              _median_run(jax, exe, args), _bound(5 * lens.shape[0]))


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


# ---------------------------------------------------------------------------
# CLI helpers
# ---------------------------------------------------------------------------


class EngineLog:
    """Captures every engine the CLI creates, for its stats, compile
    seconds and compiled executables."""

    def __init__(self):
        self.engines = []

    @contextlib.contextmanager
    def capture(self):
        from repaq_tpu import pipeline

        orig = pipeline.get_engine

        def get_engine(name="auto"):
            cfg = orig(name)
            self.engines.append(cfg)
            return cfg

        with _patched(pipeline, "get_engine", get_engine):
            yield

    def last_device(self):
        cfg = self.engines[-1]
        assert cfg.name == "device", cfg.name
        return cfg.encode_chunk.__self__


def cli(argv, elog: EngineLog | None = None) -> float:
    from repaq_tpu import cli as _cli

    t0 = time.perf_counter()
    with (elog.capture() if elog else contextlib.nullcontext()):
        rc = _cli.main(list(argv))
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError("repaq %s exited %r" % (" ".join(argv), rc))
    return dt


def same_file(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# phase 2: goldens
# ---------------------------------------------------------------------------


def phase_goldens(tmp: str) -> None:
    """Every reference golden through the CLI with --engine device and
    REPAQ_DEVICE_MIN_BASES=0, so the small chunks reach the device."""
    import glob

    listed = {g for _i, g, _k in GOLDENS}
    found = {os.path.basename(p)
             for p in glob.glob(os.path.join(FIXTURES, "*.ref*.rfq"))}
    assert found == listed, "goldens not covered: %s" % (found ^ listed)
    log("phase goldens")
    with _env("REPAQ_DEVICE_MIN_BASES", "0"):
        for inputs, golden, kb in GOLDENS:
            plain = []
            for name in inputs:
                dst = os.path.join(tmp, name)
                with gzip.open(os.path.join(FIXTURES, name + ".gz")) as src, \
                        open(dst, "wb") as out:
                    shutil.copyfileobj(src, out)
                plain.append(dst)
            ref = os.path.join(FIXTURES, golden)
            out = os.path.join(tmp, "g.rfq")
            io = ["-i", plain[0]] + (["-I", plain[1]] if len(plain) > 1
                                     else [])
            elog = EngineLog()
            cli(["-c", "--engine", "device", "-k", str(kb), "-o", out] + io,
                elog)
            enc = elog.last_device().stats
            assert same_file(out, ref), "%s: device .rfq differs" % golden
            back = [os.path.join(tmp, "g%d.fq" % i)
                    for i in range(len(plain))]
            host = [os.path.join(tmp, "h%d.fq" % i)
                    for i in range(len(plain))]
            outs = ["-o", back[0]] + (["-O", back[1]] if len(back) > 1
                                      else [])
            cli(["-d", "--engine", "device", "-i", ref] + outs, elog)
            dec = elog.last_device().stats
            houts = ["-o", host[0]] + (["-O", host[1]] if len(host) > 1
                                       else [])
            cli(["-d", "--engine", "vectorized", "-i", ref] + houts)
            for got, h, src in zip(back, host, plain):
                assert same_file(got, h), "%s: device decode != host" % golden
                with open(src, "rb") as f:
                    crlf = b"\r" in f.read()
                # CRLF input decodes to LF records, as in the reference
                assert crlf or same_file(got, src), \
                    "%s: roundtrip differs" % golden
            log("  %-26s -k %-5d identical; encode chunks device/host "
                "%d/%d, decode %d/%d" % (
                    golden, kb, enc["device_chunks"], enc["host_chunks"],
                    dec["device_decodes"], dec["host_decodes"]))
            for p in plain + back + host + [out]:
                os.unlink(p)


# ---------------------------------------------------------------------------
# phase 3: e2e on a NovaSeq-shaped PE corpus
# ---------------------------------------------------------------------------


def make_corpus(tmp: str, pairs: int):
    sys.path.insert(0, REPO)
    import bench

    t0 = time.perf_counter()
    f1, f2, total = bench.make_dataset(tmp, pairs=pairs)
    log("corpus: %d pairs 2x%d, %.1f MB FASTQ, made in %.1f s" % (
        pairs, bench.READ_LEN, total / 1e6, time.perf_counter() - t0))
    return f1, f2, total


def _report_engine(eng, label: str) -> None:
    log("  %s stats: %s" % (label, json.dumps(eng.stats, sort_keys=True)))
    for key, sec in eng.compile_seconds.items():
        log("    compile %-8s %7.2f s  [%s]" % (key[0], sec, CARD))
    for cache in (eng._enc_cache, eng._dec_cache):
        for key, exe in cache.items():
            if key[0] == "qstats":
                continue
            m = exe.memory_analysis()
            log("    memory %-8s args %d out %d temp %d code %d bytes" % (
                key[0], m.argument_size_in_bytes, m.output_size_in_bytes,
                m.temp_size_in_bytes, m.generated_code_size_in_bytes))


def phase_e2e(tmp: str, pairs: int = E2E_PAIRS) -> None:
    """The PE corpus through the CLI with --engine device: .rfq at the
    default -k and at -k 12000 (cold, then warm), byte-compared with the
    host engine's .rfq and md5-roundtripped; .rfqz at -k 12000 (its own
    default, 16000, exceeds the device's 12 Mbase chunk window). No chunk
    may take the host path."""
    ks = (1000, 12000)
    rfqz_k = 12000
    log("phase e2e")
    f1, f2, total = make_corpus(tmp, pairs)
    want = (md5(f1), md5(f2))
    o1, o2 = os.path.join(tmp, "o1.fq"), os.path.join(tmp, "o2.fq")

    def roundtrip_ok():
        got = (md5(o1), md5(o2))
        assert got == want, "roundtrip md5 %s != %s" % (got, want)
        os.unlink(o1)
        os.unlink(o2)

    for k in ks:
        host = os.path.join(tmp, "host.rfq")
        dev = os.path.join(tmp, "dev.rfq")
        th = cli(["-c", "--engine", "vectorized", "-k", str(k),
                  "-i", f1, "-I", f2, "-o", host])
        runs = {}
        for direction, argv in (
            ("compress", ["-c", "-k", str(k), "-i", f1, "-I", f2,
                          "-o", dev]),
            ("decompress", ["-d", "-i", dev, "-o", o1, "-O", o2]),
        ):
            for temp in ("cold", "warm"):
                elog = EngineLog()
                dt = cli(argv[:1] + ["--engine", "device"] + argv[1:], elog)
                eng = elog.last_device()
                runs[direction, temp] = dt
                if direction == "compress":
                    assert eng.stats["host_chunks"] == 0, eng.stats
                    assert same_file(dev, host), \
                        ".rfq -k %d differs from the host engine's" % k
                else:
                    assert eng.stats["host_decodes"] == 0, eng.stats
                    roundtrip_ok()
                if temp == "cold":
                    _report_engine(eng, "%s -k %d" % (direction, k))
        thd = cli(["-d", "--engine", "vectorized", "-i", host,
                   "-o", o1, "-O", o2])
        roundtrip_ok()
        log("  .rfq -k %d: %.1f MB, identical to host engine, md5 "
            "roundtrip ok" % (k, os.path.getsize(dev) / 1e6))
        timed("host engine compress -k %d" % k, th,
              "  %.1f MB/s" % (total / 1e6 / th))
        timed("host engine decompress -k %d" % k, thd,
              "  %.1f MB/s" % (total / 1e6 / thd))
        for (direction, temp), dt in runs.items():
            timed("device %s %s -k %d" % (direction, temp, k), dt,
                  "  %.1f MB/s (smoke reading)" % (total / 1e6 / dt))
        os.unlink(host)
        os.unlink(dev)

    z = os.path.join(tmp, "dev.rfqz")
    elog = EngineLog()
    dt = cli(["-c", "--engine", "device", "-k", str(rfqz_k), "-i", f1,
              "-I", f2, "-o", z], elog)
    assert elog.last_device().stats["host_chunks"] == 0
    timed(".rfqz compress -k %d" % rfqz_k, dt,
          "  %.1f MB/s, %.1f MB (smoke reading)" % (
              total / 1e6 / dt, os.path.getsize(z) / 1e6))
    dt = cli(["-d", "--engine", "device", "-i", z, "-o", o1, "-O", o2], elog)
    assert elog.last_device().stats["host_decodes"] == 0
    roundtrip_ok()
    timed(".rfqz decompress -k %d" % rfqz_k, dt,
          "  %.1f MB/s, md5 roundtrip ok (smoke reading)" % (
              total / 1e6 / dt))
    for p in (f1, f2, z):
        os.unlink(p)


# ---------------------------------------------------------------------------
# phase 4 (--four): the mesh path on four devices
# ---------------------------------------------------------------------------


def phase_four(jax, tmp: str, devices, pairs: int = E2E_PAIRS) -> None:
    """--mesh_devices 4 compress and decompress of the e2e corpus, compared
    with the one-device --engine device output of the same run."""
    from repaq_tpu.parallel import mesh_engine

    log("phase four (%d devices)" % len(devices))
    f1, f2, total = make_corpus(tmp, pairs)
    one = os.path.join(tmp, "one.rfq")
    mesh = os.path.join(tmp, "mesh.rfq")
    dt1 = cli(["-c", "--engine", "device", "-i", f1, "-I", f2, "-o", one])
    stats = {}

    def keep(fn, name):
        def wrapped(*a, **kw):
            stats[name] = fn(*a, **kw)
            return stats[name]
        return wrapped

    n = str(len(devices))
    with _patched(mesh_engine, "compress_pe_mesh",
                  keep(mesh_engine.compress_pe_mesh, "compress")), \
            _patched(mesh_engine, "decompress_se_mesh",
                     keep(mesh_engine.decompress_se_mesh, "decompress")):
        dtc = cli(["-c", "--engine", "device", "--mesh_devices", n,
                   "-i", f1, "-I", f2, "-o", mesh])
        o1, o2 = os.path.join(tmp, "o1.fq"), os.path.join(tmp, "o2.fq")
        dtd = cli(["-d", "--engine", "device", "--mesh_devices", n,
                   "-i", mesh, "-o", o1, "-O", o2])
    log("  mesh stats: %s" % json.dumps(stats, sort_keys=True))
    for direction in ("compress", "decompress"):
        assert stats[direction]["mesh_batches"] > 0, stats
        assert stats[direction]["fallback_chunks"] == 0, stats
    assert same_file(mesh, one), "4-device .rfq differs from 1-device .rfq"
    assert (md5(o1), md5(o2)) == (md5(f1), md5(f2)), "mesh roundtrip md5"
    log("  4-device .rfq identical to the 1-device output; md5 roundtrip ok")
    for d in devices:
        mem = d.memory_stats() or {}  # the CPU backend reports none
        log("  %s bytes_in_use %s peak_bytes_in_use %s" % (
            d, mem.get("bytes_in_use", "not reported"),
            mem.get("peak_bytes_in_use", "not reported")))
    timed("1-device compress (cold)", dt1,
          "  %.1f MB/s (smoke reading)" % (total / 1e6 / dt1))
    timed("%s-device mesh compress (cold)" % n, dtc,
          "  %.1f MB/s (smoke reading)" % (total / 1e6 / dtc))
    timed("%s-device mesh decompress (cold)" % n, dtd,
          "  %.1f MB/s (smoke reading)" % (total / 1e6 / dtd))


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device mesh path and the "
                    "1-device output it is compared with")
    args = ap.parse_args(argv)
    import_package()
    import jax

    count = 4 if args.four else 1
    devices = require_platform(jax, "gpu", count)
    CARD = query_card()
    from repaq_tpu.codec import _native

    log("card: %s" % CARD)
    log("jax %s; %d device(s) of %s; native host library loaded: %s" % (
        jax.__version__, len(jax.devices()), devices[0].device_kind,
        _native.available()))
    tmp = tempfile.mkdtemp(prefix="repaq_smoke_")
    try:
        if args.four:
            phase_four(jax, tmp, devices)
        else:
            phase_kernels(jax)
            phase_goldens(tmp)
            phase_e2e(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
