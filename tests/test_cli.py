"""CLI surface tests via subprocess: flags, stdin/stdout, xz stage, verify
modes, compare JSON files, error paths and exit codes."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def run_cli(args, stdin=None, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-m", "repaq_tpu.cli", *args],
        input=stdin,
        capture_output=True,
        env=env,
        cwd=cwd,
    )


def test_roundtrip_cli(fixtures_dir, tmp_path):
    out = tmp_path / "a.rfq"
    dec = tmp_path / "a.fq"
    r = run_cli(["-c", "-i", str(fixtures_dir / "se_illumina.fq"), "-o", str(out)])
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == (fixtures_dir / "se_illumina.ref.rfq").read_bytes()
    r = run_cli(["-d", "-i", str(out), "-o", str(dec)])
    assert r.returncode == 0, r.stderr
    assert dec.read_bytes() == (fixtures_dir / "se_illumina.fq").read_bytes()


def test_stdin_stdout(fixtures_dir):
    data = (fixtures_dir / "se_illumina.fq").read_bytes()
    r = run_cli(["-c", "--stdin", "--stdout"], stdin=data)
    assert r.returncode == 0, r.stderr
    assert r.stdout == (fixtures_dir / "se_illumina.ref.rfq").read_bytes()
    # decompress from stdin to stdout
    r2 = run_cli(["-d", "--stdin", "--stdout"], stdin=r.stdout)
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout == data


def test_interleaved_stdin(fixtures_dir, tmp_path):
    r1 = (fixtures_dir / "pe_R1.fq").read_bytes().splitlines(keepends=True)
    r2 = (fixtures_dir / "pe_R2.fq").read_bytes().splitlines(keepends=True)
    inter = bytearray()
    for i in range(0, len(r1), 4):
        inter += b"".join(r1[i : i + 4])
        inter += b"".join(r2[i : i + 4])
    r = run_cli(["-c", "--stdin", "--interleaved_in", "--stdout"], stdin=bytes(inter))
    assert r.returncode == 0, r.stderr
    assert r.stdout == (fixtures_dir / "pe.ref.rfq").read_bytes()


@pytest.mark.skipif(shutil.which("xz") is None, reason="xz not installed")
def test_xz_roundtrip(fixtures_dir, tmp_path):
    out = tmp_path / "a.rfq.xz"
    r = run_cli(["-c", "-i", str(fixtures_dir / "se_illumina.fq"), "-o", str(out)])
    assert r.returncode == 0, r.stderr
    # the decompressed .xz payload must equal the reference .rfq
    raw = subprocess.run(["xz", "-d", "-c", str(out)], capture_output=True)
    assert raw.stdout == (fixtures_dir / "se_illumina.ref.rfq").read_bytes()
    dec = tmp_path / "a.fq"
    r = run_cli(["-d", "-i", str(out), "-o", str(dec)])
    assert r.returncode == 0, r.stderr
    assert dec.read_bytes() == (fixtures_dir / "se_illumina.fq").read_bytes()


def test_verify_mode(fixtures_dir, tmp_path):
    out = tmp_path / "v.rfq"
    r = run_cli(
        ["-c", "-i", str(fixtures_dir / "se_big.fq"), "-o", str(out), "-k", "100",
         "--verify"]
    )
    assert r.returncode == 0, r.stderr
    assert b"integrity check failure" not in r.stderr
    assert out.read_bytes() == (fixtures_dir / "se_big.ref.k100.rfq").read_bytes()


def test_compare_json_file(fixtures_dir, tmp_path):
    jf = tmp_path / "cmp.json"
    r = run_cli(
        ["-p", "-i", str(fixtures_dir / "se_big.fq"),
         "-r", str(fixtures_dir / "se_big.ref.k100.rfq"), "-j", str(jf)]
    )
    assert r.returncode == 0, r.stderr
    data = json.loads(jf.read_text())
    assert data["result"] == "passed"
    assert data["fastq_reads"] == 3000
    # stdout carries the same report (reference prints both)
    assert json.loads(r.stdout)["result"] == "passed"


def test_compare_failure_exit_code(fixtures_dir):
    r = run_cli(
        ["-p", "-i", str(fixtures_dir / "se_bgi.fq"),
         "-r", str(fixtures_dir / "se_illumina.ref.rfq")]
    )
    assert r.returncode == 1
    assert json.loads(r.stdout)["result"] == "failed"


@pytest.mark.parametrize(
    "args,msg",
    [
        (["-c"], b"Please specify input file"),
        (["-c", "-d", "-i", "x.fq", "-o", "y.rfq"], b"only choose any one mode"),
        (["-c", "-i", "nope.fq", "-o", "y.rfq"], b"Failed to open file"),
        (["-d", "-i", "in.fq", "-o", "out.fq"], b"should not be a FASTQ file"),
        (["-c", "-i", "in.fq", "-o", "out.rfq", "-k", "999999999"],
         b"chunk size cannot be greater"),
        (["-c", "-i", "lower.fq", "-o", "out.rfq"],
         b"doesn't support FASTQ with lowercase bases"),
        (["-c", "-i", "bigxy.fq", "-o", "out.rfq"],
         b"coordinate cannot be larger than 2M"),
    ],
)
def test_error_paths(tmp_path, args, msg):
    (tmp_path / "in.fq").write_bytes(b"@r\nACGT\n+\nFFFF\n")
    (tmp_path / "lower.fq").write_bytes(b"@r\nacgt\n+\nFFFF\n")
    (tmp_path / "bigxy.fq").write_bytes(
        b"@A1:2:FC:4:1101:2356:3000000 1:N:0:T\nACGT\n+\nFFFF\n"
    )
    r = run_cli(args, cwd=tmp_path)
    assert r.returncode != 0
    assert msg in r.stderr


def test_version():
    r = run_cli(["--version"])
    assert r.returncode == 0
    assert b"repaq-tpu" in r.stdout


def test_decompress_se_with_out2_rejected(fixtures_dir, tmp_path):
    r = run_cli(
        ["-d", "-i", str(fixtures_dir / "se_illumina.ref.rfq"),
         "-o", str(tmp_path / "a.fq"), "-O", str(tmp_path / "b.fq")]
    )
    assert r.returncode != 0
    assert b"single-end" in r.stderr


def test_gz_output(fixtures_dir, tmp_path):
    import gzip

    out = tmp_path / "a.fq.gz"
    r = run_cli(["-d", "-i", str(fixtures_dir / "se_illumina.ref.rfq"), "-o", str(out)])
    assert r.returncode == 0, r.stderr
    assert gzip.open(out, "rb").read() == (
        fixtures_dir / "se_illumina.fq"
    ).read_bytes()


def test_num_shards_concurrent(fixtures_dir, tmp_path):
    """Three concurrent shard processes; rank 0 waits for all parts then
    assembles — output must equal the golden reference bytes."""
    import subprocess
    import sys

    out = tmp_path / "sh.rfq"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repaq_tpu.cli", "-c",
             "-i", str(fixtures_dir / "se_big.fq"), "-o", str(out),
             "-k", "100", "--num_shards", "3", "--shard", str(pid)],
            env=dict(os.environ, PYTHONPATH=str(REPO)),
            stderr=subprocess.PIPE,
        )
        for pid in (1, 2, 0)  # rank 0 last-launched: must wait for others
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert out.read_bytes() == (
        fixtures_dir / "se_big.ref.k100.rfq"
    ).read_bytes()
    assert not list(tmp_path.glob("*.part*"))


@pytest.mark.parametrize("platform,want", [
    ("gpu", "device"), ("cpu", "vectorized"),
])
def test_auto_engine_selection(monkeypatch, platform, want):
    """get_engine('auto') takes the device engine exactly when JAX's
    default device is a GPU; REPAQ_ENGINE pins either engine."""
    from repaq_tpu import pipeline

    monkeypatch.delenv("REPAQ_ENGINE", raising=False)
    monkeypatch.setattr(pipeline, "_accelerator_platform", lambda: platform)
    assert pipeline.get_engine("auto").name == want
    for pinned in ("vectorized", "device"):
        monkeypatch.setenv("REPAQ_ENGINE", pinned)
        assert pipeline.get_engine("auto").name == pinned
    monkeypatch.setenv("REPAQ_ENGINE", "oracle")
    assert pipeline.get_engine("device").name == "device"


def test_auto_engine_pinned_cpu_starts_no_backend(monkeypatch):
    """JAX_PLATFORMS=cpu answers 'cpu' without asking JAX."""
    from repaq_tpu import pipeline

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert pipeline._accelerator_platform() == "cpu"
