"""chip_smoke.py: refuses to run off a GPU or without the package, and its
phase functions pass at tiny size on the CPU backend. The `gpu`-marked
tests run the same phases at full size on a card."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run_alone(script_dir, env_platforms="cpu"):
    env = dict(os.environ, JAX_PLATFORMS=env_platforms)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
    )


def test_refuses_cpu_platform():
    r = _run_alone(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_refuses_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_alone(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_kernels_tiny():
    import jax

    cs.phase_kernels(jax, sizes=(4096, 3 << 12))


def test_phase_goldens(tmp_path):
    cs.phase_goldens(str(tmp_path))


@pytest.mark.gpu
def test_kernels_on_gpu(gpu):
    import jax

    cs.CARD = cs.query_card()
    cs.phase_kernels(jax)


@pytest.mark.gpu
def test_goldens_on_gpu(gpu, tmp_path):
    cs.CARD = cs.query_card()
    cs.phase_goldens(str(tmp_path))
