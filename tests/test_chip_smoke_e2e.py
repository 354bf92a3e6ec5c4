"""chip_smoke.py's e2e and four-device phases at tiny size on the CPU
backend (the four-device phase on four of the virtual CPU devices)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def small_chunks_on_device(monkeypatch):
    # tiny corpora: let chunks below the production window reach the device
    monkeypatch.setenv("REPAQ_DEVICE_MIN_BASES", "0")


def test_phase_e2e_tiny(tmp_path, small_chunks_on_device):
    cs.phase_e2e(str(tmp_path), pairs=2000)


def test_phase_four_on_virtual_devices(tmp_path, small_chunks_on_device):
    import jax

    cs.phase_four(jax, str(tmp_path), jax.devices()[:4], pairs=4000)
