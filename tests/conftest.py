import gzip
import os
import shutil
import sys
from pathlib import Path

# Tests run on the CPU backend with a deterministic 8-device virtual mesh,
# whatever JAX_PLATFORMS says. REPAQ_TEST_GPU=1 opts in to the GPU, for
# the `gpu`-marked tests on a card. jax.config is set as well as the
# environment, in case jax was imported before this file.
os.environ["JAX_PLATFORMS"] = (
    "cuda" if os.environ.get("REPAQ_TEST_GPU") == "1" else "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
try:
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
except ImportError:
    pass

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pytest

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures_dir(tmp_path_factory):
    """Fixture inputs decompressed into a session temp dir."""
    out = tmp_path_factory.mktemp("fx")
    for gz in FIXTURES.glob("*.fq.gz"):
        plain = out / gz.name[:-3]
        with gzip.open(gz, "rb") as src, open(plain, "wb") as dst:
            shutil.copyfileobj(src, dst)
        shutil.copy(gz, out / gz.name)
    for rfq in FIXTURES.glob("*.rfq"):
        shutil.copy(rfq, out / rfq.name)
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU as JAX's default device "
        "(skips elsewhere; run with REPAQ_TEST_GPU=1 pytest -m gpu)")


@pytest.fixture
def gpu():
    """The JAX GPU device; skips, at run time, where there is none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; JAX's default device is %r" % dev.platform)
    return dev
