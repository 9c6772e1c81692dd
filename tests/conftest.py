"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh (before any jax import) so the
sharding tests run everywhere. Numerical bit-exactness tests are
backend-independent.

``MYYUV_TEST_GPU=1`` leaves the platform to JAX instead, for the
``gpu``-marked tests on a machine with an NVIDIA card
(``MYYUV_TEST_GPU=1 python -m pytest -m gpu tests/``); without a card
those tests skip with a reason.
"""

import os
import subprocess
from pathlib import Path

if os.environ.get("MYYUV_TEST_GPU") != "1":
    # must happen before jax initializes its backends. Forced (not
    # setdefault): the suite runs on the deterministic 8-device virtual
    # CPU mesh whatever the ambient JAX_PLATFORMS says. Some installed
    # pytest plugins import jax before this conftest runs, baking the
    # ambient env into jax.config — so also update the imported config.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

    import sys

    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# persistent XLA compile cache: the heavier codec graphs (device entropy)
# compile once per shape, then every suite run reuses them
try:
    from myyuv_tpu.runtime import jaxcache  # noqa: E402

    jaxcache.enable()
except Exception:
    pass

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
IMAGES = REFERENCE / "images"
ORACLE = REPO / ".oracle" / "myyuv_cli"


def _ensure_oracle() -> bool:
    if ORACLE.exists():
        return True
    script = REPO / "tools" / "build_oracle.sh"
    if not script.exists() or not REFERENCE.exists():
        return False
    try:
        subprocess.run([str(script)], check=True, capture_output=True)
    except Exception:
        return False
    return ORACLE.exists()


@pytest.fixture(scope="session")
def oracle_cli():
    """Path to the compiled reference CLI; skips if unbuildable."""
    if not _ensure_oracle():
        pytest.skip("reference oracle CLI not available")
    return ORACLE


@pytest.fixture(scope="session")
def images_dir():
    if not IMAGES.exists():
        pytest.skip("reference golden images not available")
    return IMAGES


@pytest.fixture
def rng():
    """Function-scoped: every test sees the SAME deterministic stream
    regardless of which tests ran before (the session-scoped generator
    made test content depend on file ordering — two decode8 tests
    failed under a reordered run purely through content luck)."""
    return np.random.default_rng(0x1F1F)


def oracle_run(oracle_cli, *args):
    return subprocess.run([str(oracle_cli), *map(str, args)],
                          check=True, capture_output=True, text=True)
