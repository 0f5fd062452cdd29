"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set the env vars before the JAX backend initializes (SURVEY.md section
4: virtual devices test distributed code without a cluster).  Tests marked
``gpu`` need a CUDA device: run them on the card with

    BIOINFO1_TEST_GPU=1 python -m pytest -m gpu tests/test_band.py

which leaves JAX on its default backend; everywhere else they skip.
"""

import os
import subprocess
import sys

ON_GPU = bool(os.environ.get("BIOINFO1_TEST_GPU"))
if not ON_GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The adaptive-band cache is perf-only cross-run state; tests assert on
# adaptation behavior (band retries, growth) and must start cold.
os.environ["BIOINFO1_BAND_CACHE"] = "0"

import jax  # noqa: E402

if not ON_GPU:
    # Pin the virtual-device CPU backend before first backend use, whatever
    # accelerator plugin is installed.
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is dominated by XLA CPU compiles;
# cached reruns take seconds.
from bioinfo1_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache(0.0)

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_DIR = os.environ.get("REFERENCE_DIR", "/root/reference")
ORACLE_BIN = os.path.join(REPO, "build", "reference_mapper")


def _ensure_oracle() -> str:
    """Build the reference C++ binary once per session (skip if impossible)."""
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference sources not available")
    if not os.path.exists(ORACLE_BIN):
        try:
            subprocess.run(
                [os.path.join(REPO, "tools", "build_reference_oracle.sh")],
                check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            pytest.skip(f"cannot build reference oracle: {e}")
    return ORACLE_BIN


@pytest.fixture(scope="session")
def oracle_bin() -> str:
    return _ensure_oracle()


def run_oracle(oracle_bin, args, cwd=None):
    """Run the reference binary single-threaded (deterministic output order)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([oracle_bin] + args, capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=600)
    return proc


@pytest.fixture
def gpu():
    """Skip unless JAX sees a CUDA device.  Decided here, at run time - never
    at import - so every test worker collects the same tests."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs a GPU (run with BIOINFO1_TEST_GPU=1 on the card)")
