"""Test configuration: run everything on an 8-device virtual CPU mesh.

Sharding correctness is validated on `--xla_force_host_platform_device_count=8`
CPU devices; the multi-GPU path runs through `chip_smoke.py --four-cards`.
Tests that need the GPU carry the `gpu` marker and ask the `gpu_card`
fixture, which decides at run time (never at import) whether a card exists.
"""

import os
import shutil
import subprocess

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from plviwo_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

# persistent compile cache: cuts the suite's compile load across runs
configure_compile_cache(min_compile_time_secs=0.5)

import pytest  # noqa: E402

_test_counter = {"n": 0}


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA card is visible (asked of `nvidia-smi` in a
    child process, so this process never opens the card)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU visible to nvidia-smi")
    return out.stdout.strip()


@pytest.fixture(autouse=True)
def _periodic_jax_cache_clear(request):
    """XLA:CPU in this image crashes (SIGSEGV/abort inside compile) once a
    single process accumulates ~500 live compiled executables (reproduced at
    the ~125th fast test and after ~11 slow e2e tests).  Drop the in-memory
    executable caches every 25 fast tests and after EVERY slow test (each
    slow e2e compiles a whole pipeline); the persistent disk cache makes the
    re-loads cheap."""
    yield
    _test_counter["n"] += 1
    if request.node.get_closest_marker("slow") is not None:
        jax.clear_caches()
    elif _test_counter["n"] % 25 == 0:
        jax.clear_caches()
