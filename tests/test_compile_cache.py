"""The compile-configuration helpers (utils/compile_cache.py): for the
cache the env var wins and the fallback is a fixed, git-ignored directory
inside the checkout; the GPU XLA flags add to, never override, the
caller's."""

from pathlib import Path

import jax
import pytest

from plviwo_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_var_is_left_alone(monkeypatch, restore_cache_config, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    used = compile_cache.configure_compile_cache(min_compile_time_secs=2.0)
    assert used == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0


def test_fallback_is_fixed_inside_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    used = compile_cache.configure_compile_cache()
    assert used == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR
    path = Path(used)
    assert path.parent == REPO and path.name == ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    assert compile_cache.cache_dir() == used


@pytest.mark.parametrize("caller, expected", [
    (None, list(compile_cache.GPU_XLA_FLAGS)),
    ("--xla_force_host_platform_device_count=8",
     ["--xla_force_host_platform_device_count=8",
      *compile_cache.GPU_XLA_FLAGS]),
    ("--xla_gpu_autotune_level=4",
     ["--xla_gpu_autotune_level=4", "--xla_gpu_enable_triton_gemm=false"]),
])
def test_gpu_xla_flags_keep_the_callers(monkeypatch, caller, expected):
    if caller is None:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    else:
        monkeypatch.setenv("XLA_FLAGS", caller)
    assert compile_cache.set_gpu_xla_flags().split() == expected
    # idempotent: a second entry point in the same process adds nothing
    assert compile_cache.set_gpu_xla_flags().split() == expected
