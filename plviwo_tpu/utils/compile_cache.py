"""One place that decides how the entry points compile: the persistent
compile cache's directory and the XLA:GPU compile flags.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it itself and this
module leaves it alone.  Otherwise the cache lives at a fixed directory
inside the checkout (`.jax_cache/`, git-ignored).  The path is part of the
cache key, so it is never derived from a temp name, a pid or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")

# XLA:GPU compile time dominates a cold start: a vmapped fused_frame takes
# minutes to build.  Without autotuning and Triton GEMMs the bench-shape
# fused_step_full compiled in 105 s instead of 168 s and track_frame in
# 27 s instead of 32 s, and 20 steady track_frame calls took 33.8 ms
# instead of 36.1 ms (H100 80GB HBM3, 700 W); the images-in bench at B=64
# runs ~9% slower (5839 vs 6405 frames/s, H100 80GB HBM3, 400 W).
# `bench.py`, `chip_smoke.py` and the run_sim / run_kaist entry points all
# compile under these flags.
GPU_XLA_FLAGS = ("--xla_gpu_autotune_level=0",
                 "--xla_gpu_enable_triton_gemm=false")


def set_gpu_xla_flags() -> str:
    """Add GPU_XLA_FLAGS to `XLA_FLAGS`, keeping every flag the caller set
    (a caller's value of the same flag wins).  XLA reads the variable when
    JAX starts its backend, so call this before the first device use.
    The flags only tune XLA:GPU; the CPU backend ignores them.  Returns the
    resulting `XLA_FLAGS`."""
    flags = os.environ.get("XLA_FLAGS", "").split()
    names = {f.split("=")[0] for f in flags}
    flags += [f for f in GPU_XLA_FLAGS if f.split("=")[0] not in names]
    os.environ["XLA_FLAGS"] = " ".join(flags)
    return os.environ["XLA_FLAGS"]


def cache_dir() -> str:
    """The directory the cache uses under the current environment."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def configure_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Point JAX at the cache (unless the env var already does) and only
    persist programs that took at least `min_compile_time_secs` to build.
    Returns the directory in use."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time_secs))
    return cache_dir()
