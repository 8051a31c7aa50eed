"""Device checks for the measurement entry points (`bench.py`, `chip_smoke.py`).

A measurement that finds no GPU fails: it never falls back to the CPU.
The card's name and power limit come from `nvidia-smi` in a child process
that does not import JAX, so only the calling process holds the card.
"""

from __future__ import annotations

import shutil
import subprocess

NVIDIA_SMI_QUERY = ["--query-gpu=name,power.limit", "--format=csv,noheader"]


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    verbatim (one line per card)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: no NVIDIA card to report")
    out = subprocess.run([smi, *NVIDIA_SMI_QUERY], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_summary(devices) -> dict:
    """{"platform", "kind", "count"} of a JAX device list."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def require_gpu(n_devices: int = 1):
    """The JAX device list, or SystemExit unless it holds >= n GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {devs[0].platform!r} "
                         f"({devs[0].device_kind})")
    if len(devs) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    return devs
