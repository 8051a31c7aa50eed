"""`chip_smoke.py`, the GPU smoke test: it refuses to run without a GPU,
and its last stdout line has the shape the contract asks for.  The full run
needs the card (`pytest -m gpu`)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "chip_smoke.py"


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd, env_extra, *args, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(env_extra)
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py"), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _printed_result(stdout):
    return any(line.lstrip().startswith('{"ok"') for line in
               stdout.splitlines())


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_exits_nonzero_without_gpu(args):
    out = _run(REPO, {"JAX_PLATFORMS": "cpu"}, *args)
    assert out.returncode != 0
    assert not _printed_result(out.stdout), out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone_in_a_directory(tmp_path):
    """Without the rest of the repo the script cannot import the engine."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert not _printed_result(out.stdout)


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_result_line_shape():
    mod = _load()
    for n in (1, 4):
        line = json.dumps(mod.result_line([_Dev()] * n))
        assert json.loads(line) == {
            "ok": True,
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": n}}


@pytest.mark.gpu
def test_smoke_runs_on_the_gpu(gpu_card):
    out = _run(REPO, {}, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
