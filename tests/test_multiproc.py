"""2-process jax.distributed smoke test (VERDICT round-1 item 4 tail): the
batched full step executes over a cross-process global mesh with a real
collective metric reduction, and each process's shard matches its
single-device reference exactly."""

import json
import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_two_process_distributed_step():
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"  # 1 local device per process, 2 global
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "plviwo_tpu.parallel.multiproc_worker"]
    port = "45981"
    procs = [
        subprocess.Popen(cmd + [str(i), "2", port], cwd=repo, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append((p.returncode, out))
    for rc, out in outs:
        lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
        assert rc == 0 and lines, f"worker failed: {out[-2000:]}"
        res = json.loads(lines[-1])
        assert res["global_devices"] == 2
        assert res["shard_equal"], res
        assert res["accepted"] > 0 and res["rows"] > 0, res
