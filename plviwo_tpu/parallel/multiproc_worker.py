"""Multi-process distributed worker (SURVEY.md section 5.8 / BASELINE
scaling path): each process owns one device of a global `jax.distributed`
mesh, runs its shard of the batched full PL-VIWO step, and the metric
reduction rides a real cross-process collective (Gloo on CPU; NCCL across
GPUs — same program).

Usage (launched by tests/test_multiproc.py, 2 processes):
    python -m plviwo_tpu.parallel.multiproc_worker <pid> <nprocs> <port>

Prints one JSON line: {"pid", "global_devices", "accepted", "rows",
"shard_equal": bool} — shard_equal asserts the globally-sharded execution
matches this process's single-device reference bit-exactly.
"""

from __future__ import annotations

import json
import os
import sys


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nprocs,
        process_id=pid)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from __graft_entry__ import (
        SIGMA_LINE, WHEEL_NOISE, _batch_args, _example_inputs_full)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from plviwo_tpu.parallel.replay import batched_full_step

    B = nprocs  # one sequence per process/device
    args = _example_inputs_full()
    b = _batch_args(args, B, n_batched=16)
    gravity, sigmas = b[17], b[18]

    mesh = Mesh(np.array(jax.devices()), ("dp",))
    sh = NamedSharding(mesh, P("dp"))

    def to_global(x):
        x = np.asarray(x)
        local = x[pid : pid + 1]
        return jax.make_array_from_process_local_data(sh, local, x.shape)

    gstate = jax.tree.map(to_global, b[0])
    gargs = [to_global(a) for a in b[1:17]]

    @jax.jit
    def step(st, *a):
        ns, m = batched_full_step(
            st, *a, gravity, sigmas, 1.0, 1.0, SIGMA_LINE, WHEEL_NOISE,
            model=0, window_size=1.0)
        # cross-shard (cross-process) reduction -> real collective
        return ns.p, {k: jnp.sum(v) for k, v in m.items()}

    p, agg = step(gstate, *gargs)
    jax.block_until_ready(p)
    agg = {k: float(v) for k, v in agg.items()}

    # single-device local reference on this process's own shard
    local_state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[pid : pid + 1]),
                               b[0])
    local_args = [jnp.asarray(np.asarray(a)[pid : pid + 1]) for a in b[1:17]]
    ref, _ = jax.jit(lambda st, *a: batched_full_step(
        st, *a, gravity, sigmas, 1.0, 1.0, SIGMA_LINE, WHEEL_NOISE,
        model=0, window_size=1.0))(local_state, *local_args)
    my_shard = np.asarray([s.data for s in p.addressable_shards][0])
    equal = bool(np.array_equal(my_shard, np.asarray(ref.p)))

    print(json.dumps({
        "pid": pid, "global_devices": jax.device_count(),
        "accepted": agg["accepted"], "rows": agg["rows"],
        "shard_equal": equal,
    }), flush=True)
    return 0 if equal and agg["accepted"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
