"""Worker for the REAL multi-process (multi-host-shaped) distributed test.

Run one instance per "host" (process). Each process owns 4 virtual CPU
devices; ``jax.distributed.initialize`` stitches them into one 8-device
global mesh — the same runtime path a 2-host accelerator cluster uses
(cross-host coordination + global mesh + per-process data shards via
``jax.make_array_from_process_local_data``).

Usage (from tests or by hand):
  python benchmarks/multihost_worker.py <proc_id> <n_procs> <port>
Prints one JSON line with the globally-reduced logL; every process must
print the same value, equal to the single-process engine's logL.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    proc_id, n_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    import numpy as np

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.parallel import SiteSharding, make_mesh
    from phylo_utils_tpu.trees import random_tree

    assert jax.process_count() == n_procs
    assert len(jax.devices()) == 4 * n_procs       # global devices
    assert len(jax.local_devices()) == 4

    # identical inputs on every process (deterministic seeds)
    tree = random_tree(12, seed=7)
    rng = np.random.default_rng(8)
    aln = {
        n: "".join(rng.choice(list("ACGT"), size=200))
        for n in tree.leaf_names
    }
    engine = LikelihoodEngine(tree, aln, models.GTR, ncat=4)

    sharding = SiteSharding(make_mesh())
    lp = np.asarray(engine._leaf_partials)          # (L, P, S) host-local
    w = np.asarray(engine._weights)
    lp_pad, w_pad = sharding.pad(lp, w)
    total = lp_pad.shape[1]
    per_proc = total // n_procs
    sl = slice(proc_id * per_proc, (proc_id + 1) * per_proc)
    lp_g, w_g = sharding.from_process_local(lp_pad[:, sl, :], w_pad[sl])

    params = engine._full_params(None)
    total_ll, _ = engine._jit_fn(params, lp_g, w_g)
    local_ll = float(engine.loglikelihood())        # unsharded single-proc
    print(json.dumps({
        "process": proc_id,
        "global_devices": len(jax.devices()),
        "sharded_loglik": float(total_ll),
        "local_loglik": local_ll,
        "match": bool(abs(float(total_ll) - local_ll) < 1e-9),
    }), flush=True)


if __name__ == "__main__":
    main()
