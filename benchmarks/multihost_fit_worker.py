"""Worker for the killed-and-restarted 2-process fit test.

Each process owns 4 virtual CPU devices; ``jax.distributed.initialize``
stitches them into one 8-device global mesh. The alignment's site patterns
are sharded across the mesh (the production multi-host layout); optimizer
state is replicated, checkpoints are written by process 0 only
(``utils.checkpoint.save_checkpoint``), exactly as on a multi-host cluster.

Modes (argv[4]):
  clean   run ``fit`` for TOTAL_STEPS uninterrupted, print the final raw
          parameter digest.
  crash   run ``fit`` with a checkpoint cadence; at step CRASH_STEP the
          process hard-exits via ``os._exit`` mid-run (no cleanup, no
          distributed shutdown — the closest in-process stand-in for
          SIGKILL that is deterministic per step).
  resume  restore from the checkpoint and continue to TOTAL_STEPS; the
          final digest must equal the clean run's bit-for-bit.

Usage:
  python benchmarks/multihost_fit_worker.py <proc_id> <n_procs> <port> \
      <mode> <checkpoint_path>
Prints one JSON line on success.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOTAL_STEPS = 12
CKPT_EVERY = 3
CRASH_STEP = 7


def _digest(tree) -> str:
    import jax
    import numpy as np

    leaves = jax.tree_util.tree_leaves(jax.device_get(tree))
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(np.asarray(leaf, dtype=np.float64).tobytes())
    return h.hexdigest()


def main() -> None:
    proc_id, n_procs, port, mode, ckpt = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5],
    )
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    import numpy as np
    import optax

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.optimize import fit
    from phylo_utils_tpu.parallel import SiteSharding, make_mesh
    from phylo_utils_tpu.trees import random_tree

    # identical inputs on every process (deterministic seeds)
    tree = random_tree(8, seed=11)
    rng = np.random.default_rng(12)
    aln = {
        n: "".join(rng.choice(list("ACGT"), size=120))
        for n in tree.leaf_names
    }
    engine = LikelihoodEngine(tree, aln, models.GTR, ncat=2)

    # shard the site patterns across the global mesh, as in production
    sharding = SiteSharding(make_mesh())
    lp = np.asarray(engine._leaf_partials)
    w = np.asarray(engine._weights)
    lp_pad, w_pad = sharding.pad(lp, w)
    total = lp_pad.shape[1]
    per_proc = total // n_procs
    sl = slice(proc_id * per_proc, (proc_id + 1) * per_proc)
    lp_g, w_g = sharding.from_process_local(lp_pad[:, sl, :], w_pad[sl])
    engine._leaf_partials, engine._weights = lp_g, w_g

    # The bit-exact comparison is on the TRAJECTORY ENDPOINT (params after
    # step TOTAL_STEPS), observed via the callback — FitResult.params is the
    # best-seen over the steps a given run executed, and a resumed run never
    # saw the pre-crash steps, so "best" windows differ by construction.
    endpoint = {}

    if mode == "crash":
        def callback(n, ll, params):
            if n >= CRASH_STEP:
                # hard uncoordinated death mid-run: no atexit, no flushes,
                # no distributed shutdown — the checkpoint on disk is all
                # that survives
                os._exit(137)
    else:
        def callback(n, ll, params):
            if n == TOTAL_STEPS:
                endpoint["params"] = params

    res = fit(
        engine,
        optimizer=optax.adam(0.05),
        max_steps=TOTAL_STEPS,
        patience=10_000,            # run the full budget: trajectories must align
        callback=callback,
        checkpoint_path=ckpt if mode == "crash" else None,
        checkpoint_every=CKPT_EVERY if mode == "crash" else 0,
        resume_from=ckpt if mode == "resume" else None,
    )
    # digest the CONSTRAINED endpoint parameters (identical across processes
    # because updates are replicated; identical between clean and
    # crash+resume because the optimizer state is purely functional)
    print(json.dumps({
        "process": proc_id,
        "mode": mode,
        "n_steps": res.n_steps,
        "loglik": float(res.loglik),
        "digest": _digest(endpoint["params"]),
    }), flush=True)


if __name__ == "__main__":
    main()
