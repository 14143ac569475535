"""Partitioned-fit cost vs partition count: looped vs stacked.

How the compile and step cost of a partitioned fit scale with the
partition count, for BOTH formulations:

  looped    PartitionedEngine — one inlined engine subgraph per locus
  stacked   StackedPartitionedEngine — loci on a vmap batch axis of ONE
            engine (program size independent of G)

Methodology = profile_fit.py's: the adam/L-BFGS CHUNK program (N steps
fused per dispatch over the engine's ``_loglik_fn``) is built directly;
``compile_s`` is the first-call wall (trace + compile + one chunk),
``step_ms`` the min-over-reps warm dispatch time / N.

APPBENCH-shaped config: --taxa 64, G loci x (--sites/G) columns of one
GTR+G4-simulated alignment.

Usage: python benchmarks/partition_scaling.py [--parts 1,2,4,8]
Prints one JSON line (plus per-row progress lines).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="1,2,4,8")
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--sites", type=int, default=1000)
    ap.add_argument("--chunk-steps", type=int, default=25)
    ap.add_argument("--formulations", default="stacked,looped")
    ap.add_argument("--optimizers", default="adam,lbfgs")
    args = ap.parse_args()
    counts = [int(x) for x in args.parts.split(",")]

    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    jax.config.update("jax_enable_x64", True)

    from phylo_utils_tpu import models
    from phylo_utils_tpu.optimize import transform_params, \
        untransform_params
    from phylo_utils_tpu.partition import (
        Partition,
        PartitionedEngine,
        StackedPartitionedEngine,
    )
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.trees import random_tree
    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    tree = random_tree(args.taxa, seed=0)
    aln = simulate_alignment(jax.random.PRNGKey(1), tree, models.GTR,
                             n_sites=args.sites, ncat=4)

    classes = {
        "looped": PartitionedEngine,
        "stacked": StackedPartitionedEngine,
    }
    N = args.chunk_steps
    acc0 = jnp.zeros((), jnp.float64)
    rows = []
    for g in counts:
        q = args.sites // g
        parts = [
            Partition(
                f"locus{i}",
                {k: v[i * q:(i + 1) * q] for k, v in aln.items()},
                models.GTR, ncat=4,
            )
            for i in range(g)
        ]
        for form in args.formulations.split(","):
            pe = classes[form](tree, parts, dtype="float32")
            full = pe._full_params(None)
            lp, w = pe._leaf_partials, pe._weights
            raw0 = jax.tree.map(
                lambda x: x.astype(jnp.result_type(float)),
                transform_params(full),
            )

            def loss(raw):
                total, _ = pe._loglik_fn(untransform_params(raw), lp, w)
                return -total.astype(jnp.result_type(float))

            for optname in args.optimizers.split(","):
                if optname == "lbfgs":
                    opt = optax.lbfgs()

                    def one_step(raw, st):
                        vag = optax.value_and_grad_from_state(loss)
                        val, grads = vag(raw, state=st)
                        updates, st = opt.update(
                            grads, st, raw, value=val, grad=grads,
                            value_fn=loss,
                        )
                        return optax.apply_updates(raw, updates), st, val
                else:
                    opt = optax.adam(2e-2)

                    def one_step(raw, st):
                        val, grads = jax.value_and_grad(loss)(raw)
                        updates, st = opt.update(grads, st, raw)
                        return optax.apply_updates(raw, updates), st, val

                @jax.jit
                def run(raw, st):
                    def body(carry, _):
                        raw, st = carry
                        raw, st, val = one_step(raw, st)
                        return (raw, st), val

                    (raw, st), vals = lax.scan(body, (raw, st), None,
                                               length=N)
                    return vals[-1]

                st0 = opt.init(raw0)
                shapes = jax.eval_shape(lambda r, s: one_step(r, s)[1],
                                        raw0, st0)
                st0 = jax.tree.map(
                    lambda x, sh: jnp.asarray(x, sh.dtype), st0, shapes
                )
                t0 = time.perf_counter()
                ll_end = float(run(raw0, st0))
                compile_s = time.perf_counter() - t0
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    jax.block_until_ready(run(raw0, st0))
                    best = min(best, time.perf_counter() - t0)
                row = {
                    "formulation": form,
                    "optimizer": optname,
                    "n_partitions": g,
                    "compile_s": round(compile_s, 2),
                    "step_ms": round(best / N * 1e3, 3),
                    "warm_steps_per_s": round(N / best, 2),
                    "chunk_loss_end": round(ll_end, 2),
                }
                rows.append(row)
                print(json.dumps({"row": row}), flush=True)

    print(json.dumps({
        "metric": "partitioned-fit scaling (chunk compile + warm "
                  "steps/s) vs partition count, looped vs stacked",
        "config": {"taxa": args.taxa, "sites": args.sites,
                   "model": "GTR+G4 per locus",
                   "chunk_steps": N},
        "rows": rows,
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
