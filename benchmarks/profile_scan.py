"""Per-component timings: distinct-input evals fused into one dispatch.

bench.py's methodology: N evaluations with distinct branch lengths inside
one lax.scan (so XLA cannot hoist the work out of the loop), divided by N.
Components:

  p_build   — P(t) reconstruction from the cached eigen system
  prune     — the pruning pass alone (P built once outside the scan)
  full      — the complete logL pipeline (P build + prune + root mix)
  grad      — value_and_grad of full

Usage: python benchmarks/profile_scan.py [--taxa 64] [--sites 1024]
       [--ncat 4] [--inner 50]
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
    import jax
    import jax.numpy as jnp
    from jax import lax

    jax.config.update("jax_enable_x64", True)

    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.ops.pmatrix import (
        extend_p_identity,
        transition_matrices,
    )
    from phylo_utils_tpu.trees import random_tree

    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--sites", type=int, default=1024)
    ap.add_argument("--ncat", type=int, default=4)
    ap.add_argument("--inner", type=int, default=50)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    tree = random_tree(args.taxa, seed=0)
    aln = {
        n: "".join(rng.choice(list("ACGT"), size=args.sites))
        for n in tree.leaf_names
    }
    engine = LikelihoodEngine(
        tree, aln, models.GTR, ncat=args.ncat, dtype="float32",
    )
    params = engine._full_params(None)
    lp, w = engine._leaf_partials, engine._weights
    eig = engine.model_eigen(params)
    rdt = engine._reduce_dtype
    N = args.inner

    t0_bl = params["branch_lengths"].astype(rdt)
    from phylo_utils_tpu.ops.gamma import discrete_gamma

    rates = discrete_gamma(params["alpha"], args.ncat).astype(rdt)

    def p_of(i):
        ts = (t0_bl * (1.0 + 1e-7 * i))[:, None] * rates[None, :]
        # out_dtype mirrors likelihood.mixture_rates_and_p's fast path:
        # exp in rdt (f64), spectral-mode matmul in the compute dtype
        return transition_matrices(eig, ts, out_dtype=engine.dtype)

    def scanner(body):
        @jax.jit
        def run():
            acc, _ = lax.scan(
                lambda a, i: (a + body(i), None),
                jnp.zeros((), rdt),
                jnp.arange(N, dtype=jnp.float32),
            )
            return acc
        return run

    # p_build: P(t) reconstruction only (sum to force materialization)
    run_p = scanner(lambda i: jnp.sum(p_of(i)).astype(rdt))

    # prune: P varies per iteration (realistic layout) but is built in f32
    # OUTSIDE the timed reduction; subtracting p_build isolates the kernel.
    def prune_body(i):
        p = extend_p_identity(p_of(i), engine.schedule.n_nodes)
        root_partials, root_logscale = engine._prune(
            p.astype(engine.dtype), lp
        )
        return (jnp.sum(root_partials) + jnp.sum(root_logscale)).astype(rdt)

    run_prune = scanner(prune_body)

    cat_rates = engine.model_rates(params)

    def full_body(i):
        p2 = dict(params)
        p2["branch_lengths"] = params["branch_lengths"] * (1.0 + 1e-7 * i)
        return engine._loglik_fn(
            p2, lp, w, eig=eig, rates=cat_rates
        )[0].astype(rdt)

    run_full = scanner(full_body)

    def grad_body(i):
        p2 = dict(params)
        p2["branch_lengths"] = params["branch_lengths"] * (1.0 + 1e-7 * i)
        v, g = jax.value_and_grad(
            lambda q: engine._loglik_fn(q, lp, w, eig=eig,
                                        rates=cat_rates)[0]
        )(p2)
        return (v + jnp.sum(g["branch_lengths"])).astype(rdt)

    run_grad = scanner(grad_body)

    def timed(run):
        jax.block_until_ready(run())
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            best = min(best, time.perf_counter() - t0)
        return best / N * 1e3

    out = {
        "taxa": args.taxa, "sites": args.sites, "ncat": args.ncat,
        "device": str(jax.devices()[0]),
        "p_build_ms": round(timed(run_p), 4),
        "prune_plus_p_ms": round(timed(run_prune), 4),
        "full_ms": round(timed(run_full), 4),
        "grad_ms": round(timed(run_grad), 4),
    }
    out["kernel_ms_est"] = round(out["prune_plus_p_ms"] - out["p_build_ms"], 4)
    out["rootmix_ms_est"] = round(out["full_ms"] - out["prune_plus_p_ms"], 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
