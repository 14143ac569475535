"""Fit-step budget attribution.

Replicates BASELINE config 5 (128-taxon GTR+Gamma4 joint fit, 1024 sites,
f32 engine) and splits one optimizer step into:

  eval_full        forward logL, FULL path (Q build + eigh + gamma quantile
                   per eval — model params free, nothing cacheable)
  vag_full         value_and_grad, full path (what each L-BFGS
                   linesearch trial costs)
  vag_cached       value_and_grad with frozen-model eig+rates args (what a
                   branch-length-only fit costs; the delta to vag_full is
                   the per-eval model-rebuild tax)
  adam_step        one optax.adam step inside a 25-step scanned chunk
                   (adam = exactly 1 vag + update glue)
  lbfgs_step       one optax.lbfgs (zoom linesearch) step, same chunking —
                   the config-5 program. lbfgs_step/vag_full estimates the
                   average linesearch evals per step.

Timing: chunked scans whose iterations see distinct branch lengths, so XLA
cannot hoist the work out of the loop.

Usage: python benchmarks/profile_fit.py   (prints one JSON line)
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    jax.config.update("jax_enable_x64", True)

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.optimize import transform_params, untransform_params
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.trees import random_tree
    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    tree = random_tree(128, seed=5)
    aln = simulate_alignment(jax.random.key(5), tree, models.GTR, 1024,
                             ncat=4)
    engine = LikelihoodEngine(tree, aln, models.GTR, ncat=4,
                              dtype="float32")
    params = engine._full_params(None)
    lp, w = engine._leaf_partials, engine._weights
    eig = engine.model_eigen(params)
    rates = engine.model_rates(params)
    n_pat = engine._compressed.n_patterns

    raw0 = jax.tree.map(
        lambda x: x.astype(jnp.result_type(float)), transform_params(params)
    )

    def loss_full(raw):
        total, _ = engine._loglik_fn(untransform_params(raw), lp, w)
        return -total.astype(jnp.result_type(float))

    def loss_cached(raw):
        total, _ = engine._loglik_fn(
            untransform_params(raw), lp, w, eig=eig, rates=rates
        )
        return -total.astype(jnp.result_type(float))

    N = 25
    acc0 = jnp.zeros((), jnp.float64)

    def scan_of(fn_of_raw):
        """fn(raw)->scalar scanned N times with a perturbed raw each iter."""

        @jax.jit
        def run(raw):
            def body(acc, i):
                r = dict(raw)
                r["branch_lengths"] = raw["branch_lengths"] + 1e-7 * i
                return acc + fn_of_raw(r).astype(acc.dtype), None

            acc, _ = lax.scan(body, acc0, jnp.arange(N, dtype=jnp.float64))
            return acc

        return run

    def timed(run, *args, n_reps=3):
        jax.block_until_ready(run(*args))
        best = float("inf")
        for _ in range(n_reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(*args))
            best = min(best, time.perf_counter() - t0)
        return best / N

    res = {}
    res["eval_full_ms"] = timed(scan_of(loss_full), raw0) * 1e3
    res["vag_full_ms"] = timed(
        scan_of(lambda r: jax.value_and_grad(loss_full)(r)[0]
                + jnp.sum(jax.value_and_grad(loss_full)(r)[1]
                          ["branch_lengths"])), raw0) * 1e3
    res["vag_cached_ms"] = timed(
        scan_of(lambda r: jax.value_and_grad(loss_cached)(r)[0]
                + jnp.sum(jax.value_and_grad(loss_cached)(r)[1]
                          ["branch_lengths"])), raw0) * 1e3

    # optimizer chunks: 25 steps fused per dispatch
    def chunk_runner(opt, loss_fn, lbfgs):
        if lbfgs:
            def one_step(raw, st):
                vag = optax.value_and_grad_from_state(loss_fn)
                loss, grads = vag(raw, state=st)
                updates, st = opt.update(grads, st, raw, value=loss,
                                         grad=grads, value_fn=loss_fn)
                return optax.apply_updates(raw, updates), st, loss
        else:
            def one_step(raw, st):
                loss, grads = jax.value_and_grad(loss_fn)(raw)
                updates, st = opt.update(grads, st, raw)
                return optax.apply_updates(raw, updates), st, loss

        @jax.jit
        def run(raw, st):
            def body(carry, _):
                raw, st = carry
                raw, st, loss = one_step(raw, st)
                return (raw, st), loss

            (raw, st), losses = lax.scan(body, (raw, st), None, length=N)
            return losses[-1]

        st0 = opt.init(raw0)
        # canonicalize opt-state dtypes (optimize.py:375 rationale)
        shapes = jax.eval_shape(lambda r, s: one_step(r, s)[1], raw0, st0)
        st0 = jax.tree.map(lambda x, sh: jnp.asarray(x, sh.dtype), st0,
                           shapes)
        return run, st0

    run_adam, st_a = chunk_runner(optax.adam(1e-2), loss_full, False)
    res["adam_step_full_ms"] = timed(run_adam, raw0, st_a) * 1e3
    run_lb, st_l = chunk_runner(optax.lbfgs(), loss_full, True)
    res["lbfgs_step_full_ms"] = timed(run_lb, raw0, st_l) * 1e3
    run_lbc, st_lc = chunk_runner(optax.lbfgs(), loss_cached, True)
    res["lbfgs_step_cached_ms"] = timed(run_lbc, raw0, st_lc) * 1e3

    out = {
        "metric": "fit-step budget, config5 (128-taxon GTR+G4 joint fit)",
        "n_patterns": int(n_pat),
        "per_step_ms": {k: round(v, 4) for k, v in res.items()},
        "derived": {
            "model_rebuild_tax_ms": round(
                res["vag_full_ms"] - res["vag_cached_ms"], 4),
            "adam_glue_ms": round(
                res["adam_step_full_ms"] - res["vag_full_ms"], 4),
            "lbfgs_evals_per_step_est": round(
                res["lbfgs_step_full_ms"] / res["vag_full_ms"], 2),
            "adam_steps_per_s": round(1e3 / res["adam_step_full_ms"], 1),
            "lbfgs_steps_per_s": round(1e3 / res["lbfgs_step_full_ms"], 1),
        },
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
