"""Headline benchmark: site-patterns/sec/chip, 64-taxon GTR+Gamma pruning.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "patterns/s/chip", "vs_baseline": N,
   "device": {...}, "extra": {...}}

``vs_baseline`` is the speedup over the reference's algorithm measured as the
in-repo float64 numpy oracle (serial Felsenstein pruning — same algorithm and
serial structure as phylo_utils' Cython loop; SURVEY.md §6: the reference
publishes no numbers, so the oracle is the denominator).

Timing: N likelihood evaluations with distinct branch lengths run inside one
jitted ``lax.scan`` (distinct, so XLA cannot hoist the work out of the
loop); per-eval time = call time / N. Every evaluation includes the full
pipeline (P(t) reconstruction, the XLA pruning walk, f64 root
reduction/mixing) — what a real optimizer step pays. Needs a GPU: without
one it exits non-zero and prints nothing.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_TAXA = 64
N_SITES = 1024          # random DNA -> patterns ~= sites (all unique)
NCAT = 4
ORACLE_SITES = 128      # oracle is slow; measure on a slice and scale
N_INNER = 50            # single-stream evals per dispatch (latency)
N_INNER_GRAD = 25
VMAP_B = 64             # batched evals per launch (throughput)
VMAP_OUT = 16           # scan iterations of vmapped batches per dispatch
VMAP_B_GRAD = 64        # batched value_and_grad per launch
VMAP_OUT_GRAD = 16


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from phylo_utils_tpu.utils.device import (
        card_info,
        device_record,
        require_gpu,
    )

    devices = require_gpu()
    # x64 on: the f32 engine then builds P(t) and does the root
    # reduction / final pattern sum in f64 (likelihood.py precision plan) —
    # this is what closes rel_logl_err to <= 1e-6 while partials stay f32.
    jax.config.update("jax_enable_x64", True)

    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from __graft_entry__ import _random_alignment
    from oracle import core as oracle
    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.trees import random_tree

    dtype = os.environ.get("BENCH_DTYPE", "float32")

    tree = random_tree(N_TAXA, seed=0)
    aln = _random_alignment(tree, N_SITES, seed=1)

    engine = LikelihoodEngine(tree, aln, models.GTR, ncat=NCAT, dtype=dtype)
    n_patterns = engine._compressed.n_patterns
    params = engine._full_params(None)
    lp, w = engine._leaf_partials, engine._weights

    # model fixed across the evals -> eigen + gamma rates computed once
    # (the reference's TransitionMatrix semantics); P(t) is still rebuilt
    # per evaluation
    eig = engine.model_eigen(params)
    cat_rates = engine.model_rates(params)

    def loglik(p2):
        return engine._loglik_fn(p2, lp, w, eig=eig, rates=cat_rates)[0]

    acc0 = jnp.zeros((), jnp.result_type(float))

    @jax.jit
    def scan_eval(params):
        def body(acc, i):
            p2 = dict(params)
            p2["branch_lengths"] = params["branch_lengths"] * (
                1.0 + 1e-7 * i
            )
            return acc + loglik(p2).astype(acc.dtype), None

        acc, _ = lax.scan(
            body, acc0, jnp.arange(N_INNER, dtype=jnp.float32)
        )
        return acc

    @jax.jit
    def scan_vag(params):
        def body2(acc, i):
            p2 = dict(params)
            p2["branch_lengths"] = params["branch_lengths"] * (
                1.0 + 1e-7 * i
            )
            v, g = jax.value_and_grad(loglik)(p2)
            return (
                acc + v.astype(acc.dtype)
                + jnp.sum(g["branch_lengths"]).astype(acc.dtype),
                None,
            )

        acc, _ = lax.scan(
            body2, acc0, jnp.arange(N_INNER_GRAD, dtype=jnp.float32)
        )
        return acc

    # batched-gradient throughput (bootstrap/multi-start/topology-set
    # fits run many independent gradient evals per dispatch)
    def one_vag(scale):
        p2 = dict(params)
        p2["branch_lengths"] = params["branch_lengths"] * scale
        v, g = jax.value_and_grad(loglik)(p2)
        return v + jnp.sum(g["branch_lengths"])

    batched_vag = jax.vmap(one_vag)

    @jax.jit
    def scan_vmap_vag(params):
        def body(acc, i):
            scales = 1.0 + 1e-7 * (
                i * VMAP_B_GRAD
                + jnp.arange(VMAP_B_GRAD, dtype=jnp.float32)
            )
            return acc + jnp.sum(batched_vag(scales)).astype(acc.dtype), None

        acc, _ = lax.scan(
            body, acc0, jnp.arange(VMAP_OUT_GRAD, dtype=jnp.float32)
        )
        return acc

    # throughput mode: B independent evaluations per launch (vmap adds a
    # batch axis to every kernel of the walk), scanned VMAP_OUT times per
    # dispatch
    def one_eval(scale):
        p2 = dict(params)
        p2["branch_lengths"] = params["branch_lengths"] * scale
        return loglik(p2)

    batched_eval = jax.vmap(one_eval)

    @jax.jit
    def scan_vmap(params):
        def body(acc, i):
            scales = 1.0 + 1e-7 * (
                i * VMAP_B + jnp.arange(VMAP_B, dtype=jnp.float32)
            )
            return acc + jnp.sum(batched_eval(scales)).astype(acc.dtype), None

        acc, _ = lax.scan(
            body, acc0, jnp.arange(VMAP_OUT, dtype=jnp.float32)
        )
        return acc

    def timed(fn, n_inner, n_reps=3):
        jax.block_until_ready(fn(params))  # compile + warm
        best = float("inf")
        for _ in range(n_reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(params))
            best = min(best, time.perf_counter() - t0)
        return best / n_inner

    per_eval_batched = timed(scan_vmap, VMAP_B * VMAP_OUT)
    pps = n_patterns / per_eval_batched
    per_grad_batched = timed(scan_vmap_vag, VMAP_B_GRAD * VMAP_OUT_GRAD)
    per_eval = timed(scan_eval, N_INNER)
    per_grad = timed(scan_vag, N_INNER_GRAD)

    # one eval for the parity number
    ll = float(engine._jit_fn(params, lp, w)[0])

    # --- steady-state fit loop: optimizer steps fused into one dispatch ---
    import optax

    from phylo_utils_tpu.optimize import transform_params, untransform_params

    CHUNK = 100
    opt = optax.adam(1e-2)
    raw0 = transform_params(params)
    opt_state0 = opt.init(raw0)

    def loss_fn(raw):
        total, _ = engine._loglik_fn(untransform_params(raw), lp, w)
        return -total

    @jax.jit
    def chunk(raw, opt_state):
        def body(carry, _):
            raw, st = carry
            loss, grads = jax.value_and_grad(loss_fn)(raw)
            updates, st = opt.update(grads, st, raw)
            return (optax.apply_updates(raw, updates), st), loss

        (raw, opt_state), losses = lax.scan(
            body, (raw, opt_state), None, length=CHUNK
        )
        return raw, opt_state, losses

    raw, st, _ = chunk(raw0, opt_state0)        # compile + warm
    jax.block_until_ready((raw, st))
    t0 = time.perf_counter()
    raw, st, losses = chunk(raw, st)
    jax.block_until_ready((raw, st))
    fit_steps_per_s = CHUNK / (time.perf_counter() - t0)
    final_fit_ll = -float(np.asarray(losses)[-1])

    # --- parity + oracle denominator (after timing) ------------------------
    rates = oracle.discrete_gamma(0.5, NCAT)
    gtr_oracle = oracle.gtr([1.0] * 6, [0.25] * 4)
    weights = np.asarray(engine._compressed.weights)
    lp64 = np.asarray(engine._compressed.partials, dtype=np.float64)
    oracle_time = float("inf")
    for _ in range(3):  # min over repeats: robust to CPU contention
        t0 = time.perf_counter()
        oracle.loglikelihood(
            tree, aln, gtr_oracle, rates=rates,
            pattern_weights=weights[:ORACLE_SITES],
            leaf_partials=lp64[:, :ORACLE_SITES, :],
        )
        oracle_time = min(oracle_time, time.perf_counter() - t0)
    oracle_pps = ORACLE_SITES / oracle_time

    ll_full_oracle = oracle.loglikelihood(
        tree, aln, gtr_oracle, rates=rates, pattern_weights=weights,
        leaf_partials=lp64,
    )
    err = abs(ll - ll_full_oracle) / max(abs(ll_full_oracle), 1.0)

    result = {
        "metric": "site-patterns/sec/chip, 64-taxon GTR+Gamma4 pruning",
        "value": round(pps, 1),
        "unit": "patterns/s/chip",
        "vs_baseline": round(pps / oracle_pps, 2),
        "device": device_record(devices, card_info()),
        "extra": {
            "methodology": (
                f"throughput: {VMAP_B} independent evals per launch "
                f"(vmap) x {VMAP_OUT} per dispatch, distinct branch "
                "lengths; latency: eval_ms_single_stream (sequential scan)"
            ),
            "n_patterns": int(n_patterns),
            "eval_ms_batched": round(per_eval_batched * 1e3, 4),
            "eval_ms_single_stream": round(per_eval * 1e3, 4),
            "grad_eval_ms": round(per_grad * 1e3, 4),
            "grad_eval_ms_batched": round(per_grad_batched * 1e3, 4),
            "grad_patterns_per_s": round(n_patterns / per_grad_batched, 1),
            "grad_patterns_per_s_single_stream": round(
                n_patterns / per_grad, 1),
            "fit_steps_per_s": round(fit_steps_per_s, 1),
            "fit_chunk_ll": final_fit_ll,
            "oracle_patterns_per_s": round(oracle_pps, 1),
            "rel_logl_err_vs_f64_oracle": float(err),
            "dtype": dtype,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
