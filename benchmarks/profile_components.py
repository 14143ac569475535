"""Per-component device timings: gamma discretization, P(t) build (incl.
eigh), pruning kernel, and the fused full pipeline — plus an optional
jax.profiler trace for Perfetto/TensorBoard.

Usage: python benchmarks/profile_components.py [--taxa 64] [--sites 1024]
       [--ncat 4] [--trace /tmp/jaxtrace]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(f, *a, n=50):
    import jax

    jax.block_until_ready(f(*a))
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*a)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    import jax

    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.ops.gamma import discrete_gamma
    from phylo_utils_tpu.ops.pmatrix import p_matrices_reversible
    from phylo_utils_tpu.trees import random_tree
    from phylo_utils_tpu.utils.metrics import trace

    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--sites", type=int, default=1024)
    ap.add_argument("--ncat", type=int, default=4)
    ap.add_argument("--trace", help="profiler trace output dir")
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

    t_full = timeit(engine._jit_fn, params, lp, w)
    t_grad = timeit(engine._jit_grad, params, lp, w)
    t_gamma = timeit(jax.jit(lambda a: discrete_gamma(a, args.ncat)),
                     params["alpha"])
    sym, freqs = models.GTR.build_parts(params["model"], dtype=jnp.float32)
    rates = jnp.linspace(0.2, 2.0, args.ncat, dtype=jnp.float32)
    t = jnp.asarray(tree.lengths, jnp.float32)[:, None] * rates[None, :]
    pm = jax.jit(p_matrices_reversible)
    t_pmat = timeit(pm, sym, freqs, t)
    p = pm(sym, freqs, t)
    t_prune = timeit(jax.jit(engine._prune), p, lp)

    if args.trace:
        with trace(args.trace):
            jax.block_until_ready(engine._jit_fn(params, lp, w))

    n_pat = int(engine._weights.shape[0])
    print(json.dumps({
        "full_ms": round(t_full, 4),
        "value_and_grad_ms": round(t_grad, 4),
        "gamma_ms": round(t_gamma, 4),
        "pmatrices_ms": round(t_pmat, 4),
        "prune_ms": round(t_prune, 4),
        "patterns_per_s_full": round(n_pat / (t_full / 1e3), 1),
        "n_patterns": n_pat,
        "device": str(jax.devices()[0]),
        "trace_dir": args.trace,
    }))


if __name__ == "__main__":
    main()
