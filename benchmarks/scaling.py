"""Scaling-efficiency harness: sites/s at 1..N devices on one mesh.

On a multi-host cluster this measures the interconnect scaling required by
BASELINE.json (>=85% efficiency at 2 hosts). On one machine, run it on the
virtual CPU mesh to validate the harness + sharding math:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python benchmarks/scaling.py

Weak scaling: per-device pattern count is fixed, so ideal sites/s grows
linearly with devices; efficiency = (sites/s at N) / (N * sites/s at 1).
The only cross-device communication is the final logL psum (and its
gradient), so efficiency should be near 1 whenever per-device work amortizes
dispatch overhead.

CPU-mesh pinning and why wall-clock rows CANNOT isolate communication
here (round 3): all virtual host devices share ONE XLA threadpool, and
XLA:CPU greedily parallelizes a SINGLE device's program across every
visible core — so any taskset layout makes the 1-device ideal and the
N-device measurement use different cores-per-program, and the rows
measure cache/threadpool geometry, not psum. Measured demonstrations on
this 4-core host (64 taxa, 2048 patterns/device): 1 device reads 45.2k
patterns/s on 1 core but 72.0k on 2 cores (intra-op threading), and the
2-devices-on-3-cores point is SUPERLINEAR against the 1-core baseline
(104.0k = 1.15x of 2x45.2k) — both impossible under a communication
interpretation. The pinned subprocess rows (`taskset -c 0..N`, one core
per device plus a dispatcher core, `pinned: true`) are therefore
reported for transparency only.

The artifact's communication evidence is instead isolated BY
CONSTRUCTION: `measure_psum` times the same tiny shard_map program with
and without the scalar psum under identical dispatch conditions —
`psum_net_us` is the collective + cross-device sync cost per call, to be
compared against the multi-millisecond per-call compute at production
shard sizes (see SCALING_r03.json analysis).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(n_devices: int, patterns_per_device: int, n_taxa: int,
            grad: bool, iters: int = 10) -> float:
    import jax

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.parallel import SiteSharding, make_mesh
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.trees import random_tree

    mesh = make_mesh(jax.devices()[:n_devices])
    sharding = SiteSharding(mesh)
    tree = random_tree(n_taxa, seed=0)
    n_sites = patterns_per_device * n_devices
    aln = simulate_alignment(
        jax.random.key(7), tree, models.GTR, n_sites, ncat=4
    )
    engine = LikelihoodEngine(
        tree, aln, models.GTR, ncat=4, sharding=sharding, dtype="float32",
    )
    params = engine._full_params(None)
    fn = engine._jit_grad if grad else engine._jit_fn
    args = (params, engine._leaf_partials, engine._weights)
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return int(engine._weights.shape[0]) / dt


def measure_psum(n_devices: int, iters: int = 50) -> dict:
    """Per-call cost of the harness's ONLY collective, isolated BY
    CONSTRUCTION: the same tiny shard_map program is timed WITH the
    scalar psum (what the sharded logL reduction lowers to) and WITHOUT
    it (per-shard local sum, no communication). The difference is the
    collective + cross-device sync cost under identical dispatch
    conditions — wall-clock weak-scaling rows on a shared-core host
    cannot isolate this (see module docstring)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from phylo_utils_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices()[:n_devices])

    @jax.jit
    def with_psum(x):
        f = jax.shard_map(
            lambda v: jax.lax.psum(jnp.sum(v), "sites"),
            mesh=mesh, in_specs=P("sites"), out_specs=P(),
        )
        return f(x)

    @jax.jit
    def without_psum(x):
        f = jax.shard_map(
            lambda v: jnp.sum(v, keepdims=True),
            mesh=mesh, in_specs=P("sites"), out_specs=P("sites"),
        )
        return f(x)

    x = jnp.arange(n_devices * 8, dtype=jnp.float32)

    def timed(fn):
        jax.block_until_ready(fn(x))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(x)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / iters * 1e6)
        return best

    t_psum = timed(with_psum)
    t_local = timed(without_psum)
    return {
        "psum_us_per_call": round(t_psum, 1),
        "dispatch_only_us_per_call": round(t_local, 1),
        "psum_net_us": round(max(t_psum - t_local, 0.0), 1),
    }


def _run_pinned(n: int, args) -> dict:
    """One device-count point in a subprocess pinned to cores 0..n (one
    core per device plus a dispatcher core, capped at the host's cores)."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
    )
    top = min(n, (os.cpu_count() or 1) - 1)
    cmd = [
        "taskset", "-c", f"0-{top}" if top > 0 else "0",
        sys.executable, os.path.abspath(__file__),
        "--single", str(n),
        "--patterns-per-device", str(args.patterns_per_device),
        "--taxa", str(args.taxa),
    ] + (["--grad"] if args.grad else [])
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"pinned run n={n} failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--patterns-per-device", type=int, default=2048)
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--grad", action="store_true",
                    help="measure value_and_grad instead of forward")
    ap.add_argument("--single", type=int, default=0,
                    help="(internal) measure ONE device count and exit")
    ap.add_argument("--no-pin", action="store_true",
                    help="skip the taskset-pinned subprocess rows")
    args = ap.parse_args()

    if args.single:
        import jax

        n = args.single
        pps = measure(n, args.patterns_per_device, args.taxa, args.grad)
        row = {
            "devices": n,
            "patterns_per_s": round(pps, 1),
            "platform": jax.default_backend(),
        }
        row.update(measure_psum(n))
        print(json.dumps(row))
        return

    import jax

    n_avail = len(jax.devices())
    n_cores = os.cpu_count() or 1
    scales = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]

    # pinned rows: n compute cores + 1 shared dispatcher core (capped at
    # the host's core count). NOTE the extra core also feeds XLA intra-op
    # threading, so the 1-device baseline is inflated and the efficiency
    # column remains geometry-confounded — reported for transparency
    # only; the communication evidence is psum_net_us (module docstring).
    if jax.default_backend() == "cpu" and not args.no_pin:
        base = None
        for n in [s for s in scales if s <= n_cores]:
            row = _run_pinned(n, args)
            if base is None:
                base = row["patterns_per_s"]
            row.update(
                weak_scaling_efficiency=round(
                    row["patterns_per_s"] / (n * base), 4),
                patterns_per_device=args.patterns_per_device,
                taxa=args.taxa,
                measuring="grad" if args.grad else "forward",
                pinned=True,
                cores=f"0-{min(n, n_cores - 1)}",
            )
            print(json.dumps(row))

    # raw in-process rows (unpinned; oversubscribed beyond the core count)
    base = None
    for n in scales:
        pps = measure(n, args.patterns_per_device, args.taxa, args.grad)
        if base is None:
            base = pps
        eff = pps / (n * base)
        print(json.dumps({
            "devices": n,
            "patterns_per_s": round(pps, 1),
            "weak_scaling_efficiency": round(eff, 4),
            "patterns_per_device": args.patterns_per_device,
            "taxa": args.taxa,
            "measuring": "grad" if args.grad else "forward",
            "platform": jax.default_backend(),
            "pinned": False,
            "oversubscribed": n > n_cores,
        }))


if __name__ == "__main__":
    main()
