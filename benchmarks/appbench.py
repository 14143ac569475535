"""Application-layer workloads on the device.

Times the end-user workloads the engine-level fast paths exist to serve —
each wall-clock (what a user actually waits), with the batching/padding
economics made explicit:

  nni_hill_climb       64-taxon GTR+G4 greedy search, moves="both": whole
                       rearrangement neighborhood (~180 topologies) scored
                       + branch-length-optimized per round in ONE batched
                       device program (pad_schedules). Reports per-round
                       wall time, split into first-call (compile) vs
                       steady-state rounds, plus the padding overhead of
                       the topology batch.
  alrt_supports        aLRT/SH-aLRT for every internal edge (one batched
                       TopologySetEngine over all ~122 NNI alternatives).
  bootstrap_tree_support  B=100 replicates: batched (replicate x pair)
                       Newton ML distances + host NJ.
  PartitionedEngine fit  4-locus partitioned fit (shared tree, per-locus
                       GTR+G4 + rate multipliers), chunked L-BFGS.

Writes one JSON line; the device field says what ran. Padding overhead = 1 - real_slots/padded_slots of
the pad_schedules level grid for the first search round's neighborhood.

Usage: python benchmarks/appbench.py [--taxa 64] [--sites 1000]
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
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--sites", type=int, default=1000)
    ap.add_argument("--boot", type=int, default=100)
    ap.add_argument("--stages", default="pad,search,alrt,boot,part",
                    help="comma subset of pad,search,alrt,boot,part — "
                         "stages run independently so a hung remote "
                         "compile loses one stage, not the artifact")
    ap.add_argument("--moves", default="nni",
                    help="search neighborhood (nni|spr|both); 'both' at "
                         "64 taxa compiles a ~380-topology batched "
                         "program that has hung the remote compiler")
    args = ap.parse_args()
    stages = set(args.stages.split(","))

    import jax

    jax.config.update("jax_enable_x64", True)

    from phylo_utils_tpu import models
    from phylo_utils_tpu.batched import TopologySetEngine, pad_schedules
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.optimize import fit
    from phylo_utils_tpu.partition import Partition, PartitionedEngine
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.supports import alrt_supports, bootstrap_tree_support
    from phylo_utils_tpu.trees import (
        compile_schedule,
        nni_neighbors,
        random_tree,
        spr_neighbors,
    )
    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    out = {"metric": "application-layer wall clock on chip",
           "taxa": args.taxa, "sites": args.sites,
           "device": str(jax.devices()[0])}

    tree = random_tree(args.taxa, seed=7)
    aln = simulate_alignment(jax.random.key(7), tree, models.GTR,
                             args.sites, ncat=4)

    # --- padding economics of the search-round neighborhood batch --------
    nbrs = [tree] + nni_neighbors(tree)
    if args.moves in ("spr", "both"):
        # spr_max_targets=2: at 64 taxa the full 8-target SPR neighborhood
        # is ~1100 topologies whose batched partials buffer alone is ~9 GB
        nbrs += spr_neighbors(tree, max_targets=2, seed=1)
    if "pad" in stages:
        from phylo_utils_tpu.batched import choose_regroup_width
        from phylo_utils_tpu.trees import schedule_fill

        scheds = [compile_schedule(t) for t in nbrs]
        out["neighborhood_size"] = len(nbrs)
        out["pad_schedules_fill"] = round(schedule_fill(scheds), 4)
        u, rg = choose_regroup_width(scheds)
        out["regroup_width"] = u
        out["regrouped_fill"] = round(
            schedule_fill(rg if u else scheds), 4
        )

    # --- NNI+SPR hill climb ----------------------------------------------
    from phylo_utils_tpu.batched import nni_hill_climb

    best_tree = tree
    if "search" in stages:
        t0 = time.perf_counter()
        best_tree, best_ll, n_rounds = nni_hill_climb(
            tree, aln, models.GTR, ncat=4, max_rounds=4, brlen_steps=40,
            moves=args.moves, spr_max_targets=2,
        )
        search_s = time.perf_counter() - t0
        out["search"] = {
            "wall_s": round(search_s, 2),
            "rounds": n_rounds,
            "moves": args.moves,
            "final_loglik": round(best_ll, 4),
            "candidates_per_round": len(nbrs),
            "note": ("wall clock includes per-round TopologySetEngine "
                     "compiles; padded-shape reuse across rounds hits "
                     "the persistent compile cache"),
        }
        print(json.dumps({"stage": "search", **out["search"]}),
              flush=True)

    # --- aLRT / SH-aLRT supports ------------------------------------------
    if "alrt" in stages:
        t0 = time.perf_counter()
        sup = alrt_supports(best_tree, aln, models.GTR, ncat=4,
                            brlen_steps=60)
        alrt_s = time.perf_counter() - t0
        out["alrt"] = {
            "wall_s": round(alrt_s, 2),
            "n_edges": len(sup["edges"]),
            "n_alternatives_batched": 2 * len(sup["edges"]),
            "median_sh_alrt": float(np.median(sup["sh_alrt"])),
        }
        print(json.dumps({"stage": "alrt", **out["alrt"]}), flush=True)

    # --- Felsenstein bootstrap (batched ML distances + NJ) ----------------
    if "boot" in stages:
        t0 = time.perf_counter()
        boot = bootstrap_tree_support(best_tree, aln, models.JC69,
                                      n_reps=args.boot, seed=3)
        boot_s = time.perf_counter() - t0
        out["bootstrap"] = {
            "wall_s": round(boot_s, 2),
            "n_reps": int(boot["n_reps"]),
            "median_support": float(np.median(boot["support"])),
        }
        print(json.dumps({"stage": "boot", **out["bootstrap"]}),
              flush=True)

    # --- partitioned fit ----------------------------------------------------
    if "part" not in stages:
        print(json.dumps(out))
        return
    q = args.sites // 4
    parts = [
        Partition(f"locus{i}", {k: v[i * q:(i + 1) * q]
                                for k, v in aln.items()},
                  models.GTR, ncat=4)
        for i in range(4)
    ]
    from phylo_utils_tpu.partition import StackedPartitionedEngine

    t0 = time.perf_counter()
    # stacked formulation: the loci ride a vmap batch axis of ONE
    # engine, so the program is single-engine-sized;
    # benchmarks/partition_scaling.py holds the looped-vs-stacked curve.
    pe = StackedPartitionedEngine(tree, parts, dtype="float32")
    ll0 = pe.loglikelihood()
    res = fit(pe, max_steps=200, steps_per_call=50, patience=100)
    part_s = time.perf_counter() - t0
    out["partitioned_fit"] = {
        "wall_s": round(part_s, 2),
        "n_partitions": 4,
        "formulation": "stacked",
        "optimizer": "lbfgs x200 steps",
        "loglik_start": round(ll0, 2),
        "loglik_end": round(res.loglik, 2),
        "n_steps": res.n_steps,
        "steps_per_s": round(res.n_steps / part_s, 2),
    }

    print(json.dumps(out))


if __name__ == "__main__":
    main()
