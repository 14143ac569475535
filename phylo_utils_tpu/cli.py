"""Command-line entry points: loglik / fit / simulate / benchmark.

The reference has no CLI (SURVEY.md §5 [HIGH]); this is new design. Typed
config via argparse only — no heavyweight flag framework. Run as
``python -m phylo_utils_tpu.cli <subcommand> ...``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

MODEL_NAMES = (
    "JC69", "K80", "F81", "F84", "HKY85", "TN93", "GTR", "UNREST", "LG",
    "WAG", "GY94", "MG94"
)


def _get_model(name: str):
    from phylo_utils_tpu import models

    if name.lower().endswith(".dat") or os.sep in name:
        # a PAML empirical-matrix file (jones.dat, dayhoff.dat, ...)
        from phylo_utils_tpu.models.protein import empirical_model_from_dat

        try:
            return empirical_model_from_dat(name)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot load PAML .dat model {name!r}: {e}")
    try:
        return models.get_model(name)
    except ValueError:
        raise SystemExit(
            f"unknown model {name!r}; choose from {', '.join(MODEL_NAMES)}, "
            "MK<k>/ORDERED<k> (morphological), or a PAML .dat file path"
        )


def _parse_model_spec(spec: str):
    """'GTR+G4+I+F' -> (model, ncat, inv, emp, rate_model).

    Delegates to :func:`phylo_utils_tpu.models.parse_model_spec` (the
    shared +G[n]/+R[n]/+I/+F convention), resolving the model name with
    the CLI resolver (which also accepts PAML .dat paths)."""
    from phylo_utils_tpu.models import parse_model_spec

    try:
        return parse_model_spec(spec, get_model=_get_model)
    except ValueError as e:
        raise SystemExit(str(e))


def _read_tree(arg: str):
    from phylo_utils_tpu.io import parse_newick

    try:
        with open(arg) as f:
            text = f.read()
    except OSError:
        text = arg
    return parse_newick(text)


def _read_aln(path: str) -> Dict[str, str]:
    from phylo_utils_tpu.io import read_alignment

    return read_alignment(path)


def _json_params(arg: Optional[str]) -> Optional[Dict]:
    return json.loads(arg) if arg else None


def _engine_params(args, engine) -> Optional[Dict]:
    """--params JSON, plus --empirical-freqs observed '+F' frequencies."""
    params = _json_params(args.params) or {}
    init = getattr(engine, "_partition_init_params", None)
    if init:
        # per-partition '+F' observed frequencies; explicit --params wins
        user_parts = dict(params.get("partitions") or {})
        for name, pv in init.get("partitions", {}).items():
            up = dict(user_parts.get(name, {}))
            um = dict(up.get("model", {}))
            for k, v in pv["model"].items():
                um.setdefault(k, v)
            up["model"] = um
            user_parts[name] = up
        params["partitions"] = user_parts
    if getattr(args, "empirical_freqs", False):
        if "freqs" not in engine.model.param_defaults:
            raise SystemExit(
                f"model {engine.model.name!r} has no 'freqs' parameter"
            )
        from phylo_utils_tpu.alphabets import empirical_frequencies

        aln = _read_aln(args.alignment)
        model_p = dict(params.get("model", {}))
        model_p.setdefault(
            "freqs",
            empirical_frequencies(
                aln, engine.model.alphabet, pseudocount=0.5
            ).tolist(),
        )
        params["model"] = model_p
    return params or None


def _add_engine_args(p: argparse.ArgumentParser):
    p.add_argument("--tree", required=True, help="newick file or literal")
    p.add_argument("--alignment", required=True, help="FASTA/PHYLIP file")
    p.add_argument("--model", default="GTR",
                   help="|".join(MODEL_NAMES) + " with optional "
                        "+G[n]/+R[n]/+I/+F suffixes (e.g. GTR+G4+I+F, "
                        "HKY85+R4)")
    p.add_argument("--ncat", type=int, default=1, help="gamma categories")
    # NOTE: the boolean mixture switch is --invariant-sites; --pinv is a
    # FLOAT proportion and only exists on `simulate` (they used to share a
    # name with different semantics — ADVICE.md round 1).
    p.add_argument("--invariant-sites", dest="invariant_sites",
                   action="store_true", help="+I mixture")
    p.add_argument("--params", help="JSON params override")
    p.add_argument("--empirical-freqs", dest="empirical_freqs",
                   action="store_true",
                   help="set model equilibrium frequencies from observed "
                        "character counts (the '+F' convention)")
    p.add_argument("--dtype", default=None, help="float32|float64")
    p.add_argument("--shard-sites", action="store_true",
                   help="shard patterns over all devices")
    p.add_argument("--partitions", default=None,
                   help="RAxML/IQ-TREE-style partition file (or NEXUS "
                        "charsets): per-locus models over one tree; "
                        "entries without a model use --model")
    p.add_argument("--asc", default=None,
                   choices=["lewis", "felsenstein", "stamatakis"],
                   help="ascertainment-bias correction for variable-sites-"
                        "only data (Mk matrices, SNPs); felsenstein/"
                        "stamatakis need --asc-counts")
    p.add_argument("--asc-counts", default=None,
                   help="removed constant-site counts: one number "
                        "(felsenstein) or comma-separated per-state counts "
                        "(stamatakis)")
    p.add_argument("--recode", default=None,
                   help="recode the alignment before analysis: ry (DNA->"
                        "purine/pyrimidine), dayhoff6/sr6/kgb6 (protein->"
                        "6 classes); pair with --model MK2 / MK6")
    p.add_argument("--profile-mixture", default=None,
                   metavar="FILE.nex:NAME",
                   help="frequency-profile mixture (C10-C60/LG4X family) "
                        "from an IQ-TREE models.nex definition; --model "
                        "supplies the shared exchangeability matrix "
                        "(e.g. LG)")


def _build_engine(args):
    import os

    from phylo_utils_tpu.io import load_compressed
    from phylo_utils_tpu.likelihood import LikelihoodEngine

    if getattr(args, "partitions", None):
        if getattr(args, "empirical_freqs", False):
            raise SystemExit(
                "--empirical-freqs is per-partition under --partitions: "
                "use '+F' in the partition file's model strings"
            )
        from phylo_utils_tpu.partition import (
            PartitionedEngine,
            StackedPartitionedEngine,
            partitions_from_file,
        )

        try:
            parts, init = partitions_from_file(
                args.partitions, _read_aln(args.alignment),
                default_model=args.model, get_model=_get_model,
            )
        except ValueError as e:
            raise SystemExit(f"--partitions: {e}")
        sharding = None
        if args.shard_sites:
            from phylo_utils_tpu.parallel import SiteSharding

            sharding = SiteSharding()
        # same-family loci stack on a vmap batch axis of ONE engine
        # (compile cost independent of locus count); heterogeneous
        # mixes fall back to the general inlined-engines formulation
        try:
            engine = StackedPartitionedEngine(
                _read_tree(args.tree), parts, dtype=args.dtype,
                sharding=sharding,
            )
        except ValueError as e:
            if "share the model family" not in str(e):
                raise SystemExit(f"--partitions: {e}")
            engine = PartitionedEngine(
                _read_tree(args.tree), parts, dtype=args.dtype,
                sharding=sharding,
            )
        # stash the +F initial frequencies for _engine_params to merge
        engine._partition_init_params = init
        return engine

    if getattr(args, "profile_mixture", None):
        # FILE.nex:NAME — profile-mixture engine from an IQ-TREE
        # models.nex definition (e.g. the published C10-C60/LG4X files)
        from phylo_utils_tpu.profile_mixtures import (
            profile_mixture_from_nexus,
        )

        spec = args.profile_mixture
        if ":" not in spec:
            raise SystemExit(
                "--profile-mixture expects FILE.nex:MODELNAME"
            )
        path, _, name = spec.rpartition(":")
        base, spec_ncat, spec_inv, _, _ = _parse_model_spec(args.model)
        # the profile classes ARE the mixture axis: silently dropping
        # +G/+I/--recode/--shard-sites would run a different model than
        # the flags specify — refuse instead (ADVICE r4)
        if spec_ncat > 1 or getattr(args, "ncat", 1) > 1 or spec_inv or \
                getattr(args, "invariant_sites", False):
            raise SystemExit(
                "--profile-mixture does not compose with +G/+I rate "
                "heterogeneity (the profile classes are the mixture "
                "axis); use the file's class rates, or drop the suffix"
            )
        if getattr(args, "recode", None) or getattr(args, "shard_sites",
                                                    False):
            raise SystemExit(
                "--profile-mixture does not support --recode/"
                "--shard-sites"
            )
        try:
            return profile_mixture_from_nexus(
                path, name, _read_tree(args.tree),
                _read_aln(args.alignment), base, dtype=args.dtype,
            )
        except (OSError, ValueError) as e:
            raise SystemExit(f"--profile-mixture: {e}")

    sharding = None
    if args.shard_sites:
        from phylo_utils_tpu.parallel import SiteSharding

        sharding = SiteSharding()
    model, spec_ncat, spec_inv, spec_emp, rate_model = \
        _parse_model_spec(args.model)
    # model-string suffixes compose with (and never reduce) the explicit
    # flags: --model GTR+G4+I == --model GTR --ncat 4 --invariant-sites
    args.ncat = max(args.ncat, spec_ncat)
    args.invariant_sites = args.invariant_sites or spec_inv
    if spec_emp and hasattr(args, "empirical_freqs"):
        args.empirical_freqs = True
    if getattr(args, "recode", None):
        from phylo_utils_tpu.alphabets import recode_alignment

        try:
            aln = recode_alignment(_read_aln(args.alignment), args.recode)
        except ValueError as e:
            raise SystemExit(f"--recode: {e}")
    elif os.path.exists(args.alignment):
        # native C++ FASTA->matrix->compression fast path (falls back inside)
        aln = load_compressed(args.alignment, model.alphabet)
    else:
        aln = _read_aln(args.alignment)
    cls = LikelihoodEngine
    extra = {}
    if getattr(args, "asc", None):
        from phylo_utils_tpu.ascertainment import AscertainmentEngine

        cls = AscertainmentEngine
        extra["correction"] = args.asc
        if args.asc_counts is not None:
            counts = [float(x) for x in args.asc_counts.split(",")]
            extra["const_counts"] = (
                counts[0] if len(counts) == 1 else counts
            )
    elif getattr(args, "asc_counts", None):
        raise SystemExit("--asc-counts requires --asc")
    try:
        return cls(
            _read_tree(args.tree),
            aln,
            model,
            ncat=args.ncat,
            invariant_sites=args.invariant_sites,
            rate_model=rate_model,
            dtype=args.dtype,
            sharding=sharding,
            **extra,
        )
    except ValueError as e:
        if getattr(args, "asc", None):
            raise SystemExit(f"--asc: {e}")
        raise


def cmd_loglik(args) -> int:
    engine = _build_engine(args)
    params = engine._full_params(_engine_params(args, engine))
    ll = engine.loglikelihood(params)
    out = {"loglik": ll}
    if hasattr(engine, "partition_loglikelihoods"):
        out["partition_logliks"] = engine.partition_loglikelihoods(params)
    if args.sitewise:
        if hasattr(engine, "partition_loglikelihoods"):
            raise SystemExit(
                "--sitewise is not supported with --partitions (use the "
                "per-partition totals in 'partition_logliks')"
            )
        out["sitewise"] = engine.sitewise_loglikelihoods(params).tolist()
    print(json.dumps(out))
    return 0


def cmd_fit(args) -> int:
    import jax

    from phylo_utils_tpu.optimize import fit
    from phylo_utils_tpu.utils import MetricsLogger, load_checkpoint, save_checkpoint

    engine = _build_engine(args)
    params0 = _engine_params(args, engine)
    resume_from = None
    if args.resume:
        # Full-state checkpoints (written by --checkpoint-every) hold
        # {raw, opt_state} and resume bit-exactly inside fit(); legacy
        # final-params checkpoints just seed params0.
        with np.load(args.resume) as z:
            is_full_state = any(k.startswith("raw") for k in z.files)
        if is_full_state:
            resume_from = args.resume
        else:
            like = engine._full_params(params0)
            state, step0, _ = load_checkpoint(args.resume, like)
            params0 = state
    free = tuple(args.free.split(",")) if args.free else None
    logger = MetricsLogger(args.metrics, echo=args.verbose)
    t0 = time.perf_counter()
    n_pat = (
        int(sum(w.shape[0] for w in engine._weights))
        if isinstance(engine._weights, tuple)
        else int(engine._weights.shape[0])
    )

    def callback(step, ll, params):
        logger.log(step, loglik=ll,
                   patterns_per_s=n_pat * step / (time.perf_counter() - t0))

    res = fit(
        engine, params0, free=free, max_steps=args.max_steps,
        steps_per_call=args.steps_per_call,
        callback=callback if (args.metrics or args.verbose) else None,
        checkpoint_path=args.checkpoint if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every,
        resume_from=resume_from,
    )
    logger.close()
    se = None
    if args.se:
        from phylo_utils_tpu.optimize import standard_errors

        free_t = tuple(args.free.split(",")) if args.free else None
        se = jax.tree.map(
            lambda x: np.asarray(x).tolist(),
            standard_errors(engine, res.params, free=free_t),
        )
    if args.checkpoint and not args.checkpoint_every:
        # legacy final-params checkpoint (resumable full state is written
        # periodically by fit() when --checkpoint-every is given)
        save_checkpoint(args.checkpoint, res.params, step=res.n_steps,
                        extra={"loglik": res.loglik})
    out = {
        "loglik": res.loglik,
        "n_steps": res.n_steps,
        "converged": res.converged,
        "params": jax.tree.map(lambda x: np.asarray(x).tolist(), res.params),
    }
    if se is not None:
        out["standard_errors"] = se
    model = getattr(engine, "model", None)   # PartitionedEngine has none
    if (
        model is not None
        and str(model.alphabet).startswith("codon")
        and "omega" in model.param_defaults
    ):
        from phylo_utils_tpu.models.codon import dn_ds_by_branch

        dd = dn_ds_by_branch(
            model,
            {k: np.asarray(v) for k, v in res.params["model"].items()},
            branch_lengths=np.asarray(res.params["branch_lengths"]),
        )
        out["dn_ds"] = {
            "omega": dd["omega"], "S": dd["S"], "N": dd["N"],
            "dN": dd["dN"].tolist(), "dS": dd["dS"].tolist(),
        }
    print(json.dumps(out))
    return 0


def cmd_simulate(args) -> int:
    import jax

    from phylo_utils_tpu.simulate import simulate_alignment

    aln = simulate_alignment(
        jax.random.key(args.seed),
        _read_tree(args.tree),
        _get_model(args.model),
        args.sites,
        params=_json_params(args.params),
        ncat=args.ncat,
        pinv=args.pinv,
    )
    from phylo_utils_tpu.io import write_fasta

    text = write_fasta(aln, path=args.out)
    if not args.out:
        sys.stdout.write(text)
    return 0


def cmd_benchmark(args) -> int:
    import jax

    engine = _build_engine(args)
    params = engine._full_params(_json_params(args.params))
    fn = engine._jit_fn
    fargs = (params, engine._leaf_partials, engine._weights)
    jax.block_until_ready(fn(*fargs))
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = fn(*fargs)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.iters
    n_pat = int(engine._weights.shape[0])
    n_dev = len(jax.devices())
    print(json.dumps({
        "patterns_per_s": n_pat / dt,
        "patterns_per_s_per_chip": n_pat / dt / n_dev,
        "step_ms": dt * 1e3,
        "n_patterns": n_pat,
        "n_devices": n_dev,
    }))
    return 0


def cmd_distances(args) -> int:
    from phylo_utils_tpu.optimize import ml_distance_matrix

    model = _get_model(args.model)
    aln = _read_aln(args.alignment)
    d = ml_distance_matrix(aln, model, params=_json_params(args.params))
    names = list(aln)
    if args.format == "phylip":
        lines = [str(len(names))]
        for i, nm in enumerate(names):
            lines.append(nm + "  " + " ".join(f"{x:.6f}" for x in d[i]))
        print("\n".join(lines))
    else:
        print(json.dumps({"names": names, "distances": d.tolist()}))
    return 0


def cmd_lmap(args) -> int:
    """Likelihood mapping: quartet-resolution diagnostic of an alignment."""
    from phylo_utils_tpu.topology_tests import likelihood_mapping

    model, ncat, inv, emp, _rate_model = _parse_model_spec(args.model)
    if ncat > 1 or inv or emp:
        raise SystemExit(
            "lmap uses a plain single-rate model (drop +G/+R/+I/+F; pass "
            "explicit frequencies via --params if needed)"
        )
    out = likelihood_mapping(
        _read_aln(args.alignment), model,
        params=(_json_params(args.params) or {}).get("model"),
        n_quartets=args.n_quartets, seed=args.seed,
    )
    print(json.dumps({
        "basins": out["basins"].tolist(),
        "resolved": out["resolved"],
        "star": out["star"],
        "n_quartets": int(out["points"].shape[0]),
        "points": out["points"].round(4).tolist() if args.points else None,
    }))
    return 0


def cmd_consense(args) -> int:
    """Majority-rule consensus of a newick tree sample."""
    from phylo_utils_tpu.io import parse_newick_forest, write_newick
    from phylo_utils_tpu.trees import majority_rule_consensus

    trees = parse_newick_forest(args.trees)
    cons = majority_rule_consensus(trees, min_freq=args.min_freq)
    text = write_newick(cons)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps({"n_trees": len(trees), "consensus": text}))
    return 0


def cmd_topologies(args) -> int:
    from phylo_utils_tpu.batched import TopologySetEngine
    from phylo_utils_tpu.io import parse_newick_forest

    trees = parse_newick_forest(args.trees)
    model = _get_model(args.model)
    tse = TopologySetEngine(
        trees, _read_aln(args.alignment), model, ncat=args.ncat,
        dtype=args.dtype,
    )
    params = _json_params(args.params)
    out = {"n_trees": len(trees)}
    if args.test:
        from phylo_utils_tpu.topology_tests import au_test, kh_test, sh_test

        sw = tse.sitewise_loglikelihoods(params)
        out["logliks"] = sw.sum(axis=1).tolist()
        out["best_index"] = int(np.argmax(out["logliks"]))
        which = (("kh", "sh", "au") if args.test == "all"
                 else (args.test,))
        runners = {"kh": kh_test, "sh": sh_test, "au": au_test}
        def _clean(v):
            # +-inf (AU's degenerate-BP d statistic) is not valid JSON
            if isinstance(v, list):
                return [_clean(x) for x in v]
            if isinstance(v, float) and not np.isfinite(v):
                return None
            return v

        for name in which:
            res = runners[name](sw, n_boot=args.n_boot, seed=args.seed)
            out[name] = {
                k: _clean(v.tolist() if hasattr(v, "tolist") else v)
                for k, v in res.items()
            }
    else:
        lls = tse.loglikelihoods(params)
        out["logliks"] = lls.tolist()
        out["best_index"] = int(lls.argmax())
    print(json.dumps(out))
    return 0


def cmd_search(args) -> int:
    from phylo_utils_tpu.batched import nni_hill_climb
    from phylo_utils_tpu.io import write_newick

    best_tree, best_ll, rounds = nni_hill_climb(
        _read_tree(args.tree),
        _read_aln(args.alignment),
        _get_model(args.model),
        ncat=args.ncat,
        max_rounds=args.max_rounds,
        moves=args.moves,
        verbose=args.verbose,
    )
    out = {
        "loglik": best_ll,
        "rounds": rounds,
        "tree": write_newick(best_tree),
    }
    if args.out:
        with open(args.out, "w") as f:
            f.write(out["tree"] + "\n")
    print(json.dumps(out))
    return 0


def cmd_ancestral(args) -> int:
    from phylo_utils_tpu.ancestral import (
        ancestral_posteriors,
        site_rate_posteriors,
    )

    engine = _build_engine(args)
    params = _json_params(args.params)
    post = ancestral_posteriors(engine, params)
    map_states = post.argmax(axis=2)
    out = {
        "n_internal_nodes": post.shape[0],
        "n_sites": post.shape[1],
        "map_states": map_states.tolist(),
        "max_posterior": post.max(axis=2).tolist(),
    }
    # MAP sequences: per-state characters from the model's alphabet
    from phylo_utils_tpu.simulate import _state_chars

    chars = _state_chars(engine.model)
    tree = engine.tree
    seqs = {}
    for k in range(post.shape[0]):
        nid = tree.n_leaves + k
        label = tree.names[nid] or f"node{nid}"
        seqs[label] = "".join(chars[map_states[k]])
    out["map_sequences"] = seqs
    if args.out_fasta:
        from phylo_utils_tpu.io import write_fasta

        write_fasta(seqs, path=args.out_fasta)
    if args.joint:
        from phylo_utils_tpu.ancestral import joint_ancestral_states

        joint = joint_ancestral_states(engine, params)
        out["joint_states"] = joint["states"].tolist()
        out["joint_log_prob"] = joint["log_prob"].tolist()
        jseqs = {}
        for k2 in range(joint["states"].shape[0]):
            nid = tree.n_leaves + k2
            label = tree.names[nid] or f"node{nid}"
            jseqs[label] = "".join(chars[joint["states"][k2]])
        out["joint_sequences"] = jseqs
        if args.out_fasta:
            from phylo_utils_tpu.io import write_fasta

            # ALWAYS a distinct path: the marginal MAP FASTA already
            # went to args.out_fasta itself
            write_fasta(jseqs, path=args.out_fasta + ".joint")
    if args.full:
        out["posteriors"] = post.tolist()
    if args.ncat > 1:
        out["site_rate_posteriors"] = site_rate_posteriors(
            engine, params
        ).tolist()
    print(json.dumps(out))
    return 0


def cmd_bootstrap(args) -> int:
    engine = _build_engine(args)
    boots = engine.bootstrap_loglikelihoods(
        args.replicates, _json_params(args.params), seed=args.seed
    )
    print(json.dumps({
        "n_replicates": len(boots),
        "mean": float(boots.mean()),
        "std": float(boots.std()),
        "quantiles": {
            "q025": float(np.quantile(boots, 0.025)),
            "q500": float(np.quantile(boots, 0.5)),
            "q975": float(np.quantile(boots, 0.975)),
        },
        "logliks": boots.tolist() if args.full else None,
    }))
    return 0


def cmd_build_tree(args) -> int:
    from phylo_utils_tpu.io import write_newick
    from phylo_utils_tpu.nj import neighbor_joining
    from phylo_utils_tpu.optimize import ml_distance_matrix

    model = _get_model(args.model)
    aln = _read_aln(args.alignment)
    d = ml_distance_matrix(aln, model, params=_json_params(args.params))
    tree = neighbor_joining(d, list(aln))
    ll = None
    if args.refine:
        from phylo_utils_tpu.batched import nni_hill_climb

        tree, ll, _ = nni_hill_climb(tree, aln, model, ncat=args.ncat,
                                     moves=args.moves)
    text = write_newick(tree)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    out = {"tree": text, "loglik": ll,
           "method": "nj+" + args.moves if args.refine else "nj"}
    if args.bootstrap:
        from phylo_utils_tpu.supports import bootstrap_tree_support

        bs = bootstrap_tree_support(
            tree, aln, model, n_reps=args.bootstrap,
            params=_json_params(args.params), consensus=True, tbe=True,
        )
        out["bootstrap_support"] = {
            str(int(e)): float(s)
            for e, s in zip(bs["edges"], bs["support"])
        }
        out["tbe_support"] = {
            str(int(e)): float(s)
            for e, s in zip(bs["edges"], bs["tbe"])
        }
        out["consensus_tree"] = write_newick(bs["consensus"])
        if args.out:
            with open(args.out + ".consensus", "w") as f:
                f.write(out["consensus_tree"] + "\n")
    print(json.dumps(out))
    return 0


def cmd_serve(args) -> int:
    from phylo_utils_tpu.server import serve

    serve(_build_engine(args), host=args.host, port=args.port)
    return 0


def cmd_compare(args) -> int:
    from phylo_utils_tpu.model_selection import compare_models

    fits = compare_models(
        _read_tree(args.tree),
        _read_aln(args.alignment),
        candidates=args.models.split(",") if args.models else None,
        criterion=args.criterion,
        max_steps=args.max_steps,
    )
    print(json.dumps({
        "ranked": [f.as_dict() for f in fits],
        "best": fits[0].name,
        "criterion": args.criterion,
    }))
    return 0


def cmd_partition_finder(args) -> int:
    from phylo_utils_tpu.io import parse_partition_file
    from phylo_utils_tpu.model_selection import partition_finder
    from phylo_utils_tpu.partition import _expand_ranges

    aln = _read_aln(args.alignment)
    n_sites = len(next(iter(aln.values())))
    try:
        specs = parse_partition_file(args.subsets)
        subsets = {
            s["name"]: _expand_ranges(s["ranges"], n_sites) for s in specs
        }
        res = partition_finder(
            _read_tree(args.tree), aln, subsets,
            candidates=args.models.split(",") if args.models else None,
            criterion=args.criterion, merge=not args.no_merge,
            max_steps=args.max_steps,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    for row in res["scheme"]:
        row["n_sites"] = len(row.pop("columns"))
    print(json.dumps(res))
    return 0


def _codon_freq_setup(aln, method):
    """(params0, base_free) for codon engines: empirical codon frequencies
    held FIXED (codeml's CodonFreq convention) with kappa free, or the
    uniform default with the whole shared block free."""
    if method == "uniform":
        return None, ("branch_lengths", "shared")
    from phylo_utils_tpu.models.codon import empirical_codon_frequencies

    f = empirical_codon_frequencies(aln, method)
    return (
        {"shared": {"freqs": f.tolist()}},
        ("branch_lengths", "shared.kappa"),
    )


def cmd_site_test(args) -> int:
    """codeml-style site-model positive-selection LRTs (M1a/M2a, M7/M8)."""
    import jax

    from phylo_utils_tpu.io import encode_codon_alignment
    from phylo_utils_tpu.mixtures import (
        M1aEngine,
        M2aEngine,
        M7Engine,
        M8Engine,
        m1a_m2a_test,
        omega_posteriors,
        positive_selection_test,
    )
    from phylo_utils_tpu.optimize import fit

    tree = _read_tree(args.tree)
    aln = _read_aln(args.alignment)
    ca = encode_codon_alignment(aln)
    kw = {"dtype": args.dtype}
    # codeml convention: codon frequencies FIXED at their empirical
    # estimate (CodonFreq); kappa free via the dotted parameter name
    params0, base_free = _codon_freq_setup(aln, args.codon_freqs)
    if args.test == "m1a-m2a":
        null = M1aEngine(tree, ca, **kw)
        free = base_free + ("proportions", "omega0")
        res_null = fit(null, params0=params0, free=free,
                       max_steps=args.max_steps)
        alt = M2aEngine(tree, ca, **kw)
        res_alt = fit(alt, params0=params0, free=free + ("omega2_delta",),
                      max_steps=args.max_steps)
        lrt = m1a_m2a_test(res_null.loglik, res_alt.loglik)
    else:  # m7-m8
        null = M7Engine(tree, ca, ncat=args.ncat, **kw)
        free = base_free + ("beta_p", "beta_q")
        res_null = fit(null, params0=params0, free=free,
                       max_steps=args.max_steps)
        alt = M8Engine(tree, ca, ncat=args.ncat, **kw)
        res_alt = fit(alt, params0=params0, free=free + ("p0", "omega_delta"),
                      max_steps=args.max_steps)
        lrt = positive_selection_test(res_null.loglik, res_alt.loglik)
    mean_omega, gam = omega_posteriors(alt, res_alt.params)
    out = {
        "test": args.test,
        "loglik_null": res_null.loglik,
        "loglik_alt": res_alt.loglik,
        "lrt": lrt,
        "alt_params": jax.tree.map(
            lambda x: np.asarray(x).tolist(), res_alt.params
        ),
    }
    if args.sites:
        # NEB site scan: the last class is the omega>1 class in both tests
        out["site_mean_omega"] = np.asarray(mean_omega).tolist()
        out["site_positive_posterior"] = np.asarray(gam[:, -1]).tolist()
    if args.beb:
        if args.test != "m1a-m2a":
            raise SystemExit("--beb requires --test m1a-m2a (M2a BEB)")
        from phylo_utils_tpu.mixtures import beb_site_posteriors

        p_pos, mean_w = beb_site_posteriors(alt, res_alt.params)
        out["beb_positive_posterior"] = np.asarray(p_pos).tolist()
        out["beb_mean_omega"] = np.asarray(mean_w).tolist()
    print(json.dumps(out))
    return 0


def cmd_branch_site_test(args) -> int:
    """Branch-site Model A positive-selection LRT on a foreground clade."""
    import jax

    from phylo_utils_tpu.branch_models import (
        branch_site_test,
        mark_branches,
        mark_clade,
    )
    from phylo_utils_tpu.io import encode_codon_alignment

    tree = _read_tree(args.tree)
    aln = _read_aln(args.alignment)
    ca = encode_codon_alignment(aln)
    names = args.foreground.split(",")
    fg = (mark_clade(tree, names) if args.clade and len(names) > 1
          else mark_branches(tree, names))
    params0, _ = _codon_freq_setup(aln, args.codon_freqs)
    res = branch_site_test(
        tree, ca, fg,
        params0=params0,
        engine_kwargs={"dtype": args.dtype},
        max_steps=args.max_steps,
    )
    print(json.dumps({
        "loglik_null": res["null"].loglik,
        "loglik_alt": res["alt"].loglik,
        "lrt": res["lrt"],
        "alt_params": jax.tree.map(
            lambda x: np.asarray(x).tolist(), res["alt"].params
        ),
    }))
    return 0


def cmd_clock_test(args) -> int:
    """Molecular-clock LRT: strict clock vs unconstrained branch lengths."""
    import jax

    from phylo_utils_tpu.clock import clock_test

    out = clock_test(
        _read_tree(args.tree),
        _read_aln(args.alignment),
        _get_model(args.model),
        ncat=args.ncat,
        max_steps=args.max_steps,
    )
    from phylo_utils_tpu.io import write_newick

    print(json.dumps({
        "loglik_clock": out["null"].loglik,
        "loglik_unconstrained": out["alt"].loglik,
        "df": out["df"],
        "lrt": out["lrt"],
        "chronogram": write_newick(
            out["null_engine"].chronogram(out["null"].params)
        ),
    }))
    return 0


def cmd_date(args) -> int:
    """Penalized-likelihood dating: relative, CV-lambda, or calibrated."""
    from phylo_utils_tpu.clock import (
        cross_validate_lambda,
        penalized_likelihood_dating,
    )
    from phylo_utils_tpu.io import write_newick

    tree = _read_tree(args.tree)
    calibrations = {}
    for spec in args.calibrate:
        if "=" not in spec:
            raise SystemExit(
                f"--calibrate {spec!r}: expected LEAF,...=AGE or "
                "LEAF,...=MIN:MAX"
            )
        leaves, _, bounds = spec.partition("=")
        key = tuple(s.strip() for s in leaves.split(","))
        if ":" in bounds:
            lo, _, hi = bounds.partition(":")
            calibrations[key] = (
                float(lo) if lo else None, float(hi) if hi else None
            )
        else:
            calibrations[key] = float(bounds)
    lam = args.lam
    cv = None
    if args.cv_lambda:
        grid = tuple(float(x) for x in args.cv_lambda.split(","))
        cv = cross_validate_lambda(
            tree, args.sites, lambdas=grid, root_age=args.root_age,
            steps=args.steps,
        )
        lam = cv["lambda"]
    out = penalized_likelihood_dating(
        tree, args.sites, root_age=args.root_age, lam=lam,
        steps=args.steps, calibrations=calibrations or None,
    )
    payload = {
        "lambda": lam,
        "ages": {str(k): v for k, v in out["ages"].items()},
        "max_calibration_violation": out["max_calibration_violation"],
        "objective": out["objective"],
        "chronogram": write_newick(out["chronogram"]),
    }
    if cv is not None:
        payload["cv_scores"] = {str(k): v for k, v in cv["scores"].items()}
    print(json.dumps(payload))
    return 0


def cmd_supports(args) -> int:
    """aLRT / SH-aLRT branch supports on a fixed topology."""
    from phylo_utils_tpu.io import write_newick
    from phylo_utils_tpu.supports import alrt_supports, site_concordance

    scf = None
    if args.scf:
        scf = site_concordance(
            _read_tree(args.tree), _read_aln(args.alignment),
            n_quartets=args.scf,
        )
    out = alrt_supports(
        _read_tree(args.tree), _read_aln(args.alignment),
        _get_model(args.model), ncat=args.ncat,
        params=_json_params(args.params), n_boot=args.replicates,
    )
    tree = out["tree"]
    payload = {
        "loglik": out["loglik"],
        "tree": write_newick(tree),
        "edges": [{
            "node": int(e),
            "clade": sorted(
                n for i, n in enumerate(tree.leaf_names)
                if _in_clade(tree, int(e), i)
            ),
            "stat": float(s),
            "alrt": float(a),
            "sh_alrt": float(sh),
            "abayes": float(ab),
        } for e, s, a, sh, ab in zip(out["edges"], out["stat"],
                                     out["alrt"], out["sh_alrt"],
                                     out["abayes"])],
    }
    if scf is not None:
        payload["scf"] = {
            str(int(e)): {"scf": float(c), "sdf1": float(d1),
                          "sdf2": float(d2)}
            for e, c, d1, d2 in zip(scf["edges"], scf["scf"],
                                    scf["sdf1"], scf["sdf2"])
        }
    print(json.dumps(payload))
    return 0


def _in_clade(tree, anc: int, leaf: int) -> bool:
    n = leaf
    while n != -1:
        if n == anc:
            return True
        n = int(tree.parent[n])
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="phylo_utils_tpu",
        description="phylogenetic likelihood engine on JAX",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("loglik", help="compute log-likelihood")
    _add_engine_args(p)
    p.add_argument("--sitewise", action="store_true")
    p.set_defaults(fn=cmd_loglik)

    p = sub.add_parser("fit", help="optimize branch lengths + model params")
    _add_engine_args(p)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument("--steps-per-call", type=int, default=10,
                   help="optimizer steps fused per device dispatch")
    p.add_argument("--free", help="comma-separated free parameter names")
    p.add_argument("--checkpoint", help="write final params checkpoint here "
                   "(with --checkpoint-every: resumable full optimizer "
                   "state, written periodically)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint cadence in optimizer steps (0 = only "
                        "final params)")
    p.add_argument("--resume", help="resume from checkpoint (full-state "
                   "checkpoints resume bit-exactly incl. optimizer state)")
    p.add_argument("--metrics", help="JSONL metrics path")
    p.add_argument("--se", action="store_true",
                   help="report asymptotic standard errors (exact Hessian)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("simulate", help="simulate an alignment")
    p.add_argument("--tree", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--sites", type=int, required=True)
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--pinv", type=float, default=0.0)
    p.add_argument("--params", help="JSON params")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="output FASTA path (default stdout)")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("benchmark", help="pruning throughput")
    _add_engine_args(p)
    p.add_argument("--iters", type=int, default=30)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("distances", help="pairwise ML distance matrix")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--params", help="JSON model params")
    p.add_argument("--format", default="json", choices=["json", "phylip"])
    p.set_defaults(fn=cmd_distances)

    p = sub.add_parser("lmap",
                       help="likelihood mapping (quartet resolution "
                            "diagnostic, Strimmer-von Haeseler)")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--params", help="JSON params ({'model': {...}})")
    p.add_argument("--n-quartets", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--points", action="store_true",
                   help="include the simplex points in the output")
    p.set_defaults(fn=cmd_lmap)

    p = sub.add_parser("consense",
                       help="majority-rule consensus of a tree sample")
    p.add_argument("--trees", required=True,
                   help="newick file with multiple ';'-separated trees")
    p.add_argument("--min-freq", type=float, default=0.5,
                   help="keep splits in MORE than this fraction (>=0.5)")
    p.add_argument("--out", help="write consensus newick here")
    p.set_defaults(fn=cmd_consense)

    p = sub.add_parser("topologies",
                       help="score a set of candidate trees in one program")
    p.add_argument("--trees", required=True,
                   help="newick file with multiple ';'-separated trees")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--params", help="JSON params")
    p.add_argument("--dtype", default=None)
    p.add_argument("--test", choices=["kh", "sh", "au", "all"],
                   help="RELL topology significance test(s) to run")
    p.add_argument("--n-boot", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_topologies)

    p = sub.add_parser("search", help="greedy NNI/SPR tree search")
    p.add_argument("--tree", required=True, help="starting tree")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--moves", default="nni", choices=["nni", "spr", "both"])
    p.add_argument("--max-rounds", type=int, default=20)
    p.add_argument("--out", help="write best tree (newick) here")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("ancestral", help="ancestral state reconstruction")
    _add_engine_args(p)
    p.add_argument("--full", action="store_true",
                   help="emit full posterior tensors (large)")
    p.add_argument("--out-fasta", dest="out_fasta",
                   help="write MAP ancestral sequences as FASTA here")
    p.add_argument("--joint", action="store_true",
                   help="also run JOINT ML reconstruction (Pupko 2000 "
                        "max-product DP); with --out-fasta the joint "
                        "sequences go to <out>.joint")
    p.set_defaults(fn=cmd_ancestral)

    p = sub.add_parser("bootstrap", help="bootstrap logL replicates")
    _add_engine_args(p)
    p.add_argument("--replicates", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true", help="emit all replicates")
    p.set_defaults(fn=cmd_bootstrap)

    p = sub.add_parser("build-tree",
                       help="de novo: ML distances -> NJ (-> NNI/SPR refine)")
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="JC69")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--params", help="JSON model params")
    p.add_argument("--refine", action="store_true",
                   help="NNI/SPR hill-climb from the NJ tree")
    p.add_argument("--moves", default="nni", choices=["nni", "spr", "both"])
    p.add_argument("--out", help="write newick here")
    p.add_argument("--bootstrap", type=int, default=0, metavar="B",
                   help="B Felsenstein bootstrap replicates: per-edge "
                        "supports + majority-rule consensus tree "
                        "(written to <out>.consensus)")
    p.set_defaults(fn=cmd_build_tree)

    p = sub.add_parser("serve", help="HTTP inference server for one engine")
    _add_engine_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("compare", help="model selection (AIC/AICc/BIC)")
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--models", help="comma list, e.g. JC69,HKY85+G,GTR+G+I")
    p.add_argument("--criterion", default="bic",
                   choices=["aic", "aicc", "bic"])
    p.add_argument("--max-steps", type=int, default=200)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser(
        "partitionfinder",
        help="best model per subset + greedy scheme merging "
             "(PartitionFinder-style)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--subsets", required=True,
                   help="partition file defining the INITIAL subsets "
                        "(RAxML lines or NEXUS charsets; models in the "
                        "file are ignored — selection picks them)")
    p.add_argument("--models", help="comma list of candidate model strings")
    p.add_argument("--criterion", default="bic",
                   choices=["aic", "aicc", "bic"])
    p.add_argument("--no-merge", action="store_true",
                   help="only pick per-subset models; skip greedy merging")
    p.add_argument("--max-steps", type=int, default=200)
    p.set_defaults(fn=cmd_partition_finder)

    p = sub.add_parser(
        "site-test",
        help="positive-selection LRT over sites (codeml M1a/M2a, M7/M8)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True,
                   help="in-frame codon alignment (FASTA/PHYLIP)")
    p.add_argument("--test", default="m1a-m2a",
                   choices=["m1a-m2a", "m7-m8"])
    p.add_argument("--ncat", type=int, default=10,
                   help="beta discretization classes (m7-m8)")
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--sites", action="store_true",
                   help="emit the per-site NEB positive-selection scan")
    p.add_argument("--beb", action="store_true",
                   help="emit the BEB site scan (Yang-Wong-Nielsen 2005; "
                        "m1a-m2a only)")
    p.add_argument("--codon-freqs", default="f3x4",
                   choices=["f3x4", "f1x4", "f61", "uniform"],
                   help="empirical codon frequencies, held fixed "
                        "(codeml CodonFreq; 'uniform' frees the whole "
                        "shared block instead)")
    p.add_argument("--dtype", default=None)
    p.set_defaults(fn=cmd_site_test)

    p = sub.add_parser(
        "branch-site-test",
        help="branch-site Model A LRT (foreground lineage selection)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True,
                   help="in-frame codon alignment (FASTA/PHYLIP)")
    p.add_argument("--foreground", required=True,
                   help="comma-separated node names marking foreground edges")
    p.add_argument("--clade", action="store_true",
                   help="treat --foreground names as a clade (mark the whole "
                        "subtree under their MRCA)")
    p.add_argument("--codon-freqs", default="f3x4",
                   choices=["f3x4", "f1x4", "f61", "uniform"],
                   help="empirical codon frequencies, held fixed "
                        "(codeml CodonFreq; 'uniform' frees the whole "
                        "shared block instead)")
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--dtype", default=None)
    p.set_defaults(fn=cmd_branch_site_test)

    p = sub.add_parser(
        "clock-test",
        help="molecular-clock LRT (strict clock vs free branch lengths)",
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=200)
    p.set_defaults(fn=cmd_clock_test)

    p = sub.add_parser(
        "date",
        help="penalized-likelihood divergence dating (Sanderson/r8s)",
    )
    p.add_argument("--tree", required=True,
                   help="fitted phylogram (lengths in subs/site)")
    p.add_argument("--sites", type=int, required=True,
                   help="alignment length the phylogram was fitted on")
    p.add_argument("--lam", type=float, default=1.0,
                   help="rate-autocorrelation smoothing strength")
    p.add_argument("--cv-lambda", default=None,
                   help="comma list of lambdas: pick by Sanderson "
                        "cross-validation instead of --lam")
    p.add_argument("--root-age", type=float, default=1.0,
                   help="relative-mode root age (ignored with --calibrate)")
    p.add_argument("--calibrate", action="append", default=[],
                   metavar="LEAF,LEAF,...=AGE | LEAF,...=MIN:MAX",
                   help="absolute age (or min:max interval) for the MRCA "
                        "of the listed leaves; repeatable")
    p.add_argument("--steps", type=int, default=2000)
    p.set_defaults(fn=cmd_date)

    p = sub.add_parser(
        "supports", help="aLRT / SH-aLRT branch supports (NNI-based)"
    )
    p.add_argument("--tree", required=True)
    p.add_argument("--alignment", required=True)
    p.add_argument("--model", default="GTR")
    p.add_argument("--ncat", type=int, default=1)
    p.add_argument("--params", help="JSON model params (held fixed)")
    p.add_argument("--replicates", type=int, default=1000,
                   help="RELL replicates for SH-aLRT")
    p.add_argument("--scf", type=int, default=0, metavar="Q",
                   help="also report site concordance factors from Q "
                        "sampled quartets per branch (IQ-TREE --scf)")
    p.set_defaults(fn=cmd_supports)

    args = ap.parse_args(argv)
    if getattr(args, "dtype", None) == "float64":
        # float64 silently truncates to f32 unless x64 is enabled; the CLI
        # is the process entry point, so enabling here is safe (no arrays
        # have been created yet).
        import jax

        jax.config.update("jax_enable_x64", True)
    from phylo_utils_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
