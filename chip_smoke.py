"""GPU smoke run of the likelihood engine's main path.

    python chip_smoke.py            # one card: five phases
    python chip_smoke.py --four     # site sharding over four cards only

Drives the entry points a user calls (``LikelihoodEngine``, ``optimize.fit``,
``server.EngineServer``, ``cli.main``) on the card at realistic sizes, and
checks every result against the engine in float64 and the float64 numpy
oracle (``oracle/``):

1. DNA: 128 taxa, GTR+G4+I, 100,000 unique simulated patterns; logL,
   gradient and 5 fit steps; f32 vs f64 over all patterns, f64 vs oracle on
   a 2,048-pattern slice; the kernel count of one forward evaluation.
2. Protein: 32 taxa, LG+G4, 8,192 patterns; logL and gradient.
3. Codon: GY94 M0, 64 taxa, 2,048 codon patterns; logL and gradient.
4. Server: ``EngineServer`` on the phase-1 engine, on localhost.
5. CLI: ``cli.main(["loglik"|"fit", ...])`` on files written from the seed.

Each phase prints one JSON line. The last line of standard output is
``{"ok": true, "device": {...}}``. Without a GPU the script exits non-zero
before computing anything; any failed check raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# relative logL bounds and the gradient bound (see the module docstring)
F32_VS_F64 = 1e-6
F64_VS_ORACLE = 1e-9
GRAD_RTOL = 1e-4
SHARDED_VS_SINGLE = 1e-9

# phase-1 model: GTR+G4+I. The data are simulated under these values; the
# engines are evaluated, and fits start, at the engine's defaults
# (DNA_START), as a user's fit does.
GTR_RATES = (1.2, 3.9, 0.8, 1.1, 4.6, 1.0)
DNA_FREQS = (0.3, 0.2, 0.22, 0.28)
ALPHA, PINV = 0.6, 0.15
DNA_START = {"model": {"rates": (1.0,) * 6, "freqs": (0.25,) * 4},
             "alpha": 0.5, "pinv": 0.2}


@dataclasses.dataclass(frozen=True)
class Sizes:
    dna_taxa: int = 128            # BASELINE config 5 width
    dna_patterns: int = 100_000
    oracle_patterns: int = 2048
    fit_steps: int = 5
    prot_taxa: int = 32            # BASELINE config 4 width
    prot_patterns: int = 8192
    codon_taxa: int = 64
    codon_patterns: int = 2048
    cli_taxa: int = 32
    cli_sites: int = 2000
    server_fit_steps: int = 3
    four_fit_steps: int = 3


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


def check(ok: bool, what: str, **numbers) -> None:
    if not ok:
        raise SmokeFailure(f"{what}: {numbers}")


# -- native library ---------------------------------------------------------

def build_native() -> str:
    """Build the native data-path library from its tracked source, never
    trusting a ``_phyloio.so`` copied in with the tree."""
    so = os.path.join(REPO, "phylo_utils_tpu", "native", "_phyloio.so")
    if os.path.exists(so):
        os.remove(so)
    from phylo_utils_tpu import native

    check(native.native_available() and os.path.exists(so),
          "native library build")
    return so


# -- measurement helpers ----------------------------------------------------

def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def timed(fn, reps: int = 3):
    """(result, first-call ms, median steady ms). The first call includes
    compilation, so it is set-up time."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = _ms(t0)
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        steady.append(_ms(t0))
    return out, first, statistics.median(steady)


def memory_dict(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


_NO_LAUNCH = {"parameter", "constant", "get-tuple-element", "tuple",
              "bitcast", "call", "while", "conditional", "after-all",
              "partition-id", "replica-id", "opt-barrier"}


def kernel_count(hlo_text: str) -> dict:
    """Operations of an optimized HLO module that launch device work,
    counted by opcode outside fusion bodies and reducer computations. A
    while body is counted once, not once per trip."""
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and not line.startswith(" "):
            cur = head.group(2)
            comps[cur] = []
        elif line.startswith("}"):
            cur = None
        elif cur is not None and " = " in line:
            comps[cur].append(line)
    inner = set()
    for lines in comps.values():
        for line in lines:
            for ref in re.findall(r"(?:calls|to_apply)=%?([\w.\-]+)", line):
                if " fusion(" in line or "to_apply=" in line:
                    inner.add(ref)
    counts = collections.Counter()
    for name, lines in comps.items():
        if name in inner:
            continue
        for line in lines:
            m = re.search(r"=\s.*?\s([a-z][a-z0-9\-]*)\(", line)
            if m and m.group(1) not in _NO_LAUNCH:
                counts[m.group(1)] += 1
    return {"total": sum(counts.values()), "by_opcode": dict(counts)}


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def grad_rel_err(g, g_ref) -> float:
    """Largest |g - g_ref| over every leaf, each leaf scaled by its own
    largest |g_ref| (a gradient's near-zero entries carry no relative
    precision of their own)."""
    import jax
    import numpy as np

    worst = 0.0
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        worst = max(worst, float(np.max(np.abs(a - b))
                                 / max(float(np.max(np.abs(b))), 1e-300)))
    return worst


# -- data -------------------------------------------------------------------

def simulated_patterns(tree, model, n_patterns: int, params: dict, ncat: int,
                       pinv: float, seed: int):
    """A CompressedAlignment of the first ``n_patterns`` unique columns of
    an alignment simulated under ``model`` on the device."""
    import jax
    import numpy as np

    from phylo_utils_tpu import io as pio
    from phylo_utils_tpu.simulate import simulate_alignment

    n_sites = n_patterns + n_patterns // 4 + 16
    for attempt in range(6):
        aln = simulate_alignment(jax.random.key(seed + attempt), tree, model,
                                 n_sites, params=params, ncat=ncat,
                                 pinv=pinv)
        ca = pio.compress_patterns(aln, model.alphabet, dtype=np.float64)
        if ca.n_patterns >= n_patterns:
            return pio.CompressedAlignment(
                names=ca.names,
                partials=ca.partials[:, :n_patterns],
                weights=ca.weights[:n_patterns],
                site_to_pattern=np.arange(n_patterns, dtype=np.int32),
            )
        n_sites *= 2
    raise SmokeFailure(f"could not simulate {n_patterns} unique patterns")


def oracle_slice(tree, ca, n: int):
    """(leaf partials in tree leaf order, weights) of the first n patterns."""
    import numpy as np

    order = [ca.names.index(name) for name in tree.leaf_names]
    lp = np.asarray(ca.partials, np.float64)[order][:, :n]
    return lp, np.asarray(ca.weights, np.float64)[:n]


def f64_vs_oracle(engine64, params, tree, ca, om, rates, pinv, n):
    """Relative logL error of the f64 engine against the oracle on the
    first ``n`` patterns."""
    import numpy as np

    from oracle import core as oracle

    sw = engine64.sitewise_loglikelihoods(params, per_pattern=True)[:n]
    lp, w = oracle_slice(tree, ca, n)
    ours = float(np.dot(w, np.asarray(sw, np.float64)))
    gold = oracle.loglikelihood(tree, {}, om, rates=rates, pinv=pinv,
                                pattern_weights=w, leaf_partials=lp)
    return ours, gold


def _base_record(phase: str, card: str, device) -> dict:
    return {"phase": phase, "card": card, "platform": device.platform,
            "device_kind": device.device_kind}


def compiled_forward(engine, params):
    """The compiled program ``engine.loglikelihood`` runs (cached eigen
    and gamma rates)."""
    full = engine._full_params(params)
    eig = engine.model_eigen(full)
    rates = engine.model_rates(full)
    if rates is not None:
        return engine._jit_fn_eig_rates.lower(
            full, eig, rates, engine._leaf_partials, engine._weights
        ).compile()
    return engine._jit_fn_eig.lower(
        full, eig, engine._leaf_partials, engine._weights).compile()


def parity_phase(phase, card, tree, ca, model, params, om, rates, pinv,
                 n_oracle, truth, fit_steps=0, **engine_kw):
    """logL + gradient (+ fit) of the f32 engine at ``params`` (a fit's
    starting point), checked against the f64 engine over all patterns and
    the oracle (``om``, ``rates``, ``pinv``: the same model) on a slice.
    The gradient is also compared at ``truth``, the parameters the data
    were simulated under, and reported without a bound: there the
    gradient is a sum over all patterns that nearly cancels, and f32
    keeps fewer of its digits. Returns (record, f32 engine)."""
    import jax

    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.optimize import fit

    dev = jax.devices()[0]
    rec = _base_record(phase, card, dev)
    t0 = time.perf_counter()
    e32 = LikelihoodEngine(tree, ca, model, dtype="float32", **engine_kw)
    e64 = LikelihoodEngine(tree, ca, model, dtype="float64", **engine_kw)
    rec["n_taxa"] = tree.n_leaves
    rec["n_patterns"] = int(ca.n_patterns)
    rec["setup_ms"] = {"engines": _ms(t0)}
    ms = rec["ms"] = {}

    ll32, rec["setup_ms"]["loglik"], ms["loglik"] = timed(
        lambda: e32.loglikelihood(params))
    g32, rec["setup_ms"]["gradient"], ms["gradient"] = timed(
        lambda: e32.gradient(params))
    fwd = compiled_forward(e32, params)
    rec["memory_analysis"] = {
        "loglik": memory_dict(fwd),
        "gradient": memory_dict(e32._jit_grad.lower(
            e32._full_params(params), e32._leaf_partials, e32._weights
        ).compile()),
    }
    rec["forward_kernels"] = kernel_count(fwd.as_text())
    if fit_steps:
        t0 = time.perf_counter()
        res = fit(e32, params, max_steps=fit_steps)
        ms["fit_incl_compile"] = _ms(t0)
        t0 = time.perf_counter()
        res = fit(e32, params, max_steps=fit_steps)
        ms["fit"] = _ms(t0)
        rec["fit"] = {"steps": res.n_steps, "loglik": res.loglik,
                      "start_loglik": float(res.trace[0])}
        check((res.n_steps == fit_steps or res.converged)
              and res.loglik >= ll32 - 1e-6 * abs(ll32),
              "fit did not run its steps or lost logL",
              steps=res.n_steps, start=ll32, end=res.loglik)

    ll64, rec["setup_ms"]["loglik_f64"], ms["loglik_f64"] = timed(
        lambda: e64.loglikelihood(params), reps=1)
    g64, rec["setup_ms"]["gradient_f64"], ms["gradient_f64"] = timed(
        lambda: e64.gradient(params), reps=1)
    ours, gold = f64_vs_oracle(e64, params, tree, ca, om, rates, pinv,
                               n_oracle)
    par = rec["parity"] = {
        "loglik_f32": ll32, "loglik_f64": ll64,
        "rel_f32_vs_f64": rel(ll32, ll64),
        "grad_rel_f32_vs_f64": grad_rel_err(g32, g64),
        "grad_rel_f32_vs_f64_at_truth": grad_rel_err(
            e32.gradient(truth), e64.gradient(truth)),
        "oracle_patterns": n_oracle, "slice_loglik_f64": ours,
        "slice_loglik_oracle": gold, "rel_f64_vs_oracle": rel(ours, gold),
    }
    rec["peak_bytes_in_use"] = peak_bytes(dev)
    check(par["rel_f32_vs_f64"] <= F32_VS_F64, f"{phase}: f32 vs f64 logL",
          **par)
    check(par["grad_rel_f32_vs_f64"] <= GRAD_RTOL,
          f"{phase}: f32 vs f64 gradient", **par)
    check(par["rel_f64_vs_oracle"] <= F64_VS_ORACLE,
          f"{phase}: f64 vs oracle logL", **par)
    del e64
    return rec, e32


# -- phases -----------------------------------------------------------------

def dna_problem(sizes: Sizes, seed: int):
    """(tree, compressed alignment, start params, oracle model of the
    start, its gamma rates, simulation params)."""
    import numpy as np

    from oracle import core as oracle
    from phylo_utils_tpu import models
    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(sizes.dna_taxa, seed=seed)
    mp = {"rates": np.asarray(GTR_RATES), "freqs": np.asarray(DNA_FREQS)}
    ca = simulated_patterns(tree, models.GTR, sizes.dna_patterns,
                            {**mp, "alpha": ALPHA}, ncat=4, pinv=PINV,
                            seed=seed + 1)
    truth = {"model": mp, "alpha": ALPHA, "pinv": PINV}
    return (tree, ca, DNA_START, oracle.gtr(*DNA_START["model"].values()),
            oracle.discrete_gamma(DNA_START["alpha"], 4), truth)


def phase_dna(card: str, sizes: Sizes, seed: int):
    from phylo_utils_tpu import models

    tree, ca, start, om, rates, truth = dna_problem(sizes, seed)
    rec, e32 = parity_phase(
        "dna_gtr_g4_i", card, tree, ca, models.GTR, start, om, rates,
        start["pinv"], sizes.oracle_patterns, truth,
        fit_steps=sizes.fit_steps, ncat=4, invariant_sites=True)
    return rec, e32, start


def phase_protein(card: str, sizes: Sizes, seed: int):
    from oracle import core as oracle
    from phylo_utils_tpu import models
    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(sizes.prot_taxa, seed=seed + 10)
    ca = simulated_patterns(tree, models.LG, sizes.prot_patterns,
                            {"alpha": 0.8}, ncat=4, pinv=0.0, seed=seed + 11)
    rec, _ = parity_phase(
        "protein_lg_g4", card, tree, ca, models.LG, {"alpha": 0.5},
        oracle.lg(), oracle.discrete_gamma(0.5, 4), 0.0,
        min(sizes.oracle_patterns, sizes.prot_patterns), {"alpha": 0.8},
        ncat=4)
    return rec


def phase_codon(card: str, sizes: Sizes, seed: int):
    from oracle import core as oracle
    from phylo_utils_tpu import models
    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(sizes.codon_taxa, seed=seed + 20)
    ca = simulated_patterns(tree, models.GY94, sizes.codon_patterns,
                            {"kappa": 2.5, "omega": 0.3}, ncat=1, pinv=0.0,
                            seed=seed + 21)
    rec, _ = parity_phase(
        "codon_gy94_m0", card, tree, ca, models.GY94,
        {"model": {"kappa": 2.0, "omega": 1.0}}, oracle.gy94(2.0, 1.0),
        None, 0.0, sizes.codon_patterns,
        {"model": {"kappa": 2.5, "omega": 0.3}})
    return rec


def phase_server(card: str, engine, params: dict, loglik: float,
                 sizes: Sizes):
    """EngineServer on the phase-1 engine, on localhost, in this process."""
    import jax
    import numpy as np

    from phylo_utils_tpu.server import EngineServer

    dev = jax.devices()[0]
    rec = _base_record("server", card, dev)
    body = {"params": jax.tree.map(lambda x: np.asarray(x).tolist(), params)}
    srv = EngineServer(engine, port=0)
    srv.start()
    ms = rec["ms"] = {}
    try:
        def call(route, payload=None):
            url = f"http://127.0.0.1:{srv.port}{route}"
            data = None if payload is None else json.dumps(payload).encode()
            req = urllib.request.Request(
                url, data=data, headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                out = json.loads(r.read())
            ms[route.strip("/")] = _ms(t0)
            return out

        health = call("/health")
        ll = call("/loglik", body)["loglik"]
        grad = call("/gradient", body)["gradient"]
        fitted = call("/fit", {**body,
                               "max_steps": sizes.server_fit_steps})
    finally:
        srv.stop()
    rec["health"] = health
    rec["loglik"] = ll
    rec["rel_loglik_vs_phase1"] = rel(ll, loglik)
    rec["fit"] = {"steps": fitted["n_steps"], "loglik": fitted["loglik"]}
    rec["peak_bytes_in_use"] = peak_bytes(dev)
    check(health.get("platform") == dev.platform
          and health.get("device_kind") == dev.device_kind,
          "/health names the device", health=health)
    check(rec["rel_loglik_vs_phase1"] <= 1e-12, "/loglik vs phase 1",
          server=ll, phase1=loglik)
    check(len(grad["branch_lengths"]) == engine.tree.n_nodes
          and bool(np.all(np.isfinite(grad["branch_lengths"]))),
          "/gradient shape and finiteness")
    check(fitted["n_steps"] == sizes.server_fit_steps
          and np.isfinite(fitted["loglik"]), "/fit", fitted=rec["fit"])
    return rec


def phase_cli(card: str, sizes: Sizes, seed: int):
    """``cli.main(["loglik"|"fit", ...])`` in this process, on a FASTA and
    a Newick file written from the seed."""
    import jax
    import numpy as np

    from phylo_utils_tpu import cli, models
    from phylo_utils_tpu.io import write_newick
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.trees import random_tree

    dev = jax.devices()[0]
    rec = _base_record("cli", card, dev)
    tree = random_tree(sizes.cli_taxa, seed=seed + 30)
    aln = simulate_alignment(jax.random.key(seed + 31), tree, models.GTR,
                             sizes.cli_sites, ncat=4)
    ms = rec["ms"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fasta = os.path.join(tmp, "aln.fasta")
        nwk = os.path.join(tmp, "tree.nwk")
        with open(fasta, "w") as f:
            f.writelines(f">{n}\n{s}\n" for n, s in aln.items())
        with open(nwk, "w") as f:
            f.write(write_newick(tree) + "\n")
        common = ["--tree", nwk, "--alignment", fasta, "--model", "GTR",
                  "--ncat", "4"]

        def run(argv):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            ms[argv[0]] = _ms(t0)
            check(rc == 0, f"cli {argv[0]} exit code", rc=rc)
            return json.loads(buf.getvalue().strip().splitlines()[-1])

        out_ll = run(["loglik", *common])
        out_fit = run(["fit", *common, "--max-steps", "3"])
    direct = LikelihoodEngine(tree, aln, models.GTR, ncat=4).loglikelihood()
    rec["loglik"] = out_ll["loglik"]
    rec["rel_loglik_vs_engine"] = rel(out_ll["loglik"], direct)
    rec["fit_loglik"] = out_fit.get("loglik")
    rec["peak_bytes_in_use"] = peak_bytes(dev)
    # the CLI's file reader orders patterns differently from the dict
    # path, so the f64 sums differ in rounding only
    check(rec["rel_loglik_vs_engine"] <= 1e-10, "cli loglik vs engine",
          cli=out_ll["loglik"], engine=direct)
    check(rec["fit_loglik"] is not None and np.isfinite(rec["fit_loglik"])
          and rec["fit_loglik"] >= out_ll["loglik"], "cli fit",
          fit=rec["fit_loglik"], start=out_ll["loglik"])
    return rec


def eigh_exhibit(card: str):
    """The f64 matrices that broke a batched eigh (the regression exhibit of
    tests/test_eigh_robustness.py) through plain batched ``eigh``."""
    import importlib.util

    import jax
    import jax.numpy as jnp
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "eigh_exhibit", os.path.join(REPO, "tests", "test_eigh_robustness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    b = jnp.asarray(np.stack([mod.BAD_B[0], mod.BAD_B[1]] * 2))
    w, u = jax.jit(jnp.linalg.eigh)(b)
    rec = _base_record("eigh_exhibit", card, jax.devices()[0])
    rec["batched_eigh_finite"] = bool(jnp.all(jnp.isfinite(w))
                                      & jnp.all(jnp.isfinite(u)))
    rec["eigenvalues"] = np.asarray(w).tolist()
    return rec


def phase_four(card: str, sizes: Sizes, seed: int, devices):
    """Site sharding over ``devices`` against one device, in f64: logL,
    gradient and fit steps of the phase-1 problem."""
    import jax

    from phylo_utils_tpu import models
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.optimize import fit
    from phylo_utils_tpu.parallel import SiteSharding, make_mesh

    tree, ca, params, _, _, _ = dna_problem(sizes, seed)
    rec = _base_record("sharded_sites", card, devices[0])
    rec["n_devices"] = len(devices)
    rec["n_patterns"] = int(ca.n_patterns)
    ms = rec["ms"] = {}
    out = {}
    for mode in ("single", "sharded"):
        sharding = (SiteSharding(make_mesh(devices))
                    if mode == "sharded" else None)
        eng = LikelihoodEngine(tree, ca, models.GTR, ncat=4,
                               invariant_sites=True, dtype="float64",
                               sharding=sharding)
        ll, _, ms[f"{mode}_loglik"] = timed(
            lambda: eng.loglikelihood(params), reps=1)
        g, _, ms[f"{mode}_gradient"] = timed(
            lambda: eng.gradient(params), reps=1)
        t0 = time.perf_counter()
        res = fit(eng, params, max_steps=sizes.four_fit_steps)
        ms[f"{mode}_fit_incl_compile"] = _ms(t0)
        out[mode] = (ll, jax.device_get(g), res.loglik, res.n_steps)
        del eng
    par = rec["parity"] = {
        "loglik_single": out["single"][0], "loglik_sharded": out["sharded"][0],
        "rel_loglik": rel(out["sharded"][0], out["single"][0]),
        "grad_rel": grad_rel_err(out["sharded"][1], out["single"][1]),
        "fit_loglik_single": out["single"][2],
        "fit_loglik_sharded": out["sharded"][2],
        "rel_fit_loglik": rel(out["sharded"][2], out["single"][2]),
        "fit_steps": [out["single"][3], out["sharded"][3]],
    }
    rec["peak_bytes_in_use"] = [peak_bytes(d) for d in devices]
    for key in ("rel_loglik", "grad_rel", "rel_fit_loglik"):
        check(par[key] <= SHARDED_VS_SINGLE, f"sharded vs single: {key}",
              **par)
    return rec


# -- main -------------------------------------------------------------------

def last_line(device, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card site-sharding check")
    args = ap.parse_args(argv)
    # One process drives the card(s), so it may reserve more than JAX's
    # default 75% of device memory: the f64 reference gradient of phase 1
    # needs a 61.5 GiB buffer on top of the f32 engine's arrays.
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

    import jax

    from phylo_utils_tpu.utils.device import (
        card_info,
        device_record,
        require_gpu,
    )

    devices = require_gpu()
    jax.config.update("jax_enable_x64", True)
    so = build_native()
    from phylo_utils_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_info()
    print(f"card: {card}", flush=True)
    print(json.dumps({**device_record(devices, card),
                      "compile_cache": cache, "native_library": so}),
          flush=True)
    sizes = Sizes()
    if args.four:
        check(len(devices) >= 4, "--four needs four devices",
              found=len(devices))
        emit(phase_four(card, sizes, args.seed, devices[:4]))
        print(last_line(devices[0], 4))
        return 0
    emit(eigh_exhibit(card))
    rec, e32, params = phase_dna(card, sizes, args.seed)
    emit(rec)
    emit(phase_server(card, e32, params, rec["parity"]["loglik_f32"], sizes))
    del e32
    emit(phase_protein(card, sizes, args.seed))
    emit(phase_codon(card, sizes, args.seed))
    emit(phase_cli(card, sizes, args.seed))
    print(last_line(devices[0], 1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
