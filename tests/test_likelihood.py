"""JAX engine vs numpy-f64 oracle parity (BASELINE.json configs 1-4).

These run in float64 on the CPU backend, so agreement is expected at 1e-10,
far inside the 1e-6 requirement.
"""
import numpy as np
import pytest

import oracle
from phylo_utils_tpu import models
from phylo_utils_tpu.io import parse_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.trees import random_tree
from phylo_utils_tpu.io import write_newick


def _random_alignment(tree, n_sites, alphabet="dna", seed=1, with_ambiguity=True):
    rng = np.random.default_rng(seed)
    chars = "ACGT" if alphabet == "dna" else "ARNDCQEGHILKMFPSTWYV"
    extra = "NRY-" if (alphabet == "dna" and with_ambiguity) else ""
    pool = chars * 8 + extra
    return {
        name: "".join(rng.choice(list(pool), size=n_sites))
        for name in tree.leaf_names
    }


def _check_parity(tree, aln, jax_model, oracle_model, ncat=1, pinv=0.0,
                  alpha=0.5, params=None, rtol=1e-9):
    engine = LikelihoodEngine(
        tree, aln, jax_model, ncat=ncat, invariant_sites=pinv > 0
    )
    p = {} if params is None else dict(params)
    if ncat > 1:
        p["alpha"] = alpha
    if pinv > 0:
        p["pinv"] = pinv
    got = engine.loglikelihood(p)
    rates = oracle.discrete_gamma(alpha, ncat) if ncat > 1 else None
    want, sw_want = oracle.loglikelihood(
        tree, aln, oracle_model, alphabet=jax_model.alphabet, rates=rates,
        pinv=pinv, return_sitewise=True,
    )
    np.testing.assert_allclose(got, want, rtol=rtol)
    sw_got = engine.sitewise_loglikelihoods(p)
    np.testing.assert_allclose(sw_got, sw_want, rtol=1e-8)
    return got


def test_config1_jc69_4taxon():
    """BASELINE config 1: JC69, fixed 4-taxon tree, short DNA alignment."""
    tree = parse_newick("((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);")
    aln = {
        "a": "ACGTACGTGGACGTAC",
        "b": "ACGTTGCAGGACGAAC",
        "c": "AGGTACGAGTACGTAC",
        "d": "ACGAACGTATACGTTT",
    }
    _check_parity(tree, aln, models.JC69, oracle.jc69())


def test_config2_hky85_gamma_16taxon():
    """BASELINE config 2: HKY85 + gamma4, 16 taxa, per-node scaling."""
    tree = random_tree(16, seed=7, mean_brlen=0.15)
    aln = _random_alignment(tree, 120, seed=2)
    kappa, freqs = 2.5, [0.35, 0.15, 0.25, 0.25]
    _check_parity(
        tree, aln, models.HKY85, oracle.hky85(kappa, freqs), ncat=4,
        alpha=0.43,
        params={"model": {"kappa": kappa, "freqs": freqs}},
    )


def test_config3_gtr_gamma_i_64taxon():
    """BASELINE config 3: GTR+G+I, 64 taxa, pattern compression."""
    tree = random_tree(64, seed=11, mean_brlen=0.08)
    aln = _random_alignment(tree, 300, seed=3)
    rates = [1.5, 4.0, 0.8, 1.2, 5.0, 1.0]
    freqs = [0.35, 0.2, 0.18, 0.27]
    _check_parity(
        tree, aln, models.GTR, oracle.gtr(rates, freqs), ncat=4, pinv=0.15,
        alpha=0.7,
        params={"model": {"rates": rates, "freqs": freqs}},
    )


@pytest.mark.parametrize("model_pair", [
    (models.LG, oracle.lg()),
    (models.WAG, oracle.wag()),
], ids=["LG", "WAG"])
def test_config4_protein_gamma_32taxon(model_pair):
    """BASELINE config 4: LG/WAG + gamma, 32 taxa, amino acids."""
    jm, om = model_pair
    tree = random_tree(32, seed=13, mean_brlen=0.2)
    aln = _random_alignment(tree, 80, alphabet="protein", seed=4)
    _check_parity(tree, aln, jm, om, ncat=4, alpha=0.9)


@pytest.mark.parametrize(
    "jm,om,params",
    [
        (models.K80, oracle.k80(3.0), {"model": {"kappa": 3.0}}),
        (models.F81, oracle.f81([0.3, 0.2, 0.3, 0.2]),
         {"model": {"freqs": [0.3, 0.2, 0.3, 0.2]}}),
        (models.F84, oracle.f84(1.5, [0.3, 0.25, 0.2, 0.25]),
         {"model": {"kappa": 1.5, "freqs": [0.3, 0.25, 0.2, 0.25]}}),
        (models.TN93, oracle.tn93(2.0, 3.0, 1.0, [0.1, 0.4, 0.2, 0.3]),
         {"model": {"alpha1": 2.0, "alpha2": 3.0, "beta": 1.0,
                    "freqs": [0.1, 0.4, 0.2, 0.3]}}),
    ],
    ids=["K80", "F81", "F84", "TN93"],
)
def test_other_dna_models(jm, om, params):
    tree = random_tree(8, seed=21, mean_brlen=0.12)
    aln = _random_alignment(tree, 60, seed=5)
    _check_parity(tree, aln, jm, om, params=params)


def test_unrest_nonreversible():
    rates12 = [1.0, 2.0, 0.8, 1.4, 0.5, 2.2, 0.9, 1.1, 3.0, 0.7, 1.8, 1.3]
    tree = random_tree(6, seed=23, mean_brlen=0.1)
    aln = _random_alignment(tree, 50, seed=6)
    _check_parity(
        tree, aln, models.UNREST, oracle.unrest(rates12),
        params={"model": {"rates": rates12}},
    )


def test_multifurcating_and_unrooted():
    aln = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG", "c": "AGGTACGAGT",
           "d": "ACGAACGTAT", "e": "TCGAACGTAT"}
    # trifurcating root + a multifurcating internal node
    tree = parse_newick("(a:0.1,(b:0.2,c:0.15,d:0.3):0.1,e:0.25);")
    _check_parity(tree, aln, models.JC69, oracle.jc69())


def test_deep_tree_heavy_scaling():
    """Caterpillar tree, long branches: per-node rescaling must keep logL
    finite and equal to the oracle."""
    n = 24
    newick = "a0:0.5"
    for i in range(1, n):
        newick = f"({newick},a{i}:0.5):0.5"
    tree = parse_newick("(" + newick + ",z:0.5);")
    aln = _random_alignment(tree, 40, seed=9, with_ambiguity=False)
    got = _check_parity(tree, aln, models.JC69, oracle.jc69())
    assert np.isfinite(got)


def test_compression_invariance():
    # 4 taxa x 300 sites: at most 4^4=256 gap-free patterns, so compression
    # is guaranteed by pigeonhole.
    tree = random_tree(4, seed=31)
    aln = _random_alignment(tree, 300, seed=10, with_ambiguity=False)
    e1 = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, compress=True)
    e2 = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, compress=False)
    assert e1._compressed.n_patterns < e2._compressed.n_patterns
    np.testing.assert_allclose(
        e1.loglikelihood({"alpha": 0.6}), e2.loglikelihood({"alpha": 0.6}),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        e1.sitewise_loglikelihoods({"alpha": 0.6}),
        e2.sitewise_loglikelihoods({"alpha": 0.6}),
        rtol=1e-12,
    )


def test_float32_accuracy_vs_float64():
    """The f32 path (the throughput mode) must stay within the 1e-6 relative
    budget on a medium problem (SURVEY.md §7 hard part 1)."""
    tree = random_tree(64, seed=11, mean_brlen=0.08)
    aln = _random_alignment(tree, 300, seed=3)
    common = dict(ncat=4, invariant_sites=True)
    p = {"alpha": 0.7, "pinv": 0.15,
         "model": {"rates": [1.5, 4.0, 0.8, 1.2, 5.0, 1.0],
                   "freqs": [0.35, 0.2, 0.18, 0.27]}}
    l64 = LikelihoodEngine(tree, aln, models.GTR, dtype=np.float64, **common
                           ).loglikelihood(p)
    l32 = LikelihoodEngine(tree, aln, models.GTR, dtype=np.float32, **common
                           ).loglikelihood(p)
    assert abs(l32 - l64) / abs(l64) < 1e-6


def test_large_tree_512_taxa_smoke():
    """Big-topology smoke: schedule compilation, scan-path pruning, logL
    finiteness and oracle parity on a 512-taxon tree (f64, CPU)."""
    import numpy as np

    import oracle.core as _oracle
    from phylo_utils_tpu import models as _models
    from phylo_utils_tpu.likelihood import LikelihoodEngine as _Engine
    from phylo_utils_tpu.trees import compile_schedule, random_tree

    tree = random_tree(512, seed=42)
    sched = compile_schedule(tree)
    assert sched.n_nodes == 2 * 512 - 1
    rng = np.random.default_rng(0)
    aln = {n: "".join(rng.choice(list("ACGT"), size=40))
           for n in tree.leaf_names}
    engine = _Engine(tree, aln, _models.JC69)
    ll = engine.loglikelihood()
    assert np.isfinite(ll)
    gold = _oracle.loglikelihood(tree, aln, _oracle.jc69())
    assert abs(ll - gold) < 1e-6


def test_empirical_frequencies():
    import numpy as np

    from phylo_utils_tpu.alphabets import empirical_frequencies

    aln = {"a": "AAAC", "b": "AACG", "c": "RN--"}  # R = A/G ambiguous
    f = empirical_frequencies(aln, "dna")
    # counts: A=5, C=2, G=1 + R contributes 0.5 A, 0.5 G; N,-,- nothing
    expect = np.array([5.5, 2.0, 1.5, 0.0]) / 9.0
    np.testing.assert_allclose(f, expect, atol=1e-12)
    f2 = empirical_frequencies(aln, "dna", pseudocount=1.0)
    assert (f2 > 0).all() and f2.sum() == 1.0


def test_engine_scan_path_matches_unrolled():
    """unroll=False (lax.scan over levels) is trace-equivalent math."""
    import numpy as np

    from phylo_utils_tpu import models as _models
    from phylo_utils_tpu.likelihood import LikelihoodEngine as _Engine
    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(20, seed=9)
    rng = np.random.default_rng(10)
    aln = {n: "".join(rng.choice(list("ACGT"), size=70))
           for n in tree.leaf_names}
    e_unroll = _Engine(tree, aln, _models.GTR, ncat=3)
    e_scan = _Engine(tree, aln, _models.GTR, ncat=3, unroll=False)
    assert e_unroll.loglikelihood() == e_scan.loglikelihood()
    import jax

    g1, g2 = e_unroll.gradient(), e_scan.gradient()
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)


def test_loglikelihood_many_matches_single():
    """Batched branch-length evaluation (one dispatch) must equal per-set
    single evaluations, for the unrolled, scanned and rematerialized
    level walks."""
    import numpy as np

    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(10, seed=21)
    rng = np.random.default_rng(2)
    aln = {n: "".join(rng.choice(list("ACGT"), size=60))
           for n in tree.leaf_names}
    for walk in ({}, {"unroll": False}, {"remat": True}):
        eng = LikelihoodEngine(tree, aln, models.HKY85, ncat=3,
                               dtype="float32", **walk)
        base = np.asarray(eng.default_params()["branch_lengths"])
        sets = np.stack([base * s for s in (0.5, 1.0, 1.7, 3.0)])
        batched = eng.loglikelihood_many(sets)
        singles = [
            eng.loglikelihood({"branch_lengths": s}) for s in sets
        ]
        np.testing.assert_allclose(batched, singles, rtol=1e-6, atol=1e-4)


def test_eigen_tied_degenerate_structure_finite_and_accurate():
    """Regression: an emulated-f64 eigh returned NaN eigenpairs for a doubly-
    degenerate GTR B-matrix arising from f32-rounded duplicate rates
    (adam step 1 of a fit). eigen_reversible now applies a graded 1e-13
    diagonal tie-break for f64; this pins (a) finiteness at the exact
    failing parameter point and (b) that the jitter costs nothing at the
    oracle tolerance."""
    import jax.numpy as jnp

    from phylo_utils_tpu.models.base import eigen_reversible

    prm = {
        "rates": np.asarray(
            [1.0063176, 1.0063176, 0.99367917, 0.99367917, 1.0063176,
             1.0063176], np.float64
        ),
        "freqs": np.asarray(
            [0.25250009, 0.25250009, 0.24749991, 0.24749991], np.float64
        ),
    }
    sym, fr = models.GTR.build_parts(prm, dtype=jnp.float64)
    eig = eigen_reversible(sym, fr)
    for leaf in (eig.evals, eig.evecs, eig.ivecs):
        assert np.all(np.isfinite(np.asarray(leaf)))
    rec = (
        np.asarray(eig.evecs)
        @ np.diag(np.asarray(eig.evals))
        @ np.asarray(eig.ivecs)
    )
    np.testing.assert_allclose(rec, np.asarray(eig.q), atol=1e-12)
    # logL at a jittered-eigen point still matches the (jitter-free) oracle
    tree = parse_newick("((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);")
    aln = {"a": "ACGTACGTGG", "b": "ACGTTGCAGG",
           "c": "AGGTACGAGT", "d": "ACGAACGTAT"}
    eng = LikelihoodEngine(tree, aln, models.GTR)
    ll = eng.loglikelihood({"model": prm})
    m = oracle.gtr(list(prm["rates"]), list(prm["freqs"]))
    gold = oracle.loglikelihood(tree, aln, m)
    assert abs(ll - gold) < 1e-8 * abs(gold)


def test_unknown_parameter_keys_raise():
    """Typos in params must raise, not be silently ignored."""
    import pytest as _pytest

    tree = random_tree(4, seed=0)
    rng = np.random.default_rng(0)
    aln = {n: "".join(rng.choice(list("ACGT"), size=30))
           for n in tree.leaf_names}
    eng = LikelihoodEngine(tree, aln, models.HKY85, ncat=4)
    with _pytest.raises(ValueError, match="unknown parameter 'aplha'"):
        eng.loglikelihood({"aplha": 0.7})
    with _pytest.raises(ValueError, match="unknown model parameter"):
        eng.loglikelihood({"model": {"kapa": 2.0}})
    # valid keys still work
    assert np.isfinite(eng.loglikelihood({"alpha": 0.7,
                                          "model": {"kappa": 2.0}}))
