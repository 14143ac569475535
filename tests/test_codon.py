"""Codon models (GY94): structure, logL parity vs oracle, selection
parameter recovery, ambiguity handling."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle.core as oracle
from phylo_utils_tpu import models
from phylo_utils_tpu.io import encode_codon_alignment, parse_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.models.codon import (
    CODONS,
    CODON_TO_AA,
    f3x4_frequencies,
)
from phylo_utils_tpu.optimize import fit
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu.trees import random_tree


def test_codon_table_structure():
    assert len(CODONS) == 61
    assert "TAA" not in CODONS and "TGA" not in CODONS and "TAG" not in CODONS
    assert CODON_TO_AA["ATG"] == "M" and CODON_TO_AA["TGG"] == "W"
    assert CODON_TO_AA["TTT"] == "F" and CODON_TO_AA["AAA"] == "K"


def test_gy94_q_properties():
    eig = models.GY94.eigen({"kappa": 3.0, "omega": 0.4})
    q = np.asarray(eig.q)
    freqs = np.asarray(eig.freqs)
    np.testing.assert_allclose(q.sum(axis=1), 0, atol=1e-12)
    np.testing.assert_allclose(-(freqs * np.diag(q)).sum(), 1.0, atol=1e-12)
    # detailed balance (reversibility)
    np.testing.assert_allclose(
        freqs[:, None] * q, (freqs[:, None] * q).T, atol=1e-12
    )
    # pairs differing at >1 position have rate 0
    assert q[CODONS.index("AAA"), CODONS.index("ACC")] == 0
    # matches the independently-derived oracle Q
    om = oracle.gy94(3.0, 0.4)
    np.testing.assert_allclose(q, om.q, atol=1e-12)


def test_gy94_logl_matches_oracle():
    tree = parse_newick("((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);")
    aln = {
        "a": "ATGGCACGTAAG", "b": "ATGGCTCGTAAA",
        "c": "ATGGGACGAAAG", "d": "ATGGCACGTANG",  # ambiguity in d
    }
    ca = encode_codon_alignment(aln)
    assert ca.partials.shape[2] == 61
    engine = LikelihoodEngine(tree, ca, models.GY94)
    params = {"model": {"kappa": 2.5, "omega": 0.3}}
    ll = engine.loglikelihood(params)
    om = oracle.gy94(2.5, 0.3)
    gold = oracle.loglikelihood(
        tree, aln, om,
        pattern_weights=np.asarray(ca.weights),
        leaf_partials=np.asarray(ca.partials, np.float64),
    )
    assert ll == pytest.approx(gold, abs=1e-8)


def test_engine_accepts_codon_dict_directly():
    tree = parse_newick("(a:0.1,(b:0.2,c:0.1):0.1);")
    aln = {"a": "ATGAAA", "b": "ATGAAG", "c": "ATGAAT"}
    engine = LikelihoodEngine(tree, aln, models.GY94)  # dict -> codon route
    assert np.isfinite(engine.loglikelihood())


def test_stop_codon_rejected():
    with pytest.raises(ValueError, match="stop"):
        encode_codon_alignment({"a": "TAAATG", "b": "ATGATG"})
    with pytest.raises(ValueError, match="divisible"):
        encode_codon_alignment({"a": "ATGA", "b": "ATGA"})


def test_f3x4():
    f = f3x4_frequencies(np.full((3, 4), 0.25))
    assert f.shape == (61,)
    assert f.sum() == pytest.approx(1.0)
    np.testing.assert_allclose(f, f[0])  # uniform nt -> uniform codons


def test_simulate_and_recover_omega():
    """Simulate under purifying selection (omega=0.2), fit recovers it."""
    tree = random_tree(6, seed=2, mean_brlen=0.15)
    aln = simulate_alignment(
        jax.random.key(3), tree, models.GY94, 400,
        params={"kappa": 2.0, "omega": 0.2},
    )
    assert all(len(s) == 1200 for s in aln.values())  # 400 codons
    engine = LikelihoodEngine(tree, aln, models.GY94)
    res = fit(
        engine,
        {"model": {"kappa": 2.0, "omega": 1.0}},
        free=("branch_lengths", "model"),
        max_steps=80,
        patience=15,
    )
    # frequency vector stays near-uniform (61 params); omega must drop
    assert float(res.params["model"]["omega"]) < 0.5


def test_codon_gamma_mixture_f32_no_nan():
    """Regression (found on an accelerator): the slow gamma category's near-zero
    effective branch lengths round some f32 61x61 P entries negative,
    which flipped site likelihoods negative -> log(NaN). P is clamped to
    its mathematical domain now; a 32-taxon GY94+Gamma4 f32 run must be
    finite and match the f64 path to f32 accuracy."""
    import jax.numpy as jnp

    from phylo_utils_tpu.models.base import eigen_reversible
    from phylo_utils_tpu.ops.pmatrix import transition_matrices

    sym, freqs = models.GY94.build_parts(dtype=jnp.float32)
    p = transition_matrices(
        eigen_reversible(sym, freqs), jnp.asarray([1e-4, 1.7e-4], jnp.float32)
    )
    assert float(jnp.min(p)) >= 0.0
    tree = random_tree(32, seed=0, mean_brlen=0.15)
    aln = simulate_alignment(jax.random.key(0), tree, models.GY94, 200)
    e32 = LikelihoodEngine(tree, aln, models.GY94, ncat=4, dtype="float32")
    e64 = LikelihoodEngine(tree, aln, models.GY94, ncat=4, dtype="float64")
    ll32, ll64 = e32.loglikelihood(), e64.loglikelihood()
    assert np.isfinite(ll32)
    assert ll32 == pytest.approx(ll64, rel=2e-5)


def test_empirical_codon_frequencies():
    """F61/F3x4/F1x4 counting vs hand-computed values; gaps ignored."""
    import numpy as np

    from phylo_utils_tpu.models.codon import (
        codon_index,
        empirical_codon_frequencies,
        f3x4_frequencies,
    )

    aln = {"a": "TTTTCA", "b": "TCATTT"}
    f61 = empirical_codon_frequencies(aln, "f61")
    assert abs(f61.sum() - 1) < 1e-12
    assert f61[codon_index("TTT")] == f61[codon_index("TCA")]
    assert f61[codon_index("TTT")] > f61[codon_index("AAA")]
    # f3x4 equals the closed-form product of per-position distributions
    f3 = empirical_codon_frequencies(aln, "f3x4")
    by_pos = np.array([[0, 0, 0, 1], [0, .5, 0, .5], [.5, 0, 0, .5]])
    np.testing.assert_allclose(f3, f3x4_frequencies(by_pos), atol=1e-12)
    assert abs(empirical_codon_frequencies(aln, "f1x4").sum() - 1) < 1e-12
    # gap/ambiguity columns contribute nothing
    aln2 = dict(aln, c="---NNN")
    np.testing.assert_allclose(
        empirical_codon_frequencies(aln2, "f3x4"), f3, atol=1e-12
    )
    with pytest.raises(ValueError, match="unknown method"):
        empirical_codon_frequencies(aln, "f99")


def test_mg94_matches_oracle_and_detects_structure():
    """MG94 logL matches the independently built oracle MG94; detailed
    balance and stationarity hold; omega is recoverable."""
    import numpy as np

    import oracle.core as oracle
    from phylo_utils_tpu import models
    from phylo_utils_tpu.io import encode_codon_alignment
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.models.base import build_rate_matrix
    from phylo_utils_tpu.optimize import fit
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.trees import random_tree

    nf = np.array([[0.3, 0.2, 0.3, 0.2],
                   [0.25, 0.25, 0.25, 0.25],
                   [0.15, 0.35, 0.2, 0.3]])
    # Q structure parity vs the oracle's independent construction
    sym, freqs = models.MG94.build(kappa=3.0, omega=0.4, nuc_freqs=nf)
    q = np.asarray(build_rate_matrix(jnp.asarray(sym), jnp.asarray(freqs)))
    om = oracle.mg94(3.0, 0.4, nf)
    np.testing.assert_allclose(q, om.q, atol=1e-12)
    np.testing.assert_allclose(np.asarray(freqs), om.freqs, atol=1e-12)
    # detailed balance
    pi_q = np.asarray(freqs)[:, None] * q
    np.testing.assert_allclose(pi_q, pi_q.T, atol=1e-12)

    # logL parity on simulated data
    tree = random_tree(5, seed=6, mean_brlen=0.2)
    aln = simulate_alignment(jax.random.key(7), tree, models.MG94, 40,
                             params={"omega": 0.5, "kappa": 3.0,
                                     "nuc_freqs": nf})
    ca = encode_codon_alignment(aln)
    eng = LikelihoodEngine(tree, ca, models.MG94)
    ll = eng.loglikelihood({"model": {"kappa": 3.0, "omega": 0.5,
                                      "nuc_freqs": nf}})
    gold = oracle.loglikelihood(
        tree, {}, oracle.mg94(3.0, 0.5, nf),
        pattern_weights=np.asarray(ca.weights),
        leaf_partials=np.asarray(ca.partials, np.float64),
    )
    assert ll == pytest.approx(gold, abs=1e-7)
    # omega recovery through fit (kappa/freqs free too)
    res = fit(eng, free=("branch_lengths", "model"), max_steps=60,
              patience=12)
    assert 0.2 < float(res.params["model"]["omega"]) < 1.2


def test_vertebrate_mito_genetic_code():
    """GY94/MG94 over the vertebrate mitochondrial code (60 sense codons,
    TGA=W, ATA=M, AGA/AGG=stop): Q well-formed, simulation emits only
    sense codons, omega recoverable through the full pipeline."""
    import numpy as np

    from phylo_utils_tpu.io import encode_codon_alignment
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.models.base import build_rate_matrix
    from phylo_utils_tpu.models.codon import (
        code_tables,
        make_gy94,
        make_mg94,
    )
    from phylo_utils_tpu.optimize import fit
    from phylo_utils_tpu.simulate import simulate_alignment
    from phylo_utils_tpu.trees import random_tree

    cods, aa, _ = code_tables("vertebrate_mito")
    assert len(cods) == 60
    assert aa["TGA"] == "W" and aa["ATA"] == "M"
    assert "AGA" not in aa and "AGG" not in aa

    GYm = make_gy94("vertebrate_mito")
    sym, freqs = GYm.build(**GYm.defaults(None))
    q = np.asarray(build_rate_matrix(sym, freqs))
    assert abs(q.sum(1)).max() < 1e-12
    piq = np.asarray(freqs)[:, None] * q
    np.testing.assert_allclose(piq, piq.T, atol=1e-12)

    tree = random_tree(5, seed=2, mean_brlen=0.3)
    aln = simulate_alignment(jax.random.key(4), tree, GYm, 300,
                             params={"omega": 0.5, "kappa": 3.0})
    joined = "".join(aln.values())
    seen = {joined[i:i + 3] for i in range(0, len(joined), 3)}
    assert "AGA" not in seen and "AGG" not in seen and "TGA" in seen

    ca = encode_codon_alignment(aln, code="vertebrate_mito")
    eng = LikelihoodEngine(tree, ca, GYm)
    res = fit(eng, free=("branch_lengths", "model"), max_steps=80,
              patience=12)
    assert 0.2 < float(np.asarray(res.params["model"]["omega"])) < 1.1
    assert make_mg94("vertebrate_mito").n_states == 60

    with pytest.raises(ValueError, match="unknown genetic code"):
        make_gy94("klingon")
