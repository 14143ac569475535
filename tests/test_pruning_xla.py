"""The XLA level walk (``ops.pruning.make_prune_fn``) against the f64 oracle.

The walk is the engine's only pruning path, so these tests pin it at the
shapes a fused kernel was once checked at: DNA at 4/8/64 taxa, protein
(S=20) and codon (S=61), each in f32 (the throughput mode, f64 reductions
under x64) and f64. The unrolled, scanned (``unroll=False``) and
rematerialized (``remat=True``) forms of the walk compute the same function
and must agree in value and gradient; a 256-taxon remat gradient in f32
must agree with f64.
"""
import jax
import numpy as np
import pytest

import oracle.core as oracle
from phylo_utils_tpu import models
from phylo_utils_tpu.io import encode_codon_alignment
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.trees import random_tree

_DNA_FREQS = np.array([0.3, 0.2, 0.2, 0.3])


def _alignment(tree, n_sites, chars, seed):
    rng = np.random.default_rng(seed)
    return {n: "".join(rng.choice(chars, size=n_sites))
            for n in tree.leaf_names}


def _case(n_taxa, n_sites, n_states, seed=0):
    """(tree, alignment, engine kwargs, engine params, oracle model, oracle
    rates). Alignments are simulated under the model itself: uniformly
    random columns of 20 or 61 states hinge on P(t) entries far below
    1e-8, which a spectral P(t) carries only to its absolute rounding."""
    from phylo_utils_tpu.simulate import simulate_alignment

    tree = random_tree(n_taxa, seed=seed)
    key = jax.random.key(seed + 1)
    if n_states == 4:
        mp = {"kappa": 2.5, "freqs": _DNA_FREQS}
        aln = simulate_alignment(key, tree, models.HKY85, n_sites,
                                 params={**mp, "alpha": 0.7}, ncat=4)
        return (tree, aln, dict(model=models.HKY85, ncat=4),
                {"alpha": 0.7, "model": mp},
                oracle.hky85(2.5, _DNA_FREQS), oracle.discrete_gamma(0.7, 4))
    if n_states == 20:
        aln = simulate_alignment(key, tree, models.LG, n_sites,
                                 params={"alpha": 0.9}, ncat=4)
        return (tree, aln, dict(model=models.LG, ncat=4), {"alpha": 0.9},
                oracle.lg(), oracle.discrete_gamma(0.9, 4))
    assert n_states == 61
    mp = {"kappa": 2.5, "omega": 0.3}
    aln = encode_codon_alignment(
        simulate_alignment(key, tree, models.GY94, n_sites, params=mp))
    return (tree, aln, dict(model=models.GY94), {"model": mp},
            oracle.gy94(2.5, 0.3), None)


SHAPES = [(4, 10, 4), (8, 100, 4), (64, 300, 4), (16, 130, 20), (8, 64, 61)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_xla_walk_matches_oracle(shape, dtype):
    tree, aln, kw, params, om, rates = _case(*shape)
    engine = LikelihoodEngine(tree, aln, dtype=dtype, **kw)
    ll = engine.loglikelihood(params)
    ca = engine._compressed
    alphabet = "protein" if shape[2] == 20 else "dna"
    gold = oracle.loglikelihood(
        tree, aln if isinstance(aln, dict) else {}, om, alphabet=alphabet,
        rates=rates, pattern_weights=np.asarray(ca.weights),
        leaf_partials=np.asarray(ca.partials, np.float64)[
            [ca.names.index(n) for n in tree.leaf_names]],
    )
    tol = 1e-6 if dtype == "float32" else 1e-9
    assert abs(ll - gold) / abs(gold) < tol, (ll, gold)


_VARIANTS = {
    "scan": {"unroll": False},
    "remat": {"remat": True},
    "scan_remat": {"unroll": False, "remat": True},
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("n_states", [4, 20])
def test_walk_variants_value_and_grad_agree(n_states, variant):
    tree, aln, kw, params, _, _ = _case(12, 40, n_states, seed=5)
    base = LikelihoodEngine(tree, aln, dtype="float64", **kw)
    other = LikelihoodEngine(tree, aln, dtype="float64", **kw,
                             **_VARIANTS[variant])
    v0, g0 = base.value_and_grad(params)
    v1, g1 = other.value_and_grad(params)
    assert float(v1) == pytest.approx(float(v0), rel=1e-12)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-9, atol=1e-10)


def test_big_tree_remat_gradient_f32_matches_f64():
    """256 taxa, remat walk: the f32 engine's logL and branch-length
    gradient agree with the f64 engine's (the gradient memory of big trees
    is carried by remat, not by a segmented kernel)."""
    tree = random_tree(256, seed=7, mean_brlen=0.05)
    aln = _alignment(tree, 48, list("ACGT"), 8)
    kw = dict(ncat=2, remat=True)
    e32 = LikelihoodEngine(tree, aln, models.GTR, dtype="float32", **kw)
    e64 = LikelihoodEngine(tree, aln, models.GTR, dtype="float64", **kw)
    v32, g32 = e32.value_and_grad()
    v64, g64 = e64.value_and_grad()
    assert abs(float(v32) - float(v64)) / abs(float(v64)) < 1e-6
    np.testing.assert_allclose(
        np.asarray(g32["branch_lengths"], np.float64),
        np.asarray(g64["branch_lengths"]), rtol=1e-3, atol=1e-3,
    )


@pytest.mark.parametrize("sites", [1000, 2048, 2500])
def test_blocked_dp_matches_plain_vjp(sites):
    """The gradient's dP sums over sites in blocks of ``DP_BLOCK`` (zero
    padding the last); it must equal the plain contraction's VJP, and its
    forward-mode derivative (Hessians) must work too."""
    import jax.numpy as jnp

    from phylo_utils_tpu.ops.pruning import _child_messages

    rng = np.random.default_rng(sites)
    p = jnp.asarray(rng.random((3, 2, 2, 4, 4)))
    child = jnp.asarray(rng.random((3, 2, 2, sites, 4)))
    cot = jnp.asarray(rng.normal(size=(3, 2, 2, sites, 4)))

    def plain(p, child):
        return jnp.einsum("wckij,wcksj->wcksi", p, child,
                          precision=jax.lax.Precision.HIGHEST)

    out, vjp = jax.vjp(_child_messages, p, child)
    out0, vjp0 = jax.vjp(plain, p, child)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out0), rtol=1e-14)
    for a, b in zip(vjp(cot), vjp0(cot)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-12)
    tp = jnp.asarray(rng.normal(size=p.shape))
    _, t = jax.jvp(_child_messages, (p, child), (tp, jnp.zeros_like(child)))
    _, t0 = jax.jvp(plain, (p, child), (tp, jnp.zeros_like(child)))
    np.testing.assert_allclose(np.asarray(t), np.asarray(t0), rtol=1e-12)
