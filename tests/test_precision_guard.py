"""Every f32 contraction on an engine's loglik/gradient path asks for
``Precision.HIGHEST``.

On a GPU with tensor cores an f32 ``dot_general`` that names no precision
may run in TF32, which keeps about three decimal digits: far outside the
1e-6 relative logL budget. Library code sets no global
``default_matmul_precision``, so each contraction must carry its own. The
guard walks the traced jaxpr (sub-jaxprs of scan, cond, custom_jvp, remat
and pjit included) of ``value_and_grad`` of each engine family's loglik.
"""
import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from phylo_utils_tpu import models
from phylo_utils_tpu.trees import random_tree

_HI = jax.lax.Precision.HIGHEST


def _sub_jaxprs(params):
    for v in params.values():
        for j in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(j, jax.extend.core.ClosedJaxpr):
                yield j.jaxpr
            elif isinstance(j, jax.extend.core.Jaxpr):
                yield j


def f32_dots_without_highest(jaxpr, found=None):
    """(precision, operand dtypes) of every f32 ``dot_general`` in
    ``jaxpr`` (recursively) whose precision is not HIGHEST on both
    operands."""
    found = [] if found is None else found
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dts = [v.aval.dtype for v in eqn.invars]
            prec = eqn.params.get("precision")
            if any(d == jnp.float32 for d in dts) and prec != (_HI, _HI):
                found.append((prec, [str(d) for d in dts]))
        for sub in _sub_jaxprs(eqn.params):
            f32_dots_without_highest(sub, found)
    return found


def _dna(n_taxa=8, n_sites=60, seed=1, chars="ACGT"):
    tree = random_tree(n_taxa, seed=seed)
    rng = np.random.default_rng(seed)
    aln = {n: "".join(rng.choice(list(chars), size=n_sites))
           for n in tree.leaf_names}
    return tree, aln


def _codon(n_taxa=5, n_codons=20, seed=2):
    from phylo_utils_tpu.io import encode_codon_alignment
    from phylo_utils_tpu.simulate import simulate_alignment

    tree = random_tree(n_taxa, seed=seed)
    aln = simulate_alignment(jax.random.key(seed), tree, models.GY94,
                             n_codons)
    return tree, encode_codon_alignment(aln)


def _engine_loss(engine):
    """(loss(params), params) on the engine's own traced loglik."""
    from phylo_utils_tpu.batched import TopologySetEngine

    full = engine._full_params(None)
    if isinstance(engine, TopologySetEngine):
        return (lambda p: jnp.sum(engine._loglik_fn(p)[0])), full
    lp, w = engine._leaf_partials, engine._weights
    return (lambda p: engine._loglik_fn(p, lp, w)[0]), full


def _build(family):
    from phylo_utils_tpu.likelihood import LikelihoodEngine

    if family == "dna_gtr_gamma_inv":
        tree, aln = _dna()
        return LikelihoodEngine(tree, aln, models.GTR, ncat=4,
                                invariant_sites=True, dtype="float32")
    if family == "protein_lg_gamma":
        tree, aln = _dna(chars="ARNDCQEGHILKMFPSTWYV")
        return LikelihoodEngine(tree, aln, models.LG, ncat=4,
                                dtype="float32")
    if family == "codon_gy94":
        tree, ca = _codon()
        return LikelihoodEngine(tree, ca, models.GY94, dtype="float32")
    if family == "model_mixture":
        from phylo_utils_tpu.mixtures import ModelMixtureEngine

        tree, aln = _dna()
        return ModelMixtureEngine(
            tree, aln, models.HKY85, [{"kappa": 1.0}, {"kappa": 8.0}],
            invariant_sites=True, dtype="float32")
    if family == "m2a_codon":
        from phylo_utils_tpu.mixtures import M2aEngine

        tree, ca = _codon()
        return M2aEngine(tree, ca, dtype="float32")
    if family == "branch_model":
        from phylo_utils_tpu.branch_models import BranchModelEngine

        tree, aln = _dna()
        cls = np.zeros(tree.n_nodes, np.int32)
        cls[: tree.n_nodes // 2] = 1
        return BranchModelEngine(
            tree, aln, models.HKY85, branch_classes=cls,
            class_params=[{"kappa": 2.0}, {"kappa": 4.0}], ncat=2,
            dtype="float32")
    if family == "clock":
        from phylo_utils_tpu.clock import ClockEngine

        tree, aln = _dna()
        return ClockEngine(tree, aln, models.HKY85, ncat=2, dtype="float32")
    if family == "stacked_partition":
        from phylo_utils_tpu.partition import (
            Partition,
            StackedPartitionedEngine,
        )

        tree, a0 = _dna(seed=3)
        _, a1 = _dna(seed=4, n_sites=40)
        parts = [Partition("l0", a0, models.GTR, ncat=2),
                 Partition("l1", a1, models.GTR, ncat=2)]
        return StackedPartitionedEngine(tree, parts, dtype="float32")
    if family == "topology_set":
        from phylo_utils_tpu.batched import TopologySetEngine

        tree, aln = _dna()
        return TopologySetEngine([tree, random_tree(8, seed=5)], aln,
                                 models.GTR, ncat=2, dtype="float32")
    raise ValueError(family)


FAMILIES = [
    "dna_gtr_gamma_inv",
    "protein_lg_gamma",
    "codon_gy94",
    "model_mixture",
    "m2a_codon",
    "branch_model",
    "clock",
    "stacked_partition",
    "topology_set",
]


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_contractions_are_highest_precision(family):
    engine = _build(family)
    loss, full = _engine_loss(engine)
    jaxpr = jax.make_jaxpr(jax.value_and_grad(loss))(full).jaxpr
    bad = f32_dots_without_highest(jaxpr)
    assert not bad, f"{family}: f32 dot_general without HIGHEST: {bad}"
    eig = engine.model_eigen(full) if hasattr(engine, "model_eigen") else None
    if eig is not None:
        lp, w = engine._leaf_partials, engine._weights
        jp = jax.make_jaxpr(
            lambda p: engine._loglik_fn(p, lp, w, eig=eig)[0])(full).jaxpr
        bad = f32_dots_without_highest(jp)
        assert not bad, f"{family} (cached eigen): {bad}"


def test_guard_detects_default_precision():
    """The guard itself sees a plain f32 matmul."""
    x = jnp.ones((3, 3), jnp.float32)
    jp = jax.make_jaxpr(lambda a: jnp.tanh(a @ a))(x).jaxpr
    assert len(f32_dots_without_highest(jp)) == 1
    jp = jax.make_jaxpr(
        lambda a: jnp.matmul(a, a, precision=_HI))(x).jaxpr
    assert f32_dots_without_highest(jp) == []
