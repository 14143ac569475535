"""StackedPartitionedEngine == PartitionedEngine (VERDICT r4 item 3).

The stacked formulation puts same-family loci on a vmap batch axis of ONE
engine program (compile cost independent of partition count). It must be
numerically interchangeable with the general inlined-engines formulation.
"""
import jax
import numpy as np
import pytest

from phylo_utils_tpu import models
from phylo_utils_tpu.optimize import fit
from phylo_utils_tpu.partition import (
    Partition,
    PartitionedEngine,
    StackedPartitionedEngine,
)
from phylo_utils_tpu.simulate import simulate_alignment
from phylo_utils_tpu.trees import random_tree


@pytest.fixture(scope="module")
def setup():
    tree = random_tree(8, seed=3)
    alns = [
        simulate_alignment(jax.random.PRNGKey(i), tree, models.GTR,
                           n_sites=120 + 40 * i, ncat=2)
        for i in range(3)
    ]
    parts = [
        Partition(f"locus{i}", a, models.GTR, ncat=2)
        for i, a in enumerate(alns)
    ]
    return tree, parts


def test_stacked_matches_general(setup):
    tree, parts = setup
    gen = PartitionedEngine(tree, parts)
    stk = StackedPartitionedEngine(tree, parts)
    assert gen.loglikelihood() == pytest.approx(
        stk.loglikelihood(), rel=1e-12
    )
    pg, ps = gen.partition_loglikelihoods(), stk.partition_loglikelihoods()
    for k in pg:
        assert pg[k] == pytest.approx(ps[k], rel=1e-10)
    gg, gs = gen.gradient(), stk.gradient()
    for a, b in zip(jax.tree.leaves(gg), jax.tree.leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-10)


def test_stacked_matches_with_params_and_rates(setup):
    tree, parts = setup
    gen = PartitionedEngine(tree, parts)
    stk = StackedPartitionedEngine(tree, parts)
    params = {
        "partition_rates": [0.5, 1.5, 2.0],
        "partitions": {
            "locus1": {"model": {"freqs": [0.4, 0.2, 0.2, 0.2]},
                       "alpha": 0.7},
        },
    }
    assert gen.loglikelihood(params) == pytest.approx(
        stk.loglikelihood(params), rel=1e-12
    )


def test_stacked_fit_matches_general(setup):
    tree, parts = setup
    gen = PartitionedEngine(tree, parts)
    stk = StackedPartitionedEngine(tree, parts)
    rg = fit(gen, max_steps=5, steps_per_call=5)
    rs = fit(stk, max_steps=5, steps_per_call=5)
    assert rs.loglik == pytest.approx(rg.loglik, rel=1e-8)


def test_stacked_rejects_heterogeneous():
    tree = random_tree(6, seed=0)
    a = simulate_alignment(jax.random.PRNGKey(0), tree, models.JC69,
                           n_sites=60)
    parts = [
        Partition("x", a, models.JC69),
        Partition("y", a, models.HKY85),
    ]
    with pytest.raises(ValueError, match="share the model family"):
        StackedPartitionedEngine(tree, parts)


def test_stacked_f32_matches_general(setup):
    tree, parts = setup
    gen = PartitionedEngine(tree, parts)
    stk = StackedPartitionedEngine(tree, parts, dtype="float32")
    assert gen.loglikelihood() == pytest.approx(
        stk.loglikelihood(), rel=1e-6
    )
    gg, gs = gen.gradient(), stk.gradient()
    for a, b in zip(jax.tree.leaves(gg), jax.tree.leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
