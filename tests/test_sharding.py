"""Distributed tests on the 8-virtual-CPU-device mesh (SURVEY.md §4.5).

Asserts: sharded-sites logL == single-device logL, gradient reduction
correctness, and that the one-step sharded training step (the
``__graft_entry__.dryrun_multichip`` path) runs and is finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phylo_utils_tpu import models
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.parallel import SiteSharding, make_mesh
from phylo_utils_tpu.trees import random_tree


def _aln(tree, sites, seed=0):
    rng = np.random.default_rng(seed)
    return {
        n: "".join(rng.choice(list("ACGT"), size=sites))
        for n in tree.leaf_names
    }


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests must run on the 8-device CPU mesh"
    return make_mesh()


def test_sharded_logl_equals_unsharded(mesh):
    tree = random_tree(16, seed=2)
    aln = _aln(tree, 97, seed=3)  # 97 patterns: not divisible by 8 -> padding
    single = LikelihoodEngine(tree, aln, models.GTR, ncat=4)
    sharded = LikelihoodEngine(
        tree, aln, models.GTR, ncat=4, sharding=SiteSharding(mesh)
    )
    ll_s = single.loglikelihood()
    ll_d = sharded.loglikelihood()
    assert ll_s == pytest.approx(ll_d, rel=1e-12, abs=1e-9)


def test_sharded_gradient_equals_unsharded(mesh):
    tree = random_tree(8, seed=5)
    aln = _aln(tree, 50, seed=6)
    single = LikelihoodEngine(tree, aln, models.HKY85, ncat=2)
    sharded = LikelihoodEngine(
        tree, aln, models.HKY85, ncat=2, sharding=SiteSharding(mesh)
    )
    g_s = single.gradient()
    g_d = sharded.gradient()
    for a, b in zip(jax.tree.leaves(g_s), jax.tree.leaves(g_d)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8)


def test_sharding_actually_distributes(mesh):
    tree = random_tree(8, seed=5)
    aln = _aln(tree, 64, seed=6)
    sh = SiteSharding(mesh)
    engine = LikelihoodEngine(tree, aln, models.JC69, sharding=sh)
    lp = engine._leaf_partials
    assert len(lp.sharding.device_set) == 8
    # each device holds a 1/8 pattern slice
    shard_shapes = {s.data.shape for s in lp.addressable_shards}
    assert shard_shapes == {(lp.shape[0], lp.shape[1] // 8, lp.shape[2])}


def test_sharded_pinv_and_sitewise(mesh):
    tree = random_tree(8, seed=9)
    aln = _aln(tree, 40, seed=10)
    kw = dict(ncat=2, invariant_sites=True)
    single = LikelihoodEngine(tree, aln, models.GTR, **kw)
    sharded = LikelihoodEngine(
        tree, aln, models.GTR, sharding=SiteSharding(mesh), **kw
    )
    p = {"alpha": 0.7, "pinv": 0.15}
    assert single.loglikelihood(p) == pytest.approx(
        sharded.loglikelihood(p), rel=1e-12
    )
    np.testing.assert_allclose(
        single.sitewise_loglikelihoods(p),
        sharded.sitewise_loglikelihoods(p),
        rtol=1e-10,
    )


def test_dryrun_multichip_entrypoint():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_sharded_f32_matches_unsharded(mesh):
    """The f32 engine on the mesh must give the single-device logL."""
    tree = random_tree(12, seed=20)
    aln = _aln(tree, 96, seed=21)
    single = LikelihoodEngine(tree, aln, models.GTR, ncat=2, dtype="float32")
    sharded = LikelihoodEngine(
        tree, aln, models.GTR, ncat=2,
        sharding=SiteSharding(mesh), dtype="float32",
    )
    # full-f32 run: the sharded weighted sum reduces in a different order,
    # so agreement is at f32 rounding level (exact in the f64 engine test)
    assert single.loglikelihood() == pytest.approx(
        sharded.loglikelihood(), rel=1e-6
    )
    # gradient reduction across shards (f32 tolerance)
    g = sharded.gradient()
    gs = single.gradient()
    np.testing.assert_allclose(
        np.asarray(g["branch_lengths"]), np.asarray(gs["branch_lengths"]),
        rtol=1e-4,
    )


def test_engine_rejects_wrong_alphabet_and_pruner():
    from phylo_utils_tpu.io import compress_patterns

    tree = random_tree(4, seed=0)
    aln = _aln(tree, 20, seed=0)
    dna_encoded = compress_patterns(aln, "dna")  # 4-state partials
    with pytest.raises(ValueError, match="states"):
        LikelihoodEngine(tree, dna_encoded, models.LG)  # 20-state model
    # the kernel-choice keyword is gone: the XLA walk is the only one
    with pytest.raises(TypeError, match="pruner"):
        LikelihoodEngine(tree, aln, models.JC69, pruner="pallas")
