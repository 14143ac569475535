"""Schedule binarization: multifurcations -> binary combines via
pseudo-nodes with exact-identity P (trees.compile_schedule(binarize=True),
ops.pmatrix.extend_p_identity).

An unrooted tree's trifurcating root previously forced cmax=3 on every
node's combine (a wasted masked third contraction at ~2N binary nodes in
the pruning pass); binarization makes cmax=2 with one extra identity
combine at each multifurcation, which is mathematically the same
likelihood (product regrouping).
"""
import jax
import numpy as np
import pytest

import oracle
from phylo_utils_tpu import models
from phylo_utils_tpu.ancestral import ancestral_posteriors
from phylo_utils_tpu.io import parse_newick
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.trees import compile_schedule, nni_neighbors

UNROOTED = "((A:0.1,B:0.2):0.1,(C:0.15,(D:0.05,E:0.3):0.12):0.2,F:0.31);"
POLYTOMY = "((A:0.1,B:0.2,C:0.05,G:0.4):0.1,(D:0.05,E:0.3):0.12,F:0.31);"


def _aln(tree, n=157, seed=1):
    rng = np.random.default_rng(seed)
    return {
        name: "".join(rng.choice(list("ACGT"), size=n))
        for name in tree.leaf_names
    }


def test_binarized_schedule_structure():
    tree = parse_newick(POLYTOMY)
    s = compile_schedule(tree)
    # one pseudo-node for the 3-child root, two for the 4-way polytomy
    assert s.n_children_max == 2
    assert s.n_real_nodes == tree.n_nodes
    assert s.n_nodes == tree.n_nodes + 3
    assert s.root == tree.root  # root keeps its id
    # legacy (unbinarized) schedule still available and distinct
    s0 = compile_schedule(tree, binarize=False)
    assert s0.n_children_max == 4
    assert s0.n_nodes == s0.n_real_nodes == tree.n_nodes


def test_binary_tree_schedule_unchanged():
    """Binary trees must produce bit-identical schedules either way
    (keeps the benchmark path's compiled program byte-stable)."""
    from phylo_utils_tpu.trees import random_tree

    tree = random_tree(16, seed=3)
    a = compile_schedule(tree, binarize=True)
    b = compile_schedule(tree, binarize=False)
    assert a.n_nodes == b.n_nodes and a.n_real_nodes == b.n_nodes
    np.testing.assert_array_equal(a.level_nodes, b.level_nodes)
    np.testing.assert_array_equal(a.level_children, b.level_children)
    np.testing.assert_array_equal(a.level_childmask, b.level_childmask)


@pytest.mark.parametrize("nwk", [UNROOTED, POLYTOMY])
@pytest.mark.parametrize("dtype", ["float64", "float32"], ids=["xla", "f32"])
def test_multifurcation_logl_matches_oracle(nwk, dtype):
    tree = parse_newick(nwk)
    aln = _aln(tree)
    gold = oracle.loglikelihood(
        tree, aln, oracle.hky85(2.5, [0.3, 0.2, 0.2, 0.3]),
        rates=oracle.discrete_gamma(0.8, 4),
    )
    P = {"alpha": 0.8,
         "model": {"kappa": 2.5, "freqs": np.array([0.3, 0.2, 0.2, 0.3])}}
    tol = 1e-6 if dtype == "float32" else 1e-9
    e = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, dtype=dtype)
    ll = e.loglikelihood(P)
    assert abs(ll - gold) / abs(gold) < tol


def test_multifurcation_gradients_match_fd():
    tree = parse_newick(UNROOTED)
    aln = _aln(tree)
    e = LikelihoodEngine(tree, aln, models.GTR, ncat=2, dtype="float64")
    full = e._full_params(None)
    g = e._jit_grad(full, e._leaf_partials, e._weights)
    gb = np.asarray(g["branch_lengths"])
    assert gb.shape[0] == tree.n_nodes  # real nodes only in params
    eps = 1e-6
    bl = np.array(full["branch_lengths"])
    for i in (0, 2, 7):
        b2 = bl.copy(); b2[i] += eps
        up = e.loglikelihood({"branch_lengths": b2})
        b2 = bl.copy(); b2[i] -= eps
        dn = e.loglikelihood({"branch_lengths": b2})
        fd = (up - dn) / (2 * eps)
        assert abs(gb[i] - fd) < 1e-4 * max(1.0, abs(fd))


def test_ancestral_posteriors_report_real_nodes_only():
    tree = parse_newick(POLYTOMY)
    aln = _aln(tree, n=83)
    e = LikelihoodEngine(tree, aln, models.HKY85, ncat=4, dtype="float64")
    post = ancestral_posteriors(e)
    assert post.shape == (tree.n_nodes - tree.n_leaves, 83, 4)
    np.testing.assert_allclose(post.sum(-1), 1.0, atol=1e-8)


def test_batched_topologies_unrooted_match_single():
    tree = parse_newick(POLYTOMY)
    aln = _aln(tree)
    from phylo_utils_tpu.batched import TopologySetEngine

    nbrs = nni_neighbors(tree)[:3]
    be = TopologySetEngine(nbrs, aln, models.HKY85, ncat=2, dtype="float64")
    totals = be.loglikelihoods()
    for t2, tot in zip(nbrs, totals):
        e1 = LikelihoodEngine(t2, aln, models.HKY85, ncat=2,
                              dtype="float64")
        assert abs(e1.loglikelihood() - float(tot)) < 1e-8


def test_mixture_engine_unrooted():
    tree = parse_newick(UNROOTED)
    aln = _aln(tree)
    from phylo_utils_tpu.mixtures import ModelMixtureEngine

    me = ModelMixtureEngine(
        tree, aln, models.HKY85,
        mixture=[{"kappa": 1.5}, {"kappa": 5.0}], dtype="float64",
    )
    llm = me.loglikelihood()
    # the 2-class equal-weight mixture logL is bounded by the per-class
    # logLs mixed sitewise; a coarse sanity envelope:
    g1 = oracle.loglikelihood(tree, aln, oracle.hky85(1.5, [0.25] * 4))
    g2 = oracle.loglikelihood(tree, aln, oracle.hky85(5.0, [0.25] * 4))
    assert min(g1, g2) + np.log(0.5) - 1e-6 <= llm <= max(g1, g2) + 1e-6
