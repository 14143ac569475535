"""Worked end-to-end analysis with phylo_utils_tpu.

Simulate data under a known model, then recover everything from scratch:
distances → NJ tree → NNI/SPR search → model selection → joint ML fit →
rate/ancestral posteriors → bootstrap + topology tests.

Run:  python examples/full_analysis.py            (GPU or CPU)
      JAX_PLATFORMS=cpu python examples/full_analysis.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import phylo_utils_tpu as pu
from phylo_utils_tpu.ancestral import site_rate_posteriors
from phylo_utils_tpu.optimize import ml_distance_matrix


def main():
    # ---- ground truth + simulated alignment -------------------------------
    true_tree = pu.random_tree(10, seed=7, mean_brlen=0.15)
    aln = pu.simulate_alignment(
        jax.random.key(0), true_tree, pu.models.HKY85, 1500,
        params={"kappa": 4.0, "alpha": 0.4}, ncat=4,
    )
    print(f"simulated {len(aln)} taxa x 1500 sites under HKY85+G4 (kappa=4)")

    # ---- de-novo tree: ML distances -> NJ -> NNI refinement ---------------
    d = ml_distance_matrix(aln, pu.models.K80)
    nj = pu.neighbor_joining(d, list(aln))
    tree, ll_search, rounds = pu.nni_hill_climb(
        nj, aln, pu.models.K80, ncat=4, moves="both", max_rounds=10
    )
    print(f"NJ + {rounds}-round NNI/SPR search: logL {ll_search:.2f}, "
          f"RF to truth = {pu.robinson_foulds(true_tree, tree)}")

    # ---- model selection ---------------------------------------------------
    fits = pu.compare_models(
        tree, aln, candidates=["JC69", "K80+G", "HKY85+G", "GTR+G"],
        max_steps=120,
    )
    print("model ranking (BIC):",
          [(f.name, round(f.bic, 1)) for f in fits])
    best_spec = fits[0]

    # ---- joint ML fit under the winning model ------------------------------
    engine = pu.LikelihoodEngine(tree, aln, pu.models.HKY85, ncat=4)
    result = pu.fit(engine, max_steps=200, steps_per_call=10)
    print(f"fit: logL {result.loglik:.2f}, "
          f"kappa {float(result.params['model']['kappa']):.2f}, "
          f"alpha {float(result.params['alpha']):.2f}")

    # ---- posteriors --------------------------------------------------------
    gam = site_rate_posteriors(engine, result.params)
    post = pu.ancestral_posteriors(engine, result.params)
    print(f"site-rate posteriors {gam.shape}, "
          f"root MAP state of site 0: {int(post[-1, 0].argmax())}")

    # ---- uncertainty: bootstrap + topology tests ---------------------------
    boots = engine.bootstrap_loglikelihoods(200, result.params, seed=1)
    print(f"bootstrap logL sd: {boots.std():.2f}")
    cands = [tree] + pu.nni_neighbors(tree)[:6]
    tse = pu.TopologySetEngine(cands, aln, pu.models.HKY85, ncat=4)
    sw = tse.sitewise_loglikelihoods(
        {"model": result.params["model"], "alpha": result.params["alpha"]}
    )
    sh = pu.sh_test(sw)
    print(f"SH test: best tree index {sh['best']}, "
          f"{int((sh['pvalue'] < 0.05).sum())} neighbors rejected at 5%")


if __name__ == "__main__":
    main()
