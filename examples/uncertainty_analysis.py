"""Worked example: quantifying phylogenetic uncertainty, end to end.

Simulates data under a known tree, then runs the round-3 uncertainty
toolkit: Felsenstein + Transfer (TBE) bootstrap supports with a
majority-rule consensus tree, the KH/SH/AU topology tests over a
candidate set, joint (Pupko) vs marginal ancestral reconstruction,
posterior-mean site rates, and parametric-bootstrap vs observed-Fisher
standard errors for the model parameters.

Run:  python examples/uncertainty_analysis.py      (GPU or CPU)
      JAX_PLATFORMS=cpu python examples/uncertainty_analysis.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import phylo_utils_tpu as pu
from phylo_utils_tpu.ancestral import (
    ancestral_posteriors,
    joint_ancestral_states,
    site_rates,
)
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.optimize import (
    fit,
    parametric_bootstrap,
    standard_errors,
)
from phylo_utils_tpu.supports import bootstrap_tree_support
from phylo_utils_tpu.topology_tests import au_test, kh_test, sh_test
from phylo_utils_tpu.trees import nni_neighbors
from phylo_utils_tpu.batched import TopologySetEngine


def main():
    true_tree = pu.random_tree(8, seed=11, mean_brlen=0.2)
    aln = pu.simulate_alignment(
        jax.random.key(1), true_tree, pu.models.K80, 1200,
        params={"kappa": 3.5, "alpha": 0.6}, ncat=4,
    )
    print(f"simulated {len(aln)} taxa x 1200 sites, K80+G4 (kappa=3.5)")

    # ---- ML fit + two flavors of parameter uncertainty --------------------
    engine = LikelihoodEngine(true_tree, aln, pu.models.K80, ncat=4)
    mle = fit(engine, max_steps=300)
    se = standard_errors(engine, mle.params)
    print(f"\nMLE: kappa={float(mle.params['model']['kappa']):.3f} "
          f"+- {float(se['model']['kappa']):.3f} (observed Fisher), "
          f"alpha={float(mle.params['alpha']):.3f}")
    pb = parametric_bootstrap(engine, mle.params, n_replicates=10,
                              max_steps=150)
    print(f"parametric bootstrap (10 reps): kappa SE = "
          f"{float(pb['se']['model']['kappa']):.3f} "
          f"(vs Fisher {float(se['model']['kappa']):.3f})")

    # ---- branch supports: FBP vs TBE + consensus --------------------------
    bs = bootstrap_tree_support(true_tree, aln, pu.models.K80,
                                n_reps=50, consensus=True, tbe=True)
    print("\nedge supports (FBP / TBE):")
    for e, f, t in zip(bs["edges"], bs["support"], bs["tbe"]):
        print(f"  edge {e}: {f:.2f} / {t:.2f}")
    print("consensus:", pu.write_newick(bs["consensus"]))

    # ---- topology significance: KH / SH / AU ------------------------------
    candidates = [true_tree] + nni_neighbors(true_tree)[:6]
    tse = TopologySetEngine(candidates, aln, pu.models.K80, ncat=4)
    sw = tse.sitewise_loglikelihoods(
        {"model": {"kappa": float(mle.params["model"]["kappa"])},
         "alpha": float(mle.params["alpha"])}
    )
    kh, sh, au = (f(sw, n_boot=1000, seed=0)
                  for f in (kh_test, sh_test, au_test))
    print("\ntree  dlnL    p(KH)  p(SH)  p(AU)")
    for i in range(len(candidates)):
        print(f"  {i}  {kh['delta'][i]:7.2f}  {kh['pvalue'][i]:.3f}  "
              f"{sh['pvalue'][i]:.3f}  {au['pvalue'][i]:.3f}")

    # ---- ancestral states: marginal vs joint ------------------------------
    post = ancestral_posteriors(engine, mle.params)
    joint = joint_ancestral_states(engine, mle.params)
    agree = float((post.argmax(axis=2) == joint["states"]).mean())
    print(f"\nmarginal-vs-joint ancestral agreement: {agree:.1%}")
    r = site_rates(engine, mle.params)
    print(f"site rates: min {r.min():.2f}, max {r.max():.2f} "
          f"(mean {r.mean():.2f})")


if __name__ == "__main__":
    main()
