"""Worked example: the codeml-style selection toolkit, end to end.

Simulates codon data where one half of the sites evolves under positive
selection and one clade evolves faster, then runs the full battery:
empirical codon frequencies (F3x4), M1a-vs-M2a and M7-vs-M8 site tests
with NEB site scans, the branch-site Model A test on the fast clade, a
free-ratio branch model, and a molecular-clock LRT.

Run: python examples/selection_analysis.py   (GPU or CPU; CPU only:
     JAX_PLATFORMS=cpu python examples/selection_analysis.py)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from phylo_utils_tpu import models
from phylo_utils_tpu.branch_models import (
    BranchModelEngine,
    branch_site_test,
    free_ratio_classes,
    mark_clade,
)
from phylo_utils_tpu.clock import clock_test
from phylo_utils_tpu.io import encode_codon_alignment, parse_newick
from phylo_utils_tpu.mixtures import (  # noqa: F401
    M1aEngine,
    M2aEngine,
    m1a_m2a_test,
    omega_posteriors,
)
from phylo_utils_tpu.models.codon import empirical_codon_frequencies
from phylo_utils_tpu.optimize import fit
from phylo_utils_tpu.simulate import simulate_alignment

# --- simulate: 150 purifying + 150 positively selected codon sites --------
tree = parse_newick(
    "(((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1):0.05,(e:0.2,f:0.2):0.05);"
)
pur = simulate_alignment(jax.random.key(0), tree, models.GY94, 150,
                         params={"omega": 0.1, "kappa": 2.5})
pos = simulate_alignment(jax.random.key(1), tree, models.GY94, 150,
                         params={"omega": 4.0, "kappa": 2.5})
aln = {n: pur[n] + pos[n] for n in pur}
ca = encode_codon_alignment(aln)
f3x4 = empirical_codon_frequencies(aln, "f3x4")
params0 = {"shared": {"freqs": f3x4}}
free = ("branch_lengths", "shared.kappa")  # freqs fixed at F3x4 (codeml)

# --- M1a vs M2a -----------------------------------------------------------
m1a = M1aEngine(tree, ca)
r1 = fit(m1a, params0=params0, free=free + ("proportions", "omega0"),
         max_steps=80)
m2a = M2aEngine(tree, ca)
r2 = fit(m2a, params0=params0,
         free=free + ("proportions", "omega0", "omega2_delta"),
         max_steps=100)
lrt = m1a_m2a_test(r1.loglik, r2.loglik)
print(f"M1a lnL={r1.loglik:.2f}  M2a lnL={r2.loglik:.2f}  "
      f"p={lrt['pvalue']:.2e}")
omega2 = 1.0 + float(np.asarray(r2.params["omega2_delta"]))
print(f"  positive class omega = {omega2:.2f}")

# NEB site scan: which sites are under positive selection?
mean_omega, gam = omega_posteriors(m2a, r2.params)
called = np.where(gam[:, -1] > 0.95)[0]
frac_right = np.mean(called >= 150) if len(called) else 0.0
print(f"  NEB sites with P(positive)>0.95: {len(called)} "
      f"({frac_right:.0%} in the truly positive half)")

# BEB (codeml's published site table): integrates over parameter
# uncertainty instead of plugging in the MLEs
from phylo_utils_tpu.mixtures import beb_site_posteriors

p_pos, beb_w = beb_site_posteriors(m2a, r2.params)
called_beb = np.where(p_pos > 0.95)[0]
frac_right = np.mean(called_beb >= 150) if len(called_beb) else 0.0
print(f"  BEB sites with P(positive)>0.95: {len(called_beb)} "
      f"({frac_right:.0%} in the truly positive half)")

# --- branch-site Model A on the fast clade ---------------------------------
bs = branch_site_test(tree, ca, mark_clade(tree, ["e", "f"]),
                      params0=params0, max_steps=80)
print(f"branch-site A: alt lnL={bs['alt'].loglik:.2f}  "
      f"null lnL={bs['null'].loglik:.2f}  p={bs['lrt']['pvalue']:.2e}")

# --- free-ratio branch model (one omega per edge) ---------------------------
fr = BranchModelEngine(
    tree, ca, models.GY94, free_ratio_classes(tree),
    class_params=[{"omega": 1.0} for _ in range(tree.n_nodes)],
    shared={"freqs": f3x4},
)
rfr = fit(fr, free=("branch_lengths", "classes"), max_steps=60)
om = np.asarray(rfr.params["classes"]["omega"])[: tree.n_nodes - 1]
print(f"free-ratio: lnL={rfr.loglik:.2f}  per-edge omega in "
      f"[{om.min():.2f}, {om.max():.2f}]")

# --- molecular clock on the nucleotide level --------------------------------
dna = {n: s for n, s in aln.items()}
ct = clock_test(tree, dna, models.HKY85, max_steps=80)
print(f"clock LRT: df={ct['df']}  p={ct['lrt']['pvalue']:.3f}  "
      f"(clock lnL={ct['null'].loglik:.2f}, free lnL={ct['alt'].loglik:.2f})")
