"""Topology significance tests: KH and SH via RELL bootstrap.

Given per-site log-likelihoods for a set of candidate topologies (one
device program via ``TopologySetEngine.sitewise_loglikelihoods``), the
RELL (resampling estimated log-likelihood) bootstrap resamples SITES with
replacement — which is just a resampled weighted sum of the per-site logL
matrix, no re-optimization — and asks whether each tree's deficit to the
best tree is explainable by sampling noise.

- Kishino-Hasegawa (KH): pairwise test of tree i vs the ML tree; valid
  when the two trees were specified a priori.
- Shimodaira-Hasegawa (SH): simultaneous test over the whole candidate
  set with centering, controlling selection bias of picking the ML tree.
- Approximately Unbiased (AU, Shimodaira 2002): multiscale RELL
  bootstrap — BP curves across resample sizes r*n extrapolated through
  psi(r) = d*sqrt(r) + c/sqrt(r), p_AU = 1 - Phi(d - c). Less biased
  than KH, less conservative than SH; the standard tree-set test
  (CONSEL / IQ-TREE report it).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["rell_logliks", "kh_test", "sh_test", "au_test",
           "likelihood_mapping"]


def rell_logliks(
    sitewise: np.ndarray,           # (n_trees, n_sites)
    n_boot: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """(n_boot, n_trees) total logLs under RELL site resampling."""
    sitewise = np.asarray(sitewise, np.float64)
    n_trees, n_sites = sitewise.shape
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(
        n_sites, np.full(n_sites, 1.0 / n_sites), size=n_boot
    )                                # (n_boot, n_sites)
    return counts @ sitewise.T       # (n_boot, n_trees)


def kh_test(
    sitewise: np.ndarray,
    n_boot: int = 1000,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Kishino-Hasegawa test of each tree against the ML tree.

    Returns {"delta": observed logL deficits, "pvalue": per-tree p-values,
    "best": ML tree index}. The ML tree's p-value is 1 by construction.
    """
    sitewise = np.asarray(sitewise, np.float64)
    totals = sitewise.sum(axis=1)
    best = int(np.argmax(totals))
    delta = totals[best] - totals           # (n_trees,) >= 0
    # bootstrap distribution of the CENTERED pairwise difference
    diff_site = sitewise[best][None, :] - sitewise       # (n_trees, n_sites)
    centered = diff_site - diff_site.mean(axis=1, keepdims=True)
    boot = rell_logliks(centered, n_boot=n_boot, seed=seed)  # (B, n_trees)
    pvals = (boot >= delta[None, :]).mean(axis=0)
    pvals[best] = 1.0
    return {"delta": delta, "pvalue": pvals, "best": best}


def sh_test(
    sitewise: np.ndarray,
    n_boot: int = 1000,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Shimodaira-Hasegawa test over the full candidate set.

    For each bootstrap replicate, every tree's resampled logL is centered
    by its own expectation; the null distribution of each tree's deficit is
    max_j(centered_j) - centered_i. Conservative for all trees
    simultaneously. Returns {"delta", "pvalue", "best"}.
    """
    sitewise = np.asarray(sitewise, np.float64)
    totals = sitewise.sum(axis=1)
    best = int(np.argmax(totals))
    delta = totals[best] - totals
    boot = rell_logliks(sitewise, n_boot=n_boot, seed=seed)  # (B, T)
    centered = boot - boot.mean(axis=0, keepdims=True)
    null_delta = centered.max(axis=1, keepdims=True) - centered  # (B, T)
    pvals = (null_delta >= delta[None, :]).mean(axis=0)
    return {"delta": delta, "pvalue": pvals, "best": best}


_AU_SCALES = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4)


def au_test(
    sitewise: np.ndarray,
    n_boot: int = 2000,
    seed: int = 0,
    scales: Sequence[float] = _AU_SCALES,
) -> Dict[str, np.ndarray]:
    """Approximately Unbiased test (Shimodaira 2002, Syst. Biol. 51:492).

    Multiscale RELL bootstrap: at each scale ``r`` the replicate draws
    ``round(r * n_sites)`` sites; ``BP_i(r)`` is the fraction of
    replicates in which tree i has the top resampled logL. The normal
    quantiles ``psi_i(r) = Phi^-1(1 - BP_i(r))`` are regressed (weighted
    least squares, binomial delta-method weights) on the model
    ``psi = d*sqrt(r) + c/sqrt(r)`` — ``d`` estimates the signed distance
    to the selection-region boundary and ``c`` its curvature — giving
    ``p_AU(i) = 1 - Phi(d - c)``.

    Returns {"pvalue", "bp" (BP at r=1), "delta", "best", "d", "c"}.
    Trees whose BP is identically 0 (or 1) at every scale get p = 0
    (or 1) directly — the regression is undefined there.
    """
    from scipy.special import ndtr, ndtri

    sitewise = np.asarray(sitewise, np.float64)
    n_trees, n_sites = sitewise.shape
    totals = sitewise.sum(axis=1)
    best = int(np.argmax(totals))
    delta = totals[best] - totals
    rng = np.random.default_rng(seed)

    bp = np.empty((len(scales), n_trees))
    for si, r in enumerate(scales):
        m = max(1, int(round(r * n_sites)))
        counts = rng.multinomial(
            m, np.full(n_sites, 1.0 / n_sites), size=n_boot
        )
        boot = counts @ sitewise.T               # (B, T)
        winner = np.argmax(boot, axis=1)
        bp[si] = np.bincount(winner, minlength=n_trees) / n_boot

    # clip away exact 0/1 so the quantile transform is finite; track the
    # degenerate rows for the direct-assignment fallback
    lo = 0.5 / n_boot
    all_zero = (bp <= 0).all(axis=0)
    all_one = (bp >= 1).all(axis=0)
    bpc = np.clip(bp, lo, 1.0 - lo)
    psi = ndtri(1.0 - bpc)                       # (S, T)

    rs = np.asarray(scales, np.float64)
    x1 = np.sqrt(rs)                             # (S,)
    x2 = 1.0 / np.sqrt(rs)
    # delta-method WLS weights: var(psi) = BP(1-BP) / (B * phi(psi)^2)
    phi = np.exp(-0.5 * psi ** 2) / np.sqrt(2.0 * np.pi)
    wts = n_boot * phi ** 2 / (bpc * (1.0 - bpc))   # (S, T)

    d = np.empty(n_trees)
    c = np.empty(n_trees)
    pvals = np.empty(n_trees)
    for i in range(n_trees):
        if all_zero[i]:
            d[i], c[i], pvals[i] = np.inf, 0.0, 0.0
            continue
        if all_one[i]:
            d[i], c[i], pvals[i] = -np.inf, 0.0, 1.0
            continue
        w = wts[:, i]
        a11 = np.sum(w * x1 * x1)
        a12 = np.sum(w * x1 * x2)
        a22 = np.sum(w * x2 * x2)
        b1 = np.sum(w * x1 * psi[:, i])
        b2 = np.sum(w * x2 * psi[:, i])
        det = a11 * a22 - a12 * a12
        d[i] = (a22 * b1 - a12 * b2) / det
        c[i] = (a11 * b2 - a12 * b1) / det
        pvals[i] = 1.0 - ndtr(d[i] - c[i])
    r1 = int(np.argmin(np.abs(rs - 1.0)))
    return {
        "pvalue": pvals, "bp": bp[r1], "delta": delta, "best": best,
        "d": d, "c": c,
    }


def likelihood_mapping(
    alignment,
    model,
    params: Optional[dict] = None,
    n_quartets: int = 200,
    seed: int = 0,
    steps: int = 60,
    resolved_threshold: float = 0.95,
    star_threshold: float = 0.45,
):
    """Likelihood mapping (Strimmer & von Haeseler 1997, PNAS 94:6815).

    Samples ``n_quartets`` random 4-taxon subsets; for each, computes the
    ML log-likelihood of the three possible quartet topologies (five
    branch lengths optimized per topology) and maps the posterior weight
    vector onto the 2-simplex. The distribution of points diagnoses how
    tree-like the alignment is before any tree search.

    Batched: all ``3 * n_quartets`` four-taxon likelihood surfaces are
    optimized SIMULTANEOUSLY in one jitted program — the quartet pruning
    is written directly as einsums (no schedule machinery needed at this
    size) and vmapped over (quartet, topology); Adam in the softplus
    branch-length space.

    Returns {"points": (Q, 3) posterior weights ordered (ab|cd, ac|bd,
    ad|bc) for the sampled taxa (a,b,c,d); "quartets": (Q, 4) taxon
    indices; "basins": fraction of quartets whose best topology is each
    pairing; "resolved": fraction with max weight >= resolved_threshold;
    "star": fraction with max weight <= star_threshold (near the
    uninformative 1/3 center); "names": taxon order}.

    The resolved/star cutoffs are explicit parameters (reported tools
    draw finer 7-region pictures; occupancies quoted in practice are the
    resolved/ambiguous/star fractions these thresholds give).
    """
    import jax
    import jax.numpy as jnp

    from phylo_utils_tpu.alphabets import encode_alignment
    from phylo_utils_tpu.ops.pmatrix import transition_matrices

    names, arr = encode_alignment(alignment, model.alphabet,
                                  dtype=np.float64)
    n_taxa = arr.shape[0]
    if n_taxa < 4:
        raise ValueError("likelihood mapping needs >= 4 taxa")
    rng = np.random.default_rng(seed)
    quartets = np.stack([
        rng.choice(n_taxa, size=4, replace=False)
        for _ in range(n_quartets)
    ])                                               # (Q, 4)

    eig = model.eigen(
        {**model.defaults(jnp.float64), **{
            k: jnp.asarray(v, jnp.float64)
            for k, v in (params or {}).items()
        }},
        dtype=jnp.float64,
    )
    freqs = eig.freqs
    # (Q, 4, sites, S) leaf conditionals, f32 for speed
    lp = jnp.asarray(arr, jnp.float32)[jnp.asarray(quartets)]
    # the three pairings of (a, b, c, d): (ab|cd), (ac|bd), (ad|bc) as
    # index permutations of the quartet's four rows
    pairings = jnp.asarray([[0, 1, 2, 3], [0, 2, 1, 3], [0, 3, 1, 2]])

    hi = jax.lax.Precision.HIGHEST

    def quartet_logl(lp4, raw_t):
        """lp4: (4, sites, S) ordered (a, b | c, d); raw_t: (5,)."""
        t = jax.nn.softplus(raw_t)
        p = transition_matrices(eig, t.astype(jnp.float64),
                                out_dtype=jnp.float32)   # (5, S, S)
        msg = jnp.einsum("eij,esj->esi", p[:4], lp4,
                         precision=hi)                   # (4, sites, S)
        u = msg[0] * msg[1]                              # (sites, S)
        v = msg[2] * msg[3]
        pv = jnp.einsum("ij,sj->si", p[4], v, precision=hi)
        lik = jnp.einsum("i,si->s", freqs.astype(jnp.float32), u * pv,
                         precision=hi)
        return jnp.sum(jnp.log(jnp.maximum(lik, 1e-35)))

    def optimized_logl(lp4):
        import optax

        opt = optax.adam(0.1)
        raw0 = jnp.full((5,), 0.0, jnp.float32)          # softplus ~ 0.69
        state0 = opt.init(raw0)

        def step(carry, _):
            raw, st = carry
            ll, g = jax.value_and_grad(
                lambda r: -quartet_logl(lp4, r)
            )(raw)
            upd, st = opt.update(g, st, raw)
            return (optax.apply_updates(raw, upd), st), -ll

        (raw, _), lls = jax.lax.scan(step, (raw0, state0), None,
                                     length=steps)
        return jnp.maximum(quartet_logl(lp4, raw), jnp.max(lls))

    @jax.jit
    def run(lp):
        def one_quartet(lp4):
            return jax.vmap(
                lambda perm: optimized_logl(lp4[perm])
            )(pairings)                                  # (3,)

        return jax.vmap(one_quartet)(lp)                 # (Q, 3)

    lls = np.asarray(run(lp), np.float64)
    m = lls.max(axis=1, keepdims=True)
    w = np.exp(lls - m)
    points = w / w.sum(axis=1, keepdims=True)            # (Q, 3)
    best = points.argmax(axis=1)
    pmax = points.max(axis=1)
    return {
        "points": points,
        "quartets": quartets,
        "basins": np.bincount(best, minlength=3) / n_quartets,
        "resolved": float((pmax >= resolved_threshold).mean()),
        "star": float((pmax <= star_threshold).mean()),
        "names": names,
    }
