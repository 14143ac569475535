"""Model mixtures: categories that differ in MODEL PARAMETERS, not just rate.

Rate mixtures (gamma/FreeRate) scale branch lengths per category; model
mixtures give each category its own substitution-model parameters — e.g.
the M3 site-selection models (discrete omega classes over a GY94 codon
model: sites evolve under purifying/neutral/positive selection with
estimable class weights), or empirical profile mixtures. The pruning pass
already carries a category axis, so the only change is building one Q (and
P batch) per category via vmap over a stacked parameter PyTree.

``omega_posteriors`` gives per-site posterior class membership and the
posterior mean omega — the standard positive-selection site scan.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
)
from phylo_utils_tpu.ops.pruning import (
    invariant_site_likelihood,
    mixture_loglik,
)

__all__ = ["ModelMixtureEngine", "M1aEngine", "M2aEngine",
           "M7Engine", "M8Engine", "M8aEngine",
           "omega_posteriors", "beb_site_posteriors",
           "beb_site_posteriors_m8",
           "positive_selection_test", "m1a_m2a_test", "m8_m8a_test"]


def _stack_params(param_dicts: Sequence[Mapping], dtype) -> Dict:
    """List of per-category param dicts -> one dict of stacked leaves."""
    keys = set(param_dicts[0].keys())
    for d in param_dicts[1:]:
        if set(d.keys()) != keys:
            raise ValueError("mixture categories must share parameter names")
    return {
        k: jnp.stack([jnp.asarray(d[k], dtype) for d in param_dicts])
        for k in keys
    }


class ModelMixtureEngine(LikelihoodEngine):
    """LikelihoodEngine whose categories have independent model parameters.

    ``mixture``: list of K parameter dicts for ``model`` (same keys each);
    weights start uniform and are a free simplex parameter
    (``cat_weights``). The reversible model's build is vmapped over the
    stacked parameters, producing per-category Q/P; everything downstream
    (pruning, scaling, mixing, gradients, sharding) is unchanged.
    """

    def __init__(self, tree, alignment, model, mixture: Sequence[Mapping],
                 class_models: Optional[Sequence] = None, **kwargs):
        """``class_models``: optional list of per-class Models (one per
        mixture category) overriding ``model``'s rate matrix class by
        class — the LG4M/LG4X family, where each class carries its OWN
        exchangeability matrix, not just its own frequencies/params.
        All class models must share state count and parameter names
        (empirical protein models all expose just ``freqs``)."""
        if not model.reversible:
            raise ValueError("model mixtures require a reversible model")
        if len(mixture) < 2:
            raise ValueError("need at least 2 mixture categories")
        if class_models is not None:
            if len(class_models) != len(mixture):
                raise ValueError(
                    f"class_models has {len(class_models)} entries for "
                    f"{len(mixture)} mixture classes"
                )
            for cm in class_models:
                if not cm.reversible:
                    raise ValueError(
                        f"class model {cm.name!r} is not reversible"
                    )
                if cm.n_states != model.n_states:
                    raise ValueError(
                        f"class model {cm.name!r} has {cm.n_states} "
                        f"states, expected {model.n_states}"
                    )
                if set(cm.param_defaults) != set(model.param_defaults):
                    raise ValueError(
                        f"class model {cm.name!r} parameter names "
                        f"{sorted(cm.param_defaults)} differ from the "
                        f"base model's {sorted(model.param_defaults)}"
                    )
        kwargs.pop("ncat", None)
        super().__init__(tree, alignment, model, ncat=len(mixture), **kwargs)
        self._class_models = list(class_models) if class_models else None
        base_defaults = [
            (class_models[i] if class_models else model).param_defaults
            for i in range(len(mixture))
        ]
        self._mixture0 = [
            {**{k: v for k, v in d.items()}, **dict(m)}
            for d, m in zip(base_defaults, mixture)
        ]

    def default_params(self) -> Dict:
        params = {
            "branch_lengths": jnp.asarray(self.tree.lengths, self.dtype),
            "mixture": _stack_params(self._mixture0, self.dtype),
            "cat_weights": jnp.full(
                (self.ncat,), 1.0 / self.ncat, self.dtype
            ),
        }
        if self.invariant_sites:
            params["pinv"] = jnp.asarray(0.2, self.dtype)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        from phylo_utils_tpu.likelihood import validate_param_keys

        full = self.default_params()
        if params:
            validate_param_keys(params, full, type(self).__name__,
                                nested="mixture")
            for k, v in params.items():
                if k == "mixture":
                    full["mixture"] = {**full["mixture"], **{
                        kk: jnp.asarray(vv, self.dtype)
                        for kk, vv in v.items()
                    }}
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full

    def _category_model_params(self, params):
        """Hook: (stacked per-category model-param dict, class weights).

        Subclasses (M7/M8) derive the stacked parameters from
        hyperparameters instead of carrying them free."""
        cat_weights = params["cat_weights"].astype(self.dtype)
        return params["mixture"], cat_weights / jnp.sum(cat_weights)

    def _class_syms_freqs(self, mixture):
        """Per-class (sym, freqs) stacks from the stacked mixture params.

        With ``class_models`` each class builds under its OWN model (the
        LG4M/LG4X per-class rate matrices) — a host-side loop over the K
        tiny builds; otherwise one shared build vmapped over the stack."""
        cms = getattr(self, "_class_models", None)
        if cms is not None:
            pairs = [
                cm.build(**{k: v[i] for k, v in mixture.items()})
                for i, cm in enumerate(cms)
            ]
            return (jnp.stack([p[0] for p in pairs]),
                    jnp.stack([p[1] for p in pairs]))
        return jax.vmap(lambda cp: self.model.build(**cp))(mixture)

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """Per-category P and PER-CATEGORY frequencies.

        Shared by ``_loglik_fn``, ``category_posteriors``, and the
        ancestral/posterior machinery (ancestral.py), which detects the
        (K, S)-shaped ``freqs`` and contracts root reductions with
        per-category frequencies ('ksi,ki->ks')."""
        mixture, cat_weights = self._category_model_params(params)
        t = params["branch_lengths"].astype(dtype)           # (n_nodes,)
        sym_k, freqs_k = self._class_syms_freqs(mixture)     # (K,S,S),(K,S)
        # per-category P for all edges: vmap categories, batch edges inside
        p_k = jax.vmap(
            lambda s, f: p_matrices_reversible(s, f, t)
        )(sym_k, freqs_k)                                    # (K, n_nodes, S, S)
        p = jnp.swapaxes(p_k, 0, 1)                          # (n_nodes, K, S, S)
        p = extend_p_identity(p, self.schedule.n_nodes)
        return (jnp.ones((self.ncat,), dtype),
                cat_weights.astype(dtype), p, freqs_k.astype(dtype))

    def _loglik_fn(self, params, leaf_partials, weights):
        dtype = self.dtype
        _, cat_weights, p, freqs_k = self._mixture_tensors(params, dtype)
        root_partials, root_logscale = self._prune(p, leaf_partials)
        # mixture root reduction with PER-CATEGORY frequencies
        site_lik = jnp.einsum(
            "ksi,ki->ks", root_partials, freqs_k.astype(dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        m = jnp.max(root_logscale, axis=0)
        mixed = jnp.sum(
            cat_weights[:, None] * site_lik
            * jnp.exp(root_logscale - m[None, :]),
            axis=0,
        )
        if self.invariant_sites:
            pinv = jnp.asarray(params["pinv"], dtype)
            # invariant component under the weight-averaged frequencies
            freqs_bar = jnp.einsum("k,ki->i", cat_weights, freqs_k,
                                   precision=jax.lax.Precision.HIGHEST)
            inv = invariant_site_likelihood(leaf_partials, freqs_bar)
            log_var = jnp.log(mixed) + m
            log_inv = jnp.where(
                inv > 0, jnp.log(jnp.where(inv > 0, inv, 1.0)), -jnp.inf
            )
            sitewise = jnp.logaddexp(
                jnp.log1p(-pinv) + log_var, jnp.log(pinv) + log_inv
            )
        else:
            sitewise = jnp.log(mixed) + m
        total = jnp.sum(weights.astype(dtype) * sitewise)
        return total, sitewise

    def category_posteriors(self, params: Optional[Mapping] = None):
        """Per-site posterior class membership (n_sites, K)."""
        full = self._full_params(params)
        dtype = self.dtype

        def compute(full, leaf_partials):
            _, cat_weights, p, freqs_k = self._mixture_tensors(full, dtype)
            root_partials, root_logscale = self._prune(p, leaf_partials)
            lik = jnp.einsum("ksi,ki->ks", root_partials,
                             freqs_k.astype(dtype),
                             precision=jax.lax.Precision.HIGHEST)
            m = jnp.max(root_logscale, axis=0)
            gam = cat_weights[:, None] * lik * jnp.exp(
                root_logscale - m[None, :]
            )
            return (gam / jnp.sum(gam, axis=0, keepdims=True)).T

        if not hasattr(self, "_catpost_jit"):
            self._catpost_jit = jax.jit(compute)
        gam = self._catpost_jit(full, self._leaf_partials)
        gam = np.asarray(gam)[: self._compressed.n_patterns]
        return gam[self._compressed.site_to_pattern]


class SharedOmegaMixtureEngine(ModelMixtureEngine):
    """Omega-class site mixtures whose non-omega parameters are SHARED.

    The codeml site-model family (M1a/M2a/M7/M8): K site classes that
    differ ONLY in omega, derived from a few free hyperparameters, while
    kappa and codon frequencies (``shared``) are common to all classes.
    Subclass hooks: ``_n_classes()`` (static class count),
    ``_hyper_defaults()`` (the omega hyperparameters), and
    ``_class_omegas_weights(params) -> (omegas, weights)``.
    """

    def __init__(self, tree, alignment, model=None, **kwargs):
        if model is None:
            from phylo_utils_tpu.models import GY94 as model
        if "omega" not in model.param_defaults:
            raise ValueError(
                "omega site mixtures need a model with an 'omega' parameter"
            )
        mixture = [
            dict(model.param_defaults) for _ in range(self._n_classes())
        ]
        super().__init__(tree, alignment, model, mixture, **kwargs)

    def _n_classes(self) -> int:
        raise NotImplementedError

    def _hyper_defaults(self) -> Dict:
        raise NotImplementedError

    def default_params(self) -> Dict:
        shared0 = {
            k: v for k, v in self.model.param_defaults.items()
            if k != "omega"
        }
        params = {
            "branch_lengths": jnp.asarray(self.tree.lengths, self.dtype),
            "shared": {
                k: jnp.asarray(v, self.dtype) for k, v in shared0.items()
            },
        }
        for k, v in self._hyper_defaults().items():
            params[k] = jnp.asarray(v, self.dtype)
        if self.invariant_sites:
            params["pinv"] = jnp.asarray(0.2, self.dtype)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        from phylo_utils_tpu.likelihood import validate_param_keys

        full = self.default_params()
        if params:
            validate_param_keys(params, full, type(self).__name__,
                                nested="shared")
            for k, v in params.items():
                if k == "shared":
                    full["shared"] = {**full["shared"], **{
                        kk: jnp.asarray(vv, self.dtype)
                        for kk, vv in v.items()
                    }}
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full

    def _class_omegas_weights(self, params):
        raise NotImplementedError

    def _category_model_params(self, params):
        om, w = self._class_omegas_weights(params)
        k = om.shape[0]
        mixture = {
            kk: jnp.broadcast_to(vv[None, ...], (k,) + vv.shape)
            for kk, vv in params["shared"].items()
        }
        mixture = {**mixture, "omega": om}
        return mixture, w


class M1aEngine(SharedOmegaMixtureEngine):
    """codeml M1a "nearly neutral" (Nielsen & Yang 1998; Wong et al. 2004).

    Two site classes: purifying ``0 < omega0 < 1`` (weight p0) and
    neutral ``omega = 1`` (weight 1 - p0). Free parameters:
    ``proportions`` (2-simplex), ``omega0`` (unit interval — sigmoid
    under ``fit``), ``shared`` (kappa, codon freqs), branch lengths.
    The null model of the M1a-vs-M2a positive-selection LRT
    (``m1a_m2a_test``).
    """

    def _n_classes(self) -> int:
        return 2

    def _hyper_defaults(self) -> Dict:
        return {"proportions": [0.7, 0.3], "omega0": 0.2}

    def _class_omegas_weights(self, params):
        dtype = self.dtype
        om0 = jnp.clip(
            jnp.asarray(params["omega0"], dtype), 1e-8, 1.0 - 1e-8
        )
        om = jnp.stack([om0, jnp.ones((), dtype)])
        w = params["proportions"].astype(dtype)
        return om, w / jnp.sum(w)


class M2aEngine(M1aEngine):
    """codeml M2a "positive selection" (Wong et al. 2004; Yang et al. 2005).

    M1a plus a third class ``omega2 = 1 + omega2_delta > 1`` (weight p2;
    ``omega2_delta`` softplus-positive under ``fit``). The per-site
    posterior weight on the last class (``omega_posteriors``) is the
    NEB positively-selected-site scan. Alternative model of
    ``m1a_m2a_test`` (df = 2).
    """

    def _n_classes(self) -> int:
        return 3

    def _hyper_defaults(self) -> Dict:
        return {
            "proportions": [0.6, 0.3, 0.1],
            "omega0": 0.2,
            "omega2_delta": 1.0,
        }

    def _class_omegas_weights(self, params):
        dtype = self.dtype
        om, _ = super()._class_omegas_weights(params)
        om2 = 1.0 + jnp.asarray(params["omega2_delta"], dtype)
        w = params["proportions"].astype(dtype)
        return jnp.concatenate([om, om2[None]]), w / jnp.sum(w)


class M7Engine(SharedOmegaMixtureEngine):
    """Yang et al. (2000) M7: site omega ~ Beta(p, q), discretized.

    ``ncat`` equal-weight classes whose omega is the within-bin Beta mean
    (PAML codeml's discretization; ``ops.beta.discrete_beta``), with the
    GY94 kappa and codon frequencies shared across classes. Free
    parameters: ``beta_p``, ``beta_q`` (positive), ``shared`` (kappa,
    freqs), branch lengths — all differentiable end-to-end, so ``fit``
    optimizes the beta shape directly. The null model of the M7-vs-M8
    positive-selection test (``positive_selection_test``).
    """

    _EXTRA_KEYS: tuple = ()

    def __init__(self, tree, alignment, model=None, ncat: int = 10,
                 **kwargs):
        self.n_beta = int(ncat)
        super().__init__(tree, alignment, model=model, **kwargs)

    def _n_classes(self) -> int:
        return self.n_beta + (1 if self._EXTRA_KEYS else 0)

    def _hyper_defaults(self) -> Dict:
        return {
            "beta_p": 1.0,
            "beta_q": 1.0,
            **self._extra_defaults(),
        }

    def _extra_defaults(self) -> Dict:
        return {}

    def _class_omegas_weights(self, params):
        from phylo_utils_tpu.ops.beta import discrete_beta

        om = discrete_beta(
            params["beta_p"], params["beta_q"], self.n_beta
        ).astype(self.dtype)
        w = jnp.full((self.n_beta,), 1.0 / self.n_beta, self.dtype)
        return om, w


class M8Engine(M7Engine):
    """Yang et al. (2000) M8: Beta(p, q) plus one omega > 1 class.

    With proportion ``p0`` sites follow the discretized Beta (purifying/
    neutral); with proportion 1 - p0 they evolve under
    ``omega = 1 + omega_delta`` (positive selection; the +1 floor keeps
    the extra class in the omega > 1 regime codeml constrains it to and
    the delta softplus-positive under ``fit``'s reparameterization).
    Compare against M7 with ``positive_selection_test``.
    """

    _EXTRA_KEYS = ("p0", "omega_delta")

    def _extra_defaults(self) -> Dict:
        return {"p0": 0.9, "omega_delta": 1.0}

    def _class_omegas_weights(self, params):
        om, _ = super()._class_omegas_weights(params)
        p0 = jnp.clip(params["p0"].astype(self.dtype), 1e-6, 1.0 - 1e-6)
        om = jnp.concatenate([
            om, (1.0 + params["omega_delta"].astype(self.dtype))[None],
        ])
        w = jnp.concatenate([
            jnp.full((self.n_beta,), 1.0 / self.n_beta, self.dtype) * p0,
            (1.0 - p0)[None],
        ])
        return om, w


class M8aEngine(M8Engine):
    """M8a (Swanson et al. 2003; Wong et al. 2004): the M8 null with the
    extra class's omega FIXED at 1 — Beta(p, q) plus a neutral class of
    proportion 1 - p0. The M8-vs-M8a comparison (``m8_m8a_test``) is the
    recommended boundary-aware positive-selection LRT: under the null
    omega_s sits ON the omega = 1 boundary, so the statistic follows the
    1/2 chi2_0 + 1/2 chi2_1 mixture, not a plain chi2_1."""

    _EXTRA_KEYS = ("p0",)

    def _extra_defaults(self) -> Dict:
        return {"p0": 0.9}

    def _class_omegas_weights(self, params):
        om, _ = M7Engine._class_omegas_weights(self, params)
        p0 = jnp.clip(params["p0"].astype(self.dtype), 1e-6, 1.0 - 1e-6)
        om = jnp.concatenate([om, jnp.ones((1,), self.dtype)])
        w = jnp.concatenate([
            jnp.full((self.n_beta,), 1.0 / self.n_beta, self.dtype) * p0,
            (1.0 - p0)[None],
        ])
        return om, w


def positive_selection_test(ll_m7: float, ll_m8: float) -> Dict:
    """M7-vs-M8 LRT for positive selection (2 extra params -> df=2)."""
    from phylo_utils_tpu.model_selection import likelihood_ratio_test

    return likelihood_ratio_test(ll_m7, ll_m8, df=2)


def m8_m8a_test(ll_m8a: float, ll_m8: float) -> Dict:
    """M8-vs-M8a LRT with the boundary-mixture null: under M8a the extra
    class's omega is pinned AT the omega = 1 boundary, so
    2(lnL_M8 - lnL_M8a) ~ 1/2 chi2_0 + 1/2 chi2_1 (codeml practice;
    Self & Liang 1987). Returns {"statistic", "pvalue"}."""
    from scipy.stats import chi2

    stat = 2.0 * (ll_m8 - ll_m8a)
    p = 0.5 * float(chi2.sf(max(stat, 0.0), 1)) if stat > 0 else 1.0
    return {"statistic": float(stat), "pvalue": p}


def m1a_m2a_test(ll_m1a: float, ll_m2a: float) -> Dict:
    """M1a-vs-M2a LRT for positive selection (p2, omega2 extra -> df=2)."""
    from phylo_utils_tpu.model_selection import likelihood_ratio_test

    return likelihood_ratio_test(ll_m1a, ll_m2a, df=2)


def omega_posteriors(
    engine: ModelMixtureEngine, params: Optional[Mapping] = None
):
    """Per-site (posterior_mean_omega, class_posteriors) for a GY94 omega
    mixture — the M3/M7/M8 site-selection scan (for M8, the posterior
    weight on the last class is the per-site positive-selection
    probability, codeml's BEB-style site table's NEB analog)."""
    full = engine._full_params(params)
    mixture, _ = engine._category_model_params(full)
    omegas = np.asarray(mixture["omega"], np.float64)
    gam = engine.category_posteriors(params)
    return gam @ omegas, gam


# ---------------------------------------------------------------------------
# Bayes Empirical Bayes (Yang, Wong & Nielsen 2005)
# ---------------------------------------------------------------------------


def _site_class_logliks(engine, params, omegas):
    """Per-omega sitewise LOG-likelihoods: (len(omegas), n_patterns).

    One pruning pass with the omega grid as the category axis; kappa and
    codon frequencies come from ``params['shared']`` (the MLEs)."""
    dtype = engine.dtype
    full = engine._full_params(params)

    def compute(full, leaf_partials, omegas):
        t = full["branch_lengths"].astype(dtype)
        k = omegas.shape[0]
        stacked = {
            kk: jnp.broadcast_to(
                jnp.asarray(vv, dtype)[None, ...],
                (k,) + jnp.shape(jnp.asarray(vv)),
            )
            for kk, vv in full["shared"].items()
        }
        stacked = {**stacked, "omega": omegas.astype(dtype)}
        sym_k, freqs_k = jax.vmap(
            lambda cp: engine.model.build(**cp)
        )(stacked)
        p_k = jax.vmap(
            lambda s, f: p_matrices_reversible(s, f, t)
        )(sym_k, freqs_k)
        p = jnp.swapaxes(p_k, 0, 1)
        p = extend_p_identity(p, engine.schedule.n_nodes)
        root_partials, root_logscale = engine._prune(p, leaf_partials)
        lik = jnp.einsum("ksi,ki->ks", root_partials,
                         freqs_k.astype(dtype),
                         precision=jax.lax.Precision.HIGHEST)
        return jnp.log(lik) + root_logscale

    if not hasattr(engine, "_beb_jit"):
        engine._beb_jit = jax.jit(compute)
    return np.asarray(
        engine._beb_jit(full, engine._leaf_partials,
                        jnp.asarray(omegas, dtype)),
        np.float64,
    )


def beb_site_posteriors(engine, params: Optional[Mapping] = None,
                        d: int = 10):
    """Bayes Empirical Bayes positive-selection site scan for M2a.

    Yang, Wong & Nielsen (2005): instead of plugging in the MLEs of the
    mixture proportions and omegas (NEB, ``omega_posteriors``), integrate
    the site-class posteriors over a uniform prior grid on
    (p0, p1, omega0, omega2), weighting each grid point by its posterior
    given the data (branch lengths, kappa and codon frequencies stay at
    their MLEs, as in codeml). Grid (codeml's discretization): omega0 at
    d midpoints of (0,1); omega2 at d midpoints of (1,11); (p0,p1) at
    the d x d square midpoints folded onto the 2-simplex.

    Returns ``(p_positive, mean_omega)`` per site (not per pattern):
    the BEB posterior probability that the site is in the omega2 class,
    and the BEB posterior mean omega.
    """
    from phylo_utils_tpu.mixtures import M2aEngine

    if not isinstance(engine, M2aEngine):
        raise TypeError("BEB is implemented for M2aEngine")
    full = engine._full_params(params)
    w0 = (np.arange(d) + 0.5) / d                    # (d,)
    w2 = 1.0 + (np.arange(d) + 0.5) * (10.0 / d)     # (d,)
    omegas = np.concatenate([w0, [1.0], w2])         # (2d+1,)
    logf = _site_class_logliks(engine, full, omegas)  # (2d+1, P)
    weights = np.asarray(engine._weights, np.float64)
    n_pat = engine._compressed.n_patterns
    logf = logf[:, :n_pat]
    weights = weights[:n_pat]

    # proportion grid: square midpoints folded onto the triangle
    g0, g1 = np.meshgrid((np.arange(d) + 0.5) / d,
                         (np.arange(d) + 0.5) / d, indexing="ij")
    p0g, p1g = g0.ravel().copy(), g1.ravel().copy()
    over = p0g + p1g > 1.0
    p0g[over], p1g[over] = 1.0 - p0g[over], 1.0 - p1g[over]
    p2g = 1.0 - p0g - p1g                            # (d^2,)

    # grid = (props x omega0 x omega2); class log-liks per grid point are
    # gathers from logf rows: class0 -> w0[i], class1 -> row d, class2 ->
    # w2[j]. Work in (G, P) with G = d^2 * d * d, vectorized per (i, j).
    m = logf.max(axis=0)                             # (P,)
    f = np.exp(logf - m[None, :])                    # (2d+1, P) scaled liks
    f1 = f[d]                                        # omega = 1 row
    n_prop = p0g.shape[0]
    log_post = np.empty((d, d, n_prop))              # grid marginal logL
    # site-class posterior accumulators (expected class-2 prob, mean w)
    acc_pos = np.zeros(n_pat)
    acc_w = np.zeros(n_pat)
    # pass 1: grid posterior weights
    for i in range(d):
        for j in range(d):
            # mixture likelihood per prop point: (n_prop, P)
            lik = (p0g[:, None] * f[i][None, :]
                   + p1g[:, None] * f1[None, :]
                   + p2g[:, None] * f[d + 1 + j][None, :])
            log_post[i, j] = (weights[None, :]
                              * np.log(lik)).sum(axis=1)
    lp = log_post - log_post.max()
    post_g = np.exp(lp)
    post_g /= post_g.sum()                           # (d, d, n_prop)
    # pass 2: accumulate site posteriors under each grid point
    for i in range(d):
        for j in range(d):
            pg = post_g[i, j]                        # (n_prop,)
            if pg.max() < 1e-12:
                continue
            c0 = p0g[:, None] * f[i][None, :]
            c1 = p1g[:, None] * f1[None, :]
            c2 = p2g[:, None] * f[d + 1 + j][None, :]
            tot = c0 + c1 + c2
            acc_pos += pg @ (c2 / tot)
            acc_w += pg @ ((w0[i] * c0 + c1 + w2[j] * c2) / tot)
    s2p = engine._compressed.site_to_pattern
    return acc_pos[s2p], acc_w[s2p]


def beb_site_posteriors_m8(engine, params: Optional[Mapping] = None,
                           d: int = 10, n_fine: int = 20):
    """Bayes Empirical Bayes positive-selection scan for M8.

    Grid (after Yang, Wong & Nielsen 2005): ``p0`` at d midpoints of
    (0,1); beta parameters ``p``/``q`` at d midpoints of (0,2);
    ``omega_s`` at d midpoints of (1,11). The beta class omegas for each
    (p,q) pair are the equal-probability bin means SNAPPED to a fixed
    ``n_fine``-point omega grid on (0,1), so the whole scan needs one
    pruning pass with ``n_fine + d`` omega categories. Branch lengths,
    kappa and codon frequencies stay at their MLEs (codeml convention).

    Returns ``(p_positive, mean_omega)`` per site.
    """
    if not isinstance(engine, M8Engine):
        raise TypeError("M8 BEB is implemented for M8Engine")
    from phylo_utils_tpu.ops.beta import discrete_beta

    full = engine._full_params(params)
    w_fine = (np.arange(n_fine) + 0.5) / n_fine          # (0,1) grid
    w_s = 1.0 + (np.arange(d) + 0.5) * (10.0 / d)        # (1,11) grid
    omegas = np.concatenate([w_fine, w_s])
    logf = _site_class_logliks(engine, full, omegas)     # (n_fine+d, P)
    weights = np.asarray(engine._weights, np.float64)
    n_pat = engine._compressed.n_patterns
    logf = logf[:, :n_pat]
    weights = weights[:n_pat]
    m = logf.max(axis=0)
    f = np.exp(logf - m[None, :])                        # scaled liks
    f_beta, f_ws = f[:n_fine], f[n_fine:]                # views

    # beta-bin means per (p,q), snapped to the fine grid -> averaging
    # matrix B (n_pq, n_fine) with 1/n_beta at each snapped bin index
    pq = (np.arange(d) + 0.5) * (2.0 / d)
    n_beta = engine.n_beta
    pairs = [(p, q) for p in pq for q in pq]
    B = np.zeros((len(pairs), n_fine))
    for r, (p, q) in enumerate(pairs):
        means = np.asarray(discrete_beta(p, q, n_beta), np.float64)
        idx = np.clip((means * n_fine).astype(int), 0, n_fine - 1)
        for i in idx:
            B[r, i] += 1.0 / n_beta
    mixed_beta = B @ f_beta                              # (n_pq, P)

    p0g = (np.arange(d) + 0.5) / d                       # (d,)
    # pass 1: grid posterior. lik[a,b,c] = p0_a*mixed[b] + (1-p0_a)*f_ws[c]
    log_post = np.empty((d, len(pairs), d))
    for a in range(d):
        base = p0g[a] * mixed_beta                       # (n_pq, P)
        for c in range(d):
            lik = base + (1.0 - p0g[a]) * f_ws[c][None, :]
            log_post[a, :, c] = (weights[None, :] * np.log(lik)).sum(axis=1)
    lp = log_post - log_post.max()
    post_g = np.exp(lp)
    post_g /= post_g.sum()

    # pass 2: site posteriors. mean omega needs the beta-part posterior
    # mean per (p,q): precompute per-pair mean-omega-weighted mixture.
    Bw = np.zeros((len(pairs), n_fine))
    for r, (p, q) in enumerate(pairs):
        means = np.asarray(discrete_beta(p, q, n_beta), np.float64)
        idx = np.clip((means * n_fine).astype(int), 0, n_fine - 1)
        for mo, i in zip(means, idx):
            Bw[r, i] += mo / n_beta
    mixed_beta_w = Bw @ f_beta                           # (n_pq, P)

    acc_pos = np.zeros(n_pat)
    acc_w = np.zeros(n_pat)
    for a in range(d):
        for c in range(d):
            pg = post_g[a, :, c]                         # (n_pq,)
            if pg.max() < 1e-14:
                continue
            beta_part = p0g[a] * mixed_beta              # (n_pq, P)
            pos_part = (1.0 - p0g[a]) * f_ws[c][None, :]
            tot = beta_part + pos_part
            acc_pos += pg @ (pos_part / tot)
            acc_w += pg @ (
                (p0g[a] * mixed_beta_w + w_s[c] * pos_part) / tot
            )
    s2p = engine._compressed.site_to_pattern
    return acc_pos[s2p], acc_w[s2p]
