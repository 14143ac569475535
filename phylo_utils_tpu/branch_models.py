"""Branch models: substitution parameters that vary ACROSS EDGES.

The reference (kgori/phylo_utils) is time-homogeneous — one model for the
whole tree (SURVEY.md §2 [HIGH]). Branch models are the standard extension
family from PAML codeml: every edge carries a class label, each class has
its own model parameters. Covered here:

- ``BranchModelEngine`` — general per-edge classes over any reversible
  model: two-ratio / multi-ratio omega models (codeml model=2), per-branch
  kappa, non-homogeneous GTR, and the free-ratio model (codeml model=1,
  one omega per edge). Composes with gamma rate heterogeneity (+G) and
  invariant sites (+I).
- ``BranchSiteAEngine`` — Yang & Nielsen (2002; Zhang et al. 2005 update)
  branch-site Model A: four site classes whose omega differs between
  FOREGROUND and BACKGROUND edges; the standard test for positive
  selection on a lineage (``branch_site_test``).

Batched design: edge classes are a static int vector baked into the
compiled program; per-class (sym, freqs) are built by one ``vmap`` over the
stacked class parameters, P(t) by the degeneracy-safe
``p_matrices_reversible`` custom-JVP path, and the per-edge matrix is a
single gather — everything downstream (the pruning pass, scaling,
mixing, ``jax.grad``, sharding, ancestral posteriors) is untouched: the
engines override only the ``_mixture_tensors`` hook.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu.likelihood import LikelihoodEngine, rate_categories
from phylo_utils_tpu.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
)
from phylo_utils_tpu.trees import Tree

__all__ = [
    "BranchModelEngine",
    "BranchSiteAEngine",
    "branch_site_test",
    "beb_branch_site",
    "mark_branches",
    "mark_clade",
    "free_ratio_classes",
]


# ---------------------------------------------------------------------------
# Edge-class construction helpers
# ---------------------------------------------------------------------------


def mark_branches(tree: Tree, names: Iterable[str], cls: int = 1,
                  base: Optional[np.ndarray] = None) -> np.ndarray:
    """Edge classes with the parent edges of the NAMED nodes set to ``cls``.

    ``names`` may contain leaf names or internal-node labels (as parsed
    from the Newick). Everything else keeps class 0 (or ``base``). This is
    the analog of codeml's ``#1`` branch marks.
    """
    out = (np.zeros(tree.n_nodes, np.int32) if base is None
           else np.asarray(base, np.int32).copy())
    wanted = set(names)
    found = set()
    for i, n in enumerate(tree.names):
        if n in wanted:
            out[i] = cls
            found.add(n)
    missing = wanted - found
    if missing:
        raise ValueError(f"tree has no nodes named {sorted(missing)}")
    return out


def mark_clade(tree: Tree, leaf_names: Iterable[str], cls: int = 1,
               include_stem: bool = True,
               base: Optional[np.ndarray] = None) -> np.ndarray:
    """Edge classes with every edge inside the clade spanned by
    ``leaf_names`` set to ``cls`` (codeml's ``$1`` clade marks).

    The clade is the subtree under the MRCA of ``leaf_names``;
    ``include_stem`` also marks the MRCA's own parent edge.
    """
    idx = tree.leaf_index()
    try:
        leaves = [idx[n] for n in leaf_names]
    except KeyError as e:
        raise ValueError(f"unknown leaf {e.args[0]!r}") from None
    if not leaves:
        raise ValueError("empty clade")
    # MRCA: intersect root paths
    paths = []
    for leaf in leaves:
        path, node = [], leaf
        while node != -1:
            path.append(node)
            node = int(tree.parent[node])
        paths.append(path)
    common = set(paths[0])
    for p in paths[1:]:
        common &= set(p)
    mrca = next(n for n in paths[0] if n in common)
    out = (np.zeros(tree.n_nodes, np.int32) if base is None
           else np.asarray(base, np.int32).copy())
    stack = list(tree.children[mrca])
    while stack:
        n = stack.pop()
        out[n] = cls
        stack.extend(tree.children[n])
    if include_stem and tree.parent[mrca] != -1:
        out[mrca] = cls
    return out


def free_ratio_classes(tree: Tree) -> np.ndarray:
    """One class per edge (codeml model=1, the free-ratio model)."""
    return np.arange(tree.n_nodes, dtype=np.int32)


def _normalize_classes(tree: Tree, branch_classes, n_classes: int) -> np.ndarray:
    if isinstance(branch_classes, Mapping):
        branch_classes = _classes_from_mapping(tree, branch_classes)
    cls = np.asarray(branch_classes, np.int32)
    if cls.shape != (tree.n_nodes,):
        raise ValueError(
            f"branch_classes must have one entry per node "
            f"({tree.n_nodes}), got shape {cls.shape}"
        )
    if cls.min() < 0 or cls.max() >= n_classes:
        raise ValueError(
            f"branch class ids must be in [0, {n_classes}); "
            f"got [{cls.min()}, {cls.max()}]"
        )
    return cls


def _classes_from_mapping(tree: Tree, mapping: Mapping[str, int]) -> np.ndarray:
    out = np.zeros(tree.n_nodes, np.int32)
    wanted = dict(mapping)
    for i, n in enumerate(tree.names):
        if n in wanted:
            out[i] = wanted.pop(n)
    if wanted:
        raise ValueError(f"tree has no nodes named {sorted(wanted)}")
    return out


def _stack_class_params(class_params: Sequence[Mapping], dtype) -> Dict:
    keys = set(class_params[0].keys())
    for d in class_params[1:]:
        if set(d.keys()) != keys:
            raise ValueError("branch classes must share parameter names")
    return {
        k: jnp.stack([jnp.asarray(d[k], dtype) for d in class_params])
        for k in keys
    }


# ---------------------------------------------------------------------------
# General per-edge-class engine
# ---------------------------------------------------------------------------


class BranchModelEngine(LikelihoodEngine):
    """Likelihood engine whose model parameters vary by EDGE CLASS.

    Parameters
    ----------
    tree, alignment, model : as LikelihoodEngine (model must be reversible)
    branch_classes : int array (n_nodes,) — class of each node's parent
        edge (root entry unused), or a mapping ``{node name: class}`` with
        unnamed nodes defaulting to class 0. Build with ``mark_branches`` /
        ``mark_clade`` / ``free_ratio_classes``.
    class_params : list of per-class parameter dicts (same keys in every
        class — e.g. ``[{"omega": 0.2}, {"omega": 1.5}]`` for a two-ratio
        model). These become the free ``params["classes"]`` PyTree.
    shared : overrides for the model parameters NOT listed per class
        (e.g. kappa, freqs); they are broadcast to every class and exposed
        as the free ``params["shared"]`` PyTree.
    ncat / invariant_sites : gamma (+G) and +I compose as usual; rate
        categories scale branch lengths identically in every class.

    Root frequencies are those of the ROOT node's class (class 0 unless
    remapped), matching codeml's convention where equilibrium frequencies
    are shared across classes; supplying per-class ``freqs`` makes the
    process non-stationary and the root-class frequencies act as the root
    prior.
    """

    def __init__(self, tree, alignment, model, branch_classes,
                 class_params: Sequence[Mapping],
                 shared: Optional[Mapping] = None, **kwargs):
        if not model.reversible:
            raise ValueError("branch models require a reversible model")
        if len(class_params) < 1:
            raise ValueError("need at least one branch class")
        super().__init__(tree, alignment, model, **kwargs)
        self.n_classes = len(class_params)
        cls = _normalize_classes(self.tree, branch_classes, self.n_classes)
        self._cls = jnp.asarray(cls)
        self._root_class = int(cls[self.tree.root])
        # free-ratio-style: classes == edges, identity mapping -> pair the
        # class and edge axes instead of materializing the (C, E) cross
        # product (which is quadratic in tree size)
        self._paired = bool(
            self.n_classes == self.tree.n_nodes
            and np.array_equal(cls, np.arange(self.tree.n_nodes))
        )
        class_keys = set(class_params[0].keys())
        unknown = class_keys - set(model.param_defaults)
        if unknown:
            raise ValueError(f"unknown model parameters {sorted(unknown)}")
        self._class_params0 = [dict(d) for d in class_params]
        shared0 = {
            k: v for k, v in model.param_defaults.items()
            if k not in class_keys
        }
        if shared:
            unknown = set(shared) - set(shared0)
            if unknown:
                raise ValueError(
                    f"shared overrides {sorted(unknown)} are per-class "
                    f"parameters or unknown"
                )
            shared0.update(shared)
        self._shared0 = shared0

    # -- parameters -----------------------------------------------------

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": jnp.asarray(self.tree.lengths, self.dtype),
            "shared": {
                k: jnp.asarray(v, self.dtype)
                for k, v in self._shared0.items()
            },
            "classes": _stack_class_params(self._class_params0, self.dtype),
        }
        if self.ncat > 1:
            if self.rate_model == "free":
                params["rates"] = jnp.linspace(
                    0.2, 2.0, self.ncat, dtype=self.dtype
                )
                params["cat_weights"] = jnp.full(
                    (self.ncat,), 1.0 / self.ncat, self.dtype
                )
            else:
                params["alpha"] = jnp.asarray(0.5, self.dtype)
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
                if k in ("shared", "classes"):
                    full[k] = {**full[k], **{
                        kk: jnp.asarray(vv, self.dtype)
                        for kk, vv in v.items()
                    }}
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full

    # -- mixture hook -----------------------------------------------------

    def _mixture_tensors(self, params, dtype, eig=None):
        rates, cat_weights = rate_categories(self, params, dtype)
        t = params["branch_lengths"].astype(dtype)
        ts = t[:, None] * rates[None, :]                     # (E, K)
        c = self.n_classes
        stacked = {
            k: jnp.broadcast_to(
                jnp.asarray(v, dtype)[None, ...],
                (c,) + jnp.shape(jnp.asarray(v)),
            )
            for k, v in params["shared"].items()
        }
        stacked.update({
            k: v.astype(dtype) for k, v in params["classes"].items()
        })
        sym_c, freqs_c = jax.vmap(
            lambda cp: self.model.build(**cp)
        )(stacked)                                           # (C,S,S), (C,S)
        if self._paired:
            # free-ratio: class i IS edge i — pair the axes
            p = jax.vmap(p_matrices_reversible)(
                sym_c, freqs_c, ts
            )                                                # (E, K, S, S)
        else:
            p_c = jax.vmap(
                lambda s, f: p_matrices_reversible(s, f, ts)
            )(sym_c, freqs_c)                                # (C, E, K, S, S)
            p = p_c[self._cls, jnp.arange(ts.shape[0])]      # (E, K, S, S)
        p = extend_p_identity(p, self.schedule.n_nodes)
        freqs = freqs_c[self._root_class]
        return rates, cat_weights, p, freqs


# ---------------------------------------------------------------------------
# Branch-site Model A
# ---------------------------------------------------------------------------


class BranchSiteAEngine(LikelihoodEngine):
    """Branch-site Model A (Yang & Nielsen 2002; Zhang et al. 2005).

    Codon sites fall into four classes that differ between FOREGROUND
    (class-1) and BACKGROUND (class-0) edges:

    ========  ==========  ==========  ================================
    class     background  foreground  weight
    ========  ==========  ==========  ================================
    0         omega0      omega0      p0
    1         1           1           p1
    2a        omega0      omega2      (1-p0-p1) * p0/(p0+p1)
    2b        1           omega2      (1-p0-p1) * p1/(p0+p1)
    ========  ==========  ==========  ================================

    with 0 < omega0 < 1 <= omega2. Free parameters: ``proportions``
    (p0, p1, p2 simplex), ``omega0`` (unit interval), ``omega2_delta``
    (omega2 = 1 + delta, softplus-positive under ``fit``), ``shared``
    (kappa, codon frequencies), branch lengths. The null model of the
    branch-site positive-selection test fixes omega2 = 1
    (``free`` without ``omega2_delta`` and ``omega2_delta = 0``);
    ``branch_site_test`` runs both fits and the df=1 LRT.
    """

    def __init__(self, tree, alignment, foreground, model=None, **kwargs):
        if model is None:
            from phylo_utils_tpu.models import GY94 as model
        if not model.reversible:
            raise ValueError("branch-site models require a reversible model")
        if "omega" not in model.param_defaults:
            raise ValueError("branch-site Model A needs an 'omega' parameter")
        kwargs.pop("ncat", None)
        super().__init__(tree, alignment, model, ncat=4, **kwargs)
        cls = np.asarray(foreground, np.int32) if not isinstance(
            foreground, Mapping
        ) else _classes_from_mapping(self.tree, foreground)
        self._cls = jnp.asarray(_normalize_classes(self.tree, cls, 2))
        self._shared0 = {
            k: v for k, v in model.param_defaults.items() if k != "omega"
        }

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": jnp.asarray(self.tree.lengths, self.dtype),
            "shared": {
                k: jnp.asarray(v, self.dtype)
                for k, v in self._shared0.items()
            },
            "proportions": jnp.asarray([0.7, 0.2, 0.1], self.dtype),
            "omega0": jnp.asarray(0.2, self.dtype),
            "omega2_delta": jnp.asarray(1.0, self.dtype),
        }
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

    # site-class omega table: rows = the 4 site classes, cols = edge class
    # (0 background, 1 foreground), entries index into (omega0, 1, omega2)
    _OMEGA_IDX = np.array([[0, 0], [1, 1], [0, 2], [1, 2]], np.int32)

    def _mixture_tensors(self, params, dtype, eig=None):
        t = params["branch_lengths"].astype(dtype)           # (E,)
        n_edges = t.shape[0]
        om0 = jnp.clip(
            jnp.asarray(params["omega0"], dtype), 1e-8, 1.0 - 1e-8
        )
        om2 = 1.0 + jnp.asarray(params["omega2_delta"], dtype)
        omegas = jnp.stack([om0, jnp.ones((), dtype), om2])  # (3,)
        c = omegas.shape[0]
        stacked = {
            k: jnp.broadcast_to(
                jnp.asarray(v, dtype)[None, ...],
                (c,) + jnp.shape(jnp.asarray(v)),
            )
            for k, v in params["shared"].items()
        }
        stacked["omega"] = omegas
        sym_u, freqs_u = jax.vmap(
            lambda cp: self.model.build(**cp)
        )(stacked)                                           # (3,S,S), (3,S)
        p_u = jax.vmap(
            lambda s, f: p_matrices_reversible(s, f, t)
        )(sym_u, freqs_u)                                    # (3, E, S, S)
        midx = jnp.asarray(self._OMEGA_IDX)[:, self._cls]    # (4, E)
        p = p_u[midx, jnp.arange(n_edges)[None, :]]          # (4, E, S, S)
        p = jnp.swapaxes(p, 0, 1)                            # (E, 4, S, S)
        p = extend_p_identity(p, self.schedule.n_nodes)

        prop = params["proportions"].astype(dtype)
        prop = prop / jnp.sum(prop)
        p0, p1, p2 = prop[0], prop[1], prop[2]
        denom = jnp.maximum(p0 + p1, 1e-30)
        cat_weights = jnp.stack([
            p0, p1, p2 * p0 / denom, p2 * p1 / denom,
        ])
        rates = jnp.ones((4,), dtype)
        return rates, cat_weights, p, freqs_u[0]


def branch_site_test(tree, alignment, foreground, model=None,
                     params0: Optional[Mapping] = None,
                     engine_kwargs: Optional[Mapping] = None,
                     **fit_kwargs) -> Dict:
    """Branch-site positive-selection LRT: Model A vs. Model A with
    omega2 = 1 (the Zhang et al. 2005 recommended null), df = 1.

    Note codeml's convention: the null distribution is conservatively
    taken as chi2(1) here; the exact asymptotic null is a 50:50 mixture
    of chi2(0) and chi2(1), so halving the returned p-value is also
    defensible. Returns alt/null engines, fits, and the LRT dict.
    """
    from phylo_utils_tpu.model_selection import likelihood_ratio_test
    from phylo_utils_tpu.optimize import fit

    engine_kwargs = dict(engine_kwargs or {})
    alt = BranchSiteAEngine(tree, alignment, foreground, model=model,
                            **engine_kwargs)
    null = BranchSiteAEngine(tree, alignment, foreground, model=model,
                             **engine_kwargs)
    alt_fit = fit(alt, params0=params0, **fit_kwargs)
    null0 = dict(params0 or {})
    null0["omega2_delta"] = 0.0
    free = tuple(k for k in null.default_params() if k != "omega2_delta")
    null_fit = fit(null, params0=null0, free=free, **fit_kwargs)
    lrt = likelihood_ratio_test(null_fit.loglik, alt_fit.loglik, df=1)
    return {
        "alt": alt_fit, "null": null_fit, "lrt": lrt,
        "alt_engine": alt, "null_engine": null,
    }


def _branch_site_pair_logliks(engine: "BranchSiteAEngine", full, pairs,
                              chunk: int = 32):
    """Sitewise LOG-likelihoods for (omega_background, omega_foreground)
    pairs: (n_pairs, n_patterns). Each chunk of pairs rides the pruning
    pass's category axis in ONE dispatch; kappa/codon frequencies and
    branch lengths stay at ``full``'s values (the MLEs, codeml's BEB
    convention)."""
    dtype = engine.dtype

    def compute(full, leaf_partials, om_pairs):
        t = full["branch_lengths"].astype(dtype)
        k = om_pairs.shape[0]
        # build one model per pair-slot omega (background and foreground
        # builds share kappa/freqs)
        stacked = {
            kk: jnp.broadcast_to(
                jnp.asarray(vv, dtype)[None, ...],
                (2 * k,) + jnp.shape(jnp.asarray(vv)),
            )
            for kk, vv in full["shared"].items()
        }
        stacked["omega"] = om_pairs.T.reshape(-1).astype(dtype)  # back*k+fore*k
        sym_u, freqs_u = jax.vmap(
            lambda cp: engine.model.build(**cp)
        )(stacked)
        p_u = jax.vmap(
            lambda sy, f: p_matrices_reversible(sy, f, t)
        )(sym_u, freqs_u)                               # (2k, E, S, S)
        n_edges = t.shape[0]
        # per-category per-edge selection: background rows are u-slots
        # [0, k), foreground rows [k, 2k)
        cat_idx = jnp.arange(k)
        midx = jnp.where(
            engine._cls[None, :] == 0,
            cat_idx[:, None],
            cat_idx[:, None] + k,
        )                                                # (k, E)
        p = p_u[midx, jnp.arange(n_edges)[None, :]]      # (k, E, S, S)
        p = jnp.swapaxes(p, 0, 1)                        # (E, k, S, S)
        p = extend_p_identity(p, engine.schedule.n_nodes)
        root_partials, root_logscale = engine._prune(p, leaf_partials)
        lik = jnp.einsum("ksi,i->ks", root_partials,
                         freqs_u[0].astype(dtype),
                         precision=jax.lax.Precision.HIGHEST)
        return jnp.log(lik) + root_logscale

    if not hasattr(engine, "_bs_pair_jit"):
        engine._bs_pair_jit = jax.jit(compute)
    pairs = np.asarray(pairs, np.float64)
    out = []
    for lo in range(0, pairs.shape[0], chunk):
        block = pairs[lo:lo + chunk]
        if block.shape[0] < chunk and lo > 0:
            # pad to the compiled chunk shape; surplus rows discarded
            pad = np.repeat(block[-1:], chunk - block.shape[0], axis=0)
            padded = np.concatenate([block, pad])
            res = engine._bs_pair_jit(full, engine._leaf_partials,
                                      jnp.asarray(padded))
            out.append(np.asarray(res, np.float64)[: block.shape[0]])
        else:
            res = engine._bs_pair_jit(full, engine._leaf_partials,
                                      jnp.asarray(block))
            out.append(np.asarray(res, np.float64))
    return np.concatenate(out, axis=0)


def beb_branch_site(engine: "BranchSiteAEngine",
                    params: Optional[Mapping] = None, d: int = 10):
    """Bayes Empirical Bayes site scan for branch-site Model A.

    Yang, Wong & Nielsen (2005) applied to Model A exactly as codeml
    does for its site classes: integrate the per-site class posteriors
    over a uniform prior grid on (p0, p1, omega0, omega2) — omega0 at
    ``d`` midpoints of (0,1), omega2 at ``d`` midpoints of (1,11), and
    (p0, p1) at the d x d square midpoints folded onto the 2-simplex —
    weighting each grid point by its posterior given the data. Branch
    lengths, kappa and codon frequencies stay at their MLEs.

    Returns ``(p_positive, mean_omega_fg)`` per site: the BEB posterior
    probability that the site is under positive selection ON THE
    FOREGROUND branches (classes 2a + 2b), and the BEB posterior mean
    foreground omega.
    """
    if not isinstance(engine, BranchSiteAEngine):
        raise TypeError("beb_branch_site is implemented for "
                        "BranchSiteAEngine")
    full = engine._full_params(params)
    w0 = (np.arange(d) + 0.5) / d                     # omega0 grid
    w2 = 1.0 + (np.arange(d) + 0.5) * (10.0 / d)      # omega2 grid

    # class sitewise log-liks over the grid:
    #   class 0  at (w0_i, w0_i)      -> d pairs
    #   class 1  at (1, 1)            -> 1 pair
    #   class 2a at (w0_i, w2_j)      -> d*d pairs
    #   class 2b at (1, w2_j)         -> d pairs
    pairs = (
        [(a, a) for a in w0]
        + [(1.0, 1.0)]
        + [(a, b) for a in w0 for b in w2]
        + [(1.0, b) for b in w2]
    )
    logf = _branch_site_pair_logliks(engine, full, pairs)
    n_pat = engine._compressed.n_patterns
    logf = logf[:, :n_pat]
    weights = np.asarray(engine._weights, np.float64)[:n_pat]
    m = logf.max(axis=0)
    f = np.exp(logf - m[None, :])
    f0 = f[:d]                                        # (d, P)
    f1 = f[d]                                         # (P,)
    f2a = f[d + 1: d + 1 + d * d].reshape(d, d, -1)   # (d, d, P)
    f2b = f[d + 1 + d * d:]                           # (d, P)

    # folded 2-simplex midpoints for (p0, p1)
    g0, g1 = np.meshgrid((np.arange(d) + 0.5) / d,
                         (np.arange(d) + 0.5) / d, indexing="ij")
    p0g, p1g = g0.ravel().copy(), g1.ravel().copy()
    over = p0g + p1g > 1.0
    p0g[over], p1g[over] = 1.0 - p0g[over], 1.0 - p1g[over]
    p2g = 1.0 - p0g - p1g
    denom = np.maximum(p0g + p1g, 1e-30)
    w2a = p2g * p0g / denom
    w2b = p2g * p1g / denom

    log_post = np.empty((d, d, p0g.shape[0]))
    for i in range(d):
        for j in range(d):
            lik = (p0g[:, None] * f0[i][None, :]
                   + p1g[:, None] * f1[None, :]
                   + w2a[:, None] * f2a[i, j][None, :]
                   + w2b[:, None] * f2b[j][None, :])
            log_post[i, j] = (weights[None, :] * np.log(lik)).sum(axis=1)
    lp = log_post - log_post.max()
    post_g = np.exp(lp)
    post_g /= post_g.sum()

    acc_pos = np.zeros(n_pat)
    acc_w = np.zeros(n_pat)
    for i in range(d):
        for j in range(d):
            pg = post_g[i, j]
            if pg.max() < 1e-12:
                continue
            c0 = p0g[:, None] * f0[i][None, :]
            c1 = p1g[:, None] * f1[None, :]
            ca = w2a[:, None] * f2a[i, j][None, :]
            cb = w2b[:, None] * f2b[j][None, :]
            tot = c0 + c1 + ca + cb
            acc_pos += pg @ ((ca + cb) / tot)
            # foreground omega by class: w0_i, 1, w2_j, w2_j
            acc_w += pg @ (
                (w0[i] * c0 + c1 + w2[j] * (ca + cb)) / tot
            )
    s2p = engine._compressed.site_to_pattern
    return acc_pos[s2p], acc_w[s2p]
