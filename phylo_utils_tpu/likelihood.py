"""Top-level likelihood engine: models x mixtures x trees -> logL(params).

Reference parity: phylo_utils/likelihood.py ``RunOnTree``/``LnlModel`` and
``GammaMixture`` (set_tree / update_alpha / update_substitution_model /
get_likelihood / get_sitewise_likelihoods; SURVEY.md §2 [HIGH mechanism]).

Redesign for an accelerator: there is no mutable per-node state. The engine
holds static data (compiled schedule, encoded patterns) and exposes ONE jitted
pure function ``logL(params)`` where params is a PyTree
``{'branch_lengths', 'model', 'alpha'?, 'pinv'?}`` — so every reference
"update_*" method is just calling the same compiled function with different
parameters, and ``jax.grad`` supersedes the reference's hand-coded derivative
kernels (SURVEY.md §3.3). Rate categories are a vmapped tensor axis; sites
shard across a device mesh (see parallel.sharding).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu import io as pio
from phylo_utils_tpu import trees as ptrees
from phylo_utils_tpu.models.base import Model
from phylo_utils_tpu.ops.gamma import discrete_gamma
from phylo_utils_tpu.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
    transition_matrices,
)
from phylo_utils_tpu.ops.pruning import (
    invariant_site_likelihood,
    make_prune_fn,
    mixture_loglik,
)

__all__ = ["LikelihoodEngine"]


def _canonical_dtype(dtype):
    if dtype is not None:
        return jnp.dtype(dtype)
    return jnp.dtype(jnp.result_type(float))  # honors jax_enable_x64


def rate_categories(engine, params, dtype, rates=None):
    """(rates, cat_weights) for the engine's RATE mixture (gamma/FreeRate/
    none). Shared by ``mixture_rates_and_p`` and engines whose P(t) varies
    per edge (branch models) but still carry gamma rate heterogeneity.

    ``rates``: precomputed category rates (host-cached by parameter value,
    see ``LikelihoodEngine.model_rates``) — skips the on-device Newton
    gamma-quantile inversion on the per-eval path. Only valid for the
    equal-weight gamma mixture (FreeRate weights are free parameters).
    """
    ncat = engine.ncat
    if rates is not None and ncat > 1:
        rates = jnp.asarray(rates, dtype)
        return rates, jnp.full((ncat,), 1.0 / ncat, dtype)
    if ncat > 1 and getattr(engine, "rate_model", "gamma") == "free":
        cat_weights = params["cat_weights"].astype(dtype)
        cat_weights = cat_weights / jnp.sum(cat_weights)
        rates = params["rates"].astype(dtype)
        rates = rates / jnp.sum(cat_weights * rates)       # weighted mean 1
    elif ncat > 1:
        # cast alpha UP first: the Newton-inverted quantile follows alpha's
        # dtype, and an f32 discretization error is coherent across every
        # site (it perturbs the same 4 rates) — a real bite out of the 1e-6
        # logL budget when `dtype` is the f64 reduce dtype.
        rates = discrete_gamma(
            jnp.asarray(params["alpha"], dtype), ncat, engine.median
        )
        rates = rates.astype(dtype)
        cat_weights = jnp.full((ncat,), 1.0 / ncat, dtype)
    else:
        rates = jnp.ones((1,), dtype)
        cat_weights = jnp.full((1,), 1.0, dtype)
    return rates, cat_weights


def mixture_rates_and_p(engine, params, dtype, eig=None, rates=None):
    """Shared mixture construction: (rates, cat_weights, p, freqs).

    Single source of truth for the rate-category vector (gamma or FreeRate),
    category weights, and the batched P(t) tensor — consumed by the engine's
    ``_loglik_fn`` and by ancestral.py's posterior passes so a rate-model
    change lands in one place.

    ``eig``: a precomputed ``Eigen`` for the CURRENT model parameters. When
    given, P(t) is reconstructed from it (V e^{lambda t} V^-1 — exactly the
    reference's TransitionMatrix semantics, where the eigendecomposition
    lives with the model and only P(t) is per-branch) instead of
    re-decomposing Q on every evaluation. This is the fast path for
    model-fixed workloads (branch-length optimization, distances, tree
    search, bootstrap): it takes the eigendecomposition off the per-eval
    path. Differentiable in branch lengths (d e^{lambda t}/dt
    needs no eigh JVP); model-parameter gradients must use the eig=None
    path (Daleckii-Krein custom JVP).
    """
    rates, cat_weights = rate_categories(engine, params, dtype, rates=rates)
    t = params["branch_lengths"].astype(dtype)
    ts = t[:, None] * rates[None, :]                       # (n_nodes, K)
    if eig is not None:
        freqs = eig.freqs.astype(dtype)
        # Reconstruct P directly in the engine's COMPUTE dtype: exp(lambda
        # t) stays in `dtype` (f64 under the precision plan — the
        # coherent-error source) while the spectral-mode matmul runs in
        # f32 for f32 engines, so no (edges, K, S, S) f64 reconstruct and
        # downcast sits on the per-eval path.
        p = transition_matrices(eig, ts, out_dtype=engine.dtype)
    elif engine.model.reversible:
        # degeneracy-safe custom-JVP path (ops.pmatrix docstring)
        sym, freqs = engine.model.build_parts(params["model"], dtype=dtype)
        p = p_matrices_reversible(sym, freqs, ts)          # (n_nodes, K, S, S)
    else:
        eig = engine.model.eigen(params["model"], dtype=dtype)
        freqs = eig.freqs
        p = transition_matrices(eig, ts)
    # identity blocks for binarization pseudo-nodes (no-op on binary trees)
    p = extend_p_identity(p, engine.schedule.n_nodes)
    return rates, cat_weights, p, freqs


def validate_param_keys(params, full, where: str,
                        nested: str = None) -> None:
    """Raise on unknown top-level parameter names — and, when ``nested``
    is given, on unknown sub-keys of that nested dict. Shared typo guard
    for every engine's ``_full_params`` (a misspelled key would otherwise
    be stored and silently ignored)."""
    unknown = set(params) - set(full)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)} for {where}; "
            f"available: {sorted(full.keys())}"
        )
    if nested and nested in params:
        sub_unknown = set(params[nested]) - set(full[nested])
        if sub_unknown:
            raise ValueError(
                f"unknown {nested!r} parameter(s) {sorted(sub_unknown)} "
                f"for {where}; available: {sorted(full[nested].keys())}"
            )


class LikelihoodEngine:
    """Compiled likelihood/gradient evaluator for one (topology, model) pair.

    Parameters
    ----------
    tree : Tree or newick str
    alignment : dict name->seq, or CompressedAlignment
    model : Model
    ncat : rate categories (1 = no rate heterogeneity)
    rate_model : "gamma" (discrete gamma, param 'alpha') or "free"
        (FreeRate: per-category rates 'rates' and weights 'cat_weights' are
        free parameters; rates are renormalized so the weighted mean is 1,
        keeping branch lengths in expected substitutions/site)
    invariant_sites : add a +I mixture component (param 'pinv')
    median : use median instead of mean gamma discretization
    dtype : computation dtype (None = f64 under x64, else f32)
    compress : collapse identical columns to weighted patterns
    sharding : optional parallel.SiteSharding to shard patterns over a mesh
    remat : recompute each level's activations in the backward pass instead
        of storing the whole residual chain (less gradient memory, about one
        extra forward pass)
    unroll : unroll the level loop at trace time (False: ``lax.scan`` over
        levels, a smaller program that compiles faster)
    """

    def __init__(
        self,
        tree: Union[ptrees.Tree, str],
        alignment: Union[Mapping[str, str], pio.CompressedAlignment],
        model: Model,
        ncat: int = 1,
        invariant_sites: bool = False,
        median: bool = False,
        dtype=None,
        compress: bool = True,
        sharding=None,
        remat: bool = False,
        rate_model: str = "gamma",
        unroll: bool = True,
    ):
        if isinstance(tree, str):
            tree = pio.parse_newick(tree)
        self.tree = tree
        self.model = model
        self.ncat = int(ncat)
        self.median = bool(median)
        if rate_model not in ("gamma", "free"):
            raise ValueError(f"unknown rate_model {rate_model!r}")
        self.rate_model = rate_model
        self.invariant_sites = bool(invariant_sites)
        self.dtype = _canonical_dtype(dtype)
        self.sharding = sharding

        # Precision plan for the 1e-6 logL budget (SURVEY.md §7 hard part 1):
        # partials stay in `dtype` (f32 for the perf mode) through the
        # pruning kernel — that's where the FLOPs are — but everything
        # small is done in f64 when x64 is live: P(t) construction (eigh,
        # expm; (n_nodes, K, S, S) only), the root reduction, rate-category
        # mixing, and the final sum(w * lnL) over patterns (a 1024-term f32
        # sum at |logL|~1e4 alone costs ~1e-2 absolute). Off-x64 this
        # degrades gracefully to the plain `dtype` path.
        self._reduce_dtype = (
            jnp.dtype("float64")
            if self.dtype == jnp.dtype("float32") and jax.config.x64_enabled
            else self.dtype
        )

        if isinstance(alignment, pio.CompressedAlignment):
            ca = alignment
        elif compress:
            ca = pio.compress_patterns(alignment, model.alphabet, dtype=np.float64)
        else:
            from phylo_utils_tpu.alphabets import encode_alignment

            names, arr = encode_alignment(alignment, model.alphabet)
            ca = pio.CompressedAlignment(
                names=tuple(names),
                partials=arr,
                weights=np.ones(arr.shape[1]),
                site_to_pattern=np.arange(arr.shape[1], dtype=np.int32),
            )
        self._compressed = ca

        missing = set(tree.leaf_names) - set(ca.names)
        if missing:
            raise ValueError(f"alignment is missing taxa {sorted(missing)}")
        if ca.partials.shape[2] != model.n_states:
            raise ValueError(
                f"alignment encodes {ca.partials.shape[2]} states but model "
                f"{model.name!r} has {model.n_states} (wrong alphabet?)"
            )
        order = [ca.names.index(n) for n in tree.leaf_names]
        leaf_partials = ca.partials[order]          # (n_leaves, P, S)
        weights = ca.weights                         # (P,)

        self.schedule = ptrees.compile_schedule(tree)
        # unroll=False compiles a lax.scan over levels: a much smaller
        # program (one level body) — fast compiles for deep trees or
        # compile-latency-sensitive entry points, same math.
        self._prune = make_prune_fn(self.schedule, unroll=unroll, remat=remat)

        if sharding is not None:
            leaf_partials, weights = sharding.pad(leaf_partials, weights)
            self._leaf_partials = sharding.put_leaves(
                leaf_partials.astype(self.dtype)
            )
            self._weights = sharding.put_sites(weights.astype(self.dtype))
        else:
            self._leaf_partials = jnp.asarray(leaf_partials, self.dtype)
            self._weights = jnp.asarray(weights, self.dtype)

        self._jit_fn = jax.jit(self._loglik_fn)
        self._jit_fn_eig = jax.jit(
            lambda p, eig, lp, w: self._loglik_fn(p, lp, w, eig=eig)
        )
        self._jit_fn_eig_rates = jax.jit(
            lambda p, eig, rates, lp, w: self._loglik_fn(
                p, lp, w, eig=eig, rates=rates
            )
        )
        self._jit_grad = jax.jit(jax.grad(lambda p, lp, w: self._loglik_fn(p, lp, w)[0]))
        self._jit_vag = jax.jit(
            jax.value_and_grad(lambda p, lp, w: self._loglik_fn(p, lp, w)[0])
        )
        self._eig_cache_key = None
        self._eig_cache = None
        self._rates_cache_key = None
        self._rates_cache = None

    def model_eigen(self, full_params):
        """Eigen system for ``full_params['model']``, cached on the host by
        parameter VALUE (reference parity: the eigendecomposition lives
        with the model — phylo_utils/markov.py TransitionMatrix — and is
        NOT redone per likelihood evaluation)."""
        rdt = self._reduce_dtype
        if "model" not in full_params:
            # mixture/subclass engines with their own parameterization:
            # no single model eigen to cache
            return None
        key = tuple(
            (k, np.asarray(v).tobytes())
            for k, v in sorted(full_params["model"].items())
        )
        if key != self._eig_cache_key:
            self._eig_cache = self.model.eigen(full_params["model"], dtype=rdt)
            self._eig_cache_key = key
        return self._eig_cache

    def model_rates(self, full_params):
        """Discrete-gamma category rates for ``full_params['alpha']``,
        cached on the host by parameter VALUE (companion to
        ``model_eigen``): the PAML-style quantile inversion is a Newton
        loop of many tiny device ops — real latency on the single-stream
        eval path, pure waste when alpha is frozen (branch-length
        optimization, distances, tree search, bootstrap). Returns None
        when this engine's rates are not a pure function of alpha
        (FreeRate / no rate heterogeneity / subclass mixtures)."""
        if (
            self.ncat <= 1
            or getattr(self, "rate_model", "gamma") != "gamma"
            or "alpha" not in full_params
            # subclasses with their own mixture/likelihood plumbing don't
            # take the precomputed-rates kwarg — only the base engine's
            # unmodified path may use the cache
            or type(self)._mixture_tensors is not LikelihoodEngine._mixture_tensors
            or type(self)._loglik_fn is not LikelihoodEngine._loglik_fn
        ):
            return None
        key = (np.asarray(full_params["alpha"]).tobytes(), self.ncat,
               self.median)
        if key != self._rates_cache_key:
            rdt = self._reduce_dtype
            self._rates_cache = jax.device_get(
                discrete_gamma(
                    jnp.asarray(full_params["alpha"], rdt), self.ncat,
                    self.median,
                )
            )
            self._rates_cache_key = key
        return jnp.asarray(self._rates_cache, self._reduce_dtype)

    # -- parameters ---------------------------------------------------------

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": jnp.asarray(self.tree.lengths, self.dtype),
            "model": self.model.defaults(self.dtype),
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
        full = self.default_params()
        if params:
            for k, v in params.items():
                if k not in full:
                    # typos would otherwise be SILENTLY ignored (the key
                    # is stored but nothing reads it) — e.g. "aplha"
                    raise ValueError(
                        f"unknown parameter {k!r} for this engine; "
                        f"available: {sorted(full.keys())}"
                    )
                if k == "model":
                    unknown = set(v) - set(full["model"])
                    if unknown:
                        raise ValueError(
                            f"unknown model parameter(s) {sorted(unknown)} "
                            f"for {self.model.name}; available: "
                            f"{sorted(full['model'].keys())}"
                        )
                    full["model"] = {**full["model"], **{
                        kk: jnp.asarray(vv, self.dtype) for kk, vv in v.items()
                    }}
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full

    # -- core computation ----------------------------------------------------

    def _mixture_tensors(self, params, dtype, eig=None, rates=None):
        """Hook: (rates, cat_weights, p, freqs) for this engine's mixture.

        ``p`` is the (n_nodes, K, S, S) batch of per-edge-per-category
        transition matrices. Subclasses whose P(t) varies per EDGE as well
        as per category (branch models: per-edge omega classes) override
        only this — pruning, scaling, mixing, gradients, sharding,
        ancestral posteriors all flow through it unchanged. (Overrides may
        omit the ``rates`` precompute hook; the base engine only forwards
        it when set, and only for the plain gamma mixture.)"""
        return mixture_rates_and_p(self, params, dtype, eig=eig, rates=rates)

    def _loglik_fn(self, params, leaf_partials, weights, eig=None,
                   rates=None):
        dtype = self.dtype
        rdt = getattr(self, "_reduce_dtype", dtype)
        # P(t), rates, weights, freqs built in the high-precision dtype;
        # only the pruning pass itself runs in `dtype`.
        kw = {"rates": rates} if rates is not None else {}
        _, cat_weights, p, freqs = self._mixture_tensors(params, rdt,
                                                         eig=eig, **kw)
        pinv = params.get("pinv") if self.invariant_sites else None
        inv = (
            invariant_site_likelihood(leaf_partials.astype(rdt), freqs)
            if self.invariant_sites
            else None
        )
        root_partials, root_logscale = self._prune(
            p.astype(dtype), leaf_partials
        )
        return mixture_loglik(
            root_partials.astype(rdt), root_logscale.astype(rdt), freqs,
            cat_weights, weights.astype(rdt), pinv=pinv, inv_lik=inv,
        )

    # -- public API ----------------------------------------------------------

    def _eval(self, full):
        """(total, sitewise) via the cached-eigen (+ cached gamma rates)
        fast path when available."""
        eig = self.model_eigen(full)
        if eig is None:
            return self._jit_fn(full, self._leaf_partials, self._weights)
        rates = self.model_rates(full)
        if rates is not None:
            return self._jit_fn_eig_rates(
                full, eig, rates, self._leaf_partials, self._weights
            )
        return self._jit_fn_eig(
            full, eig, self._leaf_partials, self._weights
        )

    def loglikelihood(self, params: Optional[Mapping] = None) -> float:
        total, _ = self._eval(self._full_params(params))
        return float(total)

    def sitewise_loglikelihoods(
        self, params: Optional[Mapping] = None, per_pattern: bool = False
    ) -> np.ndarray:
        """Per-site (or per-pattern) log-likelihoods."""
        _, sw = self._eval(self._full_params(params))
        sw = np.asarray(sw)[: self._compressed.n_patterns]
        if per_pattern:
            return sw
        return sw[self._compressed.site_to_pattern]

    def loglikelihood_many(
        self, branch_length_sets, params: Optional[Mapping] = None
    ) -> np.ndarray:
        """logL for MANY branch-length vectors under one fixed model.

        ``branch_length_sets``: (B, n_nodes). All B evaluations run in one
        jitted dispatch (``vmap`` adds a batch axis to every kernel of the
        walk), which amortizes the per-launch overhead. The model
        eigendecomposition is computed once (``model_eigen``). Use for
        branch scans, profile likelihoods, multi-start seeding, and
        search-candidate scoring.
        """
        full = self._full_params(params)
        eig = self.model_eigen(full)
        rates = self.model_rates(full)
        bl = jnp.asarray(branch_length_sets, self.dtype)
        if not hasattr(self, "_jit_many"):
            def many(full, eig, rates, bl, lp, w):
                def one(b):
                    p2 = dict(full)
                    p2["branch_lengths"] = b
                    return self._loglik_fn(p2, lp, w, eig=eig,
                                           rates=rates)[0]

                return jax.vmap(one)(bl)

            self._jit_many = jax.jit(many)
        return np.asarray(
            self._jit_many(
                full, eig, rates, bl, self._leaf_partials, self._weights
            )
        )

    def gradient(self, params: Optional[Mapping] = None) -> Dict:
        return self._jit_grad(
            self._full_params(params), self._leaf_partials, self._weights
        )

    def value_and_grad(self, params: Optional[Mapping] = None):
        return self._jit_vag(
            self._full_params(params), self._leaf_partials, self._weights
        )

    def bootstrap_loglikelihoods(
        self,
        n_replicates: int,
        params: Optional[Mapping] = None,
        seed: int = 0,
    ) -> np.ndarray:
        """Nonparametric-bootstrap logL for ``n_replicates`` resamples.

        Sites are resampled with replacement, which on a pattern-compressed
        engine only changes the *pattern weights* — the pruning pass and
        sitewise vector are computed ONCE; each replicate is a weighted sum.
        (The reference would rerun its whole C pruning loop per replicate.)
        Resampling respects the original per-pattern multiplicities.
        """
        _, sw = self._eval(self._full_params(params))
        n_pat = self._compressed.n_patterns
        sw = np.asarray(sw, np.float64)[:n_pat]
        w = np.asarray(self._compressed.weights, np.float64)[:n_pat]
        n_sites = int(w.sum())
        rng = np.random.default_rng(seed)
        boot_w = rng.multinomial(n_sites, w / n_sites, size=n_replicates)
        return boot_w @ sw      # numpy, float64: no device precision mode


class GammaMixture:
    """Stateful facade mirroring the reference's ``GammaMixture`` API
    (phylo_utils/likelihood.py: set_tree / update_alpha /
    update_substitution_model / get_likelihood / get_sitewise_likelihoods;
    SURVEY.md §2 [HIGH]).

    Under the hood every "update" just edits a parameter PyTree; the compiled
    pure function is re-invoked with new values — recompilation happens only
    on ``set_tree`` (topology/shape change), never on parameter updates.
    """

    def __init__(self, alpha: float, ncat: int, model: Model,
                 invariant_sites: bool = False, pinv: float = 0.2,
                 dtype=None):
        self.model = model
        self.ncat = int(ncat)
        self.invariant_sites = bool(invariant_sites)
        self._dtype = dtype
        self._engine: Optional[LikelihoodEngine] = None
        self._alignment = None
        self._params: Dict = {"alpha": alpha}
        if invariant_sites:
            self._params["pinv"] = pinv

    # -- wiring --------------------------------------------------------------

    def set_alignment(self, alignment) -> "GammaMixture":
        self._alignment = alignment
        if self._engine is not None:
            self.set_tree(self._engine.tree)
        return self

    def set_tree(self, tree) -> "GammaMixture":
        if self._alignment is None:
            raise ValueError("call set_alignment() before set_tree()")
        self._engine = LikelihoodEngine(
            tree, self._alignment, self.model, ncat=self.ncat,
            invariant_sites=self.invariant_sites, dtype=self._dtype,
        )
        self._params.pop("branch_lengths", None)
        return self

    def _require_engine(self) -> LikelihoodEngine:
        if self._engine is None:
            raise ValueError("call set_alignment() and set_tree() first")
        return self._engine

    # -- updates (reference method names) ------------------------------------

    def update_alpha(self, alpha: float) -> None:
        self._params["alpha"] = alpha

    def update_substitution_model(self, model: Model = None, **params) -> None:
        if model is not None and model is not self.model:
            self.model = model
            # parameters of the previous model are meaningless (and often
            # invalid kwargs) for the new one
            self._params.pop("model", None)
            if self._engine is not None:
                self.set_tree(self._engine.tree)
        if params:
            merged = dict(self._params.get("model", {}))
            merged.update(params)
            self._params["model"] = merged

    def update_branch_lengths(self, lengths) -> None:
        self._params["branch_lengths"] = np.asarray(lengths, dtype=np.float64)

    def update_pinv(self, pinv: float) -> None:
        self._params["pinv"] = pinv

    # -- queries --------------------------------------------------------------

    def get_likelihood(self) -> float:
        return self._require_engine().loglikelihood(self._params)

    def get_sitewise_likelihoods(self) -> np.ndarray:
        return self._require_engine().sitewise_loglikelihoods(self._params)

    def get_gradient(self) -> Dict:
        return self._require_engine().gradient(self._params)

    def optimise(self, **kwargs):
        """Joint ML fit of all free parameters (jax.grad + L-BFGS); updates
        this object's parameters in place and returns the FitResult."""
        from phylo_utils_tpu.optimize import fit

        res = fit(self._require_engine(), self._params, **kwargs)
        self._params = {
            k: v for k, v in res.params.items()
        }
        return res
