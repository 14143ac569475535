"""Branch-length and model-parameter optimization with exact JAX gradients.

Reference parity: phylo_utils/optimisation.py (Brent/golden 1-D safeguards)
and the Newton-Raphson single-branch optimizer on analytic lnL/dlnL/d2lnL
(``OptWrapper``; SURVEY.md §2/§3.3 [MED names, HIGH mechanism]).

Redesign for an accelerator: the reference hand-codes sitewise derivative kernels for
ONE branch at a time. Here ``jax.grad`` differentiates the whole pruning pass,
so ALL branch lengths and model parameters are optimized jointly by a single
jitted update step (optax), which is strictly more capable (BASELINE.json
config 5). The reference's per-branch Newton is kept as
``newton_branch_length`` — same mechanism (dP = Q P, d2P = Q^2 P; clamped
Newton with a bisection-style safeguard) but expressed as batched jnp and
usable under jit/vmap. ``brent_minimize`` / ``golden_section`` cover 1-D
parameters without trusted curvature, as lax.while_loop ports of the classic
algorithms (not copies of the reference's code).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax

from phylo_utils_tpu.models.base import Eigen
from phylo_utils_tpu.ops.pmatrix import (
    d2p_matrices,
    dp_matrices,
    transition_matrices,
)

__all__ = [
    "transform_params",
    "untransform_params",
    "fit",
    "fit_multistart",
    "FitResult",
    "standard_errors",
    "fisher_covariance",
    "newton_branch_length",
    "ml_distance_matrix",
    "brent_minimize",
    "golden_section",
    "parametric_bootstrap",
]

_HI = lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Reparameterization: constrained model space <-> unconstrained optimizer space
# ---------------------------------------------------------------------------

_SIMPLEX_KEYS = {"freqs", "cat_weights", "proportions",
                 "nuc_freqs"}          # softmax rows (sum to 1)
_UNIT_KEYS = {"pinv", "p0", "omega0", "height_fractions"}  # sigmoid (0, 1)
# everything else positive-valued: softplus-parameterized


def _softplus(x):
    return jax.nn.softplus(x)


def _inv_softplus(y):
    y = jnp.asarray(y)
    # log(expm1(y)), stable for large y
    return jnp.where(y > 20.0, y, jnp.log(jnp.expm1(jnp.clip(y, 1e-10, None))))


def _leaf_transform(key: str, value, inverse: bool):
    if key in _SIMPLEX_KEYS:
        if inverse:
            logits = jnp.log(jnp.clip(value, 1e-12, None))
            return logits - logits.mean()
        return jax.nn.softmax(value)
    if key in _UNIT_KEYS:
        if inverse:
            v = jnp.clip(value, 1e-8, 1.0 - 1e-8)
            return jnp.log(v) - jnp.log1p(-v)
        return jax.nn.sigmoid(value)
    return _inv_softplus(value) if inverse else _softplus(value)


def _map_params(params: Mapping, inverse: bool) -> Dict:
    out: Dict = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = _map_params(v, inverse)
        else:
            out[k] = _leaf_transform(k, v, inverse)
    return out


def untransform_params(raw: Mapping) -> Dict:
    """Unconstrained optimizer PyTree -> constrained model parameters."""
    return _map_params(raw, inverse=False)


def transform_params(params: Mapping) -> Dict:
    """Constrained model parameters -> unconstrained optimizer PyTree."""
    return _map_params(params, inverse=True)


# ---------------------------------------------------------------------------
# Joint gradient-based fit
# ---------------------------------------------------------------------------


def _split_free(base: Mapping, free) -> tuple:
    """Split params into (frozen, start) by the ``free`` name list.

    Plain names claim a whole top-level entry; dotted names
    ('shared.kappa') claim one entry of a nested dict, leaving its
    siblings frozen. Unknown names raise (catches typos that would
    otherwise silently freeze a parameter)."""
    top = set()
    nested: Dict = {}
    for name in free:
        if "." in name:
            head, rest = name.split(".", 1)
            nested.setdefault(head, []).append(rest)
        else:
            top.add(name)
    unknown = (top | set(nested)) - set(base.keys())
    if unknown:
        raise ValueError(
            f"unknown free parameter(s) {sorted(unknown)}; "
            f"available: {sorted(base.keys())}"
        )
    both = top & set(nested)
    if both:
        raise ValueError(
            f"{sorted(both)} listed both whole ('k') and nested ('k.sub')"
        )
    frozen: Dict = {}
    start: Dict = {}
    for k, v in base.items():
        if k in top:
            start[k] = v
        elif k in nested:
            if not isinstance(v, Mapping):
                raise ValueError(f"'{k}' is not a nested dict; use '{k}'")
            sub_frozen, sub_start = _split_free(v, nested[k])
            if sub_frozen:
                frozen[k] = sub_frozen
            if sub_start:
                start[k] = sub_start
        else:
            frozen[k] = v
    return frozen, start


def _merge_params(frozen: Mapping, opt: Mapping) -> Dict:
    """Recombine frozen and optimized params (recursive dict merge)."""
    out = dict(frozen)
    for k, v in opt.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _merge_params(out[k], v)
        else:
            out[k] = v
    return out


class FitResult(NamedTuple):
    params: Dict                 # constrained, best seen
    loglik: float                # best logL
    trace: np.ndarray            # logL per step
    n_steps: int
    converged: bool


def fit(
    engine,
    params0: Optional[Mapping] = None,
    free: Optional[Tuple[str, ...]] = None,
    optimizer: Optional[optax.GradientTransformation] = None,
    max_steps: int = 500,
    tol: float = 1e-8,
    patience: int = 20,
    callback: Optional[Callable[[int, float, Dict], None]] = None,
    steps_per_call: int = 1,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
) -> FitResult:
    """Maximize logL over branch lengths and model parameters jointly.

    Parameters
    ----------
    engine : LikelihoodEngine
    params0 : starting constrained parameters (default engine defaults)
    free : parameter names to optimize (default: all).  Names address the
        top level of the params dict ('branch_lengths', 'model', 'alpha',
        'pinv'); dotted names address nested entries ('shared.kappa',
        'model.freqs') so sibling parameters stay frozen — e.g. codeml's
        standard setup of optimizing kappa with codon frequencies FIXED at
        their empirical (F3x4) estimates is ``free=(...,'shared.kappa')``.
        Non-free parameters are held at their starting value; unknown
        names raise.
    optimizer : optax transform; default L-BFGS with zoom linesearch
        (fast, step-size-free convergence on this smooth small-parameter
        problem; pass e.g. ``optax.adam(1e-2)`` for a stochastic-style fit)
    tol : stop when the best logL improves by < tol over `patience` steps
    steps_per_call : optimizer steps fused into one device dispatch via
        ``lax.scan`` (host sees the per-step logL trace afterwards). Raise
        this (e.g. 10-50) when per-dispatch latency dominates — each
        dispatch then advances many steps; early stopping happens at chunk
        granularity.
    checkpoint_path / checkpoint_every : when both set, the FULL optimizer
        state ``{raw, opt_state}`` (unconstrained space) plus the step
        counter is written atomically every ``checkpoint_every`` steps
        (chunk granularity in chunked mode) — a killed run restarted with
        ``resume_from=checkpoint_path`` replays the remaining steps
        bit-exactly (pure-functional state; SURVEY.md §5 checkpoint row).
    resume_from : checkpoint path to restore (raw, opt_state, step) from
        before stepping. ``max_steps`` still bounds the TOTAL step count
        including the restored steps.
    """
    base = engine._full_params(params0)
    if free is None:
        free = tuple(base.keys())
    frozen, start = _split_free(base, free)
    free_tops = {k.split(".", 1)[0] for k in free}

    # model parameters frozen -> the eigendecomposition is a constant of
    # the whole fit: use the engine's cached-eigen fast path (no eigh on
    # the per-evaluation path)
    eig = None
    if "model" not in free_tops and hasattr(engine, "model_eigen"):
        eig = engine.model_eigen(base)
    # alpha frozen too -> gamma rates are a constant of the fit: skip the
    # per-step on-device quantile inversion (host-cached like the eigen)
    rates = None
    if "alpha" not in free_tops and hasattr(engine, "model_rates"):
        rates = engine.model_rates(base)

    # Data arrays are threaded through the jitted steps as ARGUMENTS, not
    # closure constants: globally-sharded (multi-host) leaf partials span
    # non-addressable devices and may not be closed over; passing them also
    # keeps one compiled step program valid across weight-resampled data
    # (bootstrap) of the same shape.
    data_lp, data_w = engine._leaf_partials, engine._weights

    # The unconstrained optimizer vector always lives in the session's
    # widest float: an f32 ENGINE otherwise seeds f32 optax state whose
    # linesearch lax.cond then clashes with the (f64) fresh loss under
    # x64, and optimizer arithmetic benefits from f64 anyway — the engine
    # casts params to its compute dtype internally.
    _opt_dtype = jnp.result_type(float)
    raw0 = jax.tree.map(
        lambda x: x.astype(_opt_dtype), transform_params(start)
    )

    # step/chunk programs are CACHED on the engine, keyed by the optimizer
    # and chunk size: tracing an L-BFGS-linesearch chunk through the
    # pruning pass costs tens of host seconds at 3-digit taxon counts, and
    # repeated-fit workflows (bootstrap, multistart, Goldman-Cox, the
    # server) would otherwise pay it per fit() call. Everything that
    # varies between calls — frozen params, cached eigen/rates, data —
    # is a jit ARGUMENT, never a closure constant, so a cached program is
    # valid for any call with the same pytree structures (jax.jit itself
    # retraces on structure changes).
    programs = engine.__dict__.setdefault("_fit_programs", {})
    prog_key = (
        "lbfgs-default" if optimizer is None else id(optimizer),
        steps_per_call,
    )
    if prog_key in programs:
        optimizer, step, chunk = programs[prog_key]
    else:
        default_lbfgs = optimizer is None
        if default_lbfgs:
            optimizer = optax.lbfgs()

        def make_loss(lp, w, frozen, eig, rates):
            def loss_fn(raw):
                params = _merge_params(frozen, untransform_params(raw))
                kw = {}
                if eig is not None:
                    kw["eig"] = eig
                if rates is not None:
                    kw["rates"] = rates
                if kw:
                    total, _ = engine._loglik_fn(params, lp, w, **kw)
                else:
                    total, _ = engine._loglik_fn(params, lp, w)
                # fixed loss dtype: an f32 engine under x64 otherwise feeds
                # an f32 value into optax's f64 linesearch state (lax.cond
                # branch dtype mismatch inside value_and_grad_from_state)
                return -total.astype(jnp.result_type(float))
            return loss_fn

        if default_lbfgs:
            opt = optimizer

            @jax.jit
            def step(raw, opt_state, lp, w, frozen, eig, rates):
                loss_fn = make_loss(lp, w, frozen, eig, rates)
                vag = optax.value_and_grad_from_state(loss_fn)
                loss, grads = vag(raw, state=opt_state)
                updates, opt_state = opt.update(
                    grads, opt_state, raw, value=loss, grad=grads,
                    value_fn=loss_fn,
                )
                raw = optax.apply_updates(raw, updates)
                return raw, opt_state, loss

        else:
            opt = optimizer

            @jax.jit
            def step(raw, opt_state, lp, w, frozen, eig, rates):
                loss, grads = jax.value_and_grad(
                    make_loss(lp, w, frozen, eig, rates)
                )(raw)
                updates, opt_state = opt.update(grads, opt_state, raw)
                raw = optax.apply_updates(raw, updates)
                return raw, opt_state, loss

        chunk = None
        if steps_per_call > 1:
            inner = step

            @jax.jit
            def chunk(raw, opt_state, lp, w, frozen, eig, rates):
                def body(carry, _):
                    raw, opt_state = carry
                    raw, opt_state, loss = inner(
                        raw, opt_state, lp, w, frozen, eig, rates
                    )
                    return (raw, opt_state), loss

                (raw, opt_state), losses = lax.scan(
                    body, (raw, opt_state), None, length=steps_per_call
                )
                # one extra forward so the END-of-chunk raw has a known loss
                return (raw, opt_state, losses,
                        make_loss(lp, w, frozen, eig, rates)(raw))

        programs[prog_key] = (optimizer, step, chunk)

    opt_state = optimizer.init(raw0)

    # Bookkeeping invariant: step() returns the loss of the raw it was
    # GIVEN, so each recorded (ll, raw) pair must use the pre-step raw.
    # In chunked mode only the chunk-start and chunk-end evaluations have
    # a retained raw. Two separate trackers: `best_trace` (any step value;
    # drives patience/convergence) and `best_ret` (best RETAINED
    # candidate; drives the returned params) — letting unretained values
    # raise a single shared `best` used to ratchet best_raw would block
    # the chunk-end candidates forever (chunked fits then returned their
    # STARTING params).
    raw = raw0
    n = 0
    if resume_from:
        from phylo_utils_tpu.utils.checkpoint import load_checkpoint

        state, n, _ = load_checkpoint(
            resume_from, {"raw": raw0, "opt_state": opt_state}
        )
        raw, opt_state = state["raw"], state["opt_state"]
    # Signature canonicalization: optimizer.init() yields WEAK-typed
    # scalar leaves (python-float sentinels such as the zoom linesearch's
    # inf) whose avals differ from the post-update state. Left alone, the
    # SECOND device call of the loop below retraces step/chunk under the
    # strong-typed state and recompiles the whole program MID-FIT.
    # Cast every init leaf to the dtype the first update returns, so one
    # compiled program serves every call. The dtype tree is derived by
    # eval_shape (trace only, no compile) once per cached program.
    # key includes the RAW pytree structure: the same engine is fit with
    # different `free` sets (e.g. weights-only then weights+profiles) and
    # their opt states have different shapes (r4 bug: a structure-blind
    # cache fed the first fit's dtype tree to the second and crashed)
    st_key = ("st_dtypes",) + prog_key + (jax.tree.structure(raw0),)
    st_dtypes = programs.get(st_key)
    if st_dtypes is None:
        out_shapes = jax.eval_shape(
            step, raw0, opt_state, data_lp, data_w, frozen, eig, rates
        )
        st_dtypes = jax.tree.map(lambda s: s.dtype, out_shapes[1])
        programs[st_key] = st_dtypes
    opt_state = jax.tree.map(
        lambda x, d: jnp.asarray(x, dtype=d), opt_state, st_dtypes
    )
    trace = []
    best_trace = -np.inf
    best_ret = -np.inf
    best_raw = raw
    since_best = 0
    last_ckpt = n

    def _maybe_checkpoint(raw, opt_state, n):
        nonlocal last_ckpt
        if (
            checkpoint_path
            and checkpoint_every
            and n - last_ckpt >= checkpoint_every
        ):
            from phylo_utils_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_path, {"raw": raw, "opt_state": opt_state}, step=n
            )
            last_ckpt = n

    while n < max_steps:
        if steps_per_call > 1:
            raw_start = raw
            raw, opt_state, losses, end_loss = chunk(
                raw, opt_state, data_lp, data_w, frozen, eig, rates
            )
            lls = [-float(x) for x in np.asarray(losses)]
            retained = [(lls[0], raw_start), (-float(end_loss), raw)]
        else:
            raw_start = raw
            raw, opt_state, loss = step(
                raw, opt_state, data_lp, data_w, frozen, eig, rates
            )
            lls = [-float(loss)]
            retained = [(lls[0], raw_start)]
        for ll in lls:
            n += 1
            trace.append(ll)
            if callback is not None:
                callback(n, ll, untransform_params(raw))
            if ll > best_trace + tol:
                best_trace, since_best = ll, 0
            else:
                since_best += 1
        for ll, r in retained:
            if ll > best_ret:
                best_ret, best_raw = ll, r
        _maybe_checkpoint(raw, opt_state, n)
        if since_best >= patience:
            break
    # The current raw's loss was never evaluated in unchunked mode; give it
    # a chance to be the returned optimum. Evaluate through the engine's
    # cached jitted logL (one compiled program for the whole fit) instead of
    # jitting loss_fn anew — per-topology compiles are tens of seconds on
    # this platform's remote compiler.
    if steps_per_call == 1:
        cand = _merge_params(frozen, untransform_params(raw))
        final_candidate_ll = engine.loglikelihood(cand)
        if final_candidate_ll > best_ret:
            best_ret, best_raw = final_candidate_ll, raw
    converged = since_best >= patience
    params = _merge_params(frozen, untransform_params(best_raw))
    # Report the logL OF THE RETURNED PARAMS (re-evaluated), never a value
    # from a different parameter vector.
    final_ll = engine.loglikelihood(params)
    return FitResult(
        params=params,
        loglik=float(final_ll),
        trace=np.asarray(trace),
        n_steps=n,
        converged=converged,
    )


# ---------------------------------------------------------------------------
# Reference-style single-branch Newton (analytic derivatives)
# ---------------------------------------------------------------------------


def _branch_lnl_derivs(
    eig: Eigen,
    partials_a: jnp.ndarray,   # (sites, S) — partials at one end
    partials_b: jnp.ndarray,   # (sites, S) — partials at the other end
    weights: jnp.ndarray,      # (sites,)
    t: jnp.ndarray,
):
    """(lnL, dlnL/dt, d2lnL/dt2) for the likelihood across a single branch:
    L_s = sum_ij pi_i a_si P_ij(t) b_sj  (reference kernel (d), SURVEY §2)."""
    p = transition_matrices(eig, t)
    dp = dp_matrices(eig, t)
    d2p = d2p_matrices(eig, t)
    wa = partials_a * eig.freqs[None, :].astype(partials_a.dtype)

    def site_dot(mat):
        return jnp.einsum("si,ij,sj->s", wa, mat, partials_b, precision=_HI)

    f = site_dot(p)
    f1 = site_dot(dp)
    f2 = site_dot(d2p)
    f = jnp.maximum(f, jnp.finfo(f.dtype).tiny)
    lnl = jnp.sum(weights * jnp.log(f))
    d1 = f1 / f
    d2 = f2 / f - d1 * d1
    return lnl, jnp.sum(weights * d1), jnp.sum(weights * d2)


def fit_multistart(
    engine,
    params0: Optional[Mapping] = None,
    n_starts: int = 4,
    perturb: float = 0.5,
    seed: int = 0,
    free: Optional[Tuple[str, ...]] = None,
    **fit_kwargs,
) -> FitResult:
    """Multi-start ML fit: run ``fit`` from the given/default start plus
    ``n_starts - 1`` randomized starts (Gaussian noise of scale
    ``perturb`` in the unconstrained space, so positivity/simplex
    constraints hold automatically) and return the best FitResult.
    Guards against local optima in mixture weights / rate parameters;
    branch-length surfaces for a fixed topology are usually unimodal.

    Only the FREE parameters are perturbed: with ``free`` given, frozen
    parameters stay exactly at their ``params0`` values in every start
    (otherwise the 'frozen' values would be randomized too and the
    best-of-N comparison would span different constrained problems).
    """
    base = engine._full_params(params0)
    if free is None:
        free_names = tuple(base.keys())
    else:
        free_names = tuple(free)
    frozen, start_free = _split_free(base, free_names)
    rng = np.random.default_rng(seed)
    best: Optional[FitResult] = None
    for i in range(n_starts):
        if i == 0:
            start = base
        else:
            raw = transform_params(start_free)
            noisy = jax.tree.map(
                lambda x: np.asarray(x, np.float64)
                + rng.normal(0.0, perturb, np.shape(x)),
                raw,
            )
            start = _merge_params(frozen, untransform_params(noisy))
        res = fit(engine, start, free=free, **fit_kwargs)
        if best is None or res.loglik > best.loglik:
            best = res
    return best


def _hessian_fd_of_gradient(negll, point, leaves, treedef, sizes,
                            rel_h: Optional[float] = None):
    """Observed information by central differences of the exact gradient:
    H[:, i] ~= (grad(x + h e_i) - grad(x - h e_i)) / 2h. Accurate to
    O(h^2) with exact scores; used only where jax.hessian cannot
    differentiate twice (see caller). The default step is eps^(1/3) of
    the session compute dtype (~6e-6 in f64, ~5e-3 in f32 — an f32 run
    needs the much larger step or gradient roundoff swamps the
    difference)."""
    if rel_h is None:
        rel_h = float(
            np.finfo(np.dtype(jnp.result_type(float))).eps ** (1.0 / 3.0)
        )
    grad_fn = jax.jit(jax.grad(negll))
    flat = np.concatenate(
        [np.ravel(np.asarray(x, np.float64)) for x in leaves]
    )
    n = flat.size

    def unflatten(vec):
        out = []
        off = 0
        for x, sz in zip(leaves, sizes):
            out.append(
                jnp.asarray(vec[off:off + sz].reshape(np.shape(x)))
            )
            off += sz
        return jax.tree.unflatten(treedef, out)

    def gflat(vec):
        g = grad_fn(unflatten(vec))
        return np.concatenate(
            [np.ravel(np.asarray(x, np.float64))
             for x in jax.tree.leaves(g)]
        )

    h = np.zeros((n, n))
    for i in range(n):
        step = rel_h * max(abs(flat[i]), 1e-2)
        vp, vm = flat.copy(), flat.copy()
        vp[i] += step
        vm[i] -= step
        h[:, i] = (gflat(vp) - gflat(vm)) / (2.0 * step)
    return h


def fisher_covariance(
    engine,
    params: Mapping,
    free: Optional[Tuple[str, ...]] = None,
):
    """(cov, point, sizes): observed-information covariance of the free
    parameters at ``params`` (flattened order = ``jax.tree.leaves`` of the
    free sub-PyTree), the evaluation point, and per-leaf sizes.
    Boundary/non-finite rows are dropped (their variance reads nan)."""
    base = engine._full_params(params)
    if free is None:
        free = tuple(base.keys())
    frozen, point = _split_free(base, free)
    lp, w = engine._leaf_partials, engine._weights

    def negll(p):
        full = _merge_params(frozen, p)
        total, _ = engine._loglik_fn(full, lp, w)
        return -total.astype(jnp.result_type(float))

    point = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.result_type(float)), point
    )
    leaves, treedef = jax.tree.flatten(point)
    sizes = [int(np.size(x)) for x in leaves]
    n = sum(sizes)
    try:
        hess = jax.hessian(negll)(point)
        hrows = jax.tree.leaves(hess)
        idx = 0
        blocks = [[None] * len(leaves) for _ in range(len(leaves))]
        for i in range(len(leaves)):
            for j in range(len(leaves)):
                blk = np.asarray(hrows[idx], np.float64)
                blocks[i][j] = blk.reshape(sizes[i], sizes[j])
                idx += 1
        h = np.block(blocks)
    except NotImplementedError:
        # second-order autodiff is unavailable through some primitives
        # (e.g. the gamma-quantile inversion: jax has no rule for
        # differentiating `igamma_grad_a`, so a free `alpha` breaks
        # jax.hessian). Fall back to central finite differences OF THE
        # EXACT GRADIENT — the standard "numerical observed information
        # from analytic scores" construction (codeml does the same with
        # numerical first derivatives on top).
        h = _hessian_fd_of_gradient(negll, point, leaves, treedef, sizes)
    h = 0.5 * (h + h.T)
    finite = np.isfinite(h).all(axis=0) & np.isfinite(h).all(axis=1)
    cov = np.full((n, n), np.nan)
    if finite.any():
        sub = np.linalg.pinv(h[np.ix_(finite, finite)])
        cov[np.ix_(finite, finite)] = sub
    return cov, (leaves, treedef, sizes)


def standard_errors(
    engine,
    params: Mapping,
    free: Optional[Tuple[str, ...]] = None,
) -> Dict:
    """Asymptotic standard errors of MLEs from the observed Fisher
    information (the exact Hessian of logL via ``jax.hessian`` — the
    reference/codeml report these from numerical second differences).

    ``params`` should be the fitted MLEs (e.g. ``FitResult.params``);
    ``free`` selects which parameters the information matrix covers
    (same semantics as ``fit``, dotted names included). The Hessian is
    taken in the CONSTRAINED space directly. Entries whose curvature is
    not positive (parameter at a boundary, flat direction) get ``nan``.
    Confounded directions (e.g. a rooted binary tree's two root-child
    edges, where only the sum is identifiable) are resolved by the
    pseudo-inverse: the reported per-element SEs are the minimum-norm
    ones, and the IDENTIFIABLE combination's variance is split across
    the confounded elements.

    Returns a PyTree shaped like the free parameters with per-element
    standard errors.
    """
    cov, (leaves, treedef, sizes) = fisher_covariance(engine, params, free)
    var = np.diag(cov).copy()
    var[~(var > 0)] = np.nan
    se_flat = np.sqrt(var)
    out_leaves = []
    off = 0
    for x, sz in zip(leaves, sizes):
        out_leaves.append(
            np.asarray(se_flat[off:off + sz]).reshape(np.shape(x))
        )
        off += sz
    return jax.tree.unflatten(treedef, out_leaves)


def newton_branch_length(
    eig: Eigen,
    partials_a: jnp.ndarray,
    partials_b: jnp.ndarray,
    weights: jnp.ndarray,
    t0: float = 0.1,
    min_t: float = 1e-8,
    max_t: float = 20.0,
    iters: int = 20,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Optimize one branch length by safeguarded Newton-Raphson.

    Matches the reference ``OptWrapper`` mechanism (SURVEY.md §3.3): Newton
    steps on analytic first/second logL derivatives, positivity clamp, and a
    fallback halving step when curvature is not negative. Returns (t*, lnL*).
    Fixed iteration count keeps the loop jit-static; vmap over many branches.
    """
    dtype = partials_a.dtype
    t0 = jnp.asarray(t0, dtype)

    def body(t, _):
        _, d1, d2 = _branch_lnl_derivs(eig, partials_a, partials_b, weights, t)
        newton = t - d1 / jnp.where(d2 < 0, d2, -1.0)
        # If curvature is bad, move uphill by a conservative fixed fraction.
        fallback = t * jnp.where(d1 > 0, 1.5, 0.5)
        t_new = jnp.where(d2 < 0, newton, fallback)
        t_new = jnp.clip(t_new, min_t, max_t)
        return t_new, None

    t, _ = lax.scan(body, t0, None, length=iters)
    lnl, _, _ = _branch_lnl_derivs(eig, partials_a, partials_b, weights, t)
    return t, lnl


# ---------------------------------------------------------------------------
# 1-D safeguarded minimizers (reference optimisation.py parity)
# ---------------------------------------------------------------------------

_GOLD = 0.3819660112501051  # 2 - phi


def golden_section(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    lo: float,
    hi: float,
    iters: int = 60,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Golden-section minimization of ``fn`` on [lo, hi] (jit-compatible).

    Interior points x1 < x2 at the golden ratio; each iteration shrinks the
    bracket to [lo, x2] or [x1, hi], reusing the surviving interior point so
    ``fn`` is evaluated once per iteration (on the single new point).
    """
    invphi = 1.0 - _GOLD  # 0.618...
    lo = jnp.asarray(lo, jnp.result_type(float))
    hi = jnp.asarray(hi, lo.dtype)
    x1 = hi - invphi * (hi - lo)
    x2 = lo + invphi * (hi - lo)

    def body(carry, _):
        lo, hi, x1, x2, f1, f2 = carry
        left = f1 < f2  # keep [lo, x2]
        new_lo = jnp.where(left, lo, x1)
        new_hi = jnp.where(left, x2, hi)
        # surviving interior point and its value
        keep_x = jnp.where(left, x1, x2)
        keep_f = jnp.where(left, f1, f2)
        # the single new evaluation point
        new_x = jnp.where(
            left, new_hi - invphi * (new_hi - new_lo),
            new_lo + invphi * (new_hi - new_lo),
        )
        new_f = fn(new_x)
        x1n = jnp.where(left, new_x, keep_x)
        f1n = jnp.where(left, new_f, keep_f)
        x2n = jnp.where(left, keep_x, new_x)
        f2n = jnp.where(left, keep_f, new_f)
        return (new_lo, new_hi, x1n, x2n, f1n, f2n), None

    carry = (lo, hi, x1, x2, fn(x1), fn(x2))
    (lo, hi, x1, x2, f1, f2), _ = lax.scan(body, carry, None, length=iters)
    x = jnp.where(f1 < f2, x1, x2)
    return x, jnp.minimum(f1, f2)


def brent_minimize(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    lo: float,
    hi: float,
    tol: float = 1e-10,
    iters: int = 100,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Brent's method (parabolic interpolation + golden fallback) on [lo, hi].

    jit-compatible lax.while_loop implementation of the classic algorithm.
    """
    dtype = jnp.result_type(float)
    a = jnp.asarray(lo, dtype)
    b = jnp.asarray(hi, dtype)
    x = a + _GOLD * (b - a)
    fx = fn(x)
    state = (a, b, x, x, x, fx, fx, fx, jnp.zeros((), dtype), jnp.zeros((), dtype),
             jnp.zeros((), jnp.int32))

    def cond(state):
        a, b, x, *_, it = state
        m = 0.5 * (a + b)
        tol1 = tol * jnp.abs(x) + 1e-12
        return jnp.logical_and(
            jnp.abs(x - m) > 2 * tol1 - 0.5 * (b - a), it < iters
        )

    def body(state):
        a, b, x, w, v, fx, fw, fv, d, e, it = state
        m = 0.5 * (a + b)
        tol1 = tol * jnp.abs(x) + 1e-12
        tol2 = 2.0 * tol1
        # Parabolic fit through (x, fx), (w, fw), (v, fv)
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q2 = 2.0 * (q - r)
        p = jnp.where(q2 > 0, -p, p)
        q2 = jnp.abs(q2)
        use_para = jnp.logical_and(
            jnp.abs(p) < jnp.abs(0.5 * q2 * e),
            jnp.logical_and(p > q2 * (a - x), p < q2 * (b - x)),
        )
        e_new_g = jnp.where(x < m, b - x, a - x)
        d_gold = _GOLD * e_new_g
        d_para = p / jnp.where(q2 == 0, 1.0, q2)
        d_new = jnp.where(use_para, d_para, d_gold)
        e_new = jnp.where(use_para, d, e_new_g)
        u = jnp.where(
            jnp.abs(d_new) >= tol1, x + d_new, x + jnp.sign(d_new) * tol1
        )
        fu = fn(u)
        better = fu <= fx
        a_n = jnp.where(better, jnp.where(u >= x, x, a), jnp.where(u < x, u, a))
        b_n = jnp.where(better, jnp.where(u >= x, b, x), jnp.where(u < x, b, u))
        x_n = jnp.where(better, u, x)
        fx_n = jnp.where(better, fu, fx)
        repl_w = jnp.logical_or(fu <= fw, w == x)
        w_n = jnp.where(better, x, jnp.where(repl_w, u, w))
        fw_n = jnp.where(better, fx, jnp.where(repl_w, fu, fw))
        v_n = jnp.where(better, w, jnp.where(repl_w, w, jnp.where(
            jnp.logical_or(fu <= fv, jnp.logical_or(v == x, v == w)), u, v)))
        fv_n = jnp.where(better, fw, jnp.where(repl_w, fw, jnp.where(
            jnp.logical_or(fu <= fv, jnp.logical_or(v == x, v == w)), fu, fv)))
        return (a_n, b_n, x_n, w_n, v_n, fx_n, fw_n, fv_n, d_new, e_new, it + 1)

    a, b, x, w, v, fx, fw, fv, d, e, it = lax.while_loop(cond, body, state)
    return x, fx


# ---------------------------------------------------------------------------
# Pairwise ML distances (the reference OptWrapper's main consumer use-case)
# ---------------------------------------------------------------------------


def ml_distance_matrix(
    alignment,
    model,
    params: Optional[Mapping] = None,
    t0: float = 0.1,
    max_t: float = 20.0,
    dtype=None,
) -> np.ndarray:
    """Maximum-likelihood pairwise evolutionary distances.

    The reference optimizes one pair at a time through its Newton
    ``OptWrapper`` (SURVEY.md §2); here every pair's safeguarded Newton
    iteration runs simultaneously under one ``vmap`` — the n(n-1)/2 pairs
    are a batch axis on the device. Pattern compression is applied once
    globally. Returns a dense symmetric (n, n) float64 matrix (diagonal 0)
    ordered like the alignment; access names via ``list(alignment)``.
    """
    import jax

    from phylo_utils_tpu import io as pio

    ca = (
        alignment
        if isinstance(alignment, pio.CompressedAlignment)
        else pio.compress_patterns(alignment, model.alphabet)
    )
    dt = jnp.dtype(dtype) if dtype else jnp.dtype(jnp.result_type(float))
    eig = model.eigen(params, dtype=dt)
    partials = jnp.asarray(ca.partials, dt)        # (n, P, S)
    weights = jnp.asarray(ca.weights, dt)
    n = partials.shape[0]
    ii, jj = np.triu_indices(n, k=1)

    @jax.jit
    def solve_all(partials, weights):
        def one(i, j):
            t, _ = newton_branch_length(
                eig, partials[i], partials[j], weights, t0=t0, max_t=max_t
            )
            return t

        return jax.vmap(one)(jnp.asarray(ii), jnp.asarray(jj))

    ts = np.asarray(solve_all(partials, weights), np.float64)
    out = np.zeros((n, n))
    out[ii, jj] = ts
    out[jj, ii] = ts
    return out


def simulation_setup(engine, params, what: str):
    """(full, tree_at_mle, n_sites, flat sim params, pinv) for
    simulate-at-the-fitted-model workflows (parametric_bootstrap,
    goldman_cox_test). Shared so its engine-scope checks stay in one
    place: only the BASE LikelihoodEngine with the plain gamma/no-rate
    mixture is supported — mixture/branch/clock engines have their own
    parameterizations ('shared', hyperparameters, heights) that
    simulate_alignment cannot consume, and silently simulating under
    factory defaults would make the bootstrap null meaningless."""
    from phylo_utils_tpu.likelihood import LikelihoodEngine

    if (
        type(engine)._loglik_fn is not LikelihoodEngine._loglik_fn
        or type(engine)._mixture_tensors
        is not LikelihoodEngine._mixture_tensors
    ):
        raise ValueError(
            f"{what} supports the base LikelihoodEngine only; "
            f"{type(engine).__name__} has its own parameterization that "
            "simulate_alignment cannot generate under (simulate with the "
            "matching simulator — simulate_mixture_alignment / "
            "simulate_branch_alignment — and drive the analysis manually)"
        )
    if getattr(engine, "rate_model", "gamma") != "gamma":
        raise ValueError(
            f"{what} supports the (equal-weight) gamma rate mixture "
            "only: simulate_alignment cannot generate under "
            f"rate_model={engine.rate_model!r} (FreeRate rates/weights)"
        )
    full = engine._full_params(params)
    tree_mle = engine.tree.with_lengths(
        np.asarray(full["branch_lengths"], np.float64)
    )
    n_sites = int(round(float(np.asarray(engine._compressed.weights).sum())))
    sim_params = {
        k: np.asarray(v) for k, v in dict(full.get("model", {})).items()
    }
    if "alpha" in full:
        sim_params["alpha"] = np.asarray(full["alpha"])
    pinv = float(full["pinv"]) if "pinv" in full else 0.0
    return full, tree_mle, n_sites, sim_params, pinv


def parametric_bootstrap(
    engine,
    params: Optional[Mapping] = None,
    n_replicates: int = 100,
    seed: int = 0,
    free: Optional[Tuple[str, ...]] = None,
    max_steps: int = 200,
    **fit_kwargs,
):
    """Parametric bootstrap of the ML estimates (seq-gen + refit).

    Simulates ``n_replicates`` alignments of the original length under
    the engine's model AT ``params`` (pass the MLE from ``fit``), refits
    each replicate starting from those values, and returns the sampling
    distribution of the estimates — the finite-sample complement to the
    asymptotic ``standard_errors`` (observed Fisher information), and the
    standard way to expose estimator bias.

    Returns a dict with "replicates" (a params PyTree whose leaves are
    stacked (n_replicates, ...) arrays), "mean"/"se" (per-leaf summary),
    and "loglik" per replicate. Base ``LikelihoodEngine`` only (mixture /
    branch-model engines have their own simulators; see
    simulate.simulate_mixture_alignment / simulate_branch_alignment).
    """
    import jax as _jax

    from phylo_utils_tpu.simulate import simulate_alignment

    full, tree_mle, n_sites, sim_params, pinv = simulation_setup(
        engine, params, what="parametric_bootstrap"
    )

    reps = []
    lls = []
    for i in range(n_replicates):
        aln = simulate_alignment(
            _jax.random.key(seed + i), tree_mle, engine.model, n_sites,
            params=sim_params, ncat=engine.ncat, pinv=pinv,
            median=engine.median,
        )
        rep_engine = type(engine)(
            tree_mle, aln, engine.model, ncat=engine.ncat,
            invariant_sites=engine.invariant_sites, median=engine.median,
            dtype=engine.dtype,
        )
        res = fit(rep_engine, params0=full, free=free,
                  max_steps=max_steps, **fit_kwargs)
        reps.append(res.params)
        lls.append(res.loglik)

    stacked = _jax.tree.map(lambda *xs: np.stack(
        [np.asarray(x, np.float64) for x in xs]), *reps)
    mean = _jax.tree.map(lambda a: a.mean(axis=0), stacked)
    se = _jax.tree.map(lambda a: a.std(axis=0, ddof=1), stacked)
    return {
        "replicates": stacked,
        "mean": mean,
        "se": se,
        "loglik": np.asarray(lls),
    }
