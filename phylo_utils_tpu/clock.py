"""Molecular clock models: branch lengths derived from node HEIGHTS.

The reference (kgori/phylo_utils) optimizes branch lengths freely; it has
no clock machinery (SURVEY.md §2). This module adds the PAML-style clock
family:

- ``ClockEngine`` — strict clock (codeml clock=1): every lineage evolves
  at the same rate, so the tree is ULTRAMETRIC (all leaves equidistant
  from the root). Branch lengths are derived from free node heights;
  optionally per-edge-class rate multipliers give LOCAL clocks (codeml
  clock=2: a few lineages evolve at their own rate but the tree stays
  height-parameterized).
- ``clock_test`` — the classic molecular-clock LRT (Felsenstein 1981):
  strict clock (null) vs. unconstrained branch lengths (alternative),
  df = (identifiable branch lengths) - (clock parameters).

Design: heights are a PURE REPARAMETERIZATION of branch
lengths, materialized inside the jitted likelihood. Each non-root
internal node carries a free fraction f in (0,1) of its parent's height
(sigmoid-constrained under ``fit``), the root carries a free positive
height, so ultrametricity and branch-length positivity hold by
CONSTRUCTION — no constrained optimizer needed, and ``jax.grad`` flows
through the height map into the same pruning pass. The map itself is one
(static 0/1 ancestor-matrix) @ log-fractions matmul — no tree recursion
in the traced program.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu.likelihood import LikelihoodEngine, mixture_rates_and_p
from phylo_utils_tpu.trees import Tree

__all__ = ["ClockEngine", "clock_test", "node_height_errors",
           "penalized_likelihood_dating", "cross_validate_lambda", "mrca"]


def _clock_structure(tree: Tree):
    """Static index arrays for the height->branch-length map.

    Returns (internal_ids, anc, parent_slot, child_is_leaf) where
    ``internal_ids[k]`` is the node id of internal slot k (root = slot
    n_int-1), ``anc[k, j] = 1`` iff non-root internal slot j is on the
    root->slot-k path (inclusive of k), and for every node i,
    ``parent_slot[i]`` is the internal slot of i's parent.
    """
    internal_ids = np.array(
        [i for i in range(tree.n_nodes) if tree.children[i]], np.int32
    )
    slot = {int(n): k for k, n in enumerate(internal_ids)}
    n_int = len(internal_ids)
    root_slot = slot[tree.root]
    # non-root internal slots, in the fractions vector's order
    frac_slots = [k for k in range(n_int) if k != root_slot]
    frac_pos = {k: p for p, k in enumerate(frac_slots)}
    anc = np.zeros((n_int, len(frac_slots)), np.float64)
    for k, nid in enumerate(internal_ids):
        node = int(nid)
        while node != -1:
            if tree.children[node] and node != tree.root:
                anc[k, frac_pos[slot[node]]] = 1.0
            node = int(tree.parent[node])
    parent_slot = np.array(
        [slot[int(tree.parent[i])] if tree.parent[i] != -1 else -1
         for i in range(tree.n_nodes)],
        np.int32,
    )
    is_internal = np.array(
        [1.0 if tree.children[i] else 0.0 for i in range(tree.n_nodes)]
    )
    node_slot = np.array(
        [slot.get(i, 0) for i in range(tree.n_nodes)], np.int32
    )
    return internal_ids, anc, parent_slot, is_internal, node_slot, root_slot


def _initial_heights(tree: Tree) -> np.ndarray:
    """Per-node initial height: mean root-to-leaf distance below the node
    (a least-squares-flavored ultrametricization of the input lengths)."""
    h = np.zeros(tree.n_nodes)
    counts = np.zeros(tree.n_nodes)
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            counts[node] = 1.0
            continue
        tot, n = 0.0, 0.0
        for c in kids:
            tot += (h[c] + tree.lengths[c]) * counts[c]
            n += counts[c]
        h[node] = tot / n
        counts[node] = n
    return h


class ClockEngine(LikelihoodEngine):
    """Likelihood engine under a strict (or local) molecular clock.

    Free parameters replace ``branch_lengths``:

    - ``root_height`` — positive root age (in expected substitutions per
      site at rate 1).
    - ``height_fractions`` — (n_internal - 1,) values in (0, 1); each
      non-root internal node's height is this fraction of its parent's.
    - ``rate_multipliers`` — only with ``branch_classes`` (LOCAL clocks):
      one positive rate per class, class 0 pinned to 1 for
      identifiability; edge lengths in class c are scaled by
      ``multipliers[c]``.

    Everything else (model params, +G/+I, walk options, sharding,
    gradients, posteriors) behaves exactly as in ``LikelihoodEngine``;
    ``node_heights``/``chronogram`` expose the fitted ultrametric tree.
    """

    def __init__(self, tree, alignment, model,
                 branch_classes: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(tree, alignment, model, **kwargs)
        (self._internal_ids, anc, parent_slot, is_internal, node_slot,
         self._root_slot) = _clock_structure(self.tree)
        self._anc = jnp.asarray(anc, self.dtype)
        self._parent_slot = jnp.asarray(parent_slot)
        self._is_internal = jnp.asarray(is_internal, self.dtype)
        self._node_slot = jnp.asarray(node_slot)
        self.n_internal = len(self._internal_ids)
        self._h0 = _initial_heights(self.tree)
        if branch_classes is not None:
            from phylo_utils_tpu.branch_models import _classes_from_mapping

            if isinstance(branch_classes, Mapping):
                cls = _classes_from_mapping(self.tree, branch_classes)
            else:
                cls = np.asarray(branch_classes, np.int32)
            if cls.shape != (self.tree.n_nodes,):
                raise ValueError(
                    f"branch_classes must have one entry per node "
                    f"({self.tree.n_nodes}), got {cls.shape}"
                )
            self.n_rate_classes = int(cls.max()) + 1
            self._cls = jnp.asarray(cls)
        else:
            self.n_rate_classes = 1
            self._cls = None

    # -- parameters -----------------------------------------------------

    def default_params(self) -> Dict:
        params = super().default_params()
        del params["branch_lengths"]
        h0 = self._h0
        ids = self._internal_ids
        root_h = max(float(h0[self.tree.root]), 1e-3)
        fracs = []
        for k, nid in enumerate(ids):
            if k == self._root_slot:
                continue
            ph = max(float(h0[int(self.tree.parent[nid])]), 1e-9)
            fracs.append(min(max(float(h0[nid]) / ph, 0.05), 0.95))
        params["root_height"] = jnp.asarray(root_h, self.dtype)
        params["height_fractions"] = jnp.asarray(fracs, self.dtype)
        if self.n_rate_classes > 1:
            params["rate_multipliers"] = jnp.ones(
                (self.n_rate_classes - 1,), self.dtype
            )
        return params

    # -- height -> branch-length map (traced) -----------------------------

    def _heights(self, params, dtype):
        """(n_internal,) node heights from root_height + fractions."""
        h = jnp.asarray(params["root_height"], dtype)
        if self.n_internal > 1:
            f = jnp.clip(
                params["height_fractions"].astype(dtype), 1e-6, 1.0 - 1e-6
            )
            # log h_k = log H + sum of log f over root->k internal path
            h = h * jnp.exp(jnp.matmul(self._anc.astype(dtype), jnp.log(f),
                                       precision=jax.lax.Precision.HIGHEST))
        else:
            h = h[None] if h.ndim == 0 else h
        return jnp.broadcast_to(
            jnp.atleast_1d(h), (self.n_internal,)
        )

    def _branch_lengths(self, params, dtype):
        heights = self._heights(params, dtype)             # (n_int,)
        node_h = self._is_internal * heights[self._node_slot]
        parent_h = heights[jnp.clip(self._parent_slot, 0, None)]
        bl = parent_h - node_h                              # >= 0 by constr.
        if self._cls is not None:
            mult = jnp.concatenate([
                jnp.ones((1,), dtype),
                params["rate_multipliers"].astype(dtype),
            ])
            bl = bl * mult[self._cls]
        # root's own entry is unused by the likelihood; zero it for clarity
        root = self.tree.root
        return bl.at[root].set(0.0)

    def _mixture_tensors(self, params, dtype, eig=None):
        p2 = dict(params)
        p2["branch_lengths"] = self._branch_lengths(params, dtype)
        return mixture_rates_and_p(self, p2, dtype, eig=eig)

    # -- results ----------------------------------------------------------

    def node_heights(self, params: Optional[Mapping] = None) -> Dict[int, float]:
        """Fitted height of every node (leaves are 0), keyed by node id."""
        full = self._full_params(params)
        h = np.asarray(self._heights(full, self._reduce_dtype))
        out = {int(i): 0.0 for i in range(self.tree.n_leaves)}
        for k, nid in enumerate(self._internal_ids):
            out[int(nid)] = float(h[k])
        return out

    def chronogram(self, params: Optional[Mapping] = None) -> Tree:
        """The fitted ultrametric tree (lengths in height units,
        WITHOUT local-clock rate multipliers — a time tree)."""
        full = self._full_params(params)
        heights = self.node_heights(full)
        lengths = np.zeros(self.tree.n_nodes)
        for i in range(self.tree.n_nodes):
            p = int(self.tree.parent[i])
            if p != -1:
                lengths[i] = heights[p] - heights[i]
        return self.tree.with_lengths(lengths)

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        from phylo_utils_tpu.likelihood import validate_param_keys

        full = self.default_params()
        if params:
            if "branch_lengths" in params:
                # more specific than the generic unknown-key guard
                raise ValueError(
                    "ClockEngine derives branch lengths from heights; "
                    "set root_height / height_fractions instead"
                )
            validate_param_keys(params, full, type(self).__name__,
                                nested="model")
            for k, v in params.items():
                if k == "model":
                    full["model"] = {**full["model"], **{
                        kk: jnp.asarray(vv, self.dtype)
                        for kk, vv in v.items()
                    }}
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full


def clock_test(tree, alignment, model, ncat: int = 1,
               params0: Optional[Mapping] = None,
               engine_kwargs: Optional[Mapping] = None,
               **fit_kwargs) -> Dict:
    """Molecular-clock LRT (Felsenstein 1981): strict clock (null) vs.
    unconstrained branch lengths (alternative).

    df = identifiable branch lengths - clock height parameters. For a
    rooted binary tree of n extant taxa that is (2n-3) - (n-1) = n-2
    (the two root edges are confounded without a clock).
    """
    from phylo_utils_tpu.model_selection import likelihood_ratio_test
    from phylo_utils_tpu.optimize import fit

    engine_kwargs = dict(engine_kwargs or {})
    null = ClockEngine(tree, alignment, model, ncat=ncat, **engine_kwargs)
    alt = LikelihoodEngine(tree, alignment, model, ncat=ncat,
                           **engine_kwargs)
    null_fit = fit(null, params0=params0, **fit_kwargs)
    alt_fit = fit(alt, **fit_kwargs)
    n_edges = tree.n_nodes - 1
    root_children = len(tree.children[tree.root])
    n_bl = n_edges - (1 if root_children == 2 else 0)
    n_clock = null.n_internal + (null.n_rate_classes - 1)
    df = max(n_bl - n_clock, 1)
    lrt = likelihood_ratio_test(null_fit.loglik, alt_fit.loglik, df=df)
    return {
        "null": null_fit, "alt": alt_fit, "lrt": lrt, "df": df,
        "null_engine": null, "alt_engine": alt,
    }


def node_height_errors(engine: ClockEngine,
                       params: Optional[Mapping] = None) -> Dict[int, float]:
    """Asymptotic standard errors of the fitted node heights (ages).

    Delta method on the height map: heights are a smooth function of
    (root_height, height_fractions), so var(h) = J cov J^T with J the
    exact ``jax.jacobian`` of the map and cov the observed-information
    covariance of the clock parameters at the MLEs (model parameters and
    rate multipliers, if free, are marginalized through the joint
    information matrix). Returns {node id: SE} for internal nodes —
    dating with uncertainty, not just point estimates.
    """
    import jax

    from phylo_utils_tpu.optimize import fisher_covariance

    full = engine._full_params(params)
    free = ["root_height"]
    if engine.n_internal > 1:
        free.append("height_fractions")
    if engine.n_rate_classes > 1:
        free.append("rate_multipliers")
    cov, (leaves, treedef, sizes) = fisher_covariance(
        engine, full, free=tuple(free)
    )
    point = {k: full[k] for k in free}

    def heights_of(p):
        q = dict(full)
        q.update(p)
        return engine._heights(q, engine._reduce_dtype)

    jac = jax.jacobian(heights_of)(point)
    # flatten jacobian columns in the SAME leaf order as the covariance
    jleaves = jax.tree.leaves(jac)
    n_h = engine.n_internal
    cols = []
    for jl, sz in zip(jleaves, sizes):
        cols.append(np.asarray(jl, np.float64).reshape(n_h, sz))
    J = np.concatenate(cols, axis=1)                 # (n_h, n_params)
    var = np.einsum("ip,pq,iq->i", J, np.nan_to_num(cov), J)
    var[~(var >= 0)] = np.nan
    se = np.sqrt(var)
    return {int(nid): float(se[k])
            for k, nid in enumerate(engine._internal_ids)}


def mrca(tree: Tree, names: Sequence[str]) -> int:
    """Node id of the most recent common ancestor of the named leaves."""
    idx = {n: i for i, n in enumerate(tree.leaf_names)}
    try:
        ids = [idx[n] for n in names]
    except KeyError as e:
        raise ValueError(f"unknown leaf name {e.args[0]!r}") from None
    if not ids:
        raise ValueError("mrca() needs at least one leaf name")

    def ancestors(i):
        out = []
        while i != -1:
            out.append(int(i))
            i = int(tree.parent[i])
        return out

    common = set(ancestors(ids[0]))
    for i in ids[1:]:
        common &= set(ancestors(i))
    # the MRCA is the common ancestor with the greatest root distance,
    # i.e. the FIRST common entry walking up from any member
    for a in ancestors(ids[0]):
        if a in common:
            return a
    raise AssertionError("unreachable: root is always common")


class _PLProblem:
    """Shared machinery for penalized-likelihood dating fits.

    One compiled Adam-scan program serves every (poisson-mask, lambda)
    combination — both are jit ARGUMENTS — which is what makes
    leaf-one-out cross-validation over a lambda grid affordable
    (n_leaves x n_lambdas fits, zero recompiles).
    """

    def __init__(self, tree: Tree, n_sites: int, root_age: float,
                 free_root: bool, calib, calibration_weight: float,
                 steps: int, lr: float):
        import optax

        (internal_ids, anc, parent_slot, is_internal, node_slot,
         root_slot) = _clock_structure(tree)
        self.tree = tree
        self.n_sites = n_sites
        self.internal_ids = internal_ids
        self.n_int = n_int = len(internal_ids)
        self.root_slot = root_slot
        self.free_root = free_root
        h0 = _initial_heights(tree)
        h0_int = np.maximum(h0[internal_ids], 1e-6)
        fr0 = []
        for k, nid in enumerate(internal_ids):
            if k == root_slot:
                continue
            par = int(tree.parent[int(nid)])
            fr0.append(
                min(max(h0_int[k] / max(h0[par], 1e-9), 1e-3), 1.0 - 1e-3)
            )
        fr0 = np.asarray(fr0, np.float64)
        r0 = max(float(h0[tree.root]) / max(root_age, 1e-9), 1e-6)

        counts = jnp.asarray(np.asarray(tree.lengths, np.float64) * n_sites)
        root = tree.root
        nonroot_mask = jnp.asarray(
            [0.0 if i == root else 1.0 for i in range(tree.n_nodes)]
        )
        parent_of = jnp.asarray(
            [int(tree.parent[i]) if tree.parent[i] != -1 else 0
             for i in range(tree.n_nodes)], jnp.int32
        )
        is_root_child = jnp.asarray(
            [1.0 if int(tree.parent[i]) == root else 0.0
             for i in range(tree.n_nodes)]
        )
        child_mask = jnp.asarray(
            [1.0 if (tree.parent[i] != -1
                     and tree.parent[int(i)] != root) else 0.0
             for i in range(tree.n_nodes)]
        )
        anc_j = jnp.asarray(anc)
        parent_slot_j = jnp.asarray(parent_slot)
        node_slot_j = jnp.asarray(node_slot)
        is_internal_j = jnp.asarray(is_internal)
        if calib:
            calib_slots = jnp.asarray([c[0] for c in calib], jnp.int32)
            calib_lo = jnp.asarray([c[1] for c in calib])
            calib_hi = jnp.asarray([c[2] for c in calib])
        else:
            calib_slots = None

        def heights(raw_f, log_H):
            H = jnp.exp(log_H) if free_root else root_age
            f = jax.nn.sigmoid(raw_f)
            if n_int > 1:
                h = H * jnp.exp(jnp.matmul(
                    anc_j, jnp.log(f), precision=jax.lax.Precision.HIGHEST))
            else:
                h = jnp.full((1,), 1.0) * H
            return h

        def durations(raw_f, log_H):
            h = heights(raw_f, log_H)
            node_h = is_internal_j * h[node_slot_j]
            parent_h = h[jnp.clip(parent_slot_j, 0, None)]
            return jnp.maximum(parent_h - node_h, 1e-9), h

        self._durations = durations

        def objective(params, mask, lam):
            raw_f, log_r, log_H = params
            d, h = durations(raw_f, log_H)
            r = jnp.exp(log_r)
            mu = r * d * n_sites
            m = nonroot_mask * mask
            pois = jnp.sum(m * (counts * jnp.log(mu) - mu))
            diff = (r - r[parent_of]) ** 2 * child_mask
            rc = is_root_child
            nrc = jnp.sum(rc)
            mean_rc = jnp.sum(r * rc) / nrc
            var_rc = jnp.sum(rc * (r - mean_rc) ** 2) / nrc
            obj = pois - lam * n_sites * (jnp.sum(diff) + var_rc)
            if calib_slots is not None:
                viol = (
                    jnp.maximum(calib_lo - h[calib_slots], 0.0) ** 2
                    + jnp.maximum(h[calib_slots] - calib_hi, 0.0) ** 2
                )
                obj = obj - calibration_weight * n_sites * jnp.sum(viol)
            return obj

        self._objective = objective
        self.raw0 = (
            jnp.asarray(np.log(fr0 / (1 - fr0))),
            jnp.full((tree.n_nodes,), np.log(r0)),
            jnp.asarray(np.log(max(root_age, 1e-9))),
        )
        opt = optax.adam(lr)

        @jax.jit
        def run(raw0, mask, lam):
            state0 = opt.init(raw0)

            def step(carry, _):
                raw, st = carry
                val, g = jax.value_and_grad(
                    lambda q: -objective(q, mask, lam)
                )(raw)
                upd, st = opt.update(g, st, raw)
                return (optax.apply_updates(raw, upd), st), -val

            (raw, _), _trace = jax.lax.scan(step, (raw0, state0), None,
                                            length=steps)
            # report the objective AT the returned parameters (trace
            # entries are PRE-update values)
            return raw, objective(raw, mask, lam)

        self._run = run
        self._ones_mask = jnp.ones((tree.n_nodes,))

    def fit(self, mask=None, lam: float = 1.0):
        mask = self._ones_mask if mask is None else mask
        raw, obj = self._run(self.raw0, mask, jnp.asarray(float(lam)))
        return raw, float(obj)

    def unpack(self, raw):
        d, h = self._durations(raw[0], raw[2])
        rates = np.array(jnp.exp(raw[1]))
        rates[self.tree.root] = 0.0
        return np.asarray(d), np.asarray(h), rates


def _resolve_calibrations(tree: Tree, internal_ids, calibrations):
    """Normalize {node-spec: age or (lo, hi)} to [(slot, lo, hi), ...].

    A node-spec is an internal node id (int) or a sequence of leaf names
    (resolved to their MRCA). A scalar age is an exact calibration
    (lo == hi); None bounds are open (lo=0 / hi=+inf).
    """
    slot_of = {int(n): k for k, n in enumerate(internal_ids)}
    out = []
    for spec, bounds in calibrations.items():
        node = spec if isinstance(spec, (int, np.integer)) else mrca(
            tree, tuple(spec)
        )
        if int(node) not in slot_of:
            raise ValueError(
                f"calibration target {spec!r} -> node {node} is not an "
                "internal node"
            )
        if np.isscalar(bounds):
            lo = hi = float(bounds)
        else:
            lo, hi = bounds
            lo = 0.0 if lo is None else float(lo)
            hi = np.inf if hi is None else float(hi)
        if lo > hi:
            raise ValueError(f"calibration {spec!r}: min {lo} > max {hi}")
        out.append((slot_of[int(node)], lo, hi))
    return out


def penalized_likelihood_dating(
    tree: Tree,
    n_sites: int,
    root_age: float = 1.0,
    lam: float = 1.0,
    steps: int = 2000,
    lr: float = 0.02,
    calibrations: Optional[Mapping] = None,
    calibration_weight: float = 1e3,
):
    """Penalized-likelihood divergence dating (Sanderson 2002, MBE 19:101
    — the r8s/ape-chronos semiparametric method).

    Takes a fitted PHYLOGRAM (branch lengths in expected substitutions
    per site) and estimates node AGES plus per-edge substitution rates
    by maximizing a Poisson likelihood of the per-branch substitution
    counts ``n_e = b_e * n_sites`` against ``r_e * d_e * n_sites``
    (``d_e`` = branch duration from the age assignment), minus
    ``lam * n_sites * (sum over parent-child edge pairs of
    (r_child - r_parent)^2 + Var(rates at the root))`` — Sanderson's
    autocorrelation penalty, scaled by the alignment length so ``lam``
    is a per-site smoothing strength comparable across datasets.
    Large ``lam`` approaches a strict clock; small ``lam`` lets rates
    vary freely (ages then identified only by the penalty). Choose
    ``lam`` with ``cross_validate_lambda``.

    Ages are parameterized exactly like ``ClockEngine`` (root age times
    per-node fractions, monotone by construction).

    ``calibrations`` enables ABSOLUTE dating (r8s fixage/constrain): a
    mapping from node spec — an internal node id, or a sequence of leaf
    names resolved to their MRCA — to an exact age (scalar) or an
    ``(min_age, max_age)`` interval (either side None = open). With
    calibrations the root age becomes a FREE parameter (without them
    the Poisson term is scale-invariant in (ages x rates), so the root
    is FIXED at ``root_age`` and dating is relative). Calibrations are
    smooth quadratic hinge penalties with weight
    ``calibration_weight * n_sites`` — exact calibrations are met to
    optimizer precision; the result reports the worst residual violation.

    Returns {"ages": {node id: age}, "rates": (n_nodes,) per-edge rates
    (root entry 0), "chronogram": Tree with branch lengths in time
    units, "objective": final penalized logL,
    "max_calibration_violation": worst hinge residual (0.0 when no
    calibrations)}.
    """
    (internal_ids, _anc, _ps, _ii, _ns, _rs) = _clock_structure(tree)
    calib = (
        _resolve_calibrations(tree, internal_ids, calibrations)
        if calibrations else []
    )
    if calib:
        finite = [c[1] for c in calib if np.isfinite(c[1]) and c[1] > 0]
        finite += [c[2] for c in calib if np.isfinite(c[2]) and c[2] > 0]
        root_age = max(finite) * 1.5 if finite else root_age
    prob = _PLProblem(
        tree, n_sites, root_age, free_root=bool(calib), calib=calib,
        calibration_weight=calibration_weight, steps=steps, lr=lr,
    )
    raw, final_obj = prob.fit(lam=lam)
    d, h, rates = prob.unpack(raw)
    ages = {int(nid): float(h[k]) for k, nid in enumerate(internal_ids)}
    for i in range(tree.n_leaves):
        ages[i] = 0.0
    root = tree.root
    chron = tree.with_lengths(np.where(
        np.arange(tree.n_nodes) == root, 0.0, d
    ))
    viol = 0.0
    for slot, lo, hi in calib:
        viol = max(viol, lo - float(h[slot]), float(h[slot]) - hi, 0.0)
    return {
        "ages": ages,
        "rates": rates,
        "chronogram": chron,
        "objective": float(final_obj),
        "max_calibration_violation": float(viol),
    }


def cross_validate_lambda(
    tree: Tree,
    n_sites: int,
    lambdas: Sequence[float] = (0.01, 0.1, 1.0, 10.0, 100.0),
    root_age: float = 1.0,
    steps: int = 1500,
    lr: float = 0.02,
) -> Dict:
    """Sanderson's fitted cross-validation for the smoothing strength.

    For each lambda and each TERMINAL edge e: refit the dating problem
    with e's Poisson term masked out, predict its substitution count
    from the refitted ages and its parent edge's rate
    (``n_hat_e = r_parent * d_e * n_sites``; for children of the root,
    the mean rate of the root's other edges), and score
    ``sum_e (n_e - n_hat_e)^2 / n_hat_e`` (Sanderson 2002 eq. 12). The
    lambda with the smallest CV score generalizes best.

    One compiled program serves all (leaf x lambda) fits — the mask and
    lambda are jit arguments (see _PLProblem). Returns {"lambda": best,
    "scores": {lambda: score}}.
    """
    prob = _PLProblem(tree, n_sites, root_age, free_root=False, calib=[],
                      calibration_weight=0.0, steps=steps, lr=lr)
    counts = np.asarray(tree.lengths, np.float64) * n_sites
    root = tree.root
    parent = np.asarray(tree.parent)
    n_nodes = tree.n_nodes
    scores: Dict[float, float] = {}
    for lam in lambdas:
        score = 0.0
        for leaf in range(tree.n_leaves):
            mask = np.ones((n_nodes,))
            mask[leaf] = 0.0
            raw, _ = prob.fit(mask=jnp.asarray(mask), lam=lam)
            d, _h, rates = prob.unpack(raw)
            p = int(parent[leaf])
            if p != root:
                r_pred = rates[p]
            else:
                sibs = [c for c in tree.children[root] if c != leaf]
                r_pred = float(np.mean([rates[c] for c in sibs]))
            n_hat = max(r_pred * d[leaf] * n_sites, 1e-9)
            score += (counts[leaf] - n_hat) ** 2 / n_hat
        scores[float(lam)] = float(score)
    best = min(scores, key=scores.get)
    return {"lambda": best, "scores": scores}
