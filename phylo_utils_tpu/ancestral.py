"""Ancestral state reconstruction (marginal / empirical-Bayes posteriors)
and per-site rate-category posteriors.

Beyond the reference's surface, but a standard companion capability of any
likelihood engine. Two passes over the compiled level schedule:

- **down** (Felsenstein pruning, reused from ops.pruning): ``down[v]`` =
  P(data below v | state at v), per rate category, per-node rescaled.
- **up** (pre-order): ``out[v]`` = P(data outside v's subtree | state at v):
  ``out[root] = pi``; for child v of u with siblings c,
  ``out[v][i] = sum_j P_v[j, i] * out[u][j] * prod_c (P_c @ down[c])[j]``.

Posteriors: per category p_c(state=i) ∝ down*out (per-node rescaling cancels
in the per-site normalization), mixed over categories with the per-site
category posterior gamma_{s,c} ∝ w_c * L_{s,c} * e^{scale_c}. All shapes are
static; everything jits.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from phylo_utils_tpu.trees import PruningSchedule

__all__ = [
    "ancestral_posteriors",
    "site_rate_posteriors",
    "site_rates",
    "joint_ancestral_states",
]

_HI = lax.Precision.HIGHEST


def _down_pass(schedule: PruningSchedule, p, leaf_partials):
    """Felsenstein pruning retaining ALL node buffers (for the up pass)."""
    dtype = leaf_partials.dtype
    k = p.shape[1]
    sites = leaf_partials.shape[1]
    s = leaf_partials.shape[2]
    n = schedule.n_nodes
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    buf = jnp.zeros((n + 1, k, sites, s), dtype)
    buf = buf.at[: schedule.n_leaves].set(leaf_partials[:, None, :, :])
    logscale = jnp.zeros((n + 1, k, sites), dtype)
    for lvl in range(schedule.n_levels):
        nodes = schedule.level_nodes[lvl]
        children = schedule.level_children[lvl]
        mask = schedule.level_childmask[lvl]
        child_p = buf[children]
        child_sc = logscale[children]
        pm = p[children]
        contrib = jnp.einsum("wckij,wcksj->wcksi", pm, child_p, precision=_HI)
        mb = mask[:, :, None, None, None].astype(dtype)
        contrib = contrib * mb + (1.0 - mb)
        partial = jnp.prod(contrib, axis=1)
        sc = jnp.sum(child_sc * mask[:, :, None, None], axis=1)
        m = jnp.maximum(jnp.max(partial, axis=-1), tiny)
        buf = buf.at[nodes].set(partial / m[..., None])
        logscale = logscale.at[nodes].set(sc + jnp.log(m))
    return buf, logscale


def _check_engine_supported(engine, what: str) -> None:
    """Engines with bespoke likelihood plumbing that do NOT expose the
    ``_mixture_tensors`` hook (PartitionedEngine, TopologySetEngine)
    can't drive the two-pass machinery — fail with a clear message
    instead of a KeyError deep in the base hook."""
    from phylo_utils_tpu.likelihood import LikelihoodEngine

    cls = type(engine)
    mt = getattr(cls, "_mixture_tensors", None)
    ll = getattr(cls, "_loglik_fn", None)
    if mt is None or (
        ll is not LikelihoodEngine._loglik_fn
        and mt is LikelihoodEngine._mixture_tensors
    ):
        raise NotImplementedError(
            f"{what} needs the engine's _mixture_tensors hook; "
            f"{type(engine).__name__} has its own likelihood plumbing "
            "without one (run the analysis per partition / per topology "
            "on its underlying engines instead)"
        )


def _per_cat_freqs(freqs, k, dtype):
    """Frequencies normalized to shape (K, S): base engines supply (S,)
    (shared across categories), model-mixture engines supply (K, S)."""
    f = jnp.asarray(freqs, dtype)
    if f.ndim == 1:
        f = jnp.broadcast_to(f[None, :], (k, f.shape[0]))
    return f


def _up_pass(schedule: PruningSchedule, p, down, freqs):
    """Outside likelihoods out[v] for every node, pre-order, rescaled.
    ``freqs``: (S,) shared or (K, S) per-category."""
    dtype = down.dtype
    n = schedule.n_nodes
    k, sites, s = down.shape[1], down.shape[2], down.shape[3]
    fk = _per_cat_freqs(freqs, k, dtype)
    out = jnp.zeros((n + 1, k, sites, s), dtype)
    out = out.at[schedule.root].set(
        jnp.broadcast_to(fk[:, None, :], (k, sites, s))
    )
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    # reverse level order: parents' out is ready before their children's
    for lvl in range(schedule.n_levels - 1, -1, -1):
        nodes = schedule.level_nodes[lvl]          # (W,) parents u
        children = schedule.level_children[lvl]    # (W, C)
        mask = schedule.level_childmask[lvl]       # (W, C)
        parent_out = out[nodes]                    # (W, K, sites, S)
        child_down = down[children]                # (W, C, K, sites, S)
        pm = p[children]                           # (W, C, K, S, S)
        contrib = jnp.einsum(
            "wckij,wcksj->wcksi", pm, child_down, precision=_HI
        )                                          # (W, C, K, sites, S)
        mb = mask[:, :, None, None, None].astype(dtype)
        contrib = contrib * mb + (1.0 - mb)
        # product over the OTHER children: total / self, computed exactly as
        # prod over c' != c (C is tiny) to avoid division blowups at zeros
        c = contrib.shape[1]
        sib = []
        for ci in range(c):
            others = [contrib[:, cj] for cj in range(c) if cj != ci]
            acc = others[0] if others else jnp.ones_like(contrib[:, 0])
            for o in others[1:]:
                acc = acc * o
            sib.append(acc)
        sib = jnp.stack(sib, axis=1)               # (W, C, K, sites, S)
        msg = parent_out[:, None] * sib            # at parent: out_u * sibs
        child_out = jnp.einsum(
            "wckji,wcksj->wcksi", pm, msg, precision=_HI
        )                                          # transpose-P application
        # rescale per (child, category, site); scale cancels in posteriors
        mx = jnp.maximum(jnp.max(child_out, axis=-1, keepdims=True), tiny)
        child_out = child_out / mx
        flat_children = children.reshape(-1)
        flat_vals = child_out.reshape((-1,) + child_out.shape[2:])
        flat_mask = mask.reshape(-1)
        # masked scatter: padded slots write to the trash row
        tgt = jnp.where(flat_mask > 0, flat_children, n)
        out = out.at[tgt].set(
            jnp.where(
                flat_mask[:, None, None, None] > 0,
                flat_vals,
                out[tgt],
            )
        )
    return out


def ancestral_posteriors(
    engine, params: Optional[Mapping] = None
) -> np.ndarray:
    """Marginal posterior state probabilities at every internal node.

    Returns (n_internal, n_sites, S): rows ordered by internal node id
    (``engine.tree`` ids ``n_leaves..n_nodes-1``; the last row is the root),
    expanded to per-site (not per-pattern) positions, normalized over states.
    """
    _check_engine_supported(engine, "ancestral_posteriors")
    schedule = engine.schedule
    full = engine._full_params(params)
    dtype = engine.dtype

    def compute(full, leaf_partials, weights):
        # engine hook: per-edge-per-category P and the mixture weights —
        # branch-model and model-mixture engines plug in here too (the
        # latter supply per-category (K, S) frequencies)
        _, cat_weights, p, freqs = engine._mixture_tensors(full, dtype)
        k = p.shape[1]
        fk = _per_cat_freqs(freqs, k, dtype)
        down, logscale = _down_pass(schedule, p, leaf_partials)
        out = _up_pass(schedule, p, down, fk)
        # binarization pseudo-nodes (ids >= n_real_nodes) are not tree
        # nodes — report posteriors for real internal nodes only
        internal = slice(schedule.n_leaves, schedule.n_real_nodes)
        joint = down[internal] * out[internal]      # (I, K, sites, S)
        per_cat = joint / jnp.maximum(
            jnp.sum(joint, axis=-1, keepdims=True),
            jnp.finfo(dtype).tiny,
        )
        # per-site category posterior from the root reduction
        root_lik = jnp.einsum(
            "ksi,ki->ks", down[schedule.root], fk, precision=_HI,
        )
        sc = logscale[schedule.root]
        m = jnp.max(sc, axis=0)
        gam = cat_weights[:, None] * root_lik * jnp.exp(sc - m[None, :])
        g_tot = jnp.sum(gam, axis=0)                       # (sites,)
        gam = gam / g_tot[None, :]                         # (K, sites)
        post = jnp.einsum(
            "iksj,ks->isj", per_cat, gam, precision=_HI
        )                                           # (I, sites, S)
        pinv = (
            full.get("pinv")
            if getattr(engine, "invariant_sites", False)
            else None
        )
        if pinv is not None:
            # mix in the +I component: all nodes share one state x with
            # posterior ~ pinv * pi_bar_x * prod_leaves partial[x];
            # its per-site mixing weight beta against the variable part
            # (weight (1-pinv) * e^m * sum_k gam_k) is computed in log
            # space (e^m under/overflows directly)
            pinv = jnp.asarray(pinv, dtype)
            prod = jnp.prod(leaf_partials.astype(dtype), axis=0)  # (s,S)
            fbar = jnp.einsum("k,ki->i", cat_weights, fk, precision=_HI)
            inv_unnorm = fbar[None, :] * prod                     # (s,S)
            inv_tot = jnp.sum(inv_unnorm, axis=-1)                # (s,)
            log_var = jnp.log1p(-pinv) + m + jnp.log(
                jnp.maximum(g_tot, jnp.finfo(dtype).tiny)
            )
            log_inv = jnp.where(
                inv_tot > 0,
                jnp.log(pinv)
                + jnp.log(jnp.where(inv_tot > 0, inv_tot, 1.0)),
                -jnp.inf,
            )
            beta = jax.nn.sigmoid(log_inv - log_var)              # (s,)
            post_inv = inv_unnorm / jnp.maximum(
                inv_tot, jnp.finfo(dtype).tiny
            )[:, None]                                            # (s,S)
            post = (
                (1.0 - beta)[None, :, None] * post
                + beta[None, :, None] * post_inv[None, :, :]
            )
        return post

    # cache the compiled program per engine (jit on a fresh closure would
    # recompile the two-pass pruning program on every call)
    if not hasattr(engine, "_ancestral_jit"):
        engine._ancestral_jit = jax.jit(compute)
    post = engine._ancestral_jit(full, engine._leaf_partials, engine._weights)
    post = np.asarray(post)[:, : engine._compressed.n_patterns, :]
    return post[:, engine._compressed.site_to_pattern, :]


def site_rate_posteriors(
    engine, params: Optional[Mapping] = None
) -> np.ndarray:
    """Posterior probability of each rate category per site: (n_sites, K)."""
    _check_engine_supported(engine, "site_rate_posteriors")
    full = engine._full_params(params)
    dtype = engine.dtype

    def compute(full, leaf_partials, weights):
        _, cat_weights, p, freqs = engine._mixture_tensors(full, dtype)
        fk = _per_cat_freqs(freqs, p.shape[1], dtype)
        root_partials, root_logscale = engine._prune(p, leaf_partials)
        lik = jnp.einsum(
            "ksi,ki->ks", root_partials, fk, precision=_HI
        )
        m = jnp.max(root_logscale, axis=0)
        gam = cat_weights[:, None] * lik * jnp.exp(root_logscale - m[None, :])
        return (gam / jnp.sum(gam, axis=0, keepdims=True)).T   # (sites, K)

    if not hasattr(engine, "_site_rate_jit"):
        engine._site_rate_jit = jax.jit(compute)
    gam = engine._site_rate_jit(full, engine._leaf_partials, engine._weights)
    gam = np.asarray(gam)[: engine._compressed.n_patterns]
    return gam[engine._compressed.site_to_pattern]


def site_rates(engine, params: Optional[Mapping] = None) -> np.ndarray:
    """Posterior-mean evolutionary rate per site (rate4site-style):
    ``r_s = sum_k gamma_{s,k} * rate_k`` — the empirical-Bayes point
    estimate of each site's relative rate under the engine's discrete
    RATE mixture. Returns (n_sites,). Note: for ``invariant_sites``
    engines this averages over the gamma categories only (the +I
    component is a separate mixture layer, not a rate category here)."""
    from phylo_utils_tpu.likelihood import rate_categories

    full = engine._full_params(params)
    gam = site_rate_posteriors(engine, params)          # (sites, K)
    rates, _ = rate_categories(engine, full, np.float64)
    return gam @ np.asarray(rates, np.float64)


def _maxprod_contract(pm, child_d):
    """Max-product "matmul" with argmax: for each parent state j,
    ``contrib[..., j] = max_i pm[..., j, i] * child_d[..., i]`` and
    ``amax[..., j] = argmax_i``.

    pm: (W, C, K, S, S); child_d: (W, C, K, sites, S) ->
    contrib/amax: (W, C, K, sites, S). Sequential ``lax.map`` over the
    parent state keeps the peak intermediate at one (W, C, K, sites, S)
    slab instead of the (sites, S, S) outer product (a 61-state codon
    model would otherwise materialize gigabytes).
    """
    def one_parent_state(j):
        scores = pm[:, :, :, None, j, :] * child_d      # (W,C,K,sites,Si)
        return jnp.max(scores, axis=-1), jnp.argmax(
            scores, axis=-1
        ).astype(jnp.int32)

    s = pm.shape[-1]
    contrib, amax = lax.map(one_parent_state, jnp.arange(s))
    # (S, W, C, K, sites) -> (W, C, K, sites, S)
    return jnp.moveaxis(contrib, 0, -1), jnp.moveaxis(amax, 0, -1)


def joint_ancestral_states(
    engine, params: Optional[Mapping] = None
) -> Dict[str, np.ndarray]:
    """Joint maximum-likelihood ancestral reconstruction (Pupko,
    Pe'er, Shamir & Graur 2000, Mol. Biol. Evol. 17:890 — the max-product
    dynamic program PAML's RateAncestor uses for joint reconstruction).

    Unlike the marginal (empirical-Bayes) posteriors, this finds the
    single assignment of states to ALL internal nodes jointly maximizing
    P(states, data) per site. Rate mixtures are handled by running the
    DP per category and selecting, per site, the (category, assignment)
    pair maximizing w_k * P(states, data | r_k). For ``invariant_sites``
    engines the +I component competes too: its weight is ``pinv`` (the
    gamma categories get ``(1 - pinv) * w_k``), its transition matrices
    are the identity, so its best assignment is the single state x
    maximizing pi_x * prod_leaves partial[x] (−inf on sites no single
    state can explain).

    Returns {"states": (n_internal, n_sites) int32 — ordered by internal
    node id, root last; "log_prob": (n_sites,) joint log P(states, data);
    "category": (n_sites,) winning rate-category index, where the value
    ``ncat`` denotes the invariant (+I) component}.
    """
    _check_engine_supported(engine, "joint_ancestral_states")
    schedule = engine.schedule
    full = engine._full_params(params)
    dtype = engine.dtype

    def compute(full, leaf_partials, weights):
        _, cat_weights, p, freqs = engine._mixture_tensors(full, dtype)
        n = schedule.n_nodes
        k = p.shape[1]
        sites = leaf_partials.shape[1]
        s = leaf_partials.shape[2]
        tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)

        # post-order max-product: d[v][j] = max prob of subtree(v) given
        # state(v)=j (rescaled); a[v][j] = argmax of v's state given its
        # PARENT is in state j
        d = jnp.zeros((n + 1, k, sites, s), dtype)
        d = d.at[: schedule.n_leaves].set(leaf_partials[:, None, :, :])
        a = jnp.zeros((n + 1, k, sites, s), jnp.int32)
        logscale = jnp.zeros((n + 1, k, sites), dtype)
        for lvl in range(schedule.n_levels):
            nodes = schedule.level_nodes[lvl]
            children = schedule.level_children[lvl]
            mask = schedule.level_childmask[lvl]
            child_d = d[children]                   # (W, C, K, sites, S)
            pm = p[children]                        # (W, C, K, S, S)
            contrib, amax = _maxprod_contract(pm, child_d)
            mb = mask[:, :, None, None, None].astype(dtype)
            contrib = contrib * mb + (1.0 - mb)
            dv = jnp.prod(contrib, axis=1)          # (W, K, sites, S)
            sc = jnp.sum(
                logscale[children] * mask[:, :, None, None], axis=1
            )
            m = jnp.maximum(jnp.max(dv, axis=-1), tiny)
            d = d.at[nodes].set(dv / m[..., None])
            logscale = logscale.at[nodes].set(sc + jnp.log(m))
            # scatter each child's argmax table (padding -> trash row)
            flat_children = children.reshape(-1)
            flat_mask = mask.reshape(-1)
            tgt = jnp.where(flat_mask > 0, flat_children, n)
            flat_amax = amax.reshape((-1,) + amax.shape[2:])
            a = a.at[tgt].set(
                jnp.where(
                    flat_mask[:, None, None, None] > 0, flat_amax, a[tgt]
                )
            )

        # root decision + per-category joint log prob
        fk = _per_cat_freqs(freqs, k, dtype)
        root_scores = fk[:, None, :] * d[schedule.root]
        root_state = jnp.argmax(root_scores, axis=-1).astype(
            jnp.int32
        )                                                      # (K, sites)
        lj = (
            jnp.log(jnp.maximum(jnp.max(root_scores, axis=-1), tiny))
            + logscale[schedule.root]
        )                                                      # (K, sites)

        # backtrack pre-order: children read their parent's chosen state
        states = jnp.zeros((n + 1, k, sites), jnp.int32)
        states = states.at[schedule.root].set(root_state)
        for lvl in range(schedule.n_levels - 1, -1, -1):
            nodes = schedule.level_nodes[lvl]
            children = schedule.level_children[lvl]
            mask = schedule.level_childmask[lvl]
            ps = states[nodes]                      # (W, K, sites)
            ca = a[children]                        # (W, C, K, sites, S)
            child_state = jnp.take_along_axis(
                ca, ps[:, None, :, :, None], axis=-1
            )[..., 0]                               # (W, C, K, sites)
            flat_children = children.reshape(-1)
            flat_mask = mask.reshape(-1)
            tgt = jnp.where(flat_mask > 0, flat_children, n)
            flat_vals = child_state.reshape((-1,) + child_state.shape[2:])
            states = states.at[tgt].set(
                jnp.where(flat_mask[:, None, None] > 0, flat_vals,
                          states[tgt])
            )

        # per-site winning category: max_k log(w_k) + log joint_k
        log_w = jnp.log(cat_weights.astype(dtype))[:, None]
        pinv = (
            full.get("pinv") if getattr(engine, "invariant_sites", False)
            else None
        )
        if pinv is not None:
            pinv = jnp.asarray(pinv, dtype)
            log_w = log_w + jnp.log1p(-pinv)
        score_k = log_w + lj
        best_k = jnp.argmax(score_k, axis=0)                    # (sites,)
        log_prob = jnp.max(score_k, axis=0)
        internal = slice(schedule.n_leaves, schedule.n_real_nodes)
        sel = jnp.take_along_axis(
            states[internal], best_k[None, None, :], axis=1
        )[:, 0, :]                                              # (I, sites)
        best_k = best_k.astype(jnp.int32)
        if pinv is not None:
            # +I component: identity P forces every node to one state x;
            # joint prob = pinv * pi_bar_x * prod_leaves partial[l, s, x]
            prod = jnp.prod(leaf_partials.astype(dtype), axis=0)  # (sites,S)
            fbar = jnp.einsum("k,ki->i", cat_weights.astype(dtype), fk,
                              precision=_HI)
            inv_scores = fbar[None, :] * prod
            inv_state = jnp.argmax(inv_scores, axis=-1).astype(jnp.int32)
            inv_max = jnp.max(inv_scores, axis=-1)
            inv_lp = jnp.where(
                inv_max > 0.0,
                jnp.log(pinv) + jnp.log(jnp.maximum(inv_max, tiny)),
                -jnp.inf,
            )
            inv_wins = inv_lp > log_prob
            n_int = schedule.n_real_nodes - schedule.n_leaves
            sel = jnp.where(
                inv_wins[None, :],
                jnp.broadcast_to(inv_state[None, :], (n_int, sel.shape[1])),
                sel,
            )
            log_prob = jnp.maximum(log_prob, inv_lp)
            best_k = jnp.where(inv_wins, jnp.int32(k), best_k)
        return sel, log_prob, best_k

    if not hasattr(engine, "_joint_anc_jit"):
        engine._joint_anc_jit = jax.jit(compute)
    sel, log_prob, best_k = engine._joint_anc_jit(
        full, engine._leaf_partials, engine._weights
    )
    npat = engine._compressed.n_patterns
    s2p = engine._compressed.site_to_pattern
    return {
        "states": np.asarray(sel)[:, :npat][:, s2p],
        "log_prob": np.asarray(log_prob)[:npat][s2p],
        "category": np.asarray(best_k)[:npat][s2p],
    }
