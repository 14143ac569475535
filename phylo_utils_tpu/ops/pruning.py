"""Felsenstein pruning as a level-scheduled, batched XLA computation.

Reference parity: phylo_utils/likcalc.pyx ``likvec_2desc``/``likvec_1desc``
(per-node C loops over sites x states), per-node rescaling, and the sitewise
root reduction (SURVEY.md §2/§3.2 [HIGH]).

Redesign for an accelerator: instead of a Python post-order walk calling a
C kernel per node, the topology's level schedule (trees.compile_schedule)
is baked into the trace as constant index arrays; each level combines ALL
its nodes for ALL rate categories in one batched einsum over
(width x children x categories x sites x states), with unconditional
per-(category, site) rescaling. The per-category Python loop of the
reference becomes a tensor axis; the per-node loop becomes a gather/scatter
on one partials buffer. Sites are the data-parallel axis: every op here is
elementwise or a gather/scatter on non-site axes, so under a
``NamedSharding(P(..., 'sites', ...))`` the pass runs shard-local and only
the final weighted sum needs a psum.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from phylo_utils_tpu.trees import PruningSchedule

__all__ = [
    "make_prune_fn",
    "mixture_loglik",
    "invariant_site_likelihood",
    "pow2_rescale",
    "exp2_int",
    "LN2",
    "DP_BLOCK",
]

_HI = lax.Precision.HIGHEST

LN2 = float(np.log(2.0))


def pow2_rescale(m):
    """EXACT power-of-two rescale of a positive f32 tensor.

    Returns ``(scale, e)`` with ``scale = 2**-e`` bit-assembled from m's
    binary exponent (``e = floor(log2(m))``), so ``x * scale`` is an
    EXACT f32 operation and the accumulated scale exponents are exact
    small integers (stored in f32; adds are exact below 2^24).

    Why: the scale exponents are exact integers, so the rescale chain has
    no transcendental and no rounding in it, whatever the accuracy of the
    device's f32 ``log``. Accumulating an f32 ``log(m)`` per pruning node
    instead adds one rounding per node to every sitewise logL. The single
    exponent-count -> ln conversion happens once at the root, in the
    reduction dtype.
    """
    # np.int32 literals: Python ints trace as i64 under jax_enable_x64
    i32 = np.int32
    bits = jax.lax.bitcast_convert_type(m, jnp.int32)
    eb = jnp.right_shift(bits, i32(23)) & i32(0xFF)
    eb = jnp.minimum(jnp.maximum(eb, i32(1)), i32(253))
    scale = jax.lax.bitcast_convert_type(
        jnp.left_shift(i32(254) - eb, i32(23)), jnp.float32
    )
    return scale, (eb - i32(127)).astype(jnp.float32)


def exp2_int(k):
    """Exact ``2**k`` for an integer-VALUED f32 tensor (bit assembly)."""
    i32 = np.int32
    kf = jnp.minimum(jnp.maximum(k, jnp.float32(-126.0)), jnp.float32(127.0))
    ki = kf.astype(jnp.int32)
    return jax.lax.bitcast_convert_type(
        jnp.left_shift(ki + i32(127), i32(23)), jnp.float32
    )


# Sites per block of the gradient's dP contraction (``_child_messages``).
DP_BLOCK = 1024


@jax.custom_jvp
def _child_messages(p, child):
    """``sum_j P[w,c,k,i,j] * child[w,c,k,s,j]``: each child's partials
    carried up its edge, for every (node, child, category, site)."""
    return jnp.einsum("wckij,wcksj->wcksi", p, child, precision=_HI)


def _blocked_messages(dp, child):
    """``_child_messages(dp, child)`` with the sites split into blocks of
    DP_BLOCK and ``dp`` broadcast over the blocks. The same product; what
    differs is its transpose, the gradient's dP: one short contraction per
    block, then a sum over blocks.

    As one GEMM with the sites as its contraction, a GPU accumulates dP in
    f32 along the whole site axis, and the f32 gradient lost precision
    faster than the site count grew (2e-4 relative to the f64 gradient at
    100,000 patterns on an H100; 7e-7 in blocks, and no slower)."""
    w, c, k, s, n = child.shape
    if s <= DP_BLOCK:
        return _child_messages(dp, child)
    pad = (-s) % DP_BLOCK
    if pad:     # zero sites add nothing to dP (sharded engines pad whole
        # blocks per device, so this copy never splits a shard)
        child = jnp.pad(child, ((0, 0),) * 3 + ((0, pad), (0, 0)))
    nb = (s + pad) // DP_BLOCK
    blocks = child.reshape(w, c, k, nb, DP_BLOCK, n)
    dpb = jnp.broadcast_to(dp[:, :, :, None], (w, c, k, nb, n, n))
    out = jnp.einsum("wckbij,wckbsj->wckbsi", dpb, blocks, precision=_HI)
    return out.reshape(w, c, k, nb * DP_BLOCK, n)[:, :, :, :s]


def _child_messages_jvp(primals, tangents):
    p, child = primals
    dp, dchild = tangents
    out = _child_messages(p, child)
    zero = jax.custom_derivatives.SymbolicZero
    t = None
    if type(dchild) is not zero:
        t = _child_messages(p, dchild)
    if type(dp) is not zero:
        t_p = _blocked_messages(dp, child)
        t = t_p if t is None else t + t_p
    return out, jnp.zeros_like(out) if t is None else t


_child_messages.defjvp(_child_messages_jvp, symbolic_zeros=True)


def make_prune_fn(
    schedule: PruningSchedule,
    unroll: bool = True,
    remat: bool = False,
) -> Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]:
    """Compile a pruning schedule into a jit-able pure function.

    Returns ``prune(p_matrices, leaf_partials) -> (root_partials, root_logscale)``
    with shapes:

    - ``p_matrices``   (n_nodes, K, S, S) — P for the edge above each node
      (root row unused),
    - ``leaf_partials`` (n_leaves, sites, S),
    - ``root_partials`` (K, sites, S), ``root_logscale`` (K, sites).

    The schedule's index arrays are embedded as constants, so XLA sees static
    gather/scatter indices; recompilation happens only on topology change.
    ``unroll=True`` unrolls the level loop at trace time (best for autodiff:
    residual memory stays O(total nodes), not O(levels x buffer)); otherwise
    a ``lax.scan`` over padded levels is used (faster compiles for very deep
    trees, forward-only workloads). ``remat=True`` wraps each level in
    ``jax.checkpoint`` so autodiff recomputes level activations instead of
    storing the full (n_nodes+1, K, sites, S) residual chain — trades ~1
    extra forward pass for O(depth) less gradient memory on deep trees.
    """
    nodes_np = np.asarray(schedule.level_nodes)
    children_np = np.asarray(schedule.level_children)
    mask_np = np.asarray(schedule.level_childmask)
    n_nodes = schedule.n_nodes
    n_leaves = schedule.n_leaves
    root = schedule.root

    def prune(p_matrices: jnp.ndarray, leaf_partials: jnp.ndarray):
        dtype = leaf_partials.dtype
        k = p_matrices.shape[1]
        sites = leaf_partials.shape[1]
        s = leaf_partials.shape[2]
        tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)

        # buffer rows: [leaves | internals | trash]; categories broadcast at leaves
        buf = jnp.zeros((n_nodes + 1, k, sites, s), dtype)
        buf = buf.at[:n_leaves].set(leaf_partials[:, None, :, :].astype(dtype))
        logscale = jnp.zeros((n_nodes + 1, k, sites), dtype)

        def level_step(carry, level):
            buf, logscale = carry
            nodes, children, mask = level
            child_p = buf[children]          # (W, C, K, sites, S)
            child_sc = logscale[children]    # (W, C, K, sites)
            p = p_matrices[children]         # (W, C, K, S, S)
            contrib = _child_messages(p, child_p)
            mask_b = mask[:, :, None, None, None].astype(dtype)
            contrib = contrib * mask_b + (1.0 - mask_b)
            partial = jnp.prod(contrib, axis=1)                     # (W,K,sites,S)
            sc = jnp.sum(child_sc * mask[:, :, None, None], axis=1)  # (W,K,sites)
            m = jnp.maximum(jnp.max(partial, axis=-1), tiny)
            if dtype == jnp.float32:
                # exact power-of-2 rescale (see pow2_rescale): logscale
                # accumulates binary EXPONENT COUNTS here, converted to
                # ln units once at the root below
                scale, e = pow2_rescale(m)
                partial = partial * scale[..., None]
                sc = sc + e
            else:
                partial = partial / m[..., None]
                sc = sc + jnp.log(m)
            buf = buf.at[nodes].set(partial)
            logscale = logscale.at[nodes].set(sc)
            return (buf, logscale), None

        step = level_step
        if remat:
            step = jax.checkpoint(level_step, static_argnums=())
        if unroll:
            carry = (buf, logscale)
            for lvl in range(nodes_np.shape[0]):
                carry, _ = step(
                    carry, (nodes_np[lvl], children_np[lvl], mask_np[lvl])
                )
            buf, logscale = carry
        else:
            (buf, logscale), _ = lax.scan(
                step,
                (buf, logscale),
                (jnp.asarray(nodes_np), jnp.asarray(children_np),
                 jnp.asarray(mask_np)),
            )
        root_sc = logscale[root]
        if dtype == jnp.float32:
            root_sc = (
                root_sc.astype(jnp.result_type(float)) * LN2
            ).astype(dtype)
        return buf[root], root_sc

    return prune


def invariant_site_likelihood(
    leaf_partials: jnp.ndarray, freqs: jnp.ndarray
) -> jnp.ndarray:
    """Per-site likelihood of the zero-rate (invariant) component:
    sum_i pi_i * prod_leaves leaf_partials[l, s, i]. (sites,)"""
    prod = jnp.prod(leaf_partials, axis=0)  # (sites, S)
    return jnp.matmul(prod, freqs.astype(prod.dtype), precision=_HI)


def mixture_loglik(
    root_partials: jnp.ndarray,     # (K, sites, S)
    root_logscale: jnp.ndarray,     # (K, sites)
    freqs: jnp.ndarray,             # (S,)
    cat_weights: jnp.ndarray,       # (K,)
    pattern_weights: jnp.ndarray,   # (sites,)
    pinv: Optional[jnp.ndarray] = None,
    inv_lik: Optional[jnp.ndarray] = None,   # (sites,) required with pinv
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Root reduction + rate-category mixing with scale re-alignment.

    Mirrors the reference's linear-space mixing of per-category sitewise
    likelihoods under shared scaling (SURVEY.md §3.2), with an optional
    invariant-sites component L_s = pinv*I_s + (1-pinv)*sum_c w_c L_{s,c}.

    Returns (total_loglik, sitewise_loglik). The total is the weighted sum
    over (possibly sharded) patterns — under a mesh this is the single psum.
    """
    dtype = root_partials.dtype
    site_lik = jnp.einsum(
        "ksi,i->ks", root_partials, freqs.astype(dtype), precision=_HI
    )
    m = jnp.max(root_logscale, axis=0)  # (sites,)
    mixed = jnp.sum(
        cat_weights[:, None].astype(dtype)
        * site_lik
        * jnp.exp(root_logscale - m[None, :]),
        axis=0,
    )
    if pinv is not None:
        sitewise = _mix_invariant(jnp.log(mixed) + m, pinv, inv_lik, dtype)
    else:
        sitewise = jnp.log(mixed) + m
    total = jnp.sum(pattern_weights.astype(dtype) * sitewise)
    return total, sitewise


def _mix_invariant(log_var, pinv, inv_lik, dtype):
    """+I mixing in log space: L_s = pinv*I_s + (1-pinv)*L_var,s."""
    if inv_lik is None:
        raise ValueError("inv_lik is required when pinv is given")
    pinv = jnp.asarray(pinv, dtype)
    # variable sites have inv_lik == 0: their +I component is exactly
    # -inf in log space (clamping to `tiny` would floor sitewise logL at
    # log(pinv) + log(tiny), a real error in float32). NaN-safe where().
    inv_lik = inv_lik.astype(dtype)
    log_inv = jnp.where(
        inv_lik > 0,
        jnp.log(jnp.where(inv_lik > 0, inv_lik, 1.0)),
        -jnp.inf,
    )
    return jnp.logaddexp(
        jnp.log1p(-pinv) + log_var, jnp.log(pinv) + log_inv
    )
