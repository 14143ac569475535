"""Batched transition matrices P(t) and their time-derivatives.

Reference parity: phylo_utils/markov.py ``TransitionMatrix`` —
P(t) = V diag(e^{lambda t}) V^-1, dP/dt = Q P, d2P/dt2 = Q^2 P
(SURVEY.md §2/§3.3 [MED symbol names, HIGH mechanism]).

Batched: ``t`` may have arbitrary batch shape (edges x rate-categories);
the whole batch is one fused einsum on device. HIGHEST precision is requested
so f32 runs keep the 1e-6 logL budget (SURVEY.md §7 hard part 1). For
non-reversible models (Eigen.evals is None) a scaling-and-squaring expm is
used — still batched and differentiable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from phylo_utils_tpu.models.base import Eigen, build_rate_matrix, eigen_reversible

__all__ = [
    "transition_matrices",
    "dp_matrices",
    "d2p_matrices",
    "p_matrices_reversible",
    "extend_p_identity",
]

_HI = lax.Precision.HIGHEST


def extend_p_identity(p: jnp.ndarray, n_total: int) -> jnp.ndarray:
    """Append exact-identity P blocks for binarization pseudo-nodes.

    ``trees.compile_schedule(binarize=True)`` splits multifurcations into
    binary combines through pseudo-nodes (ids >= n_real). Their "edge" is
    a structural zero-length connection whose transition matrix is the
    EXACT identity — not ``P(0)`` reconstructed through the
    eigendecomposition, which carries f32 rounding — so the pruning
    product through a pseudo-node is a bit-exact pass-through and the
    appended blocks contribute no gradient (the cotangent of a broadcast
    constant is discarded).

    ``p``: (..., n_real, K, S, S) -> (..., n_total, K, S, S).
    """
    extra = n_total - p.shape[-4]
    if extra <= 0:
        return p
    s = p.shape[-1]
    eye = jnp.broadcast_to(
        jnp.eye(s, dtype=p.dtype), p.shape[:-4] + (extra,) + p.shape[-3:]
    )
    return jnp.concatenate([p, eye], axis=-4)


def transition_matrices(
    eig: Eigen, t: jnp.ndarray, out_dtype=None
) -> jnp.ndarray:
    """P(t) for a batch of times. t: (...,) -> P: (..., S, S).

    ``out_dtype``: dtype of the RECONSTRUCT step (and the returned P).
    Latency lever for f32 engines under x64: the eigenvalue
    exponentials e^{lambda t} stay in ``t``'s dtype (f64 — the exp is the
    coherent-error source: a biased e^{lambda t} acts like a systematic
    branch-length perturbation across every site), but the spectral-mode
    matmul runs in ``out_dtype`` (f32), whose rounding is incoherent
    across P entries and vanishes in the pattern sum. This removes the
    f64 reconstruct AND the separate downcast of the full
    (edges, K, S, S) tensor from the per-evaluation path.
    """
    t = jnp.asarray(t)
    if eig.evals is None:
        qt = eig.q * t[..., None, None]
        flat = qt.reshape((-1,) + qt.shape[-2:])
        p = jax.vmap(jax.scipy.linalg.expm)(flat)
        # same nonnegativity clamp as the eigen path below: f32
        # scaling-and-squaring can also round tiny entries negative
        p = jnp.maximum(p.reshape(t.shape + eig.q.shape), 0.0)
        return p if out_dtype is None else p.astype(out_dtype)
    # exp(lambda * t): (..., S)
    ew = jnp.exp(eig.evals * t[..., None])
    if eig.recon is not None:
        recon = eig.recon
        if out_dtype is not None:
            ew = ew.astype(out_dtype)
            recon = recon.astype(out_dtype)
        # P(t) = sum_k e^{lambda_k t} * recon[k]: one (batch, S) x
        # (S, S*S) contraction — the modes are precomputed with the eigen
        # system, so the per-eval work is a single small matmul
        p = jnp.einsum("...k,kij->...ij", ew, recon, precision=_HI)
    else:
        # (V * ew) @ Vi, batched over leading dims of t
        p = jnp.einsum(
            "ik,...k,kj->...ij", eig.evecs, ew, eig.ivecs, precision=_HI
        )
        if out_dtype is not None:
            p = p.astype(out_dtype)
    # True transition probabilities are >= 0, but the f32 eigen
    # reconstruction rounds tiny off-diagonals slightly negative for
    # near-zero t (measured -3.8e-7 for the 61-state codon model), which
    # can flip a site likelihood negative deep in the pruning product and
    # surface as log(negative)=NaN. Clamp to the mathematical domain.
    return jnp.maximum(p, 0.0)


def _exp_divided_difference(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """phi(x, y) = (e^x - e^y)/(x - y), continuously extended to e^x at x==y.

    Stable form: e^{(x+y)/2} * sinh(d)/d with d=(x-y)/2, series for small d.
    """
    d = 0.5 * (x - y)
    mid = 0.5 * (x + y)
    small = jnp.abs(d) < 1e-5
    # sinh(d)/d ~ 1 + d^2/6 + d^4/120
    sinhc = jnp.where(
        small,
        1.0 + d * d / 6.0 * (1.0 + d * d / 20.0),
        jnp.sinh(jnp.where(small, 1.0, d)) / jnp.where(small, 1.0, d),
    )
    return jnp.exp(mid) * sinhc


@jax.custom_jvp
def p_matrices_reversible(sym: jnp.ndarray, freqs: jnp.ndarray,
                          t: jnp.ndarray) -> jnp.ndarray:
    """P(t) = expm(Q(sym, freqs) * t) for reversible models, batched over t.

    Equivalent in value to ``transition_matrices(eigen_reversible(sym, freqs),
    t)`` but with a custom JVP using the Daleckii-Krein divided-difference
    formula for the Frechet derivative of expm. Plain autodiff through
    ``eigh`` produces wrong/NaN model-parameter gradients whenever Q has
    degenerate eigenvalues (JC69/K80/F81 all do — the eigh JVP has
    1/(lambda_i - lambda_j) terms); the divided-difference form is exact and
    smooth through degeneracies.
    """
    eig = eigen_reversible(sym, freqs)
    return transition_matrices(eig, t)


@p_matrices_reversible.defjvp
def _p_matrices_reversible_jvp(primals, tangents):
    sym, freqs, t = primals
    dsym, dfreqs, dt = tangents
    eig = eigen_reversible(sym, freqs)
    lam, v, vi, q = eig.evals, eig.evecs, eig.ivecs, eig.q
    t = jnp.asarray(t)
    ew = jnp.exp(lam * t[..., None])
    p = jnp.einsum("ik,...k,kj->...ij", v, ew, vi, precision=_HI)
    p = jnp.maximum(p, 0.0)  # keep the primal consistent with
    # transition_matrices' nonnegativity clamp (see comment there)

    _, dq = jax.jvp(build_rate_matrix, (sym, freqs), (dsym, dfreqs))
    # dA = d(Q t) = dQ * t + Q * dt, in the eigenbasis of A = Q t
    da = dq * t[..., None, None] + q * jnp.asarray(dt)[..., None, None]
    m = jnp.einsum("ik,...kl,lj->...ij", vi, da, v, precision=_HI)
    g = _exp_divided_difference(
        lam[..., :, None] * t[..., None, None],
        lam[..., None, :] * t[..., None, None],
    )
    dp = jnp.einsum("ik,...kl,lj->...ij", v, g * m, vi, precision=_HI)
    return p, dp


def dp_matrices(eig: Eigen, t: jnp.ndarray) -> jnp.ndarray:
    """dP/dt = Q P(t) (used by Newton branch-length optimization)."""
    p = transition_matrices(eig, t)
    return jnp.einsum("ik,...kj->...ij", eig.q, p, precision=_HI)


def d2p_matrices(eig: Eigen, t: jnp.ndarray) -> jnp.ndarray:
    """d2P/dt2 = Q^2 P(t)."""
    p = transition_matrices(eig, t)
    q2 = jnp.einsum("ik,kj->ij", eig.q, eig.q, precision=_HI)
    return jnp.einsum("ik,...kj->...ij", q2, p, precision=_HI)
