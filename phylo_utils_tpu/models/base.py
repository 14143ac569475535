"""Rate-matrix construction and reversible eigendecomposition (pure jnp).

Mirrors the reference's construction (SURVEY.md §3.1 [HIGH]):
Q = S * diag(pi), diagonal = -rowsum, normalized so the mean equilibrium rate
is 1 (branch lengths in expected substitutions/site); reversible models are
diagonalized via the pi^{1/2} symmetrization + ``eigh``, then de-symmetrized.

Everything is differentiable: ``eigh`` has a JAX gradient, so model-parameter
gradients flow through the eigendecomposition into P(t).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Eigen",
    "Model",
    "normalize_q",
    "build_rate_matrix",
    "eigen_reversible",
    "stationary_from_q",
]


class Eigen(NamedTuple):
    """Eigendecomposition of a (reversible) rate matrix Q = V diag(evals) Vi,
    plus the equilibrium frequencies. For non-reversible models ``evals`` is
    None and ``q`` is used directly with expm."""

    evals: Optional[jnp.ndarray]   # (S,)
    evecs: Optional[jnp.ndarray]   # (S, S) = V
    ivecs: Optional[jnp.ndarray]   # (S, S) = V^-1
    freqs: jnp.ndarray             # (S,)
    q: jnp.ndarray                 # (S, S) normalized rate matrix
    # Precomputed spectral reconstruction modes:
    # recon[k, i, j] = V[i, k] * Vi[k, j], so
    # P(t) = sum_k e^{lambda_k t} recon[k] — ONE small matmul
    # (edges*cats, S) @ (S, S*S) per evaluation instead of a 3-operand
    # einsum. Computed once with the eigendecomposition (it shares the
    # eigen system's lifetime and cache); None for non-reversible models.
    recon: Optional[jnp.ndarray] = None


def normalize_q(q: jnp.ndarray, freqs: jnp.ndarray) -> jnp.ndarray:
    """Set diagonal to -rowsum and scale so -sum_i pi_i Q_ii == 1."""
    s = q.shape[-1]
    off = q * (1.0 - jnp.eye(s, dtype=q.dtype))
    q = off - jnp.diag(jnp.sum(off, axis=1))
    scale = -jnp.sum(freqs * jnp.diagonal(q))
    return q / scale


def build_rate_matrix(sym_rates: jnp.ndarray, freqs: jnp.ndarray) -> jnp.ndarray:
    """Q from symmetric exchangeabilities S and frequencies pi (normalized)."""
    return normalize_q(sym_rates * freqs[None, :], freqs)


# When True, the symmetric eigendecomposition runs as a host callback in
# float64 (LAPACK) regardless of the on-device compute dtype. Semantically
# transparent: no gradient is ever taken through the factorization —
# p_matrices_reversible's Daleckii-Krein custom JVP consumes it as primal
# values only. Default False: the on-device eigh is not the accuracy
# bottleneck of P(t) (the f32 application of e^{lambda t} dominates), and a
# host callback puts a device->host round trip on every model rebuild.
# Host callbacks work on GPU and CPU backends; flip on if a model with an
# ill-conditioned Q needs LAPACK-quality factorization.
HOST_EIGH = False


def _eigh_host(b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """eigh via host callback, computed in float64, cast to b.dtype."""
    s = b.shape[-1]
    dt = b.dtype

    def _h(b_np):
        w, u = np.linalg.eigh(np.asarray(b_np, np.float64))
        return w.astype(dt), u.astype(dt)

    return jax.pure_callback(
        _h,
        (jax.ShapeDtypeStruct((s,), dt), jax.ShapeDtypeStruct((s, s), dt)),
        b,
        vmap_method="sequential",
    )


@jax.custom_batching.custom_vmap
def _eigh_f64_seq(b: jnp.ndarray):
    """f64 eigh that NEVER lowers to a batched eigh kernel.

    Guard kept from the accelerator this engine was first built for, whose
    emulated-f64 eigh returned all-NaN eigenpairs for specific
    WELL-CONDITIONED 4x4 inputs when vmapped/batched — the identical
    matrix decomposes fine unbatched (regression exhibit: the saved
    /tmp-era matrix is reproduced in tests/test_eigh_robustness.py).
    sequential_vmap lowers any vmapped call to a lax.map of unbatched
    eighs, which sidesteps the batched kernel entirely; model builds
    decompose one tiny (S, S) matrix per class/locus, so the
    serialization costs nothing measurable next to P(t) reconstruction.
    """
    w, u = jnp.linalg.eigh(b)
    return w, u    # plain tuple (not EighResult): the vmap rule's
    # batching spec must match the output pytree structure exactly


@_eigh_f64_seq.def_vmap
def _eigh_f64_seq_vmap(axis_size, in_batched, b):
    # hand-rolled sequential_vmap with a size-0 escape: lax.map's scan
    # rejects empty carries ("no values to scan over"), and jacobian/SE
    # machinery does produce zero-size batch axes
    (batched,) = in_batched
    if not batched:
        # plain eigh, NOT the wrapped fn: re-entering the custom fn with
        # an unbatched arg from inside its own rule recurses forever
        # (jacfwd/hessian hit this); an unbatched arg lowers the
        # unbatched kernel anyway.
        w, u = jnp.linalg.eigh(b)
        return (w, u), (False, False)
    if axis_size == 0:
        w, u = jnp.linalg.eigh(b)                 # nothing to compute
        return (w, u), (True, True)
    # map the WRAPPED fn: nested vmaps must sequentialize every level
    return jax.lax.map(_eigh_f64_seq, b), (True, True)


def eigen_reversible(
    sym_rates: jnp.ndarray, freqs: jnp.ndarray, host: Optional[bool] = None
) -> Eigen:
    """Diagonalize the reversible Q via similarity to a symmetric matrix.

    B = diag(sqrt(pi)) Q diag(1/sqrt(pi)) is symmetric for reversible Q;
    eigh(B) -> (w, U); V = diag(1/sqrt(pi)) U, V^-1 = U^T diag(sqrt(pi)).
    ``host=None`` uses the module default ``HOST_EIGH`` (see above).
    """
    q = build_rate_matrix(sym_rates, freqs)
    sqrtp = jnp.sqrt(freqs)
    b = (sqrtp[:, None] * q) / sqrtp[None, :]
    b = 0.5 * (b + b.T)  # exact symmetry against rounding
    if b.dtype == jnp.float64:
        # An emulated-f64 eigh (seen on the accelerator this engine was
        # first built for) returned NaN eigenpairs for certain exactly-tied
        # degenerate matrices (a doubly-degenerate 4x4 B from f32-rounded
        # duplicate GTR rates: evals came back [ok, ok, nan, nan]). A deterministic GRADED
        # diagonal perturbation of ~1e-13 x scale breaks the ties; the
        # eigenvalue shift is <= S*1e-13*|Q| — orders of magnitude inside
        # the 1e-6 logL budget (and below the f64 oracle gates). f32 eigh
        # does not exhibit the failure and gets no jitter (1e-13 would
        # round away anyway).
        scale = jnp.max(jnp.abs(b))
        s = b.shape[-1]
        b = b + jnp.diag(
            jnp.arange(s, dtype=b.dtype) * (1e-13 * scale / max(s - 1, 1))
        )
    if host if host is not None else HOST_EIGH:
        w, u = _eigh_host(b)
    elif b.dtype == jnp.float64:
        w, u = _eigh_f64_seq(b)
    else:
        w, u = jnp.linalg.eigh(b)
    v = u / sqrtp[:, None]
    vi = u.T * sqrtp[None, :]
    recon = v.T[:, :, None] * vi[:, None, :]       # (S modes, S, S)
    return Eigen(evals=w, evecs=v, ivecs=vi, freqs=freqs, q=q, recon=recon)


def stationary_from_q(q: jnp.ndarray) -> jnp.ndarray:
    """Stationary distribution of a general rate matrix: solve pi Q = 0,
    sum(pi) = 1 via a bordered linear system (differentiable)."""
    s = q.shape[-1]
    a = jnp.concatenate([q.T, jnp.ones((1, s), q.dtype)], axis=0)  # (S+1, S)
    b = jnp.concatenate([jnp.zeros((s,), q.dtype), jnp.ones((1,), q.dtype)])
    pi, *_ = jnp.linalg.lstsq(a, b)
    return pi


@dataclasses.dataclass(frozen=True)
class Model:
    """A substitution model spec.

    ``build`` maps a parameter PyTree (a dict) to either
    ``(sym_rates, freqs)`` for reversible models, or a raw (normalized) ``q``
    with its stationary ``freqs`` for non-reversible ones.
    """

    name: str
    n_states: int
    alphabet: str                      # "dna" | "protein" | ...
    param_defaults: Mapping[str, object]
    build: Callable[..., Tuple[jnp.ndarray, jnp.ndarray]]
    reversible: bool = True

    def defaults(self, dtype=jnp.float64) -> dict:
        return {
            k: jnp.asarray(v, dtype=dtype) for k, v in self.param_defaults.items()
        }

    def _merged(self, params: Optional[Mapping], dtype) -> dict:
        p = dict(self.param_defaults)
        if params:
            p.update(params)
        if dtype is not None:
            return {k: jnp.asarray(v, dtype=dtype) for k, v in p.items()}
        return {k: jnp.asarray(v) for k, v in p.items()}

    def build_parts(
        self, params: Optional[Mapping] = None, dtype=None
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(sym_rates, freqs) for reversible models; (Q, freqs) otherwise."""
        return self.build(**self._merged(params, dtype))

    def eigen(self, params: Optional[Mapping] = None, dtype=None) -> Eigen:
        """Parameter PyTree -> Eigen (or expm-ready Q for non-reversible)."""
        if self.reversible:
            sym, freqs = self.build_parts(params, dtype)
            return eigen_reversible(sym, freqs)
        q, freqs = self.build_parts(params, dtype)
        return Eigen(evals=None, evecs=None, ivecs=None, freqs=freqs, q=q)
