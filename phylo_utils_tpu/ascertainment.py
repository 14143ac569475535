"""Ascertainment-bias correction (+ASC): likelihoods conditioned on
variable sites.

Morphological matrices (and SNP alignments) contain only characters that
vary — constant sites are never collected — so an uncorrected model
overestimates branch lengths (Lewis 2001, Syst Biol 50:913). The
correction conditions every site likelihood on being variable:

    L_corrected(site) = L(site) / (1 - V),   V = sum_s L(constant_s)

The reference library has no ascertainment support (SURVEY.md §2); this
is a capability extension. Batched design: the S constant patterns are
APPENDED to the pattern tensor with weight 0, so V comes out of the same
single fused pruning dispatch as the data patterns — no second tree
walk, fully differentiable, works under site sharding.

Corrections:

- ``lewis``       — condition on variability (the default; IQ-TREE +ASC).
- ``felsenstein`` — ``const_counts`` gives the TOTAL number of constant
  sites removed from the original alignment (identity unknown): adds
  ``c * log(V)``.
- ``stamatakis``  — ``const_counts`` gives the per-state counts of the
  removed constant sites: adds ``sum_s c_s * log L(constant_s)``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu import io as pio
from phylo_utils_tpu.likelihood import LikelihoodEngine

__all__ = ["AscertainmentEngine"]

_CORRECTIONS = ("lewis", "felsenstein", "stamatakis")


class AscertainmentEngine(LikelihoodEngine):
    """:class:`LikelihoodEngine` with an ascertainment-bias correction.

    Same constructor as the base engine plus ``correction`` and (for the
    felsenstein/stamatakis variants) ``const_counts``. ``invariant_sites``
    is rejected: a +I mixture contradicts conditioning on variability.
    """

    def __init__(
        self,
        tree,
        alignment,
        model,
        correction: str = "lewis",
        const_counts: Optional[Union[float, Sequence[float]]] = None,
        **kwargs,
    ):
        if correction not in _CORRECTIONS:
            raise ValueError(
                f"unknown ascertainment correction {correction!r}; "
                f"expected one of {_CORRECTIONS}"
            )
        if kwargs.get("invariant_sites"):
            raise ValueError(
                "+I cannot be combined with an ascertainment correction "
                "(invariant sites are unobservable by construction)"
            )
        self.correction = correction
        s = model.n_states

        if correction == "lewis":
            if const_counts is not None:
                raise ValueError("const_counts is only for the "
                                 "felsenstein/stamatakis corrections")
            self._const_counts = None
        elif correction == "felsenstein":
            c = float(const_counts if const_counts is not None else 0.0)
            if c < 0:
                raise ValueError("const_counts must be >= 0")
            self._const_counts = c
        else:  # stamatakis
            c = np.asarray(
                const_counts if const_counts is not None else np.zeros(s),
                np.float64,
            )
            if c.shape != (s,) or (c < 0).any():
                raise ValueError(
                    f"stamatakis const_counts must be {s} non-negative "
                    "per-state counts"
                )
            self._const_counts = c

        if not isinstance(alignment, pio.CompressedAlignment):
            alignment = pio.compress_patterns(
                alignment, model.alphabet, dtype=np.float64
            )
        if correction == "lewis":
            # a (weighted) pattern certain to be constant in the data makes
            # the conditional likelihood ill-defined
            one_hot = alignment.partials.sum(axis=2) == 1.0  # (taxa, P)
            same = (
                alignment.partials.argmax(axis=2)
                == alignment.partials.argmax(axis=2)[:1]
            ).all(axis=0)
            const = (one_hot.all(axis=0) & same
                     & (alignment.weights > 0)).sum()
            if const:
                raise ValueError(
                    f"alignment contains {int(const)} constant pattern(s); "
                    "the lewis correction conditions on variable sites — "
                    "remove constant columns first"
                )

        n_taxa = alignment.partials.shape[0]
        const_partials = np.broadcast_to(
            np.eye(s, dtype=alignment.partials.dtype), (n_taxa, s, s)
        )
        augmented = pio.CompressedAlignment(
            names=alignment.names,
            partials=np.concatenate(
                [alignment.partials, const_partials], axis=1
            ),
            weights=np.concatenate(
                [alignment.weights, np.zeros(s, alignment.weights.dtype)]
            ),
            site_to_pattern=alignment.site_to_pattern,
        )
        self._n_real_patterns = alignment.n_patterns
        super().__init__(tree, alignment=augmented, model=model, **kwargs)

    def _loglik_fn(self, params, leaf_partials, weights, eig=None,
                   rates=None):
        total, sw = super()._loglik_fn(
            params, leaf_partials, weights, eig=eig, rates=rates
        )
        rdt = getattr(self, "_reduce_dtype", self.dtype)
        s = self.model.n_states
        i0 = self._n_real_patterns
        sw_const = jax.lax.dynamic_slice_in_dim(sw, i0, s).astype(rdt)
        if self.correction == "lewis":
            log_v = jax.scipy.special.logsumexp(sw_const)
            # log(1 - V) via expm1: accurate as V -> 1 (tiny trees)
            log_denom = jnp.log(-jnp.expm1(log_v))
            n_sites = jnp.sum(weights).astype(rdt)
            return total - n_sites * log_denom, sw - log_denom
        if self.correction == "felsenstein":
            log_v = jax.scipy.special.logsumexp(sw_const)
            return total + jnp.asarray(self._const_counts, rdt) * log_v, sw
        # stamatakis: per-state constant-site counts
        add = jnp.sum(jnp.asarray(self._const_counts, rdt) * sw_const)
        return total + add, sw

    def sitewise_loglikelihoods(
        self, params: Optional[Mapping] = None, per_pattern: bool = False
    ) -> np.ndarray:
        """Per-site (or per-pattern) CORRECTED log-likelihoods (the S
        appended constant patterns are excluded)."""
        _, sw = self._eval(self._full_params(params))
        sw = np.asarray(sw)[: self._n_real_patterns]
        if per_pattern:
            return sw
        return sw[self._compressed.site_to_pattern]
