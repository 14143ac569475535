"""Data-parallel site sharding over a device mesh.

The reference is a single-core CPU library with no parallelism of any kind
(SURVEY.md §2, parallelism ledger [HIGH]); every line here is new
design, constrained by BASELINE.json config 5 ("sites sharded across hosts").

Design (SURVEY.md §5 "long-context" row): alignment *site patterns* are the
data-parallel axis. Sites are conditionally i.i.d. given the tree, so the
pruning pass is embarrassingly parallel over sites — partials carry a
``NamedSharding(P(..., 'sites', ...))``, every pruning op is elementwise or a
gather on non-site axes and therefore runs shard-local, and the single
cross-device reduction is the weighted logL sum (and its gradient), which
GSPMD lowers to one psum over ICI/DCN. Model parameters, the tree schedule
and the P(t) batch are tiny and stay replicated.

The same mesh abstraction covers all three required scale points
(1 chip / 1 host / N hosts): only mesh construction differs.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from phylo_utils_tpu.ops.pruning import DP_BLOCK

__all__ = ["make_mesh", "SiteSharding", "distributed_init"]


def distributed_init(timeout: Optional[float] = None, **kwargs) -> None:
    """Multi-host runtime init (call once per process BEFORE device use).

    Thin wrapper over ``jax.distributed.initialize`` so callers never import
    jax.distributed directly. Must run before anything touches the backend
    (even ``jax.process_count()`` would initialize it host-locally — the
    original implementation did exactly that and silently degraded to
    independent single hosts). With kwargs, failures propagate; without
    kwargs we rely on env auto-detection and treat "no coordinator
    configured" as a single-process run. The collective transport (ICI
    within a slice, DCN across hosts) is compiler-lowered — there is no
    NCCL/MPI-style backend to configure (SURVEY.md §5).

    ``timeout`` (seconds) bounds how long this process waits for the
    coordinator / peers; on expiry a RuntimeError naming the coordinator
    address is raised instead of a bare hang-then-crash, so an operator can
    tell "peer never started" from "network partition" (SURVEY.md §5
    failure-detection row).
    """
    if timeout is not None:
        kwargs.setdefault("initialization_timeout", int(timeout))
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as exc:
        if kwargs:
            coord = kwargs.get("coordinator_address") or os.environ.get(
                "JAX_COORDINATOR_ADDRESS", "<env-configured>"
            )
            raise RuntimeError(
                f"multi-host init failed (coordinator {coord}, "
                f"process {kwargs.get('process_id', '?')}/"
                f"{kwargs.get('num_processes', '?')}): {exc}. "
                "Check that all processes started within the timeout and "
                "the coordinator address/port is reachable from every host."
            ) from exc
        # single-process / no-coordinator environment: run standalone


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis_name: str = "sites"
) -> Mesh:
    """1-D mesh over all (global) devices; the single axis is the site axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


class SiteSharding:
    """Shards (pattern-compressed) alignment data over a mesh's site axis.

    Parameters
    ----------
    mesh : jax.sharding.Mesh (default: all devices, axis "sites")
    axis : mesh axis name holding sites

    Padded pattern slots hold all-ones partials and zero weights: an
    all-ones column has site likelihood sum_i pi_i = 1 (logL contribution
    exactly 0 even before weighting), so padding changes nothing and never
    produces -inf/NaN in the log.
    """

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "sites"):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        if axis not in self.mesh.axis_names:
            raise ValueError(f"mesh has no axis named {axis!r}")
        self.n_devices = int(self.mesh.shape[axis])

    # -- shardings -----------------------------------------------------------

    @property
    def leaves_spec(self) -> NamedSharding:
        """(n_leaves, patterns, states): shard the pattern axis."""
        return NamedSharding(self.mesh, P(None, self.axis, None))

    @property
    def sites_spec(self) -> NamedSharding:
        """(patterns,): shard the single axis."""
        return NamedSharding(self.mesh, P(self.axis))

    @property
    def replicated_spec(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    # -- data placement ------------------------------------------------------

    def padded_size(self, n_patterns: int) -> int:
        """A multiple of the device count and, above ``DP_BLOCK`` patterns,
        of ``n_devices * DP_BLOCK``: the gradient sums dP over blocks of
        DP_BLOCK sites (ops.pruning), and whole blocks on every device keep
        that reshape local to each shard (no all-gather per level)."""
        q = self.n_devices
        if n_patterns > DP_BLOCK:
            q *= DP_BLOCK
        return max(int(math.ceil(n_patterns / q)) * q, q)

    def pad(
        self, leaf_partials: np.ndarray, weights: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad (n_leaves, P, S) partials with ones and (P,) weights with zeros
        to a device-divisible pattern count."""
        n_patterns = leaf_partials.shape[1]
        total = self.padded_size(n_patterns)
        if total == n_patterns:
            return leaf_partials, weights
        extra = total - n_patterns
        pad_lp = np.ones(
            (leaf_partials.shape[0], extra, leaf_partials.shape[2]),
            dtype=leaf_partials.dtype,
        )
        pad_w = np.zeros((extra,), dtype=weights.dtype)
        return (
            np.concatenate([leaf_partials, pad_lp], axis=1),
            np.concatenate([weights, pad_w]),
        )

    def put_leaves(self, leaf_partials) -> jax.Array:
        return jax.device_put(leaf_partials, self.leaves_spec)

    def put_sites(self, arr) -> jax.Array:
        return jax.device_put(arr, self.sites_spec)

    def put_replicated(self, tree) -> jax.Array:
        return jax.device_put(tree, self.replicated_spec)

    def from_process_local(self, local_leaf_partials, local_weights):
        """Multi-host ingestion: each host passes its pattern shard; returns
        global sharded arrays (host 0 computes the global pattern compression
        and broadcasts index ranges out-of-band; SURVEY.md §7 hard part 5)."""
        lp = jax.make_array_from_process_local_data(
            self.leaves_spec, np.asarray(local_leaf_partials)
        )
        w = jax.make_array_from_process_local_data(
            self.sites_spec, np.asarray(local_weights)
        )
        return lp, w
