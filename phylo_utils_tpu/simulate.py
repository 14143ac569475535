"""Sequence simulation along a tree (jax.random, fully on-device).

Reference parity: phylo_utils/simulation.py ``SequenceSimulator`` — draw root
states from the equilibrium frequencies, then walk the tree top-down sampling
each child's state from the parent's P(t) row, with per-site gamma-category
rates (SURVEY.md §2/§3.5 [MED]).

Redesign for an accelerator: the Python pre-order recursion with per-site weighted
choice (reference likcalc weighted sampling kernel) becomes a ``lax.scan``
over a static pre-order node array; each step samples ALL sites of one node
in a single vectorized ``jax.random.categorical`` over gathered P rows. All
randomness is explicit (splittable PRNG keys), so simulations are exactly
reproducible across devices and shardable over sites.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu import io as pio
from phylo_utils_tpu import trees as ptrees
from phylo_utils_tpu.alphabets import get_alphabet
from phylo_utils_tpu.models.base import Model
from phylo_utils_tpu.ops.gamma import discrete_gamma
from phylo_utils_tpu.ops.pmatrix import p_matrices_reversible, transition_matrices

__all__ = [
    "simulate_states",
    "simulate_alignment",
    "simulate_mixture_alignment",
    "simulate_branch_alignment",
    "SequenceSimulator",
]


def _preorder_arrays(tree: ptrees.Tree) -> Tuple[np.ndarray, np.ndarray]:
    """Non-root nodes in parent-before-child order + their parents."""
    order = [n for n in tree.postorder()][::-1]  # root first
    nodes = np.asarray([n for n in order if n != tree.root], np.int32)
    parents = np.asarray([tree.parent[n] for n in nodes], np.int32)
    return nodes, parents


def _state_chars(model) -> np.ndarray:
    """Per-state output characters (codon states emit 3-char strings)."""
    if model.alphabet.startswith("codon"):
        from phylo_utils_tpu.models.codon import code_tables

        code = (model.alphabet.split(":", 1)[1]
                if ":" in model.alphabet else "standard")
        return np.asarray(code_tables(code)[0])
    return np.asarray(list(get_alphabet(model.alphabet).states))


def simulate_states(
    key: jax.Array,
    tree: ptrees.Tree,
    model: Model,
    n_sites: int,
    params: Optional[Mapping] = None,
    ncat: int = 1,
    pinv: float = 0.0,
    median: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sample ancestral + leaf states.

    Returns ``(states, site_rates)`` where ``states`` is (n_nodes, n_sites)
    int32 and ``site_rates`` the per-site rate multipliers actually used
    (0.0 for invariant sites drawn by ``pinv``).
    """
    params = dict(params) if params else {}
    # mixture parameters ride in `params` but are NOT model-builder kwargs
    alpha_param = params.pop("alpha", None)
    model_params = model.defaults(None)
    model_params.update({k: jnp.asarray(v) for k, v in params.items()})
    if model.reversible:
        sym, freqs = model.build_parts(model_params)
        eig = None
    else:
        eig = model.eigen(model_params)
        freqs = eig.freqs
    dtype = freqs.dtype

    k_rates, k_root, k_inv, k_walk = jax.random.split(key, 4)
    if ncat > 1:
        alpha = (
            jnp.asarray(alpha_param, dtype)
            if alpha_param is not None
            else jnp.asarray(0.5, dtype)
        )
        rates = discrete_gamma(alpha, ncat, median).astype(dtype)
        cat = jax.random.randint(k_rates, (n_sites,), 0, ncat)
        site_rates = rates[cat]
    else:
        site_rates = jnp.ones((n_sites,), dtype)
    if pinv > 0:
        inv = jax.random.bernoulli(k_inv, pinv, (n_sites,))
        site_rates = jnp.where(inv, 0.0, site_rates)

    root_states = jax.random.categorical(
        k_root, jnp.log(freqs)[None, :], shape=(n_sites,)
    ).astype(jnp.int32)

    nodes, parents = _preorder_arrays(tree)
    lengths = jnp.asarray(tree.lengths, dtype)
    # P(t_node * rate_s) for every non-root node: (n_edges, n_sites, S, S) is
    # too big; instead one P per (node, unique rate) — the rate set is the
    # ncat gamma rates (+ 0 for invariant), so gather per-site from K+1 mats.
    uniq_rates = (
        jnp.concatenate([rates, jnp.zeros((1,), dtype)])
        if ncat > 1
        else jnp.concatenate([jnp.ones((1,), dtype), jnp.zeros((1,), dtype)])
    )
    t = lengths[:, None] * uniq_rates[None, :]
    if model.reversible:
        p = p_matrices_reversible(sym, freqs, t)      # (n_nodes, R, S, S)
    else:
        p = transition_matrices(eig, t)
    # per-site rate index into uniq_rates
    site_r = jnp.argmin(
        jnp.abs(site_rates[:, None] - uniq_rates[None, :]), axis=1
    )

    states0 = jnp.zeros((tree.n_nodes, n_sites), jnp.int32)
    states0 = states0.at[tree.root].set(root_states)
    keys = jax.random.split(k_walk, nodes.shape[0])

    def step(states, xs):
        node, parent, kk = xs
        parent_states = states[parent]                       # (n_sites,)
        rows = p[node][site_r, parent_states, :]             # (n_sites, S)
        logits = jnp.log(jnp.clip(rows, 1e-30, None))
        child_states = jax.random.categorical(kk, logits).astype(jnp.int32)
        return states.at[node].set(child_states), None

    states, _ = jax.lax.scan(
        step, states0, (jnp.asarray(nodes), jnp.asarray(parents), keys)
    )
    return states, site_rates


def simulate_alignment(
    key: jax.Array,
    tree: Union[ptrees.Tree, str],
    model: Model,
    n_sites: int,
    params: Optional[Mapping] = None,
    ncat: int = 1,
    pinv: float = 0.0,
    median: bool = False,
) -> Dict[str, str]:
    """Simulate a name->sequence dict at the leaves (reference output shape)."""
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    states, _ = simulate_states(
        key, tree, model, n_sites, params, ncat, pinv, median
    )
    leaf_states = np.asarray(states[: tree.n_leaves])
    chars = _state_chars(model)  # codon states emit 3-char strings
    return {
        name: "".join(chars[leaf_states[i]])
        for i, name in enumerate(tree.leaf_names)
    }


def simulate_mixture_alignment(
    key: jax.Array,
    tree: Union[ptrees.Tree, str],
    model: Model,
    n_sites: int,
    mixture,
    weights=None,
    shared: Optional[Mapping] = None,
) -> Tuple[Dict[str, str], np.ndarray]:
    """Simulate under a MODEL MIXTURE: each site draws its class iid.

    ``mixture``: list of per-class model-parameter dicts (e.g.
    ``[{"omega": 0.1}, {"omega": 1.0}, {"omega": 4.0}]`` — M2a-style data);
    ``weights``: class probabilities (uniform default); ``shared``:
    parameters common to all classes (kappa, freqs). Returns
    ``(alignment, site_classes)`` so tests/scans know the truth per site.
    Complements ``ModelMixtureEngine``/``M1aEngine``/... the way
    ``simulate_alignment`` complements ``LikelihoodEngine``.
    """
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    k = len(mixture)
    if weights is None:
        weights = np.full(k, 1.0 / k)
    weights = np.asarray(weights, np.float64)
    weights = weights / weights.sum()
    k_cls, *k_sub = jax.random.split(key, k + 1)
    site_classes = np.asarray(jax.random.categorical(
        k_cls, jnp.log(jnp.asarray(weights))[None, :], shape=(n_sites,)
    ))
    cols: Dict[int, Dict[str, str]] = {}
    counts = [int((site_classes == c).sum()) for c in range(k)]
    sims = []
    for c in range(k):
        params = dict(shared or {})
        params.update(mixture[c])
        sims.append(
            simulate_alignment(k_sub[c], tree, model, max(counts[c], 1),
                               params=params)
            if counts[c]
            else None
        )
    width = 3 if model.alphabet == "codon" else 1
    out: Dict[str, str] = {}
    for name in tree.leaf_names:
        pos = [0] * k
        chunks = []
        for c in site_classes:
            s = sims[c][name]
            i = pos[c]
            chunks.append(s[i * width:(i + 1) * width])
            pos[c] = i + 1
        out[name] = "".join(chunks)
    return out, site_classes


class SequenceSimulator:
    """OO facade mirroring the reference's ``SequenceSimulator`` API."""

    def __init__(self, tree, model: Model, params=None, ncat: int = 1,
                 pinv: float = 0.0, median: bool = False, seed: int = 0):
        self.tree = pio.parse_newick(tree) if isinstance(tree, str) else tree
        self.model = model
        self.params = params
        self.ncat = ncat
        self.pinv = pinv
        self.median = median
        self._key = jax.random.key(seed)

    def simulate(self, n_sites: int) -> Dict[str, str]:
        self._key, sub = jax.random.split(self._key)
        return simulate_alignment(
            sub, self.tree, self.model, n_sites, self.params, self.ncat,
            self.pinv, self.median,
        )


def simulate_branch_alignment(
    key: jax.Array,
    tree: Union[ptrees.Tree, str],
    model: Model,
    branch_classes,
    class_params,
    n_sites: int,
    shared: Optional[Mapping] = None,
) -> Dict[str, str]:
    """Simulate under PER-EDGE-CLASS models (the BranchModelEngine dual).

    ``branch_classes``: (n_nodes,) class of each node's parent edge (see
    ``branch_models.mark_branches``/``mark_clade``); ``class_params``:
    one model-parameter dict per class; ``shared``: parameters common to
    all classes. Single rate category (compose site classes by
    concatenating calls — see tests for a branch-site power analysis).
    """
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    cls = np.asarray(branch_classes, np.int32)
    if cls.shape != (tree.n_nodes,):
        raise ValueError("branch_classes must have one entry per node")
    n_classes = int(cls.max()) + 1
    if len(class_params) < n_classes:
        raise ValueError("class_params shorter than the class id range")
    eigs = []
    for c in range(n_classes):
        p = dict(model.defaults(None))
        p.update({k: jnp.asarray(v) for k, v in (shared or {}).items()})
        p.update({k: jnp.asarray(v) for k, v in class_params[c].items()})
        eigs.append(model.eigen(p))
    # root states from the ROOT class's stationary distribution (matches
    # BranchModelEngine's root-frequency convention)
    root_freqs = eigs[int(cls[tree.root])].freqs
    dtype = root_freqs.dtype
    k_root, k_walk = jax.random.split(key, 2)
    root_states = jax.random.categorical(
        k_root, jnp.log(root_freqs)[None, :], shape=(n_sites,)
    ).astype(jnp.int32)

    nodes, parents = _preorder_arrays(tree)
    lengths = jnp.asarray(tree.lengths, dtype)
    # P per node under ITS class: (n_nodes, S, S), stacked from per-class
    p_by_class = jnp.stack([
        transition_matrices(e, lengths) for e in eigs
    ])                                                  # (C, n_nodes, S, S)
    p = p_by_class[jnp.asarray(cls), jnp.arange(tree.n_nodes)]

    states0 = jnp.zeros((tree.n_nodes, n_sites), jnp.int32)
    states0 = states0.at[tree.root].set(root_states)
    keys = jax.random.split(k_walk, nodes.shape[0])

    def step(states, xs):
        node, parent, kk = xs
        rows = p[node][states[parent], :]               # (n_sites, S)
        logits = jnp.log(jnp.clip(rows, 1e-30, None))
        child = jax.random.categorical(kk, logits).astype(jnp.int32)
        return states.at[node].set(child), None

    states, _ = jax.lax.scan(
        step, states0, (jnp.asarray(nodes), jnp.asarray(parents), keys)
    )
    leaf_states = np.asarray(states[: tree.n_leaves])
    chars = _state_chars(model)
    return {
        name: "".join(chars[leaf_states[i]])
        for i, name in enumerate(tree.leaf_names)
    }
