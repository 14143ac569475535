"""Batched evaluation of MANY tree topologies against one alignment.

The reference (and its downstream consumer treeCl) scores candidate
topologies one at a time through a Python/Cython loop. On an accelerator the natural
design is topology batching: all binary trees on n taxa have 2n-1 nodes, so
their level schedules pad to one common (levels, width, children) shape and
the whole pruning pass vmaps over a stacked schedule tensor — hundreds of
candidate trees are scored in one device program (tree search / model
selection / bootstrap scoring).

Unlike ops.pruning (schedule baked in as constants), here the schedule
arrays are *traced inputs*, so one compiled program serves any topology set
of the same padded shape — no recompilation per candidate.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from phylo_utils_tpu import io as pio
from phylo_utils_tpu import trees as ptrees
from phylo_utils_tpu.models.base import Model
from phylo_utils_tpu.ops.gamma import discrete_gamma
from phylo_utils_tpu.ops.pmatrix import (
    extend_p_identity,
    p_matrices_reversible,
    transition_matrices,
)
from phylo_utils_tpu.ops.pruning import mixture_loglik
from phylo_utils_tpu.ops.pruning import LN2, pow2_rescale

__all__ = ["pad_schedules", "TopologySetEngine", "optimize_branch_lengths",
           "chunked_brlen_optimize", "nni_hill_climb",
           "choose_regroup_width"]


def choose_regroup_width(schedules: Sequence[ptrees.PruningSchedule],
                         candidates=(2, 3, 4, 6, 8, 12, 16),
                         max_level_factor: float = 1.6):
    """Pick the group width minimizing the padded level-grid area.

    Returns ``(width, regrouped_schedules)`` — width 0 keeps the original
    height-level grid (it wins on caterpillar-like trees whose critical
    path IS the walk). The height-level grid pads every level to the
    widest, which leaves most of the grid empty on NNI candidate sets;
    ``trees.regroup_schedule`` packs near-full fixed-width groups
    instead. Area is compared after common padding across the whole
    candidate set, so the choice is exact for the batch that will run.

    ``max_level_factor`` bounds the regrouped LEVEL COUNT at that
    multiple of the original grid's: the batched gradient's scan-VJP
    stores the full partials carry PER LEVEL, so a narrow width that
    minimizes area can multiply residual memory by G/L: an area-only
    chooser picks U=2–3 on 64-taxon sets (G≈3–5×L), and the aLRT
    gradient chunk then runs out of device memory.
    """
    l0 = max(s.n_levels for s in schedules)
    area0 = l0 * max(s.width for s in schedules)
    cap = max(int(l0 * max_level_factor), 1)
    best_u, best_area, best_scheds = 0, area0, schedules
    for u in candidates:
        rg = [ptrees.regroup_schedule(s, u) for s in schedules]
        g = max(s.n_levels for s in rg)
        if g > cap:
            continue
        area = g * u
        if area < best_area:
            best_u, best_area, best_scheds = u, area, rg
    return best_u, best_scheds

_HI = lax.Precision.HIGHEST


def pad_schedules(schedules: Sequence[ptrees.PruningSchedule],
                  pad_to: Optional[tuple] = None):
    """Stack schedules into common-shape arrays.

    All schedules must share n_nodes/n_leaves (same taxon count). Returns
    dict of stacked arrays: level_nodes (B, L, W), level_children
    (B, L, W, C), level_childmask (B, L, W, C). Padding levels are rows of
    trash-node writes (node id == n_nodes) with zero child masks.

    ``pad_to=(L, W, C)`` pins MINIMUM level/width/children dims — callers
    that process one candidate set in several chunks pass the global max
    so every chunk shares one compiled program shape.
    """
    n_nodes = {s.n_nodes for s in schedules}
    n_leaves = {s.n_leaves for s in schedules}
    if len(n_nodes) != 1 or len(n_leaves) != 1:
        raise ValueError("all trees must have the same taxon count")
    n = n_nodes.pop()
    L = max(s.n_levels for s in schedules)
    W = max(s.width for s in schedules)
    C = max(s.n_children_max for s in schedules)
    if pad_to is not None:
        L, W, C = max(L, pad_to[0]), max(W, pad_to[1]), max(C, pad_to[2])
    B = len(schedules)
    nodes = np.full((B, L, W), n, dtype=np.int32)
    children = np.zeros((B, L, W, C), dtype=np.int32)
    mask = np.zeros((B, L, W, C), dtype=np.float32)
    for b, s in enumerate(schedules):
        l, w, c = s.level_nodes.shape[0], s.level_nodes.shape[1], s.level_children.shape[2]
        nodes[b, :l, :w] = s.level_nodes
        children[b, :l, :w, :c] = s.level_children
        mask[b, :l, :w, :c] = s.level_childmask
    return {"nodes": nodes, "children": children, "mask": mask}


def _prune_dynamic(nodes, children, mask, p_matrices, leaf_partials, root):
    """Scan-based pruning with the schedule as traced arrays.

    nodes (L, W), children (L, W, C), mask (L, W, C),
    p_matrices (n_nodes, K, S, S), leaf_partials (n_leaves, sites, S);
    root is static (n_nodes - 1 by construction).
    Returns (root_partials (K, sites, S), root_logscale (K, sites)).
    """
    dtype = leaf_partials.dtype
    n_nodes = p_matrices.shape[0]
    k = p_matrices.shape[1]
    sites = leaf_partials.shape[1]
    s = leaf_partials.shape[2]
    n_leaves = leaf_partials.shape[0]
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)

    buf = jnp.zeros((n_nodes + 1, k, sites, s), dtype)
    buf = buf.at[:n_leaves].set(leaf_partials[:, None, :, :])
    logscale = jnp.zeros((n_nodes + 1, k, sites), dtype)

    def level_step(carry, level):
        buf, logscale = carry
        nodes, children, mask = level
        child_p = buf[children]
        child_sc = logscale[children]
        p = p_matrices[jnp.clip(children, 0, n_nodes - 1)]
        contrib = jnp.einsum("wckij,wcksj->wcksi", p, child_p, precision=_HI)
        mask_b = mask[:, :, None, None, None].astype(dtype)
        contrib = contrib * mask_b + (1.0 - mask_b)
        partial = jnp.prod(contrib, axis=1)
        sc = jnp.sum(child_sc * mask[:, :, None, None].astype(dtype), axis=1)
        m = jnp.maximum(jnp.max(partial, axis=-1), tiny)
        if dtype == jnp.float32:
            # exact power-of-2 rescale (see ops.pruning.pow2_rescale)
            scale, e = pow2_rescale(m)
            partial = partial * scale[..., None]
            sc = sc + e
        else:
            partial = partial / m[..., None]
            sc = sc + jnp.log(m)
        buf = buf.at[nodes].set(partial)
        logscale = logscale.at[nodes].set(sc)
        return (buf, logscale), None

    (buf, logscale), _ = lax.scan(level_step, (buf, logscale),
                                  (nodes, children, mask))
    root_sc = logscale[root]
    if dtype == jnp.float32:
        root_sc = (
            root_sc.astype(jnp.result_type(float)) * LN2
        ).astype(dtype)
    return buf[root], root_sc


class TopologySetEngine:
    """Score a set of candidate topologies against one alignment.

    One jitted program evaluates logL (and gradients w.r.t. per-tree branch
    lengths and shared model parameters) for ALL trees at once; the batch
    axis vmaps over (schedule, leaf permutation, branch lengths).

    The schedule/leaf-permutation arrays are *arguments* of the jitted
    programs (not closure constants), so ``set_candidates`` swaps in a new
    topology set of the same padded shape without recompiling — the chunked
    optimizer and the NNI searcher reuse ONE engine (and ONE compiled
    program per shape) across every chunk and round.
    """

    def __init__(
        self,
        trees: Sequence[Union[ptrees.Tree, str]],
        alignment: Union[Mapping[str, str], pio.CompressedAlignment],
        model: Model,
        ncat: int = 1,
        median: bool = False,
        dtype=None,
        compress: bool = True,
        pad_to: Optional[tuple] = None,
        sharding=None,
        regroup="auto",
    ):
        self.model = model
        self.ncat = int(ncat)
        self.median = bool(median)
        self.dtype = jnp.dtype(dtype) if dtype else jnp.dtype(jnp.result_type(float))
        self.sharding = sharding
        # regroup: "auto" (pick the area-minimizing fixed group width on
        # the first candidate set — see choose_regroup_width), an int
        # width, or 0/None to keep the height-level grid. Sticky after
        # the first set so swapped candidate sets keep the program shape.
        self._regroup_u = None if regroup == "auto" else int(regroup or 0)

        if isinstance(alignment, pio.CompressedAlignment):
            ca = alignment
        elif compress:
            ca = pio.compress_patterns(alignment, model.alphabet)
        else:
            from phylo_utils_tpu.alphabets import encode_alignment

            names, arr = encode_alignment(alignment, model.alphabet)
            ca = pio.CompressedAlignment(
                names=tuple(names), partials=arr,
                weights=np.ones(arr.shape[1]),
                site_to_pattern=np.arange(arr.shape[1], dtype=np.int32),
            )
        self._compressed = ca
        if sharding is not None:
            # shard the pattern axis over the mesh: schedules/P stay
            # replicated, pruning runs shard-local per candidate, and the
            # weighted per-tree logL sums psum over the site axis (GSPMD
            # inserts the collective; pads are all-ones/zero-weight)
            lp, wts = sharding.pad(
                np.asarray(ca.partials), np.asarray(ca.weights)
            )
            self._leaf_partials = sharding.put_leaves(lp.astype(self.dtype))
            self._weights = sharding.put_sites(wts.astype(self.dtype))
        else:
            self._leaf_partials = jnp.asarray(ca.partials, self.dtype)
            self._weights = jnp.asarray(ca.weights, self.dtype)
        # padded (L, W, C) dims; grows monotonically so a pinned shape keeps
        # serving later candidate sets (pad_to pins the minimum)
        self._pad_dims = pad_to
        self._opt_cache: Dict = {}

        self.set_candidates(trees)

        self._jit_fn = jax.jit(self._core)
        self._jit_grad = jax.jit(jax.grad(
            lambda p, sched, perm: jnp.sum(self._core(p, sched, perm)[0]),
            argnums=0,
        ))

    def set_candidates(
        self, trees: Sequence[Union[ptrees.Tree, str]]
    ) -> "TopologySetEngine":
        """Swap in a new candidate set (same taxa) WITHOUT recompiling.

        The padded schedule shape grows monotonically; as long as the new
        set fits the current (L, W, C) pad dims and has the same batch
        size, every jitted program (logL, grads, the cached branch-length
        optimizer) is reused as-is.
        """
        trees = [pio.parse_newick(t) if isinstance(t, str) else t
                 for t in trees]
        if not trees:
            raise ValueError("empty tree set")
        self.trees: List[ptrees.Tree] = trees
        ca = self._compressed
        schedules = [ptrees.compile_schedule(t) for t in trees]
        if self._regroup_u is None:
            self._regroup_u, schedules = choose_regroup_width(schedules)
        elif self._regroup_u:
            schedules = [ptrees.regroup_schedule(s, self._regroup_u)
                         for s in schedules]
        padded = pad_schedules(schedules, pad_to=self._pad_dims)
        self._pad_dims = (
            padded["nodes"].shape[1], padded["nodes"].shape[2],
            padded["children"].shape[3],
        )
        self._sched = {k: jnp.asarray(v) for k, v in padded.items()}
        self.n_nodes = schedules[0].n_nodes
        self.root = schedules[0].root
        # per-tree leaf permutation: row b maps tree-b leaf id -> pattern row
        perms = []
        for t in trees:
            missing = set(t.leaf_names) - set(ca.names)
            if missing:
                raise ValueError(f"alignment missing taxa {sorted(missing)}")
            perms.append([ca.names.index(nm) for nm in t.leaf_names])
        self._leaf_perm = jnp.asarray(np.asarray(perms, np.int32))
        self._brlens0 = jnp.asarray(
            np.stack([t.lengths for t in trees]), self.dtype
        )
        return self

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": self._brlens0,          # (B, n_nodes)
            "model": self.model.defaults(self.dtype),
        }
        if self.ncat > 1:
            params["alpha"] = jnp.asarray(0.5, self.dtype)
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            for k, v in params.items():
                if k == "model":
                    full["model"] = {**full["model"], **{
                        kk: jnp.asarray(vv, self.dtype) for kk, vv in v.items()
                    }}
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full

    def _core(self, params, sched, perm) -> jnp.ndarray:
        """logL of every candidate; ``sched``/``perm`` are traced args so
        one compiled program serves any same-shape candidate set."""
        dtype = self.dtype
        if self.ncat > 1:
            rates = discrete_gamma(params["alpha"], self.ncat, self.median)
            rates = rates.astype(dtype)
        else:
            rates = jnp.ones((1,), dtype)
        cat_weights = jnp.full((self.ncat,), 1.0 / self.ncat, dtype)
        t = params["branch_lengths"].astype(dtype)          # (B, n_nodes)
        ts = t[..., None] * rates[None, None, :]            # (B, n_nodes, K)
        if self.model.reversible:
            sym, freqs = self.model.build_parts(params["model"], dtype=dtype)
            p = p_matrices_reversible(sym, freqs, ts)       # (B, n_nodes, K, S, S)
        else:
            eig = self.model.eigen(params["model"], dtype=dtype)
            freqs = eig.freqs
            p = transition_matrices(eig, ts)
        p = extend_p_identity(p, self.n_nodes)   # (B, n_sched, K, S, S)

        def one_tree(nodes, children, mask, p_b, perm_b):
            leaves = self._leaf_partials[perm_b]            # (n_leaves, P, S)
            rp, rsc = _prune_dynamic(nodes, children, mask, p_b, leaves,
                                     self.root)
            total, sw = mixture_loglik(
                rp, rsc, freqs, cat_weights, self._weights
            )
            return total, sw

        totals, sw = jax.vmap(one_tree)(
            sched["nodes"], sched["children"], sched["mask"], p, perm,
        )
        return totals, sw

    def _loglik_fn(self, params) -> jnp.ndarray:
        return self._core(params, self._sched, self._leaf_perm)

    # -- public API ----------------------------------------------------------

    def loglikelihoods(self, params: Optional[Mapping] = None) -> np.ndarray:
        """(n_trees,) log-likelihoods in one device program."""
        return np.asarray(
            self._jit_fn(
                self._full_params(params), self._sched, self._leaf_perm
            )[0]
        )

    def sitewise_loglikelihoods(
        self, params: Optional[Mapping] = None
    ) -> np.ndarray:
        """(n_trees, n_sites) per-site log-likelihoods (for RELL/KH/SH
        topology tests; see topology_tests.py)."""
        _, sw = self._jit_fn(
            self._full_params(params), self._sched, self._leaf_perm
        )
        sw = np.asarray(sw)
        return sw[:, self._compressed.site_to_pattern]

    def gradients(self, params: Optional[Mapping] = None) -> Dict:
        """Gradient of sum of logLs (per-tree brlen grads are independent)."""
        return self._jit_grad(
            self._full_params(params), self._sched, self._leaf_perm
        )

    def best(self, params: Optional[Mapping] = None) -> int:
        return int(np.argmax(self.loglikelihoods(params)))


def optimize_branch_lengths(
    tse: "TopologySetEngine",
    params: Optional[Mapping] = None,
    steps: int = 60,
    lr: float = 0.05,
):
    """Optimize every candidate tree's branch lengths simultaneously.

    Each tree's logL depends only on its own branch-length row, so one adam
    loop on the summed logL optimizes all B trees independently in parallel
    (per-tree gradients are block-diagonal). Returns (logliks (B,),
    branch_lengths (B, n_nodes)).

    The jitted optimizer program is cached on the engine keyed by
    ``(steps, lr)`` and takes the schedule arrays / fixed params as traced
    arguments, so successive calls after ``set_candidates`` (chunked
    optimization, NNI rounds) hit the compile cache.
    """
    import optax

    full = tse._full_params(params)
    raw0 = jnp.log(jnp.expm1(jnp.clip(full["branch_lengths"], 1e-6, None)))
    fixed = {k: v for k, v in full.items() if k != "branch_lengths"}

    key = ("brlen_opt", int(steps), float(lr))
    run = tse._opt_cache.get(key)
    if run is None:
        opt = optax.adam(lr)

        def run_impl(raw0, fixed, sched, perm):
            def loss(raw):
                p = dict(fixed)
                p["branch_lengths"] = jax.nn.softplus(raw)
                return -jnp.sum(tse._core(p, sched, perm)[0])

            state = opt.init(raw0)

            def step(carry, _):
                raw, state = carry
                g = jax.grad(loss)(raw)
                updates, state = opt.update(g, state, raw)
                return (optax.apply_updates(raw, updates), state), None

            (raw, _), _ = lax.scan(step, (raw0, state), None, length=steps)
            p = dict(fixed)
            p["branch_lengths"] = jax.nn.softplus(raw)
            return tse._core(p, sched, perm)[0], p["branch_lengths"]

        run = tse._opt_cache.setdefault(key, jax.jit(run_impl))

    lls, brlens = run(raw0, fixed, tse._sched, tse._leaf_perm)
    return np.asarray(lls), np.asarray(brlens)


def chunked_brlen_optimize(
    candidates: Sequence[ptrees.Tree],
    alignment,
    model,
    ncat: int = 1,
    steps: int = 40,
    params: Optional[Mapping] = None,
    batch_chunk: Optional[int] = 64,
    dtype=None,
    engine: Optional["TopologySetEngine"] = None,
    sharding=None,
):
    """``optimize_branch_lengths`` over a candidate set in fixed-size CHUNKS.

    The batched gradient's scan-VJP stores the partials carry per level —
    B × levels × (n_nodes × K × patterns × S) floats, which for a
    125-candidate 64-taxon GTR+Γ4 NNI neighborhood is many gigabytes.
    Chunking bounds residual memory at
    ``batch_chunk/B`` of that; every chunk shares ONE compiled program:
    ONE engine's schedule arrays are swapped per chunk
    (``set_candidates``) under a padded shape pinned to the candidate
    set's global (levels, width, children) dims, and the final chunk is
    padded by repeating its last tree. Pass ``engine`` (from a previous
    call with the same alignment/model/chunk size) to also reuse the
    compiled programs across calls — the NNI searcher does this across
    rounds. Returns (logliks (B,), brlens (B, n_nodes),
    sitewise (B, n_sites), engine).
    """
    from phylo_utils_tpu import io as pio

    if isinstance(alignment, pio.CompressedAlignment):
        ca = alignment
    else:
        ca = pio.compress_patterns(alignment, model.alphabet)
    # regroup + pad dims decided over the WHOLE candidate set up front so
    # every chunk shares one program shape (a reused engine's sticky
    # width wins — its compiled programs are keyed to it)
    scheds = [ptrees.compile_schedule(t) for t in candidates]
    if engine is not None and engine._regroup_u is not None:
        u = engine._regroup_u
        if u:
            scheds = [ptrees.regroup_schedule(s, u) for s in scheds]
    else:
        u, scheds = choose_regroup_width(scheds)
    pad = (
        max(s.n_levels for s in scheds),
        max(s.width for s in scheds),
        max(s.n_children_max for s in scheds),
    )
    n = len(candidates)
    chunk = n if not batch_chunk else min(batch_chunk, n)
    tse = engine
    lls, bls, sws = [], [], []
    for b0 in range(0, n, chunk):
        sub = list(candidates[b0:b0 + chunk])
        pad_n = chunk - len(sub)
        if pad_n:
            sub = sub + [sub[-1]] * pad_n
        if tse is None:
            tse = TopologySetEngine(sub, ca, model, ncat=ncat, pad_to=pad,
                                    dtype=dtype, sharding=sharding,
                                    regroup=u)
        else:
            if tse._pad_dims is None or any(
                p > d for p, d in zip(pad, tse._pad_dims)
            ):
                tse._pad_dims = tuple(
                    max(p, d) for p, d in zip(
                        pad, tse._pad_dims or (0, 0, 0)
                    )
                )
            tse.set_candidates(sub)
        l, b = optimize_branch_lengths(tse, params=params, steps=steps)
        full = tse._full_params(params)
        full["branch_lengths"] = jnp.asarray(b, tse.dtype)
        sw = tse.sitewise_loglikelihoods(full)
        keep = chunk - pad_n
        lls.append(l[:keep])
        bls.append(b[:keep])
        sws.append(sw[:keep])
    return (np.concatenate(lls), np.concatenate(bls),
            np.concatenate(sws), tse)


def nni_hill_climb(
    tree,
    alignment,
    model,
    ncat: int = 1,
    max_rounds: int = 20,
    brlen_steps: int = 40,
    tol: float = 1e-6,
    verbose: bool = False,
    moves: str = "nni",
    spr_max_targets: Optional[int] = 8,
    batch_topologies: Optional[int] = 64,
    sharding=None,
):
    """Greedy tree search: score the whole rearrangement neighborhood (with
    per-candidate branch-length re-optimization) in chunked device
    programs per round, move to the best neighbor until no improvement.

    ``moves``: "nni", "spr", or "both" (SPR explores long-range moves;
    ``spr_max_targets`` subsamples regraft edges per pruned subtree to
    bound neighborhood size). ``batch_topologies`` caps candidates per
    device program (gradient residual memory — see
    ``chunked_brlen_optimize``; None = one program for the whole
    neighborhood). Returns (best_tree, best_loglik, n_rounds).
    This is a capability the reference does not have at all — enabled by
    topology batching.
    """
    from phylo_utils_tpu import io as pio
    from phylo_utils_tpu.trees import nni_neighbors, spr_neighbors

    if moves not in ("nni", "spr", "both"):
        raise ValueError(f"unknown moves {moves!r}")
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    current = tree
    current_ll = None
    engine = None   # persists across rounds: one compiled program per shape
    for round_ in range(1, max_rounds + 1):
        nbrs = []
        if moves in ("nni", "both"):
            nbrs += nni_neighbors(current)
        if moves in ("spr", "both"):
            nbrs += spr_neighbors(current, max_targets=spr_max_targets,
                                  seed=round_)
        candidates = [current] + nbrs
        lls, brlens, _, engine = chunked_brlen_optimize(
            candidates, alignment, model, ncat=ncat, steps=brlen_steps,
            batch_chunk=batch_topologies, engine=engine, sharding=sharding,
        )
        best = int(np.argmax(lls))
        if verbose:
            print(f"round {round_}: current={lls[0]:.4f} "
                  f"best={lls[best]:.4f} (candidate {best})")
        if current_ll is None:
            current_ll = lls[0]
        if best == 0 or lls[best] <= lls[0] + tol:
            return current.with_lengths(brlens[0]), float(lls[0]), round_
        current = candidates[best].with_lengths(brlens[best])
        current_ll = lls[best]
    return current, float(current_ll), max_rounds
