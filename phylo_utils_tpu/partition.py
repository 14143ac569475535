"""Partitioned (multi-locus) analyses: one tree, per-partition models.

Multi-gene datasets (the reference's downstream treeCl use-case) score each
locus under its own substitution model and rate mixture while sharing the
tree topology and branch lengths; a per-partition rate multiplier
("proportional branch lengths") absorbs rate differences between loci.

  logL(theta) = sum_p logL_p(branch_lengths * r_p; model_p, mixture_p)

All partition terms are independent given the shared branch lengths, so the
joint gradient is exact through one ``jax.grad``, and ``optimize.fit`` works
unchanged (PartitionedEngine exposes the same private surface the optimizer
drives). Rate multipliers are normalized to site-weighted mean 1, keeping
shared branch lengths in expected substitutions/site.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from phylo_utils_tpu import io as pio
from phylo_utils_tpu import trees as ptrees
from phylo_utils_tpu.likelihood import LikelihoodEngine
from phylo_utils_tpu.models.base import Model

__all__ = ["Partition", "PartitionedEngine", "StackedPartitionedEngine",
           "partitions_from_file", "codon_position_partitions",
           "simulate_partitions"]


class Partition:
    """One locus: (name, alignment, model, mixture options)."""

    def __init__(self, name: str, alignment, model: Model, ncat: int = 1,
                 invariant_sites: bool = False, rate_model: str = "gamma"):
        self.name = name
        self.alignment = alignment
        self.model = model
        self.ncat = ncat
        self.invariant_sites = invariant_sites
        self.rate_model = rate_model


class PartitionedEngine:
    """Joint likelihood over partitions sharing one tree."""

    def __init__(
        self,
        tree: Union[ptrees.Tree, str],
        partitions: Sequence[Partition],
        dtype=None,
        link_rates: bool = True,
        sharding=None,
    ):
        if isinstance(tree, str):
            tree = pio.parse_newick(tree)
        if not partitions:
            raise ValueError("no partitions given")
        self.tree = tree
        self.partitions = list(partitions)
        self.link_rates = bool(link_rates)
        self.sharding = sharding
        names = [p.name for p in partitions]
        if len(set(names)) != len(names):
            raise ValueError("partition names must be unique")
        # sharding: each locus shards ITS OWN pattern axis over the mesh
        # (the per-engine pad/put machinery applies per partition); the
        # joint logL is then a sum of per-partition psums — still one
        # scalar allreduce per partition per step, all riding ICI
        self._engines = [
            LikelihoodEngine(
                tree, p.alignment, p.model, ncat=p.ncat,
                invariant_sites=p.invariant_sites, dtype=dtype,
                rate_model=p.rate_model, sharding=sharding,
            )
            for p in partitions
        ]
        self.dtype = self._engines[0].dtype
        self._site_counts = jnp.asarray(
            [float(np.asarray(e._weights).sum()) for e in self._engines],
            self.dtype,
        )
        # surface consumed by optimize.fit
        self._leaf_partials = tuple(e._leaf_partials for e in self._engines)
        self._weights = tuple(e._weights for e in self._engines)
        self._jit_fn = jax.jit(self._loglik_fn)
        self._jit_grad = jax.jit(
            jax.grad(lambda p, lp, w: self._loglik_fn(p, lp, w)[0])
        )

    # -- parameters ----------------------------------------------------------

    def default_params(self) -> Dict:
        params: Dict = {
            "branch_lengths": jnp.asarray(self.tree.lengths, self.dtype),
            "partitions": {
                p.name: {
                    k: v
                    for k, v in e.default_params().items()
                    if k != "branch_lengths"
                }
                for p, e in zip(self.partitions, self._engines)
            },
        }
        if self.link_rates and len(self.partitions) > 1:
            params["partition_rates"] = jnp.ones(
                (len(self.partitions),), self.dtype
            )
        return params

    def _full_params(self, params: Optional[Mapping]) -> Dict:
        full = self.default_params()
        if params:
            for k, v in params.items():
                if k == "partitions":
                    for pname, pv in v.items():
                        cur = dict(full["partitions"][pname])
                        for kk, vv in pv.items():
                            if kk == "model":
                                cur["model"] = {**cur["model"], **{
                                    m: jnp.asarray(x, self.dtype)
                                    for m, x in vv.items()
                                }}
                            else:
                                cur[kk] = jnp.asarray(vv, self.dtype)
                        full["partitions"][pname] = cur
                else:
                    full[k] = jnp.asarray(v, self.dtype)
        return full

    # -- computation ---------------------------------------------------------

    def _loglik_fn(self, params, leaf_partials, weights):
        t = params["branch_lengths"].astype(self.dtype)
        if "partition_rates" in params:
            r = params["partition_rates"].astype(self.dtype)
            # site-weighted mean 1: sum_p n_p r_p / sum_p n_p == 1
            r = r * jnp.sum(self._site_counts) / jnp.sum(self._site_counts * r)
        else:
            r = jnp.ones((len(self._engines),), self.dtype)
        total = jnp.zeros((), self.dtype)
        sitewise = []
        for i, (p, e) in enumerate(zip(self.partitions, self._engines)):
            sub = dict(params["partitions"][p.name])
            sub["branch_lengths"] = t * r[i]
            ll, sw = e._loglik_fn(sub, leaf_partials[i], weights[i])
            total = total + ll
            sitewise.append(sw)
        return total, tuple(sitewise)

    # -- public API ----------------------------------------------------------

    def loglikelihood(self, params: Optional[Mapping] = None) -> float:
        total, _ = self._jit_fn(
            self._full_params(params), self._leaf_partials, self._weights
        )
        return float(total)

    def partition_loglikelihoods(
        self, params: Optional[Mapping] = None
    ) -> Dict[str, float]:
        full = self._full_params(params)
        _, sws = self._jit_fn(full, self._leaf_partials, self._weights)
        out = {}
        for p, e, sw in zip(self.partitions, self._engines, sws):
            w = np.asarray(e._weights)
            out[p.name] = float((w * np.asarray(sw)).sum())
        return out

    def gradient(self, params: Optional[Mapping] = None) -> Dict:
        return self._jit_grad(
            self._full_params(params), self._leaf_partials, self._weights
        )


class StackedPartitionedEngine(PartitionedEngine):
    """Partitioned likelihood with the loci STACKED on one batch axis.

    ``PartitionedEngine`` inlines one engine subgraph per locus into the
    joint program; compile time and program size grow with partition
    count (r4 APPBENCH: the 4-engine L-BFGS chunk wedged the remote
    compiler, warm steps ran 35x slower per step than a single engine).
    When every locus shares the model FAMILY and mixture config (the
    common many-locus case — per-locus GTR+G4), the per-locus term is the
    same function at different parameters, so the loci belong on a vmap
    batch axis of ONE engine: leaf partials pad to a common pattern count
    and stack to ``(G, n_leaves, P, S)``, per-locus model params stack
    leaf-wise, and the program size is that of a single engine
    regardless of G.

    Same parameter tree, same optimizer surface, same public API as
    ``PartitionedEngine`` — drop-in wherever the loci are homogeneous in
    family; heterogeneous mixes (DNA+protein, differing ncat) still need
    the general engine.
    """

    def __init__(
        self,
        tree: Union[ptrees.Tree, str],
        partitions: Sequence[Partition],
        dtype=None,
        link_rates: bool = True,
        sharding=None,
    ):
        if isinstance(tree, str):
            tree = pio.parse_newick(tree)
        if not partitions:
            raise ValueError("no partitions given")
        names = [p.name for p in partitions]
        if len(set(names)) != len(names):
            raise ValueError("partition names must be unique")
        first = partitions[0]
        for p in partitions[1:]:
            if (
                p.model is not first.model
                or p.ncat != first.ncat
                or p.invariant_sites != first.invariant_sites
                or p.rate_model != first.rate_model
            ):
                raise ValueError(
                    "StackedPartitionedEngine requires every partition to "
                    "share the model family and mixture config "
                    f"(partition {p.name!r} differs from {first.name!r}); "
                    "use PartitionedEngine for heterogeneous loci"
                )
        self.tree = tree
        self.partitions = list(partitions)
        self.link_rates = bool(link_rates)
        self.sharding = sharding

        # ONE template engine supplies schedule, walk, mixture config;
        # its _loglik_fn is pure in (params, leaf_partials, weights) and
        # vmaps over the locus axis
        self._template = LikelihoodEngine(
            tree, first.alignment, first.model, ncat=first.ncat,
            invariant_sites=first.invariant_sites, dtype=dtype,
            rate_model=first.rate_model, sharding=sharding,
        )
        self.dtype = self._template.dtype
        self._engines = [self._template] * len(partitions)

        # per-locus compression, padded to a common pattern count
        # (all-ones partials / zero weights: logL-exact padding)
        comps = [
            pio.compress_patterns(p.alignment, first.model.alphabet)
            if not isinstance(p.alignment, pio.CompressedAlignment)
            else p.alignment
            for p in partitions
        ]
        for p, ca in zip(partitions, comps):
            missing = set(tree.leaf_names) - set(ca.names)
            if missing:
                raise ValueError(
                    f"partition {p.name!r} missing taxa {sorted(missing)}"
                )
        order_of = [
            [ca.names.index(n) for n in tree.leaf_names] for ca in comps
        ]
        pmax = max(ca.partials.shape[1] for ca in comps)
        if sharding is not None:
            pmax = sharding.padded_size(pmax)
        lps, ws = [], []
        for ca, order in zip(comps, order_of):
            lp = np.asarray(ca.partials)[np.asarray(order)]
            w = np.asarray(ca.weights)
            pad = pmax - lp.shape[1]
            if pad:
                lp = np.concatenate(
                    [lp, np.ones((lp.shape[0], pad, lp.shape[2]),
                                 lp.dtype)], axis=1,
                )
                w = np.concatenate([w, np.zeros(pad, w.dtype)])
            lps.append(lp)
            ws.append(w)
        self._compressed = comps
        lp_stack = np.stack(lps).astype(self.dtype)   # (G, L, P, S)
        w_stack = np.stack(ws).astype(self.dtype)     # (G, P)
        if sharding is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            ax = sharding.axis
            self._leaf_partials = jax.device_put(
                lp_stack, NamedSharding(sharding.mesh, P(None, None, ax,
                                                         None))
            )
            self._weights = jax.device_put(
                w_stack, NamedSharding(sharding.mesh, P(None, ax))
            )
        else:
            self._leaf_partials = jnp.asarray(lp_stack)
            self._weights = jnp.asarray(w_stack)
        self._site_counts = jnp.asarray(w_stack.sum(axis=1), self.dtype)
        self._jit_fn = jax.jit(self._loglik_fn)
        self._jit_grad = jax.jit(
            jax.grad(lambda p, lp, w: self._loglik_fn(p, lp, w)[0])
        )

    def _loglik_fn(self, params, leaf_partials, weights):
        t = params["branch_lengths"].astype(self.dtype)
        g = len(self.partitions)
        if "partition_rates" in params:
            r = params["partition_rates"].astype(self.dtype)
            r = r * jnp.sum(self._site_counts) / jnp.sum(
                self._site_counts * r
            )
        else:
            r = jnp.ones((g,), self.dtype)
        # stack the per-locus parameter trees leaf-wise -> one vmap axis
        subs = []
        for i, p in enumerate(self.partitions):
            sub = dict(params["partitions"][p.name])
            sub["branch_lengths"] = t * r[i]
            subs.append(sub)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *subs)
        totals, sws = jax.vmap(
            lambda s_, lp_, w_: self._template._loglik_fn(s_, lp_, w_)
        )(stacked, leaf_partials, weights)
        return jnp.sum(totals), sws

    def partition_loglikelihoods(
        self, params: Optional[Mapping] = None
    ) -> Dict[str, float]:
        full = self._full_params(params)
        _, sws = self._jit_fn(full, self._leaf_partials, self._weights)
        w = np.asarray(self._weights)
        sws = np.asarray(sws)
        return {
            p.name: float((w[i] * sws[i]).sum())
            for i, p in enumerate(self.partitions)
        }


def codon_position_partitions(
    name_prefix: str,
    alignment,
    model: Model,
    split: str = "12_3",
    **kwargs,
):
    """Partition an in-frame coding DNA alignment by codon position.

    The classic '1+2 vs 3' (``split="12_3"``) or fully separate
    (``split="1_2_3"``) partitioning for ``PartitionedEngine`` — third
    positions evolve much faster, and proportional branch lengths across
    the partitions capture that with one extra parameter per partition.
    """
    lens = {len(s) for s in alignment.values()}
    if len(lens) != 1 or next(iter(lens)) % 3:
        raise ValueError("alignment must be equal-length, in-frame codons")
    groups = {"12_3": [(0, 1), (2,)], "1_2_3": [(0,), (1,), (2,)]}[split]
    parts = []
    for g in groups:
        sub = {
            n: "".join(s[i] for i in range(len(s)) if i % 3 in g)
            for n, s in alignment.items()
        }
        label = name_prefix + "_pos" + "".join(str(p + 1) for p in g)
        parts.append(Partition(label, sub, model, **kwargs))
    return parts


def _expand_ranges(ranges, n_sites: int) -> list:
    """1-based inclusive (start, end, stride) triples -> sorted 0-based
    column indices, validated against the alignment width."""
    cols = []
    for start, end, stride in ranges:
        if end > n_sites:
            raise ValueError(
                f"site range {start}-{end} exceeds alignment length "
                f"{n_sites}"
            )
        cols.extend(range(start - 1, end, stride))
    seen = set()
    out = []
    for c in cols:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return sorted(out)


_DATATYPE_MODELS = {
    # RAxML-style data-type keywords -> our default model for that type
    "DNA": "GTR",
    "AA": "LG",
    "PROT": "LG",
    "PROTEIN": "LG",
}


def partitions_from_file(
    path_or_text: str,
    alignment: Mapping[str, str],
    default_model: str = "GTR",
    get_model=None,
) -> Tuple[list, Dict]:
    """Build :class:`Partition` objects from a RAxML/IQ-TREE-style
    partition file (or NEXUS charsets) over one concatenated alignment.

    Per-partition model strings use the shared +G[n]/+R[n]/+I/+F
    convention; RAxML data-type keywords (DNA, AA/PROT) map to GTR/LG.
    Entries without a model (NEXUS charsets) use ``default_model``.

    Returns ``(partitions, init_params)``: ``init_params`` carries the
    per-partition observed equilibrium frequencies for '+F' entries
    (frequencies are engine *parameters* here, not Partition state), in
    the shape ``PartitionedEngine._full_params`` consumes.
    """
    from phylo_utils_tpu.alphabets import empirical_frequencies
    from phylo_utils_tpu.models import parse_model_spec

    specs = pio.parse_partition_file(path_or_text)
    lens = {len(s) for s in alignment.values()}
    if len(lens) != 1:
        raise ValueError("sequences have unequal lengths")
    (n_sites,) = lens
    parts = []
    init: Dict = {}
    for spec in specs:
        mstr = spec["model"] or default_model
        head, _, rest = mstr.partition("+")
        mapped = _DATATYPE_MODELS.get(head.upper())
        if mapped:
            mstr = mapped + (("+" + rest) if rest else "")
        model, ncat, inv, emp, rate_model = parse_model_spec(
            mstr, get_model=get_model
        )
        cols = _expand_ranges(spec["ranges"], n_sites)
        sub = {
            name: "".join(s[i] for i in cols)
            for name, s in alignment.items()
        }
        parts.append(Partition(
            spec["name"], sub, model, ncat=ncat, invariant_sites=inv,
            rate_model=rate_model,
        ))
        if emp:
            if "freqs" not in model.param_defaults:
                raise ValueError(
                    f"partition {spec['name']!r}: model {model.name!r} "
                    "has no 'freqs' parameter for '+F'"
                )
            init.setdefault("partitions", {})[spec["name"]] = {
                "model": {"freqs": empirical_frequencies(
                    sub, model.alphabet, pseudocount=0.5
                ).tolist()},
            }
    return parts, init


def simulate_partitions(key, engine: PartitionedEngine,
                        params: Optional[Mapping] = None) -> Dict:
    """Simulate one alignment per partition at the engine's parameters.

    Each partition simulates under its own model/mixture with the SHARED
    branch lengths scaled by its (normalized) partition rate — the exact
    generative counterpart of ``PartitionedEngine._loglik_fn``. Site
    counts follow each partition's observed alignment. Returns
    ``{partition_name: {taxon: sequence}}``; concatenate in partition
    order for a seq-gen-style multi-locus matrix. Use for parametric
    bootstraps / adequacy checks of partitioned fits.
    """
    import jax as _jax

    from phylo_utils_tpu.simulate import simulate_alignment

    full = engine._full_params(params)
    t = np.asarray(full["branch_lengths"], np.float64)
    if "partition_rates" in full:
        r = np.asarray(full["partition_rates"], np.float64)
        sc = np.asarray(engine._site_counts, np.float64)
        r = r * sc.sum() / (sc * r).sum()
    else:
        r = np.ones(len(engine.partitions))
    keys = _jax.random.split(key, len(engine.partitions))
    out: Dict = {}
    for i, (p, e) in enumerate(zip(engine.partitions, engine._engines)):
        if p.rate_model == "free":
            raise ValueError(
                f"partition {p.name!r}: FreeRate simulation is not "
                "supported (no generative alpha); use a gamma partition"
            )
        sub = full["partitions"][p.name]
        sim_params = {k: np.asarray(v) for k, v in sub["model"].items()}
        if p.ncat > 1 and "alpha" in sub:
            sim_params["alpha"] = np.asarray(sub["alpha"])
        pinv = float(sub["pinv"]) if p.invariant_sites else 0.0
        out[p.name] = simulate_alignment(
            keys[i],
            engine.tree.with_lengths(t * r[i]),
            p.model,
            e._compressed.n_sites,
            params=sim_params,
            ncat=p.ncat,
            pinv=pinv,
        )
    return out
