"""Per-branch support values: aLRT and SH-aLRT (+ RELL edge bootstrap).

The reference has no support machinery (SURVEY.md §2). This implements the
standard fast supports:

- **aLRT** (Anisimova & Gascuel 2006): for each internal edge, the test
  statistic 2(lnL - lnL') where lnL' is the best of the NNI
  rearrangements around that edge; parametric support from the
  ½χ²(0)+½χ²(1) mixture null.
- **SH-aLRT** (Guindon et al. 2010 flavor): the same statistic judged
  against a RELL-bootstrap centered null (no re-optimization per
  replicate), robust to model misspecification.

Batched: ALL NNI alternatives across ALL edges are scored (and their
branch lengths re-optimized) in ONE ``TopologySetEngine`` program — the
per-edge loop is a host-side regrouping of one batched device run.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from phylo_utils_tpu import trees as ptrees

__all__ = ["nni_alternatives_by_edge", "alrt_supports",
           "bootstrap_tree_support", "transfer_bootstrap_supports",
           "site_concordance", "gene_concordance"]


def nni_alternatives_by_edge(tree: ptrees.Tree):
    """{internal node v: NNI rearrangements around the edge above v}.

    Mirrors ``trees.nni_neighbors`` (each child of v exchanged with each
    sibling of v) but grouped by the edge being tested.
    """
    base = {n: list(tree.children[n]) for n in range(tree.n_nodes)}
    out: Dict[int, list] = {}
    root = tree.root
    root_bifurcating = len(tree.children[root]) == 2
    for v in range(tree.n_leaves, tree.n_nodes):
        if v == root:
            continue
        u = int(tree.parent[v])
        alts = []
        if u == root and root_bifurcating:
            # the two root-child edges are ONE unrooted edge (see
            # trees.nni_neighbors): true NNI exchanges a child of v with
            # a child of the sibling; tested once, keyed by the lower id
            (s,) = [k for k in tree.children[u] if k != v]
            if s < tree.n_leaves or s < v:
                continue
            for c in tree.children[v]:
                for c2 in tree.children[s]:
                    cm = {n: list(k) for n, k in base.items()}
                    cm[v] = [c2 if k == c else k for k in cm[v]]
                    cm[s] = [c if k == c2 else k for k in cm[s]]
                    alts.append(ptrees._rebuild_with_children(tree, cm))
        else:
            for s in tree.children[u]:
                if s == v:
                    continue
                for c in tree.children[v]:
                    cm = {n: list(k) for n, k in base.items()}
                    cm[v] = [s if k == c else k for k in cm[v]]
                    cm[u] = [c if k == s else k for k in cm[u]]
                    alts.append(ptrees._rebuild_with_children(tree, cm))
        if alts:
            out[v] = alts
    return out


def alrt_supports(
    tree,
    alignment,
    model,
    ncat: int = 1,
    params: Optional[Mapping] = None,
    brlen_steps: int = 60,
    n_boot: int = 1000,
    seed: int = 0,
    dtype=None,
    batch_topologies: Optional[int] = 64,
) -> Dict:
    """aLRT + SH-aLRT supports for every internal edge.

    Branch lengths of the input tree are optimized first (model params
    from ``params`` stay fixed); every NNI alternative's branch lengths
    are re-optimized jointly in one batched program. Returns a dict:
    ``edges`` (node ids whose parent edge is tested), ``stat`` (2ΔlnL),
    ``alrt`` (parametric mixture-χ² support), ``sh_alrt`` (RELL support),
    ``loglik`` (optimized base-tree logL), ``tree`` (the optimized tree).
    """
    from scipy.stats import chi2

    from phylo_utils_tpu.batched import chunked_brlen_optimize
    from phylo_utils_tpu.io import parse_newick
    from phylo_utils_tpu.likelihood import LikelihoodEngine
    from phylo_utils_tpu.optimize import fit

    if isinstance(tree, str):
        tree = parse_newick(tree)
    engine = LikelihoodEngine(tree, alignment, model, ncat=ncat, dtype=dtype)
    res = fit(engine, params0=params, free=("branch_lengths",),
              max_steps=200, patience=15)
    tree = tree.with_lengths(np.asarray(res.params["branch_lengths"]))
    ll0 = res.loglik
    sw0 = engine.sitewise_loglikelihoods(res.params)

    by_edge = nni_alternatives_by_edge(tree)
    edges = sorted(by_edge)
    if not edges:
        return {"edges": [], "stat": np.zeros(0), "alrt": np.zeros(0),
                "sh_alrt": np.zeros(0), "abayes": np.zeros(0),
                "loglik": ll0, "tree": tree}
    alts = [t for e in edges for t in by_edge[e]]
    owners = np.asarray([e for e in edges for _ in by_edge[e]])

    tse_params = dict(params or {})
    for k in ("branch_lengths",):
        tse_params.pop(k, None)
    # chunked: bounds the batched gradient's scan-VJP residual memory and
    # each chunk reuses ONE compiled program (see chunked_brlen_optimize)
    lls, bls, sw_alts, _ = chunked_brlen_optimize(
        alts, alignment, model, ncat=ncat, steps=brlen_steps,
        params=tse_params or None, dtype=dtype,
        batch_chunk=batch_topologies,
    )                                                    # sw: (A, n_sites)

    stat = np.empty(len(edges))
    sh = np.empty(len(edges))
    rng_seed = seed
    # one shared RELL count matrix across edges
    n_sites = sw0.shape[0]
    rng = np.random.default_rng(rng_seed)
    counts = rng.multinomial(
        n_sites, np.full(n_sites, 1.0 / n_sites), size=n_boot
    ).astype(np.float64)
    for i, e in enumerate(edges):
        rows = np.nonzero(owners == e)[0]
        best = rows[np.argmax(lls[rows])]
        delta = ll0 - float(lls[best])
        stat[i] = max(2.0 * delta, 0.0)
        # RELL centered null of the pairwise statistic (KH-style)
        dsite = sw0 - sw_alts[best]                      # (n_sites,)
        centered = dsite - dsite.mean()
        boot = counts @ centered                         # (n_boot,)
        sh[i] = float((boot < delta).mean())
    alrt = 1.0 - 0.5 * chi2.sf(stat, df=1)
    # a negative observed delta (alternative better) is zero support
    alrt = np.where(stat <= 0.0, 0.0, alrt)
    sh = np.where(stat <= 0.0, 0.0, sh)
    # aBayes (Anisimova et al. 2011): posterior of the current config
    # among the three NNI resolutions under a uniform prior = softmax of
    # the three logLs (the base tree's plus the two best alternatives)
    abayes = np.empty(len(edges))
    for i, e in enumerate(edges):
        rows = np.nonzero(owners == e)[0]
        alt_lls = np.sort(lls[rows])[::-1][:2]      # two NNI resolutions
        trio = np.concatenate([[ll0], alt_lls])
        m0 = trio.max()
        w = np.exp(trio - m0)
        abayes[i] = float(w[0] / w.sum())
    return {
        "edges": edges,
        "stat": stat,
        "alrt": np.asarray(alrt),
        "sh_alrt": np.asarray(sh),
        "abayes": abayes,
        "loglik": ll0,
        "tree": tree,
    }


def bootstrap_tree_support(
    tree,
    alignment,
    model,
    n_reps: int = 100,
    params: Optional[Mapping] = None,
    seed: int = 0,
    dtype=None,
    consensus: bool = False,
    tbe: bool = False,
    rep_chunk: Optional[int] = None,
) -> Dict:
    """Felsenstein bootstrap supports via distance/NJ replicate trees.

    Each replicate resamples alignment columns (a multinomial draw over
    pattern weights — no data copying), recomputes ALL pairwise ML
    distances for ALL replicates in one batched Newton program (the
    (replicate x pair) grid is a single vmap-of-vmap on device), builds
    the NJ tree per replicate on the host, and counts how often each of
    ``tree``'s internal edges (as unrooted bipartitions) re-appears.

    Returns ``{"edges": node ids, "support": (E,) fractions,
    "n_reps": B}``; with ``consensus=True`` also the majority-rule
    consensus Tree of the replicate NJ trees (internal labels carry
    percent support, lengths are split means); with ``tbe=True`` also
    per-edge Transfer Bootstrap Expectation supports (see
    ``transfer_bootstrap_supports``). Classic nonparametric supports — complementary to the
    likelihood-based ``alrt_supports``.
    """
    import jax
    import jax.numpy as jnp

    from phylo_utils_tpu import io as pio
    from phylo_utils_tpu.nj import neighbor_joining
    from phylo_utils_tpu.optimize import newton_branch_length

    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    ca = (
        alignment
        if isinstance(alignment, pio.CompressedAlignment)
        else pio.compress_patterns(alignment, model.alphabet)
    )
    names = list(ca.names)
    order = [names.index(n) for n in tree.leaf_names]
    dt = jnp.dtype(dtype) if dtype else jnp.dtype(jnp.result_type(float))
    eig = model.eigen(params, dtype=dt)
    partials = jnp.asarray(ca.partials, dt)[np.asarray(order)]
    w = np.asarray(ca.weights, np.float64)
    n_sites = int(w.sum())
    n = partials.shape[0]
    ii, jj = np.triu_indices(n, k=1)

    rng = np.random.default_rng(seed)
    wb = rng.multinomial(
        n_sites, w / w.sum(), size=n_reps
    ).astype(np.float64)                                  # (B, P)

    # replicates run in fixed-size CHUNKS (one compiled program, host
    # loop): a single (B x pairs) program at 64 taxa x B=100 is ~200k
    # vmapped Newton instances, each carrying full (P, S) temporaries —
    # tens of GB of device memory. Cap the per-dispatch instance count; the
    # chunk shape is fixed so ONE compile serves every dispatch.
    n_pairs = int(ii.shape[0])
    if rep_chunk is None:
        rep_chunk = min(int(n_reps), max(1, 4096 // max(n_pairs, 1)))
    rep_chunk = max(1, min(int(rep_chunk), int(n_reps)))

    @jax.jit
    def solve_chunk(partials, wbc):
        def one_rep(wrow):
            def one(i, j):
                t, _ = newton_branch_length(
                    eig, partials[i], partials[j], wrow
                )
                return t
            return jax.vmap(one)(jnp.asarray(ii), jnp.asarray(jj))
        return jax.vmap(one_rep)(wbc)

    chunks = []
    for b0 in range(0, n_reps, rep_chunk):
        wbc = wb[b0:b0 + rep_chunk]
        pad = rep_chunk - wbc.shape[0]
        if pad:
            wbc = np.concatenate([wbc, wbc[-1:].repeat(pad, 0)], axis=0)
        got = np.asarray(solve_chunk(partials, jnp.asarray(wbc, dt)),
                         np.float64)
        chunks.append(got[:rep_chunk - pad if pad else rep_chunk])
    ts = np.concatenate(chunks, axis=0)

    # reference bipartitions, keyed by the node whose parent edge they are
    leaf_names = tree.leaf_names
    all_names = frozenset(leaf_names)
    anchor = min(all_names)
    below: Dict[int, frozenset] = {}
    edge_split: Dict[int, frozenset] = {}
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            below[node] = frozenset((tree.names[node],))
            continue
        s = frozenset().union(*(below[c] for c in kids))
        below[node] = s
        if node != tree.root and 1 < len(s) < len(all_names) - 1:
            edge_split[node] = s if anchor not in s else all_names - s
    # a bifurcating root's two child edges are ONE unrooted bipartition:
    # report it once (lower internal id), like alrt_supports
    rk = tree.children[tree.root]
    if len(rk) == 2 and all(k in edge_split for k in rk):
        edge_split.pop(max(rk), None)
    edges = sorted(edge_split)
    counts = {e: 0 for e in edges}
    rep_trees = []
    for b in range(n_reps):
        d = np.zeros((n, n))
        d[ii, jj] = ts[b]
        d[jj, ii] = ts[b]
        rep = neighbor_joining(d, list(leaf_names))
        rep_trees.append(rep)
        rep_splits = ptrees._splits(rep)
        for e in edges:
            if edge_split[e] in rep_splits:
                counts[e] += 1
    support = np.asarray([counts[e] / n_reps for e in edges])
    out = {"edges": edges, "support": support, "n_reps": n_reps}
    if tbe:
        out["tbe"] = transfer_bootstrap_supports(
            tree, rep_trees, edges=edges
        )["support"]
    if consensus:
        out["consensus"] = ptrees.majority_rule_consensus(rep_trees)
    return out


def _edge_indicators(tree: ptrees.Tree, leaf_index: Dict[str, int]):
    """(E, L) bool indicator matrix over internal edges + the edge list."""
    below: Dict[int, np.ndarray] = {}
    rows = []
    edges = []
    n_l = len(leaf_index)
    for node in tree.postorder():
        kids = tree.children[node]
        if not kids:
            v = np.zeros(n_l, bool)
            v[leaf_index[tree.names[node]]] = True
            below[node] = v
            continue
        v = np.zeros(n_l, bool)
        for c in kids:
            v |= below[c]
        below[node] = v
        if node != tree.root and 1 < int(v.sum()) < n_l - 1:
            rows.append(v)
            edges.append(node)
    if rows:
        return np.stack(rows), edges
    return np.zeros((0, n_l), bool), edges


def transfer_bootstrap_supports(
    tree,
    replicate_trees,
    edges=None,
) -> Dict:
    """Transfer Bootstrap Expectation (TBE; Lemoine et al. 2018, Nature
    556:452): per reference edge b with lighter side size p,
    ``1 - mean_replicates( delta(b, T*) ) / (p - 1)`` where delta is the
    minimum transfer distance from b to ANY edge of the replicate
    (capped at p-1, the leaf-edge bound). Recovers the classical
    Felsenstein proportion on cherries (p = 2) and degrades gracefully
    on deep edges of large taxon sets where FBP collapses to 0.

    ``tree``: reference topology (Tree or newick str);
    ``replicate_trees``: iterable of Trees over the same taxa;
    ``edges``: optional node-id list to report (default: all internal
    edges, bifurcating-root duplicate removed). Returns {"edges",
    "support", "n_reps"}.
    """
    from phylo_utils_tpu import io as pio

    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    leaf_index = {n: i for i, n in enumerate(sorted(tree.leaf_names))}
    n_l = len(leaf_index)
    ind, edge_ids = _edge_indicators(tree, leaf_index)
    if edges is not None:
        # preserve the CALLER's edge order so support rows align
        pos = {e: i for i, e in enumerate(edge_ids)}
        keep = [pos[e] for e in edges if e in pos]
        ind = ind[keep]
        edge_ids = [edge_ids[i] for i in keep]
    else:
        # bifurcating root: its two child edges are one unrooted split
        rk = tree.children[tree.root]
        if len(rk) == 2:
            drop = max(rk)
            keep = [i for i, e in enumerate(edge_ids) if e != drop]
            ind, edge_ids = ind[keep], [edge_ids[i] for i in keep]
    sizes = ind.sum(axis=1)
    p = np.minimum(sizes, n_l - sizes)            # lighter side (E,)
    cap = np.maximum(p - 1, 1)
    reps = list(replicate_trees)
    delta_sum = np.zeros(len(edge_ids))
    for rep in reps:
        if set(rep.leaf_names) != set(tree.leaf_names):
            raise ValueError("replicate tree has a different taxon set")
        rind, _ = _edge_indicators(rep, leaf_index)
        if rind.shape[0] == 0:
            delta = np.minimum(cap, p - 1)        # only leaf-edge bound
        else:
            sz = rind.sum(axis=1)                  # (E',)
            ov = ind.astype(np.int64) @ rind.T.astype(np.int64)  # (E, E')
            ham = sizes[:, None] + sz[None, :] - 2 * ov
            ham = np.minimum(ham, n_l - ham)       # complement side
            delta = np.minimum(ham.min(axis=1), p - 1)
        delta_sum += np.minimum(delta, cap)
    support = 1.0 - (delta_sum / max(len(reps), 1)) / cap
    return {
        "edges": edge_ids,
        "support": support,
        "n_reps": len(reps),
    }


def site_concordance(
    tree,
    alignment: Mapping[str, str],
    n_quartets: int = 100,
    seed: int = 0,
) -> Dict:
    """Site concordance factors (sCF; Minh, Hahn & Lanfear 2020, MBE
    37:2727 — IQ-TREE's ``--scf``).

    For every internal branch, sample ``n_quartets`` quartets with one
    leaf from each of the four subtrees hanging off the branch's two
    ends; a site is DECISIVE for a quartet when it is parsimony-
    informative on it (exactly two states, two leaves each), and
    CONCORDANT when it groups the two leaves on the same side of the
    branch. sCF(branch) = mean over quartets of the fraction of
    decisive sites that are concordant (~1/3 under no signal; near 1 on
    clean data). Complements the likelihood-based aLRT and the
    bootstrap: sCF measures per-site signal directly, without a model.

    Returns {"edges": node ids (the node below each branch),
    "scf": (E,) percent values, "sdf1"/"sdf2": the two discordant
    fractions, "n_decisive": mean decisive sites per quartet}.
    """
    from phylo_utils_tpu import io as pio

    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    names = tree.leaf_names
    first = next(iter(alignment.values()))
    n_sites = len(first)
    # encode to small ints; ambiguity/gaps -> -1 (site skipped for that
    # leaf). DNA alignments keep only unambiguous ACGT; anything with
    # other letters is treated as protein (X/gaps missing).
    observed = {c for s in alignment.values() for c in s.upper()}
    if observed <= set("ACGTUNRYSWKMBDHV-?.*"):
        alphabet = "ACGT"
    else:
        alphabet = "ACDEFGHIKLMNPQRSTVWY"
    charmap = {c: i for i, c in enumerate(alphabet)}
    charmap["U"] = charmap.get("T", -1)
    enc = np.full((tree.n_leaves, n_sites), -1, np.int8)
    for li, nm in enumerate(names):
        seq = alignment[nm].upper()
        for si, ch in enumerate(seq):
            enc[li, si] = charmap.get(ch, -1)

    # leaf sets below every node
    below: Dict[int, list] = {}
    for node in tree.postorder():
        kids = tree.children[node]
        below[node] = (
            [node] if not kids
            else [x for c in kids for x in below[c]]
        )
    all_leaves = set(range(tree.n_leaves))

    rng = np.random.default_rng(seed)
    # a bifurcating root's two child edges are ONE unrooted branch:
    # report it once, keyed by the lower id (same convention as
    # gene_concordance / transfer_bootstrap_supports)
    rk = tree.children[tree.root]
    skip_dup = max(rk) if len(rk) == 2 else -1
    edges, scf, sdf1, sdf2, ndec = [], [], [], [], []
    for v in range(tree.n_leaves, tree.n_nodes):
        if v == tree.root or v == skip_dup:
            continue
        kids = tree.children[v]
        if len(kids) < 2:
            continue
        a_set, b_set = below[kids[0]], below[kids[1]]
        parent = int(tree.parent[v])
        sibs = [c for c in tree.children[parent] if c != v]
        if parent == tree.root and len(sibs) == 1:
            # bifurcating root: the "other side" is the sibling subtree —
            # split it at ITS children to get the third/fourth groups
            skids = tree.children[sibs[0]]
            if len(skids) < 2:
                continue                   # sibling is a leaf: no quartet
            c_set, d_set = below[skids[0]], below[skids[1]]
        elif parent == tree.root:
            # multifurcating (unrooted-style) root: split the remaining
            # root children into the third/fourth groups
            c_set = below[sibs[0]]
            d_set = [x for s in sibs[1:] for x in below[s]]
        else:
            c_set = [x for s in sibs for x in below[s]]
            d_set = sorted(
                all_leaves - set(below[v]) - set(c_set)
            )
        if not c_set or not d_set:
            continue
        conc = disc1 = disc2 = dec = 0
        for _ in range(n_quartets):
            a = a_set[rng.integers(len(a_set))]
            b = b_set[rng.integers(len(b_set))]
            c = c_set[rng.integers(len(c_set))]
            d = d_set[rng.integers(len(d_set))]
            sa, sb, sc, sd = enc[a], enc[b], enc[c], enc[d]
            ok = (sa >= 0) & (sb >= 0) & (sc >= 0) & (sd >= 0)
            # parsimony-informative on the quartet: 2 states x 2 leaves
            ab = sa == sb
            cd = sc == sd
            ac = sa == sc
            bd = sb == sd
            ad = sa == sd
            bc = sb == sc
            support_ab = ok & ab & cd & ~ac           # ab|cd
            support_ac = ok & ac & bd & ~ab           # ac|bd
            support_ad = ok & ad & bc & ~ab           # ad|bc
            conc += int(support_ab.sum())
            disc1 += int(support_ac.sum())
            disc2 += int(support_ad.sum())
            dec += int((support_ab | support_ac | support_ad).sum())
        edges.append(v)
        tot = max(dec, 1)
        scf.append(100.0 * conc / tot)
        sdf1.append(100.0 * disc1 / tot)
        sdf2.append(100.0 * disc2 / tot)
        ndec.append(dec / n_quartets)
    return {
        "edges": edges,
        "scf": np.asarray(scf),
        "sdf1": np.asarray(sdf1),
        "sdf2": np.asarray(sdf2),
        "n_decisive": np.asarray(ndec),
    }


def gene_concordance(tree, gene_trees) -> Dict:
    """Gene concordance factors (gCF; Minh, Hahn & Lanfear 2020): for
    every internal branch of ``tree``, the percentage of ``gene_trees``
    (single-locus estimates, any source) that contain the branch's
    bipartition, counted over the genes whose taxon set covers both
    sides (missing-taxon gene trees are skipped per branch). The
    model-free companion of ``site_concordance``.

    Returns {"edges", "gcf" (percent), "n_informative" (genes counted
    per branch)}.
    """
    from phylo_utils_tpu import io as pio

    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    leaf_index = {n: i for i, n in enumerate(sorted(tree.leaf_names))}
    ind, edge_ids = _edge_indicators(tree, leaf_index)
    rk = tree.children[tree.root]
    if len(rk) == 2:
        keep = [i for i, e in enumerate(edge_ids) if e != max(rk)]
        ind, edge_ids = ind[keep], [edge_ids[i] for i in keep]
    all_names = frozenset(tree.leaf_names)
    anchor = min(all_names)
    ref_splits = []
    for row in ind:
        side = frozenset(
            nm for nm, i in leaf_index.items() if row[i]
        )
        ref_splits.append(side if anchor not in side
                          else all_names - side)
    counts = np.zeros(len(edge_ids))
    informative = np.zeros(len(edge_ids))
    for g in gene_trees:
        if isinstance(g, str):
            g = pio.parse_newick(g)
        gset = set(g.leaf_names)
        gsplits = set(ptrees._splits(g))
        for i, sp in enumerate(ref_splits):
            a = sp & gset
            b = (all_names - sp) & gset
            if len(a) < 2 or len(b) < 2:
                continue                      # gene can't inform this edge
            informative[i] += 1
            # restrict the reference split to the gene's taxa and
            # canonicalize against the gene's own anchor
            ganchor = min(gset)
            cand = a if ganchor not in a else frozenset(gset) - a
            if cand in gsplits:
                counts[i] += 1
    gcf = np.where(informative > 0, 100.0 * counts /
                   np.maximum(informative, 1), np.nan)
    return {"edges": edge_ids, "gcf": gcf, "n_informative": informative}
