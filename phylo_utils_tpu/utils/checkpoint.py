"""Checkpoint / resume for optimizer runs.

The reference has nothing long-running enough to checkpoint (SURVEY.md §5
[HIGH]); this is new design: the entire optimization state is one
PyTree ``{params, opt_state, step, ...}`` of pure data, so checkpointing is
exact — save on host 0, restore anywhere, continue bit-for-bit (modulo
compiler nondeterminism). Format: a single ``.npz`` with '/'-joined PyTree
key paths + a JSON treedef sidecar entry, atomic rename on write. No orbax
dependency needed at this scale; the layout is orbax-msgpack-adjacent and
swappable.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Dict, Tuple

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

_META_KEY = "__pytree_meta__"


def _flatten_with_paths(tree: Any):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key or "__root__"] = np.asarray(leaf)
    return out, treedef


def save_checkpoint(path: str, state: Any, step: int = 0,
                    extra: Dict[str, Any] | None = None) -> None:
    """Atomically write ``state`` (any PyTree of arrays/scalars) to ``path``.

    Multi-host safe: only process 0 writes; other processes no-op.
    """
    if jax.process_index() != 0:
        return
    state = jax.device_get(state)
    leaves, treedef = _flatten_with_paths(state)
    meta = {
        "step": int(step),
        "treedef": str(treedef),
        "keys": list(leaves.keys()),
        "extra": extra or {},
    }
    buf = io.BytesIO()
    np.savez(buf, **leaves, **{_META_KEY: np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore a PyTree with the structure of ``like`` from ``path``.

    Returns ``(state, step, extra)``. Leaf dtypes/shapes come from the file;
    ``like`` supplies the tree structure (so opt_state namedtuples survive).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
        keys, treedef = _leaf_keys_and_treedef(like)
        leaves = []
        for key in keys:
            if key not in z:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            leaves.append(z[key])
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    return state, meta["step"], meta.get("extra", {})


def _leaf_keys_and_treedef(tree: Any):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        or "__root__"
        for path, _ in flat
    ]
    return keys, treedef
