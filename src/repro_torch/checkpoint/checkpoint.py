"""Per-party checkpoints (the port's counterpart of
``repro.checkpoint.checkpoint``).

Each party keeps only its own segment: ``save_split`` writes one ``.npz``
per party under ``step_{step:08d}/``, ``owner{i}.npz`` for each owner's
head and ``trunk.npz`` for the scientist's.  ``save`` / ``restore`` are
the single-tree primitives: a tree's leaves as numpy arrays keyed by
their path (``a/b/#i/...``, ``#i`` for a list entry), the reference's
keys, so each package reads the other's files.

Tensors cross to numpy on the host.  The owner count is the number of
heads: the leading dim of stacked heads, or the length of a list of
per-owner head segments (owners of unequal widths, one file each).
``restore_split`` reads the owner files in numeric order (``owner2``
before ``owner10``) and stacks them again where every owner's leaves
have one shape, else returns them as a list.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List

import numpy as np

from repro_torch.tree import tree_leaves, tree_map

_OWNER_FILE = re.compile(r"owner(\d+)\.npz")


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):                    # a tensor, on any device
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = _host(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Any = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def fix(node):
        if isinstance(node, dict) and node and all(
                re.fullmatch(r"#\d+", k) for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def restore(path: str):
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def _owner_trees(heads) -> List[Any]:
    """One head tree per owner: the entries of a list of per-owner
    segments, else slices of the owner-stacked leaves."""
    if isinstance(heads, list) and heads and all(
            isinstance(h, (list, tuple)) for h in heads):
        return list(heads)
    host = tree_map(_host, heads)
    n = tree_leaves(host)[0].shape[0]
    return [tree_map(lambda a, p=p: a[p], host) for p in range(n)]


def save_split(ckpt_dir: str, params, step: int = 0) -> str:
    """One file per party: ``owner{i}.npz`` per owner, ``trunk.npz``;
    returns the step's directory."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    for p, tree in enumerate(_owner_trees(params["heads"])):
        save(os.path.join(d, f"owner{p}.npz"), tree)
    save(os.path.join(d, "trunk.npz"), params["trunk"])
    return d


def restore_split(step_dir: str):
    """``{"heads": ..., "trunk": ...}`` (numpy leaves) from the files of
    :func:`save_split`: the owners' heads stacked where their leaves
    have one shape, else a list of per-owner segments."""
    found = {int(m.group(1)): f for f in os.listdir(step_dir)
             if (m := _OWNER_FILE.fullmatch(f))}
    trees = [restore(os.path.join(step_dir, found[p]))
             for p in sorted(found)]
    shapes = {tuple(a.shape for a in tree_leaves(t)) for t in trees}
    heads = (tree_map(lambda *a: np.stack(a), *trees) if len(shapes) == 1
             else trees)
    return {"heads": heads,
            "trunk": restore(os.path.join(step_dir, "trunk.npz"))}
