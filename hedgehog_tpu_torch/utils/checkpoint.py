"""Checkpoint and resume (port of ``hedgehog_tpu/utils/checkpoint.py``).

Monte Carlo state never needs a checkpoint: every path is re-derived from
its counter-based coordinates (seed, device, pair, block).  What persists is
calibration state (parameter vectors part-way through a fit) and calibrated
market objects (curves, surfaces): trees of frozen dataclasses, dicts, lists
and tuples whose leaves are tensors, numpy arrays and numbers
(:func:`~hedgehog_tpu_torch.utils.map_leaves`).  They round-trip through
the JAX package's npz layout, ``__n_leaves__`` and ``leaf_{i}`` in
``jax.tree.leaves`` order, so a dict of arrays written by either package
loads in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from . import map_leaves, tree_leaves

__all__ = ["save_pytree", "load_pytree"]


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Write the leaves of ``tree`` to ``<path>.npz`` (``np.savez`` adds the
    suffix where ``path`` lacks it).  The structure is not stored: loading
    takes it from an example tree."""
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _host_array(leaf) for i, leaf in enumerate(leaves)}
    np.savez(path, __n_leaves__=len(leaves), **arrays)


def _like_leaf(array: np.ndarray, like):
    """``array`` as a leaf of ``like``'s kind: a tensor of its dtype on its
    device, an array of its dtype, or a number of its type."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(array, dtype=like.dtype).to(like.device)
    if isinstance(like, np.ndarray):
        return np.asarray(array, dtype=like.dtype)
    if isinstance(like, np.generic):
        return like.dtype.type(array)
    return type(like)(array.item())


def load_pytree(path: str, like: Any) -> Any:
    """The tree saved by :func:`save_pytree` at ``path`` (``.npz`` added
    where missing), in the structure of ``like``: each leaf takes the kind,
    dtype and device of ``like``'s leaf in its place; dates, markers,
    strings and flags come from ``like``."""
    p = Path(path)
    if p.suffix != ".npz":
        p = p.with_name(p.name + ".npz")
    with np.load(p) as data:
        n = int(data["__n_leaves__"])
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    n_like = len(tree_leaves(like))
    if n_like != n:
        raise ValueError(f"checkpoint has {n} leaves; example tree has {n_like}")
    it = iter(arrays)
    return map_leaves(lambda leaf: _like_leaf(next(it), leaf), like)
