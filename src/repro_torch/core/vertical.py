"""Vertical partitioning of datasets across data owners (numpy; a copy
of ``repro.core.vertical``: feature columns for the MLP path, sequence
spans for the split LM).

The paper's MNIST experiment splits each image into a left and a right
half; generally, each data owner holds a disjoint vertical slice of every
data subject's features.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

Owners = Union[int, Sequence[int]]


def _split_points(width: int, owners: Owners, what: str) -> np.ndarray:
    """Resolve an owner spec (count, or explicit per-owner sizes) to the
    interior split offsets for ``np.split``."""
    if isinstance(owners, (int, np.integer)):
        if width % owners:
            raise ValueError(
                f"{what} {width} not divisible by {owners} owners; pass "
                f"explicit per-owner sizes instead")
        sizes: Sequence[int] = (width // owners,) * int(owners)
    else:
        sizes = tuple(int(s) for s in owners)
        if not sizes or any(s <= 0 for s in sizes):
            raise ValueError(f"owner sizes must be positive: {sizes}")
        if sum(sizes) != width:
            raise ValueError(
                f"owner sizes {sizes} sum to {sum(sizes)} != {what} {width}")
    return np.cumsum(sizes)[:-1]


def partition_features(x: np.ndarray, owners: Owners) -> List[np.ndarray]:
    """Split feature columns (axis -1) into contiguous owner slices."""
    return list(np.split(x, _split_points(x.shape[-1], owners, "features"),
                         axis=-1))


def partition_sequence(tokens: np.ndarray, owners: Owners
                       ) -> List[np.ndarray]:
    """Split the sequence dim (axis 1) into contiguous owner slices.
    ``owners``: a count or explicit per-owner slice lengths."""
    return list(np.split(tokens, _split_points(tokens.shape[1], owners,
                                               "seq"), axis=1))


def unpartition(slices: List[np.ndarray], axis: int = -1) -> np.ndarray:
    """Inverse of the partitioners."""
    return np.concatenate(slices, axis=axis)


def make_ids(n: int, prefix: str = "subject") -> List[str]:
    return [f"{prefix}-{i:08d}" for i in range(n)]


def scatter_to_owners(ids: List[str], slices: List[np.ndarray],
                      rng: np.random.Generator,
                      keep_frac: float = 0.9
                      ) -> List[Tuple[List[str], np.ndarray]]:
    """Simulate real-world silos: each owner independently holds a random
    subset of the subjects (so PSI has actual work to do) and stores rows
    in its own random order."""
    out = []
    n = len(ids)
    for sl in slices:
        keep = rng.random(n) < keep_frac
        idx = np.flatnonzero(keep)
        rng.shuffle(idx)
        out.append(([ids[i] for i in idx], sl[idx]))
    return out
