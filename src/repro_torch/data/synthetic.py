"""Synthetic MNIST-like data with unique subject IDs, and synthetic token
streams (numpy; a copy of ``repro.data.synthetic``'s MNIST and token
generators and its ``batches`` iterator — for a seed it gives the
reference's arrays, IDs and batches exactly).

MNIST itself is not available offline, so a class-conditional image-like
dataset with the same geometry (28x28, 10 classes, 784 features) stands
in: per-class smooth prototypes plus noise and a random shift.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.resolution import VerticalDataset
from repro_torch.core.vertical import (make_ids, partition_features,
                                       scatter_to_owners)


def make_mnist_like(n: int, seed: int = 0, n_classes: int = 10,
                    side: int = 28) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (n, side*side) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1, side)
    protos = []
    for c in range(n_classes):
        fx, fy = rng.uniform(1, 4, 2)
        px, py = rng.uniform(0, np.pi, 2)
        img = np.outer(np.sin(2 * np.pi * fx * xs + px),
                       np.cos(2 * np.pi * fy * xs + py))
        img += rng.normal(0, 0.3, (side, side))
        protos.append(img)
    protos = np.stack(protos)                     # (C, side, side)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    shift = rng.integers(-2, 3, (n, 2))
    imgs = np.empty((n, side, side), np.float32)
    for i in range(n):
        p = np.roll(protos[labels[i]], shift[i], axis=(0, 1))
        imgs[i] = p + rng.normal(0, 0.22, (side, side))
    imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min())
    return imgs.reshape(n, side * side).astype(np.float32), labels


def make_vertical_mnist_parties(n: int, n_owners: int = 2, seed: int = 0,
                                keep_frac: float = 0.9,
                                feature_splits=None):
    """The paper's Fig. 2 setup: images vertically split across owners
    (left/right halves for 2 owners), labels held by the data scientist.
    Owners hold random overlapping subject subsets in random order — PSI
    resolution is required before training.

    Returns (scientist VerticalDataset(labels), {owner: VerticalDataset}).
    """
    rng = np.random.default_rng(seed)
    X, y = make_mnist_like(n, seed)
    side = int(np.sqrt(X.shape[1]))
    if feature_splits is not None:
        halves = partition_features(X, list(feature_splits))
    elif side % n_owners == 0:
        # left/right halves = contiguous feature slices of the image rows
        halves = partition_features(X.reshape(n, side, side), n_owners)
    else:
        halves = partition_features(X, n_owners)
    halves = [h.reshape(n, -1) for h in halves]
    ids = make_ids(n)
    owners_raw = scatter_to_owners(ids, halves, rng, keep_frac)
    scientist = VerticalDataset(ids, y)
    owners = {f"owner{i}": VerticalDataset(oid, od)
              for i, (oid, od) in enumerate(owners_raw)}
    return scientist, owners


def make_token_dataset(n_docs: int, seq_len: int, vocab: int, seed: int = 0):
    """Synthetic token streams with learnable structure (order-2 Markov
    chains with per-doc offsets) + subject IDs.  (n, seq_len+1) int32 —
    inputs are [:, :-1], labels [:, 1:]."""
    rng = np.random.default_rng(seed)
    toks = np.empty((n_docs, seq_len + 1), np.int64)
    for i in range(n_docs):
        t = np.empty(seq_len + 1, np.int64)
        t[0] = rng.integers(0, vocab)
        t[1] = rng.integers(0, vocab)
        # one GLOBAL order-2 transition (15% random restarts): the same
        # (t-1, t-2) context predicts the same next token everywhere
        for j in range(2, seq_len + 1):
            if rng.random() < 0.85:
                t[j] = (t[j - 1] * 31 + t[j - 2] * 7 + 11) % vocab
            else:
                t[j] = rng.integers(0, vocab)
        toks[i] = t
    return toks.astype(np.int32)


def batches(data: Dict[str, np.ndarray], batch_size: int, seed: int = 0,
            epochs: int = 1, drop_last: bool = True) -> Iterator[Dict]:
    """Shuffled mini-batch iterator over aligned arrays (a fresh
    permutation per epoch, the reference's draws)."""
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        stop = n - (n % batch_size) if drop_last else n
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            yield {k: v[idx] for k, v in data.items()}
