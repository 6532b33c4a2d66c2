"""The feature batch layout of the MLP SplitNN (the port's counterpart of
the feature layout in ``repro.federation.batching``).

  feature layout    ``x_slices``     (P, B, f_p)   <-> partition_features

Owner-side shape plumbing: nothing here looks at labels except the
optional label gather the session does for the scientist.  The sequence
and serving layouts belong to the LM slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def stack_feature_slices(slices: Sequence[np.ndarray]) -> np.ndarray:
    """Per-owner feature slices [(B, f), ...] -> stacked (P, B, f).  The
    port trains equal owner widths only (imbalanced widths are queued in
    ROADMAP.md)."""
    if len({s.shape[-1] for s in slices}) != 1:
        raise NotImplementedError(
            "imbalanced owner feature widths are not ported yet "
            "(ROADMAP.md, port queue)")
    return np.stack([np.asarray(s) for s in slices])


def feature_batch(owner_slices: Sequence[np.ndarray],
                  labels: Optional[np.ndarray], idx=None, *,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """An ``MLPSplitNN`` batch from per-owner feature matrices
    [(N, f), ...] + scientist labels (N,), optionally gathering rows
    ``idx`` (ID-aligned across all parties after resolution)."""
    sel = (lambda a: a if idx is None else a[idx])
    xs = stack_feature_slices([sel(np.asarray(s)) for s in owner_slices])
    batch = {"x_slices": torch.from_numpy(np.ascontiguousarray(
        xs, np.float32)).to(device)}
    if labels is not None:
        batch["labels"] = torch.from_numpy(
            sel(np.asarray(labels)).astype(np.int64)).to(device)
    return batch
