"""Batch layouts (the port's counterpart of ``repro.federation.batching``).

  feature layout    ``x_slices``     (P, B, f_p)   <-> partition_features
                    (a list of (B, f_i) for owners of unequal widths)
  sequence layout   ``owner_tokens`` (P, B, S_p)   <-> partition_sequence
  serving layout    padded request waves -> the sequence layout

Owner-side shape plumbing: nothing here looks at labels except the
optional label gather the session does for the scientist.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def stack_feature_slices(slices: Sequence[np.ndarray]
                         ) -> Union[np.ndarray, List[np.ndarray]]:
    """Per-owner feature slices [(B, f_i), ...] -> stacked (P, B, f) when
    the owners have one width, else the list as it is (owners of unequal
    widths stay ragged)."""
    if len({s.shape[-1] for s in slices}) == 1:
        return np.stack([np.asarray(s) for s in slices])
    return [np.asarray(s) for s in slices]


def unstack_feature_slices(stacked) -> List:
    """Inverse of :func:`stack_feature_slices`: a list of per-owner
    slices."""
    if isinstance(stacked, list):
        return stacked
    return [stacked[p] for p in range(stacked.shape[0])]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def feature_batch(owner_slices: Sequence[np.ndarray],
                  labels: Optional[np.ndarray], idx=None, *,
                  device="cpu") -> Dict[str, object]:
    """An ``MLPSplitNN`` batch from per-owner feature matrices
    [(N, f_i), ...] + scientist labels (N,), optionally gathering rows
    ``idx`` (ID-aligned across all parties after resolution).
    ``x_slices`` is one stacked tensor, or a list of per-owner tensors
    for owners of unequal widths."""
    sel = (lambda a: a if idx is None else a[idx])
    xs = stack_feature_slices([sel(np.asarray(s)) for s in owner_slices])
    batch = {"x_slices": ([_tensor(x, device) for x in xs]
                          if isinstance(xs, list) else _tensor(xs, device))}
    if labels is not None:
        batch["labels"] = torch.from_numpy(
            sel(np.asarray(labels)).astype(np.int64)).to(device)
    return batch


# ---------------------------------------------------------------------------
# sequence layout (split LMs: ``owner_tokens``)
# ---------------------------------------------------------------------------


def sequence_owner_slices(tokens, n_owners: int) -> np.ndarray:
    """(B, S) combined sequences -> (P, B, S_p) contiguous owner slices
    (owner p holds [p*S/P, (p+1)*S/P))."""
    B, S = tokens.shape
    if S % n_owners:
        raise ValueError(f"seq {S} not divisible by {n_owners} owners")
    return np.asarray(tokens).reshape(
        B, n_owners, S // n_owners).transpose(1, 0, 2)


def merge_sequence_slices(owner_tokens) -> np.ndarray:
    """Inverse of :func:`sequence_owner_slices`: (P, B, S_p) -> (B, S)."""
    P, B, S_p = owner_tokens.shape
    return np.asarray(owner_tokens).transpose(1, 0, 2).reshape(B, P * S_p)


def sequence_batch(owner_slices: Sequence[np.ndarray],
                   labels: Optional[np.ndarray], idx=None, *,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """A ``SplitModel`` training batch from per-owner token slices
    [(N, S_p), ...] + scientist next-token labels (N, S), optionally
    gathering rows ``idx``: ``owner_tokens`` (P, B, S_p) int32 and
    ``labels`` (B, S) int64 (-100 marks a masked position) on
    ``device``."""
    sel = (lambda a: a if idx is None else a[idx])
    ot = np.stack([sel(np.asarray(s)) for s in owner_slices])
    batch = {"owner_tokens": torch.from_numpy(np.ascontiguousarray(
        ot, np.int32)).to(device)}
    if labels is not None:
        batch["labels"] = torch.from_numpy(np.ascontiguousarray(
            sel(np.asarray(labels)), np.int64)).to(device)
    return batch


# ---------------------------------------------------------------------------
# serving layout (padded request waves -> sequence layout)
# ---------------------------------------------------------------------------


def pad_contexts(contexts, n_slots: int, length: int, pad: int = 0,
                 pad_side: str = "left") -> np.ndarray:
    """Ragged request contexts -> a full (n_slots, length) int32 wave.

    ``pad_side="left"`` right-aligns each context (recency next to the
    decode position — what the serving engine wants); unused slots stay
    all-pad."""
    if len(contexts) > n_slots:
        raise ValueError(f"{len(contexts)} contexts > {n_slots} slots")
    out = np.full((n_slots, length), pad, np.int32)
    for i, c in enumerate(contexts):
        c = np.asarray(c, np.int32)
        if len(c) > length:
            raise ValueError(f"context {len(c)} > wave length {length}")
        if pad_side == "left":
            out[i, length - len(c):] = c
        elif pad_side == "right":
            out[i, :len(c)] = c
        else:
            raise ValueError(pad_side)
    return out


def serving_owner_slices(batch_tokens, n_owners: int,
                         device="cpu") -> torch.Tensor:
    """Padded (B, S) wave -> (P, B, S_p) int32 owner slices on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(sequence_owner_slices(
        batch_tokens, n_owners))).to(device)


def pad_context_row(tokens, length: int, pad: int = 0,
                    pad_side: str = "left") -> np.ndarray:
    """One request's padded (length,) row."""
    return pad_contexts([tokens], 1, length, pad=pad, pad_side=pad_side)[0]


def context_tag(row) -> str:
    """sha256 content tag of a padded context row: two requests with
    byte-identical padded contexts are the same entity-context."""
    a = np.ascontiguousarray(np.asarray(row, np.int32))
    return hashlib.sha256(a.tobytes()).hexdigest()
