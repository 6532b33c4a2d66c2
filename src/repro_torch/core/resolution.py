"""One party's ID-keyed rows and the paper's §3.1 alignment step
(copy of ``repro.core.resolution.VerticalDataset``).

The PSI rounds that decide which IDs are shared live in
``repro_torch.core.psi`` and are driven by ``VerticalSession.resolve``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class VerticalDataset:
    """One party's vertically-partitioned data: rows keyed by unique IDs."""

    ids: List[str]
    data: np.ndarray          # (n_rows, ...) — features or labels

    def __post_init__(self):
        if len(self.ids) != len(self.data):
            raise ValueError("ids/data length mismatch")
        if len(set(self.ids)) != len(self.ids):
            raise ValueError("IDs must be unique")

    def filter_and_sort(self, keep_ids: Sequence[str]) -> "VerticalDataset":
        """Discard non-shared rows; sort by ID (the paper's alignment)."""
        keep = set(keep_ids)
        order = [i for i, d in enumerate(self.ids) if d in keep]
        order.sort(key=lambda i: self.ids[i])
        return VerticalDataset([self.ids[i] for i in order],
                               self.data[order])
