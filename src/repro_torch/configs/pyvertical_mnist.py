"""The paper's own experiment config (Appendix B).

Dual-headed SplitNN on vertically-partitioned MNIST: each data owner holds
one image half (392 features) and an identical head mapping 392 -> 64 with
ReLU; the data scientist concatenates (128) and runs 128 -> 500 -> 10 with
softmax.  Owner lr 0.01, scientist lr 0.1, batch 128, 20k train images,
30 epochs.
"""
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.configs.base import SplitConfig


@dataclass(frozen=True)
class MLPSplitConfig:
    name: str = "pyvertical-mnist"
    source: str = "PyVertical (2021), Appendix B"
    n_features: int = 784           # full flattened image
    n_classes: int = 10
    head_layers: Tuple[int, ...] = (64,)           # 392 -> 64 (ReLU)
    trunk_layers: Tuple[int, ...] = (500, 10)      # 128 -> 500 -> 10
    batch_size: int = 128
    n_train: int = 20_000
    epochs: int = 30
    # imbalanced vertical datasets: explicit per-owner feature widths
    # (must sum to n_features).  None = equal.  The port trains only
    # equal widths so far (ROADMAP.md).
    feature_splits: Tuple[int, ...] = None
    split: SplitConfig = field(default_factory=lambda: SplitConfig(
        n_owners=2, cut_layer=1, combine="concat", cut_dim=64,
        owner_lr=0.01, scientist_lr=0.1))


CONFIG = MLPSplitConfig()
