"""The SplitNN configuration (copy of ``repro.configs.base.SplitConfig``).

``n_owners`` data owners each hold a vertical slice of the features of
the same data subjects.  Each owner runs ``cut_layer`` blocks (its head
segment) locally; the data scientist combines head outputs at the cut
layer and runs the remaining blocks (the trunk segment).

The privacy fields are kept so a reference config converts field for
field; the port trains only with them at their defaults (NoPeek, cut
noise and the gradient defenses are queued in ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SplitConfig:
    n_owners: int = 2
    cut_layer: int = 1             # number of blocks in each owner head
    combine: str = "concat"        # concat | sum | mean | max
    cut_dim: int = 0               # 0 = keep d_model (exact); >0 = bottleneck
    owner_lr: float = 0.01         # paper Appendix B
    scientist_lr: float = 0.1      # paper Appendix B
    cut_noise_std: float = 0.0
    nopeek_weight: float = 0.0
    grad_noise_std: float = 0.0
    grad_norm_mode: str = "none"
