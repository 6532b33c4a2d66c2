"""Model registry: ``session.build(config)`` dispatches a config to an
adapter that gives the session one surface — init, loss, batch assembly,
per-segment optimizers, the per-segment programs split execution runs,
and the serving engine (the port's counterpart of
``repro.federation.registry``).  ``MLPSplitConfig`` builds the
:class:`MLPAdapter` (the paper's path: training and evaluation);
``ArchConfig`` builds the serving half of :class:`SplitLMAdapter`
(``VerticalSession.serve`` / ``serve_dataset``).  Training the split LM
is queued in ROADMAP.md (item 13): its training accessors raise
``NotImplementedError`` naming it.

Every program accessor is cached on the adapter, so the joint path and
the split workers call the very same function objects; with the same
shapes on the same device that is what keeps split == joint bitwise.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, not_ported
from repro_torch.configs.pyvertical_mnist import MLPSplitConfig
from repro_torch.core import masking, splitnn
from repro_torch.federation import batching
from repro_torch.optim import apply_updates, multi_segment, sgd

_LM_TRAINING = "item 13, LM training"


def build_adapter(cfg):
    if isinstance(cfg, MLPSplitConfig):
        return MLPAdapter(cfg)
    if isinstance(cfg, ArchConfig):
        return SplitLMAdapter(cfg)
    raise ValueError(f"no adapter registered for {type(cfg).__name__}")


class MLPAdapter:
    """The paper's Appendix-B dual-headed MLP on feature-split data."""

    #: ``fit(microbatches=M)``: the trunk's per-chunk programs take the
    #: full batch as ``denom``, so M chunks accumulate to the batch step
    supports_microbatch = True

    def __init__(self, cfg: MLPSplitConfig):
        self.cfg = cfg
        self.model = splitnn.MLPSplitNN(cfg)
        self.loss_fn = self.model.loss_fn
        self._progs = {}

    def _cached(self, key, make):
        if key not in self._progs:
            self._progs[key] = make()
        return self._progs[key]

    def init(self, gen: torch.Generator):
        return self.model.init(gen)

    def make_batch(self, owner_arrays: Sequence[np.ndarray],
                   labels: Optional[np.ndarray], idx=None, *, device="cpu"):
        return batching.feature_batch(owner_arrays, labels, idx,
                                      device=device)

    def _segment_opts(self, owner_lr: Optional[float] = None,
                      scientist_lr: Optional[float] = None):
        """THE per-segment update rules (Appendix B) — the joint
        optimizer and the split-mode per-party optimizers both derive
        from this one definition."""
        sp = self.cfg.split
        return {
            "heads": sgd(owner_lr if owner_lr is not None else sp.owner_lr),
            "trunk": sgd(scientist_lr if scientist_lr is not None
                         else sp.scientist_lr)}

    def default_optimizer(self, owner_lr: Optional[float] = None,
                          scientist_lr: Optional[float] = None):
        return multi_segment(self._segment_opts(owner_lr, scientist_lr))

    def cut_shape(self, batch_size: int,
                  feature_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Per-owner cut activation shape: (B, k) — not the raw width."""
        return (batch_size, self.model.k)

    # ------------------------------------------------- split execution
    def owner_programs(self, owner_index: int):
        """(head_fwd, head_bwd): one pair serves every owner; the NoPeek
        weight is part of the backward, so it keys the cache."""
        w = float(self.cfg.split.nopeek_weight)
        return self._cached(
            ("head_progs", w),
            lambda: splitnn.make_mlp_head_programs(self.model, w))

    def trunk_program(self):
        return self._cached(
            "trunk_prog", lambda: splitnn.make_mlp_trunk_program(self.model))

    def trunk_microbatch_programs(self):
        return self._cached(
            "trunk_micro",
            lambda: splitnn.make_mlp_trunk_microbatch_programs(self.model))

    # ------------------------------------- secure forward aggregation
    @property
    def supports_masked(self) -> bool:
        """masked_sum rides the sum combine: the scientist only ever
        needs ``sum_p cut_p``, which the ring fold reconstructs."""
        return self.cfg.split.combine == "sum"

    def owner_param_slice(self, params, p: int):
        return self.model.owner_head(params["heads"], p)

    def stack_head_params(self, slices: Sequence):
        """The owners' head segments as ``params["heads"]``: stacked, or
        the list itself for owners of unequal widths."""
        if self.model.symmetric:
            return splitnn.stack_heads(list(slices))
        return list(slices)

    def owner_optimizer(self, owner_lr: Optional[float] = None):
        # plain SGD is elementwise, so one owner's slice of the joint
        # stacked-heads update IS this update (bit for bit)
        return self._segment_opts(owner_lr=owner_lr)["heads"]

    def trunk_optimizer(self, scientist_lr: Optional[float] = None):
        return self._segment_opts(scientist_lr=scientist_lr)["trunk"]

    def _update_rule(self, key, optimizer):
        def build():
            def upd(params, state, grads, step):
                with torch.no_grad():
                    updates, state = optimizer.update(grads, state, params,
                                                      step)
                    return apply_updates(params, updates), state
            return optimizer, upd
        return self._cached(key, build)

    def owner_update_rule(self, owner_lr: Optional[float] = None):
        """(optimizer, update+apply) for one owner's head segment."""
        return self._update_rule(("owner_upd", owner_lr),
                                 self.owner_optimizer(owner_lr))

    def trunk_update_rule(self, scientist_lr: Optional[float] = None):
        return self._update_rule(("trunk_upd", scientist_lr),
                                 self.trunk_optimizer(scientist_lr))


class SplitLMAdapter:
    """Sequence-split language models (``SplitModel``), text modality:
    the serving half.  Training them is ROADMAP.md item 13: ``fit``,
    ``evaluate`` and the training accessors here raise
    ``NotImplementedError`` naming it."""

    layout = "sequence"
    supports_serving = True
    supports_training = False
    supports_split = False
    #: ``session.build`` draws the params with a generator on the
    #: session's device (billions of them at full width)
    init_on_device = True

    def __init__(self, cfg: ArchConfig):
        if cfg.modality != "text":
            raise ValueError(
                f"VerticalSession drives text archs; {cfg.name} is "
                f"{cfg.modality}")
        if float(cfg.split.nopeek_weight) > 0.0:
            # the LM head has no NoPeek program (token inputs have no
            # meaningful euclidean geometry for the dcor penalty)
            raise ValueError(
                "SplitConfig.nopeek_weight > 0 is not supported by the "
                "sequence-split LM adapter (supports_nopeek=False); use "
                "cut_noise_std / grad-side defences instead")
        from repro_torch.models.model import SplitModel
        self.cfg = cfg
        self.model = SplitModel(cfg)

    def init(self, gen: torch.Generator):
        return self.model.init(gen)

    def cut_shape(self, batch_size: int,
                  feature_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """(B, S_p, k): sequence-slice cut activations."""
        return (batch_size, feature_shape[0], self.model.k)

    def make_engine(self, params, **engine_kw):
        from repro_torch.launch.engine import ServingEngine
        return ServingEngine(self.model, params, **engine_kw)

    # ------------------------------------------------ training: item 13
    # ``fit`` refuses on ``supports_training``; ``evaluate`` reaches these

    def loss_fn(self, params, batch):
        raise not_ported("the split LM's loss", _LM_TRAINING)

    def make_batch(self, *args, **kwargs):
        raise not_ported("the split LM's training batches", _LM_TRAINING)
