"""Model registry: ``session.build(config)`` dispatches a config to an
adapter that gives the session one surface — init, loss, batch assembly,
per-segment optimizers, the per-segment programs split execution runs,
and the serving engine (the port's counterpart of
``repro.federation.registry``).  ``MLPSplitConfig`` builds the
:class:`MLPAdapter` (the paper's path); ``ArchConfig`` builds
:class:`SplitLMAdapter` (sequence-split language models: training on
the dense family, serving).  Dispatch is on the config's type, its
subclasses included (``register_model`` / ``build_adapter``).

Adapters expose the per-segment surface that split execution
(``fit(mode="split")``) runs over the transport:

  ``owner_programs(p)``      -> (head_fwd, head_bwd) of owner p
  ``trunk_program()``        -> the fused scientist step
                                 (trunk_params, cuts, labels) ->
                                 (metrics, trunk_grads, cut_grads)
  ``trunk_microbatch_programs()``
                             -> (cutgrad, weightgrad) per-chunk programs
                                 ``(tp, cuts, labels, denom, inv_micro)``
  ``owner_param_slice`` / ``stack_head_params``
                             -> one owner's head segment in/out of the
                                joint param tree
  ``owner_update_rule`` / ``trunk_update_rule``
                             -> (optimizer, update+apply) per party: the
                                joint ``default_optimizer`` split at the
                                same boundary

Every program accessor is cached on the adapter, so the joint path, the
owner threads and (through the config they rebuild the adapter from)
the spawned owner workers call the very same functions; with the same
shapes on the same device that is what keeps split == joint bitwise.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.pyvertical_mnist import MLPSplitConfig
from repro_torch.core import splitnn
from repro_torch.federation import batching
from repro_torch.optim import (adam, apply_updates, chain,
                               clip_by_global_norm, multi_segment, sgd)
from repro_torch.tree import tree_map

_BUILDERS: Dict[type, Callable] = {}
_UPDATE_LOCK = threading.Lock()


def register_model(*cfg_types: type):
    """Class decorator: ``session.build(cfg)`` on a config of one of
    ``cfg_types`` (subclasses included) builds the decorated adapter."""
    def deco(adapter_cls):
        for t in cfg_types:
            _BUILDERS[t] = adapter_cls
        return adapter_cls
    return deco


def build_adapter(cfg):
    for t in type(cfg).__mro__:
        if t in _BUILDERS:
            return _BUILDERS[t](cfg)
    raise ValueError(f"no adapter registered for {type(cfg).__name__}; "
                     f"known: {[t.__name__ for t in _BUILDERS]}")


class _ProgramCache:
    """Build-once accessors for the segment programs and update rules."""

    def _cached(self, key, make):
        cache = self.__dict__.setdefault("_progs", {})
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def _update_rule(self, key, optimizer):
        def build():
            def upd(params, state, grads, step):
                # one party's update at a time in a process: on one card
                # their kernels run one after another anyway, and each
                # update can reuse the memory the last one freed (the
                # full LM's owners and trunk would otherwise hold their
                # transients at once)
                with _UPDATE_LOCK, torch.no_grad():
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

    def default_optimizer(self, owner_lr: Optional[float] = None,
                          scientist_lr: Optional[float] = None):
        return multi_segment(self._segment_opts(owner_lr, scientist_lr))

    def owner_optimizer(self, owner_lr: Optional[float] = None):
        return self._segment_opts(owner_lr=owner_lr)["heads"]

    def trunk_optimizer(self, scientist_lr: Optional[float] = None):
        return self._segment_opts(scientist_lr=scientist_lr)["trunk"]

    def owner_kernel_sources(self) -> Tuple[str, ...]:
        """The kernel sources an owner's programs launch, which a session
        builds before it spawns owner workers: none here."""
        return ()

    def owner_template(self, p: int):
        """Owner ``p``'s head tree structure, for rebuilding its params
        from a flat list of leaves (a spawned worker's)."""
        return self.owner_param_slice(
            self.init(torch.Generator().manual_seed(0)), p)


@register_model(MLPSplitConfig)
class MLPAdapter(_ProgramCache):
    """The paper's Appendix-B dual-headed MLP on feature-split data."""

    layout = "feature"
    supports_serving = False
    #: ``fit(microbatches=M)``: the trunk's per-chunk programs take the
    #: full batch as ``denom``, so M chunks accumulate to the batch step
    supports_microbatch = True

    def __init__(self, cfg: MLPSplitConfig):
        self.cfg = cfg
        self.model = splitnn.MLPSplitNN(cfg)
        self.loss_fn = self.model.loss_fn

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
        from this one definition.  Plain SGD is elementwise, so one
        owner's slice of the joint stacked-heads update is this update,
        bit for bit."""
        sp = self.cfg.split
        return {
            "heads": sgd(owner_lr if owner_lr is not None else sp.owner_lr),
            "trunk": sgd(scientist_lr if scientist_lr is not None
                         else sp.scientist_lr)}

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


@register_model(ArchConfig)
class SplitLMAdapter(_ProgramCache):
    """Sequence-split language models (``SplitModel``), text modality.

    Training: the per-segment rules are ``chain(clip_by_global_norm(1.0),
    adam(lr or 1e-3))`` for the heads and for the trunk.  The clip scope
    differs by construction: jointly the heads' rule sees every owner's
    gradients (one global norm), while split mode applies the same rule
    to one owner's slice — an owner cannot see its peers' gradients.
    So split training equals the joint run within a tolerance, and
    equals, bit for bit, the joint gradients with the heads' rule
    applied to each owner's slice apart.  No masked_sum (the cuts are
    sequence slices, concatenated: no sum to aggregate) and no NoPeek
    (token inputs have no geometry for its dcor), as in the reference.
    Every text config the port builds trains, zamba2's ``mamba2`` blocks
    included: their scan runs the kernel's forward with a backward of
    plain products (``kernels.mamba2_scan.ssd_fn``).  An MoE FFN's
    balance loss is the blocks' aux: each owner differentiates its own
    (``head_bwd``), the trunk its own in the objective."""

    layout = "sequence"
    supports_serving = True
    supports_split = True
    supports_microbatch = True
    #: ``session.build`` draws the params with a generator on the
    #: session's device (billions of them at full width)
    init_on_device = True

    def __init__(self, cfg: ArchConfig):
        if cfg.modality != "text":
            raise ValueError(
                f"VerticalSession drives text archs; {cfg.name} is "
                f"{cfg.modality}")
        if float(cfg.split.nopeek_weight) > 0.0:
            raise ValueError(
                "SplitConfig.nopeek_weight > 0 is not supported by the "
                "sequence-split LM adapter (supports_nopeek=False); use "
                "cut_noise_std / grad-side defences instead")
        from repro_torch.models.model import SplitModel
        self.cfg = cfg
        self.model = SplitModel(cfg)

    def init(self, gen: torch.Generator):
        return self.model.init(gen)

    def owner_kernel_sources(self) -> Tuple[str, ...]:
        """The kernel sources an owner's head launches: the attention
        kernels' where its blocks include attention, the SSD scan's where
        they include ``mamba2``; none for xLSTM heads."""
        from repro_torch.kernels import block_attention, mamba2_scan
        from repro_torch.models.transformer import ATTENTION
        pattern = self.cfg.block_pattern
        names: Tuple[str, ...] = ()
        if any(k in ATTENTION for k in pattern):
            names += tuple(block_attention.ops.SOURCES.values())
        if "mamba2" in pattern:
            names += tuple(mamba2_scan.ops.SOURCES.values())
        return names

    def owner_template(self, p: int):
        """Owner ``p``'s head tree structure without drawing its weights:
        the head of the same depth, block pattern and cut at the reduced
        widths (a worker learns the structure, its leaves come from the
        spec)."""
        from repro_torch.models.model import SplitModel
        small = self.cfg.reduced().replace(n_layers=self.cfg.n_layers)
        return self.owner_param_slice(SplitModel(small).init(
            torch.Generator().manual_seed(0)), p)

    def cut_shape(self, batch_size: int,
                  feature_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """(B, S_p, k): sequence-slice cut activations."""
        return (batch_size, feature_shape[0], self.model.k)

    def make_engine(self, params, **engine_kw):
        from repro_torch.launch.engine import ServingEngine
        return ServingEngine(self.model, params, **engine_kw)

    # ------------------------------------------------------- training

    def loss_fn(self, params, batch):
        return self.model.loss_fn(params, batch)

    def make_batch(self, owner_arrays: Sequence[np.ndarray],
                   labels: Optional[np.ndarray], idx=None, *, device="cpu"):
        return batching.sequence_batch(owner_arrays, labels, idx,
                                       device=device)

    def _segment_opts(self, owner_lr: Optional[float] = None,
                      scientist_lr: Optional[float] = None):
        """THE per-segment update rules, shared by the joint and split
        paths (see the class docstring for the clip scope)."""
        return {
            "heads": chain(clip_by_global_norm(1.0),
                           adam(owner_lr if owner_lr is not None
                                else 1e-3)),
            "trunk": chain(clip_by_global_norm(1.0),
                           adam(scientist_lr if scientist_lr is not None
                                else 1e-3))}

    # ------------------------------------------------- split execution

    def owner_programs(self, owner_index: int):
        """Owner ``owner_index``'s programs.  ``head_fwd(hp, tokens) ->
        (cut, aux)``: the embedding and head blocks on the owner's
        sequence slice (rope at the slice's global positions); the
        scalar aux (the MoE balance loss of the owner's blocks) rides
        along so split metrics match the joint path's heads + trunk aux.
        ``head_bwd(hp, tokens, g)``: the forward recomputed, then its
        gradients seeded with the received cut gradient (cast to the
        cut's dtype) and a unit cotangent on the owner's aux, which is
        the owner's own term of the joint objective."""
        model = self.model

        def build():
            def head_apply(hp, tokens):
                positions = model._positions(tokens.shape[-1], owner_index,
                                             0, tokens.device)
                cut, _, aux = model._head_one(hp, tokens, positions)
                return cut, aux

            def head_fwd(hp, tokens):
                with torch.no_grad():
                    return head_apply(hp, tokens)

            def head_bwd(hp, tokens, g, nopeek=True):
                with torch.enable_grad():
                    leaves = tree_map(splitnn._leaf, hp)
                    cut, aux = head_apply(leaves, tokens)
                    outs, cots = [cut], [g.to(cut.dtype)]
                    if aux.requires_grad:
                        outs.append(aux)
                        cots.append(torch.ones_like(aux))
                    grads = splitnn.grads_of(outs, leaves, cots)
                return grads

            return head_fwd, head_bwd

        return self._cached(("head_progs", owner_index), build)

    def _chunk_loss(self, tp, cuts, labels, scale=1.0, inv_micro=1.0):
        """The trunk on the owners' cuts: ``(ce * scale + aux *
        inv_micro, {"loss", "aux"})``."""
        model = self.model
        z = model.combine(torch.stack(tuple(cuts)).to(model.cdtype))
        logits, _, aux = model.trunk_forward(tp, z)
        aux = aux * inv_micro
        ce = model.ce_loss(logits, labels) * scale
        return ce + aux, {"loss": ce, "aux": aux}

    def trunk_program(self):
        """The fused scientist step: ``trunk_step(tp, cuts (P-tuple of
        (B, S_p, k)), labels) -> (metrics, trunk_grads, cut_grads
        tuple)``."""

        def build():
            def trunk_step(tp, cuts, labels):
                with torch.enable_grad():
                    tl = tree_map(splitnn._leaf, tp)
                    cl = [splitnn._leaf(c) for c in cuts]
                    obj, parts = self._chunk_loss(tl, cl, labels)
                    grads = splitnn.grads_of([obj], [tl, cl])
                return splitnn._detached(parts), grads[0], tuple(grads[1])
            return trunk_step

        return self._cached("trunk_prog", build)

    def trunk_microbatch_programs(self):
        """Per-chunk scientist programs (GPipe): the chunk CE is scaled
        ``bm / denom`` (the chunk mean re-weighted to the full-batch
        mean) and the trunk aux counts ``aux * inv_micro``, so summing
        parts and gradients over the chunks gives the batch step.
        ``cutgrad(tp, cuts, labels, denom, inv_micro) -> (cut_grad
        tuple, parts)``; ``weightgrad(...) -> trunk_grads`` (the trunk's
        forward recomputed)."""

        def build():
            def cutgrad(tp, cuts, labels, denom, inv_micro=1.0):
                with torch.enable_grad():
                    cl = [splitnn._leaf(c) for c in cuts]
                    obj, parts = self._chunk_loss(
                        tp, cl, labels, labels.shape[0] / denom, inv_micro)
                    return (tuple(splitnn.grads_of([obj], cl)),
                            splitnn._detached(parts))

            def weightgrad(tp, cuts, labels, denom, inv_micro=1.0):
                with torch.enable_grad():
                    tl = tree_map(splitnn._leaf, tp)
                    obj, _ = self._chunk_loss(
                        tl, cuts, labels, labels.shape[0] / denom,
                        inv_micro)
                    return splitnn.grads_of([obj], tl)

            return cutgrad, weightgrad

        return self._cached("trunk_micro", build)

    def owner_param_slice(self, params, p: int):
        return tree_map(lambda a: a[p], params["heads"])

    def stack_head_params(self, slices: Sequence):
        return tree_map(lambda *xs: torch.stack(xs), *slices)

    def owner_batch(self, owner_array: np.ndarray, idx, device="cpu"):
        return torch.from_numpy(np.ascontiguousarray(
            owner_array[idx], np.int32)).to(device)
