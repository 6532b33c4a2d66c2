"""Functional optimizers over parameter trees of tensors (the parts of
``repro.optim.optimizers`` the MLP path uses).

An optimizer is ``(init, update)``: ``state = init(params)``;
``updates, state = update(grads, state, params, step)``; apply with
``params = apply_updates(params, updates)``.  Updates build new tensors
(nothing is modified in place), so a tree handed to an owner thread is
never changed under it.

``multi_segment`` is the PyVertical-specific piece: the data-owner head
segments and the data-scientist trunk segment train with different
learning rates (Appendix B: owners 0.01, scientist 0.1), each party
updating its own segment independently.  ``torch.optim`` is not used:
the heads/trunk split must mirror the reference's per-segment rules.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params, step) -> (updates, state)


def sgd(lr: float) -> Optimizer:
    """Plain SGD at a constant rate: ``update = -lr * grad`` (the f32
    product the reference takes, ``-lr_t * g``)."""
    neg_lr = -float(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        return tree_map(lambda g: g * neg_lr, grads), state

    return Optimizer(init, update)


def multi_segment(segment_opts: Dict[str, Optimizer]) -> Optimizer:
    """Per-segment optimizers keyed by the top-level param-tree key:
    ``multi_segment({"heads": sgd(0.01), "trunk": sgd(0.1)})``."""

    def init(params):
        return {k: segment_opts[k].init(params[k]) for k in params}

    def update(grads, state, params, step):
        updates, new_state = {}, {}
        for k in grads:
            u, s = segment_opts[k].update(grads[k], state[k], params[k], step)
            updates[k], new_state[k] = u, s
        return updates, new_state

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
