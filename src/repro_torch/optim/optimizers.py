"""Functional optimizers over parameter trees of tensors (the port's
counterpart of ``repro.optim.optimizers``).

An optimizer is ``(init, update)``: ``state = init(params)``;
``updates, state = update(grads, state, params, step)``; apply with
``params = apply_updates(params, updates)``.  Updates build new tensors
(nothing is modified in place), so a tree handed to an owner thread, or
kept as a snapshot, is never changed under it.

``multi_segment`` is the PyVertical-specific piece: the data-owner head
segments and the data-scientist trunk segment train with their own
rules (Appendix B: SGD, owners 0.01, scientist 0.1; the split LM: clip
then Adam per segment), each party updating its own segment.
``torch.optim`` is not used: the heads/trunk split must mirror the
reference's per-segment rules.

The reference's formulas, in its order of operations.  Its scalars are
f32 arrays; here a schedule returns the f32 value as a Python float,
and the bias corrections are f32 numbers made on the host, so a step
needs no host sync and no tensor of its own.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable      # (grads, state, params, step) -> (updates, state)


_f32 = np.float32


# ---------------------------------------------------------------------------
# Schedules: step -> the f32 learning rate, as a Python float
# ---------------------------------------------------------------------------


def constant(lr: float):
    value = float(_f32(lr))
    return lambda step: value


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def sched(step):
        step = _f32(step)
        if step < warmup_steps:
            return float(_f32(peak_lr) * step / _f32(max(warmup_steps, 1)))
        t = np.clip((step - _f32(warmup_steps))
                    / _f32(max(total_steps - warmup_steps, 1)),
                    _f32(0.0), _f32(1.0))
        cos = _f32((1 - final_frac) * 0.5) * (
            _f32(1) + np.cos(_f32(math.pi) * t))
        return float(_f32(peak_lr) * (_f32(final_frac) + cos))
    return sched


def _as_sched(lr):
    return lr if callable(lr) else constant(lr)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    """``update = -lr_t * g``, or with ``momentum`` ``m = momentum * m +
    g`` and ``update = -lr_t * m``."""
    sched = _as_sched(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        neg_lr = -sched(step)
        if momentum == 0.0:
            return tree_map(lambda g: g * neg_lr, grads), state
        new_m = tree_map(lambda m, g: m * momentum + g, state, grads)
        return tree_map(lambda m: m * neg_lr, new_m), new_m

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """Adam with f32 update math; ``m`` and ``v`` are kept in
    ``state_dtype``.  Step ``step`` (0-based) uses the bias corrections
    ``1 - b**(step + 1)``: ``u = -lr_t * (m / bc1) / (sqrt(v / bc2) +
    eps)``, minus ``lr_t * weight_decay * p`` with weight decay."""
    sched = _as_sched(lr)

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype),
                     params)
        return {"m": z, "v": tree_map(torch.clone, z)}

    def update(grads, state, params, step):
        t = _f32(step) + _f32(1.0)
        lr_t = sched(t - _f32(1.0))
        bc1 = float(_f32(1) - _f32(b1) ** t)
        bc2 = float(_f32(1) - _f32(b2) ** t)
        neg_lr = -lr_t
        decay = float(_f32(lr_t) * _f32(weight_decay))
        f32 = torch.float32

        def leaf(m_, v_, g, p):
            # one leaf at a time, in place on fresh temporaries only: the
            # same operations in the same order as out of place, with
            # the transient memory of about two leaves (an LM's
            # vocabulary-sized leaves are 1.6 GB each)
            g = g.to(f32)
            m = m_.to(f32).mul(b1).add_(g.mul(1 - b1))
            v = v_.to(f32).mul(b2).add_(g.square().mul_(1 - b2))
            den = v.div(bc2).sqrt_().add_(eps)
            u = m.div(bc1).mul_(neg_lr).div_(den)
            del den
            if weight_decay:
                u = u.sub_(p.to(f32).mul(decay))
            return u.to(p.dtype), m.to(state_dtype), v.to(state_dtype)

        out = tree_map(leaf, state["m"], state["v"], grads, params)
        pick = (lambda i: tree_map(lambda _, o: o[i], params, out))
        return pick(0), {"m": pick(1), "v": pick(2)}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


# ---------------------------------------------------------------------------
# Transforms / composition
# ---------------------------------------------------------------------------


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scale the whole gradient tree by ``min(1, max_norm / max(norm,
    1e-9))``, ``norm`` its global L2 norm in f32 (leaf sums added in
    leaf order).  Stays on the gradients' device."""
    def init(params):
        return ()

    def update(grads, state, params, step):
        leaves = tree_leaves(grads)
        if not leaves:
            return grads, state
        sq = sum(g.to(torch.float32).square().sum() for g in leaves)
        gnorm = sq.sqrt()
        scale = torch.full_like(gnorm, max_norm).div(
            gnorm.clamp(min=1e-9)).clamp(max=1.0)
        return tree_map(lambda g: g * scale.to(g.dtype), grads), state

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    """Compose transforms left to right; the last one produces the
    updates."""

    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params, step):
        new_state = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params, step)
            new_state.append(s)
        return grads, tuple(new_state)

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
