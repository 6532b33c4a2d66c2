"""The multi-headed SplitNN engine (the port's counterpart of
``repro.core.splitnn``).

1. ``MLPSplitNN`` — the paper's Appendix-B model (dual-headed MLP for
   vertically-partitioned MNIST: 392 -> 64 ReLU heads, concat -> 500 ->
   10 trunk).  Parameters keep the reference's layout: each layer is
   ``{"w": (in, out), "b": (out,)}`` computing ``x @ w + b``; ``heads``
   is a list of layers whose leaves are stacked over owners
   (``(P, 392, 64)``, ``(P, 64)``) or, for owners of unequal widths
   (``feature_splits``), a list of per-owner layer lists; ``trunk`` a
   list of layers.  The
   trunk's first layer is the fused cut layer (``trunk_apply``): the
   owners' cuts go through the cut-fusion kernel
   (``repro_torch.kernels.cut_fusion``) straight into the trunk's input
   projection, without building the combine.
2. ``make_split_train_step`` — the joint training step: one autograd
   pass through heads + combine + trunk, then per-segment updates
   (owners' lr != scientist's lr).
3. The per-segment programs that split execution runs over the
   transport: the owner's head forward/backward (with the NoPeek
   penalty's gradient when it is on) and the scientist's trunk step,
   fused or split into cut-gradient and weight-gradient halves.  With
   ``fit(aggregation="masked_sum")`` the same trunk programs take the
   dequantized int32 ring sum of the owners' quantized cuts as one
   owner plane of the sum combine.

Split vs. joint stays bitwise inside the port because both paths run
the same functions at the same shapes: the joint step computes each
owner's head with the same per-owner head function the owner thread
runs (no batched product over owners, which may reduce in another
order), the trunk is one function, ``trunk_apply``, and the loss is
one function, ``nll_parts``, everywhere.

``cut_layer_traffic`` accounts the bytes that cross party boundaries
per step: only cut activations (fwd) and cut gradients (bwd).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch.configs.pyvertical_mnist import MLPSplitConfig
from repro_torch.core.privacy import distance_correlation, nopeek_penalty
from repro_torch.kernels.cut_fusion import cut_fusion_fn
from repro_torch.optim import apply_updates
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def head_slice(heads, p: int):
    """Owner ``p``'s head segment out of the owner-stacked ``heads``."""
    return [{k: v[p] for k, v in layer.items()} for layer in heads]


def stack_heads(slices):
    """Inverse of :func:`head_slice` over all owners."""
    return [{k: torch.stack([s[i][k] for s in slices]) for k in layer}
            for i, layer in enumerate(slices[0])]


def nll_parts(logits, labels, denom: float):
    """``-sum(log_softmax(logits)[labels]) / denom`` and the correct
    count / ``denom`` — the loss of the joint step, the trunk programs
    and evaluation alike.  The label pick is a one-hot product
    (elementwise, deterministic on the card in both directions)."""
    logp = torch.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[:, None] == classes).to(logp.dtype)
    loss = -(logp * onehot).sum() / denom
    acc = (logits.argmax(-1) == labels).sum().to(torch.float32) / denom
    return loss, {"loss": loss, "accuracy": acc}


class MLPSplitNN:
    """``feature_splits`` gives each owner its own input width (summing
    to ``n_features``); without it the owners split the features
    equally.  Owners of one width (``symmetric``) keep their head leaves
    stacked over owners; owners of unequal widths keep a list of head
    segments, one per owner.  Every cut is (B, k) either way, so the
    trunk and cut fusion do not depend on the widths."""

    def __init__(self, cfg: MLPSplitConfig):
        self.cfg = cfg
        sp = cfg.split
        self.P = sp.n_owners
        self.splits = (tuple(cfg.feature_splits or ())
                       or (cfg.n_features // self.P,) * self.P)
        if len(self.splits) != self.P or sum(self.splits) != cfg.n_features:
            raise ValueError(f"feature_splits {self.splits} inconsistent")
        if sp.combine not in ("concat", "sum", "mean", "max"):
            raise ValueError(sp.combine)
        self.symmetric = len(set(self.splits)) == 1
        self.f_p = self.splits[0]                  # 392 per owner (paper)
        self.k = cfg.head_layers[-1]               # 64
        self.trunk_in = self.P * self.k if sp.combine == "concat" else self.k

    @staticmethod
    def _mlp_init(gen: torch.Generator, dims):
        return [{"w": torch.randn((a, b), generator=gen) * math.sqrt(2.0 / a),
                 "b": torch.zeros((b,))}
                for a, b in zip(dims[:-1], dims[1:])]

    def init(self, gen: torch.Generator):
        """Random params on the CPU from ``gen`` (He-normal weights, zero
        biases, the reference's scheme; the numbers differ from JAX's —
        carry reference params across with ``repro_torch.weights``)."""
        heads = [self._mlp_init(gen, (f,) + self.cfg.head_layers)
                 for f in self.splits]
        if self.symmetric:
            heads = stack_heads(heads)
        trunk = self._mlp_init(gen, (self.trunk_in,) + self.cfg.trunk_layers)
        return {"heads": heads, "trunk": trunk}

    @staticmethod
    def _mlp_apply(params, x, final_linear=True):
        for i, layer in enumerate(params):
            x = x @ layer["w"] + layer["b"]
            if i < len(params) - 1 or not final_linear:
                x = torch.relu(x)
        return x

    def head_apply(self, hp, x):
        """One owner's head: Linear(392 -> 64) + ReLU."""
        return torch.relu(self._mlp_apply(hp, x))

    def owner_head(self, heads, p: int):
        """Owner ``p``'s head segment: a slice of the stacked heads, or
        the ``p``-th entry of a list of per-owner segments."""
        return head_slice(heads, p) if self.symmetric else heads[p]

    def heads_forward(self, heads, x_slices):
        """x_slices: (P, B, f_p), or a list of (B, f_i) slices for owners
        of unequal widths.  Each owner's head through :meth:`head_apply`,
        stacked to (P, B, k)."""
        return torch.stack([self.head_apply(self.owner_head(heads, p),
                                            x_slices[p])
                            for p in range(self.P)])

    def trunk_apply(self, trunk, cut):
        """The scientist's side, the only route from the stacked cut
        (P, B, k) to the logits: layer 0 is the fused cut layer,
        ``cut_fusion(cut, W as (P, k, d) for concat or (1, k, d) for sum
        and mean) + b`` (the combine is never built), then ReLU and the
        rest of the trunk.  ``W`` keeps the reference's (P*k, d) / (k, d)
        layout.  ``combine="max"`` has no kernel: amax, then the
        product."""
        c = self.cfg.split.combine
        first = trunk[0]
        if c == "max":
            x = cut.amax(0) @ first["w"]
        else:
            P, _, k = cut.shape
            w = first["w"].view(P if c == "concat" else 1, k, -1)
            x = cut_fusion_fn(cut.contiguous(), w, c)
        x = x + first["b"]
        if len(trunk) == 1:
            return x
        return self._mlp_apply(trunk[1:], torch.relu(x))

    def forward(self, params, x_slices):
        return self.trunk_apply(params["trunk"], self.heads_forward(
            params["heads"], x_slices))              # logits (B, 10)

    def loss_fn(self, params, batch):
        """``(objective, metrics)``: the NLL plus, with NoPeek on, the
        per-owner ``weight * dcor(raw slice, cut)`` summed over owners;
        ``metrics["loss"]`` stays the bare NLL, so trails compare across
        weights."""
        xs = batch["x_slices"]
        cut = self.heads_forward(params["heads"], xs)
        logits = self.trunk_apply(params["trunk"], cut)
        loss, metrics = nll_parts(logits, batch["labels"],
                                  float(logits.shape[0]))
        w = float(self.cfg.split.nopeek_weight)
        if w > 0.0:
            if isinstance(xs, (list, tuple)):   # owners of unequal widths
                pen = w * sum(distance_correlation(x, c)
                              for x, c in zip(xs, cut))
            else:
                pen = nopeek_penalty(xs, cut, w)
            return loss + pen, metrics
        return loss, metrics


# ---------------------------------------------------------------------------
# Joint split training step
# ---------------------------------------------------------------------------


def grads_of(outputs, tree, cotangents=None):
    """The gradients of ``outputs`` (seeded with ``cotangents``, default
    ones) with respect to every leaf of ``tree``, as a tree of its
    structure.  A leaf the outputs do not use (a unit stack of zero
    units) gets zeros."""
    return tree_unflatten(tree, list(torch.autograd.grad(
        outputs, tree_leaves(tree), cotangents, allow_unused=True,
        materialize_grads=True)))


def _grad(loss, tree):
    """d loss / d tree, as a tree of the same structure."""
    return grads_of(loss, tree)


def _leaf(t):
    return t.detach().requires_grad_()


def make_split_train_step(loss_fn: Callable, optimizer) -> Callable:
    """The joint step ``step(params, opt_state, batch, step_idx) ->
    (params, opt_state, metrics)``: one autograd pass of the objective
    (``loss_fn``'s first return: the NLL plus any NoPeek term), then the
    ``multi_segment`` optimizer (heads and trunk get their own rules,
    mirroring the paper's independent per-party updates)."""

    def step(params, opt_state, batch, step_idx):
        with torch.enable_grad():
            leaves = tree_map(_leaf, params)
            objective, metrics = loss_fn(leaves, batch)
            grads = _grad(objective, leaves)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  step_idx)
            del grads, leaves        # before the new params (a full LM's)
            params = apply_updates(params, updates)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# Per-segment programs (true split execution over a transport)
# ---------------------------------------------------------------------------


def make_mlp_head_programs(model: MLPSplitNN, nopeek_weight: float = 0.0):
    """Owner-side programs for one MLP head: ``head_fwd(hp, x) -> cut``;
    ``head_bwd(hp, x, cut_grad, nopeek=True) -> head_grads``
    (recompute-forward backward seeded with the received cut gradient).

    ``nopeek_weight > 0`` adds the gradient of the owner-local NoPeek
    term ``weight * dcor(x, head(x))``; ``nopeek=False`` leaves it out
    (the warmup, whose zero cut gradient must leave params unchanged).
    Weight 0 runs exactly the undefended backward."""
    w = float(nopeek_weight)

    def head_fwd(hp, x):
        with torch.no_grad():
            return model.head_apply(hp, x)

    def head_bwd(hp, x, g, nopeek=True):
        with torch.enable_grad():
            leaves = tree_map(_leaf, hp)
            out = model.head_apply(leaves, x)
            penalised = w > 0.0 and nopeek
            grads = torch.autograd.grad(out, tree_leaves(leaves), g,
                                        retain_graph=penalised)
            if penalised:
                pen = torch.autograd.grad(w * distance_correlation(x, out),
                                          tree_leaves(leaves))
                grads = [a + b for a, b in zip(grads, pen)]
            return tree_unflatten(leaves, list(grads))

    return head_fwd, head_bwd


def _chunk_loss(model, tp, cuts, labels, denom):
    return nll_parts(model.trunk_apply(tp, torch.stack(tuple(cuts))),
                     labels, denom)


def _detached(parts):
    return {k: v.detach() for k, v in parts.items()}


def make_mlp_trunk_program(model: MLPSplitNN):
    """The fused scientist step: ``trunk_step(tp, cuts (P-tuple of
    (B, k)), labels) -> (metrics, trunk_grads, cut_grads tuple)``."""

    def trunk_step(tp, cuts, labels):
        with torch.enable_grad():
            tl = tree_map(_leaf, tp)
            cl = [_leaf(c) for c in cuts]
            loss, parts = _chunk_loss(model, tl, cl, labels,
                                      float(labels.shape[0]))
            grads = torch.autograd.grad(loss, tree_leaves(tl) + cl)
        n = len(tree_leaves(tl))
        return (_detached(parts), tree_unflatten(tl, list(grads[:n])),
                tuple(grads[n:]))

    return trunk_step


def make_mlp_trunk_microbatch_programs(model: MLPSplitNN):
    """Per-chunk scientist programs (the pipelined schedule runs them
    even with one chunk, as the reference does).  Each chunk's loss is
    seeded ``sum / denom`` with ``denom`` = the full batch size.

      ``cutgrad(tp, cuts, labels, denom) -> (cut_grad tuple, parts)`` —
          the latency-critical half: the cut gradients ship back the
          moment they exist.
      ``weightgrad(tp, cuts, labels, denom) -> trunk_grads`` — the
          recompute-based trunk gradients, taken while the cut
          gradients are on the wire.

    Both take the session's ``inv_micro`` too, as the LM's programs do
    (its aux weight); the MLP has no aux and ignores it."""

    def cutgrad(tp, cuts, labels, denom, inv_micro=None):
        with torch.enable_grad():
            cl = [_leaf(c) for c in cuts]
            loss, parts = _chunk_loss(model, tp, cl, labels, denom)
            return tuple(torch.autograd.grad(loss, cl)), _detached(parts)

    def weightgrad(tp, cuts, labels, denom, inv_micro=None):
        with torch.enable_grad():
            tl = tree_map(_leaf, tp)
            loss, _ = _chunk_loss(model, tl, cuts, labels, denom)
            return _grad(loss, tl)

    return cutgrad, weightgrad


# ---------------------------------------------------------------------------
# Communication accounting
# ---------------------------------------------------------------------------


def cut_layer_traffic(n_owners: int, batch: int, tokens_per_owner: int,
                      cut_dim: int, bytes_per_el: int = 2) -> Dict[str, int]:
    """Bytes crossing each owner<->scientist boundary per training step:
    forward the cut activation (B, S_p, k), backward its gradient."""
    one_way = batch * tokens_per_owner * cut_dim * bytes_per_el
    return {
        "per_owner_forward_bytes": one_way,
        "per_owner_backward_bytes": one_way,
        "total_per_step_bytes": 2 * one_way * n_owners,
    }
