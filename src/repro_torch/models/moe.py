"""Mixture-of-experts FFN with capacity-based token dispatch (the port's
counterpart of ``repro.models.moe``).

Top-k routing, per-expert capacity ``C = ceil(T * k / E *
capacity_factor)`` (rounded as the reference rounds it) for the ``T``
tokens of one call, dispatch to an (E, C, d) buffer, batched expert
matmuls, gather combine.  Overflowing choices are dropped (they
contribute zero).  Also returns the Switch-style load-balance loss
``E * sum_e f_e * P_e * aux_loss_weight``.

Routing equals the reference's: ``jax.lax.top_k`` takes the lower
expert index on a tie, so the ranking here is a stable descending sort;
positions within an expert follow the choice-major order (every token's
first choice, then every second choice, ...).  Kept (expert, slot)
pairs are unique, so the dispatch is one gather through a slot ->
choice table (a zero row for an empty slot; the table comes from a
stable sort of the choices by expert) and the combine one gather of the
kept choices' slots.  Their backwards are gathers too (``_Dispatch``,
``_Combine``): autograd's own backward of an indexed read is an
accumulating ``index_put_``, which deterministic mode serialises on the
card, so neither the forward nor the backward makes an accumulating
write.
``dispatch_groups = G > 1`` routes G equal groups of tokens apart, each
with its own capacity.  The reference's sharding constraints on the
dispatch and combine buffers are called here too (``_constrain``):
no-ops without a sharding context and on a step builder's one-device
mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers, mlp as mlp_mod
from repro_torch.sharding.dtensor import replicas
from repro_torch.sharding.specs import constrain


def moe_init(gen, d: int, moe_cfg, mlp_kind: str):
    """The reference's layout and distributions (not its draws)."""
    e, de = moe_cfg.n_experts, moe_cfg.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(de)
    p = {"router": layers.dense_init(gen, d, e, scale=0.02),
         "w_in": layers.normal(gen, (e, d, de), s_in),
         "w_out": layers.normal(gen, (e, de, d), s_out)}
    if mlp_kind in ("swiglu", "geglu"):
        p["w_gate"] = layers.normal(gen, (e, d, de), s_in)
    if moe_cfg.n_shared:
        p["shared"] = mlp_mod.mlp_init(
            gen, d, moe_cfg.n_shared * moe_cfg.d_shared, mlp_kind)
    return p


def capacity(n_tokens: int, moe_cfg) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    c = int(n_tokens * moe_cfg.top_k / moe_cfg.n_experts
            * moe_cfg.capacity_factor)
    # large capacities round to 2048, as the reference's do
    if c > 2048:
        return -(-c // 2048) * 2048
    return max(8, -(-c // 8) * 8)


def route(xt, router_w, moe_cfg, C: int):
    """One group's routing.  xt: (T, d).

    Returns ``(probs (T, E) f32, top_w (T, K) f32, top_e (T, K), e_flat
    (T*K,), pos (T*K,), keep (T*K,) bool, slot_choice (E, C))``: the
    choices in choice-major order (choice ``i`` is token ``i % T``'s),
    each one's position within its expert and whether it fits, and for
    every slot the choice it holds (``T*K`` for an empty slot)."""
    T = xt.shape[0]
    E, K = moe_cfg.n_experts, moe_cfg.top_k
    logits = (xt @ layers.cast(router_w, xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: the lower index first on a tie
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    e_flat = top_e.t().reshape(T * K)                    # choice-major
    onehot = F.one_hot(e_flat, E)                        # (T*K, E) int64
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = pos < C
    # slot (e, c) holds the c-th choice of expert e in choice-major
    # order, where c < the expert's count: a stable sort by expert lists
    # each expert's choices in that order
    counts = onehot.sum(0)                               # (E,)
    order = torch.sort(e_flat, stable=True).indices
    start = counts.cumsum(0) - counts
    c_idx = torch.arange(C, device=xt.device)
    src = order[(start[:, None] + c_idx).clamp(max=T * K - 1)]
    slot_choice = torch.where(c_idx < counts[:, None], src, T * K)
    return probs, top_w, top_e, e_flat, pos, keep, slot_choice


class _Dispatch(torch.autograd.Function):
    """(T, d) tokens -> the (E, C, d) slots: each kept choice's token in
    its slot, zeros in the empty ones.  A token's gradient is the sum of
    its kept choices' slots (at most K): a gather and a sum."""

    @staticmethod
    def forward(ctx, x, slot_choice, e_flat, pos_safe, keep):
        T, d = x.shape
        ctx.T = T
        ctx.save_for_backward(e_flat, pos_safe, keep)
        slot_tok = torch.where(slot_choice < keep.numel(), slot_choice % T,
                               T)
        return torch.cat([x, x.new_zeros((1, d))])[slot_tok]

    @staticmethod
    def backward(ctx, g):
        e_flat, pos_safe, keep = ctx.saved_tensors
        rows = torch.where(keep[:, None], g[e_flat, pos_safe], 0)
        gx = rows.reshape(-1, ctx.T, g.shape[-1]).sum(0)    # over K
        return gx, None, None, None, None


class _Combine(torch.autograd.Function):
    """The (E, C, d) slots -> (T*K, d) rows, choice-major: each kept
    choice's slot, zeros for a dropped choice.  Kept (expert, slot)
    pairs are unique, so a slot's gradient is its one kept choice's row
    (zeros for an empty slot): a gather."""

    @staticmethod
    def forward(ctx, buf, slot_choice, e_flat, pos_safe, keep):
        ctx.save_for_backward(slot_choice)
        return torch.where(keep[:, None], buf[e_flat, pos_safe], 0)

    @staticmethod
    def backward(ctx, g):
        (slot_choice,) = ctx.saved_tensors
        gbuf = torch.cat([g, g.new_zeros((1, g.shape[-1]))])[slot_choice]
        return gbuf, None, None, None, None


def _experts(params, buf, mlp_kind: str):
    """buf (..., E, C, d) -> (..., E, C, d) through each expert."""
    h = torch.einsum("...ecd,edf->...ecf", buf,
                     layers.cast(params["w_in"], buf.dtype))
    if mlp_kind in ("swiglu", "geglu"):
        g = torch.einsum("...ecd,edf->...ecf", buf,
                         layers.cast(params["w_gate"], buf.dtype))
        g = F.silu(g) if mlp_kind == "swiglu" else F.gelu(
            g, approximate="tanh")
        h = g * h
    elif mlp_kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif mlp_kind == "relu2":
        r = F.relu(h)
        h = r * r
    return torch.einsum("...ecf,efd->...ecd", h,
                        layers.cast(params["w_out"], h.dtype))


def _constrain(buf):
    """The reference's constraint on a (G, E, C, d) buffer: its one
    group's (E, C, d) as "moe_buffer", or all G as
    "moe_buffer_grouped"."""
    if buf.shape[0] == 1:
        return constrain(buf[0], "moe_buffer")[None]
    return constrain(buf, "moe_buffer_grouped")


def moe_apply(params, x, moe_cfg, mlp_kind: str):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
    B, S, d = x.shape
    T = B * S
    G = moe_cfg.dispatch_groups
    E, K = moe_cfg.n_experts, moe_cfg.top_k
    Tg = T // G
    C = capacity(Tg, moe_cfg)
    # on the dry-run's DTensors the routing, the dispatch and the
    # combine run on every rank over all tokens (their sorts and gathers
    # have no DTensor placement); the experts run on the constrained
    # buffers
    xg, lift = replicas(x.reshape(G, Tg, d))
    router_w, _ = replicas(params["router"]["w"])
    routes = [route(xg[g], router_w, moe_cfg, C) for g in range(G)]
    # each group's (slot_choice, e_flat, pos_safe, keep): the gathers'
    # tables
    tables = [(r[6], r[3], torch.where(r[5], r[4], 0), r[5])
              for r in routes]
    buf = lift(torch.stack([_Dispatch.apply(xg[g], *tb)
                            for g, tb in enumerate(tables)]))  # (G,E,C,d)
    out_buf, _ = replicas(_constrain(_experts(params, _constrain(buf),
                                              mlp_kind)))

    outs = []
    for g, (r, tb) in enumerate(zip(routes, tables)):
        top_w, keep = r[1], r[5]
        gathered = _Combine.apply(out_buf[g], *tb)
        w_flat = (top_w.t().reshape(Tg * K, 1) * keep[:, None]).to(
            gathered.dtype)
        outs.append((gathered * w_flat).reshape(K, Tg, d).sum(0))
    out = lift(torch.stack(outs).reshape(B, S, d))

    if moe_cfg.n_shared:
        out = out + mlp_mod.mlp_apply(params["shared"], x, mlp_kind)

    # Switch-style load-balance loss over every group's tokens
    top1 = torch.cat([r[2][:, 0] for r in routes])
    f_e = F.one_hot(top1, E).to(torch.float32).mean(0)
    p_e = torch.cat([r[0] for r in routes]).mean(0)
    aux = lift(E * (f_e * p_e).sum() * moe_cfg.aux_loss_weight)
    return out, aux
