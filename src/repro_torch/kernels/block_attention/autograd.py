"""Attention under autograd: the kernel's forward, a backward of plain
products.

``attention_fn(q, k, v, ...)`` is ``block_attention`` with gradients.
Its forward is the wrapper itself (``ops.block_attention``, under
``no_grad``): on the card the route ``plan.choose_route`` picks (``tc``
for bf16 training shapes, ``fma`` for f32), on the CPU the plain
version.  Its backward is :func:`attention_backward`, the same plain
products on both, so the CPU tests run the card's backward.  The
reference's TPU kernel has no backward either: it trains through the
jnp attention's autodiff, whose function this backward differentiates.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.block_attention import ops
from repro_torch.kernels.block_attention.ref import NEG_INF, attention_mask

#: largest f32 score block of one backward pass, in elements; a larger
#: call runs in blocks of query rows (each block's dq whole, its dk and
#: dv summed over the blocks in order)
BLOCK_ELEMENTS = 1 << 26


def attention_backward(q, k, v, dout, *, kind: str = "causal",
                       window: int = 0, softcap: float = 0.0,
                       q_offset: int = 0, kv_len: Optional[int] = None,
                       scale: Optional[float] = None):
    """Gradients of GQA attention ``o = softmax(mask(softcap(s))) v``,
    ``s = scale * q kᵀ``, for the incoming ``dout`` (B, Sq, nh, hd):
    ``(dq, dk, dv)`` in the dtypes of q, k, v.  In f32: P recomputed
    (masked, softcapped); ``dV = Pᵀ dO``; ``dP = dO Vᵀ``; ``dS = P ∘ (dP
    − rowsum(dP ∘ P))`` (``rowsum(dP ∘ P)`` is ``rowsum(dO ∘ O)`` with O
    unrounded); the softcap's chain rule ``(1 − tanh²)``; then ``dQ =
    scale · dS K`` and ``dK = dSᵀ (scale · Q)``.  dK and dV sum the query
    heads of each kv head (the GQA groups).  Masked scores get no
    gradient, rows with no key included."""
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = scale if scale is not None else hd ** -0.5
    f32 = torch.float32
    qf = (q.to(f32) * scale).reshape(B, Sq, nkv, g, hd)
    kf, vf = k.to(f32), v.to(f32)
    do = dout.to(f32).reshape(B, Sq, nkv, g, hd)
    mask = attention_mask(q_offset + torch.arange(Sq, device=q.device),
                          torch.arange(Skv, device=q.device), kind, window,
                          kv_len)
    rows = max(1, BLOCK_ELEMENTS // max(1, B * nh * Skv))
    dq = torch.empty((B, Sq, nkv, g, hd), dtype=f32, device=q.device)
    dk = dv = None
    for lo in range(0, Sq, rows):
        hi = min(Sq, lo + rows)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf[:, lo:hi], kf)
        if softcap > 0.0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        m = mask[lo:hi]
        p = torch.softmax(torch.where(m, s, torch.full_like(s, NEG_INF)),
                          dim=-1)
        d_o = do[:, lo:hi]
        dv_b = torch.einsum("bkgqs,bqkgh->bskh", p, d_o)
        dp = torch.einsum("bqkgh,bskh->bkgqs", d_o, vf)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        ds = torch.where(m, ds, torch.zeros_like(ds))
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        dq[:, lo:hi] = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
        dk_b = torch.einsum("bkgqs,bqkgh->bskh", ds, qf[:, lo:hi])
        dk = dk_b if dk is None else dk + dk_b
        dv = dv_b if dv is None else dv + dv_b
    return (dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class BlockAttention(torch.autograd.Function):
    """``block_attention`` forward (the kernel on the card), gradients
    from :func:`attention_backward`; q, k and v are saved, the output is
    not (the backward recomputes P)."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, softcap, q_offset, kv_len,
                scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(kind=kind, window=window, softcap=softcap,
                      q_offset=q_offset, kv_len=kv_len, scale=scale)
        return ops.block_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def attention_fn(q, k, v, *, kind: str = "causal", window: int = 0,
                 softcap: float = 0.0, q_offset: int = 0,
                 kv_len: Optional[int] = None,
                 scale: Optional[float] = None):
    """GQA attention with gradients (see :class:`BlockAttention`);
    ``q_offset`` and ``kv_len`` are ints here (one position for every
    row: a training forward)."""
    return BlockAttention.apply(q, k, v, kind, window, softcap, q_offset,
                                kv_len, scale)
