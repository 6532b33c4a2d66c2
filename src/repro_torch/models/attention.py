"""Attention: GQA, causal/local/bidirectional masks, softcap, KV caches
(the port's counterpart of ``repro.models.attention``).

The attention itself is the kernel's wrapper
(``repro_torch.kernels.block_attention``): on a CUDA tensor it launches
the hand-written flash kernel, on a CPU tensor it runs the plain masked
softmax.  The reference computes the same function with a jnp scan
(``repro.models.attention.attention``).

KV caches are updated in place (the reference returns an updated copy):
a cache is allocated once per request wave and written at ``pos``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import not_ported
from repro_torch.kernels.block_attention import block_attention
from repro_torch.models import layers


# ---------------------------------------------------------------------------
# Attention block (projections + rope + GQA) and KV cache
# ---------------------------------------------------------------------------


def attn_init(gen, cfg):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": layers.dense_init(gen, d, qd),
            "wk": layers.dense_init(gen, d, kvd),
            "wv": layers.dense_init(gen, d, kvd),
            "wo": layers.dense_init(gen, qd, d)}


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cpu"):
    return {"k": torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype,
                             device=device)}


def update_kv_cache(cache, k_new, v_new, pos: int):
    """Write k/v (B, Sq, nkv, hd) at position ``pos``, in place."""
    Sq = k_new.shape[1]
    cache["k"][:, pos:pos + Sq] = k_new
    cache["v"][:, pos:pos + Sq] = v_new
    return cache


def attn_apply(params, x, *, cfg, kind: str, positions=None, window: int = 0,
               cache=None, pos=None, kv_x=None):
    """Full attention sub-layer (no norm/residual — caller owns those).

    x: (B, Sq, d).  ``cache``/``pos``: decode-mode KV cache handling (the
    cache is written in place).  Returns (out, cache).
    """
    if kv_x is not None:
        raise not_ported("cross-attention (kv_x)",
                         "item 12, KV cache variants")
    B, Sq, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = layers.dense_apply(params["wq"], x).reshape(B, Sq, nh, hd)
    k = layers.dense_apply(params["wk"], x).reshape(B, Sq, nkv, hd)
    v = layers.dense_apply(params["wv"], x).reshape(B, Sq, nkv, hd)

    if positions is not None and cfg.rope != "none":
        if cfg.rope == "mrope":
            raise not_ported("M-RoPE (qwen2-vl)", "item 8")
        if cfg.rope == "rope":
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        # sincos positions are added at the embedding, not rotary.

    q_offset, kv_len = 0, None
    if cache is not None:
        if kind == "local" and window > 0 and cache["k"].shape[1] <= window:
            raise not_ported("ring-buffer KV caches",
                             "item 12, KV cache variants")
        cache = update_kv_cache(cache, k, v, pos)
        k, v = cache["k"], cache["v"]
        q_offset = pos
        kv_len = pos + Sq

    out = block_attention(q, k.to(q.dtype), v.to(q.dtype), kind=kind,
                          window=window, softcap=cfg.attn_softcap,
                          q_offset=q_offset, kv_len=kv_len)
    out = layers.dense_apply(params["wo"], out.reshape(B, Sq, nh * hd))
    return out, cache
