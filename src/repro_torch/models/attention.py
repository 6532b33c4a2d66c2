"""Attention: GQA, causal/local/bidirectional masks, softcap, KV caches
(the port's counterpart of ``repro.models.attention``).

The attention itself is the kernel's wrapper
(``repro_torch.kernels.block_attention``): on a CUDA tensor it launches
the hand-written flash kernel, on a CPU tensor it runs the plain masked
softmax.  The reference computes the same function with a jnp scan
(``repro.models.attention.attention``).  When autograd records (a
training forward), the call goes through ``attention_fn``: the same
forward, and a backward of plain products.  Cross-attention (``kv_x``,
the whisper decoder's) runs the same kernel with Sq queries over the
encoder's Skv frames under the ``bidir`` mask; M-RoPE (qwen2-vl)
rotates q and k before it, with three position streams.

KV caches are updated in place (the reference returns an updated copy):
a cache is allocated once per request wave and written at ``pos``.  A
decode step of continuous batching gives every row its own position
(:class:`RowPositions`): each row's key and value land at its position,
and the kernel masks each row at its own length.

A ``local`` layer whose cache holds at most ``window`` slots keeps a
ring buffer (:func:`update_kv_cache_ring`, slot = position mod W), as
in the reference: a decode step attends ``bidir`` over the valid slots,
a prefill attends over its own keys with the local mask.  A cache in
``float8_e4m3fn`` stores what JAX's cast stores, byte for byte
(:func:`to_cache_dtype`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.block_attention import attention_fn, block_attention
from repro_torch.models import layers
from repro_torch.sharding.dtensor import on_shards, pinned, split_heads


# ---------------------------------------------------------------------------
# Attention block (projections + rope + GQA) and KV cache
# ---------------------------------------------------------------------------


def attn_init(gen, cfg):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": layers.dense_init(gen, d, qd),
            "wk": layers.dense_init(gen, d, kvd),
            "wv": layers.dense_init(gen, d, kvd),
            "wo": layers.dense_init(gen, qd, d)}


class RowPositions:
    """One position per batch row (continuous batching's decode step, in
    which every slot sits at its own position).  ``host``: a CPU int64
    tensor, which the attention kernel's per-row split plan and the KV
    write read; ``dev``: its copy on the compute device (rope reads it),
    uploaded once without a host sync and shared by every layer of the
    step."""

    def __init__(self, host, device):
        self.host = torch.as_tensor(np.asarray(host), dtype=torch.int64)
        if self.host.dim() != 1:
            raise ValueError(f"per-row positions are one int per row, got "
                             f"shape {tuple(self.host.shape)}")
        device = torch.device(device)
        if device.type == "cpu":
            self.dev = self.host
        else:
            self.dev = self.host.pin_memory().to(device, non_blocking=True)

    @classmethod
    def of(cls, pos, device):
        """``pos`` as an int or a :class:`RowPositions`: an int stays an
        int; a (B,) numpy array or tensor becomes per-row positions (a
        tensor on the card is read back once, with a sync)."""
        if pos is None or isinstance(pos, (int, np.integer, cls)):
            return pos
        if isinstance(pos, torch.Tensor):
            pos = pos.detach().cpu()
        return cls(pos, device)


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cpu"):
    return {"k": torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype,
                             device=device)}


#: the largest magnitude that JAX's cast to float8_e4m3fn rounds to a
#: finite value: past it (448 + half an ulp of 32) the cast gives NaN,
#: where torch's saturates to +-448
FP8_E4M3_NAN_PAST = 464.0


def to_cache_dtype(x, dtype):
    """``x`` cast to a cache's ``dtype``.  For ``float8_e4m3fn`` the
    bytes are the reference's (``jnp.astype``): a NaN, or a value whose
    magnitude passes 464 (inf included), becomes the NaN byte of its
    sign (0x7f / 0xff), as JAX's cast rounds it past 448 and has no inf;
    the rest round to nearest even in both packages.  The NaN bytes are
    written explicitly: torch's cast saturates past 448, and on the card
    drops a NaN's sign."""
    if x.dtype == dtype:
        return x
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    nan = torch.isnan(x) | (x.abs() > FP8_E4M3_NAN_PAST)
    code = torch.where(torch.signbit(x), 0xff, 0x7f).to(torch.uint8)
    return torch.where(nan, code, y.view(torch.uint8)).view(dtype)


def _write(cache, k_new, v_new, at):
    """Write k/v (B, Sq, nkv, hd) into the cache in place: at slot ``at``
    (an int) for every row, or at ``at[b]`` for row b (a list of ints,
    Sq = 1: one plain copy per row — an index_put would be one call, but
    in deterministic mode the card runs it through a sort and bounds
    checks, ~370 us of host time per call on an H100 host)."""
    k_new = to_cache_dtype(k_new, cache["k"].dtype)
    v_new = to_cache_dtype(v_new, cache["v"].dtype)
    Sq = k_new.shape[1]
    if isinstance(at, list):
        if Sq != 1:
            raise ValueError(f"per-row positions take one query per row, "
                             f"got {Sq}")
        for b, p in enumerate(at):
            cache["k"][b, p].copy_(k_new[b, 0])
            cache["v"][b, p].copy_(v_new[b, 0])
    else:
        cache["k"][:, at:at + Sq] = k_new
        cache["v"][:, at:at + Sq] = v_new
    return cache


def update_kv_cache(cache, k_new, v_new, pos):
    """Write k/v (B, Sq, nkv, hd) at position ``pos``, in place; with
    :class:`RowPositions` (Sq = 1), row b's key and value at position
    ``pos.host[b]``."""
    if isinstance(pos, RowPositions):
        return _write(cache, k_new, v_new, pos.host.tolist())
    return _write(cache, k_new, v_new, int(pos))


def update_kv_cache_ring(cache, k_new, v_new, pos):
    """Ring-buffer write for window-trimmed caches (W slots, W =
    window), in place: slot(p) = p mod W.

    Decode (Sq == 1): write at slot pos % W (row b at ``pos.host[b] %
    W`` for :class:`RowPositions`).  Prefill with Sq >= W (from position
    0): keep only the last W tokens, rolled so the element at slot i has
    position p = i (mod W).  A shorter prefill from ``pos`` is a plain
    write (no wrap), as in the reference."""
    W = cache["k"].shape[1]
    Sq = k_new.shape[1]
    if Sq == 1:
        if isinstance(pos, RowPositions):
            return _write(cache, k_new, v_new, (pos.host % W).tolist())
        return _write(cache, k_new, v_new, int(pos) % W)
    if Sq >= W:
        return _write(cache, torch.roll(k_new[:, -W:], Sq % W, dims=1),
                      torch.roll(v_new[:, -W:], Sq % W, dims=1), 0)
    return update_kv_cache(cache, k_new, v_new, pos)


def attn_apply(params, x, *, cfg, kind: str, positions=None, window: int = 0,
               cache=None, pos=None, kv_x=None):
    """Full attention sub-layer (no norm/residual — caller owns those).

    x: (B, Sq, d).  ``kv_x``: the cross-attention source (B, Skv, d) —
    when given, k and v come from it, the mask is bidirectional and no
    rotary is applied (the whisper decoder passes no cache with it, so
    it projects the encoder's output again at every call, decode steps
    included, as the reference does).  ``cache``/``pos``:
    decode-mode KV cache handling (the cache is written in place;
    ``pos`` an int or :class:`RowPositions`, whose host values go to the
    kernel as per-row ``q_offset`` and ``kv_len``).  ``positions``: the
    rope input, (..., Sq) for ``rope`` and (..., Sq, 3) for ``mrope``.
    Returns (out, cache).
    """
    B, Sq, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = split_heads(layers.dense_apply(params["wq"], x), nh, hd)
    k = split_heads(layers.dense_apply(params["wk"], src), nkv, hd)
    v = split_heads(layers.dense_apply(params["wv"], src), nkv, hd)

    if kv_x is not None:
        kind = "bidir"
    elif positions is not None:
        if cfg.rope == "mrope":
            q = layers.apply_mrope(q, positions, cfg.rope_theta)
            k = layers.apply_mrope(k, positions, cfg.rope_theta)
        elif cfg.rope == "rope":
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        # sincos positions are added at the embedding, not rotary.

    q_offset, kv_len = 0, None
    if cache is not None:
        # window-trimmed ring cache: a local-attention layer whose cache
        # holds at most `window` slots (slot = position mod W)
        W = cache["k"].shape[1]
        if kind == "local" and window > 0 and W <= window:
            cache = update_kv_cache_ring(cache, k, v, pos)
            if Sq == 1:
                # the slots hold the last min(pos + 1, W) positions in
                # some order, all inside the window: the mask is slot
                # validity alone (rope was applied at the write)
                k, v = cache["k"], cache["v"]
                kind, window = "bidir", 0
                kv_len = (torch.clamp(pos.host + 1, max=W)
                          if isinstance(pos, RowPositions)
                          else min(int(pos) + 1, W))
            # prefill: attend over the in-call k/v with the plain local
            # mask; the ring cache is storage for later decode steps
        else:
            cache = update_kv_cache(cache, k, v, pos)
            k, v = cache["k"], cache["v"]
            q_offset = pos.host if isinstance(pos, RowPositions) else pos
            kv_len = q_offset + Sq

    k, v = k.to(q.dtype), v.to(q.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        attend = attention_fn
    else:
        attend = block_attention
    # on the dry-run's DTensors the kernel runs on each rank's rows and
    # heads (batch over data, heads over model)
    out = on_shards(lambda q, k, v: attend(
        q, k, v, kind=kind, window=window, softcap=cfg.attn_softcap,
        q_offset=q_offset, kv_len=kv_len), (q, k, v), [(0, 2)] * 3,
        [(0, 2)])
    out = layers.dense_apply(params["wo"], pinned(out.reshape(B, Sq,
                                                          nh * hd)))
    return out, cache
