"""Plain PyTorch version of the attention kernel (the port's counterpart
of ``repro/kernels/block_attention/ref.py``): a direct masked softmax in
f32, the reference's ``Skv <= chunk or Sq == 1`` branch of
``repro.models.attention.attention``, with ``q_offset`` and ``kv_len``.

The CPU runs it through the wrapper in ``ops.py``; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30  # large-but-finite: keeps padded-row softmax NaN-free


def attention_mask(q_pos, kv_pos, kind: str, window: int, kv_len):
    """Boolean mask (Sq, Skv): True = attend."""
    pq = q_pos[:, None]
    pk = kv_pos[None, :]
    if kind == "bidir":
        m = torch.ones((pq.shape[0], pk.shape[1]), dtype=torch.bool,
                       device=pq.device)
    elif kind == "causal":
        m = pk <= pq
    elif kind == "local":
        m = (pk <= pq) & (pk > pq - window)
    else:
        raise ValueError(kind)
    if kv_len is not None:
        m = m & (pk < kv_len)
    return m


def attention_ref(q, k, v, *, kind: str = "causal", window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  scale: Optional[float] = None):
    """GQA attention.  q: (B, Sq, nh, hd); k, v: (B, Skv, nkv, hd);
    nh % nkv == 0.  ``q_offset``: position of q[0]; ``kv_len``: number
    of valid keys (None = all)."""
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, nkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    m = attention_mask(q_offset + torch.arange(Sq, device=dev),
                       torch.arange(Skv, device=dev), kind, window, kv_len)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, nh, hd).to(q.dtype)
