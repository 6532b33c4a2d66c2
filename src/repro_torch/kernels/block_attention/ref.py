"""Plain PyTorch version of the attention kernel (the port's counterpart
of ``repro/kernels/block_attention/ref.py``): a direct masked softmax in
f32, the reference's ``Skv <= chunk or Sq == 1`` branch of
``repro.models.attention.attention``, with ``q_offset`` and ``kv_len``.

The CPU runs it through the wrapper in ``ops.py``; ``chip_smoke.py``
holds the CUDA kernels against it on the card.  ``attention_split_kv_ref``
is the plain version of the decode route's split-KV schedule.  Both take
``q_offset`` and ``kv_len`` as ints or as one value per batch row (a
(B,) int tensor: continuous batching's decode step).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.block_attention import plan

NEG_INF = -2.0 ** 30  # large-but-finite: keeps padded-row softmax NaN-free


def _per_row(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() == 1


def attention_mask(q_pos, kv_pos, kind: str, window: int, kv_len):
    """Boolean mask (..., Sq, Skv): True = attend.  ``q_pos``: (Sq,) or
    per-row (B, Sq); ``kv_len``: None, an int or per-row (B,)."""
    pq = q_pos[..., :, None]
    pk = kv_pos
    if kind == "bidir":
        m = torch.ones(pq.shape[:-1] + pk.shape, dtype=torch.bool,
                       device=pq.device)
    elif kind == "causal":
        m = pk <= pq
    elif kind == "local":
        m = (pk <= pq) & (pk > pq - window)
    else:
        raise ValueError(kind)
    if _per_row(kv_len):
        m = m & (pk < kv_len.to(pq.device)[:, None, None])
    elif kv_len is not None:
        m = m & (pk < kv_len)
    return m


def _mask(B, Sq, Skv, kind, window, q_offset, kv_len, dev):
    """The mask broadcast over (B, nkv, g, Sq, Skv) scores: (Sq, Skv),
    or (B, 1, 1, Sq, Skv) for per-row offsets or lengths."""
    q_pos = torch.arange(Sq, device=dev)
    if _per_row(q_offset):
        q_pos = q_offset.to(dev)[:, None] + q_pos
    elif _per_row(kv_len):
        q_pos = (q_offset + q_pos).expand(B, Sq)
    else:
        q_pos = q_offset + q_pos
    m = attention_mask(q_pos, torch.arange(Skv, device=dev), kind, window,
                       kv_len)
    return m[:, None, None] if m.dim() == 3 else m


def attention_ref(q, k, v, *, kind: str = "causal", window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  scale: Optional[float] = None):
    """GQA attention.  q: (B, Sq, nh, hd); k, v: (B, Skv, nkv, hd);
    nh % nkv == 0.  ``q_offset``: position of q[0]; ``kv_len``: number
    of valid keys (None = all); each an int or one per row (B,)."""
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, nkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(B, Sq, Skv, kind, window, q_offset, kv_len, q.device)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, nh, hd).to(q.dtype)


def attention_split_kv_ref(q, k, v, *, kind: str = "causal",
                           window: int = 0, softcap: float = 0.0,
                           q_offset: int = 0, kv_len: Optional[int] = None,
                           scale: Optional[float] = None, n_sm: int = 132):
    """What the decode route computes: the live kv range (the whole cache
    when some row sees no key, ``plan.live_range``) cut by
    ``plan.split_plan``, each split's unnormalised partial (row max m,
    sum l, acc = sum of exp(s - m) v) in f32, merged in split order:
    out = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30).
    With per-row ``q_offset`` / ``kv_len`` row b is row b of the scalar
    call at that row's length (its plan is ``plan.row_plans``' row b)."""
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    if _per_row(q_offset) or _per_row(kv_len):
        qo = (q_offset if _per_row(q_offset)
              else torch.full((B,), int(q_offset)))
        kl = (kv_len if _per_row(kv_len) else
              torch.full((B,), Skv if kv_len is None else int(kv_len)))
        return torch.stack([attention_split_kv_ref(
            q, k, v, kind=kind, window=window, softcap=softcap,
            q_offset=int(qo[b]), kv_len=int(kl[b]), scale=scale,
            n_sm=n_sm)[b] for b in range(B)])
    g = nh // nkv
    scale = scale if scale is not None else hd ** -0.5
    kv_lim = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    k_begin, k_end = plan.live_range(Sq, kind, window, q_offset, kv_lim,
                                     Skv)
    split_len, n_split = plan.split_plan(k_begin, k_end, B * nkv, n_sm)
    dev = q.device
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, nkv, g, hd)
    mask = attention_mask(q_offset + torch.arange(Sq, device=dev),
                          torch.arange(Skv, device=dev), kind, window,
                          kv_lim)
    parts = []
    for lo, hi in plan.splits(k_begin, k_end, split_len, n_split):
        s = torch.einsum("bqkgh,bskh->bkgqs", qf,
                         k[:, lo:hi].to(torch.float32))
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[:, lo:hi], s, torch.full_like(s, NEG_INF))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum(
            "bkgqs,bskh->bkgqh", p, v[:, lo:hi].to(torch.float32))))
    o = torch.zeros((B, nkv, g, Sq, hd), dtype=torch.float32, device=dev)
    if parts:
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = torch.zeros_like(M)
        for m, l, acc in parts:        # fixed split order
            w = torch.exp(m - M)
            L = L + w * l
            o = o + w[..., None] * acc
        o = o / torch.clamp(L, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, hd).to(q.dtype)
