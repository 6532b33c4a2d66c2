"""Basic layers: norms, embeddings, rotary and sin-cos positions (the
port's counterpart of ``repro.models.layers``).

All layers are functional: ``*_init(gen, ...) -> params`` (a dict of
tensors) plus an apply function.  Params are kept in the arch's
``param_dtype`` (f32) and cast to the activation dtype at every use, as
the reference does: a dense layer casts its whole weight per call, an
embedding casts its whole table and then gathers.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.sharding.dtensor import is_dtensor, summed


def dtype_of(name: str) -> torch.dtype:
    """A config dtype name (``"bfloat16"``) as a torch dtype."""
    return getattr(torch, name)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def normal(gen: torch.Generator, shape, scale: float,
           dtype=torch.float32) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn from ``gen`` on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(d: int, kind: str, device, dtype=torch.float32):
    if kind == "rmsnorm":                   # gemma-style (1 + scale)
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def norm_apply(params, x, kind: str, eps: float = 1e-5):
    # reductions in f32 for stability
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * (1.0 + params["scale"].to(torch.float32))
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(torch.float32) + \
            params["bias"].to(torch.float32)
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal(gen, (d_in, d_out), scale)}


def dense_apply(params, x):
    return x @ cast(params["w"], x.dtype)


def embed_init(gen, vocab: int, d: int):
    return {"table": normal(gen, (vocab, d), 0.02)}


def embed_apply(params, ids, dtype):
    table = cast(params["table"], dtype)
    if is_dtensor(table):
        # a DTensor of the dry-run: DTensor places ``embedding`` (a
        # vocabulary-sharded table gathers its rows, masked, and sums
        # once), not an index
        return summed(torch.nn.functional.embedding(ids, table))
    return table[ids]


def softcap(x, cap: float):
    """Gemma2 soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device=None):
    """``1 / theta^(2i / head_dim)`` in f32, made once per device: built
    at every call, the host-to-device copy of ``theta`` would stall the
    host until the card drains its queue, twice per attention layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                            exps)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    ang = ang[..., None, :]                                  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(half: int, sections=(2, 3, 3)):
    """The M-RoPE stream (0 = t, 1 = h, 2 = w) of each of the ``half``
    frequency slots: the slots split in proportion to ``sections``, the
    bounds ``int(half * s / sum(sections))`` cumulated and the last one
    forced to ``half``, as in the reference (hd 128: 16 / 40 / 64)."""
    total, bounds, acc = sum(sections), [], 0
    for s in sections:
        acc += int(half * s / total)
        bounds.append(acc)
    bounds[-1] = half
    slot, prev = [], 0
    for i, b in enumerate(bounds):
        slot += [i] * (b - prev)
        prev = b
    return slot


def apply_mrope(x, positions3, theta: float, sections=(2, 3, 3)):
    """Qwen2-VL M-RoPE: rotary with 3 position streams (t, h, w).
    x: (..., S, H, head_dim); ``positions3``: (..., S, 3).  Frequency
    slot i rotates by the position of stream ``mrope_sections[i]``."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)                  # (half,)
    slot = torch.tensor(mrope_sections(half, tuple(sections)),
                        device=positions3.device)
    ang = positions3.to(torch.float32)[..., slot] * freqs    # (..., S, half)
    ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sincos_positions(positions, d: int):
    """Whisper's fixed sinusoidal position embeddings, (..., S) ->
    (..., S, d) in f32: ``[sin(p f), cos(p f)]`` with ``f_i = exp(-i
    log(10000) / max(d/2 - 1, 1))``."""
    half = d // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                      * -(math.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
