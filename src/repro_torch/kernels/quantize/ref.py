"""Plain PyTorch versions of the int8 cut quantizer (the port's
counterpart of ``repro/kernels/quantize/ref.py``).

They repeat the CUDA kernel's arithmetic op for op, so their bytes are
the kernel's: the CPU runs them through the wrappers in ``ops.py``, and
``chip_smoke.py`` holds the kernel against them on the card.
"""
from __future__ import annotations

import torch


def quantize_int8_ref(x: torch.Tensor):
    """x: (T, K).  Returns (values int8 (T, K), scales f32 (T, 1)):
    ``scale = max(absmax_row, 1e-12) / 127``,
    ``q = clip(round_half_even(x / scale), ±127)``.  NaN propagates into
    the row's scale; a value that quantizes to NaN is stored as 0 (the
    CUDA kernel's rule)."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1, keepdim=True)          # keeps NaN
    # divide by a tensor, not a Python scalar: on the card PyTorch turns
    # division by a host scalar into a multiply by its reciprocal
    scale = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, 127.0)
    r = torch.round(x / scale)                           # half to even
    q = torch.nan_to_num(r.clamp(-127.0, 127.0), nan=0.0)
    return q.to(torch.int8), scale


def quantize_pack_int8_ref(x: torch.Tensor) -> torch.Tensor:
    """The wire frame: uint8 (T, K+4) — the int8 values' bytes, then the
    4 little-endian bytes of each row's f32 scale."""
    q, scale = quantize_int8_ref(x)
    sbytes = scale.contiguous().view(torch.uint8)        # (T, 4)
    return torch.cat([q.view(torch.uint8), sbytes], dim=-1)

