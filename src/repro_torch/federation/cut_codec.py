"""Cut-payload codecs: the only tensors that cross the party boundary are
cut activations and cut gradients (the port's counterpart of the codecs
in ``repro.federation.transport``).

``fp16`` is a plain down-cast; ``int8`` is per-row symmetric quantization
fused with wire packing in one CUDA kernel
(``repro_torch/csrc/quantize.cu``): the payload is a single
``(rows, K+4)`` byte frame, values + bitcast scale.  Decoding is a plain
tensor multiply on the receiver's device.  ``to_tensor`` turns a received
payload value into a tensor.

These need torch and so live apart from ``federation/transport.py``,
whose frame, channel and endpoint code the torch-free PSI workers run.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["Codec", "FP16Codec", "Int8Codec", "get_codec", "to_tensor"]


def to_tensor(a, device) -> torch.Tensor:
    """A received payload value as a tensor on ``device`` (read-only wire
    views are copied first: torch tensors are writable; a ``bfloat16``
    frame entry already arrives as a ``torch.bfloat16`` tensor)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class Codec:
    """Encode/decode for cut payloads.  ``encode`` maps a float tensor to
    the wire payload dict (tensors stay on their device; a serializing
    channel copies them to the host); ``decode`` returns a tensor on
    ``device``, f32 for the lossy codecs.  The lossless codec ships the
    cut as it is, in its own dtype (f32 MLP cuts, bf16 LM cuts) — the
    receiver gets that dtype."""

    name = "none"

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def encode(self, t) -> Dict[str, object]:
        return {"x": t.detach()}

    def decode(self, payload: Dict[str, object]) -> torch.Tensor:
        return to_tensor(payload["x"], self.device)


class FP16Codec(Codec):
    name = "fp16"

    def encode(self, t):
        return {"h": t.detach().to(torch.float16)}

    def decode(self, payload):
        return to_tensor(payload["h"], self.device).to(torch.float32)


class Int8Codec(Codec):
    """Per-row symmetric int8 (scale = absmax/127 over the last axis),
    quantized and wire-packed in one kernel pass
    (``repro_torch.kernels.quantize.quantize_pack_int8``): the payload is
    one ``(rows, K+4)`` uint8 frame — K int8 values plus the
    little-endian f32 scale in the trailing 4 bytes of each row.  An f32
    or bf16 cut goes to the kernel as it is (bf16 is upcast exactly in
    its registers: the reference's frame of ``astype(float32)``); other
    dtypes are cast to f32 first."""

    name = "int8"

    def encode(self, t):
        from repro_torch.kernels.quantize import quantize_pack_int8
        a = t.detach()
        if a.dtype not in (torch.float32, torch.bfloat16):
            a = a.to(torch.float32)
        packed = quantize_pack_int8(a.reshape(-1, a.shape[-1]).contiguous())
        return {"qp": packed.reshape(a.shape[:-1] + (packed.shape[-1],))}

    def decode(self, payload):
        qp = to_tensor(payload["qp"], self.device)
        k = qp.shape[-1] - 4
        q = qp[..., :k].view(torch.int8).to(torch.float32)
        scale = qp[..., k:].contiguous().view(torch.float32)
        return q * scale


CODECS = {c.name: c for c in (Codec, FP16Codec, Int8Codec)}


def get_codec(name: Optional[str], device="cpu") -> Codec:
    key = name or "none"
    if key not in CODECS:
        raise ValueError(f"unknown compression {name!r}; "
                         f"known: {sorted(CODECS)}")
    return CODECS[key](device)
