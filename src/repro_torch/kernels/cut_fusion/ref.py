"""Plain PyTorch version of the fused cut layer (the port's counterpart
of ``repro/kernels/cut_fusion/ref.py``): build the combine, then take
the product.  The CPU runs it through the wrapper in ``ops.py``, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

COMBINES = ("concat", "sum", "mean")


def cut_fusion_ref(z: torch.Tensor, w: torch.Tensor, *,
                   combine: str = "concat") -> torch.Tensor:
    """z: (P, T, k); w: (P, k, d) — sum and mean read ``w[0]`` only, so
    a (1, k, d) ``w`` serves them too.  Returns (T, d) in z's dtype,
    accumulated in f32:

      concat:  sum_p z_p @ w_p   (== concat(z_0..z_{P-1}) @ W)
      sum:     (sum_p z_p) @ w_0
      mean:    ((sum_p z_p) / P) @ w_0
    """
    if combine not in COMBINES:
        raise ValueError(f"cut_fusion combines {COMBINES}, got "
                         f"{combine!r} (the TPU kernel has no max)")
    P = z.shape[0]
    zf = z.to(torch.float32)
    wf = w.to(torch.float32)
    if combine == "concat":
        out = zf[0] @ wf[0]
        for p in range(1, P):
            out = out + zf[p] @ wf[p]
    else:
        zc = zf.sum(0)
        if combine == "mean":
            zc = zc / P
        out = zc @ wf[0]
    return out.to(z.dtype)
