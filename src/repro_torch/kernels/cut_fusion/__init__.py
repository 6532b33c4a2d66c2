"""The fused cut layer and its gradient.

``cut_fusion_fn(z, w, combine)`` is ``combine(z) @ W`` under autograd:
the forward is the kernel wrapper (``ops.cut_fusion``), the backward
plain products, as in the reference, which has no backward kernel for
it.  Each gradient is computed only when autograd asks for it
(``ctx.needs_input_grad``), and always by the same product whichever
caller asks: the pipelined trunk's cut-gradient half asks for ``dz``
alone, its weight-gradient half for ``dW`` alone, the joint step for
both, and split == joint stays bitwise only if the three agree.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cut_fusion.ops import (  # noqa: F401
    cut_fusion, launch_counts, reset_launch_counts, route_of)
from repro_torch.kernels.cut_fusion.ref import (  # noqa: F401
    COMBINES, cut_fusion_ref)


class CutFusion(torch.autograd.Function):
    """Gradients of ``out = combine(z) @ W`` for the incoming ``g`` (T, d):

      concat:  dz_p = g @ W_pᵀ;             dW_p = z_pᵀ @ g
      sum:     dz_p = g @ W_0ᵀ (one product, shared by every owner);
               dW_0 = (Σ_p z_p)ᵀ @ g
      mean:    dz_p = (g @ W_0ᵀ) / P;       dW_0 = ((Σ_p z_p) / P)ᵀ @ g

    the reference's autodiff of its combine + product.  For sum and
    mean, block rows of W past the first get zero gradient."""

    @staticmethod
    def forward(ctx, z, w, combine):
        ctx.save_for_backward(z, w)
        ctx.combine = combine
        return cut_fusion(z, w, combine)

    @staticmethod
    def backward(ctx, g):
        z, w = ctx.saved_tensors
        need_z, need_w, _ = ctx.needs_input_grad
        dz = dw = None
        P = z.shape[0]
        if ctx.combine == "concat":
            if need_z:
                dz = torch.matmul(g, w.transpose(1, 2))        # (P, T, k)
            if need_w:
                dw = torch.matmul(z.transpose(1, 2), g)        # (P, k, d)
            return dz, dw, None
        if need_z:
            d = g @ w[0].t()
            if ctx.combine == "mean":
                d = d / P
            dz = d.expand(P, *d.shape)
        if need_w:
            zc = z.sum(0)
            if ctx.combine == "mean":
                zc = zc / P
            dw = (zc.t() @ g)[None]
            if w.shape[0] > 1:
                dw = torch.cat([dw, dw.new_zeros((w.shape[0] - 1,)
                                                 + dw.shape[1:])])
        return dz, dw, None


def cut_fusion_fn(z: torch.Tensor, w: torch.Tensor,
                  combine: str = "concat") -> torch.Tensor:
    """``combine(z) @ W`` with gradients (see :class:`CutFusion`)."""
    return CutFusion.apply(z, w, combine)
