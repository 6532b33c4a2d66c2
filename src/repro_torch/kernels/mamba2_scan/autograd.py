"""The SSD scan under autograd: the kernel's forward, a backward of plain
products.

``ssd_fn(x, dt, A, B_in, C_in, chunk=...)`` is ``mamba2_scan`` with
gradients.  Its forward is the wrapper itself (``ops.mamba2_scan``): on
the card the route ``plan.choose_route`` picks (``chunked`` for bf16,
``serial`` for f32), on the CPU the plain ``ssd_chunked``.  Only the
inputs are saved.  Its backward is :func:`ssd_backward`, the same f32
products on both, so the CPU tests run the card's backward.  The
reference's TPU kernel has no backward either: it trains through the
autodiff of its jnp ``ssd_chunked``, whose function this backward
differentiates.

The backward reverses the three chunk-parallel stages of ``ref.py``
(chunk states, state passing, chunk outputs), so a later kernel can
take it over stage by stage.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan import ops
from repro_torch.kernels.mamba2_scan.ref import _chunks

#: largest f32 (B, chunks, H, L, L) block of one backward pass, in
#: elements; a larger call runs the chunk outputs' reverse in blocks of
#: chunks (each chunk's gradients are its own, so nothing is summed
#: across blocks)
BLOCK_ELEMENTS = 1 << 26


def _heads_first(t):
    """(B, nc, L, H, ...) -> (B, nc, H, L, ...), contiguous."""
    return t.transpose(2, 3).contiguous()


def _output_backward(x, dt, Bm, Cm, cum, incoming, dy):
    """Stage (c) reversed for a block of chunks, every tensor head-major
    (B, c, H, L, ...): from dy to dx, dB, dC, ddt, dcum and the incoming
    states' gradient.  ``M_ij = (C_i·B_j) exp(cum_i − cum_j) dt_j`` for
    j ≤ i (0 above the diagonal: the mask is put before the exp), ``y_i
    = Σ_j M_ij x_j + exp(cum_i) C_iᵀ S_in``.  With ``dM_ij = dy_i·x_j``,
    ``G = C Bᵀ`` and ``W = dM ∘ exp(cum_i − cum_j)``: ``ddt_j = Σ_i W_ij
    G_ij``, ``dcum_i = Σ_j W_ij G_ij dt_j − dt_i ddt_i`` (cum enters M
    as +cum_i and −cum_j), ``dG = W ∘ dt_j``.  The (L, L) products run
    in place where their operand is spent."""
    L = x.shape[3]
    above = torch.ones((L, L), dtype=torch.bool,
                       device=x.device).triu_(1)
    dtj = dt[..., None, :]                                  # (B,c,H,1,L)
    Ld = (cum[..., :, None] - cum[..., None, :]).masked_fill_(
        above, -torch.inf).exp_()                           # (B,c,H,i,j)
    G = Cm @ Bm.transpose(-1, -2)
    dM = dy @ x.transpose(-1, -2)
    M = (G * Ld).mul_(dtj)
    dx = M.transpose(-1, -2) @ dy
    del M
    W = dM.mul_(Ld)
    del Ld
    WG = G.mul_(W)
    ddt = WG.sum(-2)
    # dcum sums large terms that cancel, and dA sums its reverse prefix
    # sums: accumulated in f64 (in f32 the trunk's dA parts from an f64
    # evaluation by 1.2x the 2e-4 limit on the card)
    dcum = WG.mul_(dtj).sum(-1, dtype=torch.float64) - dt * ddt
    del WG, G
    dG = W.mul_(dtj)
    dC = dG @ Bm
    dB = dG.transpose(-1, -2) @ Cm
    del dG, W
    # the inter-chunk term exp(cum_i) C_iᵀ S_in
    E = torch.exp(cum)
    dC += E[..., None] * (dy @ incoming.transpose(-1, -2))
    dcum += E * ((Cm @ incoming) * dy).sum(-1)
    dS = (Cm * E[..., None]).transpose(-1, -2) @ dy
    return dx, dB, dC, ddt, dcum, dS


def ssd_backward(x, dt, A, B_in, C_in, dy, dfinal=None, *, chunk: int,
                 initial_state=None):
    """Gradients of ``(y, final) = ssd_chunked(x, dt, A, B_in, C_in,
    chunk, initial_state)`` for the incoming ``dy`` (B, S, H, P) and
    ``dfinal`` (B, H, N, P) or None (the final state unused).  Returns
    ``(dx, ddt, dA, dB_in, dC_in, d_initial_state)`` in the inputs'
    dtypes (``d_initial_state`` None without an initial state).

    In f32 products (dcum and dA, sums of large terms that cancel,
    accumulated in f64), per chunk of L positions with ``cum`` the
    inclusive prefix sum of dt·A, ``total`` its last entry and ``S_in``
    the incoming state (recomputed from the inputs):

    * chunk outputs: ``dM_ij = dy_i·x_j`` (j ≤ i) gives dx, dB, dC, ddt
      and a dcum term; the inter-chunk term gives dC, dcum and dS_in;
    * state passing in reverse: ``dS_{c−1} += exp(total_c) dS_c`` from
      ``dfinal`` (zeros when None), which also gives dtotal_c;
    * chunk states ``s_c = Σ_j exp(total − cum_j) dt_j B_j x_jᵀ``: dB,
      dx, ddt and dcum (dtotal lands on the chunk's last cum);
    * dcum → d(dt·A) by a reverse prefix sum, a product with the
      triangle of ones (``torch.cumsum`` has no deterministic CUDA
      path), then ``ddt += da·A`` and ``dA = Σ da·dt``;
    * dB and dC summed over the heads of each group.

    Every stage runs head-major, (B, chunks, H, L, ...), so its products
    are batched matrix products over contiguous operands.  No atomics
    and no data-dependent order: the same inputs give the same bits."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    f32 = torch.float32
    *parts, L = _chunks(x, dt, B_in, C_in, chunk)
    xc, dtc, Bh, Ch = (t.to(f32) for t in parts)
    nc = xc.shape[1]
    dyc = F.pad(dy.to(f32), (0, 0, 0, 0, 0, nc * L - S)).reshape(
        Bb, nc, L, H, P)
    x_, B_, C_, dy_ = (_heads_first(t) for t in (xc, Bh, Ch, dyc))
    del xc, Bh, Ch, dyc
    dt_ = dtc.transpose(2, 3).contiguous()                  # (B,nc,H,L)
    Af = A.to(f32)
    upper = torch.ones((L, L), dtype=f32, device=x.device).triu_()
    cum = (dt_ * Af[:, None]) @ upper                       # inclusive
    total = cum[..., -1]                                    # (B,nc,H)
    decay = torch.exp(total[..., None] - cum)
    w = decay * dt_                                         # (B,nc,H,L)

    # forward states: each chunk's own, then the incoming ones
    states = (B_ * w[..., None]).transpose(-1, -2) @ x_     # (B,nc,H,N,P)
    s = (torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    incoming = []
    for c in range(nc):
        incoming.append(s)
        s = torch.exp(total[:, c])[..., None, None] * s + states[:, c]
    incoming = torch.stack(incoming, 1)                     # (B,nc,H,N,P)
    del states, s

    # chunk outputs, in blocks of chunks
    step = max(1, BLOCK_ELEMENTS // max(1, Bb * H * L * L))
    parts = [_output_backward(*(t[:, lo:lo + step] for t in (
        x_, dt_, B_, C_, cum, incoming, dy_))) for lo in range(0, nc, step)]
    dx, dB, dC, ddt, dcum, dS = (torch.cat(t, 1) if len(parts) > 1
                                 else t[0] for t in zip(*parts))
    del parts, dy_

    # state passing, reversed
    g = (torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
         if dfinal is None else dfinal.to(f32))
    dstates, dtotal = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = g
        et = torch.exp(total[:, c])
        dtotal[c] = et * (incoming[:, c] * g).sum((-2, -1))
        g = et[..., None, None] * g + dS[:, c]
    dinit = g
    dstates = torch.stack(dstates, 1)                       # (B,nc,H,N,P)
    dtotal = torch.stack(dtotal, 1)                         # (B,nc,H)
    del incoming, dS

    # chunk states, reversed
    t = x_ @ dstates.transpose(-1, -2)                      # (B,nc,H,L,N)
    dB += w[..., None] * t
    dw = (t * B_).sum(-1)                                   # (B,nc,H,L)
    del t
    dx += w[..., None] * (B_ @ dstates)
    ddt += dw * decay
    dwx = dw * w
    dcum -= dwx
    dcum[..., -1] += dtotal + dwx.sum(-1)

    # the prefix sum reversed: da_k = Σ_{i ≥ k} dcum_i (f64, as dcum)
    da = dcum @ upper.T.double()
    ddt += da * Af[:, None]
    dA = (da * dt_).sum((0, 1, 3))

    def unchunk(t, shape):
        return t.transpose(2, 3).reshape((Bb, nc * L) + shape)[:, :S]

    dx = unchunk(dx, (H, P))
    ddt = unchunk(ddt, (H,))
    rep = H // G
    dB = unchunk(dB, (G, rep, N)).sum(3)
    dC = unchunk(dC, (G, rep, N)).sum(3)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B_in.dtype), dC.to(C_in.dtype),
            None if initial_state is None
            else dinit.to(initial_state.dtype))


class SSDScan(torch.autograd.Function):
    """``mamba2_scan`` forward (the kernel on the card), gradients from
    :func:`ssd_backward`; only the inputs are saved (the backward
    recomputes the states and the chunks' quadratic terms)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_in, C_in, chunk, initial_state):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B_in, C_in, initial_state)
        return ops.mamba2_scan(x, dt, A, B_in, C_in, chunk=chunk,
                               initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B_in, C_in, initial_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dinit = ssd_backward(
            x, dt, A, B_in, C_in, dy, dfinal, chunk=ctx.chunk,
            initial_state=initial_state)
        return dx, ddt, dA, dB, dC, None, dinit


def ssd_fn(x, dt, A, B_in, C_in, *, chunk: int,
           initial_state: Optional[torch.Tensor] = None):
    """The chunked SSD scan with gradients (see :class:`SSDScan`):
    ``(y, final_state)`` as ``mamba2_scan``."""
    return SSDScan.apply(x, dt, A, B_in, C_in, chunk, initial_state)
