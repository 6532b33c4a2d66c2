"""Plain PyTorch version of the SSD scan kernel: ``ssd_chunked``, line
for line the port's counterpart of ``repro.models.ssm.ssd_chunked`` (the
reference's jnp oracle for its ``mamba2_scan`` Pallas kernel), with the
optional ``initial_state``.  One line differs: the prefix sum is a
product with a triangle of ones, since ``torch.cumsum`` refuses CUDA
tensors in deterministic mode.

The CPU runs it through the wrapper in ``ops.py``; ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, A, B_in, C_in, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (B, S, H, P)   per-head inputs
    dt: (B, S, H)     positive step sizes
    A: (H,)           negative per-head decay rates
    B_in, C_in: (B, S, G, N)   input/output projections (G groups, H%G==0)
    initial_state: (B, H, N, P) or None (zeros)
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, N, P) f32).
    """
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    rep = H // G
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    f32 = torch.float32

    def padded(a):
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.to(f32)

    xc = padded(x).reshape(Bb, nc, L, H, P)
    dtc = padded(dt).reshape(Bb, nc, L, H)
    Bc = padded(B_in).reshape(Bb, nc, L, G, N)
    Cc = padded(C_in).reshape(Bb, nc, L, G, N)
    Bh = Bc.repeat_interleave(rep, dim=3)                   # (B,nc,L,H,N)
    Ch = Cc.repeat_interleave(rep, dim=3)

    if initial_state is None:
        s = torch.zeros((Bb, H, N, P), dtype=f32, device=x.device)
    else:
        s = initial_state.to(f32)

    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # the inclusive prefix sum over a chunk as a product with the upper
    # triangle of ones: torch.cumsum on a CUDA tensor has no deterministic
    # implementation, and the card runs in deterministic mode
    upper = mask.T.to(f32)                                 # [k, i] = k <= i
    Af = A.to(f32)

    ys = []
    for c in range(nc):                  # one chunk per step, as the scan
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bh[:, c], Ch[:, c]
        a = dtk * Af                                        # (B,L,H) <= 0
        cum = torch.einsum("bkh,ki->bih", a, upper)         # inclusive
        total = cum[:, -1]                                  # (B,H)
        # within-chunk quadratic term: L_ij = exp(cum_i - cum_j), j <= i;
        # masked before the exp (the j > i entries would overflow)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (B,i,j,H)
        Ldec = torch.exp(torch.where(mask[None, :, :, None], diff,
                                     torch.full_like(diff, -torch.inf)))
        scores = torch.einsum("blhn,bmhn->blmh", Ck, Bk)    # (B,i,j,H)
        M = scores * Ldec * dtk[:, None, :, :]              # weight dt_j
        y_intra = torch.einsum("blmh,bmhp->blhp", M, xk)
        # inter-chunk term from the carried state
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               Ck * torch.exp(cum)[..., None], s)
        # chunk state contribution + recurrence
        w = torch.exp(total[:, None] - cum) * dtk           # (B,L,H)
        state_c = torch.einsum("blh,blhn,blhp->bhnp", w, Bk, xk)
        s = torch.exp(total)[..., None, None] * s + state_c
        ys.append(y_intra + y_inter)

    y = torch.stack(ys, dim=1).reshape(Bb, nc * L, H, P)[:, :S]
    return y.to(x.dtype), s
