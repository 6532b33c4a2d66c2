"""Plain PyTorch version of the SSD scan kernel: ``ssd_chunked``, line
for line the port's counterpart of ``repro.models.ssm.ssd_chunked`` (the
reference's jnp oracle for its ``mamba2_scan`` Pallas kernel), with the
optional ``initial_state``.  One line differs: the prefix sum is a
product with a triangle of ones, since ``torch.cumsum`` refuses CUDA
tensors in deterministic mode.

The CPU runs it through the wrapper in ``ops.py``; ``chip_smoke.py``
holds the CUDA kernels against it on the card.  The chunk-parallel
stage functions below are the plain versions of the ``chunked`` route's
three kernels, one each.
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


# ---------------------------------------------------------------------------
# The chunk-parallel decomposition the ``chunked`` route runs as three
# launches (csrc/mamba2_scan_chunked.cu): the chunks' own states, the
# state passing across chunks, and each chunk's output.  Chained, they
# compute what ``ssd_chunked`` computes.  Layouts are the kernels':
# states (B, H, nc, N, P) and totals (B, H, nc), in f32 — in f64 when x
# is f64, which makes the stages an f64 witness for f32 gradients.
# ---------------------------------------------------------------------------

def _work_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _chunks(x, dt, B_in, C_in, chunk):
    """The inputs padded to whole chunks, in f32 (f64 for an f64 x), per
    head: x (B, nc, L, H, P), dt (B, nc, L, H), B and C (B, nc, L, H,
    N); and L."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    work = _work_dtype(x)

    def padded(a):
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.to(work)

    xc = padded(x).reshape(Bb, nc, L, H, P)
    dtc = padded(dt).reshape(Bb, nc, L, H)
    Bh = padded(B_in).reshape(Bb, nc, L, G, N).repeat_interleave(H // G, 3)
    Ch = padded(C_in).reshape(Bb, nc, L, G, N).repeat_interleave(H // G, 3)
    return xc, dtc, Bh, Ch, L


def _cum(dtc, A, L):
    """Inclusive prefix sums of dt A inside each chunk (B, nc, L, H), as a
    product with a triangle of ones (deterministic on the card)."""
    upper = torch.triu(torch.ones((L, L), dtype=dtc.dtype,
                                  device=dtc.device))      # [k, i] = k <= i
    return torch.einsum("bckh,ki->bcih", dtc * A.to(dtc.dtype), upper)


def ssd_chunk_states(x, dt, A, B_in, chunk: int):
    """Stage (a): each chunk's own state, from a zero state,
    s_c = sum_j exp(cum_L - cum_j) dt_j B_j^T x_j, and cum_L.
    Returns (states (B, H, nc, N, P), totals (B, H, nc)), f32 (f64 for
    an f64 x)."""
    xc, dtc, Bh, _, L = _chunks(x, dt, B_in, B_in, chunk)
    cum = _cum(dtc, A, L)
    total = cum[:, :, -1]                                   # (B, nc, H)
    w = torch.exp(total[:, :, None] - cum) * dtc            # (B, nc, L, H)
    states = torch.einsum("bclh,bclhn,bclhp->bhcnp", w, Bh, xc)
    return states.contiguous(), total.permute(0, 2, 1).contiguous()


def ssd_state_passing(states, totals, initial_state=None):
    """Stage (b): S_c = exp(total_c) S_{c-1} + s_c over the chunks in
    order, from ``initial_state`` (zeros when None).  Returns (each
    chunk's incoming state S_{c-1} (B, H, nc, N, P), the final state
    (B, H, N, P)), in the states' dtype."""
    Bb, H, nc, N, P = states.shape
    s = (torch.zeros((Bb, H, N, P), dtype=states.dtype,
                     device=states.device) if initial_state is None
         else initial_state.to(states.dtype))
    incoming = []
    for c in range(nc):
        incoming.append(s)
        s = torch.exp(totals[:, :, c])[..., None, None] * s + states[:, :, c]
    return torch.stack(incoming, 2), s


def ssd_chunk_output(x, dt, A, B_in, C_in, incoming, chunk: int):
    """Stage (c): y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j
    x_j + exp(cum_i) C_i S_{c-1} for every chunk at once, the mask before
    the exp.  Returns y (B, S, H, P) in x's dtype."""
    Bb, S, H, P = x.shape
    xc, dtc, Bh, Ch, L = _chunks(x, dt, B_in, C_in, chunk)
    cum = _cum(dtc, A, L)                                   # (B, nc, L, H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None] - cum[:, :, None]             # (B,nc,i,j,H)
    Ldec = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                 torch.full_like(diff, -torch.inf)))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    M = scores * Ldec * dtc[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    y = y + torch.einsum("bcihn,bhcnp->bcihp",
                         Ch * torch.exp(cum)[..., None], incoming)
    nc = xc.shape[1]
    return y.reshape(Bb, nc * L, H, P)[:, :S].to(x.dtype)


def ssd_chunk_parallel(x, dt, A, B_in, C_in, chunk: int,
                       initial_state=None):
    """The three stages chained: what the ``chunked`` route computes.
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, N, P) f32,
    f64 for an f64 x), as ``ssd_chunked``."""
    states, totals = ssd_chunk_states(x, dt, A, B_in, chunk)
    incoming, final = ssd_state_passing(states, totals, initial_state)
    return ssd_chunk_output(x, dt, A, B_in, C_in, incoming, chunk), final
