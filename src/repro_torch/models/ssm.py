"""Mamba2 (SSD) block (the port's counterpart of ``repro.models.ssm``).

The chunked scan of a prefill (or of a forward without a cache) is the
kernel's wrapper (``repro_torch.kernels.mamba2_scan``): on a CUDA tensor
it launches the hand-written SSD scan kernel, on a CPU tensor it runs
the plain ``ssd_chunked``.  A forward without a cache that autograd
records (training) goes through ``ssd_fn``: the same wrapper forward,
with a backward of plain products.  A decode step (one token with a
cache) is the single-step recurrence :func:`ssd_step` in plain PyTorch,
as in the reference, where it is not a kernel either.

Caches are updated in place (the reference returns updated copies): the
conv window and the SSM state are copied into the f32 cache.  Left-pad
tokens flow through the state unmasked, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan import mamba2_scan, ssd_fn
from repro_torch.models import layers
from repro_torch.sharding.dtensor import is_dtensor, on_shards


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (with decode state)
# ---------------------------------------------------------------------------


def conv1d_apply(w, x, state=None):
    """Depthwise causal conv.  w: (W, C); x: (B, S, C).

    ``state``: (B, W-1, C) previous inputs for decode.  Returns (y,
    new_state).  The reference's sum of W shifted products in x's dtype,
    in its order (not ``F.conv1d``: cuDNN would take TF32 and another
    summation order).  On the dry-run's DTensors each rank convolves its
    rows and channels (DTensor cannot place the padding)."""
    if is_dtensor(x):
        args = (x, w) + (() if state is None else (state,))
        return on_shards(lambda x, w, *st: conv1d_apply(w, x, *st), args,
                         [(0, 2), (None, 1), (0, 2)][:len(args)],
                         [(0, 2), (0, 2)])
    W = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(x_pad[:, i:i + x.shape[1]] * layers.cast(w[i], x.dtype)
            for i in range(W))
    new_state = x_pad[:, -(W - 1):] if W > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# SSD decode step
# ---------------------------------------------------------------------------


def ssd_step(x, dt, A, B_in, C_in, state):
    """Single decode step.  x: (B, 1, H, P); state: (B, H, N, P)."""
    f32 = torch.float32
    H = x.shape[2]
    G = B_in.shape[2]
    rep = H // G
    xf = x[:, 0].to(f32)                                   # (B,H,P)
    dtf = dt[:, 0].to(f32)                                 # (B,H)
    Bh = B_in[:, 0].to(f32).repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = C_in[:, 0].to(f32).repeat_interleave(rep, dim=1)
    decay = torch.exp(dtf * A.to(f32))                     # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dtf, Bh, xf)
    new_state = decay[..., None, None] * state.to(f32) + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    return y[:, None].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return s, d_in, H, d_in + 2 * s.n_groups * s.d_state


def mamba2_init(gen, cfg):
    """The reference's layout and distributions (not its draws): dense
    projections N(0, 1/d_in), conv weights N(0, 0.2^2), ``A_log`` =
    log(linspace(1, 16, H)), ``dt_bias`` 0, ``D`` 1, gate norm zero."""
    s, d_in, H, conv_ch = _dims(cfg)
    d, dev = cfg.d_model, gen.device
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": layers.dense_init(
            gen, d, 2 * d_in + 2 * s.n_groups * s.d_state + H),
        "conv_w": layers.normal(gen, (s.d_conv, conv_ch), 0.2),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "dt_bias": torch.zeros((H,), device=dev),
        "D": torch.ones((H,), device=dev),
        "gate_norm": layers.norm_init(d_in, "rmsnorm", dev),
        "out_proj": layers.dense_init(gen, d_in, d),
    }


def mamba2_cache_init(batch: int, cfg, device="cpu"):
    """The decode cache, f32 whatever the compute dtype (as in the
    reference): the last W-1 conv inputs and the (H, N, P) SSM state."""
    s, _, H, conv_ch = _dims(cfg)
    f32 = torch.float32
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=f32,
                                device=device),
            "state": torch.zeros((batch, H, s.d_state, s.head_dim),
                                 dtype=f32, device=device)}


def mamba2_apply(params, x, cfg, cache=None):
    """x: (B, S, d) -> (y (B, S, d), cache); the cache is updated in
    place."""
    s, d_in, H, _ = _dims(cfg)
    Bb, S, _ = x.shape
    gn = s.n_groups * s.d_state

    zxbcdt = layers.dense_apply(params["in_proj"], x)
    z, dt = zxbcdt[..., :d_in], zxbcdt[..., 2 * d_in + 2 * gn:]
    conv_in = zxbcdt[..., d_in:2 * d_in + 2 * gn]           # [x, B, C]
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = conv1d_apply(params["conv_w"], conv_in, conv_state)
    conv_out = F.silu(conv_out)
    # x, B and C stay views of conv_out: the scan reads them strided
    xh = conv_out[..., :d_in].reshape(Bb, S, H, s.head_dim)
    Bm = conv_out[..., d_in:d_in + gn].reshape(Bb, S, s.n_groups,
                                               s.d_state)
    Cm = conv_out[..., d_in + gn:].reshape(Bb, S, s.n_groups, s.d_state)

    dt = F.softplus(dt.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))

    if cache is not None and S == 1:          # decode: single-step recurrence
        y, new_state = ssd_step(xh, dt, A, Bm, Cm, cache["state"])
    else:
        # training: the kernel's forward, a backward of plain products;
        # forward / prefill: the kernel.  On the dry-run's DTensors it
        # runs on each rank's rows and heads (and groups, when G > 1)
        if cache is None and torch.is_grad_enabled() and any(
                t.requires_grad for t in (xh, dt, A, Bm, Cm)):
            def scan(*a):
                return ssd_fn(*a, chunk=s.chunk_size)
            args = (xh, dt, A, Bm, Cm)
        else:
            def scan(*a):
                return mamba2_scan(*a[:5], chunk=s.chunk_size,
                                   initial_state=a[5])
            args = (xh, dt, A, Bm, Cm,
                    cache["state"] if cache is not None else None)
        g = (0, 2) if s.n_groups > 1 else (0, None)
        dims = [(0, 2), (0, 2), (None, 0), g, g, (0, 1)][:len(args)]
        y, new_state = on_shards(scan, args, dims, [(0, 2), (0, 1)])

    y = y + params["D"].to(torch.float32)[None, None, :, None] \
        * xh.to(torch.float32)
    y = y.reshape(Bb, S, d_in).to(x.dtype)
    y = layers.norm_apply(params["gate_norm"], y * F.silu(z), "rmsnorm")
    out = layers.dense_apply(params["out_proj"], y)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    return out, cache
