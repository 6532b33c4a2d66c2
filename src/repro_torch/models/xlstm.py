"""xLSTM blocks: mLSTM (chunked parallel, matrix memory) and sLSTM
(sequential scan, scalar memory with exponential gating)
[arXiv:2405.04517] (the port's counterpart of ``repro.models.xlstm``).

Both use max-state stabilization of the exponential gates.  The mLSTM is
a gated linear-attention recurrence computed chunkwise with a (C, n, m)
carry; a Python loop over the chunks takes the place of ``lax.scan``.
The sLSTM is a true sequential recurrence, one cell step per token.
Neither has a kernel in the reference: both are plain PyTorch here.

As in the reference: a ragged last chunk pads ``i`` with ``NEG`` (no
input) and ``f`` with 0 (a decay of ``logsigmoid(0)``), and the final
carry of such a call decays through the pad; ``m`` is clamped at
``NEG / 2``; the caches are f32 whatever the compute dtype, with ``m``
starting at ``NEG``; the sLSTM's ``h`` takes the cache's dtype (f32) in
a call with a cache and ``x``'s without, and the up/down projections
after the scan run in that dtype.  Caches are updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.ssm import conv1d_apply
from repro_torch.sharding.dtensor import on_shards, pinned, split_heads

NEG = -2.0 ** 30


# ---------------------------------------------------------------------------
# mLSTM core (chunkwise parallel with (C, n, m) carry)
# ---------------------------------------------------------------------------


def mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int, carry=None):
    """q, k, v: (B, S, H, D); i_raw, f_raw: (B, S, H).

    Returns (y (B, S, H, D) in q's dtype, carry=(C (B, H, D, D), n (B, H,
    D), m (B, H)) in f32)."""
    Bb, S, H, D = q.shape
    f32 = torch.float32
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def padded(a, fill=0.0):
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad), value=fill)
        return a.to(f32)

    qc = padded(q).reshape(Bb, nc, L, H, D)
    kc = padded(k).reshape(Bb, nc, L, H, D)
    vc = padded(v).reshape(Bb, nc, L, H, D)
    # pad f with 0 raw -> logsigmoid(0) decay; pad i with NEG (no input)
    ic = padded(i_raw, NEG).reshape(Bb, nc, L, H)
    fc = padded(f_raw).reshape(Bb, nc, L, H)

    if carry is None:
        Cp = torch.zeros((Bb, H, D, D), dtype=f32, device=q.device)
        np_ = torch.zeros((Bb, H, D), dtype=f32, device=q.device)
        mp = torch.full((Bb, H), NEG, dtype=f32, device=q.device)
    else:
        Cp, np_, mp = (c.to(f32) for c in carry)

    scale = D ** -0.5
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    ys = []
    for c in range(nc):
        qk_, kk, vk = qc[:, c] * scale, kc[:, c], vc[:, c]
        ik, fk = ic[:, c], fc[:, c]
        logf = F.logsigmoid(fk)                          # (B,L,H)
        b = torch.cumsum(logf, dim=1)                    # inclusive
        # the state after step j reaches i through sum_{t=j+1..i} logf_t
        wij = b[:, :, None, :] - b[:, None, :, :] + ik[:, None, :, :]
        wij = torch.where(tri[None, :, :, None], wij, NEG)  # (B,i,j,H)
        u = b + mp[:, None, :]                           # inter weight
        m_new = torch.maximum(wij.amax(dim=2), u)        # (B,L,H)
        m_new = m_new.clamp(min=NEG / 2)
        w = torch.exp(wij - m_new[:, :, None, :])        # (B,i,j,H)
        inter = torch.exp(u - m_new)                     # (B,L,H)

        s = torch.einsum("blhd,bmhd->blmh", qk_, kk)     # (B,i,j,H)
        sw = s * w
        num = torch.einsum("blmh,bmhd->blhd", sw, vk) \
            + inter[..., None] * torch.einsum("blhd,bhde->blhe", qk_, Cp)
        den = sw.sum(dim=2) + inter * torch.einsum("blhd,bhd->blh", qk_,
                                                   np_)
        ys.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_new))[..., None])

        # carry update
        btot = b[:, -1]                                  # (B,H)
        wlast = btot[:, None, :] - b + ik                # (B,L,H)
        m_next = torch.maximum(btot + mp, wlast.amax(dim=1))
        wl = torch.exp(wlast - m_next[:, None, :])
        decay = torch.exp(btot + mp - m_next)
        Cp = decay[..., None, None] * Cp \
            + torch.einsum("blhd,blhe->bhde", wl[..., None] * kk, vk)
        np_ = decay[..., None] * np_ + torch.einsum("blh,blhd->bhd", wl, kk)
        mp = m_next
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(q.dtype), (Cp, np_, mp)


def mlstm_step(q, k, v, i_raw, f_raw, carry):
    """Single decode step.  q, k, v: (B, 1, H, D); carry=(C, n, m)."""
    f32 = torch.float32
    D = q.shape[-1]
    Cp, np_, mp = (c.to(f32) for c in carry)
    qf = q[:, 0].to(f32) * (D ** -0.5)
    kf, vf = k[:, 0].to(f32), v[:, 0].to(f32)
    ik, fk = i_raw[:, 0].to(f32), f_raw[:, 0].to(f32)
    logf = F.logsigmoid(fk)
    m_new = torch.maximum(logf + mp, ik)
    fdec = torch.exp(logf + mp - m_new)
    iin = torch.exp(ik - m_new)
    Cn = fdec[..., None, None] * Cp + iin[..., None, None] \
        * torch.einsum("bhd,bhe->bhde", kf, vf)
    nn = fdec[..., None] * np_ + iin[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, Cn)
    den = torch.einsum("bhd,bhd->bh", qf, nn)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return y[:, None].to(q.dtype), (Cn, nn, m_new)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _m_dims(cfg):
    d_in = int(cfg.xlstm.m_proj_factor * cfg.d_model)
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def mlstm_init(gen, cfg):
    """The reference's layout and distributions (not its draws)."""
    x = cfg.xlstm
    d, H = cfg.d_model, cfg.n_heads
    d_in, _, _ = _m_dims(cfg)
    dev = gen.device
    return {
        "up_x": layers.dense_init(gen, d, d_in),
        "up_z": layers.dense_init(gen, d, d_in),
        "conv_w": layers.normal(gen, (x.conv_width, d_in), 0.2),
        "wq": layers.dense_init(gen, d_in, d_in),
        "wk": layers.dense_init(gen, d_in, d_in),
        "wv": layers.dense_init(gen, d_in, d_in),
        "w_if": layers.dense_init(gen, d_in, 2 * H, scale=0.02),
        "if_bias": torch.cat([torch.zeros((H,), device=dev),
                              torch.full((H,), 3.0, device=dev)]),
        "out_norm": layers.norm_init(d_in, "rmsnorm", dev),
        "down": layers.dense_init(gen, d_in, d),
    }


def mlstm_cache_init(batch: int, cfg, device="cpu"):
    """The decode cache in f32: the conv window, C, n and m (at NEG)."""
    d_in, H, D = _m_dims(cfg)
    f32 = torch.float32
    return {"conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, d_in),
                                dtype=f32, device=device),
            "C": torch.zeros((batch, H, D, D), dtype=f32, device=device),
            "n": torch.zeros((batch, H, D), dtype=f32, device=device),
            "m": torch.full((batch, H), NEG, dtype=f32, device=device)}


def mlstm_apply(params, x, cfg, cache=None):
    """x: (B, S, d) -> (out (B, S, d), cache); the cache is updated in
    place."""
    Bb, S, _ = x.shape
    d_in, H, D = _m_dims(cfg)
    xi = layers.dense_apply(params["up_x"], x)
    z = layers.dense_apply(params["up_z"], x)
    conv_state = cache["conv"] if cache is not None else None
    xconv, new_conv = conv1d_apply(params["conv_w"], xi, conv_state)
    xconv = F.silu(xconv)
    q = split_heads(layers.dense_apply(params["wq"], xconv), H, D)
    k = split_heads(layers.dense_apply(params["wk"], xconv), H, D)
    v = split_heads(layers.dense_apply(params["wv"], xi), H, D)
    gates = layers.dense_apply(params["w_if"], xconv) \
        + layers.cast(params["if_bias"], x.dtype)
    i_raw, f_raw = gates[..., :H], gates[..., H:]         # (B,S,H)

    carry = () if cache is None else (cache["C"], cache["n"], cache["m"])

    def core(q, k, v, i_raw, f_raw, *carry):
        if carry and S == 1:                  # decode
            y, carry = mlstm_step(q, k, v, i_raw, f_raw, carry)
        else:                                 # train / prefill
            y, carry = mlstm_chunked(q, k, v, i_raw, f_raw,
                                     cfg.xlstm.chunk_size,
                                     carry=carry or None)
        return (y,) + tuple(carry)

    # on the dry-run's DTensors the recurrence runs on each rank's rows
    # and heads, as the kernels do
    y, *carry = on_shards(core, (q, k, v, i_raw, f_raw) + carry,
                          [(0, 2)] * 5 + [(0, 1)] * len(carry),
                          [(0, 2)] + [(0, 1)] * 3)

    y = pinned(y.reshape(Bb, S, d_in))
    y = layers.norm_apply(params["out_norm"], y, "rmsnorm")
    y = y * F.silu(z)
    out = layers.dense_apply(params["down"], y)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        for key, val in zip(("C", "n", "m"), carry):
            cache[key].copy_(val)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM block (true sequential recurrence)
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg):
    """The reference's layout and distributions (not its draws)."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    d_ff = int(cfg.xlstm.s_proj_factor * d)
    return {
        # 4 gates (i, f, z, o) from the input ...
        "w_gates": layers.dense_init(gen, d, 4 * d),
        # ... and per-head recurrent connections from h_{t-1}
        "r_gates": layers.normal(gen, (H, hd, 4 * hd), 1.0 / math.sqrt(hd)),
        "gate_bias": torch.zeros((4 * d,), device=gen.device),
        "up": layers.dense_init(gen, d, d_ff),
        "down": layers.dense_init(gen, d_ff, d),
    }


def slstm_cache_init(batch: int, cfg, device="cpu"):
    """The decode cache in f32: c, n, h at 0 and m at NEG."""
    H = cfg.n_heads
    shape = (batch, H, cfg.d_model // H)

    def zeros():
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full(shape, NEG, dtype=torch.float32, device=device)}


def _slstm_cell(gx, state, r_gates):
    """One recurrence step, head-major: gx (H, B, 4*hd) f32 input-side
    gate preacts, state (c, n, h, m) of (H, B, hd), ``r_gates`` (H, hd,
    4*hd) f32.  ``h`` is multiplied in f32 (JAX promotes the bf16 ``h``
    against the f32 weights) and comes back in its own dtype."""
    c, n, h, m = state
    g = torch.baddbmm(gx, h.to(torch.float32), r_gates)   # gx + h @ r
    gi, gf, gz, go = g.chunk(4, dim=-1)                   # (H,B,hd) each
    gfm = gf + m
    m_new = torch.maximum(gfm, gi)                        # exp-gate stabilizer
    i = torch.exp(gi - m_new)
    f = torch.exp(gfm - m_new)
    c_new = torch.addcmul(f * c, i, torch.tanh(gz))
    n_new = torch.addcmul(i, f, n)
    h_new = torch.sigmoid(go) * c_new / n_new.clamp(min=1.0)
    return (c_new, n_new, h_new.to(h.dtype), m_new)


def slstm_apply(params, x, cfg, cache=None):
    """x: (B, S, d) -> (out (B, S, d), cache); the cache is updated in
    place.  The scan runs head-major ((H, B, ·) states, one batched
    product per step); the cache keeps the reference's (B, H, hd)."""
    Bb, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    f32 = torch.float32
    gx = layers.dense_apply(params["w_gates"], x) \
        + layers.cast(params["gate_bias"], x.dtype)
    # (S, H, B, 4*hd) in f32: each step's preacts contiguous
    gx = split_heads(gx, H, 4 * hd).permute(1, 2, 0, 3).to(
        f32).contiguous()
    r = layers.cast(params["r_gates"], f32)

    st = () if cache is None else tuple(
        cache[k].transpose(0, 1) for k in ("c", "n", "h", "m"))

    def scan(gx, r, *st):
        if not st:
            zero = torch.zeros(gx.shape[1:3] + (hd,), dtype=f32,
                               device=gx.device)
            st = (zero, zero, zero.to(x.dtype), torch.full_like(zero, NEG))
        ys = []
        # one unbind, not S selects: the backward stacks the steps'
        # gradients once instead of adding S zero-padded copies of gx's
        for g in gx.unbind(0):
            st = _slstm_cell(g, st, r)
            ys.append(st[2])
        return (torch.stack(ys, dim=2).permute(1, 2, 0, 3),) + st

    # on the dry-run's DTensors the scan runs on each rank's rows and
    # heads: its S steps are plain ops on the local shard
    y, *st = on_shards(scan, (gx, r) + st,
                       [(2, 1), (None, 0)] + [(1, 0)] * len(st),
                       [(0, 2)] + [(1, 0)] * 4)         # y (B,S,H,hd)
    if cache is not None:
        for key, val in zip(("c", "n", "h", "m"), st):
            cache[key].copy_(val.transpose(0, 1))

    y = pinned(y.reshape(Bb, S, d))
    h = layers.dense_apply(params["up"], y)
    h = F.gelu(h, approximate="tanh")
    out = layers.dense_apply(params["down"], h)
    return out, cache
