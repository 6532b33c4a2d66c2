"""Block assembly: super-blocks stacked over units (the port's
counterpart of ``repro.models.transformer``).

An architecture is ``n_superblocks`` repetitions of ``cfg.block_pattern``
(e.g. zamba2: 5x mamba2 + 1 shared_attn).  Parameters of the units are
stacked on a leading dim, as in the reference; a Python loop over the
units takes the place of ``lax.scan``.  Zero units is a valid stack (the
reduced llama's and zamba2's heads): the stack then returns its input
unchanged.

The port builds every kind of the reference's: ``attn:global``,
``attn:local`` and ``shared_attn`` blocks (attention with the dense or
the MoE FFN; the shared block's params live once in ``shared`` and every
unit's slot for it is ``{}``), ``mamba2`` blocks, the xLSTM's ``slstm``
and ``mlstm`` blocks, and the whisper decoder block ``dec`` (causal
self-attention, then ``norm_x`` and cross-attention ``xattn`` over the
encoder's output ``enc_out``, then the FFN).  A stack's ``pattern``
defaults to ``cfg.block_pattern``; the encoder-decoder passes its own
(``("attn:global",)`` for the encoder, ``("dec",)`` for the decoder).  A
block with the MoE FFN returns its balance loss as an auxiliary loss,
which ``stack_apply`` sums from an f32 zero as the reference does.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import (attention, layers, mlp as mlp_mod,
                                moe as moe_mod, ssm, xlstm)
from repro_torch.tree import stack_draws, tree_leaves, tree_map

#: the kinds that run attention
ATTENTION = ("attn:global", "attn:local", "shared_attn", "dec")
#: the recurrent kinds: (params key, init, f32 cache init, apply)
RECURRENT = {
    "mamba2": ("mamba", ssm.mamba2_init, ssm.mamba2_cache_init,
               ssm.mamba2_apply),
    "slstm": ("cell", xlstm.slstm_init, xlstm.slstm_cache_init,
              xlstm.slstm_apply),
    "mlstm": ("cell", xlstm.mlstm_init, xlstm.mlstm_cache_init,
              xlstm.mlstm_apply)}


def _has_ffn(cfg) -> bool:
    return cfg.moe is not None or (cfg.d_ff > 0 and cfg.mlp != "none")


def _ffn_init(gen, cfg):
    if cfg.moe is not None:
        return moe_mod.moe_init(gen, cfg.d_model, cfg.moe, cfg.mlp)
    return mlp_mod.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp)


def _ffn_apply(params, x, cfg):
    """(y, aux): the MoE FFN's balance loss, or ``None`` for the dense
    FFN."""
    if cfg.moe is not None:
        return moe_mod.moe_apply(params, x, cfg.moe, cfg.mlp)
    return mlp_mod.mlp_apply(params, x, cfg.mlp), None


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg, kind: str):
    d, dev = cfg.d_model, gen.device
    p = {"norm1": layers.norm_init(d, cfg.norm, dev)}
    if kind in RECURRENT:
        key, init, _, _ = RECURRENT[kind]
        p[key] = init(gen, cfg)
        return p
    if kind not in ATTENTION:
        raise ValueError(kind)
    p["attn"] = attention.attn_init(gen, cfg)
    if kind == "dec":
        p["norm_x"] = layers.norm_init(d, cfg.norm, dev)
        p["xattn"] = attention.attn_init(gen, cfg)
    if _has_ffn(cfg):
        p["norm2"] = layers.norm_init(d, cfg.norm, dev)
        p["ffn"] = _ffn_init(gen, cfg)
    if cfg.post_block_norm:
        p["post1"] = layers.norm_init(d, cfg.norm, dev)
        if _has_ffn(cfg):
            p["post2"] = layers.norm_init(d, cfg.norm, dev)
    return p


def block_cache_init(batch: int, cfg, kind: str, s_max: int,
                     dtype=torch.bfloat16, device="cpu",
                     window_slots: int = 0):
    """KV caches in ``dtype`` of ``min(s_max, window_slots)`` slots
    (``s_max`` when ``window_slots`` is 0); the Mamba2 and xLSTM caches
    in f32 whatever ``dtype`` and ``window_slots`` are."""
    if kind in RECURRENT:
        return RECURRENT[kind][2](batch, cfg, device)
    if kind not in ATTENTION:
        raise ValueError(kind)
    s_eff = min(s_max, window_slots) if window_slots else s_max
    return attention.init_kv_cache(batch, s_eff, cfg.n_kv_heads,
                                   cfg.head_dim, dtype, device)


def block_apply(params, x, *, cfg, kind: str, positions=None,
                attn_kind: str = "causal", window: int = 0, cache=None,
                pos=None, enc_out=None):
    """Returns (x_out, cache, aux): ``aux`` the MoE FFN's balance loss,
    ``None`` for every other block.  ``enc_out``: the encoder's output,
    which a ``dec`` block cross-attends."""
    h = layers.norm_apply(params["norm1"], x, cfg.norm, cfg.norm_eps)
    if kind in RECURRENT:
        key, _, _, apply = RECURRENT[kind]
        y, cache = apply(params[key], h, cfg, cache)
        return x + y.to(x.dtype), cache, None
    if kind not in ATTENTION:
        raise ValueError(kind)
    aux = None
    a, cache = attention.attn_apply(
        params["attn"], h, cfg=cfg, kind=attn_kind, positions=positions,
        window=window, cache=cache, pos=pos)
    if cfg.post_block_norm:
        a = layers.norm_apply(params["post1"], a, cfg.norm, cfg.norm_eps)
    x = x + a
    if kind == "dec" and enc_out is not None:
        h = layers.norm_apply(params["norm_x"], x, cfg.norm, cfg.norm_eps)
        a, _ = attention.attn_apply(params["xattn"], h, cfg=cfg,
                                    kind="bidir", kv_x=enc_out)
        x = x + a
    if _has_ffn(cfg):
        h = layers.norm_apply(params["norm2"], x, cfg.norm, cfg.norm_eps)
        f, aux = _ffn_apply(params["ffn"], h, cfg)
        if cfg.post_block_norm:
            f = layers.norm_apply(params["post2"], f, cfg.norm, cfg.norm_eps)
        x = x + f
    return x, cache, aux


# ---------------------------------------------------------------------------
# Stack of super-blocks
# ---------------------------------------------------------------------------


def stack_init(gen, cfg, n_units: int, pattern=None):
    """Returns {"units": unit-stacked params, "shared": shared params}.
    Zero units give leaves of shape (0, ...) (one unit is drawn for the
    shapes); the shared block exists whatever the number of units.
    ``pattern``: the unit's block kinds (default ``cfg.block_pattern``)."""
    pattern = pattern if pattern is not None else cfg.block_pattern
    shared = {}
    if "shared_attn" in pattern:
        shared["shared_attn"] = block_init(gen, cfg, "shared_attn")

    def draw_unit():
        return {f"b{i}": ({} if kind == "shared_attn"   # params in `shared`
                          else block_init(gen, cfg, kind))
                for i, kind in enumerate(pattern)}
    return {"units": stack_draws(draw_unit, n_units), "shared": shared}


def stack_cache_init(batch: int, cfg, n_units: int, s_max: int,
                     dtype=torch.bfloat16, device="cpu", ring: bool = False,
                     swa_override: int = 0, pattern=None):
    """Caches of every unit, stacked on a leading dim (n_units, ...).
    ``ring=True`` trims sliding-window layers' caches to their window
    (ring-buffer slots): ``attn:local`` to ``cfg.swa_window``, and with
    ``swa_override`` set (the long-context variant) ``attn:global`` and
    ``shared_attn`` to that window (a ``dec`` block's cache is never
    trimmed, as in the reference).  ``pattern``: as in
    :func:`stack_init`."""
    pattern = pattern if pattern is not None else cfg.block_pattern

    def slots(kind):
        if not ring:
            return 0
        if kind == "attn:local":
            return cfg.swa_window
        if kind in ("attn:global", "shared_attn") and swa_override:
            return swa_override
        return 0

    return {f"b{i}": tree_map(
        lambda a: a[None].repeat((n_units,) + (1,) * a.dim()),
        block_cache_init(batch, cfg, kind, s_max, dtype, device,
                         window_slots=slots(kind)))
        for i, kind in enumerate(pattern)}


def unit(tree, u: int):
    """Unit ``u``'s slice of a unit-stacked tree (views, no copies)."""
    return tree_map(lambda a: a[u], tree)


def _unit_apply(x, aux, up, shared, *, cfg, pattern, positions, caches,
                pos, enc_out, swa_override, bidir):
    """One unit (one repetition of ``pattern``): returns (x, aux), the
    unit's blocks' auxiliary losses added to ``aux`` in block order."""
    for i, kind in enumerate(pattern):
        attn_kind, window = "causal", 0
        if kind == "attn:local":
            attn_kind, window = "local", cfg.swa_window
        elif kind in ("attn:global", "shared_attn", "dec") and swa_override:
            attn_kind, window = "local", swa_override
        if bidir and kind.startswith("attn"):
            attn_kind, window = "bidir", 0
        if kind == "dec" and enc_out is None:
            raise ValueError("dec block needs enc_out")
        bp = shared["shared_attn"] if kind == "shared_attn" else up[f"b{i}"]
        x, _, aux_i = block_apply(
            bp, x, cfg=cfg, kind=kind, positions=positions,
            attn_kind=attn_kind, window=window,
            cache=None if caches is None else caches[f"b{i}"], pos=pos,
            enc_out=enc_out)
        if aux_i is not None:
            aux = aux + aux_i
    return x, aux


def stack_apply(params, x, *, cfg, pattern=None, positions=None,
                caches=None, pos=None, enc_out=None, swa_override=None,
                bidir: bool = False):
    """Apply all super-blocks.  Returns (x, caches, aux); the caches are
    updated in place, ``aux`` is the blocks' auxiliary losses summed
    from an f32 zero on x's device.  ``swa_override``: when set, every
    ``attn:global``, ``shared_attn`` and ``dec`` block runs as
    sliding-window attention with this window (the long-context
    variant).  ``bidir``: bidirectional self-attention in every block
    whose kind starts with ``attn`` (the whisper encoder), applied after
    ``swa_override``.  ``enc_out``: the encoder's output, which every
    ``dec`` block needs.  ``pattern``: as in :func:`stack_init`.

    With ``cfg.remat`` each unit runs under non-reentrant
    ``torch.utils.checkpoint`` while autograd records and no cache is
    given, as the reference wraps its super-block in ``jax.checkpoint``:
    autograd keeps each unit's input and recomputes the unit's forward
    in the backward.  Non-reentrant, because the split programs take
    ``torch.autograd.grad`` on chosen leaves; never with caches, which
    are written in place and would be written again by the recompute."""
    pattern = pattern if pattern is not None else cfg.block_pattern
    units, shared = params["units"], params["shared"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = functools.partial(
        _unit_apply, shared=shared, cfg=cfg, pattern=pattern,
        positions=positions, pos=pos, enc_out=enc_out,
        swa_override=swa_override, bidir=bidir)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for u in range(_n_units(units)):
        up = unit(units, u)
        if remat:
            # the units draw no random numbers: no RNG state to restore
            x, aux = checkpoint(run, x, aux, up, caches=None,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = run(x, aux, up,
                         caches=None if caches is None else unit(caches, u))
    return x, caches, aux


def _n_units(units) -> int:
    leaves = tree_leaves(units)
    return leaves[0].shape[0] if leaves else 0
