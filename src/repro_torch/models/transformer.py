"""Block assembly: super-blocks stacked over units (the port's
counterpart of ``repro.models.transformer``).

An architecture is ``n_superblocks`` repetitions of ``cfg.block_pattern``
(e.g. zamba2: 5x mamba2 + 1 shared_attn).  Parameters of the units are
stacked on a leading dim, as in the reference; a Python loop over the
units takes the place of ``lax.scan``.  Zero units is a valid stack (the
reduced llama's and zamba2's heads): the stack then returns its input
unchanged.

The port builds ``attn:global``, ``attn:local`` and ``shared_attn``
blocks (attention with the dense FFN; the shared block's params live
once in ``shared`` and every unit's slot for it is ``{}``) and
``mamba2`` blocks.  The other block kinds (xLSTM, the whisper decoder)
and MoE raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import not_ported
from repro_torch.models import attention, layers, mlp as mlp_mod, ssm
from repro_torch.tree import tree_leaves, tree_map

KINDS = ("attn:global", "attn:local", "shared_attn", "mamba2")


def _check_kind(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise not_ported(f"block kind {kind!r}",
                         "item 8, the other architecture families")
    if cfg.moe is not None:
        raise not_ported("MoE FFNs", "item 8, the other architecture "
                         "families")


def _has_ffn(cfg) -> bool:
    return cfg.d_ff > 0 and cfg.mlp != "none"


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg, kind: str):
    _check_kind(cfg, kind)
    d, dev = cfg.d_model, gen.device
    p = {"norm1": layers.norm_init(d, cfg.norm, dev)}
    if kind == "mamba2":
        p["mamba"] = ssm.mamba2_init(gen, cfg)
        return p
    p["attn"] = attention.attn_init(gen, cfg)
    if _has_ffn(cfg):
        p["norm2"] = layers.norm_init(d, cfg.norm, dev)
        p["ffn"] = mlp_mod.mlp_init(gen, d, cfg.d_ff, cfg.mlp)
    if cfg.post_block_norm:
        p["post1"] = layers.norm_init(d, cfg.norm, dev)
        if _has_ffn(cfg):
            p["post2"] = layers.norm_init(d, cfg.norm, dev)
    return p


def block_cache_init(batch: int, cfg, kind: str, s_max: int,
                     dtype=torch.bfloat16, device="cpu",
                     window_slots: int = 0):
    """KV caches in ``dtype`` of ``min(s_max, window_slots)`` slots
    (``s_max`` when ``window_slots`` is 0); the Mamba2 caches in f32
    whatever ``dtype`` is."""
    _check_kind(cfg, kind)
    if kind == "mamba2":
        return ssm.mamba2_cache_init(batch, cfg, device)
    s_eff = min(s_max, window_slots) if window_slots else s_max
    return attention.init_kv_cache(batch, s_eff, cfg.n_kv_heads,
                                   cfg.head_dim, dtype, device)


def block_apply(params, x, *, cfg, kind: str, positions=None,
                attn_kind: str = "causal", window: int = 0, cache=None,
                pos=None):
    """Returns (x_out, cache)."""
    _check_kind(cfg, kind)
    h = layers.norm_apply(params["norm1"], x, cfg.norm, cfg.norm_eps)
    if kind == "mamba2":
        y, cache = ssm.mamba2_apply(params["mamba"], h, cfg, cache)
        return x + y.to(x.dtype), cache
    a, cache = attention.attn_apply(
        params["attn"], h, cfg=cfg, kind=attn_kind, positions=positions,
        window=window, cache=cache, pos=pos)
    if cfg.post_block_norm:
        a = layers.norm_apply(params["post1"], a, cfg.norm, cfg.norm_eps)
    x = x + a
    if _has_ffn(cfg):
        h = layers.norm_apply(params["norm2"], x, cfg.norm, cfg.norm_eps)
        f = mlp_mod.mlp_apply(params["ffn"], h, cfg.mlp)
        if cfg.post_block_norm:
            f = layers.norm_apply(params["post2"], f, cfg.norm, cfg.norm_eps)
        x = x + f
    return x, cache


# ---------------------------------------------------------------------------
# Stack of super-blocks
# ---------------------------------------------------------------------------


def stack_init(gen, cfg, n_units: int):
    """Returns {"units": unit-stacked params, "shared": shared params}.
    Zero units give leaves of shape (0, ...) (one unit is drawn for the
    shapes); the shared block exists whatever the number of units."""
    shared = {}
    if "shared_attn" in cfg.block_pattern:
        shared["shared_attn"] = block_init(gen, cfg, "shared_attn")
    units = [{f"b{i}": ({} if kind == "shared_attn"   # params in `shared`
                        else block_init(gen, cfg, kind))
              for i, kind in enumerate(cfg.block_pattern)}
             for _ in range(max(n_units, 1))]
    return {"units": tree_map(lambda *ls: torch.stack(ls)[:n_units], *units),
            "shared": shared}


def stack_cache_init(batch: int, cfg, n_units: int, s_max: int,
                     dtype=torch.bfloat16, device="cpu", ring: bool = False,
                     swa_override: int = 0):
    """Caches of every unit, stacked on a leading dim (n_units, ...).
    ``ring=True`` trims sliding-window layers' caches to their window
    (ring-buffer slots): ``attn:local`` to ``cfg.swa_window``, and with
    ``swa_override`` set (the long-context variant) ``attn:global`` and
    ``shared_attn`` to that window."""

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
        for i, kind in enumerate(cfg.block_pattern)}


def unit(tree, u: int):
    """Unit ``u``'s slice of a unit-stacked tree (views, no copies)."""
    return tree_map(lambda a: a[u], tree)


def stack_apply(params, x, *, cfg, positions=None, caches=None, pos=None,
                swa_override=None):
    """Apply all super-blocks.  Returns (x, caches); the caches are
    updated in place.  ``swa_override``: when set, every ``attn:global``
    and ``shared_attn`` block runs as sliding-window attention with this
    window (the long-context variant)."""
    units, shared = params["units"], params["shared"]
    n_units = _n_units(units)
    for u in range(n_units):
        up = unit(units, u)
        uc = None if caches is None else unit(caches, u)
        for i, kind in enumerate(cfg.block_pattern):
            attn_kind, window = "causal", 0
            if kind == "attn:local":
                attn_kind, window = "local", cfg.swa_window
            elif kind in ("attn:global", "shared_attn") and swa_override:
                attn_kind, window = "local", swa_override
            bp = (shared["shared_attn"] if kind == "shared_attn"
                  else up[f"b{i}"])
            x, _ = block_apply(
                bp, x, cfg=cfg, kind=kind, positions=positions,
                attn_kind=attn_kind, window=window,
                cache=None if uc is None else uc[f"b{i}"], pos=pos)
    return x, caches


def _n_units(units) -> int:
    leaves = tree_leaves(units)
    return leaves[0].shape[0] if leaves else 0
