"""Step builders: the train, prefill and decode step functions of an
(architecture x input shape x mesh), with stand-ins for their inputs
and the inputs' specs (the port's counterpart of
``repro.launch.steps``).

Each builder returns ``(fn, args, specs, donate)`` as the reference's
does: ``args`` are ``meta`` tensors (params, optimizer state, batch,
caches: nothing is allocated), ``specs`` their :class:`PartitionSpec`
trees (``None`` for a scalar) and ``donate`` the positions of the
arguments whose buffers the step replaces (the params and optimizer
state of a train step, the caches of a prefill or a decode step, which
the port writes in place).  ``materialize`` turns a stand-in tree into
tensors on a device, drawn from a generator.

A step runs on the device of its inputs, under ``sharding_context(mesh,
rules)``: a one-device mesh (``launch.mesh.make_host_mesh()``) runs it;
on an abstract (production) mesh, or one of several devices, the step
raises before it touches its inputs.  Positions and the step index are ints or 0-d
integer tensors (a tensor on the card is read back with a sync).

The reference's quirks are kept: the long_500k shape runs the
``long_context="swa"`` architectures as sliding-window attention
(``swa_for``); the microbatched train step reports ``{"loss", "aux":
0}``, its ``loss`` the mean over microbatches of the objective (ce +
aux), where one microbatch reports ``loss_fn``'s metrics (ce alone),
and accumulates its gradients in f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.splitnn import _leaf, grads_of
from repro_torch.models.model import SplitModel
from repro_torch.optim import adam, apply_updates, chain, clip_by_global_norm
from repro_torch.sharding.specs import (Mesh, ShardingRules, batch_specs,
                                        cache_specs, check_runnable,
                                        make_rules, param_specs,
                                        sharding_context)
from repro_torch.tree import tree_map

#: the most elements ``materialize`` draws at once
_DRAW_ELEMENTS = 1 << 28


def struct(shape, dtype) -> torch.Tensor:
    """An input's stand-in: a ``meta`` tensor of its shape and dtype."""
    return torch.empty(shape, dtype=dtype, device="meta")


def materialize(structs, gen: torch.Generator, device):
    """A tree of stand-ins as tensors on ``device`` (``gen``'s): floats
    N(0, 1) in their dtype, drawn in pieces of whole rows of at most
    2^28 elements (a 524288-token cache is drawn in a few pieces, not as
    one f32 tensor); integers zeros."""

    def fill(out):
        if out.numel() > _DRAW_ELEMENTS and out.dim() > 1:
            row = out.numel() // out.shape[0]
            for piece in (out if row > _DRAW_ELEMENTS else
                          out.split(_DRAW_ELEMENTS // row)):
                fill(piece)
        else:
            out.copy_(torch.randn(out.shape, generator=gen, device=device))

    def leaf(x):
        if not x.is_floating_point():
            return torch.zeros(x.shape, dtype=x.dtype, device=device)
        out = torch.empty(x.shape, dtype=x.dtype, device=device)
        fill(out)
        return out

    return tree_map(lambda x: None if x is None else leaf(x), structs)


def _int(x):
    """A position or step index given as a 0-d tensor, as an int."""
    return int(x) if isinstance(x, torch.Tensor) and x.dim() == 0 else x


def _on(mesh: Mesh, rules: ShardingRules):
    """A step's context: its sharding context, after checking that the
    step can run on ``mesh`` at all (before it touches an input)."""
    check_runnable(mesh)
    return sharding_context(mesh, rules)


def swa_for(cfg: ArchConfig, shape: ShapeConfig) -> Optional[int]:
    """The explicit sliding-window long-context variant."""
    if shape.name == "long_500k" and cfg.long_context == "swa":
        return cfg.long_context_window
    return None


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    return not (shape.name == "long_500k" and cfg.long_context == "skip")


# ---------------------------------------------------------------------------
# Input stand-ins
# ---------------------------------------------------------------------------


def batch_structs(cfg: ArchConfig, shape: ShapeConfig,
                  with_labels: bool) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    half = S // 2
    if cfg.modality == "text":
        P = cfg.split.n_owners
        b = {"owner_tokens": struct((P, B, S // P), torch.int32)}
        if with_labels:
            b["labels"] = struct((B, S), torch.int32)
    elif cfg.modality == "vision_text":
        b = {"patches": struct((B, half, cfg.d_frontend), torch.bfloat16),
             "tokens": struct((B, half), torch.int32)}
        if with_labels:
            b["labels"] = struct((B, S), torch.int32)
    elif cfg.modality == "audio_text":
        b = {"frames": struct((B, half, cfg.d_frontend), torch.bfloat16),
             "tokens": struct((B, half), torch.int32)}
        if with_labels:
            b["labels"] = struct((B, half), torch.int32)
    else:
        raise ValueError(cfg.modality)
    return b


def make_optimizer(cfg: ArchConfig, opt_state_dtype=torch.float32):
    return chain(clip_by_global_norm(1.0),
                 adam(3e-4, state_dtype=opt_state_dtype))


# ---------------------------------------------------------------------------
# Builders: each returns (fn, args, specs, donate)
# ---------------------------------------------------------------------------


def _split_micro(batch, n: int):
    """Every batch leaf as (n_micro, micro_batch, ...); the owner dim of
    ``owner_tokens`` (P, B, S_p) stays outermost within a microbatch."""
    out = {}
    for k, v in batch.items():
        if k == "owner_tokens":
            P, B, S_p = v.shape
            out[k] = v.reshape(P, n, B // n, S_p).permute(1, 0, 2, 3)
        else:
            out[k] = v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
    return out


def build_train(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                rules: ShardingRules, n_microbatches: int = 1,
                opt_state_dtype=torch.float32):
    """``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``: clip + Adam on the gradients of ``loss_fn``,
    over ``n_microbatches`` microbatches one after the other."""
    model = SplitModel(cfg)
    optimizer = make_optimizer(cfg, opt_state_dtype)
    swa = swa_for(cfg, shape)

    def loss_and_grads(params, batch):
        with torch.enable_grad():
            leaves = tree_map(_leaf, params)
            loss, metrics = model.loss_fn(leaves, batch, swa_override=swa)
            grads = grads_of(loss, leaves)
        return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads

    def train_step(params, opt_state, batch, step):
        with _on(mesh, rules):
            if n_microbatches == 1:
                _, metrics, grads = loss_and_grads(params, batch)
            else:
                # gradient accumulation, one microbatch forward and
                # backward at a time
                micro = _split_micro(batch, n_microbatches)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=batch["labels"].device)
                for i in range(n_microbatches):
                    l, _, g = loss_and_grads(
                        params, {k: v[i] for k, v in micro.items()})
                    grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                     grads, g)
                    loss = loss + l
                inv = 1.0 / n_microbatches
                grads = tree_map(lambda g: g * inv, grads)
                loss = loss * inv
                metrics = {"loss": loss, "aux": torch.zeros_like(loss)}
            updates, opt_state_n = optimizer.update(grads, opt_state,
                                                    params, _int(step))
            params_n = apply_updates(params, updates)
        return params_n, opt_state_n, metrics

    p_struct = model.param_specs()
    o_struct = optimizer.init(p_struct)
    b_struct = batch_structs(cfg, shape, with_labels=True)
    s_struct = struct((), torch.int32)

    p_spec = param_specs(p_struct, cfg, mesh, rules)
    o_spec = _opt_specs(optimizer, p_struct, cfg, mesh, rules)
    b_spec = batch_specs(b_struct, cfg, mesh, rules)

    args = (p_struct, o_struct, b_struct, s_struct)
    specs = (p_spec, o_spec, b_spec, None)
    return train_step, args, specs, (0, 1)


def _opt_specs(optimizer, p_struct, cfg, mesh: Mesh, rules: ShardingRules):
    """Optimizer-state specs: the param rules leaf by leaf (m and v
    mirror the params; the clip's empty state stays empty)."""
    return param_specs(optimizer.init(p_struct), cfg, mesh, rules)


def build_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                  rules: ShardingRules, n_new: int = 8):
    """``prefill(params, batch, caches) -> (last-token logits,
    caches)``."""
    model = SplitModel(cfg)
    swa = swa_for(cfg, shape)
    B, S = shape.global_batch, shape.seq_len

    def prefill(params, batch, caches):
        with _on(mesh, rules), torch.no_grad():
            return model.prefill(params, batch, caches, swa_override=swa)

    p_struct = model.param_specs()
    b_struct = batch_structs(cfg, shape, with_labels=False)
    c_struct = model.cache_init(B, S, n_new, device="meta")

    p_spec = param_specs(p_struct, cfg, mesh, rules)
    b_spec = batch_specs(b_struct, cfg, mesh, rules)
    c_spec = cache_specs(c_struct, cfg, mesh, rules)
    args = (p_struct, b_struct, c_struct)
    specs = (p_spec, b_spec, c_spec)
    return prefill, args, specs, (2,)


def build_decode(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                 rules: ShardingRules, n_new: int = 8,
                 ring_cache: bool = False, cache_dtype=None):
    """``serve_step(params, caches, token, pos, pos_local) -> (logits,
    caches)``: one new token against a ``seq_len``-deep cache
    (``cache_init``'s ``ring`` and ``cache_dtype``; the long_500k
    window as ``swa_override``)."""
    model = SplitModel(cfg)
    swa = swa_for(cfg, shape)
    B, S = shape.global_batch, shape.seq_len

    def serve_step(params, caches, token, pos, pos_local):
        with _on(mesh, rules), torch.no_grad():
            return model.decode_step(params, caches, token, _int(pos),
                                     _int(pos_local), swa_override=swa)

    p_struct = model.param_specs()
    c_struct = model.cache_init(B, S, n_new, device="meta", ring=ring_cache,
                                swa_override=swa or 0,
                                cache_dtype=cache_dtype)
    t_struct = struct((B, 1), torch.int32)
    s_struct = struct((), torch.int32)

    p_spec = param_specs(p_struct, cfg, mesh, rules)
    c_spec = cache_specs(c_struct, cfg, mesh, rules)
    t_spec = batch_specs({"token": t_struct}, cfg, mesh, rules)["token"]
    args = (p_struct, c_struct, t_struct, s_struct, s_struct)
    specs = (p_spec, c_spec, t_spec, None, None)
    return serve_step, args, specs, (1,)


def build(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, rules=None,
          n_microbatches: int = 1, ring_cache: bool = False,
          opt_state_dtype=torch.float32, cache_dtype=None, **kw):
    rules = rules if rules is not None else make_rules(mesh, cfg, **kw)
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules,
                           n_microbatches=n_microbatches,
                           opt_state_dtype=opt_state_dtype)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules)
    if shape.kind == "decode":
        return build_decode(cfg, shape, mesh, rules,
                            ring_cache=ring_cache, cache_dtype=cache_dtype)
    raise ValueError(shape.kind)
