"""Carry parameters between the JAX reference and the port.

Both packages keep one layout per model.  The MLP SplitNN:
``{"heads": [layer, ...], "trunk": [layer, ...]}`` with ``layer = {"w":
(in, out), "b": (out,)}``, the head leaves stacked over owners.  The
split LM (``SplitModel``): ``{"heads": {"blocks": {"units": ...,
"shared": ...}, "embed": ...}, "trunk": {"blocks": ..., "out_norm": ...,
"lm_head": ...}}``, unit leaves stacked on a leading dim (after the
owner dim in the heads).  ``shared`` is ``{}`` for llama and
``{"shared_attn": block}`` for zamba2, whose units hold ``{}`` in the
shared block's slot (``b5``) and ``{"norm1", "mamba"}`` in the others;
in the heads the shared block is stacked over owners too.  The
vision-text model (qwen2-vl) adds ``front_proj`` beside ``embed`` in
every head (both owners hold both).  The encoder-decoder (whisper):
``{"heads": {"blocks", "front_proj"}, "trunk": {"blocks", "embed",
"out_norm", "lm_head"}}``, the head's units ``{"b0": attention block}``
(the encoder), the trunk's ``{"b0": dec block}`` with ``norm_x`` and
``xattn`` beside the self-attention's ``attn``.  The reference's params
cross as numpy leaves (``jax.tree.map(np.asarray,
params)``), leaf for leaf, empty dicts and zero-length unit stacks
included, so both packages start from identical weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def from_reference(tree):
    """A tree of numpy (or array-like) leaves -> f32 CPU tensors (copies;
    ``VerticalSession.build(..., params=...)`` moves them to its
    device)."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, copy=True)), tree)


def to_numpy(params):
    """The port's params -> a tree of numpy leaves in the same layout."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
