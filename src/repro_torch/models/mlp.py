"""MLP variants: SwiGLU / GeGLU (gated), GeLU, squared-ReLU (the port's
counterpart of ``repro.models.mlp``)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import layers


def mlp_init(gen, d: int, d_ff: int, kind: str):
    p = {"w_in": layers.dense_init(gen, d, d_ff),
         "w_out": layers.dense_init(gen, d_ff, d)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = layers.dense_init(gen, d, d_ff)
    return p


def mlp_apply(params, x, kind: str):
    h = layers.dense_apply(params["w_in"], x)
    if kind == "swiglu":
        h = F.silu(layers.dense_apply(params["w_gate"], x)) * h
    elif kind == "geglu":
        h = F.gelu(layers.dense_apply(params["w_gate"], x),
                   approximate="tanh") * h
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "relu2":
        r = F.relu(h)
        h = r * r
    else:
        raise ValueError(kind)
    return layers.dense_apply(params["w_out"], h)
