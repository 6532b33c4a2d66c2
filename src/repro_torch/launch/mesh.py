"""Meshes of the port, and the peak rates of the cards it runs on.

``make_production_mesh`` gives the reference's production meshes,
(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model") with
the data owners on "pod", as abstract meshes: the spec functions read
their names and sizes, and no step runs on them.
``make_host_mesh`` builds a mesh over the devices there are: the card
(``device=None``, which raises when none is visible) or the CPU when
the caller asks for it.

``CARD_PEAKS``: each card's memory rate (bytes/s) and float32 rate
outside the tensor cores (FLOP/s), from NVIDIA's data sheets, keyed by
a part of the name ``nvidia-smi`` gives; the SXM H100 is the last,
plain "H100" key.  Roofline bounds (``chip_smoke.py``) read them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import Mesh, abstract_mesh

CARD_PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def peaks(name: str):
    """(bytes/s, f32 FLOP/s) of the card named ``name``."""
    for key, rates in CARD_PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks on record for {name!r}")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_host_mesh(*, data: int = 1, model: int = 1, pod: int = 0,
                   device=None) -> Mesh:
    """A mesh over the devices of ``device``'s type (``None``: the
    cards; the CPU counts as one device); raises when the sizes ask for
    more devices than there are."""
    dev = resolve_device(device)
    sizes, names = (data, model), ("data", "model")
    if pod:
        sizes, names = (pod,) + sizes, ("pod",) + names
    n = math.prod(sizes)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > have:
        raise ValueError(f"a mesh of {sizes} needs {n} devices; "
                         f"{have} {dev.type} device(s) are there")
    devices = (tuple(torch.device("cuda", i) for i in range(n))
               if dev.type == "cuda" else (dev,) * n)
    return Mesh(sizes, names, devices)
