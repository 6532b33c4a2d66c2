"""Wrapper of the fused cut layer: for tensors on the card, the CUDA
kernel (``repro_torch/csrc/cut_fusion.cu``) on the route
``plan.choose_route`` picks before the launch — ``fma`` (CUDA-core f32
FMAs, every f32 call) or ``tc`` (wgmma and TMA, bf16) — and for tensors
on the CPU the plain version (``ref.py``).

A CUDA tensor launches its route's kernel or raises; nothing falls back
to another route or to the plain version.  The wrapper counts its
launches (``launch_counts``): ``cut_fusion`` once per call and
``cut_fusion.<route>`` for the route it took, so a run can show which
kernel its path went through.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.cut_fusion import plan, ref

_count_lock = threading.Lock()
#: kernel launches since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {
    "cut_fusion": 0, **{f"cut_fusion.{r}": 0 for r in plan.ROUTES}}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CODES = {c: i for i, c in enumerate(ref.COMBINES)}   # the kernel's enum


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (pointers
    and the stream as ``c_void_p``, or ctypes would cut them to 32
    bits)."""
    global _lib
    if _lib is None:
        lib = build.load("cut_fusion")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cut_fusion_launch.argtypes = [vp, vp, vp] + [i] * 11 + [vp]
        lib.cut_fusion_launch.restype = i
        _lib = lib
    return _lib


def _check(z: torch.Tensor, w: torch.Tensor, combine: str) -> None:
    if not (z.is_cuda and w.is_cuda and z.device == w.device):
        raise ValueError(f"cut_fusion needs z and w on one CUDA device, "
                         f"got {z.device} and {w.device}")
    if z.dtype not in DTYPES or w.dtype != z.dtype:
        raise ValueError(f"cut_fusion takes float32 or bfloat16 z and w of "
                         f"one dtype, got {z.dtype} and {w.dtype}")
    if z.dim() != 3 or w.dim() != 3 or w.shape[1] != z.shape[2]:
        raise ValueError(f"cut_fusion takes z (P, T, k) and w (P, k, d), "
                         f"got {tuple(z.shape)} and {tuple(w.shape)}")
    P, Pw = z.shape[0], w.shape[0]
    if P < 1 or Pw < 1 or (combine == "concat" and Pw != P):
        raise ValueError(f"cut_fusion({combine}) needs z's {P} owners and "
                         f"as many block rows of w, got {Pw}")
    if not (z.is_contiguous() and w.is_contiguous()):
        raise ValueError("cut_fusion takes contiguous z and w")
    if max(z.numel(), w.numel(), z.shape[1] * w.shape[2]) >= 2 ** 31:
        raise ValueError(f"unsupported cut_fusion shape {tuple(z.shape)} x "
                         f"{tuple(w.shape)}")




def _aligned16(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def route_of(z: torch.Tensor, w: torch.Tensor, combine: str = "concat"):
    """The route ``cut_fusion`` takes for CUDA tensors z and w."""
    P, _, K = z.shape
    return plan.choose_route(z.dtype, P, K, w.shape[2], combine,
                             tma_aligned=_aligned16(z, w))


def cut_fusion(z: torch.Tensor, w: torch.Tensor,
               combine: str = "concat") -> torch.Tensor:
    """z: (P, T, k) stacked owner cut activations; w: (P, k, d) block
    rows of the trunk's input projection (sum and mean read ``w[0]``, so
    ``w`` may be (1, k, d) for them).  Returns ``combine(z) @ W`` (T, d)
    in z's dtype, accumulated in f32, without building the combine."""
    if combine not in CODES:
        raise ValueError(f"cut_fusion combines {ref.COMBINES}, got "
                         f"{combine!r} (the TPU kernel has no max)")
    if z.device.type == "cpu" and w.device.type == "cpu":
        return ref.cut_fusion_ref(z, w, combine=combine)
    _check(z, w, combine)
    return _run(route_of(z, w, combine), z, w, combine)


def _launch(route: str, z: torch.Tensor, w: torch.Tensor,
            combine: str = "concat") -> torch.Tensor:
    """Check CUDA tensors, launch ``route``'s kernel and count it.  The
    card tests call it to run the fma route on bf16 calls that the tc
    route takes; ``cut_fusion`` picks the route itself."""
    _check(z, w, combine)
    return _run(route, z, w, combine)


def _run(route, z, w, combine):
    P, T, K = z.shape
    D = w.shape[2]
    out = torch.empty((T, D), dtype=z.dtype, device=z.device)
    if T == 0 or D == 0:
        return out                        # nothing to launch
    if route == "tc":
        if route_of(z, w, combine) != "tc":
            raise ValueError(f"the tc route takes bf16 with k and d "
                             f"multiples of 8 and 16-byte aligned tensors, "
                             f"got {z.dtype}, k {K}, d {D}")
        tile, stages, vec = 0, plan.tc_stages(P, combine), 0
    elif route == "fma":
        name, stages = plan.fma_plan(T, K, D, P, combine,
                                     sm_count(z.device))
        tile = plan.TILE_CODES[name]
        vec = int(z.dtype == torch.float32 and K % 4 == 0 and D % 4 == 0
                  and _aligned16(z, w))
    else:
        raise ValueError(f"unknown cut_fusion route {route!r}")
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _library().cut_fusion_launch(
        z.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPES[z.dtype], P,
        w.shape[0], T, K, D, CODES[combine], plan.ROUTES.index(route), tile,
        stages, vec, stream)
    if err:
        raise RuntimeError(f"cut_fusion {route} launch failed: "
                           + ("tensor map not encoded" if err == -1
                              else f"cudaError {err}"))
    with _count_lock:
        launch_counts["cut_fusion"] += 1
        launch_counts[f"cut_fusion.{route}"] += 1
    return out
