"""Wrapper of the fused cut layer: the CUDA kernel
(``repro_torch/csrc/cut_fusion.cu``) for tensors on the card, the plain
version (``ref.py``) for tensors on the CPU.

A CUDA tensor launches the kernel or raises; nothing falls back.  The
wrapper counts its launches (``launch_counts``), so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cut_fusion import ref

_count_lock = threading.Lock()
#: kernel launches since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {"cut_fusion": 0}

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
        lib.cut_fusion_launch.argtypes = [vp, vp, vp] + [i] * 6 + [vp]
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
    if max(z.shape[1], z.shape[2], w.shape[2]) >= 2 ** 31 or \
            -(-z.shape[1] // 64) > 65535:
        raise ValueError(f"unsupported cut_fusion shape {tuple(z.shape)} x "
                         f"{tuple(w.shape)}")


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
    P, T, K = z.shape
    D = w.shape[2]
    out = torch.empty((T, D), dtype=z.dtype, device=z.device)
    if T == 0 or D == 0:
        return out                        # nothing to launch
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _library().cut_fusion_launch(
        z.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPES[z.dtype], P, T,
        K, D, CODES[combine], stream)
    if err:
        raise RuntimeError(f"cut_fusion launch failed: cudaError {err}")
    with _count_lock:
        launch_counts["cut_fusion"] += 1
    return out
