"""Wrappers for the int8 cut quantizer: the CUDA kernel
(``repro_torch/csrc/quantize.cu``) for a tensor on the card, laid out by
``plan.quantize_plan``, the plain version (``ref.py``) for a tensor on
the CPU.  Both take f32 or bf16 rows; bf16 is upcast exactly, in the
kernel's registers or by the plain version's ``x.to(torch.float32)``.

A CUDA tensor launches the kernel or raises; nothing falls back.  Each
wrapper counts the launches it makes (``launch_counts``), so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.quantize import plan, ref

_count_lock = threading.Lock()
#: kernel launches per wrapper since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {"quantize_pack_int8": 0,
                                 "quantize_int8": 0}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared (pointers
    and the stream as ``c_void_p``, or ctypes would cut them to 32
    bits)."""
    global _lib
    if _lib is None:
        lib = build.load("quantize")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.quantize_pack_int8_launch.argtypes = [vp, vp] + [i] * 8 + [vp]
        lib.quantize_pack_int8_launch.restype = i
        lib.quantize_int8_launch.argtypes = [vp, vp, vp] + [i] * 8 + [vp]
        lib.quantize_int8_launch.restype = i
        lib.quantize_noop_launch.argtypes = [i, i, i, vp]
        lib.quantize_noop_launch.restype = i
        _lib = lib
    return _lib


DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"quantize kernel needs a CUDA or CPU tensor, "
                         f"got device {x.device}")
    if x.dtype not in DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"quantize kernel takes a contiguous 2-D float32 or bfloat16 "
            f"tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    if x.shape[1] < 1 or x.shape[0] >= 2 ** 31 or x.shape[1] >= 2 ** 31 - 4:
        raise ValueError(f"unsupported quantize shape {tuple(x.shape)}")


def plan_of(x: torch.Tensor) -> plan.Plan:
    """The row plan the kernel runs for CUDA rows ``x`` (T >= 1)."""
    T, K = x.shape
    return plan.quantize_plan(T, K, x.dtype, sm_count(x.device),
                              aligned=x.data_ptr() % plan.VECTOR_BYTES == 0)


def _plan_args(x: torch.Tensor):
    """The kernel's dtype flag and plan arguments, after the stream."""
    p = plan_of(x)
    return (int(x.dtype == torch.bfloat16), int(p.vector), p.tpr, p.rpb,
            p.vpt, int(p.wide))


def _raise_if(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def quantize_pack_int8(x: torch.Tensor) -> torch.Tensor:
    """x: (T, K) f32 or bf16.  Returns the uint8 (T, K+4) wire frame:
    int8 values, then the little-endian bytes of the f32 row scale."""
    if x.device.type == "cpu":
        return ref.quantize_pack_int8_ref(x)
    _check(x)
    T, K = x.shape
    out = torch.empty((T, K + 4), dtype=torch.uint8, device=x.device)
    if T == 0:
        return out                        # nothing to launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_if(_library().quantize_pack_int8_launch(
        x.data_ptr(), out.data_ptr(), T, K, *_plan_args(x), stream),
        "quantize_pack_int8")
    _count("quantize_pack_int8")
    return out


def quantize_int8(x: torch.Tensor):
    """x: (T, K) f32 or bf16.  Returns (values int8 (T, K), scales f32
    (T, 1))."""
    if x.device.type == "cpu":
        return ref.quantize_int8_ref(x)
    _check(x)
    T, K = x.shape
    q = torch.empty((T, K), dtype=torch.int8, device=x.device)
    s = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    if T == 0:
        return q, s                       # nothing to launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_if(_library().quantize_int8_launch(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), T, K, *_plan_args(x),
        stream), "quantize_int8")
    _count("quantize_int8")
    return q, s


def launch_floor(x: torch.Tensor) -> None:
    """Launch an empty kernel on the grid and block that the quantize
    kernel would run for CUDA rows ``x``, the way the wrappers launch:
    the floor that a quantize time is read against.  Not counted."""
    _check(x)
    p = plan_of(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_if(_library().quantize_noop_launch(
        p.blocks(x.shape[0]), p.tpr, p.rpb, stream), "quantize_noop")
