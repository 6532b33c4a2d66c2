"""Wrapper of the attention kernel: the CUDA kernel
(``repro_torch/csrc/block_attention.cu``) for tensors on the card, the
plain version (``ref.py``) for tensors on the CPU.

A CUDA tensor launches the kernel or raises; nothing falls back.  The
wrapper counts its launches (``launch_counts``), so a run can show that
its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_attention import ref

_count_lock = threading.Lock()
#: kernel launches since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {"block_attention": 0}

KINDS = {"causal": 0, "local": 1, "bidir": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (pointers
    and the stream as ``c_void_p``, strides as 64-bit ints)."""
    global _lib
    if _lib is None:
        lib = build.load("block_attention")
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
        lib.block_attention_launch.argtypes = (
            [vp] * 4 + [i] * 6 + [ll] * 9 + [i] * 4 + [f, f, vp])
        lib.block_attention_launch.restype = i
        _lib = lib
    return _lib


def _check(q, k, v, kind):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"block_attention needs q, k, v all on one CUDA "
                         f"device or all on the CPU, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"block_attention takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"block_attention takes q (B, Sq, nh, hd) and "
                         f"k, v (B, Skv, nkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, nh, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or nh % k.shape[2]:
        raise ValueError(f"mismatched q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"block_attention takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("block_attention needs the head dim contiguous")
    if B * nh > 65535 or max(Sq, k.shape[1]) >= 2 ** 31:
        raise ValueError(f"unsupported block_attention shape "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if kind not in KINDS:
        raise ValueError(kind)


def block_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    scale: Optional[float] = None):
    """GQA flash attention.  q: (B, Sq, nh, hd); k, v: (B, Skv, nkv, hd)
    -> (B, Sq, nh, hd) in q's dtype.  Query row i sits at position
    ``q_offset + i``; keys at positions >= ``kv_len`` are masked."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, kind=kind, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 kv_len=kv_len, scale=scale)
    _check(q, k, v, kind)
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    kv_lim = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().block_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Sq, nh, nkv, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        KINDS[kind], int(window), kv_lim, int(q_offset), float(softcap),
        float(scale), stream)
    if err:
        raise RuntimeError(f"block_attention launch failed: cudaError {err}")
    with _count_lock:
        launch_counts["block_attention"] += 1
    return out
