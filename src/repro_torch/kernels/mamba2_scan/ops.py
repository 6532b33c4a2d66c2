"""Wrapper of the SSD scan kernel: the CUDA kernel
(``repro_torch/csrc/mamba2_scan.cu``) for tensors on the card, the plain
version (``ref.py``) for tensors on the CPU.

The model layout is taken as it is (the reference's Pallas wrapper
transposes to (B, H, S, P) first): x (B, S, H, P), B_in and C_in
(B, S, G, N) are read through their strides, so slices of one
``conv_out`` buffer need no copy.  A CUDA tensor launches the kernel or
raises; nothing falls back.  The wrapper counts its launches
(``launch_counts``), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba2_scan import ref

_count_lock = threading.Lock()
#: kernel launches since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {"mamba2_scan": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64          # the kernel's tile width: N and P up to 64
MAX_CHUNK = 8192      # the chunk's prefix sums live in shared memory


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
        lib = build.load("mamba2_scan")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mamba2_scan_launch.argtypes = (
            [vp] * 8 + [i] * 8 + [ll] * 12 + [vp])
        lib.mamba2_scan_launch.restype = i
        _lib = lib
    return _lib


def _check(x, dt, A, B_in, C_in, initial_state):
    ts = (x, dt, A, B_in, C_in) + (() if initial_state is None
                                   else (initial_state,))
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"mamba2_scan needs every input on one CUDA device "
                         f"or all on the CPU, got "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in DTYPES or B_in.dtype != x.dtype or \
            C_in.dtype != x.dtype:
        raise ValueError(f"mamba2_scan takes float32 or bfloat16 x, B, C of "
                         f"one dtype, got {x.dtype}, {B_in.dtype}, "
                         f"{C_in.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"mamba2_scan takes float32 dt and A, got "
                         f"{dt.dtype}, {A.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_in.dim() != 4 \
            or C_in.shape != B_in.shape:
        raise ValueError(
            f"mamba2_scan takes x (B, S, H, P), dt (B, S, H), A (H,), "
            f"B_in, C_in (B, S, G, N), got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B_in.shape)}, "
            f"{tuple(C_in.shape)}")
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) or \
            tuple(B_in.shape[:2]) != (Bb, S) or H % G:
        raise ValueError(f"mismatched mamba2_scan shapes x {tuple(x.shape)}"
                         f", dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B_in {tuple(B_in.shape)}")
    if not (1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM):
        raise ValueError(f"mamba2_scan takes d_state and head dims up to "
                         f"{MAX_DIM}, got N={N}, P={P}")
    if x.stride(-1) != 1 or B_in.stride(-1) != 1 or C_in.stride(-1) != 1:
        raise ValueError("mamba2_scan needs the last dim of x, B_in, C_in "
                         "contiguous")
    if not A.is_contiguous():
        raise ValueError("mamba2_scan needs A contiguous")
    if initial_state is not None and (
            initial_state.dtype != torch.float32
            or tuple(initial_state.shape) != (Bb, H, N, P)
            or not initial_state.is_contiguous()):
        raise ValueError(f"mamba2_scan takes a contiguous float32 "
                         f"initial_state of shape {(Bb, H, N, P)}, got "
                         f"{initial_state.dtype} "
                         f"{tuple(initial_state.shape)}")
    if Bb * H >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"unsupported mamba2_scan shape {tuple(x.shape)}")


def mamba2_scan(x, dt, A, B_in, C_in, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan in the model layout: x (B, S, H, P), dt (B, S, H)
    f32 (positive), A (H,) f32 (negative rates), B_in/C_in (B, S, G, N)
    in x's dtype, ``initial_state`` (B, H, N, P) f32 or None (zeros).
    Head h reads group h // (H / G).  The chunk length is
    ``min(chunk, S)``, as in the reference.

    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, N, P)
    f32)."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B_in, C_in, chunk,
                               initial_state=initial_state)
    _check(x, dt, A, B_in, C_in, initial_state)
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    L = min(int(chunk), S)
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"mamba2_scan takes chunks of 1 to {MAX_CHUNK}, "
                         f"got {chunk}")
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().mamba2_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
        C_in.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), state.data_ptr(),
        DTYPES[x.dtype], Bb, S, H, P, G, N, L,
        *x.stride()[:3], *dt.stride(), *B_in.stride()[:3],
        *C_in.stride()[:3], stream)
    if err:
        raise RuntimeError(f"mamba2_scan launch failed: cudaError {err}")
    with _count_lock:
        launch_counts["mamba2_scan"] += 1
    return y, state
