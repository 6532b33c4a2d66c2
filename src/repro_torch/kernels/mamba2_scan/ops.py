"""Wrapper of the SSD scan kernels: for tensors on the card, one of two
hand-written CUDA routes chosen by ``plan.choose_route`` before the
launch — ``chunked`` (``repro_torch/csrc/mamba2_scan_chunked.cu``, three
launches over chunks in parallel, on the tensor cores) or ``serial``
(``repro_torch/csrc/mamba2_scan.cu``); the plain version (``ref.py``) for
tensors on the CPU.

The model layout is taken as it is (the reference's Pallas wrapper
transposes to (B, H, S, P) first): x (B, S, H, P), B_in and C_in
(B, S, G, N) are read through their strides, so slices of one
``conv_out`` buffer need no copy.  A CUDA tensor launches the kernel or
raises; nothing falls back to another route or to the plain version.
The wrapper counts its calls (``launch_counts``): ``mamba2_scan`` once
per call and ``mamba2_scan.<route>`` for the route it took, so a run can
show which kernels its path went through.  Fake or ``meta`` tensors
launch nothing: they describe the card's launch to the dry-run's trace
(``kernels/fake.py``), uncounted here.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, fake
from repro_torch.kernels.mamba2_scan import plan, ref

_count_lock = threading.Lock()
#: held across each call into a launcher: a launcher sets its kernels'
#: dynamic shared memory limit from the chunk length, then launches, and
#: the limit is one per kernel in the process, so two threads (the
#: owners' heads and the trunk of a split fit, at chunks of 128 and 256)
#: must not interleave those two steps
_launch_lock = threading.Lock()
#: kernel launches since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {
    "mamba2_scan": 0, **{f"mamba2_scan.{r}": 0 for r in plan.ROUTES}}
SOURCES = {"serial": "mamba2_scan", "chunked": "mamba2_scan_chunked"}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64          # the kernel's tile width: N and P up to 64
MAX_CHUNK = 8192      # the chunk's prefix sums live in shared memory


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


_libs: Dict[str, ctypes.CDLL] = {}


def _library(route: str) -> ctypes.CDLL:
    """The built library of ``route`` with its C signature declared
    (pointers and the stream as ``c_void_p``, strides as 64-bit ints)."""
    if route not in _libs:
        name = SOURCES[route]
        lib = build.load(name)
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, f"{name}_launch")
        if route == "serial":
            fn.argtypes = [vp] * 8 + [i] * 8 + [ll] * 12 + [vp]
        else:
            fn.argtypes = [vp] * 11 + [i] * 7 + [ll] * 12 + [i, vp]
        fn.restype = i
        _libs[route] = lib
    return _libs[route]


def _aligned16(*ts) -> bool:
    """Base pointers and the strides of all but the last dim on 16-byte
    boundaries (cp.async's rule)."""
    return all(t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:-1])
        for t in ts)


def route_of(x, B_in, C_in, initial_state=None) -> str:
    """The route ``mamba2_scan`` takes for CUDA tensors."""
    Bb, _, H, P = x.shape
    extra = () if initial_state is None else (initial_state,)
    return plan.choose_route(x.dtype, B_in.shape[3], P, Bb * H,
                             aligned=_aligned16(x, B_in, C_in, *extra))


def _check(x, dt, A, B_in, C_in, initial_state):
    ts = (x, dt, A, B_in, C_in) + (() if initial_state is None
                                   else (initial_state,))
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"mamba2_scan needs every input on one CUDA device "
                         f"or all on the CPU, got "
                         f"{[str(t.device) for t in ts]}")
    _check_args(x, dt, A, B_in, C_in, initial_state)


def _check_args(x, dt, A, B_in, C_in, initial_state):
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
    extra = () if initial_state is None else (initial_state,)
    if fake.described(x, dt, A, B_in, C_in, *extra):
        return _describe(x, dt, A, B_in, C_in, chunk, initial_state)
    _check(x, dt, A, B_in, C_in, initial_state)
    return _run(route_of(x, B_in, C_in, initial_state), x, dt, A, B_in,
                C_in, chunk, initial_state)


def _launch(route, x, dt, A, B_in, C_in, *, chunk: int, initial_state=None):
    """Check CUDA tensors, launch ``route``'s kernels and count the call.
    ``chip_smoke.py`` and the card tests call it to run both routes on
    one input; ``mamba2_scan`` picks the route itself."""
    _check(x, dt, A, B_in, C_in, initial_state)
    return _run(route, x, dt, A, B_in, C_in, chunk, initial_state)


def _describe(x, dt, A, B_in, C_in, chunk, initial_state):
    """The launch on described tensors (``kernels/fake.py``): the route
    the card takes, its outputs and the chunked route's scratch
    allocated, its work reported to the open tally; nothing launched."""
    _check_args(x, dt, A, B_in, C_in, initial_state)
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    L = _chunk_len(chunk, S)
    extra = () if initial_state is None else (initial_state,)
    route = plan.choose_route(x.dtype, N, P, Bb * H,
                              aligned=fake.aligned16(x, B_in, C_in, *extra,
                                                     dims=-1))
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    if route == "chunked":
        _chunked_scratch(Bb, H, -(-S // L), N, P, x.device)
    flops, nbytes = plan.work(Bb, S, H, P, G, N, L, x.element_size(),
                              initial_state is not None)
    fake.record(f"mamba2_scan.{route}", flops, nbytes)
    return y, state


def _chunk_len(chunk, S):
    L = min(int(chunk), S)
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"mamba2_scan takes chunks of 1 to {MAX_CHUNK}, "
                         f"got {chunk}")
    return L


def _run(route, x, dt, A, B_in, C_in, chunk, initial_state):
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    L = _chunk_len(chunk, S)
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    init = None if initial_state is None else initial_state.data_ptr()
    if route == "serial":
        lib = _library(route)
        with _launch_lock:
            err = lib.mamba2_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                C_in.data_ptr(), init, y.data_ptr(), state.data_ptr(),
                DTYPES[x.dtype], Bb, S, H, P, G, N, L,
                *x.stride()[:3], *dt.stride(), *B_in.stride()[:3],
                *C_in.stride()[:3], torch.cuda.current_stream(
                    x.device).cuda_stream)
    elif route == "chunked":
        if route_of(x, B_in, C_in, initial_state) != "chunked":
            raise ValueError(
                f"the chunked route takes bf16 with N and P multiples of "
                f"16 up to {plan.CHUNKED_MAX_DIM} and 16-byte aligned "
                f"tensors, got {x.dtype}, N {N}, P {P}")
        scratch = _chunked_scratch(Bb, H, -(-S // L), N, P, x.device)
        err = _chunked(3, x, dt, A, B_in, C_in, initial_state, y, *scratch,
                       state, L)
    else:
        raise ValueError(f"unknown scan route {route!r}")
    if err:
        raise RuntimeError(f"mamba2_scan {route} launch failed: "
                           f"cudaError {err}")
    with _count_lock:
        launch_counts["mamba2_scan"] += 1
        launch_counts[f"mamba2_scan.{route}"] += 1
    return y, state


def _chunked_scratch(Bb, H, nc, N, P, device):
    """f32 chunk states (Bb, H, nc, N, P), the incoming states as bf16 hi
    and lo planes (Bb, H, nc, 2, N, P), and f32 totals (Bb, H, nc)."""
    return (torch.empty((Bb, H, nc, N, P), dtype=torch.float32,
                        device=device),
            torch.empty((Bb, H, nc, 2, N, P), dtype=torch.bfloat16,
                        device=device),
            torch.empty((Bb, H, nc), dtype=torch.float32, device=device))


def split_hi_lo(s: torch.Tensor) -> torch.Tensor:
    """f32 states (..., N, P) as the chunked route's bf16 hi and lo planes
    (..., 2, N, P): hi = bf16(s), lo = bf16(s - hi), both rounded to
    nearest even, as the state-passing kernel writes them."""
    hi = s.to(torch.bfloat16)
    lo = (s - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo], dim=-3).contiguous()


def _chunked(stage, x, dt, A, B_in, C_in, initial_state, y, states,
             incoming, totals, final, L):
    """Launch stage 0 (chunk states), 1 (state passing), 2 (chunk
    outputs) or 3 (all three) of the chunked route."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    lib = _library("chunked")
    with _launch_lock:
        return lib.mamba2_scan_chunked_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
            C_in.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), states.data_ptr(), incoming.data_ptr(),
            totals.data_ptr(), final.data_ptr(), Bb, S, H, P, G, N, L,
            *x.stride()[:3], *dt.stride(), *B_in.stride()[:3],
            *C_in.stride()[:3], stage,
            torch.cuda.current_stream(x.device).cuda_stream)


def chunked_stage(stage: str, x, dt, A, B_in, C_in, *, chunk: int,
                  states=None, totals=None, incoming=None,
                  initial_state=None):
    """One kernel of the chunked route on CUDA tensors, for the card
    tests to hold it against its plain stage function:

      "states":  -> (states, totals) f32           (ref.ssd_chunk_states)
      "passing": states, totals -> (incoming as hi and lo planes, the
                 final state)    (ref.ssd_state_passing; hi + lo is the
                 incoming state)
      "output":  incoming (hi and lo planes, ``split_hi_lo``) -> y
                                                   (ref.ssd_chunk_output)

    Uncounted: it is a probe, not a path."""
    _check(x, dt, A, B_in, C_in, initial_state)
    if route_of(x, B_in, C_in, initial_state) != "chunked":
        raise ValueError("chunked_stage takes what the chunked route takes")
    Bb, S, H, P = x.shape
    N = B_in.shape[3]
    L = _chunk_len(chunk, S)
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
    scratch = _chunked_scratch(Bb, H, -(-S // L), N, P, x.device)
    states = scratch[0] if states is None else states.contiguous()
    incoming = scratch[1] if incoming is None else incoming.contiguous()
    totals = scratch[2] if totals is None else totals.contiguous()
    code = {"states": 0, "passing": 1, "output": 2}[stage]
    err = _chunked(code, x, dt, A, B_in, C_in, initial_state, y, states,
                   incoming, totals, final, L)
    if err:
        raise RuntimeError(f"mamba2_scan chunked stage {stage} failed: "
                           f"cudaError {err}")
    return {"states": (states, totals), "passing": (incoming, final),
            "output": y}[stage]
