"""Device selection for every entry point of the port.

``resolve_device(None)`` means the CUDA card: with no card visible it
raises instead of quietly running on the CPU.  The CPU runs only when a
caller asks for it (``device="cpu"``), as the CPU tests do.

On the card the reference's f32 numerics are kept: no TF32 in matrix
products or convolutions, and deterministic algorithms, so the split
and joint training paths stay bitwise equal (cuBLAS needs
``CUBLAS_WORKSPACE_CONFIG`` for that, set before its first call).
"""
from __future__ import annotations

import functools
import os

import torch


def configure_cuda() -> None:
    """f32 reference numerics and deterministic kernels on the card."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # deterministic mode would also NaN-fill every torch.empty (one more
    # kernel per kernel output); the port's kernels write every byte
    torch.utils.deterministic.fill_uninitialized_memory = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); anything
    else is taken as the caller's explicit choice."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU explicitly")
        configure_cuda()
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (the kernels' tile and split
    plans size their grids by it)."""
    return _sm_count_of(device.index if device.index is not None
                        else torch.cuda.current_device())
