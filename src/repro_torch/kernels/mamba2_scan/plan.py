"""The route an SSD scan call takes, decided from dtype, shapes and
alignment before the launch: a pure function, so the CPU tests cover it.

* ``chunked`` (``csrc/mamba2_scan_chunked.cu``): bf16 x, B, C with d_state
  N and head dim P multiples of 16 up to 64, tensors 16-byte aligned
  (pointers and strides, cp.async's rule) and at most 65535 (batch x
  head) — every prefill scan of zamba2-2.7b.  Three launches: chunk
  states, state passing, chunk outputs, on the tensor cores.
* ``serial`` (``csrc/mamba2_scan.cu``, PR 13's kernel): the rest — f32
  (the 2e-4 tolerance rules out bf16 operands), other widths, unaligned
  tensors.
"""
from __future__ import annotations

import torch

ROUTES = ("chunked", "serial")
CHUNKED_MAX_DIM = 64
MAX_GRID_Y = 65535


def choose_route(dtype, N: int, P: int, n_bh: int,
                 aligned: bool = True) -> str:
    """The route of a call with d_state N, head dim P and ``n_bh`` =
    batch x heads."""
    if (dtype == torch.bfloat16 and N % 16 == 0 and P % 16 == 0
            and 16 <= N <= CHUNKED_MAX_DIM and 16 <= P <= CHUNKED_MAX_DIM
            and n_bh <= MAX_GRID_Y and aligned):
        return "chunked"
    return "serial"
