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


def work(B: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
         elt: int, with_init: bool):
    """A call's (FLOPs, bytes): x, y, B and C in the inputs' dtype (``elt``
    bytes), dt, A and the states in f32, each moved once; the causal
    work of each chunk (scores and M·x over its live (i, j <= i) pairs,
    the inter-chunk term and the state update), as ``chip_smoke.py``'s
    ``scan_bound`` counts them."""
    L = min(chunk, S)
    nbytes = (elt * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * B * S * H
              + 4 * H + 4 * B * H * N * P * (2 if with_init else 1))
    flops = 0
    for c0 in range(0, S, L):
        live = min(L, S - c0)
        flops += 2 * (live * (live + 1) // 2) * (N + P) + 4 * live * N * P
    return flops * B * H, nbytes
