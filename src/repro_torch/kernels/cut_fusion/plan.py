"""How the cut-fusion wrapper cuts its work: the route a call takes, and
for the CUDA-core route the output tile and the depth of its cp.async
ring.  Pure functions of dtype, shapes, alignment and the SM count, so
the CPU tests cover them.

Routes (``ops.py`` launches one per call, decided before the launch):

* ``tc`` (tensor cores: wgmma with TMA tiles): bf16 z and w that TMA can
  read (k and d multiples of 8, 16-byte aligned pointers), and, for sum
  and mean, few enough owners that two ring stages of all owners' tiles
  fit in shared memory.  The route never depends on T, so a row's bits
  do not either.
* ``fma`` (f32 FMAs on the CUDA cores): everything else — every f32
  call (the training path; the 2e-4 tolerance rules out TF32 and bf16
  operands) and the bf16 calls TMA cannot read.

Every output of the ``fma`` route is one f32 accumulator fed by FMAs in
(owner, then k) order, whatever the tile: no split-K and no atomics, so
an output row's bits do not depend on T, on the tile plan or on the
call — what keeps split == joint and microbatched == oracle bitwise.
"""
from __future__ import annotations

from typing import Tuple

import torch

ROUTES = ("fma", "tc")
#: fma output tiles: name -> (rows BM, columns BN, rows and columns per
#: thread TM, TN, contraction depth per ring stage BK); largest first
TILES = {
    "128x128": (128, 128, 8, 8, 16),
    "64x64": (64, 64, 4, 4, 32),
    "32x32": (32, 32, 2, 2, 32),
    "16x32": (16, 32, 2, 2, 32),
}
TILE_CODES = {name: i for i, name in enumerate(TILES)}   # the kernel's enum
MAX_STAGES = 4
SMEM_BYTES = 232448 - 2048          # a block's dynamic shared memory, less slack
TC_BM, TC_BN, TC_BK = 128, 128, 64  # tc tile: rows, columns, k box
TC_MIN_STAGES = 2


def n_blocks(T: int, D: int, tile: str) -> int:
    BM, BN = TILES[tile][:2]
    return -(-T // BM) * -(-D // BN)


def fma_stage_bytes(tile: str, P: int, combine: str) -> int:
    """One ring stage: the z tile of one owner (concat) or of every owner
    (sum, mean: added in shared memory), rows padded by 4 floats, and the
    w tile, all f32."""
    BM, BN, _, _, BK = TILES[tile]
    nz = 1 if combine == "concat" else P
    return 4 * (nz * BM * (BK + 4) + BK * BN)


def fma_plan(T: int, K: int, D: int, P: int, combine: str,
             n_sm: int = 132) -> Tuple[str, int]:
    """``(tile, stages)`` of the fma route: the largest tile that gives
    every SM a block, else the one with the most blocks; the ring as deep
    as the chunks of (owner, k) it walks, up to ``MAX_STAGES``, or as
    shared memory allows.  Raises if not one stage fits (sum or mean over
    hundreds of owners)."""
    names = list(TILES)
    first = next((n for n in names if n_blocks(T, D, n) >= n_sm),
                 names[-1])
    for name in names[names.index(first):]:
        BK = TILES[name][4]
        chunks = (P if combine == "concat" else 1) * max(1, -(-K // BK))
        fit = SMEM_BYTES // fma_stage_bytes(name, P, combine)
        if fit >= 1:
            return name, min(MAX_STAGES, chunks, fit)
    raise ValueError(f"cut_fusion({combine}) over {P} owners does not fit "
                     f"one ring stage in shared memory")


def tc_stage_bytes(P: int, combine: str) -> int:
    """One tc ring stage: the bf16 z box (128 rows x 64 k) of one owner or
    of every owner (sum, mean), and the w box (64 k x 128 columns)."""
    nz = 1 if combine == "concat" else P
    return 2 * (nz * TC_BM * TC_BK + TC_BK * TC_BN)


def tc_stages(P: int, combine: str) -> int:
    return min(MAX_STAGES, SMEM_BYTES // tc_stage_bytes(P, combine))


def choose_route(dtype, P: int, K: int, D: int, combine: str,
                 tma_aligned: bool = True) -> str:
    """The route of a call with z (P, T, K) and w (., K, D); T plays no
    part."""
    if (dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and D % 8 == 0
            and tma_aligned and tc_stages(P, combine) >= TC_MIN_STAGES):
        return "tc"
    return "fma"
