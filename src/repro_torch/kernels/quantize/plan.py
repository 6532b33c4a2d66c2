"""How the int8 quantizer's wrapper lays a call's rows onto the card: the
threads of a row, the loads each thread holds in registers and the rows
of a block.  A pure function of T, K, dtype, alignment and the SM
count, so the CPU tests cover it.

A row of K values is cut into ``nvec`` loads: 16-byte vectors (4 f32 or
8 bf16) where every row starts 16-byte aligned (K % 4 == 0 for f32,
K % 8 == 0 for bf16, and an aligned base pointer), else one element per
load.  Thread ``t`` of a row takes loads ``t, t + tpr, ...`` — at most
``vpt`` of them, held in registers, so x is read once: the row's
absmax, its scale and its codes all come from those registers.  A row
longer than ``1024 * MAX_VPT`` loads (off every path) is ``wide``: one
block of 1024 threads walks it twice, reading x twice.

* Few rows (every row's threads at one load each fit in one resident
  wave of the card, ``sms * WAVE_THREADS``): latency sets the time, so
  one load per thread and no more.  (4, 3072) f32 is 4 blocks of 768
  threads, one DRAM round trip each.  A row of fewer than 32 vectors
  (the training path's (128, 64)) takes one element per load instead:
  a thread's exact divisions run one after another, so it should hold
  few elements.
* Many rows (a prefill's 2048): the fewest loads per thread that keep
  every row's threads within two resident waves, else ``MAX_VPT``: a
  few warps per row, each thread 2-4 vectors in flight.  On an H100
  this beat one wave of 8 loads a thread and three or more waves of 1.

A row's bytes never depend on the plan: its codes are elementwise, and
its absmax is exact in any order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

MAX_THREADS = 1024          # threads of a block
MAX_VPT = 8                 # loads a thread keeps in registers: 128 bytes
VPTS = (1, 2, 4, 8)         # the kernel's instantiations
WAVE_THREADS = 2048         # resident threads of an SM
BLOCK_THREADS = 256         # threads of a block of many short rows
VECTOR_BYTES = 16
MIN_VECTORS = 32            # a row of fewer, in few rows: element loads


class Plan(NamedTuple):
    tpr: int                # threads per row: 1-16 (a power of two) or
                            # a multiple of 32 up to 1024
    rpb: int                # rows per block; tpr * rpb whole warps
    vpt: int                # loads per thread in registers (VPTS)
    vector: bool            # 16-byte loads, 4-byte stores of 4 codes
    wide: bool              # row walked twice, x read twice

    @property
    def threads(self) -> int:
        return self.tpr * self.rpb

    def blocks(self, T: int) -> int:
        return -(-T // self.rpb)


def vector_elems(dtype: torch.dtype) -> int:
    """Elements of one 16-byte load."""
    return VECTOR_BYTES // dtype.itemsize


def threads_per_row(nvec: int, vpt: int) -> int:
    """Threads that give each of a row's ``nvec`` loads a slot when each
    thread takes ``vpt``: a power of two up to 16 (rows packed into a
    warp, reduced by shuffles), else whole warps."""
    need = max(1, -(-nvec // vpt))
    if need <= 16:
        return 1 << (need - 1).bit_length()
    return -(-need // 32) * 32


@functools.lru_cache(maxsize=256)       # one call per cut message
def quantize_plan(T: int, K: int, dtype: torch.dtype, sms: int,
                  aligned: bool = True) -> Plan:
    """The plan of a call on x (T, K) of ``dtype`` (float32 or bfloat16)
    on a card of ``sms`` SMs; ``aligned``: x's base pointer is 16-byte
    aligned."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the quantize kernel reads float32 or bfloat16, "
                         f"got {dtype}")
    if T < 1 or K < 1 or sms < 1:
        raise ValueError(f"no quantize plan for ({T}, {K}) on {sms} SMs")
    vector = aligned and K % vector_elems(dtype) == 0   # rows 16-aligned
    nvec = K // vector_elems(dtype) if vector else K
    if nvec > MAX_THREADS * MAX_VPT:
        return Plan(MAX_THREADS, 1, MAX_VPT, vector, True)
    few = T * threads_per_row(nvec, 1) <= sms * WAVE_THREADS
    if few and vector and nvec < MIN_VECTORS:
        vector, nvec = False, K
    fits = [v for v in VPTS if threads_per_row(nvec, v) <= MAX_THREADS]
    vpt = next((v for v in fits
                if T * threads_per_row(nvec, v) <= 2 * sms * WAVE_THREADS),
               fits[-1])
    tpr = threads_per_row(nvec, vpt)
    least = 32 // tpr if tpr < 32 else 1        # whole warps
    most = max(least, BLOCK_THREADS // tpr)
    rpb = min(most, -(-T // sms))               # spread rows over the SMs
    rpb = -(-rpb // least) * least
    return Plan(tpr, rpb, vpt, vector, False)
