"""How the attention wrapper splits its work: the route a call takes,
the keys every route walks and the split-KV plan of the decode route.
Pure functions of dtype, shapes, ``q_offset``, ``kv_len`` and the SM
count, so the CPU tests cover them and a call's bits depend on nothing
else.

A query row that sees no key (``kv_len`` 0, or a ``local`` window wholly
past ``kv_len``) gets the reference's answer, the mean of V over all Skv
keys: its scores are all the finite -2^30, so the softmax is uniform.
So when some row of a call sees no key (``has_empty_row``), every route
walks the whole cache ``[0, Skv)`` and skips no tile; rows that do see
keys are unchanged, since exp(-2^30 - m) is 0.  Keys past the walked
range (the zero-filled tail of the last tile) weigh exactly 0.

Routes (``ops.py`` launches one per call, decided before the launch):

* ``decode`` (``csrc/attention_decode.cu``): at most ``DECODE_MAX_ROWS``
  query rows per kv head (``Sq * nh / nkv``) — every decode tick of the
  serving path and short chunks over a cache; f32 or bf16, any hd.
* ``tc`` (``csrc/attention_prefill_sm90.cu``): every other bf16 call
  with hd a multiple of 16 up to 128 whose tensors TMA can read (16-byte
  aligned pointers and strides) — the serving path's prefills.
* ``fma`` (``csrc/block_attention.cu``): the rest — f32 prefills (the
  2e-4 tolerance rules out bf16 or TF32 operands), bf16 with hd above
  128 or not a multiple of 16.

Per-row lengths (continuous batching: every batch row at its own decode
position, ``q_offset`` and ``kv_len`` one per row) run on the decode
route only.  ``row_plans`` gives each row the plan a scalar call with
that row's length would take (``live_range`` and ``split_plan`` with the
call's ``B * nkv``), so a row's bits depend neither on the other rows'
lengths nor on whether its length came as a scalar or a vector.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

TILE = 64                  # keys per tile of the decode route
DECODE_MAX_ROWS = 64       # query rows per kv head the decode route takes
TC_MAX_HEAD_DIM = 128
BLOCKS_PER_SM = 2          # decode blocks wanted per SM: two waves or more
ROUTES = ("decode", "tc", "fma")


def choose_route(dtype, Sq: int, nh: int, nkv: int, hd: int,
                 tma_aligned: bool = True, per_row: bool = False) -> str:
    """The route of a call with q (B, Sq, nh, hd) and nkv kv heads;
    ``per_row``: the call gives one ``q_offset`` / ``kv_len`` per row,
    which only the decode route takes."""
    if Sq * (nh // nkv) <= DECODE_MAX_ROWS:
        return "decode"
    if per_row:
        raise ValueError(f"per-row lengths run on the decode route, which "
                         f"takes at most {DECODE_MAX_ROWS} query rows per "
                         f"kv head, got {Sq * (nh // nkv)}")
    if (dtype == torch.bfloat16 and hd % 16 == 0 and hd <= TC_MAX_HEAD_DIM
            and tma_aligned):
        return "tc"
    return "fma"


def _row_sees_no_key(pos: int, kind: str, window: int,
                     kv_lim: int) -> bool:
    lo = max(0, pos - window + 1) if kind == "local" else 0
    hi = kv_lim if kind == "bidir" else min(kv_lim, pos + 1)
    return hi <= lo


def has_empty_row(Sq: int, kind: str, window: int, q_offset: int,
                  kv_lim: int) -> bool:
    """Whether some query row of the call sees no key.  The rows that see
    a key are the positions of one interval (``[0, kv_lim + window - 1)``
    for ``local``, ``[0, inf)`` for ``causal``, all for ``bidir``, none
    at ``kv_lim`` 0), so the first and the last row decide it."""
    if Sq <= 0:
        return False
    return any(_row_sees_no_key(pos, kind, window, kv_lim)
               for pos in (q_offset, q_offset + Sq - 1))


def live_range(Sq: int, kind: str, window: int, q_offset: int,
               kv_lim: int, skv: Optional[int] = None,
               tile: int = TILE) -> Tuple[int, int]:
    """Keys ``[k_begin, k_end)`` that the routes walk: those some query
    row of the call may see, with ``k_begin`` rounded down to a whole tile
    — or the whole cache ``[0, skv)`` when some row sees no key
    (``skv`` defaults to ``kv_lim``)."""
    if has_empty_row(Sq, kind, window, q_offset, kv_lim):
        return 0, kv_lim if skv is None else skv
    pos_first, pos_last = q_offset, q_offset + Sq - 1
    k_begin, k_end = 0, kv_lim
    if kind != "bidir":
        k_end = min(k_end, pos_last + 1)
    if kind == "local":
        k_begin = max(0, pos_first - window + 1)
    return (k_begin // tile) * tile, k_end


@functools.lru_cache(maxsize=4096)
def split_plan(k_begin: int, k_end: int, n_bh: int, n_sm: int = 132,
               tile: int = TILE) -> Tuple[int, int]:
    """``(split_len, n_split)`` for ``n_bh`` (batch x kv head) blocks over
    the live range: whole tiles per split, and enough splits for about
    ``BLOCKS_PER_SM`` blocks on every SM (two waves of one block per SM),
    never more splits than tiles.  Fewer, longer splits keep each warp's
    next loads in flight and shrink the merge; on the H100, llama3.2-3b's
    and zamba2-2.7b's decode ticks ran faster at 2 blocks per SM than at
    4 or more."""
    n_tiles = -(-(k_end - k_begin) // tile) if k_end > k_begin else 0
    if n_tiles == 0:
        return tile, 0
    want = min(n_tiles, max(1, -(-BLOCKS_PER_SM * n_sm // n_bh)))
    per = -(-n_tiles // want)
    if -(-n_tiles // per) < want:      # rounding up lost a split
        per -= 1
    return per * tile, -(-n_tiles // per)


def splits(k_begin: int, k_end: int, split_len: int,
           n_split: int) -> List[Tuple[int, int]]:
    """The key ranges of a plan, in the order they are merged."""
    return [(k_begin + i * split_len, min(k_end, k_begin + (i + 1) *
                                          split_len))
            for i in range(n_split)]



def row_plans(Sq: int, kind: str, window: int, q_offsets: Sequence[int],
              kv_lens: Sequence[int], skv: int, n_bh: int,
              n_sm: int = 132, tile: int = TILE) -> np.ndarray:
    """The decode route's plan of every batch row, (B, 6) int32 in the
    kernel's order: row b's ``q_offset``, its ``kv_lim`` (``kv_len``
    clamped to [0, skv]), its live range ``k_begin, k_end`` and its split
    plan ``split_len, n_split``, each what a scalar call with that row's
    ``q_offset`` and ``kv_len`` computes (``n_bh``: the call's B * nkv,
    as in the scalar plan)."""
    out = np.zeros((len(q_offsets), 6), np.int32)
    for b, (qo, kl) in enumerate(zip(q_offsets, kv_lens)):
        qo, kv_lim = int(qo), max(0, min(int(kl), skv))
        k_begin, k_end = live_range(Sq, kind, window, qo, kv_lim, skv, tile)
        split_len, n_split = split_plan(k_begin, k_end, n_bh, n_sm, tile)
        out[b] = (qo, kv_lim, k_begin, k_end, split_len, n_split)
    return out


def live_pairs(Sq: int, Skv: int, kind: str, window: int, q_offset: int,
               kv_len: Optional[int]) -> Tuple[int, int]:
    """The (query, key) pairs the mask keeps and ``kv_lim``: the work
    these inputs need (``chip_smoke.py``'s bounds count the same)."""
    kv_lim = min(Skv, kv_len if kv_len is not None else Skv)
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    hi = (np.full(Sq, kv_lim, np.int64) if kind == "bidir"
          else np.minimum(kv_lim, qp + 1))
    lo = (np.maximum(0, qp - window + 1) if kind == "local"
          else np.zeros(Sq, np.int64))
    return int(np.maximum(0, hi - lo).sum()), kv_lim


def work(B: int, Sq: int, Skv: int, nh: int, nkv: int, hd: int, elt: int,
         kind: str, window: int, q_offsets: Sequence[int],
         kv_lens: Sequence[Optional[int]]) -> Tuple[int, int]:
    """A call's (FLOPs, bytes): 4·nh·hd FLOP a live (query, key) pair of
    each row; q and o, and the keys and values up to each row's
    ``kv_lim``, moved once (the bound of ``chip_smoke.py``'s
    ``attn_bound``).  ``q_offsets`` / ``kv_lens``: one per batch row."""
    flops = nbytes = 0
    for qo, kl in zip(q_offsets, kv_lens):
        pairs, kv_lim = live_pairs(Sq, Skv, kind, window, int(qo), kl)
        flops += 4 * nh * hd * pairs
        nbytes += elt * (2 * Sq * nh * hd + 2 * kv_lim * nkv * hd)
    return flops, nbytes
