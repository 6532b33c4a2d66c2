"""Wrapper of the attention kernels: for tensors on the card, one of three
hand-written CUDA kernels chosen by ``plan.choose_route`` from dtype and
shapes before the launch — ``decode`` (``csrc/attention_decode.cu``,
split-KV), ``tc`` (``csrc/attention_prefill_sm90.cu``, wgmma and TMA)
or ``fma`` (``csrc/block_attention.cu``); the plain version (``ref.py``)
for tensors on the CPU.

A CUDA tensor launches its route's kernel or raises; nothing falls back
to another route or to the plain version.  ``q_offset`` and ``kv_len``
are ints, or one value per batch row (a (B,) int tensor, best on the
host: a tensor on the card is read back with a sync); per-row calls take
the decode route, which reads each row's plan (``plan.row_plans``) from
a small int32 table on the card, made and uploaded once per distinct
set of lengths and kept (``_row_table``), so the layers of one decode
step share it.  The wrapper counts its
launches (``launch_counts``): ``block_attention`` once per call, and
``block_attention.<route>`` for the route it took, so a run can show
which kernels its path went through; ``block_attention.per_row`` counts
the decode launches with per-row lengths (a part of
``block_attention.decode``).  Fake or ``meta`` tensors launch nothing:
they describe the card's launch to the dry-run's trace
(``kernels/fake.py``), uncounted here.
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import Dict, Optional

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build, fake
from repro_torch.kernels.block_attention import plan, ref

_count_lock = threading.Lock()
#: kernel launches since the last ``reset_launch_counts``
launch_counts: Dict[str, int] = {
    "block_attention": 0, **{f"block_attention.{r}": 0 for r in plan.ROUTES},
    "block_attention.per_row": 0}

KINDS = {"causal": 0, "local": 1, "bidir": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: the CUDA source of each route
SOURCES = {"decode": "attention_decode", "tc": "attention_prefill_sm90",
           "fma": "block_attention"}


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
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
        fn = getattr(lib, f"{name}_launch")
        if route == "decode":    # + the per-row plan table
            fn.argtypes = ([vp] * 7 + [i] * 6 + [ll] * 9 + [i] * 4 + [f, f]
                           + [i] * 5 + [vp])
        elif route == "tc":     # Skv in place of dtype; `full` after mask
            fn.argtypes = [vp] * 4 + [i] * 6 + [ll] * 9 + [i] * 5 + [f, f, vp]
        else:                   # fma: dtype and Skv; `full` after mask
            fn.argtypes = [vp] * 4 + [i] * 7 + [ll] * 9 + [i] * 5 + [f, f, vp]
        fn.restype = i
        _libs[route] = lib
    return _libs[route]


def _aligned16(*ts) -> bool:
    """Base pointers and the strides of the first three dims on 16-byte
    boundaries (TMA's rule, and the decode route's vector loads)."""
    return all(t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:3]) for t in ts)


def _check(q, k, v, kind):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"block_attention needs q, k, v all on one CUDA "
                         f"device or all on the CPU, got {q.device}, "
                         f"{k.device}, {v.device}")
    _check_args(q, k, v, kind)


def _check_args(q, k, v, kind):
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


def _per_row(q_offset, kv_len) -> bool:
    return any(isinstance(x, torch.Tensor) and x.dim() == 1
               for x in (q_offset, kv_len))


def route_of(q, k, v, per_row: bool = False) -> str:
    """The route ``block_attention`` takes for CUDA tensors q, k, v
    (``per_row``: with per-row ``q_offset`` / ``kv_len``)."""
    B, Sq, nh, hd = q.shape
    return plan.choose_route(q.dtype, Sq, nh, k.shape[2], hd,
                             tma_aligned=_aligned16(q, k, v),
                             per_row=per_row)


def block_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    softcap: float = 0.0, q_offset=0, kv_len=None,
                    scale: Optional[float] = None):
    """GQA flash attention.  q: (B, Sq, nh, hd); k, v: (B, Skv, nkv, hd)
    -> (B, Sq, nh, hd) in q's dtype.  Query row i of batch row b sits at
    position ``q_offset + i`` (``q_offset[b] + i`` when per row); keys at
    positions >= ``kv_len`` (``kv_len[b]``) are masked."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, kind=kind, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 kv_len=kv_len, scale=scale)
    if fake.described(q, k, v):
        return _describe(q, k, v, kind, window, q_offset, kv_len)
    _check(q, k, v, kind)
    per_row = _per_row(q_offset, kv_len)
    return _run(route_of(q, k, v, per_row), q, k, v, kind, window, softcap,
                q_offset, kv_len, scale)


def _launch(route, q, k, v, *, kind="causal", window=0, softcap=0.0,
            q_offset=0, kv_len=None, scale=None):
    """Check CUDA tensors, launch ``route``'s kernel and count it.
    ``chip_smoke.py`` calls it to time the ``fma`` route at the shapes
    the other routes take; ``block_attention`` picks the route itself."""
    _check(q, k, v, kind)
    return _run(route, q, k, v, kind, window, softcap, q_offset, kv_len,
                scale)


def _describe(q, k, v, kind, window, q_offset, kv_len):
    """The launch on described tensors (``kernels/fake.py``): the route
    the card takes, its output and its split-KV workspace allocated, its
    work reported to the open tally; nothing launched."""
    _check_args(q, k, v, kind)
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    per_row = _per_row(q_offset, kv_len)
    route = plan.choose_route(q.dtype, Sq, nh, nkv, hd,
                              tma_aligned=fake.aligned16(q, k, v),
                              per_row=per_row)
    if route == "tc" and (hd % 16 or hd > plan.TC_MAX_HEAD_DIM):
        raise ValueError(f"the tc route takes hd a multiple of 16 up to "
                         f"{plan.TC_MAX_HEAD_DIM}, got {hd}")
    q_offsets = _host_rows(q_offset, B, 0)
    kv_lens = (_host_rows(kv_len, B, Skv) if kv_len is not None
               else [None] * B)
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    if route == "decode":
        rows = Sq * (nh // nkv)
        if rows > plan.DECODE_MAX_ROWS:
            raise ValueError(f"the decode route takes at most "
                             f"{plan.DECODE_MAX_ROWS} query rows per kv "
                             f"head, got {rows}")
        n_split = 0
        for qo, kl in zip(q_offsets, kv_lens):
            kv_lim = Skv if kl is None else max(0, min(int(kl), Skv))
            k_begin, k_end = plan.live_range(Sq, kind, int(window), int(qo),
                                             kv_lim, Skv)
            n_split = max(n_split, plan.split_plan(
                k_begin, k_end, B * nkv, fake.sm_count())[1])
        n = max(1, n_split * B * nkv * rows)
        torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    flops, nbytes = plan.work(B, Sq, Skv, nh, nkv, hd, q.element_size(),
                              kind, int(window), q_offsets, kv_lens)
    fake.record(f"block_attention.{route}", flops, nbytes)
    if per_row:
        fake.record("block_attention.per_row", 0, 0)
    return out


_table_lock = threading.Lock()
#: per-row plan tables on the card and their longest row's n_split, by
#: the arguments of ``plan.row_plans`` and the device, newest last
_row_tables: "OrderedDict[tuple, tuple]" = OrderedDict()
_ROW_TABLES_KEPT = 16


def _row_table(Sq, kind, window, q_offsets, kv_lens, skv, n_bh, device):
    """The per-row plans of a call on ``device`` and the largest n_split:
    computed and uploaded from pinned memory (no host sync) the first
    time these arguments are seen, then reused (every layer of a decode
    step with one cache length hands in the same arguments)."""
    key = (str(device), Sq, kind, window, tuple(q_offsets), tuple(kv_lens),
           skv, n_bh)
    with _table_lock:
        hit = _row_tables.get(key)
        if hit is None:
            table = plan.row_plans(Sq, kind, window, q_offsets, kv_lens,
                                   skv, n_bh, sm_count(device))
            hit = (torch.from_numpy(table).pin_memory().to(
                device, non_blocking=True), int(table[:, 5].max()))
            _row_tables[key] = hit
            while len(_row_tables) > _ROW_TABLES_KEPT:
                _row_tables.popitem(last=False)
        else:
            _row_tables.move_to_end(key)
        return hit


def _host_rows(x, B: int, default: int):
    """A per-row argument (int, None or (B,) tensor) as B host ints."""
    if x is None:
        return [default] * B
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        if x.shape[0] != B:
            raise ValueError(f"per-row values for {B} rows, got "
                             f"{x.shape[0]}")
        return x.detach().cpu().tolist()
    return [int(x)] * B


def _run(route, q, k, v, kind, window, softcap, q_offset, kv_len, scale):
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    per_row = _per_row(q_offset, kv_len)
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if per_row and route != "decode":
        raise ValueError(f"per-row q_offset / kv_len run on the decode "
                         f"route, not {route!r}")
    if not per_row:
        kv_lim = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
        mask = (KINDS[kind], int(window), kv_lim, int(q_offset))
        # tc and fma walk the whole cache, skipping no tile, when some
        # row sees no key (the decode route's live range says the same)
        full = int(plan.has_empty_row(Sq, kind, int(window),
                                      int(q_offset), kv_lim))
    if route == "decode":
        rows = Sq * (nh // nkv)
        if rows > plan.DECODE_MAX_ROWS:
            raise ValueError(f"the decode route takes at most "
                             f"{plan.DECODE_MAX_ROWS} query rows per kv "
                             f"head, got {rows}")
        table_ptr = 0
        if per_row:
            # each row's plan is a scalar call's at that row's length; the
            # grid covers the longest, and a block past its row's plan
            # returns at once
            table, n_split = _row_table(
                Sq, kind, int(window), _host_rows(q_offset, B, 0),
                _host_rows(kv_len, B, Skv), Skv, B * nkv, q.device)
            table_ptr = table.data_ptr()
            mask = (KINDS[kind], int(window), 0, 0)
            k_begin = k_end = 0
            split_len = plan.TILE
        else:
            k_begin, k_end = plan.live_range(Sq, kind, int(window),
                                             int(q_offset), kv_lim, Skv)
            split_len, n_split = plan.split_plan(k_begin, k_end, B * nkv,
                                                 sm_count(q.device))
        # f32 scratch: the partial accumulators, then (m, l) per row
        n = max(1, n_split * B * nkv * rows)
        scratch = torch.empty(n * (hd + 2), dtype=torch.float32,
                              device=q.device)
        vec = int(_aligned16(q, k, v) and hd * k.element_size() % 16 == 0)
        err = _library(route).attention_decode_launch(
            *ptrs, scratch.data_ptr(), scratch.data_ptr() + 4 * n * hd,
            table_ptr, DTYPES[q.dtype], B, Sq, nh, nkv, hd, *strides,
            *mask, float(softcap), float(scale), k_begin, k_end, split_len,
            n_split, vec, stream)
    elif route == "tc":
        if (q.dtype != torch.bfloat16 or hd % 16
                or hd > plan.TC_MAX_HEAD_DIM or not _aligned16(q, k, v)):
            raise ValueError(f"the tc route takes bf16 with hd a multiple "
                             f"of 16 up to {plan.TC_MAX_HEAD_DIM} and "
                             f"16-byte aligned tensors, got {q.dtype}, "
                             f"hd {hd}")
        err = _library(route).attention_prefill_sm90_launch(
            *ptrs, B, Sq, Skv, nh, nkv, hd, *strides, *mask, full,
            float(softcap), float(scale), stream)
    elif route == "fma":
        err = _library(route).block_attention_launch(
            *ptrs, DTYPES[q.dtype], B, Sq, Skv, nh, nkv, hd, *strides,
            *mask, full, float(softcap), float(scale), stream)
    else:
        raise ValueError(f"unknown attention route {route!r}")
    if err:
        raise RuntimeError(f"block_attention {route} launch failed: "
                           + ("tensor map not encoded" if err == -1
                              else f"cudaError {err}"))
    with _count_lock:
        launch_counts["block_attention"] += 1
        launch_counts[f"block_attention.{route}"] += 1
        if per_row:
            launch_counts["block_attention.per_row"] += 1
    return out
