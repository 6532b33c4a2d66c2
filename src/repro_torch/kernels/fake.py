"""The kernel wrappers on fake and ``meta`` tensors: a description of
what the card's launch would do, for the dry-run's trace
(``launch/trace.py``).

A wrapper handed fake tensors on ``cuda`` (``torch._subclasses``' fake
tensors) or ``meta`` tensors picks its route with its plan as the card
would, allocates the outputs and workspaces the launch allocates, and
reports the route, the kernel's FLOPs and bytes to the tally that is
open (:func:`tally`); it launches nothing and calls nothing through
``ctypes``.  Real tensors never come here: a CUDA tensor launches its
kernel or raises, a CPU tensor takes the plain version.

The split-KV plan sizes its grid by the SM count of the card the trace
describes (:func:`sm_count`): the open tally's, else 132 (an H100 SXM).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import is_fake

#: SMs of the card a trace describes when no tally says otherwise
DEFAULT_SMS = 132

_TALLY: contextvars.ContextVar = contextvars.ContextVar("kernel_tally",
                                                        default=None)


def described(*ts) -> bool:
    """Whether the tensors describe the card's program: fake tensors on
    ``cuda``, or ``meta`` tensors."""
    return all(t.device.type == "meta" or (is_fake(t)
                                           and t.device.type == "cuda")
               for t in ts)


def aligned16(*ts, dims: int = 3) -> bool:
    """The wrappers' 16-byte rule on described tensors: the storage
    offset and the strides of the first ``dims`` dims (``-1``: all but
    the last) on 16-byte boundaries (a card allocation's base is
    aligned)."""
    return all(t.storage_offset() * t.element_size() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:dims])
        for t in ts)


@contextlib.contextmanager
def tally(sink):
    """Report described launches to ``sink`` (an object with
    ``kernel(name, flops, nbytes)`` and ``sm_count``) in the block."""
    tok = _TALLY.set(sink)
    try:
        yield sink
    finally:
        _TALLY.reset(tok)


def sm_count() -> int:
    sink = _TALLY.get()
    return DEFAULT_SMS if sink is None else sink.sm_count


def record(name: str, flops: int, nbytes: int) -> None:
    """One described launch of ``name`` (``block_attention.tc``, ...)
    doing ``flops`` operations over ``nbytes`` of inputs and outputs."""
    sink = _TALLY.get()
    if sink is not None:
        sink.kernel(name, int(flops), int(nbytes))
