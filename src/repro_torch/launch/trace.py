"""The dry-run's trace: one step run on ``meta`` shards, tallied per
device (the port's counterpart of compiling for the production mesh and
reading XLA's per-device module).

A step's inputs enter as ``torch.distributed.tensor`` DTensors over a
mesh of a fake process group, each holding rank 0's shard as a ``meta``
tensor; the DTensor ops issue the local ops and the collectives a real
rank would.  :class:`Trace` is a ``TorchDispatchMode`` that lets each
DTensor op run (it returns ``NotImplemented`` for them, as
``CommDebugMode`` does) and tallies the local ops that follow, at
per-device shapes:

* ``flops``: ``torch.utils.flop_counter``'s formulas of each local op
  (matrix products), plus each kernel's own count (``kernels/fake.py``);
* ``bytes_accessed``: each local op's input tensors plus its outputs, as
  XLA's "bytes accessed" sums per op; view ops and allocations touch
  nothing and count 0; a kernel adds the bytes it moves;
* live bytes and their peak: each storage counted from the op that
  makes it until its last tensor dies (autograd's saved tensors
  included); the inputs' storages are live from the start;
* ``collectives``: one record per ``_c10d_functional`` op (its kind in
  the reference's names, its result's dtype and local shape, the rank
  groups of its process group, and the activation site it was issued
  for, where ``sharding.dtensor.site`` names one: ``constrain`` names
  its own);
* ``kernels``: the kernels' described launches by route.

An op met again with the arguments' metadata it was met with before is
not run: its results are made with the layouts it gave then, and its
FLOPs and bytes counted as then (``Trace._remember``).

Why ``meta`` and not fake tensors on ``cuda``: on a build of torch
without CUDA, autograd aborts the process on a fake ``cuda`` tensor
(its input metadata asks for a CUDA device guard), so a train step
cannot be traced there.  ``meta`` tensors run every op's shape function
the card's would; the kernel wrappers take them as the card's launch
(route, outputs, workspaces), never as a CPU tensor.

DTensor's own sharding propagation runs ops on fake tensors of its
own; the trace leaves those out (they are not the device's work).
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import fake
from repro_torch.sharding.dtensor import _dtensor_type, current_site

#: ``_c10d_functional`` ops under the reference's collective names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: ``_c10d_functional`` ops that are bookkeeping, not collectives
_C10D_BOOKKEEPING = {"wait_tensor", "_wrap_tensor_autograd"}
#: ops that move no bytes: allocations and bookkeeping
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "device", "detach", "lift_fresh",
             "alias"} | _C10D_BOOKKEEPING


class Trace(TorchDispatchMode):
    """Tallies the local ops of a step run on DTensors of ``meta``
    shards (see the module docstring).  ``groups_of(group_name)`` gives
    the explicit rank groups of a collective's process group;
    ``sm_count`` is the SM count of the card described."""

    def __init__(self, groups_of=None, sm_count: int = fake.DEFAULT_SMS):
        super().__init__()
        self.sm_count = sm_count
        self.groups_of = groups_of or (lambda name: [])
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.collectives: List[Dict] = []
        self.kernels: Counter = Counter()
        self.kernel_flops = 0
        self._refs: Dict[int, int] = {}      # storage -> live tensors
        self._size: Dict[int, int] = {}      # storage -> bytes
        self._watch: Dict = {}    # id(weakref to a tensor) -> (it, storage)
        self._memo: Dict = {}     # op and argument key -> layouts, tallies
        self._memo_ok: Dict = {}             # op -> memoisable
        from torch.utils.flop_counter import flop_registry
        self._flop_formulas = flop_registry

    # ------------------------------------------------------ live storages

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live while a tensor on it lives."""
        key = t.untyped_storage()._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self._size[key] = t.untyped_storage().nbytes()
            self.live += self._size[key]
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        ref = weakref.ref(t, self._dead)
        self._watch[id(ref)] = ref, key

    def _dead(self, ref) -> None:
        _, key = self._watch.pop(id(ref))
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._size.pop(key)

    def storage_of(self, t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    # ----------------------------------------------------------- tallies

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """A kernel wrapper's described launch (``kernels/fake.py``)."""
        self.kernels[name] += 1
        self.flops += flops
        self.kernel_flops += flops
        self.bytes_accessed += nbytes

    def __enter__(self):
        self._tally = fake.tally(self)
        self._tally.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._tally.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        key = self._memo_key(func, args, kwargs, ins)
        try:
            hit = None if key is None else self._memo.get(key)
        except TypeError:               # an argument that cannot be hashed
            key = hit = None
        if hit is not None:
            kind, layouts, flops, nbytes = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in layouts]
            self.flops += flops
            self.bytes_accessed += nbytes
            for t in outs:
                self.track(t)
            return outs[0] if kind is None else kind(outs)
        out = func(*args, **kwargs)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        if any(type(t) is not torch.Tensor and is_fake(t)
               for t in ins + outs):
            return out                  # DTensor's sharding propagation
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and \
                name not in _C10D_BOOKKEEPING:
            self._collective(name, args, outs)
        flops = nbytes = 0
        if packet in self._flop_formulas:
            flops = int(self._flop_formulas[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        self.flops += flops
        self.bytes_accessed += nbytes
        for t in outs:
            self.track(t)
        if key is not None:
            self._remember(key, out, ins, flops, nbytes)
        return out

    def _memo_key(self, func, args, kwargs, ins):
        """The key under which an op on ``meta`` tensors is remembered:
        the op and its arguments' metadata, on which its results'
        layouts, FLOPs and bytes depend; ``None`` for an op that is not
        to be remembered (a view, an in-place op, a collective, an op on
        real tensors or with an argument that cannot be hashed)."""
        ok = self._memo_ok.get(func)
        if ok is None:
            ok = self._memo_ok[func] = _memoisable(func)
        if not ok or not ins or not all(type(t) is torch.Tensor
                                        and t.is_meta for t in ins):
            return None
        return func, _meta_key(args), _meta_key(tuple(kwargs.items()))

    def _remember(self, key, out, ins, flops, nbytes):
        """Keep an op's results' layouts and tallies under ``key``: an op
        met again with the same metadata is then made with
        ``empty_strided`` and skips torch's ``meta`` function (most run
        in Python at 0.03-0.8 ms, which a recurrence of thousands of
        steps, the sLSTM's, cannot afford); the ops that function
        dispatches itself (its allocations, a decomposition's
        temporaries, which no card kernel makes) are then not tallied
        again.  Only fresh results are kept: none on an input's storage
        (``_unsafe_view`` shares it with no alias in its schema)."""
        kind = None if isinstance(out, torch.Tensor) else type(out)
        outs = [out] if kind is None else out
        if kind not in (None, list, tuple) or not outs or not all(
                isinstance(o, torch.Tensor) for o in outs):
            return
        shared = {t.untyped_storage()._cdata for t in ins}
        layouts = [o.untyped_storage()._cdata not in shared and _layout(o)
                   for o in outs]
        if all(layouts):
            self._memo[key] = (kind, layouts, flops, nbytes)

    def _collective(self, name, args, outs):
        if name not in COLLECTIVE_KINDS:
            raise NotImplementedError(f"the trace has no collective name for "
                                      f"_c10d_functional.{name}")
        group_name = args[-1]
        for t in outs:
            self.collectives.append({
                "kind": COLLECTIVE_KINDS[name],
                "dtype": str(t.dtype).replace("torch.", ""),
                "shape": list(t.shape),
                "groups": self.groups_of(group_name),
                "site": current_site()})


def _tensors(items, acc: list) -> list:
    """The tensors among ``items`` and in their lists, tuples and dicts,
    appended to ``acc`` (a plain walk: ``pytree``'s costs the trace
    ~10 us an op)."""
    for x in items:
        if isinstance(x, torch.Tensor):
            acc.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, acc)
        elif isinstance(x, dict):
            _tensors(x.values(), acc)
    return acc


def _meta_key(x):
    """What a ``meta`` op's result can depend on, of one argument: a
    ``meta`` tensor's shape, strides and dtype; a scalar's type and
    value; a sequence's items."""
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype
    if isinstance(x, (list, tuple)):
        return type(x), tuple(map(_meta_key, x))
    return type(x), x


def _memoisable(func) -> bool:
    """An op whose results are fresh tensors: no view, no alias, no
    in-place write, no collective."""
    schema = func._schema
    return (not func.is_view and not schema.is_mutable
            and func.namespace not in ("_c10d_functional", "c10d")
            and all(a.alias_info is None
                    for a in list(schema.arguments) + list(schema.returns)))


def _layout(t: torch.Tensor):
    """``(shape, stride, dtype)`` of a fresh result that
    ``empty_strided`` makes again exactly (its own storage, no spare
    bytes), else ``None``."""
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    if t.storage_offset() or t.untyped_storage().nbytes() != \
            (extent if t.numel() else 0) * t.element_size():
        return None
    return t.shape, t.stride(), t.dtype
