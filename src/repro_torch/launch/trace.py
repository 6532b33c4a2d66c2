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
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import fake
from repro_torch.sharding.dtensor import current_site

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
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
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
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(is_fake(t) for t in ins + outs):
            return out                  # DTensor's sharding propagation
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and \
                name not in _C10D_BOOKKEEPING:
            self._collective(name, args, outs)
        if packet in self._flop_formulas:
            self.flops += int(self._flop_formulas[packet](
                *args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in outs:
            self.track(t)
        return out

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
