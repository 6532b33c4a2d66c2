"""Partitioning rules of the split LM on the production meshes (the
port's counterpart of ``repro.sharding.specs``).

Single-pod mesh (16, 16) = ("data", "model"); multi-pod (2, 16, 16) =
("pod", "data", "model").  The owner (data-owner) dimension of head
params and activations maps onto "pod": PyVertical's parties at
datacenter scale, so the cut-layer gather is the only cross-pod
collective of the protocol.  ``trunk_dp_over_pod`` lets the trunk
data-parallelize over ("pod", "data") after the cut; by default the
trunk (the scientist's) is replicated across pods.

The spec functions take trees of tensors (``meta`` tensors for a
production mesh: nothing is allocated) and return trees of
:class:`PartitionSpec` of the same structure, leaf for leaf the
reference's: the same rules, the same divisibility guards.  A mesh is a
:class:`Mesh`: its axis names and sizes, and its devices (``None`` for
an abstract mesh, which the spec functions read and nothing runs on).
``named`` turns specs into ``torch.distributed.tensor`` placements, one
per mesh dim.

``constrain`` marks the model's activations at the reference's eight
sites.  The port runs a step on one device: under a one-device mesh
(``launch.mesh.make_host_mesh()``) every spec resolves to replication
and ``constrain`` returns its input; under an abstract mesh, or a mesh
of several devices, a step has nothing to run on and ``constrain``
raises.  The dry-run's mesh (a ``DeviceMesh`` over a fake process
group, ``Mesh.device_mesh``) runs a step as one rank on DTensors, and
there ``constrain`` places each activation (``sharding.dtensor``).  ``activation_spec`` is the reference's table of activation
specs, the function its ``with_sharding_constraint`` is given.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.sharding.dtensor import constrain_to


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (sharded over their product, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class Mesh:
    """A mesh: ``axis_names`` and their ``axis_sizes``, and the devices
    it spans in row-major order (``None``: an abstract mesh).  A mesh of
    the dry-run also carries ``device_mesh``, a ``DeviceMesh`` over a
    fake process group (``launch/dryrun.py``): its steps run on DTensors
    of ``meta`` shards, one rank's program."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[torch.device, ...]] = None
    device_mesh: Any = None

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")
        if self.devices is not None and \
                len(self.devices) != self.device_count:
            raise ValueError(f"a mesh of {self.device_count} devices got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device_count(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def abstract(self) -> bool:
        return self.devices is None and self.device_mesh is None


def abstract_mesh(axis_sizes, axis_names) -> Mesh:
    """A mesh with no devices: spec construction reads only its names and
    sizes."""
    return Mesh(tuple(axis_sizes), tuple(axis_names))


@dataclass(frozen=True)
class ShardingRules:
    multi_pod: bool = False
    model_axis: str = "model"
    data_axis: str = "data"
    pod_axis: Optional[str] = None              # None on the single-pod mesh
    fsdp: bool = False                          # ZeRO param sharding
    trunk_dp_over_pod: bool = False
    # decode-cache context parallelism: shard the cache's sequence dim
    cache_seq_axes: Tuple[str, ...] = ("model",)

    @property
    def owner_axis(self):
        return self.pod_axis

    @property
    def trunk_batch(self):
        if self.multi_pod and self.trunk_dp_over_pod:
            return (self.pod_axis, self.data_axis)
        return (self.data_axis,)


def make_rules(mesh: Mesh, cfg, **kw) -> ShardingRules:
    multi = "pod" in mesh.axis_names
    return ShardingRules(multi_pod=multi, pod_axis="pod" if multi else None,
                         fsdp=cfg.zero_sharding, **kw)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _map(f, tree, path: str = ""):
    """``f(path, leaf)`` over a tree of dicts, lists and tuples whose
    leaves are tensors or specs; ``path`` joins dict keys and ``#i``
    sequence indices with "/" (the reference's path strings); ``None``
    is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, (PartitionSpec, torch.Tensor)):
        return f(path, tree)
    sub = (lambda k: f"{path}/{k}" if path else str(k))
    if isinstance(tree, dict):
        return {k: _map(f, tree[k], sub(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(f, t, sub(f"#{i}"))
                          for i, t in enumerate(tree))
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def spec_leaves(tree):
    """The specs (or tensors) of a tree, in ``tree_leaves`` order."""
    out = []
    _map(lambda _, x: out.append(x), tree)
    return out


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

# logical trailing-dims spec per param name; tokens are resolved against
# the rules ("model" -> the model axis, "fsdp" -> the data axis when
# zero-sharding, else replicated)
_PARAM_RULES = [
    # (suffix, logical_ndim, spec template)
    ("embed/table", 2, ("model", "fsdp")),
    ("lm_head/w", 2, (None, "model")),
    ("front_proj/w", 2, (None, "model")),
    ("cut_proj/w", 2, (None, None)),
    ("in_proj/w", 2, ("fsdp", "model")),        # trunk in_proj & mamba in_proj
    ("attn/wq/w", 2, ("fsdp", "model")),
    ("attn/wk/w", 2, ("fsdp", "model")),
    ("attn/wv/w", 2, ("fsdp", "model")),
    ("xattn/wq/w", 2, ("fsdp", "model")),
    ("xattn/wk/w", 2, ("fsdp", "model")),
    ("xattn/wv/w", 2, ("fsdp", "model")),
    ("attn/wo/w", 2, ("model", "fsdp")),
    ("xattn/wo/w", 2, ("model", "fsdp")),
    ("ffn/w_in/w", 2, ("fsdp", "model")),
    ("ffn/w_gate/w", 2, ("fsdp", "model")),
    ("ffn/w_out/w", 2, ("model", "fsdp")),
    ("shared/w_in/w", 2, ("fsdp", "model")),
    ("shared/w_gate/w", 2, ("fsdp", "model")),
    ("shared/w_out/w", 2, ("model", "fsdp")),
    ("router/w", 2, (None, None)),
    # MoE experts: expert-parallel over the model axis when E divides it,
    # else tensor-parallel experts (d_expert sharded): mixtral's 8
    # experts on a 16-way model axis
    ("w_in", 3, ("expert", None, "expert_alt")),   # (E, d, d_e)
    ("w_gate", 3, ("expert", None, "expert_alt")),
    ("w_out", 3, ("expert", "expert_alt", None)),  # (E, d_e, d)
    ("conv_w", 2, (None, "model")),
    ("mamba/out_proj/w", 2, ("model", "fsdp")),
    ("up_x/w", 2, ("fsdp", "model")),
    ("up_z/w", 2, ("fsdp", "model")),
    ("cell/wq/w", 2, (None, "model")),
    ("cell/wk/w", 2, (None, "model")),
    ("cell/wv/w", 2, (None, "model")),
    ("w_if/w", 2, ("model", None)),
    ("cell/down/w", 2, ("model", "fsdp")),
    ("w_gates/w", 2, ("fsdp", "model")),
    ("r_gates", 3, (None, None, None)),
    ("cell/up/w", 2, ("fsdp", "model")),
    ("up/w", 2, ("fsdp", "model")),
    ("down/w", 2, ("model", "fsdp")),
]


def _divisible(dim: int, axes, mesh: Mesh) -> bool:
    if axes is None:
        return True
    names = axes if isinstance(axes, tuple) else (axes,)
    return dim % math.prod(mesh.shape[a] for a in names) == 0


def _resolve(template, rules: ShardingRules, mesh: Mesh, shape, offset):
    """Template tokens -> mesh axes, with divisibility guards."""
    out = []
    expert_sharded = False
    if "expert" in template:
        e_dim = shape[offset + template.index("expert")]
        expert_sharded = _divisible(e_dim, rules.model_axis, mesh)
    for i, tok in enumerate(template):
        dim = shape[offset + i]
        ax = None
        if tok == "model":
            ax = rules.model_axis
        elif tok == "fsdp":
            ax = rules.data_axis if rules.fsdp else None
        elif tok == "expert":
            ax = rules.model_axis if expert_sharded else None
        elif tok == "expert_alt":
            ax = None if expert_sharded else rules.model_axis
        if ax is not None and not _divisible(dim, ax, mesh):
            ax = None
        out.append(ax)
    return out


def _owner_dim(ps: str, shape, rules: ShardingRules, mesh: Mesh) -> bool:
    """A head leaf's leading owner dim goes over the owner axis."""
    return ("heads/" in ps and len(shape) >= 1 and bool(rules.owner_axis)
            and _divisible(shape[0], rules.owner_axis, mesh))


def param_specs(param_shapes, cfg, mesh: Mesh, rules: ShardingRules):
    """The spec tree of a param tree (``SplitModel.param_specs()``), or
    of an optimizer state over one (its paths end in the params')."""

    def leaf(ps, x):
        ndim = x.dim()
        for suffix, lnd, template in _PARAM_RULES:
            if ps.endswith(suffix) and lnd <= ndim:
                # stacking prefixes: the owner dim (heads/...), the unit dim
                n_prefix = ndim - lnd
                spec = [None] * n_prefix
                if n_prefix >= 1 and _owner_dim(ps, x.shape, rules, mesh):
                    spec[0] = rules.owner_axis
                spec += _resolve(template, rules, mesh, x.shape, n_prefix)
                return P(*spec)
        # replicated: norm scales, biases, scalars
        spec = [None] * ndim
        if _owner_dim(ps, x.shape, rules, mesh):
            spec[0] = rules.owner_axis
        return P(*spec)

    return _map(leaf, param_shapes)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch_shapes, cfg, mesh: Mesh, rules: ShardingRules):
    """Specs of a training / prefill batch dict (owner inputs, labels) or
    of a decode step's ``{"token": ...}``."""

    def leaf(name, x):
        d = rules.data_axis
        db = (lambda n: d if _divisible(n, d, mesh) else None)
        if name == "owner_tokens":                 # (P, B, S_p)
            pod = (rules.owner_axis if rules.owner_axis
                   and _divisible(x.shape[0], rules.owner_axis, mesh)
                   else None)
            return P(pod, db(x.shape[1]), None)
        if name in ("patches", "frames"):          # (B, S_p, d_f)
            return P(db(x.shape[0]), None, None)
        if name in ("tokens", "labels"):           # (B, S)
            return P(db(x.shape[0]), *([None] * (x.dim() - 1)))
        if name == "token":                        # decode (B, 1)
            return P(db(x.shape[0]), None)
        return P(*([None] * x.dim()))

    return _map(leaf, batch_shapes)


def cache_specs(cache_shapes, cfg, mesh: Mesh, rules: ShardingRules):
    """Decode-cache specs.  KV caches (units, B, S, n_kv, hd): the batch
    over data when divisible, the sequence over ``cache_seq_axes``
    (context parallelism), over data as well when the batch is not;
    recurrent states: the batch over data.  Owner-stacked head caches
    have a leading owner dim."""

    def leaf(ps, x):
        d = rules.data_axis
        shape = x.shape
        spec = [None] * len(shape)
        if ps.startswith("heads") and not ps.startswith("heads/patches") \
                and not ps.startswith("heads/tokens"):
            if rules.owner_axis and _divisible(shape[0], rules.owner_axis,
                                               mesh):
                spec[0] = rules.owner_axis
            b_dim = 2                              # (P, units, B, ...)
        else:
            b_dim = 1                              # (units, B, ...)
        if ps.startswith("enc"):                   # (B, S_enc, d)
            if _divisible(shape[0], d, mesh):
                spec[0] = d
            return P(*spec)
        if b_dim < len(shape) and _divisible(shape[b_dim], d, mesh):
            spec[b_dim] = d
        # the KV caches' sequence dim: (.., B, S, n_kv, hd)
        if len(shape) - b_dim == 4 and (ps.endswith("/k")
                                        or ps.endswith("/v")):
            s_dim = b_dim + 1
            axes = tuple(a for a in rules.cache_seq_axes
                         if a in mesh.axis_names)
            if spec[b_dim] is None:
                # batch unshardable (B = 1): context-parallel over data too
                axes = tuple(dict.fromkeys((rules.data_axis,) + axes))
            if axes and _divisible(shape[s_dim], axes, mesh):
                spec[s_dim] = axes if len(axes) > 1 else axes[0]
        return P(*spec)

    return _map(leaf, cache_shapes)


def _placements(mesh: Mesh, spec: PartitionSpec, names=None):
    """``spec`` as one ``torch.distributed.tensor`` placement per mesh
    dim (of ``names``, default the mesh's): ``Shard(d)`` where the mesh
    axis shards tensor dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in (mesh.axis_names if names is None else names):
        dim = next((i for i, e in enumerate(spec) if e == name or (
            isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def named(mesh: Mesh, spec_tree):
    """Every spec of a tree as its placements on ``mesh``."""
    return _map(lambda _, s: _placements(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# Activation constraints (called from the model)
# ---------------------------------------------------------------------------

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def sharding_context(mesh: Mesh, rules: ShardingRules):
    tok = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(tok)


def activation_spec(name: str, shape, mesh: Mesh, rules: ShardingRules):
    """The reference's spec for the activation ``name`` of ``shape``
    (each axis dropped where it does not divide its dim), or ``None``
    for a name it leaves unconstrained."""
    d, m = rules.data_axis, rules.model_axis
    tb = tuple(a for a in rules.trunk_batch if a)
    batch = tb if len(tb) > 1 else (tb[0] if tb else None)
    table = {
        "cut_stacked": (rules.owner_axis, d, None, None),  # (P, B, S_p, k)
        "combined": (batch, None, None),           # (B, S, k) after combine
        "trunk_hidden": (batch, None, None),       # (B, S, d)
        "logits": (batch, None, m),                # (B, S, vocab)
        "moe_buffer": (m, d, None),                # (E, C, d)
        "moe_buffer_grouped": (d, m, None, None),  # (G, E, C_g, d)
    }
    if name not in table:
        return None
    return P(*(ax if ax is None or _divisible(dim, ax, mesh) else None
               for dim, ax in zip(shape, table[name])))


def check_runnable(mesh: Mesh) -> None:
    """Raise unless a step can run on ``mesh``: the port runs a step on
    one device, or traces it on the dry-run's mesh over a fake process
    group (a ``device_mesh`` while the "fake" backend is up); an abstract
    mesh (no devices), a ``DeviceMesh`` over any other process group and
    a mesh of several devices cannot run it."""
    if mesh.device_mesh is not None:
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_backend() == "fake":
            return
        raise ValueError("a DeviceMesh over a real process group: the "
                         "port runs a step on one device, and traces "
                         "one over a fake process group only")
    if mesh.abstract:
        raise ValueError("an abstract mesh has no devices to run on (its "
                         "specs are for reading)")
    if mesh.device_count != 1:
        raise ValueError(f"the port runs a step on one device, not on a "
                         f"mesh of {mesh.device_count}")


def constrain(x, name: str):
    """Mark the model activation ``name`` (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed to
    ``activation_spec``'s placements on its mesh, its collectives
    labelled ``name`` (``dtensor.site``); a plain tensor, as on a step's
    one-device mesh, is returned as it is.  Raises on a mesh a step
    cannot run on (``check_runnable``)."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    check_runnable(mesh)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = activation_spec(name, x.shape, mesh, rules)
    if spec is None:
        return x
    return constrain_to(x, _placements(mesh, spec,
                                       x.device_mesh.mesh_dim_names), name)
