"""The dry-run's DTensor programs: how one rank of a production mesh
runs the port's steps on ``torch.distributed.tensor`` DTensors (see
``launch/dryrun.py``).

DTensor places each op from its inputs' placements; where that would
not be the program a rank of the reference's mesh runs, or cannot run
at all, the model calls these:

* :func:`constrain_to` (``specs.constrain``'s DTensor half) holds an
  activation and its gradient at the reference's placements, as
  ``with_sharding_constraint`` does, and :func:`site` names the
  activation a collective is issued for (the trace records it: claim
  C4 counts the cut's);
* :func:`owners` / :func:`stack_owners`: the heads run owner-parallel,
  each pod its own owners' heads over the pod's sub-mesh (their inputs
  moved there by :func:`pod_local`, a ragged cut lifted by
  :func:`owner_cuts`, one owner's result by :func:`one_owner`);
  :func:`on_pod` runs a trunk replicated over the pods on the pod's
  sub-mesh (or, when it is data-parallel over the pods, over "pod" and
  "data" merged);
* :func:`on_shards`: a kernel on each rank's rows and heads (its local
  shards); :func:`replicas`: ops DTensor has no placement for (MoE's
  sorts and gathers) on every rank over the whole value;
* :func:`split_heads`, :func:`pinned`, :func:`summed` and
  :func:`redistribute` work round DTensor's limits (a shard split
  across a head, a masked partial sum reduced twice, a shard moved
  between tensor dims with its collective left out).

On plain tensors (every real run) each is the identity or the plain
op.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import operator
from typing import Optional

import torch

_SITE: contextvars.ContextVar = contextvars.ContextVar("sharding_site",
                                                       default=None)


@contextlib.contextmanager
def site(name: str):
    """Name the activation the block's collectives are issued for (the
    dry-run's trace records it with each collective)."""
    tok = _SITE.set(name)
    try:
        yield
    finally:
        _SITE.reset(tok)


def current_site() -> Optional[str]:
    return _SITE.get()


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers at once: the
    helpers cost a real step nothing measurable)."""
    return type(x) is not torch.Tensor and isinstance(x, _dtensor_type())


def first_tensor(tree):
    """The first tensor of a tree (None if it has none)."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return next((f for f in map(first_tensor, tree) if f is not None), None)
    return tree if isinstance(tree, torch.Tensor) else None


def constrain_to(x, want, name):
    """DTensor ``x`` redistributed to the placements ``want``, and its
    gradient too; the collectives of each labelled ``name``."""
    return _Constrain.apply(x, tuple(want), name)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient too, as
    ``with_sharding_constraint`` holds both; the collectives of each
    are labelled ``name``."""

    @staticmethod
    def forward(ctx, x, want, name):
        ctx.want, ctx.name = want, name
        if tuple(x.placements) == want:
            return x.view_as(x)
        with site(name):
            return redistribute(x, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            with site(ctx.name):
                g = redistribute(g, ctx.want)
        return g, None, None


def redistribute(x, want):
    """DTensor ``x`` redistributed to the placements ``want`` on its
    mesh.  A mesh dim whose shard moves to another tensor dim goes
    through ``Replicate`` first (an all-gather, then a local chunk):
    torch's planner moves a shard between tensor dims of one mesh dim
    while another mesh dim shards the target dim with no collective on
    the first (on torch 2.13: (S(1), S(0)) -> (S(0), S(0)) over (pod,
    data) all-gathers over data alone), which would hide the traffic."""
    from torch.distributed.tensor import Replicate
    dm = x.device_mesh
    want = tuple(want)
    have = tuple(x.placements)
    if have == want:
        return x
    mid = tuple(Replicate() if h.is_shard() and w.is_shard() and h != w
                else h for h, w in zip(have, want))
    if mid != have:
        x = x.redistribute(dm, mid)
    return x if mid == want else x.redistribute(dm, want)


def pinned(t):
    """DTensor ``t`` whose gradient is redistributed to ``t``'s own
    placements (a plain tensor as it is): the gradient of a merged
    head dim must not reach the merge sharded across a head."""
    if not is_dtensor(t):
        return t
    return constrain_to(t, t.placements, None)


def summed(t):
    """DTensor ``t`` with its pending (partial) sums reduced: each
    partial mesh dim replicated."""
    from torch.distributed.tensor import Replicate
    return redistribute(t, [Replicate() if p.is_partial() else p
                            for p in t.placements])


def split_heads(t, n: int, hd: int):
    """``t`` (..., n * hd) viewed as (..., n, hd).  A DTensor whose last
    dim a mesh dim shards by a size that does not divide ``n`` (llama's
    24 heads over a 16-way "model" axis) is gathered over that mesh dim
    first: DTensor cannot split a shard across a head, so those ranks
    compute every head (XLA pads the heads instead)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        last = t.dim() - 1
        pl = [Replicate() if p.is_shard(last) and n % t.device_mesh.size(i)
              else p for i, p in enumerate(t.placements)]
        t = redistribute(t, pl)
    return t.reshape(tuple(t.shape[:-1]) + (n, hd))


def _shifted(placements, by: int):
    """Placements with every ``Shard(d)`` moved to ``Shard(d + by)``."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + by) if p.is_shard() else p
                 for p in placements)


def owners(tree, n: int):
    """The owners whose heads this rank runs, and ``take(tree, p)``:
    owner p's slice of an owner-stacked tree.  Plain tensors: every
    owner, ``take`` indexes.  DTensors over a mesh with a "pod" dim: the
    owners of this rank's pod when the owner dim is sharded over it
    (the data owners at datacenter scale: each pod runs its own heads),
    and ``take`` gives each leaf's slice as a DTensor over the other
    mesh dims (no collective)."""
    leaf = first_tensor(tree)
    if not is_dtensor(leaf) or "pod" not in (leaf.device_mesh.mesh_dim_names
                                             or ()):
        return range(n), _index
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = leaf.device_mesh
    names = dm.mesh_dim_names
    i = names.index("pod")
    sub = dm[tuple(a for a in names if a != "pod")]
    pods = dm.size(i)
    lo = 0
    if leaf.placements[i] == Shard(0):
        lo = dm.get_coordinate()[i] * (n // pods)
        mine = range(lo, lo + n // pods)
    else:
        mine = range(n)

    def take(t, p):
        def one(x):
            if not isinstance(x, DTensor):
                return x[p]
            pl = list(x.placements)
            if pl[i] == Shard(0):
                j = p - lo
            elif pl[i] == Replicate():
                j = p
            else:
                x = redistribute(x, pl[:i] + [Replicate()] + pl[i + 1:])
                pl, j = list(x.placements), p
            rest = pl[:i] + pl[i + 1:]
            if any(q.is_shard(0) for q in rest):
                raise ValueError("an owner-stacked leaf sharded on its "
                                 "owner dim over a non-pod axis")
            return DTensor.from_local(x.to_local()[j], sub,
                                      _shifted(rest, -1), run_check=False)
        return _tree_map(one, t)

    return mine, take


def stack_owners(parts, like):
    """The owners' results (from :func:`owners`' loop) stacked on a
    leading owner dim, a scalar (such as the heads' aux) summed over
    them.  Plain tensors, or DTensors whose mesh has no "pod" dim:
    ``torch.stack`` and ``+``.  On a "pod" mesh (``like``, a head leaf,
    says how the owner dim lies) the results over the sub-mesh are
    lifted onto the whole mesh: the owner dim over "pod" as ``like``'s,
    a scalar as a partial sum over the pods (a plain one taken as
    replicated on the sub-mesh)."""
    if not (is_dtensor(like)
            and "pod" in (like.device_mesh.mesh_dim_names or ())):
        if parts[0].dim():
            return torch.stack(parts)
        return functools.reduce(operator.add, parts)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = like.device_mesh
    i = dm.mesh_dim_names.index("pod")
    pod = like.placements[i]
    locals_ = [p.to_local() if isinstance(p, DTensor) else p for p in parts]
    inner = (parts[0].placements if isinstance(parts[0], DTensor)
             else (Replicate(),) * (dm.ndim - 1))
    if parts[0].dim() == 0:
        pl = list(inner)
        pl.insert(i, Partial() if pod.is_shard() else Replicate())
        return DTensor.from_local(functools.reduce(operator.add, locals_),
                                  dm, tuple(pl), run_check=False)
    pl = list(_shifted(inner, 1))
    pl.insert(i, pod)
    n = len(parts) * (dm.size(i) if pod.is_shard() else 1)
    shape = (n,) + tuple(parts[0].shape)
    return DTensor.from_local(torch.stack(locals_), dm, tuple(pl),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _off_pod(x, sub, i: int):
    """DTensor ``x`` with its mesh's "pod" dim (``i``) dropped: the same
    local tensor over ``sub``."""
    from torch.distributed.tensor import DTensor
    pl = x.placements[:i] + x.placements[i + 1:]
    return DTensor.from_local(x.to_local(), sub, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def pod_local(tree):
    """``tree`` with each DTensor that a mesh's "pod" dim replicates
    moved onto this rank's pod's sub-mesh (no collective), as the heads
    :func:`owners` hands over expect their inputs; anything else as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(x):
        if not isinstance(x, DTensor) or "pod" not in (
                x.device_mesh.mesh_dim_names or ()):
            return x
        dm = x.device_mesh
        i = dm.mesh_dim_names.index("pod")
        if x.placements[i] != Replicate():
            raise ValueError("an owner's input split over the pods")
        return _off_pod(x, dm[tuple(a for a in dm.mesh_dim_names
                                    if a != "pod")], i)
    return _tree_map(one, tree)


def _pod_mesh(like) -> bool:
    """Whether ``like`` is a DTensor over a mesh with a "pod" dim."""
    return is_dtensor(like) and "pod" in (like.device_mesh.mesh_dim_names
                                         or ())


def owner_cuts(parts, lengths, like):
    """The owners' cuts from :func:`owners`' loop, each (B, S_p, k):
    stacked on a leading owner dim (:func:`stack_owners`) when the
    owners' lengths agree, else a list in owner order (a ragged cut).
    On a "pod" mesh a ragged cut is lifted pod by pod: each pod's cuts
    padded with zeros to the longest length (a local pad, no
    collective), stacked over "pod", gathered at "cut_stacked" (the
    cut's one crossing) and cut back to each owner's length."""
    if len(set(lengths)) == 1:
        return stack_owners(parts, like)
    if not _pod_mesh(like):
        return list(parts)
    from torch.distributed.tensor import DTensor, Replicate
    L = max(lengths)

    def padded(c):
        if any(q.is_shard(1) for q in c.placements):
            raise ValueError("a ragged cut split along its sequence")
        loc = c.to_local()
        loc = torch.cat([loc, loc.new_zeros((loc.shape[0], L - c.shape[1])
                                            + tuple(loc.shape[2:]))], 1)
        return DTensor.from_local(loc, c.device_mesh, c.placements,
                                  run_check=False)
    stacked = stack_owners([padded(c) for c in parts], like)
    i = like.device_mesh.mesh_dim_names.index("pod")
    pl = list(stacked.placements)
    pl[i] = Replicate()
    with site("cut_stacked"):
        full = redistribute(stacked, pl)
    return [full[p][:, :n] for p, n in enumerate(lengths)]


def one_owner(run, p: int, heads, n: int, rows, tail, dtype):
    """``run(owner p's slice of heads)``: one owner's result, such as a
    vision decode step's cut, as the trunk receives it.  Plain tensors,
    or a mesh without a "pod" dim: ``run`` on the slice.  On a "pod"
    mesh a pod that runs owner p runs it on its sub-mesh, the other
    owners of its pod run no head and stand zeros of ``rows``' rows by
    ``tail`` (``rows`` on the pod's sub-mesh) in their slots, and the
    owners' stack, lifted onto the mesh, gives owner p's slot: gathered
    at "cut_stacked" (the cut's one crossing) where the owner dim lies
    over "pod"."""
    mine, take = owners(heads, n)
    like = first_tensor(heads)
    if not _pod_mesh(like):
        return run(take(heads, p))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    parts = []
    for q in mine:
        if q == p:
            parts.append(run(take(heads, q)))
            continue
        pl = tuple(Shard(0) if x == Shard(0) else Replicate()
                   for x in rows.placements)
        loc = torch.zeros((rows.to_local().shape[0],) + tuple(tail),
                          dtype=dtype, device=rows.to_local().device)
        parts.append(DTensor.from_local(loc, rows.device_mesh, pl,
                                        run_check=False))
    with site("cut_stacked"):
        return stack_owners(parts, like)[p]


def _merged(dm):
    """``dm`` with its "pod" and "data" dims merged into one "data" dim
    (pod-major, as their ranks lie)."""
    from torch.distributed.device_mesh import DeviceMesh
    names = dm.mesh_dim_names
    i = names.index("pod")
    shape = list(dm.mesh.shape)
    shape[i:i + 2] = [shape[i] * shape[i + 1]]
    return DeviceMesh(dm.device_type, dm.mesh.reshape(shape),
                      mesh_dim_names=names[:i] + names[i + 1:])


def on_pod(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the DTensors in the arguments over a
    mesh without a "pod" dim, where they lie the same over "pod" and
    the next dim (the trunk): replicated over "pod", on this rank's
    pod's sub-mesh (the pods compute the same thing); data-parallel
    over ("pod", "data"), on the mesh with the two merged into one
    "data" dim.  The results are lifted back.  One rank's program is
    the same either way; without the extra mesh dim DTensor's
    placement search stays small (on three dims it ran minutes for a
    reduced step).  Anything else runs as it is."""
    if not is_dtensor(first_tensor((args, kwargs))):
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate
    leaves = [x for x in _leaves((args, kwargs)) if isinstance(x, DTensor)]
    dm = leaves[0].device_mesh
    names = dm.mesh_dim_names or ()
    if "pod" not in names or any(x.device_mesh != dm for x in leaves):
        return fn(*args, **kwargs)
    i = names.index("pod")
    if all(x.placements[i] == Replicate() for x in leaves):
        sub, merge = dm[tuple(a for a in names if a != "pod")], False
    elif names[i + 1:i + 2] == ("data",) and all(
            x.placements[i] == x.placements[i + 1] for x in leaves):
        sub, merge = _merged(dm), True
    else:
        return fn(*args, **kwargs)

    def down(x):
        return _off_pod(x, sub, i) if isinstance(x, DTensor) else x

    def up(x):
        if not isinstance(x, DTensor):
            return x
        pod = x.placements[i] if merge else Replicate()
        pl = x.placements[:i] + (pod,) + x.placements[i:]
        return DTensor.from_local(x.to_local(), dm, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    out = fn(*_tree_map(down, args), **_tree_map(down, kwargs))
    return _tree_map(up, out)


def _index(t, p):
    return _tree_map(lambda x: x[p], t)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _tree_map(f, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, t) for t in tree)
    return None if tree is None else f(tree)


def _same(t):
    return t


def replicas(x):
    """``(x's whole value on this rank, lift)``: a DTensor redistributed
    to ``Replicate`` on every mesh dim and handed over as its local
    tensor, ``lift`` wrapping a local result back as a replicated
    DTensor on its mesh (both differentiable); a plain tensor as it is,
    ``lift`` the identity."""
    if not is_dtensor(x):
        return x, _same
    from torch.distributed.tensor import DTensor, Replicate
    dm = x.device_mesh
    rep = (Replicate(),) * dm.ndim
    x = redistribute(x, rep)
    return x.to_local(), (lambda t: DTensor.from_local(t, dm, rep,
                                                       run_check=False))


def on_shards(fn, args, dims, out_dims):
    """``fn(*args)`` on DTensor ``args`` as one rank runs it: each arg
    redistributed to its local layout and handed over as its shard,
    the results wrapped back over the same mesh.  ``dims``: for each
    arg, ``(batch dim, head dim)`` (``None`` where it has none);
    ``out_dims`` the same for each result.  A mesh dim keeps the first
    arg's ``Shard`` of its batch dim, or of its head dim where every
    arg with a head dim divides by the mesh dim's size; any other
    placement becomes ``Replicate`` (the work is independent per batch
    row and per head, so each rank computes its rows' and heads'
    share).  Plain tensors run ``fn`` as they are."""
    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = lead.device_mesh
    kinds = []
    for i, p in enumerate(lead.placements):
        n = dm.size(i)
        kind = None
        if p.is_shard(dims[0][0]):
            kind = 0
        elif dims[0][1] is not None and p.is_shard(dims[0][1]) and all(
                d[1] is None or a.shape[d[1]] % n == 0
                for a, d in zip(args, dims) if a is not None):
            kind = 1
        kinds.append(kind)

    def layout(d):
        return tuple(Replicate() if k is None or d[k] is None
                     else Shard(d[k]) for k in kinds)

    local = []
    for a, d in zip(args, dims):
        if isinstance(a, DTensor):
            a = redistribute(a, layout(d)).to_local()
        local.append(a)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(DTensor.from_local(o, dm, layout(d), run_check=False)
                    for o, d in zip(outs, out_dims))
    return wrapped[0] if single else wrapped
