"""Multi-pod dry-run: trace every (architecture x input shape) step on
the production meshes, with nothing allocated (the port's counterpart of
``repro.launch.dryrun``, which lowers and compiles for 512 forced host
devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod] [--trunk-dp-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

A census runs each combination in a process of its own, killed past a
time limit, and reads each record (status, ``trace_s``) from its JSON
file; a combination with no file failed, or timed out (exit code 124)::

    PYTHONPATH=src python -c "from repro_torch.configs import SHAPES, \\
    list_archs; [print(a, s, *m) for m in ((), ('--multi-pod',)) \\
    for a in list_archs() for s in SHAPES]" | PYTHONPATH=src \\
    xargs -P 8 -L 1 sh -c 'timeout 150 python -m \\
    repro_torch.launch.dryrun --arch $0 --shape $1 $2 >/dev/null 2>&1; \\
    echo $0 $1 $2 rc=$?'

A step built by ``launch.steps`` runs as rank 0 of a fake process group
of the mesh's size (``torch.distributed``'s "fake" backend: collectives
return at once): its inputs are DTensors of ``meta`` shards with the
placements of the builder's specs, and ``launch.trace.Trace`` tallies
the local program, per device: memory, FLOPs and bytes, the collectives
(``launch.analysis``) and the kernels' launches by route.  One JSON
record per combination goes to ``experiments/dryrun_torch/``.  The
process group is made inside :func:`main` / :func:`run_one` and taken
down after (one per mesh size), never at import.

The trace describes the card (``kernels/fake.py``): the kernel wrappers
pick the card's routes on the ``meta`` shards and add their work.  On a
one-device mesh (:func:`trace_step` on ``fake_mesh((1, 1), ("data",
"model"))`` in ``fake_world(1)``) it traces the program one card runs,
which ``chip_smoke.py`` holds to the card's launches and peak memory.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import time
import traceback
from typing import Dict, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, get_shape, list_archs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import fake
from repro_torch.launch import analysis
from repro_torch.launch.steps import build, shape_supported
from repro_torch.launch.trace import Trace
from repro_torch.sharding.specs import Mesh, make_rules, named
from repro_torch.tree import tree_leaves, tree_map

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
#: the production meshes: (sizes, names)
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))
#: the card a trace describes when none is visible (its SM count,
#: ``fake.DEFAULT_SMS``, sizes the decode route's split plan)
DESCRIBED_CARD = "NVIDIA H100 80GB HBM3"


def described_card() -> Tuple[str, int]:
    """(name, SM count) of the card the trace describes: the visible
    card, else an H100 SXM."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.name, props.multi_processor_count
    return DESCRIBED_CARD, fake.DEFAULT_SMS


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, for
    the block (collectives issue their ops and return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(sizes, names) -> Mesh:
    """A :class:`Mesh` over the fake group's ranks (row-major), with its
    ``DeviceMesh`` of device type ``cuda``: the card's mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh("cuda", torch.arange(math.prod(sizes)).reshape(sizes),
                    mesh_dim_names=tuple(names))
    return Mesh(tuple(sizes), tuple(names), device_mesh=dm)


def _local_shape(shape, mesh, placements):
    """Rank 0's shard of ``shape`` under ``placements`` (``torch.chunk``'s
    split: rank 0 takes the first, largest chunk)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return tuple(out)


def shard_args(args, specs, mesh: Mesh):
    """The builder's stand-ins as DTensors of ``meta`` shards on
    ``mesh`` (rank 0's), with the specs' placements; ``None`` specs (a
    position or step index) stay as they are."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh

    def one(x, pl):
        if x is None:
            return None
        local = torch.empty(_local_shape(x.shape, dm, pl), dtype=x.dtype,
                            device="meta")
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    out = []
    for a, s in zip(args, specs):
        if s is None:
            out.append(a)
        else:
            out.append(tree_map(one, a, named(mesh, s)))
    return tuple(out)


def _groups_of(mesh: Mesh):
    """``group_name -> explicit rank groups``: every group along the
    mesh dims whose process group it is (all of them, as XLA's
    replica groups list them); rank 0's group for any other."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    dm = mesh.device_mesh
    ids = dm.mesh
    by_name = {}
    for i in range(dm.ndim):
        g = dm.get_group(i)
        by_name[g.group_name] = ids.movedim(i, -1).reshape(
            -1, ids.shape[i]).tolist()

    def groups(name):
        if name in by_name:
            return by_name[name]
        return [dist.get_process_group_ranks(_resolve_process_group(name))]
    return groups


def _locals(tree):
    from torch.distributed.tensor import DTensor
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def trace_step(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
               trunk_dp_over_pod: bool = False, n_microbatches: int = 1,
               ring_cache: bool = False, opt_state_dtype=torch.float32,
               cache_dtype=None) -> Dict:
    """Build the step of (``cfg``, ``shape``) for ``mesh`` (a
    :func:`fake_mesh`) and trace it once: ``{"memory", "peak_bytes",
    "cost", "out_leaf_bytes", "collectives" (records), "kernels",
    "trace_s"}``.  A decode step runs at position ``shape.seq_len`` (a
    cache full to its context), its local position that over the
    owners; a train step at step 0."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules = make_rules(mesh, cfg, trunk_dp_over_pod=trunk_dp_over_pod)
    fn, args, specs, _ = build(cfg, shape, mesh, rules,
                               n_microbatches=n_microbatches,
                               ring_cache=ring_cache,
                               opt_state_dtype=opt_state_dtype,
                               cache_dtype=cache_dtype)
    dargs = shard_args(args, specs, mesh)
    if shape.kind == "decode":
        p = shape.seq_len
        dargs = dargs[:3] + (p, p // cfg.split.n_owners)
    elif shape.kind == "train":
        dargs = dargs[:3] + (0,)
    trace = Trace(_groups_of(mesh), described_card()[1])
    ins = _locals(dargs)
    for t in ins:
        trace.track(t)
    in_keys = {trace.storage_of(t) for t in ins}
    # the positions and the step index enter as ints (0-d int32 on the
    # card when a caller hands tensors): their stand-ins' bytes count
    arg_bytes = trace.live + sum(
        a.numel() * a.element_size() for a, s in zip(args, specs)
        if s is None)
    t0 = time.time()
    with trace, implicit_replication():
        out = fn(*dargs)
    trace_s = time.time() - t0
    outs, seen, out_bytes, alias = _locals(out), set(), 0, 0
    for t in outs:
        key = trace.storage_of(t)
        if key in seen:
            continue
        seen.add(key)
        nbytes = t.untyped_storage().nbytes()
        out_bytes += nbytes
        alias += nbytes if key in in_keys else 0
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "alias_bytes": alias,
           # what makes args + temps + outputs - aliases the peak
           "temp_bytes": trace.peak - arg_bytes - out_bytes + alias}
    return {"memory": mem, "peak_bytes": trace.peak,
            "cost": {"flops": float(trace.flops),
                     "bytes_accessed": float(trace.bytes_accessed),
                     "kernel_flops": float(trace.kernel_flops)},
            "out_leaf_bytes": [t.numel() * t.element_size() for t in outs],
            "collectives": trace.collectives,
            "kernels": dict(sorted(trace.kernels.items())),
            "trace_s": trace_s}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            trunk_dp_over_pod: bool = False, out_dir: str = ART_DIR,
            tag: str = "", verbose: bool = True, n_microbatches: int = 1,
            ring_cache: bool = False, moe_groups: int = 0,
            capacity_factor: float = 0.0, opt_bf16: bool = False,
            cache_f8: bool = False, reduced: bool = False):
    """The reference's ``run_one`` (its arguments, its record), traced on
    a fake production mesh; ``reduced`` takes the config's reduced
    widths (a check on the CPU)."""
    cfg = get_config(arch, reduced=reduced)
    if cfg.moe is not None and (moe_groups or capacity_factor):
        kw = {}
        if moe_groups:
            kw["dispatch_groups"] = moe_groups
        if capacity_factor:
            kw["capacity_factor"] = capacity_factor
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))
    shape = get_shape(shape_name)
    sizes, names = MULTI_POD if multi_pod else SINGLE_POD
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not shape_supported(cfg, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped",
               "reason": f"long_context={cfg.long_context}"}
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: skipped "
                  f"({rec['reason']})")
        _write(rec, out_dir, trunk_dp_over_pod, tag)
        return rec
    with fake_world(math.prod(sizes)):
        mesh = fake_mesh(sizes, names)
        traced = trace_step(
            cfg, shape, mesh, trunk_dp_over_pod=trunk_dp_over_pod,
            n_microbatches=n_microbatches, ring_cache=ring_cache,
            opt_state_dtype=torch.bfloat16 if opt_bf16 else torch.float32,
            cache_dtype=torch.float8_e4m3fn if cache_f8 else None)
    mem, cost = analysis.extract_memory(traced), analysis.extract_cost(
        traced)
    colls = analysis.collective_stats(
        traced["collectives"], devices_per_pod=256 if multi_pod else 0)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": math.prod(sizes),
        "trunk_dp_over_pod": trunk_dp_over_pod,
        "n_microbatches": n_microbatches,
        "n_layers": cfg.n_layers, "reduced": reduced,
        "status": "ok",
        "trace_s": round(traced["trace_s"], 2),
        "memory": mem,
        "hbm_per_device_bytes": analysis.hbm_per_device(mem),
        "cost": cost,
        "collectives": {k: v for k, v in colls.items()
                        if k != "cross_pod_ops"},
        "cross_pod_ops_sample": colls["cross_pod_ops"][:8],
        # every cross-pod collective, for claim C4: what it was issued
        # for (the cut's sites, or none) and its result
        "cross_pod": [{k: r[k] for k in ("kind", "dtype", "shape", "site")}
                      for r in colls["cross_pod_ops"]],
        "kernels": traced["kernels"],
    }
    if verbose:
        print(f"[{rec['mesh']}] {arch} x {shape_name}"
              f"{' +trunk_dp_pod' if trunk_dp_over_pod else ''}: "
              f"trace {rec['trace_s']}s, "
              f"HBM/dev {rec['hbm_per_device_bytes'] / 2**30:.2f} GiB, "
              f"flops {cost['flops']:.3e}, "
              f"coll {colls['total_bytes'] / 2**20:.1f} MiB"
              + (f" (cross-pod {colls['cross_pod_bytes'] / 2**20:.1f} MiB)"
                 if multi_pod else "") + f", kernels {rec['kernels']}")
        print("  memory:", mem)
        print("  cost:", cost)
    _write(rec, out_dir, trunk_dp_over_pod, tag)
    return rec


def _write(rec, out_dir, trunk_dp_over_pod, tag):
    """``rec`` as ``<arch>_<shape>_<mesh>[_tdp][_tag].json`` in
    ``out_dir`` (nothing when ``out_dir`` is empty)."""
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = "_tdp" if trunk_dp_over_pod else ""
    tagp = f"_{tag}" if tag else ""
    fn_out = os.path.join(out_dir, f"{rec['arch']}_{rec['shape']}_"
                          f"{rec['mesh']}{suffix}{tagp}.json")
    with open(fn_out, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--trunk-dp-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--opt-bf16", action="store_true")
    ap.add_argument("--cache-f8", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced widths (a CPU check)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args(argv)
    # DTensor's advice on each two-step all-reduce of a partial sum over
    # two mesh dims, once per call: the records count those collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                try:
                    run_one(a, s, mp, args.trunk_dp_pod, args.out,
                            args.tag, n_microbatches=args.microbatches,
                            ring_cache=args.ring_cache,
                            moe_groups=args.moe_groups,
                            capacity_factor=args.capacity_factor,
                            opt_bf16=args.opt_bf16,
                            cache_f8=args.cache_f8, reduced=args.reduced)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    traceback.print_exc()
                    failures.append((a, s, mp, str(e)[:200]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
