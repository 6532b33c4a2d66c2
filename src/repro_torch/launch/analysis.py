"""Dry-run analysis: collective traffic and roofline inputs (the port's
counterpart of ``repro.launch.analysis``).

The reference reads XLA's compiled per-device module: its
``cost_analysis()``, its ``memory_analysis()`` and, parsed from the HLO
text, every collective's result shape and replica groups.  The port has
no compiled module.  Its input is the dry-run's trace
(``launch.trace.Trace``): the counts it tallied, and one record per
collective a rank's step issued::

    {"kind": "all-gather", "dtype": "bfloat16", "shape": [2, 2, 16, 256],
     "groups": [[0, 4], [1, 5], ...], "site": "combined"}

``kind`` is one of the reference's five names (each ``_c10d_functional``
op mapped onto them), ``shape`` the result's local shape (the bytes that
land on a device, as the reference's proxy), ``groups`` the explicit
rank groups of the op's process group: rank lists for a group
collective, ``[source, target]`` pairs for a collective-permute.  The
records carry explicit lists, so the reference's ``_iota_groups`` (XLA's
compressed ``[G,N]<=[...]`` form) has no counterpart here.

Cross-pod detection: on the (pod, data, model) mesh ranks are pod-major
(rank // 256 = pod), so a group mixing rank // 256 values crosses the pod
boundary, the PyVertical party boundary.  Claim C4 requires those to be
cut-layer collectives (or 0-d reductions) only.

The memory dict has the reference's keys but ``code_bytes``: the port
generates no code.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the reference's byte table, by torch dtype name
_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "int64": 8, "uint64": 8,
    "int32": 4, "uint32": 4, "int16": 2, "uint16": 2, "int8": 1,
    "uint8": 1, "bool": 1, "complex64": 8, "complex128": 16,
}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def shape_bytes(dtype, shape: Iterable[int]) -> int:
    """Bytes of a ``dtype`` tensor of ``shape`` (a 0-d shape: one
    element)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[_dtype_name(dtype)]


def crosses(groups: List[List[int]], devices_per_pod: int) -> bool:
    """Whether a group (or a source-target pair) mixes pods."""
    return any(len({r // devices_per_pod for r in g}) > 1 for g in groups)


def collective_stats(records: Iterable[Dict],
                     devices_per_pod: int = 0) -> Dict:
    """Sum per-device collective bytes by kind; flag cross-pod ops."""
    by_kind: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    cross_pod_bytes = 0
    cross_pod_ops: List[Dict] = []
    n_ops = 0
    for r in records:
        b = shape_bytes(r["dtype"], r["shape"])
        by_kind[r["kind"]] += b
        n_ops += 1
        if devices_per_pod and crosses(r["groups"], devices_per_pod):
            cross_pod_bytes += b
            cross_pod_ops.append(r)
    return {"per_kind_bytes": by_kind, "total_bytes": sum(by_kind.values()),
            "n_ops": n_ops, "cross_pod_bytes": cross_pod_bytes,
            "cross_pod_ops": cross_pod_ops}


def extract_cost(traced: Dict) -> Dict:
    """FLOPs and bytes accessed per device of a traced step."""
    cost = traced["cost"]
    return {"flops": float(cost["flops"]),
            "bytes_accessed": float(cost["bytes_accessed"])}


def extract_memory(traced: Dict) -> Dict:
    """Per-device argument, output, temp and alias bytes of a traced
    step (no ``code_bytes``: nothing is generated).  ``temp_bytes`` is
    defined so that :func:`hbm_per_device` is the trace's peak of live
    bytes: the peak less the arguments and the outputs, plus the
    outputs that alias an argument (a cache written in place)."""
    return dict(traced["memory"])


def hbm_per_device(mem: Dict) -> int:
    """Live bytes per device: args + temps + outputs - donated aliases."""
    if not mem:
        return 0
    return (mem["argument_bytes"] + mem["temp_bytes"]
            + mem["output_bytes"] - mem["alias_bytes"])

