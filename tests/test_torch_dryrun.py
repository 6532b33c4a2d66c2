"""The port's dry-run (``repro_torch.launch.dryrun``) on fake meshes of 8
ranks, against the reference's lower-and-compile on 8 forced host
devices: the reference's five ``test_sharding_dryrun.py`` cases, reduced
(``ShapeConfig("t", 32, 4, kind)``), their per-device argument and
output bytes against the reference's ``memory_analysis()``, claim C4 per
collective on the (2, 2, 2) mesh, and the traced FLOPs of a train step
against a closed-form count.

Every trace and every compile runs in a subprocess of its own (a process
group, like XLA's device count, is global to a process), all of them
started together by one module fixture, each with its own timeout.  The
reference compiles on ``jax.make_mesh(..., axis_types=(AxisType.Auto,) *
n)``: jax 0.9's default ``Explicit`` axes refuse its sharding
constraints, which is why its own dry-run tests fail on this tree.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.launch import analysis

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300

PORT = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, steps
inner = steps.batch_structs


def ragged(cfg, shape, with_labels):
    # the vision owner's patches 8 longer than the text owner's tokens
    b = inner(cfg, shape, with_labels)
    B, n, d = b["patches"].shape
    b["patches"] = steps.struct((B, n + 8, d), b["patches"].dtype)
    if with_labels:
        b["labels"] = steps.struct((B, shape.seq_len + 8), torch.int32)
    return b


out = {}
for job in json.loads(sys.argv[1]):
    steps.batch_structs = ragged if job.get("ragged") else inner
    sizes = tuple(job["sizes"])
    cfg = get_config(job["arch"], reduced=True)
    if job.get("n_layers"):
        cfg = cfg.replace(n_layers=job["n_layers"])
    with dryrun.fake_world(int(torch.tensor(sizes).prod())):
        mesh = dryrun.fake_mesh(sizes, ("pod", "data", "model")[-len(sizes):])
        out[job["name"]] = dryrun.trace_step(
            cfg, ShapeConfig("t", 32, 4, job["kind"]), mesh,
            trunk_dp_over_pod=job.get("tdp", False))
print("RESULT " + json.dumps(out))
"""

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import analysis
from repro.launch.steps import build
from repro.sharding.specs import make_rules, named
job = json.loads(sys.argv[1])
cfg = get_config(job["arch"], reduced=True)
n = 3 if job["multi"] else 2
sizes = (2, 2, 2) if job["multi"] else (2, 4)
mesh = jax.make_mesh(sizes, ("pod", "data", "model")[-n:],
                     axis_types=(AxisType.Auto,) * n)
fn, args, specs, donate = build(cfg, ShapeConfig("t", 32, 4, job["kind"]),
                                mesh, make_rules(mesh, cfg))
shardings = named(mesh, specs)
compiled = jax.jit(fn, in_shardings=shardings,
                   donate_argnums=donate).lower(*args).compile()
mem = analysis.extract_memory(compiled)
colls = analysis.collective_stats(compiled.as_text(),
                                  devices_per_pod=4 if job["multi"] else 0)
is_sh = lambda x: isinstance(x, jax.sharding.Sharding)
outs = jax.eval_shape(fn, *args)
paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(outs)[0])
out_sh = jax.tree_util.tree_leaves(compiled.output_shardings, is_leaf=is_sh)
# each output leaf that is an input's next value: the input's sharding
in_of = {}
pairs = {"train": ((0, 0), (1, 1)), "decode": ((1, 1),),
         "prefill": ((1, 2),)}[job["kind"]]
for o, i in pairs:
    for p, s in zip(
            jax.tree_util.tree_flatten_with_path(outs[o])[0],
            jax.tree_util.tree_leaves(shardings[i], is_leaf=is_sh)):
        in_of[jax.tree_util.keystr((jax.tree_util.SequenceKey(o),)
                                   + p[0])] = s
rows = []
for p, l, s in zip(paths, leaves, out_sh):
    key = jax.tree_util.keystr(p)
    nb = lambda sh: int(np.prod(sh.shard_shape(l.shape))) * l.dtype.itemsize
    src = in_of.get(key)
    rows.append({"path": key, "bytes": nb(s),
                 "input_bytes": None if src is None else nb(src)})
print("RESULT " + json.dumps({
    "mem": mem, "out_leaves": rows,
    "cross": [l for l in colls["cross_pod_ops"]],
    "cross_pod_bytes": colls["cross_pod_bytes"],
    "total_bytes": colls["total_bytes"]}))
"""

#: the reference's five cases: (arch, kind, multi-pod)
CASES = {
    "llama-train-1pod": ("llama3.2-3b", "train", False),
    "zamba2-train-1pod": ("zamba2-2.7b", "train", False),
    "mixtral-train-1pod": ("mixtral-8x7b", "train", False),
    "llama-train-2pod": ("llama3.2-3b", "train", True),
    "llama-decode-1pod": ("llama3.2-3b", "decode", False),
}
#: the port's own cases beside the reference's: qwen2-vl-72b's
#: owner-parallel vision heads on the (2, 2, 2) mesh (and with the
#: vision owner's cut 8 longer than the text owner's: a ragged cut), and
#: xlstm-125m's train step, its mLSTM and sLSTM cores on each rank's
#: shards
PORT_CASES = {
    "qwen2-vl-train-2pod": ("qwen2-vl-72b", "train", True),
    "qwen2-vl-ragged-2pod": ("qwen2-vl-72b", "train", True),
    "xlstm-train-1pod": ("xlstm-125m", "train", False),
}
#: output leaves whose sharding the reference's compile chose itself (no
#: ``out_shardings``): zamba2's per-head Mamba2 vectors, replicated in
#: their specs, leave its step sharded over "model"
XLA_CHOSEN = {"zamba2-train-1pod": ("A_log']", "['D']", "dt_bias']",
                                    "['gate_norm']['scale']")}
#: the train steps' closed-form FLOPs case: reduced llama at 3 layers
FLOPS_LAYERS = 3


def _jobs():
    """(script, job) per subprocess: the port's traces in four
    processes of about equal work, the reference's compiles one process
    each."""
    one = {name: dict(name=name, arch=arch, kind=kind,
                      sizes=[2, 2, 2] if multi else [2, 4])
           for name, (arch, kind, multi) in {**CASES, **PORT_CASES}.items()}
    jobs = {
        ("port", "a"): (PORT, [one["llama-train-2pod"]]),
        ("port", "b"): (PORT, [dict(one["llama-train-2pod"], name="tdp",
                                    tdp=True)]),
        ("port", "c"): (PORT, [one["llama-train-1pod"],
                               one["llama-decode-1pod"],
                               one["mixtral-train-1pod"],
                               dict(one["llama-train-1pod"], name="one",
                                    sizes=[1, 1], n_layers=FLOPS_LAYERS)]),
        ("port", "d"): (PORT, [one["zamba2-train-1pod"]]),
        ("port", "e"): (PORT, [dict(one[name], ragged="ragged" in name)
                               for name in PORT_CASES]),
    }
    for name, (arch, kind, multi) in CASES.items():
        jobs[("ref", name)] = (REF, dict(arch=arch, kind=kind, multi=multi))
    return jobs


@pytest.fixture(scope="module")
def results():
    """Every trace's and compile's RESULT, by ("port" | "ref", name); the
    subprocesses run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(job)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, (script, job) in _jobs().items()}
    out, t0 = {}, time.time()
    for (side, key), p in procs.items():
        try:
            so, se = p.communicate(timeout=max(1, TIMEOUT - (time.time()
                                                             - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        lines = [x for x in so.splitlines() if x.startswith("RESULT ")]
        err = {"error": f"rc {p.returncode}\n{so[-2000:]}\n{se[-4000:]}"}
        res = json.loads(lines[-1][len("RESULT "):]) if lines else None
        if side == "ref":
            out[(side, key)] = res or err
        else:
            for job in _jobs()[(side, key)][1]:
                out[(side, job["name"])] = (res or {}).get(job["name"], err)
    return out


def _get(results, key):
    res = results[key]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("case", sorted(CASES) + sorted(PORT_CASES))
def test_dryrun_case_traces(results, case):
    """The reference's five cases and the port's own: FLOPs on every
    one, collectives on the multi-pod mesh, and every attention call of
    the step described on a card route (the xLSTM has none: no kernel
    at all)."""
    res = _get(results, ("port", case))
    assert res["cost"]["flops"] > 0
    arch, _, multi = {**CASES, **PORT_CASES}[case]
    stats = analysis.collective_stats(res["collectives"])
    if multi:
        assert stats["total_bytes"] > 0
    if arch == "xlstm-125m":
        assert res["kernels"] == {}
    else:
        assert sum(res["kernels"].values()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_argument_and_output_bytes_match_reference(results, case):
    """Per device: the port's argument bytes equal the reference's
    ``memory_analysis()`` exactly (the positions and the step index,
    ints in the port, counted as the 4-byte scalars the reference
    takes); its output bytes leaf by leaf equal the reference's output
    shardings' shards, where XLA kept an input's sharding for its next
    value, and equal its input shard everywhere (the port keeps the
    spec); ``XLA_CHOSEN`` names the leaves where XLA chose another
    output sharding of another size.  The
    reference's ``output_bytes`` is those leaves plus its output
    tuple's table, 8 bytes a leaf."""
    port = _get(results, ("port", case))
    want = _get(results, ("ref", case))
    assert port["memory"]["argument_bytes"] == \
        want["mem"]["argument_bytes"]
    rows = want["out_leaves"]
    assert want["mem"]["output_bytes"] == \
        sum(r["bytes"] for r in rows) + 8 * len(rows)
    got = port["out_leaf_bytes"]
    assert len(got) == len(rows)
    chosen = []
    for g, r in zip(got, rows):
        if r["input_bytes"] is None:
            assert g == r["bytes"], r["path"]
            continue
        assert g == r["input_bytes"], r["path"]
        if r["bytes"] != r["input_bytes"]:
            chosen.append(r["path"])
    assert port["memory"]["output_bytes"] == sum(got)
    expect = XLA_CHOSEN.get(case, ())
    assert all(any(c.endswith(e) for e in expect) for c in chosen), chosen
    assert bool(chosen) == bool(expect)


def _cross(res):
    return analysis.collective_stats(res["collectives"], 4)


@pytest.mark.parametrize("job", ["llama-train-2pod", "tdp",
                                 "qwen2-vl-train-2pod",
                                 "qwen2-vl-ragged-2pod"])
def test_only_the_cut_and_0d_reductions_cross_pods(results, job):
    """Claim C4 per collective on (2, 2, 2): every cross-pod record is
    the cut's (issued for "cut_stacked" or "combined") or a 0-d
    reduction; with ``trunk_dp_over_pod`` the trunk's gradient
    reductions over ("pod", "data") may cross too.  qwen2-vl-72b's
    vision and text owners run their heads each on its own pod; a
    ragged cut crosses as one padded gather at "cut_stacked"."""
    res = _get(results, ("port", job))
    stats = _cross(res)
    assert stats["cross_pod_bytes"] > 0
    cut = [r for r in stats["cross_pod_ops"]
           if r["site"] in ("cut_stacked", "combined")]
    assert cut
    for r in stats["cross_pod_ops"]:
        if r in cut or r["shape"] == []:
            continue
        assert job == "tdp" and r["kind"] in ("all-reduce",
                                              "reduce-scatter"), r
        assert r["dtype"] == "float32"      # the trunk's f32 gradients


def test_cut_bytes_equal_the_reference_cut_gather(results):
    """The reduced llama train step's cut crosses the pods once, as the
    reference's one cut all-gather (65,536 bytes): the same elements,
    gathered in bf16 by the port and in f32 by the reference (XLA:CPU
    normalises bf16 work to f32, the gather's operand a convert
    fusion), so the port's cut counts 65,536 at 4 bytes an element; the
    rest is f32[] reductions on both sides."""
    want = _get(results, ("ref", "llama-train-2pod"))
    gathers = [c for c in want["cross"] if "all-gather" in c]
    assert len(gathers) == 1 and "f32[2,2,16,256]" in gathers[0]
    ref_bytes = 2 * 2 * 16 * 256 * 4
    rest = want["cross_pod_bytes"] - ref_bytes
    assert rest == 4            # one f32[] all-reduce
    stats = _cross(_get(results, ("port", "llama-train-2pod")))
    cut = [r for r in stats["cross_pod_ops"]
           if r["site"] in ("cut_stacked", "combined")]
    assert [(r["kind"], r["dtype"]) for r in cut] == [("all-gather",
                                                       "bfloat16")]
    assert sum(analysis.shape_bytes("float32", r["shape"])
               for r in cut) == ref_bytes
    assert all(r["shape"] == [] and r["dtype"] == "float32"
               for r in stats["cross_pod_ops"] if r not in cut)


def test_train_flops_equal_a_closed_form_count(results):
    """On a one-device fake mesh the reduced dense train step's FLOPs
    are, exactly: 2·m·n·k for every product of the config's widths,
    forward and backward (dX and dW: three times the forward), the
    attention kernel's own count (4·B·nh·hd per live causal pair) and
    its backward's plain products (five of 2·B·nh·Sq·Skv·hd).  With
    ``remat`` (the config's default) every stack unit runs its forward
    again in the backward, up to the last tensor the backward reads
    (torch's early stop): every product but the FFN's down projection,
    whose output nothing saves, so the stack's products are four
    forwards' worth less one down projection a unit, and its kernel
    FLOPs and launches twice one forward's; the LM head, outside the
    stack, stays at three."""
    from repro_torch.configs import get_config
    res = _get(results, ("port", "one"))
    cfg = get_config("llama3.2-3b", reduced=True).replace(
        n_layers=FLOPS_LAYERS)
    S, B, P, L = 32, 4, cfg.split.n_owners, FLOPS_LAYERS
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    heads = min(max(cfg.split.cut_layer, 1), L - 1)     # units per head

    def block(T):
        return (2 * T * d * (cfg.q_dim + 2 * cfg.kv_dim)
                + 2 * T * cfg.q_dim * d + 3 * 2 * T * d * cfg.d_ff)

    assert cfg.remat
    S_p = S // P
    stack = P * heads * block(B * S_p) + (L - heads) * block(B * S)
    down = 2 * B * (P * heads * S_p + (L - heads) * S) * cfg.d_ff * d
    lm_head = 2 * B * S * d * cfg.vocab
    kernel = 4 * B * nh * hd * (P * heads * S_p * (S_p + 1) // 2
                                + (L - heads) * S * (S + 1) // 2)
    backward = 10 * B * nh * hd * (P * heads * S_p * S_p
                                   + (L - heads) * S * S)
    assert res["cost"]["kernel_flops"] == 2 * kernel
    assert res["cost"]["flops"] == \
        4 * stack - down + 3 * lm_head + 2 * kernel + backward
    # one card: no collective, every call on the decode route (Sq·g ≤ 64)
    assert res["collectives"] == []
    assert res["kernels"] == {"block_attention.decode": 2 * (P * heads
                                                             + (L - heads))}
    mem = res["memory"]
    assert mem["argument_bytes"] + mem["temp_bytes"] + \
        mem["output_bytes"] - mem["alias_bytes"] == res["peak_bytes"]


def test_dryrun_import_loads_no_jax_and_starts_no_group():
    code = ("import sys\nimport repro_torch.launch.dryrun\n"
            "import torch.distributed as dist\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "assert not (dist.is_available() and dist.is_initialized())\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_check_runnable_admits_the_fake_group_mesh_only():
    """A ``DeviceMesh`` over the fake group is the dry-run's and runs a
    step; one over a real (gloo) process group raises, even of one
    rank."""
    code = r"""
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch import dryrun
from repro_torch.sharding.specs import Mesh, check_runnable
with dryrun.fake_world(8):
    check_runnable(dryrun.fake_mesh((2, 4), ("data", "model")))
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    mesh = Mesh((1,), ("data",), device_mesh=DeviceMesh(
        "cpu", [0], mesh_dim_names=("data",)))
    try:
        check_runnable(mesh)
    except ValueError as e:
        assert "real process group" in str(e), e
    else:
        raise AssertionError("a gloo mesh ran")
finally:
    dist.destroy_process_group()
print("refused")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr


def test_skipped_combination_is_printed_and_written(tmp_path, capsys):
    """A shape the arch does not take (whisper-tiny has no long context)
    is reported and written as "skipped", with its mesh, so a census
    reads every combination's status from its file; no process group is
    started for it."""
    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                 "--both-meshes", "--reduced", "--out", str(tmp_path)])
    printed = capsys.readouterr().out
    for mesh in ("16x16", "2x16x16"):
        rec = json.loads((tmp_path / f"whisper-tiny_long_500k_{mesh}.json")
                         .read_text())
        assert rec["status"] == "skipped" and rec["mesh"] == mesh
        assert f"[{mesh}] whisper-tiny x long_500k: skipped" in printed
