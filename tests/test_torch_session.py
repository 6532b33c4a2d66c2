"""The port's training path end to end against the JAX reference:
PSI resolution and alignment, joint and split fits from shared params,
the microbatched (GPipe) schedule, the wire's per-kind byte accounting,
split == joint bitwise inside the port, and the process backend (owners
in spawned worker processes) == the queue backend bitwise.  CPU only, at
n=400 rows as the reference's transport tests.
"""
import multiprocessing
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import feature_parties as ref_feature_parties
from repro.federation import transport as ref_transport
from repro_torch.configs import CONFIG
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties
from repro_torch.federation import transport
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

N = 400
FIT = dict(epochs=2, batch_size=64, eval_frac=0.1, verbose=False)


def _ref_session(n=N):
    s = RefSession(*ref_feature_parties(*ref_parties(n, seed=0,
                                                     keep_frac=0.9)))
    s.resolve(group="modp512")
    s.build(REF_CFG)
    return s


def _session(n=N, params=None):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device="cpu")
    s.resolve(group="modp512")
    s.build(CONFIG, params=params)
    return s


@pytest.fixture(scope="module")
def ref_params():
    """The reference session's initial params as numpy leaves."""
    return jax.tree.map(np.asarray, _ref_session().params)


def _same(p1, p2):
    return all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


def test_resolve_matches_reference():
    """Same intersection, same aligned row order on every party, and the
    same PSI byte counts (exponent secrets differ; sizes do not)."""
    ours, ref = _session(), _ref_session()
    assert ours.scientist.ids == ref.scientist.ids
    assert np.array_equal(ours.scientist.labels, ref.scientist.labels)
    for o, r in zip(ours.owners, ref.owners):
        assert o.ids == r.ids
        assert np.array_equal(o._features, r._features)
    a, b = ours.resolve_stats, ref.resolve_stats
    assert a["global_intersection"] == b["global_intersection"]
    keys = ("owner", "intersection_size", "client_upload_bytes",
            "server_response_bytes", "server_set_bytes", "n_chunks",
            "blind_cached")
    assert [{k: r[k] for k in keys} for r in a["rounds"]] == \
        [{k: r[k] for k in keys} for r in b["rounds"]]
    kinds = lambda s: [(m["from"], m["to"], m["kind"], m.get("bytes"))
                       for m in s.transcript]
    assert kinds(ours) == kinds(ref)


def test_joint_fit_matches_reference(ref_params):
    """Two joint epochs from shared params: the per-epoch loss trail and
    eval metrics within rtol=1e-4 — per-step f32 differences (~1e-6,
    see test_torch_splitnn) compound over 8 SGD steps."""
    ref = _ref_session()
    hr = ref.fit(**FIT)
    ours = _session(params=from_reference(ref_params))
    h = ours.fit(**FIT)
    np.testing.assert_allclose([r["loss"] for r in h["train"]],
                               [r["loss"] for r in hr["train"]], rtol=1e-4)
    np.testing.assert_allclose([r["loss"] for r in h["eval"]],
                               [r["loss"] for r in hr["eval"]], rtol=1e-4)
    steps_per_epoch = (len(ours._train_idx) - 64) // 64 + 1
    assert len(h["loss_trail"]) == 2 * steps_per_epoch


def test_split_int8_fit_matches_reference(ref_params):
    """Split fit with the int8 codec over the queue backend: final val
    accuracy within 0.02 and loss within 2e-2 of the reference (a tiny
    cut difference can move a value across a quantization step, and the
    run compounds it), and per-owner wire bytes and message counts
    exactly equal — the frames are the reference's."""
    kw = dict(FIT, mode="split", compression="int8", backend="queue")
    ref = _ref_session()
    hr = ref.fit(**kw)
    ours = _session(params=from_reference(ref_params))
    h = ours.fit(**kw)
    assert abs(h["final"]["val_accuracy"]
               - hr["final"]["val_accuracy"]) <= 0.02
    assert abs(h["final"]["loss"] - hr["final"]["loss"]) <= 2e-2
    assert abs(h["final"]["val_loss"] - hr["final"]["val_loss"]) <= 2e-2
    assert ours.transport_stats["per_owner"] == \
        ref.transport_stats["per_owner"]
    for k in ("steps", "cut_payload_bytes_per_step", "total_payload_bytes",
              "total_wire_bytes"):
        assert ours.transport_stats[k] == ref.transport_stats[k]


@pytest.mark.parametrize("schedule,backend", [
    ("pipelined", "queue"), ("sequential", "queue"), ("pipelined", "direct")])
def test_split_equals_joint_bitwise(ref_params, schedule, backend):
    """Inside the port, lossless split training reproduces the joint
    path's params, loss trail and eval metrics bit for bit."""
    joint = _session(params=from_reference(ref_params))
    hj = joint.fit(**FIT)
    split = _session(params=from_reference(ref_params))
    hs = split.fit(**FIT, mode="split", schedule=schedule, backend=backend)
    assert _same(joint.params, split.params)
    assert hs["loss_trail"] == hj["loss_trail"]
    assert hs["eval"] == hj["eval"]
    assert split.transport_stats["steps"] == len(hj["loss_trail"])


def test_measured_bytes_match_analytic():
    s = _session()
    s.fit(**dict(FIT, epochs=1), mode="split")
    steps = s.transport_stats["steps"]
    analytic = s.cut_traffic(64, bytes_per_el=4)
    for per in s.transport_stats["per_owner"].values():
        assert per["cut_payload_bytes"] == \
            analytic["per_owner_forward_bytes"] * steps
        assert per["grad_payload_bytes"] == \
            analytic["per_owner_backward_bytes"] * steps


def test_session_without_device_needs_a_card():
    """No device given: the card, or an error — never the CPU quietly."""
    sci, owners = feature_parties(*make_vertical_mnist_parties(
        50, seed=0))
    if torch.cuda.is_available():
        assert VerticalSession(sci, owners).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VerticalSession(sci, owners)


def test_wire_frames_equal_reference():
    """``_pack`` writes the reference's frame byte for byte, from numpy
    arrays and from tensors alike; channel accounting per kind is the
    reference's."""
    rng = np.random.default_rng(0)
    payload = {"f32": rng.normal(size=(7, 33)).astype(np.float32),
               "i8": rng.integers(-127, 127, (5, 4, 3)).astype(np.int8),
               "idx": np.arange(11, dtype=np.int32),
               "h": rng.normal(size=(4, 8)).astype(np.float16),
               "scalar": np.float32(3.5)}
    ref = ref_transport._pack(payload)
    assert transport._pack(payload) == ref
    as_tensors = {k: torch.from_numpy(np.array(v)) for k, v in
                  payload.items()}
    assert transport._pack(as_tensors) == ref
    back = transport._unpack(ref)
    for k, v in payload.items():           # 0-d values cross as 1-d
        assert np.array_equal(back[k], np.atleast_1d(v))
        assert back[k].dtype == v.dtype
    stats = []
    for mod in (transport, ref_transport):
        a, b = mod.channel_pair("sci", "own", backend="queue")
        a.send("head_fwd", {"idx": np.arange(64, dtype=np.int32)}, seq=0)
        a.send("cut_gradients", {"x": payload["f32"]}, seq=0)
        b.recv(), b.recv()
        stats.append(a.sent_stats)
    assert stats[0] == stats[1]


def test_direct_backend_hands_tensors_over():
    a, b = transport.channel_pair("sci", "own", backend="direct")
    t = torch.arange(6.0)
    a.send("cut_activations", {"x": t}, seq=3)
    m = b.recv_kind("cut_activations")
    assert m.payload["x"] is t and m.seq == 3 and m.wire_bytes == 24


# ---------------------------------------------------------------------------
# Microbatches (GPipe chunks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 4])
def test_microbatched_joint_fit_matches_reference(ref_params, M):
    """The microbatched joint oracle from shared params against the
    reference's ``fit(mode="joint", microbatches=M)``: per-epoch train
    and eval losses within rtol=1e-4, as the whole-batch fit above."""
    kw = dict(FIT, microbatches=M)
    hr = _ref_session().fit(**kw)
    h = _session(params=from_reference(ref_params)).fit(**kw)
    np.testing.assert_allclose([r["loss"] for r in h["train"]],
                               [r["loss"] for r in hr["train"]], rtol=1e-4)
    np.testing.assert_allclose([r["loss"] for r in h["eval"]],
                               [r["loss"] for r in hr["eval"]], rtol=1e-4)
    np.testing.assert_allclose([r["accuracy"] for r in h["eval"]],
                               [r["accuracy"] for r in hr["eval"]],
                               atol=1e-6)


@pytest.mark.parametrize("M,backend", [(2, "queue"), (4, "direct")])
def test_split_microbatched_equals_joint_microbatched_bitwise(
        ref_params, M, backend):
    """Split pipelined execution in M chunks reproduces the microbatched
    joint oracle's params, loss trail and eval metrics bit for bit, and
    ships M cut frames per owner per step."""
    kw = dict(FIT, microbatches=M)
    joint = _session(params=from_reference(ref_params))
    hj = joint.fit(**kw)
    split = _session(params=from_reference(ref_params))
    hs = split.fit(**kw, mode="split", backend=backend)
    assert _same(joint.params, split.params)
    assert hs["loss_trail"] == hj["loss_trail"]
    assert hs["eval"] == hj["eval"]
    ts = split.transport_stats
    assert ts["microbatches"] == M
    assert ts["wire_by_kind"]["cut_activations"]["count"] == \
        len(split.owners) * M * ts["steps"]
    # the chunks add up to the whole-batch step (to rounding)
    whole = _session(params=from_reference(ref_params)).fit(**FIT)
    np.testing.assert_allclose(hj["loss_trail"], whole["loss_trail"],
                               rtol=1e-5)


def test_microbatches_must_divide_the_batch():
    s = _session(120)
    with pytest.raises(ValueError, match="must divide"):
        s.fit(epochs=1, batch_size=32, verbose=False, microbatches=3)
    with pytest.raises(ValueError, match="must be >= 1"):
        s.fit(epochs=1, batch_size=32, verbose=False, microbatches=0)


def test_microbatches_need_the_pipelined_schedule():
    s = _session(120)
    with pytest.raises(ValueError, match="requires the pipelined"):
        s.fit(epochs=1, batch_size=32, verbose=False, mode="split",
              schedule="sequential", microbatches=2)


# ---------------------------------------------------------------------------
# The process backend: owners in spawned worker processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,compression", [(2, None), (1, "int8")])
def test_process_backend_equals_queue_bitwise(ref_params, M, compression):
    """Owners in spawned worker processes reproduce the thread-backed
    queue run bit for bit: params, loss trail and eval metrics; and the
    wire's bytes by kind are the queue backend's on every kind the queue
    run has (the frames are the same ``_pack`` blobs).  The process run
    adds only the session's param pulls (``pull_params`` /
    ``params_dump``), which a thread worker does not need."""
    kw = dict(FIT, epochs=1, mode="split", microbatches=M,
              compression=compression)
    queue_s = _session(params=from_reference(ref_params))
    hq = queue_s.fit(**kw, backend="queue")
    proc_s = _session(params=from_reference(ref_params))
    hp = proc_s.fit(**kw, backend="process")
    assert _same(queue_s.params, proc_s.params)
    assert hp["loss_trail"] == hq["loss_trail"]
    assert hp["eval"] == hq["eval"]
    wq = queue_s.transport_stats["wire_by_kind"]
    wp = proc_s.transport_stats["wire_by_kind"]
    assert {k: wp[k] for k in wq} == wq
    assert set(wp) - set(wq) == {"pull_params", "params_dump"}
    for k in ("total_wire_bytes", "total_payload_bytes"):
        assert proc_s.transport_stats[k] == queue_s.transport_stats[k]
    cut_keys = ("cut_payload_bytes", "cut_wire_bytes", "grad_payload_bytes",
                "grad_wire_bytes")
    for name, per in queue_s.transport_stats["per_owner"].items():
        got = proc_s.transport_stats["per_owner"][name]
        assert {k: got[k] for k in cut_keys} == {k: per[k] for k in cut_keys}
    assert proc_s.transport_stats["backend"] == "process"
    assert not multiprocessing.active_children()


def test_process_worker_exception_surfaces_in_parent():
    """A worker that throws (here: an owner whose staged features lost a
    column, so its head product fails inside the child) ships its error
    and traceback; the parent raises it as the owner's failure instead
    of hanging, and no worker process outlives the fit."""
    from repro_torch.core.resolution import VerticalDataset
    s = _session(120)
    bad = s.owners[1]
    bad._vd = VerticalDataset(bad.ids, bad._features[:, 1:])
    with pytest.raises(RuntimeError, match="owner worker 'owner1' failed") \
            as info:
        s.fit(epochs=1, batch_size=32, verbose=False, mode="split",
              backend="process", timeout=60.0)
    cause = str(info.value.__cause__)
    assert "died" in cause and "remote traceback" in cause
    assert not multiprocessing.active_children()


def test_spawned_owner_workers_import_no_jax_and_no_reference():
    """A process-backend fit in a fresh interpreter, then a supervised
    one whose owner0 crashes at step 3 and is respawned: neither the
    session nor any spawned owner worker, the respawned one included,
    imports jax or any ``repro`` module (``-X importtime`` passes to
    the spawned children, and every process's imports land on the
    shared stderr)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import os\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"        # the workers take the same
        "from repro_torch.configs import CONFIG\n"
        "from repro_torch.data import make_vertical_mnist_parties\n"
        "from repro_torch.federation import VerticalSession, "
        "feature_parties\n"
        "s = VerticalSession(*feature_parties(*make_vertical_mnist_parties("
        "120, seed=0)), device='cpu')\n"
        "s.resolve(group='modp512')\n"
        "s.build(CONFIG)\n"
        "s.fit(epochs=1, batch_size=32, mode='split', backend='process', "
        "verbose=False)\n"
        "print('steps', s.transport_stats['steps'])\n"
        "from repro_torch.federation import faults\n"
        "os.environ[faults.CHAOS_ENV] = faults.FaultPlan([faults.Fault("
        "'owner0', 'crash', 'head_fwd', occurrence=None, step=3)]).to_env()\n"
        "s.fit(steps=6, batch_size=32, mode='split', backend='process', "
        "verbose=False, supervise=True)\n"
        "print('events', [(e['party'], e['action'], e['step']) "
        "for e in s.recovery_events])\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    env.pop("REPRO_CHAOS_PARTY", None)
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", code],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("steps")
    assert "events [('owner0', 'respawn', 2)]" in out.stdout
    mods = [line.rsplit("|", 1)[-1].strip()
            for line in out.stderr.splitlines()
            if line.startswith("import time:")]
    bad = sorted({m for m in mods if m.split(".")[0] in ("jax", "repro")})
    assert not bad, bad
    # the parent, both workers of each fit and the respawned worker
    # imported the worker's module
    assert mods.count("repro_torch.federation.runtime") == 6


def test_process_endpoint_error_frame_and_closed_pipe():
    """The pipe endpoint: frames carry the queue backend's byte counts;
    a peer's error frame raises (and keeps raising) with its traceback;
    a closed pipe raises instead of blocking."""
    from repro_torch.federation.process_transport import (
        process_endpoint_pair)
    a, b = process_endpoint_pair("owner0", "scientist")
    q_a, q_b = transport.channel_pair("owner0", "scientist",
                                      backend="queue")
    try:
        payload = {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}
        for ep, far in ((a, b), (q_a, q_b)):
            ep.send("cut_activations", payload, seq=5)
            ep.send("barrier_ack", {}, seq=-1)
            m = far.recv_kind("barrier_ack", timeout=5.0)
            assert m.seq == -1
            m = far.recv_kind("cut_activations", timeout=5.0)
            assert m.seq == 5
            assert np.array_equal(m.payload["x"], payload["x"])
        assert a.sent_stats == q_a.sent_stats
        assert b.recv_stats == q_b.recv_stats
        try:
            raise ValueError("owner-side failure")
        except ValueError as e:
            a.send_error(e, "tb-line-1\ntb-line-2")
        for _ in range(2):
            with pytest.raises(RuntimeError,
                               match="died: ValueError: owner-side"):
                b.recv(timeout=5.0)
        assert "tb-line-2" in str(b.peer_error)
    finally:
        a.close()
        b.close()
    c, d = process_endpoint_pair("owner0", "scientist")
    c.close()
    try:
        with pytest.raises(RuntimeError, match="connection .* closed"):
            d.recv(timeout=5.0)
    finally:
        d.close()
