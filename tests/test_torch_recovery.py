"""Supervised crash recovery in the port (``fit(supervise=True)``) against
the JAX reference, on thread owners over the queue backend: fault plans
and their env strings, the injector, CRC-checked frames with drop,
corrupt and delay faults, a second thread draining one endpoint, the
supervisor's heartbeats and restart budget, and recovered fits equal to
the fault-free run bit for bit.  The spawned-worker cases are in
``test_torch_recovery_process.py``.  CPU only, at the reference's sizes
(``tests/test_recovery.py``: 300 subjects, 6 steps of 64).
"""
import dataclasses
import os
import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import faults as ref_faults
from repro.federation import feature_parties as ref_feature_parties
from repro_torch.configs import CONFIG
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import (FrameCorrupt, OwnerFailure, Supervisor,
                                    VerticalSession, faults,
                                    feature_parties, transport)
from repro_torch.federation.process_transport import process_endpoint_pair
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

# several xdist workers share one CPU
torch.set_num_threads(1)

STEPS = 6
FIT = dict(steps=STEPS, batch_size=64, verbose=False, mode="split")
SUM_CFG = dataclasses.replace(CONFIG, split=dataclasses.replace(
    CONFIG.split, combine="sum"))

#: the reference's chaos matrix (tests/test_recovery.py)
FIT_FAULTS = {
    "crash_fwd": dict(party="owner0", action="crash", kind="head_fwd",
                      occurrence=None, step=3),
    "wedge_fwd": dict(party="owner0", action="wedge", kind="head_fwd",
                      occurrence=None, step=3),
    "corrupt_frame": dict(party="owner0", action="corrupt_frame",
                          kind="cut_activations", occurrence=4),
}
CRASH = FIT_FAULTS["crash_fwd"]


def plan_env(*faults_kw):
    return faults.FaultPlan([faults.Fault(**kw) for kw in faults_kw]
                            ).to_env()


def session(cfg=CONFIG, params=None):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        300, seed=0, keep_frac=0.9)), device="cpu")
    s.resolve(group="modp512")
    s.build(cfg, params=params)
    return s


def fit(backend, env=None, *, cfg=CONFIG, supervise=True, timeout=15.0,
        **kw):
    """One split fit under the chaos plan ``env`` (set and cleared
    here); returns the session and its loss trail.  ``timeout=None``
    leaves the fit's own default (120 s)."""
    if timeout is not None:
        kw["timeout"] = timeout
    with pytest.MonkeyPatch.context() as mp:
        if env:
            mp.setenv(faults.CHAOS_ENV, env)
        else:
            mp.delenv(faults.CHAOS_ENV, raising=False)
        s = session(cfg)
        h = s.fit(**FIT, backend=backend, supervise=supervise, **kw)
    assert faults.CHAOS_ENV not in os.environ
    return s, h["loss_trail"]


def same_run(a, b):
    """Params and loss trail bit for bit."""
    (sa, la), (sb, lb) = a, b
    assert la == lb
    pa, pb = tree_leaves(sa.params), tree_leaves(sb.params)
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)


def events(s):
    return [(e["party"], e["action"], e["step"]) for e in s.recovery_events]


_CLEAN: dict = {}


def clean(backend, cfg=CONFIG, **kw):
    """The fault-free supervised run, once per (backend, config, kw)."""
    key = (backend, cfg, tuple(sorted(kw.items())))
    if key not in _CLEAN:
        _CLEAN[key] = fit(backend, cfg=cfg, **kw)
        assert _CLEAN[key][0].recovery_events == []
    return _CLEAN[key]


# ---------------------------------------------------------------------------
# fault plans and the injector, against the reference's
# ---------------------------------------------------------------------------

PLANS = {
    "legacy": [dict(party="owner0", action="crash", kind="head_fwd")],
    "multi": [dict(party="owner0", action="crash", kind="head_fwd"),
              dict(party="owner1", action="wedge",
                   kind="psi_blind_chunk")],
    "json": [dict(party="owner0", action="corrupt_frame",
                  kind="cut_activations", occurrence=3, gen=0),
             dict(party="owner1", action="delay", kind="head_fwd", step=2,
                  delay_s=0.1)],
    "matrix": list(FIT_FAULTS.values()),
    "every_gen": [dict(CRASH, gen=None)],
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_env_strings_equal_reference(name):
    """The same plan gives the reference's env string, and each package
    parses the other's string back to the same faults."""
    ours = faults.FaultPlan([faults.Fault(**kw) for kw in PLANS[name]])
    ref = ref_faults.FaultPlan([ref_faults.Fault(**kw)
                                for kw in PLANS[name]])
    env = ours.to_env()
    assert env == ref.to_env()
    assert faults.FaultPlan.from_env(env) == ours
    assert [dataclasses.asdict(f) for f in
            ref_faults.FaultPlan.from_env(env)] == \
        [dataclasses.asdict(f) for f in ours]
    if name == "legacy":
        assert env == "owner0:crash_fwd"
    if name == "multi":
        assert env == "owner0:crash_fwd,owner1:wedge_psi"
    if name == "json":
        assert env.startswith("json:")


@pytest.mark.parametrize("spec", [
    "owner0:nonsense, ,owner1:crash_fwd", "", "  ", "owner0:crash_fwd,",
    "owner2:wedge_fwd,owner0:explode"])
def test_unknown_legacy_tokens_are_inert_as_in_reference(spec):
    ours = [dataclasses.asdict(f) for f in faults.FaultPlan.from_env(spec)]
    ref = [dataclasses.asdict(f)
           for f in ref_faults.FaultPlan.from_env(spec)]
    assert ours == ref


def test_unknown_fault_action_raises():
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.Fault("owner0", "explode")


# (kind, seq) events seen by one party, in order
EVENTS = [("head_fwd", 0), ("k", 0), ("k", 5), ("k2", 3), ("k2", 7),
          ("k2", 7), ("k3", 0), ("cut_activations", 0),
          ("cut_activations", 1), ("head_fwd", 1), ("cut_activations", 2),
          ("head_fwd", 2), ("head_fwd", 3), ("cut_activations", 3),
          ("head_fwd", 3), ("k", 9), ("cut_activations", 4)]
INJECTOR_PLAN = [
    dict(party="o", action="crash", kind="k", occurrence=1),
    dict(party="o", action="crash", kind="k2", occurrence=None, step=7),
    dict(party="o", action="wedge", kind="k3", gen=1),
    dict(party="o", action="crash", kind="head_fwd", occurrence=None,
         step=3, gen=None),
    dict(party="o", action="corrupt_frame", kind="cut_activations",
         occurrence=2),
    dict(party="o", action="delay", kind="cut_activations", step=3,
         occurrence=None, delay_s=0.25, gen=1),
    dict(party="o", action="drop_frame", kind="head_fwd", occurrence=1),
    dict(party="other", action="crash", kind="k", occurrence=None),
]


@pytest.mark.parametrize("party", ["o", "other", "nobody"])
@pytest.mark.parametrize("generation", [0, 1])
def test_injector_fires_on_the_reference_events(party, generation):
    ours = faults.FaultInjector(faults.FaultPlan(
        [faults.Fault(**kw) for kw in INJECTOR_PLAN]), party, generation)
    ref = ref_faults.FaultInjector(ref_faults.FaultPlan(
        [ref_faults.Fault(**kw) for kw in INJECTOR_PLAN]), party,
        generation)
    got = [(ours.actor_fault(k, s), ours.wire_fault(k, s))
           for k, s in EVENTS]
    want = [(ref.actor_fault(k, s), ref.wire_fault(k, s))
            for k, s in EVENTS]
    assert got == want
    assert (ours.has_actor_faults, ours.has_wire_faults) == \
        (ref.has_actor_faults, ref.has_wire_faults)
    if party == "o":
        assert any(a for a, _ in got) and any(w for _, w in got)


def test_arm_actor_crashes_and_leaves_other_kinds():
    class Actor:
        def handle(self, msg):
            return msg.kind

    plan = faults.FaultPlan([faults.Fault("owner0", "crash", "head_fwd",
                                          occurrence=None, step=3)])
    a = faults.arm_actor(Actor(), "owner0", plan=plan)
    msg = transport.Message("scientist", "owner0", "head_fwd", {}, seq=2)
    assert a.handle(msg) == "head_fwd"
    with pytest.raises(RuntimeError,
                       match="chaos: injected crash in owner0 on head_fwd"):
        a.handle(dataclasses.replace(msg, seq=3))
    unarmed = Actor()
    assert faults.arm_actor(unarmed, "owner1", plan=plan) is unarmed


# ---------------------------------------------------------------------------
# the wire: CRCs, drop / corrupt / delay, routing, two waiting threads
# ---------------------------------------------------------------------------


def pair(backend):
    """(scientist end, owner end) of a queue channel pair or an
    in-process pipe pair; the owner end is the one that sends cuts."""
    if backend == "queue":
        return transport.channel_pair("scientist", "owner0")
    own, sci = process_endpoint_pair("owner0", "scientist")
    return sci, own


def close(*eps):
    for ep in eps:
        if hasattr(ep, "close"):
            ep.close()


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_corrupt_frame_raises_and_is_routed_to_its_kind(backend):
    """A byte flipped after the CRC: the receiver of that kind gets
    ``FrameCorrupt`` naming kind, seq and sender; a receiver of another
    kind is not disturbed; ``flush_pending`` clears a routed marker;
    clean traffic flows afterwards.  Byte counts do not include the
    CRC."""
    sci, own = pair(backend)
    try:
        faults.arm_endpoint(own, "owner0", plan=faults.FaultPlan([
            faults.Fault("owner0", "corrupt_frame", "cut_activations",
                         occurrence=0)]))
        x = {"x": np.arange(6, dtype=np.float32)}
        own.send("cut_activations", x, seq=0)
        own.send("step_done", {}, seq=0)
        assert sci.recv_kind("step_done", timeout=5.0).seq == 0
        with pytest.raises(FrameCorrupt) as info:
            sci.recv_kind("cut_activations", timeout=5.0)
        e = info.value
        assert (e.kind, e.seq, e.sender, e.receiver) == \
            ("cut_activations", 0, "owner0", "scientist")
        assert isinstance(e, RuntimeError) and "crc32" in str(e)
        own.send("cut_activations", x, seq=1)
        own.send("cut_activations", x, seq=2)
        m = sci.recv_kind("cut_activations", timeout=5.0)
        assert m.seq == 1 and np.array_equal(m.payload["x"], x["x"])
        # a routed marker and a stashed frame: both flushed
        faults.arm_endpoint(own, "owner0", plan=faults.FaultPlan([
            faults.Fault("owner0", "corrupt_frame", "barrier_ack")]))
        own.send("barrier_ack", {}, seq=-1)
        own.send("heartbeat_ack", {}, seq=1)
        assert sci.recv_kind("cut_activations", timeout=5.0).seq == 2
        sci.recv_kind("heartbeat_ack", timeout=5.0)
        own.send("params_dump", {}, seq=-1)
        time.sleep(0.05)
        with pytest.raises(queue.Empty):
            sci.recv_kind("step_done", timeout=0.2)   # stashes the dump
        sci.flush_pending()
        with pytest.raises(queue.Empty):
            sci.recv_kind("barrier_ack", timeout=0.2)
        with pytest.raises(queue.Empty):
            sci.recv_kind("params_dump", timeout=0.2)
        blob = transport._pack(x)
        assert own.sent_stats["by_kind"]["cut_activations"] == {
            "count": 3, "payload_bytes": 3 * 24,
            "wire_bytes": 3 * len(blob)}
    finally:
        close(sci, own)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_dropped_frame_is_lost_and_counted(backend):
    sci, own = pair(backend)
    try:
        faults.arm_endpoint(own, "owner0", plan=faults.FaultPlan([
            faults.Fault("owner0", "drop_frame", "cut_activations",
                         occurrence=1)]))
        for seq in range(3):
            own.send("cut_activations", {"x": np.zeros(2, np.float32)},
                     seq=seq)
        got = [sci.recv_kind("cut_activations", timeout=5.0).seq
               for _ in range(2)]
        assert got == [0, 2]
        with pytest.raises(queue.Empty):
            sci.recv_kind("cut_activations", timeout=0.2)
        assert own.sent_stats["dropped_frames"] == 1
        assert own.sent_stats["by_kind"]["cut_activations"]["count"] == 3
    finally:
        close(sci, own)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_delayed_frame_waits_out_its_deadline(backend):
    sci, own = pair(backend)
    try:
        faults.arm_endpoint(own, "owner0", plan=faults.FaultPlan([
            faults.Fault("owner0", "delay", "cut_activations",
                         delay_s=0.3)]))
        t0 = time.monotonic()
        own.send("cut_activations", {"x": np.ones(3, np.float32)}, seq=0)
        m = sci.recv_kind("cut_activations", timeout=5.0)
        assert time.monotonic() - t0 >= 0.3
        assert m.not_before > 0 and np.array_equal(m.payload["x"],
                                                   np.ones(3, np.float32))
        t0 = time.monotonic()
        own.send("cut_activations", {"x": np.ones(3, np.float32)}, seq=1)
        assert sci.recv_kind("cut_activations", timeout=5.0).seq == 1
        assert time.monotonic() - t0 < 0.3
    finally:
        close(sci, own)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_heartbeat_thread_and_step_loop_share_an_endpoint(backend):
    """The supervisor's thread drains ``heartbeat_ack`` while the main
    thread waits on ``cut_activations`` on the same endpoint: no frame
    is lost, each thread gets its own kind in order, and the sender's
    accounting (two sending threads) is exact."""
    sci, own = pair(backend)
    n = 60
    acks, errors = [], []

    def sender(kind, gap):
        for i in range(n):
            own.send(kind, {"x": np.full(4, i, np.float32)}, seq=i)
            time.sleep(gap)

    def drain():
        try:
            while len(acks) < n:
                try:
                    acks.append(sci.recv_kind("heartbeat_ack",
                                              timeout=0.02).seq)
                except queue.Empty:
                    pass
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=sender, args=a, daemon=True)
               for a in (("heartbeat_ack", 0.001), ("cut_activations",
                                                    0.0015))]
    threads.append(threading.Thread(target=drain, daemon=True))
    try:
        for th in threads:
            th.start()
        cuts = [sci.recv_kind("cut_activations", timeout=5.0).seq
                for _ in range(n)]
        for th in threads:
            th.join(timeout=10.0)
        assert not errors
        assert cuts == list(range(n)) and acks == list(range(n))
        st = own.sent_stats
        assert st["messages"] == 2 * n
        assert {k: v["count"] for k, v in st["by_kind"].items()} == \
            {"heartbeat_ack": n, "cut_activations": n}
    finally:
        close(sci, own)


# ---------------------------------------------------------------------------
# the supervisor (mirrors tests/test_recovery.py)
# ---------------------------------------------------------------------------


def _echo_actor(ep, stop):
    while not stop.is_set():
        try:
            m = ep.recv_kind("heartbeat", timeout=0.05)
        except queue.Empty:
            continue
        ep.send("heartbeat_ack", {}, seq=m.seq)


def test_supervisor_heartbeats_and_wedge_suspicion():
    sci, own = transport.channel_pair("scientist", "owner0")
    stop = threading.Event()
    th = threading.Thread(target=_echo_actor, args=(own, stop),
                          daemon=True)
    th.start()
    sup = Supervisor(heartbeat_s=0.02, miss_limit=3)
    sup.attach("owner0", sci, None)
    sup.start()
    try:
        time.sleep(0.3)
        assert sup.stats["heartbeats_sent"] >= 3
        assert sup.stats["heartbeat_acks"] >= 1
        assert "owner0" not in sup.failed
        stop.set()                       # wedge: the actor stops answering
        deadline = time.monotonic() + 5.0
        while "owner0" not in sup.failed and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "owner0" in sup.failed
        assert "unresponsive" in str(sup.failed["owner0"])
        assert sup.stats["suspected"] == 1
    finally:
        sup.stop()
        stop.set()
        th.join(timeout=5.0)


def test_supervisor_condemns_a_worker_error_and_a_dead_pipe():
    class Dead:
        error = RuntimeError("boom")

    sci, _ = transport.channel_pair("scientist", "owner0")
    a, b = process_endpoint_pair("scientist", "owner1")
    a.close()
    sup = Supervisor(heartbeat_s=0.01)
    sup.attach("owner0", sci, Dead())
    sup.attach("owner1", a, None)
    sup._tick(1)
    assert str(sup.failed["owner0"]) == "boom"
    assert "closed" in str(sup.failed["owner1"])
    assert sup.stats["suspected"] == 2
    sup.attach("owner0", sci, None)          # re-adopted on attach
    assert "owner0" not in sup.failed
    b.close()


def test_supervisor_restart_budget_and_backoff():
    sup = Supervisor(max_restarts=2, backoff_base_s=0.01,
                     backoff_cap_s=0.02)
    sup.failed["o"] = RuntimeError("boom")
    d0 = sup.plan_restart("o")
    assert "o" not in sup.failed         # re-adopted
    assert sup.restarts("o") == 1
    d1 = sup.plan_restart("o")
    assert d0 == pytest.approx(0.01) and d1 == pytest.approx(0.02)
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        sup.plan_restart("o")
    assert sup.stats["respawns"] == 2


def test_join_or_warn_flags_leaked_thread():
    """The reference's ``tests/test_recovery.py`` case on the port: a
    thread that outlives its join window is a loud leak (a RuntimeWarning
    and a ``leak_stats`` bump, a False return), and a thread that ends
    returns True and counts nothing; both packages count alike."""
    import warnings
    from repro.federation import session as ref_session
    from repro_torch.federation import session as port_session
    for mod in (port_session, ref_session):
        ev = threading.Event()
        th = threading.Thread(target=ev.wait, daemon=True, name="wedged")
        th.start()
        before = mod.leak_stats["leaked_threads"]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert mod._join_or_warn(th, 0.05, "test") is False
        assert mod.leak_stats["leaked_threads"] == before + 1
        assert any("leaked" in str(x.message) for x in w)
        ev.set()
        th.join(timeout=5.0)
        ok = threading.Thread(target=lambda: None)
        ok.start()
        assert mod._join_or_warn(ok, 5.0, "test") is True
        assert mod.leak_stats["leaked_threads"] == before + 1


# ---------------------------------------------------------------------------
# supervised fits on thread owners over the queue
# ---------------------------------------------------------------------------


def test_fault_free_supervised_equals_unsupervised():
    """Markers, snapshot acks and heartbeats (every 10 ms here, so they
    interleave with the protocol) leave the arithmetic as it is: params
    and loss trail bit for bit, no recovery event."""
    unsup = fit("queue", supervise=False)
    sup = fit("queue", heartbeat_s=0.01)
    same_run(sup, unsup)
    s = sup[0]
    assert s.recovery_events == []
    ts = s.transport_stats
    assert ts["recoveries"] == 0 and unsup[0].transport_stats[
        "supervisor"] is None
    assert ts["supervisor"]["heartbeat_acks"] > 0
    assert ts["supervisor"]["suspected"] == 0
    wk = ts["wire_by_kind"]
    # one marker per step, each acked with 2 x (392*64 + 64) f32 leaves
    assert wk["snapshot"]["count"] == 2 * STEPS
    assert wk["snapshot_ack"]["payload_bytes"] == \
        2 * STEPS * 4 * (392 * 64 + 64)
    for k, v in unsup[0].transport_stats["wire_by_kind"].items():
        assert wk[k] == v


@pytest.mark.parametrize("fault", sorted(FIT_FAULTS))
def test_chaos_matrix_queue_recovers_bitwise(fault):
    ref = clean("queue")
    got = fit("queue", plan_env(FIT_FAULTS[fault]),
              timeout=3.0 if fault == "wedge_fwd" else 15.0)
    s = got[0]
    assert events(s) == [("owner0", "rollback" if fault == "corrupt_frame"
                          else "respawn", 4 if fault == "corrupt_frame"
                          else 2)]
    same_run(got, ref)
    ts = s.transport_stats
    assert ts["recoveries"] == 1 and ts["supervisor"]["respawns"] == 1


def test_wedge_is_caught_by_heartbeats_long_before_the_timeout():
    """With the fit's default timeout (120 s) and heartbeat period
    (0.5 s), the supervisor's verdict fails the receive from the wedged
    owner after 8 missed periods: the owner is respawned in seconds, not
    at the timeout, and the run equals the fault-free one."""
    t = time.monotonic()
    got = fit("queue", plan_env(FIT_FAULTS["wedge_fwd"]), timeout=None)
    wall = time.monotonic() - t
    s = got[0]
    assert events(s) == [("owner0", "respawn", 2)]
    assert "unresponsive" in s.recovery_events[0]["error"]
    assert s.transport_stats["supervisor"]["suspected"] == 1
    assert wall < 30.0
    same_run(got, clean("queue"))


def test_supervisor_verdict_is_tied_to_the_registration():
    """A verdict reached on a party's old registration (a heartbeat tick
    that outlives the detach of a dead owner) does not condemn the owner
    that replaces it; a detach drops a pending verdict."""
    class Dead:
        error = RuntimeError("boom")

    a, _ = transport.channel_pair("scientist", "owner0")
    b, _ = transport.channel_pair("scientist", "owner0")
    sup = Supervisor()
    sup.attach("owner0", a, Dead())
    old = sup._parties["owner0"]
    sup._tick(1)
    assert "owner0" in sup.failed
    sup.detach("owner0")
    assert "owner0" not in sup.failed
    sup.attach("owner0", b, None)
    sup._condemn("owner0", old, RuntimeError("stale"))
    assert "owner0" not in sup.failed and sup.stats["suspected"] == 1


@pytest.mark.parametrize("fault", ["crash_fwd", "corrupt_frame"])
def test_recovery_event_equals_reference(fault):
    """The reference's supervised fit under the same plan and data
    records the same (party, action, step)."""
    env = plan_env(FIT_FAULTS[fault])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ref_faults.CHAOS_ENV, env)
        ref = RefSession(*ref_feature_parties(*ref_parties(
            300, seed=0, keep_frac=0.9)))
        ref.resolve(group="modp512")
        ref.build(REF_CFG)
        ref.fit(**FIT, backend="queue", supervise=True, timeout=15.0)
    ours = fit("queue", env)[0]
    assert events(ours) == events(ref) != []


def test_fault_free_supervised_fit_matches_reference():
    """From the reference's initial params: the loss trail within rtol
    1e-4 of the reference's supervised fit (per-step f32 differences
    compound, as in test_torch_session's joint comparison) and the same
    recovery record (none)."""
    ref = RefSession(*ref_feature_parties(*ref_parties(
        300, seed=0, keep_frac=0.9)))
    ref.resolve(group="modp512")
    ref.build(REF_CFG)
    start = jax.tree.map(np.asarray, ref.params)
    hr = ref.fit(**FIT, backend="queue", supervise=True, timeout=15.0)
    ours = session(params=from_reference(start))
    h = ours.fit(**FIT, backend="queue", supervise=True, timeout=15.0)
    np.testing.assert_allclose(h["loss_trail"],
                               [r["loss"] for r in hr["train"]], rtol=1e-4)
    for a, b in zip(tree_leaves(ours.params),
                    jax.tree_util.tree_leaves(ref.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert ours.recovery_events == ref.recovery_events == []
    assert ours.transport_stats["recoveries"] == \
        ref.transport_stats["recoveries"]


@pytest.mark.parametrize("case", ["int8", "microbatches", "masked_sum",
                                  "resync_every", "sequential"])
def test_crash_recovers_bitwise_on_other_schedules(case):
    """A crash at step 3 on the queue recovers to the fault-free
    supervised run bit for bit with the int8 codec (the quantize kernel's
    plain version on every cut, replays included), in 4 microbatches, on
    the masked sum trunk (the respawned owner's masks, generation 1,
    still cancel), with markers every 2 steps, and in the sequential
    schedule."""
    cfg, kw = CONFIG, {}
    if case == "int8":
        kw = dict(compression="int8")
    elif case == "microbatches":
        kw = dict(microbatches=4)
    elif case == "masked_sum":
        cfg, kw = SUM_CFG, dict(aggregation="masked_sum")
    elif case == "resync_every":
        kw = dict(resync_every=2)
    else:
        kw = dict(schedule="sequential")
    ref = clean("queue", cfg, **kw)
    got = fit("queue", plan_env(CRASH), cfg=cfg, **kw)
    assert [e[1] for e in events(got[0])] == ["respawn"]
    same_run(got, ref)
    if case == "masked_sum":
        assert got[0].transport_stats["aggregation"] == "masked_sum"


def test_failed_respawn_is_started_again_within_the_budget():
    """The generation-1 owner crashes in its warmup: a generation-2
    owner takes its place (two restarts charged), and the run still
    equals the fault-free one."""
    env = plan_env(CRASH, dict(party="owner0", action="crash",
                               kind="warmup", gen=1))
    got = fit("queue", env)
    same_run(got, clean("queue"))
    assert events(got[0]) == [("owner0", "respawn", 2)]
    assert got[0].transport_stats["supervisor"]["respawns"] == 2


def test_restart_budget_exhaustion_surfaces():
    """An owner that crashes in every generation burns the budget and
    the fit fails loudly."""
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        fit("queue", plan_env(dict(CRASH, gen=None)), max_restarts=1)


def test_a_failure_that_is_not_an_owners_is_not_recovered(monkeypatch):
    """Recovery is not a fallback: an error in the scientist's own trunk
    program propagates from a supervised fit with no recovery."""
    s = session()
    cutgrad, weightgrad = s.adapter.trunk_microbatch_programs()
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("trunk kernel failed")
        return cutgrad(*a)

    monkeypatch.setattr(s.adapter, "trunk_microbatch_programs",
                        lambda: (failing, weightgrad))
    with pytest.raises(RuntimeError, match="trunk kernel failed"):
        s.fit(**FIT, backend="queue", supervise=True)
    assert s.recovery_events == []


def test_unsupervised_failures_keep_their_messages():
    """Without supervision a crash surfaces as before: the owner's
    failure, an ``OwnerFailure`` naming the party."""
    with pytest.raises(OwnerFailure,
                       match="owner worker 'owner0' failed") as info:
        fit("queue", plan_env(CRASH), supervise=False)
    assert info.value.party == "owner0"
    assert "injected crash" in str(info.value.__cause__)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="joint"), "requires mode='split'"),
    (dict(mode="split", backend="direct"), "requires a wire backend"),
    (dict(mode="split", resync_every=0), "resync_every must be >= 1")])
def test_supervise_value_errors(kw, match):
    s = session()
    with pytest.raises(ValueError, match=match):
        s.fit(steps=1, batch_size=16, verbose=False, supervise=True, **kw)
