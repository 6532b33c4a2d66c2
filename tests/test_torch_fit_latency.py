"""Injected wire latency and bandwidth on the port's ``fit``, and the
delivery wait under it, on the CPU: the spin margin and its
``REPRO_SPIN_WAIT_S`` override (the reference's test), the wait's
structure (one coarse sleep, then a spin that yields, only inside the
margin), a fit with latency and bandwidth equal to the same fit without
them bit for bit on the queue and process backends for every schedule,
each steady step at or above its round trips, ``log_every``, and the two
packages' ``fit`` taking the same parameters.
"""
import inspect
import multiprocessing

import numpy as np
import pytest
import torch

from repro.federation import VerticalSession as RefSession
from repro_torch.configs import CONFIG
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import (VerticalSession, feature_parties,
                                    process_transport, transport)
from repro_torch.tree import tree_leaves

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

LATENCY = 4e-3
BANDWIDTH = 5e7                 # bytes/s: ~0.17 ms per 8 KB cut frame
FIT = dict(steps=5, batch_size=32, eval_frac=0.1, verbose=False,
           mode="split")


# ---------------------------------------------------------------------------
# the delivery wait
# ---------------------------------------------------------------------------


def test_spin_wait_env_override(monkeypatch):
    """``REPRO_SPIN_WAIT_S`` overrides the spin margin; garbage or
    negative values fall back to the core-count default; channels and
    process endpoints read it at construction."""
    default = (transport.SPIN_WAIT_S if transport._effective_cores() > 1
               else transport.SPIN_WAIT_SINGLE_CORE_S)
    monkeypatch.delenv("REPRO_SPIN_WAIT_S", raising=False)
    assert transport.spin_wait_s() == default
    monkeypatch.setenv("REPRO_SPIN_WAIT_S", "0.0125")
    assert transport.spin_wait_s() == 0.0125
    a, b = process_transport.process_endpoint_pair("a", "b")
    try:
        assert a.spin_s == b.spin_s == 0.0125
    finally:
        a.close()
        b.close()
    ch_a, ch_b = transport.channel_pair("a", "b", backend="queue")
    assert ch_a.outbox.spin_s == ch_b.outbox.spin_s == 0.0125
    ch_a, _ = transport.channel_pair("a", "b", spin_s=0.0)
    assert ch_a.outbox.spin_s == 0.0
    monkeypatch.setenv("REPRO_SPIN_WAIT_S", "not-a-float")
    assert transport.spin_wait_s() == default
    monkeypatch.setenv("REPRO_SPIN_WAIT_S", "-3.0")
    assert transport.spin_wait_s() == default


class _Clock:
    """A fake ``time`` for ``transport``: ``sleep(d)`` advances the clock
    by ``d`` plus ``slack`` (a kernel's timer overshoot), and by at least
    ``tick`` (``sleep(0)`` too); every call is recorded with the time
    left to the deadline.  Times are powers of two, exact in binary."""

    def __init__(self, deadline, slack=0.0, tick=2.0 ** -17):
        self.now, self.deadline = 0.0, deadline
        self.slack, self.tick = slack, tick
        self.calls = []

    def monotonic(self):
        return self.now

    def sleep(self, d):
        self.calls.append((d, self.deadline - self.now))
        self.now += max(d + self.slack, self.tick)


@pytest.mark.parametrize("spin_s", [2.0 ** -9, 2.0 ** -11])
def test_wait_until_sleeps_then_spins(monkeypatch, spin_s):
    """One coarse sleep to ``spin_s`` before the deadline, then only
    ``sleep(0)`` passes (each yields the interpreter lock), all inside
    the last ``spin_s``, ending at the deadline, not before."""
    clock = _Clock(deadline=2.0 ** -7)
    monkeypatch.setattr(transport, "time", clock)
    transport.wait_until(clock.deadline, spin_s)
    coarse, spins = clock.calls[0], clock.calls[1:]
    assert coarse[0] == clock.deadline - spin_s
    assert spins and all(d == 0 for d, _ in spins)
    assert all(0 < left <= spin_s + 1e-12 for _, left in spins)
    assert clock.deadline <= clock.now < clock.deadline + clock.tick


def test_wait_until_edges(monkeypatch):
    """A deadline already past costs no sleep; a coarse sleep that
    overshoots the deadline ends the wait with no spin; ``spin_s=0`` is
    the sleep alone; a deadline inside the margin is all spin."""
    spin = 2.0 ** -9
    clock = _Clock(deadline=-1.0)
    monkeypatch.setattr(transport, "time", clock)
    transport.wait_until(clock.deadline, spin)
    assert clock.calls == []
    clock = _Clock(deadline=2.0 ** -7, slack=2.0 ** -8)
    monkeypatch.setattr(transport, "time", clock)
    transport.wait_until(clock.deadline, spin)
    assert [d for d, _ in clock.calls] == [2.0 ** -7 - spin]
    clock = _Clock(deadline=2.0 ** -7)
    monkeypatch.setattr(transport, "time", clock)
    transport.wait_until(clock.deadline, 0.0)
    assert [d for d, _ in clock.calls] == [2.0 ** -7]
    clock = _Clock(deadline=2.0 ** -10)
    monkeypatch.setattr(transport, "time", clock)
    transport.wait_until(clock.deadline, spin)
    assert clock.calls and all(d == 0 for d, _ in clock.calls)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_frames_arrive_at_or_after_their_deadline(backend):
    """Each frame of a ping-pong at 4 ms one-way is received no earlier
    than its ``not_before``, which is its send time plus the latency and
    its bytes over the bandwidth."""
    if backend == "queue":
        a, b = transport.channel_pair("a", "b", latency_s=LATENCY,
                                      bandwidth_bps=BANDWIDTH)
    else:
        a, b = process_transport.process_endpoint_pair(
            "a", "b", latency_s=LATENCY, bandwidth_bps=BANDWIDTH)
    try:
        x = np.zeros((32, 64), np.float32)
        for i in range(5):
            sent = transport.time.monotonic()
            msg = a.send("ping", {"x": x}, seq=i)
            got = b.recv(timeout=10.0)
            now = transport.time.monotonic()
            assert got.seq == i and now >= msg.not_before
            assert msg.not_before >= sent + LATENCY + \
                msg.wire_bytes / BANDWIDTH
    finally:
        if backend == "process":
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# fit with latency and bandwidth
# ---------------------------------------------------------------------------


def _session(n=240):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device="cpu")
    s.resolve(group="modp512")
    s.build(CONFIG)
    return s


@pytest.fixture(scope="module")
def baseline():
    """The same fit on the queue without latency, run once per schedule:
    ``baseline(schedule, microbatches) -> (param leaves, loss trail,
    eval)``."""
    runs = {}

    def get(schedule, microbatches):
        if (schedule, microbatches) not in runs:
            s = _session()
            h = s.fit(**FIT, backend="queue", schedule=schedule,
                      microbatches=microbatches)
            runs[schedule, microbatches] = (tree_leaves(s.params),
                                            h["loss_trail"], h["eval"])
        return runs[schedule, microbatches]
    return get


@pytest.mark.parametrize("backend", ["queue", "process"])
@pytest.mark.parametrize("schedule,microbatches,rtts", [
    ("pipelined", 1, 1), ("sequential", 1, 2), ("pipelined", 2, 1)])
def test_latency_leaves_the_fit_bitwise(baseline, backend, schedule,
                                        microbatches, rtts):
    """A fit at 4 ms one-way and 50 MB/s equals the same fit without
    them, bit for bit (params, loss trail, eval), thread owners and
    spawned workers alike (process == queue without latency is
    tests/test_torch_session.py's); its steady step is at least one
    round trip (2 x latency) pipelined and two sequential; and
    ``transport_stats`` records both values."""
    params, trail, ev = baseline(schedule, microbatches)
    s = _session()
    h = s.fit(**FIT, backend=backend, schedule=schedule,
              microbatches=microbatches, latency_s=LATENCY,
              bandwidth_bps=BANDWIDTH)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s.params),
                                                  params))
    assert h["loss_trail"] == trail and h["eval"] == ev
    ts = s.transport_stats
    assert ts["latency_s"] == LATENCY and ts["bandwidth_bps"] == BANDWIDTH
    assert ts["steady_step_ms"] >= 1e3 * 2 * LATENCY * rtts
    assert not multiprocessing.active_children()


def test_supervised_crash_under_latency_recovers_bitwise(monkeypatch):
    """A crashed thread owner respawns onto a channel with the fit's
    latency, and the recovered run equals the fault-free one at the same
    latency, bit for bit."""
    from repro_torch.federation import faults
    kw = dict(FIT, steps=6, backend="queue", supervise=True,
              latency_s=LATENCY)
    clean = _session()
    hc = clean.fit(**kw)
    with monkeypatch.context() as m:
        m.setenv(faults.CHAOS_ENV, faults.FaultPlan([faults.Fault(
            "owner0", "crash", "head_fwd", occurrence=None,
            step=3)]).to_env())
        s = _session()
        h = s.fit(**kw)
    assert [(e["party"], e["action"], e["step"])
            for e in s.recovery_events] == [("owner0", "respawn", 2)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s.params),
                                                  tree_leaves(clean.params)))
    assert h["loss_trail"] == hc["loss_trail"]


def test_no_latency_recorded_as_zero():
    s = _session()
    s.fit(**dict(FIT, steps=2), backend="queue")
    assert s.transport_stats["latency_s"] == 0.0
    assert s.transport_stats["bandwidth_bps"] is None


@pytest.mark.parametrize("kw", [dict(latency_s=1e-3),
                                dict(bandwidth_bps=1e6)])
def test_latency_needs_a_wire_backend(kw):
    """The reference's ValueError: latency and bandwidth model a wire."""
    s = _session()
    with pytest.raises(ValueError, match="wire backend"):
        s.fit(**FIT, backend="direct", **kw)


def test_fit_takes_every_parameter_of_the_reference():
    ours = inspect.signature(VerticalSession.fit).parameters
    ref = inspect.signature(RefSession.fit).parameters
    assert list(ours) == list(ref)
    for name, p in ref.items():
        assert ours[name].kind == p.kind
        assert ours[name].default == p.default, name


# ---------------------------------------------------------------------------
# log_every
# ---------------------------------------------------------------------------


def test_log_every(capsys):
    """Epochs: a line every ``log_every`` epochs and at the last (every
    epoch by default); steps: a line every ``log_every`` steps and at the
    last, none when it is unset."""
    s = _session()
    kw = dict(batch_size=64, eval_frac=0.1)
    s.fit(epochs=3, log_every=2, **kw)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    s.fit(epochs=2, **kw)
    assert len(capsys.readouterr().out.splitlines()) == 2
    s.fit(steps=7, log_every=3, **kw, mode="split")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "3", "6"]
    assert "loss=" in lines[0]
    s.fit(steps=4, **kw)
    assert capsys.readouterr().out == ""
