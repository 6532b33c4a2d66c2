"""Wire-native PSI in the port against the JAX package's, on the CPU:
the golden frames byte for byte, live traffic parsed by the reference
tests' own independent frame parser, and every frame of every round —
full, repeat, delta, hidden, server churn — equal to the reference's
with both sides' secrets set equal; then the protocol's loud failures
(desync, crash, timeout, malformed hello).
"""
import importlib.util
import pathlib
import threading
import time
import types

import numpy as np
import pytest

from repro.core import psi as ref_psi
from repro.federation import psi_transport as ref_pt
from repro.federation import transport as ref_transport
from repro.testing.hypo import given, settings, strategies as st
from repro_torch.core import psi
from repro_torch.federation import psi_transport as pt
from repro_torch.federation import transport

GROUP = "modp512"
NB = psi.GROUPS[GROUP][2]


def _reference_tests():
    """The reference's wire tests as a module: its golden frames, the
    payloads they were frozen from, and its independent frame parser."""
    path = pathlib.Path(__file__).with_name("test_psi_transport.py")
    spec = importlib.util.spec_from_file_location("_ref_psi_wire", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def test_golden_frames_byte_exact():
    for kind, payload in REF._canonical_payloads().items():
        assert transport._pack(payload).hex() == REF.GOLDEN_FRAMES[kind], \
            kind


def test_golden_frames_parse_and_round_trip():
    for kind, payload in REF._canonical_payloads().items():
        blob = bytes.fromhex(REF.GOLDEN_FRAMES[kind])
        assert [e[0] for e in REF._parse_frame(blob)] == list(payload)
        back = transport._unpack(blob)
        assert set(back) == set(payload)
        for name in payload:
            np.testing.assert_array_equal(np.asarray(back[name]),
                                          np.asarray(payload[name]))
            assert back[name].dtype == np.asarray(payload[name]).dtype


def test_protocol_kinds_equal_reference():
    assert pt.CLIENT_KINDS == ref_pt.CLIENT_KINDS
    assert pt.SERVER_KINDS == ref_pt.SERVER_KINDS
    assert pt.ZERO_TAG == ref_pt.ZERO_TAG


# ---------------------------------------------------------------------------
# twin rounds: the port and the reference on the same inputs and secrets
# ---------------------------------------------------------------------------


class _Twin:
    """One client and one owner actor per package, the port's secrets
    set to the reference's, every frame captured by sender."""

    def __init__(self, xs, ys, mode="noinv", latency_s=0.0):
        self.rc = ref_psi.PSIClient(xs, GROUP, mode=mode)
        self.c = psi.PSIClient(xs, GROUP, mode=mode)
        self.c._blind_exp = self.rc._blind_exp
        self.c._unblind_exp = self.rc._unblind_exp
        rs = ref_psi.PSIServer(ys, group=GROUP)
        s = psi.PSIServer(ys, group=GROUP, beta=rs._beta)
        self.frames = {"port": [], "ref": []}
        self.sides = {}
        for side, mod, srv in (("port", transport, s),
                               ("ref", ref_transport, rs)):
            cap = self.frames[side]
            ep_c, ep_s = mod.channel_pair(
                "scientist", "owner0", backend="queue",
                latency_s=latency_s,
                tap=lambda m, b, cap=cap: cap.append(
                    (m.sender, m.kind, m.seq, b)))
            serve = pt.serve_psi if side == "port" else ref_pt.serve_psi
            worker, th = serve("owner0", srv, ep_s)
            self.sides[side] = (ep_c, worker, th)

    def round(self, chunk_size):
        """One round on both; returns the port's (result, stats) after
        checking them, the frames and the op counts against the
        reference's."""
        marks = {k: len(v) for k, v in self.frames.items()}
        out = {}
        for side, cli, wrp in (("port", self.c, pt.wire_psi_round),
                               ("ref", self.rc, ref_pt.wire_psi_round)):
            ep_c, worker, _ = self.sides[side]
            out[side] = wrp(cli, ep_c, worker=worker,
                            chunk_size=chunk_size, timeout=60.0)
        assert out["port"] == out["ref"]
        assert self.c.ops == self.rc.ops
        assert self.c.round_cache.keys() == self.rc.round_cache.keys()
        for sender in ("scientist", "owner0"):
            got, want = ([f for f in self.frames[k][marks[k]:]
                          if f[0] == sender] for k in ("port", "ref"))
            assert got == want, sender
        for _, kind, _, blob in self.frames["port"][marks["port"]:]:
            REF._parse_frame(blob)          # the independent parser
        return out["port"]

    def update(self, xs):
        self.c.update_items(xs)
        self.rc.update_items(xs)

    def close(self):
        for ep_c, _, th in self.sides.values():
            ep_c.send("psi_stop", {})
            th.join(timeout=10.0)


@given(st.lists(st.text(min_size=1, max_size=8), min_size=0, max_size=40),
       st.lists(st.text(min_size=1, max_size=8), min_size=0, max_size=40),
       st.integers(1, 17), st.sampled_from(list(psi.MODES)))
@settings(max_examples=10, deadline=None)
def test_wire_round_frames_equal_reference(xs, ys, chunk, mode):
    """Random uneven sets with duplicates, every mode, any chunk size:
    every frame each side sends equals the reference's byte for byte,
    and the result equals the in-process engine's."""
    twin = _Twin(xs, ys, mode)
    try:
        got, stats = twin.round(chunk)
    finally:
        twin.close()
    inproc, _ = psi.psi_round(psi.PSIClient(xs, GROUP, mode=mode),
                              psi.PSIServer(ys, group=GROUP),
                              chunk_size=chunk)
    assert got == inproc
    assert stats["client_upload_bytes"] == NB * len(xs)


@pytest.mark.parametrize("mode", psi.MODES)
@pytest.mark.parametrize("churn", ["churn", "remove_only", "full_churn",
                                   "duplicates", "unchanged"])
def test_repeat_and_delta_rounds_equal_reference(mode, churn):
    """A first round, an unchanged repeat (hello-only), then the
    client's churn: every frame (the delta chunk and its ack, the keep
    mask), every stats flag and op count equal the reference's."""
    xs = [f"id-{i}" for i in range(90)] + ["dup"]
    ys = [f"id-{i + 30}" for i in range(90)] + ["dup", "dup"]
    new = {"churn": xs[3:] + ["fresh-0", "fresh-1", "fresh-2"],
           "remove_only": xs[10:],
           "full_churn": [f"id-{i + 500}" for i in range(40)],
           "duplicates": xs[2:] + ["dup", "id-40"],
           "unchanged": list(xs)}[churn]
    twin = _Twin(xs, ys, mode)
    try:
        twin.round(16)
        _, st2 = twin.round(16)
        assert st2["upload_skipped"] and st2["modexp_ops"] == 0
        twin.update(new)
        got, st3 = twin.round(16)
    finally:
        twin.close()
    delta = churn not in ("full_churn", "unchanged") and mode != "bloom"
    assert st3["delta_used"] == delta
    if churn == "churn" and mode == "noinv":
        # O(Δ): 3 fresh client blinds (at update) + 3 server responses
        assert st3["server_modexp_ops"] == 3
        assert st3["client_modexp_ops"] == 0
    if mode != "hidden":
        ref, _ = psi.psi_round(psi.PSIClient(list(twin.c.items), GROUP),
                               psi.PSIServer(ys, group=GROUP),
                               chunk_size=16)
        assert got == ref


def test_server_churn_invalidates_the_response_leg():
    """The owner's population churns between rounds: the leg's tag
    changes, the client re-downloads it, only new items are blinded,
    and every frame equals the reference's."""
    xs = [f"c{i}" for i in range(40)]
    twin = _Twin(xs, [f"c{i}" for i in range(20, 60)])
    try:
        twin.round(8)
        for side in ("port", "ref"):
            twin.sides[side][1].server.update_items(
                [f"c{i}" for i in range(10, 50)])
        got, st2 = twin.round(8)
    finally:
        twin.close()
    assert not st2["server_leg_skipped"]
    assert sorted(got) == sorted(f"c{i}" for i in range(10, 40))


def test_live_traffic_conforms_to_frame_schema():
    """Every frame of a live noinv round, through the reference's
    independent parser, against the documented entry schema."""
    twin = _Twin([f"id-{i}" for i in range(20)],
                 [f"id-{i + 5}" for i in range(20)])
    try:
        twin.round(4)
    finally:
        twin.close()
    schema = {
        "psi_hello": [("mode", "uint8"), ("group", "uint8"),
                      ("blind_tag", "uint8"), ("base_tag", "uint8"),
                      ("server_tag", "uint8"), ("have_resp", "uint8"),
                      ("n_items", "int64"), ("chunk_size", "int64"),
                      ("nb", "int64")],
        "psi_hello_ack": [("blind_cached", "uint8"), ("delta_ok", "uint8"),
                          ("server_cached", "uint8"),
                          ("server_tag", "uint8"),
                          ("n_server_items", "int64"),
                          ("n_server_chunks", "int64")],
        "psi_blind_chunk": [("data", "uint8"), ("base", "int64")],
        "psi_server_set_chunk": [("data", "uint8"), ("base", "int64")],
        "psi_double_chunk": [("data", "uint8"), ("base", "int64")],
        "psi_done": [("n_chunks", "int64"), ("modexp_ops", "int64")],
        "psi_stop": []}
    seen = set()
    for _, kind, _, blob in twin.frames["port"]:
        seen.add(kind)
        assert [(e[0], e[1]) for e in REF._parse_frame(blob)] == \
            schema[kind], kind
    assert set(schema) == seen


def test_latency_delays_every_frame_without_changing_bytes():
    """``latency_s`` on the channel: the round waits for it and its
    frames stay the reference's."""
    twin = _Twin([f"id-{i}" for i in range(30)],
                 [f"id-{i + 10}" for i in range(30)], latency_s=0.02)
    try:
        t0 = time.monotonic()
        twin.round(8)
        assert time.monotonic() - t0 > 0.04
    finally:
        twin.close()


def test_hidden_mode_wire_indistinguishable_member_vs_nonmember():
    ys = [f"id-{i}" for i in range(30)]
    base = [f"id-{i}" for i in range(10)] + [f"out-{i}" for i in range(9)]
    profiles = []
    for probe in ("id-20", "out-99"):
        twin = _Twin(base + [probe], ys, "hidden")
        try:
            _, stats = twin.round(8)
        finally:
            twin.close()
        prof = {}
        for _, k, _, b in twin.frames["port"]:
            prof.setdefault(k, []).append(len(b))
        profiles.append(({k: sorted(v) for k, v in prof.items()},
                         stats["hidden_kept"]))
    assert profiles[0] == profiles[1]
    assert "psi_double_chunk" not in profiles[0][0]


# ---------------------------------------------------------------------------
# loud failures
# ---------------------------------------------------------------------------


def _serve(xs, ys, wrap=None, mode="noinv"):
    client = psi.PSIClient(xs, GROUP, mode=mode)
    ep_c, ep_s = transport.channel_pair("scientist", "owner0",
                                        backend="queue")
    worker = pt.PSIServerEndpoint(
        "owner0", psi.PSIServer(ys, group=GROUP),
        ep_s if wrap is None else wrap(ep_s))
    th = threading.Thread(target=worker.run, daemon=True)
    th.start()
    return client, ep_c, worker, th


@pytest.mark.parametrize("kind", ["psi_double_chunk",
                                  "psi_server_set_chunk"])
def test_reordered_chunks_raise_clean_desync(kind):
    client, ep_c, worker, th = _serve(
        [f"id-{i}" for i in range(60)], [f"id-{i + 20}" for i in range(60)],
        wrap=lambda ep: REF._ScramblingEndpoint(ep, kind))
    try:
        with pytest.raises(RuntimeError, match="desync"):
            pt.wire_psi_round(client, ep_c, worker=worker, chunk_size=8,
                              timeout=30.0)
        assert not client.round_cache       # untouched on failure
    finally:
        ep_c.send("psi_stop", {})
        th.join(timeout=10.0)


def test_desynchronized_kind_arrival_still_exact():
    xs = [f"id-{i}" for i in range(50)] + ["dup"] * 2
    ys = [f"id-{i + 15}" for i in range(50)] + ["dup"]
    ref, _ = psi.psi_round(psi.PSIClient(xs, GROUP),
                           psi.PSIServer(ys, group=GROUP), chunk_size=8)
    client, ep_c, worker, th = _serve(
        xs, ys, wrap=lambda ep: REF._DelayingEndpoint(
            ep, "psi_server_set_chunk"))
    try:
        inter, _ = pt.wire_psi_round(client, ep_c, worker=worker,
                                     chunk_size=8, timeout=30.0)
    finally:
        ep_c.send("psi_stop", {})
        th.join(timeout=10.0)
    assert inter == ref


def test_owner_crash_mid_round_surfaces_cleanly(monkeypatch):
    calls = {"n": 0}
    real = psi.PSIServer.respond_chunk

    def flaky(self, packed):
        calls["n"] += 1
        if calls["n"] > 1:
            raise ValueError("owner-side kaboom")
        return real(self, packed)

    monkeypatch.setattr(psi.PSIServer, "respond_chunk", flaky)
    client, ep_c, worker, th = _serve([f"id-{i}" for i in range(60)],
                                      [f"id-{i + 20}" for i in range(60)])
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="PSI owner worker 'owner0'"):
            pt.wire_psi_round(client, ep_c, worker=worker, chunk_size=8,
                              timeout=60.0)
    finally:
        ep_c.send("psi_stop", {})
        th.join(timeout=10.0)
    assert time.monotonic() - t0 < 30.0


def test_unresponsive_owner_times_out_cleanly():
    client = psi.PSIClient(["a", "b"], GROUP)
    ep_c, _ = transport.channel_pair("scientist", "owner0", backend="queue")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        pt.wire_psi_round(client, ep_c, chunk_size=1, timeout=2.5)
    assert 2.0 < time.monotonic() - t0 < 10.0


def test_group_mismatch_surfaces_cleanly():
    client = psi.PSIClient(["a", "b"], "modp512")
    ep_c, ep_s = transport.channel_pair("scientist", "owner0",
                                        backend="queue")
    worker, th = pt.serve_psi("owner0", psi.PSIServer(
        ["b", "c"], group="modp2048"), ep_s)
    try:
        with pytest.raises(RuntimeError, match="PSI owner worker"):
            pt.wire_psi_round(client, ep_c, worker=worker, chunk_size=1,
                              timeout=30.0)
        assert "mismatch" in repr(worker.error)
    finally:
        ep_c.send("psi_stop", {})
        th.join(timeout=10.0)


def test_owner_endpoint_rejects_malformed_protocol():
    server = psi.PSIServer([f"s{i}" for i in range(4)], group=GROUP)
    ep_c, ep_s = transport.channel_pair("scientist", "owner0",
                                        backend="queue")
    worker = pt.PSIServerEndpoint("owner0", server, ep_s)
    u8 = pt._u8

    def msg(kind, payload=None, seq=0):
        return types.SimpleNamespace(kind=kind, payload=payload or {},
                                     seq=seq)

    def hello(**over):
        pl = {"mode": u8(b"noinv"), "group": u8(GROUP.encode()),
              "blind_tag": u8(b"x" * 16), "base_tag": u8(pt.ZERO_TAG),
              "server_tag": u8(pt.ZERO_TAG), "have_resp": np.uint8(0),
              "n_items": np.int64(4), "chunk_size": np.int64(2),
              "nb": np.int64(NB)}
        pl.update(over)
        return msg("psi_hello", pl)

    with pytest.raises(RuntimeError, match="unknown message kind"):
        worker.handle(msg("not_a_psi_kind"))
    with pytest.raises(RuntimeError, match="unknown PSI mode"):
        worker.handle(hello(mode=u8(b"nonsense")))
    with pytest.raises(RuntimeError, match="element width mismatch"):
        worker.handle(hello(nb=np.int64(1)))
    with pytest.raises(RuntimeError, match="chunk_size must be positive"):
        worker.handle(hello(chunk_size=np.int64(0)))
    with pytest.raises(RuntimeError, match="delta chunk without"):
        worker.handle(msg("psi_delta_chunk", {
            "data": u8(b""), "removed": np.array([], np.int64),
            "n_retained": np.int64(0)}))
    with pytest.raises(RuntimeError, match="lift chunk outside"):
        worker.handle(msg("psi_lift_chunk",
                          {"data": u8(b""), "base": np.int64(0)}))
    with pytest.raises(RuntimeError, match="blind chunk outside"):
        worker.handle(msg("psi_blind_chunk",
                          {"data": u8(b""), "base": np.int64(0)}))
    assert worker.handle(msg("heartbeat", seq=7))
    ack = ep_c.recv(timeout=5.0)
    assert ack.kind == "heartbeat_ack" and ack.seq == 7


def test_stale_delta_base_fails_loudly():
    """A delta whose splice does not reproduce the advertised upload is
    refused by the owner (never a silent misalignment)."""
    xs = [f"id-{i}" for i in range(40)]
    client, ep_c, worker, th = _serve(xs, [f"id-{i}" for i in range(20, 60)])
    try:
        pt.wire_psi_round(client, ep_c, worker=worker, chunk_size=8)
    finally:
        ep_c.send("psi_stop", {})
        th.join(timeout=10.0)
    base = psi.blind_tag(client._blinded_packed)
    u8 = pt._u8
    worker.handle(types.SimpleNamespace(kind="psi_hello", seq=0, payload={
        "mode": u8(b"noinv"), "group": u8(GROUP.encode()),
        "blind_tag": u8(b"y" * 16), "base_tag": u8(base),
        "server_tag": u8(pt.ZERO_TAG), "have_resp": np.uint8(0),
        "n_items": np.int64(39), "chunk_size": np.int64(8),
        "nb": np.int64(NB)}))
    with pytest.raises(RuntimeError, match="delta splice does not match"):
        worker.handle(types.SimpleNamespace(
            kind="psi_delta_chunk", seq=0, payload={
                "data": u8(b""), "removed": np.array([0], np.int64),
                "n_retained": np.int64(39)}))
