"""The rest of the port's LM serving against the JAX reference's, on the
CPU: continuous batching, the process transport, injected latency, the
repeat-entity cut cache, multiplexed sessions (``ServingService``,
``ScopedEndpoint``), degraded service, the process endpoint's tap and
duplicate dropping, and ``VerticalSession.serve`` / ``serve_dataset``.

llama3.2-3b reduced (2 layers: one head unit per owner, one trunk unit),
f32 compute, contexts of 32, at most 6 new tokens, params from the
reference's (``weights.from_reference``).  The port is held to the
reference's function outputs (greedy tokens, cut bytes, stats), and to
its own contracts: continuous == wave tokens bit for bit on every
transport, process == queue in tokens and cut bytes.  The edge cases
follow the reference's ``tests/test_serving.py`` and
``tests/test_engine.py``.
"""
import queue as queue_mod
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import make_token_dataset as ref_make_token_dataset
from repro.federation import batching as ref_batching
from repro.federation import process_transport as ref_pt
from repro.federation.parties import sequence_parties as ref_seq_parties
from repro.federation.session import VerticalSession as RefSession
from repro.launch.engine import CutCache as RefCutCache
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.core import vertical
from repro_torch.data import make_token_dataset
from repro_torch.federation import batching, process_transport
from repro_torch.federation import VerticalSession, sequence_parties
from repro_torch.federation.transport import ScopedEndpoint, channel_pair
from repro_torch.launch.engine import (CutCache, QueueFull, ServingEngine,
                                       ServingService)
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

torch.set_num_threads(1)

TRANSPORTS = [None, "direct", "queue", "process"]
LLAMA = "llama3.2-3b"


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_layers=2, compute_dtype="float32")
    ref_cfg = ref_get_config(LLAMA, reduced=True).replace(**kw)
    ref = RefSplitModel(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    cfg = get_config(LLAMA, reduced=True).replace(**kw)
    model = SplitModel(cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params))
    return cfg, model, params, ref, ref_params


def _engine(setup, **kw):
    _, model, params, _, _ = setup
    kw.setdefault("batch_slots", 2)
    kw.setdefault("ctx_len", 32)
    kw.setdefault("max_new", 6)
    return ServingEngine(model, params, device="cpu", **kw)


def _ref_engine(setup, **kw):
    _, _, _, ref, ref_params = setup
    kw.setdefault("batch_slots", 2)
    kw.setdefault("ctx_len", 32)
    kw.setdefault("max_new", 6)
    return RefServingEngine(ref, ref_params, **kw)


def _contexts(setup, n, seed=0, length=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, setup[0].vocab, length) for _ in range(n)]


def _serve(eng, ctxs, mixed):
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
    out = eng.run()
    eng.close()
    return [out[r].generated for r in rids], dict(eng.stats)


# ------------------------------------------------------- scheduler identity


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_continuous_matches_wave_bitwise(setup, transport):
    """The same requests (mixed max_new, more requests than slots) give
    bit-identical tokens under wave and continuous scheduling, and
    continuous needs fewer ticks than the waves' decode steps."""
    mixed = [2, 6, 1, 5, 6, 3]
    ctxs = _contexts(setup, 6, seed=6)
    wave, _ = _serve(_engine(setup, transport=transport), ctxs, mixed)
    cont, st = _serve(_engine(setup, transport=transport,
                              scheduler="continuous"), ctxs, mixed)
    assert cont == wave
    assert [len(g) for g in cont] == mixed
    assert st["ticks"] < 3 * 6 and st["slot_refills"] >= 3


@pytest.mark.parametrize("transport,compression", [
    (None, None), ("queue", None), ("queue", "int8"), ("direct", "fp16")])
def test_continuous_matches_reference_continuous(setup, transport,
                                                 compression):
    """The port's continuous engine against the reference's: the same
    tokens, ticks, refills, prefill calls, and cut bytes and messages on
    the wire."""
    mixed = [2, 5, 1, 4, 3]
    ctxs = _contexts(setup, 5, seed=1)
    kw = dict(scheduler="continuous", transport=transport,
              compression=compression)
    got, gs = _serve(_engine(setup, **kw), ctxs, mixed)
    want, ws = _serve(_ref_engine(setup, **kw), ctxs, mixed)
    assert got == want
    for k in ("ticks", "slot_refills", "prefill_calls", "requests",
              "tokens_generated", "cut_payload_bytes", "cut_wire_bytes",
              "cut_messages", "waves"):
        assert gs[k] == ws[k], k
    assert set(gs) == set(ws)


def test_continuous_queue_matches_process(setup):
    """Continuous scheduling gives the same tokens and the same measured
    cut bytes and messages over the thread queue and the OS pipe, as in
    the reference."""
    mixed = [2, 5, 3]
    ctxs = _contexts(setup, 3, seed=7)
    for compression in (None, "int8"):
        gq, sq = _serve(_engine(setup, scheduler="continuous",
                                transport="queue", compression=compression),
                        ctxs, mixed)
        gp, sp = _serve(_engine(setup, scheduler="continuous",
                                transport="process",
                                compression=compression), ctxs, mixed)
        assert gq == gp
        for k in ("cut_payload_bytes", "cut_wire_bytes", "cut_messages"):
            assert sq[k] == sp[k], k


@pytest.mark.parametrize("transport", ["queue", "process"])
def test_latency_is_paid_once_per_tick(setup, transport):
    """At 100 ms one-way: the same tokens as at latency 0, and one window
    per tick.  Requests of 1, 3 and 2 tokens through 2 slots take 3
    ticks, the second a refill tick whose decode and prefill frames are
    both sent before either is received, so the run pays 3 windows, not
    4."""
    mixed = [1, 3, 2]
    ctxs = _contexts(setup, 3, seed=8)
    fast, _ = _serve(_engine(setup, scheduler="continuous",
                             transport=transport), ctxs, mixed)
    eng = _engine(setup, scheduler="continuous", transport=transport,
                  latency_s=0.1)
    slow, st = _serve(eng, ctxs, mixed)
    assert slow == fast
    assert st["ticks"] == 3 and st["slot_refills"] == 1
    assert 0.1 * 3 <= st["wall_s"] < 0.1 * 4


# ------------------------------------------------------------- edge cases


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_queue_longer_than_slots_refills(setup, transport):
    """5 requests through 2 slots: freed slots refill (no wave drain) and
    every request comes back."""
    eng = _engine(setup, scheduler="continuous", transport=transport)
    mixed = [2, 6, 3, 6, 4]
    rids = [eng.submit(c, max_new=m)
            for c, m in zip(_contexts(setup, 5), mixed)]
    out = eng.run()
    eng.close()
    assert sorted(out) == sorted(rids)
    assert [len(out[r].generated) for r in rids] == mixed
    assert eng.stats["slot_refills"] >= 3 and eng.stats["requests"] == 5
    assert eng.stats["ticks"] < 3 * 6
    events = [e[0] for e in eng.transcript]
    assert events.count("admit") == 2 and events.count("finish") == 5
    assert events.count("refill") == eng.stats["slot_refills"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_eos_on_first_decoded_token(setup, transport):
    """A request whose first greedy token is EOS finishes at length 1
    without a decode step, and its slot refills at once."""
    (ctx,) = _contexts(setup, 1, seed=3)
    probe = _engine(setup, scheduler="continuous")
    rid = probe.submit(ctx)
    first = probe.run()[rid].generated[0]
    eng = _engine(setup, scheduler="continuous", transport=transport,
                  eos_token=first)
    rids = [eng.submit(ctx, max_new=6) for _ in range(3)]
    out = eng.run()
    eng.close()
    assert all(out[r].generated == [first] for r in rids)
    assert eng.stats["slot_refills"] >= 1


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_submit_after_run(setup, transport):
    """The engine is a service: submissions after a drained run are
    served by the next run."""
    eng = _engine(setup, scheduler="continuous", transport=transport)
    c1, c2 = _contexts(setup, 2, seed=4)
    r1 = eng.submit(c1, max_new=3)
    out1 = eng.run()
    r2 = eng.submit(c2, max_new=3)
    out2 = eng.run()
    eng.close()
    assert list(out1) == [r1] and list(out2) == [r2]
    assert len(out2[r2].generated) == 3


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_context_exactly_ctx_len(setup, transport):
    eng = _engine(setup, scheduler="continuous", transport=transport)
    (ctx,) = _contexts(setup, 1, seed=5, length=32)
    rid = eng.submit(ctx, max_new=2)
    out = eng.run()
    eng.close()
    assert len(out[rid].generated) == 2
    with pytest.raises(ValueError):
        eng.submit(np.zeros(33, np.int32))


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_empty_queue_run(setup, transport):
    """``run`` with nothing queued returns {} with no tick and no wire
    traffic."""
    eng = _engine(setup, scheduler="continuous", transport=transport)
    assert eng.run() == {}
    assert eng.stats["ticks"] == 0 and eng.stats["cut_messages"] == 0
    eng.close()


# ------------------------------------------------------------ stats


def test_per_request_latency(setup):
    """Latency is submit -> finish per request: a 1-token request beside
    a 6-token one reports strictly less, on both schedulers."""
    for sched in ("wave", "continuous"):
        eng = _engine(setup, scheduler=sched)
        ctxs = _contexts(setup, 2, seed=8)
        r_short = eng.submit(ctxs[0], max_new=1)
        r_long = eng.submit(ctxs[1], max_new=6)
        out = eng.run()
        assert 0.0 < out[r_short].latency_s < out[r_long].latency_s


@pytest.mark.parametrize("transport", ["queue", "process"])
def test_cut_stats_are_per_engine_deltas(setup, transport):
    """Two runs of the same traffic report twice one run's cut bytes, and
    the totals equal the channel's ``by_kind`` counts of both cut
    kinds."""
    eng = _engine(setup, scheduler="continuous", transport=transport)
    ctxs = _contexts(setup, 2, seed=9)
    for c in ctxs:
        eng.submit(c, max_new=3)
    eng.run()
    first = (eng.stats["cut_payload_bytes"], eng.stats["cut_wire_bytes"],
             eng.stats["cut_messages"])
    assert first[0] > 0
    for c in ctxs:
        eng.submit(c, max_new=3)
    eng.run()
    assert (eng.stats["cut_payload_bytes"], eng.stats["cut_wire_bytes"],
            eng.stats["cut_messages"]) == tuple(2 * x for x in first)
    bk = eng._ep_sci.recv_stats["by_kind"]
    assert eng.stats["cut_payload_bytes"] == sum(
        bk.get(k, {}).get("payload_bytes", 0)
        for k in ("cut_activations", "cut_prefill"))
    eng.close()


def test_wave_stats_delta_regression(setup):
    eng = _engine(setup, batch_slots=1, transport="queue")
    (ctx,) = _contexts(setup, 1, seed=10)
    eng.submit(ctx, max_new=2)
    eng.run()
    one = eng.stats["cut_payload_bytes"]
    eng.submit(ctx, max_new=2)
    eng.run()
    assert eng.stats["cut_payload_bytes"] == 2 * one


# ------------------------------------------------------------ cut cache


@pytest.mark.parametrize("transport", ["queue", "process", None])
def test_repeat_entity_zero_upload(setup, transport):
    """A returning entity ships zero cut-upload bytes and recomputes
    nothing owner side (the admission control frame is all that
    crosses), the hit is in the transcript, and its tokens equal the
    fresh run's bit for bit."""
    eng = _engine(setup, scheduler="continuous", transport=transport,
                  cut_cache=True)
    (ctx,) = _contexts(setup, 1, seed=11)
    r1 = eng.submit(ctx, max_new=5)
    first = eng.run()[r1].generated
    pc, pb, pm = (eng.stats["prefill_calls"],
                  eng.stats["cut_payload_bytes"], eng.stats["cut_messages"])
    r2 = eng.submit(ctx, max_new=5)
    second = eng.run()[r2].generated
    assert eng.stats["prefill_calls"] == pc
    assert eng.stats["cut_cache_hits"] == 1
    assert any(e[0] == "cut_cache_hit" and e[1] == r2
               for e in eng.transcript)
    assert any(e[0] == "cut_cache_store" and e[1] == r1
               for e in eng.transcript)
    assert second == first
    if transport is not None:
        # only decode frames: no cut_prefill for the hit
        decode = eng.stats["cut_messages"] - pm
        assert decode == 4                       # 5 tokens, 4 decode ticks
        assert eng._ep_sci.recv_stats["by_kind"]["admit"]["count"] == 2
        assert eng.stats["cut_payload_bytes"] - pb == 4 * 2 * \
            setup[1].cfg.d_model * 4
    eng.close()


def test_cut_cache_matches_reference_cache(setup):
    """The reference's cache and the port's on the same repeat traffic
    (a hit beside a fresh request in one refill): the same tokens, hits,
    refills and cut bytes."""
    ctxs = _contexts(setup, 3, seed=12)
    traffic = [ctxs[0], ctxs[1], ctxs[0], ctxs[2], ctxs[1]]
    mixed = [3, 2, 3, 4, 2]
    out = []
    for make in (_engine, _ref_engine):
        eng = make(setup, scheduler="continuous", transport="queue",
                   cut_cache=True)
        out.append(_serve(eng, traffic, mixed))
    (got, gs), (want, ws) = out
    assert got == want
    for k in ("cut_cache_hits", "slot_refills", "prefill_calls", "ticks",
              "cut_payload_bytes", "cut_wire_bytes", "cut_messages"):
        assert gs[k] == ws[k], k
    assert gs["cut_cache_hits"] == 2


def test_cut_cache_lru_eviction():
    for cls in (CutCache, RefCutCache):
        cache = cls(max_entries=2)
        for t in ("a", "b", "c"):
            cache.put(t, {"v": t})
        assert len(cache) == 2 and cache.evictions == 1
        assert cache.get("a") is None
        assert cache.get("c")["v"] == "c"
        assert (cache.hits, cache.misses) == (1, 1)


def test_evicted_entity_prefills_again(setup):
    """With room for one entry, the third request of A, B, A misses and
    pays a fresh prefill; the tokens are unchanged."""
    eng = _engine(setup, batch_slots=1, scheduler="continuous",
                  transport="queue", cut_cache=CutCache(max_entries=1))
    a, b = _contexts(setup, 2, seed=13)
    got, st = _serve(eng, [a, b, a], [2, 2, 2])
    assert got[0] == got[2]
    assert st["cut_cache_hits"] == 0 and eng.cut_cache.evictions == 2
    assert st["prefill_calls"] == 3


def test_context_tag_content_addressing():
    a = batching.pad_context_row(np.arange(5), 8)
    b = batching.pad_context_row(np.arange(5), 8)
    c = batching.pad_context_row(np.arange(1, 6), 8)
    assert batching.context_tag(a) == batching.context_tag(b)
    assert batching.context_tag(a) != batching.context_tag(c)
    assert batching.context_tag(a) == ref_batching.context_tag(a)


def test_entity_tag_is_the_reference_s(setup):
    row = batching.pad_context_row(np.arange(7), 32)
    for kw in (dict(), dict(transport="queue", compression="int8")):
        assert _engine(setup, scheduler="continuous", **kw)._entity_tag(
            row) == _ref_engine(setup, scheduler="continuous",
                                **kw)._entity_tag(row)


# ----------------------------------------------------- admission control


def test_bounded_queue_backpressure_on_continuous(setup):
    eng = _engine(setup, scheduler="continuous", max_queue=2)
    ctxs = _contexts(setup, 3, seed=13)
    eng.submit(ctxs[0])
    eng.submit(ctxs[1])
    with pytest.raises(QueueFull) as e:
        eng.submit(ctxs[2])
    assert e.value.queue_depth == 2
    assert eng.stats["rejected"] == 1 and eng.stats["submitted"] == 2
    assert eng.stats["peak_queue_depth"] == 2
    eng.run()                                # drains; capacity returns
    eng.submit(ctxs[2], max_new=1)
    assert eng.stats["submitted"] == 3
    assert eng.run() != {}


def test_blocking_submit_admits_when_queue_drains(setup):
    eng = _engine(setup, batch_slots=1, max_new=2, max_queue=1,
                  scheduler="continuous")
    c1, c2 = _contexts(setup, 2, seed=3)
    eng.submit(c1)

    def drain():
        time.sleep(0.2)
        eng._queue.pop(0)       # another thread serving the queue

    th = threading.Thread(target=drain)
    th.start()
    rid = eng.submit(c2, block=True, timeout=10.0)
    th.join()
    assert isinstance(rid, int) and eng.stats["rejected"] == 0


# ------------------------------------------------- session multiplexing


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_scoped_endpoint_stats_filtering(backend):
    """Scoped kinds on one shared endpoint pair: interleaved frames reach
    their scope (the stash absorbs the interleaving), and each scope's
    stats are its own, the scope stripped; the raw view keeps it."""
    if backend == "queue":
        a, b = channel_pair("owners", "scientist", backend="queue")
    else:
        a, b = process_transport.process_endpoint_pair("owners",
                                                       "scientist")
    try:
        s0a, s1a = ScopedEndpoint(a, "s0:"), ScopedEndpoint(a, "s1:")
        s0b, s1b = ScopedEndpoint(b, "s0:"), ScopedEndpoint(b, "s1:")
        s0a.send("cut", {"x": np.zeros(4, np.float32)})
        s1a.send("cut", {"x": np.zeros(8, np.float32)})
        s1a.send("grad", {"x": np.zeros(2, np.float32)})
        assert s1b.recv_kind("grad", timeout=5.0).payload["x"].nbytes == 8
        assert s0b.recv_kind("cut", timeout=5.0).payload["x"].nbytes == 16
        assert s1b.recv_kind("cut", timeout=5.0).payload["x"].nbytes == 32
        assert s0a.sent_stats["by_kind"]["cut"]["payload_bytes"] == 16
        assert s1a.sent_stats["by_kind"]["cut"]["payload_bytes"] == 32
        assert (s0a.sent_stats["messages"], s1a.sent_stats["messages"]) == \
            (1, 2)
        assert s1b.recv_stats["by_kind"]["grad"]["count"] == 1
        assert "s0:cut" in a.sent_stats["by_kind"]
        assert s0b.empty() and b.empty()
    finally:
        for ep in (a, b):
            if hasattr(ep, "close"):
                ep.close()


@pytest.mark.parametrize("transport", ["queue", "process"])
def test_multiplexed_sessions_concurrent(setup, transport):
    """Two engine sessions on two threads over one shared channel give
    exactly what dedicated engines give, each session's stats count its
    own frames, and the scoped stats sum to the shared channel's."""
    _, model, params, _, _ = setup
    svc = ServingService(model, params, transport=transport, batch_slots=2,
                         ctx_len=32, max_new=6, device="cpu")
    s1, s2 = svc.session(), svc.session()
    ca, cb = _contexts(setup, 3, seed=14), _contexts(setup, 3, seed=15)
    res, errors = {}, []

    def drive(s, cs, key):
        try:
            rids = [s.submit(c, max_new=4) for c in cs]
            out = s.run()
            res[key] = [out[r].generated for r in rids]
        except BaseException as e:           # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(s1, ca, "a")),
               threading.Thread(target=drive, args=(s2, cb, "b"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads)
    ra, sa = _serve(_engine(setup, scheduler="continuous",
                            transport="queue"), ca, [4] * 3)
    rb, sb = _serve(_engine(setup, scheduler="continuous",
                            transport="queue"), cb, [4] * 3)
    assert res["a"] == ra and res["b"] == rb
    for s, want in ((s1, sa), (s2, sb)):
        for k in ("cut_payload_bytes", "cut_wire_bytes", "cut_messages"):
            assert s.stats[k] == want[k], k
    raw = svc.channel_stats
    assert raw["wire_bytes"] == sum(s._ep_sci.recv_stats["wire_bytes"]
                                    for s in (s1, s2))
    kinds = set(raw["by_kind"])
    assert any(k.startswith("s0:") for k in kinds)
    assert any(k.startswith("s1:") for k in kinds)
    svc.close()


def test_service_shared_cut_cache(setup):
    """The cut cache is service-wide: an entity seen by session A is a hit
    when it returns through session B, with no cut_prefill frame in B's
    scoped traffic and the same tokens."""
    _, model, params, _, _ = setup
    svc = ServingService(model, params, transport="queue", batch_slots=2,
                         ctx_len=32, max_new=6, device="cpu")
    (ctx,) = _contexts(setup, 1, seed=16)
    s1 = svc.session()
    r1 = s1.submit(ctx, max_new=3)
    g1 = s1.run()[r1].generated
    s2 = svc.session()
    r2 = s2.submit(ctx, max_new=3)
    g2 = s2.run()[r2].generated
    assert s2.stats["cut_cache_hits"] == 1 and svc.cut_cache.hits == 1
    assert "cut_prefill" not in s2._ep_sci.recv_stats["by_kind"]
    assert g2 == g1
    svc.close()


def test_recv_kind_timeout_raises():
    a, b = channel_pair("x", "y", backend="queue")
    with pytest.raises(queue_mod.Empty):
        ScopedEndpoint(b, "s0:").recv_kind("never", timeout=0.15)


# ------------------------------------------------------ degraded service


@pytest.mark.parametrize("scheduler", ["wave", "continuous"])
def test_degraded_service_per_request_errors(setup, scheduler,
                                             monkeypatch):
    """A fault mid-schedule fails every affected request with
    ``Result.error`` instead of raising out of ``run``, and the engine
    then serves fresh work (the reference's ``tests/test_engine.py``)."""
    eng = _engine(setup, max_new=2, scheduler=scheduler)
    rids = [eng.submit(c) for c in _contexts(setup, 3, seed=4)]
    boom = lambda *a: (_ for _ in ()).throw(RuntimeError("wire died"))
    monkeypatch.setattr(eng, "_run_wave" if scheduler == "wave"
                        else "_continuous_loop", boom)
    out = eng.run()
    assert sorted(out) == sorted(rids)
    assert all(out[r].error and "wire died" in out[r].error for r in rids)
    assert eng.stats["failed_requests"] == 3
    assert any(e[0] == "degraded" and "wire died" in e[2]
               for e in eng.transcript)
    monkeypatch.undo()
    (ctx,) = _contexts(setup, 1, seed=5)
    rid = eng.submit(ctx)
    ok = eng.run()
    assert ok[rid].error is None and len(ok[rid].generated) == 2


@pytest.mark.parametrize("scheduler", ["wave", "continuous"])
def test_transport_fault_fails_pending_requests(setup, scheduler):
    """A real fault on the wire (the owner's channel refuses its fourth
    send): the in-flight and queued requests fail with the error (the
    whole wave, on the wave scheduler), a request that finished before
    it keeps its tokens, and a fresh request is served once the wire is
    healthy again."""
    eng = _engine(setup, max_new=4, scheduler=scheduler, transport="queue")
    sends = {"n": 0}

    def hook(kind, seq):
        sends["n"] += 1
        if sends["n"] == 4:
            raise OSError("link down")
        return None

    eng._ep_owner.outbox.fault_hook = hook
    ctxs = _contexts(setup, 3, seed=6)
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, [1, 4, 4])]
    out = eng.run()
    assert sorted(out) == sorted(rids)
    failed = [r for r in rids if out[r].error]
    assert failed and all("OSError: link down" in out[r].error
                          for r in failed)
    assert eng.stats["failed_requests"] == len(failed)
    if scheduler == "continuous":       # request 0 finished before the fault
        assert out[rids[0]].error is None and out[rids[0]].generated
    eng._ep_owner.outbox.fault_hook = None
    rid = eng.submit(ctxs[1], max_new=2)
    ok = eng.run()
    assert ok[rid].error is None and len(ok[rid].generated) == 2


# ------------------------------------------ the process endpoint's extras


def _process_pairs(**kw):
    return (process_transport.process_endpoint_pair("owner0", "scientist",
                                                    **kw),
            ref_pt.process_endpoint_pair("owner0", "scientist", **kw))


def test_tap_observes_both_directions_as_the_reference():
    """``tap`` on endpoint a sees a's sends and a's receives, with the
    blob; the port's taps record what the reference's record."""
    seen = {"port": [], "ref": []}
    pairs = {}
    for key in seen:
        tap = (lambda k: lambda m, blob: seen[k].append(
            (m.kind, m.sender, m.receiver, len(blob))))(key)
        mod = process_transport if key == "port" else ref_pt
        pairs[key] = mod.process_endpoint_pair("owner0", "scientist",
                                               tap=tap)
    try:
        for a, b in pairs.values():
            a.send("ping", {"x": np.zeros(2, np.float32)})
            b.send("pong", {"x": np.zeros(3, np.float32)})
            a.recv_kind("pong", timeout=5.0)
            b.recv_kind("ping", timeout=5.0)
        assert seen["port"] == seen["ref"]
        assert {(k, s) for k, s, _, _ in seen["port"]} == {
            ("ping", "owner0"), ("pong", "scientist")}
    finally:
        for a, b in pairs.values():
            a.close()
            b.close()


def test_dedup_drops_replayed_seqs_as_the_reference():
    """``dedup`` on endpoint a: a frame whose seq repeats the last
    delivered seq of its kind is dropped and counted, negative seqs are
    exempt, other kinds are tracked apart, and ``reset_dedup`` forgets;
    the port delivers what the reference delivers."""
    frames = [("cut", 0), ("cut", 0), ("cut", 1), ("grad", 1), ("cut", 1),
              ("hb", -1), ("hb", -1), ("cut", 2)]
    got = {}
    for key, (a, b) in zip(("port", "ref"), _process_pairs(dedup=True)):
        try:
            for i, (kind, seq) in enumerate(frames):
                b.send(kind, {"i": np.array([i])}, seq=seq)
            seen = []
            while True:
                try:
                    m = a.recv(timeout=0.5)
                except queue_mod.Empty:
                    break
                seen.append((m.kind, m.seq, int(m.payload["i"][0])))
            a.reset_dedup()
            b.send("cut", {"i": np.array([99])}, seq=2)
            m = a.recv(timeout=5.0)
            got[key] = (seen, a.recv_stats["dup_dropped"], m.seq)
        finally:
            a.close()
            b.close()
    assert got["port"] == got["ref"]
    seen, dropped, _ = got["port"]
    assert dropped == 2 and [s for _, s, _ in seen] == [0, 1, 1, -1, -1, 2]


def test_dedup_is_off_by_default():
    a, b = process_transport.process_endpoint_pair("owner0", "scientist")
    try:
        for _ in range(2):
            b.send("cut", {"x": np.zeros(1)}, seq=0)
        assert [a.recv(timeout=5.0).seq for _ in range(2)] == [0, 0]
        assert "dup_dropped" not in a.recv_stats
    finally:
        a.close()
        b.close()


# --------------------------------------------------- session entry points


def _sessions(n_docs=4, length=16):
    cfg = get_config(LLAMA, reduced=True).replace(compute_dtype="float32")
    ref_cfg = ref_get_config(LLAMA, reduced=True).replace(
        compute_dtype="float32")
    toks = make_token_dataset(n_docs, length, cfg.vocab, 0)[:, :length]
    np.testing.assert_array_equal(
        toks, ref_make_token_dataset(n_docs, length, cfg.vocab, 0)[:,
                                                                  :length])
    return cfg, ref_cfg, toks


def _port_session(cfg, toks, params=None):
    s = VerticalSession(*sequence_parties(toks, cfg.split.n_owners,
                                          with_labels=False), device="cpu")
    s.resolve(group="modp512")
    return s.build(cfg, params=params)


@pytest.fixture(scope="module")
def served():
    """The reference's ``serve_dataset`` on a queue and its params."""
    cfg, ref_cfg, toks = _sessions()
    ref = RefSession(*ref_seq_parties(toks, ref_cfg.split.n_owners,
                                      with_labels=False))
    ref.resolve(group="modp512")
    ref.build(ref_cfg)
    out, eng = ref.serve_dataset(max_new=3, batch_slots=4,
                                 transport="queue")
    return (cfg, toks, from_reference(jax.tree.map(np.asarray, ref.params)),
            {r: out[r].generated for r in out}, dict(eng.stats))


@pytest.mark.parametrize("transport,scheduler", [
    (None, "wave"), ("direct", "wave"), ("queue", "wave"),
    ("process", "wave"), ("queue", "continuous"),
    ("process", "continuous")])
def test_serve_dataset_matches_reference(served, transport, scheduler):
    """``VerticalSession(*sequence_parties(...))`` -> resolve -> build ->
    ``serve_dataset``: the reference session's tokens, and over a wire
    its cut bytes and messages (one wave: P prefill slices, then one per
    decode step), as in the reference's ``tests/test_transport.py`` and
    ``tests/test_process_transport.py``."""
    cfg, toks, params, want, ws = served
    s = _port_session(cfg, toks, params)
    out, eng = s.serve_dataset(max_new=3, batch_slots=4,
                               transport=transport, scheduler=scheduler)
    eng.close()
    assert {r: out[r].generated for r in out} == want
    assert eng.device == torch.device("cpu")
    if transport is None:
        assert eng.stats["cut_payload_bytes"] == 0
    elif transport != "direct":
        for k in ("cut_wire_bytes", "cut_payload_bytes", "cut_messages"):
            assert eng.stats[k] == ws[k], k
        assert ws["cut_messages"] == cfg.split.n_owners + 3 - 1


def test_serve_dataset_takes_n_requests_and_engine_knobs(served):
    cfg, toks, params, want, _ = served
    s = _port_session(cfg, toks, params)
    out, eng = s.serve_dataset(max_new=2, batch_slots=2, n_requests=3,
                               scheduler="continuous", cut_cache=True)
    assert sorted(out) == [0, 1, 2]
    assert all(out[r].generated == want[r][:2] for r in out)
    assert eng.B == 2 and eng.cut_cache is not None


def test_lm_session_builds_on_its_device_and_refuses_fit():
    """``build(ArchConfig)`` draws the LM on the session's device and
    the adapter is ``SplitLMAdapter``; a session without labels refuses
    ``fit`` as the reference's does, and an LM with Mamba2 blocks
    (zamba2) supports split and microbatches and trains, as llama does."""
    from repro_torch.federation import PrivacyError
    cfg, _, toks = _sessions()
    s = _port_session(cfg, toks)
    assert type(s.adapter).__name__ == "SplitLMAdapter"
    assert s.adapter.layout == "sequence" and s.adapter.supports_serving
    assert s.adapter.supports_split
    assert s.adapter.cut_shape(4, (8,)) == (4, 8, cfg.d_model)
    assert s.cut_traffic(4, bytes_per_el=2)["per_owner_forward_bytes"] == \
        4 * 8 * cfg.d_model * 2
    again = _port_session(cfg, toks)             # one seed, one draw
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s.params),
                                                 tree_leaves(again.params)))
    with pytest.raises(PrivacyError, match="no labels"):
        s.fit(steps=1, batch_size=2)
    zcfg = get_config("zamba2-2.7b", reduced=True)
    z = _port_session(zcfg, make_token_dataset(4, 16, zcfg.vocab, 0)[:, :16])
    assert z.adapter.supports_split and z.adapter.supports_microbatch
    with pytest.raises(PrivacyError, match="no labels"):
        z.fit(steps=1, batch_size=2)
    labelled = VerticalSession(*sequence_parties(
        make_token_dataset(4, 16, zcfg.vocab, 0), 2), device="cpu")
    labelled.resolve(group="modp512")
    labelled.build(zcfg)
    h = labelled.fit(steps=1, batch_size=2, verbose=False)
    assert np.isfinite(h["loss_trail"]).all()


def test_lm_adapter_refusals_match_reference():
    """The reference's ``ValueError`` s: NoPeek on the LM."""
    import dataclasses
    from repro_torch.federation.registry import build_adapter
    cfg = get_config(LLAMA, reduced=True)
    with pytest.raises(ValueError, match="nopeek_weight"):
        build_adapter(cfg.replace(split=dataclasses.replace(
            cfg.split, nopeek_weight=0.1)))
    with pytest.raises(ValueError, match="no adapter"):
        build_adapter(object())


def test_sequence_layout_helpers_are_the_reference_s():
    from repro.core import vertical as ref_vertical
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 500, (3, 13))
    for owners in (1, (5, 8), (4, 4, 5)):
        got = vertical.partition_sequence(toks, owners)
        want = ref_vertical.partition_sequence(toks, owners)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(vertical.unpartition(got, 1), toks)
    with pytest.raises(ValueError):
        vertical.partition_sequence(toks, 2)
    ot = batching.sequence_owner_slices(toks[:, :12], 3)
    np.testing.assert_array_equal(batching.merge_sequence_slices(ot),
                                  toks[:, :12])
    np.testing.assert_array_equal(batching.merge_sequence_slices(ot),
                                  ref_batching.merge_sequence_slices(ot))
    for with_labels in (True, False):
        sci, owners = sequence_parties(toks[:, :13 if with_labels else 12],
                                       2, with_labels=with_labels)
        rsci, rowners = ref_seq_parties(
            toks[:, :13 if with_labels else 12], 2,
            with_labels=with_labels)
        assert sci.ids == rsci.ids and sci.has_labels == rsci.has_labels
        for o, r in zip(owners, rowners):
            assert o.name == r.name and o.ids == r.ids
            np.testing.assert_array_equal(o._features, r._features)
