"""``VerticalSession.resolve`` in the port against the JAX package's, on
the CPU: stats and transcripts key for key, and the aligned arrays bit
for bit, over every mode, the direct and queue backends, the worker pool
and chunk sizes, with both sides' secrets set equal; repeat and delta
resolves after churn; the option guards.
"""
import numpy as np
import pytest
import torch

from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import feature_parties as ref_feature_parties
from repro_torch.core.psi import HIDDEN_PAD
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties

torch.set_num_threads(1)

GROUP = "modp512"


def twin_sessions(n=150, seed=4, keep_frac=0.85, modes=("noinv",)):
    """A port session and a reference session over the same parties,
    the port's PSI secrets (per mode: the client's exponents, every
    owner's β) set to the reference's."""
    ours = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=seed, keep_frac=keep_frac)), device="cpu")
    ref = RefSession(*ref_feature_parties(*ref_parties(
        n, seed=seed, keep_frac=keep_frac)))
    for mode in modes:
        rc = ref.scientist.psi_client(GROUP, mode)
        c = ours.scientist.psi_client(GROUP, mode)
        c._blind_exp, c._unblind_exp = rc._blind_exp, rc._unblind_exp
    for o, r in zip(ours.owners, ref.owners):
        o.psi_server(GROUP)._beta = r.psi_server(GROUP)._beta
    return ours, ref


def assert_same_resolve(ours, ref, st_ours, st_ref):
    assert st_ours == st_ref
    assert ours.transcript == ref.transcript
    assert ours.scientist.ids == ref.scientist.ids
    assert ours.scientist.labels.tobytes() == ref.scientist.labels.tobytes()
    for o, r in zip(ours.owners, ref.owners):
        assert o.ids == ref.scientist.ids
        assert o._features.tobytes() == r._features.tobytes()


@pytest.mark.parametrize("mode", ["noinv", "bloom", "hidden"])
@pytest.mark.parametrize("backend", ["direct", "queue"])
@pytest.mark.parametrize("parallelism,chunk_size", [(0, 4096), (0, 13),
                                                    (2, 64)])
def test_resolve_equals_reference(mode, backend, parallelism, chunk_size):
    """Stats (rounds, per-party wire, the pool's parallelism),
    transcript entries and the aligned rows — hidden pseudonyms and
    decoys included — equal the reference's."""
    ours, ref = twin_sessions(modes=(mode,))
    kw = dict(group=GROUP, mode=mode, backend=backend,
              parallelism=parallelism, chunk_size=chunk_size)
    st = ours.resolve(**kw)
    assert_same_resolve(ours, ref, st, ref.resolve(**kw))
    assert st["parallelism"] == parallelism
    if mode == "hidden":
        ids = ours.scientist.ids
        assert ids and all(i.startswith("anon") for i in ids)
        members = set(ours.scientist._full.ids)
        for o in ours.owners:
            members &= set(o._full.ids)
        # each owner pads with fewer than HIDDEN_PAD decoys
        assert len(members) <= len(ids) \
            <= len(members) + len(ours.owners) * (HIDDEN_PAD - 1)


def test_modes_and_backends_agree():
    """noinv and bloom align the same IDs; hidden's rows are the same on
    every backend."""
    out = {}
    for mode in ("noinv", "bloom", "hidden"):
        for backend in ("direct", "queue"):
            s = VerticalSession(*feature_parties(
                *make_vertical_mnist_parties(120, seed=7, keep_frac=0.85)),
                device="cpu")
            s.resolve(group=GROUP, mode=mode, backend=backend, chunk_size=16)
            out[mode, backend] = (
                list(s.scientist.ids), s.scientist.labels.tobytes(),
                [o._features.tobytes() for o in s.owners])
    for mode in ("noinv", "bloom", "hidden"):
        assert out[mode, "direct"] == out[mode, "queue"]
    assert out["noinv", "direct"] == out["bloom", "direct"]


@pytest.mark.parametrize("mode", ["noinv", "hidden"])
def test_repeat_and_churn_resolves_equal_reference(mode):
    """Resolve, resolve again unchanged (hello-only on the queue), then
    ±2 churn of the scientist's rows and of one owner's: delta rounds,
    O(Δ) modexp, the psi_blind_reuse / psi_delta_reuse entries — every
    stats value and transcript entry equal the reference's."""
    ours, ref = twin_sessions(200, seed=3, keep_frac=1.0, modes=(mode,))
    kw = dict(group=GROUP, mode=mode, backend="queue", chunk_size=64)
    assert_same_resolve(ours, ref, ours.resolve(**kw), ref.resolve(**kw))
    st2 = ours.resolve(**kw)
    assert_same_resolve(ours, ref, st2, ref.resolve(**kw))
    for r in st2["rounds"]:
        assert r["upload_skipped"] and r["server_leg_skipped"]
        assert r["client_modexp_ops"] == r["server_modexp_ops"] == 0
        assert r["upload_wire_bytes"] == 0
        # the envelope (hidden: and the keep mask, 16 bytes per row)
        assert r["download_wire_bytes"] < 1024 + 16 * r.get("hidden_kept", 0)
    for s in (ours, ref):
        sci = s.scientist
        pop = list(sci._full.ids)
        sci.update_rows(pop[2:] + ["fresh-0", "fresh-1"], np.concatenate(
            [sci._full.data[2:], np.zeros(2, sci._full.data.dtype)]))
        o = s.owners[1]
        o.update_rows(list(o._full.ids[:-1]) + ["fresh-0"],
                      np.concatenate([o._full.data[:-1],
                                      o._full.data[:1]]))
    st3 = ours.resolve(**kw)
    assert_same_resolve(ours, ref, st3, ref.resolve(**kw))
    for r in st3["rounds"]:
        assert r["delta_used"]
        assert r["upload_wire_bytes"] == 0
    # owner0 is unchanged: 2 new client elements double-blinded there
    assert st3["rounds"][0]["server_modexp_ops"] == 2
    kinds = [m["kind"] for m in ours.transcript]
    assert kinds.count("psi_delta_reuse") == 4
    assert "psi_blind_reuse" in kinds


def test_resolve_option_guards():
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        40, seed=0)), device="cpu")
    with pytest.raises(ValueError, match="unknown resolve backend"):
        s.resolve(group=GROUP, backend="carrier-pigeon")
    with pytest.raises(ValueError, match="wire backend"):
        s.resolve(group=GROUP, backend="direct", latency_s=0.01)
    with pytest.raises(ValueError, match="unknown PSI mode"):
        s.resolve(group=GROUP, mode="nope")
    st = s.resolve(group=GROUP, backend="queue", latency_s=0.001,
                   bandwidth_bps=1e9, fp_rate=1e-6, mode="bloom")
    assert st["latency_s"] == 0.001 and st["backend"] == "queue"
