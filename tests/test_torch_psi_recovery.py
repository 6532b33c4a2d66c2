"""PSI retries in the port, on the CPU: the reference's chaos-matrix and
retry-hygiene checks on the queue and process backends (``crash_psi``
and ``wedge_psi`` from the fault plan, armed at the round's attempt), and
the retry's records against the JAX package's under the same plan.
"""
import contextlib
import time

import pytest
import torch

from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import feature_parties as ref_feature_parties
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, faults, feature_parties

torch.set_num_threads(1)

GROUP = "modp512"


def _session(n=200):
    return VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.8)), device="cpu")


@pytest.fixture(scope="module")
def clean_ids():
    s = _session()
    s.resolve(group=GROUP)
    return list(s.scientist.ids)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_chaos_matrix_psi_crash_retries(backend, clean_ids):
    """crash_psi: owner0's PSI actor dies on the first blind chunk;
    without retries the resolve raises, and ``retries=1`` restarts the
    actor at generation 1 (where the fault is inert) and aligns the
    fault-free IDs."""
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv(faults.CHAOS_ENV, "owner0:crash_psi")
        s = _session()
        with pytest.raises(RuntimeError):
            s.resolve(group=GROUP, backend=backend, timeout=60.0)
        s2 = _session()
        s2.resolve(group=GROUP, backend=backend, retries=1, timeout=60.0)
    ev = [(e["party"], e["action"], e["attempt"])
          for e in s2.recovery_events]
    assert ev == [("owner0", "psi_retry", 1)]
    assert "owner0" in s2.recovery_events[0]["error"]
    assert s2.scientist.ids == clean_ids
    retry = [m for m in s2.transcript if m["kind"] == "psi_round_retry"]
    assert [(m["to"], m["attempt"]) for m in retry] == [("owner0", 1)]


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_chaos_matrix_psi_wedge_retries(backend, clean_ids):
    """wedge_psi: owner0's actor hangs on the first blind chunk; the
    round times out after ``timeout`` and the retry at generation 1
    aligns the fault-free IDs."""
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv(faults.CHAOS_ENV, "owner0:wedge_psi")
        s = _session()
        t0 = time.monotonic()
        # the wedged thread outlives its join: the queue warns of the leak
        leak = (pytest.warns(RuntimeWarning, match="leaked")
                if backend == "queue" else contextlib.nullcontext())
        with leak:
            s.resolve(group=GROUP, backend=backend, retries=1,
                      timeout=3.0)
    assert time.monotonic() - t0 < 60.0
    ev = [(e["party"], e["action"], e["attempt"]) for e in s.recovery_events]
    assert ev == [("owner0", "psi_retry", 1)]
    assert "timed out" in s.recovery_events[0]["error"]
    assert s.scientist.ids == clean_ids


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_psi_retry_wire_accounting_and_cache_hygiene(backend):
    """A crashed attempt folds none of its bytes into ``per_party_wire``
    (only the verified attempt is measured) and leaves nothing stale in
    any cache: the next resolve is the hello-only cached round."""
    clean = _session()
    st_clean = clean.resolve(group=GROUP, backend=backend, timeout=60.0)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv(faults.CHAOS_ENV, "owner0:crash_psi")
        s = _session()
        st = s.resolve(group=GROUP, backend=backend, retries=1,
                       timeout=60.0)
    assert any(e["action"] == "psi_retry" for e in s.recovery_events)
    assert s.scientist.ids == clean.scientist.ids
    for name, wire in st["per_party_wire"].items():
        ref = st_clean["per_party_wire"][name]
        assert wire == ref
    st2 = s.resolve(group=GROUP, backend=backend, timeout=60.0)
    for r in st2["rounds"]:
        assert r["upload_skipped"] and r["server_leg_skipped"]
        assert r["upload_wire_bytes"] == 0
    assert s.scientist.ids == clean.scientist.ids


def test_retry_records_equal_reference():
    """The same plan on both packages (queue, ``retries=2``, a crash on
    owner1's second blind chunk): the same retries, the same stats, and
    the transcripts equal but for the error texts."""
    plan = faults.FaultPlan([faults.Fault(
        "owner1", "crash", "psi_blind_chunk", occurrence=1)]).to_env()
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setenv(faults.CHAOS_ENV, plan)
        ours = _session(160)
        ref = RefSession(*ref_feature_parties(*ref_parties(
            160, seed=0, keep_frac=0.8)))
        kw = dict(group=GROUP, backend="queue", retries=2, chunk_size=32,
                  retry_backoff_s=0.01, timeout=60.0)
        st, rst = ours.resolve(**kw), ref.resolve(**kw)
    assert st == rst
    assert ours.scientist.ids == ref.scientist.ids

    def strip(entries):
        return [{k: v for k, v in e.items() if k != "error"}
                for e in entries]

    assert strip(ours.transcript) == strip(ref.transcript)
    assert strip(ours.recovery_events) == strip(ref.recovery_events)
    assert [e["action"] for e in ours.recovery_events] == ["psi_retry"]
