"""Supervised crash recovery with owners in spawned worker processes
(``fit(backend="process", supervise=True)``): a crash, a wedge and a
corrupt frame each recover to the fault-free supervised run bit for bit,
and so does a crash on the masked sum trunk.  The respawned worker
resumes from its snapshot leaves at generation 1 (where the plan's
generation-0 fault is inert).  Apart from ``test_torch_recovery.py`` so
that the two files run on separate test workers.  CPU only.
"""
import multiprocessing

import pytest
import torch

from test_torch_recovery import (CRASH, FIT_FAULTS, SUM_CFG, clean, events,
                                 fit, plan_env, same_run)

torch.set_num_threads(1)


def test_fault_free_supervised_process_equals_unsupervised():
    """No recovery event without a plan, and the supervised process run
    equals the unsupervised queue run bit for bit (process == queue is
    held unsupervised by test_torch_session)."""
    same_run(clean("process"), fit("queue", supervise=False))
    assert clean("process")[0].transport_stats["recoveries"] == 0


@pytest.mark.parametrize("fault", sorted(FIT_FAULTS))
def test_chaos_matrix_process_recovers_bitwise(fault):
    """The wedged worker runs under the fit's default timeout: the
    supervisor's heartbeats catch it (the queue matrix's wedge is caught
    by a short timeout instead)."""
    ref = clean("process")
    got = fit("process", plan_env(FIT_FAULTS[fault]),
              timeout=None if fault == "wedge_fwd" else 15.0)
    s = got[0]
    assert events(s) == [("owner0", "rollback" if fault == "corrupt_frame"
                          else "respawn", 4 if fault == "corrupt_frame"
                          else 2)]
    if fault == "wedge_fwd":
        assert "unresponsive" in s.recovery_events[0]["error"]
    same_run(got, ref)
    ts = s.transport_stats
    assert ts["recoveries"] == 1 and ts["backend"] == "process"
    if fault != "corrupt_frame":
        # the dead worker's frames are in the record too: owner0's cuts
        # of steps 0-2 from generation 0 and 2-5 from generation 1;
        # owner1's of steps 0-3 (step 3's left before the rollback) and
        # 2-5 again; 64 x 64 f32 each
        cut = 64 * 64 * 4
        assert {n: o["cut_payload_bytes"] for n, o in
                ts["per_owner"].items()} == {"owner0": 7 * cut,
                                             "owner1": 8 * cut}
    assert not multiprocessing.active_children()


def test_masked_crash_process_recovers_bitwise():
    """The respawned worker (generation 1) derives the same steady masks
    (tags ``s{seq}``), so its replayed frames cancel against the
    survivor's."""
    kw = dict(cfg=SUM_CFG, aggregation="masked_sum")
    got = fit("process", plan_env(CRASH), **kw)
    assert events(got[0]) == [("owner0", "respawn", 2)]
    same_run(got, clean("process", **kw))
    assert not multiprocessing.active_children()
