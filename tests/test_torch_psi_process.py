"""The port's PSI on the process backend, on the CPU: a spawned PSI
worker's lifecycle and its import chain (no torch, no jax, no ``repro``
in a fresh interpreter), process resolves against the JAX package's key
for key in every mode, repeat and delta resolves through the owners'
mirrored caches, and hidden process == queue.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.psi import GROUPS
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties
from repro_torch.federation import runtime
from repro_torch.federation.parties import DataOwner

from test_torch_psi_session import assert_same_resolve, twin_sessions

torch.set_num_threads(1)

GROUP = "modp512"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _session(n=200, seed=0, keep_frac=0.9):
    return VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=seed, keep_frac=keep_frac)), device="cpu")


def _hello(n_items, chunk_size=4):
    z = np.zeros(16, np.uint8)
    return {"mode": np.frombuffer(b"noinv", np.uint8),
            "group": np.frombuffer(GROUP.encode(), np.uint8),
            "blind_tag": z, "base_tag": z, "server_tag": z,
            "have_resp": np.uint8(0), "n_items": np.int64(n_items),
            "chunk_size": np.int64(chunk_size),
            "nb": np.int64(GROUPS[GROUP][2])}


def test_spawned_psi_worker_lifecycle():
    """Spawn, handshake, clean stop: exit code 0, no error; the worker
    serves the owner's population through the rehydrated state."""
    owner = DataOwner("owner0", [f"id-{i}" for i in range(8)],
                      np.zeros((8, 4), np.float32))
    w = runtime.spawn_psi_worker(owner, group=GROUP, latency_s=0.001)
    try:
        w.endpoint.send("psi_hello", _hello(8))
        m = w.endpoint.recv_kind("psi_hello_ack", timeout=60.0)
        assert int(np.asarray(m.payload["n_server_items"]).reshape(-1)[0]) \
            == 8
        assert w.error is None
    finally:
        try:
            w.endpoint.send("psi_stop", {})
        except RuntimeError:
            pass
        w.shutdown()
    assert w.proc.exitcode == 0 and w.error is None


def _import_log(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("REPRO_CHAOS_PARTY", None)
    out = subprocess.run([sys.executable, "-X", "importtime", "-c", code],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout, [line.rsplit("|", 1)[-1].strip()
                        for line in out.stderr.splitlines()
                        if line.startswith("import time:")]


def test_spawned_psi_worker_imports_no_torch_jax_or_reference():
    """A parent that never loads torch spawns a PSI worker and runs a
    hello against it: no process imports torch, jax or any ``repro``
    module (``-X importtime`` passes to the spawned child, whose
    imports land on the shared stderr), and only the child imports the
    PSI actor's module."""
    code = (
        "import numpy as np\n"
        "from repro_torch.federation import runtime\n"
        "spec = runtime.PSIWorkerSpec(name='owner0', group='modp512', "
        "ids=[f'id-{i}' for i in range(8)])\n"
        "h = runtime._spawn(runtime.psi_worker_main, spec)\n"
        "z = np.zeros(16, np.uint8)\n"
        "h.endpoint.send('psi_hello', {'mode': np.frombuffer(b'noinv', "
        "np.uint8), 'group': np.frombuffer(b'modp512', np.uint8), "
        "'blind_tag': z, 'base_tag': z, 'server_tag': z, "
        "'have_resp': np.uint8(0), 'n_items': np.int64(8), "
        "'chunk_size': np.int64(4), 'nb': np.int64(64)})\n"
        "m = h.endpoint.recv_kind('psi_hello_ack', timeout=60)\n"
        "h.endpoint.send('psi_stop', {})\n"
        "h.shutdown()\n"
        "print('exit', h.proc.exitcode)\n")
    stdout, mods = _import_log(code)
    assert "exit 0" in stdout
    bad = sorted({m for m in mods
                  if m.split(".")[0] in ("torch", "jax", "repro")})
    assert not bad, bad
    assert mods.count("repro_torch.federation.psi_transport") == 1
    assert mods.count("repro_torch.federation.runtime") == 2


def test_process_resolve_loads_torch_in_the_parent_only():
    """A process resolve with a pool of two: torch is imported once (the
    parent's session); the two PSI workers and the pool's workers (the
    pool starts them as work arrives: one or two) import the PSI stack
    without it, and nothing imports jax or ``repro``."""
    code = (
        "from repro_torch.data import make_vertical_mnist_parties\n"
        "from repro_torch.federation import VerticalSession, "
        "feature_parties\n"
        "s = VerticalSession(*feature_parties(*make_vertical_mnist_parties("
        "60, seed=0)), device='cpu')\n"
        "st = s.resolve(group='modp512', backend='process', "
        "parallelism=2, mode='hidden')\n"
        "print('parallelism', st['parallelism'], len(s.scientist.ids))\n")
    stdout, mods = _import_log(code)
    assert stdout.startswith("parallelism 2")
    bad = sorted({m for m in mods if m.split(".")[0] in ("jax", "repro")})
    assert not bad, bad
    assert mods.count("torch") == 1
    assert mods.count("repro_torch.federation.psi_transport") == 3
    assert mods.count("repro_torch.core.modexp") in (4, 5)


@pytest.mark.parametrize("mode,parallelism", [("noinv", 0), ("bloom", 2),
                                              ("hidden", 0)])
def test_process_resolve_equals_reference(mode, parallelism):
    ours, ref = twin_sessions(160, seed=2, keep_frac=0.85, modes=(mode,))
    kw = dict(group=GROUP, mode=mode, backend="process", chunk_size=32,
              parallelism=parallelism)
    st = ours.resolve(**kw)
    assert_same_resolve(ours, ref, st, ref.resolve(**kw))
    assert st["parallelism"] == parallelism
    for wire in st["per_party_wire"].values():
        assert wire["sent_wire_bytes"] > 0 and wire["recv_wire_bytes"] > 0


def test_repeat_and_delta_resolve_on_process_backend():
    """Round 2 with unchanged populations ships the hello only (caches
    mirrored onto the parent's parties across worker generations), and
    ±2 churn takes the delta round."""
    s = _session(200, keep_frac=1.0)
    st1 = s.resolve(group=GROUP, backend="process")
    ids1 = list(s.scientist.ids)
    full_up = max(r["upload_wire_bytes"] for r in st1["rounds"])
    st2 = s.resolve(group=GROUP, backend="process")
    assert s.scientist.ids == ids1
    for r in st2["rounds"]:
        assert r["upload_skipped"] and r["resp_skipped"]
        assert r["server_leg_skipped"]
        assert r["upload_wire_bytes"] < 1024
        assert r["download_wire_bytes"] < 1024
    sci = s.scientist
    pop = list(sci._full.ids)
    sci.update_rows(pop[2:] + ["fresh-0", "fresh-1"], np.concatenate(
        [sci._full.data[2:], np.zeros(2, sci._full.data.dtype)]))
    st3 = s.resolve(group=GROUP, backend="process")
    for r in st3["rounds"]:
        assert r["delta_used"] and r["server_leg_skipped"]
        assert r["upload_wire_bytes"] < 0.05 * full_up
    expect = sorted(set(pop[2:]))
    assert s.scientist.ids == expect
    for o in s.owners:
        assert o.ids == expect


def test_hidden_resolve_process_matches_queue():
    views = {}
    for backend in ("queue", "process"):
        s = _session(150, seed=4, keep_frac=0.85)
        st = s.resolve(group=GROUP, mode="hidden", backend=backend)
        assert st["mode"] == "hidden"
        assert s.scientist.ids and all(
            i.startswith("anon") for i in s.scientist.ids)
        views[backend] = (list(s.scientist.ids),
                          s.scientist._vd.data.tobytes(),
                          [o._vd.data.tobytes() for o in s.owners])
        for o in s.owners:
            assert o.ids == s.scientist.ids
    assert views["queue"] == views["process"]
