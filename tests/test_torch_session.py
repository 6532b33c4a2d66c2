"""The port's training path end to end against the JAX reference:
PSI resolution and alignment, joint and split fits from shared params,
the wire's per-kind byte accounting, and split == joint bitwise inside
the port.  CPU only, at n=400 rows as the reference's transport tests.
"""
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


@pytest.mark.parametrize("kw,item", [
    (dict(supervise=True), "supervise"),
    (dict(aggregation="masked_sum"), "masked_sum"),
    (dict(mode="split", backend="process"), "process backend"),
    (dict(microbatches=2), "microbatches"),
    (dict(ckpt_dir="x"), "checkpointing")])
def test_unported_fit_options_raise(kw, item):
    s = _session(120)
    with pytest.raises(NotImplementedError, match=item):
        s.fit(epochs=1, batch_size=32, verbose=False, **kw)


def test_unported_resolve_options_raise():
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        40, seed=0)), device="cpu")
    for kw in (dict(mode="bloom"), dict(parallelism=2),
               dict(backend="queue")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            s.resolve(group="modp512", **kw)


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
