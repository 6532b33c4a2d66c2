"""Per-party checkpoints in the port against the JAX reference, on the
CPU: the reference's own checkpoint tests on the port, files read across
both packages with equal leaves, owners of unequal widths (one file
each, each one the reference's ``restore`` reads), owner files in
numeric order, a checkpoint -> restore -> resume round trip on the queue
and process backends, and ``fit(ckpt_every=...)``: the reference's
steps, and a run equal to one without checkpoints, bit for bit.
"""
import dataclasses
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.core import splitnn as ref_splitnn
from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import feature_parties as ref_feature_parties
from repro_torch import checkpoint as ckpt
from repro_torch.configs import CONFIG, SplitConfig
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)


def _params(n_owners=2, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    heads = {"w": t(n_owners, 8, 4),
             "blocks": [{"s": torch.ones(n_owners, 3)},
                        {"s": torch.zeros(n_owners, 3)}]}
    trunk = {"w": t(8, 10), "b": torch.zeros(10)}
    return {"heads": heads, "trunk": trunk}


def _equal_leaves(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the reference's tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    p = _params()
    path = os.path.join(tmp_path, "tree.npz")
    ckpt.save(path, p)
    r = ckpt.restore(path)
    _equal_leaves(p, r)
    assert isinstance(r["heads"]["blocks"], list)


def test_split_checkpoint_per_party(tmp_path):
    p = _params()
    d = ckpt.save_split(str(tmp_path), p, step=7)
    assert os.path.basename(d) == "step_00000007"
    assert sorted(os.listdir(d)) == ["owner0.npz", "owner1.npz",
                                     "trunk.npz"]
    _equal_leaves(p, ckpt.restore_split(d))


def test_owner_file_contains_only_own_segment(tmp_path):
    p = _params()
    d = ckpt.save_split(str(tmp_path), p, step=0)
    o0 = ckpt.restore(os.path.join(d, "owner0.npz"))
    np.testing.assert_array_equal(o0["w"], p["heads"]["w"][0].numpy())
    # owner 0's file must not hold owner 1's weights
    assert not np.array_equal(o0["w"], p["heads"]["w"][1].numpy())


# ---------------------------------------------------------------------------
# files across the two packages
# ---------------------------------------------------------------------------


def test_files_read_across_packages(tmp_path):
    """The MLP's params at the paper's widths: the port's files restore
    in the reference with equal leaves, and the reference's in the
    port."""
    ref = jax.tree.map(np.asarray, ref_splitnn.MLPSplitNN(REF_CFG).init(
        jax.random.PRNGKey(0)))
    ours = from_reference(ref)
    d = ckpt.save_split(str(tmp_path / "port"), ours, step=3)
    back = ref_ckpt.restore_split(d)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    d = ref_ckpt.save_split(str(tmp_path / "ref"), ref, step=3)
    _equal_leaves(ckpt.restore_split(d), ours)


def test_unequal_widths_one_file_per_owner(tmp_path):
    """List heads (owners of widths 588 and 196): three files, each owner
    file equal to that owner's head under the reference's ``restore``,
    and a list of heads back from ``restore_split``."""
    cfg = dataclasses.replace(CONFIG, feature_splits=(588, 196))
    from repro_torch.core.splitnn import MLPSplitNN
    params = MLPSplitNN(cfg).init(torch.Generator().manual_seed(0))
    d = ckpt.save_split(str(tmp_path), params, step=1)
    assert sorted(os.listdir(d)) == ["owner0.npz", "owner1.npz",
                                     "trunk.npz"]
    for p, head in enumerate(params["heads"]):
        _equal_leaves(ref_ckpt.restore(os.path.join(d, f"owner{p}.npz")),
                      head)
    back = ckpt.restore_split(d)
    assert isinstance(back["heads"], list) and len(back["heads"]) == 2
    _equal_leaves(back, params)


def test_owner_files_in_numeric_order(tmp_path):
    """At 12 owners ``owner10`` and ``owner11`` come after ``owner9``:
    each owner's segment comes back at its own index."""
    p = _params(n_owners=12)
    d = ckpt.save_split(str(tmp_path), p, step=0)
    back = ckpt.restore_split(d)
    np.testing.assert_array_equal(back["heads"]["w"], p["heads"]["w"])
    _equal_leaves(back, p)


# ---------------------------------------------------------------------------
# the session: checkpoint, restore, fit(ckpt_every=)
# ---------------------------------------------------------------------------


def _session(n=300, **cfg):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device="cpu")
    s.resolve(group="modp512")
    s.build(dataclasses.replace(CONFIG, **cfg))
    return s


def _ref_session(n=300):
    s = RefSession(*ref_feature_parties(*ref_parties(n, seed=0,
                                                     keep_frac=0.9)))
    s.resolve(group="modp512")
    s.build(REF_CFG)
    return s


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_checkpoint_restore_resume_round_trip(tmp_path, backend):
    """The reference's round trip (tests/test_recovery.py): a donor's
    checkpoint restores into a fresh session bit for bit, and training
    picks up from it: the first resumed loss near the donor's last."""
    kw = dict(batch_size=64, eval_frac=0.2, verbose=False, mode="split",
              backend=backend)
    donor = _session()
    donor.fit(steps=6, **kw)
    step_dir = donor.checkpoint(str(tmp_path), step=6)
    donor_eval = donor.evaluate()

    resumed = _session()
    resumed.restore(step_dir)
    _equal_leaves(resumed.params, donor.params)
    h = resumed.fit(steps=2, **kw)
    assert h["train"][0]["loss"] == pytest.approx(
        donor.history["train"][-1]["loss"], rel=0.35)
    assert set(resumed.evaluate()) == set(donor_eval)
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("unit,backend", [
    ("epochs", "queue"), ("steps", "queue"), ("steps", "process")])
def test_fit_ckpt_every_steps_and_bits(tmp_path, unit, backend):
    """``fit(ckpt_dir=, ckpt_every=)`` writes at the reference's points
    (every ``ckpt_every`` epochs, or steps in steps mode), the run equals
    the same run without checkpoints bit for bit (params, loss trail,
    eval), and in steps mode the step-6 files hold a 6-step run's
    params."""
    run = dict(epochs=3) if unit == "epochs" else dict(steps=7)
    kw = dict(run, batch_size=64, eval_frac=0.2, verbose=False)
    every = 2 if unit == "epochs" else 3
    ref = _ref_session()
    ref.fit(**kw, ckpt_dir=str(tmp_path / "ref"), ckpt_every=every)
    want = sorted(os.listdir(tmp_path / "ref"))

    plain = _session()
    hp = plain.fit(**kw, mode="split", backend="queue")
    ours = _session()
    h = ours.fit(**kw, mode="split", backend=backend,
                 ckpt_dir=str(tmp_path / "port"), ckpt_every=every)
    assert sorted(os.listdir(tmp_path / "port")) == want
    assert want == (["step_00000002"] if unit == "epochs"
                    else ["step_00000003", "step_00000006"])
    assert len(ours.transport_stats["ckpt_s"]) == len(want)
    _equal_leaves(ours.params, plain.params)
    assert h["loss_trail"] == hp["loss_trail"]
    assert h["eval"] == hp["eval"]
    if unit == "epochs":
        return
    six = _session()
    six.fit(**dict(kw, steps=6), mode="split", backend="queue")
    _equal_leaves(ckpt.restore_split(str(tmp_path / "port" /
                                         "step_00000006")), six.params)


def test_session_checkpoint_files_equal_reference(tmp_path):
    """The session's checkpoint of the same params writes the
    reference's files: the same names and, per file, the same keys and
    arrays."""
    ref = _ref_session()
    ours = _session()
    ours.build(CONFIG, params=from_reference(jax.tree.map(np.asarray,
                                                          ref.params)))
    dr = ref.checkpoint(str(tmp_path / "ref"), step=4)
    dp = ours.checkpoint(str(tmp_path / "port"), step=4)
    assert sorted(os.listdir(dr)) == sorted(os.listdir(dp))
    for f in os.listdir(dr):
        with np.load(os.path.join(dr, f)) as a, \
                np.load(os.path.join(dp, f)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_restore_checks_the_built_model(tmp_path):
    """A checkpoint of another model's shapes is refused."""
    s = _session()
    d = s.checkpoint(str(tmp_path), step=0)
    other = _session(split=SplitConfig(combine="sum", cut_dim=64))
    with pytest.raises(ValueError, match="does not fit"):
        other.restore(d)


def test_restore_requires_built():
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        60, seed=0)), device="cpu")
    with pytest.raises(RuntimeError):
        s.restore("/nonexistent")
    with pytest.raises(RuntimeError):
        s.checkpoint("/nonexistent")
