"""Owners of unequal feature widths (``feature_splits``) in the port
against the JAX reference, on the CPU: the model's loss and gradients
from carried list heads (with and without NoPeek), ragged batches, a
joint fit against the reference's, and inside the port lossless split ==
joint bit for bit on the queue and process backends and for the
reference's eight uneven owners.

Inputs are made with numpy from fixed seeds; the reference's params
cross as numpy leaves.
"""
import dataclasses
import multiprocessing

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SplitConfig as RefSplitConfig
from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.core import splitnn as ref_splitnn
from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import batching as ref_batching
from repro.federation import feature_parties as ref_feature_parties
from repro_torch.configs import CONFIG, SplitConfig
from repro_torch.core import splitnn
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, batching, feature_parties
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference, to_numpy

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

SPLITS = (588, 196)
#: the reference's eight-owner case (tests/test_process_transport.py)
EIGHT = (200, 60, 120, 84, 96, 40, 104, 80)
FIT = dict(steps=6, batch_size=32, eval_frac=0.1, verbose=False)


def _cfg(splits, base=CONFIG, split_cls=SplitConfig, **split):
    return dataclasses.replace(base, feature_splits=splits,
                               split=split_cls(n_owners=len(splits),
                                               cut_dim=64, **split))


def _ref_session(splits=SPLITS, n=300):
    s = RefSession(*ref_feature_parties(*ref_parties(
        n, n_owners=len(splits), seed=0, keep_frac=0.9,
        feature_splits=splits)))
    s.resolve(group="modp512")
    s.build(_cfg(splits, REF_CFG, RefSplitConfig))
    return s


def _session(splits=SPLITS, n=300, params=None, **split):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, n_owners=len(splits), seed=0, keep_frac=0.9,
        feature_splits=splits)), device="cpu")
    s.resolve(group="modp512")
    s.build(_cfg(splits, **split), params=params)
    return s


def _same(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))


def _rel(got, want):
    """max |got - want| / max |want| over one leaf."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def test_model_builds_list_heads_at_each_width():
    """Owners of unequal widths get a list of head segments at their own
    widths; equal widths keep the stacked layout; a split that does not
    sum to the features raises the reference's ValueError."""
    m = splitnn.MLPSplitNN(_cfg(SPLITS))
    assert not m.symmetric and m.splits == SPLITS
    heads = m.init(torch.Generator().manual_seed(0))["heads"]
    assert [h[0]["w"].shape for h in heads] == [(588, 64), (196, 64)]
    assert splitnn.MLPSplitNN(CONFIG).symmetric
    with pytest.raises(ValueError, match="inconsistent"):
        splitnn.MLPSplitNN(_cfg((500, 200)))


@pytest.mark.parametrize("nopeek", [0.0, 0.3])
def test_loss_and_grads_match_reference(nopeek):
    """From the reference's carried list heads: the objective, metrics
    and every gradient leaf within rel 1e-5 of the reference's, without
    and with the NoPeek term (one dcor per owner entry, summed).  The
    heads' gradients under NoPeek are the exception: there both packages
    sit 0.6e-5 to 2.2e-5 (rel) from an f64 evaluation of the same
    function, so they are held to rel 1e-4 of the reference's (the
    NoPeek gradient tolerance of tests/test_torch_privacy.py) and of the
    port's own f64 evaluation."""
    cfg = _cfg(SPLITS, nopeek_weight=nopeek)
    rcfg = _cfg(SPLITS, REF_CFG, RefSplitConfig, nopeek_weight=nopeek)
    rmodel = ref_splitnn.MLPSplitNN(rcfg)
    ref = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    xs = [rng.random((32, f), dtype=np.float32) for f in SPLITS]
    y = rng.integers(0, 10, 32).astype(np.int32)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, {"x_slices": xs, "labels": y}),
        has_aux=True)(ref)

    model = splitnn.MLPSplitNN(cfg)

    def run(dtype):
        params = tree_map(lambda t: t.to(dtype).requires_grad_(),
                          from_reference(ref))
        loss, met = model.loss_fn(params, {
            "x_slices": [torch.from_numpy(x).to(dtype) for x in xs],
            "labels": torch.from_numpy(y.astype(np.int64))})
        return loss, met, torch.autograd.grad(loss, tree_leaves(params))

    loss, met, grads = run(torch.float32)
    assert _rel(loss.item(), float(rloss)) < 1e-5
    assert _rel(met["loss"].item(), float(rmet["loss"])) < 1e-5
    assert met["accuracy"].item() == pytest.approx(float(rmet["accuracy"]))
    n_head = len(tree_leaves(ref["heads"]))
    f64 = run(torch.float64)[2]
    for i, (g, r) in enumerate(zip(grads, jax.tree.leaves(rgrads))):
        assert g.shape == r.shape
        limit = 1e-4 if nopeek and i < n_head else 1e-5
        assert _rel(g.numpy(), r) < limit
        assert _rel(g.numpy(), f64[i].numpy()) < limit


def test_imbalanced_feature_slices_stay_ragged():
    rng = np.random.default_rng(0)
    slices = [rng.normal(size=(8, 588)), rng.normal(size=(8, 196))]
    out = batching.stack_feature_slices(slices)
    assert isinstance(out, list) and out[0].shape == (8, 588)
    assert isinstance(ref_batching.stack_feature_slices(slices), list)
    batch = batching.feature_batch(slices, np.zeros(8, np.int32))
    assert isinstance(batch["x_slices"], list)
    assert [tuple(x.shape) for x in batch["x_slices"]] == [(8, 588),
                                                           (8, 196)]
    even = batching.stack_feature_slices([slices[1], slices[1]])
    assert even.shape == (2, 8, 196)


def test_list_heads_carry_across_exactly():
    """``from_reference`` / ``to_numpy`` carry list heads leaf for leaf."""
    ref = jax.tree.map(np.asarray, ref_splitnn.MLPSplitNN(_cfg(
        SPLITS, REF_CFG, RefSplitConfig)).init(jax.random.PRNGKey(0)))
    back = to_numpy(from_reference(ref))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_joint_fit_matches_reference():
    """A joint fit from the reference's carried params: the loss trail
    and the eval loss within rel 1e-4 of the reference's."""
    ref = _ref_session()
    hr = ref.fit(**FIT)
    ours = _session(params=from_reference(jax.tree.map(
        np.asarray, _ref_session().params)))
    h = ours.fit(**FIT)
    np.testing.assert_allclose([r["loss"] for r in h["train"]],
                               [r["loss"] for r in hr["train"]], rtol=1e-4)
    np.testing.assert_allclose(h["eval"][-1]["loss"], hr["eval"][-1]["loss"],
                               rtol=1e-4)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_split_equals_joint_bitwise(backend):
    """Lossless split training of owners of widths 588 and 196 equals the
    joint fit bit for bit (params, loss trail, eval), on thread owners and
    on spawned worker processes."""
    joint = _session()
    hj = joint.fit(**FIT)
    split = _session()
    hs = split.fit(**FIT, mode="split", backend=backend)
    assert _same(joint, split)
    assert hs["loss_trail"] == hj["loss_trail"]
    assert hs["eval"] == hj["eval"]
    assert not multiprocessing.active_children()


def test_eight_uneven_owners_split_equals_joint():
    """The reference's eight owners of uneven widths on the queue: split
    == joint bit for bit, and every owner ships the same cut bytes (the
    cut is (B, 64) whatever the width)."""
    joint = _session(EIGHT, n=256)
    hj = joint.fit(**FIT)
    split = _session(EIGHT, n=256)
    hs = split.fit(**FIT, mode="split", backend="queue")
    assert [o.feature_shape[0] for o in split.owners] == list(EIGHT)
    assert _same(joint, split)
    assert hs["loss_trail"] == hj["loss_trail"]
    per_owner = split.transport_stats["per_owner"]
    assert len(per_owner) == 8
    assert len({v["cut_wire_bytes"] for v in per_owner.values()}) == 1
