"""The port's model, optimizer, data and weight carry-over against the
JAX reference, on the CPU at the paper's widths with small batches.

Inputs are made with numpy from fixed seeds and handed to both
packages; params are the reference's, carried across as numpy leaves.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.core import splitnn as ref_splitnn
from repro.data import synthetic as ref_synth
from repro.optim import multi_segment as ref_multi_segment
from repro.optim import sgd as ref_sgd
from repro_torch.configs import CONFIG
from repro_torch.core import splitnn
from repro_torch.data import synthetic
from repro_torch.optim import apply_updates, multi_segment, sgd
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference, to_numpy

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

B = 32


def _ref_params(seed=0):
    model = ref_splitnn.MLPSplitNN(REF_CFG)
    return model, jax.tree.map(np.asarray,
                               model.init(jax.random.PRNGKey(seed)))


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    x = rng.random((2, b, 392), dtype=np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    return x, y


def _torch_batch(x, y):
    return {"x_slices": torch.from_numpy(x),
            "labels": torch.from_numpy(y.astype(np.int64))}


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_from_reference_round_trips_exactly():
    _, ref = _ref_params()
    ours = from_reference(ref)
    assert [t.dtype for t in tree_leaves(ours)] == [torch.float32] * 6
    back = to_numpy(ours)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # the port's own init has the reference's layout
    own = splitnn.MLPSplitNN(CONFIG).init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [b.shape for b in jax.tree.leaves(ref)]


def test_forward_and_loss_match_reference():
    """Heads, logits and loss within atol=1e-5: f32 products of width
    392/128/500 reduce in another order in XLA and in PyTorch's CPU
    BLAS (about 1e-6 relative), far below 1e-5 at these magnitudes."""
    rmodel, ref = _ref_params()
    x, y = _batch()
    model = splitnn.MLPSplitNN(CONFIG)
    params = from_reference(ref)
    with torch.no_grad():
        cut = model.heads_forward(params["heads"], torch.from_numpy(x))
        logits = model.forward(params, torch.from_numpy(x))
        loss, metrics = model.loss_fn(params, _torch_batch(x, y))
    _close(cut, rmodel.heads_forward(ref["heads"], x), 1e-5)
    _close(logits, rmodel.forward(ref, x), 1e-5)
    rloss, rmetrics = rmodel.loss_fn(ref, {"x_slices": x, "labels": y})
    _close(loss, rloss, 1e-5)
    assert float(metrics["accuracy"]) == float(rmetrics["accuracy"])


def test_one_joint_sgd_step_matches_reference():
    """One joint step (owner lr 0.01, scientist lr 0.1) from the same
    params and batch: params within atol=1e-5 (the forward tolerance
    above, carried through one backward and an lr <= 0.1 update)."""
    rmodel, ref = _ref_params()
    x, y = _batch(1)
    ropt = ref_multi_segment({"heads": ref_sgd(0.01), "trunk": ref_sgd(0.1)})
    rstep = ref_splitnn.make_split_train_step(rmodel.loss_fn, ropt,
                                              donate=False)
    rp, _, rm = rstep(ref, ropt.init(ref), {"x_slices": x, "labels": y}, 0)
    model = splitnn.MLPSplitNN(CONFIG)
    opt = multi_segment({"heads": sgd(0.01), "trunk": sgd(0.1)})
    params = from_reference(ref)
    step = splitnn.make_split_train_step(model.loss_fn, opt)
    p, _, m = step(params, opt.init(params), _torch_batch(x, y), 0)
    _close(m["loss"], rm["loss"], 1e-5)
    for a, b in zip(tree_leaves(to_numpy(p)), jax.tree.leaves(rp)):
        _close(a, b, 1e-5)


def test_sgd_update_matches_reference_bitwise():
    """The update is elementwise f32 (``-lr * g``, then ``p + u``), so it
    equals the reference's bit for bit on the same grads."""
    _, ref = _ref_params()
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), ref)
    ropt = ref_multi_segment({"heads": ref_sgd(0.01), "trunk": ref_sgd(0.1)})
    ru, _ = ropt.update(grads, ropt.init(ref), ref, 0)
    rp = jax.tree.map(np.asarray, jax.tree.map(lambda p, u: p + u, ref, ru))
    opt = multi_segment({"heads": sgd(0.01), "trunk": sgd(0.1)})
    params = from_reference(ref)
    u, _ = opt.update(from_reference(grads), opt.init(params), params, 0)
    for a, b in zip(tree_leaves(to_numpy(apply_updates(params, u))),
                    jax.tree.leaves(rp)):
        assert np.array_equal(a, b)


def test_segment_programs_compose_to_joint_step_bitwise():
    """Inside the port: owner head programs + the scientist's trunk
    programs (fused, and cut-grad/weight-grad halves) + per-segment SGD
    reproduce the joint step bit for bit — the contract split training
    rests on."""
    _, ref = _ref_params(1)
    x, y = _batch(2)
    model = splitnn.MLPSplitNN(CONFIG)
    opt = multi_segment({"heads": sgd(0.01), "trunk": sgd(0.1)})
    params = from_reference(ref)
    joint, _, jm = splitnn.make_split_train_step(model.loss_fn, opt)(
        params, opt.init(params), _torch_batch(x, y), 0)

    head_fwd, head_bwd = splitnn.make_mlp_head_programs(model)
    trunk_step = splitnn.make_mlp_trunk_program(model)
    cutgrad, weightgrad = splitnn.make_mlp_trunk_microbatch_programs(model)
    xs, lab = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    slices = [splitnn.head_slice(params["heads"], p) for p in range(2)]
    cuts = tuple(head_fwd(s, xs[p]) for p, s in enumerate(slices))
    parts, tg, cg = trunk_step(params["trunk"], cuts, lab)
    cg2, parts2 = cutgrad(params["trunk"], cuts, lab, float(B))
    tg2 = weightgrad(params["trunk"], cuts, lab, float(B))
    assert all(torch.equal(a, b) for a, b in zip(cg, cg2))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tg), tree_leaves(tg2)))
    assert torch.equal(parts["loss"], jm["loss"])
    assert torch.equal(parts2["loss"], jm["loss"])
    heads = [apply_updates(s, tree_map(lambda g: g * -0.01,
                                       head_bwd(s, xs[p], cg[p])))
             for p, s in enumerate(slices)]
    split = {"heads": splitnn.stack_heads(heads),
             "trunk": apply_updates(params["trunk"],
                                    tree_map(lambda g: g * -0.1, tg))}
    for a, b in zip(tree_leaves(split), tree_leaves(joint)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_other_combines_match_reference(combine):
    import dataclasses
    from repro.configs.base import SplitConfig as RefSplit
    from repro_torch.configs import SplitConfig
    kw = dict(n_owners=2, cut_layer=1, combine=combine, cut_dim=64)
    rcfg = dataclasses.replace(REF_CFG, split=RefSplit(**kw))
    rmodel = ref_splitnn.MLPSplitNN(rcfg)
    ref = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(4)))
    x, y = _batch(4)
    model = splitnn.MLPSplitNN(dataclasses.replace(
        CONFIG, split=SplitConfig(**kw)))
    with torch.no_grad():
        logits = model.forward(from_reference(ref), torch.from_numpy(x))
    _close(logits, rmodel.forward(ref, x), 1e-5)


def test_unported_options_raise():
    """Options that once raised now build: imbalanced owner widths (list
    heads) and the privacy options (they train since the masked_sum and
    privacy slice)."""
    import dataclasses
    from repro_torch.configs import SplitConfig
    cfg = dataclasses.replace(CONFIG, feature_splits=(300, 484))
    assert not splitnn.MLPSplitNN(cfg).symmetric
    splitnn.MLPSplitNN(dataclasses.replace(CONFIG, split=SplitConfig(
        nopeek_weight=0.1, cut_noise_std=1.0, grad_noise_std=0.1,
        grad_norm_mode="sign")))


def test_data_generators_match_reference():
    X, y = synthetic.make_mnist_like(64, seed=5)
    rX, ry = ref_synth.make_mnist_like(64, seed=5)
    assert np.array_equal(X, rX) and np.array_equal(y, ry)
    sci, owners = synthetic.make_vertical_mnist_parties(120, seed=3)
    rsci, rowners = ref_synth.make_vertical_mnist_parties(120, seed=3)
    assert sci.ids == rsci.ids and np.array_equal(sci.data, rsci.data)
    assert list(owners) == list(rowners)
    for k in owners:
        assert owners[k].ids == rowners[k].ids
        assert np.array_equal(owners[k].data, rowners[k].data)


def test_cut_layer_traffic_matches_reference():
    for args in ((2, 128, 1, 64, 4), (4, 64, 16, 32, 2)):
        assert splitnn.cut_layer_traffic(*args) == \
            ref_splitnn.cut_layer_traffic(*args)
