"""The cut-layer privacy defences in the port (``repro_torch.core.privacy``
and their wiring through ``VerticalSession``) against the JAX reference.

The reference's own dcor/NoPeek tests fail on this tree, and its split
NoPeek fit trails NaN (its warmup runs the NoPeek gradient on a batch of
one repeated row), so the port is held to the reference's function
outputs at fixed inputs:

* bit for bit: the wire noise, all three cut-gradient modes with and
  without noise, the norm attack's AUC;
* within atol 1e-5: the distance correlation and the NoPeek penalty;
  within rtol 1e-4, atol 2e-6, and no farther from an f64 evaluation
  than the reference: the dcor gradient and the NoPeek head backward on
  a batch with distinct rows; the joint NoPeek and defended split fits
  from shared params within rtol 1e-4 in loss;
* within the port: the split NoPeek fit is finite, moves its heads ten
  times farther from weight 0's than from its oracle's, and tracks the joint NoPeek fit (rtol 1e-4), and the warmup
  leaves params bitwise unchanged with NoPeek on.

Inputs are made with numpy from fixed seeds (no hypothesis deadline).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.core import privacy as ref_privacy
from repro.core import splitnn as ref_splitnn
from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import feature_parties as ref_feature_parties
from repro_torch.configs import CONFIG
from repro_torch.core import privacy, splitnn
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

N = 300
FIT = dict(steps=4, batch_size=64, verbose=False)


def _cfg(cfg, **split):
    return dataclasses.replace(cfg, split=dataclasses.replace(
        cfg.split, combine="sum", **split))


def _relu_cut(seed, b=64):
    """A raw owner slice (b, 392) and a real ReLU head cut (b, 64)."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, 392), dtype=np.float32)
    w = (rng.normal(size=(392, 64)) * np.sqrt(2 / 392)).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    return x, np.maximum(x @ w + bias, 0).astype(np.float32)


def _dcor64(x, z):
    """An independent f64 evaluation of the distance correlation (the
    same formula, no f32 cast), to measure both packages' rounding."""
    def dist(a):
        a = a.reshape(a.shape[0], -1)
        sq = (a * a).sum(1)
        return torch.sqrt(torch.clamp_min(
            sq[:, None] + sq[None, :] - 2 * (a @ a.T), 1e-12))

    def center(d):
        return d - d.mean(0, keepdim=True) - d.mean(1, keepdim=True) \
            + d.mean()

    a, b = center(dist(x)), center(dist(z))
    var = torch.sqrt(torch.sqrt((a * a).mean())
                     * torch.sqrt((b * b).mean()))
    return torch.sqrt(torch.clamp_min((a * b).mean(), 0.0)) / var


def _no_farther_from_f64(got, want, truth):
    """The port's f32 result is at least as close to the f64 evaluation
    as the reference's f32 result is."""
    assert np.abs(got - truth).max() <= np.abs(want - truth).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distance_correlation_matches_reference(seed):
    x, z = _relu_cut(seed)
    got = privacy.distance_correlation(torch.from_numpy(x),
                                       torch.from_numpy(z))
    want = ref_privacy.distance_correlation(x, z)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)
    # a batch against itself is fully dependent
    assert privacy.distance_correlation(
        torch.from_numpy(x), torch.from_numpy(x)).item() == \
        pytest.approx(1.0, abs=1e-5)


def test_distance_correlation_gradient_where_d2_goes_negative():
    """On a real ReLU cut ``d2`` rounds below zero on the diagonal and
    off it; the floor's gradient there is 0, as ``jnp.maximum`` gives a
    strict loser, so the gradient is finite and tracks the reference's:
    within atol 2e-6 (rtol 1e-4) of it, and no farther from an f64
    evaluation than it (both sit ~1e-6 from f64: the centred distance
    matrices cancel most of their f32 digits)."""
    x, z = _relu_cut(4)
    z[1] = z[0]                         # a repeated row: exact zeros too
    zt = torch.from_numpy(z).requires_grad_()
    xt = torch.from_numpy(x)
    d = zt @ zt.T
    sq = (zt * zt).sum(1)
    assert ((sq[:, None] + sq[None, :] - 2 * d) < 0).any()
    g, = torch.autograd.grad(privacy.distance_correlation(xt, zt), zt)
    want = np.asarray(jax.grad(
        lambda c: ref_privacy.distance_correlation(x, c))(z))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=2e-6)
    z64 = torch.from_numpy(z).double().requires_grad_()
    truth, = torch.autograd.grad(_dcor64(xt.double(), z64), z64)
    _no_farther_from_f64(g.numpy(), want, truth.numpy())


@pytest.mark.parametrize("seed,weight", [(0, 0.3), (1, 1.0), (2, 0.0)])
def test_nopeek_penalty_matches_reference_stacked(seed, weight):
    """The stacked (P, B, F) x (P, B, k) layout: one dcor per owner,
    summed and weighted (the reference's vmap)."""
    pairs = [_relu_cut(seed * 10 + p) for p in range(2)]
    xs = np.stack([p[0] for p in pairs])
    zs = np.stack([p[1] for p in pairs])
    got = privacy.nopeek_penalty(torch.from_numpy(xs), torch.from_numpy(zs),
                                 weight)
    want = ref_privacy.nopeek_penalty(jnp.asarray(xs), jnp.asarray(zs),
                                      weight)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)


def _ref_model_and_slice(nopeek):
    cfg = _cfg(REF_CFG, nopeek_weight=nopeek)
    model = ref_splitnn.MLPSplitNN(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3)))
    hp = jax.tree.map(lambda a: a[0], params["heads"])
    return model, params, hp


def test_nopeek_head_backward_matches_reference():
    """The owner's head backward with the NoPeek term, on a batch with
    distinct rows, against ``make_mlp_head_programs(m, 0.3)[1]``: within
    rtol 1e-4, atol 2e-6, and no farther from an f64 evaluation than the
    reference (the reference's own f32 result is 1.55e-6 from it)."""
    rmodel, params, hp = _ref_model_and_slice(0.3)
    rng = np.random.default_rng(5)
    x = rng.random((64, 392), dtype=np.float32)
    g = (rng.normal(size=(64, 64)) * 1e-2).astype(np.float32)
    want = ref_splitnn.make_mlp_head_programs(rmodel, 0.3)[1](hp, x, g)
    model = splitnn.MLPSplitNN(_cfg(CONFIG, nopeek_weight=0.3))
    ours = splitnn.head_slice(from_reference(params)["heads"], 0)
    _, head_bwd = splitnn.make_mlp_head_programs(model, 0.3)
    got = head_bwd(ours, torch.from_numpy(x), torch.from_numpy(g))
    leaves = [t.double().requires_grad_() for t in tree_leaves(ours)]
    x64 = torch.from_numpy(x).double()
    out = model.head_apply([dict(zip(("b", "w"), leaves))], x64)
    truth = [a + b for a, b in zip(
        torch.autograd.grad(out, leaves, torch.from_numpy(g).double(),
                            retain_graph=True),
        torch.autograd.grad(0.3 * _dcor64(x64, out), leaves))]
    for a, b, t in zip(tree_leaves(got), jax.tree.leaves(want), truth):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=2e-6)
        _no_farther_from_f64(a.numpy(), np.asarray(b), t.numpy())
    # the NoPeek term is really there, and nopeek=False drops it exactly
    plain = splitnn.make_mlp_head_programs(model)[1](
        ours, torch.from_numpy(x), torch.from_numpy(g))
    off = head_bwd(ours, torch.from_numpy(x), torch.from_numpy(g),
                   nopeek=False)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(off),
                                                 tree_leaves(plain)))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(plain)))


def test_gaussian_cut_noise_from_a_generator():
    cut = torch.ones(8, 4)
    assert privacy.gaussian_cut_noise(torch.Generator(), cut, 0.0) is cut
    a = privacy.gaussian_cut_noise(torch.Generator().manual_seed(1), cut,
                                   2.0)
    b = privacy.gaussian_cut_noise(torch.Generator().manual_seed(1), cut,
                                   2.0)
    assert torch.equal(a, b) and not torch.equal(a, cut)
    assert abs((a - cut).std().item() - 2.0) < 0.8


@pytest.mark.parametrize("std", [0.0, 0.5, 2.0])
def test_deterministic_cut_noise_matches_reference(std):
    cut = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    got = privacy.deterministic_cut_noise(cut, std, 7, "s3")
    want = ref_privacy.deterministic_cut_noise(cut, std, 7, "s3")
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(privacy._wire_rng(7, "s3").standard_normal(5),
                          ref_privacy._wire_rng(7, "s3").standard_normal(5))


@pytest.mark.parametrize("mode", ["none", "unit", "sign"])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_obfuscate_cut_gradient_matches_reference(mode, noise):
    g = (np.random.default_rng(1).normal(size=(64, 64)) * 1e-2).astype(
        np.float32)
    g[3] = 0.0                                 # a zero row: norm floor
    kw = dict(noise_std=noise, norm_mode=mode, seed=4, tag="g2o1")
    got = privacy.obfuscate_cut_gradient(g, **kw)
    want = ref_privacy.obfuscate_cut_gradient(g, **kw)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="grad_norm_mode"):
        privacy.obfuscate_cut_gradient(g, norm_mode="bogus")


@pytest.mark.parametrize("seed", [0, 1])
def test_label_inference_auc_matches_reference(seed):
    rng = np.random.default_rng(seed)
    y = rng.random(200) < 0.1
    norms = rng.random(200) + 0.5 * y
    norms[:20] = norms[20:40]                  # ties count half
    assert privacy.label_inference_auc(norms, y) == \
        ref_privacy.label_inference_auc(norms, y)
    assert privacy.label_inference_auc(norms, np.zeros(200)) == 0.5


# ---------------------------------------------------------------------------
# fits through VerticalSession
# ---------------------------------------------------------------------------


#: the rtol within which a fit is held to its oracle's loss trail
RTOL = 1e-4
#: a wire defence must move the loss trail by ten times that, so that a
#: path that lost the defence could not pass the comparison by rounding
MOVED = 10 * RTOL


def _max_rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _heads(params):
    """The owners' head params as one f64 vector."""
    return torch.cat([torch.from_numpy(np.array(t, np.float64)).flatten()
                      for t in tree_leaves(params["heads"])])


def _assert_nopeek_reached_heads(nopeek, plain, oracle):
    """Over 4 steps NoPeek moves the loss trail by only a few times
    RTOL, so the trail alone cannot show that the penalty reached the
    heads.  The head params can: the NoPeek run must lie at least ten
    times closer to its oracle than to the weight-0 run."""
    moved = torch.linalg.norm(_heads(nopeek) - _heads(plain))
    off = torch.linalg.norm(_heads(nopeek) - _heads(oracle))
    assert 10 * off <= moved, (off.item(), moved.item())


def _ref_session(**split):
    s = RefSession(*ref_feature_parties(*ref_parties(N, seed=0,
                                                     keep_frac=0.9)))
    s.resolve(group="modp512")
    s.build(_cfg(REF_CFG, **split))
    return s


def _session(params=None, **split):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        N, seed=0, keep_frac=0.9)), device="cpu")
    s.resolve(group="modp512")
    s.build(_cfg(CONFIG, **split), params=params)
    return s


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, _ref_session().params)


_JOINT_NOPEEK: dict = {}


def _joint_nopeek(ref_params):
    if not _JOINT_NOPEEK:
        s = _session(from_reference(ref_params), nopeek_weight=0.3)
        _JOINT_NOPEEK["h"] = s.fit(**FIT, eval_frac=0.1)
        _JOINT_NOPEEK["params"] = s.params
    return _JOINT_NOPEEK["h"], _JOINT_NOPEEK["params"]


def test_joint_nopeek_fit_matches_reference(ref_params):
    """The joint NoPeek fit (the objective's gradient, not the bare
    NLL's) against the reference's, which is finite: train and eval
    losses within rtol 1e-4; the NoPeek term moves the trail by more
    than that, and the heads ten times farther than the reference's."""
    ref = _ref_session(nopeek_weight=0.3)
    hr = ref.fit(**FIT, eval_frac=0.1)
    h, params = _joint_nopeek(ref_params)
    np.testing.assert_allclose(h["loss_trail"],
                               [r["loss"] for r in hr["train"]], rtol=RTOL)
    np.testing.assert_allclose([r["loss"] for r in h["eval"]],
                               [r["loss"] for r in hr["eval"]], rtol=RTOL)
    plain = _session(from_reference(ref_params))
    h0 = plain.fit(**FIT, eval_frac=0.1)
    assert _max_rel_gap(h["loss_trail"], h0["loss_trail"]) > RTOL
    _assert_nopeek_reached_heads(params, plain.params, ref.params)


@pytest.mark.parametrize("backend", ["queue", "direct"])
def test_split_nopeek_fit_is_finite_and_tracks_joint(ref_params, backend):
    """The reference's split NoPeek trail is NaN (its warmup); the
    port's is finite, tracks the port's joint NoPeek fit within rtol
    1e-4 while moving farther than that from weight 0, and its heads lie
    ten times closer to the joint NoPeek run's than to weight 0's."""
    hj, joint = _joint_nopeek(ref_params)
    s = _session(from_reference(ref_params), nopeek_weight=0.3)
    h = s.fit(**FIT, eval_frac=0.1, mode="split", backend=backend)
    assert all(np.isfinite(h["loss_trail"]))
    assert all(torch.isfinite(t).all() for t in tree_leaves(s.params))
    np.testing.assert_allclose(h["loss_trail"], hj["loss_trail"], rtol=RTOL)
    plain = _session(from_reference(ref_params))
    h0 = plain.fit(**FIT, eval_frac=0.1, mode="split", backend=backend)
    assert _max_rel_gap(h["loss_trail"], h0["loss_trail"]) > RTOL
    _assert_nopeek_reached_heads(s.params, plain.params, joint)


@pytest.mark.parametrize("backend", ["queue", "process"])
def test_warmup_is_a_bitwise_noop_with_nopeek(backend):
    """``fit(steps=0)`` runs only the warmup handshake, whose batch is
    one row repeated (the reference's NaN case): with NoPeek on, every
    param comes back bitwise as built, and finite."""
    s = _session(nopeek_weight=0.3)
    built = [t.clone() for t in tree_leaves(s.params)]
    h = s.fit(steps=0, batch_size=64, verbose=False, mode="split",
              backend=backend)
    assert h["loss_trail"] == [] and s.transport_stats["steps"] == 0
    for a, b in zip(tree_leaves(s.params), built):
        assert torch.equal(a, b)


@pytest.mark.parametrize("defence", [
    dict(cut_noise_std=2.0), dict(grad_norm_mode="unit"),
    dict(grad_norm_mode="sign"), dict(grad_noise_std=0.05)])
def test_defended_split_fit_matches_reference(ref_params, defence):
    """The wire defences are the reference's bytes, so a defended split
    fit from shared params tracks the reference's: losses within rtol
    1e-4, and the defence moves the trail by ten times that."""
    kw = dict(FIT, mode="split", backend="queue")
    hr = _ref_session(**defence).fit(**kw)
    s = _session(from_reference(ref_params), **defence)
    h = s.fit(**kw)
    np.testing.assert_allclose(h["loss_trail"],
                               [r["loss"] for r in hr["train"]], rtol=1e-4)
    plain = _session(from_reference(ref_params)).fit(**kw)
    assert _max_rel_gap(h["loss_trail"], plain["loss_trail"]) >= MOVED


def test_cut_noise_is_ignored_under_masking(ref_params):
    """Masked cuts are ring-coded, and the owner's noise does not apply
    to them (as in the reference): the masked run with cut noise is the
    masked run without it, bit for bit."""
    runs = []
    for std in (0.0, 2.0):
        s = _session(from_reference(ref_params), cut_noise_std=std)
        runs.append((s, s.fit(**FIT, mode="split", backend="queue",
                              aggregation="masked_sum")))
    (a, ha), (b, hb) = runs
    assert ha["loss_trail"] == hb["loss_trail"]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))


def test_head_param_trees_move_with_nopeek_joint_gradient():
    """``make_split_train_step`` differentiates the objective: with
    NoPeek on, the heads' step differs from the bare NLL's, the trunk's
    does not (the penalty does not reach the trunk)."""
    from repro_torch.optim import multi_segment, sgd
    model = splitnn.MLPSplitNN(_cfg(CONFIG, nopeek_weight=0.3))
    base = splitnn.MLPSplitNN(_cfg(CONFIG))
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"x_slices": torch.from_numpy(rng.random((2, 32, 392),
                                                     dtype=np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, 32))}
    opt = multi_segment({"heads": sgd(0.01), "trunk": sgd(0.1)})
    out = []
    for m in (model, base):
        p = tree_map(torch.clone, params)
        p, _, metrics = splitnn.make_split_train_step(m.loss_fn, opt)(
            p, opt.init(p), batch, 0)
        out.append((p, metrics))
    (pn, mn), (pb, mb) = out
    assert torch.equal(mn["loss"], mb["loss"])        # the bare NLL
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pn["trunk"]),
                                                 tree_leaves(pb["trunk"])))
    assert not torch.equal(pn["heads"][0]["w"], pb["heads"][0]["w"])
