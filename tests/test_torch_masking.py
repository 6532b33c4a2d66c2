"""Secure forward aggregation in the port (``repro_torch.core.masking``,
``fit(aggregation="masked_sum")``) against the JAX reference.

Bit for bit against the reference: the fixed-point lift at random
values, exact half-way points k·2^-16 + 2^-17 and clipped values; the
pairwise masks, the owner's encoder, the oracle's fold and the
scientist's reconstruct.  Within the port, bit for bit: masked split ==
the masked joint oracle on every backend, M ∈ {1, 2} and the sequential
schedule.  Against the reference's masked joint fit: train and eval
losses within rtol 1e-4.  Inputs are made with numpy from fixed seeds;
CPU only, at 300 subjects and 4 steps of 64 as the reference's
``tests/test_masked.py``.
"""
import dataclasses
import multiprocessing

import jax
import numpy as np
import pytest
import torch

from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.core import masking as ref_masking
from repro.data import make_vertical_mnist_parties as ref_parties
from repro.federation import VerticalSession as RefSession
from repro.federation import feature_parties as ref_feature_parties
from repro_torch.configs import CONFIG
from repro_torch.core import masking
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

SUM_CFG = dataclasses.replace(CONFIG, split=dataclasses.replace(
    CONFIG.split, combine="sum"))
REF_SUM_CFG = dataclasses.replace(REF_CFG, split=dataclasses.replace(
    REF_CFG.split, combine="sum"))
N = 300
FIT = dict(steps=4, batch_size=64, verbose=False)


def _lift_inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.normal(size=(64, 64)) * 20).astype(np.float32)
    if kind == "halfway":               # k * 2^-16 + 2^-17, both signs
        k = rng.integers(-2 ** 20, 2 ** 20, size=(32, 64))
        return ((k + 0.5) / masking.SCALE).astype(np.float32)
    # at and past the clip: +-256 and beyond
    return np.array([[256.0, -256.0, 256.0001, -300.0, 1e9, -1e9,
                      255.99999, -255.99999]], np.float32)


@pytest.mark.parametrize("kind", ["random", "halfway", "clipped"])
def test_quantize_matches_reference_bitwise(kind):
    x = _lift_inputs(kind)
    want = np.asarray(ref_masking.make_quant_program()(x))
    got = masking.quantize(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # numpy in, the same ints
    assert np.array_equal(masking.quantize(x).numpy(), want)
    if kind == "halfway":             # ties went to even, as jnp.round
        assert np.all(want % 2 == 0)
    back = masking.dequantize(got)
    assert np.array_equal(back.numpy(),
                          np.asarray(ref_masking.dequantize(want)))


def test_module_constants_equal_reference():
    for k in ("MASK_ENV", "SCALE_BITS", "SCALE", "QCLIP", "RING_BYTES"):
        assert getattr(masking, k) == getattr(ref_masking, k)


@pytest.mark.parametrize("n_owners,root", [(2, 0), (3, 17), (5, 2 ** 31)])
def test_pairwise_masks_match_reference_and_cancel(n_owners, root):
    shape = (3, 5)
    total = np.zeros(shape, np.uint32)
    for p in range(n_owners):
        m = masking.pairwise_mask(root, p, n_owners, "s7", shape)
        assert np.array_equal(m, ref_masking.pairwise_mask(
            root, p, n_owners, "s7", shape))
        total = total + m
    assert not total.any()


@pytest.mark.parametrize("n_owners", [2, 3, 5])
def test_encode_fold_reconstruct_match_reference(n_owners):
    """The owner's frame, the oracle's fold and the scientist's fold are
    the reference's bytes; the fold of the masked frames is the unmasked
    sum."""
    rng = np.random.default_rng(n_owners)
    quant = ref_masking.make_quant_program()
    cuts = [(rng.normal(size=(16, 64)) * 10).astype(np.float32)
            for _ in range(n_owners)]
    payloads = []
    for p in range(n_owners):
        ours = masking.MaskedAggregator(11, p, n_owners)
        ref = ref_masking.MaskedAggregator(11, p, n_owners, quant)
        for tag in (ours.step_tag(3), ours.warmup_tag(0)):
            got = ours.encode(torch.from_numpy(cuts[p]), tag)
            want = ref.encode(cuts[p], tag)
            assert set(got) == {"mq"} and got["mq"].dtype == np.uint32
            assert np.array_equal(got["mq"], want["mq"])
        payloads.append(ours.encode(torch.from_numpy(cuts[p]),
                                    ours.step_tag(3)))
    qs = [masking.quantize(torch.from_numpy(c)).numpy() for c in cuts]
    fold = masking.fold_quantized(qs)
    assert np.array_equal(fold, ref_masking.fold_quantized(qs))
    assert np.array_equal(masking.reconstruct(payloads), fold)
    assert np.array_equal(masking.reconstruct(payloads),
                          ref_masking.reconstruct(payloads))


def test_tags_and_the_single_owner_refusal():
    a0 = masking.MaskedAggregator(0, 0, 2, generation=0)
    a1 = masking.MaskedAggregator(0, 0, 2, generation=1)
    r1 = ref_masking.MaskedAggregator(0, 0, 2, None, generation=1)
    assert a0.warmup_tag(0) != a1.warmup_tag(0) == r1.warmup_tag(0)
    assert a0.step_tag(5) == a1.step_tag(5) == r1.step_tag(5)
    with pytest.raises(ValueError, match="2 owners"):
        masking.MaskedAggregator(0, 0, 1)


def test_mask_root_env_channel(monkeypatch):
    monkeypatch.delenv(masking.MASK_ENV, raising=False)
    assert masking.mask_root_from_env(17) == 17
    monkeypatch.setenv(masking.MASK_ENV, "99")
    assert masking.mask_root_from_env(17) == 99


# ---------------------------------------------------------------------------
# fit(aggregation="masked_sum")
# ---------------------------------------------------------------------------


def _session(cfg=SUM_CFG, n=N, params=None):
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device="cpu")
    s.resolve(group="modp512")
    s.build(cfg, params=params)
    return s


def _run(mode, **kw):
    s = _session()
    h = s.fit(**dict(FIT, aggregation="masked_sum", mode=mode, **kw))
    return s, h


_ORACLE: dict = {}


def _oracle(M):
    if M not in _ORACLE:
        s, h = _run("joint", microbatches=M)
        _ORACLE[M] = (tree_leaves(s.params), h)
    return _ORACLE[M]


def _assert_same(s, h, M):
    leaves, ho = _oracle(M)
    assert h["loss_trail"] == ho["loss_trail"]
    assert [r["loss"] for r in h["train"]] == \
        [r["loss"] for r in ho["train"]]
    for a, b in zip(tree_leaves(s.params), leaves):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["direct", "queue", "process"])
@pytest.mark.parametrize("M", [1, 2])
def test_masked_split_bit_identical_to_masked_joint_oracle(backend, M):
    """The masks cancel in the ring, so masked split execution is the
    oracle's computation bit for bit: loss trail and every param leaf."""
    s, h = _run("split", backend=backend, microbatches=M)
    _assert_same(s, h, M)
    ts = s.transport_stats
    assert ts["aggregation"] == "masked_sum"
    assert ts["wire_by_kind"]["cut_activations"]["count"] == 2 * M * 4
    assert not multiprocessing.active_children()


def test_masked_sequential_schedule_bit_identical():
    s, h = _run("split", backend="direct", schedule="sequential")
    _assert_same(s, h, 1)


def test_masked_joint_fit_matches_reference():
    """The port's masked joint oracle from the reference's params against
    the reference's: train and eval losses within rtol 1e-4."""
    kw = dict(FIT, eval_frac=0.1, aggregation="masked_sum")
    ref = RefSession(*ref_feature_parties(*ref_parties(N, seed=0,
                                                       keep_frac=0.9)))
    ref.resolve(group="modp512")
    ref.build(REF_SUM_CFG)
    params = from_reference(jax.tree.map(np.asarray, ref.params))
    hr = ref.fit(**kw)
    h = _session(params=params).fit(**kw)
    np.testing.assert_allclose([r["loss"] for r in h["train"]],
                               [r["loss"] for r in hr["train"]], rtol=1e-4)
    np.testing.assert_allclose([r["loss"] for r in h["eval"]],
                               [r["loss"] for r in hr["eval"]], rtol=1e-4)
    assert [r["step"] for r in h["train"]] == [0, 1, 2, 3]


def test_masked_forward_costs_no_extra_wire_bytes():
    """uint32 ring elements are the 4 bytes per element of the f32 cuts
    they replace: masked and plain forward payload bytes are equal."""
    plain = _session()
    plain.fit(**FIT, mode="split", backend="queue")
    masked, _ = _run("split", backend="queue")
    for o in masked.owners:
        assert masked.transport_stats["per_owner"][o.name][
            "cut_payload_bytes"] == plain.transport_stats["per_owner"][
                o.name]["cut_payload_bytes"] == 4 * 64 * 64 * 4


def test_masked_composes_with_codec_on_gradient_leg():
    """The codec applies to the cut gradients only (the forward is ring
    coded): fp16 halves the gradient bytes, forward bytes are unchanged,
    and the losses track the oracle."""
    s, h = _run("split", backend="queue", compression="fp16")
    base, _ = _run("split", backend="queue")
    for o in s.owners:
        po = s.transport_stats["per_owner"][o.name]
        pb = base.transport_stats["per_owner"][o.name]
        assert po["grad_payload_bytes"] * 2 == pb["grad_payload_bytes"]
        assert po["cut_payload_bytes"] == pb["cut_payload_bytes"]
    np.testing.assert_allclose(h["loss_trail"], _oracle(1)[1]["loss_trail"],
                               rtol=0.05)


@pytest.mark.parametrize("case", ["concat", "one_owner", "bogus"])
def test_masked_fit_refusals(case):
    if case == "concat":
        s = _session(CONFIG, n=120)
        kw, match = dict(aggregation="masked_sum"), "masked_sum"
    elif case == "one_owner":
        one = dataclasses.replace(SUM_CFG, n_features=392,
                                  split=dataclasses.replace(
                                      SUM_CFG.split, n_owners=1))
        sci, owners = make_vertical_mnist_parties(120, seed=0)
        name = sorted(owners)[0]
        s = VerticalSession(*feature_parties(sci, {name: owners[name]}),
                            device="cpu")
        s.resolve(group="modp512")
        s.build(one)
        kw, match = dict(aggregation="masked_sum"), ">= 2 owners"
    else:
        s = _session(n=120)
        kw, match = dict(aggregation="bogus"), "unknown aggregation"
    with pytest.raises(ValueError, match=match):
        s.fit(steps=1, batch_size=16, verbose=False, **kw)


def test_masked_metrics_track_plain_sum_within_quantization():
    """masked_sum is the plain sum combine up to the 2^-16 lift."""
    h_plain = _session().fit(**FIT)
    _, h_mask = _oracle(1)
    np.testing.assert_allclose(h_plain["loss_trail"], h_mask["loss_trail"],
                               atol=1e-3)


def test_fit_steps_stream_and_arguments():
    """``steps`` draws the reference's index stream (a fresh permutation
    when the rest cannot fill a batch); exactly one of epochs/steps."""
    ours, ref = _session(n=120), RefSession(*ref_feature_parties(
        *ref_parties(120, seed=0, keep_frac=0.9)))
    ref.resolve(group="modp512")
    n_train = len(ours.scientist.ids)
    for s in (ours, ref):
        s._train_idx = np.arange(n_train)
    a = list(ours._index_stream(np.random.default_rng(3), n_train, 32,
                                None, 9))
    b = list(ref._index_stream(np.random.default_rng(3), n_train, 32,
                               None, 9))
    assert len(a) == 9 and all(np.array_equal(x, y) for x, y in zip(a, b))
    for kw in (dict(), dict(epochs=1, steps=2)):
        with pytest.raises(ValueError, match="exactly one"):
            ours.fit(batch_size=32, verbose=False, **kw)
