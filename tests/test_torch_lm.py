"""The port's split LM (``SplitModel`` on llama3.2-3b, reduced) against
the JAX reference, on the CPU, from shared params.

Two depths: reduced with ``n_layers=4`` (3 head units per owner, 1 trunk
unit) and reduced as it is (``n_layers=1``: zero head units, the head is
the embedding alone).  In f32 compute the logits agree within rel 1e-4
(max |diff| / max |ref|); in the default bf16 compute within atol 5e-2.
Also here: the config registry, the parameter tree's carriage between
the packages, and the numpy data and batching helpers (bitwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import make_token_dataset as ref_make_token_dataset
from repro.federation import batching as ref_batching
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.data import make_token_dataset
from repro_torch.federation import batching
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference, to_numpy

torch.set_num_threads(1)

DEPTHS = [4, 1]
COMPUTE = ["float32", "bfloat16"]


def _check(got, want, compute):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if compute == "float32":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= 5e-2, err


def _pair(n_layers, compute):
    ref_cfg = ref_get_config("llama3.2-3b", reduced=True).replace(
        n_layers=n_layers, compute_dtype=compute)
    cfg = get_config("llama3.2-3b", reduced=True).replace(
        n_layers=n_layers, compute_dtype=compute)
    ref = RefSplitModel(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    ours = SplitModel(cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params))
    return ref, ref_params, ours, params


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def test_config_matches_reference():
    for reduced in (False, True):
        ours = dataclasses.asdict(get_config("llama3.2-3b", reduced=reduced))
        ref = dataclasses.asdict(ref_get_config("llama3.2-3b",
                                                reduced=reduced))
        assert ours == ref
    cfg = get_config("llama3.2-3b")
    assert (cfg.q_dim, cfg.kv_dim, cfg.n_superblocks) == (3072, 1024, 28)


@pytest.mark.parametrize("name", ["gemma2-9b", "zamba2-2.7b",
                                  "whisper-tiny", "mixtral-8x7b"])
def test_other_configs_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 8"):
        get_config(name)


@pytest.mark.parametrize("n_layers,units", [(4, (3, 1)), (1, (0, 1)),
                                            (28, (7, 21))])
def test_split_geometry_matches_reference(n_layers, units):
    cfg = get_config("llama3.2-3b").replace(n_layers=n_layers)
    ref = RefSplitModel(ref_get_config("llama3.2-3b").replace(
        n_layers=n_layers))
    ours = SplitModel(cfg)
    assert (ours.n_head_units, ours.n_trunk_units) == units == \
        (ref.n_head_units, ref.n_trunk_units)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_init_matches_reference_layout_and_scales(n_layers):
    """``init`` from a seeded generator: the reference's tree, leaf shapes
    and distributions (dense N(0, 1/d_in), embeddings and the LM head
    N(0, 0.02^2), norms zero); the same seed gives the same params."""
    ref, ref_params, ours, _ = _pair(n_layers, "float32")
    params = ours.init(torch.Generator().manual_seed(0))
    ref_np = jax.tree.map(np.asarray, ref_params)
    assert jax.tree.structure(ref_np) == \
        jax.tree.structure(to_numpy(params))
    for a, b in zip(tree_leaves(to_numpy(params)), jax.tree.leaves(ref_np)):
        assert a.shape == b.shape and a.dtype == b.dtype
    cfg = ours.cfg
    assert abs(params["heads"]["embed"]["table"].std().item()
               - 0.02) < 2e-3
    assert abs(params["trunk"]["lm_head"]["w"].std().item() - 0.02) < 2e-3
    wq = params["trunk"]["blocks"]["units"]["b0"]["attn"]["wq"]["w"]
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not params["trunk"]["out_norm"]["scale"].any()
    again = ours.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(again)))


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_weights_round_trip_keeps_the_tree(n_layers):
    """``from_reference``/``to_numpy`` carry the SplitModel tree leaf for
    leaf; the empty ``shared`` dicts and zero-unit stacks survive."""
    _, ref_params, _, params = _pair(n_layers, "float32")
    ref_np = jax.tree.map(np.asarray, ref_params)
    back = to_numpy(params)
    assert back["heads"]["blocks"]["shared"] == {}
    assert back["trunk"]["blocks"]["shared"] == {}
    assert jax.tree.structure(back) == jax.tree.structure(ref_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_forward_matches_reference(n_layers, compute):
    ref, ref_params, ours, params = _pair(n_layers, compute)
    toks = _tokens(2, 16, ours.cfg.vocab)
    want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got = ours.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _check(got, want, compute)


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_prefill_and_decode_match_reference(n_layers, compute):
    """Prefill a 16-token context, then three decode steps (every owner's
    head on the new token, owner 0's cut to the trunk): last-token logits
    at every step, and the greedy tokens, as the reference's."""
    ref, ref_params, ours, params = _pair(n_layers, compute)
    B, S, P, n_new = 2, 16, 2, 4
    ot = ref_batching.sequence_owner_slices(_tokens(B, S, ours.cfg.vocab), P)
    rc = ref.cache_init(B, S, n_new=n_new)
    tc = ours.cache_init(B, S, n_new=n_new)
    rl, rc = ref.prefill(ref_params, {"owner_tokens": jnp.asarray(ot)}, rc)
    tl, tc = ours.prefill(params, {"owner_tokens": torch.from_numpy(
        np.ascontiguousarray(ot))}, tc)
    for t in range(n_new - 1):
        _check(tl, rl, compute)
        rtok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
        ttok = tl.argmax(-1)[:, None].to(torch.int32)
        if compute == "float32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok))
        else:
            ttok = torch.from_numpy(np.array(rtok))  # same input onward
        rl, rc = ref.decode_step(ref_params, rc, rtok, S + t, S // P + t)
        tl, tc = ours.decode_step(params, tc, ttok, S + t, S // P + t)
    _check(tl, rl, compute)
    if compute == "float32":
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(rc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("combine", ["concat", "sum", "mean", "max"])
def test_combine_matches_reference(combine):
    """The scientist's cut combine, on a (P, B, S_p, k) cut (the mean
    may round its last bit differently)."""
    sp = dict(n_owners=3, cut_layer=1, combine=combine)
    cfg = get_config("llama3.2-3b", reduced=True)
    ours = SplitModel(cfg.replace(split=dataclasses.replace(cfg.split,
                                                            **sp)))
    ref_cfg = ref_get_config("llama3.2-3b", reduced=True)
    ref = RefSplitModel(ref_cfg.replace(split=dataclasses.replace(
        ref_cfg.split, **sp)))
    cut = np.random.default_rng(4).normal(size=(3, 2, 5, 8)).astype(
        np.float32)
    np.testing.assert_allclose(
        ours.combine(torch.from_numpy(cut)).numpy(),
        np.asarray(ref.combine(jnp.asarray(cut))), rtol=1e-6, atol=0)


def test_token_dataset_is_the_reference_s():
    for args in ((3, 40, 512, 0), (2, 17, 128256, 5)):
        np.testing.assert_array_equal(make_token_dataset(*args),
                                      ref_make_token_dataset(*args))
        assert make_token_dataset(*args).dtype == np.int32


def test_batching_helpers_are_the_reference_s():
    rng = np.random.default_rng(3)
    ctxs = [rng.integers(0, 500, n) for n in (5, 12, 1)]
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            batching.pad_contexts(ctxs, 4, 12, pad=7, pad_side=side),
            ref_batching.pad_contexts(ctxs, 4, 12, pad=7, pad_side=side))
    wave = batching.pad_contexts(ctxs, 4, 12)
    np.testing.assert_array_equal(
        batching.sequence_owner_slices(wave, 2),
        ref_batching.sequence_owner_slices(wave, 2))
    got = batching.serving_owner_slices(wave, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_batching.serving_owner_slices(wave, 3)))
    row = batching.pad_context_row(ctxs[1], 16)
    np.testing.assert_array_equal(row,
                                  ref_batching.pad_context_row(ctxs[1], 16))
    assert batching.context_tag(row) == ref_batching.context_tag(row)
    with pytest.raises(ValueError):
        batching.sequence_owner_slices(wave, 5)
    with pytest.raises(ValueError):
        batching.pad_contexts(ctxs, 2, 12)
