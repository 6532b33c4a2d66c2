"""The vision-text family (qwen2-vl-72b, the ``vision_text`` modality
with M-RoPE) in the port against the JAX reference, on the CPU: the
config, M-RoPE (its sections, hd 128's among them, and attention on
rotated q/k with a GQA group of 8), the owners' positions, the split
model's layout, logits (stacked and ragged cuts), loss and gradients,
prefill and decode (the decode token's rope at the global position, its
cache written at the local one) and a 3-step clip + Adam trail.

The model is qwen2-vl-72b reduced (the reference's ``reduced()``:
d_model 256, 4 heads of 64 over 4 KV heads, vocab 512, patches of
``d_frontend`` 1280) at 4 layers: three head units per owner and one
trunk unit.  Owner 0 holds 16 patch embeddings (a 4 x 4 grid), owner 1
16 text tokens (24 in the ragged case).  Params come from the
reference's init (``weights.from_reference``); inputs from a seed with
numpy.  Logits are held as ``test_torch_lm.py`` holds them: f32 within
rel 1e-4 of the largest, bf16 within atol 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, transformer
from repro_torch.models.attention import RowPositions
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference, to_numpy

from test_torch_lm import _check
from test_torch_whisper import fit_trail_matches, grads_match

torch.set_num_threads(1)

QWEN = "qwen2-vl-72b"
COMPUTE = ["float32", "bfloat16"]
N_LAYERS = 4
B, S_PATCH, S_TOK = 2, 16, 16


def _cfgs(compute="float32", **kw):
    kw = dict(n_layers=N_LAYERS, compute_dtype=compute, **kw)
    return (get_config(QWEN, reduced=True).replace(**kw),
            ref_get_config(QWEN, reduced=True).replace(**kw))


def _pair(compute="float32"):
    cfg, rcfg = _cfgs(compute)
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, rp, SplitModel(cfg), from_reference(jax.tree.map(
        np.asarray, rp))


def batches(cfg, s_patch=S_PATCH, s_tok=S_TOK, seed=0, labels=False):
    """The same batch for the reference (jnp) and the port (torch):
    patch embeddings and text tokens; with ``labels``, next-token labels
    over the combined sequence (the patches' and a few tokens' masked)."""
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(B, s_patch, cfg.d_frontend)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (B, s_tok + 1)).astype(np.int32)
    ref = {"patches": jnp.asarray(patches),
           "tokens": jnp.asarray(toks[:, :-1])}
    ours = {"patches": torch.from_numpy(patches),
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int64))}
    if labels:
        lab = np.full((B, s_patch + s_tok), -100, np.int32)
        lab[:, s_patch:] = toks[:, 1:]
        lab[1, -3:] = -100
        ref["labels"] = jnp.asarray(lab)
        ours["labels"] = torch.from_numpy(lab.astype(np.int64))
    return ref, ours


def test_config_matches_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(QWEN, reduced=reduced)) == \
            dataclasses.asdict(ref_get_config(QWEN, reduced=reduced))
    cfg = get_config(QWEN)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.n_layers, cfg.split.cut_layer, cfg.d_frontend, cfg.rope,
            cfg.modality, cfg.rope_theta) == \
        (8192, 64, 8, 128, 80, 20, 1280, "mrope", "vision_text", 1e6)


@pytest.mark.parametrize("n_layers,units", [(80, (20, 60)), (2, (1, 1)),
                                            (4, (3, 1))])
def test_split_geometry_matches_reference(n_layers, units):
    """Head and trunk units as the reference splits them, at the full
    depth and at the cut depths the card and these tests run."""
    ours = SplitModel(get_config(QWEN).replace(n_layers=n_layers))
    ref = RefSplitModel(ref_get_config(QWEN).replace(n_layers=n_layers))
    assert (ours.n_head_units, ours.n_trunk_units) == units == \
        (ref.n_head_units, ref.n_trunk_units)
    assert ours.head_pattern == ours.trunk_pattern == ("attn:global",)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

def test_mrope_sections_are_the_reference_s():
    """hd 128 (qwen2-vl-72b's): slots 0-15 take t, 16-39 h, 40-63 w;
    the last bound is forced to half, whatever the rounding."""
    assert layers.mrope_sections(64) == [0] * 16 + [1] * 24 + [2] * 24
    for half in (32, 8, 7, 3, 1):
        bounds = np.cumsum([int(half * s / 8) for s in (2, 3, 3)])
        bounds[-1] = half
        want = np.zeros(half, int)
        prev = 0
        for i, b in enumerate(bounds):
            want[prev:b] = i
            prev = b
        assert layers.mrope_sections(half) == want.tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [128, 64, 32])
def test_apply_mrope_matches_reference(hd, dtype):
    """Three independent position streams up to 3000, theta 1e6: within
    2e-6 in f32, within one bf16 ulp of the output's magnitude in bf16;
    each stream reaches its own section (a swapped pair of streams
    parts)."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 12, 3, hd)).astype(np.float32)
    p3 = rng.integers(0, 3000, (2, 12, 3))
    want = np.asarray(ref_layers.apply_mrope(
        jnp.asarray(x, dtype), jnp.asarray(p3), 1e6), np.float32)
    dt = layers.dtype_of(dtype)
    got = layers.apply_mrope(torch.from_numpy(x).to(dt),
                             torch.from_numpy(p3), 1e6)
    assert got.dtype == dt
    atol = 2e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=atol)
    swapped = layers.apply_mrope(torch.from_numpy(x).to(dt),
                                 torch.from_numpy(p3[..., [0, 2, 1]]), 1e6)
    assert (swapped.float() - got.float()).abs().max() > 1e-2


@pytest.mark.parametrize("compute", COMPUTE)
def test_mrope_attention_matches_reference(compute):
    """``attn_apply`` with M-RoPE-rotated q/k at hd 128 with a GQA group
    of 8 (qwen2-vl-72b's head geometry: 8 query heads over one KV head),
    on the vision owner's grid positions and on text positions, without
    a cache, then a prefill of 12 and a decode step over a cache."""
    cfg, rcfg = _cfgs(compute, n_heads=8, n_kv_heads=1, head_dim=128)
    rp = ref_attention.attn_init(jax.random.PRNGKey(3), rcfg)
    tp = from_reference(jax.tree.map(np.asarray, rp))
    x = np.random.default_rng(4).normal(size=(B, 13, cfg.d_model)).astype(
        np.float32)
    dt = layers.dtype_of(compute)
    rx, tx = jnp.asarray(x, compute), torch.from_numpy(x).to(dt)
    tol = 2e-4 if compute == "float32" else 2e-2
    grid = np.stack([np.zeros(13, int), np.arange(13) // 3,
                     np.arange(13) % 3], -1)
    text = np.stack([40 + np.arange(13)] * 3, -1)
    for p3 in (grid, text):
        want, _ = ref_attention.attn_apply(rp, rx, cfg=rcfg, kind="causal",
                                           positions=jnp.asarray(p3))
        got, _ = attention.attn_apply(tp, tx, cfg=cfg, kind="causal",
                                      positions=torch.from_numpy(p3))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    rc = ref_attention.init_kv_cache(B, 16, 1, 128, compute)
    tc = attention.init_kv_cache(B, 16, 1, 128, dt)
    for sl, pos in ((slice(0, 12), 0), (slice(12, 13), 12)):
        p3 = text[sl]
        want, rc = ref_attention.attn_apply(
            rp, rx[:, sl], cfg=rcfg, kind="causal",
            positions=jnp.asarray(p3), cache=rc, pos=pos)
        got, tc = attention.attn_apply(
            tp, tx[:, sl], cfg=cfg, kind="causal",
            positions=torch.from_numpy(p3), cache=tc, pos=pos)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    np.testing.assert_allclose(tc["k"].float().numpy(),
                               np.asarray(rc["k"], np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("S_p,offset", [(16, 0), (10, 7), (1024, 5)])
def test_positions_match_reference(S_p, offset):
    """Owner 0's synthetic (t=0, h, w) grid of side int(sqrt(S_p)),
    whatever the offset; owner 1's ``[base]*3`` from ``S_p + offset``."""
    ours = SplitModel(_cfgs()[0])
    ref = RefSplitModel(_cfgs()[1])
    for owner in (0, 1):
        np.testing.assert_array_equal(
            ours._positions(S_p, owner, offset).numpy(),
            np.asarray(ref._positions(S_p, owner, offset)))
    assert ours._positions(S_p, 0, offset)[:, 0].eq(0).all()


# ---------------------------------------------------------------------------
# the split model
# ---------------------------------------------------------------------------

def test_init_matches_reference_layout_and_scales():
    """Both owners hold ``embed`` and ``front_proj`` (the structure is
    stacked, the use asymmetric); the trunk holds no embedding; the
    reference's tree, shapes and distributions; the same seed gives the
    same params."""
    ref, rp, ours, _ = _pair()
    params = ours.init(torch.Generator().manual_seed(0))
    ref_np = jax.tree.map(np.asarray, rp)
    assert jax.tree.structure(ref_np) == jax.tree.structure(
        to_numpy(params))
    for a, b in zip(tree_leaves(to_numpy(params)), jax.tree.leaves(ref_np)):
        assert a.shape == b.shape and a.dtype == b.dtype
    cfg = ours.cfg
    assert sorted(params["heads"]) == ["blocks", "embed", "front_proj"]
    assert sorted(params["trunk"]) == ["blocks", "lm_head", "out_norm"]
    fp = params["heads"]["front_proj"]["w"]
    assert fp.shape == (2, cfg.d_frontend, cfg.d_model)
    assert abs(fp.std().item() * cfg.d_frontend ** 0.5 - 1.0) < 0.05
    assert abs(params["heads"]["embed"]["table"].std().item() - 0.02) < 2e-3
    assert not torch.equal(fp[0], fp[1])
    again = ours.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(again)))


def test_weights_round_trip_keeps_the_tree():
    """The reference's params cross to the port and back bitwise."""
    _, rp, _, params = _pair()
    ref_np = jax.tree.map(np.asarray, rp)
    back = to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("s_tok", [S_TOK, 24], ids=["stacked", "ragged"])
def test_forward_matches_reference(s_tok, compute):
    """Logits over patches + tokens: equal owner lengths (a stacked cut)
    and unequal ones (16 patches, 24 tokens: a list of cuts, concat)."""
    ref, rp, ours, params = _pair(compute)
    rb, tb = batches(ours.cfg, s_tok=s_tok)
    want, raux = ref.forward(rp, rb)
    with torch.no_grad():
        cut, _, _ = ours.heads_forward(params["heads"],
                                       ours.split_owner_inputs(tb))
        assert isinstance(cut, list) == (s_tok != S_PATCH)
        got, aux = ours.forward(params, tb)
    assert got.shape == (B, S_PATCH + s_tok, ours.cfg.vocab)
    assert float(aux) == float(raux) == 0.0
    _check(got, want, compute)


@pytest.mark.parametrize("compute", COMPUTE)
def test_loss_fn_and_grads_match_reference(compute):
    """``loss_fn`` (labels on the text positions) and every gradient leaf
    against ``jax.value_and_grad``, as ``test_torch_whisper.py`` holds
    them; the owners' unused halves (owner 0's ``embed``, owner 1's
    ``front_proj``) get zero gradient in both."""
    ref, rp, ours, params = _pair(compute)
    rb, tb = batches(ours.cfg, labels=True)
    grads_match(ref, rp, ours, params, rb, tb, compute)


@pytest.mark.parametrize("compute", COMPUTE)
def test_prefill_and_decode_match_reference(compute):
    """Prefill both owners, then 3 greedy decode steps through the text
    owner's head (``pos`` the global position, ``pos_local`` the text
    owner's): last-token logits at every step, the greedy tokens (f32;
    in bf16 both are fed the reference's) and (f32) every cache leaf."""
    ref, rp, ours, params = _pair(compute)
    rb, tb = batches(ours.cfg, seed=1)
    S, S_p, n_new = S_PATCH + S_TOK, S_TOK, 4
    rc = ref.cache_init(B, S, n_new=n_new)
    tc = ours.cache_init(B, S, n_new=n_new)
    assert sorted(tc["heads"]) == ["patches", "tokens"]
    rl, rc = ref.prefill(rp, rb, rc)
    with torch.no_grad():
        tl, tc = ours.prefill(params, tb, tc)
        for t in range(3):
            _check(tl, rl, compute)
            rtok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
            ttok = tl.argmax(-1)[:, None]
            if compute == "float32":
                np.testing.assert_array_equal(ttok.numpy(),
                                              np.asarray(rtok))
            else:
                ttok = torch.from_numpy(np.array(rtok, np.int64))
            rl, rc = ref.decode_step(rp, rc, rtok, S + t, S_p + t)
            tl, tc = ours.decode_step(params, tc, ttok, S + t, S_p + t)
    _check(tl, rl, compute)
    if compute == "float32":
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(rc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)


def test_decode_rope_at_global_pos_cache_at_local():
    """A vision decode step's first head layer: the key written into the
    text owner's cache at slot ``pos_local`` is the token's key rotated
    by M-RoPE at the global ``pos`` (and not at ``pos_local``); the
    patches' head cache is left as the prefill wrote it."""
    _, _, ours, params = _pair()
    cfg = ours.cfg
    rb, tb = batches(cfg, seed=2)
    S, S_p = S_PATCH + S_TOK, S_TOK
    with torch.no_grad():
        caches = ours.cache_init(B, S, n_new=2)
        _, caches = ours.prefill(params, tb, caches)
        patches = [x.clone() for x in tree_leaves(caches["heads"]["patches"])]
        tok = torch.tensor([[3], [7]])
        ours.decode_step(params, caches, tok, S, S_p)
        hp = transformer.unit(params["heads"], 1)
        bp = transformer.unit(hp["blocks"]["units"], 0)["b0"]
        h = layers.norm_apply(bp["norm1"], layers.embed_apply(
            hp["embed"], tok, torch.float32), cfg.norm, cfg.norm_eps)
        k = layers.dense_apply(bp["attn"]["wk"], h).reshape(
            B, 1, cfg.n_kv_heads, cfg.head_dim)

        def rotated(p):
            return layers.apply_mrope(k, torch.tensor([[p] * 3]),
                                      cfg.rope_theta)[:, 0]
        written = caches["heads"]["tokens"]["b0"]["k"][0][:, S_p]
    np.testing.assert_allclose(written.numpy(), rotated(S).numpy(),
                               rtol=0, atol=1e-6)
    assert (written - rotated(S_p)).abs().max() > 1e-2
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(caches["heads"]["patches"]), patches))


def test_fit_trail_matches_reference():
    """Three steps of ``chain(clip_by_global_norm(1.0), adam(3e-4))`` on
    one labelled batch (``test_torch_whisper.fit_trail_matches``): loss
    trail within rel 1e-4 and falling."""
    ref, rp, ours, params = _pair()
    rb, tb = batches(ours.cfg, seed=3, labels=True)
    fit_trail_matches(ref, rp, ours, params, rb, tb)


def test_per_row_positions_raise():
    _, _, ours, params = _pair()
    _, tb = batches(ours.cfg, s_patch=4, s_tok=4)
    caches = ours.cache_init(B, 8, n_new=2)
    with torch.no_grad():
        _, caches = ours.prefill(params, tb, caches)
        with pytest.raises(ValueError, match="one int position"):
            ours.decode_step(params, caches, tb["tokens"][:, :1],
                             RowPositions([8, 8], "cpu"), 4)
