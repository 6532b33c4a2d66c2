"""The encoder-decoder family (whisper-tiny, the ``audio_text`` modality)
in the port against the JAX reference, on the CPU: the config and the
registry (``list_archs``), sin-cos positions, cross-attention (Sq != Skv
under the bidirectional mask) and the ``dec`` block, the split model's
layout, logits, loss and gradients, prefill and decode, a 3-step clip +
Adam trail, and the refusals of the engine and the launchers, which
drive text archs only.

The model is whisper-tiny reduced (the reference's ``reduced()``:
d_model 256, 4 heads of 64, 2 encoder and 2 decoder layers, vocab 512,
frames of ``d_frontend`` 384): one owner, whose head is the encoder over
40 frames; the trunk is the decoder over 24 tokens, cross-attending the
encoder's output.  Params come from the reference's init
(``weights.from_reference``); frames and tokens from a seed with numpy.
Logits are held as ``test_torch_lm.py`` holds them: f32 within rel 1e-4
of the largest, bf16 within atol 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.launch import serve as ref_serve
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.models.model import SplitModel as RefSplitModel
from repro_torch import optim
from repro_torch.configs import get_config, list_archs
from repro_torch.federation.registry import build_adapter
from repro_torch.launch import serve, train
from repro_torch.launch.engine import ServingEngine
from repro_torch.models import attention, layers, transformer
from repro_torch.models.attention import RowPositions
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference, to_numpy

from test_torch_lm import _check

torch.set_num_threads(1)

WHISPER = "whisper-tiny"
COMPUTE = ["float32", "bfloat16"]
B, S_ENC, S_DEC = 2, 40, 24


def _cfgs(compute="float32", cut_dim=0, **kw):
    kw = dict(compute_dtype=compute, **kw)
    return (get_config(WHISPER, reduced=True).replace(**kw).with_split(
                cut_dim=cut_dim),
            ref_get_config(WHISPER, reduced=True).replace(**kw).with_split(
                cut_dim=cut_dim))


def _pair(compute="float32", **kw):
    cfg, rcfg = _cfgs(compute, **kw)
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, rp, SplitModel(cfg), from_reference(jax.tree.map(
        np.asarray, rp))


def _inputs(cfg, seed=0, s_enc=S_ENC, s_dec=S_DEC):
    """(frames (B, s_enc, d_frontend) f32, decoder tokens (B, s_dec + 1))."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, s_enc, cfg.d_frontend)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab, (B, s_dec + 1)).astype(
        np.int32)


def batches(frames, toks, labels=None):
    """The same batch for the reference (jnp) and the port (torch)."""
    ref = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    ours = {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks.astype(np.int64))}
    if labels is not None:
        ref["labels"] = jnp.asarray(labels)
        ours["labels"] = torch.from_numpy(labels.astype(np.int64))
    return ref, ours


def _labelled(cfg, seed=0):
    frames, toks = _inputs(cfg, seed)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    labels[1, 20:] = -100
    return batches(frames, toks[:, :-1], labels)


# ---------------------------------------------------------------------------
# config and registry
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(WHISPER, reduced=reduced)) == \
            dataclasses.asdict(ref_get_config(WHISPER, reduced=reduced))
    cfg = get_config(WHISPER)
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_frontend, cfg.rope, cfg.modality) == \
        (4, 4, 384, 6, 64, 384, "sincos", "audio_text")


def test_list_archs_is_the_reference_s():
    """The ten architectures, in the reference's order, each a config
    the port builds a ``SplitModel`` of; an unknown name's KeyError
    lists them."""
    assert list_archs() == ref_list_archs()
    assert len(list_archs()) == 10
    for name in list_archs():
        cfg = get_config(name, reduced=True)
        assert SplitModel(cfg).cfg is cfg
    with pytest.raises(KeyError, match="qwen2-vl-72b.*whisper-tiny"):
        get_config("gpt-5")


@pytest.mark.parametrize("reduced", [False, True])
def test_split_geometry_matches_reference(reduced):
    """The encoder is the head (one unit per encoder layer), the decoder
    the trunk, at full size and reduced."""
    cfg, rcfg = (get_config(WHISPER, reduced=reduced),
                 ref_get_config(WHISPER, reduced=reduced))
    ours, ref = SplitModel(cfg), RefSplitModel(rcfg)
    for a in ("P", "k", "n_head_units", "n_trunk_units", "head_pattern",
              "trunk_pattern"):
        assert getattr(ours, a) == getattr(ref, a), a
    assert (ours.head_pattern, ours.trunk_pattern) == (("attn:global",),
                                                       ("dec",))


# ---------------------------------------------------------------------------
# layers: sin-cos positions, cross-attention, the dec block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [384, 256, 64, 3])
def test_sincos_positions_match_reference(d):
    """Whisper's sinusoidal embeddings (positions up to 1599, the
    encoder's 1500 frames among them), f32.  The two libraries' f32
    ``exp`` part by an ulp on some frequencies (XLA's is not correctly
    rounded), so an angle p * f parts by up to ~p * 2^-23 f: held
    within 1e-7 * (1 + max position)."""
    pos = np.arange(1600).reshape(2, 800)
    want = np.asarray(ref_layers.sincos_positions(jnp.asarray(pos), d))
    got = layers.sincos_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-7 * (1 + pos.max()))
    small = np.arange(40)
    np.testing.assert_allclose(
        layers.sincos_positions(torch.from_numpy(small), d).numpy(),
        np.asarray(ref_layers.sincos_positions(jnp.asarray(small), d)),
        rtol=0, atol=5e-6)


def _attn_inputs(cfg, Sq, Skv, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Sq, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(B, Skv, cfg.d_model)).astype(np.float32)
    return x, kv


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("Sq,Skv", [(9, 40), (1, 40), (40, 9)])
def test_cross_attention_matches_reference(Sq, Skv, compute):
    """``attn_apply(kv_x=...)``: k and v from ``kv_x`` (Skv != Sq), the
    mask forced to bidir whatever kind is asked, no rotary even when
    positions are given, no cache returned; within the kernels'
    tolerances (2e-4 f32, 2e-2 bf16)."""
    cfg, rcfg = _cfgs(compute)
    rp = ref_attention.attn_init(jax.random.PRNGKey(1), rcfg)
    tp = from_reference(jax.tree.map(np.asarray, rp))
    x, kv = _attn_inputs(cfg, Sq, Skv)
    dt = layers.dtype_of(compute)
    want, rc = ref_attention.attn_apply(
        rp, jnp.asarray(x, compute), cfg=rcfg, kind="causal",
        positions=jnp.arange(Sq), kv_x=jnp.asarray(kv, compute))
    got, tc = attention.attn_apply(
        tp, torch.from_numpy(x).to(dt), cfg=cfg, kind="causal",
        positions=torch.arange(Sq), kv_x=torch.from_numpy(kv).to(dt))
    assert rc is None and tc is None
    tol = 2e-4 if compute == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("compute", COMPUTE)
def test_dec_block_matches_reference(compute):
    """The ``dec`` block with and without a cache: causal self-attention,
    ``norm_x`` + cross-attention over ``enc_out``, the FFN; a prefill of
    9 tokens then one decode token at position 9 (outputs and the
    written cache)."""
    cfg, rcfg = _cfgs(compute)
    rp = ref_transformer.block_init(jax.random.PRNGKey(2), rcfg, "dec")
    tp = from_reference(jax.tree.map(np.asarray, rp))
    assert sorted(tp) == ["attn", "ffn", "norm1", "norm2", "norm_x",
                          "xattn"]
    x, enc = _attn_inputs(cfg, 10, S_ENC, seed=3)
    dt = layers.dtype_of(compute)
    tol = 1e-4 if compute == "float32" else 5e-2
    rx, tx = jnp.asarray(x, compute), torch.from_numpy(x).to(dt)
    renc, tenc = jnp.asarray(enc, compute), torch.from_numpy(enc).to(dt)
    want, _, _ = ref_transformer.block_apply(
        rp, rx, cfg=rcfg, kind="dec", positions=jnp.arange(10),
        enc_out=renc)
    got, _, aux = transformer.block_apply(
        tp, tx, cfg=cfg, kind="dec", positions=torch.arange(10),
        enc_out=tenc)
    assert aux is None
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    rc = ref_transformer.block_cache_init(B, rcfg, "dec", 16, compute)
    tc = transformer.block_cache_init(B, cfg, "dec", 16, dt)
    outs = []
    for sl, pos in ((slice(0, 9), 0), (slice(9, 10), 9)):
        w, rc, _ = ref_transformer.block_apply(
            rp, rx[:, sl], cfg=rcfg, kind="dec",
            positions=pos + jnp.arange(sl.stop - sl.start), cache=rc,
            pos=pos, enc_out=renc)
        g, tc, _ = transformer.block_apply(
            tp, tx[:, sl], cfg=cfg, kind="dec",
            positions=pos + torch.arange(sl.stop - sl.start), cache=tc,
            pos=pos, enc_out=tenc)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)
        outs.append(g)
    # the cached pass equals the uncached one at the decoded token
    np.testing.assert_allclose(outs[1].float().numpy(),
                               got[:, 9:10].float().numpy(), rtol=tol,
                               atol=tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].float().numpy(),
                                   np.asarray(rc[k], np.float32), rtol=tol,
                                   atol=tol)


def test_dec_stack_needs_enc_out():
    cfg, _ = _cfgs()
    params = transformer.stack_init(torch.Generator().manual_seed(0), cfg,
                                    1, ("dec",))
    with pytest.raises(ValueError, match="dec block needs enc_out"):
        transformer.stack_apply(params, torch.zeros((1, 3, cfg.d_model)),
                                cfg=cfg, pattern=("dec",))


@pytest.mark.parametrize("bidir", [True, False])
def test_encoder_stack_matches_reference(bidir):
    """The encoder stack (``attn:global`` units) bidirectional, as
    whisper's is, and causal (``bidir=False``): ``bidir`` reaches the
    kernel's mask."""
    cfg, rcfg = _cfgs()
    rp = ref_transformer.stack_init(jax.random.PRNGKey(4), rcfg, 2,
                                    ("attn:global",))
    tp = from_reference(jax.tree.map(np.asarray, rp))
    x, _ = _attn_inputs(cfg, 12, 1, seed=5)
    want, _, _ = ref_transformer.stack_apply(
        rp, jnp.asarray(x), cfg=rcfg, pattern=("attn:global",),
        positions=jnp.arange(12), bidir=bidir)
    got, _, _ = transformer.stack_apply(
        tp, torch.from_numpy(x), cfg=cfg, pattern=("attn:global",),
        positions=torch.arange(12), bidir=bidir)
    _check(got, want, "float32")
    if bidir:      # the first row sees the last key: causal would not
        causal, _, _ = transformer.stack_apply(
            tp, torch.from_numpy(x), cfg=cfg, pattern=("attn:global",),
            positions=torch.arange(12))
        assert (causal[:, 0] - got[:, 0]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the split model
# ---------------------------------------------------------------------------

def test_init_matches_reference_layout_and_scales():
    """``init``: the reference's tree and leaf shapes (the head holds
    ``front_proj`` and no ``embed``, the trunk the decoder's ``embed``;
    a dec unit holds ``norm_x`` and ``xattn``) and distributions; the
    same seed gives the same params."""
    ref, rp, ours, _ = _pair()
    params = ours.init(torch.Generator().manual_seed(0))
    ref_np = jax.tree.map(np.asarray, rp)
    assert jax.tree.structure(ref_np) == jax.tree.structure(
        to_numpy(params))
    for a, b in zip(tree_leaves(to_numpy(params)), jax.tree.leaves(ref_np)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert sorted(params["heads"]) == ["blocks", "front_proj"]
    assert sorted(params["trunk"]) == ["blocks", "embed", "lm_head",
                                       "out_norm"]
    cfg = ours.cfg
    fp = params["heads"]["front_proj"]["w"]
    assert fp.shape == (1, cfg.d_frontend, cfg.d_model)
    assert abs(fp.std().item() * cfg.d_frontend ** 0.5 - 1.0) < 0.05
    assert abs(params["trunk"]["embed"]["table"].std().item() - 0.02) < 2e-3
    dec = params["trunk"]["blocks"]["units"]["b0"]
    assert abs(dec["xattn"]["wq"]["w"].std().item() * cfg.d_model ** 0.5
               - 1.0) < 0.05
    assert not dec["norm_x"]["bias"].any() and bool(
        (dec["norm_x"]["scale"] == 1).all())
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
@pytest.mark.parametrize("variant", ["reduced", "cut_dim", "causal_enc"])
def test_forward_matches_reference(variant, compute):
    """Logits of the split model: as reduced, with a cut bottleneck
    (``cut_dim`` 64: ``cut_proj`` after the encoder, ``in_proj`` before
    the decoder's cross-attention) and with a causal encoder
    (``enc_bidirectional=False``)."""
    kw = {"reduced": {}, "cut_dim": {"cut_dim": 64},
          "causal_enc": {"enc_bidirectional": False}}[variant]
    ref, rp, ours, params = _pair(compute, **kw)
    frames, toks = _inputs(ours.cfg)
    rb, tb = batches(frames, toks[:, :-1])
    want, raux = ref.forward(rp, rb)
    with torch.no_grad():
        got, aux = ours.forward(params, tb)
    assert got.dtype == torch.float32 and got.shape == (B, S_DEC, 512)
    assert float(aux) == float(raux) == 0.0
    _check(got, want, compute)


@pytest.mark.parametrize("compute", COMPUTE)
def test_loss_fn_and_grads_match_reference(compute):
    """``loss_fn`` (labels partly masked) and every gradient leaf against
    the reference's ``jax.value_and_grad``: loss rel 1e-5 (f32) / 2e-2
    (bf16), each leaf within 1e-3 (f32) / 5e-2 (bf16) of its largest
    magnitude."""
    ref, rp, ours, params = _pair(compute)
    rb, tb = _labelled(ours.cfg)
    grads_match(ref, rp, ours, params, rb, tb, compute)


def grads_match(ref, rp, ours, params, rb, tb, compute):
    """:func:`test_loss_fn_and_grads_match_reference`'s check on any
    model pair and batch pair."""
    (rl, rm), rg = jax.value_and_grad(ref.loss_fn, has_aux=True)(rp, rb)
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    tl, tm = ours.loss_fn(leaves, tb)
    tl.backward()
    tl = tl.detach()
    rtol = 1e-5 if compute == "float32" else 2e-2
    np.testing.assert_allclose(float(tl), float(rl), rtol=rtol)
    np.testing.assert_allclose(float(tm["loss"].detach()),
                               float(rm["loss"]), rtol=rtol)
    assert float(tm["aux"]) == float(rm["aux"]) == 0.0
    frac = 1e-3 if compute == "float32" else 5e-2
    n_nonzero = 0
    for w, t in zip(jax.tree.leaves(rg), tree_leaves(leaves)):
        w = np.asarray(w, np.float32)
        g = (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, atol=frac * max(np.abs(w).max(), 1e-12), rtol=0)
        n_nonzero += bool(np.abs(w).max() > 0)
    return n_nonzero


@pytest.mark.parametrize("compute", COMPUTE)
def test_prefill_and_decode_match_reference(compute):
    """Prefill (the encoder over 40 frames, the decoder over 24 tokens)
    then 3 greedy decode steps, the decoder alone over ``caches["enc"]``:
    last-token logits at every step, the greedy tokens (f32; in bf16 both
    are fed the reference's), and (f32) every cache leaf, ``enc``
    included, as the reference's."""
    ref, rp, ours, params = _pair(compute)
    frames, toks = _inputs(ours.cfg, seed=1)
    rb, tb = batches(frames, toks[:, :-1])
    s_max, n_new = 32, 4
    rc = ref.cache_init(B, s_max, n_new=n_new)
    tc = ours.cache_init(B, s_max, n_new=n_new)
    assert tc["heads"] is None and tuple(tc["enc"].shape) == \
        (B, s_max // 2, ours.k)
    assert [tuple(x.shape) for x in _leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rc)]
    rl, rc = ref.prefill(rp, rb, rc)
    with torch.no_grad():
        tl, tc = ours.prefill(params, tb, tc)
        assert tuple(tc["enc"].shape) == (B, S_ENC, ours.k)
        for t in range(3):
            _check(tl, rl, compute)
            rtok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
            ttok = tl.argmax(-1)[:, None]
            if compute == "float32":
                np.testing.assert_array_equal(ttok.numpy(),
                                              np.asarray(rtok))
            else:
                ttok = torch.from_numpy(np.array(rtok, np.int64))
            pos = S_DEC + t
            rl, rc = ref.decode_step(rp, rc, rtok, pos, 0)
            tl, tc = ours.decode_step(params, tc, ttok, pos, 0)
    _check(tl, rl, compute)
    if compute == "float32":
        for a, b in zip(_leaves(tc), jax.tree.leaves(rc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-4)


def _leaves(caches):
    """The cache leaves as ``jax.tree.leaves`` lists them (no ``None``:
    the audio head keeps no cache)."""
    return [x for x in tree_leaves(caches) if x is not None]


def test_decode_matches_full_forward():
    """The reference's ``test_whisper_decode_matches_full_forward`` in
    the port: prefill 16 decoder tokens over 16 frames, decode the 17th,
    equals the full forward's last logits within 2e-3 (f32, params from
    the port's init)."""
    cfg, _ = _cfgs()
    decode_matches_full_forward(cfg, s_enc=16, s_dec=16)


def decode_matches_full_forward(cfg, s_enc, s_dec, params=None, seed=1,
                                device="cpu"):
    """Prefill ``s_dec`` decoder tokens over ``s_enc`` frames, then one
    decode step; held against ``forward`` over the ``s_dec + 1`` tokens
    within 2e-3 (the reference test's tolerance).  Returns the decoded
    logits."""
    model = SplitModel(cfg)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    frames, toks = _inputs(cfg, seed, s_enc, s_dec)
    _, full = batches(frames, toks)
    _, ctx = batches(frames, toks[:, :-1])
    full, ctx = (tree_map(lambda a: a.to(device), b) for b in (full, ctx))
    with torch.inference_mode():
        want = model.forward(params, full)[0][:, -1]
        caches = model.cache_init(B, 2 * s_dec, n_new=4, device=device)
        _, caches = model.prefill(params, ctx, caches)
        got, _ = model.decode_step(params, caches, full["tokens"][:, -1:],
                                   s_dec, 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-3, rtol=2e-3)
    return got


def test_fit_trail_matches_reference():
    """Three steps of ``chain(clip_by_global_norm(1.0), adam(3e-4))``
    (the reference's ``launch/steps.py::make_optimizer``) on one
    labelled batch, each package from its own ``value_and_grad`` and
    its own optimizer: the loss trail within rel 1e-4 and falling."""
    ref, rp, ours, params = _pair()
    rb, tb = _labelled(ours.cfg, seed=2)
    fit_trail_matches(ref, rp, ours, params, rb, tb)


def fit_trail_matches(ref, rp, ours, params, rb, tb, steps=3, lr=3e-4):
    """:func:`test_fit_trail_matches_reference`'s check on any pair;
    returns the port's trail."""
    ropt = ref_optim.chain(ref_optim.clip_by_global_norm(1.0),
                           ref_optim.adam(lr))
    topt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(lr))
    rstate, tstate = ropt.init(rp), topt.init(params)
    rtrail, ttrail = [], []
    value_and_grad = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))
    for t in range(steps):
        (rl, _), rg = value_and_grad(rp, rb)
        ru, rstate = ropt.update(rg, rstate, rp, t)
        rp = ref_optim.apply_updates(rp, ru)
        leaves = tree_map(lambda x: x.detach().requires_grad_(), params)
        tl, _ = ours.loss_fn(leaves, tb)
        tl.backward()
        tl = tl.detach()
        tg = tree_map(lambda x: x.grad if x.grad is not None
                      else torch.zeros_like(x), leaves)
        tu, tstate = topt.update(tg, tstate, params, t)
        params = optim.apply_updates(params, tu)
        rtrail.append(float(rl))
        ttrail.append(float(tl))
    np.testing.assert_allclose(ttrail, rtrail, rtol=1e-4)
    assert ttrail[-1] < ttrail[0], ttrail
    return ttrail


# ---------------------------------------------------------------------------
# what drives these families: SplitModel's programs only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [WHISPER, "qwen2-vl-72b"])
def test_engine_and_serve_refuse_like_the_reference(arch):
    """The reference's ``ServingEngine`` and ``serve.py`` drive text
    archs only; the port's refuse the vision and audio configs with the
    same messages."""
    cfg = get_config(arch, reduced=True)
    model = SplitModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as want:
        RefServingEngine(RefSplitModel(ref_get_config(arch, reduced=True)),
                         None)
    with pytest.raises(ValueError) as got:
        ServingEngine(model, params, device="cpu")
    assert str(got.value) == str(want.value) == \
        "ServingEngine drives text archs"
    with pytest.raises(SystemExit) as want:
        ref_serve.main(["--arch", arch, "--reduced"])
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert str(got.value) == str(want.value) == "serve.py drives text archs"


@pytest.mark.parametrize("arch", [WHISPER, "qwen2-vl-72b"])
def test_session_and_train_launcher_keep_refusing(arch):
    """``VerticalSession``'s adapter and ``train.py`` refuse them too, as
    the reference's do."""
    with pytest.raises(ValueError, match="VerticalSession drives text "
                                         "archs"):
        build_adapter(get_config(arch, reduced=True))
    with pytest.raises(SystemExit, match="train.py drives text archs"):
        train.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_per_row_positions_raise():
    """The vision and audio modalities take one int position: a per-row
    position (which only the text engines make) raises."""
    _, _, ours, params = _pair()
    frames, toks = _inputs(ours.cfg, s_enc=8, s_dec=4)
    _, tb = batches(frames, toks[:, :-1])
    caches = ours.cache_init(B, 8, n_new=2)
    with torch.no_grad():
        _, caches = ours.prefill(params, tb, caches)
        for pos in (RowPositions([4, 4], "cpu"), np.array([4, 4])):
            with pytest.raises(ValueError, match="one int position"):
                ours.decode_step(params, caches, tb["tokens"][:, :1], pos,
                                 0)
