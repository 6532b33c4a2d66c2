"""Training the sequence-split LM in the port against the JAX reference,
on the CPU: the optimizers (Adam, clipping, schedules), the sequence
layout, attention under autograd, the LM loss, ``SplitLMAdapter``'s
training programs, ``VerticalSession.fit`` / ``evaluate`` on llama3.2-3b
(joint and split, queue and direct, lossless, fp16 and int8, pipelined,
sequential, ``microbatches=2``, supervised recovery, checkpoints) and
``repro_torch.launch.train``.

The model is llama3.2-3b reduced, with 3 layers (one head unit per
owner, two trunk units: the heads run attention too) unless a test
says otherwise; params cross from the reference's
(``weights.from_reference``), inputs come from ``make_token_dataset``.
Tolerances: optimizers rel 1e-6 (bitwise where the arithmetic is the
same); attention gradients 2e-4 (f32) / 2e-2 (bf16), the kernels'; fits
rel 1e-4 in loss.  Params after a 3-step joint fit: atol 5e-5 on all but
1e-4 of each leaf's elements, and 2e-3 on those (Adam turns a gradient
at f32 rounding level, ~1e-9, into a step of about lr, and the two
packages' f32 gradients there differ).  Split lossless equals the
per-owner-clipped joint oracle (``test_torch_cuda.
lm_owner_clipped_oracle``) bit for bit, f32 and bf16.  The checks that
hold for every LM family are functions of the config (``reference_runs``,
``loss_and_grads_match``, ``split_equals_oracle`` and the rest), which
``test_torch_ssm_train.py`` calls on reduced zamba2-2.7b.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.data import synthetic as ref_synthetic
from repro.federation import batching as ref_batching
from repro.federation.parties import sequence_parties as ref_seq_parties
from repro.federation.session import VerticalSession as RefSession
from repro.models.attention import attention as ref_attention
from repro.models.model import SplitModel as RefSplitModel
from repro.core.splitnn import cut_layer_traffic
import repro.optim as ref_optim
from repro_torch import optim
from repro_torch.checkpoint import restore_split, save_split
from repro_torch.configs import get_config
from repro_torch.data import batches, make_token_dataset
from repro_torch.federation import batching, faults
from repro_torch.kernels import block_attention as attn_kernel
from repro_torch.kernels.block_attention import autograd as attn_autograd
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference, to_numpy

from test_torch_cuda import lm_owner_clipped_oracle, lm_session

torch.set_num_threads(1)

LLAMA = "llama3.2-3b"
STEPS, BATCH, SEQ, DOCS = 3, 4, 32, 16


def cfgs(compute="float32", n_layers=3, arch=LLAMA, **split):
    """(port config, reference config): ``arch`` reduced (llama3.2-3b
    unless given), cut after one unit."""
    kw = dict(n_layers=n_layers, compute_dtype=compute)
    split = {"cut_layer": 1, **split}
    return (get_config(arch, reduced=True).replace(**kw).with_split(**split),
            ref_get_config(arch, reduced=True).replace(**kw).with_split(
                **split))


def tokens(vocab, n=DOCS, seq=SEQ):
    toks = make_token_dataset(n, seq, vocab, 0)
    np.testing.assert_array_equal(
        toks, ref_synthetic.make_token_dataset(n, seq, vocab, 0))
    return toks


def ref_session(rcfg, toks):
    s = RefSession(*ref_seq_parties(toks, rcfg.split.n_owners))
    s.resolve(group="modp512")
    return s.build(rcfg)


def port_params(ref):
    return from_reference(jax.tree.map(np.asarray, ref.params))


def same_leaves(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


def reference_runs(cfg, rcfg, toks):
    """The reference's joint and split fits of ``rcfg`` on ``toks`` (3
    steps of 4, 25 % held out) and the params they start from."""
    out = {"cfg": cfg, "rcfg": rcfg, "toks": toks}
    for mode in ("joint", "split"):
        s = ref_session(rcfg, toks)
        out["p0"] = port_params(s)
        h = s.fit(steps=STEPS, batch_size=BATCH, eval_frac=0.25,
                  verbose=False, mode=mode)
        out[mode] = dict(loss=[r["loss"] for r in h["train"]],
                         aux=[float(r["aux"]) for r in h["train"]],
                         eval=h["eval"][-1], params=port_params(s),
                         ts=s.transport_stats)
    return out


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's joint and split fits of reduced llama (f32)."""
    cfg, rcfg = cfgs()
    return reference_runs(cfg, rcfg, tokens(cfg.vocab))


# ---------------------------------------------------------------------------
# optimizers, schedules, layout helpers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": (lambda o: o.sgd(0.1), True),
    "sgd_momentum": (lambda o: o.sgd(0.05, momentum=0.9), True),
    "sgd_cosine": (lambda o: o.sgd(o.warmup_cosine(0.1, 2, 5)), False),
    "adam": (lambda o: o.adam(1e-2), True),
    "adam_bf16_state": (lambda o: o.adam(
        1e-2, state_dtype=(torch.bfloat16 if o is optim
                           else jnp.bfloat16)), False),
    "adamw": (lambda o: o.adamw(1e-2, weight_decay=0.1), True),
    "adamw_cosine": (lambda o: o.adamw(o.warmup_cosine(1e-2, 2, 5)), False),
    "clip_adam": (lambda o: o.chain(o.clip_by_global_norm(1.0),
                                    o.adam(1e-3)), False),
    "clip_wide": (lambda o: o.chain(o.clip_by_global_norm(1e9),
                                    o.sgd(0.1)), True),
    "segments": (lambda o: o.multi_segment({
        "heads": o.chain(o.clip_by_global_norm(1.0), o.adam(1e-3)),
        "trunk": o.sgd(0.1, momentum=0.5)}), False),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    """5 steps on a random tree (gradients large enough to clip): params
    and state within rel 1e-6 of the reference's, bitwise where both
    compute the same f32 operations (not where a clip's sum of squares
    is reduced, or a schedule's cosine evaluated, by each library in its
    own order: one ulp apart)."""
    make, bitwise = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": [(5,), (2, 3)]}
    tree = {"heads": {"w": rng.normal(size=(3, 4))},
            "trunk": [rng.normal(size=(5,)), rng.normal(size=(2, 3))]} \
        if name == "segments" else \
        jax.tree.map(lambda s: rng.normal(size=s), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    ropt, topt = make(ref_optim), make(optim)
    rp, tp = jax.tree.map(jnp.asarray, tree), from_reference(tree)
    rs, ts = ropt.init(rp), topt.init(tp)
    for step in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(
            np.float32), tree)
        ru, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp, step)
        rp = ref_optim.apply_updates(rp, ru)
        tu, ts = topt.update(from_reference(g), ts, tp, step)
        tp = optim.apply_updates(tp, tu)
    for want, got in ((rp, tp), (rs, ts)):
        w = [np.asarray(jnp.asarray(a, jnp.float32))
             for a in jax.tree.leaves(want)]
        g = [t.float().numpy() for t in tree_leaves(got)]
        assert len(w) == len(g)
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
            if bitwise:
                np.testing.assert_array_equal(b, a)


def test_schedules_match_reference():
    for args in ((1.0, 10, 110, 0.1), (3e-4, 0, 50, 0.0), (1e-2, 5, 5, 0.5)):
        ref, ours = ref_optim.warmup_cosine(*args), optim.warmup_cosine(*args)
        for step in range(0, 130, 3):
            np.testing.assert_allclose(ours(step), float(ref(step)),
                                       rtol=1e-6, atol=1e-12)
    assert optim.constant(1e-3)(7) == float(ref_optim.constant(1e-3)(7))


def test_layout_helpers_match_reference():
    """``sequence_batch``, ``unstack_feature_slices``, ``batches`` and
    ``with_split`` give the reference's outputs."""
    rng = np.random.default_rng(3)
    slices = [rng.integers(0, 500, (10, 8)) for _ in range(2)]
    labels = rng.integers(0, 500, (10, 16))
    labels[2, 5] = -100
    idx = rng.permutation(10)[:4]
    for lab in (labels, None):
        want = ref_batching.sequence_batch(slices, lab, idx)
        got = batching.sequence_batch(slices, lab, idx)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert got["owner_tokens"].dtype == torch.int32
    from repro_torch.federation.registry import build_adapter
    ad = build_adapter(cfgs()[0])
    for p in range(2):
        np.testing.assert_array_equal(ad.owner_batch(slices[p], idx).numpy(),
                                      slices[p][idx])
    stacked = rng.normal(size=(3, 5, 4))
    for x in (stacked, [stacked[0], stacked[1][:, :2]]):
        for a, b in zip(batching.unstack_feature_slices(x),
                        ref_batching.unstack_feature_slices(x)):
            np.testing.assert_array_equal(a, b)
    data = {"x": rng.normal(size=(23, 3)), "y": np.arange(23)}
    for kw in (dict(batch_size=5, seed=1, epochs=2),
               dict(batch_size=4, seed=0, drop_last=False)):
        got = list(batches(data, **kw))
        want = list(ref_synthetic.batches(data, **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in data:
                np.testing.assert_array_equal(a[k], b[k])
    cfg, rcfg = cfgs()
    for kw in (dict(n_owners=4, combine="sum"), dict(cut_dim=64)):
        assert dataclasses.asdict(cfg.with_split(**kw).split) == \
            dataclasses.asdict(rcfg.with_split(**kw).split)


# ---------------------------------------------------------------------------
# attention under autograd
# ---------------------------------------------------------------------------

# B, S, nh, nkv, hd, kind, window, softcap
GRAD_CASES = [
    (2, 40, 4, 2, 16, "causal", 0, 0.0),
    (2, 40, 4, 2, 16, "causal", 0, 5.0),
    (1, 33, 4, 4, 16, "local", 8, 0.0),
    (1, 48, 6, 2, 32, "local", 16, 30.0),
    (2, 24, 6, 2, 16, "bidir", 0, 0.0),
    (1, 24, 4, 1, 32, "bidir", 0, 10.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_attention_grads_match_jax(case, dtype):
    """dq, dk, dv of ``attention_fn`` against ``jax.grad`` of the
    reference's ``attention`` (2e-4 f32, 2e-2 bf16, atol + rtol)."""
    B, S, nh, nkv, hd, kind, window, cap = case
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, S, nh, hd), (B, S, nkv, hd), (B, S, nkv, hd)))
    do = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(kind=kind, window=window, softcap=cap)

    def f(q_, k_, v_):
        o = ref_attention(q_, k_, v_, **kw).astype(jnp.float32)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = attn_kernel.attention_fn(tq, tk, tv, **kw)
    assert torch.equal(out.detach(), attn_kernel.block_attention(
        tq.detach(), tk.detach(), tv.detach(), **kw))
    (out.float() * torch.from_numpy(do)).sum().backward()
    tol = 2e-4 if dtype == "float32" else 2e-2
    for w, g in zip(want, (tq.grad, tk.grad, tv.grad)):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_attention_backward_in_row_blocks(monkeypatch):
    """A call too large for one score block runs the backward in blocks
    of query rows: the same gradients within f32 rounding."""
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16),
                             (2, 64, 4, 16)))
    kw = dict(kind="local", window=20, softcap=7.0)
    whole = attn_autograd.attention_backward(q, k, v, do, **kw)
    monkeypatch.setattr(attn_autograd, "BLOCK_ELEMENTS", 2 * 4 * 64 * 5)
    blocks = attn_autograd.attention_backward(q, k, v, do, **kw)
    for a, b in zip(whole, blocks):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the LM's loss and gradients
# ---------------------------------------------------------------------------

def loss_and_grads_match(cfg, rcfg, compute, seq=SEQ, leafwise=True):
    """``loss_fn`` (masked labels included) and its gradients against
    the reference's ``jax.value_and_grad`` on 4 documents of ``seq``
    tokens from the reference's init: loss rel 1e-5 (f32) / 2e-2
    (bf16); the aux 0 in both where the config has no MoE FFN, else
    within the loss's tolerance; with ``leafwise``, every gradient leaf
    within 1e-3 (f32) / 5e-2 (bf16) of its largest magnitude.  Returns
    the (reference, port) gradient leaves as numpy arrays, in
    ``tree_leaves`` order."""
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    ours = SplitModel(cfg)
    tp = from_reference(jax.tree.map(np.asarray, rp))
    toks = tokens(cfg.vocab, n=4, seq=seq)
    labels = toks[:, 1:].astype(np.int32).copy()
    labels[0, :5] = -100
    labels[3, 20:] = -100
    ot = batching.sequence_owner_slices(toks[:, :-1], 2)
    (rl, rm), rg = jax.value_and_grad(ref.loss_fn, has_aux=True)(
        rp, {"owner_tokens": jnp.asarray(ot), "labels": jnp.asarray(labels)})
    leaves = tree_map(lambda t: t.detach().requires_grad_(), tp)
    tl, tm = ours.loss_fn(leaves, {
        "owner_tokens": torch.from_numpy(np.ascontiguousarray(ot)),
        "labels": torch.from_numpy(labels.astype(np.int64))})
    tl.backward()
    rtol = 1e-5 if compute == "float32" else 2e-2
    np.testing.assert_allclose(float(tl), float(rl), rtol=rtol)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=rtol)
    if cfg.moe is None:
        assert float(tm["aux"]) == float(rm["aux"]) == 0.0
    else:
        assert float(rm["aux"]) > 0.0
        np.testing.assert_allclose(float(tm["aux"]), float(rm["aux"]),
                                   rtol=rtol)
    frac = 1e-3 if compute == "float32" else 5e-2
    want, got = [], []
    for w, t in zip(jax.tree.leaves(rg), tree_leaves(leaves)):
        w = np.asarray(w, np.float32)
        g = (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
        assert g.shape == w.shape
        if w.size and leafwise:
            np.testing.assert_allclose(
                g, w, atol=frac * max(np.abs(w).max(), 1e-12), rtol=0)
        want.append(w)
        got.append(g)
    return want, got


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_fn_and_grads_match_reference(compute):
    """:func:`loss_and_grads_match` on reduced llama."""
    loss_and_grads_match(*cfgs(compute), compute)


def test_ce_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7))
    labels[1, 2:] = -100
    for lab in (labels, np.full((3, 7), -100)):
        want = float(RefSplitModel.ce_loss(jnp.asarray(logits),
                                           jnp.asarray(lab)))
        got = float(SplitModel.ce_loss(torch.from_numpy(logits),
                                       torch.from_numpy(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# fit and evaluate against the reference
# ---------------------------------------------------------------------------

def _fit(cfg, toks, p0, **kw):
    s = lm_session(cfg, toks, "cpu", p0)
    kw.setdefault("eval_frac", 0.25)
    h = s.fit(steps=STEPS, batch_size=BATCH, verbose=False, **kw)
    return s, h


def _ref_step_grads(ref_runs):
    """The reference's joint gradients at each of the 3 steps along its
    own trajectory (its batches, its Adam updates), as numpy leaves."""
    _, rcfg = cfgs()
    r = ref_session(rcfg, ref_runs["toks"])
    ad = r.adapter
    r._train_idx = np.arange(len(r.scientist.ids) * 3 // 4)
    stream = r._index_stream(np.random.default_rng(0), len(r._train_idx),
                             BATCH, None, STEPS)
    opt = ad.default_optimizer()
    params, state, out = r.params, opt.init(r.params), []
    for t in range(STEPS):
        batch = ad.make_batch([o._features for o in r.owners],
                              r.scientist.labels, next(stream))
        _, g = jax.value_and_grad(ad.loss_fn, has_aux=True)(params, batch)
        out.append([np.asarray(x) for x in jax.tree.leaves(g)])
        u, state = opt.update(g, state, params, t)
        params = ref_optim.apply_updates(params, u)
    return out


def test_joint_fit_matches_reference(ref_runs):
    """3 Adam steps jointly: loss trail and eval metrics within rel 1e-4
    of the reference's; params within atol 5e-5 except where Adam met a
    gradient at f32 rounding level: every element that parts further
    (at most 1e-4 of a leaf, and by at most 2e-3) had, at some step, a
    gradient below 2e-6 of its leaf's largest, which Adam's
    normalisation turns into a step of about lr whose sign is rounding
    noise."""
    s, h = _fit(ref_runs["cfg"], ref_runs["toks"], ref_runs["p0"])
    want = ref_runs["joint"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(h["eval"][-1][k], want["eval"][k],
                                   rtol=1e-4, atol=1e-7)
    grads = _ref_step_grads(ref_runs)
    for i, (a, b) in enumerate(zip(tree_leaves(s.params),
                                   tree_leaves(want["params"]))):
        d = (a - b).abs().numpy()
        if not d.size:
            continue
        assert float((d > 5e-5).mean()) <= 1e-4
        assert float(d.max()) <= 2e-3
        rel = np.min([np.abs(g[i]) / np.abs(g[i]).max() for g in grads],
                     axis=0)
        assert (rel[d > 5e-5] < 2e-6).all(), (i, rel[d > 5e-5])


def test_split_fit_matches_reference(ref_runs):
    """Split lossless over the queue: loss trail within rel 1e-4 of the
    reference's split fit, eval within rel 1e-4, and the same cut
    payload bytes per owner (the cut and its 4-byte aux)."""
    s, h = _fit(ref_runs["cfg"], ref_runs["toks"], ref_runs["p0"],
                mode="split")
    want = ref_runs["split"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(h["eval"][-1]["loss"], want["eval"]["loss"],
                               rtol=1e-4)
    for name, o in s.transport_stats["per_owner"].items():
        ro = want["ts"]["per_owner"][name]
        for k in ("cut_payload_bytes", "grad_payload_bytes"):
            assert o[k] == ro[k], k


def test_reference_session_fit_then_serve():
    """The reference's ``test_session_sequence_fit_and_serve``: the
    default reduced config trains through the facade and its fitted
    params serve the aligned contexts."""
    cfg = get_config(LLAMA, reduced=True)
    s = lm_session(cfg, make_token_dataset(16, 32, cfg.vocab, 0), "cpu")
    history = s.fit(steps=3, batch_size=4, verbose=False)
    assert np.isfinite(history["final"]["loss"])
    results, engine = s.serve_dataset(max_new=3, batch_slots=4,
                                      n_requests=4)
    assert len(results) == 4
    assert all(len(r.generated) == 3 for r in results.values())
    assert engine.stats["requests"] == 4


def test_reference_split_smoke_and_cut_bytes():
    """The reference's ``test_split_lm_training_smoke``: the default
    reduced config (bf16 cuts) trains split over the queue within 5e-2
    of joint, and each owner's cut bytes are (the bf16 analytic frame +
    the 4-byte aux) per step."""
    cfg = get_config(LLAMA, reduced=True)
    toks = make_token_dataset(16, 32, cfg.vocab, 0)
    split = lm_session(cfg, toks, "cpu")
    p0 = tree_map(torch.clone, split.params)
    h = split.fit(steps=3, batch_size=4, verbose=False, mode="split")
    joint = lm_session(cfg, toks, "cpu", p0)
    hj = joint.fit(steps=3, batch_size=4, verbose=False)
    assert np.isfinite(h["final"]["loss"])
    assert abs(h["final"]["loss"] - hj["final"]["loss"]) < 5e-2
    analytic = cut_layer_traffic(n_owners=2, batch=4, tokens_per_owner=16,
                                 cut_dim=split.adapter.model.k,
                                 bytes_per_el=2)
    for v in split.transport_stats["per_owner"].values():
        assert v["cut_payload_bytes"] == \
            (analytic["per_owner_forward_bytes"] + 4) * 3


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(schedule="sequential"),
                                dict(backend="direct")],
                         ids=["pipelined", "sequential", "direct"])
def test_split_equals_owner_clipped_oracle(compute, kw):
    """:func:`split_equals_oracle` on reduced llama."""
    cfg, _ = cfgs(compute)
    split_equals_oracle(cfg, tokens(cfg.vocab), **kw)


def split_equals_oracle(cfg, toks, **kw):
    """Split lossless == the per-owner-clipped joint oracle, bit for
    bit: params and loss trail."""
    first = lm_session(cfg, toks, "cpu")
    p0 = tree_map(torch.clone, first.params)
    trail = lm_owner_clipped_oracle(first, STEPS, BATCH)
    s = lm_session(cfg, toks, "cpu", p0)
    h = s.fit(steps=STEPS, batch_size=BATCH, verbose=False, mode="split",
              **kw)
    assert h["loss_trail"] == trail
    assert same_leaves(s.params, first.params)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_microbatched_split_equals_microbatched_joint(compute):
    """:func:`microbatched_split_equals_joint` on reduced llama."""
    cfg, _ = cfgs(compute)
    microbatched_split_equals_joint(cfg, tokens(cfg.vocab))


def microbatched_split_equals_joint(cfg, toks):
    """``microbatches=2``: split over the queue == the microbatched
    joint oracle bitwise, and within 1e-2 of the whole-batch fit."""
    base = lm_session(cfg, toks, "cpu")
    p0 = tree_map(torch.clone, base.params)
    hw = base.fit(steps=STEPS, batch_size=BATCH, verbose=False,
                  mode="split")
    j = lm_session(cfg, toks, "cpu", p0)
    hj = j.fit(steps=STEPS, batch_size=BATCH, verbose=False, microbatches=2)
    s = lm_session(cfg, toks, "cpu", p0)
    hs = s.fit(steps=STEPS, batch_size=BATCH, verbose=False, mode="split",
               microbatches=2)
    assert hs["loss_trail"] == hj["loss_trail"]
    assert same_leaves(s.params, j.params)
    np.testing.assert_allclose(hs["loss_trail"], hw["loss_trail"],
                               rtol=1e-2)


@pytest.mark.parametrize("compression", ["int8", "fp16"])
def test_lossy_codecs_track_lossless(compression, ref_runs):
    """:func:`lossy_codec_tracks_lossless` on reduced llama."""
    lossy_codec_tracks_lossless(compression, ref_runs)


def lossy_codec_tracks_lossless(compression, ref_runs):
    """int8 and fp16 cuts and cut gradients: the loss trail within 2e-2
    of lossless; int8 within 2e-2 of the reference's int8 split fit;
    the int8 frames are the codec's (B·S_p rows of k + 4 bytes)."""
    cfg, toks, p0 = ref_runs["cfg"], ref_runs["toks"], ref_runs["p0"]
    s, h = _fit(cfg, toks, p0, mode="split", compression=compression)
    np.testing.assert_allclose(h["loss_trail"], ref_runs["split"]["loss"],
                               rtol=2e-2)
    if compression == "int8":
        r = ref_session(ref_runs["rcfg"], toks)
        rh = r.fit(steps=STEPS, batch_size=BATCH, eval_frac=0.25,
                   verbose=False, mode="split", compression="int8")
        np.testing.assert_allclose(h["loss_trail"],
                                   [x["loss"] for x in rh["train"]],
                                   rtol=2e-2)
        rows = BATCH * (toks.shape[1] - 1) // 2
        for name, o in s.transport_stats["per_owner"].items():
            assert o["cut_payload_bytes"] == \
                (rows * (cfg.d_model + 4) + 4) * STEPS
            assert o == r.transport_stats["per_owner"][name] | {
                k: o[k] for k in o if k.endswith("wire_bytes")
                or k == "messages"}


def test_supervised_crash_recovers_bitwise():
    """:func:`supervised_crash_recovers` on reduced llama."""
    cfg, _ = cfgs()
    supervised_crash_recovers(cfg, tokens(cfg.vocab))


def supervised_crash_recovers(cfg, toks):
    """A crash of owner0 at step 3 on the queue (Adam owners): rolled
    back, respawned, replayed — params and loss trail equal the
    fault-free supervised run's and the unsupervised run's, bit for
    bit."""
    p0 = tree_map(torch.clone, lm_session(cfg, toks, "cpu").params)
    kw = dict(steps=6, batch_size=BATCH, verbose=False, mode="split",
              timeout=15.0)

    def run(env, **extra):
        with pytest.MonkeyPatch.context() as mp:
            if env:
                mp.setenv(faults.CHAOS_ENV, env)
            else:
                mp.delenv(faults.CHAOS_ENV, raising=False)
            s = lm_session(cfg, toks, "cpu", p0)
            return s, s.fit(**kw, **extra)["loss_trail"]

    crash = faults.FaultPlan([faults.Fault(
        party="owner0", action="crash", kind="head_fwd", occurrence=None,
        step=3)]).to_env()
    sc, lc = run(crash, supervise=True)
    s0, l0 = run(None, supervise=True)
    su, lu = run(None)
    assert [(e["party"], e["action"]) for e in sc.recovery_events] == \
        [("owner0", "respawn")]
    assert s0.recovery_events == []
    assert lc == l0 == lu
    assert same_leaves(sc.params, s0.params)
    assert same_leaves(sc.params, su.params)


def test_checkpoint_read_by_both_packages(tmp_path, ref_runs):
    """:func:`checkpoints_cross_packages` on reduced llama."""
    checkpoints_cross_packages(tmp_path, ref_runs)


def checkpoints_cross_packages(tmp_path, ref_runs):
    """``fit(ckpt_dir=, ckpt_every=)`` writes the LM's per-party files
    (stacked heads, leading dim P): the reference's ``restore_split``
    reads them leaf for leaf, a port session restores them and the
    reference's ``save_split`` of its params restores into the port."""
    cfg, toks, p0 = ref_runs["cfg"], ref_runs["toks"], ref_runs["p0"]
    s, _ = _fit(cfg, toks, p0, mode="split", ckpt_dir=str(tmp_path),
                ckpt_every=STEPS)
    step_dir = os.path.join(str(tmp_path), f"step_{STEPS:08d}")
    assert sorted(os.listdir(step_dir)) == ["owner0.npz", "owner1.npz",
                                            "trunk.npz"]
    theirs = ref_ckpt.restore_split(step_dir)
    ours = restore_split(step_dir)
    for tree in (theirs, ours):
        got = jax.tree.leaves(tree)
        assert len(got) == len(tree_leaves(s.params))
        for a, b in zip(got, tree_leaves(s.params)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    fresh = lm_session(cfg, toks, "cpu").restore(step_dir)
    assert same_leaves(fresh.params, s.params)
    ref_dir = ref_ckpt.save_split(str(tmp_path / "ref"),
                                  jax.tree.map(jnp.asarray,
                                               to_numpy(p0)), 1)
    back = lm_session(cfg, toks, "cpu").restore(ref_dir)
    assert same_leaves(back.params, p0)
    out = save_split(str(tmp_path / "again"), back.params, 2)
    assert same_leaves(lm_session(cfg, toks, "cpu").restore(out).params, p0)


def test_train_launcher_on_cpu(capsys):
    """:func:`launcher_runs` on reduced llama."""
    launcher_runs(capsys, LLAMA)


def launcher_runs(capsys, arch):
    """``python -m repro_torch.launch.train --arch <arch> --device cpu``:
    the reference's flags and lines, a finite final loss."""
    from repro_torch.launch.train import main
    loss = main(["--arch", arch, "--reduced", "--steps", "3", "--batch",
                 "4", "--seq", "32", "--log-every", "1", "--device", "cpu"])
    assert np.isfinite(loss)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch} reduced=True params=")
    assert [ln.split()[:3] for ln in lines[1:]] == [
        ["step", str(i), "aux=0.0000"] for i in range(3)]


def test_lm_fit_refusals_match_reference(ref_runs):
    """The reference's ``ValueError`` for ``aggregation="masked_sum"`` on
    the LM, from the port and from the reference."""
    cfg, toks, p0 = ref_runs["cfg"], ref_runs["toks"], ref_runs["p0"]
    s = lm_session(cfg, toks, "cpu", p0)
    with pytest.raises(ValueError, match="masked_sum"):
        s.fit(steps=1, batch_size=4, mode="split", aggregation="masked_sum")
    _, rcfg = cfgs()
    with pytest.raises(ValueError, match="masked_sum"):
        ref_session(rcfg, toks).fit(steps=1, batch_size=4, mode="split",
                                    aggregation="masked_sum")


def test_owner_template_needs_no_full_width_init():
    """A spawned owner learns its head's tree structure from the
    adapter's ``owner_template``: the LM's is the head at reduced widths
    (same depth, pattern and cut), so a full-width llama3.2-3b template
    holds a few million numbers, not the head's 595 million."""
    from repro_torch.federation.registry import build_adapter
    cfg = get_config(LLAMA).with_split(cut_layer=2).replace(n_layers=8)
    ad = build_adapter(cfg)
    tpl = ad.owner_template(1)
    assert sum(t.numel() for t in tree_leaves(tpl)) < 10_000_000
    small = get_config(LLAMA, reduced=True).replace(n_layers=8).with_split(
        cut_layer=2)
    real = build_adapter(small)
    full = real.owner_param_slice(real.init(torch.Generator().manual_seed(
        0)), 0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tpl)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, full))


def test_latency_and_log_every_on_the_lm(capsys):
    """``latency_s`` on the wire changes no bit of a split LM fit, and
    ``log_every`` prints the reference's step lines."""
    cfg, _ = cfgs()
    toks = tokens(cfg.vocab)
    p0 = tree_map(torch.clone, lm_session(cfg, toks, "cpu").params)
    runs = []
    for latency in (0.0, 0.002):
        s = lm_session(cfg, toks, "cpu", p0)
        h = s.fit(steps=STEPS, batch_size=BATCH, mode="split",
                  latency_s=latency, log_every=2)
        runs.append((s, h["loss_trail"]))
        assert s.transport_stats["latency_s"] == latency
    assert runs[0][1] == runs[1][1]
    assert same_leaves(runs[0][0].params, runs[1][0].params)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["0", "2"] * 2
    assert all(ln.split()[2].startswith("aux=") for ln in lines)
