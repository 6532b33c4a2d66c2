"""Training zamba2-2.7b, the SSM family, in the port against the JAX
reference, on the CPU: the SSD scan under autograd (``ssd_fn``: the
kernel's forward, ``ssd_backward``'s plain products), the Mamba2 block's
gradients, every leaf's gradient through ``splitnn.grads_of``, and
``VerticalSession.fit`` / ``evaluate`` on zamba2 (joint and split, queue
and direct, lossless, fp16 and int8, pipelined, sequential,
``microbatches=2``, latency, supervised recovery, checkpoints), the
owners' parameter template and ``repro_torch.launch.train``.

The model is zamba2-2.7b reduced (d_state 16, head_dim 32, chunks of
32) with 12 layers, cut after one unit: each head and the trunk run one
unit of five Mamba2 blocks and the shared attention block.  The fits
take 72 tokens a document, so each head's scan sees 36 (one chunk and a
ragged one of 4) and the trunk's 72 (two chunks and a ragged one of 8).
The checks llama3.2-3b makes too are the functions of
``test_torch_lm_train.py``, called here on zamba2.  Tolerances: the
scan's gradients 2e-4 (f32) / 2e-2 (bf16), absolute plus relative (the
kernel's); fits rel 1e-4 in loss; split lossless == the per-owner-
clipped joint oracle bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.core.splitnn import _leaf, grads_of
from repro_torch.federation import batching
from repro_torch.federation.registry import build_adapter
from repro_torch.kernels import mamba2_scan as scan_kernel
from repro_torch.kernels.mamba2_scan import autograd as scan_autograd
from repro_torch.models import ssm
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference

from test_torch_cuda import lm_session
from test_torch_lm_train import (
    BATCH, STEPS, _fit, cfgs, checkpoints_cross_packages, launcher_runs,
    loss_and_grads_match, lossy_codec_tracks_lossless,
    microbatched_split_equals_joint, reference_runs, same_leaves,
    split_equals_oracle, supervised_crash_recovers, tokens)

torch.set_num_threads(1)

ZAMBA = "zamba2-2.7b"
ZSEQ = 72


def zcfgs(compute="float32", n_layers=12, **split):
    """(port config, reference config): reduced zamba2-2.7b, 12 layers
    cut after one unit."""
    return cfgs(compute, n_layers, arch=ZAMBA, **split)


@pytest.fixture(scope="module")
def zruns():
    """The reference's joint and split fits of reduced zamba2 (f32)."""
    cfg, rcfg = zcfgs()
    return reference_runs(cfg, rcfg, tokens(cfg.vocab, seq=ZSEQ))


# ---------------------------------------------------------------------------
# the SSD scan under autograd
# ---------------------------------------------------------------------------

# B, S, H, P, G, N, chunk, initial state (and a final-state cotangent)
SCAN_CASES = [
    (2, 64, 4, 8, 1, 16, 32, False),     # two whole chunks, G = 1
    (2, 72, 4, 8, 2, 16, 32, True),      # a ragged third chunk, G = 2
    (1, 50, 6, 16, 3, 16, 16, True),     # four chunks, ragged, G = 3
    (2, 40, 4, 8, 1, 16, 64, False),     # one chunk shorter than `chunk`
    (2, 72, 16, 32, 1, 16, 32, False),   # reduced zamba2's trunk widths
]


def scan_inputs(B, S, H, P, G, N, init, seed=0):
    """x, dt > 0, A < 0, B, C, the initial state (or None), dy and
    dfinal (or None), f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(B, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)) - 1.0)).astype(f)
    A = (-np.exp(rng.normal(size=(H,)) * 0.5)).astype(f)
    Bm = rng.normal(size=(B, S, G, N)).astype(f)
    Cm = rng.normal(size=(B, S, G, N)).astype(f)
    s0 = rng.normal(size=(B, H, N, P)).astype(f) if init else None
    dy = rng.normal(size=(B, S, H, P)).astype(f)
    dfin = rng.normal(size=(B, H, N, P)).astype(f) if init else None
    return x, dt, A, Bm, Cm, s0, dy, dfin


def _torch_grads(fn, tensors, dy, dfin, chunk):
    """Gradients of <y, dy> + <final, dfin> through ``fn`` (the port's
    signature) with respect to ``tensors``."""
    leaves = [t.clone().requires_grad_() for t in tensors]
    y, fin = fn(*leaves[:5], chunk, leaves[5] if len(leaves) > 5 else None)
    obj = (y.float() * torch.from_numpy(dy)).sum()
    if dfin is not None:
        obj = obj + (fin * torch.from_numpy(dfin)).sum()
    obj.backward()
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_backward_matches_jax_and_plain_stages(case, dtype):
    """``ssd_fn``'s gradients (dx, ddt, dA, dB, dC and d initial_state)
    against ``jax.grad`` of the reference's ``ssd_chunked`` and against
    autograd through the plain chunk-parallel stages
    (``ref.ssd_chunk_parallel``, on the same values in f32), within 2e-4
    (f32) / 2e-2 (bf16),
    absolute plus relative; its forward is the wrapper's, bit for bit,
    and ``ssd_backward`` called alone gives the Function's gradients."""
    B, S, H, P, G, N, chunk, init = case
    x, dt, A, Bm, Cm, s0, dy, dfin = scan_inputs(B, S, H, P, G, N, init)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(x_, dt_, A_, B_, C_, s_):
        y, fs = ref_ssm.ssd_chunked(x_, dt_, A_, B_, C_, chunk,
                                    initial_state=s_)
        out = jnp.sum(y.astype(jnp.float32) * dy)
        return out + (jnp.sum(fs * dfin) if init else 0.0)

    jargs = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
             jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt),
             jnp.asarray(s0) if init else None]
    want = jax.grad(f, argnums=tuple(range(6 if init else 5)))(*jargs)
    tt = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
          torch.from_numpy(Cm).to(tdt)] + (
              [torch.from_numpy(s0)] if init else [])

    def fn(x_, dt_, A_, B_, C_, chunk_, s_):
        return scan_kernel.ssd_fn(x_, dt_, A_, B_, C_, chunk=chunk_,
                                  initial_state=s_)

    y, got = _torch_grads(fn, tt, dy, dfin, chunk)
    # the plain stages on f32 copies of the same values, with dy rounded
    # as y's dtype rounds it: autograd through them in bf16 would round
    # each stage's part of dx, dB and dC to bf16 before adding them (0.25
    # apart at |dx| ~ 30)
    dy_seen = torch.from_numpy(dy).to(tdt).float().numpy()
    _, plain = _torch_grads(scan_kernel.ssd_chunk_parallel,
                            [t.float() for t in tt], dy_seen, dfin, chunk)
    assert torch.equal(y, scan_kernel.mamba2_scan(
        *tt[:5], chunk=chunk, initial_state=tt[5] if init else None)[0])
    alone = scan_kernel.ssd_backward(
        *tt[:5], torch.from_numpy(dy).to(tdt),
        None if dfin is None else torch.from_numpy(dfin), chunk=chunk,
        initial_state=tt[5] if init else None)
    assert (alone[5] is None) == (not init)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for i, (w, g, p, a) in enumerate(zip(want, got, plain, alone)):
        assert g.dtype == tt[i].dtype and g.shape == tt[i].shape
        assert torch.equal(g, a)
        for other in (np.asarray(jnp.asarray(w, jnp.float32)),
                      p.float().numpy()):
            np.testing.assert_allclose(g.float().numpy(), other, atol=tol,
                                       rtol=tol, err_msg=f"input {i}")


@pytest.mark.parametrize("case", SCAN_CASES[1:3])
def test_plain_stages_in_f64_witness_the_backward(case):
    """On f64 inputs the plain stages compute in f64 (the witness that
    ``chip_smoke.py`` 21(a) holds f32 gradients against): y and the
    final state in f64 and within f32 rounding of the f32 stages, and
    ``ssd_backward``'s f32 gradients within 2e-4 (absolute plus
    relative) of autograd through them."""
    B, S, H, P, G, N, chunk, init = case
    x, dt, A, Bm, Cm, s0, dy, dfin = scan_inputs(B, S, H, P, G, N, init)
    t32 = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, s0)]
    y64, g64 = _torch_grads(scan_kernel.ssd_chunk_parallel,
                            [t.double() for t in t32], dy, dfin, chunk)
    y32, _ = scan_kernel.ssd_chunk_parallel(*t32[:5], chunk, t32[5])
    assert y64.dtype == torch.float64 and all(
        g.dtype == torch.float64 for g in g64)
    np.testing.assert_allclose(y64.numpy(), y32.numpy(), rtol=1e-5,
                               atol=1e-5)
    got = scan_kernel.ssd_backward(
        *t32[:5], torch.from_numpy(dy), torch.from_numpy(dfin), chunk=chunk,
        initial_state=t32[5])
    for i, (g, w) in enumerate(zip(got, g64)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=f"input {i}")


def test_ssd_backward_in_chunk_blocks(monkeypatch):
    """A call whose (B, chunks, L, L, H) block passes ``BLOCK_ELEMENTS``
    runs the chunk outputs' reverse in blocks of chunks: the same
    gradients within f32 rounding."""
    x, dt, A, Bm, Cm, s0, dy, dfin = scan_inputs(2, 100, 4, 8, 2, 16, True,
                                                 seed=1)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy, dfin)]
    kw = dict(chunk=16, initial_state=torch.from_numpy(s0))
    whole = scan_kernel.ssd_backward(*args, **kw)
    monkeypatch.setattr(scan_autograd, "BLOCK_ELEMENTS", 2 * 16 * 16 * 4 * 3)
    blocks = scan_kernel.ssd_backward(*args, **kw)
    for a, b in zip(whole, blocks):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _ref_block_params(rcfg, seed):
    return ref_ssm.mamba2_init(jax.random.PRNGKey(seed), rcfg)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba2_apply_grads_match_jax(compute):
    """A Mamba2 block's output and its gradients (every parameter and
    the input) against ``jax.grad`` of the reference's ``mamba2_apply``
    at reduced zamba2's widths over 72 tokens (chunks of 32, a ragged
    third): forward within 1e-4 (f32) / 5e-2 (bf16) of the largest
    output, gradients within 1e-3 / 5e-2 of each leaf's largest; the
    training forward went through ``ssd_fn``."""
    cfg, rcfg = zcfgs(compute)
    rp = _ref_block_params(rcfg, 3)
    tp = from_reference(jax.tree.map(np.asarray, rp))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, ZSEQ, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=(2, ZSEQ, cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, compute), getattr(torch, compute)

    def f(p, x_):
        out, _ = ref_ssm.mamba2_apply(p, x_, rcfg)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, rout), (rgp, rgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(rp, jnp.asarray(x, jdt))
    leaves = tree_map(_leaf, tp)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    calls = []
    real = scan_autograd.SSDScan.apply

    def counted(*a):
        calls.append(1)
        return real(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan_autograd.SSDScan, "apply", counted)
        out, _ = ssm.mamba2_apply(leaves, tx, cfg)
    assert len(calls) == 1
    (out.float() * torch.from_numpy(g)).sum().backward()
    fwd = 1e-4 if compute == "float32" else 5e-2
    rout = np.asarray(rout.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), rout,
                               atol=fwd * np.abs(rout).max(), rtol=0)
    frac = 1e-3 if compute == "float32" else 5e-2
    for w, t in zip(jax.tree.leaves(rgp) + [rgx],
                    tree_leaves(leaves) + [tx]):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), w,
                                   atol=frac * np.abs(w).max(), rtol=0)


def test_serving_forwards_stay_off_the_function():
    """Prefill (a cache) and a forward under ``no_grad`` take the
    wrapper, not ``ssd_fn``, and give its bits."""
    cfg, rcfg = zcfgs()
    tp = from_reference(jax.tree.map(np.asarray, _ref_block_params(rcfg, 5)))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan_autograd.SSDScan, "apply", None)   # would raise
        with torch.no_grad():
            a, _ = ssm.mamba2_apply(tp, x, cfg)
        b, _ = ssm.mamba2_apply(tp, x, cfg,
                                cache=ssm.mamba2_cache_init(2, cfg))
    c, _ = ssm.mamba2_apply(tree_map(_leaf, tp), x, cfg)
    assert torch.equal(a, b) and torch.equal(a, c.detach())


# ---------------------------------------------------------------------------
# the LM's loss and every leaf's gradient
# ---------------------------------------------------------------------------

def test_loss_fn_and_grads_match_reference():
    """``test_torch_lm_train.loss_and_grads_match`` on reduced zamba2 in
    f32 (``loss_fn``'s value and every gradient leaf against the
    reference's ``jax.value_and_grad``)."""
    loss_and_grads_match(*zcfgs(), "float32", seq=ZSEQ)


def test_bf16_grads_part_as_bf16_rounding_does():
    """In bf16 the loss within rel 2e-2 of the reference's, and the
    gradients held by limits that only the reference's own bf16 rounding
    sets: ``rr``, the reference's bf16 gradient against its f32 gradient
    from the same params, which nothing in the port moves.

    * Each leaf's distance to the reference's bf16 gradient (Frobenius)
      at most ``4 rr`` plus the port's f32 distance to the reference's
      f32 gradient (held under 1e-3 above).
    * The port's own bf16 departure from its f32 gradient, each leaf's
      Frobenius norm relative to the f32 leaf's, in root mean square over
      the leaves: at most 1.25x the reference's.

    Through twelve bf16 layers the rounding alone moves a leaf by 2.5–10 %
    of its norm in either package, past the 5e-2 of its largest entry
    that llama's three layers hold; readings and the faults these limits
    catch are in PERF.md.  A bf16 fault below that noise shows in the
    scan's and the block's bf16 tests above."""
    leaves = {c: loss_and_grads_match(*zcfgs(c), c, seq=ZSEQ,
                                      leafwise=False)
              for c in ("float32", "bfloat16")}
    (rf, pf), (rb, pb) = leaves["float32"], leaves["bfloat16"]
    own, ref_own = [], []
    for a, b, c, d in zip(rf, pf, rb, pb):
        norm = np.linalg.norm(a)
        if not norm:
            continue
        rr = np.linalg.norm(c - a)
        gap = np.linalg.norm(d - c)
        assert gap <= 4 * rr + np.linalg.norm(b - a), (gap / rr, a.shape)
        own.append((np.linalg.norm(d - b) / norm) ** 2)
        ref_own.append((rr / norm) ** 2)
    ratio = np.sqrt(np.mean(own) / np.mean(ref_own))
    assert ratio <= 1.25, ratio


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


def test_grads_of_gives_every_leaf_its_gradient():
    """The joint step's gradients (the adapter's ``loss_fn`` through
    ``splitnn.grads_of``, whose ``materialize_grads=True`` turns an
    unreached leaf into zeros) on a zamba2 head and trunk against
    ``jax.grad`` of the reference's ``loss_fn``: every leaf within 1e-3
    of its largest magnitude, and no element the reference gives a
    gradient above 1e-3 of its leaf's largest comes back zero — among
    them ``A_log``, ``dt_bias``, ``D``, ``conv_w`` and the shared
    attention's weights, in the heads and in the trunk."""
    cfg, rcfg = zcfgs()
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    toks = tokens(cfg.vocab, n=4, seq=ZSEQ)
    ot = batching.sequence_owner_slices(toks[:, :-1], 2)
    labels = toks[:, 1:].astype(np.int32)
    rg = jax.grad(lambda p: ref.loss_fn(p, {
        "owner_tokens": jnp.asarray(ot),
        "labels": jnp.asarray(labels)})[0])(rp)
    ad = build_adapter(cfg)
    leaves = tree_map(_leaf, from_reference(jax.tree.map(np.asarray, rp)))
    with torch.enable_grad():
        obj, _ = ad.loss_fn(leaves, {
            "owner_tokens": torch.from_numpy(np.ascontiguousarray(ot)),
            "labels": torch.from_numpy(labels.astype(np.int64))})
        grads = grads_of(obj, leaves)
    paths = _paths(leaves)
    got = tree_leaves(grads)
    want = jax.tree.leaves(rg)
    assert len(paths) == len(got) == len(want)
    reached = set()
    for path, w, g in zip(paths, want, got):
        w, g = np.asarray(w), g.numpy()
        big = np.abs(w) > 1e-3 * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max(),
                                   rtol=0, err_msg=path)
        assert not (big & (g == 0)).any(), path
        if big.any():
            reached.add(path)
    for seg in ("heads", "trunk"):
        for name in ("A_log", "dt_bias", "D", "conv_w", "in_proj/w"):
            assert f"/{seg}/blocks/units/b0/mamba/{name}" in reached, \
                (seg, name)
        for name in ("wq/w", "wk/w", "wv/w", "wo/w"):
            assert (f"/{seg}/blocks/shared/shared_attn/attn/{name}"
                    in reached), (seg, name)


# ---------------------------------------------------------------------------
# fit and evaluate against the reference
# ---------------------------------------------------------------------------

def test_joint_fit_matches_reference(zruns):
    """3 Adam steps jointly: loss trail and eval metrics within rel 1e-4
    of the reference's."""
    _, h = _fit(zruns["cfg"], zruns["toks"], zruns["p0"])
    want = zruns["joint"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(h["eval"][-1][k], want["eval"][k],
                                   rtol=1e-4, atol=1e-7)


def test_split_fit_matches_reference(zruns):
    """Split lossless over the queue: loss trail and eval within rel
    1e-4 of the reference's split fit, and the same cut payload bytes
    per owner."""
    s, h = _fit(zruns["cfg"], zruns["toks"], zruns["p0"], mode="split")
    want = zruns["split"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(h["eval"][-1]["loss"], want["eval"]["loss"],
                               rtol=1e-4)
    for name, o in s.transport_stats["per_owner"].items():
        ro = want["ts"]["per_owner"][name]
        for k in ("cut_payload_bytes", "grad_payload_bytes"):
            assert o[k] == ro[k], k


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(schedule="sequential"),
                                dict(backend="direct")],
                         ids=["pipelined", "sequential", "direct"])
def test_split_equals_owner_clipped_oracle(compute, kw):
    """Split lossless == the per-owner-clipped joint oracle, bit for
    bit (``test_torch_lm_train.split_equals_oracle``)."""
    cfg, _ = zcfgs(compute)
    split_equals_oracle(cfg, tokens(cfg.vocab, seq=ZSEQ), **kw)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_microbatched_split_equals_microbatched_joint(compute):
    """``microbatches=2``: split == the microbatched joint bitwise
    (``test_torch_lm_train.microbatched_split_equals_joint``)."""
    cfg, _ = zcfgs(compute)
    microbatched_split_equals_joint(cfg, tokens(cfg.vocab, seq=ZSEQ))


@pytest.mark.parametrize("compression", ["int8", "fp16"])
def test_lossy_codecs_track_lossless(compression, zruns):
    """int8 and fp16 cuts track lossless and the reference's int8 fit
    (``test_torch_lm_train.lossy_codec_tracks_lossless``)."""
    lossy_codec_tracks_lossless(compression, zruns)


def test_latency_changes_no_bit():
    """``latency_s`` on the wire changes no bit of a split zamba2 fit."""
    cfg, _ = zcfgs()
    toks = tokens(cfg.vocab, seq=ZSEQ)
    p0 = tree_map(torch.clone, lm_session(cfg, toks, "cpu").params)
    runs = []
    for latency in (0.0, 0.002):
        s = lm_session(cfg, toks, "cpu", p0)
        h = s.fit(steps=STEPS, batch_size=BATCH, mode="split",
                  latency_s=latency, verbose=False)
        runs.append((s, h["loss_trail"]))
    assert runs[0][1] == runs[1][1]
    assert same_leaves(runs[0][0].params, runs[1][0].params)


def test_supervised_crash_recovers_bitwise():
    """A crash of owner0 at step 3, rolled back, respawned and replayed
    (``test_torch_lm_train.supervised_crash_recovers``)."""
    cfg, _ = zcfgs()
    supervised_crash_recovers(cfg, tokens(cfg.vocab, seq=ZSEQ))


def test_checkpoint_read_by_both_packages(tmp_path, zruns):
    """zamba2's per-party files (its unit slots for the shared block are
    empty, its ``shared`` subtree is not) cross both packages
    (``test_torch_lm_train.checkpoints_cross_packages``)."""
    checkpoints_cross_packages(tmp_path, zruns)


def test_owner_template_at_full_width():
    """A spawned zamba2 owner's template: the head's structure at
    reduced widths (30 layers cut after 2: two units of five Mamba2
    blocks each, an empty slot for the shared block, the shared block
    itself), a few million numbers where the real head holds hundreds
    of millions; its structure is a real head's."""
    cfg = get_config(ZAMBA).replace(n_layers=30)
    ad = build_adapter(cfg)
    tpl = ad.owner_template(1)
    assert sum(t.numel() for t in tree_leaves(tpl)) < 10_000_000
    assert tpl["blocks"]["units"]["b5"] == {}
    assert tpl["blocks"]["units"]["b0"]["mamba"]["A_log"].shape[0] == 2
    assert tree_leaves(tpl["blocks"]["shared"]["shared_attn"])
    small = get_config(ZAMBA, reduced=True).replace(n_layers=30)
    real = build_adapter(small)
    full = real.owner_param_slice(real.init(torch.Generator().manual_seed(
        0)), 0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tpl)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, full))
    stacked = real.stack_head_params([full, full])
    assert stacked["blocks"]["units"]["b5"] == {}
    assert len(tree_leaves(stacked)) == len(tree_leaves(full))


def test_owner_kernel_sources():
    """The sources a session builds before it spawns CUDA owner workers:
    the attention kernels' for every attention LM, the scan's too for
    zamba2, none for xlstm-125m's heads (no attention, no scan) and
    none for the paper's MLP."""
    from repro_torch.configs import CONFIG as mlp
    from repro_torch.kernels import block_attention
    attention = tuple(block_attention.ops.SOURCES.values())
    scan = tuple(scan_kernel.ops.SOURCES.values())
    assert build_adapter(get_config(ZAMBA)).owner_kernel_sources() == \
        attention + scan
    assert build_adapter(get_config(
        "llama3.2-3b")).owner_kernel_sources() == attention
    assert build_adapter(get_config(
        "xlstm-125m")).owner_kernel_sources() == ()
    assert build_adapter(mlp).owner_kernel_sources() == ()


def test_train_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch zamba2-2.7b --reduced
    --device cpu`` (``test_torch_lm_train.launcher_runs``)."""
    launcher_runs(capsys, ZAMBA)
