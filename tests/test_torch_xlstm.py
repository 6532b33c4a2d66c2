"""xlstm-125m (the xLSTM family: sLSTM and mLSTM blocks) in the port
against the JAX reference, on the CPU: the config, the mLSTM's chunked
core and decode step, the sLSTM's scan, each block with a cache, the
split LM's logits, prefill and decode, the recurrent-decode invariant,
the loss and its gradients, fits (joint 3 steps against the reference's;
split lossless == the per-owner-clipped joint oracle bit for bit), the
wave and continuous engines against the reference's, and the launchers.

The model is xlstm-125m reduced (d_model 256, 4 heads, chunks of 32,
vocab 512) at 4 layers: one (sLSTM, mLSTM) unit per owner's head and one
in the trunk.  Params come from the reference's init
(``weights.from_reference``).  Logits are held as ``test_torch_lm.py``
holds them: f32 within rel 1e-4 of the largest, bf16 within atol 5e-2.
The mLSTM core contracts ``s * w`` with ``v`` where the reference writes
one three-operand einsum (``"blmh,blmh,bmhd->blhd"``, whose contraction
order is XLA's): the core and the blocks are held within rel 1e-4 of
the largest value in f32 (measured: under 3e-6).  In bf16 the core is
held within 2e-2 (atol and rtol, the kernels' bf16 tolerance: its
arithmetic is f32 on bf16 inputs), and the blocks, whose q, k, v and
gate projections round to bf16 before the core, within atol 5e-2, the
LM's bf16 rule (a block's largest gap measured: 2.2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models import xlstm as ref_xlstm
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.federation.registry import build_adapter
from repro_torch.launch.engine import ServingEngine
from repro_torch.models import xlstm
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

from test_torch_lm import (_check, _tokens, decode_matches_full_forward,
                           prefill_and_decode_match)
from test_torch_lm_train import (
    _fit, cfgs, launcher_runs, loss_and_grads_match, reference_runs,
    split_equals_oracle, tokens)

torch.set_num_threads(1)

XLSTM = "xlstm-125m"
N_LAYERS = 4
COMPUTE = ["float32", "bfloat16"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _close(got, want, dtype, block=False):
    """f32: within rel 1e-4 of the largest; bf16: the core within 2e-2
    (atol + rtol), a block within atol 5e-2 (see the docstring)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype in ("float32", torch.float32):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    elif block:
        assert np.abs(got - want).max() <= 5e-2
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _xcfgs(compute="float32", n_layers=N_LAYERS, **split):
    return cfgs(compute, n_layers, arch=XLSTM, **split)


def _pair(compute="float32"):
    cfg, rcfg = _xcfgs(compute)
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, rp, SplitModel(cfg), from_reference(
        jax.tree.map(np.asarray, rp))



def test_config_matches_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(XLSTM, reduced=reduced)) == \
            dataclasses.asdict(ref_get_config(XLSTM, reduced=reduced))
    cfg = get_config(XLSTM)
    assert cfg.block_pattern == ("slstm", "mlstm")
    assert (cfg.xlstm.chunk_size, cfg.n_superblocks) == (256, 6)
    assert get_config(XLSTM, reduced=True).xlstm.chunk_size == 32


# ---------------------------------------------------------------------------
# the mLSTM core and the sLSTM scan
# ---------------------------------------------------------------------------

def _mlstm_inputs(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    i_raw = rng.normal(size=(B, S, H)).astype(np.float32)
    f_raw = (rng.normal(size=(B, S, H)) + 2.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _carry(B, H, D, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, D, D)).astype(np.float32),
            np.abs(rng.normal(size=(B, H, D))).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32))


@pytest.mark.parametrize("dtype", COMPUTE)
@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("S,chunk", [(70, 32), (64, 32), (20, 32),
                                     (33, 8)])
def test_mlstm_chunked_matches_reference(S, chunk, with_carry, dtype):
    """y and the (C, n, m) carry against the reference's: a ragged last
    chunk (S not a multiple of the chunk: ``i`` padded with NEG, ``f``
    with 0, the carry decaying through the pad), one chunk shorter than
    the chunk size, and an incoming carry."""
    B, H, D = 2, 3, 16
    arrays = _mlstm_inputs(B, S, H, D)
    carry = _carry(B, H, D) if with_carry else None
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    j = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    y, (C, n, m) = xlstm.mlstm_chunked(
        *t, chunk, carry=None if carry is None else
        tuple(torch.from_numpy(c) for c in carry))
    yr, (Cr, nr, mr) = ref_xlstm.mlstm_chunked(
        *j, chunk, carry=None if carry is None else
        tuple(jnp.asarray(c) for c in carry))
    assert y.dtype == getattr(torch, dtype)
    assert C.dtype == n.dtype == m.dtype == torch.float32
    _close(y, yr, dtype)
    for a, b in ((C, Cr), (n, nr), (m, mr)):
        _close(a, b, "float32")


def test_mlstm_chunked_pads_like_the_reference():
    """The final carry of a ragged call decays through the pad (f padded
    with 0, i with NEG): it differs from the carry of the unpadded
    sequence, as the reference's does."""
    B, S, H, D = 1, 40, 2, 8
    t = [torch.from_numpy(a) for a in _mlstm_inputs(B, S, H, D, seed=3)]
    _, (_, _, m_ragged) = xlstm.mlstm_chunked(*t, 32)
    _, (_, _, m_whole) = xlstm.mlstm_chunked(*t, 40)
    assert not torch.equal(m_ragged, m_whole)
    j = [jnp.asarray(a) for a in _mlstm_inputs(B, S, H, D, seed=3)]
    _, (_, _, mr) = ref_xlstm.mlstm_chunked(*j, 32)
    _close(m_ragged, mr, "float32")


@pytest.mark.parametrize("dtype", COMPUTE)
def test_mlstm_step_matches_reference(dtype):
    B, H, D = 2, 4, 16
    arrays = _mlstm_inputs(B, 1, H, D, seed=5)
    carry = _carry(B, H, D, seed=6)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    j = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    y, got = xlstm.mlstm_step(*t, tuple(torch.from_numpy(c) for c in carry))
    yr, want = ref_xlstm.mlstm_step(*j, tuple(jnp.asarray(c) for c in carry))
    _close(y, yr, dtype)
    for a, b in zip(got, want):
        _close(a, b, "float32")


def _block_pair(kind, compute):
    rcfg = ref_get_config(XLSTM, reduced=True).replace(compute_dtype=compute)
    cfg = get_config(XLSTM, reduced=True).replace(compute_dtype=compute)
    init = {"slstm": ref_xlstm.slstm_init, "mlstm": ref_xlstm.mlstm_init}
    rp = init[kind](jax.random.PRNGKey(2), rcfg)
    return rcfg, rp, cfg, from_reference(jax.tree.map(np.asarray, rp))


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_without_cache_matches_reference(kind, compute):
    """A training forward (no cache) of 70 tokens: the sLSTM's ``h`` in
    x's dtype, the mLSTM's chunks ragged."""
    rcfg, rp, cfg, params = _block_pair(kind, compute)
    x = np.random.default_rng(7).normal(size=(2, 70, cfg.d_model)).astype(
        np.float32)
    apply = {"slstm": (xlstm.slstm_apply, ref_xlstm.slstm_apply),
             "mlstm": (xlstm.mlstm_apply, ref_xlstm.mlstm_apply)}[kind]
    y, cache = apply[0](params, torch.from_numpy(x).to(
        getattr(torch, compute)), cfg)
    yr, _ = apply[1](rp, jnp.asarray(x, JNP[compute]), rcfg)
    assert cache is None and y.dtype == getattr(torch, compute)
    _close(y, yr, compute, block=True)


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_prefill_and_decode_match_reference(kind, compute):
    """A prefill of 70 tokens into a cache, then three decode steps:
    outputs and every cache leaf (f32, updated in place in the port) as
    the reference's.  In a call with a cache the sLSTM's ``h`` and its
    projections after the scan are f32, whatever the compute dtype."""
    rcfg, rp, cfg, params = _block_pair(kind, compute)
    init = {"slstm": (xlstm.slstm_cache_init, ref_xlstm.slstm_cache_init),
            "mlstm": (xlstm.mlstm_cache_init, ref_xlstm.mlstm_cache_init)}
    apply = {"slstm": (xlstm.slstm_apply, ref_xlstm.slstm_apply),
             "mlstm": (xlstm.mlstm_apply, ref_xlstm.mlstm_apply)}[kind]
    B, S = 2, 70
    cache = init[kind][0](B, cfg)
    rc = init[kind][1](B, rcfg, jnp.float32)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(rc)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(8).normal(size=(B, S + 3, cfg.d_model)).astype(
        np.float32)
    dt = getattr(torch, compute)
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)):
        y, c2 = apply[0](params, torch.from_numpy(x[:, lo:hi]).to(dt), cfg,
                         cache)
        assert c2 is cache
        yr, rc = apply[1](rp, jnp.asarray(x[:, lo:hi], JNP[compute]), rcfg,
                          rc)
        _close(y, yr, compute, block=True)
        for a, b in zip(tree_leaves(cache), jax.tree.leaves(rc)):
            assert a.dtype == torch.float32
            _close(a, b, compute, block=True)


# ---------------------------------------------------------------------------
# the split LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", COMPUTE)
def test_forward_matches_reference(compute):
    """Logits of 2 rows of 64 tokens, and the aux (0 for xLSTM)."""
    ref, rp, ours, params = _pair(compute)
    toks = _tokens(2, 64, ours.cfg.vocab)
    want, raux = ref.forward(rp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = ours.forward(params, {"tokens": torch.from_numpy(toks)})
    _check(got, want, compute)
    assert float(aux) == float(raux) == 0.0


@pytest.mark.parametrize("compute", COMPUTE)
def test_prefill_and_decode_match_reference(compute):
    """Prefill 2 contexts of 96 (each owner's slice 48: one chunk and a
    ragged one) and 5 greedy decode steps against the reference
    (``test_torch_lm.prefill_and_decode_match``: logits at every step,
    in f32 the tokens and every cache leaf, the mLSTM's C, n, m and conv
    window and the sLSTM's c, n, h, m)."""
    prefill_and_decode_match(*_pair(compute), compute, 96, n_new=6,
                             seed=1)


def test_decode_matches_full_forward():
    """The recurrent-decode invariant (the reference's
    ``tests/test_recurrent_decode.py``) for the mLSTM matrix memory and
    the sLSTM scalar memory, in the port
    (``test_torch_lm.decode_matches_full_forward``, f32, 4 layers)."""
    decode_matches_full_forward(_xcfgs()[0])


@pytest.mark.parametrize("ring,swa,fp8", [(True, 0, False),
                                          (False, 48, False),
                                          (True, 48, True)])
def test_cache_options_leave_xlstm_caches_as_the_reference(ring, swa, fp8):
    """``ring``, ``swa_override`` and ``cache_dtype`` touch KV caches
    only: the xLSTM caches stay f32, full size and at their initial
    values, leaf for leaf the reference's."""
    cfg, rcfg = _xcfgs("bfloat16")
    ours, ref = SplitModel(cfg), RefSplitModel(rcfg)
    kw = dict(ring=ring, swa_override=swa)
    tc = ours.cache_init(2, 96, n_new=4, cache_dtype=(
        torch.float8_e4m3fn if fp8 else None), **kw)
    rc = ref.cache_init(2, 96, n_new=4, cache_dtype=(
        jnp.float8_e4m3fn if fp8 else None), **kw)
    got, want = tree_leaves(tc), jax.tree.leaves(rc)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xruns():
    """The reference's joint and split fits of reduced xlstm-125m
    (f32)."""
    cfg, rcfg = _xcfgs()
    return reference_runs(cfg, rcfg, tokens(cfg.vocab))


def test_loss_fn_and_grads_match_reference():
    """``loss_fn`` and every gradient leaf against the reference's
    ``jax.value_and_grad`` in f32 (within 1e-3 of each leaf's largest
    magnitude; ``test_torch_lm_train.loss_and_grads_match``), through
    the sLSTM's sequential scan and the mLSTM's chunks."""
    loss_and_grads_match(*_xcfgs(), "float32")


def test_joint_fit_matches_reference(xruns):
    """3 Adam steps jointly: loss trail and eval within rel 1e-4 of the
    reference's."""
    _, h = _fit(xruns["cfg"], xruns["toks"], xruns["p0"])
    want = xruns["joint"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(h["eval"][-1][k], want["eval"][k],
                                   rtol=1e-4, atol=1e-7)


def test_split_fit_matches_reference(xruns):
    """Split lossless over the queue: loss trail and eval within rel
    1e-4 of the reference's split fit, the same cut bytes per owner."""
    s, h = _fit(xruns["cfg"], xruns["toks"], xruns["p0"], mode="split")
    want = xruns["split"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(h["eval"][-1]["loss"], want["eval"]["loss"],
                               rtol=1e-4)
    for name, o in s.transport_stats["per_owner"].items():
        ro = want["ts"]["per_owner"][name]
        for k in ("cut_payload_bytes", "grad_payload_bytes"):
            assert o[k] == ro[k], k


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("kw", [dict(), dict(schedule="sequential")],
                         ids=["pipelined", "sequential"])
def test_split_equals_owner_clipped_oracle(compute, kw):
    """Split lossless == the per-owner-clipped joint oracle, bit for bit
    (``test_torch_lm_train.split_equals_oracle``)."""
    cfg, _ = _xcfgs(compute)
    split_equals_oracle(cfg, tokens(cfg.vocab), **kw)


def test_owner_kernel_sources_and_template():
    """An xLSTM head launches no kernel of the port's (no attention, no
    scan): a spawned CUDA owner builds nothing.  Its template is the
    head at reduced widths with the real head's structure."""
    cfg = get_config(XLSTM)
    ad = build_adapter(cfg)
    assert ad.owner_kernel_sources() == ()
    tpl = ad.owner_template(1)
    assert sum(t.numel() for t in tree_leaves(tpl)) < 10_000_000
    assert set(tpl["blocks"]["units"]) == {"b0", "b1"}
    assert tpl["blocks"]["units"]["b0"]["cell"]["r_gates"].shape[0] == 1


def test_train_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch xlstm-125m --reduced
    --device cpu`` (``test_torch_lm_train.launcher_runs``)."""
    launcher_runs(capsys, XLSTM)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(eng, ctxs, mixed):
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
    out = eng.run()
    eng.close()
    return [out[r].generated for r in rids], dict(eng.stats)


@pytest.mark.parametrize("transport,compression", [(None, None),
                                                   ("queue", "int8")])
def test_engines_match_reference_engines(transport, compression):
    """The wave and continuous engines (f32, 2 slots, contexts of 48,
    mixed max_new) against the reference's: the same tokens, ticks,
    refills and cut bytes; continuous == wave bitwise (the recurrent
    rows are independent of each other, and a refill's fresh caches
    start at m = NEG)."""
    ref, rp, ours, params = _pair()
    mixed = [2, 5, 1, 4, 3]
    rng = np.random.default_rng(4)
    ctxs = [rng.integers(0, ours.cfg.vocab, 48) for _ in mixed]
    runs = {}
    for sched in ("wave", "continuous"):
        kw = dict(batch_slots=2, ctx_len=48, max_new=5, scheduler=sched,
                  transport=transport, compression=compression)
        got, gs = _serve(ServingEngine(ours, params, device="cpu", **kw),
                         ctxs, mixed)
        want, ws = _serve(RefServingEngine(ref, rp, **kw), ctxs, mixed)
        assert got == want, sched
        for k in ("ticks", "slot_refills", "prefill_calls", "requests",
                  "tokens_generated", "cut_payload_bytes", "cut_wire_bytes",
                  "cut_messages", "waves"):
            assert gs[k] == ws[k], (sched, k)
        runs[sched] = got
    assert runs["wave"] == runs["continuous"]
    assert [len(g) for g in runs["wave"]] == mixed


def test_serve_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch xlstm-125m --reduced
    --device cpu`` serves its requests."""
    from repro_torch.launch.serve import main
    toks = main(["--arch", XLSTM, "--reduced", "--device", "cpu", "--batch",
                 "2", "--ctx", "32", "--new", "3"])
    assert toks.shape == (2, 3)
    assert capsys.readouterr().out.startswith("prefill 2x32 on cpu")
