"""gemma2-9b in the port against the JAX reference, on the CPU: the
config, prefill and decode past the sliding window with ring caches,
``swa_override`` and fp8 KV caches, the serving engine on ring caches
(wave, continuous, the session's ``serve_dataset``), and the loss and
its gradients.

The model is gemma2-9b reduced (d_model 256, 4 heads of 64, window 64,
vocab 512; GeGLU, pre and post norms, attention softcap 50, final-logit
softcap 30) at 4 layers: one head unit per owner (a local and a global
layer) and one trunk unit.  Contexts of 160 tokens put each owner's
slice (80) and the trunk's sequence (160) past the window, so a ring
prefill keeps the last 64 keys rolled by 16 or by 32 and every decode
step wraps.  Params come from the reference's init
(``weights.from_reference``).  Logits are held as in
``test_torch_lm.py``: f32 within rel 1e-4 of the largest, bf16 within
atol 5e-2.

fp8 caches in f32 compute are held otherwise.  The packages' f32 keys
and values differ in their last bits, and fp8's three mantissa bits turn
the few at a rounding midpoint into a whole code step: 163 of 542,720
cache bytes with ring caches, 1335 of 692,224 without (measured on these
inputs), so the logits part by up to 1e-3, past rel 1e-4.  There each
step's logits are held within a tenth of what fp8 storage itself moves
the reference's logits (its fp8 run against its f32-cache run: 1.3e-2 to
7e-2 here), and at most 0.5 % of the cache bytes may differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.federation import batching as ref_batching
from repro.federation.parties import sequence_parties as ref_seq_parties
from repro.federation.session import VerticalSession as RefSession
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.federation import VerticalSession, sequence_parties
from repro_torch.launch.engine import ServingEngine
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

from test_torch_lm_train import loss_and_grads_match

torch.set_num_threads(1)

GEMMA = "gemma2-9b"
N_LAYERS, CTX = 4, 160
FP8 = torch.float8_e4m3fn
# (ring, swa_override, fp8): ring caches; the long-context variant with
# full caches and with ring caches (the global layers' trimmed too); fp8
# KV storage with and without ring caches
VARIANTS = [pytest.param(True, 0, False, id="ring"),
            pytest.param(False, 48, False, id="override"),
            pytest.param(True, 48, False, id="override-ring"),
            pytest.param(True, 0, True, id="fp8-ring"),
            pytest.param(False, 0, True, id="fp8")]


def _pair(compute, n_layers=N_LAYERS):
    ref_cfg = ref_get_config(GEMMA, reduced=True).replace(
        n_layers=n_layers, compute_dtype=compute)
    cfg = get_config(GEMMA, reduced=True).replace(
        n_layers=n_layers, compute_dtype=compute)
    ref = RefSplitModel(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    return (ref, ref_params, SplitModel(cfg),
            from_reference(jax.tree.map(np.asarray, ref_params)))


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def _check(got, want, compute, atol=None):
    """``atol``, when given, in place of f32's rel 1e-4."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    if atol is not None:
        assert err <= atol, (err, atol)
    elif compute == "float32":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= 5e-2, err


def _ref_logits(ref, ref_params, ot, S, n_new, **cache_kw):
    """The reference's prefill and ``n_new - 1`` greedy decode steps:
    the last-token logits of each."""
    rc = ref.cache_init(ot.shape[1], S, n_new=n_new, **cache_kw)
    rl, rc = ref.prefill(ref_params, {"owner_tokens": jnp.asarray(ot)}, rc)
    out = [np.asarray(rl)]
    for t in range(n_new - 1):
        tok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
        rl, rc = ref.decode_step(ref_params, rc, tok, S + t,
                                 S // ot.shape[0] + t)
        out.append(np.asarray(rl))
    return out


def test_config_matches_reference():
    for reduced in (False, True):
        ours = dataclasses.asdict(get_config(GEMMA, reduced=reduced))
        ref = dataclasses.asdict(ref_get_config(GEMMA, reduced=reduced))
        assert ours == ref
    cfg = get_config(GEMMA)
    assert (cfg.q_dim, cfg.kv_dim, cfg.head_dim, cfg.n_superblocks) == \
        (4096, 2048, 256, 21)
    model = SplitModel(cfg)
    assert (model.n_head_units, model.n_trunk_units) == (5, 16)
    small = get_config(GEMMA, reduced=True)
    assert (small.swa_window, small.head_dim) == (64, 64)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring,swa_override,fp8", VARIANTS)
def test_prefill_and_decode_past_the_window_match_reference(
        ring, swa_override, fp8, compute):
    """Prefill 160 tokens, then five decode steps: the last-token logits
    at every step, the greedy tokens (f32), and (f32) every cache leaf as
    the reference's with the same cache options (fp8 caches: see the
    module docstring)."""
    ref, ref_params, ours, params = _pair(compute)
    B, S, P, n_new = 2, CTX, 2, 6
    ot = ref_batching.sequence_owner_slices(
        _tokens(B, S, ours.cfg.vocab), P)
    opts = dict(ring=ring, swa_override=swa_override)
    atols = [None] * n_new
    if fp8 and compute == "float32":
        # a tenth of what fp8 storage moves the reference's logits (the
        # fp8 variants take no swa_override)
        full = _ref_logits(ref, ref_params, ot, S, n_new, **opts)
        low = _ref_logits(ref, ref_params, ot, S, n_new, **opts,
                          cache_dtype=jnp.float8_e4m3fn)
        atols = [0.1 * np.abs(a - b).max() for a, b in zip(full, low)]
    rc = ref.cache_init(B, S, n_new=n_new, **opts,
                        cache_dtype=jnp.float8_e4m3fn if fp8 else None)
    tc = ours.cache_init(B, S, n_new=n_new, **opts,
                         cache_dtype=FP8 if fp8 else None)
    ov = swa_override or None
    rl, rc = ref.prefill(ref_params, {"owner_tokens": jnp.asarray(ot)}, rc,
                         swa_override=ov)
    with torch.inference_mode():
        tl, tc = ours.prefill(params, {"owner_tokens": torch.from_numpy(
            np.ascontiguousarray(ot))}, tc, swa_override=ov)
        for t in range(n_new - 1):
            _check(tl, rl, compute, atols[t])
            rtok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
            ttok = tl.argmax(-1)[:, None].to(torch.int32)
            if compute == "float32":
                np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok))
            else:
                ttok = torch.from_numpy(np.array(rtok))  # same input onward
            rl, rc = ref.decode_step(ref_params, rc, rtok, S + t, S // P + t,
                                     swa_override=ov)
            tl, tc = ours.decode_step(params, tc, ttok, S + t, S // P + t,
                                      swa_override=ov)
    _check(tl, rl, compute, atols[-1])
    leaves = list(zip(tree_leaves(tc), jax.tree.leaves(rc)))
    assert [tuple(a.shape) for a, _ in leaves] == \
        [tuple(b.shape) for _, b in leaves]
    if compute != "float32":
        return
    n_diff = n_fp8 = 0
    for a, b in leaves:
        if a.dtype == FP8:
            diff = a.view(torch.uint8).numpy() != np.asarray(b).view(np.uint8)
            n_diff, n_fp8 = n_diff + diff.sum(), n_fp8 + diff.size
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)
    assert n_diff <= 5e-3 * n_fp8, (n_diff, n_fp8)


def test_ring_prefill_attends_over_its_own_keys():
    """A ring prefill attends over the in-call keys, not the cache: its
    logits are bitwise those of the forward without a cache.  With every
    layer on a ring (``swa_override`` = the window trims the global
    layers too), fp8 ring caches give the same bits: the ring prefill
    never sees the fp8 rounding."""
    _, _, model, params = _pair("float32")
    B, S, P, W = 2, CTX, 2, model.cfg.swa_window
    ot = torch.from_numpy(np.ascontiguousarray(
        ref_batching.sequence_owner_slices(
            _tokens(B, S, model.cfg.vocab), P)))
    with torch.inference_mode():
        for ov, dtypes in ((None, (None,)), (W, (None, FP8))):
            want = model.forward(params, {"owner_tokens": ot},
                                 swa_override=ov)[0][:, -1]
            for dt in dtypes:
                caches = model.cache_init(B, S, n_new=4, ring=True,
                                          swa_override=ov or 0,
                                          cache_dtype=dt)
                got, _ = model.prefill(params, {"owner_tokens": ot}, caches,
                                       swa_override=ov)
                assert torch.equal(got, want), (ov, dt)


def _engine_tokens(model, params, ctxs, mixed, **kw):
    eng = ServingEngine(model, params, batch_slots=2, ctx_len=CTX,
                        max_new=6, device="cpu", **kw)
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
    out = eng.run()
    eng.close()
    return [out[r].generated for r in rids], eng.stats


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("transport", [None, "queue"])
def test_continuous_equals_wave_with_ring_caches(transport, compute):
    """``ring_cache=True`` past the window (contexts of 160, window 64):
    continuous batching (every slot at its own position: its own ring
    slot and its own ``min(p + 1, W)`` keys) gives the wave engine's
    tokens bit for bit, and both equal the full caches' tokens."""
    _, _, model, params = _pair(compute)
    rng = np.random.default_rng(0)
    ctxs = [rng.integers(0, model.cfg.vocab, CTX) for _ in range(5)]
    mixed = [2, 6, 1, 5, 3]
    kw = dict(transport=transport,
              compression="int8" if transport else None)
    wave, _ = _engine_tokens(model, params, ctxs, mixed, ring_cache=True,
                             **kw)
    cont, st = _engine_tokens(model, params, ctxs, mixed, ring_cache=True,
                              scheduler="continuous", **kw)
    assert cont == wave
    assert st["slot_refills"] > 0 and st["ticks"] < sum(mixed)
    if compute == "float32":
        full, _ = _engine_tokens(model, params, ctxs, mixed, **kw)
        assert full == wave


def test_ring_engine_matches_reference_engine():
    """f32: the port's wave and continuous engines on ring caches give
    the reference's ring wave engine's tokens."""
    ref, ref_params, model, params = _pair("float32")
    rng = np.random.default_rng(1)
    ctxs = [rng.integers(0, model.cfg.vocab, CTX) for _ in range(3)]
    mixed = [6, 3, 5]
    eng = RefServingEngine(ref, ref_params, batch_slots=2, ctx_len=CTX,
                           max_new=6, ring_cache=True)
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
    out = eng.run()
    want = [out[r].generated for r in rids]
    for scheduler in ("wave", "continuous"):
        got, _ = _engine_tokens(model, params, ctxs, mixed, ring_cache=True,
                                scheduler=scheduler)
        assert got == want, scheduler


def test_serve_dataset_on_ring_caches_matches_reference():
    """``VerticalSession(*sequence_parties(...))`` -> resolve -> build
    (gemma2-9b) -> ``serve_dataset(ring_cache=True)`` over the queue:
    the reference session's tokens and cut bytes."""
    cfg = get_config(GEMMA, reduced=True).replace(
        n_layers=N_LAYERS, compute_dtype="float32")
    ref_cfg = ref_get_config(GEMMA, reduced=True).replace(
        n_layers=N_LAYERS, compute_dtype="float32")
    toks = _tokens(4, CTX, cfg.vocab, seed=2)
    ref = RefSession(*ref_seq_parties(toks, 2, with_labels=False))
    ref.resolve(group="modp512")
    ref.build(ref_cfg)
    want, ref_eng = ref.serve_dataset(max_new=4, batch_slots=2,
                                      transport="queue", ring_cache=True)
    s = VerticalSession(*sequence_parties(toks, 2, with_labels=False),
                        device="cpu")
    s.resolve(group="modp512")
    s.build(cfg, params=from_reference(jax.tree.map(np.asarray,
                                                    ref.params)))
    for scheduler in ("wave", "continuous"):
        got, eng = s.serve_dataset(max_new=4, batch_slots=2,
                                   transport="queue", ring_cache=True,
                                   scheduler=scheduler)
        eng.close()
        assert eng.ring
        assert {r: got[r].generated for r in got} == \
            {r: want[r].generated for r in want}, scheduler
        if scheduler == "wave":
            assert eng.stats["cut_wire_bytes"] == \
                ref_eng.stats["cut_wire_bytes"]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_fn_and_grads_match_reference(compute):
    """``loss_fn`` and every gradient leaf against ``jax.grad`` of the
    reference's on documents of 160 tokens (past the window: the local
    mask, both softcaps, GeGLU and the post norms all carry gradient),
    with ``test_torch_lm_train.py``'s tolerances."""
    cfg = get_config(GEMMA, reduced=True).replace(
        n_layers=N_LAYERS, compute_dtype=compute)
    rcfg = ref_get_config(GEMMA, reduced=True).replace(
        n_layers=N_LAYERS, compute_dtype=compute)
    want, got = loss_and_grads_match(cfg, rcfg, compute, seq=CTX)
    assert sum(np.abs(g).sum() > 0 for g in got) == \
        sum(np.abs(w).sum() > 0 for w in want)
