"""KV cache variants of the port against the JAX reference, on the CPU:
ring-buffer caches (``update_kv_cache_ring``, ``cache_init(ring=True)``),
the long-context ``swa_override`` and fp8 KV storage
(``cache_dtype=torch.float8_e4m3fn``).

Inputs come from numpy seeds; model params cross over through
``weights.from_reference``.  Cache writes are compared leaf for leaf
(bitwise: a write is a copy and a cast), fp8 caches byte for byte, the
reference's own ring test (``tests/test_perf_levers.py``, on mixtral,
which the port does not build) on a reduced gemma2 at atol 2e-3, and
``swa_override`` on reduced llama3.2-3b and zamba2-2.7b with the inputs
of the reference's ``test_swa_long_context_variant``: f32 within rel
1e-4, bf16 within atol 5e-2, as in ``test_torch_lm.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models import attention as ref_attention
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import ServingEngine
from repro_torch.models import attention
from repro_torch.models.attention import RowPositions
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

torch.set_num_threads(1)

GEMMA, LLAMA, ZAMBA = "gemma2-9b", "llama3.2-3b", "zamba2-2.7b"
FP8 = torch.float8_e4m3fn
#: the port's cache dtypes and the reference's
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (FP8, jnp.float8_e4m3fn)]


def _np(t):
    """A port tensor as numpy, fp8 and bf16 as their bytes' dtypes."""
    if t.dtype == FP8:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bytes(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.itemsize == 1 else
                  np.uint16 if a.itemsize == 2 else np.uint32)


def _same_cache(ours, ref):
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bytes(_np(ours[name])),
                                      _bytes(ref[name]))


def _kv(B, Sq, nkv=2, hd=8, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, Sq, nkv, hd)) * scale).astype(np.float32)
            for _ in range(2)]


def _caches(B, W, dtype, jdtype, seed=1):
    """A port cache and the reference's with the same random contents."""
    k, v = _kv(B, W, seed=seed)
    ours = {"k": torch.from_numpy(k).to(dtype),
            "v": torch.from_numpy(v).to(dtype)}
    ref = {"k": jnp.asarray(_np(ours["k"])), "v": jnp.asarray(_np(ours["v"]))}
    assert ref["k"].dtype == jdtype
    return ours, ref


# ---------------------------------------------------------------------------
# update_kv_cache_ring
# ---------------------------------------------------------------------------

# (name, W, Sq, pos): a decode step that wraps (slot 13 % 8), a prefill of
# exactly 2W tokens (roll 0), one of 13 (keep the last 8, roll 5), and a
# prefill shorter than the window (a plain write at pos)
RING_CASES = [("decode_wrap", 8, 1, 13), ("roll0", 8, 16, 0),
              ("roll5", 8, 13, 0), ("short_prefill", 8, 5, 0),
              ("short_at_pos", 8, 3, 2)]


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16", "fp8"])
@pytest.mark.parametrize("name,W,Sq,pos", RING_CASES,
                         ids=[c[0] for c in RING_CASES])
def test_update_kv_cache_ring_matches_reference(name, W, Sq, pos, dtype,
                                                jdtype):
    B = 2
    ours, ref = _caches(B, W, dtype, jdtype)
    k, v = _kv(B, Sq, seed=2)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = attention.update_kv_cache_ring(ours, kt, vt, pos)
    assert got is ours                    # written in place
    want = ref_attention.update_kv_cache_ring(ref, jnp.asarray(k),
                                              jnp.asarray(v), pos)
    _same_cache(got, want)


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16", "fp8"])
def test_ring_decode_rows_write_at_their_own_slots(dtype, jdtype):
    """Continuous batching's decode step: row b writes at ``pos[b] % W``,
    each row as the reference's scalar write at that row's position."""
    B, W = 3, 8
    pos = [13, 2, 8]
    ours, ref = _caches(B, W, dtype, jdtype)
    k, v = _kv(B, 1, seed=3)
    attention.update_kv_cache_ring(ours, torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   RowPositions(pos, "cpu"))
    for b, p in enumerate(pos):
        row = {n: ref[n][b:b + 1] for n in ("k", "v")}
        want = ref_attention.update_kv_cache_ring(
            row, jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]), p)
        _same_cache({n: ours[n][b:b + 1] for n in ("k", "v")}, want)


# ---------------------------------------------------------------------------
# fp8 bytes: JAX's cast (NaN past 464) against torch's (saturating)
# ---------------------------------------------------------------------------


def _fp8_inputs():
    """Every bf16 bit pattern (as f32), then f32 values around the
    overflow edge: 448, 460, 464 and its f32 neighbours, 466, 470, 1e4,
    ±inf and NaN of both signs."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    every_bf16 = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    edge = np.array([448, 460, 463.99997, 464, 464.00003, 466, 470, 1e4,
                     np.inf, np.nan], np.float32)
    edge = np.concatenate([edge, -edge])
    x = np.concatenate([every_bf16, edge])
    n = -(-x.size // 16) * 16
    return np.pad(x, (0, n - x.size)).reshape(1, n // 16, 2, 8)


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_fp8_cache_bytes_match_reference(src):
    """Keys and values written into a float8_e4m3fn cache hold the
    reference's bytes, from f32 and bf16 activations alike: NaN (0x7f /
    0xff) where JAX rounds past 448 (|x| > 464, ±inf), 448 at 460 and at
    464 (round half to even), where torch's own cast would saturate."""
    x = _fp8_inputs()
    S = x.shape[1]
    if src == "bfloat16":      # the same bits in both (NaN payloads too)
        with np.errstate(invalid="ignore"):
            x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    ours = attention.init_kv_cache(1, S, 2, 8, FP8)
    attention.update_kv_cache(ours, xt, -xt, 0)
    ref = ref_attention.update_kv_cache(
        ref_attention.init_kv_cache(1, S, 2, 8, jnp.float8_e4m3fn),
        xj, -xj, 0)
    _same_cache(ours, ref)
    got = _np(ours["k"]).astype(np.float32).ravel()
    xs = np.asarray(xj.astype(jnp.float32)).ravel()
    past = np.abs(xs) > 464
    assert past.sum() > 1000 and np.isnan(got[past]).all()
    for v in (460.0, 464.0):
        assert (got[xs == v] == 448.0).all() and (got[xs == -v] == -448).all()
    # torch's own cast differs there: the reason for the port's rule
    plain = xt.to(FP8).view(torch.uint8).numpy().ravel()
    assert (plain[past & ~np.isnan(xs)] & 0x7f == 0x7e).all()


# ---------------------------------------------------------------------------
# cache_init: leaf shapes and dtypes for ring x swa_override x cache_dtype
# ---------------------------------------------------------------------------


def _ref_cache_dtype(cache_dtype):
    return None if cache_dtype is None else jnp.float8_e4m3fn


@pytest.mark.parametrize("cache_dtype", [None, FP8, "float8_e4m3fn"],
                         ids=["compute", "fp8", "fp8-name"])
@pytest.mark.parametrize("swa_override", [0, 24])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch,n_layers", [(GEMMA, 4), (LLAMA, 4),
                                           (ZAMBA, 12)])
def test_cache_init_leaves_match_reference(arch, n_layers, ring,
                                           swa_override, cache_dtype):
    """Every cache leaf's shape and dtype is the reference's: ring caches
    trimmed to the window (``attn:local`` to ``swa_window``, global and
    shared attention to ``swa_override`` when set), KV caches in the
    cache dtype, Mamba2 caches in f32."""
    cfg = get_config(arch, reduced=True).replace(n_layers=n_layers)
    ref_cfg = ref_get_config(arch, reduced=True).replace(n_layers=n_layers)
    B, S, n_new = 2, 128, 5
    ours = SplitModel(cfg).cache_init(B, S, n_new=n_new, ring=ring,
                                      swa_override=swa_override,
                                      cache_dtype=cache_dtype)
    ref = RefSplitModel(ref_cfg).cache_init(
        B, S, n_new=n_new, ring=ring, swa_override=swa_override,
        cache_dtype=_ref_cache_dtype(cache_dtype))
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in tree_leaves(ours)]
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(ref)]
    assert got == want
    sizes = {tuple(t.shape)[-3] for t in tree_leaves(ours["trunk"])
             if t.dim() >= 5}
    if ring and arch == GEMMA:
        assert cfg.swa_window in sizes


def _kv_bytes(caches):
    return sum(t.numel() * t.element_size() for t in tree_leaves(caches))


def test_ring_and_fp8_caches_are_smaller():
    """Ring caches hold fewer bytes than full ones; fp8 caches half of
    bf16's."""
    model = SplitModel(get_config(GEMMA, reduced=True).replace(n_layers=4))
    full = _kv_bytes(model.cache_init(2, 256, n_new=8))
    ring = _kv_bytes(model.cache_init(2, 256, n_new=8, ring=True))
    fp8 = _kv_bytes(model.cache_init(2, 256, n_new=8, ring=True,
                                     cache_dtype=FP8))
    assert ring < full and 2 * fp8 == ring


# ---------------------------------------------------------------------------
# the reference's ring test, on a reduced gemma2
# ---------------------------------------------------------------------------


def test_ring_cache_decode_matches_full_cache():
    """The reference's ``test_ring_cache_decode_matches_full_cache``
    (``tests/test_perf_levers.py``, on mixtral there): with a window of
    16 and contexts of 32, two decode steps through ring caches give the
    full caches' logits within 2e-3, and the ring caches are smaller."""
    cfg = get_config(GEMMA, reduced=True).replace(
        n_layers=4, compute_dtype="float32", swa_window=16)
    model = SplitModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S, P = 2, 32, 2
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ot = torch.from_numpy(np.ascontiguousarray(
        toks.reshape(B, P, S // P).transpose(1, 0, 2)))
    new = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32))
    outs = {}
    with torch.inference_mode():
        for ring in (False, True):
            caches = model.cache_init(B, S, n_new=4, ring=ring)
            _, c = model.prefill(params, {"owner_tokens": ot}, caches)
            l1, c = model.decode_step(params, c, new, S, S // P)
            t2 = l1.argmax(-1)[:, None].to(torch.int32)
            l2, _ = model.decode_step(params, c, t2, S + 1, S // P + 1)
            outs[ring] = (l1.numpy(), l2.numpy())
    assert _kv_bytes(model.cache_init(B, S, ring=True)) < \
        _kv_bytes(model.cache_init(B, S, ring=False))
    for i in range(2):
        np.testing.assert_allclose(outs[False][i], outs[True][i],
                                   atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# swa_override on the dense and hybrid configs
# ---------------------------------------------------------------------------


def _check(got, want, compute):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    if compute == "float32":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= 5e-2, err


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [LLAMA, ZAMBA])
def test_swa_long_context_variant_matches_reference(arch, compute):
    """The reference's ``test_swa_long_context_variant`` inputs (reduced,
    B 2, S 32, all-ones context, ``swa_override=16``): prefill and one
    decode step give the reference's logits, and the window moves them
    (the context is longer than 16)."""
    B, S = 2, 32
    ref_cfg = ref_get_config(arch, reduced=True).replace(
        compute_dtype=compute)
    cfg = get_config(arch, reduced=True).replace(compute_dtype=compute)
    ref = RefSplitModel(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    ours = SplitModel(cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params))
    P = cfg.split.n_owners
    rc = ref.cache_init(B, S, n_new=4)
    rl, rc = ref.prefill(ref_params, {"owner_tokens": jnp.ones(
        (P, B, S // P), jnp.int32)}, rc, swa_override=16)
    r2, _ = ref.decode_step(ref_params, rc, jnp.zeros((B, 1), jnp.int32),
                            S, S // P, swa_override=16)
    with torch.inference_mode():
        tc = ours.cache_init(B, S, n_new=4)
        ot = torch.ones((P, B, S // P), dtype=torch.int32)
        tl, tc = ours.prefill(params, {"owner_tokens": ot}, tc,
                              swa_override=16)
        t2, _ = ours.decode_step(params, tc, torch.zeros((B, 1),
                                                         dtype=torch.int32),
                                 S, S // P, swa_override=16)
        full, _ = ours.prefill(params, {"owner_tokens": ot},
                               ours.cache_init(B, S, n_new=4))
    _check(tl, rl, compute)
    _check(t2, r2, compute)
    if compute == "float32":
        assert (tl - full).abs().max() > 1e-3


@pytest.mark.parametrize("arch", [LLAMA, ZAMBA])
def test_swa_override_forward_matches_reference(arch):
    """``forward(..., swa_override=)`` (training's path) on random tokens,
    f32."""
    ref_cfg = ref_get_config(arch, reduced=True).replace(
        compute_dtype="float32")
    cfg = get_config(arch, reduced=True).replace(compute_dtype="float32")
    ref = RefSplitModel(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, ref_params))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)
    want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(toks)},
                          swa_override=16)
    got, _ = SplitModel(cfg).forward(params, {"tokens": torch.from_numpy(
        toks)}, swa_override=16)
    _check(got, want, "float32")


# ---------------------------------------------------------------------------
# the engine: ring caches and the cut cache's tag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("transport", [None, "queue"])
def test_cut_cache_tag_carries_the_ring_flag(ring, transport):
    """The cut cache's entity tag is the reference engine's, the ring
    flag included, so ring and full entries never mix."""
    cfg = get_config(GEMMA, reduced=True).replace(n_layers=4)
    ref_cfg = ref_get_config(GEMMA, reduced=True).replace(n_layers=4)
    model = SplitModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    ref = RefSplitModel(ref_cfg)
    row = np.random.default_rng(0).integers(0, cfg.vocab, 96).astype(
        np.int32)
    kw = dict(batch_slots=2, ctx_len=96, max_new=4, ring_cache=ring,
              transport=transport)
    eng = ServingEngine(model, params, device="cpu", **kw)
    ref_eng = RefServingEngine(ref, ref.init(jax.random.PRNGKey(0)), **kw)
    tag = eng._entity_tag(row)
    assert tag == ref_eng._entity_tag(row)
    assert tag.split(":")[1] == str(int(ring))
    eng.close()
    ref_eng.close()

