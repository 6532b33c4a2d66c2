"""The port's attention and layers against the JAX reference, on the CPU.

On a CPU tensor the attention wrapper runs its plain version (the CUDA
kernel runs only on the card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version there).  Here the
plain version is held against the reference's attention on every case
of the reference's kernel tests plus queries over a cache
(``q_offset``/``kv_len``), and against the reference's Pallas kernel in
interpret mode where the kernel takes the case (``q_offset = 0``).
Tolerances are the reference's kernel tolerances: 2e-4 in f32, 2e-2 in
bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.block_attention.ops import \
    block_attention as ref_block_attention
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import mlp as ref_mlp
from repro_torch.configs import get_config
from repro_torch.kernels.block_attention import block_attention
from repro_torch.models import attention, layers, mlp
from repro_torch.weights import from_reference
from test_kernels import ATTN_CASES as REF_ATTN_CASES
from test_torch_cuda import ATTN_CASES, DECODE_CASES, attn_inputs, attn_tol

torch.set_num_threads(1)

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _both(arrays, tdt, jdt):
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_cases_are_the_reference_kernel_cases():
    assert ATTN_CASES == REF_ATTN_CASES


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [c + (0, None) for c in ATTN_CASES]
                         + DECODE_CASES)
def test_plain_attention_matches_reference(case, dtype):
    """The port's plain version (through the wrapper, on the CPU) against
    ``repro.models.attention.attention`` with the same q_offset and
    kv_len."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    (q, k, v), (jq, jk, jv) = _both(attn_inputs(B, Sq, Skv, nh, nkv, hd),
                                    *dtype)
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    got = block_attention(q, k, v, **kw)
    assert got.dtype == dtype[0] and got.shape == q.shape
    want = ref_attention.attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **attn_tol(dtype[0]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_attention_matches_pallas_kernel(case, dtype):
    """Against the reference's Pallas kernel in interpret mode, which has
    no q_offset or kv_len (the port's defaults give its function)."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap = case
    (q, k, v), (jq, jk, jv) = _both(attn_inputs(B, Sq, Skv, nh, nkv, hd),
                                    *dtype)
    got = block_attention(q, k, v, kind=kind, window=window, softcap=cap)
    want = ref_block_attention(jq, jk, jv, kind=kind, window=window,
                               softcap=cap, block_q=64, block_k=64,
                               interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **attn_tol(dtype[0]))


def _cfg(compute="float32"):
    ref = ref_get_config("llama3.2-3b", reduced=True).replace(
        compute_dtype=compute, n_kv_heads=2)
    ours = get_config("llama3.2-3b", reduced=True).replace(
        compute_dtype=compute, n_kv_heads=2)
    return ref, ours


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 8)])
def test_attn_apply_with_cache_matches_reference(kind, window):
    """Prefill of 12 tokens into a cache, then two decode tokens: the
    sub-layer's outputs and the cache contents, in f32 (GQA group 2)."""
    ref_cfg, cfg = _cfg()
    p = jax.tree.map(np.asarray,
                     ref_attention.attn_init(jax.random.PRNGKey(0), ref_cfg))
    tp = from_reference(p)
    rng = np.random.default_rng(0)
    B, S, d = 2, 12, cfg.d_model
    xs = rng.normal(size=(B, S + 2, d)).astype(np.float32)
    rc = ref_attention.init_kv_cache(B, 20, cfg.n_kv_heads, cfg.head_dim,
                                     jnp.float32)
    tc = attention.init_kv_cache(B, 20, cfg.n_kv_heads, cfg.head_dim,
                                 torch.float32)
    for pos, n in ((0, S), (S, 1), (S + 1, 1)):
        x = xs[:, pos:pos + n]
        positions = np.arange(pos, pos + n)
        ro, rc = ref_attention.attn_apply(
            p, jnp.asarray(x), cfg=ref_cfg, kind=kind, window=window,
            positions=jnp.asarray(positions), cache=rc, pos=pos)
        to, tc = attention.attn_apply(
            tp, torch.from_numpy(x), cfg=cfg, kind=kind, window=window,
            positions=torch.from_numpy(positions), cache=tc, pos=pos)
        np.testing.assert_allclose(_np(to), _np(ro), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(rc[name]),
                                   rtol=1e-5, atol=1e-5)


def test_norms_rope_embed_dense_match_reference():
    """The layers the reference casts at every use: f32 reductions in
    the norms, rope in f32 then cast back, the whole embedding table cast
    before the gather, the f32 weight cast to the activation dtype."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    for tdt, jdt in DTYPES:
        tol = attn_tol(tdt)
        tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
        for kind in ("rmsnorm", "layernorm"):
            p = {"scale": scale} if kind == "rmsnorm" else \
                {"scale": scale + 1.0, "bias": scale}
            got = layers.norm_apply(from_reference(p), tx, kind)
            want = ref_layers.norm_apply(p, jx, kind)
            assert got.dtype == tdt
            np.testing.assert_allclose(_np(got), _np(want), **tol)
        pos = np.arange(10, 16)
        got = layers.apply_rope(tx, torch.from_numpy(pos), 500000.0)
        want = ref_layers.apply_rope(jx, jnp.asarray(pos), 500000.0)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        table = rng.normal(size=(50, 64)).astype(np.float32)
        ids = rng.integers(0, 50, (2, 7)).astype(np.int32)
        got = layers.embed_apply({"table": torch.from_numpy(table)},
                                 torch.from_numpy(ids), tdt)
        want = ref_layers.embed_apply({"table": jnp.asarray(table)},
                                      jnp.asarray(ids), jdt)
        np.testing.assert_array_equal(_np(got), _np(want))
        w = rng.normal(size=(64, 32)).astype(np.float32)
        got = layers.dense_apply({"w": torch.from_numpy(w)}, tx)
        want = ref_layers.dense_apply({"w": jnp.asarray(w)}, jx)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want),
                                   **(tol if tdt == torch.bfloat16
                                      else dict(rtol=1e-5, atol=1e-4)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(kind):
    p = jax.tree.map(np.asarray,
                     ref_mlp.mlp_init(jax.random.PRNGKey(2), 32, 64, kind))
    x = np.random.default_rng(2).normal(size=(3, 5, 32)).astype(np.float32)
    got = mlp.mlp_apply(from_reference(p), torch.from_numpy(x), kind)
    want = ref_mlp.mlp_apply(p, jnp.asarray(x), kind)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
