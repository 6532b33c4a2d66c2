"""The port's Mamba2 pieces against the JAX reference, on the CPU: the
plain SSD scan (``ssd_chunked``) against the reference's jnp oracle and
its Pallas kernel in interpret mode, the decode step, the causal conv,
and the whole Mamba2 block with a cache, from shared params.

Tolerances: the reference kernel test's (``tests/test_kernels.py``:
2e-4 in f32, 2e-2 in bf16, absolute and relative) for the scan; the
conv is the same sum of products in the same order (bitwise); the
block in f32 within 1e-4.  The CUDA kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.mamba2_scan.ops import mamba2_scan as ref_mamba2_scan
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels import mamba2_scan as scan_kernel
from repro_torch.kernels.mamba2_scan import ops as scan_ops
from repro_torch.kernels.mamba2_scan import ssd_chunked
from repro_torch.models import ssm
from repro_torch.weights import from_reference
from test_kernels import SSD_CASES as REF_SSD_CASES
from test_torch_cuda import SSD_CASES, attn_tol, scan_inputs

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(arrays, dtype):
    """numpy x, dt, A, B, C -> (torch tensors, jnp arrays); x, B and C
    in ``dtype``, dt and A in f32."""
    x, dt, A, Bi, Ci = arrays
    t = [torch.from_numpy(a) for a in arrays]
    t = [t[0].to(dtype), t[1], t[2], t[3].to(dtype), t[4].to(dtype)]
    j = [jnp.asarray(x, JNP[dtype]), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bi, JNP[dtype]), jnp.asarray(Ci, JNP[dtype])]
    return t, j


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **attn_tol(dtype))


def test_cases_are_the_reference_kernel_cases():
    assert SSD_CASES[:len(REF_SSD_CASES)] == REF_SSD_CASES


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_scan_matches_reference(case, dtype):
    """y and the final state against the reference's ``ssd_chunked``."""
    B, S, H, P, G, N, chunk = case
    t, j = _both(scan_inputs(B, S, H, P, G, N), dtype)
    y, st = ssd_chunked(*t, chunk)
    yr, sr = ref_ssm.ssd_chunked(*j, chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert st.shape == (B, H, N, P)
    _close(y, yr, dtype)
    _close(st, sr, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", REF_SSD_CASES)
def test_plain_scan_matches_pallas_kernel(case, dtype):
    """Against the reference's Pallas kernel, in interpret mode."""
    B, S, H, P, G, N, chunk = case
    t, j = _both(scan_inputs(B, S, H, P, G, N), dtype)
    y, st = ssd_chunked(*t, chunk)
    yr, sr = ref_mamba2_scan(*j, chunk=chunk, interpret=True)
    _close(y, yr, dtype)
    _close(st, sr, dtype)


@pytest.mark.parametrize("case", [(2, 100, 4, 32, 2, 16, 32),
                                  (1, 64, 2, 16, 1, 8, 64)])
def test_plain_scan_with_initial_state_matches_reference(case):
    """A nonzero ``initial_state`` (the model's cache state) is carried
    into the first chunk and decays as the reference's."""
    B, S, H, P, G, N, chunk = case
    t, j = _both(scan_inputs(B, S, H, P, G, N), torch.float32)
    s0 = np.random.default_rng(5).normal(size=(B, H, N, P)).astype(
        np.float32)
    y, st = ssd_chunked(*t, chunk, initial_state=torch.from_numpy(s0))
    yr, sr = ref_ssm.ssd_chunked(*j, chunk, initial_state=jnp.asarray(s0))
    _close(y, yr, torch.float32)
    _close(st, sr, torch.float32)
    y0, _ = ssd_chunked(*t, chunk)
    assert not torch.allclose(y, y0)


def test_plain_scan_is_chunk_independent():
    """The chunked recurrence is exact: the chunk cannot change y or the
    final state (the reference's test, on a ragged sequence too)."""
    for S in (128, 100):
        t, _ = _both(scan_inputs(1, S, 2, 16, 1, 8, seed=3), torch.float32)
        outs = [ssd_chunked(*t, c) for c in (16, 32, 128)]
        for y, st in outs[1:]:
            torch.testing.assert_close(y, outs[0][0], atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(st, outs[0][1], atol=1e-4, rtol=1e-4)


def test_wrapper_runs_the_plain_version_only_on_the_cpu(monkeypatch):
    """A CPU tensor takes the plain version (and counts no launch); a
    mix of devices is checked for the kernel and never reaches it; meta
    tensors describe the card's launch (the dry-run's trace): no plain
    version, no launch counted."""
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].device.type)
        return ssd_chunked(*a, **kw)
    monkeypatch.setattr(scan_ops.ref, "ssd_chunked", spy)
    t, _ = _both(scan_inputs(1, 64, 2, 16, 1, 8), torch.float32)
    n0 = scan_kernel.launch_counts["mamba2_scan"]
    scan_kernel.mamba2_scan(*t, chunk=32)
    assert calls == ["cpu"]
    assert scan_kernel.launch_counts["mamba2_scan"] == n0
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_kernel.mamba2_scan(meta[0], *t[1:], chunk=32)
    y, state = scan_kernel.mamba2_scan(*meta, chunk=32)
    assert y.device.type == "meta" and y.shape == t[0].shape
    assert state.shape == (1, 2, 8, 16)
    assert calls == ["cpu"]
    assert scan_kernel.launch_counts["mamba2_scan"] == n0
    src = inspect.getsource(scan_ops.mamba2_scan)
    assert src.count("ref.") == 1 and 'x.device.type == "cpu"' in src


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ssd_step_matches_reference(dtype):
    B, H, P, G, N = 2, 4, 16, 2, 8
    x, dt, A, Bi, Ci = scan_inputs(B, 1, H, P, G, N, seed=7)
    s0 = np.random.default_rng(8).normal(size=(B, H, N, P)).astype(
        np.float32)
    t, j = _both((x, dt, A, Bi, Ci), dtype)
    y, st = ssm.ssd_step(*t, torch.from_numpy(s0))
    yr, sr = ref_ssm.ssd_step(*j, jnp.asarray(s0))
    assert y.dtype == dtype and st.dtype == torch.float32
    _close(y, yr, dtype)
    _close(st, sr, torch.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_conv1d_matches_reference(dtype, with_state):
    """The same four shifted products in the same order, in x's dtype:
    bitwise equal, with and without the decode window."""
    rng = np.random.default_rng(9)
    w = (rng.normal(size=(4, 24)) * 0.2).astype(np.float32)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state \
        else None
    y, ns = ssm.conv1d_apply(torch.from_numpy(w),
                             torch.from_numpy(x).to(dtype),
                             None if st is None else torch.from_numpy(st))
    yr, nsr = ref_ssm.conv1d_apply(jnp.asarray(w),
                                   jnp.asarray(x, JNP[dtype]),
                                   None if st is None else jnp.asarray(st))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(yr, np.float32))
    np.testing.assert_array_equal(ns.float().numpy(),
                                  np.asarray(nsr, np.float32))


def _block_pair(compute):
    ref_cfg = ref_get_config("zamba2-2.7b", reduced=True).replace(
        compute_dtype=compute)
    cfg = get_config("zamba2-2.7b", reduced=True).replace(
        compute_dtype=compute)
    ref_params = ref_ssm.mamba2_init(jax.random.PRNGKey(1), ref_cfg)
    return ref_cfg, ref_params, cfg, from_reference(
        jax.tree.map(np.asarray, ref_params))


def test_mamba2_apply_prefill_and_decode_match_reference():
    """The block in f32: a prefill of 70 tokens (3 chunks of 32, the last
    ragged) into a cache, then three decode steps; outputs and both cache
    leaves (updated in place in the port) as the reference's."""
    ref_cfg, ref_params, cfg, params = _block_pair("float32")
    B, S, d = 2, 70, cfg.d_model
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, S + 3, d)).astype(np.float32)
    cache = ssm.mamba2_cache_init(B, cfg)
    ref_cache = ref_ssm.mamba2_cache_init(B, ref_cfg)
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2), (S + 2, S + 3)):
        y, cache2 = ssm.mamba2_apply(params, torch.from_numpy(x[:, lo:hi]),
                                     cfg, cache)
        assert cache2 is cache
        yr, ref_cache = ref_ssm.mamba2_apply(ref_params,
                                             jnp.asarray(x[:, lo:hi]),
                                             ref_cfg, ref_cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-4,
                                   atol=1e-4)
        for k in ("conv", "state"):
            assert cache[k].dtype == torch.float32
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(ref_cache[k], np.float32),
                                       rtol=1e-4, atol=1e-4)


def test_mamba2_apply_bf16_forward_matches_reference():
    """The block without a cache in bf16 compute (the serving dtype)."""
    ref_cfg, ref_params, cfg, params = _block_pair("bfloat16")
    x = np.random.default_rng(11).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    y, _ = ssm.mamba2_apply(params, torch.from_numpy(x).to(torch.bfloat16),
                            cfg)
    yr, _ = ref_ssm.mamba2_apply(ref_params, jnp.asarray(x, jnp.bfloat16),
                                 ref_cfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               atol=5e-2, rtol=2e-2)
