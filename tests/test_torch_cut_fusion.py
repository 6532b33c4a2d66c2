"""The port's fused cut layer against the JAX reference: the plain
version (through the wrapper, on the CPU) against the reference's Pallas
kernel in interpret mode and its jnp oracle, the autograd backward
against ``jax.grad`` of the oracle, and ``MLPSplitNN.trunk_apply`` (the
trunk's only entry, layer 0 on the cut-fusion wrapper) against the
reference model.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and the
``cuda``-marked tests in ``test_torch_cuda.py`` hold it against the
plain version); here the wrapper takes its plain version, because the
tensors lie on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SplitConfig as RefSplit
from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro.core import splitnn as ref_splitnn
from repro.kernels.cut_fusion.ops import cut_fusion as ref_cut_fusion
from repro.kernels.cut_fusion.ref import cut_fusion_ref as ref_oracle
from repro_torch.configs import CONFIG, SplitConfig
from repro_torch.core import splitnn
from repro_torch.kernels.cut_fusion import (cut_fusion, cut_fusion_fn,
                                            cut_fusion_ref, launch_counts)
from repro_torch.weights import from_reference
from test_torch_cuda import CUT_CASES, cut_inputs

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    """The reference's kernel tolerances (tests/test_kernels.py)."""
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CUT_CASES)
def test_plain_matches_reference_kernel(case, dtype):
    """The wrapper's plain version on the CPU against the reference's
    Pallas kernel (interpret mode, the reference test's blocks) and its
    jnp oracle, on the reference's cases (a ragged one included), at
    the reference's tolerances.  Both packages round the same f32
    normals to bf16 (nearest even), so they see equal inputs."""
    P, T, K, D, combine = case
    z, w = cut_inputs(P, T, K, D)
    tdt, jdt = DTYPES[dtype]
    n0 = launch_counts["cut_fusion"]
    got = cut_fusion(torch.from_numpy(z).to(tdt),
                     torch.from_numpy(w).to(tdt), combine)
    assert launch_counts["cut_fusion"] == n0      # no kernel on the CPU
    assert got.dtype == tdt and tuple(got.shape) == (T, D)
    zj, wj = jnp.asarray(z, jdt), jnp.asarray(w, jdt)
    kern = ref_cut_fusion(zj, wj, combine=combine, block_m=64, block_n=64,
                          block_k=32, interpret=True)
    oracle = ref_oracle(zj, wj, combine=combine)
    for want in (kern, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **_tol(dtype))


def test_max_has_no_kernel():
    z = torch.zeros((2, 4, 8))
    for fn in (cut_fusion, cut_fusion_ref):
        with pytest.raises(ValueError, match="no max"):
            fn(z, torch.zeros((2, 8, 3)), combine="max")


@pytest.mark.parametrize("combine,w_rows", [
    ("concat", 3), ("sum", 3), ("mean", 3), ("sum", 1), ("mean", 1)])
def test_backward_matches_jax_grad(combine, w_rows):
    """dz and dW of ``sum(out * r)`` against ``jax.grad`` of the
    reference's oracle, f32 within atol=1e-5.  For sum and mean the
    block rows of W past the first get zero gradient, as the oracle
    reads only ``w[0]``; the trunk passes a (1, k, d) W.  Each gradient
    is the same bits whether autograd asks for it alone (the pipelined
    trunk's halves) or with the other (the joint step)."""
    P, T, K, D = 3, 70, 24, 40
    z, w = cut_inputs(P, T, K, D, seed=1)
    w = w[:w_rows]
    r = np.random.default_rng(2).normal(size=(T, D)).astype(np.float32)

    def loss(zz, ww):
        if w_rows == 1:
            ww = jnp.broadcast_to(ww, (P,) + ww.shape[1:])
        return jnp.sum(ref_oracle(zz, ww, combine=combine) * r)

    rdz, rdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(w))
    zt = torch.from_numpy(z).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = cut_fusion_fn(zt, wt, combine)
    rt = torch.from_numpy(r)
    dz, dw = torch.autograd.grad((out * rt).sum(), (zt, wt))
    np.testing.assert_allclose(dz.numpy(), np.asarray(rdz), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), atol=1e-5,
                               rtol=0)
    (dz_only,) = torch.autograd.grad(
        (cut_fusion_fn(zt, wt.detach(), combine) * rt).sum(), zt)
    (dw_only,) = torch.autograd.grad(
        (cut_fusion_fn(zt.detach(), wt, combine) * rt).sum(), wt)
    assert torch.equal(dz_only, dz) and torch.equal(dw_only, dw)


@pytest.mark.parametrize("combine", ["concat", "sum", "mean", "max"])
def test_trunk_apply_matches_reference(combine):
    """``trunk_apply`` on the reference heads' stacked cut (4 owners)
    against the reference's combine + trunk, and the port's whole
    forward against the reference's, within atol=1e-5 (f32 products in
    another order, as in test_torch_splitnn)."""
    kw = dict(n_owners=4, cut_layer=1, combine=combine, cut_dim=64)
    rcfg = dataclasses.replace(REF_CFG, split=RefSplit(**kw))
    rmodel = ref_splitnn.MLPSplitNN(rcfg)
    ref = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(7)))
    x = np.random.default_rng(7).random((4, 45, 196), dtype=np.float32)
    cut = np.array(rmodel.heads_forward(ref["heads"], x))
    model = splitnn.MLPSplitNN(dataclasses.replace(
        CONFIG, split=SplitConfig(**kw)))
    params = from_reference(ref)
    with torch.no_grad():
        logits = model.trunk_apply(params["trunk"], torch.from_numpy(cut))
        whole = model.forward(params, torch.from_numpy(x))
    want = rmodel._mlp_apply(ref["trunk"], rmodel.combine(jnp.asarray(cut)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(whole.numpy(),
                               np.asarray(rmodel.forward(ref, x)),
                               atol=1e-5, rtol=0)
