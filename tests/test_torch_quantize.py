"""The port's int8 cut quantizer against the JAX reference, and the
port's import isolation.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and the
``cuda``-marked tests in ``test_torch_cuda.py`` hold it byte for byte
against the plain version); here the wrappers take their plain PyTorch
versions, because the tensors lie on the CPU, and those are held against
the reference's Pallas kernel (interpret mode) and its jnp oracle, on
the card test's shapes minus the large one.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.federation import transport as ref_transport
from repro.kernels.quantize import (quantize_int8 as ref_quantize_int8,
                                    quantize_int8_ref as ref_q8_oracle,
                                    quantize_pack_int8 as ref_pack,
                                    quantize_pack_int8_ref as ref_pack_oracle)
from repro_torch.federation import cut_codec as pt_codec
from repro_torch.federation import transport as pt_transport
from repro_torch.kernels.quantize import (launch_counts, quantize_int8,
                                          quantize_int8_ref,
                                          quantize_pack_int8,
                                          quantize_pack_int8_ref)
from test_torch_cuda import SHAPES, edge_inputs

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_reference():
    """``import repro_torch`` and every port module load neither jax nor
    any ``repro`` module; no source line of the port imports them."""
    mods = ["repro_torch"] + [
        "repro_torch." + ".".join(p.relative_to(
            ROOT / "src" / "repro_torch").with_suffix("").parts)
        for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
        if p.name != "__init__.py"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\nprint(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                     r"|from\s+repro[.\s](?!_))", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


def _assert_matches_jitted_reference(q, s, rq, rs):
    """Against the reference's Pallas kernel (interpret mode under jit):
    int8 values identical; scales within rtol=1e-6.  XLA's CPU jit
    rewrites the division by the constant 127 as a multiplication by
    its reciprocal, which lands one ulp away on some rows (measured: 0-13
    rows of 257 on these inputs, never a changed int8 value).  The port
    divides exactly, as the eager jnp oracle does — held bit-for-bit
    below."""
    np.testing.assert_array_equal(q, np.asarray(rq))
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_pack_plain_matches_reference(shape):
    """The port's plain version (through the wrapper, on the CPU): the
    whole frame byte-identical to the reference's jnp oracle, and the
    reference's Pallas kernel to the jit tolerance above."""
    x = edge_inputs(shape)
    before = dict(launch_counts)
    ours = quantize_pack_int8(torch.from_numpy(x)).numpy()
    assert launch_counts == before          # CPU: no kernel launch
    assert ours.dtype == np.uint8 and ours.shape == (shape[0], shape[1] + 4)
    np.testing.assert_array_equal(ours, quantize_pack_int8_ref(
        torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(ours, np.asarray(ref_pack_oracle(x)))
    k = shape[1]
    pallas = np.asarray(ref_pack(x, interpret=True))
    _assert_matches_jitted_reference(
        ours[:, :k], ours[:, k:].copy().view("<f4"),
        pallas[:, :k], pallas[:, k:].copy().view("<f4"))


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_int8_plain_matches_reference(shape):
    """The unpacked entry: values equal and f32 scales bit-equal to the
    reference's oracle; the Pallas kernel to the jit tolerance."""
    x = edge_inputs(shape, seed=1)
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.shape == (shape[0], 1)
    rq, rs = ref_q8_oracle(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    _assert_matches_jitted_reference(q.numpy(), s.numpy(),
                                     *ref_quantize_int8(x, interpret=True))
    qr, sr = quantize_int8_ref(torch.from_numpy(x))
    assert torch.equal(q, qr) and torch.equal(s, sr)


def test_quantize_plain_half_way_rounds_to_even():
    """Scale 1 (absmax 127): x = k + 0.5 rounds half to even, as jnp."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]])
    q, s = quantize_int8(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]


def test_quantize_plain_nan_propagates_to_scale():
    """A NaN row gets a NaN scale (jnp.max keeps NaN) and int8 0 where
    the value quantizes to NaN — the CUDA kernel's documented rule."""
    x = torch.tensor([[1.0, float("nan"), -2.0], [1.0, 2.0, 4.0]])
    q, s = quantize_int8(x)
    assert torch.isnan(s[0, 0]) and not torch.isnan(s[1, 0])
    assert q[0].tolist() == [0, 0, 0]


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel path, which takes only CUDA tensors and raises otherwise."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_int8(x)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_int8(x)


@pytest.mark.parametrize("shape", [(64, 64), (3, 10)])
def test_int8_codec_frames_equal_reference(shape):
    """The port's Int8Codec frame has the reference's layout and size on
    the wire (dtype name, shape, byte count) with the same int8 values,
    and decodes to the reference's f32 within the scale tolerance."""
    x = edge_inputs(shape, seed=2)
    ours = pt_transport._pack(
        pt_codec.get_codec("int8").encode(torch.from_numpy(x)))
    ref = ref_transport._pack(ref_transport.get_codec("int8").encode(x))
    assert len(ours) == len(ref)
    a, b = pt_transport._unpack(ours)["qp"], ref_transport._unpack(ref)["qp"]
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    k = shape[1]
    _assert_matches_jitted_reference(a[:, :k], a[:, k:].copy().view("<f4"),
                                     b[:, :k], b[:, k:].copy().view("<f4"))
    dec = pt_codec.get_codec("int8").decode({"qp": a})
    np.testing.assert_allclose(
        dec.numpy(), ref_transport.get_codec("int8").decode({"qp": b}),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES + [(7, 3072)])
def test_quantize_plain_special_rows_match_reference_oracle(shape):
    """NaN, +inf, -inf and subnormal rows: the plain version's frame and
    unpacked values and scales equal the reference's eager oracle byte
    for byte (a NaN row: NaN scale, codes 0; an inf row: inf scale,
    codes 0; a subnormal row: the 1e-12 floor's scale, codes 0)."""
    x = edge_inputs(shape, seed=3, specials=True)
    ours = quantize_pack_int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(ref_pack_oracle(x)))
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_q8_oracle(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    T, k = shape
    scale = ours[:, k:].copy().view("<f4")[:, 0]
    if T > 3:
        assert np.isnan(scale[3]) and not ours[3, :k].any()
    for row in (4, 5):
        if T > row:
            assert scale[row] == np.inf and not ours[row, :k].any()
    if T > 6:
        assert scale[6] == np.float32(np.float32(1e-12) / np.float32(127))
        assert not ours[6, :k].any()


@pytest.mark.parametrize("shape", [(64, 64), (3, 10), (7, 3072)])
def test_int8_codec_bf16_frames_equal_reference(shape):
    """A bf16 cut: the port's frame (the plain version's upcast in place
    of the kernel's) equals the reference codec's frame for the same
    bf16 values, which it casts with ``astype(float32)``: int8 values
    identical, scales to the jit tolerance, decoded values within it."""
    import jax.numpy as jnp
    x = edge_inputs(shape, seed=4, specials=True)
    # one rounding to bf16, whose bits both packages get (each package's
    # own conversion may give the NaN another payload)
    jb = jnp.asarray(x).astype(jnp.bfloat16)
    xb = torch.from_numpy(np.array(jb).view(np.int16)).view(torch.bfloat16)
    ours = pt_transport._pack(pt_codec.get_codec("int8").encode(xb))
    ref = ref_transport._pack(ref_transport.get_codec("int8").encode(jb))
    assert len(ours) == len(ref)
    a, b = pt_transport._unpack(ours)["qp"], ref_transport._unpack(ref)["qp"]
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    k = shape[1]
    _assert_matches_jitted_reference(a[:, :k], a[:, k:].copy().view("<f4"),
                                     b[:, :k], b[:, k:].copy().view("<f4"))
    # and byte for byte to the reference's eager oracle on the f32 upcast
    np.testing.assert_array_equal(
        a, np.asarray(ref_pack_oracle(xb.float().numpy())))


def test_int8_codec_sends_bf16_and_f32_cuts_uncast(monkeypatch):
    """The codec hands an f32 or bf16 cut to the quantizer as it is (on
    the card the kernel upcasts bf16 in registers: no cast launch) and
    casts any other dtype to f32 first."""
    from repro_torch.kernels import quantize
    seen = []
    real = quantize.quantize_pack_int8

    def spy(x):
        seen.append(x.dtype)
        return real(x)
    monkeypatch.setattr(quantize, "quantize_pack_int8", spy)
    codec = pt_codec.get_codec("int8")
    x = torch.from_numpy(edge_inputs((6, 16), seed=5))
    frames = [codec.encode(x.to(dt).reshape(2, 3, 16))["qp"]
              for dt in (torch.bfloat16, torch.float32, torch.float16)]
    assert seen == [torch.bfloat16, torch.float32, torch.float32]
    assert frames[0].shape == (2, 3, 20)
    np.testing.assert_array_equal(
        frames[0].reshape(6, 20).numpy(),
        quantize_pack_int8_ref(x.to(torch.bfloat16).float()).numpy())
