"""The port on the card: the CUDA quantize kernel against its plain
version, and the training path through it.  Every test here needs an
NVIDIA GPU and skips without one; the file imports only ``repro_torch``
(no JAX), so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``SHAPES`` and ``edge_inputs`` are shared with the CPU parity tests in
``test_torch_quantize.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quantize import (launch_counts, quantize_int8,
                                          quantize_int8_ref,
                                          quantize_pack_int8,
                                          quantize_pack_int8_ref)

# the training path's (128, 64), a ragged block, one row, odd K with an
# unaligned scale
SHAPES = [(128, 64), (130, 64), (1, 128), (257, 10)]


def edge_inputs(shape, seed=0):
    """Normal rows with the kernel's edge cases planted: an all-zero
    row, exact half-way values (absmax 127 -> scale 1, so k + 0.5 sits
    exactly between two integers), and ±absmax ties."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    T, K = shape
    x[0] = 0.0
    if T > 1:
        x[1] = np.float32(0.5) + np.arange(K, dtype=np.float32) % 7 - 3
        x[1, 0] = 127.0                       # scale = 1: halves are exact
    if T > 2:
        x[2, 0], x[2, -1] = 4.0, -4.0         # ±absmax tie
    return x


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(65536, 64)])
def test_kernel_matches_plain_on_card(cuda_device, shape):
    """On the card: the CUDA kernel's bytes equal the plain version's,
    scales bit for bit, and each call is one counted launch."""
    x = torch.from_numpy(edge_inputs(shape)).to(cuda_device)
    n0 = launch_counts["quantize_pack_int8"]
    packed = quantize_pack_int8(x)
    torch.cuda.synchronize()
    assert launch_counts["quantize_pack_int8"] == n0 + 1
    assert torch.equal(packed, quantize_pack_int8_ref(x))
    q, s = quantize_int8(x)
    qr, sr = quantize_int8_ref(x)
    assert torch.equal(q, qr) and torch.equal(s.view(torch.int32),
                                              sr.view(torch.int32))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    for bad in (x.double(), x.t(), x[None]):
        with pytest.raises(ValueError, match="contiguous 2-D float32"):
            quantize_pack_int8(bad)


@pytest.mark.cuda
def test_split_int8_fit_on_card_runs_the_kernel(cuda_device):
    """A session built without ``device`` runs on the card, and its split
    int8 fit launches the kernel for every cut and every cut gradient."""
    from repro_torch.configs import CONFIG
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        400, seed=0, keep_frac=0.9)))
    assert s.device.type == "cuda"
    s.resolve(group="modp512")
    s.build(CONFIG)
    n0 = launch_counts["quantize_pack_int8"]
    h = s.fit(epochs=1, batch_size=64, eval_frac=0.1, verbose=False,
              mode="split", compression="int8", backend="queue")
    steps = s.transport_stats["steps"]
    assert launch_counts["quantize_pack_int8"] - n0 >= 2 * 2 * steps
    assert all(np.isfinite(h["loss_trail"]))
