"""The int8 quantizer's row plan, on the CPU: which threads load which
parts of which rows, the loads a thread keeps in registers, and the
block per row at a decode tick against the few warps per row of a
prefill.  The kernel itself runs on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch
from repro.testing.hypo import given, settings, strategies as st
from repro_torch.kernels.quantize import plan
from test_torch_cuda import SHAPES

F32, BF16 = torch.float32, torch.bfloat16
SMS = 132                                     # an H100 SXM's SMs
# the paths' shapes: training (128, 64); llama3.2-3b's prefill owner
# slice and decode tick; zamba2-2.7b's
PATH_SHAPES = [(128, 64), (2048, 3072), (4, 3072), (2048, 2560), (4, 2560)]
# chip_smoke.py's shapes beyond those: ragged, one row, odd K, large
SMOKE_SHAPES = [(130, 64), (1, 128), (257, 10), (65536, 64)]


def _loads(p, nvec):
    """How often each of a row's ``nvec`` loads is taken, over the
    threads of the row: thread t takes base + t + i * tpr for i < vpt,
    for each pass base (one pass unless wide) — the kernel's indexing."""
    step = p.tpr * p.vpt
    passes = -(-nvec // step) if p.wide else 1
    v = (np.arange(passes)[:, None, None] * step
         + np.arange(p.tpr)[None, :, None]
         + np.arange(p.vpt)[None, None, :] * p.tpr).ravel()
    return np.bincount(v[v < nvec], minlength=nvec)


def _rows(p, T):
    """How often each row is taken: block b, thread row y -> b * rpb + y,
    rows past T masked."""
    r = (np.arange(p.blocks(T))[:, None] * p.rpb
         + np.arange(p.rpb)[None, :]).ravel()
    return np.bincount(r[r < T], minlength=T)


def _check_plan(T, K, dtype, sms=SMS, aligned=True):
    p = plan.quantize_plan(T, K, dtype, sms, aligned)
    n = plan.vector_elems(dtype) if p.vector else 1
    if p.vector:                              # every row starts aligned
        assert aligned and K % n == 0
        assert n * dtype.itemsize == plan.VECTOR_BYTES
    nvec = -(-K // n)
    # every element of every row is loaded by exactly one thread, once
    # per pass; each load covers n elements
    assert (_loads(p, nvec) == 1).all()
    assert (_rows(p, T) == 1).all()
    # the block: whole warps, at most 1024 threads; a row's lanes are a
    # power of two inside a warp or whole warps (the kernel's reduction)
    assert p.threads % 32 == 0 and p.threads <= plan.MAX_THREADS
    assert (p.tpr <= 16 and p.tpr & (p.tpr - 1) == 0) or p.tpr % 32 == 0
    # the register budget: at most 8 loads of 16 bytes a thread
    assert p.vpt in plan.VPTS and p.vpt * n * dtype.itemsize <= 128
    # one read of x unless the row is longer than a block's registers
    assert p.wide == (nvec > plan.MAX_THREADS * plan.MAX_VPT)
    if not p.wide:
        assert p.tpr * p.vpt >= nvec
    return p


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", PATH_SHAPES + SMOKE_SHAPES + SHAPES)
def test_plan_covers_every_element_once(shape, dtype):
    _check_plan(*shape, dtype)
    _check_plan(*shape, dtype, aligned=False)     # scalar loads


@settings(max_examples=300, deadline=None)
@given(T=st.integers(1, 5000), K=st.integers(1, 80000),
       bf16=st.booleans(), aligned=st.booleans(),
       sms=st.sampled_from([1, 16, 114, 132]))
def test_plan_covers_every_element_once_any_shape(T, K, bf16, aligned, sms):
    _check_plan(T, K, BF16 if bf16 else F32, sms, aligned)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K", [3072, 2560])
def test_decode_tick_gets_a_block_per_row(K, dtype):
    """4 rows: a whole block each, one 16-byte load per thread — (4,
    3072) f32 is 4 blocks of 768 threads."""
    p = _check_plan(4, K, dtype)
    n = plan.vector_elems(dtype)
    assert p.vector and p.rpb == 1 and p.blocks(4) == 4 and p.vpt == 1
    assert p.tpr * n >= K > (p.tpr - 32) * n
    if (K, dtype) == (3072, F32):
        assert p.tpr == 768


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K", [3072, 2560])
def test_prefill_fills_the_card(K, dtype):
    """2048 rows: a few warps per row, every SM given blocks and at
    least a quarter of its 64 warps, each thread with several 16-byte
    loads in flight: over 32 KB of loads per SM."""
    T = 2048
    p = _check_plan(T, K, dtype)
    warps = T * p.tpr // 32
    assert p.vector and p.tpr % 32 == 0 and 1 <= p.tpr // 32 <= 8
    assert p.blocks(T) >= SMS and warps >= 16 * SMS
    loads = -(-K // (p.tpr * plan.vector_elems(dtype)))   # per thread
    assert loads >= 2
    assert T * p.tpr * loads * 16 / SMS >= 32 * 1024


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_training_path_takes_one_element_a_thread(dtype):
    """(128, 64): few rows of fewer than 32 vectors, so one element per
    load and per thread, two warps a row."""
    p = _check_plan(128, 64, dtype)
    assert (p.tpr, p.vpt, p.vector) == (64, 1, False)


def test_many_short_rows_keep_vectors():
    """(65536, 64): many rows, so 16-byte loads even below 32 a row."""
    p = _check_plan(65536, 64, F32)
    assert p.vector and p.tpr < 32


def test_plan_does_not_change_a_row():
    """What the plan may depend on: T, K, dtype, alignment and the SMs —
    never a value of x; the kernel's arithmetic per row is fixed."""
    import inspect
    assert list(inspect.signature(plan.quantize_plan).parameters) == [
        "T", "K", "dtype", "sms", "aligned"]


@pytest.mark.parametrize("args", [(0, 64, F32, SMS), (4, 0, F32, SMS),
                                  (4, 64, torch.float16, SMS),
                                  (4, 64, F32, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        plan.quantize_plan(*args)
