"""The SSD scan's routes and the chunk-parallel decomposition of the
``chunked`` route, on the CPU.

``plan.choose_route`` decides between ``chunked`` (three launches:
chunk states, state passing, chunk outputs, on the tensor cores) and
``serial`` (PR 13's kernel) from dtype, widths and alignment; here it is
checked as a table.  The plain stage functions, one per kernel of the
chunked route, are held against the reference: chained, against its
``ssd_chunked`` oracle and its Pallas kernel in interpret mode on the
SSD cases, to 2e-4 in f32; one by one, against the quantities the
reference's recurrence defines.  The kernels run on the card
(``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.ops import mamba2_scan as ref_mamba2_scan
from repro.models import ssm as ref_ssm
from repro_torch.kernels.mamba2_scan import (plan, ssd_chunk_output,
                                             ssd_chunk_parallel,
                                             ssd_chunk_states, ssd_chunked,
                                             ssd_state_passing)
from test_kernels import SSD_CASES as REF_SSD_CASES
from test_torch_cuda import SSD_CASES, scan_inputs

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
TOL = dict(atol=2e-4, rtol=2e-4)

# dtype, N, P, batch x heads, aligned -> route
ROUTE_TABLE = [
    (BF16, 64, 64, 320, True, "chunked"),     # zamba2-2.7b trunk prefill
    (BF16, 64, 64, 320, False, "serial"),     # unaligned views
    (F32, 64, 64, 320, True, "serial"),       # f32: the 2e-4 tolerance
    (BF16, 16, 32, 4, True, "chunked"),
    (BF16, 16, 16, 1, True, "chunked"),
    (BF16, 8, 16, 2, True, "serial"),         # N not a multiple of 16
    (BF16, 16, 24, 2, True, "serial"),        # P not a multiple of 16
    (BF16, 64, 48, 2, True, "chunked"),
    (BF16, 32, 64, 65535, True, "chunked"),
    (BF16, 32, 64, 65536, True, "serial"),    # past the grid's y limit
    (torch.float16, 64, 64, 4, True, "serial"),
]


@pytest.mark.parametrize("dtype,N,P,n_bh,aligned,route", ROUTE_TABLE)
def test_route_choice(dtype, N, P, n_bh, aligned, route):
    assert plan.choose_route(dtype, N, P, n_bh, aligned) == route


def test_route_table_covers_the_card_cases():
    """Every SSD case the card tests run in bf16 has a route, and the
    chunked route takes each whose widths allow it."""
    for B, S, H, P, G, N, chunk in SSD_CASES:
        want = "chunked" if N % 16 == 0 and P % 16 == 0 else "serial"
        assert plan.choose_route(BF16, N, P, B * H) == want


def _tensors(case, seed=0):
    B, S, H, P, G, N, chunk = case
    return [torch.from_numpy(a) for a in scan_inputs(B, S, H, P, G, N,
                                                     seed)]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_chained_stages_match_reference(case, init):
    """Chunk states -> state passing -> chunk outputs, against the
    reference's ``ssd_chunked`` (with and without an initial state)."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = _tensors(case)
    s0 = (np.random.default_rng(1).normal(size=(B, H, N, P))
          .astype(np.float32) if init else None)
    y, st = ssd_chunk_parallel(x, dt, A, Bi, Ci, chunk,
                               initial_state=None if s0 is None
                               else torch.from_numpy(s0))
    yr, sr = ref_ssm.ssd_chunked(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bi, Ci)), chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)


@pytest.mark.parametrize("case", REF_SSD_CASES)
def test_chained_stages_match_pallas_kernel(case):
    """Against the reference's Pallas kernel, in interpret mode."""
    x, dt, A, Bi, Ci = _tensors(case)
    y, st = ssd_chunk_parallel(x, dt, A, Bi, Ci, case[-1])
    yr, sr = ref_mamba2_scan(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bi, Ci)),
        chunk=case[-1], interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunk_states_are_single_chunk_scans(case):
    """Stage (a): chunk c's state is the final state of the reference's
    scan over chunk c alone from a zero state, and its total the sum of
    dt A over the chunk."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = _tensors(case)
    states, totals = ssd_chunk_states(x, dt, A, Bi, chunk)
    L = min(chunk, S)
    nc = -(-S // L)
    assert states.shape == (B, H, nc, N, P) and totals.shape == (B, H, nc)
    for c in range(nc):
        sl = slice(c * L, min(S, (c + 1) * L))
        _, sr = ref_ssm.ssd_chunked(
            *(jnp.asarray(t[:, sl].numpy()) for t in (x, dt)),
            jnp.asarray(A.numpy()),
            *(jnp.asarray(t[:, sl].numpy()) for t in (Bi, Ci)), L)
        np.testing.assert_allclose(states[:, :, c].numpy(), np.asarray(sr),
                                   **TOL)
        np.testing.assert_allclose(
            totals[:, :, c].numpy(),
            (dt[:, sl] * A).sum(1).numpy(), **TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_state_passing_gives_each_chunks_incoming_state(case):
    """Stage (b): chunk c's incoming state is the reference's final
    state after the first c chunks, from the initial state; the last
    one carried on is the final state."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = _tensors(case)
    s0 = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, H, N, P)).astype(np.float32))
    states, totals = ssd_chunk_states(x, dt, A, Bi, chunk)
    incoming, final = ssd_state_passing(states, totals, s0)
    L = min(chunk, S)
    torch.testing.assert_close(incoming[:, :, 0], s0, atol=0, rtol=0)
    for c in range(1, states.shape[2]):
        sl = slice(0, c * L)
        _, sr = ref_ssm.ssd_chunked(
            *(jnp.asarray(t[:, sl].numpy()) for t in (x, dt)),
            jnp.asarray(A.numpy()),
            *(jnp.asarray(t[:, sl].numpy()) for t in (Bi, Ci)), L,
            initial_state=jnp.asarray(s0.numpy()))
        np.testing.assert_allclose(incoming[:, :, c].numpy(),
                                   np.asarray(sr), **TOL)
    _, sr = ref_ssm.ssd_chunked(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bi, Ci)), chunk,
        initial_state=jnp.asarray(s0.numpy()))
    np.testing.assert_allclose(final.numpy(), np.asarray(sr), **TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunk_output_matches_the_serial_scan(case):
    """Stage (c) on the reference's incoming states gives the plain
    serial scan's y, in bf16 too (computed in f32, cast once)."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = _tensors(case)
    for dtype in (F32, BF16):
        xd, bd, cd = (t.to(dtype) for t in (x, Bi, Ci))
        states, totals = ssd_chunk_states(xd, dt, A, bd, chunk)
        incoming, _ = ssd_state_passing(states, totals)
        y = ssd_chunk_output(xd, dt, A, bd, cd, incoming, chunk)
        y0, _ = ssd_chunked(xd, dt, A, bd, cd, chunk)
        assert y.dtype == dtype
        torch.testing.assert_close(
            y.float(), y0.float(),
            **(TOL if dtype == F32 else dict(atol=2e-2, rtol=2e-2)))
