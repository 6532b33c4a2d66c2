"""The cut-fusion kernel's plan, on the CPU: the route a call takes
(``tc`` for bf16 that TMA can read, ``fma`` for the rest) and, on the
fma route, the output tiles and the cp.async ring.  The kernel itself
runs on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import inspect

import pytest
import torch

from repro_torch.kernels.cut_fusion import plan
from test_torch_cuda import CUT_CASES, CUT_PATH_CASES

F32, BF16 = torch.float32, torch.bfloat16
BENCH = (2, 4096, 512, 1024, "concat")       # the reference benchmark's

# dtype, P, K, D, combine, aligned -> route
ROUTE_TABLE = [
    (F32, 2, 64, 500, "concat", True, "fma"),     # the training path
    (F32, 2, 512, 1024, "concat", True, "fma"),   # f32: no TF32 or bf16
    (BF16, 2, 512, 1024, "concat", True, "tc"),   # the benchmark shape
    (BF16, 2, 64, 500, "concat", True, "fma"),    # d * 2 bytes not 16-aligned
    (BF16, 2, 60, 128, "concat", True, "fma"),    # k not a multiple of 8
    (BF16, 2, 64, 512, "concat", False, "fma"),   # unaligned pointers
    (BF16, 4, 64, 96, "concat", True, "tc"),
    (BF16, 2, 64, 128, "sum", True, "tc"),
    (BF16, 3, 64, 128, "mean", True, "tc"),
    (BF16, 12, 64, 128, "sum", True, "fma"),      # 12 owners' boxes: 1 stage
    (BF16, 2, 0, 128, "concat", True, "fma"),     # nothing to multiply
]


@pytest.mark.parametrize("dtype,P,K,D,combine,aligned,route", ROUTE_TABLE)
def test_route_choice(dtype, P, K, D, combine, aligned, route):
    assert plan.choose_route(dtype, P, K, D, combine, aligned) == route


def test_route_does_not_depend_on_T():
    """A row's bits may not depend on T: the route is decided without it,
    and on the fma route every tile feeds one accumulator per output in
    the same (p, k) order."""
    import inspect
    assert "T" not in inspect.signature(plan.choose_route).parameters


def _covers(T, D, tile):
    """Every output (t, d) lies in exactly one block's tile."""
    BM, BN, TM, TN, _ = plan.TILES[tile]
    assert BM % TM == 0 and BN % TN == 0
    seen = torch.zeros((T, D), dtype=torch.int32)
    nd = -(-D // BN)
    for bx in range(plan.n_blocks(T, D, tile)):
        t0, d0 = (bx // nd) * BM, (bx % nd) * BN
        # thread (tx, ty) owns rows ty + i * (BM / TM) and columns in
        # runs of 4 (TN % 4 == 0) or every (BN / TN)-th (the kernel's col)
        NTX = BN // TN
        for ty in range(BM // TM):
            for tx in range(NTX):
                for i in range(TM):
                    for j in range(TN):
                        t = t0 + ty + i * (BM // TM)
                        d = d0 + ((j // 4) * NTX * 4 + tx * 4 + j % 4
                                  if TN % 4 == 0 else tx + j * NTX)
                        if t < T and d < D:
                            seen[t, d] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("tile", list(plan.TILES))
@pytest.mark.parametrize("T,D", [(128, 500), (32, 500), (242, 500),
                                 (100, 70), (1, 1), (130, 129)])
def test_every_output_is_covered_once(tile, T, D):
    assert _covers(T, D, tile)


@pytest.mark.parametrize("case", CUT_PATH_CASES + CUT_CASES + [BENCH])
def test_fma_plan_fills_the_card_and_fits(case):
    """The plan's tile gives every SM a block where the shape has the
    outputs for it (else the tile with the most blocks), its ring is as
    deep as the (p, k) chunks up to 4 stages, and the stages fit in a
    block's shared memory."""
    P, T, K, D, combine = case
    tile, stages = plan.fma_plan(T, K, D, P, combine, 132)
    blocks = plan.n_blocks(T, D, tile)
    most = max(plan.n_blocks(T, D, t) for t in plan.TILES)
    assert blocks >= 132 or blocks == most
    BK = plan.TILES[tile][4]
    chunks = (P if combine == "concat" else 1) * -(-K // BK)
    assert 1 <= stages <= min(plan.MAX_STAGES, chunks)
    assert stages * plan.fma_stage_bytes(tile, P, combine) <= \
        plan.SMEM_BYTES
    BM, BN, TM, TN, _ = plan.TILES[tile]
    assert (BM // TM) * (BN // TN) in (128, 256)       # threads per block


def test_plan_at_the_training_path():
    """At the batch (T 128, d 500): 16 x 32 tiles, 128 blocks, the whole
    (p, k) depth of 4 chunks in flight; at the benchmark shape 128 x 128
    tiles (256 blocks) of 8 x 8 outputs a thread."""
    assert plan.fma_plan(128, 64, 500, 2, "concat") == ("16x32", 4)
    assert plan.n_blocks(128, 500, "16x32") == 128
    assert plan.fma_plan(4096, 512, 1024, 2, "concat") == ("128x128", 4)
    assert plan.n_blocks(4096, 1024, "128x128") == 256


def test_sum_over_too_many_owners_is_refused():
    with pytest.raises(ValueError, match="does not fit"):
        plan.fma_plan(128, 64, 500, 10000, "sum")


def test_tc_stages_fit():
    for P in (1, 2, 3, 4, 8):
        for combine in ("concat", "sum", "mean"):
            s = plan.tc_stages(P, combine)
            assert s * plan.tc_stage_bytes(P, combine) <= plan.SMEM_BYTES
