"""The attention wrapper's routes and the decode route's split-KV plan,
on the CPU.

``plan.py`` holds the pure functions that decide a call's route and cut
the decode route's kv range into splits; ``ref.attention_split_kv_ref``
is the plain version of what the decode route computes (per-split
partials merged in fixed order).  Here the route table and the plan's
invariants are checked directly, and the split-KV plain version is held
against the JAX reference's attention on the cache cases and on
llama3.2-3b's and zamba2-2.7b's decode shapes at reduced heads, at the
reference's kernel tolerances (2e-4 in f32, 2e-2 in bf16).  The CUDA
kernels themselves run only on the card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro_torch.kernels.block_attention import (attention_ref,
                                                 attention_split_kv_ref, plan)
from test_torch_cuda import DECODE_CASES, ROUTE_CASES, attn_inputs, attn_tol

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16

# dtype, Sq, nh, nkv, hd -> route
ROUTE_TABLE = [
    (F32, 1, 24, 8, 128, "decode"),      # llama3.2-3b decode tick
    (BF16, 1, 24, 8, 128, "decode"),
    (BF16, 1, 32, 32, 80, "decode"),     # zamba2-2.7b decode tick
    (F32, 16, 8, 2, 64, "decode"),       # 64 rows per kv head
    (BF16, 64, 4, 4, 16, "decode"),
    (BF16, 1, 64, 1, 256, "decode"),     # any hd
    (BF16, 17, 8, 2, 64, "tc"),          # 68 rows
    (BF16, 65, 4, 4, 16, "tc"),
    (BF16, 1, 65, 1, 64, "tc"),
    (BF16, 512, 24, 8, 128, "tc"),       # llama head prefill
    (BF16, 1024, 24, 8, 128, "tc"),      # llama trunk prefill
    (BF16, 1024, 32, 32, 80, "tc"),      # zamba2 trunk prefill
    (F32, 17, 8, 2, 64, "fma"),          # f32 prefill
    (F32, 1024, 24, 8, 128, "fma"),
    (BF16, 128, 2, 2, 256, "fma"),       # hd above 128
    (BF16, 128, 2, 2, 72, "fma"),        # hd not a multiple of 16
    (BF16, 128, 2, 2, 144, "fma"),
]


@pytest.mark.parametrize("dtype,Sq,nh,nkv,hd,route", ROUTE_TABLE)
def test_route_choice(dtype, Sq, nh, nkv, hd, route):
    assert plan.choose_route(dtype, Sq, nh, nkv, hd) == route


def test_unaligned_bf16_prefill_takes_the_fma_route():
    """TMA needs 16-byte aligned pointers and strides; a bf16 prefill
    whose tensors break that goes to the fma route, decided before any
    launch."""
    assert plan.choose_route(BF16, 512, 24, 8, 128, tma_aligned=False) \
        == "fma"
    assert plan.choose_route(BF16, 1, 24, 8, 128, tma_aligned=False) \
        == "decode"


# Sq, kind, window, q_offset, kv_lim -> (k_begin, k_end)
LIVE_TABLE = [
    (1, "causal", 0, 1040, 1041, (0, 1041)),
    (1, "causal", 0, 2000, 1041, (0, 1041)),
    (16, "causal", 0, 32, 48, (0, 48)),
    (1, "local", 16, 50, 51, (0, 51)),
    (8, "local", 100, 300, 308, (192, 308)),
    (4, "bidir", 0, 0, 500, (0, 500)),
    (1, "causal", 0, 0, 0, (0, 0)),
]


@pytest.mark.parametrize("Sq,kind,window,q_offset,kv_lim,want", LIVE_TABLE)
def test_live_range(Sq, kind, window, q_offset, kv_lim, want):
    assert plan.live_range(Sq, kind, window, q_offset, kv_lim) == want


# k_begin, k_end, n_bh (batch x kv heads), n_sm
PLAN_CASES = [
    (0, 1041, 32, 132),        # llama3.2-3b decode: 4 x 8 kv heads
    (0, 1041, 128, 132),       # zamba2-2.7b decode: 4 x 32
    (0, 1, 32, 132),
    (0, 63, 32, 132),
    (0, 64, 32, 132),
    (0, 65, 32, 132),
    (0, 545, 4, 132),
    (64, 545, 4, 132),
    (192, 308, 1, 132),
    (128, 5000, 1, 132),
    (0, 100000, 2, 132),
    (0, 4096, 600, 132),       # more blocks than SMs without splitting
    (0, 0, 32, 132),
]


@pytest.mark.parametrize("k_begin,k_end,n_bh,n_sm", PLAN_CASES)
def test_split_plan_covers_the_live_range(k_begin, k_end, n_bh, n_sm):
    """The splits cover [k_begin, k_end) exactly and in order, each one
    non-empty and made of whole 64-key tiles (the last one ends at
    k_end), and there are blocks for at least two waves where the range
    has the tiles for it."""
    split_len, n_split = plan.split_plan(k_begin, k_end, n_bh, n_sm)
    parts = plan.splits(k_begin, k_end, split_len, n_split)
    assert split_len % plan.TILE == 0 and len(parts) == n_split
    n_tiles = -(-(k_end - k_begin) // plan.TILE) if k_end > k_begin else 0
    if n_tiles == 0:
        assert parts == []
        return
    assert parts[0][0] == k_begin and parts[-1][1] == k_end
    for (lo, hi), (lo2, _) in zip(parts, parts[1:]):
        assert hi == lo2
    for lo, hi in parts:
        assert hi > lo and lo % plan.TILE == 0
        assert hi - lo == split_len or hi == k_end
    assert n_split <= n_tiles
    assert n_split * n_bh >= min(n_tiles * n_bh, 2 * n_sm)


def test_split_plan_at_the_models_decode():
    """llama3.2-3b's decode tick over 1041 live keys: 9 two-tile splits
    x 32 (batch x kv head) = 288 blocks on 132 SMs; zamba2-2.7b's (128
    batch x kv heads): 3 splits of 384 keys = 384 blocks."""
    assert plan.split_plan(0, 1041, 32, 132) == (128, 9)
    assert plan.split_plan(0, 1041, 128, 132) == (384, 3)


def test_plan_is_a_function_of_its_arguments():
    for case in PLAN_CASES:
        assert plan.split_plan(*case) == plan.split_plan(*case)
    q, k, v = (torch.from_numpy(a).to(BF16)
               for a in attn_inputs(2, 1, 300, 6, 2, 64))
    kw = dict(q_offset=250, kv_len=251, n_sm=1000)
    assert torch.equal(attention_split_kv_ref(q, k, v, **kw),
                       attention_split_kv_ref(q, k, v, **kw))


# llama3.2-3b's and zamba2-2.7b's decode ticks with their head dims and
# group sizes at reduced heads (6/2 and 4/4)
MODEL_DECODE_CASES = [
    (4, 1, 1057, 6, 2, 128, "causal", 0, 0.0, 1040, 1041),
    (4, 1, 1057, 4, 4, 80, "causal", 0, 0.0, 1040, 1041),
]


@pytest.mark.parametrize("n_sm", [132, 4096], ids=["sm132", "one_tile"])
@pytest.mark.parametrize("dtype", [(F32, jnp.float32), (BF16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES + MODEL_DECODE_CASES)
def test_split_kv_ref_matches_reference(case, dtype, n_sm):
    """The decode route's plain version against
    ``repro.models.attention.attention``; n_sm 4096 cuts every range into
    one-tile splits, so the merge runs over many partials."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    arrays = attn_inputs(B, Sq, Skv, nh, nkv, hd)
    q, k, v = (torch.from_numpy(a).to(dtype[0]) for a in arrays)
    jq, jk, jv = (jnp.asarray(a, dtype[1]) for a in arrays)
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    got = attention_split_kv_ref(q, k, v, n_sm=n_sm, **kw)
    assert got.dtype == dtype[0] and got.shape == q.shape
    want = ref_attention.attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **attn_tol(dtype[0]))


@pytest.mark.parametrize("case", [c for c in ROUTE_CASES
                                  if c[1] * c[3] // c[4] <= 64])
def test_split_kv_ref_matches_plain_on_route_cases(case):
    """On the card tests' decode-route cases (hd 256, 16 and 64 rows per
    kv head), split-KV merging agrees with the direct softmax in f32."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    q, k, v = (torch.from_numpy(a)
               for a in attn_inputs(B, Sq, Skv, nh, nkv, hd))
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    torch.testing.assert_close(
        attention_split_kv_ref(q, k, v, n_sm=4096, **kw),
        attention_ref(q, k, v, **kw), **attn_tol(F32))


# ---------------------------------------------------------------------------
# per-row lengths (continuous batching's decode step)
# ---------------------------------------------------------------------------

# B, Sq, Skv, nh, nkv, hd, kind, window, per-row q_offsets
PER_ROW_CASES = [
    (4, 1, 1057, 6, 2, 128, "causal", 0, (1024, 1040, 1056, 1030)),
    (3, 4, 300, 4, 2, 64, "causal", 0, (0, 150, 296)),
    (3, 1, 300, 4, 2, 32, "local", 64, (20, 150, 299)),
    (2, 1, 200, 4, 4, 64, "causal", 0, (199, 60)),
]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PER_ROW_CASES)
def test_per_row_lengths_equal_scalar_calls(case, dtype):
    """Both plain versions with one ``q_offset`` / ``kv_len`` per row
    (``kv_len = q_offset + Sq``): row b's bits are those of a scalar call
    at row b's length, and a vector of equal lengths gives the scalar
    call's bits; the split-KV version stays within the kernel tolerance
    of the reference's attention, row by row."""
    B, Sq, Skv, nh, nkv, hd, kind, window, offs = case
    arrays = attn_inputs(B, Sq, Skv, nh, nkv, hd)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    qo = torch.tensor(offs)
    kw = dict(kind=kind, window=window)
    for fn in (attention_ref, attention_split_kv_ref):
        got = fn(q, k, v, q_offset=qo, kv_len=qo + Sq, **kw)
        for b, o in enumerate(offs):
            alone = fn(q, k, v, q_offset=o, kv_len=o + Sq, **kw)
            assert torch.equal(got[b], alone[b]), (fn.__name__, b)
            same = fn(q, k, v, q_offset=torch.full((B,), o),
                      kv_len=torch.full((B,), o + Sq), **kw)
            assert torch.equal(same, alone), (fn.__name__, b)
            want = ref_attention.attention(
                *(jnp.asarray(a[b:b + 1]) for a in arrays), q_offset=o,
                kv_len=o + Sq, **kw)
            np.testing.assert_allclose(
                got[b:b + 1].float().numpy(), np.asarray(want, np.float32),
                **attn_tol(dtype))


def test_row_plans_are_the_scalar_plans():
    """``plan.row_plans``: each row's (q_offset, kv_lim, live range,
    split plan) is the scalar call's at that row's length, with the
    call's B * nkv, whatever the other rows hold."""
    offs, Sq, skv, n_bh = [1024, 1040, 1056, 0, 2000], 1, 1057, 40
    table = plan.row_plans(Sq, "causal", 0, offs, [o + Sq for o in offs],
                           skv, n_bh)
    assert table.dtype == np.int32 and table.shape == (5, 6)
    for row, o in zip(table, offs):
        kv_lim = min(o + Sq, skv)
        lr = plan.live_range(Sq, "causal", 0, o, kv_lim, skv)
        assert tuple(row) == (o, kv_lim) + lr + plan.split_plan(*lr, n_bh)
    alone = plan.row_plans(Sq, "causal", 0, offs[:1], [offs[0] + 1], skv,
                           n_bh)
    assert (alone[0] == table[0]).all()


def test_per_row_lengths_take_the_decode_route_only():
    """The route of a per-row call is the decode route; a call whose rows
    per kv head exceed it is refused, before any launch."""
    assert plan.choose_route(BF16, 1, 24, 8, 128, per_row=True) == "decode"
    assert plan.choose_route(F32, 16, 8, 2, 64, per_row=True) == "decode"
    for dtype, Sq, nh, nkv, hd in ((BF16, 512, 24, 8, 128),
                                   (F32, 17, 8, 2, 64)):
        with pytest.raises(ValueError, match="decode route"):
            plan.choose_route(dtype, Sq, nh, nkv, hd, per_row=True)
