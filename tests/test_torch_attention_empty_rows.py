"""Query rows that see no key, on the CPU.

The reference's ``repro.models.attention.attention`` masks with the
finite -2^30, so a row that sees no key (``kv_len`` 0, or a ``local``
window wholly past ``kv_len``) gets uniform weights over all Skv keys:
the mean of V.  The port's routes walk the whole cache for such calls
(``plan.has_empty_row``).  Here the decision is checked as a table and
by brute force, and both plain versions (the direct softmax and the
decode route's split-KV schedule) are held to the reference on such
calls, to 1e-5 in f32.  The kernels run these cases on the card
(``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro_torch.kernels.block_attention import (attention_ref,
                                                 attention_split_kv_ref, plan)
from test_torch_cuda import EMPTY_ROW_CASES, attn_inputs

torch.set_num_threads(1)

# Sq, kind, window, q_offset, kv_lim -> some row sees no key
EMPTY_TABLE = [
    (1, "causal", 0, 1040, 1041, False),    # a decode tick
    (1024, "causal", 0, 0, 1024, False),    # a prefill
    (1, "causal", 0, 0, 0, True),           # kv_len 0
    (4, "bidir", 0, 0, 0, True),
    (4, "bidir", 0, 0, 1, False),
    (1, "local", 16, 50, 51, False),
    (1, "local", 8, 90, 60, True),          # window wholly past kv_len
    (16, "local", 8, 100, 105, True),       # the last 4 rows see none
    (16, "local", 8, 100, 109, False),      # the last row sees key 108
    (128, "local", 16, 40, 100, True),
    (3, "local", 0, 10, 20, True),          # an empty window
]


@pytest.mark.parametrize("Sq,kind,window,q_offset,kv_lim,want", EMPTY_TABLE)
def test_has_empty_row(Sq, kind, window, q_offset, kv_lim, want):
    assert plan.has_empty_row(Sq, kind, window, q_offset, kv_lim) == want


@pytest.mark.parametrize("kind", ["causal", "local", "bidir"])
def test_has_empty_row_agrees_with_the_mask(kind):
    """Against the rows of the reference's mask, over a grid of calls."""
    from repro_torch.kernels.block_attention.ref import attention_mask
    for Sq in (1, 3, 17):
        for q_offset in (0, 5, 40):
            for kv_lim in (0, 1, 9, 30, 60):
                for window in ((0, 1, 4, 16) if kind == "local" else (0,)):
                    m = attention_mask(q_offset + torch.arange(Sq),
                                       torch.arange(64), kind, window,
                                       kv_lim)
                    want = bool((~m.any(-1)).any())
                    assert plan.has_empty_row(Sq, kind, window, q_offset,
                                              kv_lim) == want


@pytest.mark.parametrize("Sq,kind,window,q_offset,kv_lim",
                         [c[:5] for c in EMPTY_TABLE if c[5]])
def test_live_range_walks_the_whole_cache_for_empty_rows(Sq, kind, window,
                                                         q_offset, kv_lim):
    assert plan.live_range(Sq, kind, window, q_offset, kv_lim, 300) == \
        (0, 300)
    split_len, n_split = plan.split_plan(0, 300, 4)
    parts = plan.splits(0, 300, split_len, n_split)
    assert parts[0][0] == 0 and parts[-1][1] == 300


def _reference(arrays, kw):
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    return np.asarray(ref_attention.attention(jq, jk, jv, **kw), np.float32)


@pytest.mark.parametrize("case", EMPTY_ROW_CASES)
def test_plain_version_matches_reference_on_empty_rows(case):
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    arrays = attn_inputs(B, Sq, Skv, nh, nkv, hd)
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    got = attention_ref(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(got.numpy(), _reference(arrays, kw),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_sm", [132, 4096], ids=["sm132", "one_tile"])
@pytest.mark.parametrize("case", EMPTY_ROW_CASES)
def test_split_kv_ref_matches_reference_on_empty_rows(case, n_sm):
    """The decode route's plain version: a row with no key averages V
    over the whole cache, merged over one or many splits."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    arrays = attn_inputs(B, Sq, Skv, nh, nkv, hd)
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    got = attention_split_kv_ref(*(torch.from_numpy(a) for a in arrays),
                                 n_sm=n_sm, **kw)
    want = _reference(arrays, kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_a_row_with_no_key_gets_the_mean_of_v():
    """The reference's answer, spelled out: kv_len 0 gives every row the
    mean of V over all Skv keys of its kv head."""
    arrays = attn_inputs(2, 3, 70, 4, 2, 32)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = attention_split_kv_ref(q, k, v, q_offset=5, kv_len=0)
    mean = v.mean(1).repeat_interleave(2, dim=1)          # (B, nh, hd)
    torch.testing.assert_close(got, mean[:, None].expand_as(got),
                               atol=1e-6, rtol=1e-6)
