"""The port on the card: the CUDA quantize, attention, SSD scan and
cut-fusion kernels against their plain versions, and the training and
serving paths through them (the microbatched and process-backend
schedules, a supervised crash recovery and LM training, llama3.2-3b's
and zamba2-2.7b's, included).
Every test here but ``test_host_mesh_needs_a_visible_card`` (which
hides the card) needs an NVIDIA GPU and skips without one; the file
imports only ``repro_torch`` (no JAX), so it runs on a machine with a
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``SHAPES`` and ``edge_inputs`` are shared with the CPU parity tests in
``test_torch_quantize.py``; ``ATTN_CASES``, ``DECODE_CASES`` and
``attn_inputs`` with ``test_torch_attention.py``; ``ROUTE_CASES`` with
``test_torch_attention_routes.py``; ``SSD_CASES``,
``scan_inputs`` and ``attn_tol`` (the reference's kernel tolerances)
with ``test_torch_ssm.py`` and ``test_torch_scan_routes.py``;
``CUT_CASES`` and ``cut_inputs`` with ``test_torch_cut_fusion.py``;
``EMPTY_ROW_CASES`` with ``test_torch_attention_empty_rows.py``;
``CUT_PATH_CASES`` with ``test_torch_cut_fusion_plan.py``;
``lm_session`` and ``lm_owner_clipped_oracle`` (the per-owner-clipped
joint oracle of split LM training) with ``test_torch_lm_train.py`` and
``test_torch_lm_train_process.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_attention as attn_kernel
from repro_torch.kernels.block_attention import plan as attn_plan
from repro_torch.kernels import mamba2_scan as scan_kernel
from repro_torch.kernels.quantize import (launch_counts, quantize_int8,
                                          quantize_int8_ref,
                                          quantize_pack_int8,
                                          quantize_pack_int8_ref)

# the training path's (128, 64), a ragged block, one row, odd K with an
# unaligned scale
SHAPES = [(128, 64), (130, 64), (1, 128), (257, 10)]
# the serving paths' cuts: llama3.2-3b's prefill owner slice and decode
# tick, zamba2-2.7b's
SERVING_SHAPES = [(2048, 3072), (4, 3072), (2048, 2560), (4, 2560)]


def edge_inputs(shape, seed=0, specials=False):
    """Normal rows with the kernel's edge cases planted: an all-zero
    row, exact half-way values (absmax 127 -> scale 1, so k + 0.5 sits
    exactly between two integers), and ±absmax ties; with ``specials``,
    rows 3-6 hold a NaN, a +inf, a -inf and subnormal values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    T, K = shape
    x[0] = 0.0
    if T > 1:
        x[1] = np.float32(0.5) + np.arange(K, dtype=np.float32) % 7 - 3
        x[1, 0] = 127.0                       # scale = 1: halves are exact
    if T > 2:
        x[2, 0], x[2, -1] = 4.0, -4.0         # ±absmax tie
    if specials:
        for row, col, v in ((3, K // 2, np.nan), (4, 0, np.inf),
                            (5, K - 1, -np.inf)):
            if T > row:
                x[row, col] = v
        if T > 6:                             # below 2^-126: subnormal
            x[6] = (rng.normal(size=K) * 1e-39).astype(np.float32)
    return x


# the reference's kernel cases (tests/test_kernels.py ATTN_CASES):
# B, Sq, Skv, nh, nkv, hd, kind, window, softcap
ATTN_CASES = [
    (2, 128, 128, 4, 4, 64, "causal", 0, 0.0),
    (2, 256, 256, 8, 2, 64, "causal", 0, 0.0),      # GQA group 4
    (1, 192, 192, 4, 2, 128, "local", 64, 0.0),     # SWA
    (1, 128, 128, 2, 2, 64, "bidir", 0, 0.0),       # whisper encoder
    (1, 256, 256, 4, 2, 64, "causal", 0, 50.0),     # gemma2 softcap
    (2, 100, 100, 4, 4, 32, "causal", 0, 0.0),      # ragged (padding path)
]
# queries over a cache: ... + q_offset, kv_len (the serving path's calls)
DECODE_CASES = [
    (2, 1, 96, 6, 2, 64, "causal", 0, 0.0, 40, 41),       # decode, group 3
    (2, 16, 128, 4, 2, 64, "causal", 0, 0.0, 32, 48),     # chunk into a cache
    (1, 1, 80, 4, 4, 32, "local", 16, 0.0, 50, 51),       # local decode
    (1, 8, 130, 4, 1, 128, "causal", 0, 30.0, 100, 108),  # softcap, MQA
]


def attn_inputs(B, Sq, Skv, nh, nkv, hd, seed=0):
    """q, k, v as f32 numpy normals."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, nh, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, nkv, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, nkv, hd)).astype(np.float32))


def attn_tol(dtype):
    """The reference's kernel tolerances (tests/test_kernels.py)."""
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-4, rtol=2e-4)


# the reference's SSD kernel cases (tests/test_kernels.py SSD_CASES), then
# chunks of more than one 64-row tile with a ragged last chunk, grouped
# B/C with a ragged sequence, and one chunk shorter than a tile:
# B, S, H, P, G, N, chunk
SSD_CASES = [
    (2, 128, 4, 32, 1, 16, 32),
    (1, 96, 4, 32, 2, 16, 32),       # grouped B/C + ragged seq
    (2, 256, 8, 64, 1, 64, 64),      # zamba2-like dims
    (1, 64, 2, 16, 1, 8, 64),        # single chunk
    (1, 300, 2, 64, 1, 64, 256),     # 4 tiles per chunk, ragged
    (2, 200, 6, 32, 3, 16, 96),      # ragged tiles, 3 groups
    (1, 40, 2, 16, 1, 8, 128),       # L = S < one tile
]
# hd-80 attention with nh == nkv == 32 (zamba2-2.7b's shared block), in
# the serving path's shapes: trunk prefill into a 1024 + 33 cache, a head
# prefill, a decode step
ZAMBA_ATTN_CASES = [
    (4, 1024, 1057, 32, 32, 80, "causal", 0, 0.0, 0, 1024),
    (2, 512, 545, 32, 32, 80, "causal", 0, 0.0, 0, 512),
    (4, 1, 1057, 32, 32, 80, "causal", 0, 0.0, 1040, 1041),
]


# the attention routes' edges (B, Sq, Skv, nh, nkv, hd, kind, window,
# softcap, q_offset, kv_len): the head prefill over its 545-key cache
# (tc in bf16), ragged Sq and Skv at hd 16, 48, 80 and 96, local with a
# softcap, hd 256 (fma in both dtypes), and decode calls of 4, 16 and 64
# rows per kv head, one at hd 256
ROUTE_CASES = [
    (4, 512, 545, 24, 8, 128, "causal", 0, 0.0, 0, 512),
    (2, 70, 130, 2, 1, 16, "bidir", 0, 0.0, 0, 129),
    (1, 130, 200, 4, 4, 48, "causal", 0, 0.0, 70, 200),
    (1, 200, 333, 4, 2, 80, "causal", 0, 0.0, 100, 300),
    (1, 129, 129, 2, 2, 96, "causal", 0, 0.0, 0, None),
    (1, 300, 300, 2, 2, 64, "local", 100, 20.0, 0, None),
    (1, 128, 128, 2, 2, 256, "causal", 0, 0.0, 0, None),
    (2, 1, 300, 8, 2, 256, "causal", 0, 0.0, 299, 300),
    (1, 4, 500, 12, 3, 128, "causal", 0, 0.0, 400, 404),
    (1, 16, 200, 8, 2, 64, "causal", 0, 0.0, 150, 166),
]


# calls in which some query row sees no key (the reference gives such a
# row the mean of V over all Skv keys): kv_len 0, a local window wholly
# past kv_len, and windows that leave only the last rows empty; decode
# for at most 64 rows per kv head, else tc in bf16 and fma in f32
EMPTY_ROW_CASES = [
    (2, 1, 96, 6, 2, 64, "causal", 0, 0.0, 40, 0),
    (1, 1, 80, 4, 4, 32, "local", 8, 0.0, 90, 60),
    (1, 16, 130, 4, 2, 64, "local", 8, 0.0, 100, 105),
    (1, 128, 200, 4, 2, 64, "local", 16, 0.0, 40, 100),
    (2, 100, 150, 4, 4, 64, "causal", 0, 10.0, 0, 0),
    (1, 80, 96, 2, 2, 32, "bidir", 0, 0.0, 0, 0),
]


# the reference's cut-fusion cases (tests/test_kernels.py CUT_CASES):
# P, T, k, d, combine
CUT_CASES = [
    (2, 128, 64, 128, "concat"),
    (4, 256, 64, 96, "concat"),
    (2, 100, 60, 70, "concat"),       # ragged
    (2, 128, 64, 128, "sum"),
    (3, 128, 64, 128, "mean"),
]
# the training path's calls (2 owners, k 64, trunk width 500): the
# batch of 128, a chunk of 32 (microbatches=4), an evaluation batch of
# 242 rows (ragged), sum / mean with one block row of W, and the masked
# trunk's dequantized ring sum as one owner plane
CUT_PATH_CASES = [
    (2, 128, 64, 500, "concat"),
    (2, 32, 64, 500, "concat"),
    (2, 242, 64, 500, "concat"),
    (2, 128, 64, 500, "sum"),
    (2, 128, 64, 500, "mean"),
    (1, 128, 64, 500, "sum"),
]


def cut_inputs(P, T, K, D, seed=0):
    """z (P, T, k) and w (P, k, d) as f32 numpy normals."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, T, K)).astype(np.float32),
            rng.normal(size=(P, K, D)).astype(np.float32))


def scan_inputs(B, S, H, P, G, N, seed=0):
    """x, dt, A, B, C as f32 numpy arrays, in the reference kernel test's
    distributions: normal x, B, C; dt uniform in [0.001, 0.1]; A
    uniform in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32))


def conv_out_views(x, Bi, Ci, dtype, device):
    """x (B, S, H, P), B and C (B, S, G, N) as strided views of one
    (B, S, H*P + 2*G*N) buffer, the Mamba2 block's conv output."""
    Bb, S, H, P = x.shape
    G, N = Bi.shape[2], Bi.shape[3]
    buf = torch.cat([torch.from_numpy(a).reshape(Bb, S, -1)
                     for a in (x, Bi, Ci)], -1).to(device, dtype)
    hp, gn = H * P, G * N
    return (buf[..., :hp].reshape(Bb, S, H, P),
            buf[..., hp:hp + gn].reshape(Bb, S, G, N),
            buf[..., hp + gn:].reshape(Bb, S, G, N))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + [(65536, 64)] + SERVING_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    """On the card: the CUDA kernel's bytes equal the plain version's on
    x.float(), scales bit for bit (NaN, ±inf and subnormal rows too),
    and each call is one counted launch."""
    x = torch.from_numpy(edge_inputs(shape, specials=True)).to(
        cuda_device, dtype)
    n0 = launch_counts["quantize_pack_int8"]
    packed = quantize_pack_int8(x)
    torch.cuda.synchronize()
    assert launch_counts["quantize_pack_int8"] == n0 + 1
    assert torch.equal(packed, quantize_pack_int8_ref(x.float()))
    q, s = quantize_int8(x)
    qr, sr = quantize_int8_ref(x.float())
    assert torch.equal(q, qr) and torch.equal(s.view(torch.int32),
                                              sr.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 64), (257, 10), (65536, 64)]
                         + SERVING_SHAPES[::2])
def test_quantize_rows_do_not_depend_on_T_on_card(cuda_device, shape,
                                                  dtype):
    """Rows [0, 32) of a call equal a call on those rows alone, byte for
    byte, whatever plan each call runs."""
    x = torch.from_numpy(edge_inputs(shape, specials=True)).to(
        cuda_device, dtype)
    part = x[:32].clone()
    full, alone = quantize_pack_int8(x), quantize_pack_int8(part)
    q, s = quantize_int8(x)
    qa, sa = quantize_int8(part)
    torch.cuda.synchronize()
    assert torch.equal(full[:32], alone)
    assert torch.equal(q[:32], qa) and torch.equal(
        s[:32].view(torch.int32), sa.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 3072, 40000, 70000, 10, 3071])
def test_quantize_unaligned_and_wide_rows_on_card(cuda_device, K):
    """Scalar loads (a base pointer off 16 bytes, or K not a multiple of
    the vector) and wide rows (read twice) give the plain version's
    bytes, f32 and bf16."""
    from repro_torch.kernels.quantize import ops
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.from_numpy(edge_inputs((9, K + 1), specials=True)).to(
            cuda_device, dtype).reshape(-1)
        for x in (buf[:9 * K].view(9, K), buf[1:9 * K + 1].view(9, K)):
            p = ops.plan_of(x)
            assert not p.vector or (x.data_ptr() % 16 == 0
                                    and K % (16 // x.element_size()) == 0)
            assert torch.equal(quantize_pack_int8(x),
                               quantize_pack_int8_ref(x.float()))
            q, s = quantize_int8(x)
            qr, sr = quantize_int8_ref(x.float())
            assert torch.equal(q, qr) and torch.equal(
                s.view(torch.int32), sr.view(torch.int32))


@pytest.mark.cuda
def test_int8_codec_sends_a_bf16_cut_to_the_kernel_uncast(cuda_device,
                                                          monkeypatch):
    """A bf16 cut on the card reaches the kernel as bf16 (no cast
    launch), one counted launch per message; f32 goes as it is too."""
    from repro_torch.federation.cut_codec import get_codec
    from repro_torch.kernels import quantize
    seen = []
    real = quantize.quantize_pack_int8

    def spy(x):
        seen.append(x.dtype)
        return real(x)
    monkeypatch.setattr(quantize, "quantize_pack_int8", spy)
    codec = get_codec("int8", cuda_device)
    x = torch.from_numpy(edge_inputs((8, 3072))).to(cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        n0 = launch_counts["quantize_pack_int8"]
        a = x.to(dtype).reshape(2, 4, 3072)
        frame = codec.encode(a)["qp"]
        torch.cuda.synchronize()
        assert launch_counts["quantize_pack_int8"] == n0 + 1
        assert torch.equal(frame.reshape(8, -1),
                           quantize_pack_int8_ref(a.float().reshape(8, -1)))
    assert seen == [torch.bfloat16, torch.float32]


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    for bad in (x.double(), x.half(), x.t(), x[None]):
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c + (0, None) for c in ATTN_CASES]
                         + DECODE_CASES + ZAMBA_ATTN_CASES + ROUTE_CASES)
def test_attention_kernel_matches_plain_on_card(cuda_device, case, dtype):
    """On the card: each call takes the route ``plan.choose_route`` names
    (decode for at most 64 query rows per kv head, tc for other bf16
    calls with hd a multiple of 16 up to 128, fma for the rest), counts
    one launch there and one in the total, and agrees with the plain
    version at the reference's tolerances."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attn_inputs(B, Sq, Skv, nh, nkv, hd))
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    route = attn_plan.choose_route(dtype, Sq, nh, nkv, hd)
    if dtype == torch.bfloat16 and hd == 256 and Sq * nh // nkv > 64:
        assert route == "fma"
    n0 = dict(attn_kernel.launch_counts)
    got = attn_kernel.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    n = {r: attn_kernel.launch_counts[f"block_attention.{r}"]
         - n0[f"block_attention.{r}"] for r in attn_plan.ROUTES}
    assert n == {r: int(r == route) for r in attn_plan.ROUTES}
    assert attn_kernel.launch_counts["block_attention"] == \
        n0["block_attention"] + 1
    want = attn_kernel.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **attn_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", EMPTY_ROW_CASES)
def test_attention_routes_on_rows_with_no_key_on_card(cuda_device, case,
                                                      dtype):
    """On the card: a row that sees no key gets the plain version's (and
    the reference's) mean of V on each of decode, tc and fma, and the
    rows that see keys are unchanged."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attn_inputs(B, Sq, Skv, nh, nkv, hd))
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    assert attn_plan.has_empty_row(Sq, kind, window, q_offset,
                                   min(kv_len, Skv))
    want = attn_kernel.attention_ref(q, k, v, **kw)
    for route in attn_plan.ROUTES:
        if route == "decode" and Sq * nh // nkv > attn_plan.DECODE_MAX_ROWS:
            continue
        if route == "tc" and dtype != torch.bfloat16:
            continue
        got = attn_kernel.ops._launch(route, q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **attn_tol(dtype))


@pytest.mark.cuda
def test_attention_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    q = torch.zeros((1, 4, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn_kernel.block_attention(q.half(), q.half(), q.half())
    big = torch.zeros((1, 4, 2, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head dims up to 256"):
        attn_kernel.block_attention(big, big, big)
    with pytest.raises(ValueError, match="one CUDA device"):
        attn_kernel.block_attention(q, q.cpu(), q)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_version(cuda_device,
                                                    monkeypatch):
    """On the card the wrapper launches the kernels; the plain version is
    never called on the serving path.  Every bf16 prefill (the owners'
    80 tokens, the trunk's 160, each over more than 64 query rows per kv
    head) takes the tc route, every decode tick the decode route."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import SplitModel

    def refuse(*a, **kw):
        raise AssertionError("attention_ref called on the card")
    monkeypatch.setattr(attn_kernel.ref, "attention_ref", refuse)
    cfg = get_config("llama3.2-3b", reduced=True).replace(n_layers=4)
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, params, batch_slots=2, ctx_len=160,
                        max_new=4, transport="queue", compression="int8")
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab, 160))
    n0 = dict(attn_kernel.launch_counts)
    out = eng.run()
    assert all(len(r.generated) == 4 for r in out.values())
    n = {k: c - n0[k] for k, c in attn_kernel.launch_counts.items()}
    # 3 + 1 attention layers per forward, 1 prefill + 3 decode ticks per
    # wave, two waves
    assert n["block_attention"] == (2 * 3 + 1) * 4 * 2
    assert n["block_attention.tc"] == (2 * 3 + 1) * 2
    assert n["block_attention.decode"] == (2 * 3 + 1) * 3 * 2
    assert n["block_attention.fma"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 545, 1041])
def test_decode_route_at_cache_edges_on_card(cuda_device, kv_len, dtype):
    """llama3.2-3b's decode tick (24/8 heads, hd 128) over a 1057-key
    cache at fill levels around the 64-key tiles and the splits."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attn_inputs(4, 1, 1057, 24, 8, 128))
    kw = dict(q_offset=kv_len - 1, kv_len=kv_len)
    n0 = attn_kernel.launch_counts["block_attention.decode"]
    got = attn_kernel.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attn_kernel.launch_counts["block_attention.decode"] == n0 + 1
    want = attn_kernel.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **attn_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("route,case,dtype", [
    ("decode", (4, 1, 1057, 24, 8, 128, "causal", 0, 0.0, 1040, 1041),
     torch.bfloat16),
    ("decode", (2, 16, 600, 8, 2, 64, "causal", 0, 0.0, 500, 516),
     torch.float32),
    ("tc", (2, 512, 545, 24, 8, 128, "causal", 0, 0.0, 0, 512),
     torch.bfloat16),
    ("fma", (1, 256, 256, 8, 2, 64, "causal", 0, 0.0, 0, None),
     torch.float32)])
def test_attention_routes_are_deterministic_on_card(cuda_device, route, case,
                                                    dtype):
    """Two calls on the same inputs give the same bits on every route
    (fixed split order in decode, no split-K or atomics anywhere)."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attn_inputs(B, Sq, Skv, nh, nkv, hd))
    assert attn_kernel.route_of(q, k, v) == route
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    a = attn_kernel.block_attention(q, k, v, **kw)
    b = attn_kernel.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES + [
    (4, 512, 80, 64, 1, 64, 256),    # zamba2-2.7b head prefill
    (4, 1024, 80, 64, 1, 64, 256)])  # zamba2-2.7b trunk prefill
@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
def test_scan_kernel_matches_plain_on_card(cuda_device, case, dtype, init):
    """On the card: the CUDA SSD scan against its plain version at the
    reference's tolerances, from strided views of one conv output, with
    and without an initial state; one counted launch per call."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = scan_inputs(B, S, H, P, G, N)
    xv, bv, cv = conv_out_views(x, Bi, Ci, dtype, cuda_device)
    assert not xv.is_contiguous()
    dt, A = (torch.from_numpy(a).to(cuda_device) for a in (dt, A))
    s0 = None
    if init:
        s0 = torch.from_numpy(np.random.default_rng(1).normal(
            size=(B, H, N, P)).astype(np.float32)).to(cuda_device)
    n0 = scan_kernel.launch_counts["mamba2_scan"]
    y, st = scan_kernel.mamba2_scan(xv, dt, A, bv, cv, chunk=chunk,
                                    initial_state=s0)
    torch.cuda.synchronize()
    assert scan_kernel.launch_counts["mamba2_scan"] == n0 + 1
    yr, sr = scan_kernel.ssd_chunked(xv, dt, A, bv, cv, chunk,
                                     initial_state=s0)
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), **attn_tol(dtype))
    torch.testing.assert_close(st, sr, **attn_tol(dtype))


def _scan_case(case, dtype, device, init, seed=0):
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = scan_inputs(B, S, H, P, G, N, seed)
    xv, bv, cv = conv_out_views(x, Bi, Ci, dtype, device)
    dt, A = (torch.from_numpy(a).to(device) for a in (dt, A))
    s0 = None
    if init:
        s0 = torch.from_numpy(np.random.default_rng(1).normal(
            size=(B, H, N, P)).astype(np.float32)).to(device)
    return xv, dt, A, bv, cv, s0


# the bf16 cases the chunked route takes: the SSD cases with N and P
# multiples of 16, a ragged last chunk of one row, a chunk not a
# multiple of the 64-row tile, and the zamba2 prefills
CHUNKED_CASES = [c for c in SSD_CASES if c[3] % 16 == 0 and c[5] % 16 == 0
                 ] + [(2, 257, 4, 64, 1, 64, 256), (1, 500, 3, 48, 3, 32, 100),
                      (4, 512, 80, 64, 1, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHUNKED_CASES)
@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
def test_chunked_scan_matches_serial_and_plain_on_card(cuda_device, case,
                                                       init):
    """bf16: the chunked route against the plain version and against the
    serial route on the same inputs, ragged last chunks and an initial
    state included; the route counters sum to the call counter."""
    xv, dt, A, bv, cv, s0 = _scan_case(case, torch.bfloat16, cuda_device,
                                       init)
    chunk = case[-1]
    assert scan_kernel.route_of(xv, bv, cv, s0) == "chunked"
    n0 = dict(scan_kernel.launch_counts)
    y, st = scan_kernel.mamba2_scan(xv, dt, A, bv, cv, chunk=chunk,
                                    initial_state=s0)
    ys, ss = scan_kernel.ops._launch("serial", xv, dt, A, bv, cv,
                                     chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    n = {k: c - n0[k] for k, c in scan_kernel.launch_counts.items()}
    assert n == {"mamba2_scan": 2, "mamba2_scan.chunked": 1,
                 "mamba2_scan.serial": 1}
    yr, sr = scan_kernel.ssd_chunked(xv, dt, A, bv, cv, chunk,
                                     initial_state=s0)
    tol = attn_tol(torch.bfloat16)
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(st, sr, **tol)
    torch.testing.assert_close(y.float(), ys.float(), **tol)
    torch.testing.assert_close(st, ss, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_scan_stages_match_their_plain_stages_on_card(cuda_device,
                                                              case):
    """Each kernel of the chunked route against its plain stage function
    on the same inputs: (a) chunk states and totals, (b) incoming states
    and the final state, (c) the chunk outputs."""
    from repro_torch.kernels.mamba2_scan import ref
    xv, dt, A, bv, cv, s0 = _scan_case(case, torch.bfloat16, cuda_device,
                                       True)
    chunk = case[-1]
    tol = attn_tol(torch.bfloat16)
    states, totals = scan_kernel.ops.chunked_stage(
        "states", xv, dt, A, bv, cv, chunk=chunk)
    pst, ptot = ref.ssd_chunk_states(xv, dt, A, bv, chunk)
    torch.testing.assert_close(states, pst, **tol)
    torch.testing.assert_close(totals, ptot, atol=1e-5, rtol=1e-5)
    # (b) and (c) from the plain stages' inputs, so each stage is held
    # alone; (b) writes each incoming state as bf16 hi and lo planes,
    # exactly the split of the f32 state it carries
    split, final = scan_kernel.ops.chunked_stage(
        "passing", xv, dt, A, bv, cv, chunk=chunk, states=pst,
        totals=ptot, initial_state=s0)
    pin, pfin = ref.ssd_state_passing(pst, ptot, s0)
    hi, lo = split.float().unbind(-3)
    torch.testing.assert_close(hi + lo, pin, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(final, pfin, atol=1e-5, rtol=1e-5)
    y = scan_kernel.ops.chunked_stage(
        "output", xv, dt, A, bv, cv, chunk=chunk, totals=ptot,
        incoming=scan_kernel.ops.split_hi_lo(pin))
    torch.testing.assert_close(
        y.float(), ref.ssd_chunk_output(xv, dt, A, bv, cv, pin,
                                        chunk).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["chunked", "serial"])
def test_scan_routes_are_deterministic_on_card(cuda_device, route):
    """Two calls on the same inputs give the same bits (no atomics, a
    fixed order for every sum)."""
    xv, dt, A, bv, cv, s0 = _scan_case((4, 1024, 80, 64, 1, 64, 256),
                                       torch.bfloat16, cuda_device, True)
    a = scan_kernel.ops._launch(route, xv, dt, A, bv, cv, chunk=256,
                                initial_state=s0)
    b = scan_kernel.ops._launch(route, xv, dt, A, bv, cv, chunk=256,
                                initial_state=s0)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_scan_kernel_is_chunk_independent_on_card(cuda_device):
    x, dt, A, Bi, Ci = (torch.from_numpy(a).to(cuda_device) for a in
                        scan_inputs(1, 300, 2, 64, 1, 64, seed=3))
    outs = [scan_kernel.mamba2_scan(x, dt, A, Bi, Ci, chunk=c)
            for c in (32, 64, 100, 256)]
    for y, st in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, outs[0][1], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, dt, A, Bi, Ci = (torch.from_numpy(a).to(cuda_device) for a in
                        scan_inputs(1, 64, 2, 16, 1, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scan_kernel.mamba2_scan(x.half(), dt, A, Bi.half(), Ci.half(),
                                chunk=32)
    with pytest.raises(ValueError, match="float32 dt and A"):
        scan_kernel.mamba2_scan(x, dt.double(), A, Bi, Ci, chunk=32)
    wide = torch.zeros((1, 64, 2, 96), device=cuda_device)
    with pytest.raises(ValueError, match="up to 64"):
        scan_kernel.mamba2_scan(wide, dt, A, Bi, Ci, chunk=32)
    with pytest.raises(ValueError, match="one CUDA device"):
        scan_kernel.mamba2_scan(x, dt.cpu(), A, Bi, Ci, chunk=32)
    strided = torch.zeros((1, 64, 2, 32), device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="last dim"):
        scan_kernel.mamba2_scan(strided, dt, A, Bi, Ci, chunk=32)
    with pytest.raises(ValueError, match="initial_state"):
        scan_kernel.mamba2_scan(x, dt, A, Bi, Ci, chunk=32,
                                initial_state=torch.zeros(
                                    (1, 2, 16, 8), device=cuda_device))
    with pytest.raises(ValueError, match="H % G|mismatched"):
        scan_kernel.mamba2_scan(x, dt, A, Bi.expand(1, 64, 3, 8),
                                Ci.expand(1, 64, 3, 8), chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ZAMBA_ATTN_CASES)
def test_hd80_attention_matches_plain_on_card(cuda_device, case, dtype):
    """zamba2's shared attention (hd 80, 32 heads, MHA) runs the hd-128
    instantiation with the columns past 80 zeroed."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attn_inputs(B, Sq, Skv, nh, nkv, hd))
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_offset,
              kv_len=kv_len)
    got = attn_kernel.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = attn_kernel.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **attn_tol(dtype))


@pytest.mark.cuda
def test_zamba2_serving_never_reaches_the_plain_scan(cuda_device,
                                                     monkeypatch):
    """zamba2 on the card: every Mamba2 prefill launches the scan kernel
    (one per mamba2 block per forward of a wave's prefill; decode is the
    plain single-step recurrence), and neither plain version is called."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import SplitModel

    def refuse(*a, **kw):
        raise AssertionError("a plain kernel version called on the card")
    monkeypatch.setattr(scan_kernel.ops.ref, "ssd_chunked", refuse)
    monkeypatch.setattr(attn_kernel.ref, "attention_ref", refuse)
    cfg = get_config("zamba2-2.7b", reduced=True).replace(n_layers=18)
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, params, batch_slots=2, ctx_len=128,
                        max_new=4, transport="queue", compression="int8")
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab, 128))
    n0 = dict(scan_kernel.launch_counts)
    n_scan = scan_kernel.launch_counts["mamba2_scan"]
    n_attn = attn_kernel.launch_counts["block_attention"]
    out = eng.run()
    assert all(len(r.generated) == 4 for r in out.values())
    # 2 owners x 2 head units + 1 trunk unit, 5 mamba2 blocks and one
    # shared attention block each; two waves of a prefill + 3 decode ticks
    assert scan_kernel.launch_counts["mamba2_scan"] - n_scan == 2 * 5 * 5
    assert sum(scan_kernel.launch_counts[f"mamba2_scan.{r}"]
               - n0[f"mamba2_scan.{r}"] for r in scan_kernel.ops.plan.ROUTES) \
        == 2 * 5 * 5
    assert attn_kernel.launch_counts["block_attention"] - n_attn == \
        2 * 5 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CUT_CASES + CUT_PATH_CASES)
def test_cut_fusion_kernel_matches_plain_on_card(cuda_device, case, dtype):
    """On the card: the CUDA cut-fusion kernel against its plain version
    at the reference's tolerances, one counted launch per call; sum and
    mean read one block row of W, whether W has one or P."""
    from repro_torch.kernels import cut_fusion as cf
    P, T, K, D, combine = case
    z, w = (torch.from_numpy(a).to(cuda_device, dtype)
            for a in cut_inputs(P, T, K, D))
    rows = [w] if combine == "concat" else [w, w[:1].contiguous()]
    for ww in rows:
        n0 = cf.launch_counts["cut_fusion"]
        got = cf.cut_fusion(z, ww, combine)
        torch.cuda.synchronize()
        assert cf.launch_counts["cut_fusion"] == n0 + 1
        assert got.dtype == dtype and tuple(got.shape) == (T, D)
        want = cf.cut_fusion_ref(z, ww, combine=combine)
        torch.testing.assert_close(got.float(), want.float(),
                                   **attn_tol(dtype))
    # deterministic: the same bits on every call
    assert torch.equal(cf.cut_fusion(z, w, combine),
                       cf.cut_fusion(z, w, combine))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cut_fusion_rows_do_not_depend_on_T_on_card(cuda_device, dtype):
    """A row's bits do not depend on T or the tile plan: the first 32 rows
    of a call equal a call on those 32 rows, bit for bit (f32: fma route,
    bf16 at an aligned width: tc route), at the training path's width and
    the benchmark's."""
    from repro_torch.kernels import cut_fusion as cf
    for P, T, K, D in ((2, 242, 64, 512), (2, 4096, 512, 1024)):
        z, w = (torch.from_numpy(a).to(cuda_device, dtype)
                for a in cut_inputs(P, T, K, D))
        for combine in ("concat", "sum", "mean"):
            full = cf.cut_fusion(z, w, combine)
            head = cf.cut_fusion(z[:, :32].contiguous(), w, combine)
            torch.cuda.synchronize()
            assert cf.route_of(z, w, combine) == (
                "tc" if dtype == torch.bfloat16 else "fma")
            assert torch.equal(head, full[:32])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 32, 242, 1])
def test_masked_trunk_cut_fusion_matches_plain_on_card(cuda_device, T):
    """The masked-sum trunk's call: the dequantized ring sum as one owner
    plane, (1, T, 64) x (1, 64, 500) sum, on the fma route, against the
    plain version at the f32 tolerance, one counted launch per call."""
    from repro_torch.kernels import cut_fusion as cf
    z, w = (torch.from_numpy(a).to(cuda_device)
            for a in cut_inputs(1, T, 64, 500))
    assert cf.route_of(z, w, "sum") == "fma"
    n0 = cf.launch_counts["cut_fusion.fma"]
    got = cf.cut_fusion(z, w, "sum")
    torch.cuda.synchronize()
    assert cf.launch_counts["cut_fusion.fma"] == n0 + 1
    torch.testing.assert_close(got, cf.cut_fusion_ref(z, w, combine="sum"),
                               **attn_tol(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2])
def test_masked_split_equals_masked_oracle_on_card(cuda_device, M):
    """On the card, masked split execution (queue backend) reproduces
    the masked joint oracle bit for bit, every trunk forward through the
    cut-fusion kernel; the int8 codec runs on the gradient leg only."""
    import dataclasses
    from repro_torch.configs import CONFIG
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    from repro_torch.kernels import cut_fusion as cf
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(CONFIG, split=dataclasses.replace(
        CONFIG.split, combine="sum"))
    runs = []
    for mode in ("joint", "split"):
        s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
            400, seed=0, keep_frac=0.9)))
        s.resolve(group="modp512")
        s.build(cfg)
        n0 = cf.launch_counts["cut_fusion.fma"]
        h = s.fit(steps=4, batch_size=64, verbose=False, mode=mode,
                  microbatches=M, aggregation="masked_sum")
        torch.cuda.synchronize()
        extra = 1 if mode == "split" else 0        # the warmup step
        assert cf.launch_counts["cut_fusion.fma"] - n0 == \
            2 * M * (4 + extra)
        runs.append((s, h))
    (j, hj), (sp, hs) = runs
    assert hs["loss_trail"] == hj["loss_trail"]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(sp.params), tree_leaves(j.params)))
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        400, seed=0, keep_frac=0.9)))
    s.resolve(group="modp512")
    s.build(cfg)
    n0 = launch_counts["quantize_pack_int8"]
    h = s.fit(steps=4, batch_size=64, verbose=False, mode="split",
              microbatches=M, aggregation="masked_sum", compression="int8")
    # two owners x M gradient chunks per step, the warmup's included
    assert launch_counts["quantize_pack_int8"] - n0 == 2 * M * 5
    assert all(np.isfinite(h["loss_trail"]))


# bf16 on the tc route with ragged T, k and d (multiples of 8 that are
# not of the 128 x 64 boxes), one and several owners
TC_CASES = [(2, 100, 72, 136, "concat"), (3, 129, 8, 8, "concat"),
            (1, 300, 520, 264, "concat"), (2, 257, 40, 200, "sum"),
            (4, 70, 64, 128, "mean")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_cut_fusion_tc_route_on_ragged_shapes_on_card(cuda_device, case):
    """The tensor-core route against the plain version and against the
    fma route on the same bf16 inputs, and repeatable bit for bit."""
    from repro_torch.kernels import cut_fusion as cf
    P, T, K, D, combine = case
    z, w = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in cut_inputs(P, T, K, D))
    assert cf.route_of(z, w, combine) == "tc"
    n0 = dict(cf.launch_counts)
    got = cf.cut_fusion(z, w, combine)
    fma = cf.ops._launch("fma", z, w, combine)
    torch.cuda.synchronize()
    n = {k: c - n0[k] for k, c in cf.launch_counts.items()}
    assert n == {"cut_fusion": 2, "cut_fusion.tc": 1, "cut_fusion.fma": 1}
    want = cf.cut_fusion_ref(z, w, combine=combine)
    tol = attn_tol(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(got.float(), fma.float(), **tol)
    assert torch.equal(got, cf.cut_fusion(z, w, combine))


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype", [("fma", torch.float32),
                                         ("fma", torch.bfloat16),
                                         ("tc", torch.bfloat16)])
def test_cut_fusion_routes_are_deterministic_on_card(cuda_device, route,
                                                     dtype):
    """The benchmark shape, twice: the same bits (fixed (p, k) order, no
    split-K or atomics)."""
    from repro_torch.kernels import cut_fusion as cf
    z, w = (torch.from_numpy(a).to(cuda_device, dtype)
            for a in cut_inputs(2, 4096, 512, 1024))
    a = cf.ops._launch(route, z, w)
    b = cf.ops._launch(route, z, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cut_fusion_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    from repro_torch.kernels.cut_fusion import cut_fusion
    z = torch.zeros((2, 8, 16), device=cuda_device)
    w = torch.zeros((2, 16, 4), device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cut_fusion(z.half(), w.half())
    with pytest.raises(ValueError, match="one CUDA device"):
        cut_fusion(z, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        cut_fusion(z.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="block rows"):
        cut_fusion(z, w[:1].contiguous(), "concat")
    with pytest.raises(ValueError, match="no max"):
        cut_fusion(z, w, "max")


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["concat", "sum", "mean"])
def test_cut_fusion_autograd_on_card(cuda_device, combine):
    """The autograd Function on the card: one kernel launch per forward,
    the output and both gradients within the f32 tolerance of the same
    computation on the CPU (plain version and plain products)."""
    from repro_torch.kernels import cut_fusion as cf
    z, w = cut_inputs(2, 128, 64, 500, seed=3)
    w = w if combine == "concat" else w[:1]
    r = torch.from_numpy(np.random.default_rng(4).normal(
        size=(128, 500)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        zt = torch.from_numpy(z).to(dev).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        n0 = cf.launch_counts["cut_fusion"]
        out = cf.cut_fusion_fn(zt, wt, combine)
        grads[str(dev)] = [t.cpu() for t in (out, *torch.autograd.grad(
            (out * r.to(dev)).sum(), (zt, wt)))]
        assert cf.launch_counts["cut_fusion"] == n0 + (dev != "cpu")
    for a, b in zip(grads["cpu"], grads[str(cuda_device)]):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-4)


def _mnist_session(device, n=400):
    from repro_torch.configs import CONFIG
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device=device)
    s.resolve(group="modp512")
    s.build(CONFIG)
    return s


def _same_params(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                  tree_leaves(b.params)))


@pytest.mark.cuda
def test_microbatched_split_equals_oracle_on_card(cuda_device):
    """On the card, through the cut-fusion kernel: split pipelined
    execution in 4 chunks == the microbatched joint oracle bit for bit,
    with the exact kernel launches each schedule implies (two trunk
    forwards per chunk — cut gradient and weight gradient — plus the
    split run's warmup chunks, plus one per evaluation batch)."""
    from repro_torch.kernels import cut_fusion as cf
    kw = dict(epochs=1, batch_size=64, eval_frac=0.1, verbose=False,
              microbatches=4)
    runs = {}
    for mode in ("joint", "split"):
        s = _mnist_session(cuda_device)
        n0 = cf.launch_counts["cut_fusion"]
        h = s.fit(**kw, mode=mode)
        runs[mode] = (s, h, cf.launch_counts["cut_fusion"] - n0)
    (j, hj, nj), (sp, hs, ns) = runs["joint"], runs["split"]
    steps = len(hj["loss_trail"])
    evals = -(-len(j._eval_idx) // 512)
    assert nj == 2 * 4 * steps + evals
    assert ns == 2 * 4 * (steps + 1) + evals
    assert _same_params(j, sp) and hs["loss_trail"] == hj["loss_trail"]


@pytest.mark.cuda
@pytest.mark.parametrize("compression", [None, "int8"])
def test_process_equals_queue_on_card(cuda_device, compression):
    """On the card: owners in spawned worker processes (each its own
    CUDA context) == the thread-backed queue run bit for bit, with the
    same wire bytes on every kind the queue run has."""
    kw = dict(epochs=1, batch_size=64, eval_frac=0.1, verbose=False,
              mode="split", microbatches=2, compression=compression)
    q = _mnist_session(cuda_device)
    hq = q.fit(**kw, backend="queue")
    p = _mnist_session(cuda_device)
    hp = p.fit(**kw, backend="process")
    assert _same_params(q, p) and hp["loss_trail"] == hq["loss_trail"]
    wq = q.transport_stats["wire_by_kind"]
    wp = p.transport_stats["wire_by_kind"]
    assert {k: wp[k] for k in wq} == wq


@pytest.mark.cuda
def test_queue_int8_crash_recovers_bitwise_on_card(cuda_device, monkeypatch):
    """On the card at the paper's width (2000 subjects, heads 392 -> 64,
    one epoch of 128-row steps): owner0 crashes on ``head_fwd`` at step 3
    of a supervised split int8 fit on the queue; the respawned owner and
    the replay give the fault-free supervised run's params and loss
    trail bit for bit, with exact launches from the run's record: cut
    fusion two per step run (replays included) and two for the warmup,
    plus one per evaluation batch; the int8 kernel one per cut, cut
    gradient and warmup frame, the dead owner's and the respawn's
    warmup included."""
    from repro_torch.federation import faults
    from repro_torch.kernels import cut_fusion as cf
    from repro_torch.kernels import quantize as qz
    kw = dict(epochs=1, batch_size=128, eval_frac=0.15, verbose=False,
              mode="split", compression="int8", backend="queue",
              supervise=True)
    monkeypatch.delenv(faults.CHAOS_ENV, raising=False)
    clean = _mnist_session(cuda_device, n=2000)
    hc = clean.fit(**kw)
    monkeypatch.setenv(faults.CHAOS_ENV, faults.FaultPlan([faults.Fault(
        "owner0", "crash", "head_fwd", occurrence=None, step=3)]).to_env())
    s = _mnist_session(cuda_device, n=2000)
    n_cf = cf.launch_counts["cut_fusion.fma"]
    n_q = qz.launch_counts["quantize_pack_int8"]
    h = s.fit(**kw)
    torch.cuda.synchronize()
    monkeypatch.delenv(faults.CHAOS_ENV)
    assert [(e["party"], e["action"], e["step"])
            for e in s.recovery_events] == [("owner0", "respawn", 2)]
    assert _same_params(clean, s) and h["loss_trail"] == hc["loss_trail"]
    wk = s.transport_stats["wire_by_kind"]
    steps_run = wk["cut_gradients"]["count"] // 2
    assert steps_run == s.transport_stats["steps"] + 1     # step 2 again
    evals = -(-len(s._eval_idx) // 512)
    assert cf.launch_counts["cut_fusion.fma"] - n_cf == \
        2 * (steps_run + 1) + evals
    assert qz.launch_counts["quantize_pack_int8"] - n_q == sum(
        wk[k]["count"] for k in ("cut_activations", "warmup_cuts",
                                 "cut_gradients", "warmup_grads"))


# per-row lengths on the decode route (continuous batching): llama3.2-3b's
# trunk decode tick with lengths spread over 1025-1057, a zamba2-like MHA
# hd-80 tick, an f32 tick with four query rows per batch row, and a local
# window (B, Sq, Skv, nh, nkv, hd, kind, window, q_offsets, dtype)
PER_ROW_CASES = [
    (4, 1, 1057, 24, 8, 128, "causal", 0, (1024, 1040, 1056, 1030),
     torch.bfloat16),
    (4, 1, 1057, 32, 32, 80, "causal", 0, (1056, 1024, 1035, 1047),
     torch.bfloat16),
    (3, 4, 600, 8, 2, 64, "causal", 0, (100, 590, 333), torch.float32),
    (3, 1, 300, 4, 2, 64, "local", 64, (20, 150, 299), torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PER_ROW_CASES)
def test_per_row_decode_matches_plain_and_scalar_calls_on_card(cuda_device,
                                                               case):
    """Per-row ``q_offset`` / ``kv_len`` (``kv_len = q_offset + Sq``): the
    decode kernel is within tolerance of the plain version, every row's
    bits equal a scalar call in which every row has that row's length,
    and a vector of equal lengths gives the scalar call's bits."""
    B, Sq, Skv, nh, nkv, hd, kind, window, offs, dtype = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in attn_inputs(B, Sq, Skv, nh, nkv, hd))
    qo = torch.tensor(offs)
    kw = dict(kind=kind, window=window)
    n0 = attn_kernel.launch_counts["block_attention.decode"]
    got = attn_kernel.block_attention(q, k, v, q_offset=qo,
                                      kv_len=qo + Sq, **kw)
    want = attn_kernel.attention_ref(q, k, v, q_offset=qo, kv_len=qo + Sq,
                                     **kw)
    torch.cuda.synchronize()
    assert attn_kernel.launch_counts["block_attention.decode"] == n0 + 1
    torch.testing.assert_close(got.float(), want.float(), **attn_tol(dtype))
    for b, o in enumerate(offs):
        alone = attn_kernel.block_attention(q, k, v, q_offset=o,
                                            kv_len=o + Sq, **kw)
        same = attn_kernel.block_attention(
            q, k, v, q_offset=torch.full((B,), o),
            kv_len=torch.full((B,), o + Sq), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[b], alone[b]), b
        assert torch.equal(same, alone), b


@pytest.mark.cuda
def test_per_row_lengths_refuse_other_routes_on_card(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in attn_inputs(2, 128, 200, 8, 2, 64))
    with pytest.raises(ValueError, match="decode route"):
        attn_kernel.block_attention(q, k, v, q_offset=torch.tensor([0, 5]),
                                    kv_len=torch.tensor([128, 133]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers,ctx", [("llama3.2-3b", 4, 160),
                                               ("zamba2-2.7b", 18, 128)])
def test_continuous_equals_wave_on_card(cuda_device, arch, n_layers, ctx):
    """bf16 on the card, int8 over the queue: continuous batching (per-row
    decode positions, refills) gives the wave engine's tokens bit for
    bit, with every decode tick on the decode route."""
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import SplitModel
    cfg = get_config(arch, reduced=True).replace(n_layers=n_layers)
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    ctxs = [rng.integers(0, cfg.vocab, ctx) for _ in range(5)]
    mixed = [2, 6, 1, 5, 3]

    def run(scheduler):
        eng = ServingEngine(model, params, batch_slots=2, ctx_len=ctx,
                            max_new=6, transport="queue",
                            compression="int8", scheduler=scheduler)
        rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
        n0 = dict(attn_kernel.launch_counts)
        out = eng.run()
        n = {r: attn_kernel.launch_counts[r] - n0[r]
             for r in attn_kernel.launch_counts}
        return [out[r].generated for r in rids], n, eng.stats

    wave, nw, _ = run("wave")
    cont, nc, st = run("continuous")
    assert cont == wave
    assert nc["block_attention.fma"] == 0
    assert nc["block_attention"] == (nc["block_attention.decode"]
                                     + nc["block_attention.tc"])
    assert st["ticks"] < sum(mixed)


# ---------------------------------------------------------------------------
# LM training (the dense family): attention under autograd, split == the
# per-owner-clipped joint oracle, card vs CPU
# ---------------------------------------------------------------------------

#: attention's training shapes at llama3.2-3b's heads (24 q, 8 kv, hd
#: 128): the trunk over the combined sequence, a head over its slice
LM_TRAIN_ATTN = [(2, 256, 24, 8, 128), (2, 128, 24, 8, 128)]


def lm_session(cfg, toks, device, params=None):
    """A labelled sequence-split session on ``device``, resolved and
    built (from ``params`` when given)."""
    from repro_torch.federation import VerticalSession, sequence_parties
    s = VerticalSession(*sequence_parties(toks, cfg.split.n_owners),
                        device=device)
    s.resolve(group="modp512")
    return s.build(cfg, params=params)


def lm_owner_clipped_oracle(session, steps, batch_size):
    """The per-owner-clipped joint oracle of a split LM fit on
    ``session`` (built, never fitted): per step one autograd pass
    through the adapter's ``loss_fn`` at the joint params — the joint
    fit's gradients — then the heads' rule applied to each owner's
    ``owner_param_slice`` apart, stacked back with
    ``stack_head_params``, and the trunk's rule.  The batches are the
    fit's (the session's index stream at its seed).  Leaves the result
    in ``session.params``; returns the loss trail."""
    from repro_torch.core.splitnn import _leaf, grads_of
    from repro_torch.tree import tree_map
    ad = session.adapter
    P = len(session.owners)
    n = len(session.scientist.ids)
    session._train_idx = np.arange(n)
    stream = session._index_stream(np.random.default_rng(session.seed), n,
                                   batch_size, None, steps)
    oopt, oupd = ad.owner_update_rule()
    topt, tupd = ad.trunk_update_rule()
    slices = [ad.owner_param_slice(session.params, p) for p in range(P)]
    ostates = [oopt.init(x) for x in slices]
    tp = session.params["trunk"]
    ts = topt.init(tp)
    losses = []
    for t in range(steps):
        batch = ad.make_batch(session._owner_arrays(),
                              session.scientist.labels, next(stream),
                              device=session.device)
        with torch.enable_grad():
            leaves = tree_map(_leaf, {
                "heads": ad.stack_head_params(slices), "trunk": tp})
            obj, metrics = ad.loss_fn(leaves, batch)
            grads = grads_of(obj, leaves)
        for p in range(P):
            slices[p], ostates[p] = oupd(slices[p], ostates[p],
                                         ad.owner_param_slice(grads, p), t)
        tp, ts = tupd(tp, ts, grads["trunk"], t)
        losses.append(metrics["loss"].item())
    session.params = {"heads": ad.stack_head_params(slices), "trunk": tp}
    return losses


def _lm_train_cfg(compute):
    from repro_torch.configs import get_config
    return get_config("llama3.2-3b", reduced=True).replace(
        n_layers=3, compute_dtype=compute).with_split(cut_layer=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LM_TRAIN_ATTN)
def test_attention_function_on_card(cuda_device, shape, dtype):
    """The attention Function at the training shapes: the kernel forward
    (tc in bf16, fma in f32) and the plain-product backward against
    autograd through the plain version, within the kernel tolerances."""
    B, S, nh, nkv, hd = shape
    base = [torch.from_numpy(a).to(cuda_device)
            for a in attn_inputs(B, S, S, nh, nkv, hd)]
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, S, nh, hd)).astype(np.float32)).to(cuda_device, dtype)
    tol = attn_tol(dtype)

    def run(fn):
        q, k, v = (t.to(dtype).requires_grad_() for t in base)
        out = fn(q, k, v)
        out.backward(dout)
        return out.detach(), q.grad, k.grad, v.grad

    n0 = attn_kernel.launch_counts[
        f"block_attention.{'tc' if dtype == torch.bfloat16 else 'fma'}"]
    got = run(lambda q, k, v: attn_kernel.attention_fn(q, k, v))
    assert attn_kernel.launch_counts[
        f"block_attention.{'tc' if dtype == torch.bfloat16 else 'fma'}"] \
        == n0 + 1
    want = run(lambda q, k, v: attn_kernel.attention_ref(q, k, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_lm_split_equals_owner_clipped_oracle_on_card(cuda_device):
    """bf16 on the card: split lossless training over the queue equals
    the per-owner-clipped joint oracle bit for bit (params and loss
    trail), with the attention forward on the tc kernel."""
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _lm_train_cfg("bfloat16")
    # 256 tokens: the heads' 128 query rows and the trunk's 256 take the
    # tc route (64 rows or fewer per kv head take the decode route)
    toks = make_token_dataset(16, 256, cfg.vocab, 0)
    first = lm_session(cfg, toks, cuda_device)
    p0 = tree_map(lambda t: t.cpu(), first.params)
    trail = lm_owner_clipped_oracle(first, 3, 4)
    want = [t.cpu() for t in tree_leaves(first.params)]
    del first
    s = lm_session(cfg, toks, cuda_device, p0)
    n0 = attn_kernel.launch_counts["block_attention.tc"]
    h = s.fit(steps=3, batch_size=4, verbose=False, mode="split")
    assert attn_kernel.launch_counts["block_attention.tc"] > n0
    assert h["loss_trail"] == trail
    for a, b in zip(tree_leaves(s.params), want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_lm_joint_fit_card_vs_cpu(cuda_device):
    """f32: the joint fit's loss trail on the card within rel 1e-4 of
    the CPU's, from the same params."""
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_map
    cfg = _lm_train_cfg("float32")
    toks = make_token_dataset(16, 64, cfg.vocab, 0)
    cpu = lm_session(cfg, toks, "cpu")
    p0 = tree_map(torch.clone, cpu.params)
    want = cpu.fit(steps=3, batch_size=4, verbose=False)["loss_trail"]
    card = lm_session(cfg, toks, cuda_device, p0)
    got = card.fit(steps=3, batch_size=4, verbose=False)["loss_trail"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


# the scan Function at zamba2-2.7b's training shapes (80 heads of 64, 64
# states, chunks of 256), at batch 2: the trunk's 256 tokens, a head's 128
SCAN_TRAIN = [(2, 256, 80, 64, 1, 64, 256), (2, 128, 80, 64, 1, 64, 256)]


def _zamba2_train_cfg(compute):
    from repro_torch.configs import get_config
    return get_config("zamba2-2.7b", reduced=True).replace(
        n_layers=12, compute_dtype=compute).with_split(cut_layer=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SCAN_TRAIN)
def test_scan_function_on_card(cuda_device, case, dtype):
    """The scan Function at the training shapes, x, B and C strided views
    of one buffer: the kernel forward (chunked in bf16, serial in f32)
    against the plain ``ssd_chunked``, and the plain-product backward
    against autograd through the plain stages on f32 copies of the same
    values (the cotangent rounded as y's dtype rounds it), within the
    kernel tolerances."""
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bi, Ci = scan_inputs(B, S, H, P, G, N)
    xv, bv, cv = conv_out_views(x, Bi, Ci, dtype, cuda_device)
    ins = (xv,) + tuple(torch.from_numpy(a).to(cuda_device)
                        for a in (dt, A)) + (bv, cv)
    dy = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, S, H, P)).astype(np.float32)).to(cuda_device, dtype)

    def run(fn, args, cot):
        leaves = [t.detach().requires_grad_() for t in args]
        y, _ = fn(*leaves)
        y.backward(cot)
        return (y.detach(),) + tuple(t.grad for t in leaves)

    route = "chunked" if dtype == torch.bfloat16 else "serial"
    assert scan_kernel.route_of(xv, bv, cv) == route
    n0 = scan_kernel.launch_counts[f"mamba2_scan.{route}"]
    got = run(lambda *t: scan_kernel.ssd_fn(*t, chunk=chunk), ins, dy)
    assert scan_kernel.launch_counts[f"mamba2_scan.{route}"] == n0 + 1
    want = run(lambda *t: scan_kernel.ssd_chunk_parallel(*t, chunk),
               [t.float() for t in ins], dy.float())
    plain_y = scan_kernel.ssd_chunked(*ins, chunk)[0]
    tol = attn_tol(dtype)
    for g, w in zip(got, (plain_y,) + want[1:]):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_zamba2_split_equals_owner_clipped_oracle_on_card(cuda_device):
    """bf16 on the card: zamba2's split lossless training over the queue
    equals the per-owner-clipped joint oracle bit for bit (params and
    loss trail), every Mamba2 forward on the chunked scan kernel."""
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _zamba2_train_cfg("bfloat16")
    toks = make_token_dataset(16, 64, cfg.vocab, 0)
    first = lm_session(cfg, toks, cuda_device)
    p0 = tree_map(lambda t: t.cpu(), first.params)
    trail = lm_owner_clipped_oracle(first, 3, 4)
    want = [t.cpu() for t in tree_leaves(first.params)]
    del first
    s = lm_session(cfg, toks, cuda_device, p0)
    n0 = dict(scan_kernel.launch_counts)
    h = s.fit(steps=3, batch_size=4, verbose=False, mode="split")
    assert scan_kernel.launch_counts["mamba2_scan.chunked"] > \
        n0["mamba2_scan.chunked"]
    assert scan_kernel.launch_counts["mamba2_scan.serial"] == \
        n0["mamba2_scan.serial"]
    assert h["loss_trail"] == trail
    for a, b in zip(tree_leaves(s.params), want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_zamba2_joint_fit_card_vs_cpu(cuda_device):
    """f32: zamba2's joint fit on the card (every scan on the serial
    route) within rel 1e-4 of the CPU's loss trail, from the same
    params."""
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_map
    cfg = _zamba2_train_cfg("float32")
    toks = make_token_dataset(16, 72, cfg.vocab, 0)
    cpu = lm_session(cfg, toks, "cpu")
    p0 = tree_map(torch.clone, cpu.params)
    want = cpu.fit(steps=3, batch_size=4, verbose=False)["loss_trail"]
    card = lm_session(cfg, toks, cuda_device, p0)
    n0 = dict(scan_kernel.launch_counts)
    got = card.fit(steps=3, batch_size=4, verbose=False)["loss_trail"]
    assert scan_kernel.launch_counts["mamba2_scan.serial"] > \
        n0["mamba2_scan.serial"]
    assert scan_kernel.launch_counts["mamba2_scan.chunked"] == \
        n0["mamba2_scan.chunked"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_launchers_run_under_the_lock_on_card(cuda_device, dtype,
                                                  monkeypatch):
    """A call into a scan launcher (serial in f32, chunked, its three
    stages in one call, in bf16) holds ``ops._launch_lock``: a launcher
    sets its kernels' shared memory limit from the chunk and then
    launches, and another thread's launch must not come between."""
    ops = scan_kernel.ops
    real, held = ops._library, []

    class Recorded:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            fn = getattr(self.lib, name)

            def call(*args):
                held.append((name, ops._launch_lock.locked()))
                return fn(*args)
            return call

    monkeypatch.setattr(ops, "_library", lambda route: Recorded(real(route)))
    x, dt, A, Bi, Ci = scan_inputs(2, 256, 16, 64, 1, 64)
    xv, bv, cv = conv_out_views(x, Bi, Ci, dtype, cuda_device)
    y, _ = scan_kernel.mamba2_scan(
        xv, torch.from_numpy(dt).to(cuda_device),
        torch.from_numpy(A).to(cuda_device), bv, cv, chunk=128)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    name = ("mamba2_scan_launch" if dtype == torch.float32
            else "mamba2_scan_chunked_launch")
    assert [n for n, _ in held] == [name]
    assert all(locked for _, locked in held), held


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_launches_from_two_threads_on_card(cuda_device, dtype):
    """Two threads launching the scan at once at two chunk lengths (a
    split fit's heads at 128 and trunk at 256: each launch sets its
    kernels' shared memory limit from the chunk) all succeed, each
    thread's outputs equal to the same call alone."""
    import threading
    calls = {}
    for S in (128, 256):
        x, dt, A, Bi, Ci = scan_inputs(2, S, 16, 64, 1, 64)
        xv, bv, cv = conv_out_views(x, Bi, Ci, dtype, cuda_device)
        calls[S] = (xv, torch.from_numpy(dt).to(cuda_device),
                    torch.from_numpy(A).to(cuda_device), bv, cv)
    want = {S: scan_kernel.mamba2_scan(*a, chunk=256)[0]
            for S, a in calls.items()}
    errors, got = [], {}

    def run(S):
        try:
            for _ in range(200):
                got[S] = scan_kernel.mamba2_scan(*calls[S], chunk=256)[0]
            torch.cuda.synchronize()
        except Exception as e:          # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(S,)) for S in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for S in calls:
        assert torch.equal(got[S], want[S])


# ---------------------------------------------------------------------------
# KV cache variants: fp8 writes and ring decode rows on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_fp8_cache_write_on_card_equals_cpu(cuda_device, src):
    """A float8_e4m3fn cache written on the card holds the CPU write's
    bytes (the reference's, ``test_torch_kv_cache.py``): every bf16 bit
    pattern and f32 values at the overflow edge, NaN past 464 and 448 at
    460 and 464."""
    from repro_torch.models import attention
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    every_bf16 = bits.view(torch.bfloat16).float()
    edge = torch.tensor([448, 460, 463.99997, 464, 464.00003, 466, 470, 1e4,
                         float("inf"), float("nan")])
    x = torch.cat([every_bf16, edge, -edge])
    x = torch.nn.functional.pad(x, (0, -x.numel() % 16)).reshape(
        1, -1, 2, 8).to(src)
    # negated once, on the CPU: both writes get the same bits (NaN signs
    # included), so the two devices' casts are all that is compared
    neg = -x
    S = x.shape[1]
    out = {}
    for dev in ("cpu", cuda_device):
        cache = attention.init_kv_cache(1, S, 2, 8, torch.float8_e4m3fn,
                                        dev)
        attention.update_kv_cache(cache, x.to(dev), neg.to(dev), 0)
        out[str(dev)] = {n: c.cpu().view(torch.uint8) for n, c in
                         cache.items()}
    cpu, card = out["cpu"], out[str(cuda_device)]
    for n in ("k", "v"):
        assert torch.equal(card[n], cpu[n]), n
    got = card["k"].view(torch.float8_e4m3fn).float().ravel()
    xf = x.float().ravel()
    assert torch.isnan(got[xf.abs() > 464]).all()
    assert (got[(xf == 460) | (xf == 464)] == 448).all()


@pytest.mark.cuda
def test_ring_decode_rows_equal_the_scalar_call_on_card(cuda_device):
    """Reduced gemma2 (bf16, window 64) on ring caches past the window:
    a decode step with one position per row (continuous batching, every
    row at the same position) gives the scalar call's logits and caches
    bit for bit, every attention call on the decode route."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import RowPositions
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("gemma2-9b", reduced=True).replace(n_layers=4)
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    B, S, P = 3, 160, 2
    rng = np.random.default_rng(0)
    ot = torch.from_numpy(rng.integers(0, cfg.vocab, (P, B, S // P)).astype(
        np.int32)).cuda()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)).cuda()
    with torch.inference_mode():
        caches = model.cache_init(B, S, n_new=8, device="cuda", ring=True)
        _, caches = model.prefill(params, {"owner_tokens": ot}, caches)
        row_caches = tree_map(torch.clone, caches)
        n0 = dict(attn_kernel.launch_counts)
        want, caches = model.decode_step(params, caches, tok, S + 3,
                                         S // P + 3)
        got, row_caches = model.decode_step(
            params, row_caches, tok, RowPositions([S + 3] * B, "cuda"),
            RowPositions([S // P + 3] * B, "cuda"))
        torch.cuda.synchronize()
    n = {k: attn_kernel.launch_counts[k] - n0[k] for k in n0}
    assert n["block_attention.decode"] == n["block_attention"] > 0
    assert n["block_attention.per_row"] == n["block_attention"] // 2
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(row_caches), tree_leaves(caches)):
        assert torch.equal(a, b)


# cross-attention (the whisper decoder's): queries over another
# sequence's keys under the bidir mask, Sq != Skv (150 keys: no tile
# multiple), on each route — decode for at most 64 rows per kv head, tc
# in bf16 and fma in f32 past that
XATTN_CASES = [
    (2, 1, 150, 6, 6, 64, "bidir", 0, 0.0, 0, None),
    (2, 64, 150, 6, 6, 64, "bidir", 0, 0.0, 0, None),
    (1, 200, 150, 4, 4, 64, "bidir", 0, 0.0, 0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", XATTN_CASES)
def test_cross_attention_on_every_route_on_card(cuda_device, case, dtype):
    """Bidir with Sq != Skv: the wrapper's route (decode, or tc / fma)
    and every other route that takes the call agree with the plain
    version at the kernels' tolerances; the attention Function's
    gradients (its forward on the wrapper's route) agree with autograd
    through the plain version."""
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_offset, kv_len = case
    base = [torch.from_numpy(a).to(cuda_device)
            for a in attn_inputs(B, Sq, Skv, nh, nkv, hd)]
    q, k, v = (t.to(dtype) for t in base)
    tol = attn_tol(dtype)
    want = attn_kernel.attention_ref(q, k, v, kind=kind)
    route = attn_plan.choose_route(dtype, Sq, nh, nkv, hd)
    assert route == ("decode" if Sq * nh // nkv <= 64 else
                     "tc" if dtype == torch.bfloat16 else "fma")
    routes = [r for r in attn_plan.ROUTES
              if (r != "decode" or Sq * nh // nkv <= 64)
              and (r != "tc" or dtype == torch.bfloat16)]
    for r in routes:
        n0 = attn_kernel.launch_counts[f"block_attention.{r}"]
        got = attn_kernel.ops._launch(r, q, k, v, kind=kind)
        torch.cuda.synchronize()
        assert attn_kernel.launch_counts[f"block_attention.{r}"] == n0 + 1
        torch.testing.assert_close(got.float(), want.float(), **tol)
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, Sq, nh, hd)).astype(np.float32)).to(cuda_device, dtype)

    def run(fn):
        q, k, v = (t.to(dtype).requires_grad_() for t in base)
        out = fn(q, k, v)
        out.backward(dout)
        return out.detach(), q.grad, k.grad, v.grad

    n0 = attn_kernel.launch_counts[f"block_attention.{route}"]
    got = run(lambda q, k, v: attn_kernel.attention_fn(q, k, v, kind=kind))
    assert attn_kernel.launch_counts[f"block_attention.{route}"] == n0 + 1
    want = run(lambda q, k, v: attn_kernel.attention_ref(q, k, v,
                                                         kind=kind))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", [True, False], ids=["vision", "text"])
def test_mrope_prefill_on_card(cuda_device, grid, dtype):
    """A causal prefill of M-RoPE-rotated q and k at hd 128 with a GQA
    group of 8 (qwen2-vl-72b's head geometry, 16 query heads over 2 KV
    heads): the vision owner's (t=0, h, w) grid of side 16, or text
    positions ``[base]*3`` from 256; tc in bf16, fma in f32, against
    the plain version on the same rotated inputs."""
    from repro_torch.models.layers import apply_mrope
    B, S, nh, nkv, hd = 2, 256, 16, 2, 128
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in attn_inputs(B, S, S, nh, nkv, hd))
    ar = torch.arange(S, device=cuda_device)
    p3 = (torch.stack([torch.zeros_like(ar), ar // 16, ar % 16], -1) if grid
          else torch.stack([256 + ar] * 3, -1))
    q, k = (apply_mrope(t, p3, 1e6).to(dtype) for t in (q, k))
    v = v.to(dtype)
    route = "tc" if dtype == torch.bfloat16 else "fma"
    n0 = attn_kernel.launch_counts[f"block_attention.{route}"]
    got = attn_kernel.block_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn_kernel.launch_counts[f"block_attention.{route}"] == n0 + 1
    torch.testing.assert_close(got.float(), attn_kernel.attention_ref(
        q, k, v).float(), **attn_tol(dtype))


# llama3.2-3b's long_500k decode (24/8 heads of 128, B 1): the full
# 524296-slot cache under the 8192-token window the builder's
# swa_override sets, and the ring cache's 8192 slots, bidir.  An output
# row is a softmax-weighted mean of ~8192 N(0, 1) values (|out| < ~0.1),
# so these calls are held to ~4 bf16 ulps of the largest outputs, not to
# the reference's atol of 2e-2, which would pass a wrong window
LONG_KEYS, LONG_WINDOW = 524_288 + 8, 8192
LONG_TOL = dict(atol=2e-3, rtol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
def test_decode_route_over_the_long_500k_cache_on_card(cuda_device, fp8):
    """One decode row at position 524288 over a 524296-key cache with a
    local window of 8192: the decode route walks the window alone
    (``plan.live_range``) and agrees with the plain version, the cache
    in bf16 or stored as fp8 and upcast (the model's path)."""
    from repro_torch.models.attention import to_cache_dtype
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pos = LONG_KEYS - 8
    q = torch.randn((1, 1, 24, 128), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, LONG_KEYS, 8, 128), generator=gen,
                        device=cuda_device, dtype=torch.bfloat16)
            for _ in range(2))
    if fp8:
        k, v = (to_cache_dtype(t, torch.float8_e4m3fn).to(torch.bfloat16)
                for t in (k, v))
    kw = dict(kind="local", window=LONG_WINDOW, q_offset=pos,
              kv_len=pos + 1)
    lo, hi = attn_plan.live_range(1, "local", LONG_WINDOW, pos, pos + 1,
                                  LONG_KEYS)
    assert (lo, hi) == (516_096, pos + 1)   # the window, from a whole tile
    n0 = attn_kernel.launch_counts["block_attention.decode"]
    got = attn_kernel.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attn_kernel.launch_counts["block_attention.decode"] == n0 + 1
    want = attn_kernel.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **LONG_TOL)


@pytest.mark.cuda
def test_decode_route_over_ring_slots_on_card(cuda_device):
    """The ring cache's decode call: 8192 slots, bidir over all of them
    (every slot holds a position inside the window)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((1, 1, 24, 128), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, LONG_WINDOW, 8, 128), generator=gen,
                        device=cuda_device, dtype=torch.bfloat16)
            for _ in range(2))
    kw = dict(kind="bidir", kv_len=LONG_WINDOW)
    n0 = attn_kernel.launch_counts["block_attention.decode"]
    got = attn_kernel.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert attn_kernel.launch_counts["block_attention.decode"] == n0 + 1
    torch.testing.assert_close(got.float(), attn_kernel.attention_ref(
        q, k, v, **kw).float(), **LONG_TOL)


def test_host_mesh_needs_a_visible_card(monkeypatch):
    """``make_host_mesh()`` means the card: with none visible it raises
    (runs everywhere, with the card hidden)."""
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        make_host_mesh()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "train"])
def test_one_device_trace_launches_equal_the_card(cuda_device, monkeypatch,
                                                  kind):
    """A reduced llama3.2-3b step run for real on the card and traced by
    the dry-run on a one-device fake mesh: the same launches by route;
    the real run never takes the wrappers' described branch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.block_attention import ops as attn_ops
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import SplitModel
    cfg = get_config("llama3.2-3b", reduced=True).replace(n_layers=3)
    shape = ShapeConfig("t", 64, 4, kind)
    fn, args, _, _ = steps.build(cfg, shape, make_host_mesh())
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = SplitModel(cfg).init(gen)
    described = []
    real = attn_ops._describe
    monkeypatch.setattr(attn_ops, "_describe",
                        lambda *a: described.append(a) or real(*a))
    attn_kernel.reset_launch_counts()
    if kind == "decode":
        caches = steps.materialize(args[1], gen, cuda_device)
        token = torch.zeros((4, 1), dtype=torch.int32, device=cuda_device)
        fn(params, caches, token, 64, 32)     # the trace's positions
    else:
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=cuda_device)
                 for k, v in args[2].items()}
        fn(params, steps.make_optimizer(cfg).init(params), batch, 0)
    torch.cuda.synchronize()
    card = {k: n for k, n in attn_kernel.launch_counts.items()
            if k.startswith("block_attention.") and n}
    assert card and not described
    with dryrun.fake_world(1):
        traced = dryrun.trace_step(cfg, shape, dryrun.fake_mesh(
            (1, 1), ("data", "model")))
    assert traced["kernels"] == card
    assert len(described) == sum(card.values())
