"""The dry-run analysis against the reference's HLO parser: the same
collectives go to the port's ``collective_stats`` as records and to the
reference's as compiled-HLO lines (explicit and iota replica groups,
async start / done pairs, source-target pairs), and the two agree on
every count.  Also the trace's tallies on small steps, and the kernel
wrappers' description of a launch on ``meta`` tensors."""
import numpy as np
import pytest
import torch

from repro.launch import analysis as ref
from repro.testing.hypo import given, settings, strategies as st
from repro_torch.launch import analysis

#: torch dtype name -> the HLO type of the reference's byte table
HLO_TYPES = {"float64": "f64", "float32": "f32", "float16": "f16",
             "bfloat16": "bf16", "float8_e4m3fn": "f8e4m3fn",
             "float8_e5m2": "f8e5m2", "int64": "s64", "uint64": "u64",
             "int32": "s32", "uint32": "u32", "int16": "s16",
             "uint16": "u16", "int8": "s8", "uint8": "u8", "bool": "pred",
             "complex64": "c64", "complex128": "c128"}
KINDS = analysis.COLLECTIVES


def _groups_text(groups):
    return "{" + ",".join("{" + ",".join(map(str, g)) + "}"
                          for g in groups) + "}"


def hlo_line(i, kind, dtype, shape, groups=None, iota=None, start=False):
    """One collective as the compiled module prints it: explicit groups,
    the iota form ``(groups_shape, src_shape, perm)``, or (for a
    collective-permute) source-target pairs."""
    res = f"{HLO_TYPES[dtype]}[{','.join(map(str, shape))}]{{0}}"
    op = kind + ("-start" if start else "")
    line = f"  %{op}.{i} = {res} {op}(%x.{i}), channel_id={i}, "
    if kind == "collective-permute":
        return line + "source_target_pairs=" + _groups_text(groups)
    if iota is not None:
        g, s, perm = iota
        line += (f"replica_groups=[{','.join(map(str, g))}]<="
                 f"[{','.join(map(str, s))}]")
        if perm is not None:
            line += f"T({','.join(map(str, perm))})"
        return line
    return line + "replica_groups=" + _groups_text(groups)


def done_line(i, kind, dtype, shape):
    return (f"  %{kind}-done.{i} = {HLO_TYPES[dtype]}"
            f"[{','.join(map(str, shape))}]{{0}} {kind}-done("
            f"%{kind}-start.{i})")


def both(colls, devices_per_pod):
    """(port stats, reference stats) of one list of collectives."""
    lines, records = [], []
    for i, c in enumerate(colls):
        groups = c.get("groups")
        if c.get("iota") is not None:
            g, s, perm = c["iota"]
            groups = ref._iota_groups(g, s, perm).tolist()
        lines.append(hlo_line(i, c["kind"], c["dtype"], c["shape"],
                              groups=groups, iota=c.get("iota"),
                              start=c.get("start", False)))
        if c.get("start"):
            lines.append(done_line(i, c["kind"], c["dtype"], c["shape"]))
        records.append({"kind": c["kind"], "dtype": c["dtype"],
                        "shape": list(c["shape"]), "groups": groups,
                        "site": None})
    return (analysis.collective_stats(records, devices_per_pod),
            ref.collective_stats("\n".join(lines) + "\n", devices_per_pod))


def assert_same(port, want):
    for key in ("per_kind_bytes", "total_bytes", "n_ops",
                "cross_pod_bytes"):
        assert port[key] == want[key], (key, port[key], want[key])
    assert len(port["cross_pod_ops"]) == len(want["cross_pod_ops"])


@pytest.mark.parametrize("dtype", sorted(HLO_TYPES))
@pytest.mark.parametrize("shape", [(), (16,), (2048, 16384), (3, 1, 5)])
def test_shape_bytes_matches_reference(dtype, shape):
    text = f"{HLO_TYPES[dtype]}[{','.join(map(str, shape))}]{{0}}"
    assert analysis.shape_bytes(dtype, shape) == ref.shape_bytes(text)
    assert analysis.shape_bytes(getattr(torch, dtype), shape) == \
        ref.shape_bytes(text)


# the reference's own test_analysis.py cases, as records and as HLO
REFERENCE_CASES = {
    "counts_ops": ([
        dict(kind="all-reduce", dtype="float32", shape=(128, 256),
             groups=[[0, 1], [2, 3]]),
        dict(kind="all-gather", dtype="bfloat16", shape=(64, 64),
             groups=[[0, 1, 2, 3]])], 0),
    "explicit_groups": ([
        dict(kind="all-reduce", dtype="float32", shape=(4,),
             groups=[[0, 1], [2, 3]]),
        dict(kind="all-reduce", dtype="float32", shape=(4,),
             groups=[[0, 2], [1, 3]])], 2),
    "iota_plain": ([dict(kind="all-gather", dtype="float32", shape=(8,),
                         iota=([2, 4], [8], None))], 4),
    "iota_transposed": ([dict(kind="all-gather", dtype="float32",
                              shape=(8,), iota=([4, 2], [2, 4], [1, 0]))],
                        4),
    "iota_cross": ([dict(kind="all-gather", dtype="float32", shape=(8,),
                         iota=([4, 2], [2, 4], [1, 0]))], 4),
    "async_pair": ([dict(kind="all-gather", dtype="float32", shape=(8,),
                         groups=[[0, 1]], start=True)], 0),
    # the production mesh's three axes in iota form, 256 per pod
    "pod_axis": ([dict(kind="all-gather", dtype="bfloat16",
                       shape=(2, 8, 4096, 3072),
                       iota=([256, 2], [2, 256], [1, 0]))], 256),
    "model_axis": ([dict(kind="reduce-scatter", dtype="float32",
                         shape=(8, 4096, 192), iota=([32, 16], [512], None)),
                    dict(kind="all-to-all", dtype="bfloat16",
                         shape=(16, 2, 128), iota=([32, 16], [512], None))],
                   256),
    "permute": ([dict(kind="collective-permute", dtype="float32",
                      shape=(4, 4), groups=[[0, 1], [1, 2], [2, 3]]),
                 dict(kind="collective-permute", dtype="bfloat16",
                      shape=(4,), groups=[[0, 1], [2, 3]])], 2),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_collective_stats_match_reference(case):
    colls, dpp = REFERENCE_CASES[case]
    port, want = both(colls, dpp)
    assert_same(port, want)


def test_reference_expectations_hold_for_the_port():
    """The reference's asserted numbers, on the port's side."""
    s, _ = both(REFERENCE_CASES["counts_ops"][0], 0)
    assert s["n_ops"] == 2
    assert s["per_kind_bytes"]["all-reduce"] == 128 * 256 * 4
    assert s["per_kind_bytes"]["all-gather"] == 64 * 64 * 2
    s, _ = both(REFERENCE_CASES["explicit_groups"][0], 2)
    assert s["cross_pod_bytes"] == 16 and len(s["cross_pod_ops"]) == 1
    s, _ = both(REFERENCE_CASES["iota_cross"][0], 4)
    assert s["cross_pod_bytes"] == 32
    s, _ = both(REFERENCE_CASES["iota_plain"][0], 4)
    assert s["cross_pod_bytes"] == 0
    s, _ = both(REFERENCE_CASES["async_pair"][0], 0)
    assert s["n_ops"] == 1


@st.composite
def _collectives(draw):
    n_dev = draw(st.sampled_from([4, 8, 16]))
    out = []
    for _ in range(draw(st.integers(1, 5))):
        kind = draw(st.sampled_from(KINDS))
        ranks = draw(st.permutations(range(n_dev)))
        if kind == "collective-permute":
            pairs = draw(st.integers(1, n_dev // 2))
            groups = [[ranks[2 * i], ranks[2 * i + 1]]
                      for i in range(pairs)]
        else:
            size = draw(st.sampled_from([s for s in (1, 2, 4, 8)
                                         if n_dev % s == 0]))
            groups = [sorted(ranks[i:i + size])
                      for i in range(0, n_dev, size)]
        shape = tuple(draw(st.lists(st.integers(1, 64), max_size=3)))
        out.append(dict(kind=kind, dtype=draw(st.sampled_from(
            sorted(HLO_TYPES))), shape=shape, groups=groups,
            start=draw(st.booleans())))
    dpp = draw(st.sampled_from([0] + [d for d in (1, 2, 4, 8)
                                      if d < n_dev]))
    return out, dpp


@settings(max_examples=60, deadline=None)
@given(_collectives())
def test_collective_stats_match_reference_on_drawn_groups(drawn):
    colls, dpp = drawn
    port, want = both(colls, dpp)
    assert_same(port, want)


@pytest.mark.parametrize("mem", [
    dict(argument_bytes=5514628, output_bytes=5514768, temp_bytes=4136840,
         alias_bytes=5514240),
    dict(argument_bytes=1, output_bytes=2, temp_bytes=3, alias_bytes=0),
    {}])
def test_hbm_per_device_matches_reference(mem):
    assert analysis.hbm_per_device(mem) == ref.hbm_per_device(mem)


# ---------------------------------------------------------------------------
# The kernel wrappers on meta tensors: the card's launch, described
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


class _Sink:
    """A tally: the described launches."""
    sm_count = 132

    def __init__(self):
        self.launches = []

    def kernel(self, name, flops, nbytes):
        self.launches.append((name, flops, nbytes))


@pytest.mark.parametrize("case", [
    # (q shape, k shape, dtype, kind, q_offset, kv_len, route)
    ((2, 1, 24, 128), (2, 1032, 8, 128), torch.bfloat16, "causal", 1024,
     1025, "decode"),
    ((2, 512, 24, 128), (2, 1032, 8, 128), torch.bfloat16, "causal", 0,
     512, "tc"),
    ((2, 512, 24, 128), (2, 512, 8, 128), torch.float32, "causal", 0,
     None, "fma"),
    ((1, 300, 16, 256), (1, 300, 8, 256), torch.bfloat16, "bidir", 0,
     None, "fma"),
])
def test_attention_on_meta_describes_the_cards_launch(case):
    """On ``meta`` tensors the wrapper takes the route the card's plan
    gives, returns an output of the kernel's shape and dtype, and
    reports the work ``plan.work`` counts (``chip_smoke.py``'s bound):
    nothing launched, nothing counted in ``launch_counts``."""
    from repro_torch.kernels import block_attention as attn, fake
    from repro_torch.kernels.block_attention import plan
    qs, ks, dtype, kind, q_offset, kv_len, route = case
    q, k, v = _meta(qs, dtype), _meta(ks, dtype), _meta(ks, dtype)
    before = dict(attn.launch_counts)
    with fake.tally(_Sink()) as sink:
        out = attn.block_attention(q, k, v, kind=kind, q_offset=q_offset,
                                   kv_len=kv_len)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == dtype
    assert attn.launch_counts == before
    B, Sq, nh, hd = qs
    flops, nbytes = plan.work(B, Sq, ks[1], nh, ks[2], hd,
                              q.element_size(), kind, 0, [q_offset] * B,
                              [kv_len] * B)
    assert sink.launches == [(f"block_attention.{route}", flops, nbytes)]
    pairs = (sum(min(kv_len or ks[1], q_offset + i + 1) for i in range(Sq))
             if kind == "causal" else Sq * ks[1])
    assert flops == 4 * B * nh * hd * pairs


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "chunked"),
                                         (torch.float32, "serial")])
def test_scan_on_meta_describes_the_cards_launch(dtype, route):
    from repro_torch.kernels import fake
    from repro_torch.kernels import mamba2_scan as scan
    from repro_torch.kernels.mamba2_scan import plan
    B, S, H, P, G, N = 2, 512, 80, 64, 1, 64
    x = _meta((B, S, H, P), dtype)
    dt, A = _meta((B, S, H), torch.float32), _meta((H,), torch.float32)
    Bm, Cm = _meta((B, S, G, N), dtype), _meta((B, S, G, N), dtype)
    with fake.tally(_Sink()) as sink:
        y, state = scan.mamba2_scan(x, dt, A, Bm, Cm, chunk=256)
    assert y.shape == x.shape and y.dtype == dtype
    assert state.shape == (B, H, N, P) and state.dtype == torch.float32
    flops, nbytes = plan.work(B, S, H, P, G, N, 256, x.element_size(),
                              False)
    assert sink.launches == [(f"mamba2_scan.{route}", flops, nbytes)]


def test_real_cpu_tensors_take_the_plain_version_under_a_trace():
    """A trace changes nothing for real tensors: on the CPU the wrapper
    runs the plain version, reports no launch, and gives its values."""
    from repro_torch.kernels import block_attention as attn
    from repro_torch.launch.trace import Trace
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 8, 4, 16), generator=g)
    k, v = (torch.randn((2, 8, 2, 16), generator=g) for _ in range(2))
    trace = Trace()
    with trace:
        got = attn.block_attention(q, k, v)
    assert not trace.kernels and trace.flops > 0
    torch.testing.assert_close(got, attn.attention_ref(q, k, v), rtol=0,
                               atol=0)


def test_trace_counts_live_bytes_and_flops():
    """The trace's tallies on plain ``meta`` ops: a product's 2·m·n·k,
    its bytes in and out, the peak of live storages (the product, its
    double and the sum at once: the double dies after the sum) and the
    live bytes once the product is dropped."""
    from repro_torch.launch.trace import Trace
    a, b = _meta((64, 32), torch.float32), _meta((32, 16), torch.float32)
    trace = Trace()
    trace.track(a)
    trace.track(b)
    with trace:
        c = a @ b
        d = (c * 2).sum()
    assert trace.flops == 2 * 64 * 32 * 16
    elt = 4
    assert trace.bytes_accessed == (
        elt * (64 * 32 + 32 * 16 + 64 * 16)      # mm
        + elt * (64 * 16 + 64 * 16)              # mul (a scalar operand)
        + elt * (64 * 16 + 1))                   # sum
    assert trace.peak == elt * (64 * 32 + 32 * 16 + 2 * 64 * 16 + 1)
    del c
    assert trace.live == elt * (64 * 32 + 32 * 16 + 1)
    assert d.shape == ()


def test_trace_memo_makes_what_the_op_makes():
    """An op met again with the same argument metadata is made from the
    layout it gave the first time (``Trace._remember``): the same shape,
    strides and dtype as the op's own result on a transposed, a
    broadcast and a promoting call, and the same tallies; views and a
    result on its input's storage (``_unsafe_view``) still run, so they
    share their input's storage and add no live bytes."""
    from repro_torch.launch.trace import Trace
    a = _meta((8, 4, 16), torch.bfloat16)
    b = _meta((4, 8, 16), torch.float32).transpose(0, 1)
    c = _meta((1, 4, 1), torch.float32)
    calls = [lambda: a * b, lambda: b + c, lambda: torch.tanh(b),
             lambda: torch.bmm(a.float(), b.transpose(1, 2)),
             lambda: b.sum(-1)]
    trace = Trace()
    with trace:
        runs = [[f() for f in calls] for _ in range(3)]
        flat = torch.ops.aten._unsafe_view(runs[0][0].contiguous(),
                                           (32, 16))
        v = runs[0][0].view(32, 16)
    want = [f() for f in calls]
    for got in runs:
        assert [(x.shape, x.stride(), x.dtype) for x in got] == \
            [(x.shape, x.stride(), x.dtype) for x in want]
    assert len(trace._memo) == len(calls) + 1     # and a.float()
    for x in (flat, v):
        assert x.untyped_storage()._cdata == \
            runs[0][0].untyped_storage()._cdata
