"""The port's PSI engine against the JAX package's, on the CPU: bloom
bitsets on the scalar and batch paths, the modexp chunk kernels and the
pool, and every leg of every protocol mode (delta splices and their op
counts included) byte for byte, with both sides' secrets set equal.
"""
import numpy as np
import pytest

from repro.core import bloom as ref_bloom
from repro.core import modexp as ref_modexp
from repro.core import psi as ref_psi
from repro.core import resolution as ref_resolution
from repro.testing.hypo import given, settings, strategies as st
from repro_torch.core import bloom, modexp, psi, resolution

GROUP = "modp512"
NB = psi.GROUPS[GROUP][2]


def _pair(xs, ys, mode="noinv", fp_rate=1e-9):
    """(port client, port server, reference client, reference server)
    over the same items, the port's secrets set to the reference's."""
    rc = ref_psi.PSIClient(xs, GROUP, mode=mode)
    rs = ref_psi.PSIServer(ys, fp_rate, GROUP)
    c = psi.PSIClient(xs, GROUP, mode=mode)
    c._blind_exp, c._unblind_exp = rc._blind_exp, rc._unblind_exp
    s = psi.PSIServer(ys, fp_rate, GROUP, beta=rs._beta)
    return c, s, rc, rs


def _ids(n, off=0, prefix="id"):
    return [f"{prefix}-{i + off}" for i in range(n)]


# ---------------------------------------------------------------------------
# bloom
# ---------------------------------------------------------------------------


@given(st.lists(st.binary(min_size=1, max_size=24), min_size=1,
                max_size=200), st.floats(1e-9, 1e-2))
@settings(max_examples=15, deadline=None)
def test_bloom_bitsets_equal_reference_scalar_and_batch(items, fp):
    """The same items added one by one (scalar path) or in one batch
    give the reference's bitset byte for byte, and queries agree."""
    a = bloom.BloomFilter.for_capacity(len(items), fp)
    r = ref_bloom.BloomFilter.for_capacity(len(items), fp)
    assert (a.m, a.k) == (r.m, r.k)
    half = len(items) // 2
    for it in items[:half]:
        a.add(it)
        r.add(it)
    a.add_batch(items[half:])
    r.add_batch(items[half:])
    assert a.to_bytes() == r.to_bytes()
    probes = items + [b"absent-" + it for it in items]
    assert np.array_equal(a.query_batch(probes), r.query_batch(probes))
    assert [p in a for p in probes[:20]] == [p in r for p in probes[:20]]


@pytest.mark.parametrize("n,shards", [(300, 0), (300, 3), (5000, 7)])
def test_sharded_bloom_frames_equal_reference(n, shards):
    items = [f"e{i}".encode() for i in range(n)]
    a = bloom.ShardedBloom.for_capacity(n, 1e-9, n_shards=shards)
    r = ref_bloom.ShardedBloom.for_capacity(n, 1e-9, n_shards=shards)
    a.add_batch(items[: n // 3])
    for it in items[n // 3: n // 3 + 10]:
        a.add(it)
    a.add_batch(items[n // 3 + 10:])
    r.add_batch(items)
    assert a.shard_frames() == r.shard_frames()
    assert a.content_tag() == r.content_tag()
    # a parallel build (two halves OR-merged) equals the serial one
    b1 = bloom.ShardedBloom.for_capacity(n, 1e-9, n_shards=shards)
    b2 = bloom.ShardedBloom.for_capacity(n, 1e-9, n_shards=shards)
    b1.add_batch(items[::2])
    b2.add_batch(items[1::2])
    assert b1.merge(b2).shard_frames() == r.shard_frames()
    back = bloom.BloomFilter.from_bytes(a.shard_frames()[0],
                                        a.shards[0].m, a.shards[0].k)
    assert back.to_bytes() == a.shard_frames()[0]
    with pytest.raises(ValueError):
        bloom.BloomFilter(0, 3)


# ---------------------------------------------------------------------------
# modexp
# ---------------------------------------------------------------------------


def test_chunk_kernels_equal_reference():
    p, q, nb = psi.GROUPS[GROUP]
    rng = np.random.default_rng(0)
    items = [f"u{i}" for i in range(37)]
    exp = int(rng.integers(2, 2 ** 62))
    hp = modexp.hashpow_chunk((items, exp, p, nb))
    assert hp == ref_modexp.hashpow_chunk((items, exp, p, nb))
    assert modexp.pow_chunk((hp, exp + 1, p, nb)) == \
        ref_modexp.pow_chunk((hp, exp + 1, p, nb))
    xs = [int(v) for v in rng.integers(1, 2 ** 62, 9)]
    assert modexp.pack_ints(xs, 8) == ref_modexp.pack_ints(xs, 8)
    assert modexp.unpack_ints(modexp.pack_ints(xs, 8), 8) == xs
    assert modexp.powmod(12345, 678, 1009) == pow(12345, 678, 1009)
    assert modexp.hash_to_group(b"x", p, nb) == \
        ref_modexp.hash_to_group(b"x", p, nb)


def test_pool_is_bit_identical_and_reports_its_parallelism():
    """Two workers (spawned: torch is loaded) give the serial pool's
    bytes in task order."""
    import torch  # noqa: F401 — a parent with torch spawns its workers
    assert modexp._start_method() == "spawn"
    p, _, nb = psi.GROUPS[GROUP]
    tasks = [([f"t{i}-{j}" for j in range(5)], 3 + i, p, nb)
             for i in range(7)]
    serial = list(modexp.ModexpPool(0).imap(modexp.hashpow_chunk, tasks))
    with modexp.ModexpPool(2) as pool:
        assert pool.is_parallel, pool.fallback_reason
        assert list(pool.imap(modexp.hashpow_chunk, tasks)) == serial
        c, s, _, _ = _pair(_ids(60), _ids(60, 20))
        _, stats = psi.psi_round(c, s, pool=pool, chunk_size=16)
        assert stats["parallelism"] == 2


def test_pool_start_failure_degrades_to_serial(monkeypatch):
    import concurrent.futures as cf

    def boom(*a, **k):
        raise OSError("no workers here")

    monkeypatch.setattr(cf, "ProcessPoolExecutor", boom)
    pool = modexp.ModexpPool(4)
    assert not pool.is_parallel
    assert "no workers here" in pool.fallback_reason
    inter, stats = psi.psi_intersect(["a", "b", "c"], ["b", "c", "d"],
                                     group=GROUP, pool=pool)
    assert inter == ["b", "c"] and stats["parallelism"] == 0


def test_imap_bounded_lookahead():
    pool = modexp.ModexpPool(0)
    pulled, consumed = [], []

    def tasks():
        for i in range(20):
            pulled.append(i)
            yield (modexp.pack_ints([i + 2], 8), 3, 1000003, 8)

    for out in pool.imap(modexp.pow_chunk, tasks()):
        consumed.append(out)
        assert len(pulled) - len(consumed) <= max(pool.inflight, 1)
    assert len(consumed) == 20


# ---------------------------------------------------------------------------
# the legs, mode by mode
# ---------------------------------------------------------------------------


def _round_both(c, s, rc, rs, chunk):
    """psi_round on both packages; returns (port result, port stats,
    reference result, reference stats, port messages, reference
    messages)."""
    msgs, rmsgs = [], []
    got = psi.psi_round(c, s, chunk_size=chunk,
                        on_message=lambda k, n: msgs.append((k, n)))
    ref = ref_psi.psi_round(rc, rs, chunk_size=chunk,
                            on_message=lambda k, n: rmsgs.append((k, n)))
    return got + ref + (msgs, rmsgs)


@given(st.lists(st.text(min_size=1, max_size=8), min_size=0, max_size=40),
       st.lists(st.text(min_size=1, max_size=8), min_size=0, max_size=40),
       st.integers(1, 17), st.sampled_from(list(psi.MODES)))
@settings(max_examples=20, deadline=None)
def test_round_equals_reference_every_mode(xs, ys, chunk, mode):
    """Random uneven sets with duplicates, any chunk size, every mode:
    the intersection (hidden: the keep set and rows), every stats value
    and every simulated message equal the reference's."""
    c, s, rc, rs = _pair(xs, ys, mode)
    got, stats, ref, rstats, msgs, rmsgs = _round_both(c, s, rc, rs, chunk)
    assert got == ref
    assert stats == rstats
    assert msgs == rmsgs
    assert (c.ops, s.ops) == (rc.ops, rs.ops)


@pytest.mark.parametrize("mode", psi.MODES)
def test_leg_bytes_equal_reference(mode):
    """Each leg's packed bytes: the blinded upload, the shuffled own set
    and its row map, the double-blinds, the bloom's shard frames, the
    lifted set, and the hidden keep set with its decoy rows."""
    xs = _ids(90) + ["dup"] * 3
    ys = _ids(70, 40) + ["dup"]
    c, s, rc, rs = _pair(xs, ys, mode)
    up = c.blind_packed(chunk_size=16)
    assert up == rc.blind_packed(chunk_size=16)
    assert psi.blind_tag(up) == ref_psi.blind_tag(up)
    assert s.own_blinded_packed() == rs.own_blinded_packed()
    assert s._own_rows == rs._own_rows
    assert s.server_leg_tag(mode) == rs.server_leg_tag(mode)
    d = [b for _, b in s.respond_chunks(up, chunk_size=16)]
    assert d == [b for _, b in rs.respond_chunks(up, chunk_size=16)]
    if mode == "bloom":
        assert s.build_bloom().shard_frames() == \
            rs.build_bloom().shard_frames()
    t = modexp.pow_chunk((s.own_blinded_packed(), c._blind_exp, c._p, NB))
    if mode == "hidden":
        keep, rows = s.hidden_match(b"".join(d), t)
        assert (keep, rows) == rs.hidden_match(b"".join(d), t)
        assert len(keep) % psi.HIDDEN_PAD == 0
        members = {i for i, x in enumerate(xs) if x in set(ys)}
        decoys = [k for k in keep if k not in members]
        assert decoys and all(
            rows[keep.index(k)] == psi.decoy_row(k, len(ys))
            for k in decoys)
    assert psi.decoy_row(5, 7) == ref_psi.decoy_row(5, 7)
    assert psi.HIDDEN_PAD == ref_psi.HIDDEN_PAD


def test_noinv_and_bloom_modes_agree():
    xs, ys = _ids(120), _ids(100, 50)
    a, _ = psi.psi_intersect(xs, ys, group=GROUP, mode="noinv")
    b, _ = psi.psi_intersect(xs, ys, group=GROUP, mode="bloom")
    assert a == b == [x for x in xs if x in set(ys)]
    with pytest.raises(ValueError, match="unknown PSI mode"):
        psi.PSIClient(xs, GROUP, mode="nope")


# ---------------------------------------------------------------------------
# delta splices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["churn", "remove_only", "add_only",
                                  "full_churn", "duplicates", "unchanged",
                                  "composed"])
def test_update_items_splice_equals_reference(case):
    """``update_items`` on both packages: the spliced upload, the item
    order, the recorded delta (tags, retained, removed, added bytes) and
    the op counts are the reference's; composed updates diff against one
    base, and a rebase starts a new one."""
    xs = _ids(80) + ["dup", "dup"]
    c, _, rc, _ = _pair(xs, [])
    c.blind_packed(chunk_size=16)
    rc.blind_packed(chunk_size=16)
    new = {"churn": xs[2:] + ["fresh-0", "fresh-1"],
           "remove_only": xs[5:],
           "add_only": xs + ["fresh-9"],
           "full_churn": _ids(40, 1000),
           "duplicates": xs[:-1] + ["dup", "dup", "x"],
           "unchanged": list(xs),
           "composed": xs[1:] + ["fresh-0"]}[case]
    for cli in (c, rc):
        cli.update_items(new, chunk_size=16)
        if case == "composed":
            cli.update_items(new[1:] + ["fresh-1"], chunk_size=16)
    assert c.items == rc.items
    assert c._blinded_packed == rc._blinded_packed
    assert c._delta == rc._delta
    assert c.ops == rc.ops
    if case in ("churn", "composed"):
        assert c._delta is not None and c._delta["base_tag"] == \
            psi.blind_tag(c._base_packed)
    if case in ("full_churn", "unchanged"):
        assert c._delta is None
    # the spliced upload is what a fresh blind of the new items gives
    fresh = psi.PSIClient(c.items, GROUP)
    fresh._blind_exp = c._blind_exp
    assert fresh.blind_packed(chunk_size=16) == c._blinded_packed
    c.rebase_delta()
    assert c._base_items is None and c._delta is None


def test_server_update_items_reblinds_only_new_items():
    ys = _ids(60)
    _, s, _, rs = _pair([], ys)
    s.own_blinded_packed()
    rs.own_blinded_packed()
    new = ys[3:] + ["fresh-a", "fresh-b"]
    for srv in (s, rs):
        srv.update_items(new)
        srv.own_blinded_packed()
    assert s.own_blinded_packed() == rs.own_blinded_packed()
    assert s.ops == rs.ops == 62


# ---------------------------------------------------------------------------
# core.resolution.resolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["noinv", "bloom"])
def test_resolution_resolve_equals_reference(mode):
    rng = np.random.default_rng(3)
    pop = _ids(150)
    sci = resolution.VerticalDataset(pop[:130], np.arange(130))
    keep = [pop[i] for i in sorted(rng.choice(150, 120, replace=False))]
    owners = {"a": resolution.VerticalDataset(keep, np.ones((120, 2))),
              "b": resolution.VerticalDataset(pop[10:], np.zeros((140, 3)))}
    rsci = ref_resolution.VerticalDataset(sci.ids, sci.data)
    rown = {k: ref_resolution.VerticalDataset(v.ids, v.data)
            for k, v in owners.items()}
    a_sci, a_own, st_ = resolution.resolve(sci, owners, group=GROUP,
                                           mode=mode, chunk_size=32)
    r_sci, r_own, rst = ref_resolution.resolve(rsci, rown, group=GROUP,
                                               mode=mode, chunk_size=32)
    assert a_sci.ids == r_sci.ids
    assert np.array_equal(a_sci.data, r_sci.data)
    for k in owners:
        assert a_own[k].ids == r_own[k].ids
        assert np.array_equal(a_own[k].data, r_own[k].data)
    assert st_ == rst


# ---------------------------------------------------------------------------
# the one-shot API: blind / respond / intersect / reset_session
# ---------------------------------------------------------------------------


def test_hash_to_group_reexport_equals_reference():
    for group in ("modp512", "modp2048"):
        p, _, nb = psi.GROUPS[group]
        for item in (b"a", b"id-7", b""):
            assert psi.hash_to_group(item, p, nb) == \
                ref_psi.hash_to_group(item, p, nb)
    assert psi.hash_to_group(b"x") == ref_psi.hash_to_group(b"x")


def test_psi_server_learns_only_cardinality():
    """The server's view is blinded group elements, distinct from the raw
    hashes; with equal secrets they are the reference's."""
    c, _, rc, _ = _pair(["a", "b"], ["b"])
    blinded = c.blind()
    p, _, nb = psi.GROUPS[GROUP]
    raw = [psi.hash_to_group(x.encode(), p, nb) for x in ["a", "b"]]
    assert all(b != r for b, r in zip(blinded, raw))
    assert blinded == rc.blind()


@pytest.mark.parametrize("mode", ["noinv", "bloom"])
def test_one_shot_round_equals_reference(mode):
    """One client against two owners through ``blind`` (memoized, not
    re-blinded), ``respond`` and ``intersect``: every output equal to the
    reference's with equal secrets, and the right intersections."""
    xs = _ids(30)
    rc = ref_psi.PSIClient(xs, GROUP, mode=mode)
    c = psi.PSIClient(xs, GROUP, mode=mode)
    c._blind_exp, c._unblind_exp = rc._blind_exp, rc._unblind_exp
    b1 = c.blind()
    assert c.blind() is b1
    assert b1 == rc.blind()
    for shift in (5, 10):
        ys = _ids(30, shift)
        rs = ref_psi.PSIServer(ys, group=GROUP)
        s = psi.PSIServer(ys, group=GROUP, beta=rs._beta)
        double, bf = s.respond(b1)
        r_double, r_bf = rs.respond(rc.blind())
        assert double == r_double
        assert bf.shard_frames() == r_bf.shard_frames()
        inter = c.intersect(double, bf)
        assert inter == rc.intersect(r_double, r_bf) == _ids(30 - shift,
                                                              shift)
        assert s.ops == rs.ops
    assert c.ops == rc.ops


def test_reset_session_keeps_the_secrets():
    """The server builds its bloom once per session; ``reset_session`` on
    either side drops the memoized state and rebuilds the same bytes
    from the same secrets, as the reference's does."""
    c, s, rc, rs = _pair(_ids(10), _ids(25))
    _, bf1 = s.respond(c.blind())
    _, bf2 = s.respond(c.blind())
    assert bf1 is bf2
    rs.respond(rc.blind())
    blinded = c.blind()
    c.reset_session()
    rc.reset_session()
    assert c.blind() is not blinded and c.blind() == blinded
    s.reset_session()
    rs.reset_session()
    _, bf3 = s.respond(c.blind())
    assert bf3 is not bf1 and bf3.shard_frames() == bf1.shard_frames()
    assert bf3.shard_frames() == rs.respond(rc.blind())[1].shard_frames()
    assert (c.ops, s.ops) == (rc.ops, rs.ops)
