"""The MoE FFN (deepseek-moe-16b, mixtral-8x7b) in the port against the
JAX reference, on the CPU: the configs, ``capacity``, the routing (top-k
experts, positions within an expert, drops), ``moe_apply`` at
``dispatch_groups`` 1 and 2 with its balance loss, the split LM's logits
and aux, prefill and decode, the loss and its gradients with the aux in
them, fits (3 steps against the reference's; split lossless == the
per-owner-clipped joint oracle bit for bit; the owners' aux riding the
wire), the engines against the reference's, and the launchers.

The models are the reduced configs (d_model 256, 4 experts top-2 with
expert width 128; deepseek also 2 shared experts of 128, mixtral local
attention with window 64) at 2 layers: one unit per owner's head and
one in the trunk, both with the MoE FFN.  Params come from the
reference's init (``weights.from_reference``).

Tolerances.  In f32 the routing is equal: the same top-k experts in the
same order, the same positions, the same drops, on inputs that drop
choices and on a planted tie (two experts with one logit: the lower
index goes first, as ``jax.lax.top_k`` puts it).  FFN outputs and logits
within rel 1e-4 of the largest, the aux within rel 1e-5.  In bf16 two
packages' router logits may part by a rounding step, so a near-tie can
route differently: every token routed otherwise than the reference
routes it must have, in the reference's own probabilities, a gap
between its k-th and (k+1)-th expert below 2^-7 (bf16's relative
resolution, 2^-8, twice) of the k-th; the tokens routed alike are held
within atol 5e-2 (the LM's bf16 rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models import moe as ref_moe
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.federation.registry import build_adapter
from repro_torch.launch.engine import ServingEngine
from repro_torch.models import moe
from repro_torch.models.model import SplitModel
from repro_torch.weights import from_reference

from test_torch_lm import (_tokens, decode_matches_full_forward,
                           prefill_and_decode_match)
from test_torch_lm_train import (
    _fit, cfgs, loss_and_grads_match, reference_runs, split_equals_oracle,
    tokens)

torch.set_num_threads(1)

DEEPSEEK, MIXTRAL = "deepseek-moe-16b", "mixtral-8x7b"
ARCHS = [DEEPSEEK, MIXTRAL]
N_LAYERS = 2
COMPUTE = ["float32", "bfloat16"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _mcfgs(arch, compute="float32", **split):
    return cfgs(compute, N_LAYERS, arch=arch, **split)


def _ffn_pair(arch, compute="float32", **moe_kw):
    """(reference config, reference params, port config, port params) of
    one reduced MoE FFN."""
    rcfg = ref_get_config(arch, reduced=True).replace(compute_dtype=compute)
    cfg = get_config(arch, reduced=True).replace(compute_dtype=compute)
    if moe_kw:
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    rp = ref_moe.moe_init(jax.random.PRNGKey(3), rcfg.d_model, rcfg.moe,
                          rcfg.mlp)
    return rcfg, rp, cfg, from_reference(jax.tree.map(np.asarray, rp))


def _ref_routing(x, router_w, moe_cfg, C):
    """The reference's routing arithmetic (``repro.models.moe.moe_apply``'s
    first lines, in JAX) on one group: (probs, top_e, pos, keep)."""
    T = x.shape[0]
    E, K = moe_cfg.n_experts, moe_cfg.top_k
    logits = (x @ router_w.astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, K)
    e_flat = top_e.T.reshape(T * K)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return (np.asarray(probs), np.asarray(top_e), np.asarray(pos),
            np.asarray(pos < C))


def _x(T, d, seed=0, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)
    return x, torch.from_numpy(x).to(getattr(torch, dtype)), jnp.asarray(
        x, JNP[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
            dataclasses.asdict(ref_get_config(arch, reduced=reduced))
    m = get_config(arch, reduced=True).moe
    assert (m.n_experts, m.top_k, m.d_expert) == (4, 2, 128)


def test_capacity_matches_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            mc = get_config(arch, reduced=reduced).moe
            rmc = ref_get_config(arch, reduced=reduced).moe
            for n in (1, 4, 7, 48, 100, 512, 4096, 8192, 40000, 100000):
                assert moe.capacity(n, mc) == ref_moe.capacity(n, rmc)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _route_both(cfg, rcfg, params, rp, x, xt, xj, C):
    got = moe.route(xt, params["router"]["w"], cfg.moe, C)
    want = _ref_routing(xj, rp["router"]["w"], rcfg.moe, C)
    return got, want


@pytest.mark.parametrize("case", ["drops", "tie", "plain"])
def test_routing_equals_reference_in_f32(case):
    """top_e (order included), positions within an expert and the drops
    equal the reference's: with drops (the router biased so most first
    choices land on expert 0, past its capacity), with a planted tie
    (experts 1 and 2 share a router column: every token ties them), and
    on plain inputs."""
    rcfg, rp, cfg, params = _ffn_pair(DEEPSEEK)
    T = 64
    x, xt, xj = _x(T, cfg.d_model, seed=1)
    w = np.array(rp["router"]["w"])
    if case == "drops":
        w[:, 0] += 0.05 * np.sign(x.mean(0))
    if case == "tie":
        w[:, 2] = w[:, 1]
        w[:, 1:3] += 0.03 * np.sign(x.mean(0))[:, None]
    rp = dict(rp, router={"w": jnp.asarray(w)})
    params = dict(params, router={"w": torch.from_numpy(w)})
    C = moe.capacity(T, cfg.moe)
    (probs, top_w, top_e, e_flat, pos, keep, slot_choice), want = _route_both(
        cfg, rcfg, params, rp, x, xt, xj, C)
    rprobs, rtop_e, rpos, rkeep = want
    np.testing.assert_allclose(probs.numpy(), rprobs, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(top_e.numpy(), rtop_e)
    np.testing.assert_array_equal(pos.numpy(), rpos)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    dropped = int((~keep).sum())
    if case == "drops":
        assert dropped > 0
    if case == "tie":
        tied = (probs[:, 1] == probs[:, 2]) & (top_e == 1).any(1) & \
            (top_e == 2).any(1)
        assert int(tied.sum()) > 0
        first = top_e.numpy().tolist()
        assert all(r.index(1) < r.index(2) for r, t in zip(first, tied) if t)
    # every kept choice owns exactly its slot; every other slot is empty
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    table = np.full((E, C), T * K)
    for i in np.flatnonzero(rkeep):
        table[rtop_e.T.reshape(-1)[i], rpos[i]] = i
    np.testing.assert_array_equal(slot_choice.numpy(), table)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference_in_f32(arch, groups):
    """out and aux at ``dispatch_groups`` 1 and 2, on 2 rows of 40
    tokens: once as the init gives them, once with the router biased to
    drop choices (the drops counted the reference's way)."""
    rcfg, rp, cfg, params = _ffn_pair(arch, dispatch_groups=groups)
    x = np.random.default_rng(2).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    for bias in (0.0, 0.05):
        w = np.array(rp["router"]["w"])
        w[:, 0] += bias * np.sign(x.reshape(-1, cfg.d_model).mean(0))
        rp2 = dict(rp, router={"w": jnp.asarray(w)})
        p2 = dict(params, router={"w": torch.from_numpy(w)})
        yr, auxr = ref_moe.moe_apply(rp2, jnp.asarray(x), rcfg.moe, rcfg.mlp)
        y, aux = moe.moe_apply(p2, torch.from_numpy(x), cfg.moe, cfg.mlp)
        yr = np.asarray(yr)
        assert np.abs(y.numpy() - yr).max() <= 1e-4 * np.abs(yr).max()
        np.testing.assert_allclose(float(aux), float(auxr), rtol=1e-5)
        C = moe.capacity(80 // groups, cfg.moe)
        xs = x.reshape(groups, -1, cfg.d_model)
        want = sum(int((~_ref_routing(jnp.asarray(xg), w, rcfg.moe, C)[3])
                       .sum()) for xg in xs)
        dropped = sum(int((~moe.route(torch.from_numpy(xg), p2["router"]["w"],
                                      cfg.moe, C)[5]).sum()) for xg in xs)
        assert dropped == want
        assert (dropped > 0) == (bias > 0)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_grads_match_reference_in_f32(arch, groups):
    """The gradients of a weighted sum of out plus the aux, in x and in
    every param, against ``jax.grad`` of the reference's, on inputs that
    drop choices: within rel 1e-4 of each leaf's largest."""
    rcfg, rp, cfg, params = _ffn_pair(arch, dispatch_groups=groups)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    w = np.array(rp["router"]["w"])
    w[:, 0] += 0.05 * np.sign(x.reshape(-1, cfg.d_model).mean(0))
    rp = dict(rp, router={"w": jnp.asarray(w)})
    cot = rng.normal(size=x.shape).astype(np.float32)

    def ref_obj(p, xj):
        y, aux = ref_moe.moe_apply(p, xj, rcfg.moe, rcfg.mlp)
        return (y * cot).sum() + aux
    rgp, rgx = jax.grad(ref_obj, argnums=(0, 1))(rp, jnp.asarray(x))
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                          .requires_grad_(), rp)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(params, xt, cfg.moe, cfg.mlp)
    ((y * torch.from_numpy(cot)).sum() + aux).backward()
    pairs = [(xt.grad, rgx)] + list(zip(
        [t.grad for t in jax.tree.leaves(params)], jax.tree.leaves(rgp)))
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def _tables(T=24, E=4, K=2, C=16, seed=0):
    """One group's routing tables on random choices and a random f64 x:
    every token's first choice is expert 0, past its C slots (drops),
    and the second choices leave the other experts' slots part empty."""
    rng = np.random.default_rng(seed)
    mc = dataclasses.replace(get_config(DEEPSEEK, reduced=True).moe,
                             n_experts=E, top_k=K)
    x = torch.from_numpy(rng.normal(size=(T, 16)))
    x[:, 0] = 5.0
    router = torch.from_numpy(rng.normal(size=(16, E)))
    router[0] = torch.tensor([10.0] + [0.0] * (E - 1))
    r = moe.route(x.float(), router.float(), mc, C)
    return x, r, (r[6], r[3], torch.where(r[5], r[4], 0), r[5])


def test_dispatch_and_combine_backwards_are_exact():
    """The gather backwards of the dispatch and the combine against
    finite differences (``gradcheck`` in f64), on tables with drops and
    empty slots."""
    x, r, tb = _tables()
    assert not bool(r[5].all()) and bool((r[6] == r[5].numel()).any())
    xg = x.clone().requires_grad_()
    assert torch.autograd.gradcheck(lambda a: moe._Dispatch.apply(a, *tb),
                                    (xg,))
    E, C = r[6].shape
    buf = torch.from_numpy(np.random.default_rng(1).normal(
        size=(E, C, 16))).requires_grad_()
    assert torch.autograd.gradcheck(lambda b: moe._Combine.apply(b, *tb),
                                    (buf,))


def test_moe_backward_makes_no_accumulating_write():
    """No ``index_put`` / ``index_add`` / ``scatter_add`` op runs in the
    backward of ``moe_apply`` (groups 1 and 2, with drops): autograd's
    backward of an indexed read would be an accumulating ``index_put_``,
    which deterministic mode serialises on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.__name__)
            return func(*args, **(kwargs or {}))
    for groups in (1, 2):
        _, rp, cfg, params = _ffn_pair(DEEPSEEK, dispatch_groups=groups)
        params = {k: v for k, v in params.items()}
        leaves = [t.requires_grad_() for t in
                  jax.tree.leaves(params)]
        assert leaves
        x = torch.from_numpy(np.random.default_rng(6).normal(
            size=(2, 40, cfg.d_model)).astype(np.float32)).requires_grad_()
        y, aux = moe.moe_apply(params, x, cfg.moe, cfg.mlp)
        ops = Ops()
        with ops:
            (y.sum() + aux).backward()
        bad = [n for n in ops.names if n.startswith(
            ("index_put", "_index_put", "index_add", "scatter_add"))]
        assert not bad and x.grad is not None, (groups, sorted(ops.names))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_in_bf16_parts_only_at_near_ties(arch):
    """bf16: tokens routed otherwise than the reference routes them sit
    at a near-tie of the reference's (gap below 2^-7 of the k-th
    probability); the other tokens' outputs within atol 5e-2 (no drops
    here, so a token's route moves no other token)."""
    rcfg, rp, cfg, params = _ffn_pair(arch, compute="bfloat16")
    T = 256
    x, xt, xj = _x(T, cfg.d_model, seed=4, dtype="bfloat16")
    K = cfg.moe.top_k
    C = moe.capacity(T, cfg.moe)
    got = moe.route(xt, params["router"]["w"], cfg.moe, C)
    rprobs, rtop_e, _, rkeep = _ref_routing(xj, rp["router"]["w"], rcfg.moe,
                                            C)
    assert rkeep.all() and bool(got[5].all())
    differ = (got[2].numpy() != rtop_e).any(1)
    srt = -np.sort(-rprobs, axis=1)
    gap = srt[:, K - 1] - srt[:, K]
    assert (gap[differ] < 2.0 ** -7 * srt[differ, K - 1]).all()
    y, _ = moe.moe_apply(params, xt[None], cfg.moe, cfg.mlp)
    yr, _ = ref_moe.moe_apply(rp, xj[None], rcfg.moe, rcfg.mlp)
    diff = np.abs(y[0].float().numpy() - np.asarray(yr[0], np.float32))
    assert diff[~differ].max() <= 5e-2


# ---------------------------------------------------------------------------
# the split LM
# ---------------------------------------------------------------------------

def _pair(arch, compute="float32"):
    cfg, rcfg = _mcfgs(arch, compute)
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, rp, SplitModel(cfg), from_reference(
        jax.tree.map(np.asarray, rp))



@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, compute):
    """Logits of 2 rows of 64 tokens (f32 rel 1e-4, bf16 atol 5e-2) and
    the aux (the heads' summed over owners plus the trunk's): rel 1e-5
    in f32, 2e-2 in bf16."""
    ref, rp, ours, params = _pair(arch, compute)
    toks = _tokens(2, 64, ours.cfg.vocab)
    want, raux = ref.forward(rp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = ours.forward(params, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    if compute == "float32":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= 5e-2, err
    assert aux.dtype == torch.float32 and float(raux) > 0
    np.testing.assert_allclose(float(aux), float(raux),
                               rtol=1e-5 if compute == "float32" else 2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """f32: prefill 2 contexts of 96 (mixtral's owner slices and the
    trunk past its window of 64) and 4 greedy decode steps
    (``test_torch_lm.prefill_and_decode_match``: logits within rel 1e-4
    at every step, the same tokens, every cache leaf)."""
    prefill_and_decode_match(*_pair(arch), "float32", 96, n_new=5, seed=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The recurrent-decode invariant (the reference's
    ``tests/test_recurrent_decode.py``) on the MoE configs, in the port
    (``test_torch_lm.decode_matches_full_forward``, f32, contexts of
    32)."""
    decode_matches_full_forward(get_config(arch, reduced=True).replace(
        compute_dtype="float32"), S=32, seed=2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def druns():
    """The reference's joint and split fits of reduced deepseek-moe-16b
    (f32)."""
    cfg, rcfg = _mcfgs(DEEPSEEK)
    return reference_runs(cfg, rcfg, tokens(cfg.vocab))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn`` (ce + aux) and every gradient leaf, the router's
    included, against the reference's ``jax.value_and_grad`` in f32
    (``test_torch_lm_train.loss_and_grads_match``: the aux within rel
    1e-5, every leaf within 1e-3 of its largest magnitude)."""
    loss_and_grads_match(*_mcfgs(arch), "float32")


def test_joint_fit_matches_reference(druns):
    """3 Adam steps jointly: loss and aux trails and the eval within rel
    1e-4 of the reference's."""
    _, h = _fit(druns["cfg"], druns["toks"], druns["p0"])
    want = druns["joint"]
    np.testing.assert_allclose(h["loss_trail"], want["loss"], rtol=1e-4)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(h["eval"][-1][k], want["eval"][k],
                                   rtol=1e-4)
    assert want["eval"]["aux"] > 0


def test_split_fit_and_owner_aux_match_reference(druns):
    """Split lossless over the queue: the same cut bytes per owner as the
    reference's split fit (each cut frame carries the owner's 4-byte
    aux); step 0's loss and aux (the trunk's plus the owners' from the
    wire) within rel 1e-5 of the joint path's heads + trunk at the same
    params and batch, the port's and the reference's joint alike.

    The reference's own split fit parts from its joint fit at step 0
    already: its owners' warmup (``repro/federation/parties.py``,
    ``_warmup``) applies the update of a zero cut gradient, which it
    means as a no-op, but the head backward also seeds the owner's aux
    with 1, so with an MoE head the warmup moves the owners one Adam
    step on the warmup batch.  The port's warmup drops that update (its
    params stay bitwise the built ones), so the port's split fit is held
    to the joint path at step 0 and to the owner-clipped oracle bit for
    bit (below), not to the reference's split trail."""
    s, h = _fit(druns["cfg"], druns["toks"], druns["p0"], mode="split")
    want = druns["split"]
    for name, o in s.transport_stats["per_owner"].items():
        ro = want["ts"]["per_owner"][name]
        for k in ("cut_payload_bytes", "grad_payload_bytes"):
            assert o[k] == ro[k], k
    _, hj = _fit(druns["cfg"], druns["toks"], druns["p0"])
    aux = [float(r["aux"]) for r in h["train"]]
    for joint in (hj["train"][0], {"loss": druns["joint"]["loss"][0],
                                   "aux": druns["joint"]["aux"][0]}):
        np.testing.assert_allclose(h["loss_trail"][0], float(joint["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(aux[0], float(joint["aux"]), rtol=1e-5)
    assert all(a > 0 for a in aux)
    # the reference's warmup fault: its split step 0 is not its joint's
    assert abs(want["loss"][0] - druns["joint"]["loss"][0]) > 1e-4


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("kw", [dict(), dict(schedule="sequential")],
                         ids=["pipelined", "sequential"])
def test_split_equals_owner_clipped_oracle(compute, kw):
    """Split lossless == the per-owner-clipped joint oracle, bit for bit
    (``test_torch_lm_train.split_equals_oracle``), the owners' balance
    loss differentiated on each owner."""
    cfg, _ = _mcfgs(DEEPSEEK, compute)
    split_equals_oracle(cfg, tokens(cfg.vocab), **kw)


def test_owner_kernel_sources_and_template():
    """An MoE head runs attention: the attention kernels' sources.  A
    spawned owner's template at full width (2 layers) has the real
    head's structure at reduced widths: the router and the stacked
    experts, deepseek's shared experts too."""
    from repro_torch.kernels import block_attention
    for arch in ARCHS:
        ad = build_adapter(get_config(arch).replace(n_layers=2))
        assert ad.owner_kernel_sources() == \
            tuple(block_attention.ops.SOURCES.values())
        ffn = ad.owner_template(0)["blocks"]["units"]["b0"]["ffn"]
        assert ffn["w_in"].shape[:2] == (1, 4)
        assert ("shared" in ffn) == (arch == DEEPSEEK)


def test_train_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch deepseek-moe-16b
    --reduced --device cpu``: the reference's lines, a nonzero aux."""
    from repro_torch.launch.train import main
    loss = main(["--arch", DEEPSEEK, "--reduced", "--steps", "3", "--batch",
                 "4", "--seq", "32", "--log-every", "1", "--device", "cpu"])
    assert np.isfinite(loss)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={DEEPSEEK} reduced=True params=")
    for i, ln in enumerate(lines[1:]):
        step, t, aux = ln.split()[:3]
        assert (step, t) == ("step", str(i))
        assert aux.startswith("aux=") and float(aux[4:]) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(eng, ctxs, mixed, monkeypatch):
    """The engine's tokens and stats, and the choices every routed group
    of the run dropped (``moe.route`` wrapped for the run)."""
    keeps, route = [], moe.route

    def counted(*a):
        r = route(*a)
        keeps.append(r[5])
        return r
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
    monkeypatch.setattr(moe, "route", counted)
    out = eng.run()
    monkeypatch.setattr(moe, "route", route)
    eng.close()
    return [out[r].generated for r in rids], dict(eng.stats), sum(
        int((~k).sum()) for k in keeps)


@pytest.mark.parametrize("factor", [1.25, 2.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("transport,compression", [(None, None),
                                                   ("queue", "int8")])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference_engines(arch, transport, compression,
                                         factor, monkeypatch):
    """The wave and continuous engines (f32, 2 slots, contexts of 48,
    mixed max_new) against the reference's: the same tokens, ticks,
    refills and cut bytes.  Capacity is per call (each prefill's B·S_p
    or B·S tokens, each tick's B), so a refill's filler rows can push a
    live row's choice past it: at the configs' capacity factor 1.25
    choices are dropped here, so continuous is held to the reference's
    continuous engine and not to the wave; at factor 2.0 (capacity =
    every token: nothing can drop) continuous == wave bitwise."""
    cfg, rcfg = _mcfgs(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=factor))
    rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe,
                                                capacity_factor=factor))
    ref, ours = RefSplitModel(rcfg), SplitModel(cfg)
    rp = ref.init(jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, rp))
    mixed = [2, 5, 1, 4, 3]
    rng = np.random.default_rng(4)
    ctxs = [rng.integers(0, ours.cfg.vocab, 48) for _ in mixed]
    runs = {}
    for sched in ("wave", "continuous"):
        kw = dict(batch_slots=2, ctx_len=48, max_new=5, scheduler=sched,
                  transport=transport, compression=compression)
        got, gs, drops = _serve(ServingEngine(ours, params, device="cpu",
                                              **kw), ctxs, mixed, monkeypatch)
        r_eng = RefServingEngine(ref, rp, **kw)
        rids = [r_eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
        r_out = r_eng.run()
        r_eng.close()
        assert got == [r_out[r].generated for r in rids], sched
        for k in ("ticks", "slot_refills", "prefill_calls", "requests",
                  "tokens_generated", "cut_payload_bytes", "cut_wire_bytes",
                  "cut_messages", "waves"):
            assert gs[k] == r_eng.stats[k], (sched, k)
        runs[sched] = (got, drops)
    if factor == 2.0:
        assert runs["wave"][1] == runs["continuous"][1] == 0
        assert runs["wave"][0] == runs["continuous"][0]
    else:
        assert runs["wave"][1] > 0 and runs["continuous"][1] > 0


def test_serve_launcher_on_cpu():
    """``python -m repro_torch.launch.serve --arch mixtral-8x7b
    --reduced --device cpu`` serves its requests."""
    from repro_torch.launch.serve import main
    toks = main(["--arch", MIXTRAL, "--reduced", "--device", "cpu",
                 "--batch", "2", "--ctx", "32", "--new", "3"])
    assert toks.shape == (2, 3)
