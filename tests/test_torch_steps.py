"""The port's step builders (``repro_torch.launch.steps``) against the
JAX reference's (``repro.launch.steps``), on the CPU.

* Structs: each builder's ``args`` (``meta`` tensors) have the
  reference's shapes and dtypes, and its specs are the spec functions'
  of those args, for the ten architectures at full size and the four
  ``SHAPES`` (the decode shapes full and ring, compute dtype and fp8).
* Sizes: ``ArchConfig.param_count`` equals the reference's, full and
  reduced, ``active_only`` both ways.
* Step parity: the port's step functions against the reference's own
  ``steps.build(...)`` functions, jitted on a (1, 1) mesh with ``Auto``
  axes (jax 0.9's ``jax.make_mesh`` defaults to ``Explicit`` axes, on
  which the reference's sharding constraints fail: the cause of its
  failing ``test_perf_levers.py::
  test_microbatch_accumulation_matches_single_batch`` and
  ``test_sharding_dryrun.py`` cases, which these tests do not rely on).
  Reduced llama3.2-3b (3 layers, the cut after one), params from the
  reference's (``weights.from_reference``), every input from a numpy
  seed: the train step with 1 and 4 microbatches (loss f32 rel 1e-5;
  params after the step within atol 5e-5 but where Adam met a gradient
  at f32 rounding level, the rule of ``test_torch_lm_train.py``'s
  joint fit), prefill and decode (f32 rel 1e-4, bf16 atol 5e-2, as in
  ``test_torch_lm.py``), the decode step on ring and fp8 caches (seeded
  byte for byte on both sides) at a long_500k-named shape, which turns
  on the sliding window; and one decode step of reduced zamba2-2.7b.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models.model import SplitModel as RefSplitModel
from repro.sharding import specs as ref_specs
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.sharding import specs
from repro_torch.sharding.specs import spec_leaves
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference

torch.set_num_threads(1)

LLAMA, ZAMBA = "llama3.2-3b", "zamba2-2.7b"
FP8 = torch.float8_e4m3fn


def _sd(t):
    """(shape, dtype name) of a port tensor or a reference struct."""
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Structs and sizes
# ---------------------------------------------------------------------------


def _variants(shape):
    """The builder options a shape takes: decode caches full and ring,
    in the compute dtype and fp8."""
    if shape.kind != "decode":
        return [{}]
    return [dict(ring_cache=r, cache_dtype=c) for r in (False, True)
            for c in (None, FP8)]


@pytest.mark.parametrize("arch", list_archs())
def test_builder_args_and_specs_match_reference(arch):
    """Every builder's args: the reference's shapes and dtypes leaf for
    leaf, all ``meta``; its specs: the reference builder's, and the spec
    functions' of its own args; the donated positions the reference's."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    mesh = make_production_mesh()
    ref_mesh = ref_specs.abstract_mesh((16, 16), ("data", "model"))
    for name, shape in SHAPES.items():
        for kw in _variants(shape):
            ref_kw = dict(kw)
            if kw.get("cache_dtype") is not None:
                ref_kw["cache_dtype"] = jnp.float8_e4m3fn
            _, args, sp, donate = steps.build(cfg, shape, mesh, **kw)
            _, rargs, rsp, rdonate = ref_steps.build(
                ref_cfg, REF_SHAPES[name], ref_mesh, **ref_kw)
            assert donate == rdonate
            leaves = spec_leaves(args)
            assert {t.device.type for t in leaves} == {"meta"}
            assert [_sd(t) for t in leaves] == [
                _sd(a) for a in jax.tree.leaves(rargs)], (name, kw)
            got = [tuple(s) for s in spec_leaves(
                [s for s in sp if s is not None])]
            want = [tuple(s) for s in jax.tree.leaves(
                [s for s in rsp if s is not None],
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]
            assert got == want, (name, kw)
            rules = specs.make_rules(mesh, cfg)
            assert sp[0] == specs.param_specs(args[0], cfg, mesh, rules)
            if shape.kind == "decode":
                assert sp[1] == specs.cache_specs(args[1], cfg, mesh, rules)


def test_param_count_matches_reference():
    for arch in list_archs():
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            ref = ref_get_config(arch, reduced=reduced)
            for active in (False, True):
                assert cfg.param_count(active) == ref.param_count(active)
    moe = get_config("deepseek-moe-16b")
    assert moe.param_count(True) < moe.param_count()


def test_shapes_and_swa_match_reference():
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in
            SHAPES.items()} == {k: (s.seq_len, s.global_batch, s.kind)
                                for k, s in REF_SHAPES.items()}
    for arch in list_archs():
        cfg, ref = get_config(arch), ref_get_config(arch)
        for name, shape in SHAPES.items():
            assert steps.swa_for(cfg, shape) == ref_steps.swa_for(
                ref, REF_SHAPES[name])
            assert steps.shape_supported(cfg, shape) == \
                ref_steps.shape_supported(ref, REF_SHAPES[name])


def test_materialize_draws_every_piece(monkeypatch):
    """Floats N(0, 1) on the generator's device, drawn piece by piece (at
    most ``_DRAW_ELEMENTS`` at once) in order; ints zeros, drawing
    nothing; ``None`` subtrees stay ``None``."""
    monkeypatch.setattr(steps, "_DRAW_ELEMENTS", 8)
    tree = {"a": steps.struct((3, 4, 5), torch.bfloat16), "none": None,
            "t": (steps.struct((2, 3), torch.int32),)}
    gen = torch.Generator().manual_seed(1)
    got = steps.materialize(tree, gen, "cpu")
    g = torch.Generator().manual_seed(1)
    want = torch.stack([torch.randn((5,), generator=g) for _ in range(12)])
    assert torch.equal(got["a"], want.reshape(3, 4, 5).to(torch.bfloat16))
    assert got["none"] is None and got["t"][0].dtype == torch.int32
    assert torch.equal(got["t"][0], torch.zeros((2, 3), dtype=torch.int32))
    assert torch.equal(gen.get_state(), g.get_state())


def test_steps_refuse_an_abstract_mesh_before_touching_inputs():
    cfg = get_config(LLAMA, reduced=True)
    fn, args, _, _ = steps.build(cfg, ShapeConfig("d", 64, 2, "decode"),
                                 make_production_mesh())
    caches = steps.materialize(args[1], torch.Generator().manual_seed(0),
                               "cpu")
    before = tree_map(torch.clone, caches)
    params = steps.materialize(args[0], torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="abstract mesh"):
        fn(params, caches, torch.zeros((2, 1), dtype=torch.int32), 64, 32)
    for a, b in zip(tree_leaves(caches), tree_leaves(before)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Step parity through the reference's own builders
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@functools.lru_cache(maxsize=None)
def _setup(arch, compute, n_layers):
    """(port config, reference config, reference params, port params)."""
    kw = dict(n_layers=n_layers, compute_dtype=compute)
    cfg = get_config(arch, reduced=True).replace(**kw).with_split(
        cut_layer=1)
    ref_cfg = ref_get_config(arch, reduced=True).replace(**kw).with_split(
        cut_layer=1)
    rp = RefSplitModel(ref_cfg).init(jax.random.PRNGKey(0))
    return cfg, ref_cfg, rp, from_reference(jax.tree.map(np.asarray, rp))


def _builds(cfg, ref_cfg, shape, **kw):
    ref_kw = dict(kw)
    if kw.get("cache_dtype") is not None:
        ref_kw["cache_dtype"] = jnp.float8_e4m3fn
    fn, args, _, _ = steps.build(cfg, shape, make_host_mesh(device="cpu"),
                                 **kw)
    rfn, rargs, _, _ = ref_steps.build(
        ref_cfg, RefShapeConfig(shape.name, shape.seq_len,
                                shape.global_batch, shape.kind),
        _ref_mesh(), **ref_kw)
    return fn, args, jax.jit(rfn), rargs


_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
_VIEW = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16),
         4: (np.float32, torch.float32)}


def _seeded(struct, rng, scale=1.0):
    """One float leaf's values from numpy, in its dtype, byte for byte
    the same in both packages: (port tensor, reference array)."""
    a = (rng.normal(size=tuple(struct.shape)) * scale).astype(np.float32)
    a = a.astype(_NP[str(struct.dtype).replace("torch.", "")])
    npv, tv = _VIEW[a.itemsize]
    t = torch.from_numpy(a.view(npv).copy()).view(tv).view(struct.dtype)
    return t, jnp.asarray(a)


def _seeded_tree(structs, seed):
    rng = np.random.default_rng(seed)
    pairs = [_seeded(s, rng) for s in spec_leaves(structs)]
    from repro_torch.tree import tree_unflatten
    return tree_unflatten(structs, [p[0] for p in pairs]), [
        p[1] for p in pairs]


def _close(got, want, compute):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    if compute == "float32":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= 5e-2, err


def _tokens(rng, vocab, shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


def _ref_grads(rcfg, rp, batch):
    model = RefSplitModel(rcfg)
    _, g = jax.value_and_grad(model.loss_fn, has_aux=True)(rp, batch)
    return [np.asarray(x) for x in jax.tree.leaves(g)]


@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches_reference(n_micro):
    """One clip + Adam step of 4 x 32 tokens, whole or in 4
    microbatches: loss within f32 rel 1e-5 (the microbatched step's
    metrics ``{"loss", "aux": 0}`` as the reference's); params after the
    step within atol 5e-5 on all but 1e-4 of each leaf, by at most 2e-3,
    and every element past 5e-5 had a gradient below 2e-6 of its leaf's
    largest (``test_torch_lm_train.py``'s joint-fit rule); the Adam
    state within the same atol."""
    cfg, ref_cfg, rp, params = _setup(LLAMA, "float32", 3)
    shape = ShapeConfig("t", 32, 4, "train")
    fn, args, rfn, _ = _builds(cfg, ref_cfg, shape, n_microbatches=n_micro)
    opt = steps.make_optimizer(cfg)
    ref_opt = ref_steps.make_optimizer(ref_cfg)
    rng = np.random.default_rng(0)
    toks = _tokens(rng, cfg.vocab, (4, 33))
    ot = np.ascontiguousarray(toks[:, :-1].reshape(4, 2, 16).transpose(
        1, 0, 2))
    rbatch = {"owner_tokens": jnp.asarray(ot),
              "labels": jnp.asarray(toks[:, 1:])}
    batch = {"owner_tokens": torch.from_numpy(ot),
             "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    assert [_sd(t) for t in spec_leaves(args[2])] == [
        _sd(a) for a in jax.tree.leaves(rbatch)]
    rnew, rstate, rm = rfn(rp, ref_opt.init(rp), rbatch, 0)
    new, state, m = fn(params, opt.init(params), batch, 0)
    assert sorted(m) == sorted(rm) == ["aux", "loss"]
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(rm["aux"]), atol=0)
    grads = _ref_grads(ref_cfg, rp, rbatch)
    for i, (a, b) in enumerate(zip(tree_leaves(new),
                                   jax.tree.leaves(rnew))):
        d = np.abs(a.numpy() - np.asarray(b))
        if not d.size:
            continue
        assert float((d > 5e-5).mean()) <= 1e-4
        assert float(d.max()) <= 2e-3
        g = np.abs(grads[i])
        assert (g[d > 5e-5] / g.max() < 2e-6).all(), i
    for a, b in zip(tree_leaves(state), jax.tree.leaves(rstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5)


def test_microbatched_loss_is_the_objective_mean():
    """The microbatched step's loss: the mean over microbatches of
    ``loss_fn``'s objective, in the reference within 1e-4 of one
    batch's (its own test's criterion) and here within 1e-5 of it."""
    cfg, _, _, params = _setup(LLAMA, "float32", 3)
    mesh = make_host_mesh(device="cpu")
    shape = ShapeConfig("t", 32, 4, "train")
    toks = _tokens(np.random.default_rng(0), cfg.vocab, (4, 33))
    batch = {"owner_tokens": torch.from_numpy(np.ascontiguousarray(
        toks[:, :-1].reshape(4, 2, 16).transpose(1, 0, 2))),
        "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    opt = steps.make_optimizer(cfg)
    losses = {}
    for nm in (1, 4):
        fn, *_ = steps.build(cfg, shape, mesh, n_microbatches=nm)
        losses[nm] = float(fn(params, opt.init(params), batch, 0)[2]["loss"])
    assert losses[1] == pytest.approx(losses[4], rel=1e-5)


def test_opt_state_dtype_gives_bf16_state():
    cfg, _, _, params = _setup(LLAMA, "float32", 3)
    fn, args, _, _ = steps.build(cfg, ShapeConfig("t", 32, 4, "train"),
                                 make_host_mesh(device="cpu"),
                                 opt_state_dtype=torch.bfloat16)
    assert {t.dtype for t in spec_leaves(args[1])} == {torch.bfloat16}
    toks = _tokens(np.random.default_rng(0), cfg.vocab, (4, 33))
    batch = {"owner_tokens": torch.from_numpy(np.ascontiguousarray(
        toks[:, :-1].reshape(4, 2, 16).transpose(1, 0, 2))),
        "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    state = steps.make_optimizer(cfg, torch.bfloat16).init(params)
    _, state, m = fn(params, state, batch, 0)
    assert {t.dtype for t in tree_leaves(state)} == {torch.bfloat16}
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_step_matches_reference(compute):
    """The prefill step on zero caches: the last-token logits at the
    tolerances of ``test_torch_lm.py``, and (f32, as there) every cache
    leaf."""
    cfg, ref_cfg, rp, params = _setup(LLAMA, compute, 3)
    fn, args, rfn, rargs = _builds(cfg, ref_cfg,
                                   ShapeConfig("p", 64, 2, "prefill"))
    ot = _tokens(np.random.default_rng(1), cfg.vocab, (2, 2, 32))
    caches = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                      args[2])
    rcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), rargs[2])
    rl, rc = rfn(rp, {"owner_tokens": jnp.asarray(ot)}, rcaches)
    logits, caches = fn(params, {"owner_tokens": torch.from_numpy(ot)},
                        caches)
    _close(logits, rl, compute)
    if compute == "float32":
        for a, b in zip(tree_leaves(caches), jax.tree.leaves(rc)):
            _close(a, b, compute)


# (shape name, ring, fp8): the plain decode shape, and a long_500k-named
# shape (the architectures' sliding window, 128 reduced) past the window
DECODES = [("decode", False, False), ("long_500k", False, False),
           ("long_500k", True, False), ("long_500k", False, True),
           ("long_500k", True, True)]


def _decode_parity(arch, compute, n_layers, name, ring, fp8, S):
    cfg, ref_cfg, rp, params = _setup(arch, compute, n_layers)
    B = 2
    fn, args, rfn, rargs = _builds(
        cfg, ref_cfg, ShapeConfig(name, S, B, "decode"), ring_cache=ring,
        cache_dtype=FP8 if fp8 else None)
    assert [_sd(t) for t in spec_leaves(args[1])] == [
        _sd(a) for a in jax.tree.leaves(rargs[1])]
    caches, rleaves = _seeded_tree(args[1], 2)
    rcaches = jax.tree.unflatten(jax.tree.structure(rargs[1]), rleaves)
    tok = _tokens(np.random.default_rng(3), cfg.vocab, (B, 1))
    P = cfg.split.n_owners
    rl, rc = rfn(rp, rcaches, jnp.asarray(tok), S, S // P)
    logits, caches = fn(params, caches, torch.from_numpy(tok),
                        torch.tensor(S, dtype=torch.int32), S // P)
    _close(logits, rl, compute)
    if compute == "float32" and not fp8:
        for a, b in zip(tree_leaves(caches), jax.tree.leaves(rc)):
            _close(a, b, compute)
    return args


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,ring,fp8", DECODES)
def test_decode_step_matches_reference(name, ring, fp8, compute):
    """One decode step over seeded caches of 256 positions (the first
    new token at 256): full caches, ring caches trimmed to the window,
    fp8 caches (their bytes the same on both sides); logits at the LM
    tolerances, and (f32 caches, f32 compute) the caches after the
    step."""
    args = _decode_parity(LLAMA, compute, 3, name, ring, fp8, 256)
    slots = {t.shape[-3] for t in spec_leaves(args[1])}
    assert slots == ({128} if ring else {256 + 8, 128 + 8})


def test_zamba2_decode_step_matches_reference():
    """The builder on the hybrid family: one decode step of reduced
    zamba2-2.7b (2 units, the cut after one), f32, its Mamba2 states and
    KV caches seeded."""
    _decode_parity(ZAMBA, "float32", 12, "decode", False, False, 64)
