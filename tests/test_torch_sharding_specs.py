"""The port's sharding specs and meshes against the JAX reference, on
the CPU (no devices: both packages build the production meshes
abstractly).

Every leaf of ``param_specs``, the optimizer-state specs
(``_opt_specs``), ``batch_specs`` and ``cache_specs`` equals the
reference's ``PartitionSpec``, for the ten architectures at full size,
the four ``SHAPES``, the (16, 16) and (2, 16, 16) meshes, and rules
that vary ``fsdp`` (llama3-405b and qwen2-vl-72b set
``zero_sharding``), ``trunk_dp_over_pod``, and, for the caches,
``ring_cache`` and ``cache_dtype``.  The reference's trees are
``jax.eval_shape`` structures, the port's ``meta`` tensors.  The
activation specs (``activation_spec``) equal what the reference's
``constrain`` hands ``with_sharding_constraint``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models.model import SplitModel as RefSplitModel
from repro.sharding import specs as ref_specs
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import SplitModel
from repro_torch.sharding import specs
from repro_torch.sharding.specs import PartitionSpec, spec_leaves

FP8 = torch.float8_e4m3fn
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return specs.abstract_mesh(sizes, names), ref_specs.abstract_mesh(
        sizes, names)


def _rules(cfg, ref_cfg, mesh, ref_mesh, fsdp, dp_over_pod):
    """Both packages' rules: ``make_rules`` (fsdp from the config's
    ``zero_sharding``), with ``fsdp`` flipped when asked."""
    ours = specs.make_rules(mesh, cfg, trunk_dp_over_pod=dp_over_pod)
    ref = ref_specs.make_rules(ref_mesh, ref_cfg,
                               trunk_dp_over_pod=dp_over_pod)
    if fsdp is not None:
        ours = dataclasses.replace(ours, fsdp=fsdp)
        ref = dataclasses.replace(ref, fsdp=fsdp)
    assert ours.owner_axis == ref.owner_axis
    assert ours.trunk_batch == ref.trunk_batch
    return ours, ref


def _variants(cfg):
    """(mesh name, fsdp override, trunk_dp_over_pod): both meshes, fsdp
    as the config sets it and flipped, the trunk over the pod axis or
    not."""
    return [(m, fsdp, dp) for m in MESHES
            for fsdp in (None, not cfg.zero_sharding)
            for dp in (False, True)]


def _ref_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]


def _same(got, want, what):
    got = spec_leaves(got)
    assert all(isinstance(s, PartitionSpec) for s in got), what
    assert [tuple(s) for s in got] == _ref_leaves(want), what


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    model, ref = SplitModel(cfg), RefSplitModel(ref_cfg)
    return cfg, ref_cfg, model, ref, model.param_specs(), ref.param_specs()


@pytest.fixture(params=list_archs())
def arch(request):
    return request.param


def test_zero_sharding_archs():
    """The configs that set ``zero_sharding`` (fsdp by default)."""
    assert [a for a in list_archs() if get_config(a).zero_sharding] == \
        [a for a in list_archs() if ref_get_config(a).zero_sharding] == \
        ["llama3-405b", "qwen2-vl-72b"]


def test_param_specs_match_reference(arch):
    """Every param leaf's spec, both meshes, every rule variant (the
    params are the same for every shape)."""
    cfg, ref_cfg, _, _, p, rp = _models(arch)
    for mname, fsdp, dp in _variants(cfg):
        mesh, ref_mesh = _meshes(mname)
        rules, ref_rules = _rules(cfg, ref_cfg, mesh, ref_mesh, fsdp, dp)
        _same(specs.param_specs(p, cfg, mesh, rules),
              ref_specs.param_specs(rp, ref_cfg, ref_mesh, ref_rules),
              (mname, fsdp, dp))


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_opt_specs_match_reference(arch, state_dtype):
    """The clip + Adam state's specs (``_opt_specs``): m and v mirror the
    params, the clip's empty state stays empty; its leaves in the state
    dtype."""
    cfg, ref_cfg, _, _, p, rp = _models(arch)
    ref_dtype = jnp.float32 if state_dtype == torch.float32 \
        else jnp.bfloat16
    opt = steps.make_optimizer(cfg, state_dtype)
    ref_opt = ref_steps.make_optimizer(ref_cfg, ref_dtype)
    state = opt.init(p)
    assert {t.dtype for t in spec_leaves(state)} == {state_dtype}
    assert [tuple(t.shape) for t in spec_leaves(state)] == [
        tuple(a.shape) for a in jax.tree.leaves(jax.eval_shape(
            ref_opt.init, rp))]
    for mname, fsdp, dp in _variants(cfg):
        mesh, ref_mesh = _meshes(mname)
        rules, ref_rules = _rules(cfg, ref_cfg, mesh, ref_mesh, fsdp, dp)
        ref_p_spec = ref_specs.param_specs(rp, ref_cfg, ref_mesh, ref_rules)
        _same(steps._opt_specs(opt, p, cfg, mesh, rules),
              ref_steps._opt_specs(ref_opt, rp, ref_p_spec, ref_cfg,
                                   ref_mesh, ref_rules), (mname, fsdp, dp))


def test_batch_specs_match_reference(arch):
    """A batch's specs for every shape, with and without labels, and the
    decode step's token; the text archs also with 3 owners (an owner
    dim the pod axis does not divide)."""
    pairs = [(get_config(arch), ref_get_config(arch))]
    if pairs[0][0].modality == "text":
        pairs.append(tuple(c.with_split(n_owners=3) for c in pairs[0]))
    for cfg, ref_cfg in pairs:
        _batch_specs_match(cfg, ref_cfg)


def _batch_specs_match(cfg, ref_cfg):
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        for labels in (False, True):
            b = steps.batch_structs(cfg, shape, labels)
            rb = ref_steps.batch_structs(ref_cfg, ref_shape, labels)
            assert [(tuple(t.shape), t.dtype) for t in spec_leaves(b)] == [
                (tuple(a.shape), getattr(torch, str(a.dtype)))
                for a in jax.tree.leaves(rb)]
            for mname, fsdp, dp in _variants(cfg):
                mesh, ref_mesh = _meshes(mname)
                rules, ref_rules = _rules(cfg, ref_cfg, mesh, ref_mesh,
                                          fsdp, dp)
                _same(specs.batch_specs(b, cfg, mesh, rules),
                      ref_specs.batch_specs(rb, ref_cfg, ref_mesh,
                                            ref_rules), (name, mname))
                t = steps.struct((shape.global_batch, 1), torch.int32)
                rt = jax.ShapeDtypeStruct((shape.global_batch, 1),
                                          jnp.int32)
                _same(specs.batch_specs({"token": t}, cfg, mesh, rules),
                      ref_specs.batch_specs({"token": rt}, ref_cfg,
                                            ref_mesh, ref_rules),
                      (name, mname, "token"))


def test_cache_specs_match_reference(arch):
    """The decode caches' specs at every shape's batch and length (the
    long_500k window as ``swa_override`` where the builders set it), full
    and ring, in the compute dtype and fp8."""
    cfg, ref_cfg, model, ref, _, _ = _models(arch)
    for name, shape in SHAPES.items():
        swa = steps.swa_for(cfg, shape) or 0
        assert swa == (ref_steps.swa_for(ref_cfg, REF_SHAPES[name]) or 0)
        B, S = shape.global_batch, shape.seq_len
        for ring in (False, True):
            for fp8 in (False, True):
                c = model.cache_init(B, S, 8, device="meta", ring=ring,
                                     swa_override=swa,
                                     cache_dtype=FP8 if fp8 else None)
                rc = jax.eval_shape(functools.partial(
                    ref.cache_init, B, S, 8, ring=ring, swa_override=swa,
                    cache_dtype=jnp.float8_e4m3fn if fp8 else None))
                for mname, fsdp, dp in _variants(cfg):
                    mesh, ref_mesh = _meshes(mname)
                    rules, ref_rules = _rules(cfg, ref_cfg, mesh, ref_mesh,
                                              fsdp, dp)
                    _same(specs.cache_specs(c, cfg, mesh, rules),
                          ref_specs.cache_specs(rc, ref_cfg, ref_mesh,
                                                ref_rules),
                          (name, ring, fp8, mname, fsdp, dp))


def test_long_500k_full_cache_is_replicated_and_ring_is_sharded():
    """The reference's quirk, kept: ``cache_init``'s 8 extra slots make
    the full long_500k caches (524296 and 262152 slots) indivisible by 16
    and 256, so on the 16x16 mesh they are replicated; the ring caches
    (8192 slots) are context-parallel over ("data", "model")."""
    cfg = get_config("llama3.2-3b")
    mesh = make_production_mesh()
    rules = specs.make_rules(mesh, cfg)
    for ring, want in ((False, (None,) * 5), (True, (
            None, None, ("data", "model"), None, None))):
        _, args, sp, _ = steps.build(cfg, SHAPES["long_500k"], mesh,
                                     ring_cache=ring)
        k = args[1]["trunk"]["b0"]["k"]
        assert k.shape[2] == (8192 if ring else 524296)
        assert tuple(sp[1]["trunk"]["b0"]["k"]) == want
        assert tuple(sp[1]["heads"]["b0"]["k"])[0] is None
        assert specs.cache_specs(args[1], cfg, mesh, rules) == sp[1]


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

ACT_SHAPES = {"cut_stacked": [(2, 32, 16, 64), (2, 3, 16, 64)],
              "combined": [(32, 64, 64), (3, 64, 64)],
              "trunk_hidden": [(32, 64, 3072), (6, 64, 3072)],
              "logits": [(32, 64, 128256), (32, 64, 51865)],
              "moe_buffer": [(64, 32, 2048), (8, 20, 4096)],
              "moe_buffer_grouped": [(32, 64, 8, 16), (4, 8, 8, 16)],
              "unknown": [(4, 4)]}


@pytest.mark.parametrize("mname", list(MESHES))
def test_activation_specs_match_reference(mname, monkeypatch):
    """``activation_spec`` equals the spec the reference's ``constrain``
    gives ``with_sharding_constraint`` (captured), for every name it
    knows (and none for one it does not), shapes that divide the mesh
    and shapes that do not, the trunk over the pod axis or not."""
    seen = []
    monkeypatch.setattr(ref_specs.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    mesh, ref_mesh = _meshes(mname)
    cfg, ref_cfg = get_config("llama3.2-3b"), ref_get_config("llama3.2-3b")
    for dp in (False, True):
        rules, ref_rules = _rules(cfg, ref_cfg, mesh, ref_mesh, None, dp)
        for name, shapes in ACT_SHAPES.items():
            for shape in shapes:
                seen.clear()
                with ref_specs.sharding_context(ref_mesh, ref_rules):
                    ref_specs.constrain(jax.ShapeDtypeStruct(
                        shape, jnp.float32), name)
                got = specs.activation_spec(name, shape, mesh, rules)
                assert (None if got is None else tuple(got)) == \
                    (seen[0] if seen else None), (name, shape, dp)


def test_constrain_runs_on_one_device_only():
    """No context and a one-device mesh: the input itself.  An abstract
    mesh or a mesh of several devices: ``ValueError`` (the model's
    steps run on one device)."""
    x = torch.ones(2, 3)
    cfg = get_config("llama3.2-3b")
    assert specs.constrain(x, "logits") is x
    one = make_host_mesh(device="cpu")
    with specs.sharding_context(one, specs.make_rules(one, cfg)):
        assert specs.constrain(x, "logits") is x
    two = specs.Mesh((2, 1), ("data", "model"), (torch.device("cpu"),) * 2)
    for mesh in (make_production_mesh(), two):
        with specs.sharding_context(mesh, specs.make_rules(mesh, cfg)):
            with pytest.raises(ValueError):
                specs.constrain(x, "logits")
    assert specs.constrain(x, "logits") is x      # the context is gone


def test_named_gives_one_placement_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    got = specs.named(mesh, {"a": PartitionSpec("pod", None, "model"),
                             "b": [PartitionSpec(None, ("data", "model"))],
                             "c": PartitionSpec()})
    assert got["a"] == (Shard(0), Replicate(), Shard(2))
    assert got["b"][0] == (Replicate(), Shard(1), Shard(1))
    assert got["c"] == (Replicate(),) * 3


def test_meshes():
    """The production meshes are the reference's, abstract; a host mesh
    spans the devices there are and refuses sizes that need more."""
    for multi, (sizes, names) in ((False, MESHES["16x16"]),
                                  (True, MESHES["2x16x16"])):
        m = make_production_mesh(multi_pod=multi)
        ref = ref_specs.abstract_mesh(sizes, names)
        assert m.abstract and m.axis_names == tuple(ref.axis_names)
        assert m.shape == dict(ref.shape)
        assert m.device_count == (512 if multi else 256)
    host = make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),) and not host.abstract
    assert make_host_mesh(pod=1, device="cpu").axis_names == (
        "pod", "data", "model")
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_host_mesh(data=2, device="cpu")
