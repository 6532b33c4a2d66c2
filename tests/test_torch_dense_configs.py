"""The last two dense configs, llama3-405b (GQA 128/8, SwiGLU, RMSNorm,
rope theta 500k) and nemotron-4-15b (GQA 48/8, LayerNorm, squared-ReLU
MLP), in the port against the JAX reference, on the CPU: each config
field for field (full and reduced), the reduced split LM's logits, its
prefill and decode, and the recurrent-decode invariant.

The models are the reduced configs (d_model 256, 4 heads of 64 sharing
4 KV heads, vocab 512: the reference's ``reduced()``) at 4 layers:
three head units per owner and one trunk unit, llama3.2-3b's depth in
``test_torch_lm.py``.  Params come from the reference's init
(``weights.from_reference``).  Logits are held as ``test_torch_lm.py``
holds them: f32 within rel 1e-4 of the largest, bf16 within atol 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.federation.registry import build_adapter
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference

from test_torch_lm import (_check, _tokens, decode_matches_full_forward,
                           prefill_and_decode_match)

torch.set_num_threads(1)

ARCHS = ["llama3-405b", "nemotron-4-15b"]
COMPUTE = ["float32", "bfloat16"]
N_LAYERS = 4


def _pair(arch, compute):
    kw = dict(n_layers=N_LAYERS, compute_dtype=compute)
    rcfg = ref_get_config(arch, reduced=True).replace(**kw)
    ref = RefSplitModel(rcfg)
    rp = ref.init(jax.random.PRNGKey(0))
    ours = SplitModel(get_config(arch, reduced=True).replace(**kw))
    return ref, rp, ours, from_reference(jax.tree.map(np.asarray, rp))



@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced=reduced)) == \
            dataclasses.asdict(ref_get_config(arch, reduced=reduced))
    cfg = get_config(arch)
    want = {"llama3-405b": (16384, 128, 8, 128, 126, 31, "rmsnorm",
                            "swiglu"),
            "nemotron-4-15b": (6144, 48, 8, 128, 32, 8, "layernorm",
                               "relu2")}[arch]
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.n_layers, cfg.split.cut_layer, cfg.norm, cfg.mlp) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_split_geometry_matches_reference(arch):
    """Head and trunk units as the reference splits them, at the full
    depth and at the cut depths the card runs."""
    for n_layers in (get_config(arch).n_layers, 2, 4):
        cfg = get_config(arch).replace(n_layers=n_layers)
        ref = RefSplitModel(ref_get_config(arch).replace(n_layers=n_layers))
        ours = SplitModel(cfg)
        assert (ours.n_head_units, ours.n_trunk_units) == \
            (ref.n_head_units, ref.n_trunk_units)


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, compute):
    ref, rp, ours, params = _pair(arch, compute)
    toks = _tokens(2, 64, ours.cfg.vocab)
    want, raux = ref.forward(rp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = ours.forward(params, {"tokens": torch.from_numpy(toks)})
    _check(got, want, compute)
    assert float(aux) == float(raux) == 0.0


@pytest.mark.parametrize("compute", COMPUTE)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, compute):
    """Prefill 2 contexts of 64 and 3 greedy decode steps
    (``test_torch_lm.prefill_and_decode_match``)."""
    prefill_and_decode_match(*_pair(arch, compute), compute, 64, seed=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The recurrent-decode invariant (the reference's
    ``tests/test_recurrent_decode.py`` runs it on nemotron-4-15b) in the
    port (``test_torch_lm.decode_matches_full_forward``, f32)."""
    decode_matches_full_forward(get_config(arch, reduced=True).replace(
        n_layers=N_LAYERS, compute_dtype="float32"), seed=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_owner_template_at_full_width(arch):
    """A spawned owner's template at full width holds the reduced head's
    numbers with the real head's structure (the real head holds
    billions)."""
    cfg = get_config(arch).replace(n_layers=4).with_split(cut_layer=1)
    tpl = build_adapter(cfg).owner_template(0)
    assert sum(t.numel() for t in tree_leaves(tpl)) < 10_000_000
    assert set(tpl) == {"blocks", "embed"}
