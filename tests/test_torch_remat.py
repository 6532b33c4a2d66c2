"""Rematerialisation (``cfg.remat``) in the port, on the CPU, against
``remat=False`` and the JAX reference.

With ``cfg.remat`` (every config's default, as in the reference, whose
super-block runs under ``jax.checkpoint``) ``transformer.stack_apply``
runs each unit under non-reentrant ``torch.utils.checkpoint`` while
autograd records and no cache is given.  The recompute runs the same
ops on the same inputs and leaves autograd's graph as it is, so the
loss, the MoE aux and every gradient are bitwise those of
``remat=False`` (zamba2's ``shared_attn``, used by every unit, included:
its gradient accumulates in the same order), while autograd saves fewer
bytes.  Serving (caches, ``inference_mode``) never enters the
checkpoint.

Models: the reduced configs of five families (llama3.2-3b, zamba2-2.7b,
deepseek-moe-16b, xlstm-125m, whisper-tiny) at a depth that gives every
owner's head one unit and the trunk one or two; params from the
reference's init (``weights.from_reference``), inputs from a seed with
numpy.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.data import make_token_dataset
from repro_torch.models import transformer, xlstm
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import from_reference

from test_torch_cuda import lm_owner_clipped_oracle, lm_session
from test_torch_lm_train import BATCH, STEPS, cfgs, reference_runs, tokens

torch.set_num_threads(1)

#: arch -> layers: one head unit per owner, the trunk one or two units
#: (zamba2's two trunk units share its ``shared_attn`` block)
FAMILIES = {"llama3.2-3b": 3, "zamba2-2.7b": 18, "deepseek-moe-16b": 3,
            "xlstm-125m": 4, "whisper-tiny": 2}


def _cfgs(arch, remat=True):
    kw = dict(n_layers=FAMILIES[arch], remat=remat)
    split = {} if arch == "whisper-tiny" else {"cut_layer": 1}
    return (get_config(arch, reduced=True).replace(**kw).with_split(**split),
            ref_get_config(arch, reduced=True).replace(**kw).with_split(
                **split))


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.modality == "audio_text":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, 2 * S, cfg.d_frontend)).astype(np.float32))
    return batch


def _params(rcfg):
    return from_reference(jax.tree.map(
        np.asarray, RefSplitModel(rcfg).init(jax.random.PRNGKey(0))))


class _Checkpoints:
    """Counts the units ``stack_apply`` runs under the checkpoint."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = transformer.checkpoint

        def counted(*a, **kw):
            self.n += 1
            return inner(*a, **kw)
        monkeypatch.setattr(transformer, "checkpoint", counted)


def _step(cfg, params, batch):
    """(loss, aux, every gradient leaf, bytes autograd saved)."""
    model = SplitModel(cfg)
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, metrics = model.loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), metrics["aux"].detach(), grads, sum(saved)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_remat_step_is_bitwise_the_plain_step(arch, monkeypatch):
    """One step's loss, aux and every gradient with ``remat`` on are
    bitwise those with it off, from the same params; every unit ran
    under the checkpoint (and none with it off); autograd saved fewer
    bytes (a unit's activations are kept as its input alone: the
    checkpoint's own hooks take the unit's saved tensors)."""
    cfg, rcfg = _cfgs(arch)
    params, batch = _params(rcfg), _batch(cfg)
    model = SplitModel(cfg)
    units = model.P * model.n_head_units + model.n_trunk_units
    runs = {}
    for remat in (False, True):
        ck = _Checkpoints(monkeypatch)
        runs[remat] = _step(cfg.replace(remat=remat), params, batch)
        assert ck.n == (units if remat else 0)
    (l0, a0, g0, s0), (l1, a1, g1, s1) = runs[False], runs[True]
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    if cfg.moe is not None:
        assert float(a1) > 0.0          # the balance loss came through
    assert len(g0) == len(g1)
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))
    assert s1 < s0


def test_joint_fit_with_remat_matches_reference(monkeypatch):
    """The joint LM fit, ``remat`` on in both packages (reduced llama at
    3 layers in f32, 3 Adam steps of 4): every training forward runs
    each unit under the checkpoint (``STEPS`` x the units; the
    evaluations record no autograd), and the loss trail and evaluation
    are within rel 1e-4 of the reference's, the tolerance of
    ``test_torch_lm_train.test_joint_fit_matches_reference``."""
    cfg, rcfg = cfgs()
    assert cfg.remat and rcfg.remat
    runs = reference_runs(cfg, rcfg, tokens(cfg.vocab))
    model = SplitModel(cfg)
    ck = _Checkpoints(monkeypatch)
    s = lm_session(cfg, runs["toks"], "cpu", runs["p0"])
    h = s.fit(steps=STEPS, batch_size=BATCH, verbose=False, eval_frac=0.25)
    assert ck.n == STEPS * (model.P * model.n_head_units
                            + model.n_trunk_units)
    np.testing.assert_allclose(h["loss_trail"], runs["joint"]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(h["eval"][-1]["loss"],
                               runs["joint"]["eval"]["loss"], rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b"])
def test_split_equals_joint_with_remat(arch, monkeypatch):
    """Split lossless over the queue with ``remat`` on == the
    per-owner-clipped joint oracle, bitwise (params and loss trail).
    The split programs checkpoint each unit of every pass that records
    autograd: per step and in the warmup each owner's head backward
    (its forward recomputed) and the trunk's cut-gradient and
    weight-gradient passes, ``(STEPS + 1) x (P x head + 2 x trunk)``
    units; the owners' first forward and the evaluation record none.
    ``chip_smoke.lm_train_need`` counts the kernels' launches from the
    same units."""
    cfg, _ = _cfgs(arch)
    model = SplitModel(cfg)
    toks = make_token_dataset(16, 32, cfg.vocab, 0)
    first = lm_session(cfg, toks, "cpu")
    p0 = tree_map(torch.clone, first.params)
    trail = lm_owner_clipped_oracle(first, STEPS, BATCH)
    ck = _Checkpoints(monkeypatch)
    s = lm_session(cfg, toks, "cpu", p0)
    h = s.fit(steps=STEPS, batch_size=BATCH, verbose=False, mode="split")
    assert ck.n == (STEPS + 1) * (model.P * model.n_head_units
                                  + 2 * model.n_trunk_units)
    assert h["loss_trail"] == trail
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s.params),
                                                 tree_leaves(first.params)))


def test_serving_never_enters_the_checkpoint(monkeypatch):
    """A served wave (the engine runs under ``inference_mode``) and a
    prefill with caches while autograd records: ``remat`` is on and no
    unit is checkpointed (a cache written in place would be written
    again by a recompute)."""
    cfg, rcfg = _cfgs("llama3.2-3b")
    assert cfg.remat
    ck = _Checkpoints(monkeypatch)
    s = lm_session(cfg, make_token_dataset(8, 32, cfg.vocab, 0), "cpu")
    results, _ = s.serve_dataset(max_new=3, batch_slots=4, n_requests=4)
    assert len(results) == 4
    model = SplitModel(cfg)
    params = tree_map(lambda t: t.detach().requires_grad_(), _params(rcfg))
    toks = torch.from_numpy(make_token_dataset(2, 16, cfg.vocab, 1)[:, :16])
    with torch.enable_grad():
        logits, _ = model.prefill(params, {"tokens": toks},
                                  model.cache_init(2, 16))
    assert logits.requires_grad and ck.n == 0


def test_modal_heads_are_the_owner_loop_on_plain_tensors():
    """qwen2-vl's owner-parallel heads (``owners``, ``owner_cuts``) on
    plain tensors give bitwise the owner-by-owner loop they replaced:
    each owner's head on ``transformer.unit(heads, p)``, the cuts
    stacked when their lengths agree and a list otherwise, the aux
    summed in owner order."""
    cfg = get_config("qwen2-vl-72b", reduced=True).replace(
        n_layers=2, compute_dtype="float32")
    model = SplitModel(cfg)
    heads = model.init(torch.Generator().manual_seed(0))["heads"]
    rng = np.random.default_rng(0)
    for n_patch, n_tok in ((16, 16), (16, 12)):
        inputs = {"patches": torch.from_numpy(rng.normal(
            size=(2, n_patch, cfg.d_frontend)).astype(np.float32)),
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                    (2, n_tok)))}
        cut, _, aux = model.heads_forward(heads, inputs)
        want, want_aux = [], None
        for p, x in enumerate(inputs.values()):
            c, _, a = model._head_one(transformer.unit(heads, p), x,
                                      model._positions(x.shape[1], p),
                                      p)
            want.append(c)
            want_aux = a if want_aux is None else want_aux + a
        if n_patch == n_tok:
            assert torch.equal(cut, torch.stack(want))
        else:
            assert isinstance(cut, list) and all(
                torch.equal(a, b) for a, b in zip(cut, want))
        assert torch.equal(aux, want_aux)


@pytest.mark.parametrize("cached", [False, True])
def test_xlstm_cores_on_plain_tensors_are_unchanged(cached):
    """The mLSTM and sLSTM blocks, their cores now behind ``on_shards``,
    give bitwise the direct calls on plain tensors: ``mlstm_chunked``
    (or ``mlstm_step`` at a decode step) and the sLSTM's cell loop, with
    the same outputs and cache writes, a ragged chunk and a cache
    included."""
    cfg = get_config("xlstm-125m", reduced=True).replace(
        compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    for S in ((1, 5) if cached else (40,)):
        x = torch.from_numpy(rng.normal(size=(2, S, cfg.d_model)).astype(
            np.float32))
        for kind in ("mlstm", "slstm"):
            key, init, cache_init, apply = transformer.RECURRENT[kind]
            params = init(gen, cfg)
            cache = cache_init(2, cfg) if cached else None
            if cached:
                for v in cache.values():
                    v.copy_(torch.from_numpy(rng.normal(
                        size=tuple(v.shape)).astype(np.float32)))
            want_cache = cache and tree_map(torch.clone, cache)
            got, got_cache = apply(params, x, cfg, cache)
            want = _direct(kind, params, x, cfg, want_cache)
            assert torch.equal(got, want)
            if cached:
                assert all(torch.equal(got_cache[k], want_cache[k])
                           for k in cache)


def _direct(kind, params, x, cfg, cache):
    """The block with its core called directly (the code before the
    cores went behind ``on_shards``); ``cache`` updated in place."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    from repro_torch.models.ssm import conv1d_apply
    Bb, S, d = x.shape
    H = cfg.n_heads
    f32 = torch.float32
    if kind == "mlstm":
        d_in, _, D = xlstm._m_dims(cfg)
        xi = layers.dense_apply(params["up_x"], x)
        z = layers.dense_apply(params["up_z"], x)
        xconv, new_conv = conv1d_apply(
            params["conv_w"], xi, None if cache is None else cache["conv"])
        xconv = F.silu(xconv)
        q = layers.dense_apply(params["wq"], xconv).reshape(Bb, S, H, D)
        k = layers.dense_apply(params["wk"], xconv).reshape(Bb, S, H, D)
        v = layers.dense_apply(params["wv"], xi).reshape(Bb, S, H, D)
        gates = layers.dense_apply(params["w_if"], xconv) \
            + layers.cast(params["if_bias"], x.dtype)
        i_raw, f_raw = gates[..., :H], gates[..., H:]
        carry = None if cache is None else (cache["C"], cache["n"],
                                            cache["m"])
        if cache is not None and S == 1:
            y, carry = xlstm.mlstm_step(q, k, v, i_raw, f_raw, carry)
        else:
            y, carry = xlstm.mlstm_chunked(q, k, v, i_raw, f_raw,
                                           cfg.xlstm.chunk_size, carry)
        y = layers.norm_apply(params["out_norm"], y.reshape(Bb, S, d_in),
                              "rmsnorm") * F.silu(z)
        if cache is not None:
            cache["conv"].copy_(new_conv)
            for key, val in zip(("C", "n", "m"), carry):
                cache[key].copy_(val)
        return layers.dense_apply(params["down"], y)
    hd = d // H
    gx = layers.dense_apply(params["w_gates"], x) \
        + layers.cast(params["gate_bias"], x.dtype)
    gx = gx.reshape(Bb, S, H, 4 * hd).permute(1, 2, 0, 3).to(
        f32).contiguous()
    r = layers.cast(params["r_gates"], f32)
    if cache is not None:
        st = tuple(cache[k].transpose(0, 1) for k in ("c", "n", "h", "m"))
    else:
        zero = torch.zeros((H, Bb, hd), dtype=f32)
        st = (zero, zero, zero.to(x.dtype),
              torch.full((H, Bb, hd), xlstm.NEG, dtype=f32))
    ys = []
    for t in range(S):
        st = xlstm._slstm_cell(gx[t], st, r)
        ys.append(st[2])
    y = torch.stack(ys, dim=2).permute(1, 2, 0, 3)
    if cache is not None:
        for key, val in zip(("c", "n", "h", "m"), st):
            cache[key].copy_(val.transpose(0, 1))
    h = F.gelu(layers.dense_apply(params["up"], y.reshape(Bb, S, d)),
               approximate="tanh")
    return layers.dense_apply(params["down"], h)
