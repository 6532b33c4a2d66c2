"""The split LM's cut bottleneck and cut noise (``SplitConfig.cut_dim``,
``cut_noise_std``) and its per-row decode positions, in the port, against
the JAX reference on the CPU.

With ``cut_dim > 0`` every head ends in ``cut_proj`` (d_model -> k) and
the trunk starts with ``in_proj`` (k -> d_model): from the reference's
params (``weights.from_reference``) the logits agree within the tolerances
of ``tests/test_torch_lm.py`` (f32: max |diff| <= 1e-4 x max |ref|; bf16:
atol 5e-2, and 1e-1 for zamba2 at 18 layers, where bf16 rounding alone
puts each package 0.059-0.061 from its own f32 logits with k = 64,
measured on these inputs), and greedy serving gives the reference's
tokens and cut bytes (an int8 decode frame carries B x (k + 4) payload
bytes: k int8 values and an f32 scale per row).

Cut noise is drawn from a ``torch.Generator`` (the reference draws it
from a JAX key), so the bits cannot match: without a generator the
output is the noise-free output bit for bit; with one, the added noise
has mean within 5 standard errors of 0 and a standard deviation within
3 % of ``cut_noise_std`` over 2 x 2 x 64 x 64 = 16384 draws (the
reference's noise is held to the same bounds); one seed gives one set of
bits.

Per-row positions (continuous batching's decode step): a decode step
with every row at its own position gives each row the bits of a step
with every row at that row's position, and a vector of equal positions
gives the scalar step's bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.federation import batching as ref_batching
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.launch.engine import ServingEngine
from repro_torch.models.attention import RowPositions
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_reference, to_numpy

torch.set_num_threads(1)

LLAMA, ZAMBA = "llama3.2-3b", "zamba2-2.7b"
CTX = {LLAMA: 16, ZAMBA: 64}
NOISE_STD = 0.5
BF16_ATOL = {(ZAMBA, 18): 1e-1}        # else 5e-2 (see the docstring)


def _cfgs(arch, n_layers, compute, **split):
    ref_cfg = ref_get_config(arch, reduced=True).replace(
        n_layers=n_layers, compute_dtype=compute)
    cfg = get_config(arch, reduced=True).replace(
        n_layers=n_layers, compute_dtype=compute)
    return (ref_cfg.replace(split=dataclasses.replace(ref_cfg.split,
                                                      **split)),
            cfg.replace(split=dataclasses.replace(cfg.split, **split)))


def _pair(arch, n_layers, compute, **split):
    ref_cfg, cfg = _cfgs(arch, n_layers, compute, **split)
    ref = RefSplitModel(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    ours = SplitModel(cfg)
    return ref, ref_params, ours, from_reference(
        jax.tree.map(np.asarray, ref_params))


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def _check(got, want, compute, atol=5e-2):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if compute == "float32":
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        assert err <= atol, err


# ----------------------------------------------------------- the bottleneck

BOTTLENECKS = [pytest.param(LLAMA, 4, 32, id="llama-k32"),
               pytest.param(LLAMA, 1, 64, id="llama-k64-no-head-units"),
               pytest.param(ZAMBA, 18, 64, id="zamba2-k64")]


@pytest.mark.parametrize("arch,n_layers,cut_dim", BOTTLENECKS)
def test_bottleneck_tree_matches_reference(arch, n_layers, cut_dim):
    """``cut_proj`` in every head and ``in_proj`` in the trunk: the
    reference's tree and shapes, from ``init`` and carried by
    ``from_reference`` / ``to_numpy`` leaf for leaf; ``k`` is the
    reference's."""
    ref, ref_params, ours, params = _pair(arch, n_layers, "float32",
                                          cut_dim=cut_dim)
    assert ours.k == ref.k == cut_dim
    ref_np = jax.tree.map(np.asarray, ref_params)
    drawn = to_numpy(ours.init(torch.Generator().manual_seed(0)))
    back = to_numpy(params)
    for tree in (drawn, back):
        assert jax.tree.structure(tree) == jax.tree.structure(ref_np)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_np)):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert drawn["heads"]["cut_proj"]["w"].shape == (
        ours.P, ours.cfg.d_model, cut_dim)
    assert drawn["trunk"]["in_proj"]["w"].shape == (cut_dim,
                                                    ours.cfg.d_model)
    assert abs(drawn["trunk"]["in_proj"]["w"].std() * cut_dim ** 0.5
               - 1.0) < 0.1
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,n_layers,cut_dim", BOTTLENECKS)
def test_bottleneck_forward_matches_reference(arch, n_layers, cut_dim,
                                              compute):
    ref, ref_params, ours, params = _pair(arch, n_layers, compute,
                                          cut_dim=cut_dim)
    toks = _tokens(2, CTX[arch], ours.cfg.vocab)
    want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(toks)})
    got, _ = ours.forward(params, {"tokens": torch.from_numpy(toks)})
    _check(got, want, compute, BF16_ATOL.get((arch, n_layers), 5e-2))
    cut, _, _ = ours.heads_forward(params["heads"],
                                   ours.split_owner_inputs(
                                       {"tokens": torch.from_numpy(toks)}))
    assert cut.shape[-1] == cut_dim


@pytest.mark.parametrize("arch,n_layers,cut_dim", BOTTLENECKS)
def test_bottleneck_prefill_and_decode_match_reference(arch, n_layers,
                                                       cut_dim):
    """f32: last-token logits of a prefill and three decode steps, and
    the greedy tokens, as the reference's."""
    ref, ref_params, ours, params = _pair(arch, n_layers, "float32",
                                          cut_dim=cut_dim)
    B, S, P, n_new = 2, CTX[arch], 2, 4
    ot = ref_batching.sequence_owner_slices(_tokens(B, S, ours.cfg.vocab), P)
    rc, tc = ref.cache_init(B, S, n_new=n_new), ours.cache_init(B, S,
                                                                n_new=n_new)
    rl, rc = ref.prefill(ref_params, {"owner_tokens": jnp.asarray(ot)}, rc)
    tl, tc = ours.prefill(params, {"owner_tokens": torch.from_numpy(
        np.ascontiguousarray(ot))}, tc)
    for t in range(n_new - 1):
        _check(tl, rl, "float32")
        rtok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
        ttok = tl.argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok))
        rl, rc = ref.decode_step(ref_params, rc, rtok, S + t, S // P + t)
        tl, tc = ours.decode_step(params, tc, ttok, S + t, S // P + t)
    _check(tl, rl, "float32")


@pytest.fixture(scope="module")
def k_quarter():
    """llama3.2-3b reduced (2 layers, f32) with k = d_model / 4."""
    return _pair(LLAMA, 2, "float32", cut_dim=64)


@pytest.mark.parametrize("scheduler", ["wave", "continuous"])
def test_bottleneck_serving_matches_reference(k_quarter, scheduler):
    """Greedy serving over the queue with the int8 codec: the reference
    engine's tokens and cut bytes; at k = d_model / 4 a continuous decode
    frame carries B x (k + 4) payload bytes."""
    ref, ref_params, ours, params = k_quarter
    rng = np.random.default_rng(3)
    ctxs = [rng.integers(0, ours.cfg.vocab, 32) for _ in range(3)]
    mixed = [4, 2, 3]
    kw = dict(batch_slots=2, ctx_len=32, max_new=4, transport="queue",
              compression="int8", scheduler=scheduler)
    out = {}
    for name, eng in (("ref", RefServingEngine(ref, ref_params, **kw)),
                      ("port", ServingEngine(ours, params, device="cpu",
                                             **kw))):
        rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
        res = eng.run()
        out[name] = ([res[r].generated for r in rids], dict(eng.stats))
        eng.close()
    assert out["port"][0] == out["ref"][0]
    for k in ("cut_payload_bytes", "cut_wire_bytes", "cut_messages",
              "ticks", "prefill_calls"):
        assert out["port"][1][k] == out["ref"][1][k], k
    assert ours.k == ours.cfg.d_model // 4
    if scheduler == "continuous":
        dec = eng._ep_sci.recv_stats["by_kind"]["cut_activations"]
        assert dec["payload_bytes"] == dec["count"] * 2 * (ours.k + 4)


# ------------------------------------------------------------ the cut noise

@pytest.fixture(scope="module")
def noisy():
    return _pair(LLAMA, 4, "float32", cut_noise_std=NOISE_STD)


def _noise_stats(x):
    x = np.asarray(x, np.float64).ravel()
    return x.size, x.mean(), x.std()


def _assert_noise_stats(noise):
    n, mean, std = _noise_stats(noise)
    assert n >= 10_000
    assert abs(mean) <= 5 * NOISE_STD / np.sqrt(n), mean
    assert abs(std / NOISE_STD - 1.0) <= 0.03, std


def test_cut_noise_without_a_generator_is_noise_free(noisy):
    """No generator: the noise-free output, bit for bit (and the
    reference's within f32 tolerance, its ``rng=None`` path)."""
    ref, ref_params, ours, params = noisy
    toks = torch.from_numpy(_tokens(2, CTX[LLAMA], ours.cfg.vocab))
    quiet = SplitModel(ours.cfg.replace(split=dataclasses.replace(
        ours.cfg.split, cut_noise_std=0.0)))
    got, _ = ours.forward(params, {"tokens": toks})
    assert torch.equal(got, quiet.forward(params, {"tokens": toks})[0])
    want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(toks.numpy())})
    _check(got, want, "float32")


def test_cut_noise_statistics_and_seeds(noisy):
    """With a generator: the combine adds N(0, std^2) noise to every
    owner's cut (mean and std within the module docstring's bounds), the
    same seed gives the same bits, another seed other bits; the
    reference's combine noise has the same statistics."""
    ref, _, ours, _ = noisy
    cut = np.random.default_rng(5).normal(size=(2, 2, 64, 64)).astype(
        np.float32)
    t = torch.from_numpy(cut)
    clean = ours.combine(t)
    a = ours.combine(t, gen=torch.Generator().manual_seed(7))
    b = ours.combine(t, gen=torch.Generator().manual_seed(7))
    c = ours.combine(t, gen=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    _assert_noise_stats((a - clean).numpy())
    ref_clean = np.asarray(ref.combine(jnp.asarray(cut)))
    ref_noisy = np.asarray(ref.combine(jnp.asarray(cut),
                                       rng=jax.random.PRNGKey(7)))
    np.testing.assert_allclose(clean.numpy(), ref_clean, rtol=1e-6)
    _assert_noise_stats(ref_noisy - ref_clean)


def test_cut_noise_through_forward(noisy):
    """``forward(..., gen=)`` puts the noise on the cut: the logits move,
    one seed gives one set of bits."""
    _, _, ours, params = noisy
    toks = {"tokens": torch.from_numpy(_tokens(2, CTX[LLAMA],
                                               ours.cfg.vocab))}
    quiet, _ = ours.forward(params, toks)
    a, _ = ours.forward(params, toks, gen=torch.Generator().manual_seed(1))
    b, _ = ours.forward(params, toks, gen=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, quiet)


# ---------------------------------------------------- per-row positions

@pytest.mark.parametrize("arch,n_layers,compute", [
    pytest.param(LLAMA, 4, "float32", id="llama-f32"),
    pytest.param(LLAMA, 4, "bfloat16", id="llama-bf16"),
    pytest.param(ZAMBA, 18, "float32", id="zamba2-f32")])
def test_per_row_decode_positions(arch, n_layers, compute):
    """A decode step with every row at its own position: row b's logits
    and cache rows are those of a step with every row at row b's
    position, bit for bit, and equal positions as a vector give the
    scalar step's bits (KV written at each row's position, rope and the
    attention mask per row)."""
    cfg = get_config(arch, reduced=True).replace(n_layers=n_layers,
                                                 compute_dtype=compute)
    model = SplitModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S, P, n_new = 3, CTX[arch], 2, 6
    ot = torch.from_numpy(np.ascontiguousarray(
        ref_batching.sequence_owner_slices(_tokens(B, S, cfg.vocab), P)))
    tok = torch.from_numpy(_tokens(B, 1, cfg.vocab, seed=1))
    steps = np.array([0, 3, 5])

    def step(pos, pos_l):
        caches = model.cache_init(B, S, n_new=n_new)
        with torch.inference_mode():
            model.prefill(params, {"owner_tokens": ot}, caches)
            logits, caches = model.decode_step(params, caches, tok, pos,
                                               pos_l)
        return logits, caches

    got, gc = step(S + steps, S // P + steps)
    for b, s in enumerate(steps):
        want, wc = step(S + int(s), S // P + int(s))
        assert torch.equal(got[b], want[b]), b
        for x, y in zip(tree_leaves(gc["trunk"]), tree_leaves(wc["trunk"])):
            assert torch.equal(x[:, b], y[:, b])
        vec, vc = step(np.full(B, S + int(s)), np.full(B, S // P + int(s)))
        assert torch.equal(vec, want)
        for x, y in zip(tree_leaves(vc), tree_leaves(wc)):
            assert torch.equal(x, y)


def test_row_positions_of():
    dev = torch.device("cpu")
    assert RowPositions.of(5, dev) == 5 and RowPositions.of(None, dev) is None
    rp = RowPositions.of(np.array([3, 1]), dev)
    assert isinstance(rp, RowPositions) and rp.host.tolist() == [3, 1]
    assert RowPositions.of(rp, dev) is rp
    assert RowPositions.of(torch.tensor([2, 2]), dev).dev.dtype == \
        torch.int64
    with pytest.raises(ValueError, match="one int per row"):
        RowPositions(np.zeros((2, 2), np.int64), dev)
