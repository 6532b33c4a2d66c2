"""The port's wave serving engine against the JAX reference's, on the CPU.

With ``compute_dtype="float32"`` both engines start from shared params
and greedy-decode the same requests: the tokens are identical and the
cut bytes on the wire (``cut_wire_bytes``) are equal to the byte, for
every transport (none, direct, queue) and cut codec (none, fp16, int8)
on llama3.2-3b (reduced, 2 layers, contexts of 32), and on the direct
and queue transports with the none and int8 codecs on zamba2-2.7b
(reduced, 18 layers: 2 head units per owner and 1 trunk unit, contexts
of 128, so a head prefill scans 2 chunks of 32 and the trunk 4).
In the default bf16 compute the lossless codec ships the cut in bf16;
its frames are byte-identical to the reference's ``_pack``.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.federation import transport as ref_transport
from repro.launch.engine import ServingEngine as RefServingEngine
from repro.models.model import SplitModel as RefSplitModel
from repro_torch.configs import get_config
from repro_torch.federation import cut_codec, transport
from repro_torch.launch import serve
from repro_torch.launch.engine import QueueFull, ServingEngine
from repro_torch.models.model import SplitModel
from repro_torch.weights import from_reference

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CTX, SLOTS, NEW = 32, 2, 4
LLAMA, ZAMBA = "llama3.2-3b", "zamba2-2.7b"
ZAMBA_CTX = 128


def _models(compute, n_layers=2, arch=LLAMA):
    kw = dict(n_layers=n_layers, compute_dtype=compute)
    ref = RefSplitModel(ref_get_config(arch, reduced=True).replace(**kw))
    ref_params = ref.init(jax.random.PRNGKey(0))
    ours = SplitModel(get_config(arch, reduced=True).replace(**kw))
    return ref, ref_params, ours, from_reference(
        jax.tree.map(np.asarray, ref_params))


@pytest.fixture(scope="module")
def f32_models():
    return _models("float32")


@pytest.fixture(scope="module")
def zamba2_models():
    return _models("float32", n_layers=18, arch=ZAMBA)


def _contexts(vocab, n=3, seed=0, ctx=CTX):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, ctx - 4 * i) for i in range(n)]


def _serve(engine, contexts):
    rids = [engine.submit(c) for c in contexts]
    out = engine.run()
    return [out[r].generated for r in rids]


# (arch, transport, codec); the llama cases keep their first ids
ENGINE_CASES = [
    pytest.param(LLAMA, b, c, id=f"{b}-{c}")
    for b in (None, "direct", "queue") for c in (None, "fp16", "int8")] + [
    pytest.param(ZAMBA, b, c, id=f"zamba2-{b}-{c}")
    for b in ("direct", "queue") for c in (None, "int8")]


@pytest.mark.parametrize("arch,backend,compression", ENGINE_CASES)
def test_engine_matches_reference_engine(request, arch, backend,
                                         compression):
    """Three requests in two waves: greedy tokens identical to the
    reference engine's, and the cut bytes and messages on the wire
    equal."""
    ref, ref_params, ours, params = request.getfixturevalue(
        "f32_models" if arch == LLAMA else "zamba2_models")
    ctx = CTX if arch == LLAMA else ZAMBA_CTX
    kw = dict(batch_slots=SLOTS, ctx_len=ctx, max_new=NEW,
              transport=backend, compression=compression)
    ctxs = _contexts(ours.cfg.vocab, ctx=ctx)
    want_eng = RefServingEngine(ref, ref_params, **kw)
    got_eng = ServingEngine(ours, params, device="cpu", **kw)
    assert _serve(got_eng, ctxs) == _serve(want_eng, ctxs)
    for k in ("waves", "requests", "tokens_generated", "prefill_calls",
              "cut_payload_bytes", "cut_wire_bytes", "cut_messages"):
        assert got_eng.stats[k] == want_eng.stats[k], k
    assert set(got_eng.stats) == set(want_eng.stats)
    if backend is not None:
        # per wave: P prefill cuts + one cut per decode tick
        assert got_eng.stats["cut_messages"] == 2 * (2 + NEW - 1)


def test_bf16_engine_wire_bytes_match_reference():
    """Default bf16 compute over the queue transport, lossless codec: the
    cut crosses in bf16 (2 bytes per value), and the bytes equal the
    reference's."""
    ref, ref_params, ours, params = _models("bfloat16", n_layers=1)
    kw = dict(batch_slots=SLOTS, ctx_len=CTX, max_new=NEW, transport="queue")
    ctxs = _contexts(ours.cfg.vocab, n=2)
    want_eng = RefServingEngine(ref, ref_params, **kw)
    got_eng = ServingEngine(ours, params, device="cpu", **kw)
    _serve(want_eng, ctxs)
    _serve(got_eng, ctxs)
    assert got_eng._cut_dtype == torch.bfloat16
    d = ours.cfg.d_model
    assert got_eng.stats["cut_payload_bytes"] == \
        2 * d * SLOTS * (CTX + NEW - 1)
    for k in ("cut_payload_bytes", "cut_wire_bytes", "cut_messages"):
        assert got_eng.stats[k] == want_eng.stats[k], k


def test_bf16_frames_are_the_reference_s():
    """A bf16 cut packs to the reference's frame byte for byte (dtype name
    ``bfloat16``, raw 2-byte words), and unpacks to the same bf16
    tensor."""
    x = np.random.default_rng(0).normal(size=(2, 5, 16)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    ref_arr = np.asarray(jnp.asarray(x, jnp.bfloat16))
    assert ref_arr.dtype == ml_dtypes.bfloat16
    payload = {"x": t, "s": torch.arange(3, dtype=torch.int32)}
    blob = transport._pack(payload)
    assert blob == ref_transport._pack({"x": ref_arr,
                                        "s": np.arange(3, dtype=np.int32)})
    back = transport._unpack(blob)
    got = cut_codec.to_tensor(back["x"], torch.device("cpu"))
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    assert torch.equal(cut_codec.to_tensor(back["s"], "cpu"), payload["s"])
    ref_back = ref_transport._unpack(blob)
    np.testing.assert_array_equal(
        np.asarray(ref_back["x"]).view(np.uint16),
        t.view(torch.int16).numpy().view(np.uint16))


def test_engine_matches_manual_decode(f32_models):
    """One slot: the engine's tokens are those of prefill + decode_step
    by hand (the reference's test_engine check, in the port)."""
    _, _, model, params = f32_models
    eng = ServingEngine(model, params, batch_slots=1, ctx_len=CTX,
                        max_new=NEW, transport="direct", device="cpu")
    ctx = _contexts(model.cfg.vocab, n=1)[0].astype(np.int32)
    got = _serve(eng, [ctx])[0]
    S, P = CTX, 2
    caches = model.cache_init(1, S, n_new=NEW + 1)
    ot = torch.from_numpy(np.ascontiguousarray(
        ctx.reshape(1, P, S // P).transpose(1, 0, 2)))
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"owner_tokens": ot}, caches)
        toks = []
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for t in range(NEW):
            toks.append(int(tok[0, 0]))
            if t < NEW - 1:
                logits, caches = model.decode_step(params, caches, tok,
                                                   S + t, S // P + t)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
    assert got == toks


def test_eos_and_oversized_context(f32_models):
    _, _, model, params = f32_models
    ctx = _contexts(model.cfg.vocab, n=1)[0]
    eng = ServingEngine(model, params, batch_slots=1, ctx_len=CTX,
                        max_new=NEW, device="cpu")
    first = _serve(eng, [ctx])[0][0]
    eng2 = ServingEngine(model, params, batch_slots=1, ctx_len=CTX,
                         max_new=NEW, eos_token=first, device="cpu")
    assert _serve(eng2, [ctx]) == [[first]]
    with pytest.raises(ValueError):
        eng.submit(np.zeros(CTX + 1, np.int32))


def test_queue_full_carries_backpressure_signal(f32_models):
    _, _, model, params = f32_models
    eng = ServingEngine(model, params, batch_slots=1, ctx_len=CTX,
                        max_new=2, max_queue=2, device="cpu")
    eng.submit(np.ones(4))
    eng.submit(np.ones(4))
    with pytest.raises(QueueFull) as e:
        eng.submit(np.ones(4))
    assert e.value.queue_depth == 2 and e.value.retry_after_s == 0.05
    with pytest.raises(QueueFull):
        eng.submit(np.ones(4), block=True, timeout=0.02)
    assert eng.stats["rejected"] == 2 and eng.stats["peak_queue_depth"] == 2


def test_engine_without_device_needs_a_card(f32_models):
    _, _, model, params = f32_models
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None means it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params)


def test_serve_cli_on_the_cpu(capsys):
    for arch in (LLAMA, ZAMBA):
        gen = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--ctx", "16", "--new", "3"])
        assert gen.shape == (2, 3)
        assert "tok/s" in capsys.readouterr().out


def test_engine_imports_no_jax_and_no_reference():
    """``import repro_torch.launch.engine`` (and the serve CLI) in a fresh
    interpreter loads neither jax nor any ``repro`` module."""
    code = ("import sys\nimport repro_torch.launch.engine\n"
            "import repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
