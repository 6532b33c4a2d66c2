"""Split LM training with each owner in a spawned worker process, on the
CPU: ``fit(mode="split", backend="process")`` equals the queue backend
bit for bit (params, loss trail and cut bytes), lossless and int8, and
the workers rebuild their heads' programs from the ``ArchConfig`` in
their spec, with a parameter template of the head's structure
(``owner_template``), never a full-model init.

llama3.2-3b reduced with 3 layers (one attention unit per head), f32
and bf16 compute, and zamba2-2.7b reduced with 12 layers; each fit
spawns two workers (a few seconds each).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_token_dataset
from repro_torch.tree import tree_leaves, tree_map

from test_torch_cuda import lm_session

torch.set_num_threads(1)


def _cfg(compute):
    return get_config("llama3.2-3b", reduced=True).replace(
        n_layers=3, compute_dtype=compute).with_split(cut_layer=1)


@pytest.mark.parametrize("compute,compression", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "int8")])
def test_process_equals_queue(compute, compression):
    cfg = _cfg(compute)
    process_equals_queue(cfg, make_token_dataset(16, 32, cfg.vocab, 0),
                         compression)


@pytest.mark.parametrize("compute,compression", [
    ("float32", None), ("bfloat16", "int8")])
def test_zamba2_process_equals_queue(compute, compression):
    """Reduced zamba2-2.7b (12 layers: one unit of five Mamba2 blocks and
    the shared attention block per head, one in the trunk) over 64
    tokens: the trunk's scan spans two chunks of 32, each head's one."""
    cfg = get_config("zamba2-2.7b", reduced=True).replace(
        n_layers=12, compute_dtype=compute).with_split(cut_layer=1)
    process_equals_queue(cfg, make_token_dataset(16, 64, cfg.vocab, 0),
                         compression)


def process_equals_queue(cfg, toks, compression):
    p0 = tree_map(torch.clone, lm_session(cfg, toks, "cpu").params)
    runs = {}
    for backend in ("queue", "process"):
        s = lm_session(cfg, toks, "cpu", p0)
        h = s.fit(steps=3, batch_size=4, verbose=False, mode="split",
                  backend=backend, compression=compression, eval_frac=0.25)
        runs[backend] = (s, h)
    (sq, hq), (sp, hp) = runs["queue"], runs["process"]
    assert hp["loss_trail"] == hq["loss_trail"]
    assert np.isfinite(hp["loss_trail"]).all()
    assert hp["eval"] == hq["eval"]
    for a, b in zip(tree_leaves(sp.params), tree_leaves(sq.params)):
        assert torch.equal(a, b)
    for name, o in sp.transport_stats["per_owner"].items():
        oq = sq.transport_stats["per_owner"][name]
        for k in ("cut_payload_bytes", "cut_wire_bytes",
                  "grad_payload_bytes", "grad_wire_bytes"):
            assert o[k] == oq[k], k
