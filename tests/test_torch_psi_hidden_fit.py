"""The membership-hiding alignment feeds training: on the CPU, the port's
hidden resolve gives the JAX package's pseudonymous rows (decoys
included) bit for bit, and a split fit on them, from shared params,
keeps the reference's loss trail within ``test_torch_session.py``'s
tolerances (rtol 1e-4 lossless; 2e-2 and 0.02 accuracy with int8).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.pyvertical_mnist import CONFIG as REF_CFG
from repro_torch.configs import CONFIG
from repro_torch.weights import from_reference

from test_torch_psi_session import assert_same_resolve, twin_sessions

torch.set_num_threads(1)

GROUP = "modp512"
FIT = dict(epochs=2, batch_size=64, eval_frac=0.1, verbose=False)


def _hidden_pair():
    ours, ref = twin_sessions(400, seed=0, keep_frac=0.9, modes=("hidden",))
    kw = dict(group=GROUP, mode="hidden", backend="queue", chunk_size=128)
    assert_same_resolve(ours, ref, ours.resolve(**kw), ref.resolve(**kw))
    ref.build(REF_CFG)
    ours.build(CONFIG, params=from_reference(
        jax.tree.map(np.asarray, ref.params)))
    return ours, ref


def test_hidden_alignment_keeps_decoys_in_the_training_rows():
    """The aligned rows are the true members and, from each owner, fewer
    than HIDDEN_PAD decoys, under positional pseudonyms; labels and
    features (decoys' included) are the reference's (``_hidden_pair``
    holds them)."""
    from repro_torch.core.psi import HIDDEN_PAD
    ours, _ = _hidden_pair()
    members = set(ours.scientist._full.ids)
    for o in ours.owners:
        members &= set(o._full.ids)
    n = len(ours.scientist.ids)
    assert len(members) <= n <= len(members) + 2 * (HIDDEN_PAD - 1)
    assert ours.scientist.ids == [f"anon{k:06d}" for k in range(n)]


@pytest.mark.parametrize("compression", [None, "int8"])
def test_hidden_split_fit_matches_reference(compression):
    ours, ref = _hidden_pair()
    kw = dict(FIT, mode="split", compression=compression, backend="queue")
    hr = ref.fit(**kw)
    h = ours.fit(**kw)
    if compression is None:
        np.testing.assert_allclose([r["loss"] for r in h["train"]],
                                   [r["loss"] for r in hr["train"]],
                                   rtol=1e-4)
        np.testing.assert_allclose([r["loss"] for r in h["eval"]],
                                   [r["loss"] for r in hr["eval"]],
                                   rtol=1e-4)
    else:
        assert abs(h["final"]["val_accuracy"]
                   - hr["final"]["val_accuracy"]) <= 0.02
        assert abs(h["final"]["loss"] - hr["final"]["loss"]) <= 2e-2
        assert abs(h["final"]["val_loss"] - hr["final"]["val_loss"]) <= 2e-2
    trail = h["loss_trail"]
    assert all(np.isfinite(trail)) and sum(trail[-3:]) < sum(trail[:3])
    assert ours.transport_stats["per_owner"] == \
        ref.transport_stats["per_owner"]
