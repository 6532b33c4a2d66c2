"""Real attacks on the port's wire: transcripts of port split fits,
captured through the transport tap, scored with the reference harness's
pure functions (``tests/attacks/harness.py``: ``inversion_r2``,
``dcor_leakage``, ``norm_attack_auc``) against the thresholds of the
reference suite (``tests/attacks/test_transcript_attacks.py``), and the
reference's wire-privacy checks of masked frames
(``tests/test_wire_privacy.py``) on the port's frames.

Each capture is a sum-combine split fit over the queue backend on the
CPU (256 subjects, 6 steps of 64, labels binarised to the rare class),
as the harness's ``capture_transcript`` runs the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

from attacks import harness as H
from repro_torch.configs import CONFIG
from repro_torch.core import masking
from repro_torch.core.resolution import VerticalDataset
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties
from repro_torch.federation import transport
from repro_torch.federation.cut_codec import get_codec
from repro_torch.federation.transport import _unpack

# The tier-1 suite runs several xdist workers on one shared CPU: one
# torch thread per worker keeps these tests from starving the others.
torch.set_num_threads(1)


def _tapped_fit(*, n, steps, labels_of=None, aggregation=None, **split):
    """A split fit of the port with every serialized frame captured:
    returns the session and [(sender, receiver, kind, seq, blob)]."""
    captured = []
    orig = transport.channel_pair

    def tapped(a, b, **kw):
        kw["tap"] = lambda msg, blob: captured.append(
            (msg.sender, msg.receiver, msg.kind, msg.seq, blob))
        return orig(a, b, **kw)

    transport.channel_pair = tapped
    try:
        sci_ds, owner_ds = make_vertical_mnist_parties(n, seed=0,
                                                       keep_frac=0.9)
        if labels_of is not None:
            sci_ds = VerticalDataset(sci_ds.ids, labels_of(sci_ds.data))
        s = VerticalSession(*feature_parties(sci_ds, owner_ds),
                            device="cpu")
        s.resolve(group="modp512")
        s.build(dataclasses.replace(CONFIG, split=dataclasses.replace(
            CONFIG.split, combine="sum", **split)))
        s.fit(steps=steps, batch_size=64, verbose=False, mode="split",
              backend="queue", aggregation=aggregation)
    finally:
        transport.channel_pair = orig
    return s, captured


def capture(aggregation=None, **split) -> H.Transcript:
    """The harness's ``capture_transcript`` on the port: the rare class
    (~10% of rows) is the positive label."""
    s, captured = _tapped_fit(
        n=256, steps=6, aggregation=aggregation,
        labels_of=lambda y: (np.asarray(y) == 0).astype(np.int32), **split)
    tr = H.Transcript(aggregation=aggregation)
    codec = get_codec(None)
    for sender, receiver, kind, seq, blob in captured:
        payload = _unpack(blob)
        if kind == "head_fwd":
            tr.batches[seq] = np.asarray(payload["idx"], np.int32)
        elif kind == "cut_activations":
            if "mq" in payload:
                # a float view of the ring element: all an eavesdropper
                # can do with a masked frame
                z = (payload["mq"].view(np.int32).astype(np.float32)
                     * np.float32(2.0 ** -16))
            else:
                z = codec.decode(payload).numpy()
            tr.cuts.setdefault(sender, []).append((seq, z))
        elif kind == "cut_gradients":
            tr.grads.setdefault(receiver, []).append(
                (seq, codec.decode(payload).numpy()))
    for o in s.owners:
        tr.features[o.name] = np.asarray(o._features, np.float32)
    tr.labels = np.asarray(s.scientist.labels)
    return tr


_T: dict = {}


def _tr(name, **kw):
    if name not in _T:
        _T[name] = capture(**kw)
    return _T[name]


def _base():
    return _tr("base")


# ---------------------------------------------------------------------------
# forward leg: model inversion and dcor against the cut defences
# ---------------------------------------------------------------------------


def test_inversion_reconstructs_undefended_cuts():
    tr = _base()
    for owner in sorted(tr.cuts):
        assert H.inversion_r2(tr, owner) > 0.3


def test_cut_noise_blunts_inversion_and_dcor():
    base, noisy = _base(), _tr("cut_noise", cut_noise_std=2.0)
    for owner in sorted(base.cuts):
        r2_b, r2_d = (H.inversion_r2(base, owner),
                      H.inversion_r2(noisy, owner))
        assert r2_d < r2_b - 0.3 and r2_d < 0.05
        assert H.dcor_leakage(noisy, owner) \
            < H.dcor_leakage(base, owner) - 0.05


def test_masked_sum_blunts_forward_leakage_to_the_noise_floor():
    base, masked = _base(), _tr("masked", aggregation="masked_sum")
    for owner in sorted(base.cuts):
        assert H.inversion_r2(masked, owner) < 0.0
        assert H.dcor_leakage(masked, owner) \
            < H.dcor_leakage(base, owner) - 0.05


# ---------------------------------------------------------------------------
# backward leg: norm-based label inference against the gradient defences
# ---------------------------------------------------------------------------


def test_norm_attack_reads_labels_from_undefended_gradients():
    assert H.norm_attack_auc(_base()) > 0.9


@pytest.mark.parametrize("defence,kw", [
    ("grad_noise", dict(grad_noise_std=0.05)),
    ("grad_unit", dict(grad_norm_mode="unit")),
    ("grad_sign", dict(grad_norm_mode="sign")),
])
def test_each_gradient_defence_blunts_the_norm_attack(defence, kw):
    auc_b = H.norm_attack_auc(_base())
    auc_d = H.norm_attack_auc(_tr(defence, **kw))
    assert auc_d < auc_b - 0.25
    assert auc_d < 0.65


def test_unit_norm_defence_leaves_zero_norm_bits():
    auc = H.norm_attack_auc(_tr("grad_unit", grad_norm_mode="unit"))
    assert auc == pytest.approx(0.5, abs=0.05)


def test_transcript_shapes_and_ground_truth_alignment():
    tr = _base()
    assert len(tr.batches) == 6
    assert set(tr.cuts) == set(tr.features)
    for frames in tr.cuts.values():
        assert len(frames) == 6
        for t, z in frames:
            assert z.shape == (len(tr.batches[t]), 64)
    assert set(tr.labels.tolist()) <= {0, 1}
    assert 0.02 < tr.labels.mean() < 0.3


# ---------------------------------------------------------------------------
# what a masked fit puts on the wire
# ---------------------------------------------------------------------------

_WIRE: dict = {}


def _wire(aggregation):
    """Every frame of a 2-step split fit (200 subjects), plain or masked,
    from the same params and batches."""
    if aggregation not in _WIRE:
        _WIRE[aggregation] = _tapped_fit(n=200, steps=2,
                                         aggregation=aggregation)[1]
    return _WIRE[aggregation]


def _owner_cuts(captured):
    return [(sender, kind, _unpack(blob))
            for sender, _, kind, _, blob in captured
            if sender != "scientist"
            and kind in ("cut_activations", "warmup_cuts")]


def test_masked_frames_carry_only_ring_elements():
    frames = _owner_cuts(_wire("masked_sum"))
    assert len(frames) == 2 * 3          # 2 owners x (warmup + 2 steps)
    for sender, kind, payload in frames:
        assert set(payload) == {"mq"}, (sender, kind)
        assert payload["mq"].dtype == np.uint32
        assert payload["mq"].shape == (64, 64)


def test_masked_run_ships_no_unmasked_activation_bytes():
    """The f32 cut a plain run ships, and its bare fixed-point lift,
    appear in no frame of the masked run (same params, same batches)."""
    plain, masked = _wire(None), _wire("masked_sum")
    haystack = b"\x00".join(blob for *_, blob in masked)
    needles = 0
    for sender, kind, payload in _owner_cuts(plain):
        cut = np.asarray(payload["x"], np.float32)
        for needle in (cut.tobytes(),
                       masking.quantize(cut).numpy().tobytes()):
            assert needle not in haystack, (sender, kind)
            needles += 1
    assert needles == 2 * 3 * 2
    # the control: the plain run does carry its cut bytes
    plain_hay = b"\x00".join(blob for *_, blob in plain)
    assert np.asarray(_owner_cuts(plain)[0][2]["x"]).tobytes() in plain_hay


def test_ring_elements_are_uncorrelated_with_the_true_cut():
    """mq = q + mask is uniform mod 2^32: no correlation with the true
    lift, and almost never inside the lift's +-2^24 band."""
    def streams(frames):
        out: dict = {}
        for sender, kind, payload in frames:
            out.setdefault((sender, kind), []).append(payload)
        return out

    plain_s = streams(_owner_cuts(_wire(None)))
    masked_s = streams(_owner_cuts(_wire("masked_sum")))
    assert set(plain_s) == set(masked_s)
    checked = 0
    for key in sorted(plain_s):
        for pl_p, pl_m in zip(plain_s[key], masked_s[key]):
            q = masking.quantize(np.asarray(pl_p["x"], np.float32)).numpy()
            q = q.astype(np.int64).ravel()
            mq = pl_m["mq"].view(np.int32).astype(np.int64).ravel()
            if np.std(q) == 0:
                continue
            assert abs(np.corrcoef(q, mq)[0, 1]) < 0.1
            assert np.mean(np.abs(mq) <= masking.QCLIP) < 0.05
            checked += 1
    assert checked >= 4
