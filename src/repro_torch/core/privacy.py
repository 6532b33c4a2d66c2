"""Cut-layer privacy defences (the port's counterpart of
``repro.core.privacy``).

* NoPeek: the distance correlation between an owner's raw inputs and its
  cut joins the training objective (``SplitConfig.nopeek_weight``).  The
  penalty is owner-local: split training adds its gradient in the
  owner's head backward, and nothing more crosses the wire.
* Gaussian noise on cut activations (Titcombe et al. 2021,
  ``SplitConfig.cut_noise_std``): split training adds it on the owner's
  side before the cut ships (:func:`deterministic_cut_noise`).
* Cut-gradient obfuscation against label leakage (Li et al. 2021,
  ``SplitConfig.grad_norm_mode`` and ``grad_noise_std``): the scientist
  equalises per-example norms ("unit"), ships signs at one magnitude
  ("sign") and/or adds noise (:func:`obfuscate_cut_gradient`).

The wire transforms are host numpy keyed on ``sha256(seed|tag)``, so a
re-shipped chunk gets the same noise; they and
:func:`label_inference_auc` are byte-identical to the reference's.  The
distance correlation runs on tensors under autograd.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix of the rows of x: (B, F) -> (B, B), f32.
    ``d2`` goes slightly negative by rounding on real cuts (diagonal and
    near-duplicate rows); the floor's gradient is 0 below it."""
    x = x.reshape(x.shape[0], -1).to(torch.float32)
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.sqrt(torch.clamp_min(d2, 1e-12))


def _center(d: torch.Tensor) -> torch.Tensor:
    return (d - d.mean(0, keepdim=True) - d.mean(1, keepdim=True)
            + d.mean())


def distance_correlation(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Székely distance correlation between batches x (B, ...) and z
    (B, ...): 0 independent, 1 strongly dependent.  The NoPeek
    regulariser, and a leakage metric."""
    a = _center(_pairwise_dist(x))
    b = _center(_pairwise_dist(z))
    dcov = torch.sqrt(torch.clamp_min((a * b).mean(), 0.0))
    dvar_x = torch.sqrt(torch.clamp_min((a * a).mean(), 0.0))
    dvar_z = torch.sqrt(torch.clamp_min((b * b).mean(), 0.0))
    return dcov / torch.clamp_min(torch.sqrt(dvar_x * dvar_z), 1e-9)


def nopeek_penalty(raw_inputs: torch.Tensor, cut_activations: torch.Tensor,
                   weight: float) -> torch.Tensor:
    """The NoPeek term: ``weight * dcor(raw, cut)``, per owner and summed
    when both carry a leading owner axis ((P, B, F) and (P, B, k))."""
    if weight <= 0.0:
        return torch.zeros((), dtype=torch.float32,
                           device=cut_activations.device)
    if raw_inputs.dim() == cut_activations.dim():    # stacked owner axis
        per_owner = torch.stack([distance_correlation(x, c) for x, c in
                                 zip(raw_inputs, cut_activations)])
        return weight * per_owner.sum()
    return weight * distance_correlation(raw_inputs, cut_activations)


def gaussian_cut_noise(gen: torch.Generator, cut: torch.Tensor,
                       std: float) -> torch.Tensor:
    """``cut`` plus N(0, std^2) noise drawn from ``gen`` (a generator on
    the cut's device)."""
    if std <= 0.0:
        return cut
    return cut + std * torch.randn(cut.shape, generator=gen,
                                   dtype=cut.dtype, device=cut.device)


# ---------------------------------------------------------------------------
# Wire defences (deterministic host-side transforms on shipped tensors)
# ---------------------------------------------------------------------------


def _wire_rng(seed: int, tag: str) -> np.random.Generator:
    """A Philox stream keyed on sha256(seed|tag): the same in every
    process, so a re-shipped chunk gets bitwise the same noise."""
    h = hashlib.sha256(f"{seed}|{tag}".encode()).digest()
    return np.random.Generator(
        np.random.Philox(key=int.from_bytes(h[:16], "little")))


def deterministic_cut_noise(cut, std: float, seed: int,
                            tag: str) -> np.ndarray:
    """The owner's Titcombe noise on a cut chunk about to ship (host
    numpy: the wire path has the chunk on the host)."""
    cut = np.asarray(cut, np.float32)
    if std <= 0.0:
        return cut
    noise = _wire_rng(seed, tag).standard_normal(
        cut.shape).astype(np.float32)
    return cut + np.float32(std) * noise


def obfuscate_cut_gradient(g, *, noise_std: float = 0.0,
                           norm_mode: str = "none", seed: int = 0,
                           tag: str = "") -> np.ndarray:
    """The scientist's defence on one cut-gradient chunk (B, k) before it
    ships:

    * ``norm_mode="unit"`` rescales every example's gradient to the
      batch's median norm, so the per-example norm carries no bits;
    * ``norm_mode="sign"`` ships ``sign(g)`` at one magnitude (the mean
      |g|);
    * ``noise_std`` adds Gaussian noise keyed on ``(seed, tag)`` on top.
    """
    g = np.asarray(g, np.float32)
    if norm_mode not in ("none", "unit", "sign"):
        raise ValueError(f"unknown grad_norm_mode {norm_mode!r}")
    if norm_mode == "unit":
        norms = np.linalg.norm(g.reshape(g.shape[0], -1), axis=1)
        target = np.float32(np.median(norms))
        scale = target / np.maximum(norms, 1e-12)
        g = g * scale.reshape((-1,) + (1,) * (g.ndim - 1)).astype(
            np.float32)
    elif norm_mode == "sign":
        g = np.sign(g).astype(np.float32) * np.float32(
            np.mean(np.abs(g)))
    if noise_std > 0.0:
        noise = _wire_rng(seed, tag).standard_normal(
            g.shape).astype(np.float32)
        g = g + np.float32(noise_std) * noise
    return g


def label_inference_auc(grad_norms, labels) -> float:
    """The norm attack's score: the AUC of per-example cut-gradient norms
    predicting the (binary) label; 0.5 is chance, 1.0 a full leak."""
    norms = np.asarray(grad_norms, np.float64)
    y = np.asarray(labels).astype(bool)
    pos, neg = norms[y], norms[~y]
    if not len(pos) or not len(neg):
        return 0.5
    # Mann-Whitney U statistic, ties counted half
    greater = (pos[:, None] > neg[None, :]).sum()
    ties = (pos[:, None] == neg[None, :]).sum()
    return float((greater + 0.5 * ties) / (len(pos) * len(neg)))
