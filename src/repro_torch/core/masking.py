"""Secure forward aggregation: pairwise-cancelling cut-layer masks (the
port's counterpart of ``repro.core.masking``).

Cai et al. ("Secure Forward Aggregation", 2207.00165) observe that a
sum-combine scientist never needs the owners' head outputs one by one:
each owner ships ``head_out + mask`` where the masks cancel across the
owner set, so the scientist reconstructs exactly ``sum_p head_out_p``
and nothing else.  Floating-point addition is not exact, so the masks
cancel in an integer ring instead:

1. **Fixed-point lift.**  Each owner quantizes its cut to
   ``q = clip(round(x * 2^SCALE_BITS))`` as int32 (:func:`quantize`, on
   the cut's device; the masked joint oracle runs the same function).
   Every |q| stays within 2^24, so the f32 rounding is exact and sums
   over owners fit int32 with room to spare.
2. **Ring masking.**  For every owner pair (p, q), p < q, a shared seed
   derives a uniform uint32 stream; p adds it and q subtracts it mod
   2^32 (:func:`pairwise_mask`).  Over ALL owners the masks sum to zero
   in the ring, so the scientist's fold (:func:`reconstruct`) recovers
   the true integer sum bit for bit: masked split execution equals the
   unmasked joint oracle that runs the same quantize -> sum ->
   dequantize combine.
3. **Dequantize, and a straight-through backward.**  The trunk takes
   ``z = sum_q * 2^-SCALE_BITS`` (:func:`dequantize`); every owner's
   cut gradient is ``dL/dz`` (the sum combine's broadcast), so masks
   never touch gradients.

A message's mask is a pure function of ``(root seed, pair, tag)``, with
no stream state, so all owners agree without talking to each other and
a replayed step re-derives its masks.  The root seed is
``REPRO_MASK_SEED`` where the caller's environment sets it (spawned
owner workers inherit it), standing in for the owners' out-of-band key
agreement; without it every owner falls back to the session's init
seed.  The scientist's code never derives a mask.

The ring arithmetic runs on the host in numpy uint32, as in the
reference: the owner's frame is host numpy anyway.  Everything but
:func:`quantize` and :func:`dequantize` is numpy and byte-identical to
the reference's.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: environment variable carrying the shared mask root seed (spawned owner
#: workers inherit the parent's environment)
MASK_ENV = "REPRO_MASK_SEED"

#: fixed-point scale: 2^-16 resolution, values clipped to +-256, the
#: f32-exact integer range (|q| <= 2^24), with int32 room for sums over
#: up to ~2^7 owners
SCALE_BITS = 16
SCALE = float(2 ** SCALE_BITS)
QCLIP = float(2 ** 24)

#: ring element width on the wire (uint32): the same 4 bytes per element
#: as the f32 cut it replaces, so masking costs no forward bytes
RING_BYTES = 4


def mask_root_from_env(default: int) -> int:
    """The session-wide mask root: the environment's value when set (a
    deployment would put the owners' agreed secret there), else
    ``default`` (the session's init seed)."""
    v = os.environ.get(MASK_ENV, "")
    return int(v) if v else int(default)


def quantize(x) -> torch.Tensor:
    """The fixed-point lift ``f32 (B, k) -> int32`` on x's device: round
    to 2^-16 resolution (half to even, as ``jnp.round``), clipped to the
    f32-exact band.  The product by 2^16 is exact.  A numpy array is
    copied to a CPU tensor."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    q = torch.round(x.to(torch.float32) * SCALE)
    return q.clamp(-QCLIP, QCLIP).to(torch.int32)


def dequantize(zsum: torch.Tensor) -> torch.Tensor:
    """Inverse lift: the int32 ring sum -> the f32 trunk input.  The scale
    is a power of two, so the product is exact wherever the int fits
    f32."""
    return zsum.to(torch.float32) * (1.0 / SCALE)


def _pair_key(root: int, lo: int, hi: int, tag: str) -> int:
    h = hashlib.sha256(f"{root}|{lo}|{hi}|{tag}".encode()).digest()
    return int.from_bytes(h[:16], "little")


def pairwise_mask(root: int, owner: int, n_owners: int, tag: str,
                  shape) -> np.ndarray:
    """Owner ``owner``'s uint32 mask for message ``tag``: the sum of the
    pairwise streams it shares with every peer, + as the lower index and
    - as the higher, so ``sum_p pairwise_mask(p) == 0`` mod 2^32
    element-wise.  A pure function of ``(root, pair, tag)``."""
    m = np.zeros(shape, np.uint32)
    for q in range(n_owners):
        if q == owner:
            continue
        lo, hi = (owner, q) if owner < q else (q, owner)
        rng = np.random.Generator(
            np.random.Philox(key=_pair_key(root, lo, hi, tag)))
        r = rng.integers(0, 2 ** 32, size=shape,
                         dtype=np.uint64).astype(np.uint32)
        m = m + r if owner == lo else m - r
    return m


class MaskedAggregator:
    """The owner's encoder: quantize the cut chunk, add this owner's
    pairwise-cancelling ring mask, ship uint32.

    ``generation`` scopes the warmup tags (a restarted worker's warmup
    stream stays apart from the one it replaced); steady tags are the
    global chunk seq ``s{seq}``, the same in every generation, so
    replayed steps' masks still cancel against the other owners'."""

    def __init__(self, root: int, owner_index: int, n_owners: int, *,
                 generation: int = 0):
        if n_owners < 2:
            raise ValueError(
                "masked_sum needs >= 2 owners: a single owner's masked "
                "payload would be its bare quantized activation")
        self.root = int(root)
        self.owner_index = int(owner_index)
        self.n_owners = int(n_owners)
        self.generation = int(generation)

    def warmup_tag(self, m: int) -> str:
        return f"w{m}g{self.generation}"

    @staticmethod
    def step_tag(seq: int) -> str:
        return f"s{seq}"

    def encode(self, cut, tag: str) -> Dict[str, np.ndarray]:
        q = quantize(cut)
        q = q.detach().cpu().numpy() if isinstance(q, torch.Tensor) \
            else np.asarray(q)
        mask = pairwise_mask(self.root, self.owner_index, self.n_owners,
                             tag, q.shape)
        # uint32 arithmetic wraps mod 2^32: the ring addition
        return {"mq": q.view(np.uint32) + mask}


def fold_quantized(qs: Sequence[np.ndarray]) -> np.ndarray:
    """Ring-sum unmasked int32 quantized cuts (the joint oracle's
    combine): mod-2^32 addition in owner order, viewed back as int32.
    Integer addition is associative, so this equals the masked wire fold
    bit for bit once the masks cancel."""
    acc: Optional[np.ndarray] = None
    for q in qs:
        u = np.asarray(q).view(np.uint32)
        acc = u.astype(np.uint32, copy=True) if acc is None else acc + u
    assert acc is not None, "fold_quantized needs >= 1 owner"
    return acc.view(np.int32)


def reconstruct(payloads: List[Dict[str, np.ndarray]]) -> np.ndarray:
    """The scientist's combine: fold every owner's masked uint32 payload
    mod 2^32.  The pairwise masks sum to zero in the ring, so the result
    is the unmasked integer sum, and no owner's activation can be read
    from its frame."""
    acc: Optional[np.ndarray] = None
    for pl in payloads:
        mq = np.asarray(pl["mq"])
        if mq.dtype != np.uint32:
            mq = mq.view(np.uint32)
        acc = mq.astype(np.uint32, copy=True) if acc is None else acc + mq
    assert acc is not None, "reconstruct needs >= 1 owner payload"
    return acc.view(np.int32)
