"""Diffie–Hellman Private Set Intersection, ``noinv`` variant, serial
(a copy of the parts of ``repro.core.psi`` that the default resolve
runs: ``mode="noinv"``, ``parallelism=0``).

Both parties hash into the subgroup QR_p of a safe-prime MODP group
(p = 2q + 1) via H(x) = sha256^*(x)^2 mod p.  The client (the data
scientist) holds X and a short secret α; a server (a data owner) holds Y
and a short secret β:

  * client -> server:  A_i = H(x_i)^α                      (blinded)
  * server -> client:  D_i = A_i^β = H(x_i)^{αβ}            (in order)
  * server -> client:  { H(y_j)^β }  (deduplicated, secret-shuffled),
    which the client lifts to T_j = H(y_j)^{αβ} and matches exactly.

No modular inverse is needed anywhere, every leg is a short
exponentiation, and there are no false positives.  Only the client
learns the intersection; the server learns only |X|.  The bloom and
membership-hiding variants, the delta protocol and the worker pool are
queued in ROADMAP.md.
"""
from __future__ import annotations

import hashlib
import secrets
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.modexp import hashpow_chunk, pow_chunk

# RFC 3526, 2048-bit MODP group: p is a safe prime (p = 2q + 1).
P_HEX = (
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF"
)
PRIME = int(P_HEX, 16)

# 512-bit safe prime — NOT for production use; selectable via
# group="modp512" to keep test and demo wall-time sane.
P512 = int(
    "fb8def3a572e8dc20670083d0a2a21dd4499d394148beb09ecd2f93a018018d0"
    "af9a57a96a9172dc5baba339cccd0f6fccb7fdc53fb67c330afe160326d4cd17", 16)

GROUPS = {
    "modp2048": (PRIME, (PRIME - 1) // 2, 256),
    "modp512": (P512, (P512 - 1) // 2, 64),
}

# Short-exponent width (bits) per group: twice the group's classical
# security level (RFC 7919 §5.2).
SHORT_BITS = {"modp2048": 256, "modp512": 128}

#: streaming granularity — elements per chunk
DEFAULT_CHUNK = 4096


def _sample_exponent(exp_bits: int) -> int:
    """A secret short exponent with exactly ``exp_bits`` bits."""
    return secrets.randbits(exp_bits - 1) | (1 << (exp_bits - 1))


def _chunk_slices(total: int, size: int) -> Iterator[Tuple[int, int]]:
    for i in range(0, total, size):
        yield i, min(i + size, total)


class PSIClient:
    """The data scientist's side.  One client per session: its blinded
    set is computed once and reused against every owner."""

    def __init__(self, items: Sequence[str], group: str = "modp2048"):
        self.items = list(items)
        self.group = group
        self._p, self._q, self._nb = GROUPS[group]
        self._blind_exp = _sample_exponent(SHORT_BITS[group])
        self._blinded_packed: Optional[bytes] = None

    def blind_packed(self, chunk_size: int = DEFAULT_CHUNK) -> bytes:
        """The packed blinded set A_i = H(x_i)^α (memoized)."""
        if self._blinded_packed is None:
            items, p, nb, a = self.items, self._p, self._nb, self._blind_exp
            self._blinded_packed = b"".join(
                hashpow_chunk((items[lo:hi], a, p, nb))
                for lo, hi in _chunk_slices(len(items), chunk_size))
        return self._blinded_packed

    def match_double_blinded(self, d_blob: bytes,
                             t_blob: bytes) -> List[str]:
        """Exact membership of { D_i } in the lifted server set { T_j } —
        client order, no false positives."""
        hits = _exact_membership(d_blob, t_blob, self._nb)
        return [self.items[i] for i in np.nonzero(hits)[0]]


class PSIServer:
    """A data owner's side.  Its β-blinded own set is built once per
    session (deduplicated and secret-shuffled, so Y's row order and
    multiplicities stay private)."""

    def __init__(self, items: Sequence[str], group: str = "modp2048"):
        self.items = list(items)
        self.group = group
        self._p, self._q, self._nb = GROUPS[group]
        self._beta = _sample_exponent(SHORT_BITS[group])
        self._own_packed: Optional[bytes] = None

    def own_blinded_packed(self, chunk_size: int = DEFAULT_CHUNK) -> bytes:
        """The packed { H(y_j)^β }, deduplicated and shuffled by a
        permutation derived from β and the item set."""
        if self._own_packed is None:
            items = list(dict.fromkeys(self.items))
            p, nb, b = self._p, self._nb, self._beta
            packed = b"".join(
                hashpow_chunk((items[lo:hi], b, p, nb))
                for lo, hi in _chunk_slices(len(items), chunk_size))
            h = hashlib.sha256(b"psi-own-shuffle")
            h.update(self._beta.to_bytes(nb, "big"))
            for it in items:
                h.update(it.encode())
            rng = np.random.default_rng(int.from_bytes(h.digest(), "big"))
            perm = rng.permutation(len(items))
            self._own_packed = b"".join(packed[j * nb:(j + 1) * nb]
                                        for j in perm)
        return self._own_packed

    def respond_chunks(self, blinded_packed: bytes,
                       chunk_size: int = DEFAULT_CHUNK) -> Iterator[bytes]:
        """D_i = A_i^β in client order, chunked."""
        nbytes = chunk_size * self._nb
        for o in range(0, len(blinded_packed), nbytes):
            yield pow_chunk((blinded_packed[o:o + nbytes], self._beta,
                             self._p, self._nb))


def _keys64(blob: bytes, nb: int) -> np.ndarray:
    """64-bit prefilter keys: the leading 8 bytes of each element."""
    a = np.frombuffer(blob, np.uint8).reshape(-1, nb)[:, :8]
    return a.copy().view(">u8").ravel().astype(np.uint64)


def _exact_membership(d_blob: bytes, t_blob: bytes, nb: int) -> np.ndarray:
    """Per-element: is d_i in {t_j}?  Vectorized 64-bit prefilter, then
    an exact full-width confirm on the candidates."""
    dk, tk = _keys64(d_blob, nb), _keys64(t_blob, nb)
    cand = np.isin(dk, tk)
    if not cand.any():
        return cand
    t_sel = np.isin(tk, dk[cand])
    t_set = {t_blob[j * nb:(j + 1) * nb] for j in np.nonzero(t_sel)[0]}
    out = np.zeros(len(dk), bool)
    for i in np.nonzero(cand)[0]:
        out[i] = d_blob[i * nb:(i + 1) * nb] in t_set
    return out


def psi_round(client: PSIClient, server: PSIServer, *,
              chunk_size: int = DEFAULT_CHUNK,
              on_message: Optional[Callable[[str, int], None]] = None
              ) -> Tuple[List[str], Dict[str, object]]:
    """One noinv round between existing party objects.  ``on_message(kind,
    n_bytes)`` observes every simulated wire message
    (``psi_blind_chunk`` / ``psi_server_set_chunk`` / ``psi_double_chunk``)."""
    if client.group != server.group:
        raise ValueError(f"group mismatch: client {client.group!r} "
                         f"!= server {server.group!r}")
    emit = on_message or (lambda kind, n_bytes: None)
    nb, p = client._nb, client._p
    blind_cached = client._blinded_packed is not None

    blinded = client.blind_packed(chunk_size)
    for lo, hi in _chunk_slices(len(client.items), chunk_size):
        emit("psi_blind_chunk", (hi - lo) * nb)

    own = server.own_blinded_packed(chunk_size)
    cb = chunk_size * nb
    t_parts = []
    for o in range(0, len(own), cb):
        emit("psi_server_set_chunk", len(own[o:o + cb]))
        t_parts.append(pow_chunk((own[o:o + cb], client._blind_exp, p, nb)))
    t_blob = b"".join(t_parts)

    d_parts = []
    for packed in server.respond_chunks(blinded, chunk_size):
        emit("psi_double_chunk", len(packed))
        d_parts.append(packed)
    d_blob = b"".join(d_parts)

    inter = client.match_double_blinded(d_blob, t_blob)
    stats = {
        "mode": "noinv",
        "client_upload_bytes": len(blinded),
        "server_response_bytes": len(d_blob) + len(own),
        "server_set_bytes": len(own),
        "blind_cached": blind_cached,
        "n_chunks": max(1, -(-len(client.items) // chunk_size)),
    }
    return inter, stats
