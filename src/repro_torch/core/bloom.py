"""Bloom filters that compress the PSI server's response in ``bloom``
mode (Angelou et al. 2020: DDH-PSI with Bloom-filter compression) — the
port's own copy of ``repro.core.bloom`` (numpy only; the bits, shard
routing and wire frames are the reference's, byte for byte).

  * :class:`BloomFilter` — numpy bitset with enhanced double hashing:
    one sha256 digest per item yields ``h1, h2`` and the k probe indices
    are ``(h1 + i*h2 + (i^3 - i)/6) mod m``.  One digest per add or
    query instead of k, and the batch paths (``add_batch`` /
    ``query_batch``) vectorize the bit arithmetic in numpy.
  * :class:`ShardedBloom` — S independent :class:`BloomFilter` shards;
    each item routes to one shard by its digest.  Shards OR-merge
    (``merge``) for parallel builds, and each shard is an independently
    shippable wire frame (``shard_frames``) of bounded size.

No false negatives ever; false positives bounded by the sizing in
``for_capacity`` (m = -n ln fp / ln^2 2, k = m/n ln 2).
"""
from __future__ import annotations

import hashlib
import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1


def _digest_arrays(items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """One sha256 per item -> (h1, h2, route) uint64 arrays.  h2 is forced
    odd so the double-hash probe sequence spans the whole bitset for any
    m; ``route`` (independent digest bytes) picks the shard."""
    n = len(items)
    h1 = np.empty(n, np.uint64)
    h2 = np.empty(n, np.uint64)
    rt = np.empty(n, np.uint64)
    f = int.from_bytes
    for i, it in enumerate(items):
        d = hashlib.sha256(it).digest()
        h1[i] = f(d[0:8], "big")
        h2[i] = f(d[8:16], "big") | 1
        rt[i] = f(d[16:24], "big")
    return h1, h2, rt


class BloomFilter:
    def __init__(self, n_bits: int, n_hashes: int):
        if n_bits <= 0 or n_hashes <= 0:
            raise ValueError("n_bits and n_hashes must be positive")
        self.m = int(n_bits)
        self.k = int(n_hashes)
        self.bits = np.zeros((self.m + 7) // 8, dtype=np.uint8)

    @classmethod
    def for_capacity(cls, n_items: int, fp_rate: float = 1e-6):
        """Size the filter for ``n_items`` at the target false-positive rate."""
        n_items = max(n_items, 1)
        m = int(-n_items * math.log(max(fp_rate, 1e-12)) / (math.log(2) ** 2))
        k = max(1, round(m / n_items * math.log(2)))
        return cls(max(m, 8), k)

    # -- probe index derivation (shared scalar/batch) ----------------------
    def _indices(self, item: bytes):
        d = hashlib.sha256(item).digest()
        h1 = int.from_bytes(d[0:8], "big")
        h2 = int.from_bytes(d[8:16], "big") | 1
        for i in range(self.k):
            # enhanced double hashing (Dillinger-Manolios): the cubic
            # term keeps the k probes well-spread even when h2 shares a
            # factor with a small composite m — plain h1 + i*h2 then
            # cycles through m/gcd(h2, m) slots and the real fp rate
            # blows past the sizing target on tiny filters
            yield ((h1 + i * h2 + (i * i * i - i) // 6) & _MASK64) % self.m

    def _probe_matrix(self, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
        """(B, k) probe indices — uint64 wraparound matches the scalar
        path's explicit ``& MASK64`` (enhanced double hashing, same
        closed form as ``_indices``)."""
        i = np.arange(self.k, dtype=np.uint64)
        off = (i * i * i - i) // np.uint64(6)
        return ((h1[:, None] + i[None, :] * h2[:, None] + off[None, :])
                % np.uint64(self.m))

    # -- scalar API --------------------------------------------------------
    def add(self, item: bytes):
        for idx in self._indices(item):
            self.bits[idx >> 3] |= 1 << (idx & 7)

    def add_all(self, items: Iterable[bytes]):
        """Streaming add: consumes any iterable in bounded batches (the
        vectorized win without materializing the whole input or an
        O(n·k) probe matrix)."""
        batch: List[bytes] = []
        for it in items:
            batch.append(it)
            if len(batch) >= 65_536:
                self.add_batch(batch)
                batch = []
        self.add_batch(batch)

    def __contains__(self, item: bytes) -> bool:
        return all(self.bits[i >> 3] >> (i & 7) & 1 for i in self._indices(item))

    # -- vectorized batch API ---------------------------------------------
    def add_batch(self, items: Sequence[bytes]) -> None:
        if not items:
            return
        h1, h2, _ = _digest_arrays(items)
        self._add_hashed(h1, h2)

    def _add_hashed(self, h1: np.ndarray, h2: np.ndarray) -> None:
        idx = self._probe_matrix(h1, h2).ravel()
        np.bitwise_or.at(self.bits, (idx >> np.uint64(3)).astype(np.int64),
                         np.left_shift(np.uint8(1),
                                       (idx & np.uint64(7)).astype(np.uint8)))

    def query_batch(self, items: Sequence[bytes]) -> np.ndarray:
        if not items:
            return np.zeros(0, bool)
        h1, h2, _ = _digest_arrays(items)
        return self._query_hashed(h1, h2)

    def _query_hashed(self, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
        idx = self._probe_matrix(h1, h2)
        bit = (self.bits[(idx >> np.uint64(3)).astype(np.int64)]
               >> (idx & np.uint64(7)).astype(np.uint8)) & 1
        return bit.all(axis=1)

    # -- wire --------------------------------------------------------------
    def nbytes(self) -> int:
        """Wire size — what the PSI server actually transmits."""
        return self.bits.nbytes

    def to_bytes(self) -> bytes:
        return self.bits.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, n_bits: int, n_hashes: int):
        bf = cls(n_bits, n_hashes)
        bf.bits = np.frombuffer(data, dtype=np.uint8).copy()
        return bf

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        """OR-merge a same-shaped filter in place (parallel builds)."""
        if (self.m, self.k) != (other.m, other.k):
            raise ValueError("cannot merge differently-shaped filters")
        np.bitwise_or(self.bits, other.bits, out=self.bits)
        return self


class ShardedBloom:
    """S independent shards, routed by digest — the scalable server set.

    ``shard_capacity`` bounds the per-shard item count the sizing assumes;
    the default keeps each shard's bitmap around 256 KiB at fp 1e-9, a
    sane streaming frame.  Membership semantics are identical to one big
    filter (same fp target); the shard layout is deterministic in the
    item bytes, so serial and parallel builds produce identical bits.
    """

    DEFAULT_SHARD_CAPACITY = 65_536

    def __init__(self, shards: List[BloomFilter]):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = shards

    @classmethod
    def for_capacity(cls, n_items: int, fp_rate: float = 1e-6,
                     n_shards: int = 0,
                     shard_capacity: int = DEFAULT_SHARD_CAPACITY):
        n_items = max(n_items, 1)
        s = int(n_shards) or max(1, math.ceil(n_items / shard_capacity))
        per = math.ceil(n_items / s)
        return cls([BloomFilter.for_capacity(per, fp_rate)
                    for _ in range(s)])

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _route(self, rt: np.ndarray) -> np.ndarray:
        return (rt % np.uint64(len(self.shards))).astype(np.int64)

    # -- batch API (the engine's path) ------------------------------------
    def add_batch(self, items: Sequence[bytes]) -> None:
        if not items:
            return
        h1, h2, rt = _digest_arrays(items)
        which = self._route(rt)
        for s in np.unique(which):
            sel = which == s
            self.shards[s]._add_hashed(h1[sel], h2[sel])

    def query_batch(self, items: Sequence[bytes]) -> np.ndarray:
        if not items:
            return np.zeros(0, bool)
        h1, h2, rt = _digest_arrays(items)
        which = self._route(rt)
        out = np.zeros(len(items), bool)
        for s in np.unique(which):
            sel = which == s
            out[sel] = self.shards[s]._query_hashed(h1[sel], h2[sel])
        return out

    # -- scalar compat ----------------------------------------------------
    def add(self, item: bytes) -> None:
        self.add_batch([item])

    def __contains__(self, item: bytes) -> bool:
        return bool(self.query_batch([item])[0])

    # -- wire --------------------------------------------------------------
    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.shards)

    def shard_frames(self) -> List[bytes]:
        """Per-shard wire frames — each independently shippable, so a
        million-ID response streams as bounded messages instead of one
        multi-MB blob."""
        return [s.to_bytes() for s in self.shards]

    def content_tag(self) -> bytes:
        """16-byte content tag over the shard frames + geometry — equal
        filters get equal tags, which is what lets a client skip
        re-downloading a response leg it already holds (the PSI
        ``server_tag`` handshake)."""
        h = hashlib.sha256()
        h.update(f"{self.n_shards}:{self.shards[0].m}:"
                 f"{self.shards[0].k}".encode())
        for frame in self.shard_frames():
            h.update(frame)
        return h.digest()[:16]

    def merge(self, other: "ShardedBloom") -> "ShardedBloom":
        if self.n_shards != other.n_shards:
            raise ValueError("shard count mismatch")
        for a, b in zip(self.shards, other.shards):
            a.merge(b)
        return self
