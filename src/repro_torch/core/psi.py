"""Diffie–Hellman Private Set Intersection, streamed and parallel (the
port's copy of ``repro.core.psi``: the same protocol variants, legs,
packed bytes, stats and op counts).

Both parties hash into the subgroup QR_p of quadratic residues of a
safe-prime MODP group (p = 2q + 1, RFC 3526 §3 for the 2048-bit group)
via H(x) = sha256^*(x)^2 mod p.  The client (the data scientist) holds
X and secret α; a server (a data owner) holds Y and secret β.  The
protocol variants share the same first two legs:

  * client -> server:  A_i = H(x_i)^α                (blinded, chunked)
  * server -> client:  B_i = A_i^β = H(x_i)^{αβ}     (double-blinded,
                       ordered, chunked)

``mode="noinv"`` (default) — classic ECDH-PSI, compared in the
double-blinded domain: the server also streams its own blinded set
{ H(y_j)^β } (deduplicated and secret-shuffled, so Y's row order and
multiplicities stay private), the client lifts it with its short α to
T_j = H(y_j)^{αβ} and matches { B_i } against { T_j } exactly.  Every
leg is a short exponentiation, and there are no false positives.

``mode="bloom"`` — Angelou et al. 2020: the server's set crosses as a
:class:`~repro_torch.core.bloom.ShardedBloom` over { H(y_j)^β } (false
positives bounded by ``fp_rate``), and the client recovers
H(x_i)^β = B_i^{α^{-1} mod q} to probe it.  The full-width inverse lands
on the memoized blind leg (short γ, α = γ^{-1} mod q), paid once per
session.

``mode="hidden"`` — membership hiding: noinv's legs, but the lifted
server set returns to the owner, which matches and replies with a keep
set of client positions padded with deterministic decoys
(``HIDDEN_PAD``, ``decoy_row``).  The scientist learns an aligned row
order, never which raw IDs matched.

Only the client learns an intersection; the server learns only |X|.

Every chunk kernel (hash+blind fused, double-blind, lift/unblind) runs
through a :class:`~repro_torch.core.modexp.ModexpPool`; ``parallelism=0``
runs the identical kernels in-process, so the results are bit-identical
for every pool and chunk size.  ``PSIClient.update_items`` splices the
memoized upload after churn in O(Δ) modexp and records the delta the
wire engine (``federation/psi_transport.py``) ships.  This module
imports no torch.
"""
from __future__ import annotations

import hashlib
import secrets
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.bloom import ShardedBloom
from repro_torch.core.modexp import ModexpPool, hashpow_chunk
from repro_torch.core.modexp import hash_to_group as _hash_to_group
from repro_torch.core.modexp import pack_ints, pow_chunk, unpack_ints

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
Q = (PRIME - 1) // 2

# 512-bit safe prime (locally generated, Miller-Rabin verified).  NOT for
# production use — selectable via group="modp512" to keep CI/test/demo
# wall-time sane on hosts where a 2048-bit modexp costs ~30 ms.
P512 = int(
    "fb8def3a572e8dc20670083d0a2a21dd4499d394148beb09ecd2f93a018018d0"
    "af9a57a96a9172dc5baba339cccd0f6fccb7fdc53fb67c330afe160326d4cd17", 16)

GROUPS = {
    "modp2048": (PRIME, (PRIME - 1) // 2, 256),
    "modp512": (P512, (P512 - 1) // 2, 64),
}

# Short-exponent width (bits), per group.  The rule is twice the group's
# classical security level (RFC 7919 §5.2): modp2048 offers ~112 bits, so
# 256-bit exponents leave margin; the 512-bit toy group offers at most
# ~60 bits against NFS, so 128-bit exponents already exceed the 2x rule —
# wider ones would just burn squarings a demo group can't justify.
SHORT_EXP_BITS = 256
SHORT_BITS = {"modp2048": 256, "modp512": 128}

#: sentinel — "the group's own short-exponent width"
AUTO = "auto"


def _resolve_exp_bits(exp_bits, group: str) -> Optional[int]:
    return SHORT_BITS[group] if exp_bits == AUTO else exp_bits

#: streaming granularity — elements per pipeline chunk
DEFAULT_CHUNK = 4096

#: protocol variants (see module docstring):
#:   "noinv" — classic ECDH-PSI: compare in the double-blinded domain.
#:             Every leg is a short exponentiation (no modular inverse
#:             anywhere), intersections are exact (no Bloom false
#:             positives), but the server's response carries its own
#:             blinded set uncompressed (~2x the download of "bloom").
#:   "bloom" — Angelou et al. (the library PyVertical ships): the server
#:             set crosses the wire as a sharded Bloom filter (~12x
#:             compressed), which forces the client to unblind via
#:             α^{-1} — one full-width-exponent leg per session.
DEFAULT_MODE = "noinv"

#: all protocol variants.  "hidden" is the membership-hiding variant:
#: noinv machinery, but the *owner* performs the match (the double-blind
#: leg never returns to the client) and replies with a padded keep-set
#: of client row positions — the scientist learns an aligned row order,
#: never which raw IDs matched (see ``_round_hidden``).
MODES = ("noinv", "bloom", "hidden")

#: membership-hiding pad quantum: the keep-set is padded with
#: deterministic decoy positions up to a multiple of this, so the frame
#: length quantizes away ±1 membership differences (invariant 12)
HIDDEN_PAD = 32

#: Knuth multiplicative hash constant — maps a decoy keep-position to a
#: deterministic pseudo-row so decoy map entries are byte-uniform with
#: member entries (and bit-stable across backends/sessions)
_DECOY_MULT = 2654435761


def blind_tag(blinded_packed: bytes) -> bytes:
    """16-byte content tag of a packed blinded set.  Derived from
    already-blinded group elements, so it reveals nothing the blob
    itself doesn't; equal blobs get equal tags, which is what lets a
    peer skip a byte-identical retransmission (and what addresses the
    delta protocol's base-state check)."""
    return hashlib.sha256(blinded_packed).digest()[:16]


def decoy_row(position: int, n_rows: int) -> int:
    """The deterministic pseudo-row a hidden-mode decoy position maps
    to.  Pure data-determined arithmetic: bit-stable across backends."""
    return (position * _DECOY_MULT) % max(1, n_rows)


def hash_to_group(item: bytes, prime: int = PRIME, nbytes: int = 256) -> int:
    """H(x) = (sha256-derived integer mod p)^2, in QR_p (order q); it
    lives in :mod:`repro_torch.core.modexp`, beside the chunk kernels
    that fuse it with the blinding."""
    return _hash_to_group(item, prime, nbytes)


def _sample_exponent(q: int, exp_bits: Optional[int] = SHORT_EXP_BITS) -> int:
    """A secret exponent in [2, q).  ``exp_bits`` bounds its width for
    short-exponent DH (None = full-width uniform)."""
    if exp_bits is None or exp_bits >= q.bit_length() - 1:
        return secrets.randbelow(q - 2) + 2
    # top bit forced so the exponent has exactly exp_bits bits
    return secrets.randbits(exp_bits - 1) | (1 << (exp_bits - 1))


def _enc(x: int, nbytes: int = 256) -> bytes:
    return x.to_bytes(nbytes, "big")


def _chunk_slices(total: int, size: int) -> Iterator[Tuple[int, int]]:
    for i in range(0, total, size):
        yield i, min(i + size, total)


class PSIClient:
    """The data scientist's side.  One client object per session: its
    blinded set is computed once (packed) and reused across every owner
    round (the secret is per-session, so re-blinding per owner would buy
    nothing but modexps).

    Exponent orientation depends on the protocol mode:

      * ``noinv`` — α itself is short; no inverse is ever needed (the
        comparison happens in the double-blinded domain), so every leg
        of every round is a short exponentiation.
      * ``bloom`` — the short secret is the **unblind** exponent γ; the
        blind exponent is α = γ^{-1} mod q (full-width, paid once per
        session inside the memoized ``blind_packed``).  Every per-owner
        leg the client runs afterwards is short."""

    def __init__(self, items: Sequence[str], group: str = "modp2048",
                 exp_bits=AUTO, mode: str = DEFAULT_MODE):
        if mode not in MODES:
            raise ValueError(f"unknown PSI mode {mode!r}")
        self.items = items
        self.group = group
        self.mode = mode
        self.exp_bits = exp_bits = _resolve_exp_bits(exp_bits, group)
        self._p, self._q, self._nb = GROUPS[group]
        if mode == "bloom":
            # γ short; α = γ^{-1}: the full-width leg lands on the
            # memoized blind, the per-round unblind stays short
            self._unblind_exp = _sample_exponent(self._q, exp_bits)
            self._blind_exp = pow(self._unblind_exp, -1, self._q)
        else:
            self._blind_exp = _sample_exponent(self._q, exp_bits)
            self._unblind_exp = None            # noinv/hidden never unblind
        self._blinded_packed: Optional[bytes] = None
        self._blinded: Optional[List[int]] = None      # ``blind()``'s ints
        #: cumulative modular exponentiations submitted by this client
        #: (one per set element per leg) — the delta gate's cost metric
        self.ops = 0
        # delta-resolution state: ``_base_*`` snapshot the last state a
        # peer may hold cached; ``_delta`` is the base -> current diff
        self._delta: Optional[dict] = None
        self._base_items: Optional[List[str]] = None
        self._base_packed: Optional[bytes] = None
        #: per-peer cached round artifacts (written only on round
        #: success by the wire engine) — keyed by owner name
        self.round_cache: Dict[str, dict] = {}

    # -- blinding ----------------------------------------------------------
    def blind_packed(self, pool: Optional[ModexpPool] = None,
                     chunk_size: int = DEFAULT_CHUNK) -> bytes:
        """The packed blinded set A_i = H(x_i)^α — computed once per
        session (hash fused with the exponentiation in the chunk kernel),
        then reused against every owner."""
        if self._blinded_packed is None:
            pool = pool or ModexpPool(0)
            items, p, nb, a = self.items, self._p, self._nb, self._blind_exp
            self.ops += len(items)
            parts = pool.imap(
                hashpow_chunk,
                ((list(items[lo:hi]), a, p, nb)
                 for lo, hi in _chunk_slices(len(items), chunk_size)))
            self._blinded_packed = b"".join(parts)
        return self._blinded_packed

    def blind(self) -> List[int]:
        """The one-shot API: the blinded set as ints (memoized)."""
        if self._blinded is None:
            self._blinded = unpack_ints(self.blind_packed(), self._nb)
        return self._blinded

    def reset_session(self) -> None:
        """Drop the memoized blinded set and the delta and round state,
        keeping the secrets: a fresh round with the same exponents."""
        self._blinded_packed = None
        self._blinded = None
        self._delta = None
        self._base_items = None
        self._base_packed = None
        self.round_cache.clear()

    # -- delta resolution --------------------------------------------------
    def update_items(self, new_items: Sequence[str],
                     pool: Optional[ModexpPool] = None,
                     chunk_size: int = DEFAULT_CHUNK) -> None:
        """Replace the client's item set with ``new_items``, splicing the
        memoized blinded set in O(Δ) modexp (only genuinely *new* items
        are hash+blinded) and recording a base -> current diff the wire
        engine ships as a ``psi_delta_chunk`` (removal tombstones +
        appended additions) instead of a full re-upload.

        Multiset semantics; the retained items keep their base positional
        order (additions append), so the recorded removal positions index
        into the base upload a peer holds cached.  The base snapshot is
        rebased lazily: consecutive updates before the next round compose
        into one diff against the same base.  When nothing was blinded
        yet, when no items survive (100% churn), or when the diff would
        outweigh a full upload, the delta is dropped and the next round
        falls back to the full protocol."""
        from collections import Counter
        new = list(new_items)
        nb = self._nb
        if list(self.items) == new:
            return
        if self._blinded_packed is None:
            self.items = new
            self._delta = None
            return
        if self._delta is None:
            # rebase: current state is what peers may have cached
            self._base_items = list(self.items)
            self._base_packed = self._blinded_packed
        base_items, base_packed = self._base_items, self._base_packed

        # multiset diff base -> new: keep the first new-count occurrences
        # of every base item (positional order), append the surplus
        new_counts = Counter(new)
        quota = dict(new_counts)
        retained: List[int] = []
        removed: List[int] = []
        for i, it in enumerate(base_items):
            if quota.get(it, 0) > 0:
                quota[it] -= 1
                retained.append(i)
            else:
                removed.append(i)
        surplus = {k: v for k, v in quota.items() if v > 0}
        added: List[str] = []
        for it in new:
            if surplus.get(it, 0) > 0:
                surplus[it] -= 1
                added.append(it)

        added_packed = b""
        if added:
            pool = pool or ModexpPool(0)
            p, a = self._p, self._blind_exp
            self.ops += len(added)
            added_packed = b"".join(pool.imap(
                hashpow_chunk,
                ((added[lo:hi], a, p, nb)
                 for lo, hi in _chunk_slices(len(added), chunk_size))))

        import numpy as np
        rows = np.frombuffer(base_packed, np.uint8).reshape(-1, nb)
        kept = rows[retained].tobytes() if retained else b""
        self._blinded_packed = kept + added_packed
        self._blinded = None
        self.items = [base_items[i] for i in retained] + added

        delta_bytes = len(added_packed) + 8 * len(removed)
        worthwhile = (retained
                      and delta_bytes < len(self._blinded_packed)
                      and (removed or added))
        if not (removed or added):
            self._delta = None          # empty delta: tags already equal
        elif worthwhile:
            self._delta = {
                "base_tag": blind_tag(base_packed),
                "tag": blind_tag(self._blinded_packed),
                "retained": retained,
                "removed": removed,
                "added_packed": added_packed,
            }
        else:                           # 100% churn / diff >= full upload
            self._delta = None

    def rebase_delta(self) -> None:
        """Forget the delta base (typically after every peer has seen
        the current upload): the next ``update_items`` diffs against the
        state as of this call, keeping composed diffs bounded."""
        self._delta = None
        self._base_items = None
        self._base_packed = None

    # -- unblind + membership (bloom-mode legs) ----------------------------
    @property
    def unblind_exp(self) -> Optional[int]:
        """α^{-1} mod q, short by construction: the unblind exponent of
        a ``bloom`` client (the other modes never unblind: None)."""
        return self._unblind_exp

    def _match_packed(self, unblinded: bytes, bloom, lo: int) -> List[str]:
        nb = self._nb
        els = [unblinded[i:i + nb] for i in range(0, len(unblinded), nb)]
        hits = bloom.query_batch(els)
        return [self.items[lo + j] for j in range(len(els)) if hits[j]]

    # -- per-chunk leg hooks (shared with the wire engine) -----------------
    #
    # ``federation/psi_transport.py`` runs the protocol one transport
    # Message per chunk.  Its client legs submit the same ``pow_chunk``
    # task shape the in-process rounds below do (exp/prime/width from
    # this object), and finish through these match methods — the two
    # engines share their per-chunk compute, so bit-identity is by
    # construction.

    def match_bloom_chunk(self, unblinded: bytes, bloom,
                          base: int) -> List[str]:
        """bloom leg: probe one unblinded chunk (client items starting at
        ``base``) against the server's ShardedBloom."""
        return self._match_packed(unblinded, bloom, base)

    def match_double_blinded(self, d_blob: bytes,
                             t_blob: bytes) -> List[str]:
        """noinv finish: exact membership of the double-blinded client
        set { D_i } in the lifted server set { T_j } — client order,
        duplicates preserved, no false positives."""
        import numpy as np
        hits = _exact_membership(d_blob, t_blob, self._nb)
        return [self.items[i] for i in np.nonzero(hits)[0]]

    def intersect(self, double_blinded: Sequence[int],
                  server_bloom) -> List[str]:
        """The one-shot API: the intersection from an unchunked
        bloom-mode response (:meth:`PSIServer.respond`).  A client of
        another mode unblinds with α^{-1} mod q (full width)."""
        exp = self._unblind_exp
        if exp is None:
            exp = pow(self._blind_exp, -1, self._q)
        packed = pack_ints(list(double_blinded), self._nb)
        unb = pow_chunk((packed, exp, self._p, self._nb))
        return self._match_packed(unb, server_bloom, 0)


class PSIServer:
    """A data owner's side.  β is short; both server legs (double-blind,
    Bloom build) are short exponentiations.  The Bloom over the β-blinded
    own set is built once per session (sharded, streamed) and reused
    across rounds with the same client."""

    def __init__(self, items: Sequence[str], fp_rate: float = 1e-9,
                 group: str = "modp2048", exp_bits=AUTO,
                 beta: Optional[int] = None):
        self.items = items
        self.fp_rate = fp_rate
        self.group = group
        self._p, self._q, self._nb = GROUPS[group]
        # ``beta`` re-injects an existing session secret — a respawned
        # owner worker must reproduce byte-identical response legs, or
        # every client-side content-tag cache would miss
        self._beta = (beta if beta is not None else
                      _sample_exponent(self._q,
                                       _resolve_exp_bits(exp_bits, group)))
        self._bloom: Optional[ShardedBloom] = None
        self._own_packed: Optional[bytes] = None
        #: shuffled-position -> own row index, retained alongside
        #: ``_own_packed`` (hidden mode matches on the owner's side and
        #: must map a matched shuffled element back to its data row)
        self._own_rows: Optional[List[int]] = None
        # per-item blinded elements (H(y)^β), kept so owner-side churn
        # re-blinds only genuinely new items (O(Δ) modexp)
        self._own_elems: Dict[str, bytes] = {}
        #: cumulative modular exponentiations performed by this server
        self.ops = 0

    def build_bloom(self, pool: Optional[ModexpPool] = None,
                    chunk_size: int = DEFAULT_CHUNK) -> ShardedBloom:
        """ShardedBloom{ H(y_j)^β } — worker chunks hash+exponentiate,
        the parent streams vectorized shard adds."""
        if self._bloom is None:
            pool = pool or ModexpPool(0)
            items, p, nb, b = self.items, self._p, self._nb, self._beta
            self.ops += len(items)
            bf = ShardedBloom.for_capacity(len(items), self.fp_rate)
            for packed in pool.imap(
                    hashpow_chunk,
                    ((list(items[lo:hi]), b, p, nb)
                     for lo, hi in _chunk_slices(len(items), chunk_size))):
                bf.add_batch([packed[i:i + nb]
                              for i in range(0, len(packed), nb)])
            self._bloom = bf
        return self._bloom

    def reset_session(self) -> None:
        """Drop the memoized response side (keeping β); see
        :meth:`PSIClient.reset_session`."""
        self._bloom = None
        self._own_packed = None
        self._own_rows = None
        self._own_elems = {}

    def respond(self, blinded: Sequence[int]):
        """The one-shot API: (the double-blinded client set in order,
        the bloom over the owner's set)."""
        packed = pack_ints(list(blinded), self._nb)
        double = unpack_ints(
            pow_chunk((packed, self._beta, self._p, self._nb)), self._nb)
        return double, self.build_bloom()

    def update_items(self, new_items: Sequence[str]) -> None:
        """Replace the owner's item set.  The per-item blinded elements
        are kept, so re-deriving the response leg costs O(Δ) modexp
        (only new items are blinded); the packed own set, its shuffle,
        and the bloom are rebuilt lazily — their content tags change,
        which is what invalidates any peer-side response-leg cache."""
        new = list(new_items)
        if list(self.items) == new:
            return
        self.items = new
        self._bloom = None
        self._own_packed = None
        self._own_rows = None
        if len(self._own_elems) > 2 * max(1, len(new)):
            keep = set(new)
            self._own_elems = {k: v for k, v in self._own_elems.items()
                               if k in keep}

    def own_blinded_packed(self, pool: Optional[ModexpPool] = None,
                           chunk_size: int = DEFAULT_CHUNK) -> bytes:
        """The packed β-blinded own set { H(y_j)^β } — the uncompressed
        server response of the ``noinv`` variant.  Memoized (at-rest
        packed bytes) and reused across rounds with the same client.

        Deduplicated and secret-shuffled before it ever leaves: row
        order and duplicate multiplicity in Y are NOT part of what the
        protocol reveals (standard ECDH-PSI practice — a client could
        otherwise locate each matched record's position in the owner's
        dataset).  The intersection is order-invariant, so the shuffle
        never affects results."""
        if self._own_packed is None:
            import numpy as np
            pool = pool or ModexpPool(0)
            items = list(dict.fromkeys(self.items))
            p, nb, b = self._p, self._nb, self._beta
            missing = [it for it in items if it not in self._own_elems]
            if missing:
                self.ops += len(missing)
                packed = b"".join(pool.imap(
                    hashpow_chunk,
                    ((missing[lo:hi], b, p, nb)
                     for lo, hi in _chunk_slices(len(missing),
                                                 chunk_size))))
                for k, it in enumerate(missing):
                    self._own_elems[it] = packed[k * nb:(k + 1) * nb]
            first_row: Dict[str, int] = {}
            for r, it in enumerate(self.items):
                first_row.setdefault(it, r)
            # secret shuffle, derived from β + the item set: unknowable
            # without the secret (the client still can't locate rows),
            # but *stable* across memoization drops and worker respawns
            # — the response leg's content tag must not change unless
            # the data does
            h = hashlib.sha256(b"psi-own-shuffle")
            h.update(_enc(self._beta, self._nb))
            for it in items:
                h.update(it.encode() if isinstance(it, str) else it)
            rng = np.random.default_rng(int.from_bytes(h.digest(), "big"))
            perm = rng.permutation(len(items))
            self._own_packed = b"".join(self._own_elems[items[j]]
                                        for j in perm)
            self._own_rows = [first_row[items[j]] for j in perm]
        return self._own_packed

    def server_leg_tag(self, mode: str,
                       pool: Optional[ModexpPool] = None,
                       chunk_size: int = DEFAULT_CHUNK) -> bytes:
        """Content tag of the response leg a client of ``mode`` would
        receive (packed own set, or the bloom's shard frames) — what the
        wire protocol's response-leg cache is keyed by."""
        if mode == "bloom":
            return self.build_bloom(pool, chunk_size).content_tag()
        return blind_tag(self.own_blinded_packed(pool, chunk_size))

    def hidden_match(self, d_blob: bytes, t_blob: bytes,
                     pad: int = HIDDEN_PAD) -> Tuple[List[int], List[int]]:
        """Owner-side membership-hiding finish: match the double-blinded
        client set { D_i } (client order) against the lifted own set
        { T_j } (shuffled order), then hide *which* kept positions
        matched.  Returns ``(keep, rows)``:

          * ``keep`` — sorted client positions, the true members padded
            with decoys (the smallest unmatched positions) up to a
            multiple of ``pad``, so a captured frame's length quantizes
            away ±1 membership differences;
          * ``rows`` — for each kept position, the owner data row to
            align (true row for members via the retained shuffle
            permutation; a deterministic pseudo-row for decoys).  Member
            and decoy entries are byte-uniform int64s.

        Everything is data-determined (set membership, smallest-position
        decoys, arithmetic pseudo-rows), so the result is bit-stable
        across backends and repeat rounds."""
        import numpy as np
        nb = self._nb
        assert self._own_rows is not None, \
            "own_blinded_packed must run before hidden_match"
        hits = _exact_membership(d_blob, t_blob, nb)
        t_pos = {t_blob[j * nb:(j + 1) * nb]: j
                 for j in range(len(t_blob) // nb)}
        row_of: Dict[int, int] = {}
        for i in np.nonzero(hits)[0]:
            i = int(i)
            row_of[i] = self._own_rows[t_pos[d_blob[i * nb:(i + 1) * nb]]]
        n_cli = len(d_blob) // nb
        members = sorted(row_of)
        target = min(n_cli, -(-max(len(members), 1) // pad) * pad)
        keep = list(members)
        member_set = set(members)
        for i in range(n_cli):
            if len(keep) >= target:
                break
            if i not in member_set:
                keep.append(i)
        keep.sort()
        n_rows = len(self.items)
        rows = [row_of.get(i, decoy_row(i, n_rows)) for i in keep]
        return keep, rows

    def respond_chunk(self, packed: bytes) -> bytes:
        """One packed blinded chunk -> its double-blinded response,
        B_i = A_i^β (order preserved) — the per-chunk server kernel the
        wire engine (``federation/psi_transport``) calls per Message."""
        self.ops += len(packed) // self._nb
        return pow_chunk((packed, self._beta, self._p, self._nb))

    def respond_chunks(self, blinded_packed: bytes,
                       pool: Optional[ModexpPool] = None,
                       chunk_size: int = DEFAULT_CHUNK
                       ) -> Iterator[Tuple[int, bytes]]:
        """Stream (base_index, double-blinded packed chunk) — B_i = A_i^β
        in client order, chunked."""
        pool = pool or ModexpPool(0)
        p, nb, b = self._p, self._nb, self._beta
        self.ops += len(blinded_packed) // nb
        nbytes = chunk_size * nb
        offsets = range(0, len(blinded_packed), nbytes)
        for off, packed in zip(
                offsets,
                pool.imap(pow_chunk,
                          ((blinded_packed[o:o + nbytes], b, p, nb)
                           for o in offsets))):
            yield off // nb, packed

# ---------------------------------------------------------------------------
# The streaming round
# ---------------------------------------------------------------------------


def _keys64(blob: bytes, nb: int) -> "np.ndarray":
    """64-bit prefilter keys: the leading 8 bytes of each packed group
    element (≈ uniform — elements are random mod a ~2^(8·nb) prime)."""
    import numpy as np
    a = np.frombuffer(blob, np.uint8).reshape(-1, nb)[:, :8]
    # native-endian uint64 — np.isin rejects explicit byte-order dtypes
    return a.copy().view(">u8").ravel().astype(np.uint64)


def _exact_membership(d_blob: bytes, t_blob: bytes, nb: int):
    """Per-element: is d_i ∈ {t_j}?  Vectorized 64-bit prefilter, then
    an exact full-width confirm on the (intersection-sized) candidate
    set — no false positives, duplicates preserved."""
    import numpy as np
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


def _common_stats(client, server, pool, chunk_size) -> dict:
    return {
        "chunk_size": chunk_size,
        "n_chunks": max(1, -(-len(client.items) // chunk_size)),
        "peak_inflight_elements": min(len(client.items),
                                      chunk_size * pool.inflight),
        "parallelism": pool.parallelism if pool.is_parallel else 0,
        "uncompressed_server_set_bytes": client._nb * len(server.items),
    }


def _round_bloom(client, server, pool, chunk_size, emit):
    """Angelou et al.: compressed server response, full-width unblind."""
    nb = client._nb
    blind_cached = client._blinded_packed is not None
    bloom_cached = server._bloom is not None

    # server set -> sharded bloom (β leg), streamed
    bloom = server.build_bloom(pool, chunk_size)
    for frame in bloom.shard_frames():
        emit("psi_bloom_shard", len(frame))

    # client set -> blinded upload (α leg), memoized across owners
    blinded = client.blind_packed(pool, chunk_size)
    for lo, hi in _chunk_slices(len(client.items), chunk_size):
        emit("psi_blind_chunk", (hi - lo) * nb)

    # double-blind (β) -> unblind (γ) -> shard probes, pipelined
    inter: List[str] = []
    client.ops += len(blinded) // nb
    unblind_exp, p = client.unblind_exp, client._p
    double_chunks = server.respond_chunks(blinded, pool, chunk_size)
    offsets: List[int] = []

    def _tapped():
        for lo, packed in double_chunks:
            emit("psi_double_chunk", len(packed))
            offsets.append(lo)
            yield (packed, unblind_exp, p, nb)

    for unb in pool.imap(pow_chunk, _tapped()):
        inter.extend(client._match_packed(unb, bloom, offsets.pop(0)))

    stats = {
        "mode": "bloom",
        "client_upload_bytes": len(blinded),
        "server_response_bytes": len(blinded) + bloom.nbytes(),
        "bloom_bytes": bloom.nbytes(),
        "bloom_shards": bloom.n_shards,
        "blind_cached": blind_cached,
        "server_cached": bloom_cached,
        **_common_stats(client, server, pool, chunk_size),
    }
    return inter, stats


def _round_noinv(client, server, pool, chunk_size, emit):
    """Classic ECDH-PSI: compare in the double-blinded domain — every
    leg short, intersections exact, server set uncompressed."""
    nb, p = client._nb, client._p
    blind_cached = client._blinded_packed is not None
    own_cached = server._own_packed is not None

    # client set -> blinded upload (short α leg), memoized across owners
    blinded = client.blind_packed(pool, chunk_size)
    for lo, hi in _chunk_slices(len(client.items), chunk_size):
        emit("psi_blind_chunk", (hi - lo) * nb)

    # server's β-blinded own set (memoized) streams to the client, which
    # lifts it into the double-blinded domain: T_j = (H(y_j)^β)^α
    own = server.own_blinded_packed(pool, chunk_size)
    cb = chunk_size * nb
    client.ops += len(own) // nb

    def _own_tasks():
        for o in range(0, len(own), cb):
            emit("psi_server_set_chunk", len(own[o:o + cb]))
            yield (own[o:o + cb], client._blind_exp, p, nb)

    t_blob = b"".join(pool.imap(pow_chunk, _own_tasks()))

    # double-blind response D_i = A_i^β, streamed in client order
    d_parts: List[bytes] = []
    for _lo, packed in server.respond_chunks(blinded, pool, chunk_size):
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
        "server_cached": own_cached,
        **_common_stats(client, server, pool, chunk_size),
    }
    return inter, stats


def _round_hidden(client, server, pool, chunk_size, emit):
    """Membership-hiding variant: the first three legs are noinv's, but
    the lifted server set returns to the *owner* (``psi_lift_chunk``)
    and the double-blind products never leave it — the owner matches,
    pads the keep-set with deterministic decoys (``hidden_match``), and
    replies only with padded (position, row) pairs.  The client learns
    an aligned row order; neither a wire observer nor the scientist
    learns which positions are true members."""
    nb, p = client._nb, client._p
    blind_cached = client._blinded_packed is not None
    own_cached = server._own_packed is not None

    blinded = client.blind_packed(pool, chunk_size)
    for lo, hi in _chunk_slices(len(client.items), chunk_size):
        emit("psi_blind_chunk", (hi - lo) * nb)

    own = server.own_blinded_packed(pool, chunk_size)
    cb = chunk_size * nb
    client.ops += len(own) // nb

    def _own_tasks():
        for o in range(0, len(own), cb):
            emit("psi_server_set_chunk", len(own[o:o + cb]))
            yield (own[o:o + cb], client._blind_exp, p, nb)

    t_blob = b"".join(pool.imap(pow_chunk, _own_tasks()))
    for o in range(0, len(t_blob), cb):
        emit("psi_lift_chunk", len(t_blob[o:o + cb]))

    # D_i = A_i^β stays on the owner's side (never emitted)
    d_blob = b"".join(packed for _lo, packed in
                      server.respond_chunks(blinded, pool, chunk_size))
    keep, rows = server.hidden_match(d_blob, t_blob)
    emit("psi_keep_mask", 16 * len(keep))

    stats = {
        "mode": "hidden",
        "client_upload_bytes": len(blinded) + len(t_blob),
        "server_response_bytes": len(own) + 16 * len(keep),
        "server_set_bytes": len(own),
        "hidden_rows": rows,
        "hidden_kept": len(keep),
        "blind_cached": blind_cached,
        "server_cached": own_cached,
        **_common_stats(client, server, pool, chunk_size),
    }
    return keep, stats


def psi_round(client: PSIClient, server: PSIServer, *,
              pool: Optional[ModexpPool] = None,
              chunk_size: int = DEFAULT_CHUNK,
              on_message: Optional[Callable] = None
              ) -> Tuple[List[str], dict]:
    """One full PSI round between existing party objects, streamed in
    ``chunk_size`` chunks through ``pool`` (serial when ``None``).

    The protocol variant is the client's ``mode`` (``noinv``/``bloom``,
    see ``DEFAULT_MODE``).  Stage pipeline either way (bounded lookahead
    at every arrow, so peak big-int memory is O(chunk_size · inflight)
    regardless of |X| and |Y|):

        client blind chunks  ->  server double-blind chunks
        server set chunks    ->  client lift/unblind + match chunks

    ``on_message(kind, n_bytes)`` observes every simulated wire message
    (``psi_blind_chunk`` / ``psi_double_chunk`` / ``psi_server_set_chunk``
    / ``psi_bloom_shard``) — the session uses it for transcript
    accounting.  Results are bit-identical across ``pool`` settings:
    chunk order is preserved and every kernel computes exact modular
    arithmetic.
    """
    if client.group != server.group:
        raise ValueError(f"group mismatch: client {client.group!r} "
                         f"!= server {server.group!r}")
    pool = pool or ModexpPool(0)
    emit = on_message or (lambda kind, n_bytes: None)
    if client.mode == "bloom":
        return _round_bloom(client, server, pool, chunk_size, emit)
    if client.mode == "hidden":
        return _round_hidden(client, server, pool, chunk_size, emit)
    return _round_noinv(client, server, pool, chunk_size, emit)


def psi_intersect(client_items: Sequence[str], server_items: Sequence[str],
                  fp_rate: float = 1e-9, group: str = "modp2048",
                  exp_bits=AUTO, *,
                  mode: str = DEFAULT_MODE,
                  chunk_size: int = DEFAULT_CHUNK,
                  parallelism: int = 0,
                  pool: Optional[ModexpPool] = None):
    """One full PSI round from raw item lists.  Returns
    (intersection_as_client_sees_it, stats).  ``parallelism`` > 0 forks
    that many modexp workers (ignored when an explicit ``pool`` is
    passed); the result is bit-identical to the serial engine."""
    client = PSIClient(client_items, group, exp_bits, mode)
    server = PSIServer(server_items, fp_rate, group, exp_bits)
    if pool is not None:
        return psi_round(client, server, pool=pool, chunk_size=chunk_size)
    with ModexpPool(parallelism) as own:
        return psi_round(client, server, pool=own, chunk_size=chunk_size)
