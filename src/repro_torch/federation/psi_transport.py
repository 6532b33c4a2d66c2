"""Wire-native PSI — entity resolution over the transport layer (the
port's copy of ``repro.federation.psi_transport``: the same protocol
kinds, frames, caches and checks, byte for byte).

Every leg of every protocol variant crosses as a
:class:`~repro_torch.federation.transport.Message` over a queue channel
or a process pipe, so byte counts come from serialized frames, latency
injection applies to every chunk, and tests can hold privacy properties
on the observed traffic.

Cast:

  * :class:`PSIServerEndpoint` — the data owner's actor: on its own
    thread (queue backend) or in its own spawned worker (process
    backend), holding a :class:`~repro_torch.core.psi.PSIServer`; it
    only reacts to inbox messages, and a crash surfaces on the
    scientist's side through a short receive poll.
  * :func:`wire_psi_round` — the data scientist's side: sends the
    hello and the blinded upload, then consumes the server's legs as
    they arrive, feeding each chunk's lift/unblind ``pow_chunk`` task
    through a ``ModexpPool``.

Protocol (kinds in ``WIRE_KINDS``; frame layouts in
``docs/WIRE_PROTOCOL.md`` §1):

  client -> server:
    ``psi_hello``         group/mode/n_items/chunk_size/nb + three
                          16-byte content tags: ``blind_tag`` (the
                          packed blinded upload — lets the server skip a
                          re-upload it has seen), ``base_tag`` (the
                          cached base a delta splices against; zeros =
                          no delta offered), ``server_tag`` (the
                          response leg the client already holds; zeros
                          = none) and a ``have_resp`` flag (the client
                          holds the match artifacts for this
                          (blind_tag, server_tag) pair).
    ``psi_blind_chunk``   packed A_i = H(x_i)^α, ``seq`` = chunk index,
                          ``base`` = element offset, all sent without
                          waiting.
    ``psi_delta_chunk``   the O(Δ) upload: removal tombstones (positions
                          into the cached base upload) + the packed
                          blinded added elements.  The server splices
                          its cached copy and checks the result against
                          ``blind_tag``: a stale or corrupt base fails
                          loudly.
    ``psi_lift_chunk``    hidden mode only: the server's own set lifted
                          into the double-blinded domain by the client,
                          returned so the owner can match.
    ``psi_stop``          shuts the actor down.

  server -> client:
    ``psi_hello_ack``       blind_cached/delta_ok/server_cached flags,
                            the current response-leg ``server_tag``, and
                            the leg geometry (chunk count, or bloom
                            shard parameters).
    ``psi_server_set_chunk``packed { H(y_j)^β } (noinv/hidden;
                            deduplicated + secret-shuffled).  Skipped
                            when ``server_cached``.
    ``psi_bloom_shard``     one ShardedBloom shard bitmap (bloom).
                            Skipped when ``server_cached``.
    ``psi_double_chunk``    packed B_i = A_i^β, mirrors the blind seq
                            (noinv/bloom; never sent in hidden mode).
    ``psi_delta_ack``       the O(Δ) response: double-blinds of the
                            added elements only (empty in hidden mode).
    ``psi_keep_mask``       hidden mode: the padded keep set — sorted
                            client positions (members + deterministic
                            decoys) and the owner row each aligns to.
    ``psi_done``            end-of-round marker: double-chunk count +
                            the server's modexp-op count for the round.

Within each kind, chunks are strictly sequential (``seq`` is checked on
both sides: a reordered or dropped chunk fails with a "PSI protocol
desync" error, never a silently wrong intersection).  Across kinds the
client takes any interleaving through the endpoint's ``recv_kind``
stash.

Every heavy leg is memoized by content tag, so a repeat round with an
unchanged population costs the hello and zero modexp, and a round after
±Δ churn (``PSIClient.update_items``) costs one ``psi_delta_chunk`` /
``psi_delta_ack`` exchange and Δ modexp on each side.  The chunk kernels
are the in-process engine's (``psi_round``), so for any (mode,
chunk_size, parallelism, latency) the intersection equals the
in-process result.  This module imports no torch.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bloom import BloomFilter, ShardedBloom
from repro_torch.core.modexp import ModexpPool, pow_chunk
from repro_torch.core.psi import (DEFAULT_CHUNK, MODES, PSIClient, PSIServer,
                            _chunk_slices, blind_tag)

__all__ = ["PSIServerEndpoint", "wire_psi_round", "serve_psi",
           "WIRE_KINDS", "CLIENT_KINDS", "SERVER_KINDS", "blind_tag"]

#: scientist -> owner message kinds
CLIENT_KINDS = ("psi_hello", "psi_blind_chunk", "psi_delta_chunk",
                "psi_lift_chunk", "psi_stop")
#: owner -> scientist message kinds
SERVER_KINDS = ("psi_hello_ack", "psi_server_set_chunk", "psi_bloom_shard",
                "psi_double_chunk", "psi_delta_ack", "psi_keep_mask",
                "psi_done")
WIRE_KINDS = CLIENT_KINDS + SERVER_KINDS

#: recv poll granularity / default round deadline (mirrors the split
#: loop's owner-crash surfacing: a dead actor raises within ~1 s)
POLL_S = 1.0
DEFAULT_TIMEOUT_S = 120.0

#: the all-zeros content tag: "I hold nothing" in the hello handshake
ZERO_TAG = b"\x00" * 16

#: per-tag cache bound (blind / response / lift caches): tags are
#: content-addressed, so old entries are only ever a byte saving — cap
#: them so churn cycles can't grow owner memory without bound
_CACHE_CAP = 8


def _u8(blob: bytes) -> np.ndarray:
    """Zero-copy uint8 view of a packed byte blob (the frame payload)."""
    return np.frombuffer(blob, np.uint8)


def _scalar(x) -> int:
    """Payload scalar -> int.  Scalars ride the wire as shape-(1,)
    arrays (``ascontiguousarray`` promotes 0-d), so plain ``int()`` is
    deprecated on them."""
    return int(np.asarray(x).reshape(-1)[0])


def _i64list(x) -> List[int]:
    """Payload int64 array -> list of python ints."""
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _cache_put(cache: Dict[bytes, object], key: bytes, value,
               cap: int = _CACHE_CAP) -> None:
    cache[key] = value
    while len(cache) > cap:
        cache.pop(next(iter(cache)))


def _desync(kind: str, got, want) -> RuntimeError:
    return RuntimeError(
        f"PSI protocol desync: {kind} seq {got} != expected {want}")


class PSIServerEndpoint:
    """A data owner's PSI actor: one thread, one transport endpoint, one
    :class:`PSIServer`.  Persistent across rounds — β-side memoization
    (blinded own set / sharded bloom), the client-upload cache, the
    response-leg cache and (hidden mode) the lift cache live as long as
    the actor, so repeat rounds get cheaper in both compute and bytes.

    ``handle`` processes one inbox message and returns False on
    ``psi_stop``; ``run`` is the thread target, parking any exception in
    ``self.error`` for the scientist's receive poll to surface (the
    owner-crash contract split training established)."""

    def __init__(self, name: str, server: PSIServer, endpoint, *,
                 chunk_kernel_pool: Optional[ModexpPool] = None,
                 blind_cache: Optional[Dict[bytes, bytes]] = None,
                 resp_cache: Optional[Dict[bytes, bytes]] = None,
                 lift_cache: Optional[Dict[bytes, bytes]] = None):
        self.name = name
        self.server = server
        self.endpoint = endpoint
        self.pool = chunk_kernel_pool or ModexpPool(0)
        self.error: Optional[BaseException] = None
        self.rounds_served = 0
        # content-tag caches; an owner passes its own dicts here so the
        # byte/compute savings survive actor re-creation
        self._blind_cache = blind_cache if blind_cache is not None else {}
        self._resp_cache = resp_cache if resp_cache is not None else {}
        self._lift_cache = lift_cache if lift_cache is not None else {}
        self._round: Optional[dict] = None
        self._pending: Optional[dict] = None
        self._lift_pending: Optional[dict] = None

    # -- per-message protocol ----------------------------------------------
    def handle(self, msg) -> bool:
        if msg.kind == "psi_stop":
            return False
        if msg.kind == "psi_hello":
            self._on_hello(msg)
            return True
        if msg.kind == "psi_blind_chunk":
            self._on_blind_chunk(msg)
            return True
        if msg.kind == "psi_delta_chunk":
            self._on_delta_chunk(msg)
            return True
        if msg.kind == "psi_lift_chunk":
            self._on_lift_chunk(msg)
            return True
        if msg.kind == "heartbeat":
            # liveness probe (federation/supervisor.py)
            self.endpoint.send("heartbeat_ack", {}, seq=msg.seq)
            return True
        raise RuntimeError(
            f"PSI owner {self.name}: unknown message kind {msg.kind!r}")

    def _on_hello(self, msg) -> None:
        pl = msg.payload
        mode = bytes(pl["mode"]).decode()
        group = bytes(pl["group"]).decode()
        srv = self.server
        if group != srv.group:
            raise RuntimeError(f"PSI group mismatch: client {group!r} "
                               f"!= owner {self.name} {srv.group!r}")
        if mode not in MODES:
            raise RuntimeError(f"unknown PSI mode {mode!r}")
        nb = srv._nb
        if _scalar(pl["nb"]) != nb:
            raise RuntimeError(f"PSI element width mismatch: client "
                               f"{_scalar(pl['nb'])} != owner {nb}")
        n_items = _scalar(pl["n_items"])
        chunk_size = _scalar(pl["chunk_size"])
        if chunk_size <= 0:
            raise RuntimeError(f"chunk_size must be positive: {chunk_size}")
        tag = bytes(pl["blind_tag"].tobytes())
        base_tag = bytes(pl["base_tag"].tobytes())
        client_leg_tag = bytes(pl["server_tag"].tobytes())
        have_resp = bool(_scalar(pl["have_resp"]))
        ops0 = srv.ops
        cached = self._blind_cache.get(tag)
        # delta splice needs the cached base upload; hidden mode also
        # needs the base's double-blinds (they never went to the client)
        delta_ok = (cached is None and base_tag != ZERO_TAG
                    and base_tag in self._blind_cache
                    and (mode != "hidden"
                         or base_tag in self._resp_cache))
        leg_tag = srv.server_leg_tag(mode, self.pool, chunk_size)
        # the response leg can be skipped iff the client holds the
        # *current* leg (hidden mode additionally needs the lift of this
        # exact leg — the owner can't match without it)
        server_cached = (client_leg_tag == leg_tag
                         and (mode != "hidden"
                              or leg_tag in self._lift_cache))
        ep = self.endpoint

        ack = {"blind_cached": np.uint8(cached is not None),
               "delta_ok": np.uint8(delta_ok),
               "server_cached": np.uint8(server_cached),
               "server_tag": _u8(leg_tag),
               "n_server_items": np.int64(len(srv.items))}
        if mode == "bloom":
            bloom = srv.build_bloom(self.pool, chunk_size)
            ack["n_shards"] = np.int64(bloom.n_shards)
            ack["shard_n_bits"] = np.int64(bloom.shards[0].m)
            ack["shard_n_hashes"] = np.int64(bloom.shards[0].k)
            ep.send("psi_hello_ack", ack, seq=0)
            if not server_cached:
                for k, frame in enumerate(bloom.shard_frames()):
                    ep.send("psi_bloom_shard", {"data": _u8(frame)},
                            seq=k)
            n_srv = 0
        else:
            own = srv.own_blinded_packed(self.pool, chunk_size)
            cb = chunk_size * nb
            n_srv = -(-len(own) // cb) if own else 0
            ack["n_server_chunks"] = np.int64(n_srv)
            ep.send("psi_hello_ack", ack, seq=0)
            if not server_cached:
                for k in range(n_srv):
                    ep.send("psi_server_set_chunk",
                            {"data": _u8(own[k * cb:(k + 1) * cb]),
                             "base": np.int64(k * chunk_size)}, seq=k)

        self._round = {"mode": mode, "chunk_size": chunk_size,
                       "tag": tag, "leg_tag": leg_tag, "ops0": ops0,
                       "doubles": 0, "upload_done": False}
        if mode == "hidden":
            if server_cached:
                self._lift_pending = None
            else:
                self._lift_pending = {"remaining": n_srv, "next_seq": 0,
                                      "parts": []}
        else:
            self._lift_pending = None

        n_chunks = -(-n_items // chunk_size) if n_items else 0
        if cached is not None:
            self._pending = None
            # skip the whole double-blind leg when the client holds the
            # match artifacts for exactly this (upload, response leg)
            if mode == "hidden" or (have_resp
                                    and client_leg_tag == leg_tag):
                self._round["upload_done"] = True
            else:
                self._respond_all(tag, cached, chunk_size)
                self._round["upload_done"] = True
            self._maybe_finish()
        elif delta_ok:
            self._pending = {"kind": "delta", "tag": tag,
                             "base_tag": base_tag,
                             "chunk_size": chunk_size}
        else:
            self._pending = {"kind": "full", "tag": tag,
                             "chunk_size": chunk_size,
                             "remaining": n_chunks, "next_seq": 0,
                             "parts": [], "d_parts": []}
            if n_chunks == 0:
                self._finish_upload()

    def _on_blind_chunk(self, msg) -> None:
        pend = self._pending
        if pend is None or pend["kind"] != "full":
            raise RuntimeError("PSI protocol desync: blind chunk outside "
                               "an upload (no hello, or already done)")
        if int(msg.seq) != pend["next_seq"]:
            raise _desync("psi_blind_chunk", int(msg.seq),
                          pend["next_seq"])
        want_base = pend["next_seq"] * pend["chunk_size"]
        if _scalar(msg.payload["base"]) != want_base:
            raise _desync("psi_blind_chunk base", _scalar(msg.payload["base"]),
                          want_base)
        blob = msg.payload["data"].tobytes()
        double = self.server.respond_chunk(blob)
        if self._round["mode"] != "hidden":
            self.endpoint.send("psi_double_chunk",
                               {"data": _u8(double),
                                "base": np.int64(want_base)},
                               seq=pend["next_seq"])
            self._round["doubles"] += 1
        pend["parts"].append(blob)
        pend["d_parts"].append(double)
        pend["next_seq"] += 1
        pend["remaining"] -= 1
        if pend["remaining"] == 0:
            self._finish_upload()

    def _on_delta_chunk(self, msg) -> None:
        pend = self._pending
        if pend is None or pend["kind"] != "delta":
            raise RuntimeError("PSI protocol desync: delta chunk without "
                               "an acknowledged delta offer")
        if int(msg.seq) != 0:
            raise _desync("psi_delta_chunk", int(msg.seq), 0)
        srv = self.server
        nb = srv._nb
        base = self._blind_cache[pend["base_tag"]]
        rows = np.frombuffer(base, np.uint8).reshape(-1, nb)
        removed = _i64list(msg.payload["removed"])
        added = msg.payload["data"].tobytes()
        n_retained = _scalar(msg.payload["n_retained"])
        rem = set(removed)
        if len(rem) != len(removed) or any(
                r < 0 or r >= len(rows) for r in rem):
            raise RuntimeError("PSI delta: invalid removal tombstones")
        keep_idx = [i for i in range(len(rows)) if i not in rem]
        if len(keep_idx) != n_retained:
            raise _desync("psi_delta_chunk n_retained", n_retained,
                          len(keep_idx))
        kept = rows[keep_idx].tobytes() if keep_idx else b""
        new_blob = kept + added
        # integrity: the splice must reproduce the advertised upload —
        # a stale or corrupt base fails loudly here, never misaligns
        if blind_tag(new_blob) != pend["tag"]:
            raise RuntimeError(
                f"PSI owner {self.name}: delta splice does not match "
                f"blind_tag (stale base upload?)")
        _cache_put(self._blind_cache, pend["tag"], new_blob)
        d_added = srv.respond_chunk(added) if added else b""
        base_resp = self._resp_cache.get(pend["base_tag"])
        if base_resp is not None:
            rrows = np.frombuffer(base_resp, np.uint8).reshape(-1, nb)
            rkept = rrows[keep_idx].tobytes() if keep_idx else b""
            _cache_put(self._resp_cache, pend["tag"], rkept + d_added)
        mode = self._round["mode"]
        self.endpoint.send(
            "psi_delta_ack",
            {"data": _u8(b"" if mode == "hidden" else d_added),
             "n_total": np.int64(len(new_blob) // nb)}, seq=0)
        self._pending = None
        self._round["upload_done"] = True
        self._maybe_finish()

    def _on_lift_chunk(self, msg) -> None:
        lp = self._lift_pending
        if lp is None:
            raise RuntimeError("PSI protocol desync: lift chunk outside "
                               "a hidden-mode round")
        if int(msg.seq) != lp["next_seq"]:
            raise _desync("psi_lift_chunk", int(msg.seq), lp["next_seq"])
        lp["parts"].append(msg.payload["data"].tobytes())
        lp["next_seq"] += 1
        lp["remaining"] -= 1
        if lp["remaining"] == 0:
            self._maybe_finish()

    def _finish_upload(self) -> None:
        pend, self._pending = self._pending, None
        _cache_put(self._blind_cache, pend["tag"],
                   b"".join(pend["parts"]))
        _cache_put(self._resp_cache, pend["tag"],
                   b"".join(pend["d_parts"]))
        self._round["upload_done"] = True
        self._maybe_finish()

    def _respond_all(self, tag: bytes, blob: bytes,
                     chunk_size: int) -> None:
        """Replay the double-blind leg for a cached upload — from the
        response cache when possible (zero modexp), else recomputed and
        cached."""
        d_blob = self._resp_for(tag, blob, chunk_size)
        nb = self.server._nb
        cb = chunk_size * nb
        n_chunks = -(-len(d_blob) // cb) if d_blob else 0
        for k in range(n_chunks):
            self.endpoint.send(
                "psi_double_chunk",
                {"data": _u8(d_blob[k * cb:(k + 1) * cb]),
                 "base": np.int64(k * chunk_size)}, seq=k)
        self._round["doubles"] = n_chunks

    def _resp_for(self, tag: bytes, blob: bytes,
                  chunk_size: int) -> bytes:
        d_blob = self._resp_cache.get(tag)
        if d_blob is None:
            nb = self.server._nb
            cb = chunk_size * nb
            d_blob = b"".join(
                self.server.respond_chunk(blob[o:o + cb])
                for o in range(0, len(blob), cb))
            _cache_put(self._resp_cache, tag, d_blob)
        return d_blob

    def _maybe_finish(self) -> None:
        r = self._round
        if r is None or not r["upload_done"]:
            return
        if r["mode"] == "hidden":
            lp = self._lift_pending
            if lp is not None and lp["remaining"] > 0:
                return
            if lp is None:
                t_blob = self._lift_cache[r["leg_tag"]]
            else:
                t_blob = b"".join(lp["parts"])
                _cache_put(self._lift_cache, r["leg_tag"], t_blob)
                self._lift_pending = None
            srv = self.server
            blob = self._blind_cache[r["tag"]]
            d_blob = self._resp_for(r["tag"], blob, r["chunk_size"])
            keep, rows = srv.hidden_match(d_blob, t_blob)
            self.endpoint.send(
                "psi_keep_mask",
                {"keep": np.asarray(keep, np.int64),
                 "rows": np.asarray(rows, np.int64)}, seq=0)
        self.endpoint.send(
            "psi_done",
            {"n_chunks": np.int64(r["doubles"]),
             "modexp_ops": np.int64(self.server.ops - r["ops0"])},
            seq=r["doubles"])
        self._round = None
        self.rounds_served += 1

    # -- thread target -----------------------------------------------------
    def run(self) -> None:
        try:
            while self.handle(self.endpoint.recv()):
                pass
        except BaseException as e:          # noqa: BLE001 — surfaced by
            self.error = e                  # the client's recv poll


def _recv_kind(ep, kind: str, worker: Optional[PSIServerEndpoint],
               timeout: float):
    """Receive the next ``kind`` message, surfacing a dead owner actor
    within ~1 s (short poll) instead of after the full timeout."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return ep.recv_kind(kind, timeout=POLL_S)
        except _queue.Empty:
            if worker is not None and worker.error is not None:
                raise RuntimeError(
                    f"PSI owner worker {worker.name!r} failed"
                ) from worker.error
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"timed out waiting for {kind!r}"
                    + (f" from {worker.name!r}" if worker else ""))


def wire_psi_round(client: PSIClient, ep, *,
                   worker: Optional[PSIServerEndpoint] = None,
                   pool: Optional[ModexpPool] = None,
                   chunk_size: int = DEFAULT_CHUNK,
                   timeout: float = DEFAULT_TIMEOUT_S,
                   peer: Optional[str] = None
                   ) -> Tuple[List, dict]:
    """One full PSI round driven from the scientist's endpoint ``ep``.

    Pipelining: the memoized blinded upload goes out in one burst (chunk
    k+1 is on the wire while the server exponentiates chunk k), then the
    server's response streams are consumed as they arrive, with the
    client chunk kernels running through ``pool.imap`` so client-side
    lifting overlaps both the wire and the server's thread.  Wall-clock
    under injected one-way latency L is therefore ``compute + O(L)``,
    not ``n_chunks * 2L + compute``.

    ``peer`` keys the client's per-owner round cache (defaults to the
    endpoint's peer name): on success the round's artifacts (response
    leg, double-blinds, intersection) are stored under it, which is what
    the repeat-round and delta fast paths splice against.  The cache is
    only written after a fully verified round — a crashed or desynced
    round leaves it untouched.

    Returns ``(intersection, stats)`` — for ``noinv``/``bloom`` the
    intersection is the item list, bit-identical to the in-process
    ``psi_round``; for ``hidden`` it is the padded keep-set of client
    row positions (``stats["hidden_rows"]`` maps each to an owner row).
    ``stats`` carries the in-process byte keys plus the wire flags
    (``upload_skipped``/``delta_used``/``resp_skipped``/
    ``server_leg_skipped``) and both sides' modexp-op counts."""
    pool = pool or ModexpPool(0)
    nb, p = client._nb, client._p
    n_items = len(client.items)
    n_chunks = -(-n_items // chunk_size) if n_items else 0
    blind_was_cached = client._blinded_packed is not None
    ops0 = client.ops
    blinded = client.blind_packed(pool, chunk_size)
    tag = blind_tag(blinded)
    peer = peer or getattr(ep, "peer", None) or "server"
    rc = client.round_cache.get(peer)
    delta = client._delta

    # offer the delta only when the splice actually applies: the advert
    # must match the current upload, and (noinv) the cached per-owner
    # double-blinds must be for the delta's base
    use_delta = (delta is not None and delta["tag"] == tag
                 and (client.mode == "hidden"
                      or (client.mode == "noinv" and rc is not None
                          and rc.get("tag") == delta["base_tag"])))
    # advertise the response leg we hold (with its artifacts)
    server_tag_known = ZERO_TAG
    if rc is not None and rc.get("server_tag"):
        if client.mode == "hidden" or (
                "t_blob" in rc if client.mode == "noinv"
                else "bloom" in rc):
            server_tag_known = rc["server_tag"]
    have_resp = bool(client.mode != "hidden" and rc is not None
                     and rc.get("tag") == tag
                     and server_tag_known != ZERO_TAG
                     and "inter" in rc)

    ep.send("psi_hello", {
        "mode": _u8(client.mode.encode()),
        "group": _u8(client.group.encode()),
        "blind_tag": _u8(tag),
        "base_tag": _u8(delta["base_tag"] if use_delta else ZERO_TAG),
        "server_tag": _u8(server_tag_known),
        "have_resp": np.uint8(have_resp),
        "n_items": np.int64(n_items),
        "chunk_size": np.int64(chunk_size),
        "nb": np.int64(nb),
    }, seq=0)
    ack = _recv_kind(ep, "psi_hello_ack", worker, timeout)
    upload_skipped = bool(_scalar(ack.payload["blind_cached"]))
    delta_used = bool(_scalar(ack.payload["delta_ok"]))
    server_leg_skipped = bool(_scalar(ack.payload["server_cached"]))
    leg_tag = bytes(ack.payload["server_tag"].tobytes())
    n_server_items = _scalar(ack.payload["n_server_items"])
    resp_skipped = bool(upload_skipped and have_resp
                        and server_tag_known == leg_tag
                        and client.mode != "hidden")

    if upload_skipped:
        pass
    elif delta_used:
        ep.send("psi_delta_chunk", {
            "data": _u8(delta["added_packed"]),
            "removed": np.asarray(delta["removed"], np.int64),
            "n_retained": np.int64(len(delta["retained"]))}, seq=0)
    else:
        for k, (lo, hi) in enumerate(_chunk_slices(n_items, chunk_size)):
            ep.send("psi_blind_chunk",
                    {"data": _u8(blinded[lo * nb:hi * nb]),
                     "base": np.int64(lo)}, seq=k)

    stats = {
        "mode": client.mode,
        "client_upload_bytes": len(blinded),
        "blind_cached": blind_was_cached,
        "upload_skipped": upload_skipped,
        "delta_used": delta_used,
        "resp_skipped": resp_skipped,
        "server_leg_skipped": server_leg_skipped,
        "chunk_size": chunk_size,
        "n_chunks": max(1, n_chunks),
        "peak_inflight_elements": min(n_items, chunk_size * pool.inflight),
        "parallelism": pool.parallelism if pool.is_parallel else 0,
        "uncompressed_server_set_bytes": nb * n_server_items,
    }
    entry: dict = {"tag": tag, "server_tag": leg_tag}

    def _recv_t_blob() -> bytes:
        """The server-set leg, lifted to the double-blinded domain as it
        arrives (imap: receive / lift / server-respond all overlap)."""
        n_srv = _scalar(ack.payload["n_server_chunks"])
        if server_leg_skipped:
            return rc["t_blob"]

        def _srv_chunks():
            for k in range(n_srv):
                m = _recv_kind(ep, "psi_server_set_chunk", worker,
                               timeout)
                if int(m.seq) != k:
                    raise _desync("psi_server_set_chunk", int(m.seq), k)
                yield (m.payload["data"].tobytes(), client._blind_exp,
                       p, nb)

        blob = b"".join(pool.imap(pow_chunk, _srv_chunks()))
        client.ops += len(blob) // nb
        return blob

    def _recv_doubles() -> bytes:
        if delta_used:
            m = _recv_kind(ep, "psi_delta_ack", worker, timeout)
            if int(m.seq) != 0:
                raise _desync("psi_delta_ack", int(m.seq), 0)
            d_added = m.payload["data"].tobytes()
            if _scalar(m.payload["n_total"]) != n_items:
                raise _desync("psi_delta_ack n_total",
                              _scalar(m.payload["n_total"]), n_items)
            rows = np.frombuffer(rc["d_blob"], np.uint8).reshape(-1, nb)
            kept = (rows[delta["retained"]].tobytes()
                    if delta["retained"] else b"")
            return kept + d_added
        d_parts: List[bytes] = []
        for k in range(n_chunks):
            m = _recv_kind(ep, "psi_double_chunk", worker, timeout)
            if int(m.seq) != k:
                raise _desync("psi_double_chunk", int(m.seq), k)
            d_parts.append(m.payload["data"].tobytes())
        return b"".join(d_parts)

    if client.mode == "noinv":
        t_blob = _recv_t_blob()
        if resp_skipped:
            d_blob, inter = rc["d_blob"], list(rc["inter"])
        else:
            d_blob = _recv_doubles()
            inter = client.match_double_blinded(d_blob, t_blob)
        entry.update(t_blob=t_blob, d_blob=d_blob, inter=list(inter))
        stats["server_set_bytes"] = len(t_blob)
        stats["server_response_bytes"] = len(d_blob) + len(t_blob)
        expected_doubles = (0 if (resp_skipped or delta_used)
                            else n_chunks)
    elif client.mode == "hidden":
        if server_leg_skipped:
            t_blob = rc.get("t_blob", b"")
        else:
            t_blob = _recv_t_blob()
            cb = chunk_size * nb
            for k, o in enumerate(range(0, len(t_blob), cb)):
                ep.send("psi_lift_chunk",
                        {"data": _u8(t_blob[o:o + cb]),
                         "base": np.int64(o // nb)}, seq=k)
        if delta_used:
            m = _recv_kind(ep, "psi_delta_ack", worker, timeout)
            if int(m.seq) != 0:
                raise _desync("psi_delta_ack", int(m.seq), 0)
        km = _recv_kind(ep, "psi_keep_mask", worker, timeout)
        if int(km.seq) != 0:
            raise _desync("psi_keep_mask", int(km.seq), 0)
        keep = _i64list(km.payload["keep"])
        rows = _i64list(km.payload["rows"])
        if len(keep) != len(rows):
            raise RuntimeError("PSI protocol desync: keep/rows length "
                               "mismatch in psi_keep_mask")
        inter = keep
        entry.update(keep=list(keep), rows=list(rows), t_blob=t_blob)
        stats["hidden_rows"] = rows
        stats["hidden_kept"] = len(keep)
        stats["server_set_bytes"] = len(t_blob)
        stats["server_response_bytes"] = len(t_blob) + 16 * len(keep)
        expected_doubles = 0
    else:
        if server_leg_skipped:
            bloom = rc["bloom"]
        else:
            n_shards = _scalar(ack.payload["n_shards"])
            m_bits = _scalar(ack.payload["shard_n_bits"])
            k_hashes = _scalar(ack.payload["shard_n_hashes"])
            shards = []
            for k in range(n_shards):
                m = _recv_kind(ep, "psi_bloom_shard", worker, timeout)
                if int(m.seq) != k:
                    raise _desync("psi_bloom_shard", int(m.seq), k)
                shards.append(BloomFilter.from_bytes(
                    m.payload["data"].tobytes(), m_bits, k_hashes))
            bloom = ShardedBloom(shards) if shards else None

        if resp_skipped:
            inter = list(rc["inter"])
        else:
            bases: List[int] = []

            def _dbl_chunks():
                for k in range(n_chunks):
                    m = _recv_kind(ep, "psi_double_chunk", worker,
                                   timeout)
                    if int(m.seq) != k:
                        raise _desync("psi_double_chunk", int(m.seq), k)
                    bases.append(_scalar(m.payload["base"]))
                    yield (m.payload["data"].tobytes(),
                           client.unblind_exp, p, nb)

            client.ops += 0 if n_chunks == 0 else n_items
            inter = []
            for unb in pool.imap(pow_chunk, _dbl_chunks()):
                inter.extend(client.match_bloom_chunk(unb, bloom,
                                                      bases.pop(0)))
        entry.update(bloom=bloom, inter=list(inter))
        stats["bloom_bytes"] = bloom.nbytes() if bloom else 0
        stats["bloom_shards"] = bloom.n_shards if bloom else 0
        stats["server_response_bytes"] = (len(blinded)
                                          + stats["bloom_bytes"])
        expected_doubles = 0 if resp_skipped else n_chunks

    done = _recv_kind(ep, "psi_done", worker, timeout)
    if _scalar(done.payload["n_chunks"]) != expected_doubles:
        raise _desync("psi_done n_chunks",
                      _scalar(done.payload["n_chunks"]), expected_doubles)
    stats["server_modexp_ops"] = _scalar(done.payload["modexp_ops"])
    stats["client_modexp_ops"] = client.ops - ops0
    stats["modexp_ops"] = (stats["client_modexp_ops"]
                           + stats["server_modexp_ops"])
    # round verified end-to-end: only now may the per-owner cache change
    client.round_cache[peer] = entry
    return inter, stats


def serve_psi(name: str, server: PSIServer, endpoint
              ) -> Tuple[PSIServerEndpoint, threading.Thread]:
    """Spawn a PSI server actor on its own daemon thread (the owner-side
    analogue of the split loop's worker threads).  Returns
    ``(worker, thread)``; send ``psi_stop`` on the peer endpoint and
    join to shut down."""
    worker = PSIServerEndpoint(name, server, endpoint)
    th = threading.Thread(target=worker.run, daemon=True,
                          name=f"psi-{name}")
    th.start()
    return worker, th
