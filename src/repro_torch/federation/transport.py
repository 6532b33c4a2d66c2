"""The transport layer: what crosses the party boundary (the port's
counterpart of ``repro.federation.transport``).

Parties exchange :class:`Message` objects over :class:`Channel` s, and
everything the session reports about traffic is measured from the wire.
Two backends:

  * ``direct`` — in-process handoff: payload tensors move by reference
    and stay on their device.
  * ``queue``  — a simulated network: every payload is serialized to one
    wire frame (``_pack``/``_unpack``) and byte counts come from the
    frame.  Tensors cross as host numpy (``t.detach().cpu().numpy()``),
    so frames — dtype names, shapes, bytes — are byte-identical to the
    reference's; bf16 crosses as its raw words under the name
    ``bfloat16``.  Delivery can be delayed by ``latency_s`` plus
    ``wire_bytes / bandwidth_bps`` per frame (``fit`` and the PSI
    rounds of ``resolve`` take both).  The receiver waits a frame's
    deadline out with a coarse sleep and then a spin over its last
    ``spin_s`` seconds (:func:`wait_until`), so delivery lands within a
    fraction of a millisecond of the deadline.

Every serialized frame carries a CRC32 of its blob, checked on receipt
(:class:`FrameCorrupt`); a channel's ``fault_hook`` can drop, corrupt or
delay a frame (``federation/faults.py``), and a delayed frame carries a
``not_before`` deadline that the receiver waits out.  The CRC is not
counted in the wire bytes, so byte counts stay the reference's.

This module imports no torch: a tensor can only reach it from a process
that loaded torch, so it finds torch in ``sys.modules``, and the spawned
PSI workers of ``federation/runtime.py`` run it without ever loading
torch.  The cut-payload codecs and ``to_tensor``, which need torch, live
in ``federation/cut_codec.py``.
"""
from __future__ import annotations

import os
import queue
import struct
import sys
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Message", "Channel", "Endpoint", "ScopedEndpoint",
           "channel_pair", "FrameCorrupt", "spin_wait_s", "wait_until"]

# The delivery wait sleeps until this close to a deadline, then spins on
# the monotonic clock: ``time.sleep`` alone overshoots by the kernel's
# timer slack and the thread's wake-up (tenths of a millisecond on a
# Linux host), which would add noise of that size to every hop of an
# injected latency.
SPIN_WAIT_S = 3e-3

#: the default spin on a host with one usable core: there a long spin
#: cannot buy precision, since the sender needs the same core to make
#: progress, and it only takes the peer's turns at the interpreter lock
SPIN_WAIT_SINGLE_CORE_S = 5e-4


class FrameCorrupt(RuntimeError):
    """A serialized frame failed its CRC32 check.  Raised by the receive
    path of the queue and process backends; carries the frame's protocol
    ``kind`` and ``seq`` and its ``sender``, so a receiver can route the
    failure to the kind that owns the frame and the session knows which
    party's frame it was."""

    def __init__(self, kind: str, seq: int, sender: str, receiver: str):
        super().__init__(
            f"frame corrupt: {kind!r} seq {seq} from {sender!r} to "
            f"{receiver!r} (crc32 mismatch)")
        self.kind, self.seq = kind, seq
        self.sender, self.receiver = sender, receiver


def _is_tensor(a) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def _loaded_torch():
    """torch, which is loaded in any process that holds a tensor."""
    return sys.modules["torch"]


def crc32(blob: bytes) -> int:
    return zlib.crc32(blob) & 0xFFFFFFFF


def _effective_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):       # not Linux
        return os.cpu_count() or 1


def spin_wait_s() -> float:
    """The spin margin in effect: ``REPRO_SPIN_WAIT_S`` where it is set
    to a non-negative float, else :data:`SPIN_WAIT_S`
    (:data:`SPIN_WAIT_SINGLE_CORE_S` on a host with one usable core).
    Channels and process endpoints read it once, at construction."""
    raw = os.environ.get("REPRO_SPIN_WAIT_S")
    if raw is not None:
        try:
            v = float(raw)
            if v >= 0.0:
                return v
        except ValueError:
            pass
    return (SPIN_WAIT_S if _effective_cores() > 1
            else SPIN_WAIT_SINGLE_CORE_S)


def wait_until(deadline: float, spin_s: float = SPIN_WAIT_S) -> None:
    """Block until ``time.monotonic()`` reaches ``deadline`` (a frame's
    ``not_before``; the clock is system-wide, so a deadline stamped in
    another process holds here too): one coarse sleep to ``spin_s``
    before it, then a spin.  Each pass of the spin yields the
    interpreter lock (``sleep(0)``): a bare busy loop would hold it for
    the whole switch interval and serialise the owner threads against
    the scientist.  ``spin_s=0`` is the sleep alone."""
    while True:
        rem = deadline - time.monotonic()
        if rem <= 0.0:
            return
        if rem > spin_s:
            time.sleep(rem - spin_s)
        else:
            while time.monotonic() < deadline:
                time.sleep(0)
            return


# ---------------------------------------------------------------------------
# Wire format: one frame of named arrays
# ---------------------------------------------------------------------------
#
# Frame layout:  [u32 n_entries] then per entry
#   [u16 name_len][name][u16 dtype_len][dtype.name][u8 ndim][i64 dims...]
#   [i64 nbytes][raw buffer]
# (the reference's layout, byte for byte).


def _host(arr) -> Tuple[str, np.ndarray]:
    """A payload value as (dtype name, contiguous host numpy).  A device
    tensor is copied to the host here; that copy synchronises with its
    stream.  numpy has no bfloat16 of its own, so a bf16 tensor crosses
    as its raw 2-byte words under the dtype name ``bfloat16`` — the name
    and bytes the reference's ml_dtypes array writes."""
    if _is_tensor(arr):
        torch = _loaded_torch()
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            return "bfloat16", np.ascontiguousarray(
                t.contiguous().view(torch.int16).cpu().numpy())
        arr = t.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(arr))
    return arr.dtype.name, arr


def _pack(payload: Dict[str, object]) -> bytes:
    """Serialize ``{name: array or tensor}`` to one immutable blob."""
    entries = [(name.encode(), *_host(a)) for name, a in payload.items()]
    parts = [struct.pack("<I", len(entries))]
    for nb, dtname, arr in entries:
        dt = dtname.encode()
        parts += [struct.pack("<H", len(nb)), nb,
                  struct.pack("<H", len(dt)), dt,
                  struct.pack(f"<B{arr.ndim}q", arr.ndim, *arr.shape),
                  struct.pack("<q", arr.nbytes),
                  arr.reshape(-1).view(np.uint8).tobytes()]
    return b"".join(parts)


def _unpack(blob: bytes) -> Dict[str, object]:
    """Inverse of ``_pack``: zero-copy read-only numpy views into
    ``blob``; a ``bfloat16`` entry comes back as a CPU ``torch.bfloat16``
    tensor (a copy of its words)."""
    out: Dict[str, np.ndarray] = {}
    off = 0
    (n,) = struct.unpack_from("<I", blob, off)
    off += 4
    for _ in range(n):
        (ln,) = struct.unpack_from("<H", blob, off)
        off += 2
        name = blob[off:off + ln].decode()
        off += ln
        (ld,) = struct.unpack_from("<H", blob, off)
        off += 2
        dtname = blob[off:off + ld].decode()
        dtype = np.dtype(np.uint16 if dtname == "bfloat16" else dtname)
        off += ld
        (ndim,) = struct.unpack_from("<B", blob, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", blob, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<q", blob, off)
        off += 8
        count = nbytes // dtype.itemsize if dtype.itemsize else 0
        a = np.frombuffer(blob, dtype=dtype, count=count,
                          offset=off).reshape(shape)
        if dtname == "bfloat16":
            # only a process that loaded torch sends bf16 (a cut of an LM)
            torch = _loaded_torch()
            a = torch.from_numpy(a.copy()).view(torch.bfloat16)
        out[name] = a
        off += nbytes
    return out


def _nbytes(a) -> int:
    if _is_tensor(a):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


# ---------------------------------------------------------------------------
# Messages and channels
# ---------------------------------------------------------------------------


@dataclass
class Message:
    sender: str
    receiver: str
    kind: str
    payload: Dict[str, object]
    seq: int = 0
    payload_bytes: int = 0         # sum of array buffers (the protocol data)
    wire_bytes: int = 0            # serialized blob incl. headers (queue)
    not_before: float = 0.0        # delivery deadline (an injected delay)
    crc: Optional[int] = None      # crc32 of the blob (serialized backends)


class Channel:
    """One direction of a party boundary, with measured byte accounting.
    A thread-safe FIFO: message order is the protocol's happens-before
    edge (an owner applies the step-``t`` gradient before it runs the
    step-``t+1`` forward).  Several threads may send on one channel (the
    supervisor's heartbeats beside the step loop), so the accounting
    takes a lock.  ``latency_s`` and ``bandwidth_bps`` give every frame
    a transit time, ``latency_s + wire_bytes / bandwidth_bps``, that
    the receiver waits out, spinning its last ``spin_s`` seconds (None:
    :func:`spin_wait_s` at construction)."""

    def __init__(self, sender: str, receiver: str, *, serialize: bool,
                 latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None,
                 spin_s: Optional[float] = None, tap=None):
        self.sender, self.receiver = sender, receiver
        self.serialize = serialize
        self.latency_s = latency_s
        self.bandwidth_bps = bandwidth_bps
        self.spin_s = spin_wait_s() if spin_s is None else spin_s
        # observation hook: ``tap(msg, blob)`` on every send, with the
        # serialized frame (None on the direct backend); the privacy
        # tests capture transcripts through it
        self.tap = tap
        # fault hook: ``fault_hook(kind, seq) -> (action, delay_s) | None``,
        # installed by ``faults.arm_endpoint`` (drop, corrupt, delay)
        self.fault_hook = None
        self._q: "queue.Queue[Message]" = queue.Queue()
        self._lock = threading.Lock()
        self.stats: Dict[str, object] = {
            "messages": 0, "payload_bytes": 0, "wire_bytes": 0,
            "by_kind": {}}

    def _account(self, kind: str, payload_bytes: int, wire_bytes: int):
        with self._lock:
            st = self.stats
            st["messages"] += 1
            st["payload_bytes"] += payload_bytes
            st["wire_bytes"] += wire_bytes
            k = st["by_kind"].setdefault(
                kind, {"count": 0, "payload_bytes": 0, "wire_bytes": 0})
            k["count"] += 1
            k["payload_bytes"] += payload_bytes
            k["wire_bytes"] += wire_bytes

    def send(self, kind: str, payload: Dict[str, object], *,
             seq: int = 0) -> Message:
        pb = sum(_nbytes(a) for a in payload.values())
        blob = crc = None
        if self.serialize:
            blob = _pack(payload)
            wb = len(blob)
            crc = crc32(blob)
            payload = {"__blob__": blob}           # only bytes travel
        else:
            wb = pb                                # by-reference handoff
        msg = Message(self.sender, self.receiver, kind, payload, seq=seq,
                      payload_bytes=pb, wire_bytes=wb, crc=crc)
        if self.tap is not None:
            self.tap(msg, blob)
        fault = (self.fault_hook(kind, seq)
                 if self.fault_hook is not None else None)
        transit = self.latency_s + (wb / self.bandwidth_bps
                                    if self.bandwidth_bps else 0.0)
        if fault is not None and fault[0] == "delay":
            transit += fault[1]
        if transit:
            msg.not_before = time.monotonic() + transit
        self._account(kind, pb, wb)
        if fault is not None:
            action = fault[0]
            if action == "drop_frame":
                with self._lock:
                    self.stats["dropped_frames"] = self.stats.get(
                        "dropped_frames", 0) + 1
                return msg                         # lost on the wire
            if action == "corrupt_frame" and blob is not None:
                # one byte flipped after the crc was taken: the
                # receiver's check fails loudly (FrameCorrupt)
                bad = bytearray(blob)
                bad[len(bad) // 2] ^= 0xFF
                msg.payload = {"__blob__": bytes(bad)}
        self._q.put(msg)
        return msg

    def recv(self, timeout: Optional[float] = None) -> Message:
        msg = self._q.get(timeout=timeout)
        if msg.not_before:
            wait_until(msg.not_before, self.spin_s)
        if self.serialize:
            blob = msg.payload["__blob__"]
            if msg.crc is not None and crc32(blob) != msg.crc:
                raise FrameCorrupt(msg.kind, msg.seq, self.sender,
                                   self.receiver)
            msg.payload = _unpack(blob)
        return msg


class KindReceiver:
    """``recv_kind`` over one inbox that several threads may wait on at
    once (the step loop on a cut, the supervisor on a heartbeat ack).
    Messages of other kinds are stashed for later instead of dropped (in
    a pipelined schedule the next step's cuts can arrive while the
    scientist waits for an ack), and a corrupt frame is kept for the
    kind that owns it.  One waiter at a time reads the inbox, in polls of
    ``_POLL_S`` and without the lock; the others wait on the condition,
    which the reader notifies after every read.  So a frame a reader
    stashes reaches its waiter at once, and no waiter starves another of
    the lock.  Subclasses give ``_read(timeout)``: one frame, or
    ``queue.Empty``."""

    _POLL_S = 0.05

    def _init_receiver(self) -> None:
        self._stash: list = []
        # corrupt frames routed to the kind that owns them: a receiver of
        # one kind must not fail on another kind's corruption
        self._corrupt: Dict[str, FrameCorrupt] = {}
        self._cond = threading.Condition(threading.Lock())
        self._reading = False

    def _read(self, timeout: float) -> "Message":
        raise NotImplementedError

    def _check_peer(self) -> None:
        """Raise the peer's terminal error, where one was seen."""

    def recv_kind(self, kind: str, timeout: Optional[float] = None
                  ) -> "Message":
        """The next message of protocol kind ``kind``; raises
        ``queue.Empty`` when ``timeout`` elapses first, and
        ``FrameCorrupt`` when a frame of ``kind`` failed its check."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if kind in self._corrupt:
                    raise self._corrupt.pop(kind)
                for i, m in enumerate(self._stash):
                    if m.kind == kind:
                        return self._stash.pop(i)
                self._check_peer()
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0.0:
                    raise queue.Empty
                if self._reading:              # another waiter reads
                    self._cond.wait(left)
                    continue
                self._reading = True
                self._cond.release()
                msg = bad = None
                try:
                    msg = self._read(self._POLL_S if left is None
                                     else min(self._POLL_S, left))
                except queue.Empty:
                    pass
                except FrameCorrupt as e:
                    bad = e
                finally:
                    self._cond.acquire()
                    self._reading = False
                    self._cond.notify_all()
                if bad is not None:
                    if bad.kind == kind:
                        raise bad
                    self._corrupt[bad.kind] = bad    # another kind's frame
                elif msg is not None:
                    if msg.kind == kind:
                        return msg
                    self._stash.append(msg)

    def flush_pending(self) -> None:
        """Discard every stashed message and routed corrupt marker.  The
        supervised fit calls it after a party's ``rollback_ack``: by FIFO
        order everything that party sent before the ack is stale."""
        with self._cond:
            self._stash.clear()
            self._corrupt.clear()


class Endpoint(KindReceiver):
    """A party's end of a duplex boundary: an outbox + an inbox channel,
    received by kind (:class:`KindReceiver`)."""

    def __init__(self, name: str, peer: str, outbox: Channel,
                 inbox: Channel):
        self.name, self.peer = name, peer
        self.outbox, self.inbox = outbox, inbox
        self._init_receiver()

    def send(self, kind: str, payload: Dict[str, object], *,
             seq: int = 0) -> Message:
        return self.outbox.send(kind, payload, seq=seq)

    def recv(self, timeout: Optional[float] = None) -> Message:
        with self._cond:
            if self._stash:
                return self._stash.pop(0)
        return self.inbox.recv(timeout=timeout)

    def _read(self, timeout: float) -> Message:
        return self.inbox.recv(timeout=timeout)

    def empty(self) -> bool:
        """Nothing stashed and nothing waiting in the inbox."""
        with self._cond:
            return not self._stash and self.inbox._q.empty()

    @property
    def sent_stats(self) -> Dict[str, object]:
        return self.outbox.stats

    @property
    def recv_stats(self) -> Dict[str, object]:
        return self.inbox.stats


class ScopedEndpoint:
    """A kind-prefixed view of a shared endpoint: session multiplexing.

    Many serving sessions share one owner<->scientist boundary; each
    session's frames ride the same channel with the session scope (e.g.
    ``"s3:"``) in front of the protocol kind.  Works over :class:`Endpoint`
    and ``process_transport.ProcessEndpoint`` alike (the kind travels in
    the pipe's header), and the base endpoint's ``recv_kind``
    (:class:`KindReceiver`: several waiting threads, other kinds stashed)
    absorbs the sessions' interleaving.  ``sent_stats`` / ``recv_stats``
    are the prefix-filtered slice of the shared totals, the scope
    stripped from the ``by_kind`` keys: a session sees exactly its own
    traffic."""

    def __init__(self, base, scope: str):
        self.base, self.scope = base, scope
        self.name = getattr(base, "name", "?")
        self.peer = getattr(base, "peer", "?")

    def send(self, kind: str, payload: Dict[str, object], *,
             seq: int = 0) -> Message:
        return self.base.send(self.scope + kind, payload, seq=seq)

    def recv_kind(self, kind: str, timeout: Optional[float] = None
                  ) -> Message:
        return self.base.recv_kind(self.scope + kind, timeout)

    def empty(self) -> bool:
        return self.base.empty()

    def _filter(self, stats: Dict[str, object]) -> Dict[str, object]:
        out = {"messages": 0, "payload_bytes": 0, "wire_bytes": 0,
               "by_kind": {}}
        # a snapshot: another session's thread may add a kind meanwhile
        for k, v in list(stats["by_kind"].items()):
            if k.startswith(self.scope):
                out["by_kind"][k[len(self.scope):]] = v
                out["messages"] += v["count"]
                out["payload_bytes"] += v["payload_bytes"]
                out["wire_bytes"] += v["wire_bytes"]
        return out

    @property
    def sent_stats(self) -> Dict[str, object]:
        return self._filter(self.base.sent_stats)

    @property
    def recv_stats(self) -> Dict[str, object]:
        return self._filter(self.base.recv_stats)


def channel_pair(a: str, b: str, *, backend: str = "queue",
                 latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None,
                 spin_s: Optional[float] = None, tap=None
                 ) -> Tuple[Endpoint, Endpoint]:
    """The duplex boundary between parties ``a`` and ``b``:
    ``(endpoint_a, endpoint_b)``.  ``tap`` observes every send in both
    directions, ``latency_s`` and ``bandwidth_bps`` delay every frame
    and ``spin_s`` sets the receiver's spin (see :class:`Channel`)."""
    if backend not in ("queue", "direct"):
        raise ValueError(f"unknown transport backend {backend!r}")
    ser = backend == "queue"
    kw = dict(serialize=ser, latency_s=latency_s,
              bandwidth_bps=bandwidth_bps, spin_s=spin_s, tap=tap)
    ab = Channel(a, b, **kw)
    ba = Channel(b, a, **kw)
    return Endpoint(a, b, ab, ba), Endpoint(b, a, ba, ab)
