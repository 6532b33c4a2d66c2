"""The process boundary: the queue backend's semantics over a real OS
pipe between party processes (the port's counterpart of
``repro.federation.process_transport``, cut to what the process
backends of ``fit`` and ``resolve`` use).

:class:`ProcessEndpoint` has the endpoint surface the session, the
owner's compute loop and the PSI actor use (``send`` / ``recv`` /
``recv_kind`` / ``sent_stats`` / ``recv_stats``) over a
``multiprocessing`` connection, so ``OwnerComputeEndpoint`` and
``PSIServerEndpoint`` run unchanged inside spawned workers
(``federation/runtime.py``).  Like ``transport``, it imports no torch.

  * **One pipe per party.**  Every protocol kind shares one duplex pipe;
    the kind and seq ride a small transport header in front of the
    payload frame, and ``recv_kind`` stashes other kinds exactly as the
    queue backend's ``Endpoint`` does.
  * **The queue backend's accounting.**  The payload frame is the very
    ``transport._pack`` blob the queue backend serializes, and
    ``wire_bytes`` counts that blob alone (the header plays the part of
    the in-process ``Message`` envelope, which the queue backend does
    not count either), so byte counts by kind equal the queue
    backend's.
  * **Sends never block the party.**  A writer thread per endpoint
    drains an unbounded outbox into the pipe, so two parties sending at
    once cannot deadlock on full socket buffers.
  * **A dead peer raises.**  A failing worker ships one last
    ``__worker_error__`` frame with its traceback; the peer's next
    receive raises it as a ``RuntimeError``.  A death without that frame
    shows as a closed pipe, which raises too.
  * **Latency across the boundary.**  The sender stamps a delivery
    deadline (``latency_s + wire_bytes / bandwidth_bps`` past the send)
    into the header and the receiver waits it out: a coarse sleep, then
    a spin over the last ``spin_s`` seconds (``transport.wait_until``).
  * **Checked frames.**  The header carries a CRC32 of the blob; a
    mismatch raises ``transport.FrameCorrupt``, which ``recv_kind``
    routes to the kind that owns the frame.  ``fault_hook`` drops,
    corrupts (after the CRC) or delays a frame (``federation/
    faults.py``); a delay rides the header as a ``not_before`` deadline
    that the receiver waits out (``time.monotonic`` is system-wide on
    Linux, so it holds across processes).
  * **Two waiting threads.**  ``recv_kind`` is the queue endpoint's
    (``transport.KindReceiver``): one waiter reads the pipe at a time
    and hands on what it stashes, so the step loop and the supervisor's
    heartbeat thread may wait on one endpoint at once, and so may the
    serving sessions that share one endpoint
    (``transport.ScopedEndpoint``).
  * **A tap.**  ``tap(msg, blob)`` observes every frame the endpoint
    sends and every frame it receives (``process_endpoint_pair`` puts it
    on endpoint ``a``: both directions of the boundary).
  * **Duplicate dropping, opt in.**  With ``dedup`` a received frame
    whose seq equals the last delivered seq of its kind is dropped and
    counted (``recv_stats["dup_dropped"]``); negative seqs are exempt
    and ``reset_dedup`` forgets the seqs (after a rollback the replayed
    frames reuse them).  Off by default: serving reuses seqs per tick.
"""
from __future__ import annotations

import queue as _queue
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.federation.transport import (FrameCorrupt, KindReceiver,
                                              Message, _nbytes, _pack,
                                              _unpack, crc32, spin_wait_s,
                                              wait_until)

__all__ = ["ProcessEndpoint", "process_endpoint_pair", "POISON_KIND",
           "FrameCorrupt"]

#: the frame a dying worker sends last
POISON_KIND = "__worker_error__"

#: transport header after the kind:
#: [i64 seq][f64 not_before][i64 payload_bytes][u32 crc32 of the blob]
HEADER_FMT = "<qdqI"
_HEADER_LEN = struct.calcsize(HEADER_FMT)

_CLOSE = object()          # writer-thread shutdown sentinel


def _new_stats() -> Dict[str, object]:
    return {"messages": 0, "payload_bytes": 0, "wire_bytes": 0,
            "by_kind": {}}


def _account(stats: Dict[str, object], kind: str, payload_bytes: int,
             wire_bytes: int) -> None:
    stats["messages"] += 1
    stats["payload_bytes"] += payload_bytes
    stats["wire_bytes"] += wire_bytes
    k = stats["by_kind"].setdefault(
        kind, {"count": 0, "payload_bytes": 0, "wire_bytes": 0})
    k["count"] += 1
    k["payload_bytes"] += payload_bytes
    k["wire_bytes"] += wire_bytes


class ProcessEndpoint(KindReceiver):
    """One party's end of a duplex process boundary.  ``recv`` raises
    ``queue.Empty`` on timeout and ``RuntimeError`` once the peer died
    (its error frame, or a closed pipe).  A frame's deadline is waited
    out with a spin over its last ``spin_s`` seconds (None:
    ``transport.spin_wait_s()`` at construction)."""

    def __init__(self, name: str, peer: str, conn, *,
                 latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None,
                 spin_s: Optional[float] = None, tap=None,
                 dedup: bool = False):
        self.name, self.peer = name, peer
        self.conn = conn
        self.latency_s = latency_s
        self.bandwidth_bps = bandwidth_bps
        self.spin_s = spin_wait_s() if spin_s is None else spin_s
        self.tap = tap
        # fault hook: ``fault_hook(kind, seq) -> (action, delay_s) | None``,
        # installed by ``faults.arm_endpoint`` (drop, corrupt, delay)
        self.fault_hook = None
        self._dedup = dedup
        self._last_seq: Dict[str, int] = {}
        self.sent_stats = _new_stats()
        self.recv_stats = _new_stats()
        #: the peer's error frame, once seen
        self.peer_error: Optional[BaseException] = None
        self._init_receiver()
        self._lock = threading.Lock()
        self._outq: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._send_error: Optional[BaseException] = None
        self._closed = False
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True,
            name=f"pt-writer-{name}->{peer}")
        self._writer.start()

    # -- sending -----------------------------------------------------------
    def _write_loop(self) -> None:
        while True:
            frame = self._outq.get()
            if frame is _CLOSE:
                return
            try:
                self.conn.send_bytes(frame)
            except (OSError, ValueError) as e:
                # the peer is gone: keep the reason and drain quietly, so
                # the party's sends never block on a dead pipe
                if self._send_error is None:
                    self._send_error = e

    def send(self, kind: str, payload: Dict[str, object], *,
             seq: int = 0) -> Message:
        if self._closed:
            raise RuntimeError(
                f"{self.name}: endpoint to {self.peer} is closed")
        pb = sum(_nbytes(a) for a in payload.values())
        blob = _pack(payload)
        crc = crc32(blob)
        msg = Message(self.name, self.peer, kind, {"__blob__": blob},
                      seq=seq, payload_bytes=pb, wire_bytes=len(blob),
                      crc=crc)
        if self.tap is not None:
            self.tap(msg, blob)
        fault = (self.fault_hook(kind, seq)
                 if self.fault_hook is not None else None)
        transit = self.latency_s + (len(blob) / self.bandwidth_bps
                                    if self.bandwidth_bps else 0.0)
        if fault is not None and fault[0] == "delay":
            transit += fault[1]
        if transit:
            msg.not_before = time.monotonic() + transit
        with self._lock:
            _account(self.sent_stats, kind, pb, len(blob))
        if fault is not None:
            action = fault[0]
            if action == "drop_frame":
                with self._lock:
                    self.sent_stats["dropped_frames"] = \
                        self.sent_stats.get("dropped_frames", 0) + 1
                return msg                     # lost on the wire
            if action == "corrupt_frame":
                # one blob byte flipped after the crc was taken: the far
                # side's check raises FrameCorrupt
                bad = bytearray(blob)
                bad[len(bad) // 2] ^= 0xFF
                blob = bytes(bad)
        kb = kind.encode()
        self._outq.put(struct.pack("<H", len(kb)) + kb
                       + struct.pack(HEADER_FMT, seq, msg.not_before, pb,
                                     crc) + blob)
        return msg

    def send_error(self, exc: BaseException, tb: str = "") -> None:
        """Ship the worker's terminal exception and traceback as the last
        frame before the pipe closes."""
        try:
            self.send(POISON_KIND, {
                "error": np.frombuffer(
                    f"{type(exc).__name__}: {exc}".encode(), np.uint8),
                "traceback": np.frombuffer(tb.encode(), np.uint8)})
        except RuntimeError:
            pass

    # -- receiving ---------------------------------------------------------
    def _recv_frame(self, timeout: Optional[float]) -> Message:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            try:
                if not self.conn.poll(timeout):
                    raise _queue.Empty
                frame = self.conn.recv_bytes()
            except (EOFError, OSError) as e:
                raise RuntimeError(
                    f"{self.name}: connection to {self.peer!r} closed "
                    f"({type(e).__name__})") from (
                        self.peer_error if self.peer_error is not None
                        else e)
            (klen,) = struct.unpack_from("<H", frame, 0)
            kind = frame[2:2 + klen].decode()
            seq, not_before, pb, crc = struct.unpack_from(
                HEADER_FMT, frame, 2 + klen)
            blob = frame[2 + klen + _HEADER_LEN:]
            if kind == POISON_KIND:
                pl = _unpack(blob)
                err = pl["error"].tobytes().decode()
                tb = pl["traceback"].tobytes().decode()
                self.peer_error = RuntimeError(
                    f"party {self.peer!r} died: {err}"
                    + (f"\n--- remote traceback ---\n{tb}" if tb else ""))
                raise self.peer_error
            if crc32(blob) != crc:
                raise FrameCorrupt(kind, int(seq), self.peer, self.name)
            if self._dedup and seq >= 0:
                if self._last_seq.get(kind) == int(seq):
                    with self._lock:
                        self.recv_stats["dup_dropped"] = \
                            self.recv_stats.get("dup_dropped", 0) + 1
                    if deadline is not None:
                        timeout = max(0.0, deadline - time.monotonic())
                    continue                   # a replayed frame: drop
                self._last_seq[kind] = int(seq)
            with self._lock:
                _account(self.recv_stats, kind, int(pb), len(blob))
            if not_before:
                wait_until(not_before, self.spin_s)
            msg = Message(self.peer, self.name, kind, _unpack(blob),
                          seq=int(seq), payload_bytes=int(pb),
                          wire_bytes=len(blob), not_before=not_before,
                          crc=int(crc))
            if self.tap is not None:
                self.tap(msg, blob)
            return msg

    def reset_dedup(self) -> None:
        """Forget the last delivered seq of every kind (after a rollback
        the replayed step's frames reuse their seqs)."""
        self._last_seq.clear()

    def empty(self) -> bool:
        """Nothing stashed and nothing waiting on the pipe."""
        with self._cond:
            return not self._stash and not self.conn.poll(0)

    def recv(self, timeout: Optional[float] = None) -> Message:
        # the frame is read (and its deadline waited out) outside the
        # lock, as the queue endpoint does: a waiter in ``recv_kind``
        # never waits behind a spin
        with self._cond:
            if self._stash:
                return self._stash.pop(0)
            self._check_peer()
        return self._recv_frame(timeout)

    _read = _recv_frame

    def _check_peer(self) -> None:
        if self.peer_error is not None:
            raise self.peer_error

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain_s: float = 5.0) -> None:
        """Flush the outbox, stop the writer, close the pipe."""
        if self._closed:
            return
        self._closed = True
        self._outq.put(_CLOSE)
        self._writer.join(timeout=drain_s)
        try:
            self.conn.close()
        except OSError:
            pass


def process_endpoint_pair(a: str, b: str, *, latency_s: float = 0.0,
                          bandwidth_bps: Optional[float] = None,
                          spin_s: Optional[float] = None, tap=None,
                          dedup: bool = False
                          ) -> Tuple[ProcessEndpoint, ProcessEndpoint]:
    """Both ends of a process boundary in the current process (the
    worker spawn builds the far end inside the child; see
    ``federation/runtime.py``; serving keeps both ends here).  ``tap``
    observes endpoint ``a``'s traffic in both directions; ``dedup`` turns
    on duplicate dropping on endpoint ``a``'s receive path."""
    import multiprocessing as mp
    c1, c2 = mp.Pipe(duplex=True)
    kw = dict(latency_s=latency_s, bandwidth_bps=bandwidth_bps,
              spin_s=spin_s)
    return (ProcessEndpoint(a, b, c1, tap=tap, dedup=dedup, **kw),
            ProcessEndpoint(b, a, c2, **kw))
