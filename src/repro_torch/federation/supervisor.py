"""Liveness supervision for party workers: heartbeats, failure
attribution and the restart budget (the port's copy of
``repro.federation.supervisor``).

Every party is an independent failure domain, so the trusted runtime
must notice a dead or wedged party without waiting for a protocol
timeout.  :class:`Supervisor` runs a daemon thread that, every
``heartbeat_s`` seconds, sends a ``heartbeat`` frame to each attached
party over its transport endpoint and drains ``heartbeat_ack`` replies
(``OwnerComputeEndpoint`` answers inline between protocol messages).  A
party is marked failed when

  * its worker surfaces an error (error frame, exit code, thread error),
  * its endpoint refuses the send (closed pipe), or
  * no ack lands for ``miss_limit`` consecutive periods (a wedged actor
    stops answering long before a protocol receive times out).

Failures land in :attr:`Supervisor.failed`.  The supervised fit's
receives from a party read that verdict while they wait, so a wedged
party fails its receive after ``miss_limit * heartbeat_s`` seconds
instead of the protocol timeout.  Recovery (rollback, respawn, replay:
``fit(supervise=True)``) is driven by the session, which charges
:meth:`plan_restart` for the bounded-backoff, max-restart budget.

Heartbeats never touch model state, so a supervised run's arithmetic is
the unsupervised run's bit for bit; the extra frames show only in the
message counts.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = ["OwnerFailure", "Supervisor"]


class OwnerFailure(RuntimeError):
    """A protocol failure attributed to one party.  A ``RuntimeError``
    with the session's usual messages, so callers matching on those keep
    working; ``.party`` names the failure domain, so recovery knows whom
    to restart."""

    def __init__(self, message: str, *, party: str):
        super().__init__(message)
        self.party = party


class Supervisor:
    """Heartbeat monitor and restart budget for a set of party endpoints.

    ``attach(name, ep, worker)`` registers a party (``worker``: anything
    with an ``error`` attribute, or None); ``start()`` / ``stop()`` bound
    the monitor thread's life.  ``failed`` maps a party's name to the
    exception that condemned it.  ``plan_restart(name)`` sleeps the
    bounded exponential backoff and raises once the party's budget is
    spent.
    """

    def __init__(self, *, heartbeat_s: float = 0.5, miss_limit: int = 8,
                 max_restarts: int = 2, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0):
        self.heartbeat_s = heartbeat_s
        self.miss_limit = miss_limit
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.failed: Dict[str, BaseException] = {}
        self.stats = {"heartbeats_sent": 0, "heartbeat_acks": 0,
                      "suspected": 0, "respawns": 0}
        self._parties: Dict[str, tuple] = {}
        self._last_ack: Dict[str, float] = {}
        self._restarts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- membership --------------------------------------------------------
    def attach(self, name: str, ep, worker=None) -> None:
        with self._lock:
            self._parties[name] = (ep, worker)
            self._last_ack[name] = time.monotonic()
            self.failed.pop(name, None)

    def detach(self, name: str) -> None:
        with self._lock:
            self._parties.pop(name, None)
            self._last_ack.pop(name, None)
            self.failed.pop(name, None)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="supervisor-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=5.0)

    # -- the monitor -------------------------------------------------------
    def _condemn(self, name: str, reg: tuple, exc: BaseException) -> None:
        # only the registration the verdict was reached on: a tick that
        # outlives a detach (a respawn) must not condemn the newcomer
        with self._lock:
            if self._parties.get(name) is reg and name not in self.failed:
                self.failed[name] = exc
                self.stats["suspected"] += 1

    def _tick(self, n: int) -> None:
        with self._lock:
            parties = list(self._parties.items())
        for name, reg in parties:
            ep, worker = reg
            if name in self.failed:
                continue
            err = getattr(worker, "error", None) if worker else None
            if err is not None:
                self._condemn(name, reg, err)
                continue
            try:
                ep.send("heartbeat", {}, seq=n)
                self.stats["heartbeats_sent"] += 1
            except RuntimeError as e:
                self._condemn(name, reg, e)
                continue
            try:
                ep.recv_kind("heartbeat_ack", timeout=0.02)
                self._last_ack[name] = time.monotonic()
                self.stats["heartbeat_acks"] += 1
            except Exception:       # noqa: BLE001 — no ack this period
                pass                # (or a dead pipe): staleness decides
            stale = time.monotonic() - self._last_ack.get(
                name, time.monotonic())
            if stale > self.miss_limit * self.heartbeat_s:
                self._condemn(name, reg, RuntimeError(
                    f"party {name!r} unresponsive: no heartbeat ack for "
                    f"{stale:.1f}s ({self.miss_limit} periods)"))

    def _loop(self) -> None:
        n = 0
        while not self._stop.wait(self.heartbeat_s):
            n += 1
            self._tick(n)

    # -- restart budget ----------------------------------------------------
    def restarts(self, name: str) -> int:
        return self._restarts.get(name, 0)

    def plan_restart(self, name: str) -> float:
        """Charge one restart for ``name``: raises ``RuntimeError`` once
        the party's budget is spent, else sleeps the bounded exponential
        backoff and returns the delay slept.  Clears the party's failed
        mark so the monitor adopts it again on re-attach."""
        n = self._restarts.get(name, 0)
        if n >= self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted for party {name!r} "
                f"({self.max_restarts} restarts)") from self.failed.get(name)
        self._restarts[name] = n + 1
        self.stats["respawns"] += 1
        delay = min(self.backoff_base_s * (2 ** n), self.backoff_cap_s)
        time.sleep(delay)
        with self._lock:
            self.failed.pop(name, None)
            self._last_ack[name] = time.monotonic()
        return delay
