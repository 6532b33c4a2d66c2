"""Programmable, deterministic fault injection for the federation runtime
(the port's copy of ``repro.federation.faults``: plain Python, the same
plans and the same env strings).

A plan is a picklable list of :class:`Fault` s, each targeting a party x
message kind x occurrence index (or an exact training step), with five
actions:

  ``crash``           the actor raises before handling the message
  ``wedge``           the actor sleeps for an hour (liveness test)
  ``drop_frame``      the frame is silently lost on the wire
  ``corrupt_frame``   a blob byte is flipped after the CRC is computed
                      (the receiver raises ``transport.FrameCorrupt``)
  ``delay``           the frame's delivery deadline is pushed back

Plans ride the env channel ``REPRO_CHAOS_PARTY``, which spawned workers
inherit: single legacy tokens and comma-separated multi-party tokens
round-trip losslessly (``owner0:crash_fwd,owner1:wedge_psi``); anything
richer rides a ``json:`` prefix.

Determinism: every fault carries an occurrence index counted per
matching event and a worker ``gen``eration.  A respawned worker is armed
with ``generation=1+``, so a fault bound to generation 0 (the default)
fires once and never again: the recovery tests crash a worker
deterministically and then show that the rerun is fault-free.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

__all__ = ["Fault", "FaultPlan", "FaultInjector", "arm_actor",
           "arm_endpoint", "plan_from_env", "CHAOS_ENV", "ACTIONS"]

#: the env channel chaos plans ride into spawned workers
CHAOS_ENV = "REPRO_CHAOS_PARTY"

ACTIONS = ("crash", "wedge", "drop_frame", "corrupt_frame", "delay")
_ACTOR_ACTIONS = ("crash", "wedge")
_WIRE_ACTIONS = ("drop_frame", "corrupt_frame", "delay")

#: legacy single-token spellings -> (action, message kind)
_LEGACY = {
    "crash_fwd": ("crash", "head_fwd"),
    "wedge_fwd": ("wedge", "head_fwd"),
    "crash_psi": ("crash", "psi_blind_chunk"),
    "wedge_psi": ("wedge", "psi_blind_chunk"),
}
_LEGACY_INV = {v: k for k, v in _LEGACY.items()}


@dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``occurrence`` indexes the matching events
    (0 = first message of ``kind`` seen by this party, ``None`` = every
    one); ``step`` additionally pins the message's ``seq``; ``gen``
    restricts the fault to one worker generation (``None`` = all;
    respawned workers are armed with generation 1+)."""

    party: str
    action: str
    kind: str = "head_fwd"
    occurrence: Optional[int] = 0
    step: Optional[int] = None
    gen: Optional[int] = 0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"known: {ACTIONS}")


class FaultPlan:
    """An ordered, picklable collection of :class:`Fault` s with a
    lossless round-trip through the ``REPRO_CHAOS_PARTY`` env string."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FaultPlan)
                and self.faults == other.faults)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.faults)!r})"

    def for_party(self, party: str) -> List[Fault]:
        return [f for f in self.faults if f.party == party]

    def to_env(self) -> str:
        """Serialize for the env channel.  Plans expressible in the
        legacy grammar emit comma-separated ``<party>:<action>`` tokens
        (a one-fault plan is the single legacy token); anything richer
        emits ``json:[...]``."""
        toks = []
        for f in self.faults:
            key = (f.action, f.kind)
            legacy = (key in _LEGACY_INV and f.occurrence == 0
                      and f.step is None and f.gen == 0
                      and f.delay_s == 0.0)
            if not legacy:
                return "json:" + json.dumps(
                    [dataclasses.asdict(x) for x in self.faults])
            toks.append(f"{f.party}:{_LEGACY_INV[key]}")
        return ",".join(toks)

    @classmethod
    def from_env(cls, spec: str) -> "FaultPlan":
        spec = (spec or "").strip()
        if not spec:
            return cls()
        if spec.startswith("json:"):
            return cls(Fault(**d) for d in json.loads(spec[5:]))
        faults = []
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            who, _, action = tok.partition(":")
            if action in _LEGACY:           # unknown tokens are inert
                act, kind = _LEGACY[action]
                faults.append(Fault(who, act, kind))
        return cls(faults)


def plan_from_env() -> FaultPlan:
    """The plan currently riding the env channel (empty when unset)."""
    return FaultPlan.from_env(os.environ.get(CHAOS_ENV, ""))


class FaultInjector:
    """A party's armed view of a plan: per-fault occurrence counters,
    filtered to one worker generation.  ``actor_fault`` drives the
    crash/wedge wrap; ``wire_fault`` drives the transport send hook."""

    def __init__(self, plan: FaultPlan, party: str, generation: int = 0):
        mine = [f for f in plan.for_party(party)
                if f.gen is None or f.gen == generation]
        self.party, self.generation = party, generation
        self._actor = [f for f in mine if f.action in _ACTOR_ACTIONS]
        self._wire = [f for f in mine if f.action in _WIRE_ACTIONS]
        self._hits = {id(f): 0 for f in mine}

    @property
    def has_actor_faults(self) -> bool:
        return bool(self._actor)

    @property
    def has_wire_faults(self) -> bool:
        return bool(self._wire)

    def _fire(self, fault: Fault, kind: str, seq: int) -> bool:
        if fault.kind != kind:
            return False
        if fault.step is not None and seq != fault.step:
            return False
        n = self._hits[id(fault)]
        self._hits[id(fault)] = n + 1
        return fault.occurrence is None or n == fault.occurrence

    def actor_fault(self, kind: str, seq: int = 0) -> Optional[str]:
        """``"crash"`` / ``"wedge"`` when a fault fires on this message,
        else ``None``."""
        for f in self._actor:
            if self._fire(f, kind, seq):
                return f.action
        return None

    def wire_fault(self, kind: str, seq: int = 0
                   ) -> Optional[Tuple[str, float]]:
        """``(action, delay_s)`` when a wire fault fires on this frame,
        else ``None``."""
        for f in self._wire:
            if self._fire(f, kind, seq):
                return (f.action, f.delay_s)
        return None


def arm_actor(actor, party: str, *, generation: int = 0,
              plan: Optional[FaultPlan] = None):
    """Wrap ``actor.handle`` with this party's crash/wedge faults (the
    plan defaults to the env channel's).  A crash raises ``chaos:
    injected crash in <party> on <kind>``; a wedge sleeps an hour
    mid-protocol."""
    plan = plan_from_env() if plan is None else plan
    inj = FaultInjector(plan, party, generation)
    if not inj.has_actor_faults:
        return actor
    orig = actor.handle

    def handle(msg):
        action = inj.actor_fault(msg.kind, msg.seq)
        if action == "crash":
            raise RuntimeError(
                f"chaos: injected crash in {party} on {msg.kind}")
        if action == "wedge":
            time.sleep(3600.0)
        return orig(msg)

    actor.handle = handle
    return actor


def arm_endpoint(ep, party: str, *, generation: int = 0,
                 plan: Optional[FaultPlan] = None):
    """Install this party's wire faults (drop/corrupt/delay) as the
    transport's send hook.  On a queue ``transport.Endpoint`` the hook
    lands on both of its channels (each protocol kind is sent by exactly
    one side, so occurrence counters never fire twice); on a
    ``process_transport.ProcessEndpoint`` it lands on the endpoint
    itself: arm the end that *sends* the targeted kind."""
    plan = plan_from_env() if plan is None else plan
    inj = FaultInjector(plan, party, generation)
    if not inj.has_wire_faults:
        return ep
    if hasattr(ep, "outbox"):
        ep.outbox.fault_hook = inj.wire_fault
        ep.inbox.fault_hook = inj.wire_fault
    else:
        ep.fault_hook = inj.wire_fault
    return ep
