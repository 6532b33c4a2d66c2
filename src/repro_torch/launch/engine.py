"""Split-inference serving: wave and continuous batching over the party
boundary, session multiplexing and a repeat-entity cut cache (the
port's counterpart of ``repro.launch.engine``).

A deployer-facing layer over ``SplitModel.prefill``/``decode_step``.
Two schedulers share one engine:

  * ``scheduler="wave"`` admits requests in waves of ``batch_slots``,
    prefills them together, then decodes in lockstep until every request
    in the wave hits ``max_new`` or EOS: one decode position per wave.
  * ``scheduler="continuous"`` admits per slot: when a request hits
    EOS or ``max_new`` its slot is freed and refilled from the queue on
    the next tick by a prefill shaped like the whole batch (filler rows
    of padding), whose rows are copied into the live caches, and decode
    runs with one position per slot (``RowPositions``: the attention
    kernel's per-row lengths, the KV write at each row's position).
    Every row's result depends only on that row (the same GEMM shapes as
    the wave engine, per-row split plans in the kernel), so the tokens
    equal the wave engine's bit for bit.  With a transport the refill's
    prefill frames share the tick's decode frames' latency window.

Serving is the inference analogue of the paper's training protocol:
context slices stay with their owners; only cut activations reach the
scientist, who alone sees the generated text.  With a ``transport``
backend ("direct" | "queue" | "process") prefill and decode run as
separate owner/scientist segment programs and the cut tensors are real
wire payloads (measured bytes, injected latency and bandwidth, optional
fp16/int8 codec — ``federation.cut_codec``; the int8 codec runs the CUDA
quantize kernel on the card).

The **repeat-entity cut cache** (:class:`CutCache`) keys a request's
padded context by its sha256 content tag: a returning entity's admission
restores the owner-head and trunk KV rows plus the first-token logits
from the cache, with zero head recompute and zero cut-upload bytes,
recorded in ``transcript``.  Cached rows are bitwise what a fresh
prefill would give (prefill is row-independent).

**Session multiplexing** (:class:`ServingService`): many engine sessions
share one owner<->scientist channel pair, each session's frames
kind-scoped through ``transport.ScopedEndpoint`` (``"s3:"`` + kind),
with a service-wide cut cache.  Admission is a bounded queue per session
(``max_queue``): ``submit`` raises :class:`QueueFull`.

**Degraded service**: a transport or runtime fault inside ``run`` fails
the in-flight and queued requests one by one (``Result.error``) and the
engine keeps serving.

``ring_cache=True`` trims every sliding-window layer's KV cache to a
ring buffer of its window (``SplitModel.cache_init(ring=True)``) in
every cache the engine makes: a wave's, the continuous run's live
caches and each refill's.  (A local layer whose cache holds at most its
window takes the ring path whatever the flag, as in the reference.)

The engine runs on the CUDA card unless built with ``device="cpu"``;
the params must already live on that device.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.federation import batching, cut_codec
from repro_torch.federation import transport as transport_mod
from repro_torch.models.attention import RowPositions
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Request", "Result", "ServingEngine", "ServingService",
           "CutCache", "QueueFull", "CUT_DECODE_KIND", "CUT_PREFILL_KIND",
           "ADMIT_KIND"]

#: protocol kinds on the serving boundary (docs/WIRE_PROTOCOL.md)
CUT_DECODE_KIND = "cut_activations"   # per-tick decode cut slices
CUT_PREFILL_KIND = "cut_prefill"      # admission-time context cut rows
ADMIT_KIND = "admit"                  # slot-layout control frame
_CUT_KINDS = (CUT_DECODE_KIND, CUT_PREFILL_KIND)

# batch axis of the cache leaves: heads (P, n_units, B, ...), trunk
# (n_units, B, ...)
_HEADS_AXIS, _TRUNK_AXIS = 2, 1


class QueueFull(RuntimeError):
    """Admission rejected: the bounded request queue is at capacity.
    Carries ``queue_depth`` (how deep the queue was at rejection) and
    ``retry_after_s`` (the engine's mean per-request service time)."""

    def __init__(self, message: str, *, queue_depth: int = 0,
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


@dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (ctx,) int32 — the combined context
    max_new: int = 16
    submit_t: float = 0.0         # wall-clock at submit (latency anchor)
    tag: Optional[str] = None     # content tag of the padded context


@dataclass
class Result:
    rid: int
    generated: List[int] = field(default_factory=list)
    latency_s: float = 0.0        # submit -> finish (queueing + compute)
    error: Optional[str] = None   # set when the request failed (degraded
    #                               service: the engine survives)


class CutCache:
    """Repeat-entity cut cache: padded-context content tag -> the prefill
    artifacts both parties would otherwise recompute and ship (one slot's
    head KV rows, trunk KV rows and first-token logits).  The engine
    prefixes the tag with its geometry and codec, so an entry is only
    found by an engine that would have stored the same rows.
    LRU-bounded (``max_entries``); thread-safe (a service shares one
    across its sessions).  At full width an entry is large (llama3.2-3b
    at ctx 1024: about 122 MB of bf16 KV rows), so size it to the
    card."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._d: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, tag: str) -> Optional[dict]:
        with self._lock:
            entry = self._d.get(tag)
            if entry is not None:
                self._d.move_to_end(tag)
                self.hits += 1
            else:
                self.misses += 1
            return entry

    def put(self, tag: str, entry: dict) -> None:
        with self._lock:
            self._d[tag] = entry
            self._d.move_to_end(tag)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


def _rows(tree, axis: int, slot: int):
    """Copies of one batch row of every cache leaf."""
    return tree_map(lambda a: a.select(axis, slot).clone(), tree)


def _set_rows(tree, rows, axis: int, slot: int) -> None:
    for a, r in zip(tree_leaves(tree), tree_leaves(rows)):
        a.select(axis, slot).copy_(r)


def _scatter(live, fresh, idx: torch.Tensor, axis: int) -> None:
    """Copy rows ``idx`` of every ``fresh`` cache leaf into ``live``."""
    for a, b in zip(tree_leaves(live), tree_leaves(fresh)):
        a.index_copy_(axis, idx, b.index_select(axis, idx))


class ServingEngine:
    def __init__(self, model: SplitModel, params, *, batch_slots: int = 4,
                 ctx_len: int = 128, max_new: int = 32,
                 eos_token: Optional[int] = None, ring_cache: bool = False,
                 pad_token: int = 0, transport: Optional[str] = None,
                 latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None,
                 scheduler: str = "wave",
                 compression: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 cut_cache=None, endpoints: Optional[Tuple] = None,
                 device=None):
        """``transport`` ("direct" | "queue" | "process") routes every cut
        activation through a real channel: prefill and decode run as
        separate owner/scientist segment programs and ``stats`` reports
        *measured* cut bytes off the wire ("process" carries the frames
        over an OS pipe); ``latency_s`` / ``bandwidth_bps`` delay every
        frame.  ``scheduler`` picks wave or continuous batching (module
        docstring); ``compression`` applies a cut codec ("fp16" |
        "int8") on the wire; ``max_queue`` bounds the admission queue
        (``submit`` raises :class:`QueueFull` beyond it); ``cut_cache``
        turns on the repeat-entity cache (``True`` for a private one, or
        a shared :class:`CutCache`); ``endpoints`` injects a pre-built
        (owner, scientist) endpoint pair — how :class:`ServingService`
        multiplexes sessions onto one channel."""
        if model.cfg.modality != "text":
            raise ValueError("ServingEngine drives text archs")
        if scheduler not in ("wave", "continuous"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.device = resolve_device(device)
        leaf = tree_leaves(params)[0]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"on {self.device}")
        self.model, self.params = model, params
        self.ring = ring_cache
        self.B, self.S, self.max_new = batch_slots, ctx_len, max_new
        self.P = model.cfg.split.n_owners
        self.eos = eos_token
        self.pad = pad_token
        self.scheduler = scheduler
        self.max_queue = max_queue
        self._codec = cut_codec.get_codec(compression, self.device)
        self._cut_dtype = None        # model cut dtype, seen at first ship
        if cut_cache is True:
            cut_cache = CutCache()
        # "is a CutCache", not truthiness: an empty cache has len 0
        self.cut_cache: Optional[CutCache] = (
            cut_cache if isinstance(cut_cache, CutCache) else None)
        self._queue: List[Request] = []
        # popped from the queue by this tick's admission, not yet in a
        # slot: a fault in between must fail them too
        self._admitting: List[Request] = []
        self._next_rid = 0
        self._tick = 0
        #: protocol events: (event, rid, detail...) tuples — admissions,
        #: refills, cache hits and stores, finishes, degraded service
        self.transcript: List[Tuple] = []
        self._ep_owner = self._ep_sci = None
        self._owns_endpoints = False
        if endpoints is not None:
            self._ep_owner, self._ep_sci = endpoints
        elif transport == "process":
            from repro_torch.federation.process_transport import \
                process_endpoint_pair
            self._ep_owner, self._ep_sci = process_endpoint_pair(
                "owners", "scientist", latency_s=latency_s,
                bandwidth_bps=bandwidth_bps)
            self._owns_endpoints = True
        elif transport is not None:
            self._ep_owner, self._ep_sci = transport_mod.channel_pair(
                "owners", "scientist", backend=transport,
                latency_s=latency_s, bandwidth_bps=bandwidth_bps)
            self._owns_endpoints = True
        self.stats = {"waves": 0, "requests": 0, "tokens_generated": 0,
                      "wall_s": 0.0, "cut_payload_bytes": 0,
                      "cut_wire_bytes": 0, "cut_messages": 0,
                      "ticks": 0, "slot_refills": 0, "prefill_calls": 0,
                      "cut_cache_hits": 0,
                      "submitted": 0, "rejected": 0,
                      "peak_queue_depth": 0, "failed_requests": 0}
        self._cut_seen = (0, 0, 0)    # consumed (payload, wire, count)

    # ------------------------------------------------------------ admission

    def _retry_after(self) -> float:
        done = self.stats["requests"]
        return (self.stats["wall_s"] / done) if done else 0.05

    def submit(self, tokens, max_new: Optional[int] = None, *,
               block: bool = False, timeout: Optional[float] = None) -> int:
        """Queue one request.  When a bounded queue is at capacity:
        ``block=False`` (default) raises :class:`QueueFull` and counts
        the rejection in ``stats["rejected"]``; ``block=True`` waits (at
        most ``timeout`` seconds, forever when ``None``) for another
        thread to drain the queue before giving up the same way."""
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) > self.S:
            raise ValueError(f"context {len(tokens)} > engine ctx {self.S}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            pause = 0.005
            while block and len(self._queue) >= self.max_queue:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                time.sleep(pause if deadline is None else
                           min(pause, max(0.0,
                                          deadline - time.monotonic())))
                pause = min(pause * 2, 0.25)
            if len(self._queue) >= self.max_queue:
                self.stats["rejected"] += 1
                raise QueueFull(
                    f"admission queue at capacity ({self.max_queue})",
                    queue_depth=len(self._queue),
                    retry_after_s=self._retry_after())
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, tokens,
                                   min(max_new or self.max_new,
                                       self.max_new),
                                   submit_t=time.time()))
        self.stats["submitted"] += 1
        self.stats["peak_queue_depth"] = max(
            self.stats["peak_queue_depth"], len(self._queue))
        return rid

    # ------------------------------------------------------- cut shipping

    def _encode_cut(self, t: torch.Tensor) -> Dict[str, object]:
        if self._cut_dtype is None:
            self._cut_dtype = t.dtype
        return self._codec.encode(t)

    def _decode_cut(self, payload) -> torch.Tensor:
        x = self._codec.decode(payload)
        if self._codec.name != "none" and self._cut_dtype is not None:
            # lossy codecs decode to f32; restore the model's cut dtype
            x = x.to(self._cut_dtype)
        return x

    def _ship_cut(self, cuts, kind: str = CUT_DECODE_KIND) -> torch.Tensor:
        """Route cut activations through the owner->scientist channel
        (the measured boundary) and return the scientist-side tensor."""
        for i, c in enumerate(cuts):
            self._ep_owner.send(kind, self._encode_cut(c), seq=i)
        out = [self._decode_cut(self._ep_sci.recv_kind(kind).payload)
               for _ in cuts]
        return torch.stack(out) if len(out) > 1 else out[0]

    def _drain_cut_stats(self) -> None:
        """Fold the channel's cut-kind totals into ``stats`` as deltas:
        the engine's numbers count its own work even on a shared or
        long-lived endpoint."""
        if self._ep_sci is None:
            return
        bk = self._ep_sci.recv_stats["by_kind"]
        tot = [0, 0, 0]
        for kind in _CUT_KINDS:
            st = bk.get(kind, {})
            tot[0] += st.get("payload_bytes", 0)
            tot[1] += st.get("wire_bytes", 0)
            tot[2] += st.get("count", 0)
        seen = self._cut_seen
        self.stats["cut_payload_bytes"] += tot[0] - seen[0]
        self.stats["cut_wire_bytes"] += tot[1] - seen[1]
        self.stats["cut_messages"] += tot[2] - seen[2]
        self._cut_seen = tuple(tot)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device, without a sync."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------ wave scheduler

    def _split_prefill(self, owner_tokens, caches):
        cut, head_caches = self.model.prefill_heads(
            self.params["heads"], owner_tokens, caches["heads"])
        self.stats["prefill_calls"] += 1
        cut = self._ship_cut([cut[p] for p in range(self.P)],
                             CUT_DECODE_KIND)
        logits, trunk_caches = self.model.prefill_trunk(
            self.params["trunk"], cut, caches["trunk"])
        return logits, {"heads": head_caches, "trunk": trunk_caches}

    def _split_decode(self, caches, tok, pos, pos_local):
        z, head_caches = self.model.decode_heads(
            self.params["heads"], tok, caches["heads"], pos_local)
        z = self._ship_cut([z])          # only the generation owner's slice
        logits, trunk_caches = self.model.decode_trunk(
            self.params["trunk"], z, caches["trunk"], pos)
        return logits, {"heads": head_caches, "trunk": trunk_caches}

    def _run_wave(self, wave: List[Request]) -> List[Result]:
        t0 = time.time()
        B, S = self.B, self.S
        # serving layout (federation/batching.py): left-pad for recency,
        # then the standard (P, B, S_p) sequence-slice partition
        toks = batching.pad_contexts([r.tokens for r in wave], B, S,
                                     pad=self.pad, pad_side="left")
        caches = self.model.cache_init(B, S, n_new=self.max_new + 1,
                                       device=self.device, ring=self.ring)
        owner_tokens = batching.serving_owner_slices(toks, self.P,
                                                     self.device)
        if self._ep_owner is not None:
            logits, caches = self._split_prefill(owner_tokens, caches)
        else:
            logits, caches = self.model.prefill(
                self.params, {"owner_tokens": owner_tokens}, caches)
            self.stats["prefill_calls"] += 1
        tok = logits.argmax(-1)[:, None].to(torch.int32)

        results = [Result(r.rid) for r in wave]
        done = np.zeros(B, bool)
        done[len(wave):] = True                      # empty slots
        for t in range(self.max_new):
            tk = tok[:, 0].cpu().numpy()
            appended = 0
            now = time.time()
            for i, r in enumerate(wave):
                if not done[i]:
                    results[i].generated.append(int(tk[i]))
                    appended += 1
                    if (self.eos is not None and tk[i] == self.eos) or \
                            len(results[i].generated) >= r.max_new:
                        done[i] = True
                        results[i].latency_s = now - r.submit_t
            self.stats["tokens_generated"] += appended
            if done.all() or t == self.max_new - 1:
                break
            if self._ep_owner is not None:
                logits, caches = self._split_decode(caches, tok, S + t,
                                                    S // self.P + t)
            else:
                logits, caches = self.model.decode_step(
                    self.params, caches, tok, S + t, S // self.P + t)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        now = time.time()
        for r, res in zip(wave, results):
            if res.latency_s == 0.0:     # hit the max_new ceiling
                res.latency_s = now - r.submit_t
        self.stats["waves"] += 1
        self.stats["requests"] += len(wave)
        self.stats["wall_s"] += now - t0
        self._drain_cut_stats()
        return results

    # ------------------------------------------------ continuous scheduler

    def _entity_tag(self, row: np.ndarray) -> str:
        """Cache key = content tag x everything that changes the stored
        rows bit for bit: geometry, ring caches, codec, and which prefill
        program (fused or transport-split) produced them."""
        path = "t" if self._ep_owner is not None else "l"
        return (f"{self.B}x{self.S}+{self.max_new}:{int(self.ring)}:"
                f"{path}:{self._codec.name}:{batching.context_tag(row)}")

    def _admit(self, free: List[int]):
        """Pop up to ``len(free)`` queued requests into free slots:
        [(slot, request, cache entry or None, padded row)], logged."""
        admitted = []
        refill = self._tick > 0
        for slot in free:
            if not self._queue:
                break
            req = self._queue.pop(0)
            row = batching.pad_context_row(req.tokens, self.S,
                                           pad=self.pad)
            req.tag = self._entity_tag(row)
            entry = (self.cut_cache.get(req.tag)
                     if self.cut_cache is not None else None)
            admitted.append((slot, req, entry, row))
            self.transcript.append(("refill" if refill else "admit",
                                    req.rid, slot, self._tick))
            if refill:
                self.stats["slot_refills"] += 1
            if entry is not None:
                self.stats["cut_cache_hits"] += 1
                self.transcript.append(
                    ("cut_cache_hit", req.rid, req.tag[-16:]))
        return admitted

    def _refill_send(self, admitted, caches) -> Optional[dict]:
        """Owner half of an admission: a fresh prefill shaped like the
        whole batch with the admitted contexts in their slot rows (the
        other rows padding), the admitted rows' cut slices shipped, and
        the fresh head KV rows copied into the live caches.  Cache hits
        skip the prefill for their row (all-cached admissions skip it
        entirely: the control frame is all that crosses).  Called after
        the tick's decode ship is sent, so both share one latency
        window."""
        B, S, P = self.B, self.S, self.P
        fresh_slots = [(s, r) for s, r, e, _ in admitted if e is None]
        if not fresh_slots:
            if self._ep_owner is not None and admitted:
                idx = np.asarray([s for s, _, _, _ in admitted], np.int32)
                self._ep_owner.send(ADMIT_KIND, {
                    "slots": idx, "cached": np.ones(len(idx), np.uint8)})
            return None

        ctx = np.full((B, S), self.pad, np.int32)
        for slot, _, entry, row in admitted:
            if entry is None:
                ctx[slot] = row
        fresh = self.model.cache_init(B, S, n_new=self.max_new + 1,
                                      device=self.device, ring=self.ring)
        owner_tokens = batching.serving_owner_slices(ctx, P, self.device)
        idx_np = np.asarray([s for s, _ in fresh_slots], np.int64)
        ship = {"fresh": fresh, "idx": self._on_device(idx_np),
                "fresh_slots": fresh_slots}
        if self._ep_owner is not None:
            cut, fresh_hc = self.model.prefill_heads(
                self.params["heads"], owner_tokens, fresh["heads"])
            self.stats["prefill_calls"] += 1
            # only the admitted rows' cut slices cross; the scientist puts
            # them into an all-zero buffer (filler rows never touch the
            # admitted rows' results)
            self._ep_owner.send(ADMIT_KIND, {
                "slots": idx_np.astype(np.int32),
                "cached": np.zeros(len(idx_np), np.uint8)})
            for p in range(P):
                self._ep_owner.send(CUT_PREFILL_KIND,
                                    self._encode_cut(cut[p, ship["idx"]]),
                                    seq=p)
            ship["cut_shape"] = tuple(cut.shape)
            ship["cut_dtype"] = cut.dtype
            _scatter(caches["heads"], fresh_hc, ship["idx"], _HEADS_AXIS)
        else:
            ship["owner_tokens"] = owner_tokens
        return ship

    def _refill_recv(self, ship, admitted, caches) -> Dict[int, int]:
        """Scientist half of an admission: receive the fresh cut rows,
        prefill the trunk on them, copy the fresh trunk KV rows in,
        restore cached entries' rows, store new cache entries.  Returns
        {slot: first token} for every admitted slot."""
        first: Dict[int, int] = {}
        if ship is not None:
            idx = ship["idx"]
            fresh = ship["fresh"]
            if self._ep_owner is not None:
                self._ep_sci.recv_kind(ADMIT_KIND)
                buf = torch.zeros(ship["cut_shape"], dtype=ship["cut_dtype"],
                                  device=self.device)
                for p in range(self.P):
                    buf[p].index_copy_(0, idx, self._decode_cut(
                        self._ep_sci.recv_kind(CUT_PREFILL_KIND).payload))
                logits, fresh_tc = self.model.prefill_trunk(
                    self.params["trunk"], buf, fresh["trunk"])
                fresh_hc = fresh["heads"]
            else:
                logits, fresh_caches = self.model.prefill(
                    self.params, {"owner_tokens": ship["owner_tokens"]},
                    fresh)
                self.stats["prefill_calls"] += 1
                fresh_hc, fresh_tc = (fresh_caches["heads"],
                                      fresh_caches["trunk"])
                _scatter(caches["heads"], fresh_hc, idx, _HEADS_AXIS)
            _scatter(caches["trunk"], fresh_tc, idx, _TRUNK_AXIS)
            toks = logits.argmax(-1).cpu().numpy()
            for slot, req in ship["fresh_slots"]:
                first[slot] = int(toks[slot])
                if self.cut_cache is not None:
                    self.cut_cache.put(req.tag, {
                        "hc_row": _rows(fresh_hc, _HEADS_AXIS, slot),
                        "tc_row": _rows(fresh_tc, _TRUNK_AXIS, slot),
                        "logits": logits[slot].clone()})
                    self.transcript.append(
                        ("cut_cache_store", req.rid, req.tag[-16:]))
        elif admitted and self._ep_owner is not None:
            self._ep_sci.recv_kind(ADMIT_KIND)

        for slot, req, entry, _ in admitted:
            if entry is not None:
                _set_rows(caches["heads"], entry["hc_row"], _HEADS_AXIS,
                          slot)
                _set_rows(caches["trunk"], entry["tc_row"], _TRUNK_AXIS,
                          slot)
                first[slot] = int(entry["logits"].argmax())
        return first

    def _fail_pending(self, exc: BaseException, out: Dict[int, Result],
                      slots: Optional[List[Optional[Request]]] = None,
                      results: Optional[Dict[int, Result]] = None
                      ) -> None:
        """Degraded service: the scheduler hit a transport or runtime
        fault.  Every in-flight and queued request gets a ``Result`` with
        ``error`` set instead of ``run`` raising, so a deployment keeps
        answering its other sessions.  That includes requests this tick's
        admission took from the queue but had not yet put in a slot (the
        reference's engine drops those without a ``Result``)."""
        err = f"{type(exc).__name__}: {exc}"
        now = time.time()
        for req in ([r for r in (slots or []) if r is not None]
                    + self._admitting + self._queue):
            res = (results or {}).get(req.rid) or Result(req.rid)
            res.error = err
            res.latency_s = now - req.submit_t
            out[req.rid] = res
            self.stats["failed_requests"] += 1
        if slots is not None:
            slots[:] = [None] * len(slots)
        self._admitting = []
        self._queue.clear()
        self.transcript.append(("degraded", -1, err[:120]))

    def _run_continuous(self) -> Dict[int, Result]:
        out: Dict[int, Result] = {}
        if not self._queue:
            return out
        t0 = time.time()
        B = self.B
        caches = self.model.cache_init(B, self.S, n_new=self.max_new + 1,
                                       device=self.device, ring=self.ring)
        slots: List[Optional[Request]] = [None] * B
        results: Dict[int, Result] = {}
        gen = np.zeros(B, np.int64)        # tokens appended per slot
        tok_np = np.zeros(B, np.int32)     # next token to append per slot
        self._tick = 0
        try:
            self._continuous_loop(out, caches, slots, results, gen, tok_np)
        except (RuntimeError, OSError) as e:
            if isinstance(e, QueueFull):
                raise
            self._fail_pending(e, out, slots, results)
        self.stats["wall_s"] += time.time() - t0
        self._drain_cut_stats()
        return out

    def _continuous_loop(self, out, caches, slots, results, gen, tok_np
                         ) -> None:
        B, S, P = self.B, self.S, self.P
        while self._queue or any(s is not None for s in slots):
            continuing = [i for i in range(B) if slots[i] is not None]
            free = [i for i in range(B) if slots[i] is None]
            admitted = self._admit(free) if self._queue else []
            self._admitting = [req for _, req, _, _ in admitted]

            # one decode tick for the continuing slots (input: the token
            # appended last tick, at the slot's own position).  The whole
            # batch decodes: freed rows carry garbage at frozen positions,
            # which row independence keeps harmless.  Over a transport the
            # decode ship and the refill's prefill ship are both sent
            # before either receive waits, so a refill tick pays one
            # latency window, not two.
            ship = None
            if continuing:
                tok = self._on_device(tok_np[:, None])
                step = np.maximum(gen, 1) - 1
                pos = RowPositions(S + step, self.device)
                pos_l = RowPositions(S // P + step, self.device)
                if self._ep_owner is not None:
                    z, _ = self.model.decode_heads(
                        self.params["heads"], tok, caches["heads"], pos_l)
                    self._ep_owner.send(CUT_DECODE_KIND,
                                        self._encode_cut(z))
                    if admitted:
                        ship = self._refill_send(admitted, caches)
                    z = self._decode_cut(
                        self._ep_sci.recv_kind(CUT_DECODE_KIND).payload)
                    logits_dec, _ = self.model.decode_trunk(
                        self.params["trunk"], z, caches["trunk"], pos)
                else:
                    logits_dec, _ = self.model.decode_step(
                        self.params, caches, tok, pos, pos_l)
                    if admitted:
                        ship = self._refill_send(admitted, caches)
                dec_tok = logits_dec.argmax(-1).cpu().numpy()
            elif admitted:
                ship = self._refill_send(admitted, caches)
            first = (self._refill_recv(ship, admitted, caches)
                     if admitted else {})

            for i in continuing:
                tok_np[i] = dec_tok[i]
            for slot, req, _, _ in admitted:
                slots[slot] = req
                results[req.rid] = Result(req.rid)
                gen[slot] = 0
                tok_np[slot] = first[slot]
            self._admitting = []

            # append phase: every active slot banks one token, then
            # EOS / max_new frees the slot for the next tick's refill
            now = time.time()
            for i in range(B):
                req = slots[i]
                if req is None:
                    continue
                res = results[req.rid]
                res.generated.append(int(tok_np[i]))
                gen[i] += 1
                self.stats["tokens_generated"] += 1
                if (self.eos is not None and tok_np[i] == self.eos) or \
                        len(res.generated) >= req.max_new:
                    res.latency_s = now - req.submit_t
                    self.transcript.append(("finish", req.rid, i,
                                            self._tick))
                    out[req.rid] = res
                    self.stats["requests"] += 1
                    slots[i] = None
            self._tick += 1
            self.stats["ticks"] += 1

    # --------------------------------------------------------------- run

    def run(self) -> Dict[int, Result]:
        """Drain the queue; returns {request_id: Result}.  Requests that
        hit a transport or runtime fault mid-flight come back with
        ``Result.error`` set instead of raising (degraded service)."""
        with torch.inference_mode():
            if self.scheduler == "continuous":
                return self._run_continuous()
            out: Dict[int, Result] = {}
            while self._queue:
                wave, self._queue = (self._queue[:self.B],
                                     self._queue[self.B:])
                try:
                    for res in self._run_wave(wave):
                        out[res.rid] = res
                except (RuntimeError, OSError) as e:
                    self._queue = wave + self._queue   # wave died unserved
                    self._fail_pending(e, out)
            return out

    def close(self) -> None:
        """Release engine-owned endpoints (a process pipe's writer
        threads); shared service endpoints are left alone."""
        if self._owns_endpoints:
            for ep in (self._ep_owner, self._ep_sci):
                if ep is not None and hasattr(ep, "close"):
                    ep.close()


class ServingService:
    """One split-serving deployment: a single owner<->scientist channel
    shared by many concurrent engine sessions, plus a service-wide
    repeat-entity :class:`CutCache`.

    Each ``session()`` is a full :class:`ServingEngine` whose frames ride
    the shared channel with a ``"s{sid}:"`` kind prefix
    (``transport.ScopedEndpoint``); the endpoint's ``recv_kind`` absorbs
    the sessions' interleaving, and each session's stats come from the
    prefix-filtered ``by_kind`` totals.  Sessions may run on separate
    threads.  Engine defaults passed here apply to every session; the
    shared cut cache needs sessions of one geometry (the cache tag
    enforces it: mismatched sessions never hit)."""

    def __init__(self, model: SplitModel, params, *,
                 transport: str = "queue", latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None,
                 cut_cache=True, cache_entries: int = 256,
                 **engine_defaults):
        self.model, self.params = model, params
        self.transport = transport
        if transport == "process":
            from repro_torch.federation.process_transport import \
                process_endpoint_pair
            self._ep_owner, self._ep_sci = process_endpoint_pair(
                "owners", "scientist", latency_s=latency_s,
                bandwidth_bps=bandwidth_bps)
        else:
            self._ep_owner, self._ep_sci = transport_mod.channel_pair(
                "owners", "scientist", backend=transport,
                latency_s=latency_s, bandwidth_bps=bandwidth_bps)
        if cut_cache is True:
            cut_cache = CutCache(cache_entries)
        self.cut_cache = (cut_cache if isinstance(cut_cache, CutCache)
                          else None)
        self._defaults = dict(engine_defaults)
        self._defaults.setdefault("scheduler", "continuous")
        self._sid = 0
        self.sessions: List[ServingEngine] = []

    def session(self, **engine_kw) -> ServingEngine:
        """A new multiplexed serving session on the shared channel."""
        sid = self._sid
        self._sid += 1
        scope = f"s{sid}:"
        kw = {**self._defaults, **engine_kw}
        eng = ServingEngine(
            self.model, self.params, cut_cache=self.cut_cache,
            endpoints=(transport_mod.ScopedEndpoint(self._ep_owner, scope),
                       transport_mod.ScopedEndpoint(self._ep_sci, scope)),
            **kw)
        eng.sid = sid
        self.sessions.append(eng)
        return eng

    @property
    def channel_stats(self) -> Dict[str, object]:
        """The shared channel's raw (unscoped) receive totals."""
        return self._ep_sci.recv_stats

    def close(self) -> None:
        for ep in (self._ep_owner, self._ep_sci):
            if hasattr(ep, "close"):
                ep.close()
