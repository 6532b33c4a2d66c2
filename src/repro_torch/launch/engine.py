"""Split-inference serving: the wave engine over the party boundary (the
port's counterpart of ``repro.launch.engine``).

A deployer-facing layer over ``SplitModel.prefill``/``decode_step``.
``scheduler="wave"`` admits requests in waves of ``batch_slots``,
prefills them together, then decodes in lockstep until every request in
the wave hits ``max_new`` or EOS.

Serving is the inference analogue of the paper's training protocol:
context slices stay with their owners; only cut activations reach the
scientist, who alone sees the generated text.  With a ``transport``
backend ("direct" | "queue") prefill and decode run as separate
owner/scientist segment programs and the cut tensors are real wire
payloads (measured bytes, optional fp16/int8 codec —
``federation.cut_codec``; the int8 codec runs the CUDA quantize kernel
on the card).

The engine runs on the CUDA card unless built with ``device="cpu"``;
the params must already live on that device.

Not ported yet (each raises ``NotImplementedError`` naming its
ROADMAP.md item): ``scheduler="continuous"``, the repeat-entity cut
cache, ``ServingService`` session multiplexing (injected endpoints),
``transport="process"``, injected latency/bandwidth, ring caches, and
degraded service — a fault inside ``run`` raises instead of failing
requests one by one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import not_ported
from repro_torch.device import resolve_device
from repro_torch.federation import batching, cut_codec
from repro_torch.federation import transport as transport_mod
from repro_torch.models.model import SplitModel
from repro_torch.tree import tree_leaves

__all__ = ["Request", "Result", "ServingEngine", "QueueFull",
           "CUT_DECODE_KIND"]

#: the protocol kind of the wave engine's cuts, prefill and decode alike
#: (docs/WIRE_PROTOCOL.md)
CUT_DECODE_KIND = "cut_activations"

_SERVING_ITEM = "item 11, serving beyond the wave engine"


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


@dataclass
class Result:
    rid: int
    generated: List[int] = field(default_factory=list)
    latency_s: float = 0.0        # submit -> finish (queueing + compute)


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
                 cut_cache=None, endpoints=None, device=None):
        """``transport`` ("direct" | "queue") routes every cut activation
        through a real ``federation.transport`` channel: prefill and
        decode run as separate owner/scientist segment programs and
        ``stats`` reports *measured* cut bytes off the wire.
        ``compression`` applies a cut codec ("fp16" | "int8") on the
        wire; ``max_queue`` bounds the admission queue (``submit``
        raises :class:`QueueFull` beyond it)."""
        if scheduler == "continuous":
            raise not_ported("scheduler='continuous'", _SERVING_ITEM)
        if scheduler != "wave":
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if cut_cache not in (None, False):
            raise not_ported("the repeat-entity cut cache", _SERVING_ITEM)
        if endpoints is not None:
            raise not_ported("injected endpoints (ServingService)",
                             _SERVING_ITEM)
        if transport == "process":
            raise not_ported("transport='process' on serving",
                             _SERVING_ITEM)
        if latency_s or bandwidth_bps is not None:
            raise not_ported("injected latency/bandwidth", _SERVING_ITEM)
        if ring_cache:
            raise not_ported("ring caches", "item 12, KV cache variants")
        self.device = resolve_device(device)
        leaf = tree_leaves(params)[0]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"on {self.device}")
        self.model, self.params = model, params
        self.B, self.S, self.max_new = batch_slots, ctx_len, max_new
        self.P = model.cfg.split.n_owners
        self.eos = eos_token
        self.pad = pad_token
        self.max_queue = max_queue
        self._codec = cut_codec.get_codec(compression, self.device)
        self._cut_dtype = None        # model cut dtype, seen at first ship
        self._queue: List[Request] = []
        self._next_rid = 0
        self._ep_owner = self._ep_sci = None
        if transport is not None:
            self._ep_owner, self._ep_sci = transport_mod.channel_pair(
                "owners", "scientist", backend=transport)
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
        """Fold the channel's cut-kind totals into ``stats`` as deltas."""
        if self._ep_sci is None:
            return
        st = self._ep_sci.recv_stats["by_kind"].get(CUT_DECODE_KIND, {})
        tot = [st.get("payload_bytes", 0), st.get("wire_bytes", 0),
               st.get("count", 0)]
        seen = self._cut_seen
        self.stats["cut_payload_bytes"] += tot[0] - seen[0]
        self.stats["cut_wire_bytes"] += tot[1] - seen[1]
        self.stats["cut_messages"] += tot[2] - seen[2]
        self._cut_seen = tuple(tot)

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
                                       device=self.device)
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

    # --------------------------------------------------------------- run

    def run(self) -> Dict[int, Result]:
        """Drain the queue; returns {request_id: Result}."""
        out: Dict[int, Result] = {}
        with torch.inference_mode():
            while self._queue:
                wave, self._queue = (self._queue[:self.B],
                                     self._queue[self.B:])
                for res in self._run_wave(wave):
                    out[res.rid] = res
        return out

    def close(self) -> None:
        """The reference's API: it releases process pipes.  The queue and
        direct channels hold no OS resources, so there is nothing to
        release."""
