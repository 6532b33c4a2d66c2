"""VerticalSession — the entry point of the port's training path (the
port's counterpart of ``repro.federation.session``).

The paper's pipeline (Fig. 2): resolve -> build -> fit -> evaluate.

<!-- docs-check: skip -->
```python
from repro_torch.configs import CONFIG
from repro_torch.data import make_vertical_mnist_parties
from repro_torch.federation import VerticalSession, feature_parties

sci, owners = feature_parties(*make_vertical_mnist_parties(2000))
session = VerticalSession(sci, owners)          # the CUDA card
session.resolve(group="modp512")                # DH-PSI + ID alignment
session.build(CONFIG)                           # the dual-headed SplitNN
session.fit(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
            compression="int8", backend="queue")
session.evaluate()
```

The session runs on the CUDA card unless built with ``device="cpu"``;
with no card and no explicit device it raises.

Training modes:

  * ``fit(mode="joint")`` — one autograd step per batch through the
    whole model (the gradient-equivalence oracle).
  * ``fit(mode="split")`` — true split execution: each owner's head runs
    on its own thread (``backend="queue"|"direct"``) or in its own
    spawned OS process (``backend="process"``) behind a transport
    channel; only cut activations and cut gradients cross, measured on
    the wire.  With the lossless codec it reproduces the joint path bit
    for bit (both schedules, every backend).  ``compression="int8"``
    ships cuts and gradients through the int8 quantize kernel.
  * ``microbatches=M`` cuts every batch into M GPipe chunks: the split
    pipelined schedule ships each chunk's cut gradient as soon as its
    cuts arrive, and ``fit(mode="joint", microbatches=M)`` is its
    bit-for-bit oracle (per-chunk programs, gradients summed in chunk
    order, one update per step).

Privacy (``SplitConfig`` and ``fit(aggregation=...)``):

  * ``aggregation="masked_sum"`` (sum combine, >= 2 owners): secure
    forward aggregation (``core/masking.py``).  Each owner ships its cut
    quantized and ring-masked with pairwise-cancelling masks (root seed
    ``REPRO_MASK_SEED`` where the environment sets it, else the init
    seed), so the scientist reconstructs only the owners' sum, which
    enters the usual trunk programs as one owner plane.  ``mode="joint"`` with it runs
    the masked joint oracle (the same quantize -> ring sum ->
    dequantize, without masks) through the microbatched loop, even at
    M = 1; masked split execution reproduces it bit for bit.
  * ``nopeek_weight``: the NoPeek term in the objective (joint) or in
    each owner's head backward (split).
  * ``cut_noise_std``: the owners' deterministic noise on every
    steady-state cut they ship (split).
  * ``grad_norm_mode`` / ``grad_noise_std``: the scientist's
    obfuscation of every cut-gradient chunk it ships (split).

The scientist's trunk takes the owners' cuts through the cut-fusion
kernel (``MLPSplitNN.trunk_apply``) on every path: joint, split,
microbatched, masked (the ring sum as one owner plane) and evaluation.

Party-visibility contract: owners never see labels, the scientist never
receives raw feature arrays; every cross-party message the session
mediates is appended to ``session.transcript``.

Supervised recovery (``fit(mode="split", supervise=True)``, queue or
process backend): snapshot markers every ``resync_every`` steps,
heartbeats (``federation/supervisor.py``: 8 missed in a row fail the
owner), and on an owner's crash, wedge or corrupt frame a rollback to the newest marker, a respawn of the
dead owner and a replay of the steps since, with the fault-free run's
bits; each recovery lands in ``session.recovery_events``.  Faults are
injected from a plan in ``REPRO_CHAOS_PARTY`` (``federation/faults.py``).

Entity resolution (``resolve``) takes every option of the reference's:
the ``noinv``, ``bloom`` and membership-hiding ``hidden`` modes, the
modexp worker pool, the ``direct`` / ``queue`` / ``process`` backends
with latency and bandwidth, O(Δ) delta rounds after churn, and retries
of a crashed or wedged owner round.

Training options of the reference's ``fit`` that the port takes as
well: ``latency_s`` / ``bandwidth_bps`` (every frame of a split fit's
wire waits out ``latency_s + wire_bytes / bandwidth_bps``, for thread
and spawned owners alike), ``log_every``, owners of unequal feature
widths (``feature_splits`` in the config), and per-party checkpoints
(``checkpoint`` / ``restore``, ``fit(ckpt_dir=, ckpt_every=)``; files
under ``step_{step:08d}/`` that the reference reads too).

Split LMs (``ArchConfig``): ``build`` draws the LM's params on the
session's device.  ``fit`` trains an LM, dense (llama3.2-3b) or hybrid
(zamba2-2.7b's Mamba2 blocks), on sequence-slice owners
(``sequence_parties``): each owner's head runs on its slice of every
document, the cuts are (B, S_p, k) and the scientist's trunk holds the
next-token labels; the per-segment rules are clip + Adam
(``SplitLMAdapter``), every ``fit`` option above applies except
``aggregation="masked_sum"`` and NoPeek (the reference's
``ValueError`` s), and each owner's scalar aux loss rides with its cut
frames.  Split training equals the joint run within a tolerance (the
clip scope: one global norm jointly, one owner's slice split).
``serve(**engine_kw)`` wraps the params in a
``launch.engine.ServingEngine`` (wave or continuous scheduling, the
direct / queue / process transports, latency, cut codecs, the cut
cache), and ``serve_dataset`` serves the session's own aligned contexts
(``sequence_parties(..., with_labels=False)``, or a trained session's).
"""
from __future__ import annotations

import queue as _queue
import sys
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint import restore_split, save_split
from repro_torch.core import masking, privacy
from repro_torch.core.modexp import ModexpPool
from repro_torch.core.psi import (DEFAULT_CHUNK, DEFAULT_MODE, blind_tag,
                                  psi_round)
from repro_torch.core.splitnn import cut_layer_traffic, make_split_train_step
from repro_torch.device import resolve_device
from repro_torch.federation import batching, faults, transport
from repro_torch.federation.cut_codec import get_codec, to_tensor
from repro_torch.federation.parties import (SNAPSHOTS_KEPT, DataOwner,
                                            DataScientist,
                                            OwnerComputeEndpoint,
                                            PrivacyError, device_rows)
from repro_torch.federation.registry import build_adapter
from repro_torch.federation.supervisor import OwnerFailure, Supervisor
from repro_torch.tree import tree_add, tree_leaves, tree_map, tree_unflatten


def _cut_aux(out):
    """A head forward's output as ``(cut, aux or None)``."""
    return out if isinstance(out, tuple) else (out, None)


def _with_owner_aux(metrics, owner_aux: float):
    """The step's metrics with the owners' aux added to the trunk's (the
    joint path's heads + trunk aux)."""
    if owner_aux and "aux" in metrics:
        return {**metrics, "aux": metrics["aux"] + owner_aux}
    return metrics


def _scalars(m):
    return {k: v if k in ("epoch", "step") else float(v)
            for k, v in m.items()}


#: leaked-actor accounting: party threads that outlived their join
#: deadline (process-wide; a wedged actor sleeping through its stop is
#: the common producer)
leak_stats = {"leaked_threads": 0}


def _join_or_warn(th: threading.Thread, limit: float, context: str) -> bool:
    """``th.join(limit)`` that surfaces a party thread still alive after
    its deadline (a wedged actor, a stuck receive) as a loud
    ``RuntimeWarning`` and a ``leak_stats`` bump instead of letting it
    outlive the session silently.  Returns whether the thread ended."""
    th.join(timeout=limit)
    if th.is_alive():
        leak_stats["leaked_threads"] += 1
        warnings.warn(
            f"{context}: thread {th.name!r} still alive after "
            f"{limit:.1f}s join — leaked (wedged actor?)",
            RuntimeWarning, stacklevel=3)
        return False
    return True


class VerticalSession:
    """Orchestrates one scientist + N owners through resolve / build /
    fit / evaluate.  The session is the trusted simulation runtime;
    party objects keep their raw data private."""

    def __init__(self, scientist: DataScientist,
                 owners: Union[Sequence[DataOwner], Dict[str, DataOwner]],
                 *, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.scientist = scientist
        self.owners: List[DataOwner] = (list(owners.values())
                                        if isinstance(owners, dict)
                                        else list(owners))
        if len({o.name for o in self.owners}) != len(self.owners):
            raise ValueError("owner names must be unique")
        if not self.owners:
            raise ValueError("need at least one data owner")
        self.seed = seed
        self.transcript: List[dict] = []
        self.resolve_stats: Optional[dict] = None
        self.transport_stats: Optional[dict] = None
        #: one record per supervised recovery: ``party``, ``action``
        #: ("respawn" | "rollback"), ``step`` (the marker replayed from),
        #: ``error`` and ``seconds`` (the recovery's wall time, respawn
        #: and its warmup included); and per PSI round retry: ``party``,
        #: ``action`` "psi_retry", ``attempt`` and ``error``
        self.recovery_events: List[dict] = []
        self.adapter = None
        self.config = None
        self._init_seed = seed
        self.params = None
        self.history: Optional[dict] = None
        self._resolved = False
        self._train_idx = np.arange(0)
        self._eval_idx = np.arange(0)

    # ------------------------------------------------------------- plumbing

    def _log(self, frm: str, to: str, kind: str, **payload):
        self.transcript.append({"from": frm, "to": to, "kind": kind,
                                **payload})

    def _owner_arrays(self) -> List[np.ndarray]:
        """Owner-side accessor: aligned per-owner feature matrices (the
        simulation of owner-local head computation in the joint path)."""
        return [o._features for o in self.owners]

    def _require(self, *, resolved=False, built=False, labels=False):
        if resolved and not self._resolved:
            raise RuntimeError("call session.resolve() before training — "
                               "parties are not ID-aligned yet")
        if built and self.adapter is None:
            raise RuntimeError("call session.build(config) first")
        if labels and not self.scientist.has_labels:
            raise PrivacyError("the scientist holds no labels; this "
                               "session supports inference only")

    # ------------------------------------------------------------ 1. resolve

    def resolve(self, *, group: str = "modp2048",
                fp_rate: float = 1e-9, mode: str = DEFAULT_MODE,
                parallelism: int = 0,
                chunk_size: int = DEFAULT_CHUNK,
                backend: str = "direct", latency_s: float = 0.0,
                bandwidth_bps: Optional[float] = None,
                timeout: float = 120.0, retries: int = 0,
                retry_backoff_s: float = 0.05) -> dict:
        """The paper's §3.1 protocol: the scientist runs DH-PSI pairwise
        with each owner (scientist = client, so only the scientist learns
        each intersection), intersects globally, broadcasts the shared
        IDs, and every party filters and sorts.  Returns the stats dict.

        ``mode``: ``"noinv"`` (default) and ``"bloom"`` reveal each
        pairwise intersection to the scientist; ``"hidden"`` matches on
        the owner's side and replies with a padded keep set (members and
        deterministic decoys, alike in every frame), and every party
        aligns on positional pseudonyms ``anon000000``, ..., so the
        scientist never learns which raw IDs matched.  A repeat resolve
        after ±Δ churn (``scientist.update_rows`` /
        ``owner.update_rows``) costs O(Δ) modexp and, on a wire backend,
        one ``psi_delta_chunk``; unchanged response legs are skipped by
        content tag.

        The scientist blinds its set once and reuses the upload for
        every owner round (logged as ``psi_blind_reuse``); the delta and
        cached-leg fast paths are logged as ``psi_delta_reuse``.
        ``parallelism`` starts that many modexp workers shared by all
        rounds (0: the serial engine; ``stats["parallelism"]`` is the
        parallelism the pool really has); ``chunk_size`` bounds the
        streamed chunks.  ``fp_rate`` sizes the bloom.

        ``backend``: ``"direct"`` (party objects exchange chunks by
        direct call, byte counts are protocol-data tallies), ``"queue"``
        (each owner's ``PSIServerEndpoint`` on its own thread behind a
        serialized channel, every leg a measured frame) or ``"process"``
        (the same actor in a spawned worker, over an OS pipe).
        ``latency_s`` / ``bandwidth_bps`` delay every frame (wire
        backends only); ``timeout`` bounds each receive, so a wedged
        owner fails the resolve.  The intersection is bit-identical
        across backends, chunk sizes and parallelism.

        ``retries`` reruns a failed owner round (crashed or wedged PSI
        actor) up to that many extra times, ``retry_backoff_s * 2^k``
        apart, with the actor restarted at generation ``attempt`` (a
        generation-0 fault does not fire again); each retry lands in the
        transcript (``psi_round_retry``) and in ``recovery_events``
        (``psi_retry``)."""
        if backend not in ("direct", "queue", "process"):
            raise ValueError(f"unknown resolve backend {backend!r}")
        if backend == "direct" and (latency_s or bandwidth_bps):
            raise ValueError("latency_s/bandwidth_bps model the wire — "
                             "they require a wire backend "
                             "('queue' or 'process')")
        stats: dict = {"rounds": [], "global_intersection": 0,
                       "mode": mode, "parallelism": parallelism,
                       "chunk_size": chunk_size, "backend": backend}
        if backend != "direct":
            stats["latency_s"] = latency_s
            stats["per_party_wire"] = {}
        hidden = mode == "hidden"
        global_pos: Optional[set] = None        # hidden: keep positions
        row_maps: Dict[str, dict] = {}          # hidden: pos -> owner row
        with ModexpPool(parallelism) as pool:
            # a cached client syncs to the scientist's population here:
            # the O(Δ) splice after churn arms the wire's delta round
            client = self.scientist.psi_client(group, mode, pool=pool)
            global_ids = set(client.items)
            for owner in self.owners:
                for attempt in range(max(0, retries) + 1):
                    try:
                        if backend != "direct":
                            inter, rstats = self._resolve_owner_wire(
                                client, owner, backend=backend,
                                group=group, fp_rate=fp_rate, pool=pool,
                                chunk_size=chunk_size,
                                latency_s=latency_s,
                                bandwidth_bps=bandwidth_bps,
                                timeout=timeout, stats=stats,
                                generation=attempt)
                        else:
                            inter, rstats = self._resolve_owner_direct(
                                client, owner, group=group,
                                fp_rate=fp_rate, pool=pool,
                                chunk_size=chunk_size)
                        break
                    except RuntimeError as e:
                        # the client's upload is memoized: the rerun
                        # ships only what the owner never cached
                        if attempt >= retries:
                            raise
                        self._log("scientist", owner.name,
                                  "psi_round_retry", attempt=attempt + 1,
                                  error=str(e))
                        self.recovery_events.append(
                            {"party": owner.name, "action": "psi_retry",
                             "attempt": attempt + 1, "error": str(e)})
                        time.sleep(retry_backoff_s * (2 ** attempt))
                # the engine's parallelism (0 where the pool degraded to
                # serial), never merely the one asked for
                stats["parallelism"] = rstats["parallelism"]
                if rstats["blind_cached"] or rstats.get("upload_skipped"):
                    self._log("scientist", owner.name, "psi_blind_reuse",
                              reused_upload_bytes=
                              rstats["client_upload_bytes"],
                              recompute_skipped=rstats["blind_cached"],
                              upload_skipped=bool(
                                  rstats.get("upload_skipped", False)))
                if rstats.get("delta_used") or rstats.get("resp_skipped") \
                        or rstats.get("server_leg_skipped"):
                    self._log("scientist", owner.name, "psi_delta_reuse",
                              delta_used=bool(rstats.get("delta_used")),
                              resp_skipped=bool(
                                  rstats.get("resp_skipped")),
                              server_leg_skipped=bool(
                                  rstats.get("server_leg_skipped")))
                if hidden:
                    row_maps[owner.name] = dict(
                        zip(inter, rstats["hidden_rows"]))
                    pos = set(inter)
                    global_pos = (pos if global_pos is None
                                  else global_pos & pos)
                else:
                    global_ids &= set(inter)
                stats["rounds"].append({
                    "owner": owner.name, "intersection_size": len(inter),
                    "client_upload_bytes": rstats["client_upload_bytes"],
                    "server_response_bytes":
                        rstats["server_response_bytes"],
                    "n_chunks": rstats["n_chunks"],
                    "blind_cached": rstats["blind_cached"],
                    **({"bloom_bytes": rstats["bloom_bytes"],
                        "bloom_shards": rstats["bloom_shards"]}
                       if mode == "bloom" else
                       {"server_set_bytes": rstats["server_set_bytes"]}),
                    **({k: rstats[k] for k in
                        ("delta_used", "resp_skipped",
                         "server_leg_skipped", "client_modexp_ops",
                         "server_modexp_ops", "hidden_kept")
                        if k in rstats}),
                    **({"upload_skipped": rstats["upload_skipped"],
                        "upload_wire_bytes": rstats["upload_wire_bytes"],
                        "download_wire_bytes":
                            rstats["download_wire_bytes"]}
                       if backend != "direct" else {})})
        if hidden:
            final = sorted(global_pos or set())
            stats["global_intersection"] = len(final)
            # every party keeps the same aligned order; the scientist maps
            # keep positions back to its rows through the client's item
            # order, never learning which positions were members
            items = list(client.items)
            for owner in self.owners:
                owner._align_hidden(
                    [row_maps[owner.name][p] for p in final])
                self._log("scientist", owner.name, "resolved_ids",
                          count=len(final))
            self.scientist._align_hidden(final, items)
        else:
            stats["global_intersection"] = len(global_ids)
            self.scientist._align(global_ids)
            for owner in self.owners:
                owner._align(global_ids)
                self._log("scientist", owner.name, "resolved_ids",
                          count=len(global_ids))
        for owner in self.owners:
            if owner.ids != self.scientist.ids:
                raise RuntimeError(f"misaligned owner {owner.name}")
        # every owner round succeeded: the next churn diffs against the
        # state all peers now hold
        client.rebase_delta()
        self._resolved = True
        self.resolve_stats = stats
        return stats

    def _resolve_owner_direct(self, client, owner, *, group, fp_rate,
                              pool, chunk_size):
        """One in-process PSI round, with one transcript entry per wire
        kind (the engine's message callback tallies them)."""
        wire: Dict[str, List[int]] = {}

        def tally(kind, n_bytes):
            c = wire.setdefault(kind, [0, 0])
            c[0] += 1
            c[1] += n_bytes

        inter, rstats = psi_round(client, owner.psi_server(group, fp_rate),
                                  pool=pool, chunk_size=chunk_size,
                                  on_message=tally)
        for kind, (n_msgs, n_bytes) in wire.items():
            frm, to = (("scientist", owner.name)
                       if kind in ("psi_blind_chunk", "psi_delta_chunk",
                                   "psi_lift_chunk")
                       else (owner.name, "scientist"))
            self._log(frm, to, kind, bytes=n_bytes, chunks=n_msgs)
        return inter, rstats

    def _mirror_owner_psi_caches(self, owner, client, group, fp_rate):
        """Copy a finished process-backend round's content-addressed PSI
        artifacts onto the owner: the spawned worker's caches died with
        it, and a long-lived owner process would have kept them.  Every
        entry is keyed by its own content tag, so none can go stale.
        The hidden response leg (D) never reaches the client, so a
        hidden delta on the process backend degrades to a full upload."""
        key = (group, fp_rate)
        blob = client._blinded_packed
        if blob is not None:
            owner._psi_blind_caches.setdefault(key, {})[blind_tag(blob)] = \
                blob
        rc = client.round_cache.get(owner.name)
        if not rc:
            return
        if "d_blob" in rc:
            owner._psi_resp_caches.setdefault(key, {})[rc["tag"]] = \
                rc["d_blob"]
        if client.mode == "hidden" and rc.get("t_blob"):
            owner._psi_lift_caches.setdefault(key, {})[rc["server_tag"]] = \
                rc["t_blob"]

    def _resolve_owner_wire(self, client, owner, *, backend, group,
                            fp_rate, pool, chunk_size, latency_s,
                            bandwidth_bps, timeout, stats,
                            generation=0):
        """One wire-native PSI round: the owner's actor on its own thread
        (queue) or in a spawned worker (process), every leg a measured
        frame.  The transcript gets one entry per kind and direction with
        the measured payload and wire bytes, and
        ``stats["per_party_wire"]`` the owner's channel totals (of the
        verified attempt only)."""
        from repro_torch.federation.psi_transport import wire_psi_round

        if backend == "process":
            from repro_torch.federation import runtime
            # the own set is blinded on the owner's persistent server in
            # the parent at spawn: its ops count as the round's server ops
            srv_parent = owner.psi_server(group, fp_rate)
            spawn_ops0 = srv_parent.ops
            handle = runtime.spawn_psi_worker(
                owner, group=group, fp_rate=fp_rate,
                latency_s=latency_s, bandwidth_bps=bandwidth_bps,
                generation=generation, pool=pool, chunk_size=chunk_size)
            try:
                ep_sci = handle.endpoint
                inter, rstats = wire_psi_round(
                    client, ep_sci, worker=handle, pool=pool,
                    chunk_size=chunk_size, timeout=timeout,
                    peer=owner.name)
            finally:
                try:
                    handle.endpoint.send("psi_stop", {})
                except RuntimeError:        # the worker is gone
                    pass
                handle.shutdown()
            for k in ("server_modexp_ops", "modexp_ops"):
                rstats[k] = rstats.get(k, 0) + srv_parent.ops - spawn_ops0
            self._mirror_owner_psi_caches(owner, client, group, fp_rate)
        else:
            ep_sci, ep_own = transport.channel_pair(
                "scientist", owner.name, backend="queue",
                latency_s=latency_s, bandwidth_bps=bandwidth_bps)
            worker = owner.psi_endpoint(ep_own, group, fp_rate, pool=pool)
            # the spawned workers' chaos surface, on the thread actor
            faults.arm_actor(worker, owner.name, generation=generation)
            faults.arm_endpoint(ep_own, owner.name, generation=generation)
            th = threading.Thread(target=worker.run, daemon=True,
                                  name=f"psi-{owner.name}")
            th.start()
            try:
                inter, rstats = wire_psi_round(
                    client, ep_sci, worker=worker, pool=pool,
                    chunk_size=chunk_size, timeout=timeout,
                    peer=owner.name)
            finally:
                ep_sci.send("psi_stop", {})
                _join_or_warn(th, 10.0, f"resolve({owner.name})")

        sent, rcvd = ep_sci.sent_stats, ep_sci.recv_stats
        for kind, st in sorted(sent["by_kind"].items()):
            if kind == "psi_stop":
                continue
            self._log("scientist", owner.name, kind, measured=True,
                      bytes=st["payload_bytes"],
                      wire_bytes=st["wire_bytes"], chunks=st["count"])
        for kind, st in sorted(rcvd["by_kind"].items()):
            self._log(owner.name, "scientist", kind, measured=True,
                      bytes=st["payload_bytes"],
                      wire_bytes=st["wire_bytes"], chunks=st["count"])
        stats["per_party_wire"][owner.name] = {
            "sent_wire_bytes": sent["wire_bytes"],
            "recv_wire_bytes": rcvd["wire_bytes"],
            "messages": sent["messages"] + rcvd["messages"],
        }
        # the blind upload alone (0 when the owner had it cached)
        rstats["upload_wire_bytes"] = sent["by_kind"].get(
            "psi_blind_chunk", {"wire_bytes": 0})["wire_bytes"]
        rstats["download_wire_bytes"] = rcvd["wire_bytes"]
        return inter, rstats

    # -------------------------------------------------------------- 2. build

    def build(self, config, *, seed: Optional[int] = None,
              params=None) -> "VerticalSession":
        """Instantiate the split model for ``config`` and its params on
        the session's device: from ``params`` when given (a tree in the
        reference's layout, e.g. ``repro_torch.weights.from_reference``
        of the JAX params), else drawn from a ``torch.Generator`` seeded
        with ``seed`` (default: the session seed)."""
        self.adapter = build_adapter(config)
        self.config = config
        # the init seed also keys the wire defences' noise and, unless the
        # environment sets one, the mask root
        self._init_seed = self.seed if seed is None else seed
        if params is None:
            # the MLP's draws come from a CPU generator on every device;
            # an LM's billions of params are drawn where they will live
            on_device = getattr(self.adapter, "init_on_device", False)
            params = self.adapter.init(torch.Generator(
                device=self.device if on_device else "cpu").manual_seed(
                    self._init_seed))
            self.params = tree_map(lambda t: t.to(self.device), params)
        else:
            self.params = tree_map(
                lambda t: torch.as_tensor(t, dtype=torch.float32).to(
                    self.device).clone(), params)
        return self

    # ---------------------------------------------------------------- 3. fit

    def fit(self, *, epochs: Optional[int] = None,
            steps: Optional[int] = None, batch_size: int = 128,
            eval_frac: float = 0.0, owner_lr: Optional[float] = None,
            scientist_lr: Optional[float] = None,
            log_every: Optional[int] = None, ckpt_dir: Optional[str] = None,
            ckpt_every: int = 0, shuffle_seed: Optional[int] = None,
            verbose: bool = True, mode: str = "joint",
            schedule: str = "pipelined", microbatches: int = 1,
            compression: Optional[str] = None, backend: str = "queue",
            latency_s: float = 0.0, bandwidth_bps: Optional[float] = None,
            timeout: float = 120.0, supervise: bool = False,
            max_restarts: int = 2, resync_every: int = 1,
            heartbeat_s: float = 0.5,
            aggregation: Optional[str] = None) -> dict:
        """The SplitNN training loop over exactly one of ``epochs``
        epochs of full batches or ``steps`` steps (a fresh permutation
        whenever the rest cannot fill a batch).  ``eval_frac`` holds out
        the last fraction of aligned rows; eval metrics land in
        ``history["eval"]`` (per epoch, or once after ``steps``), and the
        per-step loss in ``history["loss_trail"]``.  ``steps=0`` runs
        only the split warmup handshake.

        ``verbose`` prints every ``log_every`` epochs (default 1) and the
        last; in steps mode it prints every ``log_every`` steps and the
        last, and nothing when ``log_every`` is unset.  ``ckpt_dir`` with
        ``ckpt_every`` writes per-party checkpoints (:meth:`checkpoint`)
        every ``ckpt_every`` epochs, or steps in steps mode; a checkpoint
        is taken outside the step time and changes nothing in the run.

        ``mode="joint"`` runs the single autograd step (with
        ``microbatches=M > 1``: the microbatched joint oracle).
        ``mode="split"`` runs true split execution: ``schedule``
        ("pipelined" ships the step-t+1 forward request before step t's
        gradients, so owner work overlaps the scientist's, and with
        ``microbatches=M`` every batch is cut into M GPipe chunks;
        "sequential" is the synchronous baseline, whole batches only),
        ``compression`` (None | "fp16" | "int8" cut codec), ``backend``
        ("queue" = serialized simulated network, "direct" = in-process
        handoff, "process" = each owner in a spawned worker process over
        an OS pipe), ``latency_s`` / ``bandwidth_bps`` (every frame in
        both directions arrives ``latency_s + wire_bytes /
        bandwidth_bps`` after its send; wire backends only), ``timeout``
        (seconds a receive from an owner may wait; warmup receives wait
        at least 120 s, for worker start-up).
        ``aggregation`` (None | "masked_sum"): secure forward aggregation,
        see the module docstring.  Both modes draw batches from one index
        stream, so they see the same batches in the same order.

        ``supervise=True`` (split mode, queue or process backend) turns
        on crash recovery: a ``snapshot`` marker every ``resync_every``
        steps (each owner acks its step-start leaves), heartbeats every
        ``heartbeat_s`` seconds, and on an owner's failure (crash, error
        frame, 8 heartbeats missed in a row, a receive past ``timeout``)
        or a corrupt frame a rollback
        of every party to the newest consistent marker, a respawn of a
        dead owner from its snapshot (bounded backoff, at most
        ``max_restarts`` per owner, then "restart budget exhausted"), and
        a replay of the steps since.  The final params and loss trail
        equal the fault-free run's bit for bit.  Any other error
        propagates as it would unsupervised."""
        self._require(resolved=True, built=True)
        self._require(labels=True)
        if (epochs is None) == (steps is None):
            raise ValueError("pass exactly one of epochs= or steps=")
        if mode not in ("joint", "split"):
            raise ValueError(f"mode must be 'joint' or 'split': {mode!r}")
        if aggregation not in (None, "masked_sum"):
            raise ValueError(f"unknown aggregation {aggregation!r} "
                             "(None | 'masked_sum')")
        if aggregation == "masked_sum":
            if not getattr(self.adapter, "supports_masked", False):
                raise ValueError(
                    f"{type(self.adapter).__name__} does not support "
                    "masked_sum aggregation (needs combine='sum')")
            if len(self.owners) < 2:
                raise ValueError(
                    "masked_sum needs >= 2 owners: a single owner's "
                    "masked payload would expose its activations")
        M = int(microbatches)
        if M < 1:
            raise ValueError(f"microbatches must be >= 1: {M}")
        if M > 1:
            if batch_size % M:
                raise ValueError(f"microbatches={M} must divide "
                                 f"batch_size={batch_size}")
            if not getattr(self.adapter, "supports_microbatch", False):
                raise ValueError(f"{type(self.adapter).__name__} does not "
                                 "support microbatched training")
        if supervise:
            if mode != "split":
                raise ValueError("supervise=True requires mode='split' "
                                 "(recovery is a wire protocol)")
            if backend == "direct":
                raise ValueError("supervise=True requires a wire "
                                 "backend ('queue' or 'process')")
            if int(resync_every) < 1:
                raise ValueError(
                    f"resync_every must be >= 1: {resync_every}")
        if backend == "direct" and (latency_s or bandwidth_bps):
            raise ValueError("latency_s/bandwidth_bps model the wire — "
                             "they require a wire backend "
                             "('queue' or 'process')")
        n = len(self.scientist.ids)
        n_train = n - int(n * eval_frac)
        if n_train < batch_size:
            raise ValueError(f"{n_train} train rows < batch {batch_size}")
        self._train_idx = np.arange(n_train)
        self._eval_idx = np.arange(n_train, n)
        rng = np.random.default_rng(self.seed if shuffle_seed is None
                                    else shuffle_seed)
        if epochs is not None:
            steps_per_epoch = (n_train - batch_size) // batch_size + 1
            total_steps = epochs * steps_per_epoch
        else:
            steps_per_epoch, total_steps = None, int(steps)
        # the per-fit bookkeeping (``_after_step``): printing, checkpoints,
        # and the seconds each checkpoint took
        book = dict(steps_per_epoch=steps_per_epoch, epochs=epochs,
                    total_steps=total_steps, verbose=verbose,
                    log_every=log_every, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every, ckpt_s=[])
        loop = dict(stream=self._index_stream(rng, n_train, batch_size,
                                              epochs, steps),
                    total_steps=total_steps, batch_size=batch_size,
                    owner_lr=owner_lr, scientist_lr=scientist_lr, book=book)
        if mode == "split":
            return self._fit_split(
                **loop, schedule=schedule, microbatches=M,
                compression=compression, backend=backend,
                latency_s=latency_s, bandwidth_bps=bandwidth_bps,
                timeout=timeout,
                aggregation=aggregation, supervise=supervise,
                max_restarts=max_restarts, resync_every=int(resync_every),
                heartbeat_s=heartbeat_s)
        if M > 1 or aggregation is not None:
            return self._fit_joint_microbatched(
                **loop, microbatches=M, aggregation=aggregation)
        return self._fit_joint(**loop)

    def _index_stream(self, rng, n_train, batch_size, epochs, steps):
        """The batch-index stream — one generator shared by the joint
        and split loops.  Epochs: a fresh permutation per epoch, full
        batches; steps: a fresh permutation whenever the rest of the
        current one cannot fill a batch."""
        if epochs is not None:
            for _ in range(epochs):
                order = rng.permutation(self._train_idx)
                for s in range(0, n_train - batch_size + 1, batch_size):
                    yield order[s:s + batch_size]
            return
        order = rng.permutation(self._train_idx)
        cursor = 0
        for _ in range(steps):
            if cursor + batch_size > n_train:
                order = rng.permutation(self._train_idx)
                cursor = 0
            yield order[cursor:cursor + batch_size]
            cursor += batch_size

    def _labels(self, idx) -> torch.Tensor:
        return torch.from_numpy(self.scientist.labels[idx].astype(
            np.int64)).to(self.device)

    def _after_step(self, t, metrics, history, t0, book, sync):
        """Step ``t``'s bookkeeping, shared by every loop (the
        reference's).  Epochs: at each epoch's end its record, eval,
        print and checkpoint.  Steps: the step's record, whose tensors
        ``_finish`` reads, so a step takes no host sync unless
        ``log_every`` prints it; a checkpoint every ``ckpt_every``
        steps.  ``sync`` makes ``self.params`` current before an eval or
        a checkpoint reads them."""
        spe = book["steps_per_epoch"]
        if spe is None:
            history["train"].append({"step": t, **metrics})
            every = book["log_every"]
            if book["verbose"] and every and (
                    t % every == 0 or t == book["total_steps"] - 1):
                print(f"step {t:5d} " + " ".join(
                    f"{k}={v:.4f}" for k, v in
                    sorted(_scalars(metrics).items()))
                    + f" ({time.time() - t0:.1f}s)")
            done = t + 1
        elif (t + 1) % spe == 0:
            done = (t + 1) // spe
            self._end_epoch(done - 1, metrics, history, t0, book, sync)
        else:
            return
        every = book["ckpt_every"]
        if book["ckpt_dir"] and every and done % every == 0:
            tc = time.time()
            sync()
            self.checkpoint(book["ckpt_dir"], done)
            book["ckpt_s"].append(time.time() - tc)

    def _end_epoch(self, ep, metrics, history, t0, book, sync):
        """Per-epoch history, eval and print (every ``log_every`` epochs
        and the last).  ``sync`` makes ``self.params`` current before
        eval reads them."""
        rec = {"epoch": ep, **_scalars(metrics)}
        history["train"].append(rec)
        if len(self._eval_idx):
            sync()
            history["eval"].append({"epoch": ep, **self.evaluate()})
        if book["verbose"] and (ep % (book["log_every"] or 1) == 0
                                or ep == book["epochs"] - 1):
            ev = history["eval"][-1] if history["eval"] else {}
            extra = "".join(f" val_{k}={v:.4f}"
                            for k, v in ev.items() if k != "epoch")
            print(f"epoch {ep:3d} " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(rec.items())
                if k != "epoch")
                + extra + f" ({time.time() - t0:.1f}s)")

    def _finish(self, history, losses, book):
        """The run's history; ``self.params`` must be current.  A steps
        run gets its records' scalars and one eval here."""
        history["loss_trail"] = torch.stack(losses).tolist() if losses \
            else []
        if book["steps_per_epoch"] is None:
            history["train"] = [_scalars(r) for r in history["train"]]
            if len(self._eval_idx):
                history["eval"].append({"step": len(losses),
                                        **self.evaluate()})
        final = dict(history["train"][-1]) if history["train"] else {}
        if history["eval"]:
            final.update({f"val_{k}": v
                          for k, v in history["eval"][-1].items()
                          if k not in ("epoch", "step")})
        history["final"] = final
        self.history = history
        return history

    # ------------------------------------------------------- 3a. joint

    def _fit_joint(self, stream, *, total_steps, batch_size, owner_lr,
                   scientist_lr, book) -> dict:
        adapter = self.adapter
        opt = adapter.default_optimizer(owner_lr, scientist_lr)
        state = opt.init(self.params)
        step_fn = make_split_train_step(adapter.loss_fn, opt)
        for owner in self.owners:
            shape = adapter.cut_shape(batch_size, owner.feature_shape)
            self._log(owner.name, "scientist", "cut_activations",
                      shape=shape, width=shape[-1], per_step=True)
            self._log("scientist", owner.name, "cut_gradients",
                      shape=shape, per_step=True)
        owner_arrays = self._owner_arrays()
        labels = self.scientist.labels
        history: dict = {"train": [], "eval": []}
        losses: list = []
        t0 = time.time()
        for t in range(total_steps):
            batch = adapter.make_batch(owner_arrays, labels, next(stream),
                                       device=self.device)
            self.params, state, metrics = step_fn(self.params, state,
                                                  batch, t)
            losses.append(metrics["loss"])
            self._after_step(t, metrics, history, t0, book, lambda: None)
        return self._finish(history, losses, book)

    # ------------------------------------- 3a'. microbatched joint oracle

    def _fit_joint_microbatched(self, stream, *, total_steps, batch_size,
                                owner_lr, scientist_lr, book, microbatches,
                                aggregation=None) -> dict:
        """The GPipe oracle of ``fit(mode="split", microbatches=M)``: the
        same cached per-segment programs in the same order.  Per chunk,
        the owners' head forwards, the trunk's cut gradient and the
        owners' head backwards, summed in chunk order at step-start
        params; then one update per owner, the trunk's weight gradient
        per chunk, summed in chunk order, and one trunk update.  Each
        chunk's loss is ``sum / batch``, so the chunks add up to the
        batch step.  The split run reproduces it bit for bit.

        With ``aggregation="masked_sum"`` this is the masked joint
        oracle: each owner's cut is quantized, the ints are ring-summed
        on the host (``masking.fold_quantized``, bitwise the wire's fold
        once the masks cancel), the trunk programs take its dequantized
        value as one owner plane, and every owner's head backward takes
        the one ``dL/dz``."""
        adapter = self.adapter
        M = microbatches
        bm = batch_size // M
        P = len(self.owners)
        head_progs = [adapter.owner_programs(p) for p in range(P)]
        owner_opt, owner_update = adapter.owner_update_rule(owner_lr)
        slices = [adapter.owner_param_slice(self.params, p)
                  for p in range(P)]
        ostates = [owner_opt.init(s) for s in slices]
        trunk_opt, trunk_update = adapter.trunk_update_rule(scientist_lr)
        masked = aggregation == "masked_sum"
        cutgrad, weightgrad = adapter.trunk_microbatch_programs()
        tp = self.params["trunk"]
        ts = trunk_opt.init(tp)
        denom, inv_micro = float(batch_size), 1.0 / M
        # each owner's rows staged on the device, as its worker stages them
        feats = [device_rows(f, self.device) for f in self._owner_arrays()]

        def reassemble():
            self.params = {"heads": adapter.stack_head_params(slices),
                           "trunk": tp}

        history: dict = {"train": [], "eval": []}
        losses: list = []
        t0 = time.time()
        for t in range(total_steps):
            idx = next(stream)
            rows = torch.from_numpy(np.asarray(idx, np.int64)).to(
                self.device)
            xs = [f[rows] for f in feats]
            lab = self._labels(idx)
            hg: list = [None] * P
            metrics, cache, owner_aux = None, [], 0.0
            for m in range(M):
                sl = slice(m * bm, (m + 1) * bm)
                chunks = [x[sl] for x in xs]
                cuts = []
                for p in range(P):
                    cut, aux = _cut_aux(head_progs[p][0](slices[p],
                                                         chunks[p]))
                    cuts.append(cut)
                    if aux is not None:
                        # the f32 round trip the wire's aux takes
                        owner_aux += float(np.float32(aux.sum().item()))
                cuts = tuple(cuts)
                if masked:
                    # no masks: they would cancel in the fold anyway
                    cuts = (self._dequantized(masking.fold_quantized(
                        [masking.quantize(c).cpu().numpy()
                         for c in cuts])),)
                cg, parts = cutgrad(tp, cuts, lab[sl], denom, inv_micro)
                if masked:
                    cg = [cg[0]] * P
                for p in range(P):
                    g = head_progs[p][1](slices[p], chunks[p], cg[p])
                    hg[p] = tree_add(hg[p], g)
                metrics = tree_add(metrics, parts)
                cache.append((cuts, lab[sl]))
            for p in range(P):
                slices[p], ostates[p] = owner_update(
                    slices[p], ostates[p], hg[p], t)
            tg = None
            for cuts, lab_m in cache:
                tg = tree_add(tg, weightgrad(tp, cuts, lab_m, denom,
                                             inv_micro))
            tp, ts = trunk_update(tp, ts, tg, t)
            metrics = _with_owner_aux(metrics, owner_aux)
            losses.append(metrics["loss"])
            self._after_step(t, metrics, history, t0, book, reassemble)
        reassemble()
        return self._finish(history, losses, book)

    def _dequantized(self, ints: np.ndarray) -> torch.Tensor:
        """A host int32 ring sum, dequantized on the session's device."""
        return masking.dequantize(torch.from_numpy(ints).to(self.device))

    # ------------------------------------------------- 3b. split execution

    def _recv_from_owner(self, ep, worker, kind, timeout: float,
                         sup: Optional[Supervisor] = None):
        """Receive ``kind`` from one owner, surfacing a dead owner within
        a second instead of after the full timeout.  A worker process
        can also fail through the receive itself (its error frame, or a
        closed pipe): that too is raised as the owner's failure.  With a
        supervisor ``sup``, an owner it has condemned (no heartbeat ack
        for ``miss_limit`` periods: a wedge) fails the receive too, long
        before ``timeout``.  Every failure is an :class:`OwnerFailure`
        naming the owner, so the supervised fit knows whom to restart; a
        corrupt frame (``transport.FrameCorrupt``) passes through as it
        is: its owner is alive and is rolled back, not restarted."""
        name = worker.owner.name
        deadline = time.monotonic() + timeout
        while True:
            try:
                return ep.recv_kind(kind, timeout=1.0)
            except _queue.Empty:
                if worker.error is not None:
                    raise OwnerFailure(f"owner worker {name!r} failed",
                                       party=name) from worker.error
                why = sup.failed.get(name) if sup is not None else None
                if why is not None:
                    raise OwnerFailure(str(why), party=name) from why
                if time.monotonic() > deadline:
                    raise OwnerFailure(
                        f"timed out waiting for {kind!r} from {name!r}",
                        party=name) from None
            except transport.FrameCorrupt:
                raise
            except RuntimeError as e:
                raise OwnerFailure(f"owner worker {name!r} failed",
                                   party=name) from (worker.error or e)

    def _sync_split_params(self, workers, eps, trunk_params, timeout,
                           sup=None):
        """Flush every owner's queue (barrier), then reassemble the
        session's param tree from the owners' live head segments: a
        thread worker's params directly, a worker process's through a
        ``pull_params`` request answered with numpy leaves."""
        for ep in eps:
            ep.send("barrier", {}, seq=-1)
        slices = []
        for p, (ep, w) in enumerate(zip(eps, workers)):
            self._recv_from_owner(ep, w, "barrier_ack", timeout, sup)
            if isinstance(w, OwnerComputeEndpoint):
                slices.append(w.params)
                continue
            ep.send("pull_params", {}, seq=-1)
            m = self._recv_from_owner(ep, w, "params_dump", timeout, sup)
            slices.append(tree_unflatten(
                self.adapter.owner_param_slice(self.params, p),
                [to_tensor(m.payload[str(i)], self.device)
                 for i in range(len(m.payload))]))
        self.params = {"heads": self.adapter.stack_head_params(slices),
                       "trunk": trunk_params}

    def _start_owners(self, workers, eps, threads, backend, **kw):
        """One owner worker per owner (:meth:`_start_owner`), appended to
        ``workers`` (with its scientist endpoint to ``eps``, and a thread
        to ``threads``) as it starts, so that a failure half way leaves
        every started one to the caller's clean-up."""
        if backend == "process" and self.device.type == "cuda":
            # build before spawning: the workers (respawns too) load what
            # is built — the codec's kernel and the owners' programs'
            from repro_torch.kernels import build
            names = (["quantize"] if kw["compression"] == "int8" else [])
            names += self.adapter.owner_kernel_sources()
            if names:
                build.build(names)
        for p in range(len(self.owners)):
            w, ep, th = self._start_owner(p, backend, **kw)
            workers.append(w)
            eps.append(ep)
            if th is not None:
                threads.append(th)

    def _start_owner(self, p, backend, *, codec, compression, owner_lr,
                     sequential, microbatches, aggregation, latency_s,
                     bandwidth_bps, leaves=None, opt_leaves=None,
                     start_step=0, generation=0):
        """Start owner ``p``: a thread behind a channel pair (queue,
        direct) or a spawned process behind a pipe, either with the
        wire's ``latency_s`` and ``bandwidth_bps`` in both directions;
        returns ``(worker, scientist endpoint, thread or None)``.  The
        first start takes the owner's slice of the session's params and
        a fresh optimizer state; a respawn gives the snapshot's ``leaves`` and
        ``opt_leaves`` (host numpy), the ``start_step`` to resume at and
        its ``generation``.  Owners are armed from the env fault plan at
        their generation.  Masked owners, threads and processes alike,
        take the mask root from ``REPRO_MASK_SEED`` where it is set, else
        the init seed."""
        adapter = self.adapter
        owner = self.owners[p]
        P = len(self.owners)
        noise = dict(cut_noise_std=self.config.split.cut_noise_std,
                     noise_seed=self._init_seed)
        template = adapter.owner_param_slice(self.params, p)
        if backend == "process":
            from repro_torch.federation import runtime
            if leaves is None:
                leaves = [t.detach().cpu().numpy()
                          for t in tree_leaves(template)]
            spec = runtime.OwnerWorkerSpec(
                name=owner.name, ids=list(owner.ids),
                features=np.asarray(owner._features), owner_index=p,
                config=self.config, device=str(self.device),
                param_leaves=list(leaves), codec=compression,
                microbatches=microbatches, ack_steps=sequential,
                owner_lr=owner_lr,
                num_threads=(torch.get_num_threads()
                             if self.device.type == "cpu" else None),
                aggregation=aggregation, n_owners=P,
                opt_state_leaves=opt_leaves, start_step=start_step,
                generation=generation, latency_s=latency_s,
                bandwidth_bps=bandwidth_bps,
                spin_s=transport.spin_wait_s(), **noise)
            handle = runtime.spawn_owner_worker(spec, owner=owner)
            return handle, handle.endpoint, None
        owner_opt, owner_update = adapter.owner_update_rule(owner_lr)
        hp = template if leaves is None else tree_unflatten(
            template, [to_tensor(a, self.device) for a in leaves])
        opt_state = owner_opt.init(hp)
        if opt_leaves is not None:
            opt_state = tree_unflatten(opt_state, [
                to_tensor(a, self.device) for a in opt_leaves])
        ep_sci, ep_own = transport.channel_pair(
            "scientist", owner.name, backend=backend, latency_s=latency_s,
            bandwidth_bps=bandwidth_bps)
        head_fwd, head_bwd = adapter.owner_programs(p)
        masker = None
        if aggregation == "masked_sum":
            masker = masking.MaskedAggregator(
                masking.mask_root_from_env(self._init_seed), p, P,
                generation=generation)
        w = OwnerComputeEndpoint(
            owner, ep_own, head_fwd, head_bwd, update=owner_update,
            params=hp, opt_state=opt_state, codec=codec,
            device=self.device, ack_steps=sequential,
            microbatches=microbatches, masker=masker,
            start_step=start_step, **noise)
        faults.arm_actor(w, owner.name, generation=generation)
        if backend == "queue":
            faults.arm_endpoint(ep_own, owner.name, generation=generation)
        th = threading.Thread(target=w.run, daemon=True,
                              name=f"owner-{owner.name}")
        th.start()
        return w, ep_sci, th

    def _fit_split(self, stream, *, total_steps, batch_size, owner_lr,
                   scientist_lr, book, schedule, microbatches, compression,
                   backend, latency_s, bandwidth_bps, timeout, aggregation,
                   supervise=False, max_restarts=2, resync_every=1,
                   heartbeat_s=0.5) -> dict:
        """True split execution over the transport (paper Fig. 2).

        Per step t the wire carries ``head_fwd`` (batch row indices),
        ``cut_activations``, ``cut_gradients`` and — in the sequential
        schedule only — ``step_done`` acks.  The pipelined schedule sends
        the step-t+1 forward request before step t's gradients; the
        owners stage it until their step-t update lands (FIFO), so the
        math is the joint step's.  With ``microbatches=M`` each batch
        crosses as M chunks (seq ``t*M + m``): each chunk's cut gradient
        leaves the moment its cuts arrive, and the trunk's weight
        gradients and update run afterwards, while the gradients are on
        the wire.  A warmup round runs every program and both codec
        directions once per chunk before the timed region; with
        ``backend="process"`` it also absorbs the workers' start-up.

        Masked runs fold each chunk's ring payloads into the int32 sum
        (``masking.reconstruct``) and ship the one ``dL/dz`` to every
        owner.  The gradient defences (``grad_norm_mode``,
        ``grad_noise_std``) apply to every cut-gradient chunk, keyed on
        ``g{seq}o{owner}``; the warmup's zero gradients are sent as they
        are.

        ``supervise``: every ``resync_every`` steps a ``snapshot`` marker
        s goes to every owner (each acks its step-s-start leaves) and the
        trunk's step-s state is kept by reference; a
        :class:`~repro_torch.federation.supervisor.Supervisor` sends
        heartbeats beside the step loop, and every receive from an owner
        reads its verdict.  On an :class:`OwnerFailure` (crash, error
        frame, missed heartbeats, timeout) the dead owner is respawned from
        the newest marker it acked, on a ``FrameCorrupt`` every owner
        rolls back to the newest marker; the survivors roll back, the
        trunk and the history return to the marker, and the steps from
        it are replayed from the batch-index log (the stream is read
        once, so a replay sees the same batches).  Batch indices, masks,
        cut noise and gradient defences are all keyed by step or seq, so
        the replay gives the first run's bits."""
        adapter = self.adapter
        if backend not in ("queue", "direct", "process"):
            raise ValueError(f"unknown fit backend {backend!r}")
        if schedule not in ("pipelined", "sequential"):
            raise ValueError(f"unknown schedule {schedule!r}")
        sequential = schedule == "sequential"
        M = microbatches
        if sequential and M > 1:
            raise ValueError("microbatches > 1 requires the pipelined "
                             "schedule (sequential is the synchronous "
                             "baseline)")
        bm = batch_size // M
        codec = get_codec(compression, self.device)
        denom, inv_micro = float(batch_size), 1.0 / M
        masked = aggregation == "masked_sum"

        trunk_opt, trunk_update = adapter.trunk_update_rule(scientist_lr)
        tp = self.params["trunk"]
        ts = trunk_opt.init(tp)
        if sequential:
            trunk_step = adapter.trunk_program()
        else:
            cutgrad, weightgrad = adapter.trunk_microbatch_programs()
        sp = self.config.split
        defend_on = sp.grad_noise_std > 0.0 or sp.grad_norm_mode != "none"

        owner_kw = dict(codec=codec, compression=compression,
                        owner_lr=owner_lr, sequential=sequential,
                        microbatches=M, aggregation=aggregation,
                        latency_s=latency_s, bandwidth_bps=bandwidth_bps)
        workers, eps, threads = [], [], []
        # replaced owners: (owner index, endpoint) for the accounting, and
        # their threads (a wedged one never ends)
        retired, retired_threads = [], []
        inflight: deque = deque()
        # the batch-index log: a replay re-sends step s's exact indices
        # without reading the stream (and its rng) again
        idx_log: list = []

        def recv(ep, w, kind, wait):
            # an owner the supervisor (once started) condemns fails here
            return self._recv_from_owner(ep, w, kind, wait, sup)

        def send_fwd(seq):
            while len(idx_log) <= seq:
                idx_log.append(next(stream))
            idx = idx_log[seq]
            for ep in eps:
                ep.send("head_fwd", {"idx": np.asarray(idx, np.int32)},
                        seq=seq)
            inflight.append(idx)

        def recv_cuts(kind, seq, wait):
            """One chunk from every owner: the decoded cuts, or (masked)
            the dequantized ring sum of their payloads as one owner
            plane, so the scientist never holds an owner's cut; and the
            owners' summed aux scalars (an LM's)."""
            payloads, aux = [], 0.0
            for ep, w in zip(eps, workers):
                m = recv(ep, w, kind, wait)
                if m.seq != seq:
                    raise RuntimeError(f"protocol desync: {kind} seq "
                                       f"{m.seq} != expected {seq}")
                payloads.append(m.payload)
                if "aux" in m.payload:
                    aux += float(np.asarray(m.payload["aux"]).sum())
            if masked:
                return (self._dequantized(masking.reconstruct(payloads)),
                        ), aux
            return tuple(codec.decode(pl) for pl in payloads), aux

        def to_owners(cg):
            """The trunk's cut gradient as one tensor per owner (masked:
            the same ``dL/dz`` for all)."""
            return [cg[0]] * len(eps) if masked else cg

        def defend(g, seq, p):
            if not defend_on:
                return g
            return torch.from_numpy(privacy.obfuscate_cut_gradient(
                g.float().cpu().numpy(), noise_std=sp.grad_noise_std,
                norm_mode=sp.grad_norm_mode, seed=self._init_seed,
                tag=f"g{seq}o{p}")).to(self.device)

        def send_grads(grads, seq):
            for p, (g, ep) in enumerate(zip(grads, eps)):
                ep.send("cut_gradients", codec.encode(defend(g, seq, p)),
                        seq=seq)

        def sync():
            self._sync_split_params(workers, eps, tp, timeout, sup)

        # ---------------- supervision: markers, snapshots, recovery
        sup = None
        trunk_snaps: dict = {}         # marker -> (trunk params, state)
        hist_marks: dict = {}          # marker -> history lengths
        snap_acks: Dict[int, dict] = {p: {} for p in range(len(self.owners))}
        marker = {"last": None, "pending": False}

        def collect_acks(s):
            for p, (ep, w) in enumerate(zip(eps, workers)):
                m = recv(ep, w, "snapshot_ack", timeout)
                if int(m.seq) != s:
                    name = self.owners[p].name
                    raise OwnerFailure(
                        f"snapshot ack desync from {name!r}: seq {m.seq} "
                        f"!= {s}", party=name)
                snap_acks[p][s] = m.payload
                for old in sorted(snap_acks[p])[:-SNAPSHOTS_KEPT]:
                    del snap_acks[p][old]

        def mark(s):
            # the previous marker's acks have been on the wire since its
            # step: collect them now, then ship marker s (each owner is at
            # step-s start by FIFO order) and keep the trunk's step-s
            # state by reference (updates build new tensors)
            if marker["pending"]:
                collect_acks(marker["last"])
            for ep in eps:
                ep.send("snapshot", {}, seq=s)
            trunk_snaps[s] = (tp, ts)
            hist_marks[s] = (len(history["train"]), len(history["eval"]),
                             len(losses))
            for old in sorted(trunk_snaps)[:-SNAPSHOTS_KEPT]:
                del trunk_snaps[old]
                del hist_marks[old]
            marker["last"], marker["pending"] = s, True

        def respawn(p, s):
            """Start owner ``p`` again from the marker-``s`` leaves it
            acked, at its next generation (generation-0 faults stay
            fired)."""
            name = self.owners[p].name
            ack = snap_acks[p][s]
            n_p = sum(k.startswith("p") for k in ack)
            w, ep, th = self._start_owner(
                p, backend, **owner_kw,
                leaves=[ack[f"p{i}"] for i in range(n_p)],
                opt_leaves=[ack[f"o{i}"] for i in range(len(ack) - n_p)],
                start_step=s, generation=sup.restarts(name))
            retired.append((p, eps[p]))
            if th is not None:
                retired_threads.append(threads[p])
                threads[p] = th
            workers[p], eps[p] = w, ep

        def rewarm(p):
            """The respawned owner's warmup handshake (its zero-gradient
            update leaves params and state bitwise as they are)."""
            ep, w = eps[p], workers[p]
            ep.send("warmup", {"idx": widx}, seq=-1)
            for m in range(M):
                recv(ep, w, "warmup_cuts", wait)
                ep.send("warmup_grads", codec.encode(wzero), seq=m)
            recv(ep, w, "warmup_done", wait)

        def recover(exc):
            """Roll every party back to the newest consistent marker s,
            respawn a dead owner from its acked snapshot, and return s,
            the step to replay from."""
            nonlocal tp, ts
            t_fail = time.time()
            crashed = isinstance(exc, OwnerFailure)
            party = exc.party if crashed else exc.sender
            sup.failed.setdefault(party, exc)
            sup.plan_restart(party)          # the budget, and the backoff
            p_dead = None
            s_star = marker["last"]
            if crashed:
                p_dead = next(i for i, o in enumerate(self.owners)
                              if o.name == party)
                sup.detach(party)
                # snapshot acks the dead owner sent before it died
                try:
                    while True:
                        m = eps[p_dead].recv_kind("snapshot_ack",
                                                  timeout=0.5)
                        snap_acks[p_dead][int(m.seq)] = m.payload
                except Exception:   # noqa: BLE001 — the channel is dead
                    pass
                if not isinstance(workers[p_dead], OwnerComputeEndpoint):
                    workers[p_dead].shutdown(timeout=1.0)
                acked = sorted(s for s in snap_acks[p_dead]
                               if s in trunk_snaps)
                if not acked:
                    raise OwnerFailure(
                        f"party {party!r} failed with no recoverable "
                        "snapshot", party=party) from exc
                s_star = acked[-1]
            for i, ep in enumerate(eps):
                if i != p_dead:
                    ep.send("rollback", {}, seq=s_star)
            for i, (ep, w) in enumerate(zip(eps, workers)):
                if i == p_dead:
                    continue
                while int(recv(
                        ep, w, "rollback_ack", timeout).seq) != s_star:
                    pass
                # everything the owner sent before its ack is stale
                ep.flush_pending()
            if crashed:
                while True:
                    respawn(p_dead, s_star)
                    try:
                        rewarm(p_dead)
                        break
                    except OwnerFailure as again:
                        # the new worker failed too: charge the budget
                        if not isinstance(workers[p_dead],
                                          OwnerComputeEndpoint):
                            workers[p_dead].shutdown(timeout=1.0)
                        sup.failed[party] = again
                        sup.plan_restart(party)
                sup.attach(party, eps[p_dead], workers[p_dead])
            tp, ts = trunk_snaps[s_star]
            n_tr, n_ev, n_loss = hist_marks[s_star]
            del history["train"][n_tr:]
            del history["eval"][n_ev:]
            del losses[n_loss:]
            trunk_snaps.clear()
            hist_marks.clear()
            for acks in snap_acks.values():
                acks.clear()
            marker["last"], marker["pending"] = None, False
            # every owner (a respawned one too) snapshots its restored
            # state at once, so a second failure before the next marker
            # is covered
            mark(s_star)
            collect_acks(s_star)
            marker["pending"] = False
            self.recovery_events.append({
                "party": party, "step": int(s_star),
                "action": "respawn" if crashed else "rollback",
                "error": str(exc), "seconds": time.time() - t_fail})
            return s_star

        # party threads trade sub-millisecond messages; the default 5 ms
        # switch interval would let one party stall another's dispatch
        old_switch = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        clean = False
        try:
            self._start_owners(workers, eps, threads, backend, **owner_kw)
            # ---------------- warmup: every program once per chunk shape,
            # before the clock
            widx = np.zeros(batch_size, np.int32)
            for ep in eps:
                ep.send("warmup", {"idx": widx}, seq=-1)
            wait = max(timeout, 120.0)
            wlab = self._labels(widx)
            for m in range(M):
                cuts, _ = recv_cuts("warmup_cuts", m, wait)
                lab_m = wlab[m * bm:(m + 1) * bm]
                if sequential:
                    _, _, cg = trunk_step(tp, cuts, lab_m)
                else:
                    cg, _ = cutgrad(tp, cuts, lab_m, denom, inv_micro)
                    weightgrad(tp, cuts, lab_m, denom, inv_micro)
                wzero = torch.zeros_like(to_owners(cg)[0])
                for ep in eps:
                    ep.send("warmup_grads", codec.encode(wzero), seq=m)
            # run and dropped, as the owners do
            trunk_update(tp, ts, tree_map(torch.zeros_like, tp), 0)
            for ep, w in zip(eps, workers):
                recv(ep, w, "warmup_done", wait)
            if supervise:
                sup = Supervisor(max_restarts=max_restarts,
                                 heartbeat_s=heartbeat_s)
                for owner, ep, w in zip(self.owners, eps, workers):
                    sup.attach(owner.name, ep, w)
                sup.start()

            # ---------------- the timed training region
            history: dict = {"train": [], "eval": []}
            losses: list = []
            t0 = time.time()
            t_warm = None
            overhead_s = 0.0
            t = fwd_next = 0
            while t < total_steps:
                try:
                    if supervise and t % resync_every == 0 \
                            and marker["last"] != t:
                        mark(t)
                    if fwd_next == t:
                        send_fwd(t)
                        fwd_next = t + 1
                    if not sequential and fwd_next == t + 1 < total_steps:
                        send_fwd(t + 1)
                        fwd_next = t + 2
                    lab_t = self._labels(inflight.popleft())
                    if sequential:
                        cuts, owner_aux = recv_cuts("cut_activations", t,
                                                    timeout)
                        metrics, tg, cg = trunk_step(tp, cuts, lab_t)
                        tp, ts = trunk_update(tp, ts, tg, t)
                        send_grads(to_owners(cg), t)
                        for ep, w in zip(eps, workers):
                            recv(ep, w, "step_done",
                                                  timeout)
                    else:
                        metrics, cache, owner_aux = None, [], 0.0
                        for m in range(M):
                            seq = t * M + m
                            lab_m = lab_t[m * bm:(m + 1) * bm]
                            cuts, aux_m = recv_cuts("cut_activations", seq,
                                                    timeout)
                            owner_aux += aux_m
                            cg, parts = cutgrad(tp, cuts, lab_m, denom,
                                                inv_micro)
                            send_grads(to_owners(cg), seq)
                            metrics = tree_add(metrics, parts)
                            cache.append((cuts, lab_m))
                        tg = None
                        for cuts, lab_m in cache:
                            tg = tree_add(tg, weightgrad(tp, cuts, lab_m,
                                                         denom, inv_micro))
                        tp, ts = trunk_update(tp, ts, tg, t)
                    metrics = _with_owner_aux(metrics, owner_aux)
                    losses.append(metrics["loss"])
                    if t == 0:
                        t_warm = time.time()
                    tb = time.time()
                    self._after_step(t, metrics, history, t0, book, sync)
                    overhead_s += time.time() - tb
                    t += 1
                except (OwnerFailure, transport.FrameCorrupt) as e:
                    if not supervise:
                        raise
                    t = recover(e)
                    inflight.clear()
                    fwd_next = t
            wall_s = time.time() - t0
            sync()
            clean = True
        finally:
            sys.setswitchinterval(old_switch)
            if sup is not None:
                sup.stop()
            for ep in eps:
                try:
                    ep.send("stop", {})
                except RuntimeError:        # a worker process already gone
                    pass
            # a replaced owner's thread is not waited for long: a wedged
            # one never returns
            for th, limit in [(th, 10.0) for th in threads] + \
                    [(th, 1.0) for th in retired_threads]:
                _join_or_warn(th, limit, "fit(split)")
            for w in workers:
                if not isinstance(w, OwnerComputeEndpoint):
                    # after a failure a survivor may wait on a message
                    # that never comes: terminate it soon
                    w.shutdown(timeout=10.0 if clean else 1.0)

        # ------------------------------------- measured traffic accounting
        # every endpoint, replaced owners' included: the frames that
        # crossed, replays and all
        n_div = max(total_steps, 1)        # steps=0 runs only the warmup
        per_owner: Dict[str, dict] = {}
        by_kind: Dict[str, dict] = {}      # both directions, all owners
        zero = {"payload_bytes": 0, "wire_bytes": 0}
        for p, ep in list(enumerate(eps)) + retired:
            sent, rcvd = ep.sent_stats, ep.recv_stats
            for st in (sent, rcvd):
                for kind, v in st["by_kind"].items():
                    acc = by_kind.setdefault(kind, dict.fromkeys(v, 0))
                    for k in v:
                        acc[k] += v[k]
            cut_k = rcvd["by_kind"].get("cut_activations", zero)
            grad_k = sent["by_kind"].get("cut_gradients", zero)
            o = per_owner.setdefault(self.owners[p].name, {
                "cut_payload_bytes": 0, "cut_wire_bytes": 0,
                "grad_payload_bytes": 0, "grad_wire_bytes": 0,
                "messages": 0})
            o["cut_payload_bytes"] += cut_k["payload_bytes"]
            o["cut_wire_bytes"] += cut_k["wire_bytes"]
            o["grad_payload_bytes"] += grad_k["payload_bytes"]
            o["grad_wire_bytes"] += grad_k["wire_bytes"]
            o["messages"] += sent["messages"] + rcvd["messages"]
        tot_payload = tot_wire = 0
        for owner in self.owners:
            o = per_owner[owner.name]
            tot_payload += o["cut_payload_bytes"] + o["grad_payload_bytes"]
            tot_wire += o["cut_wire_bytes"] + o["grad_wire_bytes"]
            self._log(owner.name, "scientist", "cut_activations",
                      bytes=o["cut_payload_bytes"], measured=True,
                      per_step_bytes=o["cut_payload_bytes"] // n_div,
                      width=adapter.cut_shape(
                          batch_size, owner.feature_shape)[-1])
            self._log("scientist", owner.name, "cut_gradients",
                      bytes=o["grad_payload_bytes"], measured=True,
                      per_step_bytes=o["grad_payload_bytes"] // n_div)
        step_s = wall_s - overhead_s
        self.transport_stats = {
            "mode": "split", "schedule": schedule, "microbatches": M,
            "aggregation": aggregation or "none",
            "compression": compression or "none", "backend": backend,
            "latency_s": latency_s, "bandwidth_bps": bandwidth_bps,
            "device": str(self.device),
            "steps": total_steps, "wall_s": wall_s,
            # per-step cost excludes eval/sync/checkpoint bookkeeping ...
            "step_ms": 1e3 * step_s / n_div,
            # ... and, steady-state, the step-0 pipeline fill too
            "steady_step_ms": (1e3 * (t0 + step_s - t_warm)
                               / (total_steps - 1) if total_steps > 1
                               else 1e3 * step_s),
            "per_owner": per_owner,
            "wire_by_kind": by_kind,
            "cut_payload_bytes_per_step": sum(
                o["cut_payload_bytes"] for o in per_owner.values())
            // n_div,
            "total_payload_bytes": tot_payload,
            "total_wire_bytes": tot_wire,
            "total_payload_bytes_per_step": tot_payload // n_div,
            "recoveries": len(self.recovery_events),
            "supervisor": dict(sup.stats) if sup is not None else None,
            # the wall seconds of each checkpoint (its sync included)
            "ckpt_s": list(book["ckpt_s"]),
        }
        history = self._finish(history, losses, book)
        history["transport"] = self.transport_stats
        return history

    # ------------------------------------------------------------ 4. eval

    def evaluate(self, *, split: str = "eval",
                 batch_size: int = 512) -> Dict[str, float]:
        """Metrics on the held-out (or train) rows, batched and
        length-weighted."""
        self._require(resolved=True, built=True, labels=True)
        idx = self._eval_idx if split == "eval" else self._train_idx
        if not len(idx):
            raise ValueError(f"no rows in split {split!r} — "
                             "fit with eval_frac > 0 first")
        owner_arrays = self._owner_arrays()
        labels = self.scientist.labels
        totals: Dict[str, float] = {}
        with torch.no_grad():
            for s in range(0, len(idx), batch_size):
                sub = idx[s:s + batch_size]
                batch = self.adapter.make_batch(owner_arrays, labels, sub,
                                                device=self.device)
                _, m = self.adapter.loss_fn(self.params, batch)
                for k, v in m.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * len(sub)
        return {k: v / len(idx) for k, v in totals.items()}

    # ---------------------------------------------------------- accounting

    def cut_traffic(self, batch_size: int,
                    bytes_per_el: int = 4) -> Dict[str, int]:
        """Bytes crossing each owner<->scientist boundary per step."""
        self._require(built=True)
        shape = self.adapter.cut_shape(batch_size,
                                       self.owners[0].feature_shape)
        tokens = shape[1] if len(shape) == 3 else 1
        return cut_layer_traffic(len(self.owners), batch_size, tokens,
                                 shape[-1], bytes_per_el)

    def checkpoint(self, ckpt_dir: str, step: int = 0) -> str:
        """Per-party checkpoints of the session's params:
        ``step_{step:08d}/owner{i}.npz`` per owner and ``trunk.npz``
        (:func:`repro_torch.checkpoint.save_split`); returns that
        directory."""
        self._require(built=True)
        return save_split(ckpt_dir, self.params, step)

    def restore(self, step_dir: str) -> "VerticalSession":
        """Load the per-party checkpoints of ``step_dir`` (written by
        :meth:`checkpoint`, ``fit(ckpt_every=...)`` or the reference's
        ``save_split``) into the session's params on its device, so a
        fresh session resumes from that step."""
        self._require(built=True)
        loaded = tree_leaves(restore_split(step_dir))
        want = [tuple(t.shape) for t in tree_leaves(self.params)]
        got = [tuple(a.shape) for a in loaded]
        if got != want:
            raise ValueError(f"checkpoint {step_dir!r} does not fit the "
                             f"built model: leaf shapes {got} != {want}")
        # the built tree's structure: a file keeps no empty subtree (an
        # LM's ``shared: {}``)
        self.params = tree_unflatten(self.params, [torch.from_numpy(
            np.array(a, np.float32)).to(self.device) for a in loaded])
        return self

    # ------------------------------------------------------------ 5. serve

    def serve(self, **engine_kw):
        """Wrap the resident split model in a ``ServingEngine`` (LM
        archs) on the session's device.  Kwargs are forwarded:
        ``batch_slots, ctx_len, max_new, eos_token, pad_token``, the
        transport boundary (``transport`` "direct" | "queue" | "process",
        ``latency_s``, ``bandwidth_bps``, ``compression`` None | "fp16"
        | "int8"), and ``scheduler`` ("wave" | "continuous"),
        ``max_queue`` and ``cut_cache``."""
        self._require(built=True)
        if not getattr(self.adapter, "supports_serving", False):
            raise ValueError(
                f"{type(self.adapter).__name__} does not support serving")
        engine_kw.setdefault("device", self.device)
        return self.adapter.make_engine(self.params, **engine_kw)

    def serve_dataset(self, *, max_new: int = 16, batch_slots: int = 4,
                      n_requests: Optional[int] = None, **engine_kw):
        """Serve the session's own aligned contexts: the owners' sequence
        slices are merged (owner side) into each request's context,
        queued, and decoded.  Returns ({rid: Result}, engine)."""
        self._require(resolved=True, built=True)
        contexts = batching.merge_sequence_slices(
            np.stack(self._owner_arrays()))
        if n_requests is not None:
            contexts = contexts[:n_requests]
        engine = self.serve(batch_slots=batch_slots,
                            ctx_len=contexts.shape[1], max_new=max_new,
                            **engine_kw)
        for row in contexts:
            engine.submit(row)
        return engine.run(), engine
