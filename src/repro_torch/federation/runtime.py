"""One OS process per data owner (the port's counterpart of
``repro.federation.runtime``).

``fit(backend="process")`` and ``resolve(backend="process")`` spawn one
worker per owner.  Each worker is a ``spawn``-started process (CUDA
cannot be used again in a forked child) that rebuilds its party actor
from a picklable spec and runs the very loop the thread backend runs:

  * :func:`owner_worker_main` — resolves the spec's device (on a card
    that configures the reference numerics in the worker's own CUDA
    context), rebuilds the registry adapter from the config dataclass
    (the MLP's ``MLPSplitConfig`` or an LM's ``ArchConfig``: the worker
    builds its head's programs from it), takes its head params as numpy
    leaves, and runs an
    :class:`~repro_torch.federation.parties.OwnerComputeEndpoint` over
    a :class:`~repro_torch.federation.process_transport.ProcessEndpoint`.
    Only cut activations and cut gradients cross back.
  * :func:`psi_worker_main` — a :class:`~repro_torch.federation.
    psi_transport.PSIServerEndpoint` over the owner's IDs.  Its import
    chain (this module, ``faults``, ``process_transport``,
    ``transport``, ``psi_transport``, ``core.psi``, ``core.bloom``,
    ``core.modexp``) loads no torch, so a PSI worker starts in well
    under a second.  :func:`spawn_psi_worker` rehydrates the owner's
    persistent PSI state into it — β, the blinded own set and its
    shuffle, and the content-tag caches — so a fresh worker per round
    (or per retry) ships the same bytes a long-lived owner would.
  * :class:`WorkerHandle` — the parent's view: the endpoint, the
    process, and the ``error`` the session's receive polls check (the
    worker's error frame, or a nonzero exit code for a death too sudden
    to send one).

Lifecycle: spawn -> warmup handshake (driven by the session over the
pipe, before the timed region) -> the step protocol -> ``stop`` ->
drain, exit 0.  A worker that throws ships one error frame with its
traceback and exits 1.  Kernel launch counts are per process: a
worker's launches (the int8 codec on its cuts) are counted in the
worker, not in the parent.

Supervised recovery respawns a worker from a snapshot: the spec then
carries the optimizer-state leaves, the step to resume at and the
worker's generation.  Chaos: ``REPRO_CHAOS_PARTY`` carries a
``federation.faults`` plan, which a spawned worker inherits with the
caller's environment; the worker arms its actor (crash, wedge) and its
endpoint (drop, corrupt, delay) from it at its generation, so a
generation-0 fault does not fire again in a respawn; a PSI worker is
armed the same way, at the generation of its round's attempt.
"""
from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.psi import DEFAULT_CHUNK
from repro_torch.federation import faults
from repro_torch.federation.process_transport import ProcessEndpoint

__all__ = ["OwnerWorkerSpec", "PSIWorkerSpec", "WorkerHandle",
           "owner_worker_main", "psi_worker_main", "spawn_owner_worker",
           "spawn_psi_worker"]

SCIENTIST = "scientist"


@dataclass
class OwnerWorkerSpec:
    """Everything a spawned owner worker needs to rebuild its party:
    ``config`` is the model config (a frozen dataclass);
    ``param_leaves`` the owner's head params as numpy leaves in
    ``tree_leaves`` order (the worker rebuilds the tree against its
    adapter's ``owner_template``, so no structure crosses);
    ``device`` the explicit device string the worker resolves;
    ``num_threads`` the worker's intra-op CPU threads (None: torch's
    default).  ``aggregation="masked_sum"`` makes the worker build its
    :class:`~repro_torch.core.masking.MaskedAggregator` over
    ``n_owners`` owners.  Its root seed is ``REPRO_MASK_SEED`` where the
    environment sets it (a spawned worker inherits the caller's), else
    ``noise_seed``, the session's init seed, which the session's own
    owner threads fall back to as well.  ``cut_noise_std`` and
    ``noise_seed`` are the owner's cut-noise defence.  A respawn gives
    ``opt_state_leaves`` (the snapshot's optimizer state; None: a fresh
    state from the params), ``start_step`` (the step to resume at) and
    ``generation`` (0 for the first start, one more per respawn: it
    scopes the fault plan and the masked warmup's tags).  ``latency_s``
    and ``bandwidth_bps`` delay every frame on the pipe in both
    directions, and ``spin_s`` is the delivery wait's spin, the caller's
    ``transport.spin_wait_s()``."""

    name: str
    ids: List[str]
    features: np.ndarray
    owner_index: int
    config: object
    device: str
    param_leaves: List[np.ndarray] = field(default_factory=list)
    codec: Optional[str] = None
    microbatches: int = 1
    ack_steps: bool = False
    owner_lr: Optional[float] = None
    num_threads: Optional[int] = None
    aggregation: Optional[str] = None
    n_owners: int = 0
    cut_noise_std: float = 0.0
    noise_seed: int = 0
    opt_state_leaves: Optional[List[np.ndarray]] = None
    start_step: int = 0
    generation: int = 0
    latency_s: float = 0.0
    bandwidth_bps: Optional[float] = None
    spin_s: Optional[float] = None


@dataclass
class PSIWorkerSpec:
    """A PSI server actor's world: the owner's IDs and group geometry,
    the wire's ``latency_s`` / ``bandwidth_bps``, the worker's
    ``generation`` (the round's attempt), and the owner's persistent PSI
    state: ``beta``, the three content-tag cache snapshots and the
    precomputed response side (the packed blinded own set, its
    shuffled-position -> row map and the per-item element cache)."""

    name: str
    ids: List[str]
    group: str
    fp_rate: float = 1e-9
    latency_s: float = 0.0
    bandwidth_bps: Optional[float] = None
    generation: int = 0
    beta: Optional[int] = None
    blind_cache: Optional[dict] = None
    resp_cache: Optional[dict] = None
    lift_cache: Optional[dict] = None
    own_packed: Optional[bytes] = None
    own_rows: Optional[List[int]] = None
    own_elems: Optional[dict] = None


def _run_worker(spec, conn, body, **wire) -> None:
    """A worker's scaffold: the endpoint up (``wire``: its latency and
    bandwidth) and armed with the plan's wire faults, ``body``, then a
    clean close (exit 0) — or the error frame and exit 1."""
    ep = ProcessEndpoint(spec.name, SCIENTIST, conn, **wire)
    # wire faults (drop, corrupt, delay) on everything this worker sends
    faults.arm_endpoint(ep, spec.name, generation=spec.generation)
    try:
        body(spec, ep)
    except BaseException as e:              # noqa: BLE001 — shipped to
        ep.send_error(e, traceback.format_exc())   # the parent's poll
        ep.close()
        raise SystemExit(1)
    ep.close()


def _owner_body(spec: OwnerWorkerSpec, ep: ProcessEndpoint) -> None:
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.federation.parties import (DataOwner,
                                                OwnerComputeEndpoint)
    from repro_torch.federation.registry import build_adapter
    from repro_torch.federation.cut_codec import get_codec
    from repro_torch.tree import tree_unflatten

    if spec.num_threads:
        torch.set_num_threads(spec.num_threads)
    device = resolve_device(spec.device)
    adapter = build_adapter(spec.config)
    p = spec.owner_index
    # the structure only: an LM's full-width init would draw billions
    # of weights on the worker's host just to learn shapes
    params = tree_unflatten(adapter.owner_template(p), [
        torch.from_numpy(np.array(leaf, np.float32)).to(device)
        for leaf in spec.param_leaves])
    owner_opt, owner_update = adapter.owner_update_rule(spec.owner_lr)
    opt_state = owner_opt.init(params)
    if spec.opt_state_leaves is not None:
        opt_state = tree_unflatten(opt_state, [
            torch.from_numpy(np.array(leaf)).to(device)
            for leaf in spec.opt_state_leaves])
    head_fwd, head_bwd = adapter.owner_programs(p)
    masker = None
    if spec.aggregation == "masked_sum":
        from repro_torch.core import masking
        masker = masking.MaskedAggregator(
            masking.mask_root_from_env(spec.noise_seed), p, spec.n_owners,
            generation=spec.generation)
    worker = OwnerComputeEndpoint(
        DataOwner(spec.name, spec.ids, spec.features), ep, head_fwd,
        head_bwd, update=owner_update, params=params, opt_state=opt_state,
        codec=get_codec(spec.codec, device), device=device,
        ack_steps=spec.ack_steps, microbatches=spec.microbatches,
        masker=masker, cut_noise_std=spec.cut_noise_std,
        noise_seed=spec.noise_seed, start_step=spec.start_step)
    faults.arm_actor(worker, spec.name, generation=spec.generation)
    worker.run()
    if worker.error is not None:
        raise worker.error


def owner_worker_main(spec: OwnerWorkerSpec, conn) -> None:
    """Spawn target of an owner worker."""
    _run_worker(spec, conn, _owner_body, latency_s=spec.latency_s,
                bandwidth_bps=spec.bandwidth_bps, spin_s=spec.spin_s)


def _psi_body(spec: PSIWorkerSpec, ep: ProcessEndpoint) -> None:
    from repro_torch.core.psi import PSIServer
    from repro_torch.federation.psi_transport import PSIServerEndpoint

    server = PSIServer(spec.ids, spec.fp_rate, spec.group, beta=spec.beta)
    if spec.own_packed is not None:
        server._own_packed = spec.own_packed
        server._own_rows = list(spec.own_rows or [])
        server._own_elems = dict(spec.own_elems or {})
    actor = PSIServerEndpoint(spec.name, server, ep,
                              blind_cache=dict(spec.blind_cache or {}),
                              resp_cache=dict(spec.resp_cache or {}),
                              lift_cache=dict(spec.lift_cache or {}))
    faults.arm_actor(actor, spec.name, generation=spec.generation)
    actor.run()
    if actor.error is not None:
        raise actor.error


def psi_worker_main(spec: PSIWorkerSpec, conn) -> None:
    """Spawn target of a PSI server actor (no torch in its imports)."""
    _run_worker(spec, conn, _psi_body, latency_s=spec.latency_s,
                bandwidth_bps=spec.bandwidth_bps)


class WorkerHandle:
    """The scientist's view of one spawned owner worker: ``endpoint``
    (its end of the pipe), ``proc``, ``owner`` (the parent-side party
    object) and ``error``, which the session's receive polls read, as
    they read a thread worker's."""

    def __init__(self, name: str, proc, endpoint: ProcessEndpoint,
                 owner=None):
        self.name = name
        self.proc = proc
        self.endpoint = endpoint
        self.owner = owner

    @property
    def error(self) -> Optional[BaseException]:
        if self.endpoint.peer_error is not None:
            return self.endpoint.peer_error
        code = self.proc.exitcode
        if code not in (None, 0):
            return RuntimeError(
                f"party worker {self.name!r} exited with code {code}")
        return None

    def shutdown(self, timeout: float = 10.0) -> None:
        """Join; terminate a worker that is stuck.  Idempotent."""
        self.proc.join(timeout=timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5.0)
        self.endpoint.close()


def _spawn(main, spec, *, owner=None, latency_s: float = 0.0,
           bandwidth_bps: Optional[float] = None,
           spin_s: Optional[float] = None) -> WorkerHandle:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=main, args=(spec, child_conn), daemon=True,
                       name=f"party-{spec.name}")
    proc.start()
    child_conn.close()          # the child owns its end now
    ep = ProcessEndpoint(SCIENTIST, spec.name, parent_conn,
                         latency_s=latency_s, bandwidth_bps=bandwidth_bps,
                         spin_s=spin_s)
    return WorkerHandle(spec.name, proc, ep, owner=owner)


def spawn_owner_worker(spec: OwnerWorkerSpec, *, owner=None
                       ) -> WorkerHandle:
    """Start one owner worker; returns the parent's handle, whose
    ``endpoint`` is the scientist's end of the party boundary, with the
    spec's latency, bandwidth and spin."""
    return _spawn(owner_worker_main, spec, owner=owner,
                  latency_s=spec.latency_s, bandwidth_bps=spec.bandwidth_bps,
                  spin_s=spec.spin_s)


def spawn_psi_worker(owner, *, group: str, fp_rate: float = 1e-9,
                     latency_s: float = 0.0,
                     bandwidth_bps: Optional[float] = None,
                     generation: int = 0, pool=None,
                     chunk_size: int = DEFAULT_CHUNK) -> WorkerHandle:
    """Start one PSI server actor for ``owner`` (a ``DataOwner``) at
    ``generation`` (the round's attempt: a generation-0 fault does not
    fire again in a retry).  The owner's persistent server blinds its
    own set here, in the parent (``pool`` runs it in chunks of
    ``chunk_size``, the round's: the bytes do not depend on it; O(Δ new
    items) after churn), so retries never repeat it; the spec carries
    that state and the owner's caches into the worker."""
    key = (group, fp_rate)
    srv = owner.psi_server(group, fp_rate)   # synced to the population
    srv.own_blinded_packed(pool, chunk_size)
    spec = PSIWorkerSpec(
        name=owner.name, ids=list(srv.items), group=group, fp_rate=fp_rate,
        latency_s=latency_s, bandwidth_bps=bandwidth_bps,
        generation=generation, beta=srv._beta,
        blind_cache=dict(owner._psi_blind_caches.setdefault(key, {})),
        resp_cache=dict(owner._psi_resp_caches.setdefault(key, {})),
        lift_cache=dict(owner._psi_lift_caches.setdefault(key, {})),
        own_packed=srv._own_packed, own_rows=srv._own_rows,
        own_elems=srv._own_elems)
    return _spawn(psi_worker_main, spec, owner=owner, latency_s=latency_s,
                  bandwidth_bps=bandwidth_bps)
