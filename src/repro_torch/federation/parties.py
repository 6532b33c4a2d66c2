"""Party abstractions (the port's counterpart of
``repro.federation.parties``).

A data scientist trains on features vertically partitioned across data
owners without ever touching raw features, and owners never see labels.
These classes make that visibility contract structural:

  * :class:`DataOwner` holds ``(ids, features)`` and no labels; its
    ``features`` property raises :class:`PrivacyError` — raw features
    are reachable only through the owner-side accessor ``_features``.
  * :class:`DataScientist` holds ``(ids, labels)`` and nothing else.
  * :class:`OwnerComputeEndpoint` is the compute that runs on an owner's
    device in split training, driven by protocol messages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.privacy import deterministic_cut_noise
from repro_torch.core.psi import DEFAULT_MODE, PSIClient, PSIServer
from repro_torch.core.resolution import VerticalDataset
from repro_torch.core.vertical import make_ids, partition_sequence
from repro_torch.tree import tree_add, tree_leaves

# snapshot markers an owner (and the supervised fit, of its acks) keeps:
# with sparse markers the pipeline's lag still needs the one before the
# newest, and a rollback needs the scientist's newest acked marker still
# held by every survivor
SNAPSHOTS_KEPT = 4


def device_rows(features, device) -> torch.Tensor:
    """An owner's aligned rows on ``device``: integer token slices as
    int32, anything else as f32."""
    a = np.asarray(features)
    dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)


class PrivacyError(RuntimeError):
    """Raised when code crosses the party-visibility boundary."""


class DataOwner:
    """A data owner: a vertical slice of every shared subject's features.
    It ships only cut-layer activations; raw rows never leave."""

    def __init__(self, name: str, ids: Sequence[str], features: np.ndarray):
        self.name = name
        self._vd = VerticalDataset(list(ids), np.asarray(features))
        # the full population: ``_vd`` becomes the aligned training view
        # after a resolve, but PSI always runs against the population
        self._full = self._vd
        self._psi_servers: Dict[tuple, PSIServer] = {}
        # content-tag caches (client uploads / double-blind responses /
        # hidden-mode lifts), keyed by (group, fp_rate): owned here so
        # the byte and modexp savings survive actor re-creation, worker
        # respawns and population churn
        self._psi_blind_caches: Dict[tuple, dict] = {}
        self._psi_resp_caches: Dict[tuple, dict] = {}
        self._psi_lift_caches: Dict[tuple, dict] = {}

    @property
    def ids(self) -> List[str]:
        return self._vd.ids

    @property
    def n_rows(self) -> int:
        return len(self._vd.ids)

    @property
    def feature_shape(self) -> Tuple[int, ...]:
        """Per-row feature shape — metadata, not data."""
        return tuple(self._vd.data.shape[1:])

    @property
    def features(self):
        raise PrivacyError(
            f"raw features of {self.name!r} are private to the owner; "
            "only cut-layer activations cross the party boundary")

    def __repr__(self):
        return (f"DataOwner({self.name!r}, rows={self.n_rows}, "
                f"feature_shape={self.feature_shape})")

    def psi_server(self, group: str, fp_rate: float = 1e-9) -> PSIServer:
        """The owner's PSI endpoint, cached per (group, fp_rate): β and
        the per-element blinded own set persist, so a resolve after ±Δ
        row churn blinds only the Δ new elements
        (``PSIServer.update_items``).  It syncs itself to the owner's
        current population."""
        key = (group, fp_rate)
        pop = self._full.ids
        srv = self._psi_servers.get(key)
        if srv is None:
            srv = self._psi_servers[key] = PSIServer(pop, fp_rate, group)
        elif srv.items != pop:
            srv.update_items(pop)
        return srv

    def psi_endpoint(self, endpoint, group: str, fp_rate: float = 1e-9,
                     pool=None):
        """The owner's wire-native PSI actor on ``endpoint``: a
        :class:`~repro_torch.federation.psi_transport.PSIServerEndpoint`
        over the cached :meth:`psi_server`, with the owner's content-tag
        caches, so repeat rounds skip the re-upload even across actor
        re-creation.  ``pool`` feeds the actor's own-set chunk
        kernels."""
        from repro_torch.federation.psi_transport import PSIServerEndpoint
        key = (group, fp_rate)
        return PSIServerEndpoint(
            self.name, self.psi_server(group, fp_rate), endpoint,
            blind_cache=self._psi_blind_caches.setdefault(key, {}),
            resp_cache=self._psi_resp_caches.setdefault(key, {}),
            lift_cache=self._psi_lift_caches.setdefault(key, {}),
            chunk_kernel_pool=pool)

    def update_rows(self, ids: Sequence[str], features: np.ndarray
                    ) -> None:
        """Replace the owner's population in place.  PSI state is kept:
        the cached server re-syncs on the next resolve (O(Δ) new
        exponentiations for ±Δ churn), and the content-tag caches stay
        valid because they are keyed by content."""
        self._full = VerticalDataset(list(ids), np.asarray(features))
        self._vd = self._full

    # -- owner-side surface (runs 'on the owner's device') -----------------
    @property
    def _features(self) -> np.ndarray:
        return self._vd.data

    def _align(self, keep_ids: Sequence[str]) -> None:
        """Discard non-shared rows and sort by ID (paper §3.1)."""
        self._vd = self._full.filter_and_sort(keep_ids)

    def _align_hidden(self, rows: Sequence[int]) -> None:
        """Membership-hiding alignment: keep exactly ``rows`` (indices
        into the full population, decoys included) in that order, under
        positional pseudonyms ``anon000000``, ... — the aligned order is
        the only cross-party coordinate, so no party learns which raw
        IDs matched."""
        rows = list(rows)
        self._vd = VerticalDataset(
            [f"anon{k:06d}" for k in range(len(rows))],
            self._full.data[np.asarray(rows, np.int64)]
            if rows else self._full.data[:0])


class DataScientist:
    """The data scientist: subject ids + labels.  Holds no features."""

    def __init__(self, ids: Sequence[str], labels: Optional[np.ndarray]):
        self._set_rows(ids, labels)
        self._psi_clients: Dict[tuple, PSIClient] = {}

    def _set_rows(self, ids, labels) -> None:
        ids = list(ids)
        self._vd = VerticalDataset(
            ids, np.asarray(labels) if labels is not None
            else np.zeros(len(ids), np.int32))
        self.has_labels = labels is not None
        self._full = self._vd

    @property
    def ids(self) -> List[str]:
        return self._vd.ids

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self._vd.data if self.has_labels else None

    def __repr__(self):
        return (f"DataScientist(rows={len(self._vd.ids)}, "
                f"labels={self.has_labels})")

    def psi_client(self, group: str, mode: str = DEFAULT_MODE,
                   pool=None) -> PSIClient:
        """The scientist's PSI endpoint, cached per (group, mode): its
        blinded upload is memoized and reused against every owner round.
        It syncs itself to the scientist's current population through
        ``PSIClient.update_items``: after ±Δ churn the upload is spliced
        in O(Δ) modexp (``pool`` runs the new elements' chunks), which
        arms the wire's delta round."""
        key = (group, mode)
        pop = self._full.ids
        cli = self._psi_clients.get(key)
        if cli is None:
            cli = self._psi_clients[key] = PSIClient(pop, group, mode=mode)
        elif cli.items != pop:
            cli.update_items(pop, pool=pool)
        return cli

    def update_rows(self, ids: Sequence[str],
                    labels: Optional[np.ndarray]) -> None:
        """Replace the scientist's population in place; cached PSI
        clients re-sync on the next resolve (O(Δ) modexp and a delta
        upload for ±Δ churn)."""
        self._set_rows(ids, labels)

    def _align(self, keep_ids: Sequence[str]) -> None:
        self._vd = self._full.filter_and_sort(keep_ids)

    def _align_hidden(self, positions: Sequence[int],
                      client_items: Sequence[str]) -> None:
        """Membership-hiding alignment: ``positions`` index the PSI
        client's item order (members and decoys alike); each maps back
        to the scientist's full-population row, under the owners'
        positional pseudonyms."""
        row_of = {it: i for i, it in enumerate(self._full.ids)}
        rows = [row_of[client_items[p]] for p in positions]
        self._vd = VerticalDataset(
            [f"anon{k:06d}" for k in range(len(rows))],
            self._full.data[np.asarray(rows, np.int64)]
            if rows else self._full.data[:0])


# ---------------------------------------------------------------------------
# Owner-side compute endpoint (true split execution)
# ---------------------------------------------------------------------------


class OwnerComputeEndpoint:
    """The compute that, in a deployment, runs on the owner's device.

    Holds the owner's private feature slice (staged on the device once),
    its head-segment parameters and its optimizer state; everything else
    arrives as protocol messages on its transport endpoint:

      ``head_fwd``       batch row indices for step t (seq t).  The owner
                         gathers its own rows on the device, cuts them
                         into ``microbatches`` chunks and — once the step
                         t-1 update is applied — runs the head forward
                         per chunk, shipping each codec-encoded cut the
                         moment it exists (``cut_activations``, seq
                         ``t*M + m``).
      ``cut_gradients``  the cut gradient of chunk m of step t (seq
                         ``t*M + m``): the head backward for that chunk
                         at once, accumulated in chunk order at
                         step-start params; on the step's last chunk one
                         optimizer update, then the staged step-t+1
                         forward if its request already arrived.
      ``warmup``         pre-training handshake: one forward per chunk,
                         one backward of a zero gradient per chunk
                         (without the NoPeek term) and one update whose
                         result is dropped, through both codec
                         directions: params and optimizer state stay
                         bitwise as they are (a respawned owner's too).
      ``barrier``        flush marker, acked once every prior message is
                         processed.
      ``pull_params``    the head params as numbered numpy leaves
                         (``params_dump``): across a process boundary the
                         session's only view of the owner's state.
      ``heartbeat``      liveness probe (``federation/supervisor.py``),
                         answered inline with ``heartbeat_ack``: a wedged
                         owner stops answering.
      ``snapshot``       step marker s (seq s): params and optimizer
                         state are at step-s start by FIFO order.  The
                         owner keeps them (by reference: updates build
                         new tensors) for the 4 newest markers and acks
                         their leaves as host numpy ``p{i}`` / ``o{i}``
                         (``snapshot_ack``), from which the scientist
                         can respawn it.
      ``rollback``       another party failed: restore the step-s
                         snapshot, drop the staged plan, the in-flight
                         chunks and the gradient accumulator, and ack
                         (``rollback_ack``); the scientist replays from
                         step s.
      ``stop``           end of training.

    FIFO channel order is the only synchronization: every gradient of
    step t precedes the forward of step t+1 (an early ``head_fwd`` is
    staged, not run), so the pipelined schedule is exact.  Every tensor
    op runs on the session's device; the host copy at the wire boundary
    synchronises, so the loop takes no explicit device sync.  ``run``
    is the thread target (and the spawned worker's loop,
    ``federation/runtime.py``).

    The owner's rows are staged as they are held: feature rows as f32,
    token slices as integers.  A head forward may return ``(cut, aux)``
    (an LM's): ``aux`` ships beside the cut as one f32 scalar.
    Cuts ship codec-encoded, or with ``masker`` (a
    :class:`~repro_torch.core.masking.MaskedAggregator`) quantized and
    ring-masked as ``{"mq": uint32}``, bypassing the codec.  Without a
    masker, ``cut_noise_std`` adds the owner's deterministic Gaussian
    noise (keyed on ``noise_seed`` and ``s{seq}``) to every steady-state
    cut before the codec; under masking it is ignored, as in the
    reference.  ``opt_state`` and ``start_step`` let a respawned owner
    resume a snapshot mid-run.  The reference's fused owner tail is
    queued in ROADMAP.md.
    """

    def __init__(self, owner: DataOwner, endpoint, head_fwd, head_bwd, *,
                 update, params, opt_state, codec, device,
                 ack_steps: bool = False, microbatches: int = 1,
                 masker=None, cut_noise_std: float = 0.0,
                 noise_seed: int = 0, start_step: int = 0):
        self.owner = owner
        self.endpoint = endpoint
        self.head_fwd, self.head_bwd = head_fwd, head_bwd
        self.masker = masker
        self.cut_noise_std = float(cut_noise_std)
        self.noise_seed = int(noise_seed)
        self._update = update
        self.params = params
        self.opt_state = opt_state
        self.codec = codec
        self.device = torch.device(device)
        self.ack_steps = ack_steps
        self.micro = int(microbatches)
        self.steps_done = int(start_step)
        self.error: Optional[BaseException] = None
        # marker step -> (params, opt_state), for rollback
        self._snaps: Dict[int, tuple] = {}
        self._inflight: Dict[int, torch.Tensor] = {}   # seq -> head input
        self._plan: Dict[int, List[torch.Tensor]] = {}  # step -> chunks
        self._grad_acc = None
        self._grads_seen = 0
        self._feats = device_rows(owner._features, self.device)

    def _stage(self, idx) -> List[torch.Tensor]:
        """Gather the step's rows on the device and cut the chunks."""
        x = self._feats[torch.from_numpy(
            np.asarray(idx, np.int64)).to(self.device)]
        bm = x.shape[0] // self.micro
        return [x[m * bm:(m + 1) * bm] for m in range(self.micro)]

    def _ship_cut(self, out, seq: int, kind: str = "cut_activations"
                  ) -> None:
        # an LM's head forward returns (cut, aux): the owner's scalar aux
        # loss rides with the cut, for the scientist's aux metric
        cut, aux = out if isinstance(out, tuple) else (out, None)
        if self.masker is not None:
            # {"mq": uint32 ring element}: uniform ring words, 4 bytes
            # each like the f32 cut, so no codec applies
            tag = (self.masker.step_tag(seq) if kind == "cut_activations"
                   else self.masker.warmup_tag(seq))
            payload = self.masker.encode(cut, tag)
        else:
            if self.cut_noise_std > 0.0 and kind == "cut_activations":
                # the noisy cut ships in f32 whatever the cut's dtype
                cut = torch.from_numpy(deterministic_cut_noise(
                    cut.float().cpu().numpy(), self.cut_noise_std,
                    self.noise_seed, f"s{seq}")).to(self.device)
            payload = self.codec.encode(cut)
        if aux is not None:
            payload["aux"] = np.float32(aux.sum().item())
        self.endpoint.send(kind, payload, seq=seq)

    def _run_fwd(self, step: int) -> None:
        for m, x in enumerate(self._plan.pop(step)):
            seq = step * self.micro + m
            self._inflight[seq] = x
            self._ship_cut(self.head_fwd(self.params, x), seq)

    def _warmup(self, msg) -> None:
        chunks = self._stage(msg.payload["idx"])
        for m, x in enumerate(chunks):
            self._ship_cut(self.head_fwd(self.params, x), m, "warmup_cuts")
        for x in chunks:
            g = self.codec.decode(
                self.endpoint.recv_kind("warmup_grads").payload)
            # no NoPeek term: on the warmup's batch of one repeated row
            # its gradient is not finite, and any term would move params
            self._grad_acc = tree_add(self._grad_acc, self.head_bwd(
                self.params, x, g * 0.0, nopeek=False))
        # the update runs and its result is dropped: a zero gradient
        # still moves a respawned owner's restored Adam state (m decays)
        self._update(self.params, self.opt_state, self._grad_acc, 0)
        self._grad_acc = None
        self.endpoint.send("warmup_done", {}, seq=msg.seq)

    def handle(self, msg) -> bool:
        """Process one protocol message; returns False on ``stop``."""
        if msg.kind == "stop":
            return False
        if msg.kind == "barrier":
            self.endpoint.send("barrier_ack", {}, seq=msg.seq)
        elif msg.kind == "pull_params":
            self.endpoint.send("params_dump", {
                str(i): leaf for i, leaf in
                enumerate(tree_leaves(self.params))}, seq=msg.seq)
        elif msg.kind == "warmup":
            self._warmup(msg)
        elif msg.kind == "head_fwd":
            step = int(msg.seq)
            self._plan[step] = self._stage(msg.payload["idx"])
            if step == self.steps_done:
                self._run_fwd(step)
        elif msg.kind == "cut_gradients":
            seq = int(msg.seq)
            g = self.codec.decode(msg.payload)
            self._grad_acc = tree_add(self._grad_acc, self.head_bwd(
                self.params, self._inflight.pop(seq), g))
            self._grads_seen += 1
            if self._grads_seen == self.micro:
                # every chunk's gradient is in: the step's one update
                self.params, self.opt_state = self._update(
                    self.params, self.opt_state, self._grad_acc,
                    self.steps_done)
                self._grad_acc, self._grads_seen = None, 0
                self.steps_done += 1
                if self.steps_done in self._plan:
                    self._run_fwd(self.steps_done)
            if self.ack_steps:
                self.endpoint.send("step_done", {}, seq=seq)
        elif msg.kind == "heartbeat":
            self.endpoint.send("heartbeat_ack", {}, seq=msg.seq)
        elif msg.kind == "snapshot":
            s = int(msg.seq)
            self._snaps[s] = (self.params, self.opt_state)
            for old in sorted(self._snaps)[:-SNAPSHOTS_KEPT]:
                del self._snaps[old]
            payload = {f"p{i}": t for i, t in
                       enumerate(tree_leaves(self.params))}
            payload.update({f"o{i}": t for i, t in
                            enumerate(tree_leaves(self.opt_state))})
            self.endpoint.send("snapshot_ack", payload, seq=s)
        elif msg.kind == "rollback":
            s = int(msg.seq)
            if s not in self._snaps:
                raise RuntimeError(f"owner {self.owner.name}: no snapshot "
                                   f"for step {s}")
            self.params, self.opt_state = self._snaps[s]
            self._snaps = {s: self._snaps[s]}
            self._plan.clear()
            self._inflight.clear()
            self._grad_acc, self._grads_seen = None, 0
            self.steps_done = s
            self.endpoint.send("rollback_ack", {}, seq=s)
        else:
            raise RuntimeError(f"owner {self.owner.name}: unknown message "
                               f"kind {msg.kind!r}")
        return True

    def run(self):
        try:
            while self.handle(self.endpoint.recv()):
                pass
        except Exception as e:         # noqa: BLE001 — surfaced by the
            self.error = e             # session's receive poll


def feature_parties(scientist_ds: VerticalDataset,
                    owner_ds: Dict[str, VerticalDataset]
                    ) -> Tuple[DataScientist, List[DataOwner]]:
    """Wrap ``make_vertical_mnist_parties``-style datasets (scientist
    labels + per-owner feature slices) as party objects."""
    sci = DataScientist(scientist_ds.ids, scientist_ds.data)
    owners = [DataOwner(name, ds.ids, ds.data)
              for name, ds in owner_ds.items()]
    return sci, owners


def sequence_parties(tokens: np.ndarray, n_owners: int,
                     ids: Optional[Sequence[str]] = None,
                     with_labels: bool = True
                     ) -> Tuple[DataScientist, List[DataOwner]]:
    """Vertically partition token streams across sequence-slice owners.

    ``tokens``: (N, S+1) when ``with_labels`` (inputs ``[:, :-1]``, the
    scientist keeps next-token labels ``[:, 1:]``), else (N, S) raw
    contexts (serving: the scientist holds no labels).  Owner p receives
    the contiguous sequence slice [p*S/P, (p+1)*S/P) of every
    document."""
    tokens = np.asarray(tokens)
    if with_labels:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs, labels = tokens, None
    ids = list(ids) if ids is not None else make_ids(len(tokens), "doc")
    slices = partition_sequence(inputs, n_owners)
    owners = [DataOwner(f"owner{p}", ids, slices[p])
              for p in range(n_owners)]
    return DataScientist(ids, labels), owners
