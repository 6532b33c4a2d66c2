"""The paper's §3.1 data-resolution protocol for 2+ data owners (the
port's copy of ``repro.core.resolution``).

The data scientist runs PSI independently with each data owner (as the
PSI client, so only the scientist learns each pairwise intersection),
computes the global intersection, and broadcasts it.  Data owners never
communicate and never learn of each other.  Each party then discards
non-shared rows and sorts by ID, so element n of every vertical dataset
belongs to the same data subject.

One :class:`~repro_torch.core.psi.PSIClient` serves every owner round:
its blinded upload is computed once and reused.  ``parallelism`` starts
that many modexp workers shared across all rounds; ``chunk_size`` bounds
the in-flight working set.  Results are bit-identical for every
(parallelism, chunk_size).  ``VerticalSession.resolve`` is the party
API over the same rounds (with the wire backends and retries).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.modexp import ModexpPool
from repro_torch.core.psi import (DEFAULT_CHUNK, DEFAULT_MODE, PSIClient,
                                  PSIServer, psi_round)


@dataclass
class VerticalDataset:
    """One party's vertically-partitioned data: rows keyed by unique IDs."""

    ids: List[str]
    data: np.ndarray          # (n_rows, ...) — features or labels

    def __post_init__(self):
        if len(self.ids) != len(self.data):
            raise ValueError("ids/data length mismatch")
        if len(set(self.ids)) != len(self.ids):
            raise ValueError("IDs must be unique")

    def filter_and_sort(self, keep_ids: Sequence[str]) -> "VerticalDataset":
        """Discard non-shared rows; sort by ID (the paper's alignment)."""
        keep = set(keep_ids)
        order = [i for i, d in enumerate(self.ids) if d in keep]
        order.sort(key=lambda i: self.ids[i])
        return VerticalDataset([self.ids[i] for i in order],
                               self.data[order])


def resolve(scientist: VerticalDataset,
            owners: Dict[str, VerticalDataset],
            fp_rate: float = 1e-9, group: str = "modp2048", *,
            mode: str = DEFAULT_MODE,
            chunk_size: int = DEFAULT_CHUNK,
            parallelism: int = 0,
            pool: Optional[ModexpPool] = None):
    """Run the full protocol.  Returns (aligned_scientist,
    {owner: aligned_dataset}, stats).

    After resolution every returned dataset has identical ``ids`` in
    identical order — the invariant SplitNN training relies on.
    ``parallelism``/``chunk_size`` tune the PSI engine (see module
    docstring); the default is the serial in-process engine.
    """
    own_pool = pool is None
    pool = pool or ModexpPool(parallelism)
    try:
        client = PSIClient(scientist.ids, group,
                           mode=mode)              # ONE client, all owners
        pairwise = {}
        stats = {"rounds": [], "global_intersection": 0,
                 "mode": mode, "parallelism": pool.parallelism,
                 "chunk_size": chunk_size}
        for name, ds in owners.items():
            server = PSIServer(ds.ids, fp_rate, group)
            inter, rstats = psi_round(client, server, pool=pool,
                                      chunk_size=chunk_size)
            # effective engine parallelism (0 on fork-fallback hosts)
            stats["parallelism"] = rstats["parallelism"]
            pairwise[name] = set(inter)
            stats["rounds"].append({
                "owner": name,
                "intersection_size": len(inter),
                **{k: rstats[k] for k in
                   ("client_upload_bytes", "server_response_bytes",
                    "n_chunks", "blind_cached")},
                **({"bloom_bytes": rstats["bloom_bytes"],
                    "bloom_shards": rstats["bloom_shards"]}
                   if mode == "bloom" else
                   {"server_set_bytes": rstats["server_set_bytes"]}),
            })
    finally:
        if own_pool:
            pool.close()

    global_ids = set(scientist.ids)
    for s in pairwise.values():
        global_ids &= s
    stats["global_intersection"] = len(global_ids)

    aligned_scientist = scientist.filter_and_sort(global_ids)
    aligned_owners = {name: ds.filter_and_sort(global_ids)
                      for name, ds in owners.items()}

    # invariant: identical ID order everywhere
    for name, ds in aligned_owners.items():
        if ds.ids != aligned_scientist.ids:
            raise RuntimeError(f"misaligned owner {name}")
    return aligned_scientist, aligned_owners, stats
