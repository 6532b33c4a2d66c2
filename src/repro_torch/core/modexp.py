"""Batch modular exponentiation — the PSI engine's compute backend (the
port's copy of ``repro.core.modexp``: the same kernels, integers and
packed bytes).

Every leg of the DH-PSI protocol is one modexp per element, so this is
where a large resolution spends its time.  Three layers:

  * **Scalar backend** — ``powmod`` uses gmpy2's ``powmod`` when the
    module is importable and CPython's ``pow`` otherwise; both give the
    same integers (``HAVE_GMPY2`` records which one is live).
  * **Packed chunk kernels** — ``pow_chunk`` / ``hashpow_chunk`` work on
    packed buffers (``nb`` big-endian bytes per element, the PSI wire
    encoding), which cross process boundaries as one cheap pickle.
  * **ModexpPool** — a worker pool with a bounded-lookahead ``imap``.
    ``parallelism=0`` runs the same kernels in-process; the integers are
    identical either way, so the parallel engine is bit-identical to the
    serial one by construction.  Workers start ``spawn``-ed whenever
    ``torch`` is loaded in the parent (a fork of a parent with torch's
    thread pools or a CUDA context is not safe) and ``fork``-ed from a
    light parent.  A host that cannot start workers degrades to serial
    and records why in ``fallback_reason``.

This module imports the standard library only, so spawned pool workers
stay light: they never import torch.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

try:                                    # pragma: no cover - host-dependent
    from gmpy2 import powmod as _powmod
    HAVE_GMPY2 = True
except ImportError:
    _powmod = pow
    HAVE_GMPY2 = False


def powmod(base: int, exp: int, mod: int) -> int:
    """``base ** exp % mod`` via the fastest available backend."""
    return int(_powmod(base, exp, mod))


def hash_to_group(item: bytes, prime: int, nbytes: int = 256) -> int:
    """H(x) = (sha256-derived integer mod p)^2 — lands in QR_p (order q)."""
    h = b""
    ctr = 0
    while len(h) < nbytes + 16:  # modulus size + slack for uniformity
        h += hashlib.sha256(item + ctr.to_bytes(4, "big")).digest()
        ctr += 1
    v = int.from_bytes(h, "big") % prime
    return int(_powmod(v, 2, prime))


# ---------------------------------------------------------------------------
# Packed big-int buffers
# ---------------------------------------------------------------------------


def pack_ints(xs: Sequence[int], nb: int) -> bytes:
    """Fixed-width big-endian packing — the PSI wire encoding."""
    return b"".join(x.to_bytes(nb, "big") for x in xs)


def unpack_ints(blob: bytes, nb: int) -> List[int]:
    f = int.from_bytes
    return [f(blob[i:i + nb], "big") for i in range(0, len(blob), nb)]


# ---------------------------------------------------------------------------
# Chunk kernels (top-level so pool workers import them by reference)
# ---------------------------------------------------------------------------


def pow_chunk(task: Tuple[bytes, int, int, int]) -> bytes:
    """packed elements -> packed ``el^exp mod p`` (same order)."""
    blob, exp, p, nb = task
    f = int.from_bytes
    out = bytearray(len(blob))
    for i in range(0, len(blob), nb):
        out[i:i + nb] = int(
            _powmod(f(blob[i:i + nb], "big"), exp, p)).to_bytes(nb, "big")
    return bytes(out)


def hashpow_chunk(task: Tuple[Sequence[str], int, int, int]) -> bytes:
    """item strings -> packed ``H(item)^exp mod p`` (hash fused with the
    exponentiation so the parent never hashes on the hot path)."""
    items, exp, p, nb = task
    out = bytearray(len(items) * nb)
    for i, it in enumerate(items):
        h = hash_to_group(it.encode(), p, nb)
        out[i * nb:(i + 1) * nb] = int(_powmod(h, exp, p)).to_bytes(nb,
                                                                    "big")
    return bytes(out)


# ---------------------------------------------------------------------------
# Worker pool
# ---------------------------------------------------------------------------


def _start_method() -> str:
    """``spawn`` when torch is loaded in this process (or the host has no
    ``fork``), else ``fork``."""
    import multiprocessing as mp
    import sys
    if "torch" in sys.modules or "fork" not in mp.get_all_start_methods():
        return "spawn"
    return "fork"


class ModexpPool:
    """Bounded-lookahead map over chunk kernels, optionally parallel.

    ``parallelism=0`` (or ``None``) is the serial reference: kernels run
    in-process, lazily, one task ahead of the consumer.
    ``parallelism=N`` starts N workers and keeps up to ``inflight =
    max(2 * N, 2)`` chunk tasks outstanding: the consumer (bloom adds,
    buffer appends, membership checks) runs in the parent while the
    workers exponentiate.  If the host cannot start workers the pool degrades to
    serial and records why in ``fallback_reason``; ``is_parallel`` says
    which one runs.
    """

    def __init__(self, parallelism: Optional[int] = None):
        self.parallelism = int(parallelism or 0)
        self.inflight = max(2 * self.parallelism, 2)
        self._executor = None
        self._tried = False
        self.fallback_reason: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    def _ensure_executor(self):
        if self._tried or self.parallelism <= 0:
            return self._executor
        self._tried = True
        try:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self._executor = ProcessPoolExecutor(
                max_workers=self.parallelism,
                mp_context=mp.get_context(_start_method()))
            # probe: surface a host that cannot start workers now, not
            # mid-protocol
            self._executor.submit(pow_chunk,
                                  (b"\x02", 3, 251, 1)).result(timeout=60)
        except Exception as e:              # noqa: BLE001 — any failure
            self.fallback_reason = f"{type(e).__name__}: {e}"
            if self._executor is not None:
                self._executor.shutdown(wait=False)
            self._executor = None
        return self._executor

    @property
    def is_parallel(self) -> bool:
        return self._ensure_executor() is not None

    def close(self):
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the one primitive -------------------------------------------------
    def imap(self, kernel, tasks: Iterable[tuple]) -> Iterator[bytes]:
        """Yield ``kernel(task)`` for each task **in task order**, with at
        most ``self.inflight`` tasks submitted ahead of the consumer.
        Tasks are pulled from the (possibly lazy) iterable only as the
        lookahead permits, so chained ``imap`` stages form a streaming
        pipeline with bounded peak memory."""
        ex = self._ensure_executor()
        it = iter(tasks)
        if ex is None:
            for task in it:
                yield kernel(task)
            return
        from collections import deque
        pending: deque = deque()
        try:
            for task in it:
                pending.append(ex.submit(kernel, task))
                if len(pending) >= self.inflight:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()
