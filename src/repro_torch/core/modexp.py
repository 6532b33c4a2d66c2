"""Modular exponentiation over packed big-int buffers — the PSI engine's
compute (a serial copy of the chunk kernels of ``repro.core.modexp``).

Elements are packed as ``nb`` big-endian bytes each (the PSI wire
encoding).  gmpy2's ``powmod`` is used when importable, CPython's
``pow`` otherwise; both give the same integers.  The worker pool of the
reference (``parallelism > 0``) is queued in ROADMAP.md.
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

try:                                    # pragma: no cover - host-dependent
    from gmpy2 import powmod as _powmod
except ImportError:
    _powmod = pow


def hash_to_group(item: bytes, prime: int, nbytes: int = 256) -> int:
    """H(x) = (sha256-derived integer mod p)^2 — lands in QR_p (order q)."""
    h = b""
    ctr = 0
    while len(h) < nbytes + 16:  # modulus size + slack for uniformity
        h += hashlib.sha256(item + ctr.to_bytes(4, "big")).digest()
        ctr += 1
    v = int.from_bytes(h, "big") % prime
    return int(_powmod(v, 2, prime))


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
    """item strings -> packed ``H(item)^exp mod p``."""
    items, exp, p, nb = task
    out = bytearray(len(items) * nb)
    for i, it in enumerate(items):
        h = hash_to_group(it.encode(), p, nb)
        out[i * nb:(i + 1) * nb] = int(_powmod(h, exp, p)).to_bytes(nb,
                                                                    "big")
    return bytes(out)
