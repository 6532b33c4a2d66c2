"""The party-centric API: ``DataOwner`` / ``DataScientist`` objects, the
``VerticalSession`` facade over resolve / build / fit / evaluate, and the
wire underneath.

Exports are lazy (PEP 562): importing the wire-level stack
(``transport``, ``process_transport``, ``psi_transport``, ``runtime``,
``faults``) loads no torch.  The spawned PSI workers
(``runtime.psi_worker_main``) import this package on their way to the
PSI actor, and an eager ``session`` import here would load torch into
every one of them.
"""
import sys

_EXPORTS = {
    "DataOwner": "parties",
    "DataScientist": "parties",
    "OwnerComputeEndpoint": "parties",
    "PrivacyError": "parties",
    "feature_parties": "parties",
    "sequence_parties": "parties",
    "build_adapter": "registry",
    "VerticalSession": "session",
    "OwnerFailure": "supervisor",
    "Supervisor": "supervisor",
    "FrameCorrupt": "transport",
}
_SUBMODULES = ("batching", "cut_codec", "faults", "parties",
               "process_transport", "psi_transport", "registry", "runtime",
               "session", "supervisor", "transport")

__all__ = sorted(list(_EXPORTS) + list(_SUBMODULES))


def _load(sub: str):
    # the import statement's path (``__import__``), not importlib's: it
    # is the one ``python -X importtime`` reports
    full = f"{__name__}.{sub}"
    __import__(full)
    return sys.modules[full]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(_load(_EXPORTS[name]), name)
    if name in _SUBMODULES:
        return _load(name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + __all__))
