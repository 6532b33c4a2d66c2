"""Config registry of the port.

``CONFIG`` is the paper's MLP SplitNN (slice 1).  ``get_config(name,
reduced=False)`` returns an architecture config as the reference's
registry does; the port knows every architecture of the reference's but
``"qwen2-vl-72b"`` and ``"whisper-tiny"``, for which it names the
ROADMAP.md item.
"""
import importlib

from repro_torch.configs.base import (ArchConfig, MoEConfig,  # noqa: F401
                                      SplitConfig, SSMConfig, XLSTMConfig,
                                      not_ported)
from repro_torch.configs.pyvertical_mnist import (CONFIG,  # noqa: F401
                                                  MLPSplitConfig)

_ARCH_MODULES = {
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-125m": "xlstm_125m",
    "gemma2-9b": "gemma2_9b",
    "llama3-405b": "llama3_405b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "llama3.2-3b": "llama3_2_3b",
}

#: the reference's architectures that the port does not build yet
_NOT_PORTED = ("qwen2-vl-72b", "whisper-tiny")


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name in _NOT_PORTED:
        raise not_ported(f"the {name} config",
                         "item 8, the other architecture families")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{list(_ARCH_MODULES)} and {list(_NOT_PORTED)}")
    cfg = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}").CONFIG
    return cfg.reduced() if reduced else cfg
