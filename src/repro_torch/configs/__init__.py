"""Config registry of the port.

``CONFIG`` is the paper's MLP SplitNN (slice 1).  ``get_config(name,
reduced=False)`` returns an architecture config as the reference's
registry does, and ``list_archs()`` names every architecture, in the
reference's order.  ``get_shape(name)`` returns one of the reference's
four input shapes (``SHAPES``).
"""
import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, ArchConfig,
    MoEConfig, ShapeConfig, SplitConfig, SSMConfig, XLSTMConfig)
from repro_torch.configs.pyvertical_mnist import (CONFIG,  # noqa: F401
                                                  MLPSplitConfig)

_ARCH_MODULES = {
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-125m": "xlstm_125m",
    "gemma2-9b": "gemma2_9b",
    "llama3-405b": "llama3_405b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-tiny": "whisper_tiny",
    "nemotron-4-15b": "nemotron_4_15b",
    "llama3.2-3b": "llama3_2_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    cfg = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}").CONFIG
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
