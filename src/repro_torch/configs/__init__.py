"""Config registry of the port.

``CONFIG`` is the paper's MLP SplitNN (slice 1).  ``get_config(name,
reduced=False)`` returns an architecture config as the reference's
registry does; the port knows ``"llama3.2-3b"``, ``"zamba2-2.7b"`` and
``"gemma2-9b"`` and names the ROADMAP.md item for the reference's other
architectures.
"""
from repro_torch.configs.base import (ArchConfig, SplitConfig,  # noqa: F401
                                      SSMConfig, not_ported)
from repro_torch.configs.pyvertical_mnist import (CONFIG,  # noqa: F401
                                                  MLPSplitConfig)

#: the reference's architectures that the port does not build yet
_NOT_PORTED = ("xlstm-125m", "llama3-405b",
               "qwen2-vl-72b", "deepseek-moe-16b", "mixtral-8x7b",
               "whisper-tiny", "nemotron-4-15b")


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name == "llama3.2-3b":
        from repro_torch.configs.llama3_2_3b import CONFIG as cfg
    elif name == "zamba2-2.7b":
        from repro_torch.configs.zamba2_2_7b import CONFIG as cfg
    elif name == "gemma2-9b":
        from repro_torch.configs.gemma2_9b import CONFIG as cfg
    elif name in _NOT_PORTED:
        raise not_ported(f"the {name} config",
                         "item 8, the other architecture families")
    else:
        raise KeyError(f"unknown arch {name!r}; known: llama3.2-3b, "
                       f"zamba2-2.7b, gemma2-9b and {list(_NOT_PORTED)}")
    return cfg.reduced() if reduced else cfg
