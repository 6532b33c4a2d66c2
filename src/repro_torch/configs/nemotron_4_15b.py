"""nemotron-4-15b — GQA, squared-ReLU MLP [arXiv:2402.16819] (copy of
``repro.configs.nemotron_4_15b``).

32 layers, d_model 6144, 48 heads (kv=8), d_ff 24576, vocab 256000.
LayerNorm, squared-ReLU (non-gated) MLP, rotary positions.
"""
from repro_torch.configs.base import ArchConfig, SplitConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mlp="relu2",
    norm="layernorm",
    long_context="swa",
    long_context_window=8192,
    split=SplitConfig(n_owners=2, cut_layer=8),
)
