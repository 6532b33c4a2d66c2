"""llama3-405b — GQA, 128k vocab [arXiv:2407.21783] (copy of
``repro.configs.llama3_405b``).

126 layers, d_model 16384, 128 heads (kv=8), d_ff 53248, vocab 128256.
SwiGLU, RMSNorm, rope theta 500k.
"""
from repro_torch.configs.base import ArchConfig, SplitConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    mlp="swiglu",
    rope_theta=500000.0,
    zero_sharding=True,
    long_context="swa",
    long_context_window=8192,
    split=SplitConfig(n_owners=2, cut_layer=31),
)
