"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-1B family card]
(copy of ``repro.configs.llama3_2_3b``).

28 layers, d_model 3072, 24 heads (kv=8), d_ff 8192, vocab 128256.
SwiGLU, RMSNorm, rope theta 500k, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, SplitConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    mlp="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
    long_context="swa",
    long_context_window=8192,
    split=SplitConfig(n_owners=2, cut_layer=7),
)
