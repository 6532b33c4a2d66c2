"""mixtral-8x7b — 8 experts top-2, sliding-window attention
[arXiv:2401.04088] (copy of ``repro.configs.mixtral_8x7b``).

32 layers, d_model 4096, 32 heads (kv=8), expert hidden 14336,
vocab 32000.  All layers use a 4096-token sliding window.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SplitConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    mlp="swiglu",
    swa_window=4096,
    block_pattern=("attn:local",),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
    long_context="native",
    long_context_window=4096,
    split=SplitConfig(n_owners=2, cut_layer=8),
)
