"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066] (copy of ``repro.configs.deepseek_moe_16b``).

28 layers, d_model 2048, 16 heads (kv=16), expert hidden 1408,
vocab 102400.  Every block: attention + MoE FFN with 2 shared experts
(always on) and 64 routed experts, top-6 routing.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SplitConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mlp="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408,
                  n_shared=2, d_shared=1408),
    long_context="swa",
    long_context_window=8192,
    split=SplitConfig(n_owners=2, cut_layer=7),
)
