"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]
(copy of ``repro.configs.zamba2_2_7b``).

54 layers, d_model 2560, 32 heads (kv=32), d_ff 10240, vocab 32000,
ssm_state 64.  The repeating unit is 5 Mamba2 blocks followed by one
shared-parameter attention block (the zamba2 "shared transformer block"
applied periodically): 9 units x 6 blocks = 54 layers.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, SplitConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    mlp="gelu",
    rope="rope",
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "shared_attn"),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
    long_context="native",
    split=SplitConfig(n_owners=2, cut_layer=2),
)
