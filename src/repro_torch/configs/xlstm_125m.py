"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517] (copy of
``repro.configs.xlstm_125m``).

12 layers, d_model 768, 4 heads (kv=4), no separate FFN (d_ff=0: xLSTM
blocks carry their own up/down projections), vocab 50304.  Alternating
sLSTM/mLSTM units.
"""
from repro_torch.configs.base import ArchConfig, SplitConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    mlp="none",
    norm="layernorm",
    rope="none",
    block_pattern=("slstm", "mlstm"),
    xlstm=XLSTMConfig(),
    long_context="native",
    split=SplitConfig(n_owners=2, cut_layer=1),
)
