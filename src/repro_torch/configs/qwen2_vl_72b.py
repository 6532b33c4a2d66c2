"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191] (copy of
``repro.configs.qwen2_vl_72b``).

80 layers, d_model 8192, 64 heads (kv=8), d_ff 29568, vocab 152064.
The vision frontend (ViT + merger) is a stub: owner 0 supplies
precomputed patch embeddings (d_frontend=1280), which its head projects
to d_model; owner 1 supplies text tokens.  M-RoPE: rotary positions in
3 sections (t, h, w).
"""
from repro_torch.configs.base import ArchConfig, SplitConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mlp="swiglu",
    rope="mrope",
    rope_theta=1000000.0,
    modality="vision_text",
    d_frontend=1280,
    zero_sharding=True,
    long_context="swa",
    long_context_window=8192,
    split=SplitConfig(n_owners=2, cut_layer=20),
)
