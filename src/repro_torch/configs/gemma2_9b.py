"""gemma2-9b — local+global alternating attention, logit softcaps
[arXiv:2408.00118] (copy of ``repro.configs.gemma2_9b``).

42 layers, d_model 3584, 16 heads (kv=8, head_dim 256), d_ff 14336,
vocab 256000.  GeGLU MLP, RMSNorm pre+post, attention-logit softcap 50,
final-logit softcap 30, 4096-token sliding window on local layers.
"""
from repro_torch.configs.base import ArchConfig, SplitConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    mlp="geglu",
    post_block_norm=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    swa_window=4096,
    tie_embeddings=True,
    block_pattern=("attn:local", "attn:global"),
    # local/SWA layers are native; long_500k runs with global layers
    # falling back to the sliding window (native-ish long-context story).
    long_context="native",
    long_context_window=4096,
    split=SplitConfig(n_owners=2, cut_layer=5),
)
