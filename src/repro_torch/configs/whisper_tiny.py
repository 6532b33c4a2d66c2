"""whisper-tiny — encoder-decoder with a conv frontend stub
[arXiv:2212.04356] (copy of ``repro.configs.whisper_tiny``).

4 encoder + 4 decoder layers, d_model 384, 6 heads (kv=6), d_ff 1536,
vocab 51865.  The mel-spectrogram + conv feature extractor is a stub:
owner 0 (the audio owner) supplies precomputed frame embeddings.  The
encoder is the owner head, the decoder the scientist trunk, and the
cross-attention input the cut tensor.  Whisper's decoder context is 448
tokens.
"""
from repro_torch.configs.base import ArchConfig, SplitConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=4,               # decoder layers
    n_enc_layers=4,
    enc_dec=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    mlp="gelu",
    norm="layernorm",
    rope="sincos",
    modality="audio_text",
    d_frontend=384,
    long_context="skip",
    split=SplitConfig(n_owners=1, cut_layer=4),  # head == whole encoder
)
