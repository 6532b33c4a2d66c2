"""Configuration dataclasses (copies of ``repro.configs.base``'s
``SplitConfig``, ``MoEConfig``, ``SSMConfig``, ``XLSTMConfig`` and
``ArchConfig``).

``SplitConfig``: ``n_owners`` data owners each hold a vertical slice of
the inputs of the same data subjects.  Each owner runs ``cut_layer``
blocks (its head segment) locally; the data scientist combines head
outputs at the cut layer and runs the remaining blocks (the trunk
segment).  The privacy fields (NoPeek, cut noise, the cut-gradient
defences) train on the MLP SplitNN; the LM trains and serves with a
``cut_dim`` bottleneck and cut noise.

``ArchConfig``: one architecture, field for field as in the reference.
The port builds every family of the reference's: the dense attention
family, the MoE FFN (``moe``: a :class:`MoEConfig`), the Mamba2 hybrid
(``ssm``: an :class:`SSMConfig`), the xLSTM blocks (``xlstm``: an
:class:`XLSTMConfig`), the encoder-decoder (``enc_dec``: whisper) and
the vision-text modality with M-RoPE (qwen2-vl).
``ArchConfig.param_count`` is the reference's analytic count.

``ShapeConfig``: one input shape (sequence length, global batch, and
the step it drives: ``train``, ``prefill`` or ``decode``); ``SHAPES``
holds the reference's four.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SplitConfig:
    n_owners: int = 2
    cut_layer: int = 1             # number of blocks in each owner head
    combine: str = "concat"        # concat | sum | mean | max
    cut_dim: int = 0               # 0 = keep d_model (exact); >0 = bottleneck
    owner_lr: float = 0.01         # paper Appendix B
    scientist_lr: float = 0.1      # paper Appendix B
    cut_noise_std: float = 0.0
    nopeek_weight: float = 0.0
    grad_noise_std: float = 0.0
    grad_norm_mode: str = "none"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    n_experts: int
    top_k: int
    d_expert: int              # hidden dim of a single routed expert
    n_shared: int = 0          # always-on shared experts (DeepSeekMoE)
    d_shared: int = 0          # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # tokens are dispatched within G groups (group-local capacity);
    # 1 = one global dispatch
    dispatch_groups: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block configuration."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # SSD head dim (P in the SSD paper)
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (sLSTM + mLSTM)."""

    m_proj_factor: float = 2.0    # mLSTM up-projection factor
    s_proj_factor: float = 4.0 / 3.0  # sLSTM FFN projection factor
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    source: str                    # citation for the config
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    post_block_norm: bool = False  # gemma2 pre+post norms
    mlp: str = "swiglu"            # swiglu | geglu | gelu | relu2 | none
    rope: str = "rope"             # rope | mrope | sincos | none
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0      # gemma2 attention logit soft-capping
    logit_softcap: float = 0.0     # gemma2 final logit soft-capping
    swa_window: int = 4096
    tie_embeddings: bool = False

    # the repeating unit of blocks; n_layers is a multiple of its length
    block_pattern: Tuple[str, ...] = ("attn:global",)

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_bidirectional: bool = True

    modality: str = "text"         # text | vision_text | audio_text
    d_frontend: int = 0

    long_context: str = "swa"
    long_context_window: int = 8192

    split: SplitConfig = field(default_factory=SplitConfig)

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    zero_sharding: bool = False
    remat: bool = True             # checkpoint each stack unit in training

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.enc_dec:
            if self.n_enc_layers <= 0:
                raise ValueError("enc_dec arch needs n_enc_layers")
        elif self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"block pattern of length {len(self.block_pattern)}")

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def with_split(self, **kw) -> "ArchConfig":
        """This config with the given ``SplitConfig`` fields replaced."""
        return dataclasses.replace(
            self, split=dataclasses.replace(self.split, **kw))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """The smoke-test variant: same family/block pattern, tiny dims."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kw = dict(
            n_layers=len(self.block_pattern) if not self.enc_dec else 2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, n_heads),
            head_dim=max(d_model // n_heads, 16),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            swa_window=64,
            long_context_window=128,
            zero_sharding=False,
        )
        if self.enc_dec:
            kw["n_enc_layers"] = 2
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 128),
                d_shared=min(self.moe.d_shared, 128) if self.moe.d_shared
                else 0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, chunk_size=32)
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic parameter count (approximate: norms
        and biases are left out).  ``active_only`` counts only the
        routed experts a token uses (top_k of n_experts), the MoE
        "active parameters" convention."""
        d, v = self.d_model, self.vocab
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += v * d                  # lm head
        per_layer = {}

        def attn_params():
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def mlp_params(d_ff):
            if self.mlp in ("swiglu", "geglu"):
                return 3 * d * d_ff
            return 2 * d * d_ff

        for kind in set(self.block_pattern):
            if kind.startswith("attn") or kind == "shared_attn":
                p = attn_params()
                if self.moe is not None:
                    e = self.moe
                    routed = e.top_k if active_only else e.n_experts
                    p += routed * 3 * d * e.d_expert
                    p += e.n_shared * 3 * d * max(e.d_shared, e.d_expert)
                    p += d * e.n_experts    # router
                elif self.d_ff:
                    p += mlp_params(self.d_ff)
            elif kind == "mamba2":
                s = self.ssm
                d_in = s.expand * d
                p = d * (2 * d_in + 2 * s.n_groups * s.d_state) + d_in * d
                p += d_in                   # dt, A, D (order-d_in terms)
            elif kind in ("slstm", "mlstm"):
                x = self.xlstm
                f = x.m_proj_factor if kind == "mlstm" else x.s_proj_factor
                d_in = int(f * d)
                p = 2 * d * d_in + d_in * d + 4 * d_in * d_in // 4
            else:
                raise ValueError(kind)
            per_layer[kind] = p

        shared_counted = False
        for kind in self.block_pattern:
            if kind == "shared_attn":
                if not shared_counted:      # one set, shared by every use
                    total += per_layer[kind]
                    shared_counted = True
            else:
                total += self.n_superblocks * per_layer[kind]
        if self.enc_dec:
            # decoder layers: self-attention, cross-attention, MLP
            total += self.n_layers * (2 * attn_params()
                                      + mlp_params(self.d_ff))
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
