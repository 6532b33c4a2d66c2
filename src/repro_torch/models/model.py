"""SplitModel — the paper's multi-headed SplitNN wrapped around a text
language model (the port's counterpart of ``repro.models.model``).

The network (``cfg.n_superblocks`` super-blocks) is split by layer: each
of ``cfg.split.n_owners`` data owners runs an identical *head segment*
(embedding + ``cut_layer`` super-blocks) on its private slice of the
sequence (owner p holds positions [p*S/P, (p+1)*S/P)); the data
scientist combines the cut-layer activations (concat along the sequence
| sum | mean | max) and runs the *trunk segment* (remaining super-blocks
+ final norm + LM head).

Head params are stacked on a leading owner dim, as in the reference; the
port runs the owners' heads one after the other.  The reference's
quirks are kept: ``decode_heads``/``decode_step`` run every owner's head
on the new token and keep owner 0's cut (so every head cache advances);
a decode token's head rope position is ``owner + pos_local``; every
owner's Mamba2 state advances on the decode token too; left-pad tokens
flow through the Mamba2 state unmasked; the LM
head is its own matrix even with ``tie_embeddings``; the logits are
computed in f32.

Training: ``forward`` returns ``(logits, aux)`` and ``loss_fn`` the
objective ``ce + aux`` with ``{"loss": ce, "aux": aux}``, as in the
reference; ``ce_loss`` is the causal LM loss (labels -100 are masked).
``aux`` is the blocks' auxiliary loss (the MoE FFN's balance loss; an
f32 zero for every other family): ``heads_forward`` sums it over the
owners, ``forward`` adds the trunk's, as in the reference.  Attention
under autograd runs the kernel forward and a backward of plain products
(``kernels.block_attention.attention_fn``).

``SplitConfig.cut_dim > 0`` puts a bottleneck at the cut: each head ends
in ``cut_proj`` (d_model -> cut_dim) and the trunk starts with
``in_proj`` (cut_dim -> d_model), so the cut is ``(..., self.k)``.
``cut_noise_std > 0`` adds Gaussian noise in the combine when
``forward`` (or ``combine``) is given a ``torch.Generator``; serving
never adds it, as in the reference.

The decode programs take a position as an int (every row at one
position: the wave engine) or as one position per batch row (continuous
batching: a (B,) int array or CPU tensor, or a
:class:`~repro_torch.models.attention.RowPositions`).

KV cache variants (as in the reference): ``cache_init(ring=True)``
trims sliding-window layers' caches to ring buffers of their window,
``swa_override`` (on ``cache_init`` and every forward, prefill and
decode program) runs ``attn:global`` and ``shared_attn`` as
sliding-window attention with that window, and ``cache_dtype`` stores
the KV caches in another dtype (``torch.float8_e4m3fn``: half the bytes
of bf16).

Only the text modality is ported; the vision/audio modalities and the
encoder-decoder raise.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, not_ported
from repro_torch.core.privacy import gaussian_cut_noise
from repro_torch.models import layers, transformer
from repro_torch.models.attention import RowPositions
from repro_torch.tree import stack_draws, tree_map

Params = Dict[str, Any]


def _cdtype(cfg) -> torch.dtype:
    return layers.dtype_of(cfg.compute_dtype)


class SplitModel:
    def __init__(self, cfg: ArchConfig):
        if cfg.modality != "text" or cfg.enc_dec:
            raise not_ported(f"the {cfg.modality} modality / enc-dec",
                             "item 8, the other architecture families")
        if cfg.param_dtype != "float32":
            raise ValueError("the port keeps params in float32")
        self.cfg = cfg
        sp = cfg.split
        self.P = sp.n_owners
        n_units = cfg.n_superblocks
        cut = min(max(sp.cut_layer, 1), n_units - 1)
        self.n_head_units = cut
        self.n_trunk_units = n_units - cut
        self.k = sp.cut_dim if sp.cut_dim > 0 else cfg.d_model
        self.cdtype = _cdtype(cfg)

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen``'s device, drawn from ``gen``: dense
        weights N(0, 1/d_in), embeddings and the LM head N(0, 0.02^2),
        norms zero (the reference's distributions; not its draws).  With
        ``cut_dim > 0`` each head gains ``cut_proj`` and the trunk
        ``in_proj``."""
        cfg = self.cfg
        bottleneck = cfg.split.cut_dim > 0

        def head_one():
            hp = {"blocks": transformer.stack_init(
                gen, cfg, self.n_head_units),
                "embed": layers.embed_init(gen, cfg.vocab, cfg.d_model)}
            if bottleneck:
                hp["cut_proj"] = layers.dense_init(gen, cfg.d_model, self.k)
            return hp

        heads = stack_draws(head_one, self.P)
        trunk: Params = {"blocks": transformer.stack_init(
            gen, cfg, self.n_trunk_units)}
        if bottleneck:
            trunk["in_proj"] = layers.dense_init(gen, self.k, cfg.d_model)
        trunk["out_norm"] = layers.norm_init(cfg.d_model, cfg.norm,
                                             gen.device)
        trunk["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                             scale=0.02)
        return {"heads": heads, "trunk": trunk}

    # ------------------------------------------------------------ head pass

    def _positions(self, S_p: int, owner: int, offset=0, device="cpu"):
        """Global positions of owner ``owner``'s slice (rope input): (S_p,)
        for an int ``offset``, (B, S_p) for per-row positions."""
        if self.cfg.rope == "mrope":
            raise not_ported("M-RoPE positions", "item 8")
        base = owner * S_p + torch.arange(S_p, device=device)
        if isinstance(offset, RowPositions):
            return offset.dev[:, None] + base
        return offset + base

    def _head_one(self, hp, owner_inputs, positions, caches=None, pos=None,
                  swa_override=None):
        """One owner's head: (cut, caches, aux)."""
        cfg = self.cfg
        x = layers.embed_apply(hp["embed"], owner_inputs, _cdtype(cfg))
        if cfg.rope == "sincos":
            raise not_ported("sin-cos positions", "item 8")
        x, caches, aux = transformer.stack_apply(
            hp["blocks"], x, cfg=cfg, positions=positions, caches=caches,
            pos=pos, swa_override=swa_override)
        if cfg.split.cut_dim > 0:
            x = layers.dense_apply(hp["cut_proj"], x)
        return x, caches, aux

    def heads_forward(self, heads, owner_inputs, *, caches=None, pos=None,
                      swa_override=None):
        """owner_inputs: (P, B, S_p) token ids.  Returns (cut (P, B, S_p,
        k), caches, aux): the head caches (leaves (P, n_units, ...)) are
        updated in place; ``aux`` is the owners' auxiliary losses summed
        in owner order."""
        S_p = owner_inputs.shape[-1]
        cuts, aux = [], None
        for p in range(self.P):
            positions = self._positions(S_p, p, 0 if pos is None else pos,
                                        owner_inputs.device)
            hc = None if caches is None else transformer.unit(caches, p)
            cut, _, a = self._head_one(transformer.unit(heads, p),
                                       owner_inputs[p], positions, hc, pos,
                                       swa_override)
            cuts.append(cut)
            aux = a if aux is None else aux + a
        return torch.stack(cuts), caches, aux

    # ------------------------------------------------------------- combine

    def combine(self, cut, gen=None):
        """The paper's cut-layer combine (data-scientist side).

        cut: (P, B, S_p, k).  concat: along the sequence (ID-aligned
        order) -> (B, S, k); sum/mean/max: elementwise across owners ->
        (B, S_p, k).  With ``cut_noise_std > 0`` and a generator ``gen``
        (on the cut's device), N(0, cut_noise_std^2) noise in the cut's
        dtype is added to every owner's cut first (the reference draws it
        from a JAX key: the same distribution, not the same draws)."""
        sp = self.cfg.split
        if sp.cut_noise_std > 0.0 and gen is not None:
            cut = gaussian_cut_noise(gen, cut, sp.cut_noise_std)
        P, B, S_p, k = cut.shape
        if sp.combine == "concat":
            return cut.permute(1, 0, 2, 3).reshape(B, P * S_p, k)
        if sp.combine == "sum":
            return cut.sum(0)
        if sp.combine == "mean":
            return cut.mean(0)
        if sp.combine == "max":
            return cut.amax(0)
        raise ValueError(sp.combine)

    # ---------------------------------------------------------- trunk pass

    def trunk_forward(self, trunk, z, *, caches=None, pos=None,
                      swa_override=None):
        """z: combined cut (B, S, k).  Returns (logits (B, S, vocab) f32,
        caches, aux)."""
        cfg = self.cfg
        if cfg.split.cut_dim > 0:
            z = layers.dense_apply(trunk["in_proj"], z)
        S = z.shape[1]
        positions = torch.arange(S, device=z.device)
        if isinstance(pos, RowPositions):
            positions = pos.dev[:, None] + positions
        elif pos is not None:
            positions = pos + positions
        x, caches, aux = transformer.stack_apply(
            trunk["blocks"], z, cfg=cfg, positions=positions, caches=caches,
            pos=pos, swa_override=swa_override)
        x = layers.norm_apply(trunk["out_norm"], x, cfg.norm, cfg.norm_eps)
        logits = layers.dense_apply(trunk["lm_head"], x.to(torch.float32))
        logits = layers.softcap(logits, cfg.logit_softcap)
        return logits, caches, aux

    # ------------------------------------------------------------- forward

    def split_owner_inputs(self, batch):
        """Vertical partition of a global batch into per-owner slices."""
        if "owner_tokens" in batch:                   # pre-partitioned (P,B,S_p)
            return batch["owner_tokens"]
        t = batch["tokens"]                           # (B, S)
        B, S = t.shape
        return t.reshape(B, self.P, S // self.P).permute(1, 0, 2)

    def forward(self, params, batch, gen=None, *, swa_override=None):
        """Full-sequence forward (train / prefill without a cache).
        Returns ``(logits (B, S, vocab) f32, aux)``: the heads' aux
        summed over owners plus the trunk's.  ``gen``: the cut noise's
        generator (see :meth:`combine`)."""
        cut, _, aux_h = self.heads_forward(params["heads"],
                                           self.split_owner_inputs(batch),
                                           swa_override=swa_override)
        z = self.combine(cut.to(self.cdtype), gen=gen)
        logits, _, aux_t = self.trunk_forward(params["trunk"], z,
                                              swa_override=swa_override)
        return logits, aux_h + aux_t

    @staticmethod
    def ce_loss(logits, labels):
        """Causal LM loss: the mean over valid positions (labels >= 0;
        -100 is masked) of ``logsumexp(logits) - logits[label]``, the
        label logit picked with a vocabulary comparison, as the
        reference does."""
        valid = labels >= 0
        lab = torch.where(valid, labels, 0)
        lse = torch.logsumexp(logits, dim=-1)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        label_logit = torch.where(vocab == lab[..., None], logits,
                                  0.0).sum(-1)
        ll = label_logit - lse
        n = valid.sum().clamp(min=1)
        return -(ll * valid).sum() / n

    def loss_fn(self, params, batch, gen=None, *, swa_override=None):
        """``(ce + aux, {"loss": ce, "aux": aux})``."""
        logits, aux = self.forward(params, batch, gen=gen,
                                   swa_override=swa_override)
        loss = self.ce_loss(logits, batch["labels"])
        return loss + aux, {"loss": loss, "aux": aux}

    # ------------------------------------------------------------ serving

    def cache_init(self, batch_size: int, s_max: int, n_new: int = 8,
                   device="cpu", *, ring: bool = False,
                   swa_override: int = 0, cache_dtype=None):
        """Decode caches: KV caches in ``cache_dtype`` (a torch dtype or
        its name, e.g. ``torch.float8_e4m3fn``; default the compute
        dtype), Mamba2 caches (conv window, SSM state) in f32 whatever it
        is, as in the reference.  The trunk cache covers the combined
        sequence; head caches (stacked over owners) cover each owner's
        slice + room for generated tokens.  ``ring`` / ``swa_override``:
        see ``transformer.stack_cache_init``."""
        cfg = self.cfg
        dt = _cdtype(cfg)
        if cache_dtype is not None:
            dt = (layers.dtype_of(cache_dtype)
                  if isinstance(cache_dtype, str) else cache_dtype)
        kw = dict(ring=ring, swa_override=swa_override)
        s_head = s_max // self.P + n_new
        one = transformer.stack_cache_init(
            batch_size, cfg, self.n_head_units, s_head, dt, device, **kw)
        heads = tree_map(
            lambda a: a[None].repeat((self.P,) + (1,) * a.dim()), one)
        trunk = transformer.stack_cache_init(
            batch_size, cfg, self.n_trunk_units, s_max + n_new, dt, device,
            **kw)
        return {"heads": heads, "trunk": trunk}

    def prefill(self, params, batch, caches, *, swa_override=None):
        """Process the full context, filling the caches.  Returns
        (last-token logits, caches)."""
        cut, hc, _ = self.heads_forward(params["heads"],
                                        self.split_owner_inputs(batch),
                                        caches=caches["heads"], pos=0,
                                        swa_override=swa_override)
        logits, tc, _ = self.trunk_forward(
            params["trunk"], self.combine(cut), caches=caches["trunk"],
            pos=0, swa_override=swa_override)
        return logits[:, -1], {"heads": hc, "trunk": tc}

    # ------------------------------------------- per-segment serving programs
    #
    # prefill/decode_step run heads + trunk as one program.  When the
    # engine serves through a transport-backed boundary it uses these
    # halves instead, so the cut activations are a real wire payload.

    def prefill_heads(self, heads, owner_inputs, head_caches, *,
                      swa_override=None):
        """Owner side of prefill: (cut (P, B, S_p, k), head caches)."""
        cut, hc, _ = self.heads_forward(heads, owner_inputs,
                                        caches=head_caches, pos=0,
                                        swa_override=swa_override)
        return cut, hc

    def prefill_trunk(self, trunk, cut, trunk_caches, *, swa_override=None):
        """Scientist side of prefill: combine the received cut and run
        the trunk.  Returns (last-token logits, trunk caches)."""
        logits, tc, _ = self.trunk_forward(trunk, self.combine(cut),
                                           caches=trunk_caches, pos=0,
                                           swa_override=swa_override)
        return logits[:, -1], tc

    def decode_heads(self, heads, token, head_caches, pos_local, *,
                     swa_override=None):
        """Owner side of one decode step: the generation owner's cut
        slice (B, 1, k) plus updated head caches.  ``pos_local``: an int,
        or one position per row (see the module docstring)."""
        pos_local = RowPositions.of(pos_local, token.device)
        oi = token[None].expand((self.P,) + tuple(token.shape))
        cut, hc, _ = self.heads_forward(heads, oi, caches=head_caches,
                                        pos=pos_local,
                                        swa_override=swa_override)
        return cut[0], hc

    def decode_trunk(self, trunk, z, trunk_caches, pos, *,
                     swa_override=None):
        pos = RowPositions.of(pos, z.device)
        logits, tc, _ = self.trunk_forward(trunk, z, caches=trunk_caches,
                                           pos=pos,
                                           swa_override=swa_override)
        return logits[:, -1], tc

    def decode_step(self, params, caches, token, pos, pos_local, *,
                    swa_override=None):
        """One new token (B, 1).  The generation owner is owner 0.
        ``pos``: global position in the combined sequence;
        ``pos_local``: position within owner 0's slice/cache; each an
        int, or one position per row."""
        z, hc = self.decode_heads(params["heads"], token, caches["heads"],
                                  pos_local, swa_override=swa_override)
        logits, tc = self.decode_trunk(params["trunk"], z, caches["trunk"],
                                       pos, swa_override=swa_override)
        return logits, {"heads": hc, "trunk": tc}
