"""SplitModel — the paper's multi-headed SplitNN wrapped around a
language model (the port's counterpart of ``repro.models.model``).

The network (``cfg.n_superblocks`` super-blocks) is split by layer: each
of ``cfg.split.n_owners`` data owners runs an identical *head segment*
(embedding + ``cut_layer`` super-blocks) on its private vertical slice
of the input; the data scientist combines the cut-layer activations
(concat along the sequence | sum | mean | max) and runs the *trunk
segment* (remaining super-blocks + final norm + LM head).

Vertical-partition semantics per modality, as in the reference:

  text         owner p holds sequence slice [p*S/P, (p+1)*S/P)
  vision_text  owner 0 holds patch embeddings (the ViT is a stub; its
               head projects them with ``front_proj``), owner 1 text
               tokens; ``batch = {"patches", "tokens"}``
  audio_text   owner 0 holds frame embeddings (the conv stem is a stub);
               the head is the whisper encoder, the trunk the whisper
               decoder over ``batch["tokens"]``, cross-attending the cut
               (enc-dec is a SplitNN); ``batch = {"frames", "tokens"}``

Head params are stacked on a leading owner dim, as in the reference; the
port runs the owners' heads one after the other.  The reference's
quirks are kept: ``decode_heads``/``decode_step`` run every owner's head
on the new token and keep owner 0's cut (so every head cache advances);
a decode token's head rope position is ``owner + pos_local``; every
owner's Mamba2 state advances on the decode token too; left-pad tokens
flow through the Mamba2 state unmasked; the LM
head is its own matrix even with ``tie_embeddings``; the logits are
computed in f32.  Of the other modalities:

* both vision owners hold ``embed`` and ``front_proj`` (a stackable
  structure), owner 0 uses only the first, owner 1 only the second;
* vision owner 0's M-RoPE positions are a synthetic square grid
  ``(t=0, h, w)`` of side ``int(sqrt(S_p))`` that ignores the offset;
  owner 1 and the trunk rotate by ``[base]*3`` (owner 1's base starts
  at ``S_p``); the cut is stacked when the owners' shapes agree, a list
  (concat only) otherwise;
* a vision decode step routes the token through owner 1's head alone:
  its rope position is the global ``pos``, its cache is written at
  ``pos_local``; the patches' head cache stays as the prefill left it;
* the audio head keeps no cache (``cache_init`` gives ``None``); the
  caches' ``enc`` is a ``(B, s_max // 2, k)`` placeholder that prefill
  replaces with the encoder's output, which every decode step
  cross-attends, projecting its K and V again each time (no cross-KV
  cache, as in the reference);
* sin-cos positions are added at the embeddings: the encoder's from
  ``pos`` (0 at prefill), the decoder's from ``pos``.

``param_specs()`` is ``init``'s tree as ``meta`` tensors (nothing is
allocated or drawn).  The reference's sharding constraints are called at
its four sites (``sharding.specs.constrain``: the stacked cut, the
combined cut, the trunk's last hidden state and the logits), and the
combined cut of ``prefill`` too: no-ops without a sharding context and
on a step builder's one-device mesh; on the dry-run's DTensors they
place the activation.  There the heads run owner-parallel: with the
owner dim over "pod", each pod runs its own owners' heads
(``sharding.dtensor.owners``), so only the cut crosses the party
boundary; a trunk replicated over the pods runs on its pod
(``sharding.dtensor.on_pod``).

The vision and audio modalities take int positions only (no engine of
the reference drives them per row): a per-row position raises
``ValueError``.

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

The text modality's decode programs take a position as an int (every
row at one position: the wave engine) or as one position per batch row
(continuous batching: a (B,) int array or CPU tensor, or a
:class:`~repro_torch.models.attention.RowPositions`).

KV cache variants (as in the reference): ``cache_init(ring=True)``
trims sliding-window layers' caches to ring buffers of their window,
``swa_override`` (on ``cache_init`` and every forward, prefill and
decode program) runs ``attn:global``, ``shared_attn`` and ``dec`` as
sliding-window attention with that window, and ``cache_dtype`` stores
the KV caches in another dtype (``torch.float8_e4m3fn``: half the bytes
of bf16).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.privacy import gaussian_cut_noise
from repro_torch.models import layers, transformer
from repro_torch.models.attention import RowPositions
from repro_torch.sharding.dtensor import (first_tensor, on_pod, one_owner,
                                          owner_cuts, owners, pod_local,
                                          site, stack_owners)
from repro_torch.sharding.specs import constrain
from repro_torch.tree import stack_draws, tree_map

Params = Dict[str, Any]


def _cdtype(cfg) -> torch.dtype:
    return layers.dtype_of(cfg.compute_dtype)


def _int_pos(pos):
    """A vision or audio program's position: None or one int for every
    row."""
    if pos is None or isinstance(pos, (int, np.integer)):
        return pos
    raise ValueError("the vision and audio modalities take one int "
                     "position for every row, not per-row positions")


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: ``init``
    with it allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


class SplitModel:
    def __init__(self, cfg: ArchConfig):
        if cfg.param_dtype != "float32":
            raise ValueError("the port keeps params in float32")
        self.cfg = cfg
        sp = cfg.split
        self.P = sp.n_owners
        if cfg.enc_dec:
            self.n_head_units = cfg.n_enc_layers     # encoder layers
            self.n_trunk_units = cfg.n_layers
            self.head_pattern = ("attn:global",)     # bidir: stack_apply
            self.trunk_pattern = ("dec",)
        else:
            n_units = cfg.n_superblocks
            cut = min(max(sp.cut_layer, 1), n_units - 1)
            self.n_head_units = cut
            self.n_trunk_units = n_units - cut
            self.head_pattern = self.trunk_pattern = cfg.block_pattern
        self.k = sp.cut_dim if sp.cut_dim > 0 else cfg.d_model
        self.cdtype = _cdtype(cfg)

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen``'s device, drawn from ``gen``: dense
        weights N(0, 1/d_in), embeddings and the LM head N(0, 0.02^2),
        norms zero (the reference's distributions; not its draws).  Each
        head holds ``embed`` (text, vision) and ``front_proj`` (vision,
        audio); the enc-dec trunk holds the decoder's ``embed``.  With
        ``cut_dim > 0`` each head gains ``cut_proj`` and the trunk
        ``in_proj``."""
        cfg = self.cfg
        bottleneck = cfg.split.cut_dim > 0

        def head_one():
            hp = {"blocks": transformer.stack_init(
                gen, cfg, self.n_head_units, self.head_pattern)}
            if cfg.modality in ("text", "vision_text"):
                hp["embed"] = layers.embed_init(gen, cfg.vocab, cfg.d_model)
            if cfg.modality in ("vision_text", "audio_text"):
                hp["front_proj"] = layers.dense_init(
                    gen, cfg.d_frontend or cfg.d_model, cfg.d_model)
            if bottleneck:
                hp["cut_proj"] = layers.dense_init(gen, cfg.d_model, self.k)
            return hp

        heads = stack_draws(head_one, self.P)
        trunk: Params = {"blocks": transformer.stack_init(
            gen, cfg, self.n_trunk_units, self.trunk_pattern)}
        if bottleneck:
            trunk["in_proj"] = layers.dense_init(gen, self.k, cfg.d_model)
        trunk["out_norm"] = layers.norm_init(cfg.d_model, cfg.norm,
                                             gen.device)
        trunk["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                             scale=0.02)
        if cfg.enc_dec:
            trunk["embed"] = layers.embed_init(gen, cfg.vocab, cfg.d_model)
        return {"heads": heads, "trunk": trunk}

    def param_specs(self) -> Params:
        """``init``'s param tree as ``meta`` tensors: its structure,
        shapes and dtypes, with nothing allocated."""
        return self.init(_MetaGenerator())

    # ------------------------------------------------------------ head pass

    def _embed_owner(self, hp, owner_inputs, owner_index, dtype):
        """One owner's raw vertical slice as (B, S_p, d): token ids
        through ``embed``, patch or frame embeddings through
        ``front_proj``."""
        modality = self.cfg.modality
        if modality == "text" or (modality == "vision_text"
                                  and owner_index != 0):
            return layers.embed_apply(hp["embed"], owner_inputs, dtype)
        if modality in ("vision_text", "audio_text"):
            return layers.dense_apply(hp["front_proj"],
                                      owner_inputs.to(dtype))
        raise ValueError(modality)

    def _positions(self, S_p: int, owner: int, offset=0, device="cpu"):
        """Global positions of owner ``owner``'s slice (rope input): (S_p,)
        for an int ``offset``, (B, S_p) for per-row positions; with
        M-RoPE a trailing dim of 3 (t, h, w): vision owner 0's synthetic
        grid, ``[base]*3`` for every other owner."""
        ar = torch.arange(S_p, device=device)
        if self.cfg.rope == "mrope" and self.cfg.modality == \
                "vision_text" and owner == 0:
            side = max(int(math.sqrt(S_p)), 1)
            return torch.stack([torch.zeros_like(ar), ar // side,
                                ar % side], dim=-1)
        base = owner * S_p + ar
        if isinstance(offset, RowPositions):
            base = offset.dev[:, None] + base
        else:
            base = offset + base
        if self.cfg.rope == "mrope":
            return torch.stack([base] * 3, dim=-1)
        return base

    def _head_one(self, hp, owner_inputs, positions, owner_index=0,
                  caches=None, pos=None, swa_override=None):
        """One owner's head: (cut, caches, aux)."""
        cfg = self.cfg
        x = self._embed_owner(hp, owner_inputs, owner_index, self.cdtype)
        if cfg.rope == "sincos":
            off = pos if pos is not None else 0
            x = x + layers.sincos_positions(
                off + torch.arange(x.shape[1], device=x.device),
                cfg.d_model).to(x.dtype)
        x, caches, aux = transformer.stack_apply(
            hp["blocks"], x, cfg=cfg, pattern=self.head_pattern,
            positions=positions, caches=caches, pos=pos,
            swa_override=swa_override,
            bidir=cfg.enc_dec and cfg.enc_bidirectional)
        if cfg.split.cut_dim > 0:
            x = layers.dense_apply(hp["cut_proj"], x)
        return x, caches, aux

    def heads_forward(self, heads, owner_inputs, *, caches=None, pos=None,
                      swa_override=None):
        """owner_inputs: text: (P, B, S_p) token ids; vision / audio: a
        dict of the owners' inputs in owner order (``split_owner_inputs``).
        Returns (cut, caches, aux): the cut (P, B, S_p, k), or a list of
        (B, S_i, k) when the owners' lengths differ; the head caches
        (text: leaves (P, n_units, ...); vision: a dict by input name;
        audio: None) are updated in place; ``aux`` is the owners'
        auxiliary losses summed in owner order."""
        if self.cfg.modality != "text":
            return self._modal_heads(heads, owner_inputs, caches,
                                     _int_pos(pos), swa_override)
        S_p = owner_inputs.shape[-1]
        # the owners this rank runs: all of them, or on a dry-run mesh
        # with the owner dim over "pod" the pod's own (sharding.dtensor)
        mine, take = owners(heads, self.P)
        cuts, auxes = [], []
        for p in mine:
            positions = self._positions(S_p, p, 0 if pos is None else pos,
                                        owner_inputs.device)
            hc = None if caches is None else take(caches, p)
            cut, _, a = self._head_one(take(heads, p), take(owner_inputs, p),
                                       positions, 0, hc, pos, swa_override)
            cuts.append(cut)
            auxes.append(a)
        like = first_tensor(heads)
        return (stack_owners(cuts, like), caches,
                stack_owners(auxes, like))

    def _modal_heads(self, heads, owner_inputs, caches, pos, swa_override):
        """The vision / audio heads, owner by owner (asymmetric inputs):
        on a dry-run mesh with the owner dim over "pod" each pod runs
        its own owners' heads, as the text path does."""
        items = list(owner_inputs.items())
        mine, take = owners(heads, self.P)
        cuts, auxes = [], []
        for p in mine:
            name, x = items[p]
            positions = self._positions(x.shape[1], p,
                                        0 if pos is None else pos, x.device)
            cut, _, a = self._head_one(
                take(heads, p), pod_local(x), positions, p,
                None if caches is None else pod_local(caches[name]), pos,
                swa_override)
            cuts.append(cut)
            auxes.append(a)
        like = first_tensor(heads)
        return (owner_cuts(cuts, [x.shape[1] for _, x in items], like),
                caches, stack_owners(auxes, like))

    # ------------------------------------------------------------- combine

    def combine(self, cut, gen=None):
        """The paper's cut-layer combine (data-scientist side).

        cut: (P, B, S_p, k), or a list of (B, S_i, k) (concat only).
        concat: along the sequence (ID-aligned order) -> (B, S, k);
        sum/mean/max: elementwise across owners -> (B, S_p, k).  With
        ``cut_noise_std > 0`` and a generator ``gen`` (on the cut's
        device), N(0, cut_noise_std^2) noise in the cut's dtype is added
        to every owner's cut first (the reference draws it from a JAX
        key: the same distribution, not the same draws)."""
        sp = self.cfg.split
        noisy = sp.cut_noise_std > 0.0 and gen is not None
        if isinstance(cut, list):
            if noisy:
                cut = [gaussian_cut_noise(gen, c, sp.cut_noise_std)
                       for c in cut]
            if sp.combine != "concat":
                raise ValueError("ragged cuts support concat only")
            return torch.cat(cut, dim=1)
        if noisy:
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
                      dec_tokens=None, swa_override=None):
        """z: combined cut (B, S, k) — for the enc-dec, the encoder's
        output, which the decoder over ``dec_tokens`` (B, S_d)
        cross-attends.  Returns (logits (B, S or S_d, vocab) f32,
        caches, aux)."""
        cfg = self.cfg
        if cfg.modality != "text":
            pos = _int_pos(pos)
        if cfg.split.cut_dim > 0:
            z = layers.dense_apply(trunk["in_proj"], z)
        enc_out = None
        if cfg.enc_dec:
            off = pos if pos is not None else 0
            x = layers.embed_apply(trunk["embed"], dec_tokens, self.cdtype)
            positions = off + torch.arange(dec_tokens.shape[1],
                                           device=x.device)
            x = x + layers.sincos_positions(positions, cfg.d_model).to(
                x.dtype)
            enc_out = z
        else:
            x = z
            positions = torch.arange(z.shape[1], device=z.device)
            if isinstance(pos, RowPositions):
                positions = pos.dev[:, None] + positions
            elif pos is not None:
                positions = pos + positions
            if cfg.rope == "mrope":
                positions = torch.stack([positions] * 3, dim=-1)
        x, caches, aux = transformer.stack_apply(
            trunk["blocks"], x, cfg=cfg, pattern=self.trunk_pattern,
            positions=positions, caches=caches, pos=pos, enc_out=enc_out,
            swa_override=swa_override)
        x = layers.norm_apply(trunk["out_norm"], x, cfg.norm, cfg.norm_eps)
        x = constrain(x, "trunk_hidden")
        logits = layers.dense_apply(trunk["lm_head"], x.to(torch.float32))
        logits = layers.softcap(logits, cfg.logit_softcap)
        logits = constrain(logits, "logits")
        return logits, caches, aux

    # ------------------------------------------------------------- forward

    def split_owner_inputs(self, batch):
        """Vertical partition of a global batch into per-owner slices."""
        modality = self.cfg.modality
        if "owner_tokens" in batch:                   # pre-partitioned (P,B,S_p)
            return batch["owner_tokens"]
        if modality == "text":
            t = batch["tokens"]                       # (B, S)
            B, S = t.shape
            return t.reshape(B, self.P, S // self.P).permute(1, 0, 2)
        if modality == "vision_text":
            return {"patches": batch["patches"], "tokens": batch["tokens"]}
        if modality == "audio_text":
            return {"frames": batch["frames"]}
        raise ValueError(modality)

    def forward(self, params, batch, gen=None, *, swa_override=None):
        """Full-sequence forward (train / prefill without a cache).
        Returns ``(logits (B, S, vocab) f32, aux)``: the heads' aux
        summed over owners plus the trunk's.  ``gen``: the cut noise's
        generator (see :meth:`combine`).  A stacked cut is cast to the
        compute dtype before the combine, a list of cuts is not, as in
        the reference."""
        cut, _, aux_h = self.heads_forward(params["heads"],
                                           self.split_owner_inputs(batch),
                                           swa_override=swa_override)
        if not isinstance(cut, list):
            cut = constrain(cut.to(self.cdtype), "cut_stacked")
        z = constrain(self.combine(cut, gen=gen), "combined")
        logits, _, aux_t = on_pod(
            self.trunk_forward, params["trunk"], z,
            dec_tokens=batch["tokens"] if self.cfg.enc_dec else None,
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
        sequence; head caches cover each owner's slice + room for
        generated tokens: stacked over owners (text), a dict by input
        name (vision), or none (audio: the encoder runs once, at
        prefill).  The enc-dec's caches also hold ``enc``, the encoder's
        output, a ``(B, s_max // 2, k)`` placeholder until prefill.
        ``ring`` / ``swa_override``: see
        ``transformer.stack_cache_init``."""
        cfg = self.cfg
        dt = _cdtype(cfg)
        if cache_dtype is not None:
            dt = (layers.dtype_of(cache_dtype)
                  if isinstance(cache_dtype, str) else cache_dtype)
        kw = dict(ring=ring, swa_override=swa_override)
        heads = None
        if cfg.modality in ("text", "vision_text"):
            s_head = s_max // self.P + n_new
            one = transformer.stack_cache_init(
                batch_size, cfg, self.n_head_units, s_head, dt, device,
                pattern=self.head_pattern, **kw)
            if cfg.modality == "text":
                heads = tree_map(
                    lambda a: a[None].repeat((self.P,) + (1,) * a.dim()),
                    one)
            else:
                heads = {"patches": one,
                         "tokens": tree_map(torch.clone, one)}
        trunk = transformer.stack_cache_init(
            batch_size, cfg, self.n_trunk_units, s_max + n_new, dt, device,
            pattern=self.trunk_pattern, **kw)
        out = {"heads": heads, "trunk": trunk}
        if cfg.enc_dec:
            out["enc"] = torch.zeros((batch_size, s_max // 2, self.k),
                                     dtype=dt, device=device)
        return out

    def prefill(self, params, batch, caches, *, swa_override=None):
        """Process the full context, filling the caches.  Returns
        (last-token logits, caches); the enc-dec's caches hold the
        encoder's output as ``enc``."""
        cfg = self.cfg
        cut, hc, _ = self.heads_forward(params["heads"],
                                        self.split_owner_inputs(batch),
                                        caches=caches["heads"], pos=0,
                                        swa_override=swa_override)
        z = constrain(self.combine(cut), "combined")
        logits, tc, _ = on_pod(
            self.trunk_forward, params["trunk"], z, caches=caches["trunk"],
            pos=0,
            dec_tokens=batch["tokens"] if cfg.enc_dec else None,
            swa_override=swa_override)
        out = {"heads": hc, "trunk": tc}
        if cfg.enc_dec:
            out["enc"] = z
        return logits[:, -1], out

    # ------------------------------------------- per-segment serving programs
    #
    # prefill/decode_step run heads + trunk as one program.  When the
    # engine serves through a transport-backed boundary it uses these
    # halves instead, so the cut activations are a real wire payload.
    # Text modality, decoder-only (the engine serves text archs only).

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
        with site("cut_stacked"):       # owner 0's cut reaches the trunk
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
        """One new token (B, 1).  The generation owner is owner 0 (the
        vision modality's text owner, owner 1; the enc-dec runs the
        decoder alone, over ``caches["enc"]``).  ``pos``: global
        position in the combined sequence; ``pos_local``: position
        within the generation owner's slice/cache; each an int, or (the
        text modality) one position per row."""
        cfg = self.cfg
        if cfg.enc_dec:
            logits, tc, _ = self.trunk_forward(
                params["trunk"], caches["enc"], caches=caches["trunk"],
                pos=pos, dec_tokens=token, swa_override=swa_override)
            return logits[:, -1], dict(caches, trunk=tc)
        if cfg.modality == "text":
            z, hc = self.decode_heads(params["heads"], token,
                                      caches["heads"], pos_local,
                                      swa_override=swa_override)
        else:
            # the token through the text owner's head: rope at the global
            # position, its cache written at the local one
            pos, pos_local = _int_pos(pos), _int_pos(pos_local)
            positions = pos + torch.arange(1, device=token.device)
            if cfg.rope == "mrope":
                positions = torch.stack([positions] * 3, dim=-1)
            z = one_owner(
                lambda hp: self._head_one(
                    hp, pod_local(token), positions, 1,
                    pod_local(caches["heads"]["tokens"]), pos_local,
                    swa_override)[0],
                1, params["heads"], self.P, pod_local(token), (1, self.k),
                self.cdtype)
            hc = caches["heads"]
        logits, tc = on_pod(self.decode_trunk, params["trunk"], z,
                            caches["trunk"], pos, swa_override=swa_override)
        return logits, {"heads": hc, "trunk": tc}
