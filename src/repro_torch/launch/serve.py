"""Batched split-inference launcher (the port's counterpart of
``repro.launch.serve``): prefill the vertically-partitioned context
through the owner heads, then decode new tokens through the
generation-owner head + scientist trunk.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --reduced --batch 4 --ctx 128 --new 16 [--device cpu]

``--arch`` is any text architecture ``configs.get_config`` builds (the
vision and audio ones exit, as in the reference)
(gemma2-9b's and mixtral-8x7b's local layers keep ring caches whenever a
cache holds at most the window).  It runs on the CUDA
card unless ``--device cpu`` is given; the weights are random, drawn
from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.federation import batching
from repro_torch.models.model import SplitModel


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.modality != "text":
        raise SystemExit("serve.py drives text archs")
    device = resolve_device(args.device)
    model = SplitModel(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)

    B, S, P = args.batch, args.ctx, cfg.split.n_owners
    toks = make_token_dataset(B, S, cfg.vocab, args.seed)[:, :S]
    batch = {"owner_tokens": batching.serving_owner_slices(toks, P, device)}
    caches = model.cache_init(B, S, n_new=args.new, device=device)

    def pick(logits):
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen).to(
                torch.int32)
        return logits.argmax(-1)[:, None].to(torch.int32)

    with torch.inference_mode():
        t0 = time.time()
        logits, caches = model.prefill(params, batch, caches)
        _sync(device)
        print(f"prefill {B}x{S} on {device}: {time.time() - t0:.2f}s")
        tok = pick(logits)
        out = [tok]
        t0 = time.time()
        for t in range(args.new - 1):
            logits, caches = model.decode_step(params, caches, tok, S + t,
                                               S // P + t)
            tok = pick(logits)
            out.append(tok)
        _sync(device)
        dt = time.time() - t0
    gen_toks = np.concatenate([t.cpu().numpy() for t in out], axis=1)
    print(f"decoded {args.new - 1} steps in {dt:.2f}s "
          f"({(args.new - 1) * B / max(dt, 1e-9):.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  request {b}: ...{toks[b, -8:].tolist()} -> "
              f"{gen_toks[b].tolist()}")
    return gen_toks


if __name__ == "__main__":
    main()
