"""End-to-end SplitNN training launcher (the port's counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --reduced --steps 50 --batch 8 --seq 256 [--device cpu]

A thin client of ``VerticalSession``: token streams are vertically
partitioned into sequence-slice owners and a label-holding scientist,
the session resolves and aligns them (DH-PSI), builds the split model
through the registry, and runs the per-segment-optimizer loop with
checkpointing.  It runs on the CUDA card unless ``--device cpu`` is
given; the weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.data import make_token_dataset
from repro_torch.federation import VerticalSession, sequence_parties
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--owner-lr", type=float, default=1e-3)
    ap.add_argument("--scientist-lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.modality != "text":
        raise SystemExit("train.py drives text archs; see examples/ for "
                         "vlm/audio training")
    toks = make_token_dataset(max(args.batch * 8, 64), args.seq,
                              cfg.vocab, args.seed)
    session = VerticalSession(
        *sequence_parties(toks, cfg.split.n_owners), seed=args.seed,
        device=args.device)
    session.resolve(group="modp512")
    session.build(cfg, seed=args.seed)

    model = session.adapter.model
    n_params = sum(t.numel() for t in tree_leaves(session.params))
    print(f"arch={cfg.name} reduced={args.reduced} params={n_params/1e6:.1f}M"
          f" owners={cfg.split.n_owners} cut_layer={model.n_head_units}")

    history = session.fit(
        steps=args.steps, batch_size=args.batch,
        owner_lr=args.owner_lr, scientist_lr=args.scientist_lr,
        log_every=args.log_every,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0)
    return history["final"]["loss"]


if __name__ == "__main__":
    main()
