#!/usr/bin/env python
"""The port's serving decode tick, timed: llama3.2-3b at full width and
depth, random weights from a seed, behind the wave engine over the queue
transport with the int8 cut codec, as ``chip_smoke.py``'s phase 7 serves
it (4 slots, contexts of 1024, 32 new tokens a request).  Each decode
tick is timed on the host clock between two device syncs; the last line
is a JSON object with every tick's ms and their median.

    python tools/decode_tick_torch.py [--src DIR] [--waves N] [--label L]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees are compared on one card:
run the script on each in turn on the same card.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

SLOTS, CTX, NEW = 4, 1024, 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_dataset
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import SplitModel
    if not torch.cuda.is_available():
        raise SystemExit("no card visible")
    cfg = get_config("llama3.2-3b")
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ctxs = make_token_dataset(SLOTS * args.waves, CTX, cfg.vocab, 0)[:, :CTX]
    kw = dict(batch_slots=SLOTS, ctx_len=CTX, transport="queue",
              compression="int8", device="cuda")
    warm = ServingEngine(model, params, max_new=2, **kw)
    for c in ctxs[:SLOTS]:
        warm.submit(c)
    warm.run()

    eng = ServingEngine(model, params, max_new=NEW, **kw)
    ticks = []
    decode = eng._split_decode

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(*a, **k)
        torch.cuda.synchronize()
        ticks.append(1e3 * (time.perf_counter() - t))
        return out
    eng._split_decode = timed
    for c in ctxs:
        eng.submit(c)
    eng.run()
    print(json.dumps({"label": args.label, "src": args.src,
                      "ticks": len(ticks),
                      "median_ms": statistics.median(ticks),
                      "tick_ms": [round(x, 4) for x in ticks]}))


if __name__ == "__main__":
    main()
