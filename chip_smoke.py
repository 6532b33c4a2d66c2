#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU — the quickest proof that the port builds and trains there.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  1. the card's name and power limit, as ``nvidia-smi`` reports them;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, byte for
     byte, at the training path's shape and at edge shapes, with times
     (CUDA events) beside the bytes-over-bandwidth bound;
  4. the main path at full width: PSI -> the paper's dual-headed MNIST
     SplitNN -> one split epoch over the queue transport with the int8
     cut codec -> evaluate, with the kernel launch counts read around it
     and the loss trail held against the same run on the CPU; then one
     more epoch under torch.profiler for the device's busy share;
  5. split == joint bit for bit on the card (lossless codec, both
     schedules), and the card's joint run against the CPU's;
  6. a ``{"kernels": [...]}`` JSON line, then the ``{"ok": true, ...}``
     JSON line last.

Without a CUDA device it prints nothing and exits 2.  It imports only
``repro_torch`` (never JAX or the JAX package ``repro``).
"""
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# memory rate (bytes/s) and f32 rate outside the tensor cores (FLOP/s)
# by card, from NVIDIA's data sheets; the SXM H100 is the default
CARD_PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}
# the kernel's shapes: the path's, a ragged block, one row, odd K with
# an unaligned scale, and a large one
SHAPES = [(128, 64), (130, 64), (1, 128), (257, 10), (65536, 64)]
PATH_SHAPE = (128, 64)
OPS_PER_ELEMENT = 6     # abs, max, divide, round, two clamps


def peaks(name):
    for key, rates in CARD_PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks on record for {name!r}")


def inputs(shape, seed=0):
    """Normal rows with the edge cases planted: an all-zero row, exact
    half-way values (absmax 127 -> scale 1), and a ±absmax tie."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    T, K = shape
    x[0] = 0.0
    if T > 1:
        x[1] = np.float32(0.5) + np.arange(K, dtype=np.float32) % 7 - 3
        x[1, 0] = 127.0
    if T > 2:
        x[2, 0], x[2, -1] = 4.0, -4.0
    return x


def device_ms(fn, reps=100, rounds=11):
    """Device time of one call: a CUDA graph of ``reps`` calls replayed
    between CUDA events, median over ``rounds`` (no host launch cost)."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return _median_ms(g.replay, 1, rounds) / reps


def eager_ms(fn, reps=100, rounds=11):
    """Time of one call as the path issues it (host launch included)."""
    for _ in range(10):
        fn()
    return _median_ms(fn, reps, rounds) / reps


def _median_ms(fn, reps, rounds):
    import torch
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def phase_kernels(bw, flops):
    """Phase 3: both entry points vs their plain versions, byte for byte."""
    import torch
    from repro_torch.kernels.quantize import (quantize_int8,
                                              quantize_int8_ref,
                                              quantize_pack_int8,
                                              quantize_pack_int8_ref)
    out = {}
    for name, kern, plain in (
            ("quantize_pack_int8", quantize_pack_int8,
             quantize_pack_int8_ref),
            ("quantize_int8", quantize_int8, quantize_int8_ref)):
        err, rows = 0.0, []
        for shape in SHAPES:
            x = torch.from_numpy(inputs(shape)).cuda()
            got, want = kern(x), plain(x)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                if a.dtype == torch.float32:        # scales: bitwise
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}{shape}: kernel bytes "
                                         "differ from the plain version")
                err = max(err, (a.double() - b.double()).abs().max().item())
            T, K = shape
            nbytes = 4 * T * K + (T * (K + 4) if name == "quantize_pack_int8"
                                  else T * K + 4 * T)
            bytes_ms = 1e3 * nbytes / bw
            ops_ms = 1e3 * OPS_PER_ELEMENT * T * K / flops
            row = {"shape": list(shape),
                   "ms": device_ms(lambda: kern(x)),
                   "plain_ms": device_ms(lambda: plain(x)),
                   "eager_ms": eager_ms(lambda: kern(x)),
                   "plain_eager_ms": eager_ms(lambda: plain(x)),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations"}
            rows.append(row)
            print(f"  {name}{shape}: identical; kernel {row['ms']:.6f} ms "
                  f"(eager {row['eager_ms']:.6f}), plain "
                  f"{row['plain_ms']:.6f} ms (eager "
                  f"{row['plain_eager_ms']:.6f}), bound "
                  f"{row['bound_ms']:.8f} ms ({row['bound_by']})")
        out[name] = {"max_abs_err": err, "rows": rows}
    return out


def mnist_session(device, n=2000):
    from repro_torch.configs import CONFIG
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device=device)
    stats = s.resolve(group="modp512")
    s.build(CONFIG)
    return s, stats


def phase_main_path():
    """Phase 4: the paper's path at full width, through the int8 kernel."""
    import torch
    from repro_torch.kernels.quantize import (launch_counts,
                                              reset_launch_counts)
    reset_launch_counts()
    t0 = time.time()
    session, stats = mnist_session("cuda")
    h = session.fit(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
                    compression="int8", backend="queue", verbose=True)
    ev = session.evaluate()
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    wall = time.time() - t0
    ts = session.transport_stats
    steps, owners = ts["steps"], len(session.owners)
    trail = h["loss_trail"]
    print(f"  PSI: {stats['global_intersection']} shared subjects; "
          f"{steps} steps; wall {wall:.2f} s")
    print(f"  loss trail: {[round(v, 5) for v in trail]}")
    print(f"  val: {ev}")
    print(f"  step_ms {ts['step_ms']:.3f}, steady_step_ms "
          f"{ts['steady_step_ms']:.3f}")
    print(f"  wire bytes by kind: {json.dumps(ts['wire_by_kind'])}")
    print(f"  kernel launches in the run: {counts}")
    if counts["quantize_pack_int8"] < 2 * owners * steps:
        raise AssertionError(f"quantize_pack_int8 launched "
                             f"{counts['quantize_pack_int8']} times, "
                             f"< 2 x {owners} owners x {steps} steps")
    if len(trail) != steps or not all(math.isfinite(v) for v in trail):
        raise AssertionError(f"bad loss trail {trail}")
    if not sum(trail[-3:]) < sum(trail[:3]):
        raise AssertionError(f"loss did not fall: {trail}")
    # the same run on the CPU (plain quantizer): int8 rounding can flip
    # a code where the card's f32 products differ in the last bit
    cpu, _ = mnist_session("cpu")
    hc = cpu.fit(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
                 compression="int8", backend="queue", verbose=False)
    gap = max(abs(a - b) for a, b in zip(trail, hc["loss_trail"]))
    print(f"  loss trail vs the CPU run: max |diff| {gap:.3e} (limit 2e-2)")
    if gap > 2e-2 or abs(ev["accuracy"] - cpu.evaluate()["accuracy"]) > 0.02:
        raise AssertionError("card and CPU int8 runs disagree")
    profile_epoch(session)
    return counts, ts


def profile_epoch(session):
    """One more split int8 epoch under torch.profiler: the device's busy
    share of the epoch's wall time and the kernels that fill it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.fit(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
                    compression="int8", backend="queue", verbose=False)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    if not busy:
        print("  profiler: no device time recorded; busy share not measured")
        return
    steps = session.transport_stats["steps"]
    print(f"  profiled fit (warmup, {steps} steps, eval; profiler on): wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms = "
          f"{busy / wall_us:.4f} of it")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total:10.1f} us  x{e.count:<5d} "
              f"{e.key[:90]}")
    ours = [e for e in kernels if "quantize_rows" in e.key]
    q_us = sum(e.self_device_time_total for e in ours)
    print(f"  quantize_rows: {q_us:.1f} us over "
          f"{sum(e.count for e in ours)} launches = {q_us / busy:.4f} of "
          f"device busy time")


def phase_split_equals_joint():
    """Phase 5: lossless split == joint bitwise on the card; card vs CPU."""
    import torch
    from repro_torch.tree import tree_leaves
    kw = dict(epochs=1, batch_size=128, eval_frac=0.15, verbose=False)
    joint, _ = mnist_session("cuda")
    hj = joint.fit(**kw)
    for schedule in ("pipelined", "sequential"):
        split, _ = mnist_session("cuda")
        hs = split.fit(**kw, mode="split", schedule=schedule,
                       backend="queue")
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(joint.params), tree_leaves(split.params)))
        if not same or hs["loss_trail"] != hj["loss_trail"]:
            raise AssertionError(f"split ({schedule}) != joint on the card")
        print(f"  split ({schedule}) == joint: params and loss trail "
              f"bitwise equal over {len(hj['loss_trail'])} steps")
    cpu, _ = mnist_session("cpu")
    hc = cpu.fit(**kw)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(hj["loss_trail"], hc["loss_trail"]))
    pdiff = max((a.cpu() - b).abs().max().item() for a, b in
                zip(tree_leaves(joint.params), tree_leaves(cpu.params)))
    print(f"  joint card vs CPU: loss trail max rel {rel:.3e} (limit "
          f"1e-4), params max |diff| {pdiff:.3e} (limit 1e-4)")
    if rel > 1e-4 or pdiff > 1e-4:
        raise AssertionError("card and CPU joint runs disagree")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.device import configure_cuda
    from repro_torch.kernels import build
    configure_cuda()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks(name)
    print("== 1. device")
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; peaks "
          f"used for bounds: {bw / 1e12} TB/s, {flops / 1e12} TFLOP/s f32")

    print("== 2. build")
    t = time.time()
    build.build(["quantize"])
    print(f"  built in {time.time() - t:.2f} s")
    for src, log in build.build_logs.items():
        print("\n".join(f"  nvcc {src}: {line}" for line in
                        log.strip().splitlines()))

    print("== 3. kernels vs plain versions on the card")
    kern = phase_kernels(bw, flops)
    print("== 4. main path: PSI -> SplitNN -> split int8 fit -> evaluate")
    counts, _ = phase_main_path()
    print("== 5. split == joint on the card")
    phase_split_equals_joint()

    print("== 6. results")
    src = "src/repro_torch/csrc/quantize.cu"
    tpu = "src/repro/kernels/quantize/kernel.py"
    replaces = {"quantize_pack_int8": f"{tpu}:28",     # _quantize_pack_kernel
                "quantize_int8": f"{tpu}:19"}          # _quantize_kernel
    entries = []
    for kname, res in kern.items():
        row = next(r for r in res["rows"] if tuple(r["shape"]) == PATH_SHAPE)
        entries.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname], "launches": counts[kname],
            "on_path": kname == "quantize_pack_int8",
            "max_abs_err": res["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "eager_ms": row["eager_ms"],
            "plain_eager_ms": row["plain_eager_ms"],
            "all_shapes": res["rows"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
