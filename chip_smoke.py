#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU — the quickest proof that the port builds and trains there.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  1. the card's name and power limit, as ``nvidia-smi`` reports them;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  3. the quantize kernel against its plain PyTorch version on the card,
     byte for byte, at the training path's shape, edge shapes and the
     serving paths' cuts, f32 and bf16, with NaN, ±inf and subnormal
     rows; the first 32 rows of a call against a call on them alone; the
     row plan of each call, and times (CUDA events) beside an empty
     kernel launched on the same grid (the launch floor) and the
     bytes-over-bandwidth bound;
  4. the main path at full width: PSI -> the paper's dual-headed MNIST
     SplitNN -> one split epoch over the queue transport with the int8
     cut codec -> evaluate, with the exact kernel launch counts read
     around it (the int8 codec on every cut and cut gradient, the
     cut-fusion kernel on every trunk forward) and the loss trail held
     against the same run on the CPU; then one more epoch under
     torch.profiler for the device's busy share;
  5. split == joint bit for bit on the card (lossless codec, both
     schedules, the cut-fusion kernel in both, exact launch counts), and
     the card's joint run against the CPU's;
  6. the attention kernels against their plain version on the card, on
     the reference's kernel cases (f32 and bf16), queries over a cache,
     and the serving paths' ten shapes (llama3.2-3b's, zamba2-2.7b's
     and gemma2-9b's: hd 256 with softcap 50, causal head and trunk
     prefills over a cache, a local ring prefill and a bidir ring
     decode), each on the route the wrapper picks (decode: split-KV;
     tc: wgmma and TMA; fma: CUDA cores, bf16 at hd 256 too), with
     times beside the fma route's at the same shape, the bound and one
     PyTorch call (``scaled_dot_product_attention``; with a softcap,
     compiled ``flex_attention`` with a tanh ``score_mod``, SDPA's
     uncapped function timed beside it); in the softcapped cases q is
     scaled so that the scores reach the cap's bend, and the kernel at
     cap 30 and at no cap must fail the tolerance; gemma2's ring decode
     with per-row lengths, each row bitwise a scalar call; then calls
     in which some query row sees no key
     (kv_len 0, a local window past kv_len) on every route that takes
     them;
  7. split-LM serving at full width: llama3.2-3b (random weights from a
     seed) behind the wave engine over the queue transport with the int8
     cut codec, 8 contexts of 1024 tokens in two waves of 4, 32 new
     tokens each, with the kernel launch counts read around it (every
     prefill attention call on the tc route, every decode call on the
     decode route), the cut
     bytes held against the frame size;
  8. engine == prefill + decode_step by hand on the card (greedy tokens
     identical), and the card against the CPU at full width with 2
     layers in f32 compute (identical greedy tokens, first-token logits
     within rel 1e-3); then the llama params are freed;
  9. the SSD scan kernels against their plain version on the card, on
     the reference's kernel cases and more (f32 and bf16, with and
     without an initial state) and at zamba2-2.7b's head and trunk
     prefill shapes, all read as strided views of one conv-output
     buffer, on both routes where both apply (chunked: three launches on
     the tensor cores; serial: one block per (batch, head)), with the
     two routes timed in the same call beside the plain version and the
     bound;
 10. zamba2-2.7b (Mamba2 + shared attention, random weights from a
     seed) served at full width and depth as in phase 7, with the exact
     launch counts of all three kernels (every scan on the chunked
     route) and the cut bytes checked;
 11. phase 8's checks for zamba2-2.7b: engine == by hand at full width,
     and card == CPU at reduced widths with 18 layers in f32;
 12. the cut-fusion kernel against its plain version on the card, on the
     reference's kernel cases and the training path's shapes (the
     batch, a microbatch chunk, a ragged evaluation batch, sum and
     mean, the masked trunk's one owner plane (1, 128, 64) x (1, 64,
     500) sum) and the reference benchmark's shape, f32 and bf16, on both
     routes where both apply (fma: CUDA-core f32 FMAs; tc: wgmma and
     TMA on bf16), with times beside the bound and beside one PyTorch
     call; and a row's bits independent of T (the first 32 rows of a
     call equal a call on those rows, f32 and bf16);
 13. the training path at full width through the other schedules:
     split in 4 microbatches == the microbatched joint oracle bit for
     bit, owners in spawned worker processes == the queue backend bit
     for bit (lossless, then int8), each with exact launch counts; and
     the concat, sum and mean trunks each through a joint fit, card
     against CPU;
 15. secure forward aggregation and the cut-layer defences at full width
     with the sum trunk: one masked split int8 epoch over the queue with
     exact launch counts (cut fusion on every trunk forward, the int8
     codec on gradient messages only), masked split == the masked joint
     oracle bit for bit (lossless), process == queue (int8) bit for bit,
     card == CPU masked joint within rel 1e-4, the host time of one
     owner's mask and the forward bytes per owner; then one split int8
     epoch per defence (NoPeek, cut noise, unit and sign gradients,
     gradient noise), each with a finite trail and a warmup that leaves
     the built params bitwise, NoPeek split against NoPeek joint within
     rel 1e-4 while NoPeek moves it past that limit from weight 0 (its
     heads ten times closer to NoPeek joint's than to weight 0's), and
     every steady step time beside the undefended sum run's;
 16. supervised crash recovery (``fit(supervise=True)``) at phase 4's
     width and depth, split int8: the fault-free supervised run ==
     the unsupervised one bit for bit on the queue; the snapshot and
     heartbeat cost as three alternating pairs of 50-step fits, every
     steady step printed; a crash at step 3 and a corrupt cut frame on
     the queue, one fit each, and on the process backend one fit with a
     crash, a corrupt cut frame and a wedge caught by the heartbeats,
     each == its backend's fault-free supervised run bit for bit, with
     its recovery events and wall time beside the fault-free one; a
     masked-sum crash on the queue == its
     fault-free masked run; exact launch counts in every run, replays
     and the respawn's warmup included, from the run's own record; no
     recovery without a plan; "restart budget exhausted" for a crash in
     every generation;
 17. PSI entity resolution at phase 4's population (2000 subjects, two
     owners), host compute beside the card: one resolve at the default
     group modp2048 (500 subjects) on the process backend with a pool of
     min(8, cpus) modexp workers, equal to the serial direct modp512
     resolve; every
     mode (noinv, bloom, hidden) on every backend (direct, queue,
     process) with the pool, and without it (noinv everywhere, bloom
     and hidden on direct), rows bitwise equal within a
     mode, every pool reporting the parallelism it asked for; ±1 % churn
     of the scientist's rows, then delta rounds on queue and process
     with the reference engine's O(Δ) modexp counts, and a hello-only
     unchanged repeat; ``crash_psi`` and ``wedge_psi`` retried once on
     queue and process; the split int8 fit over the queue on the hidden
     alignment, with exact launch counts and its loss trail against the
     CPU's; one resolve of 10000 subjects (wall, IDs/s, modexps, wire
     bytes by kind);
 18. the rest of ``fit`` on the paper's path: (a) frames at 8 ms one-way
     on a queue channel pair and a process endpoint pair, the receiver's
     wait ending past their deadline by a p50 under 0.1 ms with the
     spin, beside the sleep alone (``REPRO_SPIN_WAIT_S=0``), with
     ``recv``'s return (unpacking included) printed beside it; (b)
     phase 4's split int8 fit at 8 ms one-way, pipelined, sequential, in 4 microbatches and on a
     1e8 B/s link, each steady step at or above its round-trip floor,
     pipelined below sequential, params and loss trail bitwise those of
     the same fit at latency 0, with phase 4's and phase 13's exact
     launch counts; (c) owners of widths 588 + 196 (queue and process)
     and the reference's eight uneven owners (queue, 1000 subjects):
     lossless split ==
     joint bitwise, one cut byte count for every owner, int8 fits with
     exact counts, and cut fusion at P = 8 against its plain version
     (2e-4), timed beside the library call and the bound; (d) a 10-step
     split int8 process fit with ``ckpt_every=5``: the files equal the
     fit's params, a fresh session restores step 5 and its 5 more steps
     equal a session that went on without a restore, bit for bit, and
     each checkpoint's wall time beside the steady step;
 19. the rest of LM serving at full width, run right after phase 8 on
     phase 7's llama3.2-3b params (and (i) right after phase 11 on phase
     10's zamba2-2.7b params): (a) the attention decode kernel with
     per-row kv lengths (llama's trunk decode tick, lengths 1025-1057)
     against its plain version (2e-2), each row's bits against a scalar
     call at its length, a vector of equal lengths against the scalar
     call, timed beside the scalar route and SDPA with a per-row mask;
     (b) 8 requests of 1024 tokens with mixed max_new through 4 slots,
     int8 over the queue: continuous == wave tokens bitwise, exact
     launches derived from each run's ticks and refills, fewer ticks
     than the waves' token steps, tok/s and ms per tick; (c) the same
     on the process transport: tokens, cut bytes and messages equal;
     (d) the requests twice through a cut cache of 8 entries: 8 hits, no
     prefill bytes, bitwise tokens, bytes per entry; (e) two
     ``ServingService`` sessions on two threads over one process
     channel, each equal to its solo run, scoped stats summing to the
     channel's; (f) each tick's ms at 8 ms one-way beside latency 0,
     every tick above the one-way floor, refill ticks paying one window;
     (g) a transport fault failing the pending requests with
     ``Result.error``, then a fresh request served; (h) ``cut_dim`` 768
     (phase 7's params plus ``cut_proj`` / ``in_proj``): exact launches
     and decode frame bytes against the analytic size, prefill ms; (j)
     ``VerticalSession(*sequence_parties(...))`` -> resolve -> build ->
     ``serve_dataset`` (continuous, process, int8), 8 documents of 1024
     tokens; (i) zamba2-2.7b continuous == wave bitwise with exact
     launches;
 20. LM training at full width (the dense family), after phase 18: (a)
     the attention Function (the kernel forward, a backward of plain
     products) against autograd through the plain version at
     llama3.2-3b's training shapes (batch 8, the trunk's 256 tokens and
     a head's 128; 24/8 heads, hd 128), bf16 (route tc) and f32 (route
     fma), with the forward's, the backward's, the plain version's and
     SDPA's forward and forward + backward times beside the bounds; (b)
     llama3.2-3b at full widths, 4 layers cut after 2 (params from seed
     0), 64 documents of 256 tokens (8 held out) through PSI into 10
     Adam steps of 8: joint, split lossless over the queue (its params
     and loss trail bitwise those of the per-owner-clipped joint
     oracle) and split int8 (within 2e-2 of lossless), each with exact
     tc attention and quantize launch counts (the split head backward
     recomputes its forward; with ``remat``, the configs' default, every
     unit a backward goes through runs its forward once more there), a
     falling loss, the wire bytes per owner
     per step against the frames, the steady step and an evaluation;
     (c) the reduced config's int8 split fit with owners in spawned
     workers == the queue, bitwise; (d) ``python -m
     repro_torch.launch.train --reduced --steps 3`` on the card, started
     beside (c);
 21. LM training at full width on the SSM family, after phase 20: (a)
     the scan Function (the kernel forward, a backward of plain
     products) at zamba2-2.7b's training shapes (batch 8, the trunk's 256
     tokens and a head's 128; 80 heads of 64, 64 states, chunks of 256;
     x, B, C strided views of one buffer as the Mamba2 block gives them),
     bf16 (route chunked) and f32 (route serial): the forward against the
     plain ``ssd_chunked`` and the gradients against autograd through the
     plain stages, within 2e-2 / 2e-4, with the forward's, the
     backward's and the plain version's times beside the backward's
     bound; (b) zamba2-2.7b at full widths cut in depth to 12 layers (2
     units, the cut after 1), phase 20(b)'s data and fits, with exact
     chunked-scan, tc and quantize launches, the scan backward's calls
     and its share of the step, split lossless == the per-owner-clipped
     oracle bitwise; (c) the reduced config's int8 split fit on spawned
     workers == the queue, bitwise; (d) ``python -m
     repro_torch.launch.train --arch zamba2-2.7b --reduced --steps 3``,
     started beside (c);
 22. KV cache variants on gemma2-9b, after phase 21: (a) gemma2-9b at
     full width and depth (42 layers, d 3584, 16/8 heads of 256, vocab
     256000; random weights from seed 0, 52.2 GB of f32 params) served
     as in phase 7 with ``ring_cache=True`` (every local layer's cache
     within its 4096-token window: the ring path), with exact launch
     counts (every prefill on the fma route, every decode call on the
     decode route, none on tc), the int8 wire bytes against the frame
     size, peak device memory and a profiled wave; (b) its full widths
     cut to 4 layers, one row of 8448 tokens (owner slices of 4224 and
     the trunk's 8448 past the window: ring prefills roll by 128 and
     256, every decode wraps), 16 teacher-forced decode steps on full,
     ring, ``swa_override=4096`` without and with ring, and fp8 ring
     caches: each pair's largest logit gap against the bf16 floor (the
     full caches' bf16 run against its f32 run), cache bytes (ring below
     full, fp8 half of bf16), the ring caches after each prefill and
     step slot by slot against the full caches' positions (bitwise where
     the prefill or the embedding wrote them, else within twice the
     bf16 floor of an f32 run on full caches), one more ring step with
     two rows at different positions == a scalar call at each, bitwise,
     with the per-row launches counted from 0; (c) reduced gemma2 (f32,
     window 64, contexts of 160) on ring caches card vs CPU within rel
     1e-4 (``card_vs_cpu``: ``configure_cuda``'s numerics asserted and
     printed, the CPU on one thread, the largest gap's step,
     row and logit), wave and continuous tokens equal;
 23. the xLSTM and MoE families and the last two dense configs, after
     phase 22: (a) xlstm-125m at full width and depth (12 layers of
     sLSTM and mLSTM units, random weights from a seed) served as in
     phase 7 with exactly 0 attention and 66 quantize launches, and one
     more wave under torch.profiler; (b) its training at full width,
     6 of its 12 layers, 2 Adam steps of phase 20's batch (8 x 256) on 9
     documents, one held
     out: joint, the per-owner-clipped oracle and split lossless (== the
     oracle, bitwise), exact launch counts, a falling loss;
     (c) llama3-405b and nemotron-4-15b at full width cut to 2 layers,
     served as in phase 7 with exact tc, decode and quantize counts and
     the peak memory; (d) deepseek-moe-16b and mixtral-8x7b the same
     way, with the top-k choices each call dropped past its capacity,
     and deepseek's training (5 steps, as (b)); (e) reduced xlstm-125m
     and deepseek-moe-16b (f32) card vs CPU within rel 1e-4, as 22(c);
 24. the enc-dec and vision families, after phase 23, through
     ``SplitModel``'s own programs (the engine drives text archs only):
     (a) whisper-tiny at full width and depth, 8 rows of 1500 frames
     (the conv stem a stub) and a 64-token prompt, prefill + 31 greedy
     decode ticks at a context of 448, with exact attention launches
     by route (the encoder's on tc, every decoder call on decode: self-
     and cross-attention, Sq != Skv), and in f32 a decode step's logits
     == ``forward``'s within 2e-3; (b) its training, 5 steps of clip +
     Adam on one batch of 8 x (1500 frames, 224 tokens): a falling loss,
     exact tc launches; (c) qwen2-vl-72b at full width, 2 layers, 4 rows
     of 1024 patches (a 32 x 32 M-RoPE grid) + 1024 tokens, 3 tc per
     wave and 2 decode per tick; (d) both reduced (f32) card vs CPU within
     rel 1e-4, the logits and a 3-step trail; (e) the attention kernel
     at these paths' calls, beside the plain version, SDPA and the
     bound;
 25. the step builders (``repro_torch.launch.steps``), run right after
     phase 19(b)-(i) on phase 7's llama3.2-3b params: (a) the long_500k
     decode step that ``steps.build(cfg, LONG_500K, make_host_mesh(),
     ring_cache=True)`` builds, at full width and depth, its ring
     caches (8192 slots in every layer) drawn from a seed, 8 ticks at
     positions 524288-524295 with 35 decode launches a tick (2 owners x
     7 head layers + 21 trunk layers), the tick ms and the peak; each
     attention call of a tick against the plain version (atol 2e-3),
     the logits against the same ticks on the plain attention from the
     same caches (2x the bf16 floor of two plain versions, measured in
     the run) and, in f32 compute, within rel 1e-4; (b) the same with
     ``cache_dtype=torch.float8_e4m3fn`` and no ring: the full
     524296-slot trunk cache and 262152-slot head caches (bytes against
     the analytic size), the tick ms and the peak, the fp8 caches'
     upcast to bf16 in one tick (CUDA events around it), and the same
     checks, the f32 run on (b)'s own fp8 caches; (c)
     ``build_prefill`` at phase 7's 8 contexts of 1024 == ``prefill``
     called directly, bitwise; (g) kernel 4 at the long_500k calls (a
     row over 524296 keys under the 8192-token window; 8192 ring slots,
     bidir) against the plain version, timed beside it, SDPA and the
     bound; then, with phase 7's params freed, (d) ``build_train`` at
     full width, 4 layers cut after 2, 8 x 256: one step with ``remat``
     off and one with it on (the config's default: every stack unit
     checkpointed) from the same params, the loss and every updated leaf
     bitwise equal, tc launched once and twice a unit, the bytes
     allocated between the loss and the backward lower with it on and
     the one-step peak no higher, both printed with the card's name and
     power limit; losses in 1 and 4 microbatches within rel 1e-4, a
     bf16 optimizer state, ms a step;
     (e) reduced llama3.2-3b through the builders, card vs CPU: prefill
     and decode ticks on ring caches, 3 train steps; (f) the sharded
     leaves of every spec tree for the ten archs x the four shapes x
     both production meshes; (a)-(d) each read the card's peak over one
     step with its inputs in place, for phase 26;
 26. the dry-run (``repro_torch.launch.dryrun``), after phase 25: (a)
     ``python -m repro_torch.launch.dryrun --arch llama3.2-3b
     --both-meshes`` at full width and depth in a subprocess, its four
     shapes traced on fake meshes of 256 and 512 ranks: every record
     "ok", per-device GiB, FLOPs, collective MiB and trace seconds
     printed; on (2, 16, 16) cross-pod bytes only at the cut's sites
     ("cut_stacked", "combined": forward, or their gradients) and in 0-d
     reductions (claim C4 per collective), none on (16, 16); (b) phase
     25's four steps traced on a one-device fake mesh: the traced
     launches by route equal phase 25's on the card exactly, the trace's
     ``hbm_per_device`` within 10% of the card's one-step peak, and
     whether the fp8 tick's transient is the whole-cache upcast; (c)
     each step's traced FLOPs over the card's ms, beside the card's
     peaks (information, no limit);
 14. the results, last (after phases 15, 16, 17, 18, 20, 21, 22, 23,
     24 and 25): a
     ``{"serving_continuous": ...}`` JSON line with phase 19's numbers, a
     ``{"privacy": ...}`` JSON line with phase 15's numbers, a
     ``{"recovery": ...}`` line with phase 16's, a ``{"psi": ...}`` line
     with phase 17's, a ``{"fit_options": ...}`` line with phase 18's, a
     ``{"kernels": [...]}`` JSON line (each entry with its
     ``recovery_launches`` in the queue crash run, its ``psi_launches``
     in phase 17's fit, its ``phase18_launches`` over phase 18's fits,
     and its ``continuous_launches`` / ``zamba2_continuous_launches`` in
     phase 19's continuous runs; cut fusion's fma entry with phase 18's
     P = 8 timing as ``p8``; the decode route with per-row lengths as
     ``block_attention.per_row``), then the ``{"ok": true, ...}`` JSON
     line last; before them a ``{"gemma2": ...}`` line with phase 22's
     numbers, an ``{"lm_train": ...}`` line with phase 20's and a
     ``{"zamba2_train": ...}`` line with phase 21's, and every kernels
     entry with its ``lm_train_launches`` over phase 20(b)'s three fits,
     its ``zamba2_train_launches`` over phase 21(b)'s and its
     ``gemma2_launches`` in phase 22(a)'s run (the fma, decode and
     per-row entries with a ``gemma2`` row: their time at gemma2's
     shapes), its ``families_launches`` over phase 23's runs and its
     ``enc_dec_vision_launches`` over phase 24's (the tc and decode
     entries with an ``enc_dec_vision`` table: their time at phase 24's
     calls) and its ``steps_launches`` over phase 25's built steps (the
     decode entry with a ``long_500k`` table: kernel 4 at 25(g)'s
     calls); a ``{"dryrun": ...}`` line with phase 26's numbers, a
     ``{"steps": ...}`` line with phase 25's numbers, a
     ``{"families": ...}`` line with phase 23's, an
     ``{"enc_dec_vision": ...}`` line with phase 24's and a
     ``{"phase_seconds": ...}`` line with each phase's wall seconds.

Without a CUDA device it prints nothing and exits 2.  It imports only
``repro_torch`` (never JAX or the JAX package ``repro``).
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# compiled flex_attention (phase 6's library time for softcapped
# attention) builds into the checkout, in this process
_BUILD = Path(__file__).resolve().parent / "build"
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(_BUILD / "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD / "triton"))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# the kernel's shapes: the path's, a ragged block, one row, odd K with
# an unaligned scale, a large one, and the serving paths' cuts (a
# prefill owner slice of 4 x 512 rows, a decode tick's 4 rows) of
# llama3.2-3b (d 3072) and zamba2-2.7b (d 2560); each in f32 and bf16
SHAPES = [(128, 64), (130, 64), (1, 128), (257, 10), (65536, 64),
          (2048, 3072), (4, 3072), (2048, 2560), (4, 2560)]
PATH_SHAPE = (128, 64)
OPS_PER_ELEMENT = 6     # abs, max, divide, round, two clamps


def inputs(shape, seed=0, specials=True, planted=True):
    """Normal rows with the edge cases planted (unless not ``planted``):
    an all-zero row, exact half-way values (absmax 127 -> scale 1), a
    ±absmax tie, then (with ``specials``) a row with a NaN, one with
    +inf, one with -inf and a subnormal row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    if not planted:
        return x
    T, K = shape
    x[0] = 0.0
    if T > 1:
        x[1] = np.float32(0.5) + np.arange(K, dtype=np.float32) % 7 - 3
        x[1, 0] = 127.0
    if T > 2:
        x[2, 0], x[2, -1] = 4.0, -4.0
    if not specials:
        return x
    for row, col, v in ((3, K // 2, np.nan), (4, 0, np.inf),
                        (5, K - 1, -np.inf)):
        if T > row:
            x[row, col] = v
    if T > 6:
        x[6] = (rng.normal(size=K) * 1e-39).astype(np.float32)
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


def _as_bits(got, want):
    """Output pairs, f32 scales viewed as their int32 bits."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        yield a, b


def same_bytes(got, want):
    """Outputs equal byte for byte (f32 scales compared as bits)."""
    import torch
    return all(torch.equal(a, b) for a, b in _as_bits(got, want))


def max_bits_diff(got, want):
    """Largest |a - b| over the outputs (f32 scales as int32 bits)."""
    return max((a.double() - b.double()).abs().max().item()
               for a, b in _as_bits(got, want))


def phase_kernels(bw, flops):
    """Phase 3: both entry points vs their plain versions, byte for
    byte, on f32 and bf16 rows (the plain version on x.float()), with
    the row plan, and rows [0, 32) of a call against a call on those
    rows alone.  Times are taken on the same shapes without the NaN,
    inf and subnormal rows (the exact division's slow path on those
    rows would set a small call's time), beside an empty kernel
    launched on the same grid (the launch floor), and again on dense
    normal rows with nothing planted (``dense_ms``: a zero dividend
    takes the division's slow path too, so at a few rows the all-zero
    row sets the call's time; a serving cut has no such row)."""
    import torch
    from repro_torch.kernels.quantize import (ops, quantize_int8,
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
            x32 = torch.from_numpy(inputs(shape)).cuda()
            t32 = torch.from_numpy(inputs(shape, specials=False)).cuda()
            d32 = torch.from_numpy(inputs(shape, planted=False)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                x, xt, xd = x32.to(dtype), t32.to(dtype), d32.to(dtype)
                got, want = kern(x), plain(x.float())
                torch.cuda.synchronize()
                if not same_bytes(got, want):
                    raise AssertionError(f"{name}{shape} {dtype}: kernel "
                                         "bytes differ from the plain "
                                         "version")
                err = max(err, max_bits_diff(got, want))
                T, K = shape
                sliced = ""
                if T > 32:          # a row's bytes do not depend on T
                    part = x[:32].clone()
                    full, alone = kern(x), kern(part)
                    torch.cuda.synchronize()
                    head = tuple(t[:32] for t in full) if isinstance(
                        full, tuple) else full[:32]
                    if not same_bytes(head, alone):
                        raise AssertionError(
                            f"{name}{shape} {dtype}: rows 0..31 differ "
                            f"from a call on them alone")
                    sliced = (f"; rows 0..31 == a call on them "
                              f"[plan {tuple(ops.plan_of(part))}], bitwise")
                p = ops.plan_of(x)
                nbytes = x.element_size() * T * K + (
                    T * (K + 4) if name == "quantize_pack_int8"
                    else T * K + 4 * T)
                bytes_ms = 1e3 * nbytes / bw
                ops_ms = 1e3 * OPS_PER_ELEMENT * T * K / flops
                row = {"shape": list(shape), "dtype": str(dtype)[6:],
                       "plan": p._asdict(),
                       "ms": device_ms(lambda: kern(xt)),
                       "dense_ms": device_ms(lambda: kern(xd)),
                       "plain_ms": device_ms(lambda: plain(xt)),
                       "floor_ms": device_ms(lambda: ops.launch_floor(xt)),
                       "eager_ms": eager_ms(lambda: kern(xt)),
                       "plain_eager_ms": eager_ms(lambda: plain(xt)),
                       "floor_eager_ms": eager_ms(
                           lambda: ops.launch_floor(xt)),
                       "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms
                       else "operations"}
                row["share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                print(f"  {name}{shape} {row['dtype']}: identical{sliced}"
                      f"\n    plan tpr {p.tpr} rpb {p.rpb} vpt {p.vpt} "
                      f"vector {int(p.vector)} wide {int(p.wide)} ("
                      f"{p.blocks(T)} blocks of {p.threads}); kernel "
                      f"{row['ms']:.6f} ms (eager {row['eager_ms']:.6f}; "
                      f"dense rows {row['dense_ms']:.6f}), "
                      f"launch floor {row['floor_ms']:.6f} ms (eager "
                      f"{row['floor_eager_ms']:.6f}), plain "
                      f"{row['plain_ms']:.6f} ms (eager "
                      f"{row['plain_eager_ms']:.6f}), bound "
                      f"{row['bound_ms']:.8f} ms ({row['bound_by']}; "
                      f"share {row['share']:.4f})")
        out[name] = {"max_abs_err": err, "rows": rows}
    return out


_RESOLVED = {}


def mnist_session(device, n=2000, combine="concat", **split):
    """The paper's config at full width with ``combine`` and any other
    ``SplitConfig`` fields (the privacy defences) replaced.  The first
    session of each (n, device) runs PSI (phase 4's is the main path's);
    later ones start from a copy of that resolved session: the same
    computation on the same parties, which phase 17 drives in depth."""
    import copy
    import dataclasses
    from repro_torch.configs import CONFIG
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    key = (n, str(device))
    if key not in _RESOLVED:
        s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
            n, seed=0, keep_frac=0.9)), device=device)
        stats = s.resolve(group="modp512")
        _RESOLVED[key] = (copy.deepcopy(s), stats)
    base, stats = _RESOLVED[key]
    s = copy.deepcopy(base)
    s.build(dataclasses.replace(CONFIG, split=dataclasses.replace(
        CONFIG.split, combine=combine, **split)))
    return s, stats


def kernel_modules():
    from repro_torch.kernels import block_attention, cut_fusion, mamba2_scan
    from repro_torch.kernels import quantize
    return (quantize, cut_fusion, block_attention, mamba2_scan)


def reset_counts():
    """Every kernel's launch count to 0."""
    for k in kernel_modules():
        k.reset_launch_counts()


def read_counts():
    import torch
    torch.cuda.synchronize()
    return {n: c for k in kernel_modules() for n, c in k.launch_counts.items()}


def trunk_forwards(session, schedule="pipelined", microbatches=1,
                   evaluates=1, steps=None):
    """The cut-fusion launches a fit of ``session`` implies: one per
    trunk forward.  Pipelined split: cut gradient and weight gradient,
    two per chunk, for every step and for the warmup chunks; sequential
    split: one fused step per step and warmup; the microbatched joint
    oracle (and the masked oracle, at any M): two per chunk, no warmup;
    the joint step: one per step.  Each ``evaluate`` adds one per batch
    of 512 held-out rows.  ``steps``: the steps run (replays included),
    by default the loss trail's length."""
    if steps is None:
        steps = len(session.history["loss_trail"])
    per_eval = -(-len(session._eval_idx) // 512)
    M = microbatches
    if schedule == "pipelined":
        n = 2 * M * (steps + 1)
    elif schedule == "sequential":
        n = steps + 1
    elif schedule == "joint":
        n = 2 * M * steps if M > 1 else steps
    elif schedule == "oracle":
        n = 2 * M * steps
    return n + evaluates * per_eval


def check_counts(counts, need, what):
    print(f"  kernel launches in {what}: "
          f"{ {k: counts[k] for k in need} } (needed exactly {need})")
    for k, n in need.items():
        if counts[k] != n:
            raise AssertionError(f"{what}: {k} launched {counts[k]} != "
                                 f"{n} times")


def phase_main_path():
    """Phase 4: the paper's path at full width, through the int8 and
    cut-fusion kernels."""
    import torch
    reset_counts()
    t0 = time.time()
    session, stats = mnist_session("cuda")
    h = session.fit(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
                    compression="int8", backend="queue", verbose=True)
    ev = session.evaluate()
    counts = read_counts()
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
    # int8: every cut (owners) and every cut gradient (scientist), the
    # warmup's included; cut fusion: every trunk forward, the fit's
    # epoch-end evaluation and the one above included
    n_cut = trunk_forwards(session, evaluates=2)
    check_counts(counts, {
        "quantize_pack_int8": 2 * owners * (steps + 1),
        "cut_fusion": n_cut, "cut_fusion.fma": n_cut, "cut_fusion.tc": 0},
        "the run")
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
    cut = path_cut_timing(session)
    profile_epoch(session)
    return counts, ts, cut


def path_cut_timing(session):
    """The int8 kernel on the training path's own traffic: owner 0's cut
    (its ReLU head on the first batch of subjects, at the fit's
    weights), its share of zeros, and its time beside dense normal rows
    of the same shape and the launch floor, all in this call."""
    import numpy as np
    import torch
    from repro_torch.kernels.quantize import (ops, quantize_pack_int8,
                                              quantize_pack_int8_ref)
    head_fwd, _ = session.adapter.owner_programs(0)
    hp = session.adapter.owner_param_slice(session.params, 0)
    feats = session.owners[0]._features[:PATH_SHAPE[0]]
    cut = head_fwd(hp, torch.from_numpy(np.ascontiguousarray(
        feats, np.float32)).cuda()).contiguous()
    if tuple(cut.shape) != PATH_SHAPE:
        raise AssertionError(f"owner cut {tuple(cut.shape)}, expected "
                             f"{PATH_SHAPE}")
    if not same_bytes(quantize_pack_int8(cut), quantize_pack_int8_ref(cut)):
        raise AssertionError("kernel bytes differ from the plain version "
                             "on the path's cut")
    dense = torch.from_numpy(inputs(PATH_SHAPE, planted=False)).cuda()
    res = {"shape": list(PATH_SHAPE),
           "zero_share": (cut == 0).double().mean().item(),
           "ms": device_ms(lambda: quantize_pack_int8(cut)),
           "dense_ms": device_ms(lambda: quantize_pack_int8(dense)),
           "floor_ms": device_ms(lambda: ops.launch_floor(cut))}
    print(f"  the path's cut {PATH_SHAPE} (owner 0's ReLU head): zero share "
          f"{res['zero_share']:.4f}; kernel {res['ms']:.6f} ms, on dense "
          f"rows {res['dense_ms']:.6f} ms, launch floor "
          f"{res['floor_ms']:.6f} ms")
    return res


def read_profile(prof):
    """A finished ``torch.profiler`` profile read in one pass over its raw
    events, by the rules of ``prof.events()`` / ``key_averages()`` but
    without the tree of event objects they build (40–80 s for a wave of
    10^5 host ops).  Returns ``(kernels, top, host)``: ``kernels``
    {device event name: [count, us]}; ``top`` the aten ops whose parent
    is no aten op; ``host`` {host op name: [count, self us]}.  A host
    op's parent is the innermost synchronous host op around it on its
    thread, as in the tree."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    kernels, host, threads = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (_filter_name(name)
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.is_async() or e.start_thread_id() != e.end_thread_id()):
            continue
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (e.end_ns() - e.start_ns()) / 1e3
        elif e.device_type() == DeviceType.CPU:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), name))
    top = 0

    # a stack entry: [start, end, name, children's ns, children, whether
    # the last child has the entry's name]; the tree folds an only child
    # of the same name into its parent (``_remove_dup_nodes``)
    def close(ev):
        h = host.setdefault(ev[2], [0, 0.0])
        h[0] += 1 - (ev[4] == 1 and ev[5])
        h[1] += (ev[1] - ev[0] - ev[3]) / 1e3

    for evs in threads.values():
        evs.sort(key=lambda ev: (ev[0], -ev[1]))
        stack = []
        for s, t, name in evs:
            while stack and (s >= stack[-1][1] or t > stack[-1][1]):
                close(stack.pop())
            parent = stack[-1] if stack else None
            if name.startswith("aten::") and (
                    parent is None or not parent[2].startswith("aten::")):
                top += 1
            if parent is not None:
                parent[3] += t - s
                parent[4] += 1
                parent[5] = name == parent[2]
            stack.append([s, t, name, 0, 0, False])
        while stack:
            close(stack.pop())
    return kernels, top, host


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
    reset_counts()
    hj = joint.fit(**kw)
    check_counts(read_counts(), {"cut_fusion": trunk_forwards(
        joint, "joint")}, "the joint fit")
    for schedule in ("pipelined", "sequential"):
        split, _ = mnist_session("cuda")
        reset_counts()
        hs = split.fit(**kw, mode="split", schedule=schedule,
                       backend="queue")
        check_counts(read_counts(), {"cut_fusion": trunk_forwards(
            split, schedule)}, f"the split ({schedule}) fit")
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


# ---------------------------------------------------------------------------
# Split-LM serving (llama3.2-3b) and its attention kernel
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA's data sheet)
LM = "llama3.2-3b"
ZAMBA = "zamba2-2.7b"
SLOTS, CTX, NEW = 4, 1024, 32
# the reference's kernel cases (tests/test_kernels.py ATTN_CASES):
# B, Sq, Skv, nh, nkv, hd, kind, window, softcap
ATTN_CASES = [
    (2, 128, 128, 4, 4, 64, "causal", 0, 0.0),
    (2, 256, 256, 8, 2, 64, "causal", 0, 0.0),
    (1, 192, 192, 4, 2, 128, "local", 64, 0.0),
    (1, 128, 128, 2, 2, 64, "bidir", 0, 0.0),
    (1, 256, 256, 4, 2, 64, "causal", 0, 50.0),
    (2, 100, 100, 4, 4, 32, "causal", 0, 0.0),
]
# queries over a cache: ... + q_offset, kv_len
DECODE_CASES = [
    (2, 1, 96, 6, 2, 64, "causal", 0, 0.0, 40, 41),
    (2, 16, 128, 4, 2, 64, "causal", 0, 0.0, 32, 48),
    (1, 1, 80, 4, 4, 32, "local", 16, 0.0, 50, 51),
    (1, 8, 130, 4, 1, 128, "causal", 0, 30.0, 100, 108),
]
# the serving path's calls at llama3.2-3b width (24 q heads, 8 kv
# heads, hd 128), engine at 4 slots, ctx 1024, 32 new tokens: head
# prefill over a head cache of 512 + 33, trunk prefill over 1024 + 33,
# and a trunk decode step 16 tokens in
PATH_CASES = {
    "head_prefill": (4, 512, 545, 24, 8, 128, "causal", 0, 0.0, 0, 512),
    "trunk_prefill": (4, 1024, 1057, 24, 8, 128, "causal", 0, 0.0, 0, 1024),
    "trunk_decode": (4, 1, 1057, 24, 8, 128, "causal", 0, 0.0, 1040, 1041),
    # zamba2-2.7b's shared attention block (32 heads, MHA, hd 80: the
    # kernel's hd-128 instantiation with the columns past 80 zeroed)
    "zamba2_head_prefill": (4, 512, 545, 32, 32, 80, "causal", 0, 0.0, 0,
                            512),
    "zamba2_trunk_prefill": (4, 1024, 1057, 32, 32, 80, "causal", 0, 0.0, 0,
                             1024),
    "zamba2_trunk_decode": (4, 1, 1057, 32, 32, 80, "causal", 0, 0.0, 1040,
                            1041),
    # gemma2-9b's (16 q heads, 8 kv heads, hd 256, softcap 50; phase 22):
    # a global layer's head prefill over its cache of 512 + 33 and trunk
    # prefill over 1024 + 33, a local layer's ring prefill over its own
    # 1024 keys (window 4096), and a local layer's ring decode 16 tokens
    # in: bidir over the 1057 slots, the first 1041 valid.  hd 256 takes
    # the fma route in bf16
    "gemma2_head_prefill": (4, 512, 545, 16, 8, 256, "causal", 0, 50.0, 0,
                            512),
    "gemma2_trunk_prefill": (4, 1024, 1057, 16, 8, 256, "causal", 0, 50.0,
                             0, 1024),
    "gemma2_trunk_prefill_local": (4, 1024, 1024, 16, 8, 256, "local",
                                   4096, 50.0, 0, None),
    "gemma2_trunk_decode_ring": (4, 1, 1057, 16, 8, 256, "bidir", 0, 50.0,
                                 0, 1041),
}
HEADLINE = "trunk_prefill"
GEMMA_HEADLINE = "gemma2_trunk_prefill"
# gemma2's ring decode with per-row lengths (continuous batching): the
# four slots 1 to 32 tokens past the context, bidir over 1057 slots
GEMMA_RING_ROWS = (1025, 1041, 1057, 1033)
# q's scale in the softcapped path cases: N(0, 1) inputs at hd 256 give
# scores of about N(0, 1), where a cap of 50 moves a score by at most
# ~1e-2 and cannot be told from no cap; x20 gives scores of about N(0,
# 400), well inside tanh's bend, so a kernel at another cap (30, or none)
# fails the tolerance (``cap_is_seen``)
CAP_Q_SCALE = 20.0
# calls in which some query row sees no key (the reference gives such a
# row the mean of V over all Skv keys): kv_len 0, a local window wholly
# past kv_len, windows that leave only the last rows without a key; run
# on every route that takes them
EMPTY_ROW_CASES = [
    (2, 1, 96, 6, 2, 64, "causal", 0, 0.0, 40, 0),
    (1, 1, 80, 4, 4, 32, "local", 8, 0.0, 90, 60),
    (1, 16, 130, 4, 2, 64, "local", 8, 0.0, 100, 105),
    (1, 128, 200, 4, 2, 64, "local", 16, 0.0, 40, 100),
    (2, 100, 150, 4, 4, 64, "causal", 0, 10.0, 0, 0),
    (1, 80, 96, 2, 2, 32, "bidir", 0, 0.0, 0, 0),
]


def live_pairs(Sq, Skv, kind, window, q_offset, kv_len):
    """(query, key) pairs the mask keeps — the work these inputs need
    (the port's count, which the dry-run's trace adds per launch)."""
    from repro_torch.kernels.block_attention import plan
    return plan.live_pairs(Sq, Skv, kind, window, q_offset, kv_len)


def attn_bound(case, dtype, bw, f32_flops):
    """4·nh·hd FLOP a live pair; q, o and the keys and values up to
    ``kv_lim`` moved once (``plan.work``, the trace's count too)."""
    B, Sq, Skv, nh, nkv, hd, kind, window, _cap, q_off, kv_len = case
    import torch
    from repro_torch.kernels.block_attention import plan
    elt = 2 if dtype == torch.bfloat16 else 4
    flops, nbytes = plan.work(B, Sq, Skv, nh, nkv, hd, elt, kind, window,
                              [q_off] * B, [kv_len] * B)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else f32_flops
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / peak
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), flops


def phase_attention(bw, f32_flops):
    """Phase 6: the attention kernels vs their plain version on the card,
    each case on the route the wrapper picks; at the path's shapes the
    route's time beside the fma route's (the private ``ops._launch``),
    the plain version's, SDPA's and the bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.block_attention import (attention_ref,
                                                     block_attention, ops,
                                                     route_of)
    from repro_torch.kernels.block_attention.plan import ROUTES
    from repro_torch.kernels.block_attention.ref import attention_mask
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    err, rows, seen = {r: 0.0 for r in ROUTES}, {}, set()
    cases = [(f"case{i}", c + (0, None)) for i, c in enumerate(ATTN_CASES)]
    cases += [(f"cache{i}", c) for i, c in enumerate(DECODE_CASES)]
    cases += [(f"path:{n}", c) for n, c in PATH_CASES.items()]
    for name, case in cases:
        B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_off, kv_len = case
        rng = np.random.default_rng(0)
        base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .cuda() for s in ((B, Sq, nh, hd), (B, Skv, nkv, hd),
                                  (B, Skv, nkv, hd))]
        path = name.startswith("path")
        if path and cap:
            base[0] *= CAP_Q_SCALE
        dtypes = [torch.bfloat16] if path else [torch.float32, torch.bfloat16]
        for dt in dtypes:
            q, k, v = (t.to(dt) for t in base)
            kw = dict(kind=kind, window=window, softcap=cap,
                      q_offset=q_off, kv_len=kv_len)
            route = route_of(q, k, v)
            seen.add(route)
            got = block_attention(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs()
            lim = tol[dt] + tol[dt] * want.float().abs()
            if not bool((e <= lim).all()) or not torch.isfinite(got).all():
                raise AssertionError(
                    f"attention {name} {dt} ({route}): kernel vs plain max "
                    f"|diff| {e.max().item():.3e} beyond atol=rtol={tol[dt]}")
            err[route] = max(err[route], e.max().item())
            print(f"  {name} {tuple(q.shape)} kv {Skv} {kind} "
                  f"{str(dt)[6:]} [{route}]: max |diff| "
                  f"{e.max().item():.3e} (tol {tol[dt]})")
            if not path:
                continue
            if cap:
                cap_is_seen(name, lambda c: block_attention(
                    q, k, v, **dict(kw, softcap=c)), want, tol[dt])
            need = ("decode" if Sq == 1 else
                    "tc" if hd <= 128 else "fma")   # bf16 hd 256: fma
            if route != need:
                raise AssertionError(f"attention {name}: route {route}, "
                                     f"the serving path needs {need}")
            bound, by, flops = attn_bound(case, dt, bw, f32_flops)
            # the library: SDPA, which has no softcap; with a cap, compiled
            # flex_attention, with SDPA's uncapped time beside it
            sdpa = sdpa_call(q, k, v, case[:8] + (0.0,) + case[9:],
                             attention_mask)
            # the library's fastest kernels are not deterministic ones
            torch.use_deterministic_algorithms(False)
            sdpa_ms = device_ms(sdpa, reps=10, rounds=7)
            library, compile_s = (flex_call(q, k, v, case) if cap
                                  else (sdpa, 0.0))
            lib_err = library_matches(name, library(), want, tol[dt])
            library_ms = (device_ms(library, reps=10, rounds=7) if cap
                          else sdpa_ms)
            torch.use_deterministic_algorithms(True)
            fma = ops._launch("fma", q, k, v, **kw)
            fma_err = (fma.float() - want.float()).abs().max().item()
            row = {"shape": [list(q.shape), list(k.shape)],
                   "q_offset": q_off, "kv_len": kv_len, "route": route,
                   "ms": device_ms(lambda: block_attention(q, k, v, **kw),
                                   reps=10, rounds=7),
                   "fma_ms": device_ms(lambda: ops._launch("fma", q, k, v,
                                                           **kw),
                                       reps=10, rounds=7),
                   "fma_max_abs_err": fma_err,
                   "plain_ms": device_ms(lambda: attention_ref(q, k, v,
                                                               **kw),
                                         reps=5, rounds=5),
                   "library_ms": library_ms,
                   "library": "flex_attention" if cap else "sdpa",
                   "library_compile_s": compile_s,
                   "sdpa_uncapped_ms": sdpa_ms if cap else None,
                   "eager_ms": eager_ms(lambda: block_attention(q, k, v,
                                                                **kw),
                                        reps=10, rounds=5),
                   "bound_ms": bound, "bound_by": by, "flops": flops,
                   "max_abs_err": e.max().item(),
                   "library_max_abs_err": lib_err}
            row["tflops"] = flops / row["ms"] / 1e9
            row["fma_over_route"] = row["fma_ms"] / row["ms"]
            rows[name[5:]] = row
            lib = (f"SDPA {library_ms:.6f} ms (|diff| {lib_err:.2e})"
                   if not cap else f"flex_attention {library_ms:.6f} ms "
                   f"(|diff| {lib_err:.2e}, compiled in {compile_s:.2f} s)"
                   f", SDPA without the softcap (another function) "
                   f"{sdpa_ms:.6f} ms")
            print(f"    {route} {row['ms']:.6f} ms ({row['tflops']:.2f} "
                  f"TFLOP/s; eager {row['eager_ms']:.6f}); fma route "
                  f"{row['fma_ms']:.6f} ms (x{row['fma_over_route']:.2f}, "
                  f"|diff| {fma_err:.2e}); plain {row['plain_ms']:.6f} ms;"
                  f" {lib}; bound {row['bound_ms']:.6f} ms ({by})")
    missing = [r for r in ROUTES if r not in seen]
    if missing:
        raise AssertionError(f"attention routes never exercised: {missing}")
    rows["gemma2_ring_per_row"] = gemma_ring_rows(bw, f32_flops, tol)
    empty_seen = set()
    for i, case in enumerate(EMPTY_ROW_CASES):
        B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_off, kv_len = case
        rng = np.random.default_rng(0)
        base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .cuda() for s in ((B, Sq, nh, hd), (B, Skv, nkv, hd),
                                  (B, Skv, nkv, hd))]
        kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_off,
                  kv_len=kv_len)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dt) for t in base)
            want = attention_ref(q, k, v, **kw)
            for route in ROUTES:
                if route == "decode" and Sq * nh // nkv > 64:
                    continue
                if route == "tc" and dt != torch.bfloat16:
                    continue
                got = ops._launch(route, q, k, v, **kw)
                torch.cuda.synchronize()
                e = (got.float() - want.float()).abs()
                lim = tol[dt] + tol[dt] * want.float().abs()
                if not bool((e <= lim).all()) or \
                        not torch.isfinite(got).all():
                    raise AssertionError(
                        f"attention empty{i} {dt} ({route}): kernel vs plain"
                        f" max |diff| {e.max().item():.3e} beyond "
                        f"atol=rtol={tol[dt]}")
                err[route] = max(err[route], e.max().item())
                empty_seen.add(route)
                print(f"  empty{i} {tuple(q.shape)} kv {Skv} {kind} "
                      f"q_offset {q_off} kv_len {kv_len} {str(dt)[6:]} "
                      f"[{route}]: max |diff| {e.max().item():.3e} (rows "
                      f"with no key: the mean of V)")
    missing = [r for r in ROUTES if r not in empty_seen]
    if missing:
        raise AssertionError(f"rows with no key never run on: {missing}")
    return {"max_abs_err": err, "rows": rows}


def gemma_ring_rows(bw, f32_flops, tol):
    """gemma2's ring decode with one kv length per row
    (``GEMMA_RING_ROWS``, bidir, q_offset 0): within tolerance of the
    plain version, every row bitwise a scalar call at its length, timed
    beside the scalar call at the longest length."""
    import numpy as np
    import torch
    from repro_torch.kernels.block_attention import (attention_ref,
                                                     block_attention)
    case = PATH_CASES["gemma2_trunk_decode_ring"]
    B, Sq, Skv, nh, nkv, hd, kind, window, cap = case[:9]
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                * scale).cuda().to(torch.bfloat16)
               for s, scale in (((B, Sq, nh, hd), CAP_Q_SCALE),
                                ((B, Skv, nkv, hd), 1.0),
                                ((B, Skv, nkv, hd), 1.0)))
    lens = torch.tensor(GEMMA_RING_ROWS)
    lens_dev = lens.cuda()     # the plain version's mask, under a graph
    kw = dict(kind=kind, window=window, softcap=cap, q_offset=0)
    got = block_attention(q, k, v, kv_len=lens, **kw)
    want = attention_ref(q, k, v, kv_len=lens, **kw).float()
    torch.cuda.synchronize()
    e = (got.float() - want).abs()
    if not bool((e <= tol[torch.bfloat16] * (1 + want.abs())).all()):
        raise AssertionError(f"gemma2 per-row ring decode: max |diff| "
                             f"{e.max().item():.3e}")
    cap_is_seen("gemma2 per-row ring decode", lambda c: block_attention(
        q, k, v, kv_len=lens, **dict(kw, softcap=c)), want,
        tol[torch.bfloat16])
    torch.use_deterministic_algorithms(False)
    library, compile_s = flex_call(q, k, v, case, lens=lens_dev)
    lib_err = library_matches("gemma2 per-row ring decode", library(), want,
                              tol[torch.bfloat16])
    library_ms = device_ms(library, reps=10, rounds=7)
    torch.use_deterministic_algorithms(True)
    for b, n in enumerate(GEMMA_RING_ROWS):
        alone = block_attention(q, k, v, kv_len=n, **kw)
        if not torch.equal(got[b], alone[b]):
            raise AssertionError(f"gemma2 per-row ring decode: row {b} != "
                                 f"a scalar call at kv_len {n}")
    # each row reads its own keys: bf16 q, o of one row and k, v of its
    # kv_len slots; 4 hd flops per (query, key) pair
    nbytes = sum(2 * (2 * Sq * nh * hd + 2 * n * nkv * hd)
                 for n in GEMMA_RING_ROWS)
    flops = sum(4 * nh * hd * Sq * n for n in GEMMA_RING_ROWS)
    bound = max(1e3 * nbytes / bw, 1e3 * flops / BF16_FLOPS)
    row = {"shape": [list(q.shape), list(k.shape)],
           "kv_lens": list(GEMMA_RING_ROWS), "route": "decode",
           "max_abs_err": e.max().item(),
           "ms": device_ms(lambda: block_attention(q, k, v, kv_len=lens,
                                                   **kw), reps=10,
                           rounds=7),
           "scalar_ms": device_ms(lambda: block_attention(
               q, k, v, kv_len=max(GEMMA_RING_ROWS), **kw), reps=10,
               rounds=7),
           "plain_ms": device_ms(lambda: attention_ref(
               q, k, v, kv_len=lens_dev, **kw), reps=5, rounds=5),
           "bound_ms": bound, "bound_by": ("bytes" if nbytes / bw >= flops
                                           / BF16_FLOPS else "operations"),
           "library_ms": library_ms, "library": "flex_attention",
           "library_max_abs_err": lib_err, "library_compile_s": compile_s}
    print(f"  gemma2 ring decode, per-row kv_len {list(GEMMA_RING_ROWS)} "
          f"(bidir, softcap {cap}) [decode]: max |diff| "
          f"{row['max_abs_err']:.3e}; every row == a scalar call at its "
          f"length, bitwise; {row['ms']:.6f} ms beside the scalar call at "
          f"{max(GEMMA_RING_ROWS)} {row['scalar_ms']:.6f} ms; plain "
          f"{row['plain_ms']:.6f} ms; flex_attention {library_ms:.6f} ms "
          f"(|diff| {lib_err:.2e}, compiled in {compile_s:.2f} s); bound "
          f"{bound:.6f} ms")
    return row


def cap_is_seen(what, call, want, tol):
    """The case can tell the softcap: ``call(cap)`` (the kernel at
    another cap) at cap 30 and at no cap each fail the tolerance against
    ``want``, the plain version at the case's cap."""
    import torch
    want = want.float()
    lim = tol + tol * want.abs()
    seen = []
    for wrong in (30.0, 0.0):
        got = call(wrong)
        torch.cuda.synchronize()
        e = (got.float() - want).abs()
        n = int((e > lim).sum())
        if n == 0:
            raise AssertionError(f"{what}: the kernel at softcap {wrong:g} "
                                 f"passes atol=rtol={tol}: the case cannot "
                                 f"see the cap")
        seen.append(f"cap {wrong:g}: max |diff| {e.max().item():.3e}, "
                    f"{n} of {e.numel()} values past the tolerance")
    print(f"    the case sees the cap: the kernel at {'; at '.join(seen)}")


def library_matches(what, got, want, tol):
    """The library's output within the kernel's tolerance of the plain
    version (the yardstick computes the same function); its max |diff|."""
    import torch
    torch.cuda.synchronize()
    want = want.float()
    e = (got.float() - want).abs()
    if not bool((e <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{what}: the library's call vs plain max "
                             f"|diff| {e.max().item():.3e} beyond "
                             f"atol=rtol={tol}")
    return e.max().item()


_FLEX = {}


def flex_call(q, k, v, case, lens=None):
    """One compiled ``flex_attention`` call that computes a softcapped
    case's function: the cap as a tanh ``score_mod``, the case's mask as
    a block mask over its valid keys (``lens``: one kv length per row, a
    (B,) tensor on the card), GQA by ``enable_gqa``.  Compiled (and run
    once) here; returns (the call, the seconds of that first call).
    Timed as the library's time for softcapped attention only; the port
    never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_off, kv_len = case
    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    fn = _FLEX["fn"]
    if lens is None:
        lens = torch.full((B,), Skv if kv_len is None else kv_len,
                          device=q.device)

    def mask_mod(b, h, i, j):
        qp = i + q_off
        keep = j < lens[b]
        if kind == "causal":
            keep = keep & (j <= qp)
        elif kind == "local":
            keep = keep & (j <= qp) & (j > qp - window)
        return keep

    def score_mod(s, b, h, i, j):
        return cap * torch.tanh(s / cap)

    mask = create_block_mask(mask_mod, B, None, Sq, Skv, device=q.device)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        return fn(qh, kh, vh, score_mod=score_mod, block_mask=mask,
                  enable_gqa=True).transpose(1, 2)
    t = time.time()
    call()
    torch.cuda.synchronize()
    return call, time.time() - t


def sdpa_call(q, k, v, case, attention_mask):
    """One ``scaled_dot_product_attention`` call that computes the case's
    function, in its fastest form: the valid keys ``[:kv_len]`` sliced
    (views), ``is_causal`` for a causal prefill from position 0, no mask
    for bidir or for a decode step that sees every valid key, else a
    boolean mask.
    Timed as a yardstick only; the port never calls it."""
    import torch
    B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_off, kv_len = case
    if cap:
        raise ValueError("SDPA has no soft-capping")
    kv_lim = min(Skv, kv_len if kv_len is not None else Skv)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k[:, :kv_lim],
                                              v[:, :kv_lim]))
    kw = dict(enable_gqa=True)
    if kind == "causal" and q_off == 0:
        kw["is_causal"] = True
    elif kind != "bidir" and not (kind == "causal" and Sq == 1
                                  and kv_lim <= q_off + 1):
        kw["attn_mask"] = attention_mask(
            q_off + torch.arange(Sq, device=q.device),
            torch.arange(kv_lim, device=q.device), kind, window, None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kh, vh, **kw).transpose(1, 2)


# ---------------------------------------------------------------------------
# The SSD scan kernel (zamba2-2.7b's Mamba2 blocks)
# ---------------------------------------------------------------------------

# the reference's SSD kernel cases (tests/test_kernels.py SSD_CASES), then
# chunks of several 64-row tiles with a ragged last chunk, ragged tiles
# with 3 groups, and a chunk shorter than a tile: B, S, H, P, G, N, chunk
SSD_CASES = [
    (2, 128, 4, 32, 1, 16, 32),
    (1, 96, 4, 32, 2, 16, 32),
    (2, 256, 8, 64, 1, 64, 64),
    (1, 64, 2, 16, 1, 8, 64),
    (1, 300, 2, 64, 1, 64, 256),
    (2, 200, 6, 32, 3, 16, 96),
    (1, 40, 2, 16, 1, 8, 128),
]
# zamba2-2.7b's prefill scans (d_in 5120 = 80 heads of 64, one group of
# 64 states, chunks of 256) at 4 slots: each owner's head over its 512
# tokens, the trunk over 1024
SCAN_PATH_CASES = {"head_prefill": (4, 512, 80, 64, 1, 64, 256),
                   "trunk_prefill": (4, 1024, 80, 64, 1, 64, 256)}


def scan_inputs(B, S, H, P, G, N, seed=0):
    """The reference kernel test's distributions, f32 numpy: normal x, B,
    C; dt uniform in [0.001, 0.1]; A uniform in [-2, -0.5]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32))


def conv_out_views(x, Bi, Ci, dtype):
    """x, B, C as strided views of one (B, S, H*P + 2*G*N) buffer on the
    card, as the Mamba2 block hands them to the scan."""
    import torch
    Bb, S, H, P = x.shape
    G, N = Bi.shape[2], Bi.shape[3]
    buf = torch.cat([torch.from_numpy(a).reshape(Bb, S, -1)
                     for a in (x, Bi, Ci)], -1).to("cuda", dtype)
    hp, gn = H * P, G * N
    return (buf[..., :hp].reshape(Bb, S, H, P),
            buf[..., hp:hp + gn].reshape(Bb, S, G, N),
            buf[..., hp + gn:].reshape(Bb, S, G, N))


def scan_bound(case, dtype, bw, f32_flops, with_init):
    """Each input read once and each output written once (x, y, B, C in
    ``dtype``; dt, A and the states in f32) over the memory rate, and the
    causal work (scores and M.x over the live (i, j <= i) pairs, the
    inter-chunk term and the state update) over the peak rate."""
    import torch
    from repro_torch.kernels.mamba2_scan import plan
    B, S, H, P, G, N, chunk = case
    elt = 2 if dtype == torch.bfloat16 else 4
    flops, nbytes = plan.work(B, S, H, P, G, N, chunk, elt, with_init)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else f32_flops
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / peak
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), flops, nbytes


def phase_scan(bw, f32_flops):
    """Phase 9: the SSD scan kernels vs their plain version on the card,
    each case on the route the wrapper picks and, where the chunked
    route applies, on the serial route too; at the path's shapes both
    routes timed in one call."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2_scan import (mamba2_scan, ops, route_of,
                                                 ssd_chunked)
    from repro_torch.kernels.mamba2_scan.plan import ROUTES
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    err = {r: 0.0 for r in ROUTES}
    worst, rows = 0.0, {}
    cases = [(f"case{i}", c) for i, c in enumerate(SSD_CASES)]
    cases += [(f"path:{n}", c) for n, c in SCAN_PATH_CASES.items()]
    for name, case in cases:
        B, S, H, P, G, N, chunk = case
        x, dt, A, Bi, Ci = scan_inputs(B, S, H, P, G, N)
        dt, A = (torch.from_numpy(a).cuda() for a in (dt, A))
        s0 = torch.from_numpy(np.random.default_rng(1).normal(
            size=(B, H, N, P)).astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            xv, bv, cv = conv_out_views(x, Bi, Ci, dtype)
            for init in (None, s0):
                route = route_of(xv, bv, cv, init)
                both = [route] + (["serial"] if route == "chunked" else [])
                want = ssd_chunked(xv, dt, A, bv, cv, chunk,
                                   initial_state=init)
                for r_ in both:
                    got = ops._launch(r_, xv, dt, A, bv, cv, chunk=chunk,
                                      initial_state=init)
                    torch.cuda.synchronize()
                    e = r = 0.0
                    for a, b in zip(got, want):
                        d = (a.float() - b.float()).abs()
                        # |diff| over its limit atol + rtol |plain|, <= 1
                        q = d / (tol[dtype] + tol[dtype] * b.float().abs())
                        e, r = max(e, d.max().item()), max(r, q.max().item())
                        if r > 1.0 or not torch.isfinite(a).all():
                            raise AssertionError(
                                f"scan {name} {dtype} ({r_}): kernel vs "
                                f"plain max |diff| {d.max().item():.3e} "
                                f"beyond atol=rtol={tol[dtype]}")
                    err[r_], worst = max(err[r_], e), max(worst, r)
                    print(f"  {name} (B, S, H, P, G, N, chunk) {case} "
                          f"{str(dtype)[6:]}, "
                          f"{'state' if init is not None else 'zero'} init "
                          f"[{r_}]: max |diff| {e:.3e}, max |diff| / (atol "
                          f"+ rtol |plain|) {r:.3f} (atol=rtol={tol[dtype]})")
            if not name.startswith("path") or dtype != torch.bfloat16:
                continue
            # timed as the path calls it: bf16, the fresh cache's zero
            # state as initial_state; the serial route in the same call
            z = torch.zeros_like(s0)
            if route_of(xv, bv, cv, z) != "chunked":
                raise AssertionError(f"scan {name}: the serving path's "
                                     "prefill needs the chunked route")
            bound, by, flops, nbytes = scan_bound(case, dtype, bw,
                                                  f32_flops, True)
            row = {"shape": list(case), "bound_ms": bound, "bound_by": by,
                   "flops": flops, "bytes": nbytes, "route": "chunked",
                   "ms": device_ms(lambda: mamba2_scan(
                       xv, dt, A, bv, cv, chunk=chunk, initial_state=z),
                       reps=10, rounds=7),
                   "serial_ms": device_ms(lambda: ops._launch(
                       "serial", xv, dt, A, bv, cv, chunk=chunk,
                       initial_state=z), reps=10, rounds=7),
                   "plain_ms": device_ms(lambda: ssd_chunked(
                       xv, dt, A, bv, cv, chunk, initial_state=z),
                       reps=3, rounds=5),
                   "eager_ms": eager_ms(lambda: mamba2_scan(
                       xv, dt, A, bv, cv, chunk=chunk, initial_state=z),
                       reps=10, rounds=5),
                   "library_ms": None}
            row["tflops"] = flops / row["ms"] / 1e9
            row["gbps"] = nbytes / row["ms"] / 1e6
            row["serial_over_chunked"] = row["serial_ms"] / row["ms"]
            rows[name[5:]] = row
            print(f"    chunked {row['ms']:.6f} ms ({row['tflops']:.2f} "
                  f"TFLOP/s, {row['gbps']:.1f} GB/s; eager "
                  f"{row['eager_ms']:.6f}); serial {row['serial_ms']:.6f} "
                  f"ms (x{row['serial_over_chunked']:.2f}); plain "
                  f"{row['plain_ms']:.6f} ms; bound {row['bound_ms']:.6f} "
                  f"ms ({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} "
                  f"MB)")
    return {"max_abs_err": err, "tol_ratio": worst, "rows": rows}


def lm_contexts(vocab, n, length, seed=0):
    from repro_torch.data import make_token_dataset
    return make_token_dataset(n, length, vocab, seed)[:, :length]


def phase_serving(arch, n_layers=None, profile=False, **engine_kw):
    """Phases 7, 10, 22(a) and 23: ``arch`` at full width (at its depth,
    or cut to ``n_layers``) behind the wave engine over the queue
    transport with the int8 cut codec (``engine_kw``: further engine
    options); ``profile``: one more wave under torch.profiler for the
    busy share.  With an MoE FFN, the choices each call dropped past
    its capacity are counted (the reference's rule)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import block_attention as attn
    from repro_torch.kernels import mamba2_scan as scan
    from repro_torch.kernels import quantize
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models import moe
    from repro_torch.models.model import SplitModel
    from repro_torch.models.transformer import ATTENTION
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = SplitModel(cfg)
    t = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_heads = sum(p.numel() for p in tree_leaves(params["heads"]))
    print(f"  {arch}: {n_params / 1e9:.3f} G params (f32, "
          f"{4 * n_params / 1e9:.2f} GB; heads {n_heads / 1e9:.3f} G, "
          f"trunk {(n_params - n_heads) / 1e9:.3f} G) on the card in "
          f"{time.time() - t:.2f} s; {model.n_head_units} head units x "
          f"{model.P} owners, {model.n_trunk_units} trunk units")
    ctxs = lm_contexts(cfg.vocab, 2 * SLOTS, CTX)
    kw = dict(batch_slots=SLOTS, ctx_len=CTX, max_new=NEW,
              transport="queue", compression="int8", device="cuda",
              **engine_kw)

    warm = ServingEngine(model, params, **dict(kw, max_new=2))
    for c in ctxs[:SLOTS]:
        warm.submit(c)
    warm.run()

    eng = ServingEngine(model, params, **kw)
    pre_s, dec_s = [], []
    eng._split_prefill = synced(eng._split_prefill, pre_s)
    eng._split_decode = synced(eng._split_decode, dec_s)
    rids = [eng.submit(c) for c in ctxs]
    for k in (attn, scan, quantize):
        k.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keeps, route = [], moe.route
    if cfg.moe is not None:
        # every routed group's keep mask (route's sixth output), counted
        # after the run: no sync inside the wave
        def counted(*a):
            r = route(*a)
            keeps.append(r[5])
            return r
        moe.route = counted
    try:
        t = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        moe.route = route
    drops = [(k.numel(), int((~k).sum())) for k in keeps]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {**attn.launch_counts, **scan.launch_counts,
              **quantize.launch_counts}
    st = eng.stats
    waves, ticks = st["waves"], NEW - 1
    print(f"  served {len(out)} requests in {waves} waves: wall "
          f"{wall * 1e3:.3f} ms; prefill ms {[round(1e3 * s, 3) for s in pre_s]}"
          f"; decode ms per token (median of {len(dec_s)}) "
          f"{1e3 * float(np.median(dec_s)):.3f}, min "
          f"{1e3 * min(dec_s):.3f}, max {1e3 * max(dec_s):.3f}; "
          f"{st['tokens_generated'] / wall:.2f} tok/s; peak device memory "
          f"{peak_gb:.2f} GB")
    for r in rids[:2]:
        print(f"    request {r}: ...{ctxs[r][-6:].tolist()} -> "
              f"{out[r].generated[:12]}...")
    bad = [r for r in rids if len(out[r].generated) != NEW or not all(
        0 <= tk < cfg.vocab for tk in out[r].generated)]
    if bad or waves != 2:
        raise AssertionError(f"serving output wrong for requests {bad}")
    # the int8 frame: one uint8 (B, S_p or 1, d + 4) entry named "qp"
    header = 4 + 2 + len("qp") + 2 + len("uint8") + 1 + 3 * 8 + 8
    row = cfg.d_model + 4
    per_wave = (model.P * (SLOTS * (CTX // model.P) * row + header)
                + ticks * (SLOTS * row + header))
    print(f"  cut_wire_bytes {st['cut_wire_bytes']} (analytic "
          f"{waves * per_wave}: {model.P} x ({SLOTS}x{CTX // model.P}x"
          f"{row} + {header}) + {ticks} x ({SLOTS}x{row} + {header}) per "
          f"wave); cut_messages {st['cut_messages']}")
    if st["cut_wire_bytes"] != waves * per_wave:
        raise AssertionError("cut wire bytes differ from the frame size")
    # launches are exact: every attention block of every forward, every
    # Mamba2 block of a prefill (decode is the plain single-step
    # recurrence), one quantize per cut message
    units = model.P * model.n_head_units + model.n_trunk_units
    n_attn = sum(k in ATTENTION for k in cfg.block_pattern)
    n_ssm = sum(k == "mamba2" for k in cfg.block_pattern)
    # every bf16 prefill call takes the tc route (the fma route at hd
    # above 128: gemma2's 256), every decode call the decode route;
    # every scan the chunked route
    pre, other = ("tc", "fma") if cfg.head_dim <= 128 else ("fma", "tc")
    need = {"block_attention": waves * units * n_attn * (1 + ticks),
            f"block_attention.{pre}": waves * units * n_attn,
            "block_attention.decode": waves * units * n_attn * ticks,
            f"block_attention.{other}": 0,
            "mamba2_scan": waves * units * n_ssm,
            "mamba2_scan.chunked": waves * units * n_ssm,
            "mamba2_scan.serial": 0,
            "quantize_pack_int8": waves * (model.P + ticks)}
    print(f"  kernel launches in the run: {counts} (needed exactly "
          f"{need})")
    for k, n in need.items():
        if counts[k] != n:
            raise AssertionError(f"{k} launched {counts[k]} != {n} times")
    res = {"counts": counts, "wall_ms": 1e3 * wall,
           "prefill_ms": [1e3 * s for s in pre_s],
           "decode_ms_median": 1e3 * float(np.median(dec_s)),
           "tok_per_s": st["tokens_generated"] / wall,
           "peak_gb": peak_gb, "n_params": n_params,
           "cut_wire_bytes": st["cut_wire_bytes"]}
    if cfg.moe is not None:
        # per call (each owner's head and the trunk, per MoE layer; one
        # routed group a call, as every config's dispatch_groups is 1):
        # its tokens' top-k choices and those past the capacity
        pre = [d for d in drops if d[0] > SLOTS * cfg.moe.top_k]
        res["moe_drops"] = {
            "calls": len(drops), "choices": sum(c for c, _ in drops),
            "dropped": sum(d for _, d in drops),
            "prefill_calls": [list(d) for d in pre],
            "decode_dropped": sum(d for c, d in drops
                                  if c <= SLOTS * cfg.moe.top_k)}
        print(f"  MoE dispatch: {len(drops)} calls, "
              f"{res['moe_drops']['dropped']} of "
              f"{res['moe_drops']['choices']} top-{cfg.moe.top_k} choices "
              f"dropped past capacity (prefill calls (choices, dropped): "
              f"{res['moe_drops']['prefill_calls']}; decode ticks "
              f"{res['moe_drops']['decode_dropped']})")
    res["busy_share"] = (profile_wave(model, params, kw, ctxs[:SLOTS])
                         if profile else None)
    return dict(res, model=model, params=params)


def synced(fn, times):
    """``fn`` timed on the host clock between two device syncs."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out
    return run


def profile_wave(model, params, kw, ctxs):
    """One more wave under torch.profiler: the device's busy share of the
    wave's wall time and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.engine import ServingEngine
    eng = ServingEngine(model, params, **kw)
    for c in ctxs:
        eng.submit(c)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    t_read = time.perf_counter()
    kernels, top, _ = read_profile(prof)
    read_s = time.perf_counter() - t_read
    busy = sum(us for _, us in kernels.values())
    if not busy:
        print("  profiler: no device time recorded; busy share not measured")
        return None
    print(f"  profiled wave (prefill + {NEW - 1} decode ticks; profiler "
          f"on): wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms = {busy / wall_us:.4f} of it; profile read "
          f"in {read_s:.2f} s")
    for key, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {us:12.1f} us  x{n:<6d} {key[:90]}")
    # host dispatch: operator calls made from Python (an aten op whose
    # parent is not itself an aten op), per forward of the wave
    print(f"  host: {top} top-level aten ops in the wave = {top / NEW:.0f} "
          f"per forward (prefill or decode tick)")
    # the port's kernels on the serving path: attention (tc, decode_mma
    # and its merge), the chunked scan's three launches, int8
    for tag in ("attn_tc", "attn_fwd", "decode_mma", "decode_split",
                "decode_combine", "ssd_chunk_state", "ssd_state_pass",
                "ssd_chunk_out", "quantize_rows"):
        ours = [v for key, v in kernels.items() if tag in key]
        us = sum(u for _, u in ours)
        print(f"  {tag}: {us:.1f} us over {sum(n for n, _ in ours)} "
              f"launches = {us / busy:.4f} of device busy time")
    return busy / wall_us


def phase_lm_checks(model, params, small_cfg, small_ctx):
    """Phases 8 and 11: the engine against prefill + decode_step by hand
    on the card, then the card against the CPU on ``small_cfg`` (f32)
    with contexts of ``small_ctx``."""
    import numpy as np
    import torch
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_map
    S, n_new, P = 128, 8, model.P
    ctx = lm_contexts(model.cfg.vocab, 1, S, seed=1)[0]
    eng = ServingEngine(model, params, batch_slots=1, ctx_len=S,
                        max_new=n_new, transport="direct", device="cuda")
    rid = eng.submit(ctx)
    got = eng.run()[rid].generated
    with torch.inference_mode():
        caches = model.cache_init(1, S, n_new=n_new + 1, device="cuda")
        ot = torch.from_numpy(np.ascontiguousarray(
            ctx.reshape(1, P, S // P).transpose(1, 0, 2))).cuda()
        logits, caches = model.prefill(params, {"owner_tokens": ot}, caches)
        tok, want = logits.argmax(-1)[:, None].to(torch.int32), []
        for t in range(n_new):
            want.append(int(tok[0, 0]))
            if t < n_new - 1:
                logits, caches = model.decode_step(params, caches, tok,
                                                   S + t, S // P + t)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
    print(f"  engine (direct, 1 slot): {got}\n  by hand:                 "
          f"{want}")
    if got != want:
        raise AssertionError("engine and manual decode disagree on the card")

    cfg = small_cfg
    small = SplitModel(cfg)
    t = time.time()
    cpu_params = small.init(torch.Generator().manual_seed(0))
    card_params = tree_map(lambda a: a.cuda(), cpu_params)
    C = small_ctx
    ctxs = lm_contexts(cfg.vocab, 2, C, seed=2)
    kw = dict(batch_slots=2, ctx_len=C, max_new=4, transport="queue")
    toks, first = {}, {}
    for dev, p in (("cuda", card_params), ("cpu", cpu_params)):
        e = ServingEngine(small, p, device=dev, **kw)
        rids = [e.submit(c) for c in ctxs]
        res = e.run()
        toks[dev] = [res[r].generated for r in rids]
        with torch.inference_mode():
            caches = small.cache_init(2, C, n_new=5, device=dev)
            ot = torch.from_numpy(np.ascontiguousarray(
                ctxs.reshape(2, P, C // P).transpose(1, 0, 2))).to(dev)
            first[dev] = small.prefill(p, {"owner_tokens": ot},
                                       caches)[0].cpu()
    rel = ((first["cuda"] - first["cpu"]).abs().max()
           / first["cpu"].abs().max()).item()
    print(f"  card vs CPU ({cfg.name}, d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, f32, contexts of {C}; "
          f"{time.time() - t:.1f} s): tokens {toks['cuda']} vs "
          f"{toks['cpu']}; first-token logits max rel diff {rel:.3e} "
          f"(limit 1e-3)")
    if toks["cuda"] != toks["cpu"] or rel > 1e-3:
        raise AssertionError("card and CPU serving runs disagree")


# ---------------------------------------------------------------------------
# The cut-fusion kernel (the scientist's cut layer) and the schedules
# ---------------------------------------------------------------------------

# the reference's kernel cases (tests/test_kernels.py CUT_CASES), then the
# training path's calls (2 owners, k 64, trunk width 500): the batch of
# 128, a microbatch chunk of 32 (microbatches=4), phase 4's evaluation
# batch of 242 rows, sum and mean with W's one block row, the masked
# trunk's dequantized ring sum as one owner plane (phase 15); then the
# reference benchmark's shape (benchmarks/kernels_bench.py):
# P, T, k, d, combine, rows of W
CUT_CASES = [(2, 128, 64, 128, "concat", 2), (4, 256, 64, 96, "concat", 4),
             (2, 100, 60, 70, "concat", 2), (2, 128, 64, 128, "sum", 2),
             (3, 128, 64, 128, "mean", 3)]
CUT_PATH_CASES = {"batch": (2, 128, 64, 500, "concat", 2),
                  "chunk": (2, 32, 64, 500, "concat", 2),
                  "eval": (2, 242, 64, 500, "concat", 2),
                  "sum": (2, 128, 64, 500, "sum", 1),
                  "mean": (2, 128, 64, 500, "mean", 1),
                  "masked": (1, 128, 64, 500, "sum", 1),
                  "bench": (2, 4096, 512, 1024, "concat", 2)}


def cut_bound(case, dtype, bw, f32_flops):
    """Each input read once (sum and mean read one block row of W) and
    the output written once, over the memory rate; the products (and
    the owner sums, and the division for mean) over the peak rate."""
    import torch
    P, T, K, D, combine, _ = case
    elt = 2 if dtype == torch.bfloat16 else 4
    if combine == "concat":
        flops, w_rows = 2 * P * T * K * D, P
    else:
        flops = 2 * T * K * D + (P - 1 + (combine == "mean")) * T * K
        w_rows = 1
    nbytes = elt * (P * T * K + w_rows * K * D + T * D)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else f32_flops
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / peak
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), flops, nbytes


def cut_library_call(z, w, combine):
    """One PyTorch call computing the same function (cuBLAS, TF32 off):
    ``einsum`` over owners and k for concat, ``matmul`` of the combined
    cut for sum and mean.  Timed as a yardstick only; the port never
    calls it."""
    import torch
    if combine == "concat":
        return lambda: torch.einsum("ptk,pkd->td", z, w)
    if z.shape[0] == 1:                 # one owner plane: a plain product
        return lambda: torch.matmul(z[0], w[0])
    if combine == "sum":
        return lambda: torch.matmul(z.sum(0), w[0])
    return lambda: torch.matmul(z.mean(0), w[0])


def phase_cut_fusion(bw, f32_flops):
    """Phase 12: the cut-fusion kernel vs its plain version on the card,
    each case on the route the wrapper picks and, where the tc route
    applies, on the fma route too; times at the path's shapes; a row's
    bits independent of T."""
    import numpy as np
    import torch
    from repro_torch.kernels.cut_fusion import (cut_fusion, cut_fusion_ref,
                                                ops, route_of)
    from repro_torch.kernels.cut_fusion.plan import ROUTES
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    err = {r: 0.0 for r in ROUTES}
    worst, rows = 0.0, {}
    cases = [(f"case{i}", c) for i, c in enumerate(CUT_CASES)]
    cases += [(f"path:{n}", c) for n, c in CUT_PATH_CASES.items()]
    for name, case in cases:
        P, T, K, D, combine, w_rows = case
        rng = np.random.default_rng(0)
        z32 = torch.from_numpy(rng.normal(size=(P, T, K)).astype(
            np.float32)).cuda()
        w32 = torch.from_numpy(rng.normal(size=(w_rows, K, D)).astype(
            np.float32)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            z, w = z32.to(dt), w32.to(dt)
            route = route_of(z, w, combine)
            want = cut_fusion_ref(z, w, combine=combine)
            for r_ in [route] + (["fma"] if route == "tc" else []):
                got = ops._launch(r_, z, w, combine)
                torch.cuda.synchronize()
                d = (got.float() - want.float()).abs()
                r = (d / (tol[dt] + tol[dt] * want.float().abs())).max()
                r = r.item()
                if r > 1.0 or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"cut_fusion {name} {dt} ({r_}): kernel vs plain max"
                        f" |diff| {d.max().item():.3e} beyond "
                        f"atol=rtol={tol[dt]}")
                err[r_], worst = max(err[r_], d.max().item()), max(worst, r)
                if r_ == route:
                    route_err = d.max().item()
                print(f"  {name} (P, T, k, d) {case[:4]} {combine} "
                      f"{str(dt)[6:]} [{r_}]: max |diff| "
                      f"{d.max().item():.3e}, max |diff| / (atol + rtol "
                      f"|plain|) {r:.3f}")
            timed = name.startswith("path") and (
                dt == torch.float32 or name == "path:bench")
            if not timed:
                continue
            bound, by, flops, nbytes = cut_bound(case, dt, bw, f32_flops)
            library = cut_library_call(z, w, combine)
            lib_err = (library().float() - want.float()).abs().max().item()
            row = {"shape": list(case[:4]), "combine": combine,
                   "dtype": str(dt)[6:], "route": route,
                   "ms": device_ms(lambda: cut_fusion(z, w, combine)),
                   "plain_ms": device_ms(lambda: cut_fusion_ref(
                       z, w, combine=combine)),
                   "library_ms": device_ms(library),
                   "eager_ms": eager_ms(lambda: cut_fusion(z, w, combine)),
                   "bound_ms": bound, "bound_by": by, "flops": flops,
                   "bytes": nbytes, "max_abs_err": route_err,
                   "library_max_abs_err": lib_err}
            if route == "tc":         # the fma route at the same shape
                row["fma_ms"] = device_ms(lambda: ops._launch(
                    "fma", z, w, combine))
            row["tflops"] = flops / row["ms"] / 1e9
            row["x_lib"] = row["ms"] / row["library_ms"]
            rows[f"{name[5:]}:{row['dtype']}"] = row
            print(f"    {route} {row['ms']:.6f} ms ({row['tflops']:.3f} "
                  f"TFLOP/s; eager {row['eager_ms']:.6f})"
                  + (f", fma route {row['fma_ms']:.6f} ms"
                     if "fma_ms" in row else "")
                  + f", plain {row['plain_ms']:.6f} ms, library "
                  f"{row['library_ms']:.6f} ms (x lib {row['x_lib']:.2f}; "
                  f"|diff| {lib_err:.2e}), bound {row['bound_ms']:.6f} ms "
                  f"({by}; {flops / 1e6:.3f} MFLOP, {nbytes / 1e6:.4f} MB)")
    # a row's bits do not depend on T: the first 32 rows of a call are a
    # call on those 32 rows (f32 on the fma route, with another tile
    # plan at T 4096; bf16 on the tc route)
    for P, T, K, D in ((2, 242, 64, 512), (2, 4096, 512, 1024)):
        rng = np.random.default_rng(1)
        z32 = torch.from_numpy(rng.normal(size=(P, T, K)).astype(
            np.float32)).cuda()
        w32 = torch.from_numpy(rng.normal(size=(P, K, D)).astype(
            np.float32)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            z, w = z32.to(dt), w32.to(dt)
            for combine in ("concat", "sum", "mean"):
                full = cut_fusion(z, w, combine)
                head = cut_fusion(z[:, :32].contiguous(), w, combine)
                torch.cuda.synchronize()
                if not torch.equal(head, full[:32]):
                    raise AssertionError(
                        f"cut_fusion {combine} {dt} ({route_of(z, w)}): "
                        f"rows 0..31 of T {T} differ from a call on them")
            print(f"  rows independent of T ({P}, {T}, {K}, {D}) "
                  f"{str(dt)[6:]} [{route_of(z, w)}]: the first 32 rows "
                  f"of the call equal a call on them, bitwise, for concat,"
                  f" sum and mean")
    return {"max_abs_err": err, "tol_ratio": worst, "rows": rows}


def same_params(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                  tree_leaves(b.params)))


def phase_schedules():
    """Phase 13: the training path at full width through the schedules
    beyond phase 4's: microbatched split == its joint oracle, owners in
    worker processes == the queue backend, and the three fused combines
    card vs CPU."""
    from repro_torch.tree import tree_leaves
    kw = dict(epochs=1, batch_size=128, eval_frac=0.15, verbose=False)
    M = 4
    runs = {}
    for mode in ("joint", "split"):
        s, _ = mnist_session("cuda")
        reset_counts()
        t = time.time()
        h = s.fit(**kw, mode=mode, microbatches=M)
        counts = read_counts()
        check_counts(counts, {"cut_fusion": trunk_forwards(
            s, "joint" if mode == "joint" else "pipelined", M)},
            f"the {mode} fit in {M} microbatches")
        runs[mode] = (s, h)
        print(f"  {mode} fit, {M} microbatches of {128 // M}: "
              f"{len(h['loss_trail'])} steps in {time.time() - t:.2f} s"
              + (f"; steady_step_ms "
                 f"{s.transport_stats['steady_step_ms']:.3f}"
                 if mode == "split" else ""))
    (j, hj), (sp, hs) = runs["joint"], runs["split"]
    if not same_params(j, sp) or hs["loss_trail"] != hj["loss_trail"]:
        raise AssertionError("microbatched split != its joint oracle")
    print(f"  split in {M} microbatches == the microbatched joint oracle: "
          f"params and loss trail bitwise equal over "
          f"{len(hj['loss_trail'])} steps; cut frames "
          f"{sp.transport_stats['wire_by_kind']['cut_activations']['count']}")

    for compression in (None, "int8"):
        pair = {}
        for backend in ("queue", "process"):
            s, _ = mnist_session("cuda")
            reset_counts()
            t = time.time()
            h = s.fit(**kw, mode="split", backend=backend,
                      compression=compression)
            wall = time.time() - t
            counts = read_counts()
            steps = s.transport_stats["steps"]
            # launches are per process: a worker process's int8 launches
            # on its cuts are its own; the parent counts the scientist's
            # (every cut gradient) and, for thread owners, theirs
            need = {"cut_fusion": trunk_forwards(s)}
            if compression == "int8":
                need["quantize_pack_int8"] = len(s.owners) * (steps + 1) \
                    * (2 if backend == "queue" else 1)
            check_counts(counts, need,
                         f"the {backend} fit ({compression or 'lossless'})")
            pair[backend] = (s, h)
            print(f"  {backend} ({compression or 'lossless'}): {steps} "
                  f"steps, fit wall {wall:.2f} s (workers' start-up "
                  f"included), steady_step_ms "
                  f"{s.transport_stats['steady_step_ms']:.3f}")
        (q, hq), (p, hp) = pair["queue"], pair["process"]
        wq = q.transport_stats["wire_by_kind"]
        wp = p.transport_stats["wire_by_kind"]
        if not same_params(q, p) or hp["loss_trail"] != hq["loss_trail"]:
            raise AssertionError(f"process != queue ({compression})")
        if {k: wp[k] for k in wq} != wq or \
                set(wp) - set(wq) != {"pull_params", "params_dump"}:
            raise AssertionError(f"process wire bytes != queue's "
                                 f"({compression}): {wp} vs {wq}")
        print(f"  process == queue ({compression or 'lossless'}): params "
              f"and loss trail bitwise equal; wire bytes by kind equal on "
              f"the queue's {len(wq)} kinds (+ the param pulls)")

    for combine in ("concat", "sum", "mean"):
        res = {}
        for dev in ("cuda", "cpu"):
            s, _ = mnist_session(dev, combine=combine)
            reset_counts()
            h = s.fit(**kw)
            if dev == "cuda":
                check_counts(read_counts(), {"cut_fusion": trunk_forwards(
                    s, "joint")}, f"the joint fit ({combine})")
            res[dev] = (s, h)
        (c, hc), (u, hu) = res["cuda"], res["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(hc["loss_trail"], hu["loss_trail"]))
        pdiff = max((a.cpu() - b).abs().max().item() for a, b in
                    zip(tree_leaves(c.params), tree_leaves(u.params)))
        print(f"  joint ({combine}) card vs CPU: loss trail max rel "
              f"{rel:.3e} (limit 1e-4), params max |diff| {pdiff:.3e} "
              f"(limit 1e-4); final loss {hc['loss_trail'][-1]:.5f}")
        if rel > 1e-4 or pdiff > 1e-4:
            raise AssertionError(f"card and CPU joint ({combine}) disagree")


def mask_build_ms(reps=200):
    """Host time of one owner's mask for a (128, 64) message (two owners:
    one Philox stream of 8192 uint32 words), and of the whole masked
    encode of a cut on the card (lift, copy to the host, mask, ring
    add), medians of ``reps`` calls on the host clock."""
    import torch
    from repro_torch.core import masking
    cut = torch.randn(PATH_SHAPE, device="cuda").relu()
    agg = masking.MaskedAggregator(0, 0, 2)
    out = {}
    for key, fn in (
            ("mask_ms", lambda i: masking.pairwise_mask(
                0, 0, 2, f"s{i}", PATH_SHAPE)),
            ("encode_ms", lambda i: agg.encode(cut, f"s{i}"))):
        times = []
        for i in range(reps):
            t = time.perf_counter()
            fn(i)
            times.append(1e3 * (time.perf_counter() - t))
        out[key] = sorted(times)[reps // 2]
    return out


def phase_privacy():
    """Phase 15: secure forward aggregation and the cut-layer defences on
    the paper's path at full width with the sum trunk.  Masked: one split
    int8 epoch over the queue with exact launch counts (cut fusion on
    every trunk forward; the int8 codec on gradient messages only, the
    ring-coded forward bypasses it), masked split == the masked joint
    oracle (lossless: the oracle has no codec), process == queue (int8)
    bitwise, card == CPU oracle.  Defended: one split int8 epoch per
    defence with a finite trail, the warmup alone (``steps=0``) leaving
    the built params bitwise, and NoPeek split (lossless) against NoPeek
    joint, with NoPeek moving the run past that comparison's limit from
    weight 0.  Step times beside the undefended sum run's, all in this
    call."""
    import torch
    from repro_torch.tree import tree_leaves
    kw = dict(epochs=1, batch_size=128, eval_frac=0.15, verbose=False)
    int8 = dict(kw, mode="split", compression="int8", backend="queue")
    base, _ = mnist_session("cuda", combine="sum")
    base.fit(**int8)
    bts = base.transport_stats
    steps, owners = bts["steps"], len(base.owners)
    int8_cut = {n: o["cut_payload_bytes"] // steps
                for n, o in bts["per_owner"].items()}
    print(f"  undefended sum (split int8 queue): steady_step_ms "
          f"{bts['steady_step_ms']:.3f}; forward bytes per owner per step "
          f"{int8_cut}")
    res = {"base_steady_step_ms": bts["steady_step_ms"]}

    # ---- masked: the main drive, counts read around it
    masked, _ = mnist_session("cuda", combine="sum")
    reset_counts()
    hm = masked.fit(**int8, aggregation="masked_sum")
    counts = read_counts()
    n_cut = trunk_forwards(masked)
    check_counts(counts, {
        "quantize_pack_int8": owners * (steps + 1), "cut_fusion": n_cut,
        "cut_fusion.fma": n_cut, "cut_fusion.tc": 0},
        "the masked split int8 fit")
    mts = masked.transport_stats
    fwd = {n: o["cut_payload_bytes"] // steps
           for n, o in mts["per_owner"].items()}
    if set(fwd.values()) != {PATH_SHAPE[0] * PATH_SHAPE[1] * 4} or \
            mts["aggregation"] != "masked_sum":
        raise AssertionError(f"masked forward bytes {fwd}")
    if not all(math.isfinite(v) for v in hm["loss_trail"]):
        raise AssertionError(f"masked trail {hm['loss_trail']}")
    print(f"  masked (split int8 queue): {steps} steps, steady_step_ms "
          f"{mts['steady_step_ms']:.3f} (undefended "
          f"{bts['steady_step_ms']:.3f}); forward bytes per owner per step "
          f"{fwd} (ring words, against {int8_cut} int8-coded)")
    res.update(counts=counts, masked_steady_step_ms=mts["steady_step_ms"],
               masked_fwd_bytes=fwd, int8_fwd_bytes=int8_cut)

    oracle, _ = mnist_session("cuda", combine="sum")
    reset_counts()
    ho = oracle.fit(**kw, aggregation="masked_sum")
    check_counts(read_counts(), {"cut_fusion": trunk_forwards(
        oracle, "oracle")}, "the masked joint oracle")
    lossless, _ = mnist_session("cuda", combine="sum")
    hl = lossless.fit(**kw, mode="split", backend="queue",
                      aggregation="masked_sum")
    if not same_params(oracle, lossless) or \
            hl["loss_trail"] != ho["loss_trail"]:
        raise AssertionError("masked split != the masked joint oracle")
    print(f"  masked split (lossless) == the masked joint oracle: params "
          f"and loss trail bitwise equal over {len(ho['loss_trail'])} steps")
    proc, _ = mnist_session("cuda", combine="sum")
    t = time.time()
    hp = proc.fit(**dict(int8, backend="process"), aggregation="masked_sum")
    if not same_params(masked, proc) or hp["loss_trail"] != hm["loss_trail"]:
        raise AssertionError("masked process != masked queue")
    print(f"  masked process == queue (int8): params and loss trail bitwise "
          f"equal; fit wall {time.time() - t:.2f} s (workers' start-up "
          f"included), steady_step_ms "
          f"{proc.transport_stats['steady_step_ms']:.3f}")
    cpu, _ = mnist_session("cpu", combine="sum")
    hc = cpu.fit(**kw, aggregation="masked_sum")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(ho["loss_trail"], hc["loss_trail"]))
    pdiff = max((a.cpu() - b).abs().max().item() for a, b in
                zip(tree_leaves(oracle.params), tree_leaves(cpu.params)))
    print(f"  masked joint card vs CPU: loss trail max rel {rel:.3e} (limit "
          f"1e-4), params max |diff| {pdiff:.3e}")
    if rel > 1e-4:
        raise AssertionError("card and CPU masked joint runs disagree")
    res.update(mask_build_ms(), card_cpu_rel=rel)
    print(f"  host time for one owner's mask of a {PATH_SHAPE} message: "
          f"{res['mask_ms']:.4f} ms; the whole masked encode of a cut on "
          f"the card: {res['encode_ms']:.4f} ms (medians of 200)")

    # ---- the defences, each one split int8 epoch
    defences = {"nopeek": dict(nopeek_weight=0.3),
                "cut_noise": dict(cut_noise_std=2.0),
                "grad_unit": dict(grad_norm_mode="unit"),
                "grad_sign": dict(grad_norm_mode="sign"),
                "grad_noise": dict(grad_noise_std=0.05)}
    res["defended_steady_step_ms"] = {}
    for name, split in defences.items():
        warm, _ = mnist_session("cuda", combine="sum", **split)
        built = [t.clone() for t in tree_leaves(warm.params)]
        warm.fit(**dict(int8, epochs=None, eval_frac=0.0), steps=0)
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(warm.params), built)):
            raise AssertionError(f"{name}: the warmup moved the params")
        s, _ = mnist_session("cuda", combine="sum", **split)
        h = s.fit(**int8)
        trail = h["loss_trail"]
        if len(trail) != steps or not all(math.isfinite(v) for v in trail):
            raise AssertionError(f"{name}: bad loss trail {trail}")
        ms = s.transport_stats["steady_step_ms"]
        res["defended_steady_step_ms"][name] = ms
        print(f"  {name} {split} (split int8 queue): finite trail, final "
              f"loss {trail[-1]:.5f}; warmup left the params bitwise as "
              f"built; steady_step_ms {ms:.3f} (undefended "
              f"{bts['steady_step_ms']:.3f})")
    nj, _ = mnist_session("cuda", combine="sum", nopeek_weight=0.3)
    hj = nj.fit(**kw)
    ns, _ = mnist_session("cuda", combine="sum", nopeek_weight=0.3)
    hs = ns.fit(**kw, mode="split", backend="queue")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(hs["loss_trail"], hj["loss_trail"]))
    print(f"  NoPeek split (lossless) vs NoPeek joint on the card: loss "
          f"trail max rel {rel:.3e} (limit 1e-4)")
    if rel > 1e-4 or not all(math.isfinite(v) for v in hs["loss_trail"]):
        raise AssertionError("NoPeek split and joint disagree")
    # the comparison above shows NoPeek reached split training only if
    # the term moves the run by more than its limit: weight 0 beside it
    plain, _ = mnist_session("cuda", combine="sum")
    h0 = plain.fit(**kw)
    gap = max(abs(a - b) / abs(b) for a, b in
              zip(hs["loss_trail"], h0["loss_trail"]))

    def heads(sess):
        return torch.cat([t.double().flatten()
                          for t in tree_leaves(sess.params["heads"])])

    moved = torch.linalg.norm(heads(ns) - heads(plain)).item()
    off = torch.linalg.norm(heads(ns) - heads(nj)).item()
    print(f"  NoPeek split vs weight-0 joint: loss trail max rel {gap:.3e} "
          f"(must exceed the 1e-4 limit); heads' distance {moved:.4e} "
          f"from weight 0's, {off:.4e} from NoPeek joint's (must be ten "
          f"times closer)")
    if not gap > 1e-4 or not 10 * off <= moved:
        raise AssertionError("NoPeek does not move split training past "
                             "the split-vs-joint limit")
    res.update(nopeek_split_joint_rel=rel, nopeek_weight0_rel=gap,
               nopeek_heads_moved=moved, nopeek_heads_off=off)
    return res


def without(obj, key):
    """``obj`` with ``key`` left out of every dict in it."""
    if isinstance(obj, dict):
        return {k: without(v, key) for k, v in obj.items() if k != key}
    return obj


def chaos_fit(session, fault=None, **kw):
    """``session.fit(**kw)`` under a plan of one fault or a list of them
    (``federation.faults`` keywords) set in ``REPRO_CHAOS_PARTY`` for
    this fit alone."""
    from repro_torch.federation import faults
    if fault:
        os.environ[faults.CHAOS_ENV] = faults.FaultPlan(
            [faults.Fault(**f) for f in (
                fault if isinstance(fault, list) else [fault])]).to_env()
    try:
        return session.fit(**kw)
    finally:
        os.environ.pop(faults.CHAOS_ENV, None)


def frames(session, kinds):
    """Frames of ``kinds`` in the fit's record (every endpoint, a
    replaced owner's included)."""
    wk = session.transport_stats["wire_by_kind"]
    return sum(wk.get(k, {"count": 0})["count"] for k in kinds)


def recovery_counts(session, backend, masked=False):
    """The launches a supervised split int8 fit (M = 1) implies, from its
    own record.  G = cut-gradient frames (one per owner per step whose
    cut gradient ran: G / P = steps + replayed steps).  Cut fusion:
    ``trunk_forwards`` over those G / P steps.  The int8 kernel, in the
    scientist's process: one
    launch per cut-gradient and warmup-gradient frame (a respawn's
    warmup included); with thread owners (queue) also one per
    cut-activation and warmup-cut frame the owners sent, those of a dead
    owner's generation included, unless masked (the ring-coded cut
    bypasses the codec).  Worker processes count their own launches."""
    P = len(session.owners)
    G = frames(session, ["cut_gradients"])
    n_cut = trunk_forwards(session, steps=G // P)
    q = frames(session, ["cut_gradients", "warmup_grads"])
    if backend == "queue" and not masked:
        q += frames(session, ["cut_activations", "warmup_cuts"])
    return {"quantize_pack_int8": q, "cut_fusion": n_cut,
            "cut_fusion.fma": n_cut, "cut_fusion.tc": 0}, G // P


# the chaos runs: a fault, the step at which the scientist notices it, and
# the recovery it must give (party, action, marker); faults at step 3 are
# noticed at step 3 and replay from marker 2, the corrupt fifth cut of
# owner0 (step 4) rolls back to marker 4
RECOVERY_FAULTS = {
    "crash": (dict(party="owner0", action="crash", kind="head_fwd",
                   occurrence=None, step=3), 3, ("owner0", "respawn", 2)),
    "corrupt": (dict(party="owner0", action="corrupt_frame",
                     kind="cut_activations", occurrence=4), 4,
                ("owner0", "rollback", 4)),
}
# the process backend's three faults in one fit (a CUDA worker's start-up
# costs each process fit 10-20 s): owner0 crashes at step 3 (replay from
# marker 2); owner1's seventh cut (steps 0-3, the replayed 2-3, then step
# 4) is corrupted (rollback to marker 4); owner1 wedges at step 7, caught
# by the heartbeats (respawn, replay from marker 6)
PROCESS_FAULTS = [
    (dict(party="owner0", action="crash", kind="head_fwd", occurrence=None,
          step=3), 3, ("owner0", "respawn", 2)),
    (dict(party="owner1", action="corrupt_frame", kind="cut_activations",
          occurrence=6), 4, ("owner1", "rollback", 4)),
    (dict(party="owner1", action="wedge", kind="head_fwd", occurrence=None,
          step=7), 7, ("owner1", "respawn", 6)),
]


def phase_recovery():
    """Phase 16: supervised crash recovery (``fit(supervise=True)``) on
    the paper's path at full width, phase 4's session (2000 subjects, two
    owners, split int8, one epoch of 10 steps).  Fault-free supervised ==
    unsupervised bitwise on the queue.  The snapshot and heartbeat cost:
    three pairs of 5-epoch queue fits (50 steps), unsupervised and
    supervised in alternating order, heartbeats every 50 ms (ten times
    the default rate, so that they fire inside a fit), every steady step
    printed.  Then crash (owner0 on ``head_fwd`` at
    step 3) and corrupt frame (owner0's fifth ``cut_activations``) on the
    queue, one fit each, and on the process backend one fit with three
    faults (``PROCESS_FAULTS``: owner0's crash, a corrupt cut of owner1,
    then owner1 wedged on ``head_fwd`` at step 7 under the default 120 s
    timeout: the heartbeats must catch it): each run equals its backend's
    fault-free supervised run bit for bit, with its recovery events and
    the wall time beside the fault-free one.  The sum trunk with
    ``aggregation="masked_sum"`` crashed at step 3 on the queue == its
    fault-free masked supervised run.  Exact launch counts in every run
    from its own record (``recovery_counts``): with P owners, G
    cut-gradient frames and E evaluation batches, cut fusion 2 (G / P +
    1) + E, and G / P = steps + (the step the fault is noticed at − the
    event's marker); the int8 kernel once per frame that the scientist's
    process encodes.  No recovery event in a run without a plan; a crash
    in every generation with ``max_restarts=1`` ends in "restart budget
    exhausted"."""
    from repro_torch.federation import faults
    if os.environ.get(faults.CHAOS_ENV):
        raise AssertionError(f"{faults.CHAOS_ENV} is set before the phase")
    kw = dict(epochs=1, batch_size=128, eval_frac=0.15, verbose=False,
              mode="split", compression="int8")
    out = {}

    def run(backend, fault=None, masked=False, session=None, **extra):
        if session is None:
            s, _ = mnist_session("cuda",
                                 combine="sum" if masked else "concat")
        else:                      # resolved once; params drawn again
            s = session.build(session.config)
        reset_counts()
        t = time.time()
        h = chaos_fit(s, fault, **{**kw, **extra}, backend=backend,
                      **(dict(aggregation="masked_sum") if masked else {}))
        wall = time.time() - t
        counts = read_counts()
        return s, h, wall, counts

    def check_run(what, s, counts, backend, masked=False, expect=()):
        """Exact counts; the recovery record against ``expect``, a list
        of (noticed at, (party, action, marker)), or none."""
        need, stepped = recovery_counts(s, backend, masked)
        steps = s.transport_stats["steps"]
        ev = [(e["party"], e["action"], e["step"])
              for e in s.recovery_events]
        replayed = sum(n - e[2] for n, e in expect)
        if ev != [e for _, e in expect] or stepped != steps + replayed:
            raise AssertionError(f"{what}: events {ev}, {stepped} steps "
                                 f"run, expected {expect}")
        check_counts(counts, need, what)
        return {"counts": {k: counts[k] for k in need}, "events": ev,
                "replayed_steps": replayed, "all_counts": counts}

    # ---- fault-free: supervised == unsupervised
    base = {}
    for sup in (False, True):
        s, h, wall, counts = run("queue", supervise=sup)
        base[sup] = (s, h, wall)
        if sup:
            res = check_run("the supervised queue fit", s, counts, "queue")
            check_counts(counts, {"quantize_pack_int8": 2 * len(s.owners) * (
                s.transport_stats["steps"] + 1)}, "the same, phase 4's form")
    (u, hu, _), (q, hq, q_wall) = base[False], base[True]
    if not same_params(u, q) or hu["loss_trail"] != hq["loss_trail"]:
        raise AssertionError("supervised != unsupervised")
    print(f"  queue fault-free: supervised == unsupervised (params and loss "
          f"trail bitwise); snapshot acks {frames(q, ['snapshot_ack'])}; "
          f"launches {res['counts']}")

    # ---- the supervision's cost: alternating pairs of longer fits, with
    # heartbeats that fire; all runs bitwise equal, none suspected
    steady, acks, first = {False: [], True: []}, [], None
    cost_session, _ = mnist_session("cuda")
    for i in range(3):
        for sup in ((False, True) if i % 2 == 0 else (True, False)):
            s, h, _, _ = run("queue", session=cost_session, supervise=sup,
                             epochs=5,
                             **(dict(heartbeat_s=0.05) if sup else {}))
            steady[sup].append(s.transport_stats["steady_step_ms"])
            if sup:
                st = s.transport_stats["supervisor"]
                if s.recovery_events or st["suspected"] or \
                        not st["heartbeat_acks"]:
                    raise AssertionError(f"cost run: events "
                                         f"{s.recovery_events}, {st}")
                acks.append(st["heartbeat_acks"])
            if first is None:
                # the tree, not the session (rebuilt for the next run)
                first = (types.SimpleNamespace(params=s.params), h)
            elif not same_params(first[0], s) or \
                    h["loss_trail"] != first[1]["loss_trail"]:
                raise AssertionError("two 5-epoch fault-free runs differ")
    med = {k: sorted(v)[len(v) // 2] for k, v in steady.items()}
    print(f"  supervision cost, 3 pairs of 50-step queue fits in "
          f"alternating order (all bitwise equal, heartbeats every 50 ms, "
          f"acks {acks}): steady_step_ms unsupervised "
          f"{[round(x, 3) for x in steady[False]]} (median "
          f"{med[False]:.3f}), supervised "
          f"{[round(x, 3) for x in steady[True]]} (median {med[True]:.3f})")
    out["queue"] = {"cost": {"epochs": 5, "heartbeat_s": 0.05,
                             "unsupervised_steady_step_ms": steady[False],
                             "supervised_steady_step_ms": steady[True],
                             "heartbeat_acks": acks},
                    "clean_wall_s": q_wall, "clean": res}

    def chaos(backend, name, clean, masked=False, plan=None, **extra):
        """One fit under the fault ``name`` or under ``plan`` (a list of
        ``RECOVERY_FAULTS``-form entries): == ``clean`` bitwise, every
        recovery event in order, a wedge caught by the heartbeats."""
        plan = plan or [RECOVERY_FAULTS[name]]
        c, hc, c_wall = clean
        s, h, wall, counts = run(backend, [f for f, _, _ in plan], masked,
                                 supervise=True, **extra)
        if not same_params(c, s) or h["loss_trail"] != hc["loss_trail"]:
            raise AssertionError(f"{backend} {name}: != fault-free")
        what = f"the {'masked ' if masked else ''}{backend} {name} fit"
        r = check_run(what, s, counts, backend, masked,
                      [(n, e) for _, n, e in plan])
        for (f, _, _), e in zip(plan, s.recovery_events):
            if f["action"] == "wedge" and "unresponsive" not in e["error"]:
                raise AssertionError(f"the wedge was not caught by the "
                                     f"heartbeats: {e['error']}")
        secs = [e["seconds"] for e in s.recovery_events]
        print(f"  {backend} {'masked ' if masked else ''}{name}: == "
              f"fault-free bitwise; events {r['events']}, recovery "
              f"{', '.join(f'{x:.2f}' for x in secs)} s; fit wall "
              f"{wall:.2f} s (fault-free {c_wall:.2f} s); replayed "
              f"{r['replayed_steps']}; launches {r['counts']}")
        return dict(r, wall_s=wall, clean_wall_s=c_wall,
                    recover_s=secs[0] if len(secs) == 1 else secs)

    for name in ("crash", "corrupt"):
        out["queue"][name] = chaos("queue", name, base[True])
    p_clean = run("process", supervise=True)
    check_run("the supervised process fit", p_clean[0], p_clean[3],
              "process")
    if not same_params(q, p_clean[0]):
        raise AssertionError("supervised process != supervised queue")
    out["process"] = {"clean_wall_s": p_clean[2]}
    out["process"]["crash+corrupt+wedge"] = chaos(
        "process", "crash+corrupt+wedge", p_clean[:3], plan=PROCESS_FAULTS)
    m_clean = run("queue", masked=True, supervise=True)
    check_run("the supervised masked queue fit", m_clean[0], m_clean[3],
              "queue", masked=True)
    out["masked"] = chaos("queue", "crash", m_clean[:3], masked=True)
    out["masked"]["clean_wall_s"] = m_clean[2]

    s, _ = mnist_session("cuda")
    try:
        chaos_fit(s, dict(RECOVERY_FAULTS["crash"][0], gen=None), **kw,
                  backend="queue", supervise=True, max_restarts=1)
    except RuntimeError as e:
        if "restart budget exhausted" not in str(e):
            raise
        print(f"  a crash in every generation, max_restarts=1: {e}")
    else:
        raise AssertionError("a crash in every generation recovered")
    if os.environ.get(faults.CHAOS_ENV):
        raise AssertionError(f"{faults.CHAOS_ENV} left set")
    out["budget_exhausted"] = True
    return out



PSI_MODES = ("noinv", "bloom", "hidden")
PSI_BACKENDS = ("direct", "queue", "process")
# (a) and (b)'s chunk: 2000 IDs in 8 chunks, one task per pool worker (at
# the default 4096 each leg is one task and the pool idles)
PSI_CHUNK = 256


# (f)'s subjects: a sixth of MNIST's 60000 training subjects
PSI_SCALE = 10000
# (a)'s subjects: modp2048's modexps are ~8x modp512's, so (a) holds the
# default group at a quarter of phase 4's population
PSI_MODP2048 = 500


def psi_session(device, n=2000):
    """Phase 4's parties (``n`` subjects, two owners, keep_frac 0.9),
    not yet resolved."""
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    return VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, seed=0, keep_frac=0.9)), device=device)


def timed_resolve(session, **kw):
    t = time.time()
    st = session.resolve(**kw)
    return st, time.time() - t


def aligned_view(session):
    """The aligned IDs, label bytes and each owner's feature bytes."""
    return (list(session.scientist.ids),
            session.scientist.labels.tobytes(),
            [o._features.tobytes() for o in session.owners])


def wire_by_kind(session):
    """Wire bytes and frames by PSI kind, both directions, every owner,
    from the resolve's measured transcript entries."""
    out = {}
    for m in session.transcript:
        if m.get("measured"):
            k = out.setdefault(m["kind"], {"wire_bytes": 0, "frames": 0})
            k["wire_bytes"] += m["wire_bytes"]
            k["frames"] += m["chunks"]
    return out


def phase_psi():
    """Phase 17: PSI entity resolution in every mode and backend, into
    the paper's training path.  Phase 4's population (2000 subjects, two
    owners, keep_frac 0.9); N = min(8, cpu count) modexp workers;
    chunks of ``PSI_CHUNK`` IDs in (a) and (b).  (a) one resolve at the
    default group modp2048 on the process backend with the pool, at
    ``PSI_MODP2048`` subjects, whose IDs equal the serial direct modp512
    resolve's of the same parties;
    (b) every mode on every backend with parallelism N at modp512, and
    0 for noinv on every backend and for bloom and hidden on direct:
    within a mode the aligned IDs, labels and features bitwise equal,
    noinv's IDs == bloom's, hidden's pseudonym rows equal across
    backends, and every pool run reporting the N it asked for; then
    noinv on the process backend with parallelism 0 and N at resolve's
    default chunk, the pool's speedup a caller who sets only
    ``parallelism`` sees; (c) ±1 %
    churn of the scientist's rows (20 out, 20 in) through
    ``update_rows``, then a resolve on queue and process: every round a
    delta round, the client's splice 20 modexps, each owner's 20 and the
    client's lift 0 (the reference engine's O(Δ) counts), the IDs of a
    fresh resolve of the churned parties; then an unchanged repeat,
    hello-only (0 blind bytes, 0 modexp); (d) ``crash_psi`` and
    ``wedge_psi`` (``timeout=5``) with ``retries=1`` on queue and
    process: one ``psi_retry`` event each, the fault-free IDs; (e) the
    paper's split int8 fit over the queue on (b)'s hidden alignment,
    then evaluate, with exact kernel launch counts (phase 4's form) and
    a finite, falling loss trail within 2e-2 of the same run on the CPU;
    (f) one resolve at 10000 subjects, a sixth of MNIST's 60000
    training subjects (modp512, noinv, process, the pool): wall seconds,
    IDs/s, modexp ops, wire bytes by kind.  Seconds are host wall time around each resolve."""
    import numpy as np
    from repro_torch.core.psi import DEFAULT_CHUNK, HIDDEN_PAD
    from repro_torch.federation import faults
    if os.environ.get(faults.CHAOS_ENV):
        raise AssertionError(f"{faults.CHAOS_ENV} is set before the phase")
    from repro_torch.core.modexp import HAVE_GMPY2
    N = min(8, os.cpu_count() or 1)
    out = {"host_cpus": os.cpu_count(), "pool": N, "subjects": 2000,
           "chunk": PSI_CHUNK, "gmpy2": HAVE_GMPY2}

    # ---- (a) the default group, on the process backend with the pool
    ref = psi_session("cuda")
    st, ref_s = timed_resolve(ref, group="modp512")
    ref_ids = list(ref.scientist.ids)
    small = psi_session("cuda", n=PSI_MODP2048)
    timed_resolve(small, group="modp512")
    s = psi_session("cuda", n=PSI_MODP2048)
    st, sec = timed_resolve(s, group="modp2048", backend="process",
                            parallelism=N, chunk_size=PSI_CHUNK)
    want = list(small.scientist.ids)
    if st["parallelism"] != N or list(s.scientist.ids) != want:
        raise AssertionError(f"modp2048: parallelism {st['parallelism']}, "
                             f"{len(s.scientist.ids)} IDs vs {len(want)}")
    ops = sum(r["client_modexp_ops"] + r["server_modexp_ops"]
              for r in st["rounds"])
    print(f"  (a) modp2048, {PSI_MODP2048} subjects, process, pool {N}: "
          f"{len(want)} IDs == the serial direct modp512 resolve's; "
          f"{sec:.3f} s, {ops} modexps ({ops / sec:.1f}/s)")
    out["modp2048"] = {"subjects": PSI_MODP2048, "seconds": sec,
                       "modexp_ops": ops, "parallelism": st["parallelism"]}

    # ---- (b) modes x backends x parallelism (bloom and hidden serial on
    # direct only: the pool's speedup on each backend is noinv's)
    views, secs, hidden_queue = {}, {}, None
    for mode in PSI_MODES:
        for backend in PSI_BACKENDS:
            serial = mode == "noinv" or backend == "direct"
            for par in ((0, N) if serial else (N,)):
                s = psi_session("cuda")
                st, sec = timed_resolve(s, group="modp512", mode=mode,
                                        backend=backend, parallelism=par,
                                        chunk_size=PSI_CHUNK)
                if st["parallelism"] != par:
                    raise AssertionError(f"{mode} {backend}: pool of {par} "
                                         f"reports {st['parallelism']}")
                views[mode, backend, par] = aligned_view(s)
                secs[f"{mode}/{backend}/{par}"] = sec
                if (mode, backend, par) == ("hidden", "queue", N):
                    hidden_queue = s
        first = views[mode, "direct", 0]
        bad = [k for k, v in views.items() if k[0] == mode and v != first]
        if bad:
            raise AssertionError(f"{mode}: aligned rows differ in {bad}")
    if views["noinv", "direct", 0][0] != views["bloom", "direct", 0][0]:
        raise AssertionError("noinv and bloom align different IDs")
    if views["noinv", "direct", 0][0] != ref_ids:
        raise AssertionError("noinv differs from (a)'s serial resolve")
    # hidden: the members and, from each owner, fewer than HIDDEN_PAD
    # decoys (another owner's members among them)
    hid = views["hidden", "direct", 0][0]
    if not hid or any(not i.startswith("anon") for i in hid) or not \
            len(ref_ids) <= len(hid) <= len(ref_ids) + 2 * (HIDDEN_PAD - 1):
        raise AssertionError(f"hidden alignment: {len(hid)} rows")
    print(f"  (b) 3 modes x 3 backends x pool {N}, and serial (noinv on "
          f"every backend, bloom and hidden on direct): rows bitwise "
          f"equal within each mode, noinv == bloom IDs ({len(ref_ids)}), "
          f"hidden {len(hid)} pseudonym rows on every backend")
    for k, v in secs.items():
        print(f"    {k}: {v:.3f} s")
    out["round_seconds"] = secs
    out["pool_speedup"] = {
        f"{m}/{b}": secs[f"{m}/{b}/0"] / secs[f"{m}/{b}/{N}"]
        for m in PSI_MODES for b in PSI_BACKENDS if f"{m}/{b}/0" in secs}
    out["hidden_rows"] = len(hid)
    # the pool at resolve's default chunk, as a caller who sets only
    # ``parallelism`` gets it (2000 IDs: one task per leg), on the
    # process backend (each backend's pool ran in the matrix above)
    dsecs = {}
    for par in (0, N):
        s = psi_session("cuda")
        st, dsecs[par] = timed_resolve(s, group="modp512",
                                       backend="process", parallelism=par)
        if st["parallelism"] != par or list(s.scientist.ids) != ref_ids:
            raise AssertionError(f"default chunk, process, pool {par}")
    out["pool_speedup"]["noinv/process/default_chunk"] = dsecs[0] / dsecs[N]
    print(f"    noinv/process at the default chunk {DEFAULT_CHUNK}: "
          f"{dsecs[0]:.3f} s serial, {dsecs[N]:.3f} s pool "
          f"({dsecs[0] / dsecs[N]:.2f}x)")

    # ---- (c) ±1 % churn of the scientist's rows: delta rounds
    out["churn"] = {}
    for backend in ("queue", "process"):
        s = psi_session("cuda")
        s.resolve(group="modp512", backend=backend)
        sci = s.scientist
        cli = sci.psi_client("modp512")
        ops0 = cli.ops
        pop, data = list(sci._full.ids), sci._full.data
        sci.update_rows(pop[20:] + [f"fresh-{i:02d}" for i in range(20)],
                        np.concatenate([data[20:], data[:20]]))
        st, sec = timed_resolve(s, group="modp512", backend=backend)
        splice = cli.ops - ops0 - sum(r["client_modexp_ops"]
                                      for r in st["rounds"])
        for r in st["rounds"]:
            if not (r["delta_used"] and r["server_leg_skipped"]) or \
                    r["server_modexp_ops"] != 20 or \
                    r["client_modexp_ops"] != 0 or r["upload_wire_bytes"]:
                raise AssertionError(f"churn on {backend}: {r}")
        if splice != 20:
            raise AssertionError(f"churn on {backend}: splice {splice}")
        fresh = psi_session("cuda")
        fresh.scientist.update_rows(list(sci._full.ids), sci._full.data)
        fresh.resolve(group="modp512")
        if list(s.scientist.ids) != list(fresh.scientist.ids):
            raise AssertionError(f"churn on {backend}: IDs differ")
        st2, sec2 = timed_resolve(s, group="modp512", backend=backend)
        for r in st2["rounds"]:
            if not (r["upload_skipped"] and r["resp_skipped"]) or \
                    r["upload_wire_bytes"] or r["client_modexp_ops"] or \
                    r["server_modexp_ops"]:
                raise AssertionError(f"repeat on {backend}: {r}")
        down = [r["download_wire_bytes"] for r in st2["rounds"]]
        print(f"  (c) {backend}: ±1 % churn -> delta rounds, splice 20 + "
              f"20 per owner modexps, {sec:.3f} s; unchanged repeat "
              f"hello-only (0 blind bytes, 0 modexp, {down} bytes down), "
              f"{sec2:.3f} s")
        out["churn"][backend] = {"delta_seconds": sec,
                                 "repeat_seconds": sec2,
                                 "repeat_download_bytes": down}

    # ---- (d) PSI retries
    out["retries"] = {}
    for backend in ("queue", "process"):
        for token, kw in (("crash_psi", {}), ("wedge_psi",
                                              {"timeout": 5.0})):
            s = psi_session("cuda")
            os.environ[faults.CHAOS_ENV] = f"owner0:{token}"
            try:
                st, sec = timed_resolve(s, group="modp512", backend=backend,
                                        retries=1, **kw)
            finally:
                os.environ.pop(faults.CHAOS_ENV, None)
            ev = [(e["party"], e["action"]) for e in s.recovery_events]
            if ev != [("owner0", "psi_retry")] or \
                    list(s.scientist.ids) != ref_ids:
                raise AssertionError(f"{token} on {backend}: {ev}")
            print(f"  (d) {token} on {backend}, retries=1: one psi_retry, "
                  f"the fault-free IDs; {sec:.3f} s")
            out["retries"][f"{token}/{backend}"] = sec

    # ---- (e) the paper's split int8 fit on the hidden alignment
    from repro_torch.configs import CONFIG
    kw = dict(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
              compression="int8", backend="queue", verbose=False)
    s = hidden_queue.build(CONFIG)
    reset_counts()
    h = s.fit(**kw)
    ev = s.evaluate()
    counts = read_counts()
    steps, trail = s.transport_stats["steps"], h["loss_trail"]
    n_cut = trunk_forwards(s, evaluates=2)
    check_counts(counts, {
        "quantize_pack_int8": 2 * len(s.owners) * (steps + 1),
        "cut_fusion": n_cut, "cut_fusion.fma": n_cut, "cut_fusion.tc": 0},
        "the hidden-alignment fit")
    if len(trail) != steps or not all(math.isfinite(v) for v in trail) or \
            not sum(trail[-3:]) < sum(trail[:3]):
        raise AssertionError(f"hidden fit: bad loss trail {trail}")
    cpu = psi_session("cpu")
    cpu.resolve(group="modp512", mode="hidden", backend="queue")
    if aligned_view(cpu) != views["hidden", "queue", N]:
        raise AssertionError("hidden alignment differs on the CPU")
    hc = cpu.build(CONFIG).fit(**kw)
    gap = max(abs(a - b) for a, b in zip(trail, hc["loss_trail"]))
    print(f"  (e) hidden alignment ({len(hid)} rows), split int8 fit: "
          f"{steps} steps, trail {[round(v, 5) for v in trail]}, val {ev}; "
          f"vs the CPU run max |diff| {gap:.3e} (limit 2e-2)")
    if gap > 2e-2:
        raise AssertionError("hidden fit: card and CPU disagree")
    out["fit"] = {"steps": steps, "loss_trail": trail, "eval": ev,
                  "cpu_gap": gap,
                  "counts": {k: counts[k] for k in (
                      "quantize_pack_int8", "cut_fusion", "cut_fusion.fma",
                      "cut_fusion.tc")}}

    # ---- (f) a sixth of MNIST's 60000 training subjects (cut from all
    # 60000, then from 20000, to keep the script inside its time limit)
    t = time.time()
    s = psi_session("cuda", n=PSI_SCALE)
    made = time.time() - t
    st, sec = timed_resolve(s, group="modp512", backend="process",
                            parallelism=N)
    if st["parallelism"] != N:
        raise AssertionError(f"{PSI_SCALE}: pool reports "
                             f"{st['parallelism']}")
    ops = sum(r["client_modexp_ops"] + r["server_modexp_ops"]
              for r in st["rounds"])
    wire = wire_by_kind(s)
    print(f"  (f) {PSI_SCALE} subjects (parties made in {made:.2f} s), "
          f"noinv, "
          f"process, pool {N}: {st['global_intersection']} shared, "
          f"{sec:.3f} s, {PSI_SCALE / sec:.1f} IDs/s, {ops} modexps; wire "
          f"{json.dumps(wire)}")
    out["scale"] = {"subjects": PSI_SCALE, "seconds": sec, "ids_per_s":
                    PSI_SCALE / sec, "modexp_ops": ops, "shared":
                    st["global_intersection"], "wire_by_kind": wire}
    if os.environ.get(faults.CHAOS_ENV):
        raise AssertionError(f"{faults.CHAOS_ENV} left set")
    return out, out["fit"]["counts"]


# ---------------------------------------------------------------------------
# Phase 18: the rest of fit on the paper's path
# ---------------------------------------------------------------------------

WIRE_LATENCY = 8e-3             # one-way, the paper's pipeline experiment
WIRE_BANDWIDTH = 1e8            # bytes per second
WIRE_FRAMES = 200
IMBALANCED = (588, 196)
#: the reference's eight uneven owners (tests/test_process_transport.py)
EIGHT_OWNERS = (200, 60, 120, 84, 96, 40, 104, 80)
CUT_P8 = (8, 128, 64, 500, "concat", 8)


def _pcts(ms):
    ms = sorted(ms)
    return {"p50_ms": ms[len(ms) // 2], "p90_ms": ms[(9 * len(ms)) // 10],
            "max_ms": ms[-1], "min_ms": ms[0]}


def wire_overshoot(backend, spin):
    """``WIRE_FRAMES`` frames (an int8 cut's (128, 68) bytes) sent one at
    a time at ``WIRE_LATENCY`` one-way on a queue channel pair or a
    process endpoint pair: how far past its deadline (``not_before``)
    the receiver's wait ends (``wait``), and how far past it ``recv``
    returns the frame, its CRC check and unpacking included
    (``delivery``), in ms.  ``spin`` False builds the pair under
    ``REPRO_SPIN_WAIT_S=0`` (the sleep alone).  The wait is timed by
    wrapping ``transport.wait_until`` for the run."""
    import numpy as np
    from repro_torch.federation import process_transport, transport
    old = os.environ.pop("REPRO_SPIN_WAIT_S", None)
    if not spin:
        os.environ["REPRO_SPIN_WAIT_S"] = "0"
    try:
        if backend == "queue":
            a, b = transport.channel_pair("a", "b",
                                          latency_s=WIRE_LATENCY)
            spin_s = b.inbox.spin_s
        else:
            a, b = process_transport.process_endpoint_pair(
                "a", "b", latency_s=WIRE_LATENCY)
            spin_s = b.spin_s
    finally:
        os.environ.pop("REPRO_SPIN_WAIT_S", None)
        if old is not None:
            os.environ["REPRO_SPIN_WAIT_S"] = old
    waits, delivery = [], []
    real = transport.wait_until

    def timed_wait(deadline, spin_s=transport.SPIN_WAIT_S):
        real(deadline, spin_s)
        waits.append(1e3 * (time.monotonic() - deadline))

    x = np.zeros((128, 68), np.uint8)
    mods = (transport, process_transport)
    for m in mods:
        m.wait_until = timed_wait
    try:
        for i in range(WIRE_FRAMES):
            msg = a.send("cut_activations", {"x": x}, seq=i)
            b.recv(timeout=10.0)
            delivery.append(1e3 * (time.monotonic() - msg.not_before))
    finally:
        for m in mods:
            m.wait_until = real
        if backend == "process":
            a.close()
            b.close()
    if len(waits) != WIRE_FRAMES:
        raise AssertionError(f"{backend}: {len(waits)} waits for "
                             f"{WIRE_FRAMES} frames")
    return {"spin_s": spin_s, "wait": _pcts(waits),
            "delivery": _pcts(delivery)}


def fit_counts(session, schedule="pipelined", microbatches=1, int8=True,
               evaluates=2, process=False):
    """The launches a split fit of ``session`` implies (phase 4's and
    phase 13's forms), ``evaluates`` evaluations included: cut fusion on
    every trunk forward; with int8 one quantize per cut and cut-gradient
    chunk, the warmup's included (worker processes count their own
    cuts)."""
    n_cut = trunk_forwards(session, schedule, microbatches, evaluates)
    need = {"cut_fusion": n_cut, "cut_fusion.fma": n_cut,
            "cut_fusion.tc": 0}
    if int8:
        steps = session.transport_stats["steps"]
        need["quantize_pack_int8"] = len(session.owners) * microbatches \
            * (steps + 1) * (1 if process else 2)
    return need


def leaves_of(session):
    from repro_torch.tree import tree_leaves
    return tree_leaves(session.params)


def same_leaves(a, b):
    import torch
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu())
                                    for x, y in zip(a, b))


def owners_session(device, splits, keep_frac, parallelism=0, n=2000,
                   **split):
    """Phase 4's ``n`` (2000) subjects split across owners of widths
    ``splits``, resolved (modp512) and built with the paper's head and
    trunk."""
    import dataclasses
    from repro_torch.configs import CONFIG
    from repro_torch.data import make_vertical_mnist_parties
    from repro_torch.federation import VerticalSession, feature_parties
    s = VerticalSession(*feature_parties(*make_vertical_mnist_parties(
        n, n_owners=len(splits), seed=0, keep_frac=keep_frac,
        feature_splits=splits)), device=device)
    s.resolve(group="modp512", parallelism=parallelism)
    return s.build(dataclasses.replace(
        CONFIG, feature_splits=splits, split=dataclasses.replace(
            CONFIG.split, n_owners=len(splits), **split)))


def run_fit(session, total, what, need=None, evaluate=True, **kw):
    """``session.fit(**kw)`` from its built params, then one evaluate,
    with the launch counts read around both and checked against
    ``need(session)``; the counts are added into ``total``."""
    session.build(session.config)
    reset_counts()
    h = session.fit(**kw)
    if evaluate:
        session.evaluate()
    counts = read_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    if need is not None:
        check_counts(counts, need(session), what)
    return h


def phase_fit_options(bw, f32_flops):
    """Phase 18: the delivery wait's precision at 8 ms one-way; the
    paper's pipeline at 8 ms (pipelined, sequential, 4 microbatches, and
    a 1e8 B/s link) against its round-trip floors and bitwise against
    latency 0; owners of unequal widths (588 + 196 on queue and process,
    the reference's eight on the queue) split == joint bitwise, with cut
    fusion at P = 8 timed; and checkpoints of a process fit restored and
    resumed bit for bit."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_split
    from repro_torch.kernels.cut_fusion import (cut_fusion, cut_fusion_ref,
                                                route_of)
    from repro_torch.tree import tree_leaves
    out = {"latency_s": WIRE_LATENCY, "bandwidth_bps": WIRE_BANDWIDTH}
    total: dict = {}

    # ---- (a) the delivery wait: spin, then the sleep alone
    out["wire"] = {}
    for backend in ("queue", "process"):
        for spin in (True, False):
            r = wire_overshoot(backend, spin)
            out["wire"][f"{backend}/{'spin' if spin else 'sleep'}"] = r
            w, d = r["wait"], r["delivery"]
            print(f"  (a) {backend}, {'spin' if spin else 'sleep alone'} "
                  f"(spin_s {r['spin_s']}), {WIRE_FRAMES} frames at "
                  f"{1e3 * WIRE_LATENCY:.0f} ms one-way, past the "
                  f"deadline: the wait ends p50 {w['p50_ms']:.4f} / p90 "
                  f"{w['p90_ms']:.4f} / max {w['max_ms']:.4f} ms; recv "
                  f"returns p50 {d['p50_ms']:.4f} / p90 {d['p90_ms']:.4f} "
                  f"/ max {d['max_ms']:.4f} ms")
            if w["min_ms"] < 0:
                raise AssertionError(f"{backend}: a wait ended before its "
                                     "deadline")
            if spin and w["p50_ms"] >= 0.1:
                raise AssertionError(f"{backend}: p50 overshoot of the "
                                     f"wait {w['p50_ms']:.4f} ms >= 0.1 ms")

    # ---- (b) the paper's pipeline at 8 ms one-way
    s, _ = mnist_session("cuda")
    base = dict(epochs=1, batch_size=128, eval_frac=0.15, mode="split",
                compression="int8", backend="queue", verbose=False)
    runs = {"pipelined": dict(schedule="pipelined"),
            "sequential": dict(schedule="sequential"),
            "pipelined_m4": dict(microbatches=4)}
    zero = {}
    for name, kw in runs.items():
        M = kw.get("microbatches", 1)
        sched = kw.get("schedule", "pipelined")
        h = run_fit(s, total, f"the {name} fit at latency 0",
                    lambda x: fit_counts(x, sched, M), **base, **kw)
        zero[name] = (leaves_of(s), h["loss_trail"])
    runs["pipelined_bw"] = dict(bandwidth_bps=WIRE_BANDWIDTH)
    out["pipeline"] = {}
    for name, kw in runs.items():
        M = kw.get("microbatches", 1)
        sched = kw.get("schedule", "pipelined")
        h = run_fit(s, total, f"the {name} fit at 8 ms",
                    lambda x: fit_counts(x, sched, M), **base, **kw,
                    latency_s=WIRE_LATENCY)
        ts = s.transport_stats
        wk = ts["wire_by_kind"]
        frame = {k: wk[k]["wire_bytes"] / wk[k]["count"]
                 for k in ("cut_activations", "cut_gradients")}
        rtts = 2 if sched == "sequential" else 1
        floor = 1e3 * 2 * rtts * WIRE_LATENCY
        if "bandwidth_bps" in kw:
            # the step's one round trip carries a gradient and a cut frame
            floor += 1e3 * (frame["cut_activations"]
                            + frame["cut_gradients"]) / WIRE_BANDWIDTH
        twin = "pipelined" if name == "pipelined_bw" else name
        params0, trail0 = zero[twin]
        bitwise = same_leaves(leaves_of(s), params0) \
            and h["loss_trail"] == trail0
        out["pipeline"][name] = {
            "steady_step_ms": ts["steady_step_ms"], "step_ms": ts["step_ms"],
            "floor_ms": floor, "steps": ts["steps"], "microbatches": M,
            "frame_bytes": frame, "bitwise_vs_latency_0": bitwise}
        print(f"  (b) {name}: steady_step_ms {ts['steady_step_ms']:.3f} "
              f"(floor {floor:.3f} ms: {rtts} round trip(s) of "
              f"{1e3 * WIRE_LATENCY:.0f} ms one-way"
              + (f" + a {frame['cut_activations']:.0f} B cut and a "
                 f"{frame['cut_gradients']:.0f} B gradient at "
                 f"{WIRE_BANDWIDTH:.0e} B/s" if "bandwidth_bps" in kw
                 else "")
              + f"), step_ms {ts['step_ms']:.3f}; params and loss trail "
              f"{'bitwise equal to' if bitwise else 'DIFFER from'} "
              f"latency 0")
        if not bitwise:
            raise AssertionError(f"{name}: latency changed the fit")
        if ts["steady_step_ms"] < floor:
            raise AssertionError(f"{name}: step below its floor")
    pipe = out["pipeline"]
    if not pipe["pipelined"]["steady_step_ms"] < \
            pipe["sequential"]["steady_step_ms"]:
        raise AssertionError("pipelined is not faster than sequential")

    # ---- (c) owners of unequal widths
    N = min(8, os.cpu_count() or 1)
    out["imbalanced"] = {}
    lossless = dict(base, compression=None)
    s2 = owners_session("cuda", IMBALANCED, 0.9)
    run_fit(s2, total, "the joint fit (588 + 196)",
            lambda x: {"cut_fusion": trunk_forwards(x, "joint",
                                                    evaluates=2)},
            **dict(lossless, mode="joint"))
    joint = (leaves_of(s2), s2.history["loss_trail"])
    for backend in ("queue", "process"):
        t = time.time()
        h = run_fit(s2, total, f"the lossless {backend} fit (588 + 196)",
                    lambda x: fit_counts(x, int8=False),
                    **dict(lossless, backend=backend))
        if not (same_leaves(leaves_of(s2), joint[0])
                and h["loss_trail"] == joint[1]):
            raise AssertionError(f"588 + 196, {backend}: split != joint")
        lossless_s = time.time() - t
        t = time.time()
        h8 = run_fit(s2, total, f"the int8 {backend} fit (588 + 196)",
                     lambda x: fit_counts(x, process=backend == "process"),
                     **dict(base, backend=backend))
        po = s2.transport_stats["per_owner"]
        if len({v["cut_wire_bytes"] for v in po.values()}) != 1:
            raise AssertionError(f"588 + 196, {backend}: cut bytes differ "
                                 f"by owner: {po}")
        out["imbalanced"][f"588+196/{backend}"] = {
            "shared": len(s2.scientist.ids),
            "steps": s2.transport_stats["steps"],
            "int8_loss_trail": h8["loss_trail"],
            "steady_step_ms": s2.transport_stats["steady_step_ms"],
            "cut_wire_bytes_per_owner": po["owner0"]["cut_wire_bytes"]}
        print(f"  (c) 588 + 196 on {backend}: lossless split == joint, "
              f"params and loss trail bitwise ({len(joint[1])} steps, "
              f"{lossless_s:.2f} s); int8 fit ({time.time() - t:.2f} s) "
              f"trail {[round(v, 4) for v in h8['loss_trail']]}, steady "
              f"{s2.transport_stats['steady_step_ms']:.3f} ms, "
              f"{po['owner0']['cut_wire_bytes']} cut bytes per owner")
    if out["imbalanced"]["588+196/queue"]["int8_loss_trail"] != \
            out["imbalanced"]["588+196/process"]["int8_loss_trail"]:
        raise AssertionError("588 + 196 int8: process != queue")
    t = time.time()
    # half phase 4's subjects: an eight-owner PSI is the phase's longest
    s8 = owners_session("cuda", EIGHT_OWNERS, 0.95, parallelism=N, n=1000)
    resolve_s = time.time() - t
    run_fit(s8, total, "the joint fit (eight owners)",
            lambda x: {"cut_fusion": trunk_forwards(x, "joint",
                                                    evaluates=2)},
            **dict(lossless, mode="joint"))
    joint8 = (leaves_of(s8), s8.history["loss_trail"])
    h = run_fit(s8, total, "the lossless queue fit (eight owners)",
                lambda x: fit_counts(x, int8=False), **lossless)
    po = s8.transport_stats["per_owner"]
    if not (same_leaves(leaves_of(s8), joint8[0])
            and h["loss_trail"] == joint8[1]):
        raise AssertionError("eight owners: split != joint")
    if len({v["cut_wire_bytes"] for v in po.values()}) != 1:
        raise AssertionError(f"eight owners: cut bytes differ: {po}")
    h8 = run_fit(s8, total, "the int8 queue fit (eight owners)",
                 lambda x: fit_counts(x), **base)
    out["imbalanced"]["eight/queue"] = {
        "shared": len(s8.scientist.ids), "resolve_s": resolve_s,
        "steps": s8.transport_stats["steps"],
        "int8_loss_trail": h8["loss_trail"],
        "steady_step_ms": s8.transport_stats["steady_step_ms"]}
    print(f"  (c) eight owners {EIGHT_OWNERS} on the queue "
          f"({len(s8.scientist.ids)} shared, resolved with a pool of {N} "
          f"in {resolve_s:.2f} s): lossless split == joint bitwise over "
          f"{len(joint8[1])} steps, one cut byte count "
          f"({po['owner0']['cut_wire_bytes']}) for every owner; int8 "
          f"steady {s8.transport_stats['steady_step_ms']:.3f} ms")
    # cut fusion at P = 8, the trunk's input at eight owners
    P, T, K, D, combine, _ = CUT_P8
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(size=(P, T, K)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(P, K, D)).astype(
        np.float32)).cuda()
    want = cut_fusion_ref(z, w, combine=combine)
    got = cut_fusion(z, w, combine)
    d = (got - want).abs()
    ratio = (d / (2e-4 + 2e-4 * want.abs())).max().item()
    if ratio > 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"cut_fusion P = 8: max |diff| "
                             f"{d.max().item():.3e} beyond atol=rtol=2e-4")
    bound, by, flops, nbytes = cut_bound(CUT_P8, torch.float32, bw,
                                         f32_flops)
    library = cut_library_call(z, w, combine)
    p8 = {"shape": list(CUT_P8[:4]), "combine": combine,
          "dtype": "float32", "route": route_of(z, w, combine),
          "max_abs_err": d.max().item(), "tol_ratio": ratio,
          "ms": device_ms(lambda: cut_fusion(z, w, combine)),
          "plain_ms": device_ms(lambda: cut_fusion_ref(z, w,
                                                       combine=combine)),
          "library_ms": device_ms(library), "bound_ms": bound,
          "bound_by": by, "flops": flops, "bytes": nbytes}
    p8["x_lib"] = p8["ms"] / p8["library_ms"]
    out["cut_fusion_p8"] = p8
    print(f"  (c) cut_fusion (P, T, k, d) {CUT_P8[:4]} f32 "
          f"[{p8['route']}]: max |diff| {p8['max_abs_err']:.3e} (ratio "
          f"{ratio:.3f}); {p8['ms']:.6f} ms, plain {p8['plain_ms']:.6f} "
          f"ms, library {p8['library_ms']:.6f} ms (x lib "
          f"{p8['x_lib']:.2f}), bound {bound:.6f} ms ({by})")

    # ---- (d) checkpoints of a process fit, restored and resumed
    ckpt_dir = Path(__file__).resolve().parent / "build" / "phase18_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(steps=10, batch_size=128, eval_frac=0.15, mode="split",
              compression="int8", verbose=False, shuffle_seed=0)
    try:
        run_fit(s, total, "the process fit with checkpoints",
                lambda x: fit_counts(x, process=True, evaluates=1),
                evaluate=False,
                **kw, backend="process", ckpt_dir=str(ckpt_dir),
                ckpt_every=5)
        ts = s.transport_stats
        ten = leaves_of(s)
        dirs = sorted(os.listdir(ckpt_dir))
        if dirs != ["step_00000005", "step_00000010"]:
            raise AssertionError(f"checkpoints at {dirs}")
        if not same_leaves([torch.from_numpy(a) for a in tree_leaves(
                restore_split(str(ckpt_dir / dirs[1])))], ten):
            raise AssertionError("the step-10 files != the fit's params")
        # the same five steps without checkpoints (queue == process)
        half = dict(kw, steps=5, backend="queue")
        run_fit(s, total, "five steps", None, evaluate=False, **half)
        five = leaves_of(s)
        if not same_leaves([torch.from_numpy(a) for a in tree_leaves(
                restore_split(str(ckpt_dir / dirs[0])))], five):
            raise AssertionError("the step-5 files != five steps' params")
        s.fit(**half)                     # on, without a restore
        on = (leaves_of(s), s.history["loss_trail"])
        fresh, _ = mnist_session("cuda")
        fresh.restore(str(ckpt_dir / dirs[0]))
        if not same_leaves(leaves_of(fresh), five):
            raise AssertionError("restored params != the step-5 state")
        fresh.fit(**half)
        if not (same_leaves(leaves_of(fresh), on[0])
                and fresh.history["loss_trail"] == on[1]):
            raise AssertionError("the resumed fit != the session that "
                                 "went on without a restore")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["checkpoint"] = {"ckpt_s": ts["ckpt_s"],
                         "steady_step_ms": ts["steady_step_ms"],
                         "step_ms": ts["step_ms"]}
    print(f"  (d) process fit, 10 steps, ckpt_every=5: files at {dirs}; "
          f"checkpoint wall {[round(x, 4) for x in ts['ckpt_s']]} s "
          f"(sync + pull + save) beside a steady step of "
          f"{ts['steady_step_ms']:.3f} ms; the step-10 files == the fit's "
          f"params, the step-5 files == five steps' params, bitwise; "
          f"restored + 5 steps == the same session going on without a "
          f"restore (params and loss trail bitwise)")
    return out, total


# ---------------------------------------------------------------------------
# Phase 19: the rest of LM serving — continuous batching on per-row decode
# positions, the process transport, the cut cache, multiplexed sessions,
# latency, degraded service, the cut bottleneck, the session entry point
# ---------------------------------------------------------------------------

# (b)'s requests: phase 7's eight contexts with mixed max_new; the
# continuous schedule at 4 slots takes 52 ticks, the waves 64 token steps
MIXED = [32, 8, 24, 4, 32, 16, 12, 28]
# (a): llama's trunk decode tick with per-row kv lengths over 1025-1057
PER_ROW_LENS = (1025, 1041, 1057, 1033)
CUT_DIM = 768                      # (h): a quarter of d_model
LATENCY_S = 0.008                  # (f): one way


def per_row_kernel(bw):
    """19(a): the decode kernel with per-row lengths against its plain
    version, each row's bits against a scalar call at that row's length,
    a vector of equal lengths against the scalar call; timed beside the
    scalar route at the same shape and SDPA with a per-row mask."""
    import numpy as np
    import torch
    from repro_torch.kernels.block_attention import (attention_ref,
                                                     block_attention)
    B, Sq, Skv, nh, nkv, hd = 4, 1, 1057, 24, 8, 128
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .cuda().to(torch.bfloat16)
               for s in ((B, Sq, nh, hd), (B, Skv, nkv, hd),
                         (B, Skv, nkv, hd)))
    lens = torch.tensor(PER_ROW_LENS)
    kw = dict(q_offset=lens - 1, kv_len=lens)
    got = block_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    e = (got.float() - want.float()).abs()
    if not bool((e <= 2e-2 + 2e-2 * want.float().abs()).all()):
        raise AssertionError(f"per-row decode: max |diff| "
                             f"{e.max().item():.3e} beyond 2e-2")
    for b, n in enumerate(PER_ROW_LENS):
        alone = block_attention(q, k, v, q_offset=n - 1, kv_len=n)
        same = block_attention(q, k, v, q_offset=torch.full((B,), n - 1),
                               kv_len=torch.full((B,), n))
        torch.cuda.synchronize()
        if not torch.equal(got[b], alone[b]):
            raise AssertionError(f"per-row decode: row {b}'s bits differ "
                                 f"from a call at its length {n}")
        if not torch.equal(same, alone):
            raise AssertionError(f"per-row decode at {n}: the vector call "
                                 "differs from the scalar call")
    mask = (torch.arange(Skv, device="cuda")[None, :]
            < lens.cuda()[:, None])[:, None, None]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max()
    torch.use_deterministic_algorithms(False)
    library_ms = device_ms(lib, reps=10, rounds=7)
    torch.use_deterministic_algorithms(True)
    # the plain version reads the lengths on the card (a graph captures
    # no copy from pageable host memory)
    kw_dev = {n: t.cuda() for n, t in kw.items()}
    keys = sum(PER_ROW_LENS)
    nbytes = 2 * (2 * B * Sq * nh * hd + 2 * keys * nkv * hd)
    flops = 4 * nh * hd * Sq * keys
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / BF16_FLOPS
    row = {"shape": [[B, Sq, nh, hd], [B, Skv, nkv, hd]],
           "kv_lens": list(PER_ROW_LENS),
           "max_abs_err": e.max().item(),
           "ms": device_ms(lambda: block_attention(q, k, v, **kw),
                           reps=10, rounds=7),
           "scalar_ms": device_ms(lambda: block_attention(
               q, k, v, q_offset=Skv - 1, kv_len=Skv), reps=10, rounds=7),
           "plain_ms": device_ms(lambda: attention_ref(q, k, v, **kw_dev),
                                 reps=5, rounds=5),
           "eager_ms": eager_ms(lambda: block_attention(q, k, v, **kw),
                                reps=10, rounds=5),
           "library_ms": library_ms,
           "library_max_abs_err": lib_err.item(),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"  per-row decode {row['shape']} kv_lens {row['kv_lens']} bf16: "
          f"max |diff| {row['max_abs_err']:.3e} (tol 2e-2); every row == a "
          f"call at its length, and vector == scalar, bitwise\n    "
          f"{row['ms']:.6f} ms (eager {row['eager_ms']:.6f}); scalar route "
          f"at kv_len {Skv} {row['scalar_ms']:.6f} ms; plain "
          f"{row['plain_ms']:.6f} ms; SDPA (per-row mask) "
          f"{row['library_ms']:.6f} ms (|diff| "
          f"{row['library_max_abs_err']:.2e}); bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


def profile_schedulers(model, params, kw, ctxs, n_new=12):
    """Both schedulers on the same 4 requests of ``n_new`` tokens (the
    same forwards: one prefill, ``n_new`` - 1 decode steps) under
    torch.profiler: wall, device busy share, top-level aten ops and the
    host time of the ops that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.engine import ServingEngine
    out = {}
    for sched in ("wave", "continuous"):
        eng = ServingEngine(model, params, scheduler=sched,
                            **dict(kw, max_new=n_new))
        for c in ctxs:
            eng.submit(c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels, top, host_ops = read_profile(prof)
        busy = sum(us for _, us in kernels.values())
        host = sorted(((us, k, n) for k, (n, us) in host_ops.items()),
                      reverse=True)
        out[sched] = {"wall_ms": 1e3 * wall,
                      "busy_share": busy / (1e6 * wall) if busy else None,
                      "top_level_aten_ops": top,
                      "host_ms_top": [(k, round(us / 1e3, 3), n)
                                      for us, k, n in host[:6]]}
        print(f"    profiled {sched} (4 x {n_new} tokens, profiler on): "
              f"wall {1e3 * wall:.3f} ms, device busy "
              f"{out[sched]['busy_share']}, {top} top-level aten ops; "
              f"host ms by op {out[sched]['host_ms_top']}")
    return out


def tick_table(transcript, n_ticks):
    """Per tick of one continuous run (its transcript's slice): whether
    some slot decodes, and the admissions that need a prefill (cache hits
    excluded)."""
    admit, finish, hit = {}, {}, set()
    for ev in transcript:
        if ev[0] in ("admit", "refill"):
            admit[ev[1]] = ev[3]
        elif ev[0] == "finish":
            finish[ev[1]] = ev[3]
        elif ev[0] == "cut_cache_hit":
            hit.add(ev[1])
    decode = [any(admit[r] < t <= finish[r] for r in finish)
              for t in range(n_ticks)]
    prefill = [any(t == admit[r] and r not in hit for r in admit)
               for t in range(n_ticks)]
    return decode, prefill


def serving_need(model, decode_steps, prefills, per_row, int8_frames=None):
    """Exact launches of a run with ``decode_steps`` decode forwards and
    ``prefills`` prefill forwards: every attention block of every forward
    (decode route at a decode step — per-row on the continuous engine —
    tc at a prefill), every Mamba2 block of a prefill (chunked scan), one
    quantize per int8 cut message."""
    cfg = model.cfg
    units = model.P * model.n_head_units + model.n_trunk_units
    n_attn = units * sum(k != "mamba2" for k in cfg.block_pattern)
    n_ssm = units * sum(k == "mamba2" for k in cfg.block_pattern)
    need = {"block_attention": n_attn * (decode_steps + prefills),
            "block_attention.decode": n_attn * decode_steps,
            "block_attention.tc": n_attn * prefills,
            "block_attention.fma": 0,
            "block_attention.per_row": n_attn * decode_steps if per_row
            else 0,
            "mamba2_scan": n_ssm * prefills,
            "mamba2_scan.chunked": n_ssm * prefills,
            "mamba2_scan.serial": 0}
    if int8_frames is not None:
        need["quantize_pack_int8"] = int8_frames
    return need


def continuous_need(eng, start, model, int8=True):
    """The exact launches of the continuous run whose transcript starts at
    ``start``, derived from its ticks and refills: a decode tick ships one
    int8 decode frame, a prefill ships one cut_prefill frame per owner."""
    decode, prefill = tick_table(eng.transcript[start:], eng._tick)
    n_dec, n_pre = sum(decode), sum(prefill)
    need = serving_need(model, n_dec, n_pre, True,
                        n_dec + model.P * n_pre if int8 else None)
    return need, n_dec, n_pre


def wave_need(model, mixed, slots=SLOTS):
    """The wave engine's launches on ``mixed``: per wave one prefill and
    max(max_new) - 1 decode steps, one int8 frame per owner at the
    prefill and one per decode step."""
    waves = [mixed[i:i + slots] for i in range(0, len(mixed), slots)]
    steps = sum(max(w) - 1 for w in waves)
    need = serving_need(model, steps, len(waves), False,
                        steps + model.P * len(waves))
    return need, sum(max(w) for w in waves)


def served(eng, ctxs, mixed):
    """Submit, run under fresh launch counts, read them: (tokens, counts,
    wall s, transcript start)."""
    import torch
    start = len(eng.transcript)
    rids = [eng.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.run()
    counts = read_counts()
    wall = time.perf_counter() - t
    bad = [r for r in rids if out[r].error]
    if bad:
        raise AssertionError(f"requests {bad} failed: {out[bad[0]].error}")
    return [out[r].generated for r in rids], counts, wall, start


def tick_timed_engine(*a, **kw):
    """A ``ServingEngine`` that records the host time (after a device
    sync) at every tick's end: ``tick_ends``, from the run's start."""
    import torch
    from repro_torch.launch.engine import ServingEngine

    class TickTimed(ServingEngine):
        @property
        def _tick(self):
            return self.__dict__.get("_tick_n", 0)

        @_tick.setter
        def _tick(self, n):
            torch.cuda.synchronize()
            if n == 0:
                self.tick_ends = [time.perf_counter()]
            else:
                self.tick_ends.append(time.perf_counter())
            self.__dict__["_tick_n"] = n

    return TickTimed(*a, **kw)


def timed_wire_waits(eng):
    """Time every delivery wait of the in-process transport (the receiver
    blocking until a frame's injected ``not_before``) while ``eng`` runs,
    summed per tick of a ``tick_timed_engine``: returns ``(waits,
    restore)`` with ``waits`` {tick: seconds}; ``restore()`` puts the
    transport's own wait back."""
    from repro_torch.federation import transport
    orig, waits = transport.wait_until, {}

    def timed(deadline, spin_s=transport.SPIN_WAIT_S):
        t = time.perf_counter()
        orig(deadline, spin_s)
        tick = eng.__dict__.get("_tick_n", 0)
        waits[tick] = waits.get(tick, 0.0) + time.perf_counter() - t

    def restore():
        transport.wait_until = orig

    transport.wait_until = timed
    return waits, restore


def bottleneck_params(model, params, cut_dim):
    """Phase 7's param tree plus each head's ``cut_proj`` (d -> cut_dim)
    and the trunk's ``in_proj`` (cut_dim -> d), drawn on the card; the
    other leaves are shared, not copied."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda").manual_seed(1)
    d = model.cfg.d_model
    heads = dict(params["heads"])
    heads["cut_proj"] = {"w": torch.stack([layers.dense_init(
        gen, d, cut_dim)["w"] for _ in range(model.P)])}
    trunk = dict(params["trunk"])
    trunk["in_proj"] = layers.dense_init(gen, cut_dim, d)
    return {"heads": heads, "trunk": trunk}


def phase_continuous(model, params, bw):
    """Phase 19 (a)-(h) on phase 7's llama3.2-3b params."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.engine import (CutCache, ServingEngine,
                                           ServingService)
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves
    out = {}
    t0 = time.time()
    print("  (a) the decode kernel with per-row lengths")
    out["per_row_kernel"] = per_row_kernel(bw)
    cfg = model.cfg
    ctxs = lm_contexts(cfg.vocab, len(MIXED), CTX)
    kw = dict(batch_slots=SLOTS, ctx_len=CTX, max_new=NEW,
              transport="queue", compression="int8", device="cuda")

    warm = ServingEngine(model, params, scheduler="continuous", **kw)
    served(warm, ctxs[:2], [2, 1])
    print(f"  (b) continuous vs wave: {len(MIXED)} requests of {CTX} "
          f"tokens, max_new {MIXED}, {SLOTS} slots, int8, queue")
    wave = ServingEngine(model, params, **kw)
    w_toks, w_counts, w_wall, _ = served(wave, ctxs, MIXED)
    need, wave_ticks = wave_need(model, MIXED)
    check_counts(w_counts, need, "the wave run")
    cont = ServingEngine(model, params, scheduler="continuous", **kw)
    c_toks, c_counts, c_wall, start = served(cont, ctxs, MIXED)
    need, n_dec, n_pre = continuous_need(cont, start, model)
    check_counts(c_counts, need, "the continuous run")
    st = cont.stats
    if c_toks != w_toks:
        bad = [i for i, (a, b) in enumerate(zip(c_toks, w_toks)) if a != b]
        raise AssertionError(f"continuous != wave tokens for {bad}")
    if not st["ticks"] < wave_ticks:
        raise AssertionError(f"{st['ticks']} ticks, the waves took "
                             f"{wave_ticks}")
    n_tok = sum(MIXED)
    out["continuous_vs_wave"] = {
        "tokens_equal": True, "ticks": st["ticks"],
        "wave_token_steps": wave_ticks, "decode_ticks": n_dec,
        "prefill_ticks": n_pre, "slot_refills": st["slot_refills"],
        "wall_ms": 1e3 * c_wall, "wave_wall_ms": 1e3 * w_wall,
        "tok_per_s": n_tok / c_wall, "wave_tok_per_s": n_tok / w_wall,
        "ms_per_tick": 1e3 * c_wall / st["ticks"],
        "wave_ms_per_step": 1e3 * w_wall / wave_ticks,
        "counts": c_counts, "wave_counts": w_counts,
        "cut_wire_bytes": st["cut_wire_bytes"],
        "cut_messages": st["cut_messages"]}
    print(f"    tokens bitwise equal; continuous {st['ticks']} ticks ({n_dec} "
          f"decode, {n_pre} with a prefill, {st['slot_refills']} refills) "
          f"in {1e3 * c_wall:.3f} ms = {n_tok / c_wall:.2f} tok/s, "
          f"{1e3 * c_wall / st['ticks']:.3f} ms per tick; wave "
          f"{wave_ticks} token steps in {1e3 * w_wall:.3f} ms = "
          f"{n_tok / w_wall:.2f} tok/s, {1e3 * w_wall / wave_ticks:.3f} "
          f"ms per step")
    cont.close()
    out["profile"] = profile_schedulers(model, params, kw, ctxs[:SLOTS])

    print("  (c) the same continuous run on the process transport")
    proc = ServingEngine(model, params, scheduler="continuous",
                         **dict(kw, transport="process"))
    p_toks, p_counts, p_wall, start = served(proc, ctxs, MIXED)
    check_counts(p_counts, continuous_need(proc, start, model)[0],
                 "the process run")
    proc.close()
    for k in ("cut_wire_bytes", "cut_messages", "cut_payload_bytes"):
        if proc.stats[k] != st[k]:
            raise AssertionError(f"process {k} {proc.stats[k]} != queue "
                                 f"{st[k]}")
    if p_toks != c_toks:
        raise AssertionError("process tokens differ from the queue's")
    out["process"] = {"tokens_equal": True, "wall_ms": 1e3 * p_wall,
                      "cut_wire_bytes": proc.stats["cut_wire_bytes"],
                      "cut_messages": proc.stats["cut_messages"]}
    print(f"    tokens, cut_wire_bytes {proc.stats['cut_wire_bytes']} and "
          f"cut_messages {proc.stats['cut_messages']} equal the queue's; "
          f"wall {1e3 * p_wall:.3f} ms")

    print(f"  (d) the cut cache ({len(MIXED)} entries), the requests twice")
    cache = CutCache(max_entries=len(MIXED))
    ce = ServingEngine(model, params, scheduler="continuous",
                       cut_cache=cache, **kw)
    first, _, _, _ = served(ce, ctxs, MIXED)
    before = dict(ce._ep_sci.recv_stats["by_kind"].get(
        "cut_prefill", {"payload_bytes": 0}))
    again, h_counts, h_wall, start = served(ce, ctxs, MIXED)
    need, n_dec_h, n_pre_h = continuous_need(ce, start, model)
    check_counts(h_counts, need, "the cache-hit run")
    after = ce._ep_sci.recv_stats["by_kind"]["cut_prefill"]
    hits = ce.stats["cut_cache_hits"]
    if (hits != len(MIXED) or n_pre_h != 0
            or after["payload_bytes"] != before["payload_bytes"]
            or first != c_toks or again != c_toks):
        raise AssertionError(f"cut cache: {hits} hits, {n_pre_h} prefills, "
                             f"prefill bytes {before} -> {after}")
    entry = next(iter(cache._d.values()))
    per_entry = sum(t.numel() * t.element_size()
                    for t in tree_leaves(entry))
    out["cut_cache"] = {"hits": hits, "bytes_per_entry": per_entry,
                        "hit_run_wall_ms": 1e3 * h_wall,
                        "counts": h_counts}
    print(f"    {hits} cut_cache_hits, 0 prefill cut bytes on the second "
          f"run, tokens bitwise equal; {per_entry} bytes per entry "
          f"({per_entry / 1e6:.1f} MB); hit run {1e3 * h_wall:.3f} ms")
    del ce, cache, entry

    print("  (e) ServingService: two sessions on two threads over one "
          "process channel")
    import threading
    sets = [(ctxs[:4], [8, 4, 6, 2]), (ctxs[4:], [8, 2, 4, 6])]
    svc = ServingService(model, params, transport="process",
                         batch_slots=SLOTS, ctx_len=CTX, max_new=NEW,
                         compression="int8", cache_entries=len(MIXED),
                         device="cuda")
    sessions = [svc.session(), svc.session()]
    res, errors = {}, []

    def drive(i):
        try:
            s, (cs, mx) = sessions[i], sets[i]
            rids = [s.submit(c, max_new=m) for c, m in zip(cs, mx)]
            o = s.run()
            res[i] = [o[r].generated for r in rids]
        except BaseException as e:           # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(i,)) for i in (0, 1)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    svc_wall = time.perf_counter() - t
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"multiplexed sessions failed: {errors}")
    solo = []
    for cs, mx in sets:
        e = ServingEngine(model, params, scheduler="continuous",
                          **dict(kw, transport="process"))
        solo.append(served(e, cs, mx)[0])
        e.close()
    raw = svc.channel_stats
    scoped = [s._ep_sci.recv_stats for s in sessions]
    if [res[0], res[1]] != solo:
        raise AssertionError("a session's tokens differ from its solo run")
    for k in ("messages", "payload_bytes", "wire_bytes"):
        if raw[k] != sum(sc[k] for sc in scoped):
            raise AssertionError(f"scoped {k} do not sum to the channel's")
    svc.close()
    out["sessions"] = {"tokens_equal_solo": True, "wall_ms": 1e3 * svc_wall,
                       "channel_wire_bytes": raw["wire_bytes"],
                       "session_wire_bytes": [sc["wire_bytes"]
                                              for sc in scoped]}
    print(f"    each session == its solo run; scoped wire bytes "
          f"{[sc['wire_bytes'] for sc in scoped]} sum to the channel's "
          f"{raw['wire_bytes']}; both sessions in {1e3 * svc_wall:.3f} ms")
    del svc, sessions

    print(f"  (f) latency: continuous on the queue at "
          f"{1e3 * LATENCY_S:.0f} ms one-way against 0")
    lat_ctx, lat_mx = ctxs[:6], [12, 4, 8, 2, 6, 10]
    # A tick's wall time swings by tens of ms from run to run on the host,
    # so the windows a tick pays are read from the transport itself: the
    # time its receives block until a frame's delivery deadline.  A refill
    # tick whose ships are both sent before either receive waits at most
    # one window in all; a refill shipped after the decode's receive
    # would wait two.
    runs = {}
    for lat in (0.0, LATENCY_S, 0.0):      # latency 0 before and after
        e = tick_timed_engine(model, params, scheduler="continuous",
                              **dict(kw, latency_s=lat))
        waits, restore = timed_wire_waits(e)
        try:
            toks, _, wall, start = served(e, lat_ctx, lat_mx)
        finally:
            restore()
        ends = e.tick_ends
        decode, prefill = tick_table(e.transcript[start:], e._tick)
        kinds = ["refill" if p and d else "prefill" if p else "decode"
                 for d, p in zip(decode, prefill)]
        runs.setdefault(lat, []).append(
            ([1e3 * (b - a) for a, b in zip(ends, ends[1:])], toks, kinds,
             [1e3 * waits.get(i, 0.0) for i in range(len(kinds))]))
    t0s = [min(a, b) for a, b in zip(runs[0.0][0][0], runs[0.0][1][0])]
    t8, toks8, kinds, w8 = runs[LATENCY_S][0]
    if toks8 != runs[0.0][0][1] or kinds != runs[0.0][0][2]:
        raise AssertionError("the run at 8 ms differs from latency 0")
    if any(w for r in runs[0.0] for w in r[3]):
        raise AssertionError("a receive waited on the wire at latency 0")
    floor = 1e3 * LATENCY_S
    print("    tick: kind, ms at 8 ms one-way (floor 8) | ms at 0 (the "
          "lesser of two runs) | difference | ms waited on the wire at 8")
    for i, (k, a, b, w) in enumerate(zip(kinds, t8, t0s, w8)):
        print(f"    {i:3d}: {k:7s} {a:9.3f} | {b:9.3f} | {a - b:8.3f} | "
              f"{w:7.3f}")
    if min(t8) < floor:
        raise AssertionError(f"a tick at {min(t8):.3f} ms, below the "
                             f"{floor} ms one-way floor")
    refill_wait = [w for k, w in zip(kinds, w8) if k == "refill"]
    decode_wait = [w for k, w in zip(kinds, w8) if k == "decode"]
    # a decode tick receives its own frame at once: it waits the window
    if not decode_wait or min(decode_wait) < 0.75 * floor:
        raise AssertionError(f"decode ticks waited {decode_wait} ms on the "
                             f"wire, not the {floor} ms window")
    if not refill_wait or max(refill_wait) > 1.5 * floor:
        raise AssertionError(f"refill ticks waited {refill_wait} ms on the "
                             f"wire: more than one {floor} ms window")
    refill_extra = [a - b for k, a, b in zip(kinds, t8, t0s)
                    if k == "refill"]
    decode_extra = [a - b for k, a, b in zip(kinds, t8, t0s)
                    if k == "decode"]
    out["latency"] = {
        "one_way_ms": floor, "kinds": kinds, "tick_ms": t8,
        "tick_ms_latency0": t0s, "wire_wait_ms": w8,
        "refill_wire_wait_ms": refill_wait,
        "decode_wire_wait_ms_median": float(np.median(decode_wait)),
        "refill_extra_ms_median": float(np.median(refill_extra)),
        "decode_extra_ms_median": float(np.median(decode_extra))}
    print(f"    every tick at or above the {floor} ms floor; waited on the "
          f"wire: refill ticks {[round(w, 3) for w in refill_wait]} ms (at "
          f"most one {floor} ms window; two would be {2 * floor}), decode "
          f"ticks median {out['latency']['decode_wire_wait_ms_median']:.3f}"
          f" ms; median wall extra over latency 0: refill ticks "
          f"{out['latency']['refill_extra_ms_median']:.3f} ms, decode "
          f"ticks {out['latency']['decode_extra_ms_median']:.3f} ms")

    print("  (g) degraded service: a transport fault mid-run")
    de = ServingEngine(model, params, scheduler="continuous", **kw)
    sends = {"n": 0}

    def hook(kind, seq):
        sends["n"] += 1
        if sends["n"] == 6:
            raise OSError("link down")
        return None

    de._ep_owner.outbox.fault_hook = hook
    rids = [de.submit(c, max_new=m) for c, m in zip(ctxs[:5],
                                                    [4, 2, 4, 4, 3])]
    got = de.run()
    failed = [r for r in rids if got[r].error]
    if (sorted(got) != sorted(rids) or not failed
            or de.stats["failed_requests"] != len(failed)
            or not all("link down" in got[r].error for r in failed)):
        raise AssertionError(f"degraded service: {got}")
    de._ep_owner.outbox.fault_hook = None
    fresh = de.submit(ctxs[5], max_new=2)
    ok = de.run()[fresh]
    if ok.error or len(ok.generated) != 2:
        raise AssertionError(f"no fresh service after the fault: {ok}")
    out["degraded"] = {"failed": len(failed), "served": len(rids)
                       - len(failed), "fresh_ok": True}
    print(f"    {len(failed)} of {len(rids)} requests failed with "
          f"{got[failed[0]].error!r}; the engine then served a fresh "
          f"request: {ok.generated}")

    print(f"  (h) the cut bottleneck: cut_dim {CUT_DIM} (phase 7's params "
          f"+ cut_proj and in_proj drawn on the card)")
    bcfg = cfg.replace(split=dataclasses.replace(cfg.split,
                                                 cut_dim=CUT_DIM))
    bmodel = SplitModel(bcfg)
    bparams = bottleneck_params(model, params, CUT_DIM)
    be = ServingEngine(bmodel, bparams, scheduler="continuous", **kw)
    send_s, pre_s = [], []
    be._refill_send = synced(be._refill_send, send_s)
    be._refill_recv = synced(be._refill_recv, pre_s)
    b_toks, b_counts, b_wall, start = served(be, ctxs, MIXED)
    need, b_dec, b_pre = continuous_need(be, start, bmodel)
    check_counts(b_counts, need, "the bottleneck run")
    dec = be._ep_sci.recv_stats["by_kind"]["cut_activations"]
    full = cont._ep_sci.recv_stats["by_kind"]["cut_activations"]
    header = 4 + 2 + len("qp") + 2 + len("uint8") + 1 + 3 * 8 + 8
    want_p = dec["count"] * SLOTS * (CUT_DIM + 4)
    if (dec["payload_bytes"] != want_p
            or dec["wire_bytes"] != want_p + dec["count"] * header
            or dec["count"] != b_dec):
        raise AssertionError(f"bottleneck decode frames {dec}, analytic "
                             f"payload {want_p}")
    if any(not 0 <= tk < cfg.vocab for g in b_toks for tk in g) or \
            [len(g) for g in b_toks] != MIXED:
        raise AssertionError("bottleneck serving output wrong")
    ratio = (dec["payload_bytes"] / dec["count"]) / (
        full["payload_bytes"] / full["count"])
    out["bottleneck"] = {
        "cut_dim": CUT_DIM, "decode_frames": dec["count"],
        "decode_payload_bytes": dec["payload_bytes"],
        "decode_wire_bytes": dec["wire_bytes"],
        "payload_ratio_to_d_model": ratio, "counts": b_counts,
        "head_prefill_ms": [1e3 * s for s in send_s],
        "trunk_prefill_ms": [1e3 * s for s in pre_s],
        "wall_ms": 1e3 * b_wall,
        "tok_per_s": sum(MIXED) / b_wall}
    print(f"    {dec['count']} decode frames of {SLOTS} x ({CUT_DIM} + 4) "
          f"payload bytes ({dec['payload_bytes']} B, wire "
          f"{dec['wire_bytes']}: + {header} B of header each) = "
          f"{ratio:.4f} of d_model's ({SLOTS} x 3076 a frame); per "
          f"refill, head prefill + ship ms "
          f"{[round(1e3 * s, 3) for s in send_s]}, receive + trunk "
          f"prefill ms {[round(1e3 * s, 3) for s in pre_s]}; "
          f"{sum(MIXED) / b_wall:.2f} tok/s")
    del bparams, be
    out["wall_s"] = time.time() - t0
    return out


def phase_continuous_session():
    """19(j): VerticalSession(*sequence_parties(...)) -> resolve ->
    build(llama3.2-3b) -> serve_dataset(continuous, process, int8) on the
    card, eight documents of 1024 tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.federation import VerticalSession, sequence_parties
    cfg = get_config(LM)
    toks = lm_contexts(cfg.vocab, 2 * SLOTS, CTX, seed=3)
    t = time.perf_counter()
    s = VerticalSession(*sequence_parties(toks, cfg.split.n_owners,
                                          with_labels=False))
    rstats = s.resolve(group="modp512")
    s.build(cfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    n_new = 8
    reset_counts()
    t = time.perf_counter()
    out, eng = s.serve_dataset(max_new=n_new, batch_slots=SLOTS,
                               scheduler="continuous", transport="process",
                               compression="int8")
    counts = read_counts()
    wall = time.perf_counter() - t
    eng.close()
    need = continuous_need(eng, 0, eng.model)[0]
    check_counts(counts, need, "serve_dataset")
    gen = [out[r].generated for r in sorted(out)]
    if (len(gen) != 2 * SLOTS or any(len(g) != n_new for g in gen)
            or any(not 0 <= tk < cfg.vocab for g in gen for tk in g)
            or any(out[r].error for r in out)):
        raise AssertionError(f"serve_dataset output wrong: {gen}")
    print(f"  PSI {rstats['global_intersection']} documents aligned; build "
          f"+ resolve {setup_s:.2f} s; served {len(gen)} x {n_new} tokens "
          f"in {1e3 * wall:.3f} ms ({eng.stats['ticks']} ticks, "
          f"{eng.stats['cut_messages']} cut messages, "
          f"{eng.stats['cut_wire_bytes']} wire bytes); request 0 -> "
          f"{gen[0]}")
    del s
    return {"documents": len(gen), "ticks": eng.stats["ticks"],
            "wall_ms": 1e3 * wall, "setup_s": setup_s, "counts": counts,
            "cut_wire_bytes": eng.stats["cut_wire_bytes"]}


def phase_continuous_zamba(model, params):
    """19(i): zamba2-2.7b continuous == wave bit for bit on phase 10's
    params: 4 requests of 1024 tokens, max_new up to 8 (the Mamba2 conv
    and state rows scattered on refill, the shared attention block's
    decode on per-row lengths)."""
    from repro_torch.launch.engine import ServingEngine
    ctxs = lm_contexts(model.cfg.vocab, 6, CTX, seed=4)
    mixed = [8, 3, 6, 2, 5, 4]
    kw = dict(batch_slots=SLOTS, ctx_len=CTX, max_new=8, transport="queue",
              compression="int8", device="cuda")
    wave = ServingEngine(model, params, **kw)
    w_toks, w_counts, w_wall, _ = served(wave, ctxs, mixed)
    check_counts(w_counts, wave_need(model, mixed)[0], "the zamba2 wave")
    cont = ServingEngine(model, params, scheduler="continuous", **kw)
    c_toks, c_counts, c_wall, start = served(cont, ctxs, mixed)
    need, n_dec, n_pre = continuous_need(cont, start, model)
    check_counts(c_counts, need, "the zamba2 continuous run")
    if c_toks != w_toks:
        raise AssertionError("zamba2: continuous != wave tokens")
    print(f"  zamba2-2.7b: {len(mixed)} requests, max_new {mixed}: tokens "
          f"bitwise equal; continuous {cont.stats['ticks']} ticks "
          f"({n_dec} decode, {n_pre} with a prefill) in {1e3 * c_wall:.3f} "
          f"ms, wave {1e3 * w_wall:.3f} ms")
    return {"tokens_equal": True, "ticks": cont.stats["ticks"],
            "wall_ms": 1e3 * c_wall, "wave_wall_ms": 1e3 * w_wall,
            "counts": c_counts}


# ---------------------------------------------------------------------------
# Phase 20: LM training at full width (the dense family)
# ---------------------------------------------------------------------------

# (a): the attention Function at llama3.2-3b's training shapes, batch 8:
# the trunk over the combined 256 tokens, a head over its 128
LM_TRAIN_ATTN = {"trunk": (8, 256, 24, 8, 128), "head": (8, 128, 24, 8, 128)}
# (b): llama3.2-3b at full width, 4 layers cut after 2 (two head units per
# owner, two trunk units), 64 documents of 256 tokens, 8 held out, 10
# Adam steps of 8 documents
LM_TRAIN_LAYERS, LM_TRAIN_CUT, LM_TRAIN_DOCS, LM_TRAIN_SEQ = 4, 2, 64, 256
LM_TRAIN_BATCH, LM_TRAIN_STEPS, LM_TRAIN_EVAL = 8, 10, 0.125


def attn_train_bound(shape, dtype, bw, f32_flops):
    """The least time of the attention's forward and of its backward at
    a causal training shape: forward 4·B·nh·hd·pairs FLOP over q, k, v
    in and o out; backward 10·B·nh·hd·pairs (S recomputed, dV, dP, dQ,
    dK) over q, k, v, dO in and dq, dk, dv out."""
    import torch
    B, S, nh, nkv, hd = shape
    pairs = S * (S + 1) // 2
    elt = 2 if dtype == torch.bfloat16 else 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else f32_flops
    qo = B * S * nh * hd * elt
    kv = B * S * nkv * hd * elt
    out = {}
    for part, flops, nbytes in (
            ("fwd", 4 * B * nh * hd * pairs, 2 * qo + 2 * kv),
            ("bwd", 10 * B * nh * hd * pairs, 3 * qo + 4 * kv)):
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / peak
        out[part] = (max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms >= ops_ms else "operations")
    return out


def lm_attention_function(bw, f32_flops):
    """20(a): the attention Function (the kernel forward, the backward of
    plain products) against autograd through the plain version on the
    card, bf16 (route tc) and f32 (route fma) at the training shapes;
    times of the kernel forward, the backward, the plain version's
    forward and forward + backward, SDPA's forward and forward +
    backward, and the bounds."""
    import numpy as np
    import torch
    from repro_torch.kernels.block_attention import (attention_backward,
                                                     attention_fn,
                                                     attention_ref,
                                                     block_attention,
                                                     route_of)
    from repro_torch.kernels.block_attention.ref import attention_mask
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    rows, err = {}, {"fwd": {}, "bwd": {}}
    for name, shape in LM_TRAIN_ATTN.items():
        B, S, nh, nkv, hd = shape
        rng = np.random.default_rng(0)
        base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .cuda() for s in ((B, S, nh, hd), (B, S, nkv, hd),
                                  (B, S, nkv, hd), (B, S, nh, hd))]
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = (t.to(dt) for t in base)

            def fwd_bwd(fn):
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                out = fn(qq, kk, vv)
                out.backward(do)
                return out.detach(), qq.grad, kk.grad, vv.grad

            got = fwd_bwd(attention_fn)
            want = fwd_bwd(attention_ref)
            torch.cuda.synchronize()
            errs = []
            for part, g, w in zip(("out", "dq", "dk", "dv"), got, want):
                e = (g.float() - w.float()).abs()
                lim = tol[dt] + tol[dt] * w.float().abs()
                if not bool((e <= lim).all()) or not torch.isfinite(g).all():
                    raise AssertionError(
                        f"attention Function {name} {dt} {part}: max |diff| "
                        f"{e.max().item():.3e} beyond atol=rtol={tol[dt]}")
                errs.append(e.max().item())
            key = f"{name}:{str(dt)[6:]}"
            route = route_of(q, k, v)
            err["fwd"][key], err["bwd"][key] = errs[0], max(errs[1:])
            bound = attn_train_bound(shape, dt, bw, f32_flops)
            case = (B, S, S, nh, nkv, hd, "causal", 0, 0.0, 0, S)
            sdpa = sdpa_call(q, k, v, case, attention_mask)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa_g = sdpa_call(qs, ks, vs, case, attention_mask)

            def sdpa_fwd_bwd():
                qs.grad = ks.grad = vs.grad = None
                sdpa_g().backward(do)

            def fn_fwd_bwd():
                fwd_bwd(attention_fn)

            def plain_fwd_bwd():
                fwd_bwd(attention_ref)

            torch.use_deterministic_algorithms(False)
            library_ms = device_ms(sdpa, reps=10, rounds=7)
            library_fb_ms = eager_ms(sdpa_fwd_bwd, reps=5, rounds=5)
            torch.use_deterministic_algorithms(True)
            row = {"shape": list(shape), "dtype": str(dt)[6:],
                   "route": route,
                   "fwd_ms": device_ms(lambda: block_attention(q, k, v),
                                       reps=10, rounds=7),
                   "bwd_ms": device_ms(lambda: attention_backward(
                       q, k, v, do), reps=5, rounds=5),
                   "fwd_bwd_ms": eager_ms(fn_fwd_bwd, reps=5, rounds=5),
                   "plain_ms": device_ms(lambda: attention_ref(q, k, v),
                                         reps=5, rounds=5),
                   "plain_fwd_bwd_ms": eager_ms(plain_fwd_bwd, reps=5,
                                                rounds=5),
                   "library_ms": library_ms,
                   "library_fwd_bwd_ms": library_fb_ms,
                   "bound_ms": bound["fwd"][0], "bound_by": bound["fwd"][1],
                   "bwd_bound_ms": bound["bwd"][0],
                   "bwd_bound_by": bound["bwd"][1],
                   "max_abs_err": errs[0], "grad_max_abs_err": max(errs[1:])}
            rows[key] = row
            print(f"  {key} {tuple(shape)} [{route}]: out |diff| "
                  f"{errs[0]:.3e}, grads |diff| {max(errs[1:]):.3e} (tol "
                  f"{tol[dt]}); forward {row['fwd_ms']:.6f} ms (bound "
                  f"{row['bound_ms']:.6f}, {row['bound_by']}; SDPA "
                  f"{library_ms:.6f}; plain {row['plain_ms']:.6f}); "
                  f"backward {row['bwd_ms']:.6f} ms (bound "
                  f"{row['bwd_bound_ms']:.6f}, {row['bwd_bound_by']}); "
                  f"forward + backward {row['fwd_bwd_ms']:.6f} ms (SDPA "
                  f"{library_fb_ms:.6f}; plain "
                  f"{row['plain_fwd_bwd_ms']:.6f})")
    return {"rows": rows, "max_abs_err": err}


def lm_train_cfg(**split):
    from repro_torch.configs import get_config
    return get_config(LM).replace(n_layers=LM_TRAIN_LAYERS).with_split(
        cut_layer=LM_TRAIN_CUT, **split)


def lm_train_session(cfg, toks, params=None, device="cuda", seed=0):
    from repro_torch.federation import VerticalSession, sequence_parties
    s = VerticalSession(*sequence_parties(toks, cfg.split.n_owners),
                        device=device)
    s.resolve(group="modp512")
    return s.build(cfg, seed=seed, params=params)


def owner_clipped_oracle(session, steps, batch_size):
    """The per-owner-clipped joint oracle of a split LM fit: per step one
    autograd pass through the adapter's ``loss_fn`` at the joint params
    (the joint fit's gradients), then the heads' rule on each owner's
    ``owner_param_slice`` apart, stacked back, and the trunk's rule; the
    fit's batches (the session's index stream at its seed, no rows held
    out).  Leaves the result in ``session.params``; returns the loss
    trail."""
    import numpy as np
    import torch
    from repro_torch.core.splitnn import _leaf, grads_of
    from repro_torch.tree import tree_map
    ad = session.adapter
    P = len(session.owners)
    n = len(session.scientist.ids)
    n_train = n - int(n * LM_TRAIN_EVAL)
    session._train_idx = np.arange(n_train)
    stream = session._index_stream(np.random.default_rng(session.seed),
                                   n_train, batch_size, None, steps)
    oopt, oupd = ad.owner_update_rule()
    topt, tupd = ad.trunk_update_rule()
    slices = [ad.owner_param_slice(session.params, p) for p in range(P)]
    ostates = [oopt.init(x) for x in slices]
    tp = session.params["trunk"]
    ts = topt.init(tp)
    session.params = None
    losses = []
    for t in range(steps):
        batch = ad.make_batch(session._owner_arrays(),
                              session.scientist.labels, next(stream),
                              device=session.device)
        with torch.enable_grad():
            leaves = tree_map(_leaf, {
                "heads": ad.stack_head_params(slices), "trunk": tp})
            obj, metrics = ad.loss_fn(leaves, batch)
            grads = grads_of(obj, leaves)
        del leaves, obj
        for p in range(P):
            slices[p], ostates[p] = oupd(slices[p], ostates[p],
                                         ad.owner_param_slice(grads, p), t)
        tp, ts = tupd(tp, ts, grads["trunk"], t)
        del grads
        losses.append(metrics["loss"].item())
    del ostates, ts
    session.params = {"heads": ad.stack_head_params(slices), "trunk": tp}
    return losses


def step_clock(session):
    """Per-step wall times of the session's next fit (a device sync at
    each step's end), read from its bookkeeping hook."""
    import torch
    marks = []
    inner = session._after_step

    def after(t, *a, **kw):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return inner(t, *a, **kw)

    session._after_step = after
    return marks


def lm_train_need(cfg, mode, steps, evaluations, int8=False):
    """Exact launches of one fit, and the calls of the scan's backward:
    each unit of the block pattern runs the tc attention kernel once per
    attention block and the chunked scan once per ``mamba2`` block, in
    every forward — per joint step the heads' and the trunk's; per split
    step (and once in the warmup) each owner's forward and its
    backward's recompute, and the trunk's cut-gradient and
    weight-gradient passes — plus one forward per evaluation; with
    ``cfg.remat`` each unit a backward pass goes through runs its
    forward once more, in that backward (the checkpoint's recompute;
    the owners' first forward and the evaluations record no autograd and
    are not checkpointed); the int8 codec on every cut and cut gradient,
    the warmup's included.  The scan's backward runs once per ``mamba2``
    block of every unit a backward pass goes through: per joint step
    the heads' and the trunk's, per split step (and in the warmup) each
    owner's head and the trunk's two passes."""
    from repro_torch.models.model import SplitModel
    model = SplitModel(cfg)
    P, head, trunk = (cfg.split.n_owners, model.n_head_units,
                      model.n_trunk_units)
    from repro_torch.models.transformer import ATTENTION
    n_scan = sum(k == "mamba2" for k in cfg.block_pattern)
    n_attn = sum(k in ATTENTION for k in cfg.block_pattern)
    fwd = P * head + trunk
    if mode == "joint":
        back = steps * fwd
        units = steps * fwd + cfg.remat * back
    else:
        back = (steps + 1) * (P * head + 2 * trunk)
        units = (steps + 1) * (2 * P * head + 2 * trunk) + cfg.remat * back
    units += evaluations * fwd
    tc, scans = units * n_attn, units * n_scan
    need = {"block_attention": tc, "block_attention.tc": tc,
            "block_attention.fma": 0, "block_attention.decode": 0,
            "mamba2_scan": scans, "mamba2_scan.chunked": scans,
            "mamba2_scan.serial": 0}
    need["quantize_pack_int8"] = 2 * P * (steps + 1) if int8 else 0
    return need, back * n_scan


class ScanBackwardClock:
    """Counts the SSD scan's backward calls (``mamba2_scan.autograd.
    ssd_backward``, plain products, no kernel launch of its own) while
    it is entered, and brackets each with CUDA events on the calling
    thread's stream: ``ms()`` sums their spans (the device time from
    the backward's first operation to its last, gaps included)."""

    def __init__(self):
        from repro_torch.kernels.mamba2_scan import autograd
        self.module, self.inner, self.events = autograd, None, []

    def __enter__(self):
        import torch
        inner = self.inner = self.module.ssd_backward

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            return out

        self.module.ssd_backward = timed
        return self

    def __exit__(self, *exc):
        self.module.ssd_backward = self.inner

    @property
    def calls(self):
        return len(self.events)

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def lm_train_fit(cfg, toks, p0, name, steps=None, **kw):
    """One fit of phase 20(b) (10 steps, or ``steps``) from the host
    params ``p0``, with its counts (reset just before, read just after),
    step times, loss trail, evaluation and wire bytes; the session is
    returned for the caller to compare and free."""
    import torch
    steps = steps or LM_TRAIN_STEPS
    s = lm_train_session(cfg, toks, p0)
    marks = step_clock(s)
    reset_counts()
    t0 = time.perf_counter()
    with ScanBackwardClock() as clock:
        h = s.fit(steps=steps, batch_size=LM_TRAIN_BATCH,
                  eval_frac=LM_TRAIN_EVAL, verbose=False, **kw)
        ev = s.evaluate(batch_size=LM_TRAIN_BATCH)
    counts = read_counts()
    wall = time.perf_counter() - t0
    del s._after_step            # the hook: a cycle that would keep s
    split = kw.get("mode") == "split"
    need, back = lm_train_need(cfg, "split" if split else "joint",
                               steps, 2,
                               int8=kw.get("compression") == "int8")
    check_counts(counts, need, name)
    if clock.calls != back:
        raise AssertionError(f"{name}: the scan's backward ran "
                             f"{clock.calls} times, not {back}")
    trail = h["loss_trail"]
    if len(trail) != steps or not all(map(math.isfinite, trail)):
        raise AssertionError(f"{name}: bad loss trail {trail}")
    if not trail[-1] < trail[0]:
        raise AssertionError(f"{name}: step {steps - 1}'s loss {trail[-1]}"
                             f" is not below step 0's {trail[0]}")
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    out = {"loss_trail": trail, "eval": ev, "counts": counts,
           "wall_s": wall, "steady_step_ms": sorted(steps_ms)[
               len(steps_ms) // 2],
           "step_ms": steps_ms, "peak_gb": torch.cuda.max_memory_allocated()
           / 1e9}
    if back:
        # the backward's spans per step (the split warmup's included)
        per_step = clock.ms() / (steps + split)
        out.update(scan_backward_calls=back, scan_backward_ms_per_step=
                   per_step, scan_backward_share=per_step
                   / out["steady_step_ms"])
    if split:
        ts = s.transport_stats
        out["transport_steady_step_ms"] = ts["steady_step_ms"]
        out["per_owner"] = ts["per_owner"]
    print(f"  {name}: loss {trail[0]:.4f} -> {trail[-1]:.4f}; eval "
          f"{ev['loss']:.4f}; steady step {out['steady_step_ms']:.3f} ms "
          f"(median of steps 1-{steps - 1} between device syncs"
          + (f"; transport's {out['transport_steady_step_ms']:.3f}"
             if split else "") + f"); wall {wall:.2f} s; peak "
          f"{out['peak_gb']:.2f} GB")
    if back:
        print(f"    the scan's backward: {back} calls (exactly as derived), "
              f"{out['scan_backward_ms_per_step']:.3f} ms a step (CUDA "
              f"event spans) = {out['scan_backward_share']:.4f} of the "
              "steady step")
    return s, out


def free_card():
    """Collect what the last run left (sessions hold cycles through
    their threads' closures) and return the cached blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def profile_lm_steps(cfg, toks, p0, steps=3):
    """``steps`` more joint steps under torch.profiler: the device's busy
    share of their wall time and the kernels that fill it, by family
    (the f32 LM head's and the bf16 GEMMs, attention, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = lm_train_session(cfg, toks, p0)
    s.fit(steps=1, batch_size=LM_TRAIN_BATCH, verbose=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            ScanBackwardClock() as clock:
        t0 = time.perf_counter()
        s.fit(steps=steps, batch_size=LM_TRAIN_BATCH, verbose=False)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    del s
    t = time.perf_counter()
    kernels, top, _ = read_profile(prof)
    busy = sum(us for _, us in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    out = {"steps": steps, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "busy_share": busy / wall_us, "top_level_aten_ops": top,
           "top_kernels": [[n[:90], c, us / 1e3] for n, (c, us) in
                           ranked[:12]], "read_s": time.perf_counter() - t}
    print(f"  joint, {steps} steps profiled: wall {out['wall_ms']:.1f} ms, "
          f"device busy {out['busy_ms']:.1f} ms (share "
          f"{out['busy_share']:.3f}), {top} top-level aten ops; read in "
          f"{out['read_s']:.2f} s; top kernels (calls, ms):")
    for n, c, ms in out["top_kernels"]:
        print(f"    {ms:10.3f} ms {c:6d}x  {n}")
    if clock.calls:
        out["scan_backward"] = {"calls": clock.calls, "ms": clock.ms()}
        out["scan_backward"]["share_of_wall"] = \
            out["scan_backward"]["ms"] / out["wall_ms"]
        print(f"    the scan's backward in these steps: {clock.calls} "
              f"calls, {out['scan_backward']['ms']:.1f} ms of CUDA event "
              f"spans = {out['scan_backward']['share_of_wall']:.4f} of the "
              "profiled wall")
    return out


def phase_lm_train(bw, f32_flops):
    """Phase 20: LM training at full width (the dense family)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_dataset
    out = {}
    free_card()                  # what earlier phases left cached
    t = time.time()
    print("  (a) the attention Function at the training shapes")
    out["attention"] = lm_attention_function(bw, f32_flops)
    out["attention_s"] = time.time() - t

    t = time.time()
    cfg = lm_train_cfg()
    print(f"  (b) {LM} at full width: {LM_TRAIN_LAYERS} layers cut after "
          f"{LM_TRAIN_CUT}, ", end="")
    lm_train_full(cfg, out)
    out["full_width_s"] = time.time() - t

    t = time.time()
    launcher = start_train_launcher([])      # (d), beside (c)
    print("  (c) reduced llama, bf16: owners in spawned workers == the "
          "queue, bitwise")
    small = get_config(LM, reduced=True).replace(n_layers=3).with_split(
        cut_layer=1)
    lm_process_equals_queue(small, make_token_dataset(16, 64, small.vocab,
                                                      0))
    out["process_s"] = time.time() - t

    t = time.time()
    print("  (d) python -m repro_torch.launch.train --reduced --steps 3 "
          "(started beside (c))")
    out["launcher_loss"] = finish_train_launcher(launcher)
    out["launcher_s"] = time.time() - t
    return out


def lm_train_full(cfg, out):
    """Phase 20(b) and 21(b) on ``cfg`` at full width: params from seed
    0, 64 documents of 256 tokens through PSI, then the joint fit (and
    three joint steps profiled), the per-owner-clipped oracle, the split
    lossless fit (== the oracle, bitwise) and the split int8 fit, each
    with its exact counts (``lm_train_fit``); the int8 fit's step-0 gap
    to lossless and the wire bytes per owner per step against the
    frames.  Fills ``out``."""
    import torch
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_leaves, tree_map
    toks = make_token_dataset(LM_TRAIN_DOCS, LM_TRAIN_SEQ, cfg.vocab, 0)
    first = lm_train_session(cfg, toks)
    p0 = tree_map(lambda x: x.cpu(), first.params)
    del first
    n_params = sum(x.numel() for x in tree_leaves(p0))
    print(f"{n_params / 1e9:.3f} G params ({n_params}, seed 0), "
          f"{LM_TRAIN_DOCS} documents of {LM_TRAIN_SEQ}, {LM_TRAIN_STEPS} "
          f"Adam steps of {LM_TRAIN_BATCH}")
    out["n_params"] = n_params
    runs = {}
    free_card()
    s, runs["joint"] = lm_train_fit(cfg, toks, p0, "joint")
    del s
    free_card()
    out["joint_profile"] = profile_lm_steps(cfg, toks, p0)
    free_card()
    o = lm_train_session(cfg, toks, p0)
    oracle_trail = owner_clipped_oracle(o, LM_TRAIN_STEPS, LM_TRAIN_BATCH)
    oracle = [x.cpu() for x in tree_leaves(o.params)]
    del o
    free_card()
    s, runs["split"] = lm_train_fit(cfg, toks, p0, "split lossless, queue",
                                    mode="split")
    got = tree_leaves(s.params)
    same = runs["split"]["loss_trail"] == oracle_trail and all(
        torch.equal(a.cpu(), b) for a, b in zip(got, oracle))
    if not same:
        raise AssertionError("split lossless != the per-owner-clipped "
                             "joint oracle")
    print("    split lossless == the per-owner-clipped joint oracle: "
          "params and loss trail bitwise equal")
    del s, got, oracle
    free_card()
    s, runs["int8"] = lm_train_fit(cfg, toks, p0, "split int8, queue",
                                   mode="split", compression="int8")
    del s
    free_card()
    # step 0 runs on equal params, so its loss gap is the codec's own;
    # later steps part further (Adam on int8-coded cut gradients), and
    # are printed, not held to a limit
    gaps = [abs(a - b) / abs(b) for a, b in zip(
        runs["int8"]["loss_trail"], runs["split"]["loss_trail"])]
    print(f"    int8 vs lossless loss, relative gap per step: "
          f"{[float(f'{g:.3e}') for g in gaps]} (step 0 limit 2e-2)")
    if gaps[0] > 2e-2:
        raise AssertionError("int8 split training's step 0 parts from "
                             "lossless")
    out["int8_gap"] = gaps
    rows = LM_TRAIN_BATCH * LM_TRAIN_SEQ // cfg.split.n_owners
    wire = {"split": (rows * cfg.d_model * 2 + 4, rows * cfg.d_model * 2),
            "int8": (rows * (cfg.d_model + 4) + 4, rows * (cfg.d_model + 4))}
    for name, (fwd, bwd) in wire.items():
        for owner, o in runs[name]["per_owner"].items():
            if (o["cut_payload_bytes"] != fwd * LM_TRAIN_STEPS
                    or o["grad_payload_bytes"] != bwd * LM_TRAIN_STEPS):
                raise AssertionError(
                    f"{name} {owner}: {o['cut_payload_bytes']} / "
                    f"{o['grad_payload_bytes']} bytes, want {fwd} / {bwd} "
                    "per step")
        print(f"    {name}: {fwd} forward and {bwd} backward bytes per "
              "owner per step, as the frames give")
    out["wire_per_owner_step"] = wire
    out["runs"] = {k: {kk: vv for kk, vv in v.items() if kk != "counts"}
                   for k, v in runs.items()}
    out["counts"] = {k: v["counts"] for k, v in runs.items()}
    out["oracle_trail"] = oracle_trail


def lm_process_equals_queue(small, stoks):
    """Phase 20(c) and 21(c): the int8 split fit of ``small`` (bf16, 3
    steps of 4) with owners in spawned workers == the queue, bitwise."""
    import torch
    from repro_torch.tree import tree_leaves, tree_map
    sp0 = tree_map(lambda x: x.cpu(),
                   lm_train_session(small, stoks).params)
    res = {}
    for backend in ("queue", "process"):
        ss = lm_train_session(small, stoks, sp0)
        hh = ss.fit(steps=3, batch_size=4, verbose=False, mode="split",
                    backend=backend, compression="int8")
        res[backend] = (hh["loss_trail"], [x.cpu() for x in
                                           tree_leaves(ss.params)])
    if res["process"][0] != res["queue"][0] or not all(
            torch.equal(a, b) for a, b in zip(res["process"][1],
                                              res["queue"][1])):
        raise AssertionError("LM process backend != queue backend")
    print(f"    int8, 3 steps: process == queue bitwise, trail "
          f"{[round(x, 5) for x in res['queue'][0]]}")


def start_train_launcher(args):
    """``python -m repro_torch.launch.train --reduced --steps 3
    --log-every 1`` plus ``args``, started on the card in the background:
    most of its ~20 s is a fresh process's start-up, which overlaps the
    (c) check it runs beside."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--reduced", "--steps", "3", "--log-every", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def finish_train_launcher(proc):
    """Wait for :func:`start_train_launcher`'s run: its lines, a finite
    final loss (returned)."""
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    print("\n".join(f"    {ln}" for ln in stdout.strip().splitlines()))
    if proc.returncode != 0:
        raise AssertionError(f"launch.train failed: {stderr[-2000:]}")
    last = stdout.strip().splitlines()[-1]
    loss = float(last.split("loss=")[1].split()[0])
    if not math.isfinite(loss):
        raise AssertionError(f"launch.train loss {loss}")
    return loss


# ---------------------------------------------------------------------------
# Phase 21: LM training at full width (the SSM family: zamba2-2.7b)
# ---------------------------------------------------------------------------

# (a): the scan Function at zamba2-2.7b's training shapes, batch 8 (80
# heads of 64, one group of 64 states, chunks of 256): the trunk's scan
# over the combined 256 tokens, a head's over its 128
SCAN_TRAIN = {"trunk": (8, 256, 80, 64, 1, 64, 256),
              "head": (8, 128, 80, 64, 1, 64, 256)}
# (b): zamba2-2.7b at full width cut in depth to 12 layers (2 units of 5
# mamba2 + 1 shared_attn; 18 until the dry-run's phase 26 took the
# seconds), the config's cut after 2 units clipped to 1: one head unit
# per owner, one trunk unit; phase 20's documents, batch and steps
ZAMBA_TRAIN_LAYERS = 12


def scan_train_bound(case, dtype, bw, f32_flops):
    """The least time of the scan's backward at a training shape: x, B,
    C, dy (``dtype``), dt and A (f32) read once, dx, dB, dC (``dtype``),
    ddt and dA (f32) written once; the operations of its products over
    the live (i, j <= i) pairs of each chunk — the scores C·B and dy·x
    (N + P), dx (P) and dB, dC (2 N): 2 (3 N + 2 P) a pair — and the
    six (N, P) products a position (the states recomputed, the
    inter-chunk term's dC, dcum and dS, the states' dx and dB)."""
    import torch
    B, S, H, P, G, N, chunk = case
    L = min(chunk, S)
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = (elt * (3 * B * S * H * P + 4 * B * S * G * N)
              + 2 * 4 * (B * S * H + H))
    flops = 0
    for c0 in range(0, S, L):
        live = min(L, S - c0)
        flops += (2 * (live * (live + 1) // 2) * (3 * N + 2 * P)
                  + 12 * live * N * P)
    flops *= B * H
    peak = BF16_FLOPS if dtype == torch.bfloat16 else f32_flops
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / peak
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), flops, nbytes


def elementwise_ratio(got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 within the
    kernel tolerance (atol and rtol ``tol``), in f64."""
    w = want.double()
    return ((got.double() - w).abs() / (tol + tol * w.abs())).max().item()


def scan_function(bw, f32_flops):
    """21(a): the scan Function (the kernel forward, a backward of plain
    products) at the training shapes, bf16 (route chunked) and f32
    (route serial), x, B and C strided views of one conv_out buffer as
    the Mamba2 block hands them over: the forward against the plain
    ``ssd_chunked`` and each gradient against autograd through the plain
    stages (``ssd_chunk_parallel`` on f32 copies of the same values, the
    cotangent rounded as y's dtype rounds it), elementwise within 2e-2 /
    2e-4 (atol + rtol).  In f32 both gradients are also held against an
    f64 witness (the plain stages in f64 on the same values) and their
    ratios to the limit printed: information, not a check (ddt parts
    from it past the limit in either f32 evaluation).  Times of the
    kernel forward, the backward, the Function's and the plain version's
    forward + backward, and the backward's bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2_scan import (mamba2_scan, route_of,
                                                 ssd_backward,
                                                 ssd_chunk_parallel,
                                                 ssd_chunked, ssd_fn)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    want_route = {torch.float32: "serial", torch.bfloat16: "chunked"}
    parts = ("y", "dx", "ddt", "dA", "dB", "dC")
    rows, err = {}, {"fwd": {}, "bwd": {}}
    for name, case in SCAN_TRAIN.items():
        B, S, H, P, G, N, chunk = case
        x, dt, A, Bi, Ci = scan_inputs(B, S, H, P, G, N)
        dy_np = np.random.default_rng(2).normal(
            size=(B, S, H, P)).astype(np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            xv, bv, cv = conv_out_views(x, Bi, Ci, dtype)
            dtt, At = (torch.from_numpy(a).cuda() for a in (dt, A))
            dy = torch.from_numpy(dy_np).to("cuda", dtype)
            ins = (xv, dtt, At, bv, cv)
            route = route_of(xv, bv, cv)
            if route != want_route[dtype]:
                raise AssertionError(f"scan Function {name} {dtype}: route "
                                     f"{route}, not {want_route[dtype]}")

            def fwd_bwd(fn, args, cot):
                leaves = [t.detach().requires_grad_() for t in args]
                y, _ = fn(*leaves)
                y.backward(cot)
                return (y.detach(),) + tuple(t.grad for t in leaves)

            def function(*t):
                return ssd_fn(*t, chunk=chunk)

            def plain(*t):
                return ssd_chunk_parallel(*t, chunk)

            got = fwd_bwd(function, ins, dy)
            want = ((ssd_chunked(*ins, chunk)[0],)
                    + fwd_bwd(plain, [t.float() for t in ins],
                              dy.float())[1:])
            witness = (fwd_bwd(plain, [t.double() for t in ins],
                               dy.double()) if dtype == torch.float32
                       else None)
            torch.cuda.synchronize()
            t_ = tol[dtype]
            errs, ratios, f64, bad = [], {}, {}, []
            for i, (part, g, w) in enumerate(zip(parts, got, want)):
                ratios[part] = elementwise_ratio(g, w, t_)
                if witness is not None and part != "y":
                    f64[part] = (elementwise_ratio(g, witness[i], t_),
                                 elementwise_ratio(w, witness[i], t_))
                if ratios[part] > 1.0 or not bool(torch.isfinite(g).all()):
                    bad.append(part)
                errs.append((g.float() - w.float()).abs().max().item())
            key = f"{name}:{str(dtype)[6:]}"
            shown = {p: round(r, 3) for p, r in ratios.items()}
            witnessed = {p: (round(a, 3), round(b, 3))
                         for p, (a, b) in f64.items()}
            print(f"  {key} {tuple(case)} [{route}]: |diff| / (tol + tol "
                  f"|plain|) (tol {t_}) {shown}"
                  + (f"; against the f64 witness (the Function's, the "
                     f"plain f32's) {witnessed}" if f64 else ""))
            if bad:
                raise AssertionError(
                    f"scan Function {name} {dtype}: {bad} beyond the "
                    f"limit (tol {t_})")
            err["fwd"][key], err["bwd"][key] = errs[0], max(errs[1:])
            bound, by, flops, nbytes = scan_train_bound(case, dtype, bw,
                                                        f32_flops)
            fbound = scan_bound(case, dtype, bw, f32_flops, False)
            row = {"shape": list(case), "dtype": str(dtype)[6:],
                   "route": route,
                   "fwd_ms": device_ms(lambda: mamba2_scan(
                       *ins, chunk=chunk), reps=10, rounds=7),
                   "bwd_ms": device_ms(lambda: ssd_backward(
                       *ins, dy, chunk=chunk), reps=5, rounds=5),
                   "fwd_bwd_ms": eager_ms(lambda: fwd_bwd(
                       function, ins, dy), reps=5, rounds=5),
                   "plain_ms": device_ms(lambda: ssd_chunked(
                       *ins, chunk), reps=3, rounds=5),
                   "plain_fwd_bwd_ms": eager_ms(lambda: fwd_bwd(
                       plain, ins, dy), reps=3, rounds=5),
                   "library_ms": None,
                   "bound_ms": fbound[0], "bound_by": fbound[1],
                   "bwd_bound_ms": bound, "bwd_bound_by": by,
                   "bwd_flops": flops, "bwd_bytes": nbytes,
                   "max_abs_err": errs[0], "grad_max_abs_err":
                   max(errs[1:]), "elementwise_ratio": ratios,
                   "f64_witness_ratio": f64}
            rows[key] = row
            print(f"    y |diff| {errs[0]:.3e}, grads |diff| "
                  f"{max(errs[1:]):.3e}; forward {row['fwd_ms']:.6f} ms "
                  f"(bound {row['bound_ms']:.6f}, {row['bound_by']}; plain "
                  f"{row['plain_ms']:.6f}); backward {row['bwd_ms']:.6f} ms "
                  f"(bound {bound:.6f}, {by}: {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.3f} MB); forward + backward "
                  f"{row['fwd_bwd_ms']:.6f} ms (plain "
                  f"{row['plain_fwd_bwd_ms']:.6f})")
            del ins, xv, bv, cv, dy, got, want, witness
    return {"rows": rows, "max_abs_err": err}


def zamba_train_cfg():
    from repro_torch.configs import get_config
    return get_config(ZAMBA).replace(n_layers=ZAMBA_TRAIN_LAYERS)


def zamba_card_vs_cpu(small):
    """21(c), f32: the reduced config's 3-step joint fit on the card
    (every scan on the serial route, counted) within rel 1e-4 of the
    same fit on the CPU."""
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_map
    cfg = small.replace(compute_dtype="float32")
    toks = make_token_dataset(16, 72, cfg.vocab, 0)
    cpu = lm_train_session(cfg, toks, device="cpu")
    p0 = tree_map(lambda x: x.clone(), cpu.params)
    want = cpu.fit(steps=3, batch_size=4, verbose=False)["loss_trail"]
    card = lm_train_session(cfg, toks, p0)
    reset_counts()
    got = card.fit(steps=3, batch_size=4, verbose=False)["loss_trail"]
    counts = read_counts()
    need, _ = lm_train_need(cfg, "joint", 3, 0)
    need = {"mamba2_scan": need["mamba2_scan"], "mamba2_scan.chunked": 0,
            "mamba2_scan.serial": need["mamba2_scan"]}
    check_counts(counts, need, "the f32 joint fit")
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"    f32 joint fit, 3 steps, every scan on the serial route: "
          f"card vs CPU loss trail rel {gap:.3e} (limit 1e-4)")
    if gap > 1e-4:
        raise AssertionError("zamba2 f32 joint fit: card and CPU disagree")
    return {"rel_gap": gap, "route": "serial", "trail": got}


def phase_zamba_train(bw, f32_flops):
    """Phase 21: LM training at full width on the SSM family
    (zamba2-2.7b)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_dataset
    out = {}
    free_card()
    t = time.time()
    print("  (a) the scan Function at the training shapes")
    out["scan"] = scan_function(bw, f32_flops)
    out["scan_s"] = time.time() - t

    t = time.time()
    cfg = zamba_train_cfg()
    print(f"  (b) {ZAMBA} at full width: {ZAMBA_TRAIN_LAYERS} layers "
          f"({cfg.n_superblocks} units of 5 mamba2 + 1 shared_attn) cut "
          f"after {cfg.split.cut_layer} units, ", end="")
    lm_train_full(cfg, out)
    out["full_width_s"] = time.time() - t

    t = time.time()
    launcher = start_train_launcher(["--arch", ZAMBA])    # (d), beside (c)
    print("  (c) reduced zamba2, bf16: owners in spawned workers == the "
          "queue, bitwise")
    small = get_config(ZAMBA, reduced=True).replace(
        n_layers=12).with_split(cut_layer=1)
    lm_process_equals_queue(small, make_token_dataset(16, 64, small.vocab,
                                                      0))
    out["process_s"] = time.time() - t
    out["card_vs_cpu"] = zamba_card_vs_cpu(small)

    t = time.time()
    print(f"  (d) python -m repro_torch.launch.train --arch {ZAMBA} "
          "--reduced --steps 3 (started beside (c))")
    out["launcher_loss"] = finish_train_launcher(launcher)
    out["launcher_s"] = time.time() - t
    return out


# ---------------------------------------------------------------------------
# Phase 22: KV cache variants on gemma2-9b (ring caches, swa_override, fp8)
# ---------------------------------------------------------------------------

GEMMA = "gemma2-9b"
# (b): gemma2-9b at full widths cut to 4 layers (2 units of a local and a
# global layer, the cut after 1: one head unit per owner, one trunk unit;
# 8 layers until phase 26 took the seconds), one row of 8448 tokens: each
# owner's 4224 and the trunk's 8448 pass the 4096-token window, so the
# ring prefills roll by 128 and 256 and every decode step wraps; 16
# decode steps, teacher-forced
RING_LAYERS, RING_CUT, RING_CTX, RING_STEPS = 4, 1, 8448, 16
# (b)'s limits on each pair's largest logit gap over the prefill and the
# 16 steps, as multiples of the bf16 floor (the bf16 run on full caches
# against the f32 run on full caches, same inputs): two bf16 runs of one
# function part by at most the sum of their roundings (2x the floor);
# an fp8 e4m3 cache rounds keys and values with a unit roundoff of 2^-4,
# 16x bf16's 2^-8
BF16_PAIR_LIMIT, FP8_PAIR_LIMIT = 2.0, 16.0


def kv_bytes(caches):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(caches))


def teacher_forced(model, params, toks, steps, on_step=None, **opts):
    """Prefill ``toks[:, :S]`` (S = its length - ``steps``) on the params'
    device, then ``steps`` decode steps fed the next tokens of ``toks``
    (``opts``: ``cache_init``'s ring, swa_override, cache_dtype; the
    override goes to every program).  ``on_step(t, caches)`` runs after
    the prefill (t = 0) and after each step t.  Returns (last-token
    logits of the prefill and each step (steps + 1, B, vocab) f32, the
    final caches, their bytes)."""
    import numpy as np
    import torch
    from repro_torch.tree import tree_leaves
    dev = tree_leaves(params)[0].device
    ov = opts.get("swa_override") or None
    B, P = toks.shape[0], model.P
    S = toks.shape[1] - steps
    ot = torch.from_numpy(np.ascontiguousarray(
        toks[:, :S].reshape(B, P, S // P).transpose(1, 0, 2))).to(dev)
    nxt = torch.from_numpy(toks[:, S:].astype(np.int32)).to(dev)
    with torch.inference_mode():
        caches = model.cache_init(B, S, n_new=steps + 1, device=dev, **opts)
        nbytes = kv_bytes(caches)
        logits, caches = model.prefill(params, {"owner_tokens": ot}, caches,
                                       swa_override=ov)
        out = [logits.clone()]      # a view of every position's logits
        del logits
        if on_step is not None:
            on_step(0, caches)
        for t in range(steps):
            logits, caches = model.decode_step(
                params, caches, nxt[:, t:t + 1], S + t, S // P + t,
                swa_override=ov)
            out.append(logits)
            if on_step is not None:
                on_step(t + 1, caches)
        out = torch.stack(out).float()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, caches, nbytes


def ring_span(caches, ring_slots, n0, steps):
    """From a run on full caches (its final ``caches``), each KV leaf that
    the ring run trims to W slots (``ring_slots``: the ring run's slot
    count per leaf, by part): positions [n0 - W, n0 + steps), every
    position a ring of W slots holds after the prefill or a step (``n0``:
    the positions the prefill wrote, by part); None where not trimmed."""
    from repro_torch.tree import tree_leaves
    return {part: [None if W == a.shape[-3] else
                   a.narrow(-3, n0[part] - W, W + steps).clone()
                   for a, W in zip(tree_leaves(caches[part]),
                                   ring_slots[part])]
            for part in ("heads", "trunk")}


def ring_checker(span, f32_span, n0, tally):
    """``on_step`` for a ring run: after the prefill and after step t,
    every trimmed leaf slot by slot against ``span`` (the full-cache run
    of the same inputs, ``ring_span``), position p read at slot p mod W.
    Positions the prefill wrote must be equal bitwise (both prefills run
    the same kernel tiles over the same keys); so must the decode
    positions of the head's first unit's local layer, which the token's
    embedding alone feeds.  The decode positions of the other layers
    follow attention over the slots in ring order, not position order,
    so they are held to ``BF16_PAIR_LIMIT`` x the bf16 floor of the same
    positions (the full run against ``f32_span``, the f32 run's on full
    caches with the same options).  A slot
    written or rolled wrong holds another token's key: off by the keys'
    own size."""
    import torch
    from repro_torch.tree import tree_leaves

    def check(t, caches):
        for part in ("heads", "trunk"):
            for i, (a, want, w32) in enumerate(zip(
                    tree_leaves(caches[part]), span[part], f32_span[part])):
                if want is None:
                    continue
                W = a.shape[-3]
                n = n0[part] + t
                held = a.index_select(-3, torch.arange(
                    n - W, n, device=a.device) % W)
                want = want.narrow(-3, t, W)
                pre = W - t            # held positions the prefill wrote
                if not torch.equal(held.narrow(-3, 0, pre),
                                   want.narrow(-3, 0, pre)):
                    raise AssertionError(
                        f"22(b) ring cache {part} leaf {i} after step {t}: "
                        f"a slot the prefill wrote != the full cache's "
                        f"position, bitwise")
                tally["bitwise"] += pre * want[..., 0, :, :].numel()
                if t == 0:
                    continue
                got_d = held.narrow(-3, pre, t).float()
                want_d = want.narrow(-3, pre, t).float()
                if part == "heads" and i < 2:      # b0 (local) k and v
                    if not torch.equal(got_d[:, 0], want_d[:, 0]):
                        raise AssertionError(
                            f"22(b) ring cache: the first local layer's "
                            f"decode slots != the full cache's, bitwise "
                            f"(step {t})")
                gap = (got_d - want_d).abs().max().item()
                floor = (want_d - w32.narrow(-3, W, t).float()
                         ).abs().max().item()
                tally["gap"] = max(tally["gap"], gap / max(floor, 1e-30))
                if not gap <= BF16_PAIR_LIMIT * floor:
                    raise AssertionError(
                        f"22(b) ring cache {part} leaf {i} step {t}: decode "
                        f"slots off the full cache's by {gap:.4e}, past "
                        f"{BF16_PAIR_LIMIT:g} x their bf16 floor "
                        f"{floor:.4e}")
        tally["checks"] += 1
    return check


def ring_rows_equal_scalar(model, params, caches, tok, pos, pos_local):
    """One more decode step on the B = 1 ring ``caches`` doubled to two
    rows at different positions (``pos``, ``pos_local``: one per row;
    ``tok`` (2, 1)) through ``RowPositions``, against a scalar call at
    each row's position on the same two rows: that row's logits and
    caches bitwise.  The per-row call's launches are counted from 0: one
    per-row decode launch for each attention layer, no other attention
    launch.  Returns the count."""
    import torch
    from repro_torch.models.attention import RowPositions
    from repro_torch.tree import tree_leaves, tree_map
    two = tree_map(lambda a: torch.cat([a, a], dim=-4), caches)
    n_attn = ((model.P * model.n_head_units + model.n_trunk_units)
              * len(model.cfg.block_pattern))
    with torch.inference_mode():
        got_c = tree_map(torch.clone, two)
        reset_counts()
        got, got_c = model.decode_step(
            params, got_c, tok, RowPositions(pos, tok.device),
            RowPositions(pos_local, tok.device))
        counts = read_counts()
        for b in range(2):
            c = tree_map(torch.clone, two)
            want, c = model.decode_step(params, c, tok, pos[b], pos_local[b])
            torch.cuda.synchronize()
            same = torch.equal(got[b], want[b]) and all(
                torch.equal(x.select(-4, b), y.select(-4, b))
                for x, y in zip(tree_leaves(got_c), tree_leaves(c)))
            if not same:
                raise AssertionError(
                    f"per-row ring decode row {b} (position {pos[b]}, "
                    f"{pos_local[b]}) != the scalar call, bitwise")
    n = counts["block_attention.per_row"]
    if n != n_attn or counts["block_attention"] != n_attn:
        raise AssertionError(
            f"per-row ring decode: {n} per-row launches of "
            f"{counts['block_attention']} attention launches, needed "
            f"exactly {n_attn} of {n_attn}")
    return n


def ring_caches_in_earnest():
    """22(b): the KV cache variants at full widths past the window."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves
    cfg = get_config(GEMMA).replace(n_layers=RING_LAYERS).with_split(
        cut_layer=RING_CUT)
    model = SplitModel(cfg)
    f32_model = SplitModel(cfg.replace(compute_dtype="float32"))
    t = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    W = cfg.swa_window
    print(f"  (b) {GEMMA} at full widths, {RING_LAYERS} layers ("
          f"{model.n_head_units} head units x {model.P} owners, "
          f"{model.n_trunk_units} trunk unit; {n_params / 1e9:.3f} G "
          f"params, {4 * n_params / 1e9:.2f} GB, {time.time() - t:.2f} s), "
          f"one row of {RING_CTX} tokens (owner slices of "
          f"{RING_CTX // model.P}, window {W}: ring prefills roll by "
          f"{RING_CTX // model.P % W} and {RING_CTX % W}), {RING_STEPS} "
          f"decode steps teacher-forced")
    toks = lm_contexts(cfg.vocab, 1, RING_CTX + RING_STEPS, seed=3)
    fp8 = torch.float8_e4m3fn
    ov = dict(swa_override=W)
    variants = [("f32 full", f32_model, {}), ("full", model, {}),
                ("ring", model, dict(ring=True)),
                ("f32 override", f32_model, ov), ("override", model, ov),
                ("override ring", model, dict(ring=True, **ov)),
                ("fp8 ring", model, dict(ring=True, cache_dtype=fp8))]
    S = RING_CTX
    n0 = {"heads": S // model.P, "trunk": S}    # positions a prefill writes

    def slots_of(opts):
        c = model.cache_init(1, S, n_new=RING_STEPS + 1, device="meta",
                             **opts)
        return {part: [a.shape[-3] for a in tree_leaves(c[part])]
                for part in ("heads", "trunk")}
    trim = {"ring": slots_of(dict(ring=True)),
            "override ring": slots_of(dict(ring=True, **ov))}
    # each ring run checked slot by slot against two full-cache runs
    against = {"ring": ("full", "f32 full"),
               "override ring": ("override", "f32 override")}
    span_for = {f: r for r, fs in against.items() for f in fs}
    spans, tally = {}, {"bitwise": 0, "gap": 0.0, "checks": 0}
    logits, nbytes, out = {}, {}, {"params": n_params, "runs": {}}
    for name, m, opts in variants:
        t = time.time()
        check = (ring_checker(*(spans.pop(f) for f in against[name]), n0,
                              tally) if name in against else None)
        logits[name], caches, nbytes[name] = teacher_forced(
            m, params, toks, RING_STEPS, on_step=check, **opts)
        if name in span_for:
            spans[name] = ring_span(caches, trim[span_for[name]], n0,
                                    RING_STEPS)
        if name == "ring":
            # row 0 continues the sequence (the ring wraps); row 1 sits
            # inside the window (fewer valid slots, another write slot)
            pos = [S + RING_STEPS, W - 96]
            pos_local = [S // m.P + RING_STEPS, W // 2 - 48]
            tok = torch.tensor([[int(toks[0, -1])], [int(toks[0, 0])]],
                               dtype=torch.int32, device="cuda")
            n = ring_rows_equal_scalar(m, params, caches, tok, pos,
                                       pos_local)
            out["per_row_launches"] = n
            print(f"    one more ring decode step, two rows at positions "
                  f"{pos} (owner {pos_local}) through RowPositions == a "
                  f"scalar call at each row's position, logits and caches "
                  f"bitwise; {n} per-row decode launches, counted from 0 "
                  f"(one per attention layer, as needed)")
        del caches, check
        wall = time.time() - t
        out["runs"][name] = {"cache_bytes": nbytes[name], "s": wall}
        print(f"    {name}: KV cache {nbytes[name]} bytes; prefill + "
              f"{RING_STEPS} steps in {wall:.2f} s")
    out["ring_slots"] = tally
    print(f"    ring caches slot by slot against the full caches' positions"
          f" after each prefill and step ({tally['checks']} checks): "
          f"{tally['bitwise']} prefill-written values bitwise equal; the "
          f"decode slots past the embedding-fed layer at most "
          f"{tally['gap']:.3f} x their bf16 floor (limit "
          f"{BF16_PAIR_LIMIT:g} x)")
    floor = (logits["full"] - logits["f32 full"]).abs().max().item()
    out["bf16_floor"] = floor
    print(f"    bf16 floor (full caches, bf16 vs f32 compute): largest "
          f"logit gap {floor:.4e} (logits up to "
          f"{logits['f32 full'].abs().max().item():.3f})")
    for a, b, lim in (("ring", "full", BF16_PAIR_LIMIT),
                      ("override ring", "override", BF16_PAIR_LIMIT),
                      ("fp8 ring", "ring", FP8_PAIR_LIMIT)):
        gap = (logits[a] - logits[b]).abs().max().item()
        out[f"{a} vs {b}"] = {"gap": gap, "limit": lim * floor}
        print(f"    {a} vs {b}: largest logit gap {gap:.4e} = "
              f"{gap / floor:.3f} x the floor (limit {lim:g} x = "
              f"{lim * floor:.4e})")
        if not gap <= lim * floor:
            raise AssertionError(f"22(b) {a} vs {b}: logit gap {gap:.4e} "
                                 f"past {lim:g} x the bf16 floor")
    if not (nbytes["ring"] < nbytes["full"]
            and nbytes["override ring"] < nbytes["override"]
            and 2 * nbytes["fp8 ring"] == nbytes["ring"]):
        raise AssertionError(f"22(b) cache bytes: {nbytes}")
    print(f"    cache bytes: ring {nbytes['ring'] / nbytes['full']:.4f} of "
          f"full, override ring "
          f"{nbytes['override ring'] / nbytes['override']:.4f} of "
          f"override, fp8 ring exactly half of bf16 ring")
    del params
    free_card()
    return out


#: the numerics ``repro_torch.device.configure_cuda`` sets on the card
CONFIGURED = {"allow_tf32": False, "cudnn_allow_tf32": False,
              "float32_matmul_precision": "highest", "deterministic": True,
              "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def numerics_state():
    """The settings a card-vs-CPU check relies on: TF32 and the matmul
    precision, deterministic algorithms, the cuBLAS workspace, and the
    CPU's thread count, vector instruction set and model (printed: CPU
    reductions round by them)."""
    import torch
    model = next((ln.split(":", 1)[1].strip() for ln in Path(
        "/proc/cpuinfo").read_text().splitlines()
        if ln.startswith("model name")), None) \
        if Path("/proc/cpuinfo").exists() else None
    return {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "num_threads": torch.get_num_threads(),
            "CUBLAS_WORKSPACE_CONFIG": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            "cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "cpu_model": model}


def assert_configured(what):
    """Print the numerics state and fail unless it is ``configure_cuda``'s
    (the CPU's thread count is printed, not checked: the check pins
    it)."""
    st = numerics_state()
    bad = {k: st[k] for k, v in CONFIGURED.items() if st[k] != v}
    print(f"  {what}: numerics {st}")
    if bad:
        raise AssertionError(f"{what}: not configure_cuda's numerics: {bad}")
    return st


def gap_at(got, want):
    """The largest |got - want| of (steps + 1, B, vocab) logits, its rel
    to max |want| and where it sits (step, row, logit)."""
    import numpy as np
    d = (got - want).abs()
    step, row, logit = np.unravel_index(int(d.argmax()), tuple(d.shape))
    return {"rel": (d.max() / want.abs().max()).item(),
            "abs": d.max().item(), "step": int(step), "row": int(row),
            "logit": int(logit), "value": want[step, row, logit].item()}


def on_card_and_cpu(run, cpu_params, what):
    """``run(params)`` on the card (the params moved there) and on the
    CPU, under ``configure_cuda``'s numerics (asserted) with the CPU on
    one thread, as the CPU tests pin it: a reduction split across
    threads rounds otherwise, and the thread count is the host's.
    Returns (the card's result, the CPU's, the numerics)."""
    import torch
    from repro_torch.tree import tree_map
    st = assert_configured(what)
    card_params = tree_map(lambda a: a.cuda(), cpu_params)
    got = run(card_params)
    del card_params
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = run(cpu_params)
    finally:
        torch.set_num_threads(n)
    return got, want, st


def card_vs_cpu(model, cpu_params, toks, steps, what,
                forced=teacher_forced, **opts):
    """Teacher-forced logits (the prefill and ``steps`` decode steps,
    ``forced``'s: the text LM's by default) of ``model`` on the card
    against the CPU (``on_card_and_cpu``).  Returns the gap."""
    got, want, st = on_card_and_cpu(
        lambda p: forced(model, p, toks, steps, **opts)[0].cpu(),
        cpu_params, what)
    gap = gap_at(got, want)
    S = toks.shape[1] - steps
    print(f"  {what}: card vs CPU (1 thread) max rel {gap['rel']:.3e} at "
          f"step {gap['step']} (position {S - 1 + gap['step']}), row "
          f"{gap['row']}, logit {gap['logit']} (|diff| {gap['abs']:.3e} on "
          f"{gap['value']:.4f})")
    return {"rel": gap["rel"], "at": gap, "numerics": st}


def gemma_card_vs_cpu():
    """22(c): reduced gemma2 (f32, window 64, 4 layers) on ring caches,
    contexts of 160 (owner slices of 80: every ring wraps), prefill and 5
    teacher-forced steps, card against CPU within rel 1e-4; the engine's
    wave and continuous tokens on the card equal the CPU's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServingEngine
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_map
    cfg = get_config(GEMMA, reduced=True).replace(n_layers=4,
                                                  compute_dtype="float32")
    model = SplitModel(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    card_params = tree_map(lambda a: a.cuda(), cpu_params)
    C, steps = 160, 5
    toks = lm_contexts(cfg.vocab, 2, C + steps, seed=4)
    gap = card_vs_cpu(model, cpu_params, toks, steps, "(c) reduced gemma2",
                      ring=True)
    rel = gap["rel"]
    ctxs = lm_contexts(cfg.vocab, 5, C, seed=5)
    mixed = [2, 6, 1, 5, 3]
    runs = {}
    for dev, p in (("cuda", card_params), ("cpu", cpu_params)):
        for sched in ("wave", "continuous"):
            e = ServingEngine(model, p, batch_slots=2, ctx_len=C,
                              max_new=6, ring_cache=True, scheduler=sched,
                              transport="queue", device=dev)
            rids = [e.submit(c, max_new=m) for c, m in zip(ctxs, mixed)]
            res = e.run()
            runs[dev, sched] = [res[r].generated for r in rids]
    same = len({str(v) for v in runs.values()}) == 1
    print(f"  (c) reduced {GEMMA} (f32, window {cfg.swa_window}, contexts "
          f"of {C}, ring caches): card vs CPU logits over the prefill and "
          f"{steps} steps max rel {rel:.3e} (limit 1e-4); engine tokens "
          f"(wave, continuous) on the card == the CPU's: {same}")
    if rel > 1e-4 or not same:
        raise AssertionError("reduced gemma2: card and CPU disagree")
    return dict(gap, tokens_equal=same)


def phase_gemma():
    """Phase 22: gemma2-9b served at full width and depth on ring caches;
    the cache variants at full widths past the window; reduced gemma2
    card vs CPU."""
    import torch
    from repro_torch.tree import tree_leaves
    out = {}
    free_card()                  # what earlier phases left cached
    print(f"  free before (a): {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated")
    t = time.time()
    a = phase_serving(GEMMA, ring_cache=True)
    model = a.pop("model")
    del a["params"]              # 52 GB: (b) needs the card
    slots = sorted({x.shape[-3] for x in tree_leaves(model.cache_init(
        SLOTS, CTX, n_new=NEW + 1, ring=True, device="meta"))})
    print(f"  every local layer on the ring path: KV caches of {slots} "
          f"slots, none past the {model.cfg.swa_window}-token window")
    if max(slots) > model.cfg.swa_window:
        raise AssertionError("22(a): a local layer off the ring path")
    del model
    free_card()
    out["serving"] = a
    out["serving_s"] = time.time() - t
    t = time.time()
    out["ring"] = ring_caches_in_earnest()
    out["ring_s"] = time.time() - t
    t = time.time()
    out["card_vs_cpu"] = gemma_card_vs_cpu()
    out["card_vs_cpu_s"] = time.time() - t
    return out


# ---------------------------------------------------------------------------
# Phase 23: the xLSTM and MoE families, and the last two dense configs
# ---------------------------------------------------------------------------

XLSTM = "xlstm-125m"
DENSE_BIG = ("llama3-405b", "nemotron-4-15b")
MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x7b")
# (c) and (d) at full width cut in depth: one head unit per owner, one
# trunk unit; (b) and (d)'s fits: this many Adam steps on phase 20's
# batch of 8 x 256, from 9 documents (one held out): random tokens carry
# nothing a model can learn but the rows themselves, so every step
# revisits its one training batch and the loss falls within a few steps
# (on phase 20's 56 rows it falls only once an epoch ends, at step 7)
FAMILY_LAYERS, FAMILY_STEPS = 2, 5
FAMILY_DOCS = LM_TRAIN_BATCH + 1
# (b): xlstm-125m trained at full width, half its 12 layers (3 units of an
# sLSTM and an mLSTM block: one head unit per owner, two trunk units)
XLSTM_TRAIN_LAYERS = 6


def family_train(cfg, name, steps=FAMILY_STEPS):
    """23(b) and (d): ``cfg`` at full width through PSI on
    ``FAMILY_DOCS`` documents of 256 tokens, batches of 8, for ``steps``
    Adam steps: the joint fit, the per-owner-clipped joint oracle and
    the split lossless fit over the queue (== the oracle, params and
    loss trail bitwise), each fit with its exact launch counts and a
    falling loss (``lm_train_fit``)."""
    import torch
    from repro_torch.data import make_token_dataset
    from repro_torch.tree import tree_leaves, tree_map
    toks = make_token_dataset(FAMILY_DOCS, LM_TRAIN_SEQ, cfg.vocab, 0)
    first = lm_train_session(cfg, toks)
    p0 = tree_map(lambda x: x.cpu(), first.params)
    del first
    n_params = sum(x.numel() for x in tree_leaves(p0))
    print(f"    {name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} G params"
          f" (seed 0), {steps} Adam steps of {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ} on {FAMILY_DOCS} documents (one held out)")
    out = {"n_params": n_params, "n_layers": cfg.n_layers}
    free_card()
    s, out["joint"] = lm_train_fit(cfg, toks, p0, f"{name} joint",
                                   steps=steps)
    del s
    free_card()
    o = lm_train_session(cfg, toks, p0)
    trail = owner_clipped_oracle(o, steps, LM_TRAIN_BATCH)
    oracle = [x.cpu() for x in tree_leaves(o.params)]
    del o
    free_card()
    s, out["split"] = lm_train_fit(cfg, toks, p0,
                                   f"{name} split lossless, queue",
                                   steps=steps, mode="split")
    same = out["split"]["loss_trail"] == trail and all(
        torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(s.params),
                                                oracle))
    if not same:
        raise AssertionError(f"{name}: split lossless != the per-owner-"
                             "clipped joint oracle")
    print("      split lossless == the per-owner-clipped joint oracle: "
          "params and loss trail bitwise equal")
    del s, oracle
    free_card()
    out["counts"] = {k: out[k].pop("counts") for k in ("joint", "split")}
    return out


def families_card_vs_cpu():
    """23(e): reduced xlstm-125m (4 layers) and reduced deepseek-moe-16b
    (2 layers) in f32, contexts of 96 (the mLSTM's head chunks ragged),
    prefill and 5 teacher-forced steps, card against CPU within rel 1e-4
    (``card_vs_cpu``: under ``configure_cuda``'s numerics, the CPU on
    one thread)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import SplitModel
    out = {}
    for arch, n_layers in ((XLSTM, 4), (MOE_ARCHS[0], 2)):
        cfg = get_config(arch, reduced=True).replace(
            n_layers=n_layers, compute_dtype="float32")
        model = SplitModel(cfg)
        cpu_params = model.init(torch.Generator().manual_seed(0))
        toks = lm_contexts(cfg.vocab, 2, 96 + 5, seed=6)
        gap = card_vs_cpu(model, cpu_params, toks, 5,
                          f"(e) reduced {arch}")
        if gap["rel"] > 1e-4:
            raise AssertionError(f"reduced {arch}: card and CPU disagree")
        out[arch] = gap
    return out


def phase_families():
    """Phase 23: xlstm-125m served and trained at full width and depth;
    llama3-405b and nemotron-4-15b served at full width, cut depth;
    deepseek-moe-16b and mixtral-8x7b served at full width, cut depth,
    deepseek trained there too; reduced xLSTM and MoE card vs CPU."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    free_card()
    t = time.time()
    print(f"  (a) {XLSTM} at full width and depth (no attention: every "
          "launch is the int8 codec's)")
    a = phase_serving(XLSTM, profile=True)
    del a["model"], a["params"]
    # phase 7's 66: two waves of 2 prefill cuts and 31 decode ticks
    if a["counts"]["block_attention"] or \
            a["counts"]["quantize_pack_int8"] != 2 * (2 + NEW - 1):
        raise AssertionError(f"{XLSTM}: launches {a['counts']}")
    out["xlstm_serving"] = a
    out["xlstm_serving_s"] = time.time() - t
    free_card()
    t = time.time()
    print(f"  (b) {XLSTM} training at full width, {XLSTM_TRAIN_LAYERS} "
          "layers")
    # 2 steps (a falling loss needs two): each was ~3.4 s jointly at 12
    # layers (host-bound: 1536 sequential sLSTM cell steps a forward,
    # their backward too); 3 steps at full depth until phase 26 took the
    # seconds
    out["xlstm_train"] = family_train(get_config(XLSTM).replace(
        n_layers=XLSTM_TRAIN_LAYERS), XLSTM, steps=2)
    out["xlstm_train_s"] = time.time() - t
    for arch in DENSE_BIG + MOE_ARCHS:
        t = time.time()
        part = "(c)" if arch in DENSE_BIG else "(d)"
        print(f"  {part} {arch} at full width, {FAMILY_LAYERS} layers")
        r = phase_serving(arch, n_layers=FAMILY_LAYERS)
        del r["model"], r["params"]
        free_card()
        out[arch] = r
        out[f"{arch}_s"] = time.time() - t
    t = time.time()
    print(f"  (d) {MOE_ARCHS[0]} training at full width, {FAMILY_LAYERS} "
          "layers")
    out["moe_train"] = family_train(get_config(MOE_ARCHS[0]).replace(
        n_layers=FAMILY_LAYERS), MOE_ARCHS[0])
    out["moe_train_s"] = time.time() - t
    t = time.time()
    out["card_vs_cpu"] = families_card_vs_cpu()
    out["card_vs_cpu_s"] = time.time() - t
    free_card()
    print(f"  peak device memory: " + ", ".join(
        f"{k} {out[k]['peak_gb']:.2f} GB" for k in DENSE_BIG + MOE_ARCHS)
        + f"; {XLSTM} {out['xlstm_serving']['peak_gb']:.2f} GB")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the enc-dec and vision families
# ---------------------------------------------------------------------------

WHISPER = "whisper-tiny"
QWEN_VL = "qwen2-vl-72b"
# (a) whisper's 30 s window after its conv stem (the frontend stub): 1500
# frames; its decoder context of 448 tokens; a 64-token prompt and NEW
# greedy tokens for 8 rows.  (b) 224 decoder tokens a row, 5 Adam steps
# on one fixed batch (random tokens teach nothing until a batch is
# revisited).  (c) qwen2-vl at 2 layers (one head unit per owner, one
# trunk unit): 1024 patch embeddings (a 32 x 32 grid; the ViT is a
# stub) and 1024 text tokens for 4 rows
W_SLOTS, W_FRAMES, W_CTX, W_PROMPT = 8, 1500, 448, 64
W_TRAIN_TOKENS, W_TRAIN_STEPS = 224, 5
V_SLOTS, V_PATCHES, V_TOKENS, V_LAYERS = 4, 1024, 1024, 2
# kernel 4 at these paths' calls (B, Sq, Skv, nh, nkv, hd, kind, window,
# softcap, q_offset, kv_len) and the route each takes: the encoder's
# bidir prefill, cross-attention (Sq != Skv, 1500 keys: no tile
# multiple) at prefill, in training and at a decode tick, the decoder's
# self-attention 16 ticks in (a cache of 448 + 32), and qwen2-vl's head
# and trunk prefills (caches of 1024 + 32 and 2048 + 32) and trunk decode
XPATH_CASES = {
    "whisper_encoder": ((8, 1500, 1500, 6, 6, 64, "bidir", 0, 0.0, 0,
                         None), "tc"),
    "whisper_cross_prefill": ((8, 64, 1500, 6, 6, 64, "bidir", 0, 0.0, 0,
                               None), "decode"),
    "whisper_cross_train": ((8, 224, 1500, 6, 6, 64, "bidir", 0, 0.0, 0,
                             None), "tc"),
    "whisper_cross_decode": ((8, 1, 1500, 6, 6, 64, "bidir", 0, 0.0, 0,
                              None), "decode"),
    "whisper_self_decode": ((8, 1, 480, 6, 6, 64, "causal", 0, 0.0, 80,
                             81), "decode"),
    "qwen2vl_head_prefill": ((4, 1024, 1056, 64, 8, 128, "causal", 0, 0.0,
                              0, 1024), "tc"),
    "qwen2vl_trunk_prefill": ((4, 2048, 2080, 64, 8, 128, "causal", 0, 0.0,
                               0, 2048), "tc"),
    "qwen2vl_trunk_decode": ((4, 1, 2080, 64, 8, 128, "causal", 0, 0.0,
                              2064, 2065), "decode"),
}


def check_attention_counts(counts, tc, decode, what):
    """Exactly ``tc`` and ``decode`` attention launches, none on fma."""
    need = {"block_attention": tc + decode, "block_attention.tc": tc,
            "block_attention.decode": decode, "block_attention.fma": 0}
    got = {k: counts[k] for k in need}
    print(f"    {what}: attention launches {got} (needed exactly {need})")
    if got != need:
        raise AssertionError(f"{what}: attention launches {got} != {need}")


def modal_wave(model, params, inputs, prompt, new, pos0, local0):
    """One wave through ``SplitModel``'s own programs (the engine drives
    text archs only): prefill ``inputs`` (the frames or patches) with the
    ``prompt`` tokens, then ``new - 1`` greedy decode steps at global
    position ``pos0 + t`` and local position ``local0 + t``.  Returns
    (prefill s, per-tick s, tokens (B, new), the last logits)."""
    import torch
    enc_dec = model.cfg.enc_dec
    # the decoder's context (whisper's), or the combined sequence
    s_max = W_CTX if enc_dec else inputs.shape[1] + prompt.shape[1]
    with torch.inference_mode():
        caches = model.cache_init(prompt.shape[0], s_max, n_new=NEW,
                                  device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = model.prefill(
            params, {"frames" if enc_dec else "patches": inputs,
                     "tokens": prompt}, caches)
        tok = logits.argmax(-1)[:, None]
        del logits
        torch.cuda.synchronize()
        pre = time.perf_counter() - t
        out, ticks = [tok], []
        for i in range(new - 1):
            t = time.perf_counter()
            logits, caches = model.decode_step(params, caches, tok,
                                               pos0 + i, local0 + i)
            tok = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t)
            out.append(tok)
    return pre, ticks, torch.cat(out, 1), logits


def report_wave(what, pre, ticks, toks, vocab, logits):
    import numpy as np
    import torch
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = pre + sum(ticks)
    res = {"prefill_ms": 1e3 * pre,
           "decode_ms_median": 1e3 * float(np.median(ticks)),
           "decode_ms_max": 1e3 * max(ticks),
           "tok_per_s": toks.numel() / wall, "peak_gb": peak}
    print(f"    {what}: prefill {res['prefill_ms']:.3f} ms; decode ms per "
          f"tick (median of {len(ticks)}) {res['decode_ms_median']:.3f}, "
          f"max {res['decode_ms_max']:.3f}; {res['tok_per_s']:.2f} tok/s; "
          f"peak device memory {peak:.2f} GB; row 0 -> "
          f"{toks[0, :12].tolist()}...")
    if not (bool(((toks >= 0) & (toks < vocab)).all())
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{what}: tokens out of range or logits not "
                             "finite")
    return res


def whisper_serving():
    """24(a): whisper-tiny at full width and depth: prefill (the encoder
    over 1500 frames, the decoder over the prompt), NEW - 1 decode ticks
    (the decoder alone, cross-attending the stashed encoder output),
    exact launches by route; then, in f32 at full size, a decode step's
    logits against ``forward`` over the same tokens within 2e-3."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import block_attention as attn
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves
    cfg = get_config(WHISPER)
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  (a) {WHISPER}: {n_params / 1e9:.4f} G params (f32, "
          f"{4 * n_params / 1e9:.3f} GB), {model.n_head_units} encoder + "
          f"{model.n_trunk_units} decoder layers, d {cfg.d_model}; "
          f"{W_SLOTS} rows x {W_FRAMES} frames of {cfg.d_frontend}, a "
          f"{W_PROMPT}-token prompt, {NEW} new tokens, context {W_CTX}")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.normal(size=(
        W_SLOTS, W_FRAMES, cfg.d_frontend)).astype(np.float32)).cuda()
    toks = torch.from_numpy(lm_contexts(cfg.vocab, W_SLOTS, W_PROMPT + 1,
                                        seed=1).astype(np.int64)).cuda()
    prompt = toks[:, :W_PROMPT]
    modal_wave(model, params, frames, prompt, 2, W_PROMPT, 0)     # warm
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pre, ticks, out, logits = modal_wave(model, params, frames, prompt,
                                         NEW, W_PROMPT, 0)
    counts = dict(attn.launch_counts)
    res = report_wave(WHISPER, pre, ticks, out, cfg.vocab, logits)
    # the encoder's layers once (tc: 1500 rows); per decoder layer, self-
    # and cross-attention at the prefill (64 rows: decode) and at every
    # tick
    n_enc, n_dec = model.P * model.n_head_units, model.n_trunk_units
    check_attention_counts(counts, n_enc, 2 * n_dec * NEW, WHISPER)
    res["counts"] = counts
    f32 = SplitModel(cfg.replace(compute_dtype="float32"))
    with torch.inference_mode():
        want = f32.forward(params, {"frames": frames, "tokens": toks})[0][
            :, -1]
        caches = f32.cache_init(W_SLOTS, W_CTX, n_new=NEW, device="cuda")
        _, caches = f32.prefill(params, {"frames": frames,
                                         "tokens": prompt}, caches)
        got, _ = f32.decode_step(params, caches, toks[:, -1:], W_PROMPT, 0)
        torch.cuda.synchronize()
    gap = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, atol=2e-3, rtol=2e-3))
    print(f"    f32 at full size: decode_step's logits at position "
          f"{W_PROMPT} vs forward over {W_PROMPT + 1} tokens: max |diff| "
          f"{gap:.3e} (atol = rtol = 2e-3): {ok}")
    if not ok:
        raise AssertionError(f"{WHISPER}: decode != forward in f32")
    res.update(n_params=n_params, decode_vs_forward=gap)
    return res


def whisper_train():
    """24(b): whisper-tiny trained at full size: W_TRAIN_STEPS steps of
    ``chain(clip_by_global_norm(1.0), adam(3e-4))`` (the reference's
    ``launch/steps.py::make_optimizer``) on one batch of 8 x 1500 frames
    and 224 decoder tokens (labels the next tokens); the loss falls, the
    attention forwards are exact (every call past 64 rows: tc)."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core.splitnn import make_split_train_step
    from repro_torch.kernels import block_attention as attn
    from repro_torch.models.model import SplitModel
    cfg = get_config(WHISPER)
    model = SplitModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(lm_contexts(
        cfg.vocab, W_SLOTS, W_TRAIN_TOKENS + 1, seed=2).astype(
        np.int64)).cuda()
    batch = {"frames": torch.from_numpy(rng.normal(size=(
        W_SLOTS, W_FRAMES, cfg.d_frontend)).astype(np.float32)).cuda(),
        "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(3e-4))
    step = make_split_train_step(model.loss_fn, opt)
    state = opt.init(params)
    attn.reset_launch_counts()
    free_card()
    losses, times = [], []
    for t in range(W_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, t)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    counts = dict(attn.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = 1e3 * float(np.median(times[1:]))
    print(f"  (b) {WHISPER} training at full size: {W_TRAIN_STEPS} steps "
          f"of {W_SLOTS} x ({W_FRAMES} frames, {W_TRAIN_TOKENS} tokens); "
          f"loss trail {[round(x, 5) for x in losses]}; step ms "
          f"{[round(1e3 * x, 3) for x in times]} (steady {steady:.3f}); "
          f"peak device memory {peak:.2f} GB")
    # each step: the encoder units' self-attention and the decoder
    # units' self- and cross-attention, each again in the backward's
    # recompute (remat: the config's default)
    n_enc, n_dec = model.P * model.n_head_units, model.n_trunk_units
    check_attention_counts(
        counts, W_TRAIN_STEPS * (1 + cfg.remat) * (n_enc + 2 * n_dec), 0,
        f"{WHISPER} training")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"{WHISPER}: the loss did not fall: {losses}")
    return {"loss_trail": losses, "step_ms": [1e3 * x for x in times],
            "steady_step_ms": steady, "peak_gb": peak, "counts": counts}


def vlm_serving():
    """24(c): qwen2-vl-72b at full width, V_LAYERS layers: prefill the
    vision owner's patches and the text owner's tokens (M-RoPE: the
    patches on a 32 x 32 grid), NEW - 1 decode ticks through the text
    owner's head and the trunk, exact launches by route."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import block_attention as attn
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves
    cfg = get_config(QWEN_VL).replace(n_layers=V_LAYERS)
    model = SplitModel(cfg)
    t = time.time()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  (c) {QWEN_VL} at full width, {V_LAYERS} layers: "
          f"{n_params / 1e9:.3f} G params (f32, {4 * n_params / 1e9:.2f} "
          f"GB) on the card in {time.time() - t:.2f} s; "
          f"{model.n_head_units} head unit x {model.P} owners, "
          f"{model.n_trunk_units} trunk unit; {V_SLOTS} rows of "
          f"{V_PATCHES} patches ({cfg.d_frontend}) + {V_TOKENS} tokens, "
          f"{NEW} new tokens")
    rng = np.random.default_rng(3)
    patches = torch.from_numpy(rng.normal(size=(
        V_SLOTS, V_PATCHES, cfg.d_frontend)).astype(np.float32)).cuda()
    prompt = torch.from_numpy(lm_contexts(cfg.vocab, V_SLOTS, V_TOKENS,
                                          seed=3).astype(np.int64)).cuda()
    S = V_PATCHES + V_TOKENS
    modal_wave(model, params, patches, prompt, 2, S, V_TOKENS)    # warm
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pre, ticks, out, logits = modal_wave(model, params, patches, prompt,
                                         NEW, S, V_TOKENS)
    counts = dict(attn.launch_counts)
    res = report_wave(QWEN_VL, pre, ticks, out, cfg.vocab, logits)
    # the prefill: each owner's head layer and the trunk's (1024 / 2048
    # rows of 8 query heads per kv head: tc); a tick: the text owner's
    # head layer and the trunk's (8 rows: decode)
    units = model.P * model.n_head_units + model.n_trunk_units
    check_attention_counts(counts, units,
                           (model.n_head_units + model.n_trunk_units)
                           * (NEW - 1), QWEN_VL)
    res.update(n_params=n_params, counts=counts)
    return res


def modal_forced(model, params, toks, steps, inputs=None):
    """``teacher_forced`` for the vision and audio models: prefill
    ``inputs`` (frames or patches, a numpy array) with ``toks[:, :S]``
    (S = its length - ``steps``), then ``steps`` decode steps fed the
    next tokens.  Returns (last-token logits (steps + 1, B, vocab) f32,)."""
    import torch
    from repro_torch.tree import tree_leaves
    dev = tree_leaves(params)[0].device
    enc_dec = model.cfg.enc_dec
    B, S = toks.shape[0], toks.shape[1] - steps
    x = torch.from_numpy(inputs).to(dev)
    t = torch.from_numpy(toks.astype("int64")).to(dev)
    s_max = S if enc_dec else x.shape[1] + S
    with torch.inference_mode():
        caches = model.cache_init(B, s_max, n_new=steps + 1, device=dev)
        logits, caches = model.prefill(
            params, {"frames" if enc_dec else "patches": x,
                     "tokens": t[:, :S]}, caches)
        out = [logits.clone()]
        del logits
        for i in range(steps):
            logits, caches = model.decode_step(
                params, caches, t[:, S + i:S + i + 1],
                S + i if enc_dec else x.shape[1] + S + i,
                0 if enc_dec else S + i)
            out.append(logits)
        out = torch.stack(out).float()
    return (out,)


def modal_trail(model, params, batch, steps=3):
    """``steps`` steps of ``chain(clip_by_global_norm(1.0), adam(3e-4))``
    on one batch of numpy arrays: the loss trail."""
    import torch
    from repro_torch import optim
    from repro_torch.core.splitnn import make_split_train_step
    from repro_torch.tree import tree_leaves
    dev = tree_leaves(params)[0].device
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adam(3e-4))
    step, state, trail = make_split_train_step(model.loss_fn, opt), \
        opt.init(params), []
    for t in range(steps):
        params, state, m = step(params, state, b, t)
        trail.append(m["loss"].item())
    return trail


def modal_card_vs_cpu():
    """24(d): reduced whisper-tiny (2 + 2 layers) and qwen2-vl-72b (4
    layers) in f32: the prefill and 5 teacher-forced steps' logits and
    a 3-step clip + Adam trail, card against CPU within rel 1e-4
    (``on_card_and_cpu``: under ``configure_cuda``'s numerics, the CPU
    on one thread)."""
    import functools
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import SplitModel
    out = {}
    for arch, n_layers, n_in in ((WHISPER, None, 96), (QWEN_VL, 4, 64)):
        cfg = get_config(arch, reduced=True).replace(compute_dtype="float32")
        if n_layers:
            cfg = cfg.replace(n_layers=n_layers)
        model = SplitModel(cfg)
        cpu_params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(7)
        x = rng.normal(size=(2, n_in, cfg.d_frontend)).astype(np.float32)
        toks = lm_contexts(cfg.vocab, 2, 64 + 5, seed=7)
        gap = card_vs_cpu(model, cpu_params, toks, 5, f"(d) reduced {arch}",
                          forced=functools.partial(modal_forced, inputs=x))
        lab = toks[:, 1:65].astype(np.int64)
        if not cfg.enc_dec:          # labels over patches + tokens
            lab = np.concatenate([np.full((2, n_in), -100), lab], 1)
        batch = {"frames" if cfg.enc_dec else "patches": x,
                 "tokens": toks[:, :64].astype(np.int64), "labels": lab}
        got, want, _ = on_card_and_cpu(
            lambda p: modal_trail(model, p, batch), cpu_params,
            f"(d) reduced {arch} trail")
        trail_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"    (d) reduced {arch}: 3-step clip + Adam trail card "
              f"{got} vs CPU {want}: max rel {trail_rel:.3e}")
        if gap["rel"] > 1e-4 or trail_rel > 1e-4:
            raise AssertionError(f"reduced {arch}: card and CPU disagree")
        out[arch] = dict(gap, trail=got, trail_rel=trail_rel)
    return out


def xpath_attention_rows(bw, f32_flops):
    """24(e): kernel 4 at these paths' calls (``XPATH_CASES``, bf16): the
    route taken, agreement with the plain version (2e-2), the kernel's
    time beside the plain version's, SDPA's and the bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.block_attention import (attention_ref,
                                                     block_attention,
                                                     route_of)
    from repro_torch.kernels.block_attention.ref import attention_mask
    rows = {}
    for name, (case, need) in XPATH_CASES.items():
        B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_off, kv_len = case
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .cuda().to(torch.bfloat16)
                   for s in ((B, Sq, nh, hd), (B, Skv, nkv, hd),
                             (B, Skv, nkv, hd)))
        kw = dict(kind=kind, window=window, softcap=cap, q_offset=q_off,
                  kv_len=kv_len)
        route = route_of(q, k, v)
        if route != need:
            raise AssertionError(f"attention {name}: route {route}, the "
                                 f"path takes {need}")
        got = block_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = library_matches(f"attention {name} (kernel)", got, want, 2e-2)
        sdpa = sdpa_call(q, k, v, case, attention_mask)
        torch.use_deterministic_algorithms(False)
        lib_err = library_matches(f"attention {name}", sdpa(), want, 2e-2)
        sdpa_ms = device_ms(sdpa, reps=10, rounds=7)
        torch.use_deterministic_algorithms(True)
        bound, by, flops = attn_bound(case, torch.bfloat16, bw, f32_flops)
        row = {"shape": [list(q.shape), list(k.shape)], "kind": kind,
               "q_offset": q_off, "kv_len": kv_len, "route": route,
               "ms": device_ms(lambda: block_attention(q, k, v, **kw),
                               reps=10, rounds=7),
               "plain_ms": device_ms(lambda: attention_ref(q, k, v, **kw),
                                     reps=2, rounds=3),
               "library_ms": sdpa_ms, "library": "sdpa",
               "bound_ms": bound, "bound_by": by, "flops": flops,
               "max_abs_err": err, "library_max_abs_err": lib_err}
        rows[name] = row
        print(f"    {name} {tuple(q.shape)} kv {Skv} {kind} [{route}]: "
              f"|diff| {err:.2e}; {row['ms']:.6f} ms, plain "
              f"{row['plain_ms']:.6f}, SDPA {sdpa_ms:.6f} (|diff| "
              f"{lib_err:.2e}), bound {bound:.6f} ({by})")
        del q, k, v, got, want
        free_card()
    return rows


def phase_enc_dec_vision(bw, f32_flops):
    """Phase 24: whisper-tiny served and trained at full width and depth,
    qwen2-vl-72b served at full width and cut depth, both reduced card
    vs CPU, and kernel 4 at their calls."""
    out = {}
    for key, fn in (("whisper_serving", whisper_serving),
                    ("whisper_train", whisper_train),
                    ("vlm_serving", vlm_serving),
                    ("card_vs_cpu", modal_card_vs_cpu)):
        free_card()
        t = time.time()
        out[key] = fn()
        out[f"{key}_s"] = time.time() - t
    free_card()
    t = time.time()
    print("  (e) the attention kernel at these paths' calls (bf16)")
    out["attention_rows"] = xpath_attention_rows(bw, f32_flops)
    out["attention_rows_s"] = time.time() - t
    return out


# ---------------------------------------------------------------------------
# Phase 25: the step builders (shapes, specs, steps) on llama3.2-3b
# ---------------------------------------------------------------------------

# (a), (b): 8 decode ticks at long_500k's positions 524288-524295 (owner
# 0's slice 262144-262151); a tick launches the decode route once per
# attention layer: every owner's head (2 x 7) and the trunk (21)
LONG_TICKS = 8
# kernel 4 at the long_500k decode calls (bf16, llama's 24/8 heads of
# 128): a row at 524288 over the full 524296-slot cache under the
# 8192-token window, and a ring decode over the 8192 slots
# kernel 4 against its plain version at these calls (bf16): an output
# row is a softmax-weighted mean of ~8192 N(0, 1) values, |out| < ~0.1,
# so the reference's atol of 2e-2 would pass a wrong window; 2e-3 is ~4
# bf16 ulps of the largest outputs
LONG_CALL_ATOL = 2e-3
LONG_ATTN = {"long_500k_window": (1, 1, 524_296, 24, 8, 128, "local", 8192,
                                  0.0, 524_288, 524_289),
             "long_500k_ring": (1, 1, 8192, 24, 8, 128, "bidir", 0, 0.0,
                                0, 8192)}
# (e): reduced llama3.2-3b in f32, 3 layers cut after one; contexts of
# 320 at a long_500k-named shape (the reduced window of 128, ring caches)
STEPS_SMALL_LAYERS, STEPS_SMALL_CTX, STEPS_SMALL_TICKS = 3, 320, 5


def zeros_like_structs(structs, device="cuda"):
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda s: None if s is None else torch.zeros(
        s.shape, dtype=s.dtype, device=device), structs)


def owner_tokens(toks, P, device):
    """(B, S) numpy tokens as the (P, B, S / P) int32 owner slices."""
    import numpy as np
    import torch
    B, S = toks.shape
    return torch.from_numpy(np.ascontiguousarray(
        toks.reshape(B, P, S // P).transpose(1, 0, 2)).astype(
        np.int32)).to(device)


def tick_slots(caches, pos0, local0, n):
    """The KV slots ``n`` decode ticks from (``pos0``, ``local0``) write
    (slot = position mod the cache's slots: ring and full caches
    alike), saved; returns a function that puts them back."""
    from repro_torch.tree import tree_leaves
    saved = []
    for part, p0 in (("trunk", pos0), ("heads", local0)):
        for leaf in tree_leaves(caches[part]):
            lo = p0 % leaf.shape[-3]
            if lo + n > leaf.shape[-3]:
                raise AssertionError("the ticks' slots wrap")
            saved.append((leaf, lo, leaf.narrow(-3, lo, n).clone()))

    def restore():
        for leaf, lo, s in saved:
            leaf.narrow(-3, lo, n).copy_(s)
    return restore


def run_ticks(fn, params, caches, toks, pos0, local0):
    """Teacher-forced decode ticks through a built ``serve_step``:
    (logits (ticks, B, vocab) f32, each tick's ms on the host clock
    between device syncs)."""
    import torch
    out, ms = [], []
    for t in range(toks.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = fn(params, caches, toks[t], pos0 + t, local0 + t)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        out.append(logits.float())
    return torch.stack(out), ms


def step_peak(step):
    """The card's peak allocated bytes over one ``step()``, its inputs
    already in place (the peak reset just before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


@contextlib.contextmanager
def patched(module, **attrs):
    """``module``'s attributes set to ``attrs`` for the ``with`` block,
    then put back."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def plain_attention(fn=None):
    """The model's attention through ``fn`` for the ``with`` block (the
    plain version ``attention_ref`` by default)."""
    from repro_torch.kernels.block_attention import attention_ref
    from repro_torch.models import attention
    return patched(attention, block_attention=fn or attention_ref)


def long_call_gap(got, want, what):
    """A kernel-4 output at a long_500k decode call against the plain
    version's: (max |got - want|, max |want|); raises past
    ``LONG_CALL_ATOL``."""
    want = want.float()
    gap = (got.float() - want).abs().max().item()
    if not gap <= LONG_CALL_ATOL:
        raise AssertionError(f"{what} parts from the plain version by "
                             f"{gap:.3e} (atol {LONG_CALL_ATOL})")
    return gap, want.abs().max().item()


def checked_tick(fn, params, caches, tok, pos, local):
    """One tick in which every attention call is also run through the
    plain version on the same inputs: (the largest |kernel - plain|, the
    largest |plain|, calls); raises past ``LONG_CALL_ATOL``."""
    from repro_torch.kernels.block_attention import attention_ref
    from repro_torch.models import attention
    real, seen = attention.block_attention, []

    def checked(q, k, v, **kw):
        got = real(q, k, v, **kw)
        seen.append(long_call_gap(got, attention_ref(q, k, v, **kw),
                                  "an attention call of the tick"))
        return got

    with plain_attention(checked):
        fn(params, caches, tok, pos, local)
    return (max(g for g, _ in seen), max(w for _, w in seen), len(seen))


def upcast_ms(fn, params, caches, tok, pos, local):
    """One tick with CUDA events after each KV write and before each
    attention call: between them on the stream, only the cache's upcast
    to the compute dtype (``attn_apply``'s ``k.to(q.dtype), v.to(...)``).
    Returns (the upcasts' ms summed over the tick's layers, layers)."""
    import torch
    from repro_torch.models import attention
    spans = []
    write, attend = attention.update_kv_cache, attention.block_attention

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_write(*a, **kw):
        out = write(*a, **kw)
        spans.append([event()])
        return out

    def timed_attend(*a, **kw):
        spans[-1].append(event())
        return attend(*a, **kw)

    with patched(attention, update_kv_cache=timed_write,
                 block_attention=timed_attend):
        fn(params, caches, tok, pos, local)
        torch.cuda.synchronize()
    if any(len(s) != 2 for s in spans):
        raise AssertionError("a KV write without its attention call")
    return sum(e0.elapsed_time(e1) for e0, e1 in spans), len(spans)


def constrain_cost(fn, params, caches, tok, pos, local, tick_ms):
    """The host cost, in a built decode tick, of the activation
    constraints and of the dry-run's DTensor helpers on the real path
    (``sharding.dtensor``: each returns at once on a plain tensor): the
    calls one tick makes (counted), times each one's host microseconds
    on the tick's kind of input (10^5 calls; the constraints under the
    step's one-device sharding context)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, model as model_mod, moe
    from repro_torch.sharding import dtensor, specs
    calls = {}

    def counted(name, real):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        return call

    helpers = {attention: ("split_heads", "on_shards", "pinned"),
               model_mod: ("constrain", "owners", "stack_owners", "on_pod"),
               moe: ("constrain", "replicas")}
    with contextlib.ExitStack() as stack:
        for mod, names in helpers.items():
            stack.enter_context(patched(mod, **{
                n: counted(n, getattr(mod, n)) for n in names}))
        fn(params, caches, tok, pos, local)
    mesh = make_host_mesh()
    x = torch.empty((4, 1, 3072), device="cuda")
    ident = (lambda *a: a[0])
    probes = {"constrain": (specs.constrain, (x, "logits")),
              "split_heads": (dtensor.split_heads, (x, 24, 128)),
              "on_shards": (dtensor.on_shards, (ident, (x,), [(0, 2)],
                                                 [(0, 2)])),
              "pinned": (dtensor.pinned, (x,)),
              "owners": (dtensor.owners, ({"w": x}, 2)),
              "stack_owners": (dtensor.stack_owners, ([x, x], x)),
              "on_pod": (dtensor.on_pod, (ident, {"w": x})),
              "replicas": (dtensor.replicas, (x,))}
    us = {}
    with specs.sharding_context(mesh, specs.make_rules(mesh,
                                                       get_config(LM))):
        for name in calls:
            f, args = probes[name]
            t = time.perf_counter()
            for _ in range(100_000):
                f(*args)
            us[name] = (time.perf_counter() - t) * 10
    total = sum(calls[k] * us[k] for k in calls)
    out = {"calls_per_tick": calls, "us_per_call": us,
           "us_per_tick": total, "share_of_tick": total / 1e3 / tick_ms}
    print(f"  (a) the activation constraints and DTensor helpers on the "
          f"real path: calls a tick {calls}, host us each "
          f"{ {k: round(v, 3) for k, v in us.items()} }: {total:.1f} us a "
          f"tick, {out['share_of_tick']:.2e} of the median tick")
    return out


def f32_ticks(model, params, toks, what, opts, caches=None, rel=1e-4):
    """(a) / (b) in f32 compute (the decode route's f32 path): the 8
    ticks' logits against the same ticks on the plain attention within
    rel ``rel`` (max |diff| / max |logit|), full width and depth.  (a)
    draws f32 ring caches from the same seed; (b) passes its own fp8
    caches, upcast to f32 at every layer (the ticks' slots put back
    after each run)."""
    import torch
    from repro_torch.configs import LONG_500K
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_leaves
    cfg = model.cfg.replace(compute_dtype="float32")
    fn, args, _, _ = steps.build(cfg, LONG_500K, make_host_mesh(), **opts)
    if caches is None:
        caches = steps.materialize(args[1], torch.Generator(
            device="cuda").manual_seed(25), "cuda")
    elif [(t.shape, t.dtype) for t in tree_leaves(caches)] != [
            (t.shape, t.dtype) for t in tree_leaves(args[1])]:
        raise AssertionError(f"{what}: the f32 step's caches differ")
    S, P = LONG_500K.seq_len, model.P
    restore = tick_slots(caches, S, S // P, LONG_TICKS)
    got, ms = run_ticks(fn, params, caches, toks, S, S // P)
    restore()
    with plain_attention():
        want, _ = run_ticks(fn, params, caches, toks, S, S // P)
    restore()
    gap = ((got - want).abs().max() / want.abs().max()).item()
    print(f"  {what} in f32 compute: logits vs the plain attention's max "
          f"rel {gap:.3e} (limit {rel}); tick ms "
          f"{[round(x, 3) for x in ms]}")
    if not gap <= rel or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what} f32: logits part from the plain "
                             f"attention's")
    return {"rel": gap, "tick_ms": ms}


def long_decode(model, params, ring):
    """25(a) / (b): ``build(cfg, LONG_500K, make_host_mesh(), ...)`` on
    ``params`` (phase 7's), the caches drawn from a seed, 8 ticks timed,
    the launch counts, then the plain-attention checks from the same
    caches (the ticks' slots put back before each run)."""
    import numpy as np
    import torch
    from repro_torch.configs import LONG_500K
    from repro_torch.kernels import block_attention as attn
    from repro_torch.kernels.block_attention import (attention_ref,
                                                     attention_split_kv_ref)
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_leaves
    cfg, P = model.cfg, model.P
    what = "(a) ring caches" if ring else "(b) fp8 caches, full length"
    opts = (dict(ring_cache=True) if ring
            else dict(cache_dtype=torch.float8_e4m3fn))
    fn, args, _, donate = steps.build(cfg, LONG_500K, make_host_mesh(),
                                      **opts)
    S, B = LONG_500K.seq_len, LONG_500K.global_batch
    slots = sorted({t.shape[-3] for t in tree_leaves(args[1])})
    nbytes = kv_bytes(args[1])
    W = cfg.long_context_window
    units = P * model.n_head_units + model.n_trunk_units
    per = 2 * cfg.n_kv_heads * cfg.head_dim * B
    if ring:
        want_slots = [W]
        want_bytes = 2 * per * W * units
    else:
        want_slots = [S // P + 8, S + 8]
        want_bytes = per * (model.n_trunk_units * (S + 8)
                            + P * model.n_head_units * (S // P + 8))
    print(f"  {what}: swa_override {steps.swa_for(cfg, LONG_500K)}, KV "
          f"slots {slots} (needed {want_slots}), {nbytes / 1e9:.3f} GB of "
          f"caches (analytic {want_bytes / 1e9:.3f} GB), donate {donate}")
    if slots != want_slots or nbytes != want_bytes:
        raise AssertionError(f"{what}: slots or cache bytes wrong")
    free_card()
    t = time.time()
    caches = steps.materialize(args[1], torch.Generator(
        device="cuda").manual_seed(25), "cuda")
    torch.cuda.synchronize()
    fill_s = time.time() - t
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        0, cfg.vocab, (LONG_TICKS, B, 1)).astype(np.int32)).cuda()
    pos0, local0 = S, S // P
    restore = tick_slots(caches, pos0, local0, LONG_TICKS)
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    got, ms = run_ticks(fn, params, caches, toks, pos0, local0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = dict(attn.launch_counts)
    need = {"block_attention": units * LONG_TICKS,
            "block_attention.decode": units * LONG_TICKS,
            "block_attention.tc": 0, "block_attention.fma": 0}
    print(f"  {what}: filled from a seed in {fill_s:.2f} s; {LONG_TICKS} "
          f"ticks at {pos0}-{pos0 + LONG_TICKS - 1}: ms {[round(x, 3) for x in ms]}"
          f", median {float(np.median(ms)):.3f}; peak device memory "
          f"{peak_gb:.2f} GB; launches {counts} (needed {need}: {units} a "
          f"tick)")
    for k, n in need.items():
        if counts[k] != n:
            raise AssertionError(f"{what}: {k} launched {counts[k]} != {n}")
    restore()
    out = {"slots": slots, "cache_bytes": nbytes, "fill_s": fill_s,
           "tick_ms": ms, "tick_ms_median": float(np.median(ms)),
           "peak_gb": peak_gb, "counts": counts, "launches_per_tick": units,
           "step_peak_bytes": step_peak(lambda: fn(
               params, caches, toks[0], pos0, local0))}
    print(f"  {what}: one tick alone, its inputs in place: peak "
          f"{out['step_peak_bytes'] / 1e9:.3f} GB")
    if not ring:
        up, layers = upcast_ms(fn, params, caches, toks[-1],
                               pos0 + LONG_TICKS - 1, local0 + LONG_TICKS - 1)
        out.update(upcast_ms=up, upcast_layers=layers,
                   upcast_share=up / out["tick_ms_median"])
        print(f"  {what}: the fp8 caches' upcast to bf16 in one tick "
              f"(CUDA events around it, {layers} layers) {up:.3f} ms, "
              f"{out['upcast_share']:.3f} of the median tick")
    # the plain-attention checks: every call of a tick against the plain
    # version on its inputs (LONG_CALL_ATOL); the logits of the 8 ticks
    # against the same ticks on the plain version, held to twice the
    # bf16 floor of 28 layers: the gap between two plain versions that
    # differ only in their f32 summation order (attention_ref,
    # attention_split_kv_ref); then the same ticks in f32 compute
    restore()
    (out["per_call_max_abs_err"], out["per_call_max_abs_want"],
     calls) = checked_tick(fn, params, caches, toks[0], pos0, local0)
    print(f"  {what}: each of the tick's {calls} attention calls against "
          f"the plain version on its inputs: max |diff| "
          f"{out['per_call_max_abs_err']:.3e} (atol {LONG_CALL_ATOL}) on "
          f"outputs up to {out['per_call_max_abs_want']:.3e}")
    runs = {}
    for name, plain in (("ref", attention_ref),
                        ("split_ref", attention_split_kv_ref)):
        restore()
        with plain_attention(plain):
            runs[name], _ = run_ticks(fn, params, caches, toks, pos0,
                                      local0)
    gap = (got - runs["ref"]).abs().max().item()
    floor = (runs["ref"] - runs["split_ref"]).abs().max().item()
    out.update(max_abs_err=gap, bf16_floor=floor)
    print(f"  {what}: logits vs the same ticks on the plain attention: max "
          f"|diff| {gap:.3e}; the bf16 floor (two plain versions) "
          f"{floor:.3e}; limit {BF16_PAIR_LIMIT} x the floor (max |logit| "
          f"{runs['ref'].abs().max().item():.3f})")
    if not gap <= BF16_PAIR_LIMIT * floor or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{what}: logits part from the plain "
                             f"attention's past the bf16 floor")
    restore()
    if ring:
        out["constrain"] = constrain_cost(fn, params, caches, toks[0], pos0,
                                          local0, out["tick_ms_median"])
        out["f32"] = f32_ticks(model, params, toks, what, opts)
    else:
        out["f32"] = f32_ticks(model, params, toks, what, opts, caches)
    del caches, restore
    return out


def built_prefill_is_direct(model, params):
    """25(c): ``build_prefill`` at phase 7's 8 contexts of 1024 ==
    ``SplitModel.prefill`` called directly, bitwise (logits and
    caches)."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import block_attention as attn
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_leaves
    B = 2 * SLOTS
    shape = ShapeConfig("prefill_card", CTX, B, "prefill")
    fn, args, _, _ = steps.build(model.cfg, shape, make_host_mesh())
    ot = owner_tokens(lm_contexts(model.cfg.vocab, B, CTX), model.P, "cuda")
    caches = zeros_like_structs(args[2])
    fn(params, {"owner_tokens": ot}, zeros_like_structs(args[2]))  # warm
    attn.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    got, caches = fn(params, {"owner_tokens": ot}, caches)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    counts = dict(attn.launch_counts)
    with torch.no_grad():
        want, direct = model.prefill(params, {"owner_tokens": ot},
                                     model.cache_init(B, CTX, 8,
                                                      device="cuda"))
    same = torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(caches),
                                          tree_leaves(direct)))
    units = model.P * model.n_head_units + model.n_trunk_units
    print(f"  (c) build_prefill {tuple(ot.shape)}: {ms:.3f} ms, peak "
          f"{peak / 1e9:.3f} GB (its inputs in place); launches "
          f"{counts} (tc needed {units}); logits and caches == "
          f"SplitModel.prefill bitwise: {same}")
    if not same or counts["block_attention.tc"] != units or \
            counts["block_attention"] != units:
        raise AssertionError("(c) the prefill builder parts from prefill")
    return {"ms": ms, "counts": counts, "bitwise": same,
            "step_peak_bytes": peak}


def remat_step(cfg, shape, mesh, params, batch):
    """One ``build_train`` step of ``cfg`` from ``params``: (updated
    leaves on the host, loss, attention launches by route, the bytes
    allocated when the loss is in hand and its backward not begun, the
    step's peak)."""
    import torch
    from repro_torch.kernels import block_attention as attn
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    fn, _, _, _ = steps.build(cfg, shape, mesh)
    state = steps.make_optimizer(cfg).init(params)
    held = []
    inner = steps.grads_of

    def grads_of(loss, tree, *a):
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        return inner(loss, tree, *a)

    attn.reset_launch_counts()
    result = []
    with patched(steps, grads_of=grads_of):
        peak = step_peak(lambda: result.extend(fn(params, state, batch, 0)))
    p, _, m = result
    leaves = [t.cpu() for t in tree_leaves(p)]
    del p, state, result
    return (leaves, float(m["loss"]), dict(attn.launch_counts), held[0],
            peak)


def built_train():
    """25(d): ``build_train`` at full width, 4 layers cut after 2, one
    batch of 8 x 256: one step with ``remat`` off and one with it on
    (the config's default) from the same params — loss and every
    updated leaf bitwise equal, tc launched ``units`` and ``2·units``
    times, fewer bytes held between the loss and the backward with it
    on and a one-step peak no higher; 1 and 4 microbatches (losses
    within rel 1e-4), the bf16 optimizer state, ms a step."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import block_attention as attn
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves
    cfg = lm_train_cfg()
    assert cfg.remat
    model = SplitModel(cfg)
    mesh = make_host_mesh()
    shape = ShapeConfig("train_card", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = lm_contexts(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ + 1, seed=7)
    batch = {"owner_tokens": owner_tokens(toks[:, :-1], model.P, "cuda"),
             "labels": torch.from_numpy(np.ascontiguousarray(
                 toks[:, 1:]).astype(np.int32)).cuda()}
    units = model.P * model.n_head_units + model.n_trunk_units
    out = {"losses": {}, "counts": {}, "remat": {}}
    card = card_line()
    runs = {}
    for remat in (False, True):
        free_card()
        runs[remat] = remat_step(cfg.replace(remat=remat), shape, mesh,
                                 params, batch)
        _, loss, counts, held, peak = runs[remat]
        # every unit's kernel forward once, and with remat once more in
        # the backward's recompute
        want = units * (1 + remat)
        out["remat"]["on" if remat else "off"] = {"loss": loss, "tc": counts[
            "block_attention.tc"], "held_bytes": held, "peak_bytes": peak}
        print(f"  (d) build_train, remat={remat}: loss {loss:.6f}; tc "
              f"launches {counts['block_attention.tc']} (needed exactly "
              f"{want}); {held / 1e9:.3f} GB allocated between the loss and "
              f"the backward; one-step peak {peak / 1e9:.3f} GB ({card})")
        if counts["block_attention.tc"] != want:
            raise AssertionError(f"(d) remat={remat}: tc launched "
                                 f"{counts['block_attention.tc']} != {want}")
    off, on = runs[False], runs[True]
    same = off[1] == on[1] and all(torch.equal(a, b)
                                   for a, b in zip(off[0], on[0]))
    saved = off[3] - on[3]
    print(f"  (d) remat on == off: loss and every updated leaf bitwise "
          f"equal: {same}; remat holds {saved / 1e9:.3f} GB fewer between "
          f"the loss and the backward; peak {on[4] / 1e9:.3f} vs "
          f"{off[4] / 1e9:.3f} GB")
    if not same or saved <= 0 or on[4] > off[4]:
        raise AssertionError("(d) remat on != off, or it held no fewer "
                             "bytes, or its peak is higher")
    out["remat_saved_bytes"] = saved
    del runs, off, on
    for nm in (1, 4):
        fn, args, _, _ = steps.build(cfg, shape, mesh, n_microbatches=nm)
        state = steps.make_optimizer(cfg).init(params)
        attn.reset_launch_counts()
        _, _, m = fn(params, state, batch, 0)
        out["losses"][nm] = float(m["loss"])
        out["counts"][nm] = dict(attn.launch_counts)
        if out["counts"][nm]["block_attention.tc"] != 2 * units * nm:
            raise AssertionError(f"(d) {nm} microbatches: tc launched "
                                 f"{out['counts'][nm]['block_attention.tc']}"
                                 f" != {2 * units * nm}")
        del state, m
    rel = abs(out["losses"][1] - out["losses"][4]) / abs(out["losses"][1])
    out["micro_rel"] = rel
    fn, args, _, _ = steps.build(cfg, shape, mesh,
                                 opt_state_dtype=torch.bfloat16)
    state = steps.make_optimizer(cfg, torch.bfloat16).init(params)
    p, state, m = fn(params, state, batch, 0)
    dtypes = sorted({str(t.dtype) for t in tree_leaves(args[1])}
                    | {str(t.dtype) for t in tree_leaves(state)})
    del p, state
    fn, _, _, _ = steps.build(cfg, shape, mesh)
    p, state = params, steps.make_optimizer(cfg).init(params)
    del params
    free_card()
    ms, peaks = [], []
    for i in range(4):
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()    # each step's own peak
        t = time.perf_counter()
        p, state, m = fn(p, state, batch, i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        peaks.append(torch.cuda.max_memory_allocated())
    out.update(step_ms=ms[1:], step_ms_median=float(np.median(ms[1:])),
               peak_gb=max(peaks) / 1e9, step_peak_bytes=peaks[-1],
               bf16_state_dtypes=dtypes, n_params=sum(
                   t.numel() for t in tree_leaves(p)))
    print(f"  (d) build_train, {cfg.n_layers} layers cut after "
          f"{cfg.split.cut_layer}, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: loss "
          f"{out['losses'][1]:.6f} in one batch, {out['losses'][4]:.6f} in "
          f"4 microbatches (rel {rel:.3e}, limit 1e-4); tc launches "
          f"{2 * units} / {8 * units}; opt_state_dtype=bfloat16 state "
          f"dtypes {dtypes}; steps ms {[round(x, 3) for x in ms]} (median of"
          f" the last 3 {out['step_ms_median']:.3f}); peak "
          f"{out['peak_gb']:.2f} GB, the last step's own "
          f"{out['step_peak_bytes'] / 1e9:.3f} GB")
    if rel > 1e-4 or dtypes != ["torch.bfloat16"] or \
            not np.isfinite(float(m["loss"])):
        raise AssertionError("(d) the train builder's checks failed")
    del p, state
    return out


def built_forced(model, params, toks, n_ticks, **_):
    """Teacher-forced logits through the builders at a long_500k-named
    shape (the window as ``swa_override``): ``build_prefill`` into
    ``build_decode``'s ring caches, then ``n_ticks`` built decode ticks
    (``teacher_forced``'s contract, for ``card_vs_cpu``)."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_leaves
    dev = tree_leaves(params)[0].device
    mesh = make_host_mesh(device=dev.type)
    B, P = toks.shape[0], model.P
    S = toks.shape[1] - n_ticks
    pre, _, _, _ = steps.build(model.cfg, ShapeConfig("long_500k", S, B,
                                                      "prefill"), mesh)
    dec, args, _, _ = steps.build(model.cfg, ShapeConfig(
        "long_500k", S, B, "decode"), mesh, ring_cache=True)
    caches = zeros_like_structs(args[1], dev)
    logits, caches = pre(params, {"owner_tokens": owner_tokens(
        toks[:, :S], P, dev)}, caches)
    out = [logits]
    nxt = torch.from_numpy(toks[:, S:].astype(np.int32)).to(dev)
    for t in range(n_ticks):
        logits, caches = dec(params, caches, nxt[:, t:t + 1], S + t,
                             S // P + t)
        out.append(logits)
    return torch.stack(out).float(), caches, None


def built_card_vs_cpu():
    """25(e): reduced llama3.2-3b (f32) through the builders, card
    against CPU (``card_vs_cpu``): the prefill and decode ticks on ring
    caches at a long_500k-named shape, and 3 train steps in 2
    microbatches."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import SplitModel
    from repro_torch.tree import tree_leaves
    cfg = get_config(LM, reduced=True).replace(
        n_layers=STEPS_SMALL_LAYERS, compute_dtype="float32").with_split(
        cut_layer=1)
    model = SplitModel(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    toks = lm_contexts(cfg.vocab, 2, STEPS_SMALL_CTX + STEPS_SMALL_TICKS,
                       seed=8)
    dec = card_vs_cpu(model, cpu_params, toks, STEPS_SMALL_TICKS,
                      "(e) reduced llama, built prefill + decode (ring)",
                      forced=built_forced)
    ttoks = lm_contexts(cfg.vocab, 4, 65, seed=9)

    def trail(params):
        dev = tree_leaves(params)[0].device
        fn, _, _, _ = steps.build(cfg, ShapeConfig("t", 64, 4, "train"),
                                  make_host_mesh(device=dev.type),
                                  n_microbatches=2)
        batch = {"owner_tokens": owner_tokens(ttoks[:, :-1], model.P, dev),
                 "labels": torch.from_numpy(np.ascontiguousarray(
                     ttoks[:, 1:]).astype(np.int32)).to(dev)}
        state = steps.make_optimizer(cfg).init(params)
        losses = []
        for i in range(3):
            params, state, m = fn(params, state, batch, i)
            losses.append(m["loss"])
        return torch.stack(losses).cpu()

    got, want, _ = on_card_and_cpu(trail, cpu_params,
                                   "(e) reduced llama, built train steps")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"  (e) built train steps, card vs CPU (1 thread): losses "
          f"{got.tolist()} / {want.tolist()}, max rel {rel:.3e}")
    if dec["rel"] > 1e-4 or rel > 1e-4:
        raise AssertionError("(e) card and CPU part past rel 1e-4")
    return {"decode": dec, "train_rel": rel}


def spec_census():
    """25(f): for every arch x shape x production mesh, the sharded
    leaves of each spec tree (no device: the trees are ``meta``)."""
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import SplitModel
    from repro_torch.sharding import specs
    out = {}
    meshes = {"16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True)}

    def sharded(tree):
        leaves = specs.spec_leaves(tree)
        return [sum(any(e is not None for e in s) for s in leaves),
                len(leaves)]

    for arch in list_archs():
        cfg = get_config(arch)
        model = SplitModel(cfg)
        p = model.param_specs()
        o = steps.make_optimizer(cfg).init(p)
        row = {}
        for name, shape in SHAPES.items():
            B, S = shape.global_batch, shape.seq_len
            swa = steps.swa_for(cfg, shape) or 0
            b = steps.batch_structs(cfg, shape, shape.kind == "train")
            c = model.cache_init(B, S, 8, device="meta", swa_override=swa)
            for mname, mesh in meshes.items():
                r = specs.make_rules(mesh, cfg)
                row[f"{name}/{mname}"] = {
                    "params": sharded(specs.param_specs(p, cfg, mesh, r)),
                    "opt": sharded(specs.param_specs(o, cfg, mesh, r)),
                    "batch": sharded(specs.batch_specs(b, cfg, mesh, r)),
                    "cache": sharded(specs.cache_specs(c, cfg, mesh, r))}
        out[arch] = row
        print(f"  (f) {arch}: sharded / all leaves (params, opt, batch, "
              f"cache) by shape/mesh: " + "; ".join(
                  f"{k} {v['params']} {v['opt']} {v['batch']} {v['cache']}"
                  for k, v in row.items()))
    return out


def long_attention_rows(bw, f32_flops):
    """25(g): kernel 4 at the long_500k decode calls, bf16, against the
    plain version, timed beside it, SDPA and the bound (the keys the
    window needs: the route walks the window, not the cache)."""
    import torch
    from repro_torch.kernels.block_attention import (attention_ref,
                                                     block_attention,
                                                     route_of)
    from repro_torch.kernels.block_attention.ref import attention_mask
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(26)
    for name, case in LONG_ATTN.items():
        B, Sq, Skv, nh, nkv, hd, kind, window, cap, q_off, kv_len = case
        q = torch.randn((B, Sq, nh, hd), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, Skv, nkv, hd), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        kw = dict(kind=kind, window=window, q_offset=q_off, kv_len=kv_len)
        if route_of(q, k, v) != "decode":
            raise AssertionError(f"{name}: not on the decode route")
        want = attention_ref(q, k, v, **kw)
        gap, want_max = long_call_gap(block_attention(q, k, v, **kw), want,
                                      name)
        pairs, _ = live_pairs(Sq, Skv, kind, window, q_off, kv_len)
        nbytes = 2 * (2 * B * Sq * nh * hd + 2 * B * pairs * nkv * hd)
        flops = 4 * B * nh * hd * pairs
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / BF16_FLOPS
        lo = kv_len - pairs // Sq          # the keys the row needs
        window_keys = (k[:, lo:kv_len], v[:, lo:kv_len])
        torch.use_deterministic_algorithms(False)
        library = sdpa_call(q, *window_keys, (B, Sq, kv_len - lo, nh, nkv,
                                              hd, "bidir", 0, 0.0, 0, None),
                            attention_mask)
        lib_err = (library().float() - want.float()).abs().max().item()
        row = {"shape": [list(q.shape), list(k.shape)], "route": "decode",
               "kind": kind, "window": window, "q_offset": q_off,
               "kv_len": kv_len, "keys_needed": pairs,
               "ms": device_ms(lambda: block_attention(q, k, v, **kw),
                               reps=10, rounds=7),
               "plain_ms": device_ms(lambda: attention_ref(q, k, v, **kw),
                                     reps=2, rounds=3),
               "library_ms": device_ms(library, reps=10, rounds=7),
               "library": "sdpa over the window's keys",
               "library_max_abs_err": lib_err,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "max_abs_err": gap, "max_abs_want": want_max}
        if kind == "local":
            masked = sdpa_call(q, k, v, case, attention_mask)
            row["library_masked_ms"] = device_ms(masked, reps=3, rounds=5)
        torch.use_deterministic_algorithms(True)
        rows[name] = row
        print(f"  (g) {name} {row['shape']} {kind} window {window} at "
              f"{q_off}: decode {row['ms']:.6f} ms; plain "
              f"{row['plain_ms']:.6f}; SDPA over the window's {pairs} keys "
              f"{row['library_ms']:.6f} (|diff| {lib_err:.2e})"
              + (f", SDPA masked over the whole cache "
                 f"{row['library_masked_ms']:.6f}" if kind == "local" else "")
              + f"; bound {row['bound_ms']:.6f} ({row['bound_by']}); max "
              f"|diff| {gap:.3e} (atol {LONG_CALL_ATOL}) on outputs up to "
              f"{want_max:.3e}")
        del q, k, v, window_keys, library
    return rows


def phase_steps_serving(model, params, bw, f32_flops):
    """Phase 25(a)-(c) and (g), on phase 7's llama3.2-3b params."""
    out = {}
    for key, fn in (("ring", lambda: long_decode(model, params, True)),
                    ("fp8", lambda: long_decode(model, params, False)),
                    ("prefill", lambda: built_prefill_is_direct(model,
                                                                params)),
                    ("attention_rows", lambda: long_attention_rows(
                        bw, f32_flops))):
        free_card()
        t = time.time()
        out[key] = fn()
        out[f"{key}_s"] = time.time() - t
    return out


def phase_steps_train():
    """Phase 25(d)-(f)."""
    out = {}
    for key, fn in (("train", built_train),
                    ("card_vs_cpu", built_card_vs_cpu),
                    ("specs", spec_census)):
        free_card()
        t = time.time()
        out[key] = fn()
        out[f"{key}_s"] = time.time() - t
    free_card()
    return out


# ---------------------------------------------------------------------------
# Phase 26: the dry-run and its analysis
# ---------------------------------------------------------------------------

#: the cut's activation sites: the only collectives besides 0-d
#: reductions that may cross the pods (claim C4)
CUT_SITES = ("cut_stacked", "combined")
#: the one-card trace's memory against the card's one-step peak
HBM_RTOL = 0.10


def dryrun_cli():
    """26(a): ``python -m repro_torch.launch.dryrun --arch llama3.2-3b
    --both-meshes`` at full width and depth in a subprocess: every record
    "ok"; on (2, 16, 16) cross-pod bytes only at the cut's sites and in
    0-d reductions, and some at the cut; on (16, 16) none."""
    import tempfile
    from repro_torch.launch.analysis import shape_bytes
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM,
             "--both-meshes", "--out", tmp], cwd=root, capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(root / "src")))
        wall = time.time() - t
        recs = [json.loads((Path(tmp) / f).read_text())
                for f in sorted(os.listdir(tmp))]
    if r.returncode:
        print(r.stdout[-3000:], r.stderr[-6000:])
        raise AssertionError(f"26(a): the dry-run CLI exited {r.returncode}")
    out = {"wall_s": wall, "records": {}}
    for rec in recs:
        key = f"{rec['shape']}/{rec['mesh']}"
        c = rec["collectives"]
        cut = sum(shape_bytes(x["dtype"], x["shape"])
                  for x in rec["cross_pod"] if x["site"] in CUT_SITES)
        other = [x for x in rec["cross_pod"]
                 if x["site"] not in CUT_SITES and x["shape"]]
        row = {"status": rec["status"], "trace_s": rec["trace_s"],
               "hbm_gib": rec["hbm_per_device_bytes"] / 2**30,
               "flops": rec["cost"]["flops"],
               "coll_mib": c["total_bytes"] / 2**20,
               "cross_pod_bytes": c["cross_pod_bytes"], "cut_bytes": cut,
               "zero_d_reductions": sum(
                   1 for x in rec["cross_pod"] if not x["shape"]),
               "kernels": rec["kernels"]}
        out["records"][key] = row
        print(f"  (a) {key}: {rec['status']}, trace {rec['trace_s']} s, "
              f"{row['hbm_gib']:.2f} GiB a device, {row['flops']:.4e} FLOPs,"
              f" {row['coll_mib']:.1f} MiB of collectives, cross-pod "
              f"{c['cross_pod_bytes']} B ({cut} B at the cut's sites, "
              f"{row['zero_d_reductions']} 0-d reductions), kernels "
              f"{rec['kernels']}")
        if rec["status"] != "ok":
            raise AssertionError(f"26(a) {key}: {rec['status']}")
        if rec["mesh"] == "2x16x16":
            if not cut or other or c["cross_pod_bytes"] <= 0:
                raise AssertionError(f"26(a) {key}: cross-pod traffic off "
                                     f"the cut: {other[:4]}")
        elif c["cross_pod_bytes"]:
            raise AssertionError(f"26(a) {key}: cross-pod bytes on one pod")
    if len(recs) != 8:
        raise AssertionError(f"26(a): {len(recs)} records, not 8")
    print(f"  (a) the CLI: 8 records in {wall:.1f} s")
    return out


def one_card_traces(built):
    """26(b)-(c): the dry-run's trace on a one-device fake mesh of the
    four steps phase 25 ran on the card: its launches by route equal
    phase 25's, its ``hbm_per_device`` is within ``HBM_RTOL`` of the
    card's peak over one step, and its FLOPs over the card's ms."""
    import torch
    from repro_torch.configs import LONG_500K, ShapeConfig, get_config
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.mesh import peaks
    f32_peak = peaks(torch.cuda.get_device_name(0))[1]
    cfg = get_config(LM)
    steps = {
        "ring": (cfg, LONG_500K, dict(ring_cache=True),
                 built["ring"]["tick_ms_median"], LONG_TICKS),
        "fp8": (cfg, LONG_500K, dict(cache_dtype=torch.float8_e4m3fn),
                built["fp8"]["tick_ms_median"], LONG_TICKS),
        "prefill": (cfg, ShapeConfig("prefill_card", CTX, 2 * SLOTS,
                                     "prefill"), {},
                    built["prefill"]["ms"], 1),
        "train": (lm_train_cfg(), ShapeConfig(
            "train_card", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train"), {},
            built["train"]["step_ms_median"], 1)}
    out = {}
    for name, (c, shape, kw, card_ms, per) in steps.items():
        with dryrun.fake_world(1):
            tr = dryrun.trace_step(c, shape, dryrun.fake_mesh(
                (1, 1), ("data", "model")), **kw)
        card = (built[name]["counts"] if name != "train"
                else built["train"]["counts"][1])
        want = {k: v // per for k, v in card.items()
                if k.startswith("block_attention.") and v}
        hbm = analysis.hbm_per_device(tr["memory"])
        peak = built[name]["step_peak_bytes"]
        tflops = tr["cost"]["flops"] / (card_ms / 1e3) / 1e12
        row = {"kernels": tr["kernels"], "card_launches": want,
               "hbm_bytes": hbm, "card_peak_bytes": peak,
               "ratio": hbm / peak, "memory": tr["memory"],
               "flops": tr["cost"]["flops"], "card_ms": card_ms,
               "achieved_tflops": tflops, "trace_s": tr["trace_s"]}
        out[name] = row
        print(f"  (b) {name}: traced {tr['kernels']} vs the card's "
              f"{want}{' a tick' if per > 1 else ''}; hbm_per_device "
              f"{hbm / 1e9:.3f} GB vs the card's one-step peak "
              f"{peak / 1e9:.3f} GB (ratio {hbm / peak:.4f}, limit 1 +- "
              f"{HBM_RTOL}); temp {tr['memory']['temp_bytes'] / 1e9:.3f} GB")
        print(f"  (c) {name}: {tr['cost']['flops']:.4e} FLOPs over the "
              f"card's {card_ms:.3f} ms = {tflops:.2f} TFLOP/s (f32 peak "
              f"{f32_peak / 1e12:.0f}, bf16 {BF16_FLOPS / 1e12:.0f})")
        if tr["kernels"] != want:
            raise AssertionError(f"26(b) {name}: traced launches "
                                 f"{tr['kernels']} != the card's {want}")
        if abs(hbm / peak - 1) > HBM_RTOL:
            raise AssertionError(f"26(b) {name}: hbm_per_device {hbm} vs "
                                 f"the card's {peak}")
    # the fp8 step's transient: a trunk layer's whole cache upcast to bf16
    # (K and V), the largest a tick makes
    S, W = LONG_500K.seq_len + 8, 2 * cfg.n_kv_heads * cfg.head_dim * 2
    upcast = LONG_500K.global_batch * S * W
    temp = out["fp8"]["memory"]["temp_bytes"]
    out["fp8"]["upcast_bytes"] = upcast
    print(f"  (b) fp8: the trace's temp bytes {temp / 1e9:.3f} GB against "
          f"one trunk layer's K and V upcast to bf16, {upcast / 1e9:.3f} GB:"
          f" the upcast is the tick's transient: {upcast <= temp < 1.1 * upcast}")
    return out


def phase_dryrun(built):
    """Phase 26: the dry-run (``repro_torch.launch.dryrun``)."""
    out = {}
    t = time.time()
    out["cli"] = dryrun_cli()
    out["cli_s"] = time.time() - t
    t = time.time()
    out["one_card"] = one_card_traces(built)
    out["one_card_s"] = time.time() - t
    return out


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.device import configure_cuda
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import peaks
    configure_cuda()
    phase_s, last = {}, [None, time.time()]

    def mark(label):
        """Each phase's wall seconds, from its header to the next's."""
        now = time.time()
        if last[0] is not None:
            phase_s[last[0]] = round(now - last[1], 2)
        last[:] = [label, now]

    smi = card_line()
    name = torch.cuda.get_device_name(0)
    bw, flops = peaks(name)
    mark("1")
    print("== 1. device")
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; peaks "
          f"used for bounds: {bw / 1e12} TB/s, {flops / 1e12} TFLOP/s f32")

    mark("2")
    print("== 2. build")
    t = time.time()
    build.build(["quantize", "block_attention", "attention_decode",
                 "attention_prefill_sm90", "mamba2_scan",
                 "mamba2_scan_chunked", "cut_fusion"])
    print(f"  built in {time.time() - t:.2f} s")
    for src, log in build.build_logs.items():
        print("\n".join(f"  nvcc {src}: {line}" for line in
                        log.strip().splitlines()))

    mark("3")
    print("== 3. kernels vs plain versions on the card")
    kern = phase_kernels(bw, flops)
    mark("4")
    print("== 4. main path: PSI -> SplitNN -> split int8 fit -> evaluate")
    counts, _, path_cut = phase_main_path()
    mark("5")
    print("== 5. split == joint on the card")
    phase_split_equals_joint()
    t = time.time()
    mark("6")
    print("== 6. attention kernel vs plain version on the card")
    att = phase_attention(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("7")
    print(f"== 7. split-LM serving at full width: {LM}, wave engine, "
          "queue transport, int8 cut codec")
    serving = phase_serving(LM)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("8")
    print("== 8. engine == manual decode; card vs CPU")
    lm_model, lm_params = serving.pop("model"), serving.pop("params")
    phase_lm_checks(lm_model, lm_params,
                    get_config(LM).replace(n_layers=2,
                                           compute_dtype="float32"), 64)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("19")
    print(f"== 19. the rest of LM serving at full width ({LM}, run here "
          "while phase 7's params are alive): continuous batching, "
          "process transport, cut cache, sessions, latency, degraded "
          "service, cut bottleneck, the session entry point")
    cont = phase_continuous(lm_model, lm_params, bw)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("25")
    print(f"== 25. the step builders on {LM} ({LM}'s params from phase 7): "
          "long_500k decode built by steps.build on ring caches and on a "
          "full-length fp8 cache, the prefill and train builders, card vs "
          "CPU, the spec trees of every arch, shape and production mesh")
    built = phase_steps_serving(lm_model, lm_params, bw, flops)
    del lm_model, lm_params
    torch.cuda.empty_cache()       # the llama params are gone
    built.update(phase_steps_train())
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("26")
    print(f"== 26. the dry-run: {LM}'s four shapes traced on fake "
          "production meshes of 256 and 512 ranks (claim C4 per "
          "collective), and phase 25's steps traced on one device against "
          "the card")
    dry = phase_dryrun(built)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("19(j)")
    print("  (j) VerticalSession -> resolve -> build -> serve_dataset "
          "(continuous, process, int8)")
    cont["session"] = phase_continuous_session()
    torch.cuda.empty_cache()
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("9")
    print("== 9. SSD scan kernel vs plain version on the card")
    ssd = phase_scan(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("10")
    print(f"== 10. split-LM serving at full width: {ZAMBA}, wave engine, "
          "queue transport, int8 cut codec")
    zamba = phase_serving(ZAMBA)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("11")
    print("== 11. engine == manual decode; card vs CPU (zamba2-2.7b)")
    z_model, z_params = zamba.pop("model"), zamba.pop("params")
    phase_lm_checks(z_model, z_params,
                    get_config(ZAMBA, reduced=True).replace(
                        n_layers=18, compute_dtype="float32"), 128)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("19(i)")
    print("== 19(i). zamba2-2.7b continuous == wave (phase 10's params)")
    cont["zamba2"] = phase_continuous_zamba(z_model, z_params)
    del z_model, z_params
    torch.cuda.empty_cache()
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("12")
    print("== 12. cut-fusion kernel vs plain version on the card")
    cut = phase_cut_fusion(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("13")
    print("== 13. the training path through the other schedules: "
          "microbatches, worker processes, combines")
    phase_schedules()
    print(f"  phase wall {time.time() - t:.2f} s")
    t = time.time()
    mark("15")
    print("== 15. secure forward aggregation and the cut-layer defences")
    priv = phase_privacy()
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("16")
    print("== 16. supervised crash recovery: faults, rollback, respawn, "
          "replay")
    rec = phase_recovery()
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("17")
    print("== 17. PSI entity resolution: every mode and backend, the pool, "
          "delta rounds, retries, into the split int8 fit")
    psi_out, psi_counts = phase_psi()
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("18")
    print("== 18. the rest of fit: wire latency and bandwidth, owners of "
          "unequal widths, checkpoints")
    fit_out, fit_counts_18 = phase_fit_options(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("20")
    print(f"== 20. LM training at full width ({LM}, the dense family): the "
          "attention Function, joint / split lossless / split int8 fits, "
          "process == queue, the launcher")
    lm_train = phase_lm_train(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("21")
    print(f"== 21. LM training at full width ({ZAMBA}, the SSM family): the "
          "scan Function, joint / split lossless / split int8 fits, "
          "process == queue, the launcher")
    zamba_train = phase_zamba_train(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("22")
    print(f"== 22. KV cache variants on {GEMMA}: served at full width and "
          "depth on ring caches, ring / swa_override / fp8 caches past the "
          "window, card vs CPU")
    gemma = phase_gemma()
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("23")
    print("== 23. the xLSTM and MoE families and the last two dense "
          f"configs: {XLSTM} served and trained at full width and depth; "
          f"{', '.join(DENSE_BIG + MOE_ARCHS)} at full width, cut depth")
    families = phase_families()
    print(f"  phase wall {time.time() - t:.2f} s")

    t = time.time()
    mark("24")
    print(f"== 24. the enc-dec and vision families: {WHISPER} served and "
          f"trained at full width and depth, {QWEN_VL} served at full "
          f"width, {V_LAYERS} layers (cross-attention and M-RoPE on the "
          "attention kernel), both reduced card vs CPU")
    modal = phase_enc_dec_vision(bw, flops)
    print(f"  phase wall {time.time() - t:.2f} s")

    mark("14")
    print("== 14. results")
    src = "src/repro_torch/csrc/quantize.cu"
    tpu = "src/repro/kernels/quantize/kernel.py"
    replaces = {"quantize_pack_int8": f"{tpu}:28",     # _quantize_pack_kernel
                "quantize_int8": f"{tpu}:19"}          # _quantize_kernel
    entries = []
    for kname, res in kern.items():
        row = next(r for r in res["rows"] if tuple(r["shape"]) == PATH_SHAPE
                   and r["dtype"] == "float32")
        entries.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname], "launches": counts[kname],
            "on_path": kname == "quantize_pack_int8",
            "max_abs_err": res["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "eager_ms": row["eager_ms"],
            "plain_eager_ms": row["plain_eager_ms"],
            "launch_floor_ms": row["floor_ms"],
            "path_cut": path_cut if kname == "quantize_pack_int8" else None,
            "masked_launches": priv["counts"][kname],
            "all_shapes": res["rows"]})
    # the attention kernel's three routes, each at its headline shape:
    # tc at llama's trunk prefill, decode at llama's trunk decode, and the
    # fma route (off the serving path) timed at the trunk prefill
    for aroute, shape, src in (
            ("tc", HEADLINE, "attention_prefill_sm90"),
            ("decode", "trunk_decode", "attention_decode"),
            ("fma", HEADLINE, "block_attention")):
        row = att["rows"][shape]
        key = f"block_attention.{aroute}"
        fma = aroute == "fma"
        entries.append({
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": "src/repro/kernels/block_attention/kernel.py:28",
            "launches": serving["counts"][key], "on_path": not fma,
            "max_abs_err": att["max_abs_err"][aroute],
            "ms": row["fma_ms" if fma else "ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": shape, "zamba2_launches": zamba["counts"][key],
            "eager_ms": None if fma else row["eager_ms"],
            "all_shapes": att["rows"] if aroute == "tc" else None})
    # the scan's two routes at zamba2's trunk prefill, timed in one call:
    # chunked (the serving path's) and serial (off the path)
    row = ssd["rows"]["trunk_prefill"]
    for sroute, src, key in (("chunked", "mamba2_scan_chunked", "ms"),
                             ("serial", "mamba2_scan", "serial_ms")):
        name_ = f"mamba2_scan.{sroute}"
        entries.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": "src/repro/kernels/mamba2_scan/kernel.py:25",
            "launches": zamba["counts"][name_],
            "on_path": sroute == "chunked",
            "max_abs_err": ssd["max_abs_err"][sroute],
            "tol_ratio": ssd["tol_ratio"], "ms": row[key],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": "trunk_prefill",
            "eager_ms": row["eager_ms"] if sroute == "chunked" else None,
            "all_shapes": ssd["rows"] if sroute == "chunked" else None})
    # cut fusion's two routes: fma (f32, the training path's) at the
    # batch, tc (bf16, off the path) at the benchmark shape
    for croute, shape in (("fma", "batch:float32"),
                          ("tc", "bench:bfloat16")):
        row = cut["rows"][shape]
        if row["route"] != croute:
            raise AssertionError(f"cut_fusion {shape}: route {row['route']}"
                                 f", expected {croute}")
        name_ = f"cut_fusion.{croute}"
        entries.append({
            "name": name_, "route": "cuda",
            "source": "src/repro_torch/csrc/cut_fusion.cu",
            "replaces": "src/repro/kernels/cut_fusion/kernel.py:30",
            "launches": counts[name_], "on_path": croute == "fma",
            "max_abs_err": cut["max_abs_err"][croute],
            "tol_ratio": cut["tol_ratio"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
            "eager_ms": row["eager_ms"],
            "masked_launches": priv["counts"][name_],
            "masked_shape": (cut["rows"]["masked:float32"]
                             if croute == "fma" else None),
            "all_shapes": cut["rows"] if croute == "fma" else None})
    entries[0]["serving_launches"] = \
        serving["counts"]["quantize_pack_int8"]
    entries[0]["zamba2_launches"] = zamba["counts"]["quantize_pack_int8"]
    # every kernel's launches in the queue crash run (replays and the
    # respawn's warmup included)
    crash_counts = rec["queue"]["crash"]["all_counts"]
    for e in entries:
        e["recovery_launches"] = crash_counts.get(e["name"], 0)
        # and in phase 17's split int8 fit on the hidden alignment
        e["psi_launches"] = psi_counts.get(e["name"], 0)
        # and over phase 18's fits and evaluations
        e["phase18_launches"] = fit_counts_18.get(e["name"], 0)
    # cut fusion at eight owners (phase 18), beside the path's P = 2
    next(e for e in entries if e["name"] == "cut_fusion.fma")["p8"] = \
        fit_out["cut_fusion_p8"]
    # the decode route with per-row lengths (phase 19(a)), launched on
    # every decode tick of the continuous engine
    pr = cont["per_row_kernel"]
    c_counts = cont["continuous_vs_wave"]["counts"]
    entries.append({
        "name": "block_attention.per_row", "route": "cuda",
        "source": "src/repro_torch/csrc/attention_decode.cu",
        "replaces": "src/repro/kernels/block_attention/kernel.py:28",
        "launches": c_counts["block_attention.per_row"], "on_path": True,
        "max_abs_err": pr["max_abs_err"], "ms": pr["ms"],
        "plain_ms": pr["plain_ms"], "bound_ms": pr["bound_ms"],
        "bound_by": pr["bound_by"], "library_ms": pr["library_ms"],
        "shape": pr["shape"], "kv_lens": pr["kv_lens"],
        "scalar_ms": pr["scalar_ms"], "eager_ms": pr["eager_ms"]})
    # every kernel's launches in phase 19(b)'s continuous run (llama) and
    # 19(i)'s (zamba2)
    z_counts = cont["zamba2"]["counts"]
    for e in entries:
        e["continuous_launches"] = c_counts.get(e["name"], 0)
        e["zamba2_continuous_launches"] = z_counts.get(e["name"], 0)
    # and over phase 20(b)'s three full-width fits (joint, split
    # lossless, split int8)
    for e in entries:
        e["lm_train_launches"] = sum(c.get(e["name"], 0) for c in
                                     lm_train["counts"].values())
        # and over phase 21(b)'s (zamba2-2.7b)
        e["zamba2_train_launches"] = sum(c.get(e["name"], 0) for c in
                                         zamba_train["counts"].values())
        # and in phase 22(a)'s gemma2-9b wave run (which puts the fma
        # route on a serving path)
        e["gemma2_launches"] = gemma["serving"]["counts"].get(e["name"], 0)
        e["on_path"] = e["on_path"] or e["gemma2_launches"] > 0
    # gemma2's attention at hd 256 (phase 6): the fma route's prefill,
    # the decode route's ring decode (bidir) and its per-row lengths
    for e in entries:
        shape = {"block_attention.fma": GEMMA_HEADLINE,
                 "block_attention.decode": "gemma2_trunk_decode_ring",
                 "block_attention.per_row": "gemma2_ring_per_row"}.get(
            e["name"])
        if shape is not None:
            e["gemma2"] = dict(att["rows"][shape], shape_name=shape)
    # and in phase 23's runs: every wave (xlstm-125m's, the dense and
    # MoE configs') and the fits of (b) and (d)
    for e in entries:
        e["families_launches"] = sum(
            families[k]["counts"].get(e["name"], 0) for k in
            DENSE_BIG + MOE_ARCHS) + \
            families["xlstm_serving"]["counts"].get(e["name"], 0) + sum(
            c.get(e["name"], 0) for k in ("xlstm_train", "moe_train")
            for c in families[k]["counts"].values())
    # and in phase 24's runs (whisper-tiny's wave and fit, qwen2-vl's
    # wave), with kernel 4's time at their calls on the entry of the
    # route each takes
    for e in entries:
        e["enc_dec_vision_launches"] = sum(
            modal[k]["counts"].get(e["name"], 0) for k in
            ("whisper_serving", "whisper_train", "vlm_serving"))
        if e["name"] in ("block_attention.tc", "block_attention.decode"):
            e["enc_dec_vision"] = {
                k: r for k, r in modal["attention_rows"].items()
                if f"block_attention.{r['route']}" == e["name"]}
    # and in phase 25's built steps ((a) ring and (b) fp8 long_500k
    # ticks, (c) the prefill, (d) the train steps), with kernel 4's time
    # at the long_500k decode calls on the decode entry
    for e in entries:
        e["steps_launches"] = sum(
            built[k]["counts"].get(e["name"], 0)
            for k in ("ring", "fp8", "prefill")) + sum(
            c.get(e["name"], 0) for c in built["train"]["counts"].values())
        if e["name"] == "block_attention.decode":
            e["long_500k"] = built["attention_rows"]
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"steps": {
        k: ({x: y for x, y in v.items() if x != "counts"}
            if isinstance(v, dict) else v) for k, v in built.items()}}))
    print(json.dumps({"enc_dec_vision": {
        k: ({x: y for x, y in v.items() if x != "counts"}
            if isinstance(v, dict) else v) for k, v in modal.items()}}))
    print(json.dumps({"families": {
        k: ({x: y for x, y in v.items() if x != "counts"}
            if isinstance(v, dict) else v) for k, v in families.items()}}))
    print(json.dumps({"gemma2": {k: v if k != "serving" else {
        x: y for x, y in v.items() if x != "counts"}
        for k, v in gemma.items()}}))
    print(json.dumps({"lm_train": {k: v for k, v in lm_train.items()
                                   if k != "counts"}}))
    print(json.dumps({"zamba2_train": {k: v for k, v in zamba_train.items()
                                       if k != "counts"}}))
    print(json.dumps({"serving_continuous": cont}))
    print(json.dumps({"privacy": {k: v for k, v in priv.items()
                                  if k != "counts"}}))
    print(json.dumps({"recovery": without(rec, "all_counts")}))
    print(json.dumps({"psi": psi_out}))
    print(json.dumps({"fit_options": fit_out}))
    mark(None)
    print(f"  seconds by phase: {phase_s}; total "
          f"{sum(phase_s.values()):.1f}")
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
