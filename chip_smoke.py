"""Drive the PyTorch port's Gather service, DAPC, Filter pushdown, tree collectives, yi-9b, rwkv6-1.6b and hymba-1.5b serving once on an NVIDIA card.

Usage: ``python3 chip_smoke.py [--profile DIR]`` from the root of
a checkout, on a host with one Hopper card (sm_90) and the CUDA toolkit.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every hand-written kernel from ``src/repro_torch/csrc``.
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   bit-exact, in f32, bf16 and i32 (the f32 rows' bit patterns, which the
   service's Gatherer looks up), at the service's shapes (K = 16 ids of one
   message, bucket x K ids of a batched dispatch, into one 524,288 x 128
   shard), 1, 31, 33 and 65,536 ids, on both ``embed_lookup`` routes
   (``bulk``, ``warp``), each line naming its route; rows of 6
   bytes, which must take ``warp``; and launch.serve's remote-embedding rows
   (each LM's d_model in f32) at 8 and 1,024 ids.
4. Service phase: ``EmbedShardService`` on an 8-server ``Cluster`` on the
   card, 4,194,304 x 128 f32 table (256 MiB per shard resident on the card;
   DLRM-DCNv2's embedding width, rows cut from its 40M-row tables), 1,024
   ragged requests through the per-message, batched and zero-copy gathers
   and ``gather_get``; every arm row-for-row bit-identical to the numpy
   oracle; kernel launch counts read around the whole phase.
5. DAPC phase: ``PointerChaseApp`` on another 8-server ``Cluster`` on the
   card over a 2**27-entry pointer chain (64 MiB of int32 per shard,
   resident on the card, larger than the 50 MB L2), 256 chases of depth 64
   (the traffic of ``BENCH_dapc.json``) through the bitcode per-message,
   bitcode batched, bitcode zero-copy (every 8-byte RETURN a one-sided
   write: ``DataPlaneConfig.zero_copy(eager_max=0)``, as in
   ``benchmarks/dapc.py``), binary batched and Active Message
   arms and the GBPC baseline; every arm equal to the numpy oracle, and
   ``chase_shard`` launches equal to the servers' Chaser dispatches (0 in
   ``am`` and ``gbpc``).  Before the arms, ``chase_shard`` is held against
   its plain version on one shard of that chain and on a cycle local to
   the shard, at 1, 8, 33, 256 and 65,536 chases, on both routes
   (``thread``, ``spread``).  The service and DAPC lines log the launches
   by route and the batched arms' mean ids and chases a launch.
6. Filter phase: ``FilterShardService`` on an 8-server ``Cluster`` on the
   card (``hetero_wire``) over the service phase's table, windows of 24
   rows (``BENCH_placement.json``'s), 256 windows (seed 1) at selectivities
   0.05, 0.25 and 0.75, each through pushdown per-message, batched and
   zero-copy (``DataPlaneConfig.zero_copy()``), ``filter_pull`` (no card)
   and ``placement="auto"``: every arm bit-identical to ``oracle_filter``,
   ``embed_lookup`` launched once per server Filter dispatch (0 for pull),
   the pushdown/pull payload-byte ratio rising with selectivity, and the
   optimizer's choice, ``pushdown_us`` and ``pull_us`` logged beside the
   winner scored from the run (``benchmarks/placement.py``'s arithmetic)
   and whether the two agree.  ``kernel embed_lookup ... filter`` lines in
   the kernel phase (3) hold the Filter's N = 24 and a 64-slot bucket of
   it on both routes.
7. Propagation phase: a 16-server ``Cluster`` on the card with
   ``BENCH_propagate.json``'s config (``thor_bf2``, binomial, k = 2, ttl
   16): ``xrdma_flat_push``, cold and warm ``xrdma_bcast`` of the TSI, each
   server's counter equal to its invokes, and client sends, publishes, hop
   frames and header and payload bytes equal to that JSON's; the warm arm
   moves no code; then a gossiper that publishes itself 16 hops around the
   17-PE ring, its visits and sums equal to numpy's.
8. Reduce phase: ``xrdma_reduce`` over the same 17 PEs of one 25 MiB i32
   vector each (6,553,600 values from seed 0 in [-2**20, 2**20), PyTorch
   DDP's default bucket), per-message and batched (the batched run folds
   arrived partials in one dispatch of the code cache's propagate fold):
   the result equal to the numpy sum, 16 FORWARDs.
9. Timing: the launch floor and the hop latency L (chase_shard's latency
   probe: one thread's dependent loads, 0 and 1,024 hops, __ldg and
   ld.global.cg in turns; L on the shard-sized cycle, from HBM and from L2);
   then ``embed_lookup`` at N = 16, the batched arm's mean N and 1,024 of
   512-byte rows and at launch.serve's remote embedding (N = 8 of each
   LM's d_model f32 rows), and ``chase_shard`` at B = 1, the batched arm's
   mean B and 256 on the chain and 256 on the cycle,
   each route in turns (A B B A, 5 rounds, median and spread;
   ``index_select`` in the same turns), with device ms per call (CUDA
   events around calls queued behind a sleep; torch.profiler for the plain
   versions, which wait for the card inside a call), back-to-back call ms,
   the bytes bound and the reachable bound (floor + the larger of bytes
   and the dependent loads' latency); and the host side of a per-message
   call against ``index_select``'s (call ms of each wrapper and of its
   custom op as a traced slice calls it, in turns, and a CPU trace of 200
   calls of each).
   After the LM phases, the launch-weighted gap of both kernels by shape,
   against both bounds.
10. Flash kernel phase: ``flash_attention`` against its plain version at
   yi-9b's prefill (S = T = 300, 1,000 and 2,048, and S = 256 over a
   1,024-token prefix of a 2,048-slot cache) and decode (B = 8, S = 1 on
   cache views of T = 1, 129, 777, 4,096) shapes and at the five shapes of
   the JAX kernel sweep, in f32 and bf16, within 2e-5 / 2e-2; each bf16
   call also against the plain version on f32 copies of its inputs, within
   atol 1e-4 and rtol 1e-2.  Each line names the route the call took: bf16
   prefill on the tensor cores (``wgmma``), bf16 decode split over keys
   (``split``), f32 on the CUDA-core kernel (``simt``).
11. Parity phase: a 2-layer yi-9b at full width in f32, one set of weights
   from seed 0, 128 prompt tokens and 8 teacher-forced decode steps on the
   card (kernel) and on the CPU (plain version): logits within 1e-3, equal
   greedy tokens.
12. Serving phase: yi-9b at full width and 16 of its 48 layers (bf16,
   random weights drawn on the card) behind ``ServeScheduler(slots=8,
   t_max=4096)``: 16 requests with prompts of 256-3,072 tokens, 32 new
   tokens each, every logit finite, ``flash_attention`` launched 16 x
   (prefills + decode groups) times, 16 x prefills on the ``wgmma`` route
   and 16 x decode groups on the ``split`` route; then a profiled decode
   burst and prefill (busy share, the kernel's share).
13. ``repro_torch.launch.serve --no-smoke --batch 4 --prompt-len 2048
   --gen 32`` at full yi-9b (48 layers), local and with ``--remote-embed
   --embed-servers 2``: the two token streams bit-identical,
   ``embed_lookup`` launched in the remote run.
14. Times ``flash_attention`` at the prefill (S = T = 2,048) and decode
   (B = 8, T = 2,048) shapes beside its plain version,
   ``scaled_dot_product_attention`` and its bound (operations or bytes),
   and logs each tensor-core and split instance's registers and spills
   from the build's ptxas report.
15. wkv6 kernel phase: ``wkv6`` against its plain version on both routes
   (``step``: one kernel walks T; ``split``: T cut into chunks run in
   parallel, their states carried) at rwkv6-1.6b's prefill (B = 1, T =
   2,048, H = 32, M = 64) and decode (B = 8, T = 1 from a state) shapes,
   launch.serve's B = 4, T = 2,048, the three shapes of the JAX wkv6
   sweep in f32 and bf16, a constant log-decay of -1 and -1.5 per step
   over T = 2,048 and over T = 777 from a state across chunk boundaries,
   T = 777 from a state on both routes and in chunks of 16, T a step
   either side of a chunk, and each chunk length the grid times: outputs
   within 2e-5 of the largest (bf16 also 2**-7 of each value), states
   within 2e-5 of the largest; each call counted on its route.
16. Times ``wkv6`` at the prefill (both routes in turns) and decode shapes
   beside its plain version and its bound (no PyTorch call computes WKV6),
   then the route grid: both routes and the split at chunks of 16-256
   over B 1 and 4 and T 128-3,072.
17. The parity phase again on a 2-layer rwkv6-1.6b at full width (d_model
   2,048, 32 WKV heads, d_ff 7,168, vocab 65,536).
18. The serving phase on rwkv6-1.6b at full width and 12 of its 24 layers
   (bf16): the same 16 requests, ``wkv6`` launched 12 x (prefills + decode
   groups) times, 12 x prefills on the ``split`` route and 12 x decode
   groups on ``step``, and its profiled decode burst and prefill (the
   split's three device kernels a launch, each kernel's time by name).
19. ``launch.serve`` at full rwkv6-1.6b, local and remote-embed: streams
   bit-identical, ``wkv6`` launched 24 x (1 + 32) times in each, the
   prefill's on ``split`` and the steps' on ``step``.
20. ssm_scan kernel phase: ``ssm_scan`` against its plain version on both
   routes at hymba-1.5b's prefill (B = 1, T = 2,048, D = 1,600, N = 16) and
   decode (B = 8, T = 1 from a state) shapes, T = 777 from a state and T a
   step either side of a chunk, in bf16 and f32; launch.serve's B = 4, T =
   2,048; N = 8 in chunks of 16; the three shapes of the JAX ssm_scan sweep
   in f32 and bf16; decays whose 32-step sum passes -60 over T = 2,048 and
   over T = 777 from a state across chunk boundaries; each chunk length the
   grid times: outputs within 2e-5 of the largest (bf16 also 2**-7 of each
   value), states within 2e-5 of the largest; each call counted on its
   route. The flash phase (10) also holds hymba's windowed shapes (25/5
   heads of 64, window 2,048: prefill S = T = 3,000, decode T = 2,049 and
   4,096, and a global decode case), and the flash timing (14) adds hymba's
   windowed prefill (S = T = 3,072) and decode (B = 8, T = 4,096).
21. Times ``ssm_scan`` at the prefill (both routes in turns) and decode
   shapes beside its plain version and its bound (no PyTorch call computes
   the selective scan), then its route grid as for ``wkv6``.
22. The parity phase on a 2-layer hymba-1.5b at full width (d_model 1,600,
   25/5 heads, d_ff 5,504, vocab 32,001; both layers windowed) with a
   2,064-token prompt, so the 2,048 window bites at prefill and decode.
23. The serving phase on full hymba-1.5b (32 layers, bf16): the same 16
   requests, ``flash_attention`` and ``ssm_scan`` each launched 32 x
   (prefills + decode groups) times (flash on the ``wgmma`` and ``split``
   routes as for yi, ``ssm_scan`` on ``split`` and ``step``), and its
   profiled decode burst and prefill with both kernels' shares. Each burst
   line also logs, per kernel, the kernels recorded in the window, those
   matched to a launch in it by correlation id, the wrapper's launches in
   it and the names matched (ROADMAP T12).
24. ``launch.serve`` at full hymba-1.5b, local and remote-embed: streams
   bit-identical, each kernel launched 32 x (1 + 32) times in each.

Prints one JSON line of kernel results, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` last.  Any failure exits non-zero with
no result.  ``--profile DIR`` also writes torch.profiler tables of a short
batched Gather burst, of the batched DAPC arm and of the yi-9b decode and
prefill bursts (``lm_*``; ``rwkv_*`` for rwkv6-1.6b, ``hymba_*`` for
hymba-1.5b) to ``DIR``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parent
WINDOW = "chip_smoke_window"  # profiled()'s record_function range
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
SHARD_ROWS, DIM, N_SERVERS, N_KEYS, MAX_SLOTS = 524_288, 128, 8, 16, 64
N_REQUESTS = 1024
# the Filter phase: BENCH_placement.json's window and selectivities over the
# service phase's table
FILTER_WINDOW, FILTER_REQUESTS, FILTER_SELECTIVITIES = 24, 256, (0.05, 0.25, 0.75)
GOSSIP_HOPS = 16  # the gossiper's hops around the propagation phase's ring
REDUCE_WIDTH = 6_553_600  # i32 a PE: 25 MiB, PyTorch DDP's default bucket_cap_mb
DAPC_ENTRIES, DAPC_CHASES, DAPC_DEPTH = 1 << 27, 256, 64
CHASE_SIZES = (1, 8, 33, 256, 65_536)
# embed_lookup's checked id counts: a message, either side of a bulk block,
# two batched buckets and a large call
EMBED_SIZES = {"one": 1, "message": N_KEYS, "block-1": 31, "block+1": 33,
               "bucket8": 8 * N_KEYS, "bucket64": MAX_SLOTS * N_KEYS, "large": 65_536,
               "filter": FILTER_WINDOW, "filter_bucket64": MAX_SLOTS * FILTER_WINDOW}
PROBE_HOPS = 1024  # the latency probe's long chain
REMOTE_KEYS = 8  # RemoteEmbedClient's ids a request (launch.serve --remote-embed)
HBM_CYCLE = 1 << 28  # entries of the probe's cycle that L2 cannot hold (1 GiB)
# the JAX flash sweep's shapes (tests/test_kernels.py): b, h, kh, s, t, d, bq, bk, causal, cap
SWEEP = [
    (2, 4, 2, 256, 256, 64, 128, 128, True, None),
    (1, 8, 8, 128, 128, 128, 128, 64, True, 50.0),
    (2, 4, 1, 256, 512, 32, 64, 256, False, None),
    (1, 2, 2, 512, 512, 64, 256, 128, True, None),
    (1, 6, 2, 128, 256, 64, 128, 128, True, 30.0),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX sweep's tolerances
# A bf16 call also against the plain version run on f32 copies of the same
# inputs (f32 probabilities): the two then differ by the kernel's bf16
# output rounding, at most 2**-8 of a value (rtol), and by its bf16
# probabilities (both bf16 routes round P to bf16 before the P V product,
# as the Pallas kernel does; the f32 route keeps P in f32): each weight off
# by up to 2**-9 of itself, ~2**-9 / sqrt(T) of an output, ~1e-5 at
# T = 4,096, with f32 summation order ~1e-6 (atol).  At T = 4,096 the
# outputs are ~0.026 (sqrt(e / T)), which 2e-2 does not resolve; a key tile
# skipped moves them by ~3e-3.
FLASH_F32P_ATOL, FLASH_F32P_RTOL = 1e-4, 1e-2
# f32 card vs CPU over 2 full-width layers: |logit| is O(1) and the two
# sides sum 4,096- and 11,008-long f32 products in different orders
PARITY_ATOL, PARITY_PROMPT, PARITY_STEPS = 1e-3, 128, 8
# hymba's parity prompt passes its 2,048-token window, so the window bites
# at prefill and at every decode step
PARITY_PROMPT_BY_ARCH = {"hymba-1.5b": 2064}
SERVE_SLOTS, SERVE_T_MAX, SERVE_REQUESTS, SERVE_NEW = 8, 4096, 16, 32
SERVE_PROMPT_MIN, SERVE_PROMPT_MAX = 256, 3072
# the earlier slices' scheduler phases run at a cut depth, so that the whole
# run stays near half its 1,200 s limit on a slow host; their launch.serve
# phases still run the full model
SERVE_LAYERS = {"yi-9b": 16, "rwkv6-1.6b": 12}
LAUNCH_BATCH, LAUNCH_PROMPT = 4, 2048  # launch.serve's batch and prompt length
# timed shapes (B, S, T) with yi's H=32, K=4, d=128 in bf16
FLASH_TIMING = {"prefill": (1, 2048, 2048), "decode": (8, 1, 2048)}
# hymba's attention: H=25 over K=5 heads of d=64, window 2,048 on 28 of 32
# layers; timed shapes (B, S, T) at its longest prompt and past the window
HYMBA_HEADS, HYMBA_WINDOW = (25, 5, 64), 2048
HYMBA_FLASH_TIMING = {"hymba_prefill": (1, 3072, 3072), "hymba_decode": (8, 1, 4096)}
# each LM arch's path kernels: (wrapper name, the CUDA symbol's stem), each
# launched once per layer per forward
PATH_KERNEL = {
    "yi-9b": (("flash_attention", "flash"),),
    "rwkv6-1.6b": (("wkv6", "wkv6"),),
    "hymba-1.5b": (("flash_attention", "flash"), ("ssm_scan", "ssm_scan")),
}
PROFILE_STEM = {"yi-9b": "lm", "rwkv6-1.6b": "rwkv", "hymba-1.5b": "hymba"}
# each path kernel's route at prefill and at decode on the serving path
PATH_ROUTES = {"flash_attention": ("wgmma", "split"), "wkv6": ("split", "step"),
               "ssm_scan": ("split", "step")}
F32_FLOPS = 67e12  # H100 SXM f32 peak outside the tensor cores, NVIDIA data sheet
# wkv6 against its plain version: both run the recurrence in f32 and sum
# each output's 64 products in other orders, and the state's rounding
# carries over the steps where the decay is weak; so f32 agrees within
# WKV_ATOL of the largest output (or 1).  bf16 outputs may round to the
# other neighbour: one bf16 step, 2**-7 of the value (WKV_BF16_RTOL).  The
# state is f32 in both dtypes.
WKV_ATOL, WKV_BF16_RTOL = 2e-5, 2.0**-7
# the JAX wkv6 sweep (tests/test_kernels.py): b, t, h, m
WKV_SWEEP = [(2, 128, 2, 64), (1, 256, 4, 64), (2, 64, 1, 128)]
# rwkv6-1.6b's WKV at the path's shapes: H = 32 heads of M = 64
WKV_H, WKV_M = 32, 64
# ssm_scan against its plain version: both run the recurrence in f32, the
# kernel fusing the step's product and sum and summing each y's N products
# in another order; so f32 agrees within SSM_ATOL of the largest output (or
# 1), bf16 outputs may also round to the other neighbour (SSM_BF16_RTOL),
# and states agree within SSM_ATOL of the largest
SSM_ATOL, SSM_BF16_RTOL = 2e-5, 2.0**-7
# the JAX ssm_scan sweep (tests/test_kernels.py): b, t, d, n
SSM_SWEEP = [(2, 128, 64, 16), (1, 64, 128, 8), (2, 96, 32, 16)]
# hymba-1.5b's SSM at the path's shapes: D = 1,600 channels of N = 16 states
SSM_D, SSM_N = 1600, 16
# device kernels one wrapper call records, by kernel and route (else 1): the
# recurrences' split route runs the local pass, the carry and the output pass
DEVICE_KERNELS = {"wkv6": {"split": 3}, "ssm_scan": {"split": 3}}
# the recurrences' route grid: both routes, the split at each chunk length,
# over these batch rows and steps (the scheduler's B = 1 prefills of 256-3,072
# tokens, launch.serve's B = 4 of 2,048, and T either side of the threshold)
SPLIT_CHUNKS = (16, 32, 64, 128, 256)
SPLIT_GRID_B, SPLIT_GRID_T = (1, 4), (128, 192, 256, 384, 512, 1024, 2048, 3072)


def log(*args) -> None:
    print(*args, flush=True)


def line_prefix(arch: str) -> str:
    """The rwkv phases' lines name their arch; yi's keep their PR 14 text."""
    return "" if arch == "yi-9b" else f"{arch} "


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def profiled(fn, tries: int = 3, edge=None):
    """Runs ``fn`` under torch.profiler, with a run of ``edge`` (default
    ``fn``) before and one after it in the same trace, and keeps the events
    of the middle run (a ``record_function`` window): the profiler can lose
    a few kernels of a trace, for any launch path (ROADMAP T8), and loses
    more of a longer one.  Tries until the window holds a kernel for every
    kernel launch the host made in it.  Returns ``(prof, window_events,
    wall_s, whole)``; ``whole`` is False if no try of ``tries`` was whole."""
    edge = edge or fn
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            edge()
            torch.cuda.synchronize()
            with record_function(WINDOW):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            edge()
            torch.cuda.synchronize()
        events = prof.events()
        mark = next(e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU)
        window = [e for e in events
                  if mark.time_range.start <= e.time_range.start <= mark.time_range.end]
        kernels = sum(1 for e in window if e.device_type == DeviceType.CUDA
                      and e.name != WINDOW and not e.name.startswith("Mem"))
        launches = sum(1 for e in window
                       if e.device_type == DeviceType.CPU and e.name in LAUNCH_APIS)
        if kernels >= launches > 0:
            return prof, window, wall, True
        log(f"profiled: {kernels} kernels recorded for {launches} launches; again")
    return prof, window, wall, False


def device_ms(fn, arg_sets, reps: int = 10) -> float:
    """Device time per call: the summed duration of every kernel and copy
    the calls put on the card (torch.profiler, :func:`profiled`), over
    ``reps`` calls cycling through ``arg_sets``, after warm-up; host time
    between launches is not counted.  For a function that waits for the
    card inside a call, which :func:`event_ms` cannot time.  Raises unless
    one of ten tries gives a whole profile (ROADMAP T8: three tries in a
    row have lost kernels of 50 plain chase calls, 2,673 kernels; a shorter
    window loses fewer and parses faster)."""
    for args in arg_sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    _, window, _, whole = profiled(
        lambda: [fn(*arg_sets[i % len(arg_sets)]) for i in range(reps)], tries=10)
    if not whole:
        raise RuntimeError(f"device_ms: no whole profile of {getattr(fn, '__name__', fn)}")
    return device_us(window) / 1e3 / reps


def device_us(events) -> float:
    """Summed device time of the kernels and copies among ``events``; the
    device-side span of :func:`profiled`'s window annotation is no work."""
    return sum(e.device_time_total for e in events
               if e.device_type == DeviceType.CUDA and e.name != WINDOW)


def event_ms(fn, arg_sets, reps: int = 100) -> float:
    """Device time per call of ``reps`` calls cycling through ``arg_sets``
    (distinct inputs, so rows come from HBM, not L2), queued behind a sleep
    kernel (``torch.cuda._sleep``), from one pair of CUDA events around
    them, after warm-up.  The card is still asleep when the host has queued
    the last call (checked; the sleep doubles until it is), so the card
    runs the calls back to back and no host time between launches is
    counted; the short gaps between the calls' kernels are.  Keep
    ``reps`` x kernels per call to a few hundred, inside the stream's
    launch queue."""
    for args in arg_sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    cycles = 1 << 24  # ~8 ms at the H100's 1.98 GHz boost clock
    for _ in range(8):
        awake, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(cycles)
        awake.record()
        start.record()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        queued_in_time = not awake.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"event_ms: the host could not queue {reps} calls of "
                       f"{getattr(fn, '__name__', fn)} inside the sleep")


def call_ms(fn, arg_sets, reps: int = 200) -> float:
    """Wall time per call of back-to-back calls (CUDA events, no sleep
    ahead): the rate the host can issue them, which bounds a launch-sized
    kernel."""
    for args in arg_sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(fns: dict, arg_sets, reps: int, rounds: int) -> dict[str, dict]:
    """Device ms per call of each of ``fns`` (:func:`event_ms`), timed in
    turns in one process: each round runs them in order and then in
    reverse (A B B A), so drift over the run falls on all alike.  Returns
    each one's median, spread (min, max) and every time."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in [*fns, *reversed(fns)]:
            times[name].append(event_ms(fns[name], arg_sets, reps))
    return {name: {"median": float(np.median(ts)), "min": min(ts), "max": max(ts), "ms": ts}
            for name, ts in times.items()}


def edge_ids(rng, n: int, lo: int, v_loc: int, dev) -> torch.Tensor:
    """Mostly in-shard ids, plus ids below and above the shard and -1 pads."""
    ids = rng.integers(lo, lo + v_loc, n)
    pick = rng.random(n)
    ids[pick < 0.05] = rng.integers(0, max(lo, 1), int((pick < 0.05).sum()))
    above = (pick >= 0.05) & (pick < 0.10)
    ids[above] = rng.integers(lo + v_loc, lo + 2 * v_loc, int(above.sum()))
    ids[pick >= 0.97] = -1
    edges = [-1, lo - 1, lo + v_loc, lo][:n]  # the boundaries, always
    ids[:len(edges)] = edges
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def kernel_phase(dev, rng) -> dict:
    """embed_lookup on the card against its plain version, bit-exact, on
    each route that takes the rows; a 6-byte row must take ``warp``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_ref, embed_route
    from repro_torch.kernels.embed_lookup.kernel import ROUTES

    lo = 3 * SHARD_ROWS
    lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
    worst = 0.0

    def check(table, ids, route, what, lo_t=lo_t):
        nonlocal worst
        before = embed_lookup.route_launches[route]
        got = embed_lookup(table, ids, lo_t, route=route)
        want = embed_lookup_ref(table, ids, lo_t)
        torch.cuda.synchronize()
        if embed_lookup.route_launches[route] != before + 1:
            raise AssertionError(f"embed_lookup {what}: not counted on {route}")
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"embed_lookup differs from plain ({what}, {route})")
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        log(f"kernel embed_lookup {what} ({route}): bit-exact, max_abs_err={err}")

    f32 = torch.randn(SHARD_ROWS, DIM, generator=torch.Generator(dev).manual_seed(1),
                      device=dev)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        table = f32.view(torch.int32) if dtype == torch.int32 else f32.to(dtype)
        for label, n in EMBED_SIZES.items():
            ids = edge_ids(rng, n, lo, SHARD_ROWS, dev)
            for route in ROUTES:
                check(table, ids, route, f"{str(dtype)[6:]} {label} n={n}")
    del table, f32
    # a 6-byte row (bf16, D = 3): only the warp route takes it
    narrow = torch.randn(SHARD_ROWS, 3, device=dev).to(torch.bfloat16)
    if embed_route(N_KEYS, 6, narrow.data_ptr() % 16 == 0) != "warp":
        raise AssertionError("a 6-byte row must take the warp route")
    check(narrow, edge_ids(rng, 1024, lo, SHARD_ROWS, dev), "warp", "bf16 6-byte rows n=1024")
    del narrow
    # launch.serve's remote embedding: each LM's d_model f32 rows
    wide_lo = 3 * 8192
    wide_lo_t = torch.tensor([wide_lo], dtype=torch.int32, device=dev)
    for arch in PATH_KERNEL:
        dim = get_config(arch).d_model
        wide = torch.randn(8192, dim, device=dev)
        for n in (REMOTE_KEYS, 1024):
            ids = edge_ids(rng, n, wide_lo, 8192, dev)
            for route in ROUTES:
                check(wide, ids, route, f"float32 remote {arch} rows of {4 * dim} B n={n}",
                      wide_lo_t)
        del wide
    torch.cuda.empty_cache()
    return {"max_abs_err": worst}


def reachable_bound(floor_ms: float, bytes_ms: float, chains, least_ms: float, what: str):
    """The least time a launch can take: the launch floor plus the larger
    of the bytes' time and the dependent loads' latency.  ``chains`` are
    counts of that latency in ms, the truest first; a count whose bound
    lies above ``least_ms`` (a time some design measured) is wrong, and is
    logged and passed over for the next.  Returns ``(bound_ms, count)``."""
    for label, chain_ms in chains:
        bound = floor_ms + max(bytes_ms, chain_ms)
        if bound <= least_ms:
            return bound, label
        log(f"bound {what}: {label} gives {bound} ms, above a measured {least_ms} ms: "
            f"wrong, not used")
    raise AssertionError(f"bound {what}: the launch floor {floor_ms} ms alone lies above "
                         f"a measured {least_ms} ms")


def time_floor(dev, rng, tables) -> dict:
    """The launch floor and one load's latency, from chase_shard's latency
    probe: one thread's dependent loads through a cycle, each call from a
    fresh random start (so no call finds its chain in L2 from an earlier
    one), __ldg and ld.global.cg in turns.  t(0 hops) is the floor; (t(1,024)
    - t(0)) / 1,024 the latency of a load: on the 2**24-entry cycle (the
    DAPC shard's size; L, which the bounds use), on a 2**28-entry cycle
    made on the card (1 GiB, 20x the L2: nearly every load from HBM) and on
    a 2**20-entry one (4 MiB, L2-resident)."""
    from repro_torch.core import make_chain
    from repro_torch.kernels.chase.kernel import latency_probe

    shard = tables["cycle"][0]
    n_big = HBM_CYCLE
    perm = torch.randperm(n_big, device=dev, generator=torch.Generator(dev).manual_seed(3))
    big = torch.empty(n_big, dtype=torch.int32, device=dev)
    big[perm] = perm.roll(-1).to(torch.int32)
    del perm
    small = torch.from_numpy(make_chain(1 << 20, seed=2)).to(dev)
    out = {}
    for label, table, hops, reps in (("t0", shard, 0, 100), ("shard", shard, PROBE_HOPS, 10),
                                     ("hbm", big, PROBE_HOPS, 10),
                                     ("l2", small, PROBE_HOPS, 10)):
        starts = iter(rng.integers(0, table.shape[0], 200 * (reps + 4)).tolist())
        out[label] = ab_ms({
            "ldg": lambda t=table, h=hops, it=starts: latency_probe(t, next(it), h, False),
            "cg": lambda t=table, h=hops, it=starts: latency_probe(t, next(it), h, True),
        }, [()], reps, 5)
    floor = min(out["t0"][k]["median"] for k in ("ldg", "cg"))
    levels = ("shard", "hbm", "l2")
    lat = {lvl: {k: (out[lvl][k]["median"] - out["t0"][k]["median"]) / PROBE_HOPS * 1e3
                 for k in ("ldg", "cg")} for lvl in levels}
    apart = {lvl: out[lvl]["ldg"]["min"] > out[lvl]["cg"]["max"]
             or out[lvl]["cg"]["min"] > out[lvl]["ldg"]["max"] for lvl in levels}
    res = {
        "floor_ms": floor,
        "latency_us": lat,  # by table and load flavour
        "flavours_apart": apart,  # the two flavours' spreads do not touch
        "hop_us": min(lat["shard"].values()),  # L: the faster flavour on the shard's cycle
        "hbm_us": min(lat["hbm"].values()),
        "l2_us": min(lat["l2"].values()),
        "faster": {lvl: min(lat[lvl], key=lat[lvl].get) for lvl in levels},
    }
    log(f"timing launch floor and hop latency ({PROBE_HOPS} hops from fresh starts, __ldg "
        f"and ld.global.cg in turns, 5 rounds A B B A): floor {floor} ms, L {res['hop_us']} "
        f"us on the 2**24 cycle, {res['hbm_us']} us on 1 GiB, {res['l2_us']} us from L2; "
        f"{json.dumps(res)}; probe times {json.dumps(out)}")
    del big, small
    torch.cuda.empty_cache()
    return res


def launch_gap(shapes: dict, launches: dict, key: str) -> float:
    """Seconds over the bound ``key`` of the path's launches: launches x
    (time - bound), summed over the shapes they come in."""
    return sum(n * (shapes[s]["ms"] - shapes[s][key]) / 1e3 for s, n in launches.items())


def time_kernel(dev, rng, floor: dict, mean_n: float) -> dict:
    """Times at the shapes the path's launches come in: the Gather
    service's N = 16 ids (a message), its batched arm's mean N and N =
    1,024 (the largest bucket), into one f32 shard of 512-byte rows; and
    launch.serve's remote embedding, N = 8 ids (RemoteEmbedClient's
    n_keys) of each LM's d_model f32 rows.  Each table holds 256 MiB and
    each shape has 128 distinct id sets, so the rows are cold in L2.  Each
    route and index_select (on the in-shard ids only: its yardstick) in
    turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_ref, embed_route
    from repro_torch.kernels.embed_lookup.kernel import ROUTES

    library = lambda t, i: torch.index_select(t, 0, i)  # yardstick, unused by the port
    saved = embed_lookup.launches, dict(embed_lookup.route_launches), embed_lookup.items
    timed = [("message", N_KEYS, DIM), ("mean", max(1, round(mean_n)), DIM),
             ("bucket64", MAX_SLOTS * N_KEYS, DIM)]
    timed += [(f"remote {arch}", REMOTE_KEYS, get_config(arch).d_model) for arch in PATH_KERNEL]
    shapes, table = {}, None
    for label, n, dim in timed:
        rows_n = SHARD_ROWS * DIM // dim  # 256 MiB of f32 rows
        lo = 3 * rows_n
        if table is None or table.shape[1] != dim:
            del table
            table = torch.randn(rows_n, dim, device=dev)
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        row = dim * table.element_size()
        sets = [edge_ids(rng, n, lo, rows_n, dev) for _ in range(128)]
        args = [(table, ids, lo_t) for ids in sets]
        inside = [(ids.long() - lo >= 0) & (ids.long() - lo < rows_n) for ids in sets]
        lib_args = [(table, (ids.long() - lo)[m].contiguous()) for ids, m in zip(sets, inside)]
        n_in = sum(int(m.sum()) for m in inside) / len(sets)
        moved = n * 4 + n_in * row + n * row  # ids read, in-shard rows read, rows written
        fns = {r: (lambda i, r=r: embed_lookup(*args[i], route=r)) for r in ROUTES}
        fns["index_select"] = lambda i: library(*lib_args[i])
        ab = ab_ms(fns, [(i,) for i in range(len(args))], 100, 5)
        route = embed_route(n, row, True)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        hop, l2 = floor["hop_us"] / 1e3, floor["l2_us"] / 1e3
        least = min(v["median"] for v in ab.values())
        reach, count = reachable_bound(floor["floor_ms"], bytes_ms, (
            ("id and row at L", 2 * hop), ("id from L2, row at L", l2 + hop),
            ("id and row from L2", 2 * l2), ("no load latency", 0.0)), least,
            f"embed_lookup {label} n={n}")
        calls = {r: call_ms(lambda *a, r=r: embed_lookup(*a, route=r), args) for r in ROUTES}
        calls["path"] = call_ms(embed_lookup, args)  # the wrapper on its default route
        calls["index_select"] = call_ms(library, lib_args)
        shapes[label] = {
            "n": n, "row_bytes": row, "route": route, "ms": ab[route]["median"],
            "route_ms": {r: ab[r]["median"] for r in ROUTES},
            "plain_ms": device_ms(embed_lookup_ref, args),  # waits for a host-to-card copy
            "library_ms": ab["index_select"]["median"],
            "bound_ms": bytes_ms, "bound_by": "bytes",
            "reachable_bound_ms": reach, "reachable_count": count,
            "call_ms": calls[route], "calls_ms": calls,
            "half_of_reachable": reach >= 0.5 * ab[route]["median"],
        }
        log(f"timing embed_lookup {label} n={n} f32 rows of {row} B ({route}), {moved:.0f} B "
            f"moved: {json.dumps(shapes[label])}; in turns (A B B A, 5 rounds): "
            f"{json.dumps(ab)}")
    del table
    torch.cuda.empty_cache()
    embed_lookup.launches, embed_lookup.route_launches, embed_lookup.items = saved
    return shapes


def service_phase(dev, n_requests: int, profile_dir: str | None) -> dict:
    from repro_torch.core import Cluster, DataPlaneConfig
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.runtime import EmbedShardService, ragged_batches

    vocab = SHARD_ROWS * N_SERVERS
    t0 = time.perf_counter()
    table = np.random.default_rng(0).standard_normal((vocab, DIM), dtype=np.float32)
    cluster = Cluster(n_servers=N_SERVERS, wire="thor_xeon", device=dev)
    svc = EmbedShardService(cluster, vocab=vocab, dim=DIM, n_keys=N_KEYS,
                            max_slots=MAX_SLOTS, table=table)
    reqs = ragged_batches(vocab, n_requests, N_KEYS, seed=1)
    oracle = svc.oracle(reqs)
    log(f"service: {N_SERVERS} servers on {dev}, table {vocab}x{DIM} f32, "
        f"{len(reqs)} requests, set-up {time.perf_counter() - t0:.2f} s, gatherer "
        f"archive {cluster.toolchain.lookup('gatherer').fat.nbytes} B")

    def server_invokes() -> int:
        return sum(pe.stats.invokes for pe in cluster.servers)

    arms = {
        "per_message": dict(batching=False),
        "batched": dict(batching=True),
        "zerocopy": dict(batching=True, dataplane=DataPlaneConfig(zerocopy=True)),
    }
    from repro_torch.kernels.embed_lookup import embed_lookup

    reset_launches()  # the main path's launches are counted from here
    per_arm = {}
    for name, kw in arms.items():
        launches0, inv0 = launch_counts()["embed_lookup"], server_invokes()
        items0 = embed_lookup.items
        t = time.perf_counter()
        rep = svc.gather(reqs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for i, (got, want) in enumerate(zip(rep.results, oracle)):
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                raise AssertionError(f"{name}: request {i} differs from the oracle")
        launches = launch_counts()["embed_lookup"] - launches0
        dispatches = server_invokes() - inv0
        if launches == 0 or launches != dispatches:
            raise AssertionError(
                f"{name}: {launches} kernel launches for {dispatches} server dispatches"
            )
        per_arm[name] = dict(
            wall_s=wall, invokes=rep.invokes, server_dispatches=dispatches,
            kernel_launches=launches, ids_per_launch=(embed_lookup.items - items0) / launches,
            puts=rep.puts, coalesced_frames=rep.coalesced_frames,
            region_puts=rep.region_puts, rounds=rep.rounds, modeled_us=rep.modeled_us,
        )
        log(f"arm {name}: oracle-identical, {json.dumps(per_arm[name])}")
    t = time.perf_counter()
    rep = svc.gather_get(reqs)
    for i, (got, want) in enumerate(zip(rep.results, oracle)):
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"gather_get: request {i} differs from the oracle")
    log(f"arm gather_get: oracle-identical, gets={rep.gets}, "
        f"wall_s={time.perf_counter() - t:.3f}")
    launches = launch_counts()
    for pe in cluster.servers:
        triple = pe.target_cache.lookup("gatherer").extras["triple"]
        if triple != "cuda-sm90":
            raise AssertionError(f"{pe.name} installed the {triple} slice")
    routes = dict(embed_lookup.route_launches)
    mean_n = per_arm["batched"]["ids_per_launch"]
    log(f"installed gatherer slice: cuda-sm90 on all {N_SERVERS} servers; "
        f"main-path launches {launches}, embed_lookup by route {routes}; batched arm's "
        f"mean N {mean_n} ids a launch")
    if profile_dir:
        profile_burst(svc, reqs[:256], Path(profile_dir))
    return {"launches": launches, "routes": routes, "arms": per_arm, "mean_n": mean_n,
            "table": table}


def placement_scored(rep, arm: str, caps: dict, n: int, operand_bytes: int) -> float:
    """A copy of ``benchmarks/placement.py``'s ``_scored``: an arm's modeled
    wire time plus the per-message overheads and the scan the fabric does
    not meter.  n request PUTs by the client and n ragged RETURN PUTs by the
    servers (pushdown), n range GETs (pull)."""
    client, server = caps["client"], caps["server0"]
    if arm == "pushdown":
        return (
            rep.modeled_us
            + n * (client.o_us + server.o_us)
            + n * operand_bytes / server.scan_Bus
        )
    return rep.modeled_us + n * operand_bytes / client.scan_Bus


def filter_phase(dev, table: np.ndarray) -> dict:
    """FilterShardService over the service phase's table on an 8-server
    cluster on the card: every arm bit-identical to ``oracle_filter``,
    ``embed_lookup`` launched once per server Filter dispatch, and the
    placement optimizer's choice beside the winner scored from the run."""
    from repro_torch.core import Cluster, DataPlaneConfig
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.embed_lookup import embed_lookup
    from repro_torch.runtime import FilterShardService
    from repro_torch.sharding import PlacementOptimizer

    vocab = SHARD_ROWS * N_SERVERS
    t0 = time.perf_counter()
    cluster = Cluster(n_servers=N_SERVERS, wire="thor_xeon", hetero_wire=True, device=dev)
    svc = FilterShardService(cluster, vocab=vocab, dim=DIM, window=FILTER_WINDOW,
                             max_slots=MAX_SLOTS, table=table)
    opt = PlacementOptimizer(cluster)
    caps = cluster.capabilities()
    los = svc.windows(FILTER_REQUESTS, seed=1)
    n, operand = len(los), FILTER_WINDOW * DIM * 4
    # first contact ships the code (benchmarks/placement.py warms with its
    # first 8 windows); one window a server keeps code out of every arm
    svc.filter([s * svc.rows_per_shard for s in range(N_SERVERS)], 0.0, placement="pushdown")
    log(f"filter: {N_SERVERS} servers on {dev}, table {vocab}x{DIM} f32, window "
        f"{FILTER_WINDOW}, {n} windows, set-up {time.perf_counter() - t0:.2f} s, filter "
        f"archive {cluster.toolchain.lookup('filter').fat.nbytes} B, capabilities "
        f"client {caps['client'].isa}/{caps['client'].wire}/{caps['client'].mem_bw_class}, "
        f"servers {caps['server0'].isa}/{caps['server0'].wire}/{caps['server0'].mem_bw_class}")

    def server_invokes() -> int:
        return sum(pe.stats.invokes for pe in cluster.servers)

    arms = {
        "per_message": dict(placement="pushdown"),
        "batched": dict(placement="pushdown", batching=True),
        "zerocopy": dict(placement="pushdown", batching=True,
                         dataplane=DataPlaneConfig.zero_copy()),
        "pull": dict(placement="pull"),
        "auto": dict(placement="auto", batching=True),
    }
    t_phase = time.perf_counter()
    reset_launches()  # the Filter path's launches are counted from here
    inv_phase = server_invokes()
    cells, ratios = [], []
    for sel in FILTER_SELECTIVITIES:
        thresh = svc.thresh_for_selectivity(sel)
        want = svc.oracle_filter(los, thresh)
        per_arm, reps = {}, {}
        for name, kw in arms.items():
            launches0, inv0 = launch_counts()["embed_lookup"], server_invokes()
            t = time.perf_counter()
            rep = reps[name] = svc.filter(los, thresh, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            for i, (got, w) in enumerate(zip(rep.results, want)):
                if not np.array_equal(got.view(np.int32), w.view(np.int32)):
                    raise AssertionError(f"filter {sel} {name}: window {i} differs from the oracle")
            launches = launch_counts()["embed_lookup"] - launches0
            dispatches = server_invokes() - inv0
            pushed = rep.gets == 0
            if launches != dispatches or pushed != (launches > 0):
                raise AssertionError(f"filter {sel} {name}: {launches} kernel launches for "
                                     f"{dispatches} server dispatches, {rep.gets} GETs")
            per_arm[name] = dict(
                wall_s=wall, server_dispatches=dispatches, kernel_launches=launches,
                puts=rep.puts, gets=rep.gets, region_puts=rep.region_puts,
                wire_bytes_by_kind=rep.wire_bytes_by_kind, modeled_us=rep.modeled_us,
            )
        push, pull = reps["per_message"], reps["pull"]
        if push.puts != 2 * n:
            raise AssertionError(f"filter {sel}: {push.puts} PUTs for {n} windows")
        # benchmarks/placement.py's payload bytes: the frames' fixed bytes off
        payload_push = (push.put_bytes - n * (72 + len(svc.op_name))
                        - n * (72 + len(svc.return_name)))
        ratio = payload_push / pull.get_bytes
        scored = {arm: placement_scored(rep, arm, caps, n, operand)
                  for arm, rep in (("pushdown", push), ("pull", pull))}
        winner = "pushdown" if scored["pushdown"] < scored["pull"] else "pull"
        decision = svc.plan_with(opt, los)
        auto_route = "pull" if per_arm["auto"]["gets"] else "pushdown"
        if auto_route != decision.choice:
            raise AssertionError(f"filter {sel}: auto took {auto_route}, the plan "
                                 f"{decision.choice}")
        cell = dict(selectivity=sel, thresh=float(thresh), arms=per_arm,
                    payload_bytes_pushdown=int(payload_push),
                    payload_bytes_pull=int(pull.get_bytes), payload_ratio=ratio,
                    scored_us=scored, scored_winner=winner,
                    optimizer=dict(choice=decision.choice, pushdown_us=decision.pushdown_us,
                                   pull_us=decision.pull_us),
                    optimizer_agrees=decision.choice == winner)
        for name, arm in per_arm.items():
            log(f"filter sel={sel} arm {name}: oracle-identical, {json.dumps(arm)}")
        log(f"filter sel={sel}: payload ratio pushdown/pull {ratio} ({payload_push} / "
            f"{pull.get_bytes} B); optimizer {json.dumps(cell['optimizer'])}; scored "
            f"{json.dumps(scored)} -> {winner}; agree {cell['optimizer_agrees']}")
        cells.append(cell)
        ratios.append(ratio)
    if ratios != sorted(ratios) or len(set(ratios)) != len(ratios):
        raise AssertionError(f"filter payload ratios do not rise with selectivity: {ratios}")
    launches = launch_counts()["embed_lookup"]
    dispatches = server_invokes() - inv_phase
    if launches == 0 or launches != dispatches:
        raise AssertionError(f"filter: {launches} embed_lookup launches for {dispatches} "
                             f"server Filter dispatches")
    for pe in cluster.servers:
        triple = pe.target_cache.lookup("filter").extras["triple"]
        if triple != "cuda-sm90":
            raise AssertionError(f"{pe.name} installed the {triple} filter slice")
    routes = dict(embed_lookup.route_launches)
    wall = time.perf_counter() - t_phase
    log(f"filter phase: {launches} embed_lookup launches = {dispatches} server Filter "
        f"dispatches, by route {routes}; optimizer agrees with the scored winner in "
        f"{sum(c['optimizer_agrees'] for c in cells)} of {len(cells)} cells; wall_s={wall}")
    return {"launches": launches, "routes": routes, "cells": cells, "wall_s": wall}


def propagation_phase(dev):
    """BENCH_propagate.json's multicast on a 16-server cluster on the card:
    flat push, cold tree and warm tree of the TSI, every counter and the
    header and payload bytes equal to that JSON's; then a gossiper that
    publishes itself around the ring.  Returns the tree arm's cluster."""
    from repro_torch.core import Cluster, PropagationConfig, make_gossiper, make_tsi
    from repro_torch.sharding import xrdma_bcast, xrdma_flat_push

    ref = json.loads((ROOT / "BENCH_propagate.json").read_text())
    c = ref["config"]
    cfg = PropagationConfig(topology=c["topology"], k=c["k"], ttl=c["ttl"])
    t_phase = time.perf_counter()
    tsi, value = make_tsi(), 7
    payload = np.array([value], np.int32)

    def fresh():
        cl = Cluster(n_servers=c["n_servers"], wire=c["profile"], device=dev)
        for pe in cl.servers:
            pe.register_region("counter", np.zeros(1, np.int32))
        cl.toolchain.publish(tsi)
        return cl

    def check(name, cl, rep, times):
        for pe in cl.servers:
            got, invokes = int(pe.region("counter")[0]), pe.stats.invokes
            if got != value * invokes or invokes != times:
                raise AssertionError(f"propagation {name}: {pe.name} counter {got} "
                                     f"after {invokes} invokes")
        want = ref[name]
        got = dict(client_sends=rep.client_sends, client_code_sends=rep.client_code_sends,
                   publishes=rep.publishes, hop_frames=rep.hop_frames, covered=rep.covered,
                   n_targets=rep.n_targets,
                   header=rep.wire_bytes_by_kind.get("header", 0),
                   payload=rep.wire_bytes_by_kind.get("payload", 0))
        for key, v in got.items():
            w = want["wire_bytes_by_kind"][key] if key in ("header", "payload") else want[key]
            if v != w:
                raise AssertionError(f"propagation {name}: {key} {v}, BENCH_propagate.json {w}")
        logged = dict(got, code=rep.wire_bytes_by_kind.get("code", 0),
                      modeled_completion_us=rep.modeled_completion_us, rounds=rep.rounds)
        log(f"propagation arm {name}: counters and BENCH_propagate.json's counts equal, "
            f"{json.dumps(logged)}")
        return got

    cl_flat = fresh()
    flat = check("flat", cl_flat, xrdma_flat_push(cl_flat, "tsi", payload), 1)
    del cl_flat
    cl = fresh()
    tree = check("tree", cl, xrdma_bcast(cl, "tsi", payload, config=cfg), 1)
    rep = xrdma_bcast(cl, "tsi", payload, config=cfg)
    warm = check("warm", cl, rep, 2)
    if rep.wire_bytes_by_kind.get("code", 0) != 0:
        raise AssertionError("propagation warm: code bytes moved")
    # the gossiper: one send, then the code publishes itself hop by hop
    peers = cl.pes()
    for i, pe in enumerate(peers):
        pe.register_region("gossip_log", np.zeros(2, np.int32))
        pe.register_cap("gossip_meta", np.array([i, len(peers)], np.int32))
    cl.toolchain.publish(make_gossiper())
    publishes0 = sum(pe.stats.publishes for pe in peers)
    gossip_value = 5
    cl.client.send_ifunc("server0", "gossiper", np.array([GOSSIP_HOPS, gossip_value], np.int32))
    cl.drain()
    want = np.zeros((len(peers), 2), np.int64)
    for hop in range(GOSSIP_HOPS + 1):  # arrivals at 0, 1, ... around the ring
        want[hop % len(peers)] += (1, gossip_value)
    got = np.array([pe.region("gossip_log") for pe in peers], np.int64)
    if not np.array_equal(got, want):
        raise AssertionError(f"gossiper logs {got.tolist()}, numpy {want.tolist()}")
    publishes = sum(pe.stats.publishes for pe in peers) - publishes0
    if publishes != GOSSIP_HOPS:
        raise AssertionError(f"gossiper: {publishes} self-publishes for {GOSSIP_HOPS} hops")
    wall = time.perf_counter() - t_phase
    log(f"propagation gossiper: {GOSSIP_HOPS} hops around {len(peers)} PEs, visits and "
        f"sums equal numpy, {publishes} self-publishes; propagation phase wall_s={wall}")
    return cl, {"flat": flat, "tree": tree, "warm": warm, "wall_s": wall}


def reduce_phase(cl) -> dict:
    """``xrdma_reduce`` of one 25 MiB i32 vector a PE (PyTorch DDP's default
    bucket) over the propagation phase's 17 PEs, per-message and batched
    (the batched run folds arrived partials in one dispatch): the result
    equal to the numpy sum, 16 upward FORWARDs."""
    from repro_torch.core import PropagationConfig
    from repro_torch.sharding import xrdma_reduce

    ref = json.loads((ROOT / "BENCH_propagate.json").read_text())["config"]
    cfg = PropagationConfig(topology=ref["topology"], k=ref["k"], ttl=ref["ttl"])
    n = cl.n_servers + 1
    t = time.perf_counter()
    vals = np.random.default_rng(0).integers(-2**20, 2**20, (n, REDUCE_WIDTH), dtype=np.int32)
    want = vals.sum(axis=0, dtype=np.int32)
    log(f"reduce: {n} PEs, {REDUCE_WIDTH} i32 a PE ({REDUCE_WIDTH * 4 / 2**20} MiB), "
        f"values from seed 0, set-up {time.perf_counter() - t:.2f} s")
    out = {}
    for name, batching in (("per_message", False), ("batched", True)):
        cl.set_batching(batching)
        folds0 = sum(pe.stats.batched_invokes for pe in cl.pes())
        t = time.perf_counter()
        rep = xrdma_reduce(cl, vals, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not np.array_equal(rep.result, want):
            raise AssertionError(f"reduce {name}: result differs from the numpy sum")
        if rep.forwards != n - 1:
            raise AssertionError(f"reduce {name}: {rep.forwards} FORWARDs, want {n - 1}")
        folds = sum(pe.stats.batched_invokes for pe in cl.pes()) - folds0
        if batching and folds == 0:
            raise AssertionError("reduce batched: no batched propagate fold ran")
        out[name] = dict(wall_s=wall, forwards=rep.forwards, batched_folds=folds,
                         rounds=rep.rounds, puts=rep.puts, modeled_us=rep.modeled_us,
                         wire_bytes_by_kind=rep.wire_bytes_by_kind)
        log(f"reduce arm {name}: equal to the numpy sum, {json.dumps(out[name])}")
    cl.set_batching(False)
    return out


def chase_inputs(rng, table, lo: int, b: int, max_depth: int, dev):
    """Frontiers mostly inside the shard, plus ids below and above it and
    chases that start with depth 0."""
    n_loc = table.shape[0]
    frontier = rng.integers(lo, lo + n_loc, b)
    pick = rng.random(b)
    low = pick < 0.05
    frontier[low] = rng.integers(lo - n_loc, lo, int(low.sum()))
    high = (pick >= 0.05) & (pick < 0.10)
    frontier[high] = rng.integers(lo + n_loc, lo + 2 * n_loc, int(high.sum()))
    depth = rng.integers(1, max_depth + 1, b)
    depth[pick >= 0.97] = 0
    if b >= 8:  # the shard's edges and an id far below it, always (a lone
        # chase stays a real chase)
        frontier[:4], depth[:4] = [lo - 1, lo + n_loc, lo, -(2**31)], [7, 7, 0, 7]
    else:
        frontier[:], depth[:] = rng.integers(lo, lo + n_loc, b), max_depth
    as_dev = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return as_dev(frontier), as_dev(depth)


def chase_tables(dev, app) -> dict:
    """The two shard kinds at N_loc = 2**24: one shard of the DAPC chain
    (most chases leave after about one hop) and a cycle local to a shard at
    lo = 0 (every chase runs its full depth)."""
    from repro_torch.core import make_chain

    shard = app.shard_size
    lo = 3 * shard
    return {
        "chain": (torch.from_numpy(app.table[lo : lo + shard]).to(dev), lo, DAPC_DEPTH),
        "cycle": (torch.from_numpy(make_chain(shard, seed=1)).to(dev), 0, 1024),
    }


def chase_kernel_phase(dev, rng, tables) -> dict:
    """chase_shard on the card against its plain version, bit-exact, on
    both routes."""
    from repro_torch.kernels.chase import chase_shard, chase_shard_ref
    from repro_torch.kernels.chase.kernel import ROUTES

    worst = 0.0
    for kind, (table, lo, max_depth) in tables.items():
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        for b in CHASE_SIZES:
            frontier, depth = chase_inputs(rng, table, lo, b, max_depth, dev)
            f_want, d_want = chase_shard_ref(table, frontier, depth, lo_t)
            hops = (depth - d_want).long()
            for route in ROUTES:
                before = chase_shard.route_launches[route]
                f, d = chase_shard(table, frontier, depth, lo_t, route=route)
                torch.cuda.synchronize()
                if chase_shard.route_launches[route] != before + 1:
                    raise AssertionError(f"chase_shard {kind} B={b}: not counted on {route}")
                if not (torch.equal(f, f_want) and torch.equal(d, d_want)):
                    raise AssertionError(
                        f"chase_shard differs from plain ({kind}, B={b}, {route})")
                err = max((f.long() - f_want.long()).abs().max().item(),
                          (d.long() - d_want.long()).abs().max().item())
                worst = max(worst, float(err))
                log(f"kernel chase_shard {kind} B={b} ({route}): bit-exact, max_abs_err={err}, "
                    f"hops mean {hops.float().mean().item()} max {hops.max().item()}")
    return {"max_abs_err": worst}


def dapc_setup(dev):
    from repro_torch.core import Cluster, PointerChaseApp, chase_ref

    t0 = time.perf_counter()
    cluster = Cluster(n_servers=N_SERVERS, wire="thor_xeon", device=dev)
    app = PointerChaseApp(cluster, n_entries=DAPC_ENTRIES, max_slots=DAPC_CHASES, seed=0)
    starts = np.random.default_rng(1).integers(0, DAPC_ENTRIES, DAPC_CHASES).astype(np.int32)
    oracle = np.array([chase_ref(app.table, s, DAPC_DEPTH) for s in starts], np.int32)
    log(f"dapc: {N_SERVERS} servers on {dev}, chain of {DAPC_ENTRIES} int32 entries "
        f"({app.shard_size} per shard), {DAPC_CHASES} chases of depth {DAPC_DEPTH}, "
        f"set-up {time.perf_counter() - t0:.2f} s, chaser archive "
        f"{cluster.toolchain.lookup('chaser').fat.nbytes} B, return_result archive "
        f"{cluster.toolchain.lookup('return_result').fat.nbytes} B")
    return app, starts, oracle


def dapc_phase(app, starts, oracle, profile_dir: str | None) -> dict:
    from repro_torch.core import DataPlaneConfig
    from repro_torch.kernels import launch_counts, reset_launches

    cluster = app.cluster
    run = lambda **kw: app.dapc(starts, DAPC_DEPTH, **kw)
    arms = {
        "bitcode_per_message": lambda: run(mode="bitcode"),
        "bitcode_batched": lambda: run(mode="bitcode", batching=True),
        "bitcode_zerocopy": lambda: run(
            mode="bitcode", batching=True, dataplane=DataPlaneConfig.zero_copy(eager_max=0)),
        "binary_batched": lambda: run(mode="binary", batching=True),
        "am": lambda: run(mode="am"),
        "gbpc": lambda: app.gbpc(starts, DAPC_DEPTH),
    }
    # host time inside each PE's poll, by role: where an arm's wall time goes
    poll_s = {"servers": 0.0, "client": 0.0}
    for pe in cluster.pes():
        role = "client" if pe is cluster.client else "servers"

        def timed(*a, _poll=pe.poll, _role=role, **kw):
            t = time.perf_counter()
            try:
                return _poll(*a, **kw)
            finally:
                poll_s[_role] += time.perf_counter() - t

        pe.poll = timed

    def server_invokes() -> int:
        return sum(pe.stats.invokes for pe in cluster.servers)

    from repro_torch.kernels.chase import chase_shard

    reset_launches()  # the DAPC path's launches are counted from here
    per_arm = {}
    for name, arm in arms.items():
        launches0, inv0 = launch_counts()["chase_shard"], server_invokes()
        items0 = chase_shard.items
        poll0 = dict(poll_s)
        t = time.perf_counter()
        rep = arm()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not np.array_equal(rep.results, oracle):
            bad = int(np.flatnonzero(rep.results != oracle)[0])
            raise AssertionError(f"dapc {name}: chase {bad} differs from the oracle")
        launches = launch_counts()["chase_shard"] - launches0
        dispatches = server_invokes() - inv0
        if name in ("am", "gbpc"):
            if launches != 0:
                raise AssertionError(f"dapc {name}: {launches} chase_shard launches, want 0")
        elif launches == 0 or launches != dispatches:
            raise AssertionError(
                f"dapc {name}: {launches} chase_shard launches for {dispatches} "
                f"server dispatches"
            )
        per_arm[name] = dict(
            wall_s=wall, invokes=rep.invokes, server_dispatches=dispatches,
            kernel_launches=launches,
            chases_per_launch=(chase_shard.items - items0) / launches if launches else None,
            puts=rep.puts, gets=rep.gets,
            coalesced_frames=rep.coalesced_frames, region_puts=rep.region_puts,
            rounds=rep.rounds, modeled_us=rep.modeled_us,
            server_poll_s=poll_s["servers"] - poll0["servers"],
            client_poll_s=poll_s["client"] - poll0["client"],
        )
        log(f"dapc arm {name}: oracle-identical, {json.dumps(per_arm[name])}")
    launches = launch_counts()
    for pe in cluster.servers:
        exe = pe.target_cache.lookup("chaser")
        if exe is None or exe.extras["triple"] != "cuda-sm90":
            raise AssertionError(f"{pe.name} did not install the cuda-sm90 chaser slice")
    routes = dict(chase_shard.route_launches)
    mean_b = per_arm["bitcode_batched"]["chases_per_launch"]
    log(f"installed chaser slice: cuda-sm90 on all {N_SERVERS} servers; "
        f"DAPC launches {launches}, chase_shard by route {routes}; batched arm's mean B "
        f"{mean_b} chases a launch")
    if profile_dir:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run(mode="bitcode", batching=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        write_profile(prof, wall, Path(profile_dir) / "dapc_profile.txt",
                      f"dapc batched arm, {DAPC_CHASES} chases")
    return {"launches": launches, "routes": routes, "arms": per_arm, "mean_b": mean_b}


def time_chase(dev, rng, tables, floor: dict, mean_b: float) -> dict:
    """Times at the shapes the DAPC path's launches come in: B = 1 chase (a
    message), the batched arm's mean B and B = 256, depth 64, into one
    2**24-entry shard of the DAPC chain (most chases leave after about one
    hop), and B = 256 on a cycle local to the shard (every chase takes its
    64 hops); 128 distinct frontier sets a shape, so the shard is read from
    HBM.  Both routes in turns.  The bytes bound counts 16 B per chase
    (frontier and depth read and written) plus 4 B per hop taken; the
    reachable one the mean over the sets of a launch's longest chase, in
    loads of the probe's latency."""
    from repro_torch.kernels.chase import chase_route, chase_shard, chase_shard_ref
    from repro_torch.kernels.chase.kernel import ROUTES

    saved = chase_shard.launches, dict(chase_shard.route_launches), chase_shard.items
    shapes = {}
    for label, kind, b in (("message", "chain", 1), ("mean", "chain", max(1, round(mean_b))),
                           ("bucket", "chain", DAPC_CHASES), ("cycle", "cycle", DAPC_CHASES)):
        table, lo, _ = tables[kind]
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        depth = torch.full((b,), DAPC_DEPTH, dtype=torch.int32, device=dev)
        sets = [
            torch.from_numpy(rng.integers(lo, lo + table.shape[0], b).astype(np.int32)).to(dev)
            for _ in range(128)
        ]
        args = [(table, f, depth, lo_t) for f in sets]
        hops = torch.stack([depth - chase_shard_ref(*a)[1] for a in args]).long()
        longest = hops.max(dim=1).values.float().mean().item()
        moved = 16 * b + 4 * hops.sum().item() / len(sets)
        fns = {r: (lambda *a, r=r: chase_shard(*a, route=r)) for r in ROUTES}
        ab = ab_ms(fns, args, 100, 5)
        route = chase_route(b)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        least = min(v["median"] for v in ab.values())
        reach, count = reachable_bound(floor["floor_ms"], bytes_ms, (
            ("longest chase at L", longest * floor["hop_us"] / 1e3),
            ("longest chase from L2", longest * floor["l2_us"] / 1e3),
            ("no load latency", 0.0)), least, f"chase_shard {label} B={b}")
        calls = {r: call_ms(fns[r], args) for r in ROUTES}
        calls["path"] = call_ms(chase_shard, args)  # the wrapper on its default route
        calls["plain"] = call_ms(chase_shard_ref, args)
        shapes[label] = {
            "b": b, "table": kind, "route": route, "ms": ab[route]["median"],
            "route_ms": {r: ab[r]["median"] for r in ROUTES},
            "plain_ms": device_ms(chase_shard_ref, args),  # waits for the card each hop
            "library_ms": None,  # no single PyTorch call chases to exit
            "bound_ms": bytes_ms, "bound_by": "bytes",
            "reachable_bound_ms": reach, "reachable_count": count,
            "hops_mean": hops.float().mean().item(), "hops_max": hops.max().item(),
            "longest_mean": longest,
            "call_ms": calls[route], "calls_ms": calls,
            "half_of_reachable": reach >= 0.5 * ab[route]["median"],
        }
        log(f"timing chase_shard {label} {kind} B={b} depth {DAPC_DEPTH} ({route}), "
            f"{moved:.0f} B moved: {json.dumps(shapes[label])}; in turns (A B B A, 5 "
            f"rounds): {json.dumps(ab)}")
    chase_shard.launches, chase_shard.route_launches, chase_shard.items = saved
    return shapes


def time_host_launch(dev, rng, tables, embed: dict, chase: dict) -> dict:
    """The host side of a launch-sized call at the per-message shapes (N =
    16 ids, B = 1 chase): back-to-back call_ms of each wrapper, of its
    custom op as a traced slice's graph node calls it
    (``torch.ops.repro_torch.*.default``: the dispatcher, the op's Python
    body, then the wrapper) and of index_select at N = 16, in turns (A..E
    E..A, 5 rounds); and a torch.profiler CPU trace of 200 calls of each
    (the ops' host time by name; the rest of a call is Python)."""
    from repro_torch.kernels.chase import chase_shard
    from repro_torch.kernels.embed_lookup import embed_lookup

    lo = 3 * SHARD_ROWS
    lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
    rows = torch.randn(SHARD_ROWS, DIM, device=dev)
    ids = edge_ids(rng, N_KEYS, lo, SHARD_ROWS, dev)
    loc = (ids.long() - lo).clamp(0, SHARD_ROWS - 1)
    table, c_lo, _ = tables["chain"]
    c_lo_t = torch.tensor([c_lo], dtype=torch.int32, device=dev)
    frontier = torch.tensor([c_lo + 5], dtype=torch.int32, device=dev)
    depth = torch.tensor([DAPC_DEPTH], dtype=torch.int32, device=dev)
    saved = {fn: (fn.launches, dict(fn.route_launches), fn.items)
             for fn in (embed_lookup, chase_shard)}
    embed_op = torch.ops.repro_torch.embed_lookup.default
    chase_op = torch.ops.repro_torch.chase_shard.default
    calls = {
        "embed_lookup": lambda: embed_lookup(rows, ids, lo_t),
        "embed_lookup_op": lambda: embed_op(rows, ids, lo_t),
        "chase_shard": lambda: chase_shard(table, frontier, depth, c_lo_t),
        "chase_shard_op": lambda: chase_op(table, frontier, depth, c_lo_t),
        "index_select": lambda: torch.index_select(rows, 0, loc),
    }
    turns = {name: [] for name in calls}
    for _ in range(5):
        for name in [*calls, *reversed(calls)]:
            turns[name].append(call_ms(calls[name], [()]))
    med = {name: float(np.median(ts)) for name, ts in turns.items()}
    yardstick = embed["message"]["calls_ms"]["index_select"]
    out = {
        "ratio_to_index_select": {  # the timing phase's call_ms, the wrappers alone
            "embed_lookup": embed["message"]["call_ms"] / yardstick,
            "chase_shard": chase["message"]["call_ms"] / yardstick,
        },
        "call_ms_in_turns": {name: {"median": med[name], "min": min(ts), "max": max(ts)}
                             for name, ts in turns.items()},
        "ratio_in_turns": {name: med[name] / med["index_select"] for name in calls
                           if name != "index_select"},
    }
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = time.perf_counter()
            for _ in range(200):
                fn()
            wall = time.perf_counter() - t
        torch.cuda.synchronize()
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
        out[name] = {"traced_wall_us_per_call": wall / 200 * 1e6, "self_cpu_us_per_call": {
            e.key: e.self_cpu_time_total / 200 for e in ops}}
    for fn, (n, routes, items) in saved.items():
        fn.launches, fn.route_launches, fn.items = n, routes, items
    log(f"timing host launch, per-message shapes (call_ms of the wrappers, their custom ops "
        f"and index_select at N=16 in turns, and a CPU trace of 200 calls each): "
        f"{json.dumps(out)}")
    return out


# ------------------------------------------------------------ LM serving
def _flash_case(dev, g, b, s, t, h, kh, d, dtype, t_max=None):
    """q (B, S, H, d) and k, v as the first T positions of a (B, T_max, K, d)
    cache (a strided view when T < T_max)."""
    t_max = t_max or t
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    kc = torch.randn(b, t_max, kh, d, generator=g, device=dev).to(dtype)
    vc = torch.randn(b, t_max, kh, d, generator=g, device=dev).to(dtype)
    return q, kc[:, :t], vc[:, :t]


def flash_kernel_phase(dev) -> dict:
    """flash_attention on the card against its plain version: yi's prefill
    (S = T = 300, 1,000 and 2,048; S = 256 on a 1,024-token view of a
    2,048-slot cache) and decode (B = 8, S = 1 on cache views of T = 1,
    129, 777 and 4,096 of a 4,096-slot cache: ragged splits) shapes, the five shapes of
    the JAX kernel sweep (heads-first tensors transposed into the model
    layout: strided inputs) and hymba's (25/5 heads of 64) with its 2,048
    window at prefill S = T = 3,000 and decode T = 2,049 and 4,096, and
    global at decode T = 4,096, each in f32 and bf16.  Every call within
    FLASH_TOL of the plain version in its own dtype; every bf16 call also
    within FLASH_F32P_* of the plain version on f32 copies of its inputs.
    Each call must raise its route's launch count (``flash_route``) by one."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref, flash_route,
    )

    g = torch.Generator(dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for dtype in (f32, bf16):
        cases += [(f"prefill S=T={n}", (1, n, n, 32, 4, 128, dtype), dict(causal=True))
                  for n in (300, 1000, 2048)]
        cases.append(("prefill S=256 T=1024 of a 2048-slot cache",
                      (1, 256, 1024, 32, 4, 128, dtype, 2048), dict(causal=True)))
        cases += [(f"decode B=8 T={t}", (8, 1, t, 32, 4, 128, dtype, 4096), dict(causal=True))
                  for t in (1, 129, 777, 4096)]
    for b, h, kh, s, t, d, _, _, causal, cap in SWEEP:
        for dtype in (f32, bf16):
            cases.append((f"sweep {(b, h, kh, s, t, d)} causal={causal} softcap={cap}",
                          (b, h, kh, s, t, d, dtype), dict(causal=causal, softcap=cap)))
    h, kh, d = HYMBA_HEADS
    win = dict(causal=True, window=HYMBA_WINDOW)
    for dtype in (f32, bf16):  # hymba's shapes, its window biting, and one global case
        cases += [
            ("hymba prefill S=T=3000 window 2048", (1, 3000, 3000, h, kh, d, dtype), win),
            ("hymba decode B=8 T=2049 window 2048", (8, 1, 2049, h, kh, d, dtype, 4096), win),
            ("hymba decode B=8 T=4096 window 2048", (8, 1, 4096, h, kh, d, dtype, 4096), win),
            ("hymba decode B=8 T=4096 global", (8, 1, 4096, h, kh, d, dtype, 4096),
             dict(causal=True)),
        ]
    worst = {f32: 0.0, bf16: 0.0, "f32_probs": 0.0}
    before = flash_attention.launches, dict(flash_attention.route_launches)
    for label, shape, kw in cases:
        if label.startswith("sweep"):
            b, h, kh, s, t, d, dtype = shape
            q = torch.randn(b, h, s, d, generator=g, device=dev).to(dtype).transpose(1, 2)
            k = torch.randn(b, kh, t, d, generator=g, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(b, kh, t, d, generator=g, device=dev).to(dtype).transpose(1, 2)
        else:
            dtype = shape[6]
            q, k, v = _flash_case(dev, g, *shape)
        route = flash_route(dtype, q.shape[1], q.shape[2], k.shape[2])
        at = flash_attention.route_launches[route]
        got = flash_attention(q, k, v, **kw).float()
        if flash_attention.route_launches[route] != at + 1:
            raise AssertionError(f"flash_attention {label}: no launch on the {route} route")
        want = flash_attention_ref(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = FLASH_TOL[dtype]
        line = (f"kernel flash_attention {label} {str(dtype)[6:]} ({route}): max_abs_err={err} "
                f"(within {tol}), plain |out| max {want.abs().max().item()} rms "
                f"{want.square().mean().sqrt().item()}")
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention differs from plain: {line}")
        worst[dtype] = max(worst[dtype], err)
        if dtype == bf16:
            want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
            err = (got - want).abs().max().item()
            line += (f"; against f32 probabilities max_abs_err={err} (within atol "
                     f"{FLASH_F32P_ATOL}, rtol {FLASH_F32P_RTOL})")
            if not torch.allclose(got, want, atol=FLASH_F32P_ATOL, rtol=FLASH_F32P_RTOL):
                raise AssertionError(f"flash_attention differs from plain: {line}")
            worst["f32_probs"] = max(worst["f32_probs"], err)
        log(line)
    # checking launches are not main-path launches
    flash_attention.launches, flash_attention.route_launches = before
    return {"max_abs_err": max(worst[f32], worst[bf16]), "max_abs_err_f32_probs":
            worst["f32_probs"]}


def parity_phase(dev, arch: str = "yi-9b") -> dict:
    """A 2-layer ``arch`` at full width (yi-9b: d_model 4,096, 32/4 heads,
    d_ff 11,008, vocab 64,000; rwkv6-1.6b: d_model 2,048, 32 WKV heads,
    d_ff 7,168, vocab 65,536; hymba-1.5b: d_model 1,600, 25/5 heads,
    d_ff 5,504, vocab 32,001, both layers windowed at 2,048) in f32, one
    set of weights drawn on the card from seed 0 and copied to the host; a
    128-token prompt (hymba: 2,064, past its window) and 8 teacher-forced
    decode steps on the card (kernel) and on the CPU (plain version).  The
    logits must agree within PARITY_ATOL and the greedy tokens exactly."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.common import ParamFactory

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products on both sides
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).replace(n_layers=2, dtype=torch.float32)
    t = time.perf_counter()
    card_model = zoo.build_params(cfg, 0, device=dev)
    host_model = zoo.LM(cfg, ParamFactory(0, torch.float32, torch.device("cpu"), fill=False))
    host_model.load_state_dict(card_model.state_dict())
    rng = np.random.default_rng(0)
    n_prompt = PARITY_PROMPT_BY_ARCH.get(arch, PARITY_PROMPT)
    prompt = rng.integers(0, cfg.vocab, (2, n_prompt)).astype(np.int32)
    fed = rng.integers(0, cfg.vocab, (2, PARITY_STEPS)).astype(np.int32)

    def run(model, device):
        t_max = n_prompt + PARITY_STEPS
        cache = zoo.init_kv_cache(cfg, 2, t_max, dtype=cfg.dtype, device=device)
        logits, _, _ = zoo.forward(cfg, model, {"tokens": torch.from_numpy(prompt).to(device)},
                                   caches=cache, offset=0)
        out = [logits[:, -1].float().cpu()]
        step = zoo.make_serve_step(cfg)
        for i in range(PARITY_STEPS):
            tok = torch.from_numpy(fed[:, i : i + 1]).to(device)
            logits, cache = step(model, cache, tok, n_prompt + i)
            out.append(logits.float().cpu())
        return torch.stack(out, 1)  # (B, 1 + steps, Vp)

    card = run(card_model, dev)
    host = run(host_model, torch.device("cpu"))
    err = (card - host).abs().max().item()
    same = torch.equal(card.argmax(-1), host.argmax(-1))
    log(f"parity: 2-layer {arch} full width f32, prompt {n_prompt} + {PARITY_STEPS} "
        f"teacher-forced steps, card vs CPU logits max_abs_err={err} (tolerance {PARITY_ATOL}), "
        f"|logit| max {host.abs().max().item()}, greedy tokens equal: {same}, "
        f"{time.perf_counter() - t:.1f} s")
    if not (err <= PARITY_ATOL and same and torch.isfinite(card).all()):
        raise AssertionError("card and CPU logits disagree on the full-width parity model")
    del card_model, host_model
    torch.cuda.empty_cache()
    return {"max_abs_err": err}


def _finite(fn):
    def checked(*args, **kw):
        logits, cache = fn(*args, **kw)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError("non-finite logits on the serving path")
        return logits, cache
    return checked


def serving_phase(dev, profile_dir: str | None, arch: str = "yi-9b") -> dict:
    """``arch`` at full width (yi-9b and rwkv6-1.6b at the depth of
    SERVE_LAYERS, 16 of 48 and 12 of 24 layers; hymba-1.5b full, 32 layers;
    bf16, random weights drawn on the card) behind ServeScheduler(slots 8,
    t_max 4,096): 16 requests with prompts of 256-3,072 tokens
    (default_rng(0)), 32 new tokens each.  Each of the arch's kernels
    (PATH_KERNEL) must launch once per layer per prefill and per decode
    group."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import WRAPPERS, launch_counts, reset_launches
    from repro_torch.models import zoo
    from repro_torch.runtime import ServeScheduler

    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=SERVE_LAYERS.get(arch, cfg.n_layers))
    t = time.perf_counter()
    model = zoo.build_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"serving: {arch} {cfg.n_layers} layers d_model {cfg.d_model} bf16, "
        f"{zoo.param_count(model)} parameters drawn on the card in "
        f"{time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_PROMPT_MIN, SERVE_PROMPT_MAX + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]
    sched = ServeScheduler(cfg, model, slots=SERVE_SLOTS, t_max=SERVE_T_MAX)
    sched._prefill, sched._step = _finite(sched._prefill), _finite(sched._step)
    for p in prompts:
        sched.submit(p, SERVE_NEW)
    torch.cuda.synchronize()
    reset_launches()  # the serving path's launches are counted from here
    t = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    if len(done) != SERVE_REQUESTS or any(len(r.out) != SERVE_NEW for r in done):
        raise AssertionError(f"serving: {len(done)} requests done, lengths "
                             f"{sorted(len(r.out) for r in done)}")
    want = cfg.n_layers * (sched.prefills + sched.decode_groups)
    for kernel, _ in PATH_KERNEL[arch]:
        if launches[kernel] != want:
            raise AssertionError(f"serving {arch}: {launches[kernel]} {kernel} launches, want "
                                 f"{cfg.n_layers} x ({sched.prefills} + {sched.decode_groups})")
    # each kernel's prefills on one route and its decode groups on another
    routes = {kernel: dict(WRAPPERS[kernel].route_launches) for kernel, _ in PATH_KERNEL[arch]}
    for kernel, _ in PATH_KERNEL[arch]:
        pre, dec = PATH_ROUTES[kernel]
        want_routes = dict.fromkeys(routes[kernel], 0)
        want_routes[pre] += cfg.n_layers * sched.prefills
        want_routes[dec] += cfg.n_layers * sched.decode_groups
        if routes[kernel] != want_routes:
            raise AssertionError(f"serving {arch}: {kernel} routes {routes[kernel]}, want {pre} "
                                 f"{cfg.n_layers} x {sched.prefills} and {dec} "
                                 f"{cfg.n_layers} x {sched.decode_groups}")
    ttft = [r.t_first - r.t_submit for r in done]
    rec = dict(wall_s=wall, prefills=sched.prefills, decode_groups=sched.decode_groups,
               prompt_tokens=int(lengths.sum()), new_tokens=SERVE_REQUESTS * SERVE_NEW,
               tok_s=SERVE_REQUESTS * SERVE_NEW / wall, ttft_s_max=max(ttft),
               **{f"{short}_launches": launches[kernel] for kernel, short in PATH_KERNEL[arch]},
               **{f"{short}_routes": routes[kernel] for kernel, short in PATH_KERNEL[arch]})
    prefix = line_prefix(arch)
    shorts = " and ".join(short for _, short in PATH_KERNEL[arch])
    log(f"{prefix}serving scheduler: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens, all "
        f"finite, {shorts} launches = {cfg.n_layers} x (prefills + decode groups): "
        f"{json.dumps(rec)}")
    rec["burst"] = decode_burst(cfg, model, sched.cache, dev, profile_dir, arch)
    del sched, model
    torch.cuda.empty_cache()
    rec["launches"] = launches
    rec["routes"] = routes
    return rec


def decode_burst(cfg, model, cache, dev, profile_dir: str | None, arch: str = "yi-9b") -> dict:
    """torch.profiler over 8 decode steps of all 8 slots at position 2,048
    (one step before and one after them in the trace) and over one
    2,048-token prefill: the card's busy share of the wall
    time, and each path kernel's share of the device time.  Both shares
    count only when the profile holds every kernel launched (T8, see
    :func:`profiled`); else they are null, "not measured".  A kernel
    counts for its share when its launch lies in the window (matched by
    correlation id, ``_by_launch``); for each path kernel the line also
    logs the kernels whose start lies in the window (``_recorded``), the
    wrapper's launches in the window (``_launched``) and the kernel names
    matched (ROADMAP T12).  A wrapper launch records one device kernel on
    each route (``flash_fwd_wgmma`` for the prefill, ``flash_fwd_split``
    for a decode step, its chunks' partials merged inside the same kernel,
    ``flash_fwd`` for f32; ``wkv6_fwd`` and ``ssm_scan_fwd`` on their step
    routes), except the recurrences' split route, which records three
    (DEVICE_KERNELS: the local pass, ``*_fwd_carry`` and the output pass):
    so in a whole window the kernels matched to a launch must number k x
    the launches on each route, summed.  Each kernel's device time is also
    logged by name."""
    from repro_torch.kernels import WRAPPERS
    from repro_torch.models import zoo

    kernels = PATH_KERNEL[arch]
    before = {kernel: (WRAPPERS[kernel].launches, dict(WRAPPERS[kernel].route_launches))
              for kernel, _ in kernels}
    step = zoo.make_serve_step(cfg)
    n = LAUNCH_PROMPT
    tok = torch.zeros(SERVE_SLOTS, 1, dtype=torch.int32, device=dev)
    prompt = {"tokens": torch.zeros(1, n, dtype=torch.int32, device=dev)}
    prefill = zoo.make_prefill_step(cfg)
    step(model, cache, tok, n - 8)
    prefill(model, prompt)
    torch.cuda.synchronize()
    out = {}
    # the runs around the window: one decode step, or the prefill
    bursts = (("decode", lambda: [step(model, cache, tok, n + i) for i in range(8)],
               lambda: step(model, cache, tok, n)),
              ("prefill", lambda: prefill(model, prompt), lambda: prefill(model, prompt)))
    for name, fn, edge in bursts:
        per_call = []  # the wrapper launches of each window; the last try's counts

        def counted(fn=fn):
            at = {kernel: dict(WRAPPERS[kernel].route_launches) for kernel, _ in kernels}
            fn()
            per_call.append({k: {r: n - at[k][r] for r, n in WRAPPERS[k].route_launches.items()}
                             for k in at})

        prof, window, wall, whole = profiled(counted, edge=edge)
        busy = device_us(window)
        launch_ids = {e.id for e in window
                      if e.device_type == DeviceType.CPU and e.name in LAUNCH_APIS}
        rec = {"wall_ms": wall * 1e3, "whole_profile": whole,
               "device_busy_pct": 100 * busy / 1e3 / (wall * 1e3) if whole else None}
        for kernel, short in kernels:
            mine = [e for e in window
                    if e.device_type == DeviceType.CUDA and f"{short}_fwd" in e.name]
            by_launch = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and f"{short}_fwd" in e.name and e.id in launch_ids]
            by_route = {r: n for r, n in per_call[-1][kernel].items() if n}
            expect = sum(n * DEVICE_KERNELS.get(kernel, {}).get(r, 1)
                         for r, n in by_route.items())
            rec[f"{short}_recorded"] = len(mine)
            rec[f"{short}_by_launch"] = len(by_launch)
            rec[f"{short}_launched"] = sum(by_route.values())
            rec[f"{short}_launched_by_route"] = by_route
            rec[f"{short}_kernels_expected"] = expect
            rec[f"{short}_names"] = sorted({e.name for e in mine})
            per_name = {}
            for e in by_launch:
                per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
            rec[f"{short}_us_by_name"] = per_name
            rec[f"{short}_share_pct"] = (
                100 * sum(e.device_time_total for e in by_launch) / busy if whole else None)
            if whole and len(by_launch) != expect:
                raise AssertionError(
                    f"{arch} profile {name}: {len(by_launch)} {short} kernels matched to a "
                    f"launch in a whole window, want {expect} for the launches {by_route}")
        out[name] = rec
        what = f"8 steps of B={SERVE_SLOTS} at T={n}" if name == "decode" else f"B=1 S={n}"
        prefix = line_prefix(arch)
        log(f"{prefix}profile {name} ({what}): {json.dumps(rec)}")
        if profile_dir:
            stem = PROFILE_STEM[arch]
            write_profile(prof, wall, Path(profile_dir) / f"{stem}_{name}_profile.txt",
                          f"{arch} {name} burst", busy)
    for kernel, (count, routes) in before.items():  # profiled launches are not main-path
        WRAPPERS[kernel].launches, WRAPPERS[kernel].route_launches = count, routes
    return out


def launch_serve_phase(dev, arch: str = "yi-9b") -> dict:
    """repro_torch.launch.serve at full ``arch``: local, then remote-embed
    over 2 embedding servers, same seed; the streams must be bit-identical
    and each of the arch's kernels launched once per layer per forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import WRAPPERS, launch_counts, reset_launches
    from repro_torch.launch.serve import serve

    n_layers = get_config(arch).n_layers
    argv = ["--arch", arch, "--no-smoke", "--batch", str(LAUNCH_BATCH), "--prompt-len",
            str(LAUNCH_PROMPT), "--gen", str(SERVE_NEW), "--seed", "0", "--device", str(dev)]
    prefix = line_prefix(arch)
    runs = {}
    for name, extra in (("local", []), ("remote", ["--remote-embed", "--embed-servers", "2"])):
        reset_launches()
        t = time.perf_counter()
        rec, toks = serve(argv + extra)
        torch.cuda.synchronize()
        launches = launch_counts()
        rec["wall_s"], rec["launches"] = time.perf_counter() - t, launches
        rec["routes"] = {k: dict(WRAPPERS[k].route_launches)
                         for k in (*(k for k, _ in PATH_KERNEL[arch]), "embed_lookup")}
        runs[name] = (rec, toks)
        log(f"{prefix}launch.serve {name}: {json.dumps(rec)}")
        if any(launches[k] != n_layers * (1 + SERVE_NEW) for k, _ in PATH_KERNEL[arch]):
            raise AssertionError(f"{prefix}launch.serve {name}: {launches} launches")
        for kernel, _ in PATH_KERNEL[arch]:  # the prefill on one route, each step on another
            pre, dec = PATH_ROUTES[kernel]
            routes = rec["routes"][kernel]
            if (routes[pre], routes[dec]) != (n_layers, n_layers * SERVE_NEW):
                raise AssertionError(f"{prefix}launch.serve {name}: {kernel} routes {routes}")
        torch.cuda.empty_cache()
    if not np.array_equal(runs["local"][1], runs["remote"][1]):
        raise AssertionError(f"{prefix}launch.serve: remote-embed stream differs from the local one")
    if runs["remote"][0]["launches"]["embed_lookup"] == 0:
        raise AssertionError(f"{prefix}launch.serve remote: no embed_lookup launch")
    log(f"{prefix}launch.serve: local and remote-embed token streams bit-identical "
        f"({runs['local'][1].size} tokens)")
    return {name: rec for name, (rec, _) in runs.items()}


def time_flash(dev) -> dict:
    """Device time per call at yi's prefill (B=1, S=T=2,048) and decode
    (B=8, S=1, T=2,048 on views of 4,096-slot caches, 8 cache sets so the
    268 MB of K/V exceeds the 50 MB L2) shapes, and at hymba's windowed
    prefill (B=1, S=T=3,072) and decode (B=8, T=4,096, 8 whole caches)
    with its 2,048 window (SDPA given the window as a boolean mask), bf16: the kernel's from
    CUDA events around calls queued behind a sleep (:func:`event_ms`), beside the plain version's and
    scaled_dot_product_attention's (a yardstick the port never calls) timed
    the same way, and the bound: the larger of the FLOPs over the bf16 dense
    tensor-core peak and the bytes (q, k, v read once, out written once)
    over the HBM rate.  Each record names the route; the ptxas report of
    each tensor-core and split instance (registers, spills) is logged when
    this process built the library."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref, flash_route,
    )

    for inst in flash_instances():
        log(f"ptxas flash_attention instance {json.dumps(inst)}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(dev).manual_seed(4)
    before = flash_attention.launches, dict(flash_attention.route_launches)
    out = {}
    h, kh, d = 32, 4, 128
    for name, (b, s, t) in FLASH_TIMING.items():
        sets = [_flash_case(dev, g, b, s, t, h, kh, d, torch.bfloat16, None if s > 1 else 2 * t)
                for _ in range(1 if s > 1 else 8)]
        lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in qkv) for qkv in sets]
        causal_pairs = s * (s + 1) // 2 if s == t else s * t
        flops = 4 * b * h * d * causal_pairs
        moved = 2 * (2 * b * s * h * d + 2 * b * t * kh * d)  # bf16 q, o, k, v
        bounds = {"operations": flops / BF16_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        reps = 20 if s > 1 else 200
        rec = {
            "ms": event_ms(flash_attention, sets, reps),
            "plain_ms": event_ms(flash_attention_ref, sets, 20),  # 14 kernels per call
            "library_ms": event_ms(
                lambda q, k, v: sdpa(q, k, v, is_causal=s > 1, enable_gqa=True), lib_sets, 20),
            "bound_ms": bounds[bound_by],
            "bound_by": bound_by,
            "flops": flops,
            "bytes": moved,
            "call_ms": call_ms(flash_attention, sets, reps),
            "route": flash_route(torch.bfloat16, s, h, kh),
        }
        out[name] = rec
        log(f"timing flash_attention {name} B={b} S={s} T={t} H={h} K={kh} d={d} bf16: "
            f"{json.dumps(rec)}")
    h, kh, d = HYMBA_HEADS
    w = HYMBA_WINDOW
    for name, (b, s, t) in HYMBA_FLASH_TIMING.items():
        sets = [_flash_case(dev, g, b, s, t, h, kh, d, torch.bfloat16, None if s > 1 else t)
                for _ in range(1 if s > 1 else 8)]
        lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in qkv) for qkv in sets]
        # the pairs and keys this window leaves visible: query i sees
        # min(i + T - S + 1, w) keys; the K/V rows any query sees are read once
        pairs = sum(min(i + t - s + 1, w) for i in range(s))
        keys = t if s > 1 else min(t, w)
        flops = 4 * b * h * d * pairs
        moved = 2 * (2 * b * s * h * d + 2 * b * keys * kh * d)  # bf16 q, o, k, v
        bounds = {"operations": flops / BF16_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        pos = torch.arange(t, device=dev)
        qpos = pos[t - s :, None]
        mask = (pos[None, :] <= qpos) & (qpos - pos[None, :] < w)  # (S, T), True = visible
        reps = 20 if s > 1 else 200
        rec = {
            "ms": event_ms(lambda q, k, v: flash_attention(q, k, v, window=w), sets, reps),
            "plain_ms": event_ms(lambda q, k, v: flash_attention_ref(q, k, v, window=w),
                                 sets, 20),
            "library_ms": event_ms(
                lambda q, k, v: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), lib_sets, 20),
            "bound_ms": bounds[bound_by],
            "bound_by": bound_by,
            "flops": flops,
            "bytes": moved,
            "call_ms": call_ms(lambda q, k, v: flash_attention(q, k, v, window=w), sets, reps),
            "route": flash_route(torch.bfloat16, s, h, kh),
        }
        out[name] = rec
        log(f"timing flash_attention {name} B={b} S={s} T={t} H={h} K={kh} d={d} window {w} "
            f"bf16: {json.dumps(rec)}")
    # timing launches are not main-path launches
    flash_attention.launches, flash_attention.route_launches = before
    return out


def flash_instances() -> list[dict]:
    """ptxas's report of each ``flash_fwd_wgmma`` and ``flash_fwd_split``
    instance (head dim, registers, spilled bytes, static shared memory), from
    the build log of this process; empty when the library was built before."""
    from repro_torch.kernels import build

    out = []
    for block in build.build_logs.get("flash_attention", "").split("Compiling entry function")[1:]:
        name = re.search(r"(flash_fwd_(?:wgmma|split))I(.*?)EEv", block)
        used = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if not (name and used and spill):
            continue
        smem = re.search(r"(\d+) bytes smem", block)
        out.append({"kernel": name.group(1), "d": int(re.findall(r"Li(\d+)E", name.group(2))[0]),
                    "registers": int(used.group(1)), "spill_stores": int(spill.group(1)),
                    "spill_loads": int(spill.group(2)),
                    "static_smem": int(smem.group(1)) if smem else 0})
    return out


def split_grid(name: str, fn, draw, route_of, chunk_of) -> dict:
    """A recurrence kernel's routes over SPLIT_GRID_B x SPLIT_GRID_T from a
    state: the step route and the split at each chunk of SPLIT_CHUNKS up to
    T, in turns (:func:`ab_ms`, 2 rounds, two input sets): the A/B behind
    the wrapper's route threshold and chunk rule.  Each record names the
    fastest, the route and chunk the wrapper takes, and its time."""
    grid = {}
    for b in SPLIT_GRID_B:
        for t in SPLIT_GRID_T:
            sets = [draw(b, t) for _ in range(2)]
            fns = {"step": lambda *a: fn(*a, route="step")}
            fns |= {f"L{c}": (lambda *a, c=c: fn(*a, route="split", chunk=c))
                    for c in SPLIT_CHUNKS if c <= t}
            med = {k: v["median"] for k, v in ab_ms(fns, sets, 10, 2).items()}
            route, chunk = route_of(t), chunk_of(b, t)
            taken = med["step"] if route == "step" else med[f"L{chunk}"]
            rec = {"route": route, "chunk": chunk, "taken_ms": taken,
                   "fastest": min(med, key=med.get), "ms": med}
            grid[f"B={b} T={t}"] = rec
            log(f"timing {name} grid B={b} T={t}: {json.dumps(rec)}")
    return grid


def _wkv_case(dev, g, b, t, h, m, dtype, w_dtype, lam=None, state=False):
    """r, k, v ~ N(0, 0.25) in ``dtype``; decays from the JAX sweep's domain
    (log w = -exp(x), x ~ N(-1, 1) clipped to [-6, 1]) or a constant
    log-decay ``lam`` per step, in ``w_dtype``; u ~ N(0, 0.09) in ``dtype``;
    an N(0, 0.25) f32 state when ``state``, else None (zeros)."""
    r, k, v = (0.5 * torch.randn(b, t, h, m, generator=g, device=dev) for _ in range(3))
    if lam is None:
        x = (torch.randn(b, t, h, m, generator=g, device=dev) - 1.0).clamp(-6.0, 1.0)
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.full((b, t, h, m), float(np.exp(lam)), device=dev)
    u = 0.3 * torch.randn(h, m, generator=g, device=dev)
    s = 0.5 * torch.randn(b, h, m, m, generator=g, device=dev) if state else None
    return r.to(dtype), k.to(dtype), v.to(dtype), w.to(w_dtype), u.to(dtype), s


def wkv6_kernel_phase(dev) -> dict:
    """wkv6 on the card against its plain version: rwkv6's prefill (B = 1,
    T = 2,048) on both routes and decode (B = 8, T = 1 from a state)
    shapes with r, k, v, u in bf16 and w in f32 (the model's types) and in
    f32; launch.serve's prefill (B = 4, T = 2,048); the three shapes of the
    JAX sweep in f32 and bf16 (w in the inputs' type); a constant log-decay
    of -1 and -1.5 per step over T = 2,048, where the reference's chunk-64
    form passes its clamp, and over T = 777 from a state across the split's
    chunk boundaries; T = 777 from a state on both routes and in chunks of
    16; T a step either side of the split's chunk; the split at each chunk
    length its timing compares.  Outputs within WKV_ATOL of the largest
    (f32; bf16 also WKV_BF16_RTOL), states within WKV_ATOL.  Each call must
    raise its route's launch count by one."""
    from repro_torch.kernels.wkv6 import wkv6, wkv6_ref, wkv6_route, split_chunk

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsum in f32
    g = torch.Generator(dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    h, m = WKV_H, WKV_M
    L = 64  # a chunk length for the cases either side of it
    # (label, shape, draw, route (None: by shape), chunk (None: split_chunk))
    cases = [
        ("prefill B=1 T=2048", (1, 2048, h, m, bf16, f32), {}, None, None),
        ("prefill B=1 T=2048", (1, 2048, h, m, bf16, f32), {}, "step", L),
        ("prefill B=1 T=2048", (1, 2048, h, m, f32, f32), {}, None, None),
        ("prefill B=1 T=2048", (1, 2048, h, m, f32, f32), {}, "step", L),
        ("launch.serve prefill B=4 T=2048", (4, 2048, h, m, bf16, f32), {}, None, None),
        ("decode B=8 T=1", (8, 1, h, m, bf16, f32), dict(state=True), None, None),
        ("decode B=8 T=1", (8, 1, h, m, f32, f32), dict(state=True), None, None),
        ("log-decay -1 B=1 T=2048", (1, 2048, h, m, f32, f32), dict(lam=-1.0), None, None),
        ("log-decay -1.5 B=1 T=2048", (1, 2048, h, m, f32, f32), dict(lam=-1.5), None, None),
        ("log-decay -1 B=1 T=777", (1, 777, h, m, f32, f32), dict(lam=-1.0, state=True),
         "split", L),
        ("log-decay -1.5 B=1 T=777", (1, 777, h, m, f32, f32), dict(lam=-1.5, state=True),
         "split", L),
        ("ragged B=2 T=777", (2, 777, h, m, f32, f32), dict(state=True), None, None),
        ("ragged B=2 T=777", (2, 777, h, m, f32, f32), dict(state=True), "step", L),
        ("ragged B=2 T=777", (2, 777, h, m, bf16, f32), dict(state=True), None, None),
        ("ragged B=2 T=777 chunk 16", (2, 777, h, m, bf16, f32), dict(state=True), "split", 16),
        (f"T=L-1={L - 1}", (2, L - 1, h, m, f32, f32), dict(state=True), "split", L),
        (f"T=L+1={L + 1}", (2, L + 1, h, m, bf16, f32), dict(state=True), "split", L),
    ]
    cases += [(f"prefill B=1 T=2048 chunk {c}", (1, 2048, h, m, bf16, f32), {}, "split", c)
              for c in SPLIT_CHUNKS if c != split_chunk(1, 2048)]
    for b, t, hh, mm in WKV_SWEEP:
        cases += [(f"sweep {(b, t, hh, mm)}", (b, t, hh, mm, dt, dt), {}, None, None)
                  for dt in (f32, bf16)]
    worst = {f32: 0.0, bf16: 0.0, "state": 0.0}
    before = wkv6.launches, dict(wkv6.route_launches)
    for label, shape, kw, route, chunk in cases:
        dtype = shape[4]
        args = _wkv_case(dev, g, *shape, **kw)
        took = route or wkv6_route(shape[1])
        at = wkv6.route_launches[took]
        out, state = wkv6(*args, route=route, chunk=chunk)
        if wkv6.route_launches[took] != at + 1:
            raise AssertionError(f"wkv6 {label}: no launch on the {took} route")
        want, want_state = wkv6_ref(*args)
        torch.cuda.synchronize()
        scale = max(1.0, want.float().abs().max().item())
        rtol = WKV_BF16_RTOL if dtype == bf16 else 0.0
        err = (out.float() - want.float()).abs().max().item()
        s_scale = max(1.0, want_state.abs().max().item())
        s_err = (state - want_state).abs().max().item()
        line = (f"kernel wkv6 {label} {str(dtype)[6:]} (w {str(shape[5])[6:]}) ({took}): "
                f"max_abs_err={err} (within {WKV_ATOL} x {scale} + {rtol} |out|), "
                f"state max_abs_err={s_err} (within {WKV_ATOL} x {s_scale}), "
                f"plain |out| max {want.float().abs().max().item()}")
        if not (torch.allclose(out.float(), want.float(), atol=WKV_ATOL * scale, rtol=rtol)
                and s_err <= WKV_ATOL * s_scale and out.dtype == want.dtype):
            raise AssertionError(f"wkv6 differs from plain: {line}")
        worst[dtype] = max(worst[dtype], err)
        worst["state"] = max(worst["state"], s_err)
        log(line)
    wkv6.launches, wkv6.route_launches = before  # checking launches are not main-path launches
    log(f"kernel wkv6: worst f32 {worst[f32]}, bf16 {worst[bf16]}, state {worst['state']}")
    return {"max_abs_err": max(worst.values())}


def time_wkv6(dev) -> dict:
    """Device time per call at rwkv6's prefill (B = 1, T = 2,048, H = 32,
    M = 64; two input sets, 84 MB, beyond the 50 MB L2) and decode (B = 8,
    T = 1 from a state; 16 state sets, 67 MB) shapes, r, k, v, u in bf16
    and w in f32: the kernel's from CUDA events around calls queued behind
    a sleep (:func:`event_ms`), the prefill on both routes in turns (A B B
    A, 5 rounds, :func:`ab_ms`), decode on its step route.  The plain
    version's decode the same way;
    its prefill launches ~10 kernels a step (20,000 a call), more than the
    launch queue holds behind a sleep, so it is timed by CUDA events around
    back-to-back calls (:func:`call_ms`): its host issue time counts.  The
    bound: the larger of the operations (per state entry and step the r^T S
    product, 2, and the decay-and-add, 3; 4 M per step for the bonus) over
    the f32 peak, and the bytes (r, k, v, w, u, the state in read once; out
    and the state out written once) over the HBM rate.  No PyTorch call
    computes the WKV6 recurrence: library_ms is null.  Then the route grid
    (:func:`split_grid`)."""
    from repro_torch.kernels.wkv6 import wkv6, wkv6_ref, wkv6_route, split_chunk

    g = torch.Generator(dev).manual_seed(6)
    before = wkv6.launches, dict(wkv6.route_launches)
    out = {}
    h, m = WKV_H, WKV_M

    def draw(b, t, n_sets, state):
        return [_wkv_case(dev, g, b, t, h, m, torch.bfloat16, torch.float32, state=state)
                for _ in range(n_sets)]

    def routes(**kw):
        return {r: (lambda *a, r=r: wkv6(*a, route=r, **kw)) for r in ("step", "split")}

    for name, (b, t, n_sets, state) in {"prefill": (1, 2048, 2, False),
                                        "decode": (8, 1, 16, True)}.items():
        sets = draw(b, t, n_sets, state)
        flops = b * t * h * (5 * m * m + 4 * m)
        moved = b * t * h * m * (3 * 2 + 4 + 2) + h * m * 2 + b * h * m * m * 4 * (1 + state)
        bounds = {"operations": flops / F32_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        route = wkv6_route(t)
        rec = {"route": route}
        if t > 1:
            ab = ab_ms(routes(), sets, 20, 5)
            rec.update(ms=ab[route]["median"], step_ms=ab["step"]["median"],
                       split_ms=ab["split"]["median"], routes_ab=ab)
        else:
            rec["ms"] = event_ms(wkv6, sets, 200)
        rec.update({
            "plain_ms": call_ms(wkv6_ref, sets, 2) if t > 1 else event_ms(wkv6_ref, sets, 20),
            "plain_timed_by": "call_ms" if t > 1 else "event_ms",
            "library_ms": None,  # no PyTorch call computes the WKV6 recurrence
            "bound_ms": bounds[bound_by],
            "bound_by": bound_by,
            "flops": flops,
            "bytes": moved,
            "call_ms": call_ms(wkv6, sets, 20 if t > 1 else 200),
        })
        out[name] = rec
        log(f"timing wkv6 {name} B={b} T={t} H={h} M={m} bf16 (w f32): {json.dumps(rec)}")
    out["grid"] = split_grid("wkv6", wkv6, lambda b, t: draw(b, t, 1, True)[0], wkv6_route,
                             split_chunk)
    wkv6.launches, wkv6.route_launches = before  # timing launches are not main-path launches
    return out


def _ssm_case(dev, g, b, t, d, n, dtype, state=False, dt_range=None):
    """x, b, c ~ N(0, 0.25) in ``dtype``; dt = softplus(N(0, 1) - 4.6) + 1e-4
    (Mamba's domain, the JAX sweep's) or uniform in ``dt_range``, in
    ``dtype``; a = -exp(N(0, 0.09)) in f32; an N(0, 0.25) f32 state when
    ``state``, else None (zeros)."""
    x = 0.5 * torch.randn(b, t, d, generator=g, device=dev)
    if dt_range is None:
        dt = torch.nn.functional.softplus(torch.randn(b, t, d, generator=g, device=dev) - 4.6)
        dt = dt + 1e-4
    else:
        lo, hi = dt_range
        dt = lo + (hi - lo) * torch.rand(b, t, d, generator=g, device=dev)
    a = -torch.exp(0.3 * torch.randn(d, n, generator=g, device=dev))
    bb, cc = (0.5 * torch.randn(b, t, n, generator=g, device=dev) for _ in range(2))
    h0 = 0.5 * torch.randn(b, d, n, generator=g, device=dev) if state else None
    return x.to(dtype), dt.to(dtype), a, bb.to(dtype), cc.to(dtype), h0


def ssm_scan_kernel_phase(dev) -> dict:
    """ssm_scan on the card against its plain version: hymba's prefill
    (B = 1, T = 2,048, D = 1,600, N = 16) on both routes and decode (B = 8,
    T = 1 from a state) shapes in bf16 (the model's type; a f32) and f32,
    launch.serve's prefill (B = 4, T = 2,048), T = 777 from a state on both
    routes and at N = 8 in chunks of 16, T a step either side of the
    split's chunk, the three shapes of the JAX sweep in f32 and bf16, dt of
    2-3 per step at a ~ -1 (a 32-step decay sum of about -80, past the
    Pallas form's -60 clamp) over T = 2,048 and over T = 777 from a state
    across the split's chunk boundaries, and the split at each chunk length
    its timing compares.  Outputs within SSM_ATOL of the largest (bf16 also
    SSM_BF16_RTOL of each value), states within SSM_ATOL of the largest.
    Each call must raise its route's launch count by one."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref, ssm_scan_route, split_chunk

    g = torch.Generator(dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    d, n = SSM_D, SSM_N
    L = 64  # a chunk length for the cases either side of it
    # (label, shape, draw, route (None: by shape), chunk (None: split_chunk))
    cases = []
    for dtype in (bf16, f32):
        cases += [
            ("prefill B=1 T=2048", (1, 2048, d, n, dtype), {}, None, None),
            ("prefill B=1 T=2048", (1, 2048, d, n, dtype), {}, "step", L),
            ("decode B=8 T=1", (8, 1, d, n, dtype), dict(state=True), None, None),
            ("ragged B=2 T=777", (2, 777, d, n, dtype), dict(state=True), None, None),
            ("ragged B=2 T=777", (2, 777, d, n, dtype), dict(state=True), "step", L),
            (f"T=L-1={L - 1}", (2, L - 1, d, n, dtype), dict(state=True), "split", L),
            (f"T=L+1={L + 1}", (2, L + 1, d, n, dtype), dict(state=True), "split", L),
        ]
    cases += [
        ("launch.serve prefill B=4 T=2048", (4, 2048, d, n, bf16), {}, None, None),
        ("ragged B=2 T=777 N=8 chunk 16", (2, 777, d, 8, bf16), dict(state=True), "split", 16),
        ("past the clamp B=1 T=2048 dt 2-3", (1, 2048, d, n, f32), dict(dt_range=(2.0, 3.0)),
         None, None),
        ("past the clamp B=1 T=777 dt 2-3", (1, 777, d, n, f32),
         dict(dt_range=(2.0, 3.0), state=True), "split", L),
    ]
    cases += [(f"prefill B=1 T=2048 chunk {c}", (1, 2048, d, n, bf16), {}, "split", c)
              for c in SPLIT_CHUNKS if c != split_chunk(1, 2048)]
    for b, t, dd, nn in SSM_SWEEP:
        cases += [(f"sweep {(b, t, dd, nn)}", (b, t, dd, nn, dt), {}, None, None)
                  for dt in (f32, bf16)]
    worst = {f32: 0.0, bf16: 0.0, "state": 0.0}
    before = ssm_scan.launches, dict(ssm_scan.route_launches)
    for label, shape, kw, route, chunk in cases:
        dtype = shape[4]
        args = _ssm_case(dev, g, *shape, **kw)
        took = route or ssm_scan_route(shape[1])
        at = ssm_scan.route_launches[took]
        y, h = ssm_scan(*args, route=route, chunk=chunk)
        if ssm_scan.route_launches[took] != at + 1:
            raise AssertionError(f"ssm_scan {label}: no launch on the {took} route")
        want, want_h = ssm_scan_ref(*args)
        torch.cuda.synchronize()
        scale = max(1.0, want.float().abs().max().item())
        rtol = SSM_BF16_RTOL if dtype == bf16 else 0.0
        err = (y.float() - want.float()).abs().max().item()
        h_scale = max(1.0, want_h.abs().max().item())
        h_err = (h - want_h).abs().max().item()
        line = (f"kernel ssm_scan {label} D={shape[2]} N={shape[3]} {str(dtype)[6:]} ({took}): "
                f"max_abs_err={err} (within {SSM_ATOL} x {scale} + {rtol} |y|), "
                f"state max_abs_err={h_err} (within {SSM_ATOL} x {h_scale}), "
                f"plain |y| max {want.float().abs().max().item()}")
        if not (torch.allclose(y.float(), want.float(), atol=SSM_ATOL * scale, rtol=rtol)
                and h_err <= SSM_ATOL * h_scale and y.dtype == want.dtype):
            raise AssertionError(f"ssm_scan differs from plain: {line}")
        worst[dtype] = max(worst[dtype], err)
        worst["state"] = max(worst["state"], h_err)
        log(line)
    # checking launches are not main-path launches
    ssm_scan.launches, ssm_scan.route_launches = before
    log(f"kernel ssm_scan: worst f32 {worst[f32]}, bf16 {worst[bf16]}, state {worst['state']}")
    return {"max_abs_err": max(worst.values())}


def time_ssm_scan(dev) -> dict:
    """Device time per call at hymba's prefill (B = 1, T = 2,048, D = 1,600,
    N = 16; four input sets, 52 MB, beyond the 50 MB L2) and decode (B = 8,
    T = 1 from a state; 64 state sets, 52 MB) shapes in bf16 (a and the
    state f32): the kernel's from CUDA events around calls queued behind a
    sleep (:func:`event_ms`), the prefill on both routes in turns (A B B A,
    5 rounds, :func:`ab_ms`), decode on its step route.  The plain
    version's decode the same way; its
    prefill launches ~8 kernels a step (16,000 a call), more than the launch
    queue holds behind a sleep, so it is timed by CUDA events around
    back-to-back calls (:func:`call_ms`): its host issue time counts.  The
    bound: the larger of the operations (per state entry and step: dt a,
    the exponential, the drive's product with b, the decay-and-add (2),
    the product with c and the sum, 7; 1 per channel and step for dt x)
    over the f32 peak, and the bytes (x, dt, b, c, a and the state in read
    once; y and the state out written once) over the HBM rate.  No PyTorch
    call computes the selective scan: library_ms is null.  Then the route
    grid (:func:`split_grid`)."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref, ssm_scan_route, split_chunk

    g = torch.Generator(dev).manual_seed(8)
    before = ssm_scan.launches, dict(ssm_scan.route_launches)
    out = {}
    d, n = SSM_D, SSM_N

    def draw(b, t, n_sets, state):
        return [_ssm_case(dev, g, b, t, d, n, torch.bfloat16, state=state)
                for _ in range(n_sets)]

    def routes(**kw):
        return {r: (lambda *a, r=r: ssm_scan(*a, route=r, **kw)) for r in ("step", "split")}

    for name, (b, t, n_sets, state) in {"prefill": (1, 2048, 4, False),
                                        "decode": (8, 1, 64, True)}.items():
        sets = draw(b, t, n_sets, state)
        flops = b * t * d * (7 * n + 1)
        moved = b * t * (3 * d + 2 * n) * 2 + d * n * 4 + b * d * n * 4 * (1 + state)
        bounds = {"operations": flops / F32_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        route = ssm_scan_route(t)
        rec = {"route": route}
        if t > 1:
            ab = ab_ms(routes(), sets, 20, 5)
            rec.update(ms=ab[route]["median"], step_ms=ab["step"]["median"],
                       split_ms=ab["split"]["median"], routes_ab=ab)
        else:
            rec["ms"] = event_ms(ssm_scan, sets, 200)
        rec.update({
            "plain_ms": (call_ms(ssm_scan_ref, sets, 2) if t > 1
                         else event_ms(ssm_scan_ref, sets, 20)),
            "plain_timed_by": "call_ms" if t > 1 else "event_ms",
            "library_ms": None,  # no PyTorch call computes the selective scan
            "bound_ms": bounds[bound_by],
            "bound_by": bound_by,
            "flops": flops,
            "bytes": moved,
            "call_ms": call_ms(ssm_scan, sets, 20 if t > 1 else 200),
        })
        out[name] = rec
        log(f"timing ssm_scan {name} B={b} T={t} D={d} N={n} bf16 (a, state f32): "
            f"{json.dumps(rec)}")
    out["grid"] = split_grid("ssm_scan", ssm_scan, lambda b, t: draw(b, t, 1, True)[0],
                             ssm_scan_route, split_chunk)
    # timing launches are not main-path launches
    ssm_scan.launches, ssm_scan.route_launches = before
    return out


def profile_burst(svc, reqs, out: Path) -> None:
    """torch.profiler over one batched burst; its tables go to ``out``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.gather(reqs, batching=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    write_profile(prof, wall, out / "gather_profile.txt",
                  f"batched burst of {len(reqs)} requests")


def write_profile(prof, wall: float, path: Path, what: str, busy_us: float | None = None) -> None:
    """The profile's tables to ``path``; the busy share is ``busy_us`` (the
    device time of the run ``wall`` timed; default: the whole trace's)."""
    events = prof.key_averages()
    if busy_us is None:
        busy_us = device_us(prof.events())
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=40)
        + "\n\n" + events.table(sort_by="self_device_time_total", row_limit=20)
    )
    log(f"profile: {what}, wall {wall * 1e3} ms, "
        f"device busy {busy_us / 1e3} ms ({100 * busy_us / 1e6 / wall}%)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = t_start = time.perf_counter()

    def elapsed(done: str) -> None:  # the run's time budget, phase by phase
        log(f"elapsed after {done}: {time.perf_counter() - t_start:.1f} s")

    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "entry function")) or (
                "error" in line.lower()
            ):
                log(f"ptxas {name}: {line.strip()}")
    rng = np.random.default_rng(0)
    checked = kernel_phase(dev, rng)
    service = service_phase(dev, N_REQUESTS, args.profile)
    elapsed("the Gather phases")
    app, starts, oracle = dapc_setup(dev)
    tables = chase_tables(dev, app)
    chase_checked = chase_kernel_phase(dev, rng, tables)
    dapc = dapc_phase(app, starts, oracle, args.profile)
    elapsed("the DAPC phases")
    filtered = filter_phase(dev, service.pop("table"))
    elapsed("the Filter phase")
    prop_cluster, propagated = propagation_phase(dev)
    reduced = reduce_phase(prop_cluster)
    del prop_cluster
    torch.cuda.empty_cache()
    elapsed("the propagation and reduce phases")
    floor = time_floor(dev, rng, tables)
    timing = time_kernel(dev, rng, floor, service["mean_n"])
    chase_timing = time_chase(dev, rng, tables, floor, dapc["mean_b"])
    host_launch = time_host_launch(dev, rng, tables, timing, chase_timing)
    del app, tables
    torch.cuda.empty_cache()
    elapsed("the embed_lookup and chase_shard timings")
    flash_checked = flash_kernel_phase(dev)
    flash_timing = time_flash(dev)
    elapsed("the flash kernel phase and timings")
    parity_phase(dev)
    serving = serving_phase(dev, args.profile)
    served = {"yi-9b": launch_serve_phase(dev)}
    elapsed("the yi-9b phases")
    wkv_checked = wkv6_kernel_phase(dev)
    wkv_timing = time_wkv6(dev)
    parity_phase(dev, "rwkv6-1.6b")
    rwkv_serving = serving_phase(dev, args.profile, "rwkv6-1.6b")
    served["rwkv6-1.6b"] = launch_serve_phase(dev, "rwkv6-1.6b")
    elapsed("the rwkv6-1.6b phases")
    ssm_checked = ssm_scan_kernel_phase(dev)
    ssm_timing = time_ssm_scan(dev)
    parity_phase(dev, "hymba-1.5b")
    hymba_serving = serving_phase(dev, args.profile, "hymba-1.5b")
    served["hymba-1.5b"] = launch_serve_phase(dev, "hymba-1.5b")
    elapsed("the hymba-1.5b phases")
    # the path's launches by the shape they come in: per-message dispatches
    # at N = 16 ids and B = 1 chase, batched ones at their arm's mean, and
    # launch.serve's remote embedding at N = 8 of each LM's rows
    g_arms, d_arms = service["arms"], dapc["arms"]
    embed_by_shape = {"message": g_arms["per_message"]["kernel_launches"],
                      "mean": sum(g_arms[a]["kernel_launches"] for a in ("batched", "zerocopy")),
                      **{f"remote {arch}": runs["remote"]["launches"]["embed_lookup"]
                         for arch, runs in served.items()}}
    chase_by_shape = {"message": d_arms["bitcode_per_message"]["kernel_launches"],
                      "mean": sum(d_arms[a]["kernel_launches"] for a in (
                          "bitcode_batched", "bitcode_zerocopy", "binary_batched"))}
    gaps = {name: {"launches_by_shape": by_shape,
                   "reachable_s": launch_gap(shapes, by_shape, "reachable_bound_ms"),
                   "bytes_s": launch_gap(shapes, by_shape, "bound_ms")}
            for name, shapes, by_shape in (("embed_lookup", timing, embed_by_shape),
                                           ("chase_shard", chase_timing, chase_by_shape))}
    log(f"timing launch-weighted gap, launches x (time - bound) by shape: {json.dumps(gaps)}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_keys = (*keys, "route", "call_ms", "reachable_bound_ms", "route_ms")
    kernels = [{
        "name": "embed_lookup",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embed_lookup.cu",
        "replaces": "src/repro/kernels/embed_lookup/kernel.py:50",
        "launches": service["launches"]["embed_lookup"],
        "launches_by_route": service["routes"],
        "launches_filter": filtered["launches"],
        "launches_by_route_filter": filtered["routes"],
        "launches_remote_embed": {arch: runs["remote"]["launches"]["embed_lookup"]
                                  for arch, runs in served.items()},
        "launches_by_route_remote_embed": {arch: runs["remote"]["routes"]["embed_lookup"]
                                           for arch, runs in served.items()},
        "max_abs_err": checked["max_abs_err"],
        **{k: timing["message"][k] for k in keys},
        "shape": f"message N={N_KEYS} f32 rows of {DIM} ({timing['message']['route']})",
        "shapes": {label: {"n": v["n"], **{k: v[k] for k in shape_keys}}
                   for label, v in timing.items()},
        "launch_floor_ms": floor["floor_ms"],
        "hop_latency_us": floor["hop_us"],
        "gap_s": gaps["embed_lookup"],
        "call_ratio_to_index_select": host_launch["ratio_to_index_select"]["embed_lookup"],
        "op_call_ratio_to_index_select": host_launch["ratio_in_turns"]["embed_lookup_op"],
    }, {
        "name": "chase_shard",
        "route": "cuda",
        "source": "src/repro_torch/csrc/chase.cu",
        "replaces": "src/repro/kernels/chase/kernel.py:70",
        "launches": dapc["launches"]["chase_shard"],
        "launches_by_route": dapc["routes"],
        "max_abs_err": chase_checked["max_abs_err"],
        **{k: chase_timing["message"][k] for k in keys},
        "shape": (f"message B=1 depth {DAPC_DEPTH} on the chain "
                  f"({chase_timing['message']['route']})"),
        "shapes": {label: {"b": v["b"], "table": v["table"], **{k: v[k] for k in shape_keys}}
                   for label, v in chase_timing.items()},
        "launch_floor_ms": floor["floor_ms"],
        "hop_latency_us": floor["hop_us"],
        "gap_s": gaps["chase_shard"],
        "call_ratio_to_index_select": host_launch["ratio_to_index_select"]["chase_shard"],
        "op_call_ratio_to_index_select": host_launch["ratio_in_turns"]["chase_shard_op"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": serving["launches"]["flash_attention"],
        "launches_hymba": hymba_serving["launches"]["flash_attention"],
        "launches_by_route": serving["routes"]["flash_attention"],
        "launches_by_route_hymba": hymba_serving["routes"]["flash_attention"],
        "max_abs_err": flash_checked["max_abs_err"],
        "max_abs_err_f32_probs": flash_checked["max_abs_err_f32_probs"],
        **{k: flash_timing["prefill"][k] for k in keys},
        "shape": "prefill B=1 S=T=2048 H=32 K=4 d=128 bf16 (wgmma; decodes: split)",
        "decode": {k: flash_timing["decode"][k] for k in keys},
        "hymba_prefill": {k: flash_timing["hymba_prefill"][k] for k in keys},
        "hymba_decode": {k: flash_timing["hymba_decode"][k] for k in keys},
    }, {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:91",
        "launches": rwkv_serving["launches"]["wkv6"],
        "launches_by_route": rwkv_serving["routes"]["wkv6"],
        "max_abs_err": wkv_checked["max_abs_err"],
        **{k: wkv_timing["prefill"][k] for k in keys},
        "shape": "prefill B=1 T=2048 H=32 M=64 bf16 (w f32) (split; decodes: step)",
        "step_ms": wkv_timing["prefill"]["step_ms"],
        "decode": {k: wkv_timing["decode"][k] for k in keys},
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:70",
        "launches": hymba_serving["launches"]["ssm_scan"],
        "launches_by_route": hymba_serving["routes"]["ssm_scan"],
        "max_abs_err": ssm_checked["max_abs_err"],
        **{k: ssm_timing["prefill"][k] for k in keys},
        "shape": "prefill B=1 T=2048 D=1600 N=16 bf16 (a f32) (split; decodes: step)",
        "step_ms": ssm_timing["prefill"]["step_ms"],
        "decode": {k: ssm_timing["decode"][k] for k in keys},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
