"""Drive the PyTorch port's Gather service, DAPC, Filter pushdown, tree collectives, control layers, compiled SPMD rendering, yi-9b, rwkv6-1.6b and hymba-1.5b serving and training once on an NVIDIA card.

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
9. Control-layer phases, each with the launch counts set to 0 before it:
   (a) tenancy: ``BENCH_tenancy.json``'s config (8 ``thor_bf2`` servers, a
   hot tenant at 8 requests a tick and 3 background tenants at 1, 40
   ticks, 64 rows a shard of 16 f32; hot slot quota 2, queue limit 10,
   credit budget 1; ``poll_budget`` 32, ``credit_window`` 8, 32 slots)
   through ``TenantRouter`` in the solo, shared and qos arms of
   ``benchmarks/tenancy.py``, on the card and on the CPU: equal
   ``report()`` dicts, logged beside that JSON's; then the same arms over
   the Gather table.  Every served request bit-identical to the table,
   shed ones never served, ``embed_lookup`` launched once per server
   dispatch; the p95 ratios, shed total and the hot tenant's credit stalls
   logged.  (b) loss: DAPC as in 5 at ``BENCH_reliability.json``'s loss
   rates (1%, 5%) and reliability config, per-message and batched, then
   the Gather service at 5% loss in its three planes (128 requests,
   per-message) and the Filter at 5% loss (256 windows at selectivity 0.25,
   pushdown per-message): oracle-identical, launches equal to server
   dispatches, retransmits and goodput logged.  (c) sandbox: the Gather service and
   the Filter under ``SandboxConfig.on()`` on all-``cuda-sm90`` PEs:
   oracle-identical, no refusal, cold verifies equal installs, a warm pass
   verifies nothing; then a torch-authored ``action_bomb`` refused and
   quarantined on every PE, the next batch still oracle-identical.  (d)
   autotune: a warm per-message DAPC run captured with ``capture``, saved
   and loaded back (``build/chip_smoke/``), ``replay_stats`` equal to the
   live counters; ``autotune`` for ``thor_xeon``, the profile installed by
   ``set_flow(profile=path)``, the run repeated oracle-identical; the
   replay's estimate logged beside the live ``modeled_us``.
9a. Compiled SPMD phase (``repro_torch.sharding``, ``attend_sp``): 4
   gloo ranks (``torch.multiprocessing``), all on the one card, each
   holding its shards there; gloo stages every collective through the
   host, so the walls are host numbers.  On a (1, 4) ("data", "model")
   mesh: ``dapc_shard_map`` (64 rounds, each one ``chase_shard`` launch of
   depth 1 and a psum of 256 int32) and ``gbpc_reference`` (the shards
   all-gathered, then 64 ``index_select`` hops) over the DAPC phase's
   chain (128 MiB a shard), both equal to the oracle, with 64 launches and
   64 x 256 x 4 collective bytes a rank (gbpc's bytes and the ratio
   logged); ``gather_shard_map`` over the service phase's table (512 MiB a
   shard), 1,024 requests x 16 keys, bit-identical to ``gather_ref``, one
   ``embed_lookup`` launch a rank.  On a (2, 2) mesh: ``embed_c2d`` and
   ``embed_gather`` on yi-9b's vocab table (64,000 x 4,096 bf16, seed 0)
   with launch.serve's ids (B = 4, S = 2,048), bit-identical to
   ``embed_plain``, c2d one ``bulk`` launch a rank; ``attend_sp`` over
   both axes at hymba's width (25/5 heads of 64, bf16, B = 1, S = 3,072,
   768 queries a rank), global and window 2,048, every rank bit-identical
   to one ``flash_attention`` call on the whole sequence and, like that
   call, within the flash phase's bounds (11) of the plain version, one
   ``wgmma`` launch a rank a layer; ``compressed_psum_with_feedback``
   and ``hierarchical_psum`` of one 25 MiB f32 bucket a rank: q, error
   and result equal to numpy's f32 arithmetic, the hierarchical sum
   within 3 f32 roundings of the f64 sum, the relative error and the
   int32 payload bytes against f32's logged.  Then one NCCL rank runs
   DAPC, GBPC and the Gather at the same sizes, oracle-identical.  The
   chain and the table reach the ranks as ``.npy`` files under
   ``build/chip_smoke/spmd`` (removed after); every rank counts its
   launches by route and its collective bytes from 0 for each arm.  The
   timings (10, 15) add the phase's kernel shapes: ``chase_shard`` at B
   = 256, depth 1, on a 2**25-entry shard; ``embed_lookup`` at N = 16,384
   of 512-byte rows and N = 4,096 of 8 KB bf16 rows; ``flash_attention``
   at S = 768 over T = 768-3,072, global and windowed.
10. Timing: the launch floor and the hop latency L (chase_shard's latency
   probe: one thread's dependent loads, 0 and 1,024 hops, __ldg and
   ld.global.cg in turns; L on the shard-sized cycle, from HBM and from L2);
   then ``embed_lookup`` at N = 16, the batched arm's mean N and 1,024 of
   512-byte rows and at launch.serve's remote embedding (N = 8 of each
   LM's d_model f32 rows) and at the Filter's shapes (one window of N = 24
   contiguous i32 rows, and its batched arms' windows a launch), and
   ``chase_shard`` at B = 1, the batched arm's
   mean B and 256 on the chain and 256 on the cycle,
   each route in turns (A B B A, 5 rounds, median and spread;
   ``index_select`` in the same turns, the reachable bound held against
   the routes' times alone), with device ms per call (CUDA
   events around calls queued behind a sleep; torch.profiler for the plain
   versions, which wait for the card inside a call), back-to-back call ms,
   the bytes bound and the reachable bound (floor + the larger of bytes
   and the dependent loads' latency); and the host side of a per-message
   call against ``index_select``'s (call ms of each wrapper and of its
   custom op as a traced slice calls it, in turns, and a CPU trace of 200
   calls of each).
   After the LM phases, the launch-weighted gap of both kernels by shape,
   against both bounds.
11. Flash kernel phase: ``flash_attention`` against its plain version at
   yi-9b's prefill (S = T = 300, 1,000 and 2,048, and S = 256 over a
   1,024-token prefix of a 2,048-slot cache) and decode (B = 8, S = 1 on
   cache views of T = 1, 129, 777, 4,096) shapes and at the five shapes of
   the JAX kernel sweep, in f32 and bf16, within 2e-5 / 2e-2; each bf16
   call also against the plain version on f32 copies of its inputs, within
   atol 1e-4 and rtol 1e-2.  Each line names the route the call took: bf16
   prefill on the tensor cores (``wgmma``), bf16 decode split over keys
   (``split``), f32 on the CUDA-core kernel (``simt``).
12. Parity phase: a 2-layer yi-9b at full width in f32, one set of weights
   from seed 0, 128 prompt tokens and 8 teacher-forced decode steps on the
   card (kernel) and on the CPU (plain version): logits within 1e-3, equal
   greedy tokens.
13. Serving phase: yi-9b at full width and 8 of its 48 layers (bf16,
   random weights drawn on the card) behind ``ServeScheduler(slots=8,
   t_max=4096)``: 16 requests with prompts of 256-3,072 tokens, 32 new
   tokens each, every logit finite, ``flash_attention`` launched 8 x
   (prefills + decode groups) times, 8 x prefills on the ``wgmma`` route
   and 8 x decode groups on the ``split`` route; then a profiled decode
   burst and prefill (busy share, the kernel's share).
14. ``repro_torch.launch.serve --no-smoke --batch 4 --prompt-len 2048
   --gen 32`` at full yi-9b (48 layers), local and with ``--remote-embed
   --embed-servers 2``: the two token streams bit-identical,
   ``embed_lookup`` launched in the remote run.
15. Times ``flash_attention`` at the prefill (S = T = 2,048) and decode
   (B = 8, T = 2,048) shapes, and at hymba's and attend_sp's, beside its plain version,
   ``scaled_dot_product_attention`` and its bound (operations or bytes),
   and logs each tensor-core and split instance's registers and spills
   from the build's ptxas report.
16. wkv6 kernel phase: ``wkv6`` against its plain version on both routes
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
17. Times ``wkv6`` at the prefill (both routes in turns) and decode shapes
   beside its plain version and its bound (no PyTorch call computes WKV6),
   then the route grid: both routes and the split at chunks of 16-256
   over B 1 and 4 and T 128-3,072.
18. The parity phase again on a 2-layer rwkv6-1.6b at full width (d_model
   2,048, 32 WKV heads, d_ff 7,168, vocab 65,536).
19. The serving phase on rwkv6-1.6b at full width and 6 of its 24 layers
   (bf16): the same 16 requests, ``wkv6`` launched 6 x (prefills + decode
   groups) times, 6 x prefills on the ``split`` route and 6 x decode
   groups on ``step``, and its profiled decode burst and prefill (the
   split's three device kernels a launch, each kernel's time by name).
20. ``launch.serve`` at full rwkv6-1.6b, local and remote-embed: streams
   bit-identical, ``wkv6`` launched 24 x (1 + 32) times in each, the
   prefill's on ``split`` and the steps' on ``step``.
21. ssm_scan kernel phase: ``ssm_scan`` against its plain version on both
   routes at hymba-1.5b's prefill (B = 1, T = 2,048, D = 1,600, N = 16) and
   decode (B = 8, T = 1 from a state) shapes, T = 777 from a state and T a
   step either side of a chunk, in bf16 and f32; launch.serve's B = 4, T =
   2,048; N = 8 in chunks of 16; the three shapes of the JAX ssm_scan sweep
   in f32 and bf16; decays whose 32-step sum passes -60 over T = 2,048 and
   over T = 777 from a state across chunk boundaries; each chunk length the
   grid times: outputs within 2e-5 of the largest (bf16 also 2**-7 of each
   value), states within 2e-5 of the largest; each call counted on its
   route. The flash phase (11) also holds hymba's windowed shapes (25/5
   heads of 64, window 2,048: prefill S = T = 3,000, decode T = 2,049 and
   4,096, and a global decode case), and the flash timing (15) adds hymba's
   windowed prefill (S = T = 3,072) and decode (B = 8, T = 4,096).
22. Times ``ssm_scan`` at the prefill (both routes in turns) and decode
   shapes beside its plain version and its bound (no PyTorch call computes
   the selective scan), then its route grid as for ``wkv6``.
23. The parity phase on a 2-layer hymba-1.5b at full width (d_model 1,600,
   25/5 heads, d_ff 5,504, vocab 32,001; both layers windowed) with a
   2,064-token prompt, so the 2,048 window bites at prefill and decode.
24. The serving phase on hymba-1.5b at full width and 8 of its 32 layers
   (bf16; layer 7 global): the same 16 requests, ``flash_attention`` and
   ``ssm_scan`` each launched 8 x (prefills + decode groups) times (flash on the ``wgmma`` and ``split``
   routes as for yi, ``ssm_scan`` on ``split`` and ``step``), and its
   profiled decode burst and prefill with both kernels' shares. Each burst
   line also logs, per kernel, the kernels recorded in the window, those
   matched to a launch in it by correlation id, the wrapper's launches in
   it and the names matched (ROADMAP T12).
25. ``launch.serve`` at full hymba-1.5b, local and remote-embed: streams
   bit-identical, each kernel launched 32 x (1 + 32) times in each.
26. Flash backward kernel phase: dQ, dK and dV of ``flash_attention_bwd``
   against its plain version on the same inputs, on the ``wgmma`` route
   (bf16: dK/dV and dQ on the tensor cores, P and dS rounded to bf16 in
   both) and the ``simt`` route (f32, and bf16 asked for by name: all in
   f32, so its plain version runs on f32 copies); bf16 ``wgmma`` also on
   f32 copies, within twice the plain bf16 version's own error there plus
   the f32-copies bound; and the plain version against ``torch.autograd``
   of the plain forward, at the JAX flash sweep's shapes, yi's train shape
   (B = 2, S = T = 4,096, bf16), hymba's windowed shape, a softcap, S < T
   and rows that see no key (dQ exactly 0), in f32 and bf16; then its time
   at yi's train shape, given the forward's lse, on both routes in turns,
   beside the function's bound (10 B H d a visible pair), the design's
   floor (14 B H d), the plain version, the forward kernel writing lse and
   SDPA's backward.
27. Train parity phase: a 2-layer yi-9b at full width in f32, one set of
   weights: the loss and every gradient on the card against the CPU, and
   after one AdamW step every weight, m and v.
28. Train phase: ``TrainDriver``'s step function and AdamW on yi-9b at full
   width, 8 of its 48 layers, bf16, remat, 4 sequences of 4,096 tokens a
   step in 2 microbatches, 6 steps over ``TokenPipeline`` batches: finite
   losses, weights that move, 32 flash forward and 16 backward launches a
   step, all 16 on ``wgmma``, and no plain version on the card; first,
   step 0's gradients on one microbatch through ``wgmma`` and through
   ``simt`` (global norm within 1%, each leaf's error logged); each step's
   seconds, tokens/s, peak memory and device seconds by stage, the last
   step profiled.
29. Driver phase: ``python -m repro_torch.launch.train --arch yi-9b
   --smoke --steps 12 --ckpt-every 5`` in subprocesses, clean and with
   ``--fail-at-step 8`` (one restart to step 5, the clean run's losses),
   the step-5 checkpoint restored with its sha256s, and a resume of the
   clean run to 17 steps that runs 5; then ``--arch rwkv6-1.6b --smoke`` and
   ``--arch hymba-1.5b --smoke``, clean and with ``--fail-at-step 8``, each
   replaying its clean run (the same checks as yi's); every restarted run's
   first and last losses equal its clean run's bit for bit.
30. wkv6 backward kernel phase: every gradient of ``wkv6_bwd`` (dr, dk, dv,
   dw, du, the initial state's) against ``wkv6_bwd_ref`` on the same inputs
   at rwkv6's train microbatch (B = 2, T = 4,096, H = 32, M = 64) in bf16
   with f32 w and in f32, at T = 100 (below the forward's split) and at T =
   777 in bf16 and in f32 from a state with a final-state cotangent and
   decays in [1e-30, 0.999], each on every route its dtype takes (bf16
   ``mma`` and ``split``, f32 ``split``): within 1e-4 of each gradient's
   largest (bf16 also 2**-7 of each value), two calls bit-identical, one
   launch a call counted under its route; then its time at the train shape,
   ``mma`` and ``split`` in turns with the forward kernel, beside the plain
   backward, each route's device kernels, the function's bound and the
   route's floor.
31. The same for ``ssm_scan_bwd`` (dx, ddt, da, db, dc, dh0; routes
   ``regs`` and ``split``) at hymba's train microbatch (B = 2, T = 4,096, D
   = 1,600, N = 16), T = 100, and T = 777 from a state with dt in 2-3.
32. Train parity (27) on a 2-layer rwkv6-1.6b and hymba-1.5b at full width
   in f32: each gradient within 1e-4 of its leaf's largest of the CPU's
   (rwkv6: within 2e-4 of an f64 run of the model on the card, the CPU's
   own error against it logged), the AdamW step within what that moves.
33. The train phase (28) on rwkv6-1.6b (24 layers) and hymba-1.5b (32
   layers) at full width and depth, bf16, remat, 4 x 4,096 tokens a step in
   2 microbatches, 4 steps: rwkv 96 ``wkv6`` and 48 ``wkv6_bwd`` launches a
   step (all ``mma``); hymba 128 ``ssm_scan``, 64 ``ssm_scan_bwd`` (all
   ``regs``), 128 flash forward and 64 flash backward (all ``wgmma``); no
   plain version on the card; each
   step's seconds, tokens/s, peak memory and device seconds by stage, and
   the profiled last step's share of each kernel kind.

Prints one JSON line of kernel results, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` last.  Any failure exits non-zero with
no result.  ``--profile DIR`` also writes torch.profiler tables of a short
batched Gather burst, of the batched DAPC arm and of the yi-9b decode and
prefill bursts (``lm_*``; ``rwkv_*`` for rwkv6-1.6b, ``hymba_*`` for
hymba-1.5b) to ``DIR``.  ``--grad-conditioning N`` runs only a sweep of
phase 32's rwkv6 reference: for N seeds of weights drawn on the card and
on the CPU, the CPU's and the kernels' f32 gradients against an f64 run on
the card.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from datetime import timedelta
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
# each row's log-sum-exp that the forward writes for the backward, against
# the plain one: f32 sums of O(1) terms in other orders, |lse| ~ 10, ~1e-6
FLASH_LSE_ATOL = 1e-4
# f32 card vs CPU over 2 full-width layers: |logit| is O(1) and the two
# sides sum 4,096- and 11,008-long f32 products in different orders
PARITY_ATOL, PARITY_PROMPT, PARITY_STEPS = 1e-3, 128, 8
# hymba's parity prompt passes its 2,048-token window, so the window bites
# at prefill and at every decode step
PARITY_PROMPT_BY_ARCH = {"hymba-1.5b": 2064}
SERVE_SLOTS, SERVE_T_MAX, SERVE_REQUESTS, SERVE_NEW = 8, 4096, 16, 32
SERVE_PROMPT_MIN, SERVE_PROMPT_MAX = 256, 3072
# the earlier slices' scheduler phases run at a cut depth, so that the whole
# run stays well inside its 1,200 s limit on a slow host (cut to 8, 6 and 8
# layers, hymba's global layer 7 kept, when the rwkv6 and hymba training
# phases came; 16, 12 and 32 before); their launch.serve phases still run
# the full model
SERVE_LAYERS = {"yi-9b": 8, "rwkv6-1.6b": 6, "hymba-1.5b": 8}
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
# exponentials (ex2 on the SFUs): 16 SFUs an SM against 128 f32 lanes, each
# lane's FMA two operations (NVIDIA H100 architecture white paper)
SFU_PER_S = F32_FLOPS / 16
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
# the control-layer phases: benchmarks/tenancy.py's table (64 rows a shard of
# 16 f32) and request size (up to 8 keys); the sandboxed Gather's and
# Filter's requests; the loss model's seed
TENANCY_ROWS, TENANCY_DIM, TENANCY_N_KEYS = 64, 16, 8
SANDBOX_REQUESTS, LOSS_SEED = 256, 1
# the compiled SPMD phase: 4 gloo ranks sharing the card, yi-9b's vocab
# table, hymba's longest prompt (768 queries a rank); a dead rank fails the
# others after SPMD_TIMEOUT
SPMD_RANKS, YI_VOCAB, YI_DIM, SPMD_SEQ = 4, 64_000, 4_096, 3_072
SPMD_TIMEOUT = timedelta(seconds=300)
SPMD_DIR = ROOT / "build" / "chip_smoke" / "spmd"
# the training phases (26-29).  The flash backward kernel and its plain
# version both compute in f32 from the same inputs and round once at the
# end: in f32 they differ by the order of their sums, each gradient a sum of
# up to T (dV, dK) or T (dQ) products of O(1) terms, ~1e-6 of the largest
# gradient; BWD_TOL of the largest |gradient| leaves room.  A bf16 gradient
# may round to the other neighbour of the same f32 value: one bf16 step,
# 2**-7 of the value (BWD_BF16_RTOL); against the plain version on f32
# copies of the inputs (no final rounding) half a step, 2**-8.  The wgmma
# route and its plain version also round P and dS to bf16, each from f32
# values summed in its own order: a row may move by one bf16 step of its
# largest rounded term (flash_attention_bwd_step_ref; tests/
# test_torch_flash_bwd.py shows a re-summed rendering needing it), and on
# f32 copies the route may err by up to twice the plain bf16 version's own
# error there.
BWD_TOL, BWD_BF16_RTOL, BWD_F32C_RTOL = 2e-5, 2**-7, 2**-8
YI_TRAIN = (2, 4096, 4096, 32, 4, 128)  # b, s, t, h, kh, d: train_4k's sequence, microbatch 2
# the train parity phase: a 2-layer yi-9b at full width in f32, card vs
# CPU.  The gradients are f32 on both sides, summed in other orders (4,096-
# and 11,008-long products, 128 positions, two layers forward and back,
# ~2.5e-5 of a leaf's largest gradient at f32's 6e-8 a rounding); each leaf
# within TRAIN_GRAD_RTOL of its largest |gradient|, the loss within
# PARITY_ATOL as the logits of phase 12.  After one AdamW step the moments
# and weights within what that gradient bound moves them (train_step_bound)
TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH, TRAIN_GRAD_RTOL, TRAIN_LR = 128, 1, 1e-4, 1e-3
# rwkv6's f32 gradients are not good to TRAIN_GRAD_RTOL at every draw:
# against an f64 run of the model on the card, six draws of these shapes
# (seeds 0-2 on each generator) put the CPU's 3.5e-5 to 9.9e-4 of a leaf's
# largest off and the kernels' 3.9e-5 to 1.7e-3, as the draw conditions
# them: the card's draws 1.1e-4 to 9.9e-4 (CPU), the CPU's 3.5e-5 to
# 1.7e-4, overlapping (PERF.md §6).  At this draw the CPU's are 3.7e-4
# off, the kernels' 1.2e-4 and the plain versions' on the card 2.6e-4
# (``--grad-conditioning``).  Its gradients are held to that f64
# run (:func:`_f64_grads`, rounded to f32) within TRAIN_F64_RTOL of a leaf's
# largest, set between the kernels' and the plain versions' readings; the
# CPU's error against it is logged
TRAIN_F64_REF, TRAIN_F64_RTOL = ("rwkv6-1.6b",), 2e-4
# the train phase: yi-9b at full width and 8 of its 48 layers, bf16, remat,
# train_4k's 4,096 tokens, 4 sequences a step in 2 microbatches
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCH, TRAIN_STEPS = 8, 4096, 4, 2, 6
# step 0's gradients through the backward's two routes: bf16 P and dS
# (wgmma) against f32 ones (simt) move the global norm by far less than 1%
TRAIN_ROUTE_RTOL = 0.01
TRAIN_DIR = ROOT / "build" / "chip_smoke" / "train"
# the recurrences' backward kernels against their plain versions (phases
# 30-31): both run the same f32 recurrence forward and back and sum in
# other orders (a gradient over up to T steps; dv over M key rows, db and
# dc over D channels, du and da over B T), ~1e-6 of the largest gradient;
# f32 within REC_BWD_TOL of each tensor's largest |gradient|.  A bf16
# gradient may also round to the other neighbour of the same f32 value: one
# bf16 step, REC_BWD_BF16_RTOL of the value
REC_BWD_TOL, REC_BWD_BF16_RTOL = 1e-4, 2.0**-7
REC_TRAIN = (2, 4096)  # b, t: rwkv6's and hymba's train microbatch
# the train phase's layers and steps by arch: yi at 8 of its 48 layers;
# rwkv6 and hymba at full depth (their weights, gradients and moments, ~25
# and ~22 GB, fit the card), 4 steps each
TRAIN_DEPTH = {"yi-9b": (TRAIN_LAYERS, TRAIN_STEPS), "rwkv6-1.6b": (24, 4),
               "hymba-1.5b": (32, 4)}
# each arch's path kernels a train step launches, forward and backward
TRAIN_KERNELS = {"yi-9b": (("flash_attention", "flash_attention_bwd"),),
                 "rwkv6-1.6b": (("wkv6", "wkv6_bwd"),),
                 "hymba-1.5b": (("flash_attention", "flash_attention_bwd"),
                                ("ssm_scan", "ssm_scan_bwd"))}
# weights that every step must move, by arch (the last layer's filled in)
TRAIN_PROBES = {"yi-9b": ("embed.tok", "blocks.0.wq", "blocks.{last}.wo2"),
                "rwkv6-1.6b": ("embed.tok", "blocks.0.tm.wr", "blocks.{last}.cm.wv"),
                "hymba-1.5b": ("embed.tok", "blocks.0.ssm.w_in", "blocks.{last}.wo2")}
# the driver phase: launch.train on yi smoke, 12 steps, a checkpoint every 5
DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_FAIL_AT, DRIVER_RESUME_TO = 12, 5, 8, 17


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


def once_ms(fn, *args) -> float:
    """Wall ms of one call that ends in a synchronize (CUDA events around
    it): for a plain version that issues tens of thousands of launches a
    call, seconds long, where a warm-up call would double the cost."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


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


def window_ids(rng, windows: int, lo: int, v_loc: int, dev) -> torch.Tensor:
    """The Filter's ids: ``windows`` shard-aligned windows of
    ``FILTER_WINDOW`` contiguous rows, at random in the shard."""
    starts = lo + rng.integers(0, v_loc // FILTER_WINDOW, windows) * FILTER_WINDOW
    ids = (starts[:, None] + np.arange(FILTER_WINDOW)).reshape(-1)
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def time_kernel(dev, rng, floor: dict, mean_n: float, filter_mean_n: float) -> dict:
    """Times at the shapes the path's launches come in: the Gather
    service's N = 16 ids (a message), its batched arm's mean N and N =
    1,024 (the largest bucket), into one f32 shard of 512-byte rows; and
    launch.serve's remote embedding, N = 8 ids (RemoteEmbedClient's
    n_keys) of each LM's d_model f32 rows; and the Filter's, one window of
    N = 24 contiguous rows a dispatch and its batched arms' windows a
    launch, as the rows' i32 bit patterns.  Each table holds 256 MiB.  And
    the compiled SPMD phase's: N = 16,384 ids of the Gather into one rank's
    1,048,576-row f32 shard (512 MiB), and N = 4,096 of embed_c2d into a
    32,000-row shard of yi-9b's bf16 vocab (8 KB rows), the ids uniform over
    every shard's rows, as the ranks' are.  Each shape has 128 distinct id
    sets, so the rows are cold in L2.  Each route and index_select (on the
    in-shard ids only: its yardstick, which writes fewer rows, so the
    reachable bound is held against the routes' times alone) in turns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_ref, embed_route
    from repro_torch.kernels.embed_lookup.kernel import ROUTES

    library = lambda t, i: torch.index_select(t, 0, i)  # yardstick, unused by the port
    saved = embed_lookup.launches, dict(embed_lookup.route_launches), embed_lookup.items
    # (label, ids, row width, Filter windows a launch or 0 for random ids,
    # and for an SPMD rank's launch: its table's dtype and rows and the
    # number of shards its ids spread over)
    timed = [("message", N_KEYS, DIM, 0, None), ("mean", max(1, round(mean_n)), DIM, 0, None),
             ("bucket64", MAX_SLOTS * N_KEYS, DIM, 0, None)]
    timed += [(f"remote {arch}", REMOTE_KEYS, get_config(arch).d_model, 0, None)
              for arch in PATH_KERNEL]
    batch = max(1, round(filter_mean_n / FILTER_WINDOW))
    timed += [("filter", FILTER_WINDOW, DIM, 1, None),
              ("filter_batched", batch * FILTER_WINDOW, DIM, batch, None)]
    timed += [("spmd gather", N_REQUESTS * N_KEYS, DIM, 0,
               (torch.float32, SHARD_ROWS * N_SERVERS // SPMD_RANKS, SPMD_RANKS)),
              ("spmd embed_c2d", LAUNCH_BATCH // 2 * LAUNCH_PROMPT, YI_DIM, 0,
               (torch.bfloat16, YI_VOCAB // 2, 2))]
    shapes, table = {}, None
    for label, n, dim, windows, spmd in timed:
        dtype, rows_n, shards = spmd or (torch.float32, SHARD_ROWS * DIM // dim, 0)  # 256 MiB
        lo = rows_n if shards else 3 * rows_n  # an SPMD table is rank 1's shard
        if table is None or table.shape != (rows_n, dim) or table.dtype != dtype:
            del table
            table = torch.randn(rows_n, dim, device=dev).to(dtype)
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        row = dim * table.element_size()
        if windows:  # the Filter resolves its window as the rows' bit patterns
            sets = [window_ids(rng, windows, lo, rows_n, dev) for _ in range(128)]
            args = [(table.view(torch.int32), ids, lo_t) for ids in sets]
        elif shards:  # an SPMD rank's ids: uniform over every shard's rows
            sets = [torch.from_numpy(rng.integers(0, shards * rows_n, n).astype(np.int32)).to(dev)
                    for _ in range(128)]
            args = [(table, ids, lo_t) for ids in sets]
        else:
            sets = [edge_ids(rng, n, lo, rows_n, dev) for _ in range(128)]
            args = [(table, ids, lo_t) for ids in sets]
        inside = [(ids.long() - lo >= 0) & (ids.long() - lo < rows_n) for ids in sets]
        lib_args = [(a[0], (ids.long() - lo)[m].contiguous())
                    for a, ids, m in zip(args, sets, inside)]
        n_in = sum(int(m.sum()) for m in inside) / len(sets)
        moved = n * 4 + n_in * row + n * row  # ids read, in-shard rows read, rows written
        fns = {r: (lambda i, r=r: embed_lookup(*args[i], route=r)) for r in ROUTES}
        fns["index_select"] = lambda i: library(*lib_args[i])
        ab = ab_ms(fns, [(i,) for i in range(len(args))], 100, 5)
        route = embed_route(n, row, True)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        hop, l2 = floor["hop_us"] / 1e3, floor["l2_us"] / 1e3
        least = min(ab[r]["median"] for r in ROUTES)
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
        kind = f"{windows} window(s) of i32" if windows else str(dtype)[6:]
        log(f"timing embed_lookup {label} n={n} {kind} rows of {row} B ({route}), {moved:.0f} B "
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
            items0 = embed_lookup.items
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
                ids_per_launch=(embed_lookup.items - items0) / launches if launches else None,
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
    batched = [c["arms"][a] for c in cells for a in ("batched", "zerocopy", "auto")
               if c["arms"][a]["kernel_launches"]]
    mean_n = (sum(a["ids_per_launch"] * a["kernel_launches"] for a in batched)
              / sum(a["kernel_launches"] for a in batched))
    return {"launches": launches, "routes": routes, "cells": cells, "wall_s": wall,
            "mean_n": mean_n}


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


def time_chase(dev, rng, tables, floor: dict, mean_b: float, chain: np.ndarray) -> dict:
    """Times at the shapes the DAPC path's launches come in: B = 1 chase (a
    message), the batched arm's mean B and B = 256, depth 64, into one
    2**24-entry shard of the DAPC chain (most chases leave after about one
    hop), and B = 256 on a cycle local to the shard (every chase takes its
    64 hops); and the compiled SPMD phase's round, B = 256 at depth 1 on one
    rank's 2**25-entry shard of ``chain`` with frontiers over the whole
    chain (a quarter in the shard); 128 distinct frontier sets a shape, so
    the shard is read from HBM.  Both routes in turns.  The bytes bound counts 16 B per chase
    (frontier and depth read and written) plus 4 B per hop taken; the
    reachable one the mean over the sets of a launch's longest chase, in
    loads of the probe's latency."""
    from repro_torch.kernels.chase import chase_route, chase_shard, chase_shard_ref
    from repro_torch.kernels.chase.kernel import ROUTES

    saved = chase_shard.launches, dict(chase_shard.route_launches), chase_shard.items
    n_loc = DAPC_ENTRIES // SPMD_RANKS
    kinds = {**tables, "spmd": (torch.from_numpy(chain[n_loc : 2 * n_loc]).to(dev), n_loc, 1)}
    shapes = {}
    for label, kind, b, hops_to in (
            ("message", "chain", 1, DAPC_DEPTH),
            ("mean", "chain", max(1, round(mean_b)), DAPC_DEPTH),
            ("bucket", "chain", DAPC_CHASES, DAPC_DEPTH),
            ("cycle", "cycle", DAPC_CHASES, DAPC_DEPTH), ("spmd", "spmd", DAPC_CHASES, 1)):
        table, lo, _ = kinds[kind]
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        depth = torch.full((b,), hops_to, dtype=torch.int32, device=dev)
        f_lo, f_hi = (0, DAPC_ENTRIES) if kind == "spmd" else (lo, lo + table.shape[0])
        sets = [torch.from_numpy(rng.integers(f_lo, f_hi, b).astype(np.int32)).to(dev)
                for _ in range(128)]
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
            "b": b, "depth": hops_to, "table": kind, "route": route, "ms": ab[route]["median"],
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
        log(f"timing chase_shard {label} {kind} B={b} depth {hops_to} ({route}), "
            f"{moved:.0f} B moved: {json.dumps(shapes[label])}; in turns (A B B A, 5 "
            f"rounds): {json.dumps(ab)}")
    del kinds
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


def flash_within(what: str, dtype, got, want, want32=None) -> tuple[str, float, float]:
    """flash_attention's ``got`` within FLASH_TOL[dtype] of the plain
    version's ``want`` (on inputs of ``dtype``) and, for bf16, within
    FLASH_F32P_* of ``want32`` (the plain version on f32 copies); raises
    where not.  Returns the log line and both errors (the second 0.0 where
    there is no ``want32``)."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = FLASH_TOL[dtype]
    line = (f"{what}: max_abs_err={err} (within {tol}), plain |out| max "
            f"{want.abs().max().item()} rms {want.square().mean().sqrt().item()}")
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"flash_attention differs from plain: {line}")
    err32 = 0.0
    if want32 is not None:
        err32 = (got - want32).abs().max().item()
        line += (f"; against f32 probabilities max_abs_err={err32} (within atol "
                 f"{FLASH_F32P_ATOL}, rtol {FLASH_F32P_RTOL})")
        if not torch.allclose(got, want32, atol=FLASH_F32P_ATOL, rtol=FLASH_F32P_RTOL):
            raise AssertionError(f"flash_attention differs from plain: {line}")
    return line, err, err32


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
    Each call must raise its route's launch count (``flash_route``) by one.
    Each call is made again writing each row's log-sum-exp, as the train
    step's forward does: the output bit-identical, the lse within
    FLASH_LSE_ATOL of the plain one (``flash_attention_lse_ref``)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_lse_ref, flash_attention_ref, flash_route,
    )
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

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
    worst = {f32: 0.0, bf16: 0.0, "f32_probs": 0.0, "lse": 0.0}
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
        got = flash_attention(q, k, v, **kw)
        if flash_attention.route_launches[route] != at + 1:
            raise AssertionError(f"flash_attention {label}: no launch on the {route} route")
        want = flash_attention_ref(q, k, v, **kw)
        want32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw) if dtype == bf16 \
            else None
        line, err, err32 = flash_within(
            f"kernel flash_attention {label} {str(dtype)[6:]} ({route})", dtype, got, want, want32)
        worst[dtype] = max(worst[dtype], err)
        worst["f32_probs"] = max(worst["f32_probs"], err32)
        at = flash_attention.route_launches[route]
        again, lse = flash_kernel._forward(q, k, v, kw["causal"], kw.get("softcap"), None,
                                           kw.get("window", 0), save_lse=True)
        if flash_attention.route_launches[route] != at + 1 or not torch.equal(again, got):
            raise AssertionError(f"flash_attention {label} {dtype}: writing lse changed the "
                                 f"{route} route's launch or output")
        lse_err = (lse - flash_attention_lse_ref(q, k, **kw)).abs().max().item()
        if not lse_err <= FLASH_LSE_ATOL:
            raise AssertionError(f"flash_attention {label} {dtype} ({route}): lse off the "
                                 f"plain one by {lse_err}")
        worst["lse"] = max(worst["lse"], lse_err)
        log(f"{line}; with lse: output bit-identical, lse max_abs_err={lse_err} "
            f"(within {FLASH_LSE_ATOL})")
    # checking launches are not main-path launches
    flash_attention.launches, flash_attention.route_launches = before
    return {"max_abs_err": max(worst[f32], worst[bf16]), "max_abs_err_f32_probs":
            worst["f32_probs"], "max_abs_err_lse": worst["lse"]}


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
    """``arch`` at full width (at the depth of SERVE_LAYERS: yi-9b 8 of 48,
    rwkv6-1.6b 6 of 24, hymba-1.5b 8 of 32 layers; bf16, random weights
    drawn on the card) behind ServeScheduler(slots 8,
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
    with its 2,048 window, and attend_sp's S = 768 queries a rank over T =
    768, 1,536, 2,304 and 3,072 keys at hymba's heads, global and windowed
    (SDPA given the window as a boolean mask), bf16: the kernel's from
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
    s_loc = SPMD_SEQ // SPMD_RANKS  # attend_sp's rank r: its queries over (r + 1) x s_loc keys
    hymba = [(name, b, s, t, HYMBA_WINDOW) for name, (b, s, t) in HYMBA_FLASH_TIMING.items()]
    hymba += [(f"spmd T={t}" + (f" window {w}" if w else ""), 1, s_loc, t, w)
              for t in range(s_loc, SPMD_SEQ + 1, s_loc) for w in (0, HYMBA_WINDOW)]
    for name, b, s, t, w in hymba:
        sets = [_flash_case(dev, g, b, s, t, h, kh, d, torch.bfloat16, None if s > 1 else t)
                for _ in range(1 if s > 1 else 8)]
        lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in qkv) for qkv in sets]
        # the pairs and keys this window leaves visible: query i sees
        # min(i + T - S + 1, w) keys; the K/V rows any query sees are read once
        win = w or t  # a global layer: every earlier key
        pairs = sum(min(i + t - s + 1, win) for i in range(s))
        keys = t - max(0, t - s - win + 1)
        flops = 4 * b * h * d * pairs
        moved = 2 * (2 * b * s * h * d + 2 * b * keys * kh * d)  # bf16 q, o, k, v
        bounds = {"operations": flops / BF16_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        pos = torch.arange(t, device=dev)
        qpos = pos[t - s :, None]
        mask = (pos[None, :] <= qpos) & (qpos - pos[None, :] < win)  # (S, T), True = visible
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


# ------------------------------------------------------------------ slice 10
def make_schedule(tenants, vocab: int, n_keys: int, duration: int, seed: int) -> list:
    """A copy of ``benchmarks/tenancy.py``'s ``make_schedule``: ``rate``
    uniform key batches a tenant a tick, drawn up front so that every arm
    replays the same offered load (a solo arm replays its tenant's part)."""
    rng = np.random.default_rng(seed)
    plan = []
    for _ in range(duration):
        tick_plan = []
        for name, rate in tenants:
            for _ in range(rate):
                n = int(rng.integers(1, n_keys + 1))
                tick_plan.append((name, rng.integers(0, vocab, n).astype(np.int32)))
        plan.append(tick_plan)
    return plan


def tenancy_arm(dev, classes, plan, cfg: dict, table: np.ndarray | None, n_keys: int) -> dict:
    """One arm of ``benchmarks/tenancy.py`` on the port: replay ``plan``
    through a ``TenantRouter`` over a fresh cluster, every accepted request
    bit-identical to the table's rows and shed ones never served; on the
    card ``embed_lookup`` launched once per server Gatherer dispatch."""
    from repro_torch.core import Cluster
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime import EmbedShardService, TenantRouter

    n_servers = cfg["n_servers"]
    vocab = TENANCY_ROWS * n_servers if table is None else table.shape[0]
    dim = TENANCY_DIM if table is None else table.shape[1]
    cl = Cluster(n_servers=n_servers, wire=cfg["profile"], device=dev)
    svc = EmbedShardService(cl, vocab=vocab, dim=dim, n_keys=n_keys,
                            max_slots=cfg["max_slots"], seed=0, table=table)
    names = {c.name for c in classes}
    server_invokes = lambda: sum(pe.stats.invokes for pe in cl.servers)
    launches0, inv0 = launch_counts()["embed_lookup"], server_invokes()
    t = time.perf_counter()
    svc.gather([b for tick in plan[:2] for name, b in tick if name in names]
               or [np.arange(1, n_keys + 1, dtype=np.int32)], batching=True)
    cl.set_batching(True)
    svc.batching = True
    cl.set_flow(lanes=True, credit_window=cfg["credit_window"], poll_budget=cfg["poll_budget"])
    router = TenantRouter(svc, classes)
    expected, done = {}, []
    for tick_plan in plan:
        for tenant, keys in tick_plan:
            if tenant in names:
                rid = router.submit(tenant, keys)
                if rid is not None:
                    expected[rid] = svc.table[keys]
        done += router.tick()
    ticks = len(plan)
    while svc.queue or svc.active:
        done += router.tick()
        ticks += 1
        if ticks > 200_000:
            raise AssertionError("tenancy arm did not drain in 200,000 ticks")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    served = [r for r in done if r.rid in expected]
    rids = [r.rid for r in served]
    for req in served:
        if req.degraded or not np.array_equal(req.rows.view(np.int32),
                                              expected[req.rid].view(np.int32)):
            raise AssertionError(f"tenancy: rid {req.rid} differs from the table's rows")
    if any(r.rid not in expected for r in done):
        raise AssertionError("tenancy: a request served that the router did not accept")
    attempts = sum(1 for tp in plan for name, _ in tp if name in names)
    shed = sum(st.shed for st in router.stats.values())
    if len(expected) + shed != attempts:
        raise AssertionError(f"tenancy: {len(expected)} accepted + {shed} shed != {attempts}")
    launches = launch_counts()["embed_lookup"] - launches0
    dispatches = server_invokes() - inv0
    if dev.type == "cuda" and (launches == 0 or launches != dispatches):
        raise AssertionError(f"tenancy: {launches} embed_lookup launches for {dispatches} "
                             f"server dispatches")
    return {
        "tenants": router.report(),
        "drain_ticks": ticks,
        "shed_total": shed,
        "shed_exactly_once": len(rids) == len(set(rids)) == len(expected),
        "credit_stalls": cl.fabric.stats.credit_stalls,
        "tenant_stalls": dict(cl.fabric.stats.tenant_stalls),
        "wall_s": wall, "server_dispatches": dispatches, "kernel_launches": launches,
    }


def tenancy_ab(dev, tenants, plan, cfg: dict, table: np.ndarray | None = None,
               n_keys: int = 8) -> dict:
    """``benchmarks/tenancy.py``'s A/B on the port: each tenant alone, all
    of them sharing one cluster with no QoS, and all of them under the QoS
    classes (the hot tenant's slot quota, queue limit and credit budget; the
    background tenants on the express lane); the same ratios."""
    from repro_torch.runtime import TenantClass

    bg = [name for name, _ in tenants if name != "hot"]
    qos = [TenantClass("hot", slot_quota=cfg["hot_slot_quota"],
                       queue_limit=cfg["hot_queue_limit"],
                       credit_budget=cfg["hot_credit_budget"])]
    qos += [TenantClass(name, express=True) for name in bg]
    arm = lambda classes: tenancy_arm(dev, classes, plan, cfg, table, n_keys)
    solo = {name: arm([TenantClass(name)]) for name, _ in tenants}
    shared = arm([TenantClass(name) for name, _ in tenants])
    q = arm(qos)
    p95 = lambda a, n: max(a["tenants"][n]["p95_ticks"], 1.0)
    return {
        "solo": solo, "shared": shared, "qos": q,
        "bg_p95_ratio": round(max(p95(q, n) / p95(solo[n], n) for n in bg), 2),
        "bg_p95_ratio_unprotected": round(max(p95(shared, n) / p95(solo[n], n) for n in bg), 2),
        "hot_p95_ratio": round(p95(q, "hot") / p95(solo["hot"], "hot"), 2),
        "shed_total": q["shed_total"],
        "hot_credit_stalls": q["tenant_stalls"].get("hot", 0),
        "launches": sum(a["kernel_launches"] for a in (*solo.values(), shared, q)),
    }


REPORT_KEYS = ("tenants", "drain_ticks", "shed_total", "shed_exactly_once",
                "credit_stalls", "tenant_stalls")


def tenancy_reports(ab: dict) -> dict:
    """The device-free part of an A/B: every arm's reports and counts."""
    arms = {f"solo {n}": a for n, a in ab["solo"].items()}
    arms |= {"shared": ab["shared"], "qos": ab["qos"]}
    return {name: {k: a[k] for k in REPORT_KEYS} for name, a in arms.items()}


def tenancy_phase(dev, table: np.ndarray) -> dict:
    """``BENCH_tenancy.json``'s config on the card and on the CPU in this
    process, equal reports; then the same tenant mix over the Gather
    phase's table on the card."""
    from repro_torch.kernels import launch_counts, reset_launches

    ref = json.loads((ROOT / "BENCH_tenancy.json").read_text())
    cfg = ref["config"]
    reset_launches()  # the tenant-routed Gather's launches are counted from here
    tenants = [("hot", cfg["hot_rate"])] + [(f"bg{i}", cfg["bg_rate"]) for i in range(cfg["n_bg"])]
    plan = make_schedule(tenants, TENANCY_ROWS * cfg["n_servers"], TENANCY_N_KEYS,
                         cfg["duration"], 1)
    t = time.perf_counter()
    card = tenancy_ab(dev, tenants, plan, cfg, n_keys=TENANCY_N_KEYS)
    wall_card = time.perf_counter() - t
    t = time.perf_counter()
    host = tenancy_ab(torch.device("cpu"), tenants, plan, cfg, n_keys=TENANCY_N_KEYS)
    wall_host = time.perf_counter() - t
    if tenancy_reports(card) != tenancy_reports(host):
        raise AssertionError(f"tenancy: card reports {json.dumps(tenancy_reports(card))} "
                             f"differ from the CPU's {json.dumps(tenancy_reports(host))}")
    bench = {f"solo {n}": a for n, a in ref["solo"].items()} | {
        "shared": ref["shared"], "qos": ref["qos"]}
    bench = {name: {k: a[k] for k in REPORT_KEYS} for name, a in bench.items()}
    heads = ("bg_p95_ratio", "bg_p95_ratio_unprotected", "hot_p95_ratio", "shed_total",
             "hot_credit_stalls")
    log(f"tenancy BENCH_tenancy.json config: card and CPU reports equal; wall_s card "
        f"{wall_card}, CPU {wall_host}; {card['launches']} embed_lookup launches = server "
        f"dispatches; "
        f"reports equal to BENCH_tenancy.json's: {tenancy_reports(card) == bench}; "
        f"{json.dumps({k: card[k] for k in heads})} (BENCH_tenancy.json "
        f"{json.dumps({k: ref[k] for k in heads})}); qos arm {json.dumps(card['qos']['tenants'])}")
    vocab = table.shape[0]
    big_plan = make_schedule(tenants, vocab, TENANCY_N_KEYS, cfg["duration"], 1)
    t = time.perf_counter()
    big = tenancy_ab(dev, tenants, big_plan, cfg, table=table, n_keys=TENANCY_N_KEYS)
    wall = time.perf_counter() - t
    arms = {name: {k: a[k] for k in ("tenants", "wall_s", "server_dispatches",
                                     "kernel_launches", "tenant_stalls")}
            for name, a in (("shared", big["shared"]), ("qos", big["qos"]))}
    log(f"tenancy over the Gather table ({vocab}x{table.shape[1]} f32, {cfg['n_servers']} "
        f"servers): every served request bit-identical, shed ones unserved; "
        f"{json.dumps({k: big[k] for k in heads})}; {big['launches']} embed_lookup launches "
        f"= server dispatches; phase wall_s {wall}; {json.dumps(arms)}")
    launches = launch_counts()["embed_lookup"]
    if launches != card["launches"] + big["launches"]:
        raise AssertionError(f"tenancy: {launches} embed_lookup launches in the phase, "
                             f"{card['launches'] + big['launches']} in its arms")
    return {"launches": launches, "bench": card, "table": big}


def server_work(cl) -> tuple[int, int]:
    """Server dispatches and retransmits so far, summed over the PEs."""
    return (sum(pe.stats.invokes for pe in cl.servers),
            sum(pe.stats.retransmits for pe in cl.pes()))


def loss_phase(dev, app, starts, oracle, table: np.ndarray, lossless: dict) -> dict:
    """DAPC at ``BENCH_dapc.json``'s traffic on the 2**27 chain at
    ``BENCH_reliability.json``'s loss rates and reliability config,
    per-message and batched, then the Gather service at 5% loss in its three
    planes and the Filter at 5% loss: every run equal to the oracle, and each
    kernel launched once per server dispatch (a duplicate dropped at the seq
    gate launches nothing)."""
    from repro_torch.core import Cluster, DataPlaneConfig, ReliabilityConfig
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.runtime import EmbedShardService, FilterShardService, ragged_batches

    reset_launches()  # the lossy DAPC and Gather launches are counted from here
    rel = json.loads((ROOT / "BENCH_reliability.json").read_text())["config"]
    cfg = ReliabilityConfig.on(**{k: v for k, v in rel["reliability"].items() if k != "enabled"})
    cl = app.cluster
    cl.set_reliability(cfg)
    out, chase_dispatches = {}, 0
    for rate in rel["loss_rates"]:
        for name, batching in (("per_message", False), ("batched", True)):
            cl.fabric.set_loss(rate, seed=LOSS_SEED)
            (inv0, retx0), launches0 = server_work(cl), launch_counts()["chase_shard"]
            t = time.perf_counter()
            rep = app.dapc(starts, DAPC_DEPTH, batching=batching)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if not np.array_equal(rep.results, oracle):
                raise AssertionError(f"dapc loss {rate} {name}: results differ from the oracle")
            (inv, retx), launches = server_work(cl), launch_counts()["chase_shard"] - launches0
            if launches == 0 or launches != inv - inv0:
                raise AssertionError(f"dapc loss {rate} {name}: {launches} chase_shard "
                                     f"launches for {inv - inv0} server dispatches")
            lost = cl.fabric.stats.frames_lost
            if lost == 0 or retx == retx0:
                raise AssertionError(f"dapc loss {rate} {name}: {lost} frames lost, "
                                     f"{retx - retx0} retransmits")
            clean = lossless[f"bitcode_{name}"]
            arm = dict(wall_s=wall, server_dispatches=inv - inv0, kernel_launches=launches,
                       frames_lost=lost, retransmits=retx - retx0, rounds=rep.rounds,
                       goodput_chases_per_round=DAPC_CHASES / rep.rounds,
                       lossless_rounds=clean["rounds"], lossless_wall_s=clean["wall_s"],
                       puts=rep.puts, modeled_us=rep.modeled_us)
            out[f"dapc {rate} {name}"] = arm
            chase_dispatches += inv - inv0
            log(f"loss dapc {rate} {name}: oracle-identical, {json.dumps(arm)}")
    cl.fabric.set_loss(0.0)
    cl.set_reliability(None)
    vocab = table.shape[0]
    gcl = Cluster(n_servers=N_SERVERS, wire="thor_xeon", device=dev)
    svc = EmbedShardService(gcl, vocab=vocab, dim=DIM, n_keys=N_KEYS, max_slots=MAX_SLOTS,
                            table=table)
    reqs = ragged_batches(vocab, rel["offered"], N_KEYS, seed=3)
    want = svc.oracle(reqs)
    svc.gather([np.array([s * svc.rows_per_shard], np.int32) for s in range(N_SERVERS)])
    gcl.set_reliability(cfg)
    gcl.fabric.set_loss(0.05, seed=LOSS_SEED)
    planes = {"framed": None, "zerocopy": DataPlaneConfig.zero_copy(eager_max=0),
              "rendezvous": DataPlaneConfig.rendezvous(rndv_min=1)}
    for plane, dataplane in planes.items():
        (inv0, retx0), launches0 = server_work(gcl), launch_counts()["embed_lookup"]
        t = time.perf_counter()
        # per-message: a batched zero-copy burst under loss returns zeros in
        # both packages (ROADMAP T14)
        rep = svc.gather(reqs, dataplane=dataplane)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for i, (got, w) in enumerate(zip(rep.results, want)):
            if not np.array_equal(got.view(np.int32), w.view(np.int32)):
                raise AssertionError(f"gather loss {plane}: request {i} differs from the oracle")
        (inv, retx), launches = server_work(gcl), launch_counts()["embed_lookup"] - launches0
        if launches == 0 or launches != inv - inv0:
            raise AssertionError(f"gather loss {plane}: {launches} embed_lookup launches for "
                                 f"{inv - inv0} server dispatches")
        arm = dict(wall_s=wall, server_dispatches=inv - inv0, kernel_launches=launches,
                   frames_lost=gcl.fabric.stats.frames_lost,
                   region_writes_lost=gcl.fabric.stats.region_writes_lost,
                   retransmits=retx - retx0, rounds=rep.rounds,
                   goodput_requests_per_round=len(reqs) / rep.rounds, puts=rep.puts)
        out[f"gather 0.05 {plane}"] = arm
        log(f"loss gather 0.05 {plane}: oracle-identical, {json.dumps(arm)}")
    embed_dispatches = sum(pe.stats.invokes for pe in gcl.servers)
    del svc, gcl
    fcl = Cluster(n_servers=N_SERVERS, wire="thor_xeon", hetero_wire=True, device=dev)
    fsvc = FilterShardService(fcl, vocab=vocab, dim=DIM, window=FILTER_WINDOW,
                              max_slots=MAX_SLOTS, table=table)
    fsvc.filter([s * fsvc.rows_per_shard for s in range(N_SERVERS)], 0.0, placement="pushdown")
    fcl.set_reliability(cfg)
    fcl.fabric.set_loss(0.05, seed=LOSS_SEED)
    los = fsvc.windows(FILTER_REQUESTS, seed=1)
    thresh = fsvc.thresh_for_selectivity(0.25)
    (inv0, retx0), launches0 = server_work(fcl), launch_counts()["embed_lookup"]
    t = time.perf_counter()
    rep = fsvc.filter(los, thresh, placement="pushdown")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for i, (got, w) in enumerate(zip(rep.results, fsvc.oracle_filter(los, thresh))):
        if not np.array_equal(got.view(np.int32), w.view(np.int32)):
            raise AssertionError(f"filter loss: window {i} differs from the oracle")
    (inv, retx), launches = server_work(fcl), launch_counts()["embed_lookup"] - launches0
    if launches == 0 or launches != inv - inv0 or fcl.fabric.stats.frames_lost == 0:
        raise AssertionError(f"filter loss: {launches} embed_lookup launches for {inv - inv0} "
                             f"server dispatches, {fcl.fabric.stats.frames_lost} frames lost")
    arm = dict(wall_s=wall, server_dispatches=inv - inv0, kernel_launches=launches,
               frames_lost=fcl.fabric.stats.frames_lost, retransmits=retx - retx0,
               rounds=rep.rounds, goodput_windows_per_round=len(los) / rep.rounds,
               puts=rep.puts)
    out["filter 0.05 pushdown"] = arm
    log(f"loss filter 0.05 pushdown sel=0.25: oracle-identical, {json.dumps(arm)}")
    launches = launch_counts()
    want_counts = {"chase_shard": chase_dispatches,
                   "embed_lookup": embed_dispatches + sum(pe.stats.invokes for pe in fcl.servers)}
    if {k: launches[k] for k in want_counts} != want_counts:
        raise AssertionError(f"loss: launches {launches} in the phase for server dispatches "
                             f"{want_counts}")
    return {"arms": out, "launches": launches}


def action_bomb():
    """A hostile ifunc authored for the port: it emits an ``A_RETURN`` row
    without declaring a ``returns:`` dep, an action its capability stamp can
    never hold (``tests/test_sandbox.py``'s fixture, in torch ops)."""
    from repro_torch.core import A_RETURN, ACTION_WIDTH, IFunc, ShapeDtypeStruct

    def entry(payload):
        z = payload[0] * 0
        return torch.stack([z + A_RETURN, z, z + 1, payload[0]] + [z] * (ACTION_WIDTH - 4))

    return IFunc.build(name="action_bomb", fn=entry,
                       payload_aval=ShapeDtypeStruct((1,), torch.int32), abi="xrdma")


def sandbox_phase(dev, table: np.ndarray) -> dict:
    """The Gather service and the Filter under ``SandboxConfig.on()`` on
    all-``cuda-sm90`` PEs: oracle-identical, no refusal, one cold verify a
    PE install, a warm pass all stamp hits; then a torch-authored
    ``action_bomb`` refused and quarantined cluster-wide while the next
    healthy batch still completes."""
    from repro_torch.core import Cluster, SandboxConfig, SandboxViolation
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.runtime import EmbedShardService, FilterShardService, ragged_batches

    reset_launches()  # the sandboxed Gather and Filter launches are counted from here
    vocab = table.shape[0]
    verifies = lambda cl: sum(pe.verifier.verifies for pe in cl.pes())
    installs = lambda cl: sum(pe.stats.ifunc_installs for pe in cl.pes())
    hits = lambda cl: sum(pe.verifier.stamp_hits for pe in cl.pes())

    def run(name, cl, fn, want) -> dict:
        """One oracle-checked pass that refuses nothing new and launches
        ``embed_lookup`` once per server dispatch, on all-cuda-sm90 PEs."""
        launches0 = launch_counts()["embed_lookup"]
        inv0, refused = sum(pe.stats.invokes for pe in cl.servers), cl.refusals()
        t = time.perf_counter()
        rep = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for i, (got, w) in enumerate(zip(rep.results, want)):
            if not np.array_equal(got.view(np.int32), w.view(np.int32)):
                raise AssertionError(f"sandbox {name}: request {i} differs from the oracle")
        if cl.refusals() != refused:
            raise AssertionError(f"sandbox {name}: refusals {cl.refusals()}, before {refused}")
        launches = launch_counts()["embed_lookup"] - launches0
        dispatches = sum(pe.stats.invokes for pe in cl.servers) - inv0
        if launches == 0 or launches != dispatches:
            raise AssertionError(f"sandbox {name}: {launches} embed_lookup launches for "
                                 f"{dispatches} server dispatches")
        if any(pe.triple != "cuda-sm90" for pe in cl.pes()):
            raise AssertionError(f"sandbox {name}: a PE is not cuda-sm90")
        arm = dict(server_dispatches=dispatches, kernel_launches=launches,
                   verifies=verifies(cl), installs=installs(cl), stamp_hits=hits(cl),
                   wall_s=wall)
        log(f"sandbox {name}: oracle-identical, no refusal, {json.dumps(arm)}")
        return arm

    out = {}
    cl = Cluster(n_servers=N_SERVERS, wire="thor_xeon", device=dev)
    svc = EmbedShardService(cl, vocab=vocab, dim=DIM, n_keys=N_KEYS, max_slots=MAX_SLOTS,
                            table=table)
    cl.set_sandbox(SandboxConfig.on())
    reqs = ragged_batches(vocab, SANDBOX_REQUESTS, N_KEYS, seed=4)
    want = svc.oracle(reqs)
    gather = lambda: svc.gather(reqs, batching=True)
    out["gather cold"] = cold = run("gather cold", cl, gather, want)
    if cold["verifies"] != cold["installs"] or cold["verifies"] == 0:
        raise AssertionError(f"sandbox gather: {cold['verifies']} cold verifies for "
                             f"{cold['installs']} installs")
    out["gather warm"] = warm = run("gather warm", cl, gather, want)
    if warm["verifies"] != cold["verifies"] or warm["stamp_hits"] <= cold["stamp_hits"]:
        raise AssertionError(f"sandbox gather warm: {warm['verifies'] - cold['verifies']} "
                             f"verifies, {warm['stamp_hits'] - cold['stamp_hits']} stamp hits")
    bomb = action_bomb()
    cl.toolchain.publish(bomb)
    hexd = bomb.digest.hex()
    cl.client.send_ifunc("server0", "action_bomb", np.array([3], np.int32))
    launches0 = launch_counts()["embed_lookup"]
    try:
        cl.drain()
    except SandboxViolation as e:
        refused = str(e)
    else:
        raise AssertionError("sandbox: the action_bomb was not refused")
    if launch_counts()["embed_lookup"] != launches0:
        raise AssertionError("sandbox: the action_bomb launched a kernel")
    roll = cl.refusals()
    if roll.get("verify_action") != 1 or any(hexd not in pe.verifier.quarantined
                                             for pe in cl.pes()):
        raise AssertionError(f"sandbox: action_bomb refusals {roll}, not quarantined everywhere")
    if any(pe.target_cache.has_name("action_bomb") for pe in cl.pes()):
        raise AssertionError("sandbox: the action_bomb is still installed")
    healthy = reqs[:64]
    out["gather after the bomb"] = run("gather after the bomb", cl, lambda: svc.gather(
        healthy, batching=True), svc.oracle(healthy))
    log(f"sandbox action_bomb: refused ({refused}), quarantined on all {len(cl.pes())} PEs, "
        f"refusals {roll}; the next {len(healthy)} requests oracle-identical")
    del svc, cl
    fcl = Cluster(n_servers=N_SERVERS, wire="thor_xeon", hetero_wire=True, device=dev)
    fsvc = FilterShardService(fcl, vocab=vocab, dim=DIM, window=FILTER_WINDOW,
                              max_slots=MAX_SLOTS, table=table)
    fcl.set_sandbox(SandboxConfig.on())
    los = fsvc.windows(SANDBOX_REQUESTS, seed=1)
    thresh = fsvc.thresh_for_selectivity(0.25)
    fwant = fsvc.oracle_filter(los, thresh)
    for name, batching in (("filter cold", False), ("filter warm", True)):
        out[name] = run(name, fcl, lambda b=batching: fsvc.filter(
            los, thresh, batching=b, placement="pushdown"), fwant)
    if out["filter cold"]["verifies"] != out["filter cold"]["installs"]:
        raise AssertionError(f"sandbox filter: {out['filter cold']['verifies']} cold verifies "
                             f"for {out['filter cold']['installs']} installs")
    if out["filter warm"]["verifies"] != out["filter cold"]["verifies"]:
        raise AssertionError("sandbox filter warm: a warm pass verified code")
    launches = launch_counts()["embed_lookup"]
    if launches != sum(a["kernel_launches"] for a in out.values()):
        raise AssertionError(f"sandbox: {launches} embed_lookup launches in the phase, "
                             f"{sum(a['kernel_launches'] for a in out.values())} in its arms")
    return {"arms": out, "launches": launches}


def autotune_phase(app, starts, oracle) -> dict:
    """A warm per-message DAPC run captured on the card, saved and loaded
    back, its replay equal to the live counters; ``autotune`` for
    ``thor_xeon`` on it, the profile installed through ``set_flow(profile=
    path)`` and the run repeated, equal to the oracle."""
    from repro_torch.analysis import (
        ReplayModel, autotune, capture, load_trace, pe_stats_subset, replay_stats, save_trace,
    )
    from repro_torch.kernels import launch_counts, reset_launches

    reset_launches()  # the captured and tuned DAPC launches are counted from here
    cl = app.cluster
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)

    def run(name, **kw):
        inv0, launches0 = server_work(cl)[0], launch_counts()["chase_shard"]
        t = time.perf_counter()
        rep = app.dapc(starts, DAPC_DEPTH, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if not np.array_equal(rep.results, oracle):
            raise AssertionError(f"autotune {name}: results differ from the oracle")
        launches = launch_counts()["chase_shard"] - launches0
        if launches == 0 or launches != server_work(cl)[0] - inv0:
            raise AssertionError(f"autotune {name}: {launches} chase_shard launches for "
                                 f"{server_work(cl)[0] - inv0} server dispatches")
        return rep, wall, launches

    before = {pe.name: pe_stats_subset(pe.stats) for pe in cl.pes()}
    with capture(cl, meta={"workload": "dapc", "chases": DAPC_CHASES, "depth": DAPC_DEPTH}) as rec:
        rep, wall, launches = run("captured")
    path = out_dir / "dapc_trace.jsonl"
    t = time.perf_counter()
    save_trace(rec, str(path))
    trace = load_trace(str(path))
    io_s = time.perf_counter() - t
    traffic, pes = replay_stats(trace)
    if traffic.as_dict() != cl.fabric.stats.as_dict():
        raise AssertionError("autotune: replay_stats differs from the live TrafficStats")
    for pe in cl.pes():
        after = pe_stats_subset(pe.stats)
        delta = {k: after[k] - before[pe.name][k] for k in after}
        if pes.get(pe.name, dict.fromkeys(delta, 0)) != delta:
            raise AssertionError(f"autotune: replayed {pe.name} {pes.get(pe.name)} != live {delta}")
    t = time.perf_counter()
    report = autotune(trace, wire="thor_xeon", seed=0)
    tune_s = time.perf_counter() - t
    prof = report.profile
    prof_path = out_dir / "dapc_flow_profile.json"
    prof.save(str(prof_path))
    cl.set_flow(profile=str(prof_path))
    tuned, tuned_wall, tuned_launches = run("tuned", batching=prof.batching,
                                            dataplane=prof.dataplane())
    estimate = ReplayModel(trace).cost(prof)
    res = dict(events=len(trace), trace_bytes=path.stat().st_size, save_load_s=io_s,
               captured_wall_s=wall, captured_launches=launches,
               captured_modeled_us=rep.modeled_us, replay_default_us=report.default_us,
               tune_s=tune_s, evaluations=report.evaluations, profile=prof.as_dict(),
               tuned_wall_s=tuned_wall, tuned_launches=tuned_launches,
               tuned_modeled_us=tuned.modeled_us, replay_tuned_us=estimate,
               improvement_pct=report.improvement_pct)
    log(f"autotune dapc: replay_stats equals the live counters ({len(trace)} events); tuned "
        f"run oracle-identical; replay {estimate} us beside live {tuned.modeled_us} us "
        f"(default: replay {report.default_us} beside live {rep.modeled_us}); {json.dumps(res)}")
    if launch_counts()["chase_shard"] != launches + tuned_launches:
        raise AssertionError(f"autotune: {launch_counts()['chase_shard']} chase_shard "
                             f"launches in the phase, {launches + tuned_launches} in its runs")
    return {"launches": launches + tuned_launches, **res}


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (bf16 through its int16 bits)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def spmd_starts() -> np.ndarray:
    """``dapc_setup``'s starts: the DAPC phase's 256 chases."""
    return np.random.default_rng(1).integers(0, DAPC_ENTRIES, DAPC_CHASES).astype(np.int32)


def gather_keys() -> np.ndarray:
    """The Gather service's 1,024 requests at its 16 keys each."""
    keys = np.random.default_rng(1).integers(0, SHARD_ROWS * N_SERVERS, N_REQUESTS * N_KEYS)
    return keys.astype(np.int32)


def yi_vocab(dev) -> tuple[torch.Tensor, torch.Tensor]:
    """yi-9b's vocab table (f32 drawn from seed 0, then rounded to bf16: the
    same bits in every process) and launch.serve's (B, S) ids."""
    ids = np.random.default_rng(2).integers(0, YI_VOCAB, (LAUNCH_BATCH, LAUNCH_PROMPT))
    table = torch.randn(YI_VOCAB, YI_DIM, generator=torch.Generator(dev).manual_seed(0),
                        device=dev)
    return table.to(torch.bfloat16), torch.from_numpy(ids.astype(np.int32)).to(dev)


def hymba_qkv(dev) -> tuple[torch.Tensor, ...]:
    """q, k, v at hymba-1.5b's width (25/5 heads of 64), B = 1, S = 3,072,
    bf16, from seed 5."""
    h, kh, d = HYMBA_HEADS
    g = torch.Generator(dev).manual_seed(5)
    return tuple(torch.randn(1, SPMD_SEQ, n, d, generator=g, device=dev).to(torch.bfloat16)
                 for n in (h, kh, kh))


def grad_bucket(dev, rank: int) -> torch.Tensor:
    """Rank ``rank``'s f32 gradient bucket of REDUCE_WIDTH values."""
    g = torch.Generator(dev).manual_seed(100 + rank)
    return torch.randn(REDUCE_WIDTH, generator=g, device=dev)


def npy_shard(path: Path, mesh) -> torch.Tensor:
    """This rank's rows of the array saved at ``path`` over ``"model"``, read
    from a memory map, on the mesh's device."""
    rows = np.load(path, mmap_mode="r")
    n = rows.shape[0] // mesh.axis_size("model")
    i = mesh.axis_index("model")
    return torch.from_numpy(np.array(rows[i * n : (i + 1) * n])).to(mesh.device)


def spmd_rank(rank: int, world: int, backend: str, store: str, out_dir: str) -> None:
    """One rank of the compiled SPMD phase, on ``cuda:0`` beside the others.
    Four gloo ranks run every arm: DAPC and GBPC, the Gather on a (1, 4)
    ("data", "model") mesh; the c2d and gather embeddings, attend_sp and the
    gradient psums on a (2, 2) one.  One NCCL rank runs DAPC and the
    Gather.  Each arm starts from launch counts and collective bytes of 0;
    its results (digests where the parent holds the oracle), launches by
    route, bytes and wall go to ``out_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import WRAPPERS, launch_counts, reset_launches
    from repro_torch.models import attend_sp, embed_c2d, embed_gather
    from repro_torch.sharding import (
        compressed_psum_with_feedback, dapc_shard_map, gather_shard_map, gbpc_reference,
        hierarchical_psum, init_mesh, shard_rows,
    )

    mesh = init_mesh((1, world), ("data", "model"), backend=backend, rank=rank,
                     init_method=f"file://{store}", timeout=SPMD_TIMEOUT)
    dev = mesh.device
    res = {"device": str(dev), "arms": {}}
    mesh.psum(torch.zeros(1, device=dev), "model")  # NCCL makes its communicator here

    def arm(name, m, fn):
        reset_launches()
        m.reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["arms"][name] = {
            "wall_s": time.perf_counter() - t, "bytes": dict(m.bytes_by_kind),
            "launches": launch_counts(),
            "routes": {k: {r: n for r, n in w.route_launches.items() if n}
                       for k, w in WRAPPERS.items() if any(w.route_launches.values())},
        }
        return out

    shard = npy_shard(Path(out_dir) / "chain.npy", mesh)
    starts = torch.from_numpy(spmd_starts()).to(dev)
    for name, fn in (("dapc", dapc_shard_map), ("gbpc", gbpc_reference)):
        res[name] = arm(name, mesh, lambda: fn(shard, starts, DAPC_DEPTH, mesh)).cpu().numpy()
    del shard
    shard = npy_shard(Path(out_dir) / "gather_table.npy", mesh)
    keys = torch.from_numpy(gather_keys()).to(dev)
    res["gather"] = digest(arm("gather", mesh, lambda: gather_shard_map(shard, keys, mesh)))
    del shard
    torch.cuda.empty_cache()
    if world > 1:
        m22 = init_mesh((2, world // 2), ("data", "model"), backend=backend, rank=rank,
                        init_method=f"file://{store}", timeout=SPMD_TIMEOUT)
        vocab, ids = yi_vocab(dev)
        vocab = shard_rows(vocab, m22, "model").clone()
        ids = shard_rows(ids, m22, "data")
        torch.cuda.empty_cache()
        for name, fn in (("embed_c2d", embed_c2d), ("embed_gather", embed_gather)):
            res[name] = digest(arm(name, m22, lambda: fn(vocab, ids, m22)))
        del vocab
        both = ("data", "model")
        q, k, v = (shard_rows(x, m22, both, dim=1).contiguous() for x in hymba_qkv(dev))
        pos = torch.arange(SPMD_SEQ)  # attend_sp reads the positions on the host
        for name, window in (("attend_sp", None), ("attend_sp_window", HYMBA_WINDOW)):
            res[name] = arm(name, m22, lambda: attend_sp(
                q, k, v, q_pos=pos, k_pos=pos, mesh=m22, axis=both, window=window)).cpu()
        grad = grad_bucket(dev, rank)
        sent = []
        psum = m22.psum
        m22.psum = lambda x, axis: (sent.append(x), psum(x, axis))[1]  # the int32 payload is q
        out, err = arm("compressed_psum", m22, lambda: compressed_psum_with_feedback(
            grad, torch.zeros_like(grad), both, m22))
        m22.psum = psum
        res["compressed_psum"] = {"q": digest(sent[0]), "out": digest(out), "err": digest(err)}
        out = arm("hierarchical_psum", m22, lambda: hierarchical_psum(grad, both, m22))
        res["hierarchical_psum"] = digest(out)
        if rank == 0:
            res["hierarchical_psum_rank0"] = out.cpu().numpy()
    torch.save(res, Path(out_dir) / f"{backend}_rank{rank}.pt")
    mesh.close()


def spmd_run(world: int, backend: str) -> list[dict]:
    """``world`` ranks of :func:`spmd_rank` (``torch.multiprocessing``,
    joined; a rank that raises fails the run), each with a fresh store."""
    store = SPMD_DIR / f"{backend}_store"
    store.unlink(missing_ok=True)
    torch.multiprocessing.spawn(spmd_rank, args=(world, backend, str(store), str(SPMD_DIR)),
                                nprocs=world, join=True)
    return [torch.load(SPMD_DIR / f"{backend}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def expect_launches(run: dict, what: str, want: dict) -> None:
    """``want``: {kernel: {route: launches}}; every other count 0."""
    got = {k: dict(v) for k, v in run["routes"].items()}
    if got != want or sum(run["launches"].values()) != sum(
            n for routes in want.values() for n in routes.values()):
        raise AssertionError(f"spmd {what}: launches {run['launches']} by route {got}, "
                             f"want {want}")


def spmd_phase(dev, table: np.ndarray, chain: np.ndarray, oracle: np.ndarray) -> dict:
    """The compiled SPMD rendering on the card: 4 gloo ranks sharing it,
    then one NCCL rank (:func:`spmd_rank`), over the DAPC phase's ``chain``
    and the service phase's ``table`` (handed over as ``.npy`` files under
    ``build/chip_smoke/spmd``, removed after); every result checked here
    against the oracles and the one-process versions.  Gloo stages every
    collective through the host, so the walls are host numbers."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.models import embed_plain
    from repro_torch.sharding import gather_ref

    keys = gather_keys()
    gather_want = digest(torch.from_numpy(gather_ref(table, keys)))
    shutil.rmtree(SPMD_DIR, ignore_errors=True)
    SPMD_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    np.save(SPMD_DIR / "chain.npy", chain)
    np.save(SPMD_DIR / "gather_table.npy", table)
    out = {"save_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ranks = spmd_run(SPMD_RANKS, "gloo")
    out["gloo_s"] = time.perf_counter() - t0
    n_loc = DAPC_ENTRIES // SPMD_RANKS
    walls = {name: max(r["arms"][name]["wall_s"] for r in ranks) for name in ranks[0]["arms"]}
    for r, res in enumerate(ranks):
        arms = res["arms"]
        for name in ("dapc", "gbpc"):
            if not np.array_equal(res[name], oracle):
                raise AssertionError(f"spmd gloo rank {r} {name}: results differ from the oracle")
        expect_launches(arms["dapc"], f"rank {r} dapc", {"chase_shard": {"spread": DAPC_DEPTH}})
        expect_launches(arms["gbpc"], f"rank {r} gbpc", {})
        want = {"dapc": {"psum": DAPC_DEPTH * DAPC_CHASES * 4, "pmax": 0, "all_gather": 0},
                "gbpc": {"psum": 0, "pmax": 0, "all_gather": n_loc * 4},
                "gather": {"psum": len(keys) * DIM * 4, "pmax": 0, "all_gather": 0}}
        for name, b in want.items():
            if arms[name]["bytes"] != b:
                raise AssertionError(f"spmd gloo rank {r} {name}: bytes {arms[name]['bytes']}, "
                                     f"want {b}")
        if res["gather"] != gather_want:
            raise AssertionError(f"spmd gloo rank {r} gather: rows differ from gather_ref")
        expect_launches(arms["gather"], f"rank {r} gather", {"embed_lookup": {"warp": 1}})
    dapc_b = ranks[0]["arms"]["dapc"]["bytes"]["psum"]
    gbpc_b = ranks[0]["arms"]["gbpc"]["bytes"]["all_gather"]
    log(f"spmd gloo x{SPMD_RANKS} dapc_shard_map and gbpc_reference: oracle-identical on every "
        f"rank; chase_shard {DAPC_DEPTH} launches a rank (spread, B={DAPC_CHASES} depth 1); "
        f"collective bytes a rank dapc {dapc_b} (= {DAPC_DEPTH} x {DAPC_CHASES} x 4), gbpc "
        f"{gbpc_b}, gbpc/dapc {gbpc_b / dapc_b}; wall s (host) dapc {walls['dapc']}, gbpc "
        f"{walls['gbpc']}")
    log(f"spmd gloo x{SPMD_RANKS} gather_shard_map: bit-identical to gather_ref on every rank, "
        f"{len(keys)} keys, one embed_lookup launch a rank (warp); bytes a rank "
        f"{ranks[0]['arms']['gather']['bytes']['psum']}; wall s (host) {walls['gather']}")
    # (c) the (2, 2) mesh: embeddings against embed_plain in this process
    vocab, ids = yi_vocab(dev)
    plain = embed_plain(vocab, ids)
    half = LAUNCH_BATCH // 2
    embed_want = [digest(plain[i * half : (i + 1) * half]) for i in range(2)]
    del vocab, plain
    for r, res in enumerate(ranks):
        for name in ("embed_c2d", "embed_gather"):
            if res[name] != embed_want[r // 2]:
                raise AssertionError(f"spmd gloo rank {r} {name}: rows differ from embed_plain")
        expect_launches(res["arms"]["embed_c2d"], f"rank {r} embed_c2d",
                        {"embed_lookup": {"bulk": 1}})
        expect_launches(res["arms"]["embed_gather"], f"rank {r} embed_gather", {})
    log(f"spmd gloo (2, 2) embed_c2d and embed_gather: yi-9b vocab {YI_VOCAB}x{YI_DIM} bf16, "
        f"ids ({LAUNCH_BATCH}, {LAUNCH_PROMPT}), bit-identical to embed_plain on every rank; "
        f"embed_c2d one embed_lookup launch a rank (bulk, N={half * LAUNCH_PROMPT} of "
        f"{YI_DIM * 2} B rows); bytes a rank c2d "
        f"{ranks[0]['arms']['embed_c2d']['bytes']}, gather "
        f"{ranks[0]['arms']['embed_gather']['bytes']}; wall s (host) c2d {walls['embed_c2d']}, "
        f"gather {walls['embed_gather']}")
    # attend_sp: the one-rank call and every rank's slice within the flash
    # phase's bounds of the plain version, and each rank's slice bit for bit
    # the one-rank call's (the same tiles of keys in the same order)
    q, k, v = hymba_qkv(dev)
    s_loc = SPMD_SEQ // SPMD_RANKS
    saved = flash_attention.launches, dict(flash_attention.route_launches)
    attn = {}
    for name, window in (("attend_sp", 0), ("attend_sp_window", HYMBA_WINDOW)):
        full = flash_attention(q, k, v, window=window)
        plain = flash_attention_ref(q, k, v, window=window)
        plain32 = flash_attention_ref(q.float(), k.float(), v.float(), window=window)
        _, err, err32 = flash_within(f"spmd {name} one rank S=T={SPMD_SEQ}", torch.bfloat16,
                                     full, plain, plain32)
        errs = {"one_rank": err, "one_rank_f32_probs": err32, "ranks": [], "ranks_f32_probs": []}
        for r, res in enumerate(ranks):
            rows = slice(r * s_loc, (r + 1) * s_loc)
            got = res[name].to(dev)
            _, err, err32 = flash_within(f"spmd {name} rank {r}", torch.bfloat16, got,
                                         plain[:, rows], plain32[:, rows])
            errs["ranks"].append(err)
            errs["ranks_f32_probs"].append(err32)
            if not torch.equal(got, full[:, rows]):
                raise AssertionError(f"spmd {name} rank {r}: not bit-identical to the one-rank "
                                     f"flash call")
            expect_launches(res["arms"][name], f"rank {r} {name}",
                            {"flash_attention": {"wgmma": 1}})
        attn[name] = {"max_abs_err": errs, "wall_s": walls[name],
                      "bytes": ranks[0]["arms"][name]["bytes"]["all_gather"]}
        del full, plain, plain32
    flash_attention.launches, flash_attention.route_launches = saved  # checks, not the path
    log(f"spmd gloo (2, 2) attend_sp over (data, model): hymba width (25/5 heads of 64) bf16, "
        f"B=1 S={SPMD_SEQ}, {s_loc} queries a rank, rank r passing (r + 1) x {s_loc} keys; "
        f"every rank bit-identical to flash_attention on the whole sequence, and both within "
        f"{FLASH_TOL[torch.bfloat16]} of the plain version (atol {FLASH_F32P_ATOL}, rtol "
        f"{FLASH_F32P_RTOL} of it on f32 copies), one wgmma launch a rank a layer: "
        f"{json.dumps(attn)}")
    # (d) the gradient bucket: numpy's f32 arithmetic on every rank's bucket
    grads = np.stack([grad_bucket(dev, r).cpu().numpy() for r in range(SPMD_RANKS)])
    g = grads + np.zeros_like(grads)  # grad + err, err 0 at the first step
    scale = np.maximum(np.abs(g).max(), np.float32(1e-12)) / np.float32(127.0)
    q8 = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    # the residual rounded once (XLA fuses it into a multiply-add under jit)
    err = (g.astype(np.float64) - q8.astype(np.float64) * np.float64(scale)).astype(np.float32)
    red = q8.astype(np.int32).sum(0).astype(np.float32) * scale
    exact = grads.astype(np.float64).sum(0)
    for r, res in enumerate(ranks):
        want = {"q": digest(torch.from_numpy(q8[r].astype(np.int32))),
                "out": digest(torch.from_numpy(red)), "err": digest(torch.from_numpy(err[r]))}
        if res["compressed_psum"] != want:
            raise AssertionError(f"spmd rank {r} compressed_psum: {res['compressed_psum']} "
                                 f"differs from numpy's {want}")
        if res["hierarchical_psum"] != ranks[0]["hierarchical_psum"]:
            raise AssertionError(f"spmd rank {r} hierarchical_psum differs from rank 0's")
        expect_launches(res["arms"]["compressed_psum"], f"rank {r} compressed_psum", {})
    hier = ranks[0]["hierarchical_psum_rank0"].astype(np.float64)
    hier_err = np.abs(hier - exact).max()
    bound = 3 * 2.0**-24 * np.abs(grads).astype(np.float64).sum(0)
    if not (np.abs(hier - exact) <= bound).all():
        raise AssertionError(f"spmd hierarchical_psum: {hier_err} from the f64 sum")
    cp_bytes = ranks[0]["arms"]["compressed_psum"]["bytes"]
    psums = {
        "compressed_rel_err": float(np.abs(red - exact).max() / np.abs(exact).max()),
        "hierarchical_max_abs_err": float(hier_err),
        "compressed_bytes": cp_bytes, "f32_psum_bytes": REDUCE_WIDTH * 4,
        "compressed_over_f32": sum(cp_bytes.values()) / (REDUCE_WIDTH * 4),
        "hierarchical_bytes": ranks[0]["arms"]["hierarchical_psum"]["bytes"],
        "wall_s": {"compressed": walls["compressed_psum"],
                   "hierarchical": walls["hierarchical_psum"]},
    }
    log(f"spmd gloo (2, 2) compressed_psum_with_feedback and hierarchical_psum over (data, "
        f"model), one {REDUCE_WIDTH * 4 // 2**20} MiB f32 bucket a rank: q, error and result "
        f"equal to numpy's f32 arithmetic on every rank, hierarchical within 3 f32 roundings "
        f"of the f64 sum; {json.dumps(psums)}")
    out.update(arms=walls, attn=attn, psums=psums, dapc_bytes=dapc_b, gbpc_bytes=gbpc_b)
    out["launches"] = [{k: res["arms"][k]["launches"] for k in res["arms"]} for res in ranks]
    # (e) one NCCL rank: the NCCL code path at (a)'s and (b)'s sizes
    t1 = time.perf_counter()
    (nccl,) = spmd_run(1, "nccl")
    out["nccl_s"] = time.perf_counter() - t1
    if not np.array_equal(nccl["dapc"], oracle) or not np.array_equal(nccl["gbpc"], oracle):
        raise AssertionError("spmd nccl: chase results differ from the oracle")
    if nccl["gather"] != gather_want:
        raise AssertionError("spmd nccl gather: rows differ from gather_ref")
    expect_launches(nccl["arms"]["dapc"], "nccl dapc", {"chase_shard": {"spread": DAPC_DEPTH}})
    expect_launches(nccl["arms"]["gather"], "nccl gather", {"embed_lookup": {"warp": 1}})
    out["nccl"] = {k: {"wall_s": a["wall_s"], "bytes": a["bytes"], "launches": a["launches"]}
                   for k, a in nccl["arms"].items()}
    shutil.rmtree(SPMD_DIR)
    log(f"spmd nccl x1 dapc_shard_map, gbpc_reference and gather_shard_map: oracle-identical, "
        f"{DAPC_DEPTH} chase_shard and 1 embed_lookup launches; {json.dumps(out['nccl'])}")
    return out


# ---------------------------------------------------------------- training
def _bwd_within(what: str, dtype, got, want, want32=None, own32=None,
                steps=None) -> tuple[str, float, float]:
    """Each of ``got`` (dq, dk, dv) within BWD_TOL of the largest |want|
    (bf16: plus BWD_BF16_RTOL of each value, plus ``steps`` where given:
    one bf16 step of each row's largest term rounded to bf16, for the route
    that rounds P and dS, ``flash_attention_bwd_step_ref``) and, for bf16,
    within BWD_TOL plus BWD_F32C_RTOL of ``want32`` (the plain version on
    f32 copies), plus twice ``own32`` where given: the largest error of the
    plain bf16 version, which rounds P and dS where the kernel does, against
    those copies.  Raises where not.  Returns the log line, the largest
    error and the largest share of its bound that an element's error uses."""
    torch.cuda.synchronize()
    parts, worst, use = [], 0.0, 0.0
    for name, g, w, w32, o32, step in zip(("dq", "dk", "dv"), got, want,
                                          want32 or (None,) * 3, own32 or (0.0,) * 3,
                                          steps or (0.0,) * 3):
        g, w = g.float(), w.float()
        top = w.abs().max().item()
        err = (g - w).abs().max().item()
        rtol = BWD_BF16_RTOL if dtype == torch.bfloat16 else 0.0
        bound = BWD_TOL * top + rtol * w.abs() + step
        ok = bool(((g - w).abs() <= bound).all())
        share = ((g - w).abs() / bound).max().item()
        part = f"{name} err {err} (|max| {top}, {share} of its bound)"
        if w32 is not None:
            err32 = (g - w32).abs().max().item()
            bound32 = 2 * o32 + BWD_TOL * top + BWD_F32C_RTOL * w32.abs()
            ok &= bool(((g - w32).abs() <= bound32).all())
            share32 = ((g - w32).abs() / bound32).max().item()
            part += f" f32-copies err {err32} ({share32} of its bound)"
            if own32 is not None:
                part += f" (the plain bf16's own {o32})"
            share = max(share, share32)
        if not ok or not torch.isfinite(g).all():
            raise AssertionError(f"flash_attention_bwd differs from plain: {what}: {part}")
        parts.append(part)
        worst, use = max(worst, err), max(use, share)
    return f"{what}: " + "; ".join(parts), worst, use


def flash_bwd_kernel_phase(dev) -> dict:
    """The flash backward kernel on the card against its plain version on
    the same inputs (``flash_attention_bwd_ref``), and that against
    ``torch.autograd`` of the plain forward on f32 copies: the JAX flash
    sweep's shapes, yi's train shape (B = 2, S = T = 4,096, 32/4 heads of
    128, bf16), hymba's windowed shape (25/5 heads of 64, S = T = 3,072,
    window 2,048), a softcap, S < T with a window, and rows that see no key
    (S = 300 > T = 200: their dQ must be 0, not NaN), in f32 and bf16 (yi's
    in bf16).  Where every row sees a key the forward kernel writes each
    row's log-sum-exp, as the train step's does: within FLASH_LSE_ATOL of
    ``flash_attention_lse_ref``, and the backward is checked given it (the
    train step's call: a delta pass, no Q K^T for the rows) against the
    plain version given the same lse, then without it (the row pass) against
    the plain version that recomputes it; keyless rows run without.  bf16
    runs both routes: ``wgmma`` against the plain version on the same inputs
    (it rounds P and dS where the kernel does) and, on f32 copies, within
    twice that plain version's own error there plus the f32-copies bound;
    ``simt`` (all f32) against the plain version on f32 copies.  f32 runs
    ``simt``.  Autograd spreads a keyless row over all keys (module note of
    tests/test_torch_flash_bwd.py): its dO is 0 in that comparison.  Each
    call must count one launch on its route, the call without ``route``
    (bf16 on ``wgmma``, f32 on ``simt``) as well; checking launches are not
    main-path launches."""
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.flash_attention import (
        BWD_ROUTES, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_bwd_step_ref,
        flash_attention_lse_ref, flash_attention_ref,
    )
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products in the plain versions
    g = torch.Generator(dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    default = {bf16: "wgmma", f32: "simt"}
    cases = [(f"sweep {(b, h, kh, s, t, d)} causal={causal} softcap={cap}",
              (b, s, t, h, kh, d), dict(causal=causal, softcap=cap), (f32, bf16))
             for b, h, kh, s, t, d, _, _, causal, cap in SWEEP]
    cases += [
        ("yi train B=2 S=T=4096", YI_TRAIN, {}, (bf16,)),
        ("hymba S=T=3072 window 2048", (1, 3072, 3072, *HYMBA_HEADS), dict(window=HYMBA_WINDOW),
         (f32, bf16)),
        ("softcap 30 S=T=1000", (1, 1000, 1000, 8, 2, 64), dict(softcap=30.0), (f32, bf16)),
        ("S=256 T=1024 window 300", (2, 256, 1024, 8, 4, 128), dict(window=300), (f32, bf16)),
        ("keyless rows S=300 T=200", (1, 300, 200, 4, 2, 32), {}, (f32, bf16)),
    ]
    before = {k: (WRAPPERS[k].launches, dict(WRAPPERS[k].route_launches))
              for k in ("flash_attention", "flash_attention_bwd")}
    worst, worst_lse, use, taken = 0.0, 0.0, 0.0, {}
    t0 = time.perf_counter()
    for label, (b, s, t, h, kh, d), kw, dtypes in cases:
        keyless = max(0, s - t) if kw.get("causal", True) else 0
        opts = {"causal": True, "softcap": None, "window": 0, **kw}
        for dtype in dtypes:
            q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype) for shape in (
                (b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d)))
            if keyless:
                out, lse = flash_attention_ref(q, k, v, **kw).contiguous(), None
            else:
                out, lse = flash_kernel._forward(q, k, v, opts["causal"], opts["softcap"], None,
                                                 opts["window"], save_lse=True)
                lse_err = (lse - flash_attention_lse_ref(q, k, **kw)).abs().max().item()
                if not lse_err <= FLASH_LSE_ATOL:
                    raise AssertionError(f"flash_attention {label} {dtype}: lse off the plain "
                                         f"one by {lse_err}")
                worst_lse = max(worst_lse, lse_err)
                log(f"kernel flash_attention {label} {str(dtype)[6:]}: lse max_abs_err "
                    f"{lse_err} (within {FLASH_LSE_ATOL})")
            want32 = None
            if dtype == bf16:
                want32 = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                                 dout.float(), **kw)
            for given in ((lse, None) if lse is not None else (None,)):
                want = flash_attention_bwd_ref(q, k, v, out, dout, lse=given, **kw)
                own32 = steps = None
                if dtype == bf16:
                    own32 = [(w.float() - w32).abs().max().item() for w, w32 in zip(want, want32)]
                    steps = flash_attention_bwd_step_ref(q, k, v, out, dout, lse=given, **kw)
                for route in ("wgmma", "simt") if dtype == bf16 else ("simt",):
                    asked = None if route == default[dtype] else route
                    at = dict(flash_attention_bwd.route_launches)
                    got = flash_attention_bwd(q, k, v, out, dout, lse=given, route=asked, **kw)
                    moved = {r: flash_attention_bwd.route_launches[r] - at[r] for r in BWD_ROUTES}
                    if moved != {r: int(r == route) for r in BWD_ROUTES}:
                        raise AssertionError(f"flash_attention_bwd {label} route={asked}: "
                                             f"launches {moved}, want one on {route}")
                    if asked is None:
                        taken[str(dtype)[6:]] = route
                    what = (f"kernel flash_attention_bwd {label} {str(dtype)[6:]} ({route}, "
                            f"{'the forward' if given is not None else 'no'} lse)")
                    if route == "simt" and dtype == bf16:  # all f32: the plain one on f32 copies
                        line, err, u = _bwd_within(what, dtype, got, [w.to(bf16) for w in want32],
                                                   want32)
                    else:
                        line, err, u = _bwd_within(what, dtype, got, want, want32, own32, steps)
                    worst, use = max(worst, err), max(use, u)
                    if keyless and bool(got[0][:, :keyless].abs().max() != 0):
                        raise AssertionError(f"{what}: a row that sees no key has a nonzero dQ")
                    log(line)
                    del got
                del want, steps
            del want32
            # the plain backward against autograd of the plain forward, f32 copies
            x32 = [x.float().requires_grad_() for x in (q, k, v)]
            do32 = dout.float()
            do32[:, :keyless] = 0.0
            o32 = flash_attention_ref(*x32, **kw)
            auto = torch.autograd.grad(o32, x32, do32)
            plain = flash_attention_bwd_ref(*(x.detach() for x in x32), o32.detach(), do32, **kw)
            errs = []
            for name, a, p in zip(("dq", "dk", "dv"), auto, plain):
                e = (a - p).abs().max().item()
                if e > BWD_TOL * a.abs().max().item():
                    raise AssertionError(f"{what}: the plain backward's {name} differs from "
                                         f"autograd of the plain forward by {e}")
                errs.append(e)
            log(f"kernel flash_attention_bwd {label} {str(dtype)[6:]}: plain vs autograd "
                f"(f32 copies) errs {errs}")
            del q, k, v, dout, out, lse, x32, do32, o32, auto, plain
            torch.cuda.empty_cache()
    for k, (count, routes) in before.items():
        WRAPPERS[k].launches, WRAPPERS[k].route_launches = count, routes
    log(f"flash backward kernel phase: {time.perf_counter() - t0:.1f} s, largest share of a "
        f"bound used {use}")
    return {"max_abs_err": worst, "max_abs_err_lse": worst_lse, "bound_share": use,
            "routes_by_dtype": taken}


def time_flash_bwd(dev) -> dict:
    """The backward kernel at yi's train shape (B = 2, S = T = 4,096, 32/4
    heads of 128, causal, bf16) as the train step calls it (given the
    forward's lse), from CUDA events around calls queued behind a sleep
    (:func:`event_ms`): the ``wgmma`` and ``simt`` routes in turns
    (:func:`ab_ms`), beside the plain backward, the forward kernel writing
    lse at the same shape, and SDPA's backward (forward plus backward of
    ``scaled_dot_product_attention`` less its forward, in its (B, H, S, d)
    layout: a yardstick the port never calls), and the route's device
    kernels one by one (a profiled call).  The bound: the function's
    operations, 2.5 x the forward's 4 B H d per visible pair (QK^T, dO V^T,
    dV, dK, dQ: 10 B H d), over the bf16 dense tensor-core peak, against the
    bytes (q, out, dO read and dq written, k, v read and dk, dv written,
    lse read) over the HBM rate; beside it the two-kernel design's own
    floor, its seven products (14 B H d a pair) at that peak."""
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref,
    )
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    before = {k: (WRAPPERS[k].launches, dict(WRAPPERS[k].route_launches))
              for k in ("flash_attention", "flash_attention_bwd")}
    b, s, t, h, kh, d = YI_TRAIN
    g = torch.Generator(dev).manual_seed(6)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                     for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d)))
    out, lse = flash_kernel._forward(q, k, v, True, None, None, 0, save_lse=True)
    sets = [(q, k, v, out, dout)]
    pairs = s * (s + 1) // 2
    flops = 2.5 * 4 * b * h * d * pairs
    design_flops = 14 * b * h * d * pairs
    moved = 2 * (4 * b * s * h * d + 4 * b * t * kh * d) + 4 * b * h * s
    bounds = {"operations": flops / BF16_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    lq, lk, lv, ldo = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    lq, lk, lv = (x.requires_grad_() for x in (lq, lk, lv))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        return sdpa(lq, lk, lv, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (lq, lk, lv), ldo)

    routes = ab_ms({route: (lambda q, k, v, o, do, route=route: flash_attention_bwd(
        q, k, v, o, do, lse=lse, route=route)) for route in ("wgmma", "simt")}, sets, 5, 2)
    rec = {
        "ms": routes["wgmma"]["median"],
        "simt_ms": routes["simt"]["median"],
        "route_ms": routes,
        "plain_ms": event_ms(lambda *a: flash_attention_bwd_ref(*a, lse=lse), sets, 2),
        "forward_ms": event_ms(lambda q, k, v, o, do: flash_kernel._forward(
            q, k, v, True, None, None, 0, save_lse=True), sets, 20),
        "bound_ms": bounds[bound_by],
        "bound_by": bound_by,
        "design_floor_ms": design_flops / BF16_FLOPS * 1e3,
        "flops": flops,
        "design_flops": design_flops,
        "bytes": moved,
        "route": "wgmma",
    }
    fb = event_ms(lambda *a: sdpa_fwd_bwd(), sets, 10)
    fw = event_ms(lambda *a: sdpa_fwd(), sets, 10)
    rec["library_ms"] = fb - fw
    rec["library_fwd_bwd_ms"], rec["library_fwd_ms"] = fb, fw
    # the wgmma route's device kernels, from a whole profile of one call
    _, window, _, whole = profiled(lambda: flash_attention_bwd(q, k, v, out, dout, lse=lse),
                                  tries=5)
    name = lambda e: (re.search(r"flash_bwd_\w+", e.name) or re.search(".{0,40}", e.name))[0]
    rec["kernels_ms"] = ({name(e): e.device_time_total / 1e3 for e in window
                          if e.device_type == DeviceType.CUDA and e.name != WINDOW}
                         if whole else None)
    for k2, (count, routes) in before.items():
        WRAPPERS[k2].launches, WRAPPERS[k2].route_launches = count, routes
    log(f"timing flash_attention_bwd train B={b} S=T={s} H={h} K={kh} d={d} bf16: "
        f"{json.dumps(rec)}")
    del q, k, v, dout, out, lse, sets, lq, lk, lv, ldo
    torch.cuda.empty_cache()
    return rec


WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")
SSM_BWD_NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")


def _rec_bwd_within(what: str, names, got, want) -> tuple[float, float]:
    """Each gradient of ``got`` in its plain version's dtype and shape and
    within REC_BWD_TOL of the largest |want| of its tensor (bf16: plus
    REC_BWD_BF16_RTOL of each value); raises where not.  Returns the largest
    error and the largest share of its bound that an element's error uses."""
    torch.cuda.synchronize()
    worst, use, parts = 0.0, 0.0, []
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {name} is {g.dtype} {tuple(g.shape)}, the plain "
                                 f"version's {w.dtype} {tuple(w.shape)}")
        g32, w32 = g.float(), w.float()
        top = w32.abs().max().item()
        err = (g32 - w32).abs()
        rtol = REC_BWD_BF16_RTOL if g.dtype == torch.bfloat16 else 0.0
        bound = REC_BWD_TOL * top + rtol * w32.abs()
        ok = bool((err <= bound).all())
        share = (err / bound.clamp_min(1e-30)).max().item()
        worst, use = max(worst, err.max().item()), max(use, share)
        parts.append(f"{name} err {err.max().item()} (|max| {top}, {share} of its bound)")
        if not ok:
            log(f"{what}: {'; '.join(parts)}")
            raise AssertionError(f"{what}: {name} off its plain version by {err.max().item()}")
    log(f"{what}: {'; '.join(parts)}")
    return worst, use


def _rec_bwd_case(what, fn, plain, names, args, routes) -> dict:
    """``fn(*args, route=route)`` for each of ``routes``: twice, bit-identical,
    one launch each counted in ``fn.launches`` and under ``route`` alone, and
    within its bounds of ``plain(*args)`` (run once for all routes).
    Returns each route's largest error and largest share of its bound."""
    want = plain(*args)
    out = {}
    for route in routes:
        before = fn.launches, dict(fn.route_launches)
        got = fn(*args, route=route)
        again = fn(*args, route=route)
        torch.cuda.synchronize()
        moved = {r: fn.route_launches[r] - before[1][r] for r in fn.route_launches}
        if fn.launches != before[0] + 2 or moved != {r: 2 * (r == route) for r in moved}:
            raise AssertionError(f"{what} ({route}): launches {fn.launches} from {before[0]}, "
                                 f"by route {moved}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what} ({route}): two calls differ")
        out[route] = _rec_bwd_within(f"kernel {what} ({route}, two calls bit-identical)", names,
                                     got, want)
        del got, again
    del want
    return out


def _rec_bwd_phase(cases: dict, draw, fn, plain, names, routes_of) -> dict:
    """Each case of ``cases`` (label -> draw's arguments) on every route
    ``routes_of(dtype)`` gives it; the largest error and bound share over
    all, and by route."""
    by_route: dict[str, dict] = {}
    for what, spec in cases.items():
        args, dtype = draw(*spec)
        for route, (e, sh) in _rec_bwd_case(what, fn, plain, names, args,
                                            routes_of(dtype)).items():
            rec = by_route.setdefault(route, {"max_abs_err": 0.0, "bound_share": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            rec["bound_share"] = max(rec["bound_share"], sh)
        del args
        torch.cuda.empty_cache()
    return {"max_abs_err": max(r["max_abs_err"] for r in by_route.values()),
            "bound_share": max(r["bound_share"] for r in by_route.values()),
            "routes": by_route}


def wkv6_bwd_kernel_phase(dev) -> dict:
    """``wkv6_bwd`` on the card against ``wkv6_bwd_ref`` on the same inputs:
    rwkv6's train microbatch (B = 2, T = 4,096, H = 32, M = 64) with r, k, v,
    u and dout in bf16 and w in f32 (the model's types) and all in f32; B =
    2, T = 100 (below SPLIT_MIN_T, not a multiple of the chunk) in bf16; and
    B = 2, T = 777 in bf16 and in f32 from a given state with a final-state
    cotangent, decays log-uniform in [1e-30, 0.999].  Each case on every
    route its dtype has (bf16: ``mma`` and ``split``; f32: ``split``):
    every gradient within REC_BWD_TOL of its largest (bf16: plus
    REC_BWD_BF16_RTOL of each value), two calls bit-identical, each call one
    launch counted under the route it took."""
    from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_bwd_ref

    g = torch.Generator(dev).manual_seed(11)
    h, m = WKV_H, WKV_M
    b, t = REC_TRAIN
    bf16, f32 = torch.bfloat16, torch.float32

    def draw(b_, t_, dtype, state):
        r, k, v, w, u, s0 = _wkv_case(dev, g, b_, t_, h, m, dtype, f32, state=state)
        dout = (0.5 * torch.randn(b_, t_, h, m, generator=g, device=dev)).to(dtype)
        ds = None
        if state:
            w = torch.exp(torch.rand(b_, t_, h, m, generator=g, device=dev)
                          * float(np.log(1e-30 / 0.999)) + float(np.log(0.999)))
            ds = 0.5 * torch.randn(b_, h, m, m, generator=g, device=dev)
        return (r, k, v, w, u, s0, dout, ds), dtype

    cases = {
        f"wkv6_bwd train B={b} T={t} H={h} M={m} bf16 (w f32)": (b, t, bf16, False),
        f"wkv6_bwd train B={b} T={t} H={h} M={m} f32": (b, t, f32, False),
        f"wkv6_bwd B=2 T=100 H={h} M={m} bf16 (w f32, step-route length)": (2, 100, bf16, False),
        f"wkv6_bwd B=2 T=777 H={h} M={m} bf16 (w f32) from a state, final-state cotangent, "
        "decays in [1e-30, 0.999]": (2, 777, bf16, True),
        f"wkv6_bwd B=2 T=777 H={h} M={m} f32 from a state, final-state cotangent, "
        "decays in [1e-30, 0.999]": (2, 777, f32, True),
    }
    rec = _rec_bwd_phase(cases, draw, wkv6_bwd, wkv6_bwd_ref, WKV_BWD_NAMES,
                         lambda dtype: ["mma", "split"] if dtype == bf16 else ["split"])
    rec["routes_by_dtype"] = {"bfloat16": "mma", "float32": "split"}
    return rec


def ssm_scan_bwd_kernel_phase(dev) -> dict:
    """``ssm_scan_bwd`` on the card against ``ssm_scan_bwd_ref`` on the same
    inputs: hymba's train microbatch (B = 2, T = 4,096, D = 1,600, N = 16)
    with x, dt, b, c and dy in bf16 and a in f32 (the model's types) and all
    in f32; B = 2, T = 100 in bf16; and B = 2, T = 777 in f32 from a given
    state with a final-state cotangent and dt in 2-3 (decays down to ~1e-3).
    Each case on both routes (``regs`` and ``split``); bounds as for
    wkv6_bwd."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_bwd_ref

    g = torch.Generator(dev).manual_seed(12)
    d, n = SSM_D, SSM_N
    b, t = REC_TRAIN
    bf16, f32 = torch.bfloat16, torch.float32

    def draw(b_, t_, dtype, state):
        x, dt, a, bb, cc, h0 = _ssm_case(dev, g, b_, t_, d, n, dtype, state=state,
                                         dt_range=(2.0, 3.0) if state else None)
        dy = (0.5 * torch.randn(b_, t_, d, generator=g, device=dev)).to(dtype)
        dh = 0.5 * torch.randn(b_, d, n, generator=g, device=dev) if state else None
        return (x, dt, a, bb, cc, h0, dy, dh), dtype

    cases = {
        f"ssm_scan_bwd train B={b} T={t} D={d} N={n} bf16 (a f32)": (b, t, bf16, False),
        f"ssm_scan_bwd train B={b} T={t} D={d} N={n} f32": (b, t, f32, False),
        f"ssm_scan_bwd B=2 T=100 D={d} N={n} bf16 (a f32, step-route length)": (2, 100, bf16,
                                                                                False),
        f"ssm_scan_bwd B=2 T=777 D={d} N={n} f32 from a state, final-state cotangent, "
        "dt in 2-3": (2, 777, f32, True),
    }
    rec = _rec_bwd_phase(cases, draw, ssm_scan_bwd, ssm_scan_bwd_ref, SSM_BWD_NAMES,
                         lambda dtype: ["regs", "split"])
    rec["routes_by_dtype"] = {"bfloat16": "regs", "float32": "regs"}
    return rec


def time_rec_bwd(dev, name: str) -> dict:
    """A recurrence's backward kernel at its arch's train microbatch (bf16
    operands, w or a in f32), as the train step calls it, from CUDA events
    around calls queued behind a sleep: its default route (wkv6_bwd ``mma``,
    ssm_scan_bwd ``regs``) and the ``split`` route in turns with the forward
    kernel at the same shape (:func:`ab_ms`), beside the plain backward (~20
    kernels a step, 80,000 a call: one call, :func:`once_ms`) and each
    route's device kernels one by one (a profiled call).  The function's
    bound: the larger of the f32 operations (wkv6_bwd 14 per state entry and
    step, forming S and G again, 3 each, and the dr, dk, dv, dw products, 2
    each; ssm_scan_bwd 13, one an exponential) over the f32 peak and the
    bytes (each operand and cotangent read once, each gradient written once)
    over the HBM rate.  The default route's design floor: the larger of its
    operations at the rate of the units that run them (wkv6_bwd: its
    tensor-core products at the bf16 peak, then its CUDA-core work at the f32
    peak; ssm_scan_bwd: its four exponentials per state entry and step on
    the SFUs, 1/16 of the f32 peak) and its bytes (the function's, and the
    chunk states and adjoints written once and read once).  No PyTorch call
    computes either backward: library_ms is null."""
    b, t = REC_TRAIN
    g = torch.Generator(dev).manual_seed(13)
    if name == "wkv6_bwd":
        from repro_torch.kernels.wkv6 import (
            MMA_CHUNK, wkv6 as fwd, wkv6_bwd as fn, wkv6_bwd_ref as plain,
        )

        h, m = WKV_H, WKV_M
        r, k, v, w, u, _ = _wkv_case(dev, g, b, t, h, m, torch.bfloat16, torch.float32)
        dout = (0.5 * torch.randn(b, t, h, m, generator=g, device=dev)).to(torch.bfloat16)
        sets = [(r, k, v, w, u, None, dout)]
        fwd_args = lambda *a: fwd(*a[:5])
        n = b * t * h * m
        flops = 14 * n * m
        moved = n * (2 * 4 + 4 + 2 * 3 + 4) + 2 * 2 * h * m + 4 * b * h * m * m
        route, chunk = "mma", MMA_CHUNK
        blocks = b * h * -(-t // chunk)
        # per (chunk, head): S and G 3 products each of 2 M^2 L; X and Y 3
        # each, Z 6, of 2 L M^2; VD 2 L^2 M
        tc_flops = blocks * (12 * 2 * m * m * chunk + 2 * chunk * chunk * m)
        # the walk (~8 a pair t < s and row, ~10 a step and row), the parts
        # of 3 M^2 f32 operands (6 each), KR's sums, dv's sums, the carries'
        # decay products, parts and scaling
        pairs = chunk * (chunk - 1) // 2
        cc_ops = blocks * (8 * pairs * m + 10 * chunk * m + 18 * m * m
                           + (pairs + chunk) * m + chunk * chunk * m + 2 * (8 * chunk * m + m * m))
        design = {"tensor_core_ms": tc_flops / BF16_FLOPS * 1e3,
                  "cuda_core_ms": cc_ops / F32_FLOPS * 1e3}
        design_moved = moved + 2 * 2 * 4 * blocks * m * m
        shape = f"train B={b} T={t} H={h} M={m} bf16 (w f32)"
    else:
        from repro_torch.kernels.ssm_scan import (
            BWD_CHUNK, REGS_CHANNELS, ssm_scan as fwd, ssm_scan_bwd as fn,
            ssm_scan_bwd_ref as plain,
        )

        d, n_ = SSM_D, SSM_N
        x, dt, a, bb, cc, _ = _ssm_case(dev, g, b, t, d, n_, torch.bfloat16)
        dy = (0.5 * torch.randn(b, t, d, generator=g, device=dev)).to(torch.bfloat16)
        sets = [(x, dt, a, bb, cc, None, dy)]
        fwd_args = lambda *a: fwd(*a[:5])
        n = b * t * d
        flops = 13 * n * n_
        moved = n * 2 * 5 + b * t * n_ * 2 * 4 + d * n_ * 4 * 2 + 4 * b * d * n_
        route = "regs"
        # four exponentials per state entry and step (the two serial passes,
        # the chunk's history and its walk back) on the SFUs
        design = {"sfu_ms": 4 * n * n_ / SFU_PER_S * 1e3,
                  "cuda_core_ms": 2 * 20 * n * n_ / F32_FLOPS * 1e3}
        entries = b * -(-t // BWD_CHUNK) * d * n_
        design_moved = moved + 3 * 2 * 4 * entries + 2 * 4 * -(-d // REGS_CHANNELS) * b * t * 2 * n_
        shape = f"train B={b} T={t} D={d} N={n_} bf16 (a f32)"
    before = {k2: (w2.launches, dict(w2.route_launches)) for k2, w2 in
              (("fwd", fwd), ("bwd", fn))}
    bounds = {"operations": flops / F32_FLOPS * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    design["bytes_ms"] = design_moved / HBM_BYTES_PER_S * 1e3
    ab = ab_ms({route: lambda *a: fn(*a, route=route), "split": lambda *a: fn(*a, route="split"),
                "forward": fwd_args}, sets, 3, 3)
    rec = {"ms": ab[route]["median"], "split_ms": ab["split"]["median"],
           "forward_ms": ab["forward"]["median"], "turns": ab,
           "plain_ms": once_ms(plain, *sets[0]), "plain_timed_by": "once_ms",
           "library_ms": None, "bound_ms": bounds[bound_by], "bound_by": bound_by,
           "bounds_ms": bounds, "design_floor_ms": max(design.values()), "design_ms": design,
           "flops": flops, "bytes": moved, "design_bytes": design_moved, "route": route}
    stem = re.compile(rf"{name}_\w+")
    rec["kernels_ms"] = {}
    for rt in (route, "split"):
        _, window, _, whole = profiled(lambda: fn(*sets[0], route=rt), tries=5)
        kernels_ms: dict[str, float] = {}
        for e in window:
            if e.device_type == DeviceType.CUDA and e.name != WINDOW:
                key = (stem.search(e.name) or re.search(".{0,40}", e.name))[0]
                kernels_ms[key] = kernels_ms.get(key, 0.0) + e.device_time_total / 1e3
        rec["kernels_ms"][rt] = kernels_ms if whole else None
    for key, w2 in (("fwd", fwd), ("bwd", fn)):  # timing launches are not main-path launches
        w2.launches, w2.route_launches = before[key]
    log(f"timing {name} {shape}: {json.dumps(rec)}")
    del sets
    torch.cuda.empty_cache()
    return rec


def _grads(cfg, model, batch, raw: bool = False) -> tuple:
    """The loss and every gradient leaf (JAX names, on the host) of one
    forward and backward; with ``raw`` also the gradients as autograd gave
    them, by the model's parameter names."""
    from repro_torch.models import zoo

    params = zoo.model_params(model)
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = zoo.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    for p in params.values():
        p.requires_grad_(False)
    named = zoo.to_jax_params(cfg, dict(zip(params, grads)))
    host = {k: x.cpu() for k, x in named.items()}
    return (loss.item(), host, dict(zip(params, grads))) if raw else (loss.item(), host)


def train_step_bound(g: torch.Tensor, dg: float, scale: float, dscale: float, lr: float,
                     eps: float = 1e-8):
    """How far a gradient error of ``dg`` moves each element's m, v and
    weight after the first AdamW step (b1 0.9, b2 0.95, scale the clip
    factor): m = 0.1 g', v = 0.05 g'^2 with g' = scale g.  ``dscale``: how
    far the other side's clip factor lies from ``scale`` (its global norm
    moved by the gradients' errors), which moves g' by |g| dscale more.  The
    weight's bound is lr times the update g' / (|g'| + eps)'s largest change
    over g' within that error (the update rises with g', so the ends of
    that range bound it); its slope at g' understates that change where the
    error reaches across 0.  The change from b to a = b + error is formed
    without cancellation (f32 and f64 round the change of an update near 1
    to 0): eps (a - b) / ((|a| + eps)(|b| + eps)) on one side of 0,
    |a| / (|a| + eps) + |b| / (|b| + eps) across it; in f64."""
    g = g.double()
    x = scale * g
    dgp = scale * dg + (g.abs() + dg) * dscale

    def change(b):  # from b to a = b + dgp
        a = b + dgp
        return torch.where(a * b >= 0, eps * dgp / ((a.abs() + eps) * (b.abs() + eps)),
                           a.abs() / (a.abs() + eps) + b.abs() / (b.abs() + eps))

    step = torch.maximum(change(x), change(x - dgp))
    return 0.1 * dgp, 0.05 * (2 * x.abs() + dgp) * dgp, lr * step


def _wkv6_in_dtype(r, k, v, w, u, state=None):
    """The WKV6 recurrence step by step in r's dtype (f64 for
    :func:`_f64_grads`), for autograd: wkv6_ref computes in f32."""
    b, t, h, m = r.shape
    s = (torch.zeros((b, h, m, m), dtype=r.dtype, device=r.device) if state is None
         else state.to(r.dtype))
    w, u = w.to(r.dtype), u.to(r.dtype)
    outs = []
    for i in range(t):
        r_t, k_t, v_t = r[:, i], k[:, i], v[:, i]
        bonus = (r_t * u * k_t).sum(-1, keepdim=True) * v_t
        outs.append((r_t[..., :, None] * s).sum(-2) + bonus)
        s = w[:, i, ..., None] * s + k_t[..., :, None] * v_t[..., None, :]
    return torch.stack(outs, 1), s


def _f64_grads(cfg, model, batch) -> tuple:
    """The gradient leaves of an f64 copy of an rwkv6 ``model`` on its
    device, the WKV recurrence in f64 too, rounded to f32 on the host: by
    JAX names and by the model's parameter names (rwkv6's train parity
    reference)."""
    from repro_torch.models import rwkv

    m64 = copy.deepcopy(model).double()
    saved = rwkv.wkv6
    rwkv.wkv6 = _wkv6_in_dtype
    try:
        _, named, raw = _grads(cfg.replace(dtype=torch.float64), m64, batch, raw=True)
    finally:
        rwkv.wkv6 = saved
        del m64
    return ({k: x.float() for k, x in named.items()},
            {k: x.float().cpu() for k, x in raw.items()})


def train_parity_phase(dev, arch: str = "yi-9b") -> dict:
    """A 2-layer ``arch`` at full width in f32, one set of weights drawn on
    the card from seed 0 and copied to the host, one train_4k-kind batch of
    TRAIN_PARITY_SEQ tokens: the loss on the card (the arch's forward and
    backward kernels: flash for yi, wkv6 for rwkv6, flash and ssm_scan for
    hymba) against the CPU's (plain versions); every gradient leaf within
    TRAIN_GRAD_RTOL of its largest of the CPU's (rwkv6: within
    TRAIN_F64_RTOL of an f64 run's, TRAIN_F64_REF); then one AdamW step of
    ``make_train_step`` on the card against AdamW.update of the reference
    gradients on the host (as make_train_step applies them): every weight,
    m and v within :func:`train_step_bound` of the gradient bound and the
    two clip factors."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.common import ParamFactory
    from repro_torch.optim import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=2, dtype=torch.float32)
    card_model = zoo.build_params(cfg, 0, device=dev)
    host_model = zoo.LM(cfg, ParamFactory(0, torch.float32, torch.device("cpu"), fill=False))
    host_model.load_state_dict(card_model.state_dict())
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH,
                                              "train"), 0, device="cpu")
    card_batch = {k: x.to(dev) for k, x in batch.items()}
    card_loss, card_g = _grads(cfg, card_model, card_batch)
    host_loss, host_g, host_raw = _grads(cfg, host_model, batch, raw=True)
    rec = {"loss_card": card_loss, "loss_cpu": host_loss, "reference": "cpu",
           "grad_rel_err": {}}
    if not abs(card_loss - host_loss) <= PARITY_ATOL:
        raise AssertionError(f"train parity {arch}: loss {card_loss} on the card, {host_loss} "
                             "on the CPU")
    rel = lambda g, ref: (g - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
    ref_g, ref_raw, rtol = host_g, host_raw, TRAIN_GRAD_RTOL
    if arch in TRAIN_F64_REF:
        ref_g, ref_raw = _f64_grads(cfg, card_model, card_batch)
        rtol, rec["reference"] = TRAIN_F64_RTOL, "f64 on the card"
        rec["cpu_vs_ref_grad_rel_err"] = {name: rel(g, ref_g[name]) for name, g in host_g.items()}
    del host_raw
    grad_bound = {name: rtol * g.abs().max().item() for name, g in ref_g.items()}
    for name, g in ref_g.items():
        rec["grad_rel_err"][name] = rel(card_g[name], g)
    off = {name: rec["grad_rel_err"][name] for name, g in ref_g.items()
           if not (card_g[name] - g).abs().max().item() <= grad_bound[name]}
    if off:
        log(f"train parity {arch}: gradient relative errors {json.dumps(rec)}")
        raise AssertionError(f"train parity {arch}: gradients off by more than {rtol} of each "
                             f"leaf's largest (relative errors): {off}")
    opts = AdamW(lr=TRAIN_LR), AdamW(lr=TRAIN_LR)
    states = [{"params": m, "opt": o.init(zoo.model_params(m)), "step": 0}
              for m, o in zip((card_model, host_model), opts)]
    _, card_m = zoo.make_train_step(cfg, opts[0])(states[0], {k: x.to(dev) for k, x in
                                                             batch.items()})
    # on the host the same step from the reference gradients: make_train_step
    # with one microbatch on the CPU takes the CPU's again (the same sums,
    # bit for bit) and hands them to AdamW.update
    with torch.no_grad():
        *_, host_m = opts[1].update(ref_raw, states[1]["opt"], zoo.model_params(host_model))
    del ref_raw
    scale = min(1.0, 1.0 / float(host_m["grad_norm"]))
    # the clip factors differ where the gradients' bound lets the global
    # norms differ (rwkv6: by ~1.2e-4 of the norm)
    dscale = abs(min(1.0, 1.0 / float(card_m["grad_norm"])) - scale)
    rec["grad_norm_card"], rec["grad_norm_ref"] = (float(card_m["grad_norm"]),
                                                   float(host_m["grad_norm"]))
    trees = [(zoo.to_jax_params(cfg, st["params"]), zoo.to_jax_params(cfg, st["opt"].m),
              zoo.to_jax_params(cfg, st["opt"].v)) for st in states]
    worst = {"params": 0.0, "m": 0.0, "v": 0.0}
    # the bounds and comparisons on the card (f64 over yi's 0.9 B weights
    # takes the host ~1 min)
    for name, g in ref_g.items():
        g = g.to(dev)
        bounds = train_step_bound(g, grad_bound[name], scale, dscale, TRAIN_LR)
        for i, what in enumerate(("params", "m", "v")):
            card, host = trees[0][i][name], trees[1][i][name].to(dev)
            lim = {"m": bounds[0], "v": bounds[1], "params": bounds[2]}[what]
            # and f32's own rounding: 1e-6 of a value; a weight's update is
            # lr times an O(1) quotient, good to ~1e-6 of lr, which a weight
            # that the step brings near 0 does not scale down
            lim = lim + 1e-6 * host.abs() + (TRAIN_LR * 1e-6 if what == "params" else 1e-12)
            bad = ((card - host).abs() > lim).flatten().nonzero()[:, 0].cpu()
            worst[what] = max(worst[what], (card - host).abs().max().item())
            if len(bad):
                at = bad[:6]
                show = {"g_ref": g.cpu().flatten()[at], "g_card": card_g[name].flatten()[at],
                        **{f"{w}_{side}": trees[j][i2][name].cpu().flatten()[at]
                           for j, side in enumerate(("card", "ref"))
                           for i2, w in enumerate(("params", "m", "v"))}}
                log(f"train parity {arch}: {len(bad)} elements of {what} {name} past the "
                    f"bound; first: {({k: v.tolist() for k, v in show.items()})}, "
                    f"scale {scale}")
                raise AssertionError(f"train parity {arch}: {len(bad)} elements of {what} "
                                     f"{name} past the bound the gradient tolerance allows")
        del g, bounds, card, host, lim
    rec["max_abs_err_after_step"] = worst
    rec["seconds"] = time.perf_counter() - t
    log(f"train parity: 2-layer {arch} full width f32, B={TRAIN_PARITY_BATCH} "
        f"S={TRAIN_PARITY_SEQ}, card vs {rec['reference']}: {json.dumps(rec)}")
    del card_model, host_model, states, trees
    torch.cuda.empty_cache()
    return rec


def grad_conditioning(dev, seeds: int) -> list:
    """rwkv6's f32 gradients against an f64 run on the card (the
    TRAIN_F64_REF reference) at draws of the train parity phase's shapes:
    for seeds 0 to ``seeds`` - 1, weights drawn on the card's generator and
    on the CPU's; each side's (the CPU's plain versions, the card's
    kernels) largest error of a leaf relative to the leaf's largest
    |gradient|, and the leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.common import ParamFactory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("rwkv6-1.6b").replace(n_layers=2, dtype=torch.float32)
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH,
                                              "train"), 0, device="cpu")
    card_batch = {k: x.to(dev) for k, x in batch.items()}
    rel = lambda g, ref: (g - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
    out = []
    for drawn in ("card", "cpu"):
        for seed in range(seeds):
            card_model = zoo.build_params(cfg, seed, device=dev if drawn == "card" else "cpu")
            card_model = card_model.to(dev)
            host_model = zoo.LM(cfg, ParamFactory(0, torch.float32, torch.device("cpu"),
                                                  fill=False))
            host_model.load_state_dict(card_model.state_dict())
            sides = {"kernels": _grads(cfg, card_model, card_batch)[1],
                     "cpu": _grads(cfg, host_model, batch)[1]}
            ref_g, _ = _f64_grads(cfg, card_model, card_batch)
            rec = {"drawn": drawn, "seed": seed}
            for side, grads in sides.items():
                errs = {name: rel(g, ref_g[name]) for name, g in grads.items()}
                worst = max(errs, key=errs.get)
                rec[side] = {"max": errs[worst], "leaf": worst}
            log(f"grad conditioning: 2-layer rwkv6-1.6b f32 against f64 on the card, "
                f"B={TRAIN_PARITY_BATCH} S={TRAIN_PARITY_SEQ}: {json.dumps(rec)}")
            out.append(rec)
            del card_model, host_model, sides, ref_g
            torch.cuda.empty_cache()
    return out


def route_gradients(cfg, model, batch) -> dict:
    """Every weight's gradient of one forward and backward of ``batch``,
    once with the flash backward on its ``wgmma`` route (the train step's)
    and once on ``simt`` (``bwd_route_forced``): the relative error of the
    global gradient norm, which must be within TRAIN_ROUTE_RTOL, and of each
    leaf (``|g_wgmma - g_simt| / |g_simt|``, 2-norms), with each route's
    launches."""
    from repro_torch.kernels.flash_attention import bwd_route_forced, flash_attention_bwd
    from repro_torch.models import zoo

    params = zoo.model_params(model)
    grads, routes = {}, {}
    for route in ("wgmma", "simt"):
        before = dict(flash_attention_bwd.route_launches)
        try:
            for p in params.values():
                p.requires_grad_(True)
            with bwd_route_forced(route):
                loss, _ = zoo.loss_fn(cfg, model, batch)
                grads[route] = torch.autograd.grad(loss, list(params.values()))
        finally:
            for p in params.values():
                p.requires_grad_(False)
        routes[route] = {k: n - before[k] for k, n in flash_attention_bwd.route_launches.items()}
        if routes[route][route] != TRAIN_LAYERS or sum(routes[route].values()) != TRAIN_LAYERS:
            raise AssertionError(f"route gradients: {route} launches {routes[route]}")
    norm = lambda gs: torch.sqrt(sum(g.float().pow(2).sum() for g in gs)).item()
    gw, gs = norm(grads["wgmma"]), norm(grads["simt"])
    leaves = {name: (torch.linalg.vector_norm((a.float() - b.float())) /
                     torch.linalg.vector_norm(b.float()).clamp_min(1e-30)).item()
              for name, a, b in zip(params, grads["wgmma"], grads["simt"])}
    rec = {"norm_wgmma": gw, "norm_simt": gs, "norm_rel_err": abs(gw - gs) / gs,
           "leaf_rel_err": leaves, "launches": routes}
    log(f"train phase step 0 gradients, wgmma vs simt: {json.dumps(rec)}")
    if not rec["norm_rel_err"] <= TRAIN_ROUTE_RTOL:
        raise AssertionError(f"route gradients: global norm {gw} through wgmma, {gs} through simt")
    del grads
    torch.cuda.empty_cache()
    return rec


def train_phase(dev, profile_dir: str | None, arch: str = "yi-9b") -> dict:
    """TrainDriver's step function and AdamW on ``arch`` at full width (yi-9b
    at TRAIN_LAYERS of its 48 layers; rwkv6-1.6b and hymba-1.5b at full
    depth: TRAIN_DEPTH), bf16, remat on, TRAIN_BATCH sequences of TRAIN_SEQ
    tokens a step from TokenPipeline in TRAIN_MICROBATCH microbatches.
    Launch counts from 0 just before the steps: a step launches each of the
    arch's forward kernels layers x microbatches x 2 (forward and remat
    recompute) and each of its backward kernels layers x microbatches
    (TRAIN_KERNELS), and no other path kernel; no plain version may run on
    the card; every flash backward launch takes the ``wgmma`` route.  For yi,
    before the steps, on step 0's first microbatch and the initial weights,
    the gradients through ``wgmma`` against those through ``simt`` (the
    Function's route forced): the global gradient norm within
    TRAIN_ROUTE_RTOL, each leaf's relative error logged
    (:func:`route_gradients`).  Each step logs its seconds, tokens/s, peak
    memory and the device seconds of forward, loss, backward (with the
    loss's and the blocks' recompute) and optimizer from CUDA events at the
    step's stage marks; the last step runs under torch.profiler for the
    device's busy share and each kernel kind's device seconds and share."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv6_kernel
    from repro_torch.models import zoo
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainDriver

    layers, n_steps = TRAIN_DEPTH[arch]
    cfg = get_config(arch).replace(n_layers=layers, microbatch=TRAIN_MICROBATCH)
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, vocab=cfg.vocab)
    # launch.train's default schedule: peak 3e-4 after 20 warm-up steps of 100
    driver = TrainDriver(cfg, TRAIN_DIR / arch, data=data, device=dev,
                         opt=AdamW(lr=cosine_schedule(3e-4, 20, 100)))
    t = time.perf_counter()
    state = driver.init_state()
    pipe = TokenPipeline(data)
    n_params = zoo.param_count(state["params"])
    probe = {name: state["params"].get_parameter(name).detach().float().sum().item()
             for name in (p.format(last=layers - 1) for p in TRAIN_PROBES[arch])}
    events: list = []

    def mark(stage: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    step_fn = zoo.make_train_step(cfg, driver.opt, mark=mark)
    routed = None
    if arch == "yi-9b":
        first = pipe.batch_at(0)
        routed = route_gradients(cfg, state["params"], {k: torch.as_tensor(np.asarray(x[
            :TRAIN_BATCH // TRAIN_MICROBATCH])).to(dev) for k, x in first.items()})
    plain_refs = {flash_kernel: ("flash_attention_ref", "flash_attention_bwd_ref",
                                 "flash_attention_lse_ref"),
                  wkv6_kernel: ("wkv6_ref", "wkv6_bwd_ref"),
                  ssm_kernel: ("ssm_scan_ref", "ssm_scan_bwd_ref")}
    plain_on_card = {name: 0 for names in plain_refs.values() for name in names}
    originals = {(mod, name): getattr(mod, name) for mod, names in plain_refs.items()
                 for name in names}

    def counting(mod, name):
        def call(x, *args, **kw):
            if x.device.type == "cuda":
                plain_on_card[name] += 1
            return originals[mod, name](x, *args, **kw)
        return call

    for mod, name in originals:
        setattr(mod, name, counting(mod, name))
    log(f"train phase: {arch} {layers} layers, {n_params} weights in bf16, set up "
        f"in {time.perf_counter() - t:.1f} s")
    path = [k for pair in TRAIN_KERNELS[arch] for k in pair]
    watched = ("flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd", "ssm_scan",
               "ssm_scan_bwd")
    per = layers * TRAIN_MICROBATCH
    want = {k: (2 * per if k in path and not k.endswith("_bwd") else per if k in path else 0)
            for k in watched}
    want_routes = {"simt": 0, "wgmma": want["flash_attention_bwd"]}
    kinds = {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_bwd",),
             "wkv6_fwd": ("wkv6_fwd",), "wkv6_bwd": ("wkv6_bwd",),
             "ssm_scan_fwd": ("ssm_scan_fwd",), "ssm_scan_bwd": ("ssm_scan_bwd",),
             "matmul": ("gemm", "nvjet", "xmma", "cutlass")}
    # the recurrences' backward kernels take their bf16 route on every launch
    rec_bwd = {"wkv6_bwd": "mma", "ssm_scan_bwd": "regs"}
    want_rec_routes = {k: {r: want[k] * (r == route) for r in kernels.WRAPPERS[k].route_launches}
                       for k, route in rec_bwd.items()}
    steps, losses = [], []
    kernels.reset_launches()
    bwd = kernels.WRAPPERS["flash_attention_bwd"]
    try:
        for step in range(n_steps):
            batch = pipe.batch_at(step)
            at = kernels.launch_counts()
            at_routes = dict(bwd.route_launches)
            at_rec = {k: dict(kernels.WRAPPERS[k].route_launches) for k in rec_bwd}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            events.clear()
            mark("start")
            t0 = time.perf_counter()
            profiled_step = step == n_steps - 1
            if profiled_step:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state, metrics = step_fn(state, batch)
                    torch.cuda.synchronize()
            else:
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"train phase {arch}: loss {loss} at step {step}")
            losses.append(loss)
            stage_s: dict[str, float] = {}
            for (_, a), (stage, b) in zip(events, events[1:]):
                stage_s[stage] = stage_s.get(stage, 0.0) + a.elapsed_time(b) / 1e3
            now = kernels.launch_counts()
            rec = {"arch": arch, "step": step, "loss": loss, "seconds": wall,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
                   "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                   "stage_device_s": stage_s,
                   "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
                   "launches": {k: now[k] - at[k] for k in watched},
                   "bwd_routes": {k: n - at_routes[k] for k, n in bwd.route_launches.items()},
                   "rec_bwd_routes": {k: {r: n - at_rec[k][r] for r, n in
                                          kernels.WRAPPERS[k].route_launches.items()}
                                      for k in rec_bwd}}
            if profiled_step:
                evs = prof.events()
                kernels_seen = sum(1 for e in evs if e.device_type == DeviceType.CUDA)
                launched = sum(1 for e in evs if e.device_type == DeviceType.CPU
                               and e.name in LAUNCH_APIS)
                busy = device_us(evs)
                rec["profiled"] = True
                rec["device_busy_pct"] = (100 * busy / 1e6 / wall
                                          if kernels_seen >= launched > 0 else None)
                by_name: dict[str, float] = {}
                for e in evs:
                    if e.device_type == DeviceType.CUDA:
                        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
                rec["kernel_device_s"] = {kind: sum(t for n, t in by_name.items() if any(
                    w in n.lower() for w in words)) for kind, words in kinds.items()}
                rec["kernel_device_s"]["all"] = busy / 1e6
                rec["kernel_share_pct"] = {kind: 100 * v * 1e6 / busy for kind, v in
                                           rec["kernel_device_s"].items() if kind != "all"}
                rec["top_kernels_s"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
                if profile_dir:
                    stem = "" if arch == "yi-9b" else f"{PROFILE_STEM[arch]}_"
                    write_profile(prof, wall, Path(profile_dir) / f"{stem}train_profile.txt",
                                  f"{arch} train step", busy)
            if (rec["launches"] != want or rec["bwd_routes"] != want_routes
                    or rec["rec_bwd_routes"] != want_rec_routes):
                raise AssertionError(f"train phase {arch} step {step}: launches "
                                     f"{rec['launches']}, flash backward routes "
                                     f"{rec['bwd_routes']}, recurrences' backward routes "
                                     f"{rec['rec_bwd_routes']}, want {want}, {want_routes} and "
                                     f"{want_rec_routes}")
            steps.append(rec)
            log(f"train step: {json.dumps(rec)}")
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = kernels.launch_counts()
    route_launches = {k: dict(kernels.WRAPPERS[k].route_launches) for k in watched}
    if any(plain_on_card.values()):
        raise AssertionError(f"train phase {arch}: plain versions ran on the card "
                             f"{plain_on_card}")
    moved = {name: state["params"].get_parameter(name).detach().float().sum().item() != v
             for name, v in probe.items()}
    if not all(moved.values()):
        raise AssertionError(f"train phase {arch}: weights did not move {moved}")
    unprofiled = [r["seconds"] for r in steps[1:-1]]
    rec = {"arch": arch, "layers": layers, "steps": n_steps, "losses": losses,
           "launches": launches, "route_launches": route_launches,
           "bwd_routes": dict(bwd.route_launches),
           "route_gradients": routed, "plain_on_card": plain_on_card, "weights_moved": moved,
           "median_step_s": float(np.median(unprofiled)),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(np.median(unprofiled)),
           "peak_memory_gb": max(r["max_memory_allocated_gb"] for r in steps),
           "profiled_step": steps[-1], "seconds": time.perf_counter() - t}
    log(f"train phase: {json.dumps({k: v for k, v in rec.items() if k != 'profiled_step'})}")
    del state, driver, step_fn
    torch.cuda.empty_cache()
    return rec


def _launch_trains(runs: dict) -> dict:
    """Each of ``runs`` (name -> (arch, *launch.train flags)) as a
    ``launch.train --smoke`` subprocess on the card, all started together;
    the JSON line each prints last, by name.  Kills any left running."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    try:
        for name, (arch, *args) in runs.items():
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
                   "--ckpt-every", str(DRIVER_CKPT_EVERY), *args]
            procs[name] = cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                                env=env)
        out = {}
        for name, (cmd, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{' '.join(cmd)} failed:\n{stderr[-4000:]}")
            out[name] = json.loads(stdout.strip().splitlines()[-1])
        return out
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _launch_train(arch: str, *args: str) -> dict:
    return _launch_trains({"run": (arch, *args)})["run"]


def _replays(arch: str, clean: dict, faulty: dict) -> None:
    """The run with a host lost at DRIVER_FAIL_AT reports one restart to the
    step-5 checkpoint and ends on the clean run's losses bit for bit: every
    gradient on the path is summed in a fixed order (the embedding's
    backward included, models/embedding.py), so the restarted process
    replays the clean one's steps exactly."""
    if not (faulty["restarts"] == 1 and faulty["restored_steps"] == [DRIVER_CKPT_EVERY]
            and faulty["steps"] == DRIVER_STEPS + DRIVER_FAIL_AT - DRIVER_CKPT_EVERY):
        raise AssertionError(f"driver {arch}: the faulty run reports {faulty}")
    if (faulty["first_loss"], faulty["last_loss"]) != (clean["first_loss"], clean["last_loss"]):
        raise AssertionError(f"driver {arch}: replayed losses differ: {faulty} vs {clean}")


def driver_phase(dev) -> dict:
    """``python -m repro_torch.launch.train --arch yi-9b --smoke`` in
    subprocesses on the card: 12 steps with a checkpoint every 5, clean and
    with a host lost at step 8 (``--fail-at-step``), which must replay the
    clean run (:func:`_replays`); the step-5 checkpoint restores (sha256
    verified) into a train state that saves back to the same bytes; and a
    third process resumes the clean run from its step-12 checkpoint to 17
    steps and runs exactly 5.  Then ``--arch rwkv6-1.6b --smoke`` and
    ``--arch hymba-1.5b --smoke`` (their recurrences' forward and backward
    kernels), clean and with ``--fail-at-step 8``, each faulty run replaying
    its clean run.  The six clean and faulty processes run at once; the
    resume follows them."""
    from repro_torch.checkpoint import restore_state, snapshot
    from repro_torch.configs import get_config
    from repro_torch.runtime import TrainDriver

    t = time.perf_counter()
    shutil.rmtree(TRAIN_DIR / "driver", ignore_errors=True)
    base = TRAIN_DIR / "driver"
    steps = ("--steps", str(DRIVER_STEPS))
    archs = ("rwkv6-1.6b", "hymba-1.5b")
    fault = {"clean": (), "faulty": ("--fail-at-step", str(DRIVER_FAIL_AT))}
    done = _launch_trains({
        ("yi-9b", kind): ("yi-9b", *steps, "--ckpt-dir", str(base / kind), *flags)
        for kind, flags in fault.items()} | {
        (arch, kind): (arch, *steps, "--ckpt-dir", str(base / arch / kind), *flags)
        for arch in archs for kind, flags in fault.items()})
    clean, faulty = done["yi-9b", "clean"], done["yi-9b", "faulty"]
    resumed = _launch_train("yi-9b", "--steps", str(DRIVER_RESUME_TO), "--ckpt-dir",
                            str(base / "clean"))
    log(f"driver clean: {json.dumps(clean)}")
    log(f"driver fail at {DRIVER_FAIL_AT}: {json.dumps(faulty)}")
    log(f"driver resumed to {DRIVER_RESUME_TO}: {json.dumps(resumed)}")
    _replays("yi-9b", clean, faulty)
    if resumed["steps"] != DRIVER_RESUME_TO - DRIVER_STEPS or resumed["restored_steps"]:
        raise AssertionError(f"driver: the resumed run reports {resumed}")
    cfg = get_config("yi-9b", smoke=True)
    path = base / "faulty" / cfg.name
    drv = TrainDriver(cfg, path, device=dev)
    state = drv.init_state()
    tree, step = restore_state(path, drv.tree(state), step=DRIVER_CKPT_EVERY)  # sha256 checked
    state = drv.load_tree(state, tree)
    manifest = json.loads((path / f"step_{step:09d}" / "MANIFEST.json").read_text())["leaves"]
    saved = snapshot(drv.tree(state))  # the restored state, as a save would write it
    same = set(saved) == set(manifest) and all(
        hashlib.sha256(arr.tobytes()).hexdigest() == manifest[name]["sha256"]
        and dtype == manifest[name]["dtype"] for name, (arr, dtype) in saved.items())
    if step != DRIVER_CKPT_EVERY or not same or state["step"] != DRIVER_CKPT_EVERY:
        raise AssertionError("driver: the step-5 state does not restore to its checkpoint")
    recurrent = {arch: {kind: done[arch, kind] for kind in fault} for arch in archs}
    for arch, runs in recurrent.items():
        log(f"driver {arch}: {json.dumps(runs)}")
        _replays(arch, runs["clean"], runs["faulty"])
    rec = {"clean": clean, "faulty": faulty, "resumed": resumed,
           "restored_step_equals_checkpoint": same, "recurrent": recurrent,
           "seconds": time.perf_counter() - t}
    log(f"driver phase: restarts {faulty['restarts']} restored {faulty['restored_steps']}, "
        f"last loss {faulty['last_loss']} vs clean {clean['last_loss']}, step-5 state equals "
        f"its checkpoint (sha256 verified), resumed {resumed['steps']} steps; rwkv6 and hymba "
        f"restarted runs replay their clean runs; {rec['seconds']:.1f} s")
    del drv, state, tree
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


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
    ap.add_argument("--grad-conditioning", metavar="SEEDS", type=int, default=None,
                    help="run only rwkv6's f32-against-f64 gradient sweep over SEEDS draws")
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

    if args.grad_conditioning is not None:
        build.build_all(["wkv6", "wkv6_bwd"])
        grad_conditioning(dev, args.grad_conditioning)
        return 0
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
    table = service.pop("table")
    filtered = filter_phase(dev, table)
    elapsed("the Filter phase")
    prop_cluster, propagated = propagation_phase(dev)
    reduced = reduce_phase(prop_cluster)
    del prop_cluster
    torch.cuda.empty_cache()
    elapsed("the propagation and reduce phases")
    tenancy = tenancy_phase(dev, table)
    elapsed("the tenancy phase")
    lossy = loss_phase(dev, app, starts, oracle, table, dapc["arms"])
    elapsed("the loss phase")
    sandboxed = sandbox_phase(dev, table)
    elapsed("the sandbox phase")
    tuned = autotune_phase(app, starts, oracle)
    elapsed("the tenancy, loss, sandbox and autotune phases")
    spmd = spmd_phase(dev, table, app.table, oracle)
    del table
    torch.cuda.empty_cache()
    elapsed("the compiled SPMD phase (host walls: gloo stages through the host)")
    floor = time_floor(dev, rng, tables)
    timing = time_kernel(dev, rng, floor, service["mean_n"], filtered["mean_n"])
    chase_timing = time_chase(dev, rng, tables, floor, dapc["mean_b"], app.table)
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
    bwd_checked = flash_bwd_kernel_phase(dev)
    bwd_timing = time_flash_bwd(dev)
    elapsed("the flash backward kernel phase and timing")
    train_parity_phase(dev)
    elapsed("the train parity phase")
    trained = train_phase(dev, args.profile)
    elapsed("the train phase")
    wkv_bwd_checked = wkv6_bwd_kernel_phase(dev)
    wkv_bwd_timing = time_rec_bwd(dev, "wkv6_bwd")
    ssm_bwd_checked = ssm_scan_bwd_kernel_phase(dev)
    ssm_bwd_timing = time_rec_bwd(dev, "ssm_scan_bwd")
    elapsed("the recurrences' backward kernel phases and timings")
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        train_parity_phase(dev, arch)
    elapsed("the rwkv6 and hymba train parity phases")
    rwkv_trained = train_phase(dev, args.profile, "rwkv6-1.6b")
    hymba_trained = train_phase(dev, args.profile, "hymba-1.5b")
    elapsed("the rwkv6 and hymba train phases")
    driver_phase(dev)
    elapsed("the driver phase")
    # the path's launches by the shape they come in: per-message dispatches
    # at N = 16 ids and B = 1 chase, batched ones at their arm's mean,
    # launch.serve's remote embedding at N = 8 of each LM's rows, and the
    # compiled SPMD phase's ranks (four gloo, one NCCL)
    g_arms, d_arms = service["arms"], dapc["arms"]
    spmd_ranks = [*spmd["launches"], {k: a["launches"] for k, a in spmd["nccl"].items()}]
    spmd_by = lambda arm, kernel: sum(r[arm][kernel] for r in spmd_ranks if arm in r)
    embed_by_shape = {"message": g_arms["per_message"]["kernel_launches"],
                      "mean": sum(g_arms[a]["kernel_launches"] for a in ("batched", "zerocopy")),
                      **{f"remote {arch}": runs["remote"]["launches"]["embed_lookup"]
                         for arch, runs in served.items()},
                      "filter": sum(c["arms"]["per_message"]["kernel_launches"]
                                    for c in filtered["cells"]),
                      "filter_batched": sum(c["arms"][a]["kernel_launches"]
                                            for c in filtered["cells"]
                                            for a in ("batched", "zerocopy", "auto")),
                      "spmd gather": spmd_by("gather", "embed_lookup"),
                      "spmd embed_c2d": spmd_by("embed_c2d", "embed_lookup")}
    chase_by_shape = {"message": d_arms["bitcode_per_message"]["kernel_launches"],
                      "mean": sum(d_arms[a]["kernel_launches"] for a in (
                          "bitcode_batched", "bitcode_zerocopy", "binary_batched")),
                      "spmd": spmd_by("dapc", "chase_shard")}
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
        "launches_tenancy": tenancy["launches"],
        "launches_loss": lossy["launches"]["embed_lookup"],
        "launches_sandbox": sandboxed["launches"],
        "launches_spmd": {arm: [r[arm]["embed_lookup"] for r in spmd["launches"]]
                          for arm in ("gather", "embed_c2d")},
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
        "launches_loss": lossy["launches"]["chase_shard"],
        "launches_autotune": tuned["launches"],
        "launches_spmd": [r["dapc"]["chase_shard"] for r in spmd["launches"]],
        "max_abs_err": chase_checked["max_abs_err"],
        **{k: chase_timing["message"][k] for k in keys},
        "shape": (f"message B=1 depth {DAPC_DEPTH} on the chain "
                  f"({chase_timing['message']['route']})"),
        "shapes": {label: {"b": v["b"], "depth": v["depth"], "table": v["table"],
                           **{k: v[k] for k in shape_keys}}
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
        "launches_spmd": [r["attend_sp"]["flash_attention"] + r["attend_sp_window"][
            "flash_attention"] for r in spmd["launches"]],
        "max_abs_err": flash_checked["max_abs_err"],
        "max_abs_err_f32_probs": flash_checked["max_abs_err_f32_probs"],
        "max_abs_err_lse": max(flash_checked["max_abs_err_lse"], bwd_checked["max_abs_err_lse"]),
        **{k: flash_timing["prefill"][k] for k in keys},
        "shape": "prefill B=1 S=T=2048 H=32 K=4 d=128 bf16 (wgmma; decodes: split)",
        "decode": {k: flash_timing["decode"][k] for k in keys},
        "hymba_prefill": {k: flash_timing["hymba_prefill"][k] for k in keys},
        "hymba_decode": {k: flash_timing["hymba_decode"][k] for k in keys},
        "shapes_spmd": {k.removeprefix("spmd "): {k2: v[k2] for k2 in (*keys, "route", "call_ms")}
                        for k, v in flash_timing.items() if k.startswith("spmd")},
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
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "no Pallas kernel: the JAX package differentiates its einsum attend "
                    "(src/repro/models/attention.py:46) with XLA",
        "launches": trained["launches"]["flash_attention_bwd"],
        "launches_by_route": trained["bwd_routes"],
        "routes_by_dtype": bwd_checked["routes_by_dtype"],
        "launches_flash_attention_forward_in_training": trained["launches"]["flash_attention"],
        "max_abs_err": bwd_checked["max_abs_err"],
        "bound_share": bwd_checked["bound_share"],
        **{k: bwd_timing[k] for k in keys},
        "simt_ms": bwd_timing["simt_ms"],
        "design_floor_ms": bwd_timing["design_floor_ms"],
        "kernels_ms": bwd_timing["kernels_ms"],
        "forward_ms": bwd_timing["forward_ms"],
        "step0_grad_norm_rel_err_wgmma_vs_simt": trained["route_gradients"]["norm_rel_err"],
        "shape": "train B=2 S=T=4096 H=32 K=4 d=128 bf16 causal, given the forward's lse "
                 "(wgmma: delta pass, dK/dV and dQ)",
        "launches_hymba_training": hymba_trained["launches"]["flash_attention_bwd"],
        "launches_by_route_hymba_training": hymba_trained["bwd_routes"],
    }]
    for name, stem, checked, timing, run, shape, jax_fn in (
            ("wkv6_bwd", "wkv6", wkv_bwd_checked, wkv_bwd_timing, rwkv_trained,
             "train B=2 T=4096 H=32 M=64 bf16 (w f32)", "src/repro/models/rwkv.py:33 wkv6_scan"),
            ("ssm_scan_bwd", "ssm_scan", ssm_bwd_checked, ssm_bwd_timing, hymba_trained,
             "train B=2 T=4096 D=1600 N=16 bf16 (a f32)",
             "src/repro/models/ssm.py:50 selective_scan")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"no Pallas kernel: the JAX package differentiates its jnp scan "
                        f"({jax_fn}) with XLA",
            "launches": run["launches"][name],
            "launches_by_route": run["route_launches"][name],
            "launches_forward_in_training": run["launches"][stem],
            "launches_by_route_per_step": run["profiled_step"]["rec_bwd_routes"][name],
            "routes_by_dtype": checked["routes_by_dtype"],
            "max_abs_err": checked["max_abs_err"],
            "bound_share": checked["bound_share"],
            "by_route": checked["routes"],
            **{k: timing[k] for k in keys},
            "split_ms": timing["split_ms"],
            "design_floor_ms": timing["design_floor_ms"],
            "design_ms": timing["design_ms"],
            "forward_ms": timing["forward_ms"],
            "kernels_ms": timing["kernels_ms"],
            "shape": f"{shape}, as the train step calls it ({timing['route']}; split timed "
                     "in turns)",
            "train_step_share_pct": run["profiled_step"]["kernel_share_pct"][name],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
