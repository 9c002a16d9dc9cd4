"""Drive the PyTorch port's Gather service and DAPC once on an NVIDIA card.

Usage: ``python3 chip_smoke.py [--profile DIR]`` from the root of
a checkout, on a host with one Hopper card (sm_90) and the CUDA toolkit.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every hand-written kernel from ``src/repro_torch/csrc``.
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   bit-exact, in f32, bf16 and i32 (the f32 rows' bit patterns, which the
   service's Gatherer looks up), at the service's shapes (K = 16 ids of one
   message, bucket x K ids of a batched dispatch, into one 524,288 x 128
   shard) and a large one.
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
   the shard, at 1, 8, 256 and 65,536 chases.
6. Times each kernel on the card (device time per call, torch.profiler)
   beside its plain version, the PyTorch call that computes the same
   function where there is one, and its bound from bytes moved; logs the
   back-to-back wall time per call (CUDA events) too.

Prints one JSON line of kernel results, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` last.  Any failure exits non-zero with
no result.  ``--profile DIR`` also writes torch.profiler tables of a short
batched Gather burst and of the batched DAPC arm to ``DIR``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SHARD_ROWS, DIM, N_SERVERS, N_KEYS, MAX_SLOTS = 524_288, 128, 8, 16, 64
N_REQUESTS = 1024
DAPC_ENTRIES, DAPC_CHASES, DAPC_DEPTH = 1 << 27, 256, 64
CHASE_SIZES = (1, 8, 256, 65_536)


def log(*args) -> None:
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, arg_sets, reps: int = 200) -> float:
    """Device time per call: the summed duration of every kernel and copy
    the calls put on the card (torch.profiler), over ``reps`` calls cycling
    through ``arg_sets`` (distinct id sets, so rows come from HBM, not L2),
    after warm-up.  Host time between launches is not counted."""
    for args in arg_sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = device_us(prof)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / reps


def device_us(prof) -> float:
    return sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)


def call_ms(fn, arg_sets, reps: int = 200) -> float:
    """Wall time per call of back-to-back calls (CUDA events): the rate the
    host can issue them, which bounds a launch-sized kernel."""
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


def edge_ids(rng, n: int, lo: int, v_loc: int, dev) -> torch.Tensor:
    """Mostly in-shard ids, plus ids below and above the shard and -1 pads."""
    ids = rng.integers(lo, lo + v_loc, n)
    pick = rng.random(n)
    ids[pick < 0.05] = rng.integers(0, max(lo, 1), int((pick < 0.05).sum()))
    above = (pick >= 0.05) & (pick < 0.10)
    ids[above] = rng.integers(lo + v_loc, lo + 2 * v_loc, int(above.sum()))
    ids[pick >= 0.97] = -1
    ids[:4] = [-1, lo - 1, lo + v_loc, lo]  # the boundaries, always
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def kernel_phase(dev, rng) -> dict:
    """embed_lookup on the card against its plain version, bit-exact."""
    from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_ref

    lo = 3 * SHARD_ROWS
    lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
    worst = 0.0
    shapes = {"message": N_KEYS, "bucket8": 8 * N_KEYS, "bucket64": MAX_SLOTS * N_KEYS,
              "large": 65_536}
    f32 = torch.randn(SHARD_ROWS, DIM, generator=torch.Generator(dev).manual_seed(1),
                      device=dev)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        table = f32.view(torch.int32) if dtype == torch.int32 else f32.to(dtype)
        for label, n in shapes.items():
            ids = edge_ids(rng, n, lo, SHARD_ROWS, dev)
            got = embed_lookup(table, ids, lo_t)
            want = embed_lookup_ref(table, ids, lo_t)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"embed_lookup differs from plain ({dtype}, {label})")
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            log(f"kernel embed_lookup {str(dtype)[6:]} {label} n={n}: bit-exact, max_abs_err={err}")
    del table, f32
    torch.cuda.empty_cache()
    return {"max_abs_err": worst}


def time_kernel(dev, rng) -> dict:
    """Times at the batched service's shape: bucket x K = 64 x 16 ids into
    one f32 shard, 128 distinct id sets so the rows are cold in L2."""
    from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_ref

    lo = 3 * SHARD_ROWS
    lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
    table = torch.randn(SHARD_ROWS, DIM, device=dev)
    n = MAX_SLOTS * N_KEYS
    sets = [edge_ids(rng, n, lo, SHARD_ROWS, dev) for _ in range(128)]
    args = [(table, ids, lo_t) for ids in sets]
    inside = [(ids.long() - lo >= 0) & (ids.long() - lo < SHARD_ROWS) for ids in sets]
    lib_args = [(table, (ids.long() - lo)[m].contiguous()) for ids, m in zip(sets, inside)]
    row = DIM * table.element_size()
    n_in = sum(int(m.sum()) for m in inside) / len(sets)
    moved = n * 4 + n_in * row + n * row  # ids read, in-shard rows read, rows written
    before = embed_lookup.launches
    library = lambda t, i: torch.index_select(t, 0, i)  # yardstick, unused by the port
    out = {
        "ms": device_ms(embed_lookup, args),
        "plain_ms": device_ms(embed_lookup_ref, args),
        "library_ms": device_ms(library, lib_args),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    calls = {
        "kernel": call_ms(embed_lookup, args),
        "plain": call_ms(embed_lookup_ref, args),
        "library": call_ms(library, lib_args),
    }
    embed_lookup.launches = before  # timing launches are not main-path launches
    log(f"timing embed_lookup n={n} f32, {moved:.0f} B moved: device ms per call "
        f"kernel {out['ms']}, plain {out['plain_ms']}, index_select yardstick "
        f"{out['library_ms']}, bound {out['bound_ms']}; back-to-back wall ms per "
        f"call {json.dumps(calls)}")
    return out


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
    reset_launches()  # the main path's launches are counted from here
    per_arm = {}
    for name, kw in arms.items():
        launches0, inv0 = launch_counts()["embed_lookup"], server_invokes()
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
            kernel_launches=launches, puts=rep.puts, coalesced_frames=rep.coalesced_frames,
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
    log(f"installed gatherer slice: cuda-sm90 on all {N_SERVERS} servers; "
        f"main-path launches {launches}")
    if profile_dir:
        profile_burst(svc, reqs[:256], Path(profile_dir))
    return {"launches": launches, "arms": per_arm}


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
    if b >= 8:  # the shard's edges, always (a lone chase stays a real chase)
        frontier[:3], depth[:3] = [lo - 1, lo + n_loc, lo], [7, 7, 0]
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
    """chase_shard on the card against its plain version, bit-exact."""
    from repro_torch.kernels.chase import chase_shard, chase_shard_ref

    worst = 0.0
    for kind, (table, lo, max_depth) in tables.items():
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        for b in CHASE_SIZES:
            frontier, depth = chase_inputs(rng, table, lo, b, max_depth, dev)
            f, d = chase_shard(table, frontier, depth, lo_t)
            f_want, d_want = chase_shard_ref(table, frontier, depth, lo_t)
            torch.cuda.synchronize()
            if not (torch.equal(f, f_want) and torch.equal(d, d_want)):
                raise AssertionError(f"chase_shard differs from plain ({kind}, B={b})")
            err = max((f.long() - f_want.long()).abs().max().item(),
                      (d.long() - d_want.long()).abs().max().item())
            worst = max(worst, float(err))
            hops = (depth - d).long()
            log(f"kernel chase_shard {kind} B={b}: bit-exact, max_abs_err={err}, hops "
                f"mean {hops.float().mean().item()} max {hops.max().item()}")
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

    reset_launches()  # the DAPC path's launches are counted from here
    per_arm = {}
    for name, arm in arms.items():
        launches0, inv0 = launch_counts()["chase_shard"], server_invokes()
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
            kernel_launches=launches, puts=rep.puts, gets=rep.gets,
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
    log(f"installed chaser slice: cuda-sm90 on all {N_SERVERS} servers; "
        f"DAPC launches {launches}")
    if profile_dir:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run(mode="bitcode", batching=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        write_profile(prof, wall, Path(profile_dir) / "dapc_profile.txt",
                      f"dapc batched arm, {DAPC_CHASES} chases")
    return {"launches": launches, "arms": per_arm}


def time_chase(dev, rng, tables) -> dict:
    """Times at the batched bucket shape: 256 chases of depth 64 into one
    2**24-entry shard of the DAPC chain (128 distinct frontier sets, so the
    shard is read from HBM), and the same on a cycle local to the shard,
    where every chase takes all 64 hops.  The bound counts 16 B per chase
    (frontier and depth read and written) plus 4 B per hop taken."""
    from repro_torch.kernels.chase import chase_shard, chase_shard_ref

    before = chase_shard.launches
    out = {}
    for kind, (table, lo, _) in tables.items():
        lo_t = torch.tensor([lo], dtype=torch.int32, device=dev)
        b = DAPC_CHASES
        depth = torch.full((b,), DAPC_DEPTH, dtype=torch.int32, device=dev)
        sets = [
            torch.from_numpy(rng.integers(lo, lo + table.shape[0], b).astype(np.int32)).to(dev)
            for _ in range(128)
        ]
        args = [(table, f, depth, lo_t) for f in sets]
        hops = torch.stack([depth - chase_shard_ref(*a)[1] for a in args]).long()
        moved = 16 * b + 4 * hops.sum().item() / len(sets)
        out[kind] = {
            "ms": device_ms(chase_shard, args),
            "plain_ms": device_ms(chase_shard_ref, args),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,  # no single PyTorch call chases to exit
            "hops_mean": hops.float().mean().item(),
            "hops_max": hops.max().item(),
            "call_ms": call_ms(chase_shard, args),
            "plain_call_ms": call_ms(chase_shard_ref, args),
        }
        log(f"timing chase_shard {kind} B={b} depth {DAPC_DEPTH}, {moved:.0f} B moved: "
            f"{json.dumps(out[kind])}")
    chase_shard.launches = before  # timing launches are not main-path launches
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


def write_profile(prof, wall: float, path: Path, what: str) -> None:
    events = prof.key_averages()
    busy_us = device_us(prof)
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
    t = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t:.1f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    rng = np.random.default_rng(0)
    checked = kernel_phase(dev, rng)
    service = service_phase(dev, N_REQUESTS, args.profile)
    app, starts, oracle = dapc_setup(dev)
    tables = chase_tables(dev, app)
    chase_checked = chase_kernel_phase(dev, rng, tables)
    dapc = dapc_phase(app, starts, oracle, args.profile)
    timing = time_kernel(dev, rng)
    chase_timing = time_chase(dev, rng, tables)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "embed_lookup",
        "route": "cuda",
        "source": "src/repro_torch/csrc/embed_lookup.cu",
        "replaces": "src/repro/kernels/embed_lookup/kernel.py:50",
        "launches": service["launches"]["embed_lookup"],
        "max_abs_err": checked["max_abs_err"],
        **{k: timing[k] for k in keys},
    }, {
        "name": "chase_shard",
        "route": "cuda",
        "source": "src/repro_torch/csrc/chase.cu",
        "replaces": "src/repro/kernels/chase/kernel.py:70",
        "launches": dapc["launches"]["chase_shard"],
        "max_abs_err": chase_checked["max_abs_err"],
        **{k: chase_timing["chain"][k] for k in keys},
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
