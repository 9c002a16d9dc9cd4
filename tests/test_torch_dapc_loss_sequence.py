"""chip_smoke.py's DAPC, loss and autotune phases in their order, on the CPU
at a small chain: ROADMAP T18, pinned as a reference fault.

A draft run of chip_smoke's loss phase on the first 128 of the DAPC
phase's 256 chases was followed, in the autotune phase, by a per-message
DAPC run on all 256 that failed with ``ProtocolError: ... truncated frame
for unregistered ifunc '' (stale sender cache)``.  This test replays that
order (8 ``thor_xeon`` servers, 2**18 entries, 256 chases of depth 64,
chip_smoke's seeds and ``BENCH_reliability.json``'s config):

1. the DAPC phase's arms on all 256 chases: bitcode per-message, batched
   and zero-copy, binary batched, Active Messages, GBPC;
2. the loss phase: the reliability config and loss rates, per-message and
   batched, on the FIRST 128 chases (loss seed 1), then loss and
   reliability off; on the port also the lossy Gather (framed, zero-copy,
   rendezvous; per message) and Filter (pushdown at selectivity 0.25), each
   at 5% on its own cluster;
3. the autotune phase's capture: a per-message run on all 256 chases.

Steps 1 and 2 equal their oracles.  Step 3 raises the same
``ProtocolError`` on the same server in the port (the ``cuda-sm90`` slice
through the kernels' plain versions) and in the JAX package: the fault is
the reference's, and the port keeps it.  chip_smoke runs its loss phase on
all 256 chases, where no server is left behind.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as janalysis
import repro.core as jcore
import repro_torch.analysis as tanalysis
import repro_torch.core as tcore
from repro_torch.runtime import EmbedShardService, FilterShardService, ragged_batches

ROOT = Path(__file__).resolve().parent.parent
N_SERVERS, N_ENTRIES, CHASES, DEPTH, LOSSY_CHASES = 8, 1 << 18, 256, 64, 128
LOSS_SEED = 1
ARMS = ("bitcode_per_message", "bitcode_batched", "bitcode_zerocopy", "binary_batched", "am",
        "gbpc")
REL = json.loads((ROOT / "BENCH_reliability.json").read_text())["config"]
LOSSY = [f"{rate} {name}" for rate in REL["loss_rates"] for name in ("per_message", "batched")]
PLANES = ("framed", "zerocopy", "rendezvous")
PACKAGES = {"port": (tcore, tanalysis, dict(server_triple="cuda-sm90", device="cpu")),
            "jax": (jcore, janalysis, {})}


def _lossy_gather_and_filter(out: dict, rel) -> None:
    """The loss phase's Gather and Filter at 5%, each on its own port
    cluster, at a small table."""
    kw = dict(wire="thor_xeon", **PACKAGES["port"][2])
    table = np.random.default_rng(2).standard_normal((4096, 16)).astype(np.float32)
    gcl = tcore.Cluster(n_servers=N_SERVERS, **kw)
    svc = EmbedShardService(gcl, vocab=4096, dim=16, n_keys=16, max_slots=64, table=table)
    reqs = ragged_batches(4096, 48, 16, seed=3)
    svc.gather([np.array([s * svc.rows_per_shard], np.int32) for s in range(N_SERVERS)])
    gcl.set_reliability(rel)
    gcl.fabric.set_loss(0.05, seed=LOSS_SEED)
    planes = {"framed": None, "zerocopy": tcore.DataPlaneConfig.zero_copy(eager_max=0),
              "rendezvous": tcore.DataPlaneConfig.rendezvous(rndv_min=1)}
    for plane, dataplane in planes.items():
        rep = svc.gather(reqs, dataplane=dataplane)
        out[f"gather {plane}"] = (np.concatenate(rep.results), np.concatenate(svc.oracle(reqs)))
    fcl = tcore.Cluster(n_servers=N_SERVERS, hetero_wire=True, **kw)
    fsvc = FilterShardService(fcl, vocab=4096, dim=16, window=24, max_slots=64, table=table)
    fsvc.filter([s * fsvc.rows_per_shard for s in range(N_SERVERS)], 0.0, placement="pushdown")
    fcl.set_reliability(rel)
    fcl.fabric.set_loss(0.05, seed=LOSS_SEED)
    los = fsvc.windows(64, seed=1)
    thresh = fsvc.thresh_for_selectivity(0.25)
    rep = fsvc.filter(los, thresh, placement="pushdown")
    out["filter"] = (np.concatenate(rep.results),
                     np.concatenate(fsvc.oracle_filter(los, thresh)))


def _sequence(pkg: str) -> dict:
    """Each step's ``(got, want)`` by name, in chip_smoke's order; the
    captured run's ``(type, message)`` under ``raised`` where it raises."""
    core, analysis, kw = PACKAGES[pkg]
    out = {}
    cl = core.Cluster(n_servers=N_SERVERS, wire="thor_xeon", **kw)
    app = core.PointerChaseApp(cl, n_entries=N_ENTRIES, max_slots=CHASES, seed=0)
    starts = np.random.default_rng(1).integers(0, N_ENTRIES, CHASES).astype(np.int32)
    oracle = np.array([core.chase_ref(app.table, s, DEPTH) for s in starts], np.int32)
    run = lambda s, **kw: app.dapc(s, DEPTH, **kw).results  # noqa: E731
    out["bitcode_per_message"] = (run(starts, mode="bitcode"), oracle)
    out["bitcode_batched"] = (run(starts, mode="bitcode", batching=True), oracle)
    out["bitcode_zerocopy"] = (run(starts, mode="bitcode", batching=True,
                                   dataplane=core.DataPlaneConfig.zero_copy(eager_max=0)), oracle)
    out["binary_batched"] = (run(starts, mode="binary", batching=True), oracle)
    out["am"] = (run(starts, mode="am"), oracle)
    out["gbpc"] = (app.gbpc(starts, DEPTH).results, oracle)
    rel = core.ReliabilityConfig.on(**{k: v for k, v in REL["reliability"].items()
                                       if k != "enabled"})
    cl.set_reliability(rel)
    for rate in REL["loss_rates"]:
        for name, batching in (("per_message", False), ("batched", True)):
            cl.fabric.set_loss(rate, seed=LOSS_SEED)
            lost = cl.fabric.stats.frames_lost
            out[f"{rate} {name}"] = (run(starts[:LOSSY_CHASES], batching=batching),
                                     oracle[:LOSSY_CHASES])
            out[f"{rate} {name} frames lost"] = cl.fabric.stats.frames_lost - lost
    cl.fabric.set_loss(0.0)
    cl.set_reliability(None)
    if pkg == "port":
        _lossy_gather_and_filter(out, tcore.ReliabilityConfig.on(
            **{k: v for k, v in REL["reliability"].items() if k != "enabled"}))
    try:
        with analysis.capture(cl, meta={"workload": "dapc", "chases": CHASES, "depth": DEPTH}):
            out["captured"] = (run(starts), oracle)
    except Exception as e:  # noqa: BLE001 - the fault is the finding
        out["raised"] = (type(e).__name__, str(e))
    return out


@pytest.fixture(scope="module")
def sequences():
    return {pkg: _sequence(pkg) for pkg in PACKAGES}


STEPS = [*ARMS, *LOSSY, *(f"gather {p}" for p in PLANES), "filter"]


@pytest.mark.parametrize("step", STEPS)
def test_each_run_before_the_capture_equals_its_oracle(sequences, step):
    got, want = sequences["port"][step]
    assert np.array_equal(np.asarray(got).view(np.int32), np.asarray(want).view(np.int32)), step
    if step in sequences["jax"]:
        got, want = sequences["jax"][step]
        assert np.array_equal(np.asarray(got), np.asarray(want)), ("jax", step)


def test_the_lossy_runs_lost_the_same_frames_in_both_packages(sequences):
    lost = {pkg: [seq[f"{s} frames lost"] for s in LOSSY] for pkg, seq in sequences.items()}
    assert sum(lost["port"]) > 0 and lost["port"] == lost["jax"], lost


def test_the_whole_run_after_partial_lossy_runs_is_the_reference_fault(sequences):
    """T18: both packages raise the same stale-sender-cache error on the same
    server where the captured run sends its first code-less frame."""
    port, jax = sequences["port"].get("raised"), sequences["jax"].get("raised")
    assert jax is not None and jax[0] == "ProtocolError" and "stale sender cache" in jax[1], jax
    assert port == jax
