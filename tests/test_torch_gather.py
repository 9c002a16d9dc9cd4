"""The Gather slice end to end: the port's service against the JAX one.

Both packages serve the same ragged request stream from the same table
(state carried across with ``Cluster.load_reference_state``) in every
batching x data-plane arm and through ``gather_get``.  Rows must equal the
numpy oracle bit for bit in both, and the wire/dispatch counters must be
equal — all but the code bytes, since a ``torch.export`` slice is larger
than a StableHLO one.  The port's servers take the ``cuda-sm90`` slice, so
the kernel's custom op runs here through its plain CPU version."""

import io
import zipfile

import numpy as np
import pytest
import torch

from repro.core import Cluster as JaxCluster
from repro.core import DataPlaneConfig as JaxDataPlaneConfig
from repro.core import make_gather_return as jax_make_gather_return
from repro.core import make_gatherer as jax_make_gatherer
from repro.core.bitcode import deserialize_and_jit as jax_deserialize
from repro.runtime.embed_service import EmbedShardService as JaxService
from repro.runtime.embed_service import ragged_batches
from repro_torch.core import Cluster, DataPlaneConfig, make_gather_return, make_gatherer
from repro_torch.core.bitcode import deserialize_and_jit, load_program
from repro_torch.runtime import EmbedShardService

N_SERVERS, VOCAB, DIM, N_KEYS, MAX_SLOTS = 4, 1024, 8, 8, 16
ARMS = {
    "framed": None,
    "zerocopy": dict(zerocopy=True),
    "rendezvous": dict(eager_max=0, rndv_min=0),
}
COUNTERS = (
    "puts", "gets", "get_bytes", "invokes", "coalesced_frames",
    "coalesced_payloads", "region_puts", "region_put_bytes", "hop_frames", "rounds",
)


def _state(cluster) -> dict:
    """A JAX cluster's PE state through its public accessors."""
    return {
        pe.name: {
            "regions": {n: pe.region(n) for n in pe.endpoint.regions},
            "caps": dict(pe.caps),
        }
        for pe in cluster.pes()
    }


@pytest.fixture(scope="module")
def services():
    table = np.random.default_rng(0).standard_normal((VOCAB, DIM)).astype(np.float32)
    table[5, 0] = -0.0  # bit-cast RETURN rows must keep it
    ref = JaxService(
        JaxCluster(N_SERVERS, wire="thor_xeon"), VOCAB, DIM,
        n_keys=N_KEYS, max_slots=MAX_SLOTS, table=table,
    )
    cl = Cluster(N_SERVERS, wire="thor_xeon", server_triple="cuda-sm90", device="cpu")
    port = EmbedShardService(cl, VOCAB, DIM, n_keys=N_KEYS, max_slots=MAX_SLOTS, table=table)
    cl.load_reference_state(_state(ref.cluster))
    reqs = ragged_batches(VOCAB, 48, N_KEYS, seed=1)
    reqs[0] = np.array([5, 5, 1023, 0], np.int32)
    return ref, port, reqs


def _same_rows(rep, oracle):
    assert len(rep.results) == len(oracle)
    for got, want in zip(rep.results, oracle):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _same_counters(a, b):
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), name
    for kind in ("header", "payload", "region"):
        assert a.wire_bytes_by_kind.get(kind, 0) == b.wire_bytes_by_kind.get(kind, 0), kind


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
def test_gather_matches_reference(services, batching, arm):
    ref, port, reqs = services
    cfg = ARMS[arm]
    got = port.gather(reqs, batching=batching, dataplane=cfg and DataPlaneConfig(**cfg))
    want = ref.gather(reqs, batching=batching, dataplane=cfg and JaxDataPlaneConfig(**cfg))
    oracle = ref.oracle(reqs)
    _same_rows(got, oracle)
    _same_rows(want, oracle)
    _same_counters(got, want)
    assert got.invokes > 0


def test_gather_get_matches_reference(services):
    ref, port, reqs = services
    got, want = port.gather_get(reqs), ref.gather_get(reqs)
    _same_rows(got, ref.oracle(reqs))
    _same_counters(got, want)
    assert got.gets == sum(len(r) for r in reqs)


def test_servers_run_the_kernel_slice(services):
    _, port, _ = services
    port.gather([np.array([1, 700], np.int32)])
    for pe in port.cluster.servers:
        exe = pe.target_cache.lookup("gatherer")
        assert exe is not None and exe.fn is not None
        ops = {str(n.target) for n in exe.extras["exported"].graph.nodes}
        assert "repro_torch.embed_lookup.default" in ops


def test_load_reference_state_copies_regions(services):
    ref, port, _ = services
    for pe_ref, pe in zip(ref.cluster.servers, port.cluster.servers):
        np.testing.assert_array_equal(pe.region("embed_shard"), pe_ref.region("embed_shard"))
        np.testing.assert_array_equal(pe.caps["gather_meta"], pe_ref.caps["gather_meta"])
        assert not np.shares_memory(pe.region("embed_shard"), pe_ref.region("embed_shard"))


def _payloads(rng, n_servers, rows_per, n_keys):
    keys = rng.integers(-1, n_servers * rows_per, (6, n_keys)).astype(np.int32)
    hdr = np.array([n_servers, 3, 2], np.int32)
    return [np.concatenate([hdr, k]) for k in keys]


@pytest.mark.parametrize("triple", ["cpu-host", "cuda-sm90"])
def test_gatherer_slice_matches_jax_entry(triple):
    """One hop of the shipped code: the port's slice and the JAX slice
    emit the same action matrix, payload rows bit-cast alike."""
    S, rows_per, K, D = 3, 8, 5, 4
    rng = np.random.default_rng(4)
    shard = rng.standard_normal((rows_per, D)).astype(np.float32)
    meta = np.array([1, rows_per, S], np.int32)
    j_fn, _ = jax_deserialize(
        jax_make_gatherer(rows_per, S, K, D, targets=("cpu-host",)).fat.slices["cpu-host"]
    )
    t_fn, _ = deserialize_and_jit(make_gatherer(rows_per, S, K, D).fat.slices[triple], "cpu")
    for pay in _payloads(rng, S, rows_per, K):
        want = np.asarray(j_fn(pay, shard, meta))
        got = t_fn(torch.from_numpy(pay), torch.from_numpy(shard), torch.from_numpy(meta))
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_return_slice_matches_jax_entry():
    slots, K, D = 4, 3, 2
    rng = np.random.default_rng(8)
    j_fn, _ = jax_deserialize(
        jax_make_gather_return(slots, K, D, targets=("cpu-host",)).fat.slices["cpu-host"]
    )
    t_fn, _ = deserialize_and_jit(make_gather_return(slots, K, D).fat.slices["cpu-host"], "cpu")
    region = np.zeros((slots, 2 + K * D), np.int32)
    region[:, 1] = [1, 2, 1, 3]
    for slot, epoch in [(1, 2), (0, 1), (1, 2), (3, 9)]:  # last one is stale
        pos = np.where(rng.random(K) < 0.6, np.arange(K), -1).astype(np.int32)
        rows = rng.integers(-(2 ** 31), 2 ** 31 - 1, K * D).astype(np.int32)
        pay = np.concatenate([[slot, epoch, (pos >= 0).sum()], pos, rows]).astype(np.int32)
        want = np.asarray(j_fn(pay, region))
        got = t_fn(torch.from_numpy(pay), torch.from_numpy(region)).numpy()
        np.testing.assert_array_equal(got, want)
        region = want.copy()  # a writable copy for the next fold


def test_slices_are_device_neutral_and_small():
    """A slice carries the graph only: no example tensors (the archive does
    not grow with the shard), no host sync (``item``) and no device baked
    into its ops, so it runs unchanged once moved onto the card."""
    small = make_gatherer(16, 2, 4, 8)
    big = make_gatherer(1 << 16, 2, 4, 8)  # a 2 MiB shard
    # only the shapes' digits differ, padded to the archive's 64-byte records
    assert 0 <= big.fat.nbytes - small.fat.nbytes <= 64 * len(big.fat.slices)
    for ifn in (big, make_gather_return(8, 4, 8)):
        for triple, blob in ifn.fat.slices.items():
            with zipfile.ZipFile(io.BytesIO(blob)) as z:
                data = {i.filename: i.file_size for i in z.infolist() if "/data/" in i.filename}
            assert data and max(data.values()) <= 64, (triple, data)
            for node in load_program(blob, "cpu").graph.nodes:
                assert "item" not in str(node.target), (triple, node)
                assert "device" not in node.kwargs, (triple, node)
