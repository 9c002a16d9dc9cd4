"""The Filter slice: the port's predicate pushdown against the JAX package.

The Filter and FilterReturn slices run on the same payloads and shards in
both packages and must emit the same i32 words; the service runs the same
windows over the same table (state carried across with
``Cluster.load_reference_state``) in every batching x data-plane arm, its
windows bit-identical to ``oracle_filter`` and its wire/dispatch counters
equal to the JAX run's, code bytes excepted.  The port's servers take the
``cuda-sm90`` slice, so the ``embed_lookup`` custom op runs here through its
plain CPU version.  Tolerance: exact everywhere.

One difference is pinned, not hidden: XLA:CPU (like the TPU) compares f32
with subnormals flushed to zero, so the JAX Filter disagrees with its own
numpy oracle where a subnormal meets a zero or another subnormal.  The port
holds the oracle there (IEEE ``>``); everywhere else it equals the JAX slice
bit for bit, NaN included."""

import numpy as np
import pytest
import torch

from repro.core import Cluster as JaxCluster
from repro.core import DataPlaneConfig as JaxDataPlaneConfig
from repro.core.bitcode import deserialize_and_jit as jax_deserialize
from repro.core.xrdma import _filter_slab as jax_filter_slab
from repro.core.xrdma import make_filter as jax_make_filter
from repro.core.xrdma import make_filter_return as jax_make_filter_return
from repro.runtime.embed_service import FilterShardService as JaxFilterService
from repro_torch.core import Cluster, DataPlaneConfig, make_filter, make_filter_return
from repro_torch.core.bitcode import deserialize_and_jit
from repro_torch.core.pe import ExecLayer
from repro_torch.core.xrdma import FILTER_HDR, _filter_slab
from repro_torch.runtime import FilterShardService

I32, F32 = np.int32, np.float32
S, ROWS_PER, W, D = 3, 32, 8, 4  # slice shapes: 3 shards of 32 rows, window 8
INF, NAN = np.float32(np.inf), np.float32(np.nan)
TINY = np.float32(1e-40)  # subnormal
COUNTERS = (
    "puts", "gets", "get_bytes", "invokes", "coalesced_frames",
    "coalesced_payloads", "region_puts", "region_put_bytes", "hop_frames", "rounds",
)


def _bits(x) -> int:
    return int(np.array([x], F32).view(I32)[0])


def _shard(seed, special=True):
    """A (ROWS_PER, D) f32 shard; column 0 holds ties with the thresholds,
    signed zeros, infinities and a NaN when ``special``."""
    rng = np.random.default_rng(seed)
    shard = rng.standard_normal((ROWS_PER, D)).astype(F32)
    if special:
        shard[:12, 0] = [0.0, -0.0, INF, -INF, NAN, 1.0, -0.5, 1.0, -0.0, 3e38, -3e38, 0.0]
    return shard


def _slices(triple):
    """(JAX entry, port entry) of the Filter at one triple.  The cuda slice's
    counterpart is the JAX ``cpu-bf2`` slice: its TPU slice (the Pallas
    lookup, not runnable here) and the masked take both read zeros off the
    shard, where the default body clamps a slice into it."""
    j_triple = "cpu-host" if triple == "cpu-host" else "cpu-bf2"
    j_fat = jax_make_filter(ROWS_PER, S, W, D, targets=("cpu-host", "cpu-bf2")).fat
    j_fn, _ = jax_deserialize(j_fat.slices[j_triple])
    t_fn, _ = deserialize_and_jit(make_filter(ROWS_PER, S, W, D).fat.slices[triple], "cpu")
    return j_fn, t_fn


@pytest.fixture(scope="module", params=["cpu-host", "cpu-bf2", "cuda-sm90"])
def slices(request):
    return request.param, *_slices(request.param)


def _payload(lo, thresh, requester=S, slot=5, epoch=2):
    return np.array([requester, slot, epoch, lo, _bits(thresh)], I32)


def _port(t_fn, pay, shard, meta):
    return t_fn(torch.from_numpy(pay), torch.from_numpy(shard), torch.from_numpy(meta)).numpy()


META = np.array([1, ROWS_PER, S], I32)
LO = ROWS_PER  # shard 1's first row
THRESHOLDS = [0.0, -0.0, -0.5, 1.0, 2.5, -2.5, -1e30, 3e38, INF, -INF, NAN]


@pytest.mark.parametrize("thresh", THRESHOLDS, ids=lambda t: repr(float(t)))
def test_filter_slice_matches_jax(slices, thresh):
    """Every window start of the shard, ties, signed zeros, infinities and a
    NaN in column 0: the same action row as the JAX slice, word for word."""
    triple, j_fn, t_fn = slices
    shard = _shard(1)
    for off in range(0, ROWS_PER - W + 1, 3):
        pay = _payload(LO + off, np.float32(thresh))
        want = np.asarray(j_fn(pay, shard, META))
        got = _port(t_fn, pay, shard, META)
        np.testing.assert_array_equal(got, want, err_msg=f"{triple} off={off}")


@pytest.mark.parametrize("thresh", [TINY, -TINY, np.float32(1e-45), np.float32(-1e-45)],
                         ids=["1e-40", "-1e-40", "1e-45", "-1e-45"])
def test_filter_slice_subnormal_threshold_matches_jax(slices, thresh):
    """Subnormal thresholds against column values that are neither zero nor
    subnormal: flushed or not, the predicate is the same, so the slices
    agree bit for bit."""
    triple, j_fn, t_fn = slices
    shard = _shard(2, special=False)
    for off in (0, 7, ROWS_PER - W):
        pay = _payload(LO + off, thresh)
        np.testing.assert_array_equal(
            _port(t_fn, pay, shard, META), np.asarray(j_fn(pay, shard, META))
        )


def test_filter_keeps_ieee_order_where_the_reference_flushes_subnormals():
    """Column values at ±0 and ±1e-40 against thresholds at 0, -0, ±1e-40
    and 1e-45: the port's survivors are numpy's ``col > thresh``; the JAX
    slice's are that predicate with every subnormal read as zero (XLA:CPU's
    flush), which differs from the oracle in some of these cells."""
    _, j_fn, t_fn = ("cpu-host", *_slices("cpu-host"))
    shard = _shard(3, special=False)
    shard[:W, 0] = [TINY, -TINY, 0.0, -0.0, np.float32(5e-41), 2 * TINY, -2 * TINY, 1.0]
    col = shard[:W, 0]
    flushed = np.where(np.abs(col) < np.finfo(F32).tiny, 0.0, col).astype(F32)
    differ = 0
    for thresh in (np.float32(0.0), np.float32(-0.0), TINY, -TINY, np.float32(1e-45)):
        pay = _payload(LO, thresh)
        got, want = _port(t_fn, pay, shard, META), np.asarray(j_fn(pay, shard, META))
        survivors = lambda row: row[6 : 6 + W][row[6 : 6 + W] >= 0]
        np.testing.assert_array_equal(survivors(got), np.flatnonzero(col > thresh))
        t_flushed = thresh if abs(thresh) >= np.finfo(F32).tiny else np.float32(0.0)
        np.testing.assert_array_equal(survivors(want), np.flatnonzero(flushed > t_flushed))
        differ += not np.array_equal(got, want)
    assert differ > 0, "the pinned difference of the reference no longer shows"


@pytest.mark.parametrize("thresh,n_surv", [(INF, 0), (-INF, W), (np.float32(0.0), None)],
                         ids=["none", "all", "some"])
def test_filter_slice_ragged_plen(slices, thresh, n_surv):
    """``plen = 3 + W + nsurv*D``: a window in which nothing survives carries
    only its header and positions; one in which everything survives, every
    row."""
    triple, j_fn, t_fn = slices
    shard = _shard(4, special=False)
    row = _port(t_fn, _payload(LO + 5, thresh), shard, META)
    nsurv = int((row[6 : 6 + W] >= 0).sum())
    if n_surv is not None:
        assert nsurv == n_surv
    else:
        assert 0 < nsurv < W
    assert row[2] == 3 + W + nsurv * D
    assert row.shape == (3 + 3 + W + W * D,)


def test_misaligned_window_matches_each_jax_slice():
    """A window that runs past the shard's end: the default slice clamps its
    start into the shard (the reference's dynamic_slice), the masked-take
    slices read zeros past the end (cpu-bf2, and the kernel's cuda-sm90) —
    each equal to its JAX counterpart."""
    shard = _shard(5, special=False)
    pay = _payload(LO + ROWS_PER - 3, np.float32(-10.0))
    for triple in ("cpu-host", "cpu-bf2", "cuda-sm90"):
        j_fn, t_fn = _slices(triple)
        np.testing.assert_array_equal(
            _port(t_fn, pay, shard, META), np.asarray(j_fn(pay, shard, META)), err_msg=triple
        )


def test_cuda_slice_under_vmap_matches_per_payload_calls():
    """The batched rendering of the cuda-sm90 slice (``torch.vmap``, the
    embed_lookup op's vmap rule) equals one call per payload."""
    _, t_fn = _slices("cuda-sm90")
    shard = torch.from_numpy(_shard(6))
    meta = torch.from_numpy(META)
    rng = np.random.default_rng(6)
    pays = torch.from_numpy(np.stack([
        _payload(LO + int(o), np.float32(t))
        for o, t in zip(rng.integers(0, ROWS_PER - W + 1, 12), rng.standard_normal(12))
    ]))
    got = torch.vmap(t_fn, in_dims=(0, None, None))(pays, shard, meta)
    want = torch.stack([t_fn(p, shard, meta) for p in pays])
    assert torch.equal(got, want)


def test_filter_return_slice_matches_jax():
    """Ragged RETURN payloads (zero-extended as the exec layer pads them)
    folded into a CQ region, a stale epoch among them: the same region."""
    slots = 4
    j_fn, _ = jax_deserialize(
        jax_make_filter_return(slots, W, D, targets=("cpu-host",)).fat.slices["cpu-host"]
    )
    t_exe = make_filter_return(slots, W, D)
    t_fn, _ = deserialize_and_jit(t_exe.fat.slices["cpu-host"], "cpu")
    rng = np.random.default_rng(8)
    region = np.zeros((slots, 2 + W * D), I32)
    region[:, 1] = [1, 2, 1, 3]
    for slot, epoch, nsurv in [(1, 2, 3), (0, 1, 0), (2, 1, W), (3, 9, 2), (1, 2, 1)]:
        spos = np.full(W, -1, I32)
        spos[:nsurv] = np.sort(rng.choice(W, nsurv, replace=False))
        rows = rng.integers(-(2**31), 2**31 - 1, nsurv * D).astype(I32)
        ragged = np.concatenate([[slot, epoch, (1 << W) - 1], spos, rows]).astype(I32)
        pay = np.frombuffer(
            ExecLayer._pad_ragged(t_exe.payload_aval, ragged.tobytes()), I32
        ).copy()
        want = np.asarray(j_fn(pay, region))
        got = t_fn(torch.from_numpy(pay), torch.from_numpy(region)).numpy()
        np.testing.assert_array_equal(got, want)
        region = want.copy()


@pytest.mark.parametrize("nsurv", [0, 1, 3, W])
def test_filter_slab_matches_jax(nsurv):
    """The zero-copy plan of a ragged RETURN: the same WRITE segments (one
    per run of window positions), the doorbell on the last, doorbell-only
    when nothing survived."""
    rng = np.random.default_rng(nsurv)
    spos = np.full(W, -1, I32)
    spos[:nsurv] = np.sort(rng.choice(W, nsurv, replace=False))
    rows = rng.integers(-(2**31), 2**31 - 1, nsurv * D).astype(I32)
    pay = np.concatenate([[2, 7, (1 << W) - 1], spos, rows]).astype(I32)
    fields = lambda w: (w.region, w.offset, bytes(w.data), w.doorbell, w.guard)
    got = [fields(w) for w in _filter_slab(W, D).plan(pay)]
    want = [fields(w) for w in jax_filter_slab(W, D).plan(pay)]
    assert got == want and got
    assert got[-1][3] == (2 * (2 + W * D) * 4, (1 << W) - 1, "or")


def test_filter_payload_layout():
    assert FILTER_HDR == 5
    with pytest.raises(ValueError, match="window > 31"):
        make_filter(64, 2, 32, 4)
    with pytest.raises(ValueError, match="window > 31"):
        make_filter_return(4, 32, 4)


# ------------------------------------------------------------- the service
N_SERVERS, VOCAB, DIM, WINDOW, MAX_SLOTS = 4, 1024, 8, 12, 16


def _state(cluster) -> dict:
    return {
        pe.name: {
            "regions": {n: pe.region(n) for n in pe.endpoint.regions},
            "caps": dict(pe.caps),
        }
        for pe in cluster.pes()
    }


@pytest.fixture(scope="module")
def services():
    table = np.random.default_rng(0).standard_normal((VOCAB, DIM)).astype(F32)
    table[5, 0] = -0.0
    ref = JaxFilterService(
        JaxCluster(N_SERVERS, wire="thor_xeon"), VOCAB, DIM,
        window=WINDOW, max_slots=MAX_SLOTS, table=table,
    )
    cl = Cluster(N_SERVERS, wire="thor_xeon", server_triple="cuda-sm90", device="cpu")
    port = FilterShardService(cl, VOCAB, DIM, window=WINDOW, max_slots=MAX_SLOTS, table=table)
    cl.load_reference_state(_state(ref.cluster))
    los = ref.windows(24, seed=1)
    los[0] = 0  # the window holding the -0.0 row
    return ref, port, los


def _same_rows(rep, oracle):
    assert len(rep.results) == len(oracle)
    for got, want in zip(rep.results, oracle):
        np.testing.assert_array_equal(got.view(I32), want.view(I32))


def _same_counters(a, b):
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), name
    for kind in ("header", "payload", "region"):
        assert a.wire_bytes_by_kind.get(kind, 0) == b.wire_bytes_by_kind.get(kind, 0), kind


ARMS = {
    "framed": None,
    "zerocopy": dict(eager_max=0),  # every RETURN a slab write, doorbell-only when empty
    "zerocopy_eager": dict(),  # DataPlaneConfig.zero_copy()'s default threshold
}
THRESH = {"none": INF, "all": -INF, "sel05": None, "sel50": None}


@pytest.mark.parametrize("cut", list(THRESH))
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
def test_filter_service_matches_reference(services, batching, arm, cut):
    ref, port, los = services
    thresh = THRESH[cut]
    if thresh is None:
        thresh = ref.thresh_for_selectivity(0.05 if cut == "sel05" else 0.5)
    cfg = ARMS[arm]
    got = port.filter(
        los, thresh, batching=batching, placement="pushdown",
        dataplane=None if cfg is None else DataPlaneConfig.zero_copy(**cfg),
    )
    want = ref.filter(
        los, thresh, batching=batching, placement="pushdown",
        dataplane=None if cfg is None else JaxDataPlaneConfig.zero_copy(**cfg),
    )
    oracle = ref.oracle_filter(los, thresh)
    _same_rows(got, oracle)
    _same_rows(want, oracle)
    _same_counters(got, want)
    if cfg is not None and cfg.get("eager_max") == 0:
        # every RETURN a slab write: per message one chain a window (the
        # request frames the only PUTs); batched, a chain a destination a tick
        if batching:
            assert got.region_puts > 0
        else:
            assert got.puts == got.region_puts == len(los)
    assert got.invokes > 0


def test_filter_pull_matches_reference(services):
    ref, port, los = services
    thresh = ref.thresh_for_selectivity(0.25)
    got, want = port.filter_pull(los, thresh), ref.filter_pull(los, thresh)
    _same_rows(got, ref.oracle_filter(los, thresh))
    _same_counters(got, want)
    assert got.gets == len(los) and got.puts == 0


@pytest.mark.parametrize("arm", ["pushdown", "pull", "auto"])
def test_filter_arms_match_oracle(services, arm):
    """All three placements through ``filter``: rows equal ``oracle_filter``;
    ``auto`` takes whichever side the cost model picks."""
    _, port, los = services
    for sel in (0.05, 0.75):
        thresh = port.thresh_for_selectivity(sel)
        rep = port.filter(los, thresh, placement=arm)
        _same_rows(rep, port.oracle_filter(los, thresh))
        assert (rep.gets > 0) == (arm == "pull" or (arm == "auto" and rep.puts == 0))


def test_filter_rejects_misaligned_windows(services):
    _, port, _ = services
    boundary = port.rows_per_shard - port.n_keys // 2
    with pytest.raises(ValueError, match="crosses a shard boundary"):
        port.filter([boundary], 0.0)
    with pytest.raises(ValueError, match="outside the table"):
        port.filter([port.vocab - 1], 0.0)
    with pytest.raises(ValueError, match="crosses a shard boundary"):
        port.filter_pull([boundary], 0.0)


def test_servers_run_the_kernel_slice(services):
    _, port, los = services
    port.filter(los[:4], 0.0)
    for pe in port.cluster.servers:
        exe = pe.target_cache.lookup("filter")
        if exe is None:
            continue
        ops = {str(n.target) for n in exe.extras["exported"].graph.nodes}
        assert "repro_torch.embed_lookup.default" in ops
        assert exe.extras["triple"] == "cuda-sm90"
