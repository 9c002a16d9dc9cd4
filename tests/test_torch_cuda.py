"""The hand-written kernels on the card, against their plain versions, the
batched Chaser and Filter slices' one launch per group, the Filter
service's one launch per dispatch, and the LMs' one launch per layer of
each path kernel (flash attention, wkv6, ssm_scan).

Marked ``cuda``: skipped on a host without a Hopper card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of JAX, so it runs where only the port is
installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import Cluster, make_chain, make_chaser, make_filter
from repro_torch.core.bitcode import deserialize_and_jit
from repro_torch.kernels import build
from repro_torch.kernels.chase import chase_shard, chase_shard_op, chase_shard_ref
from repro_torch.kernels.chase import kernel as chase_kernel
from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_op, embed_lookup_ref
from repro_torch.kernels.embed_lookup import kernel as embed_kernel
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, flash_route
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref, ssm_scan_route
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref, wkv6_route

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (sm_90)")
    return torch.device("cuda", 0)


def _inputs(card, n, v_loc, d, dtype, seed):
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.standard_normal((v_loc, d), dtype=np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(-1, 3 * v_loc, n).astype(np.int32))
    lo = torch.tensor(v_loc, dtype=torch.int32)
    return tab.to(card), ids.to(card), lo.to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,v_loc,d", [(1024, 4096, 128), (1000, 517, 9), (3, 5, 1)])
def test_kernel_matches_plain(card, n, v_loc, d, dtype):
    tab, ids, lo = _inputs(card, n, v_loc, d, dtype, n + d)
    before = embed_lookup.launches
    got = embed_lookup(tab, ids, lo)
    torch.cuda.synchronize()
    assert embed_lookup.launches == before + 1
    assert torch.equal(got.cpu(), embed_lookup_ref(tab.cpu(), ids.cpu(), lo.cpu()))


def test_vmap_rule_is_one_launch(card):
    tab, ids, lo = _inputs(card, 64, 256, 16, torch.float32, 3)
    batch = ids.reshape(8, 8)
    before = embed_lookup.launches
    got = torch.vmap(embed_lookup_op, in_dims=(None, 0, None))(tab, batch, lo)
    torch.cuda.synchronize()
    assert embed_lookup.launches == before + 1
    assert torch.equal(got.reshape(64, 16), embed_lookup_ref(tab, ids, lo))


def _chase_inputs(card, b, n_loc, kind, seed):
    """A shard of an 8-way chain (most chases leave after about a hop) or a
    cycle local to the shard (every chase runs its full depth), with
    frontiers below, inside and above the shard and some depth-0 chases."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        lo = 3 * n_loc
        table = make_chain(8 * n_loc, seed=seed)[lo : lo + n_loc]
        frontier = rng.integers(0, 8 * n_loc, b)
        frontier[: b // 2] = rng.integers(lo, lo + n_loc, b // 2)
        depth = rng.integers(0, 65, b)
    else:
        lo = 0
        table = make_chain(n_loc, seed=seed)
        frontier = rng.integers(0, 2 * n_loc, b)
        depth = rng.integers(0, 1025, b)
    if b >= 8:  # the shard's edges; a lone chase stays a real chase
        frontier[:3], depth[:3] = [lo - 1, lo + n_loc, lo], [5, 5, 0]
    else:
        frontier[:], depth[:] = lo + 1, 64
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(card)
    return as_t(table), as_t(frontier), as_t(depth), as_t([lo])


@pytest.mark.parametrize("kind", ["chain", "cycle"])
@pytest.mark.parametrize("b", [1, 8, 256, 65_536])
def test_chase_kernel_matches_plain(card, b, kind):
    table, frontier, depth, lo = _chase_inputs(card, b, 1 << 16, kind, b)
    before = chase_shard.launches
    f, d = chase_shard(table, frontier, depth, lo)
    torch.cuda.synchronize()
    assert chase_shard.launches == before + 1
    f_want, d_want = chase_shard_ref(table, frontier, depth, lo)
    assert torch.equal(f, f_want) and torch.equal(d, d_want)


def test_chase_vmap_rule_is_one_launch(card):
    table, frontier, depth, lo = _chase_inputs(card, 64, 4096, "chain", 5)
    before = chase_shard.launches
    f, d = torch.vmap(chase_shard_op, in_dims=(None, 0, 0, None))(
        table, frontier.reshape(64, 1), depth.reshape(64, 1), lo
    )
    torch.cuda.synchronize()
    assert chase_shard.launches == before + 1
    f_want, d_want = chase_shard_ref(table, frontier, depth, lo)
    assert torch.equal(f.reshape(-1), f_want) and torch.equal(d.reshape(-1), d_want)


def test_batched_chaser_slice_is_one_launch(card):
    """The Chaser's reloaded cuda-sm90 slice under torch.vmap, as the
    batched runtime dispatches it: one launch for the group, the same
    action rows as one call per payload."""
    shard_size, n_servers = 4096, 8
    table = make_chain(shard_size * n_servers, seed=1)
    shard = torch.from_numpy(table[shard_size : 2 * shard_size]).to(card)
    meta = torch.tensor([1, shard_size, n_servers], dtype=torch.int32, device=card)
    rng = np.random.default_rng(2)
    pays = np.stack([
        rng.integers(shard_size, 2 * shard_size, 16), rng.integers(0, 64, 16),
        np.full(16, n_servers), np.arange(16),
    ], axis=1).astype(np.int32)
    pays = torch.from_numpy(pays).to(card)
    fn, _ = deserialize_and_jit(make_chaser(shard_size).fat.slices["cuda-sm90"], card)
    before = chase_shard.launches
    got = torch.vmap(fn, in_dims=(0, None, None))(pays, shard, meta)
    torch.cuda.synchronize()
    assert chase_shard.launches == before + 1
    want = torch.stack([fn(p, shard, meta) for p in pays])
    assert torch.equal(got, want)


def test_filter_slice_is_one_launch_per_dispatch(card):
    """The Filter's reloaded cuda-sm90 slice resolves its window through
    embed_lookup: one launch a call, one for a vmapped group, the same
    action rows as the slice's plain version on the host."""
    rows_per, n_servers, window, dim = 4096, 8, 24, 128
    rng = np.random.default_rng(3)
    shard = rng.standard_normal((rows_per, dim), dtype=np.float32)
    meta = np.array([2, rows_per, n_servers], np.int32)
    lo = 2 * rows_per + rng.integers(0, rows_per - window + 1, 16)
    thresh = rng.standard_normal(16).astype(np.float32).view(np.int32)
    pays = np.stack([np.full(16, n_servers), np.arange(16), np.ones(16), lo, thresh],
                    axis=1).astype(np.int32)
    blob = make_filter(rows_per, n_servers, window, dim).fat.slices["cuda-sm90"]
    fn, _ = deserialize_and_jit(blob, card)
    host_fn, _ = deserialize_and_jit(blob, "cpu")
    d_shard, d_meta = torch.from_numpy(shard).to(card), torch.from_numpy(meta).to(card)
    d_pays = torch.from_numpy(pays).to(card)
    before = embed_lookup.launches
    one = [fn(p, d_shard, d_meta) for p in d_pays]
    torch.cuda.synchronize()
    assert embed_lookup.launches == before + 16
    got = torch.vmap(fn, in_dims=(0, None, None))(d_pays, d_shard, d_meta)
    torch.cuda.synchronize()
    assert embed_lookup.launches == before + 17
    assert torch.equal(got, torch.stack(one))
    want = torch.stack([host_fn(torch.from_numpy(p), torch.from_numpy(shard),
                                torch.from_numpy(meta)) for p in pays])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("batching", [False, True], ids=["permsg", "batched"])
def test_filter_service_launches_once_per_dispatch(card, batching):
    from repro_torch.runtime import FilterShardService

    cl = Cluster(4, wire="thor_xeon", device=card)
    svc = FilterShardService(cl, vocab=4 * 1024, dim=16, window=24, max_slots=16)
    los = svc.windows(40, seed=2)
    thresh = svc.thresh_for_selectivity(0.25)
    invokes0 = sum(pe.stats.invokes for pe in cl.servers)
    before = embed_lookup.launches
    rep = svc.filter(los, thresh, batching=batching, placement="pushdown")
    torch.cuda.synchronize()
    dispatches = sum(pe.stats.invokes for pe in cl.servers) - invokes0
    assert embed_lookup.launches - before == dispatches > 0
    for got, want in zip(rep.results, svc.oracle_filter(los, thresh)):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


EMBED_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}


def _edge_embed_inputs(card, n, dtype, seed, v_loc=4096, d=128):
    """Ids in and around the shard, with -1, lo - 1, lo + V_loc and lo."""
    rng = np.random.default_rng(seed)
    f32 = torch.from_numpy(rng.standard_normal((v_loc, d), dtype=np.float32))
    tab = f32.view(torch.int32) if dtype == torch.int32 else f32.to(dtype)
    lo = 2 * v_loc
    ids = rng.integers(-1, 4 * v_loc, n)
    ids[:4] = [-1, lo - 1, lo + v_loc, lo][:n]
    ids = torch.from_numpy(ids.astype(np.int32))
    return tab.to(card), ids.to(card), torch.tensor([lo], dtype=torch.int32, device=card)


@pytest.mark.parametrize("route", embed_kernel.ROUTES)
@pytest.mark.parametrize("n", [1, 16, 31, 33, 1024, 65_536])
@pytest.mark.parametrize("dtype", list(EMBED_DTYPES))
def test_embed_routes_match_plain(card, dtype, n, route):
    tab, ids, lo = _edge_embed_inputs(card, n, EMBED_DTYPES[dtype], n)
    before = dict(embed_lookup.route_launches)
    got = embed_lookup(tab, ids, lo, route=route)
    torch.cuda.synchronize()
    assert embed_lookup.route_launches[route] == before[route] + 1
    want = embed_lookup_ref(tab, ids, lo)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("route", embed_kernel.ROUTES)
@pytest.mark.parametrize("n", [8, 1024])
@pytest.mark.parametrize("d", [1600, 2048, 4096])
def test_embed_wide_rows_match_plain(card, d, n, route):
    """The remote embedding's rows: each LM's d_model in f32 (6.4-16 KB),
    on each route and on the one the wrapper picks."""
    tab, ids, lo = _edge_embed_inputs(card, n, torch.float32, d + n, v_loc=2048, d=d)
    got = embed_lookup(tab, ids, lo, route=route)
    auto = embed_lookup(tab, ids, lo)
    torch.cuda.synchronize()
    assert torch.equal(auto, got)
    assert torch.equal(got.view(torch.int32), embed_lookup_ref(tab, ids, lo).view(torch.int32))


def test_embed_narrow_rows_take_warp(card):
    """Rows of 6 bytes (bf16, D = 3) take the warp route; the bulk route
    refuses them."""
    tab, ids, lo = _edge_embed_inputs(card, 1000, torch.bfloat16, 6, d=3)
    before = embed_lookup.route_launches["warp"]
    got = embed_lookup(tab, ids, lo)
    torch.cuda.synchronize()
    assert embed_lookup.route_launches["warp"] == before + 1
    assert torch.equal(got.view(torch.int16), embed_lookup_ref(tab, ids, lo).view(torch.int16))
    with pytest.raises(ValueError, match="bulk"):
        embed_lookup(tab, ids, lo, route="bulk")


@pytest.mark.parametrize("rows_per_block, blocks, what", [
    (32, 2, "a grid that fits"), (32, 1, "too few blocks"), (32, 3, "a block with no id"),
    (33, 2, "more rows than lanes"), (4, 10, "a tile over 48 KB"),
])
def test_embed_bulk_entry_refuses_grids_it_cannot_take(card, rows_per_block, blocks, what):
    """The bulk C entry launches only a grid that gives every id one block
    and every block an id, at most 32 rows a block in at most 48 KB; it
    returns cudaErrorInvalidValue (1) for the rest and writes nothing."""
    n, d = 40, 4096 if "tile" in what else 128
    tab, ids, lo = _edge_embed_inputs(card, n, torch.float32, 11, d=d)
    out = torch.full((n, d), 7.0, device=card)
    launch = embed_kernel._launch or embed_kernel._bind()
    err = build.launch_on(card, launch, tab.data_ptr(), ids.data_ptr(), lo.data_ptr(),
                          out.data_ptr(), n, tab.shape[0], d * 4, 1, blocks, rows_per_block)
    torch.cuda.synchronize()
    if what == "a grid that fits":
        assert err == 0 and torch.equal(out, embed_lookup_ref(tab, ids, lo))
    else:
        assert err == 1, what
        assert bool((out == 7.0).all())


@pytest.mark.parametrize("route", embed_kernel.ROUTES)
def test_embed_vmap_rule_is_one_launch_on_each_route(card, route, monkeypatch):
    monkeypatch.setattr(embed_kernel, "embed_route", lambda n, row_bytes, aligned: route)
    tab, ids, lo = _edge_embed_inputs(card, 64 * 16, torch.int32, 7)
    before = dict(embed_lookup.route_launches)
    got = torch.vmap(embed_lookup_op, in_dims=(None, 0, None))(tab, ids.reshape(64, 16), lo)
    torch.cuda.synchronize()
    assert embed_lookup.route_launches[route] == before[route] + 1
    assert sum(embed_lookup.route_launches.values()) == sum(before.values()) + 1
    assert torch.equal(got.reshape(-1, 128), embed_lookup_ref(tab, ids, lo))


@pytest.mark.parametrize("route", ["thread", "spread"])
@pytest.mark.parametrize("b", [1, 8, 33, 256, 65_536])
@pytest.mark.parametrize("kind", ["chain", "cycle"])
def test_chase_routes_match_plain(card, kind, b, route):
    """Both routes, with depth 0 and a frontier far below lo among the
    chases (B >= 8)."""
    table, frontier, depth, lo = _chase_inputs(card, b, 1 << 16, kind, b + 1)
    if b >= 8:
        frontier[3], depth[3] = -(2**31), 5
    before = chase_shard.route_launches[route]
    f, d = chase_shard(table, frontier, depth, lo, route=route)
    torch.cuda.synchronize()
    assert chase_shard.route_launches[route] == before + 1
    f_want, d_want = chase_shard_ref(table, frontier, depth, lo)
    assert torch.equal(f, f_want) and torch.equal(d, d_want)


@pytest.mark.parametrize("route", ["thread", "spread"])
def test_chase_vmap_rule_is_one_launch_on_each_route(card, route, monkeypatch):
    monkeypatch.setattr(chase_kernel, "chase_route", lambda b: route)
    table, frontier, depth, lo = _chase_inputs(card, 256, 4096, "chain", 9)
    before = dict(chase_shard.route_launches)
    f, d = torch.vmap(chase_shard_op, in_dims=(None, 0, 0, None))(
        table, frontier.reshape(256, 1), depth.reshape(256, 1), lo
    )
    torch.cuda.synchronize()
    assert chase_shard.route_launches[route] == before[route] + 1
    assert sum(chase_shard.route_launches.values()) == sum(before.values()) + 1
    f_want, d_want = chase_shard_ref(table, frontier, depth, lo)
    assert torch.equal(f.reshape(-1), f_want) and torch.equal(d.reshape(-1), d_want)


@pytest.mark.parametrize("cg", [False, True])
def test_latency_probe_follows_the_cycle(card, cg):
    """The probe is a measuring tool, but its chain must be the real one:
    ``hops`` loads from ``start`` land where the plain walk lands."""
    cycle = make_chain(4096, seed=3)
    table = torch.from_numpy(cycle).to(card)
    want = 17
    for _ in range(1000):
        want = int(cycle[want])
    assert chase_kernel.latency_probe(table, 17, 0, cg).item() == 17
    assert chase_kernel.latency_probe(table, 17, 1000, cg).item() == want


# tolerances of the JAX kernel sweep: f32 to rounding, bf16 to the oracle's
# bf16 probabilities
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(card, shapes, dtype, seed):
    g = torch.Generator(card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_prefill_matches_plain(card, dtype):
    """yi's head layout (32 query heads over 4 KV heads, d 128) at a prompt
    length no tile divides."""
    q, k, v = _flash_inputs(card, [(1, 300, 32, 128), (1, 300, 4, 128), (1, 300, 4, 128)],
                            dtype, 1)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_on_a_cache_view_matches_plain(card, dtype):
    """One query per row against the valid prefix of a (B, T_max, K, d)
    cache, passed as a strided view (no copy)."""
    q, kc, vc = _flash_inputs(card, [(8, 1, 32, 128), (8, 512, 4, 128), (8, 512, 4, 128)],
                              dtype, 2)
    k, v = kc[:, :257], vc[:, :257]
    assert not k.is_contiguous()
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k.contiguous(), v.contiguous())
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_lm_launches_one_flash_kernel_per_layer(card):
    """yi smoke on the card: a prefill and each decode step launch the
    kernel once per layer, and greedy tokens are finite-logit argmaxes."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = get_config("yi-9b", smoke=True)
    model = zoo.build_params(cfg, 0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 20), device=card, dtype=torch.int32)
    cache = zoo.init_kv_cache(cfg, 2, 24, dtype=cfg.dtype, device=card)
    before = flash_attention.launches
    logits, _, _ = zoo.forward(cfg, model, {"tokens": tokens}, caches=cache, offset=0)
    assert flash_attention.launches == before + cfg.n_layers
    step = zoo.make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for pos in range(20, 24):
        logits, cache = step(model, cache, tok, pos)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 5 * cfg.n_layers
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    # (name, b, s, t, t_max, h, kh, d, causal, softcap, window)
    ("decode_yi_T1", 8, 1, 1, 4096, 32, 4, 128, True, None, 0),
    ("decode_yi_T129", 8, 1, 129, 4096, 32, 4, 128, True, None, 0),
    ("decode_yi_T777", 8, 1, 777, 4096, 32, 4, 128, True, None, 0),
    ("decode_yi_T4096", 8, 1, 4096, 4096, 32, 4, 128, True, None, 0),
    ("decode_hymba_T2049_w2048", 8, 1, 2049, 4096, 25, 5, 64, True, None, 2048),
    ("decode_hymba_T4096_w2048", 8, 1, 4096, 4096, 25, 5, 64, True, None, 2048),
    ("decode_2q_T777_w300_d32", 2, 2, 777, 1024, 16, 2, 32, True, 30.0, 300),
    ("prefill_yi_S300", 1, 300, 300, 300, 32, 4, 128, True, None, 0),
    ("prefill_yi_S256_T1024", 1, 256, 1024, 2048, 32, 4, 128, True, None, 0),
    ("prefill_d32_cap50", 1, 128, 128, 128, 8, 8, 32, True, 50.0, 0),
    ("prefill_d64_cap30", 1, 128, 256, 256, 6, 2, 64, True, 30.0, 0),
    ("prefill_noncausal_S256_T512", 2, 256, 512, 512, 4, 1, 32, False, None, 0),
    ("prefill_hymba_S1000_w300", 1, 1000, 1000, 1000, 25, 5, 64, True, None, 300),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_flash_routes_match_plain(card, case, dtype):
    """Each route against the plain version: bf16 decode (at most 16 rows per
    KV head) split over keys at ragged T, through a window and on cache
    views; bf16 prefill on the tensor cores at a prompt no tile divides, on
    top of a cache (S < T), at d 32/64 with softcaps and without the causal
    mask; f32 on the CUDA-core kernel.  The route's own launch count shows
    which kernel ran."""
    _, b, s, t, t_max, h, kh, d, causal, cap, window = case
    q, kc, vc = _flash_inputs(card, [(b, s, h, d), (b, t_max, kh, d), (b, t_max, kh, d)],
                              dtype, t + s)
    k, v = kc[:, :t], vc[:, :t]
    kw = dict(causal=causal, softcap=cap, window=window)
    route = flash_route(dtype, s, h, kh)
    assert route == ("simt" if dtype == torch.float32 else "split" if s * h // kh <= 16
                     else "wgmma")
    before = flash_attention.launches, flash_attention.route_launches[route]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.route_launches[route]) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_ref(q, k.contiguous(), v.contiguous(), **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    again = flash_attention(q, k, v, **kw)  # the split route's tickets were left zero
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def test_flash_split_decodes_on_two_streams(card):
    """yi's decode shape (B = 8, T = 2,048 of a 4,096-slot cache) on the
    split route from two streams at once, over and over: each stream's
    output equals its single-stream result, so the streams' partials never
    merge through a shared ticket."""
    sets = [_flash_inputs(card, [(8, 1, 32, 128), (8, 4096, 4, 128), (8, 4096, 4, 128)],
                          torch.bfloat16, seed) for seed in (11, 12)]
    sets = [(q, kc[:, :2048], vc[:, :2048]) for q, kc, vc in sets]
    assert flash_route(torch.bfloat16, 1, 32, 4) == "split"
    alone = [flash_attention(*qkv) for qkv in sets]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in sets]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(card))
    outs = [[], []]
    for _ in range(50):
        for i, (st, qkv) in enumerate(zip(streams, sets)):
            with torch.cuda.stream(st):
                outs[i].append(flash_attention(*qkv))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(o, want) for o in got)


# The kernel and the plain version both run the recurrence in f32 and sum
# each output's M products in other orders; the state's rounding carries
# over the steps where the decay is weak.  So f32 agrees within WKV_ATOL of
# the largest output (or 1); bf16 outputs may also round to the other
# neighbour, one bf16 step: 2**-7 of the value.
WKV_ATOL = 2e-5
WKV_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}


def _wkv_inputs(card, b, t, h, m, dtype, w_dtype, seed, lam=None, state=False):
    """r, k, v ~ N(0, 0.25), u ~ N(0, 0.09), and decays from the JAX sweep's
    domain (log w = -exp(x), x ~ N(-1, 1) clipped to [-6, 1]) or a constant
    log-decay ``lam`` per step; an N(0, 0.25) state in when ``state``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, m)).astype(np.float32) * 0.5 for _ in range(3))
    if lam is None:
        w = np.exp(-np.exp(np.clip(rng.standard_normal((b, t, h, m)) - 1.0, -6.0, 1.0)))
    else:
        w = np.full((b, t, h, m), np.exp(lam))
    u = rng.standard_normal((h, m)) * 0.3
    s = rng.standard_normal((b, h, m, m)) * 0.5 if state else None
    on = lambda a, dt: torch.from_numpy(np.asarray(a, np.float32)).to(dt).to(card)
    return ([on(x, dtype) for x in (r, k, v)] + [on(w, w_dtype), on(u, dtype)]
            + [None if s is None else on(s, torch.float32)])


def _wkv_close(got, want):
    (o, s), (o_want, s_want) = got, want
    for x, ref in ((o, o_want), (s, s_want)):
        assert x.dtype == ref.dtype and x.shape == ref.shape
        scale = max(1.0, ref.float().abs().max().item())
        torch.testing.assert_close(x.float(), ref.float(), atol=WKV_ATOL * scale,
                                   rtol=WKV_RTOL[x.dtype])


@pytest.mark.parametrize("case", [
    # (b, t, h, m, dtype, w dtype, log-decay, state in, route (None: by shape), chunk)
    ("prefill", 1, 2048, 32, 64, torch.bfloat16, torch.float32, None, False, None, None),
    ("prefill_step", 1, 2048, 32, 64, torch.bfloat16, torch.float32, None, False, "step", 64),
    ("prefill_f32", 1, 512, 32, 64, torch.float32, torch.float32, None, False, None, None),
    ("serve_B4", 4, 2048, 32, 64, torch.bfloat16, torch.float32, None, False, None, None),
    ("decode", 8, 1, 32, 64, torch.bfloat16, torch.float32, None, True, None, None),
    ("decode_f32", 8, 1, 32, 64, torch.float32, torch.float32, None, True, None, None),
    ("decay_-1", 1, 256, 2, 64, torch.float32, torch.float32, -1.0, False, None, None),
    ("decay_-1.5", 1, 256, 2, 64, torch.float32, torch.float32, -1.5, False, None, None),
    ("split_decay_-1_777", 1, 777, 2, 64, torch.float32, torch.float32, -1.0, True, "split", 64),
    ("split_decay_-1.5_777", 1, 777, 2, 64, torch.float32, torch.float32, -1.5, True, "split",
     64),
    ("ragged_777", 2, 777, 4, 64, torch.float32, torch.float32, None, True, None, None),
    ("ragged_777_step", 2, 777, 4, 64, torch.float32, torch.float32, None, True, "step", 64),
    ("ragged_777_chunk16", 2, 777, 4, 64, torch.bfloat16, torch.float32, None, True, "split",
     16),
    ("split_L-1", 2, 63, 4, 64, torch.float32, torch.float32, None, True, "split", 64),
    ("split_L+1", 2, 65, 4, 64, torch.bfloat16, torch.float32, None, True, "split", 64),
    ("ragged_37_bf16_w", 2, 37, 4, 64, torch.bfloat16, torch.bfloat16, None, True, None, None),
    ("sweep_m128", 2, 64, 1, 128, torch.bfloat16, torch.bfloat16, None, False, None, None),
    ("split_m128", 2, 300, 1, 128, torch.bfloat16, torch.bfloat16, None, True, "split", 64),
    ("m32", 2, 64, 2, 32, torch.float32, torch.float32, None, True, None, None),
    ("split_m32", 2, 300, 2, 32, torch.float32, torch.float32, None, True, "split", 64),
], ids=lambda c: c[0])
def test_wkv6_kernel_matches_plain(card, case):
    """Both routes against the plain version: the step route at decode and
    on request, the split route at the path's prefill, launch.serve's B=4,
    a chunk length either side of T, ragged T from a state, strong decay
    across chunk boundaries and each head size.  The route's own count
    shows which ran."""
    _, b, t, h, m, dtype, w_dtype, lam, state, route, chunk = case
    args = _wkv_inputs(card, b, t, h, m, dtype, w_dtype, t + m, lam, state)
    took = route or wkv6_route(t)
    before = wkv6.launches, wkv6.route_launches[took]
    got = wkv6(*args, route=route, chunk=chunk)
    torch.cuda.synchronize()
    assert (wkv6.launches, wkv6.route_launches[took]) == (before[0] + 1, before[1] + 1)
    _wkv_close(got, wkv6_ref(*args))


@pytest.mark.parametrize("kernel", ["wkv6", "ssm_scan"])
def test_recurrence_routes_by_shape(card, kernel):
    """Decode (T = 1) takes the step route and the path's prefill (T =
    2,048) the split route, each counted once on its route."""
    fn, route_of = (wkv6, wkv6_route) if kernel == "wkv6" else (ssm_scan, ssm_scan_route)
    assert (route_of(1), route_of(2048)) == ("step", "split")
    for t, route in ((1, "step"), (2048, "split")):
        if kernel == "wkv6":
            args = _wkv_inputs(card, 1, t, 32, 64, torch.bfloat16, torch.float32, t, state=True)
        else:
            args = _ssm_inputs(card, 1, t, 1600, 16, torch.bfloat16, t, state=True)
        before = fn.launches, dict(fn.route_launches)
        fn(*args)
        torch.cuda.synchronize()
        want = dict(before[1], **{route: before[1][route] + 1})
        assert (fn.launches, fn.route_launches) == (before[0] + 1, want)


def test_rwkv_launches_one_wkv6_kernel_per_layer(card):
    """rwkv6 smoke on the card: a prefill and each decode step launch the
    kernel once per layer; a step limited to one row leaves the other row's
    state as it was."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = get_config("rwkv6-1.6b", smoke=True)
    model = zoo.build_params(cfg, 0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 20), device=card, dtype=torch.int32)
    cache = zoo.init_kv_cache(cfg, 2, 24, dtype=cfg.dtype, device=card)
    before = wkv6.launches
    logits, _, _ = zoo.forward(cfg, model, {"tokens": tokens}, caches=cache, offset=0)
    assert wkv6.launches == before + cfg.n_layers
    step = zoo.make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for pos in range(20, 23):
        logits, cache = step(model, cache, tok, pos)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    kept = {name: leaf[:, 0].clone() for name, leaf in cache.items()}
    step(model, cache, tok, 23, rows=torch.tensor([1], device=card))
    torch.cuda.synchronize()
    assert wkv6.launches == before + 5 * cfg.n_layers
    assert torch.isfinite(logits.float()).all()
    for name, leaf in cache.items():
        assert torch.equal(leaf[:, 0], kept[name]), name


@pytest.mark.parametrize("case", ["head_size", "strided"])
def test_wkv6_kernel_refuses_what_it_does_not_take(card, case):
    """A head size with no instance, and operands that are not contiguous."""
    m = 48 if case == "head_size" else 64
    r, k, v, w, u, _ = _wkv_inputs(card, 1, 8, 2, m, torch.float32, torch.float32, 0)
    if case == "strided":
        r = torch.cat([r, r], dim=1)[:, ::2]
    before = wkv6.launches
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u)
    assert wkv6.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    # (b, s, t, t_max, h, kh, d, window)
    ("prefill_3000_w2048", 1, 3000, 3000, 3000, 25, 5, 64, 2048),
    ("decode_2049_w2048", 8, 1, 2049, 4096, 25, 5, 64, 2048),
    ("decode_4096_w2048", 8, 1, 4096, 4096, 25, 5, 64, 2048),
    ("prefill_300_w100_d32", 2, 300, 300, 300, 4, 2, 32, 100),
    ("chunk_7_at_200_w16", 2, 7, 207, 256, 4, 1, 64, 16),
    ("window_1", 1, 70, 70, 70, 2, 2, 128, 1),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_flash_window_matches_plain(card, case, dtype):
    """hymba's head layout (25 query heads over 5 KV heads, d 64) with its
    2,048-token window at prefill past the window and at decode on cache
    views past it, and other windows, head dims and chunk shapes."""
    _, b, s, t, t_max, h, kh, d, window = case
    q, kc, vc = _flash_inputs(card, [(b, s, h, d), (b, t_max, kh, d), (b, t_max, kh, d)],
                              dtype, t + window)
    k, v = kc[:, :t], vc[:, :t]
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k.contiguous(), v.contiguous(), window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if t >= window + 64:  # a tile or more outside the window: the answer moved
        glob = flash_attention_ref(q, k.contiguous(), v.contiguous())
        assert (glob - want).float().abs().max() > 4 * (got - want).float().abs().max()


# The kernel and the plain version both run the recurrence in f32, with the
# step's product and sum fused or not and each y's N products summed in
# other orders.  So f32 agrees within SSM_ATOL of the largest output (or 1);
# bf16 outputs may also round to the other neighbour (2**-7 of the value);
# the state is f32 in both.
SSM_ATOL = 2e-5
SSM_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-7}


def _ssm_inputs(card, b, t, d, n, dtype, seed, state=False, dt_range=None):
    """x, b, c ~ N(0, 0.25); dt = softplus(N(0, 1) - 4.6) + 1e-4 (Mamba's
    domain, the JAX sweep's) or uniform in ``dt_range``; a = -exp(N(0, 0.09))
    in f32; an N(0, 0.25) f32 state when ``state``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)) * 0.5
    if dt_range is None:
        dt = np.log1p(np.exp(rng.standard_normal((b, t, d)) - 4.6)) + 1e-4
    else:
        dt = rng.uniform(*dt_range, (b, t, d))
    a = -np.exp(rng.standard_normal((d, n)) * 0.3)
    bb, cc = (rng.standard_normal((b, t, n)) * 0.5 for _ in range(2))
    h0 = rng.standard_normal((b, d, n)) * 0.5 if state else None
    on = lambda v, dt_: torch.from_numpy(np.asarray(v, np.float32)).to(dt_).to(card)
    return ([on(x, dtype), on(dt, dtype), on(a, torch.float32), on(bb, dtype), on(cc, dtype)]
            + [None if h0 is None else on(h0, torch.float32)])


@pytest.mark.parametrize("case", [
    # (b, t, d, n, dtype, state in, dt range, route (None: by shape), chunk)
    ("prefill", 1, 2048, 1600, 16, torch.bfloat16, False, None, None, None),
    ("prefill_step", 1, 2048, 1600, 16, torch.bfloat16, False, None, "step", 64),
    ("prefill_f32", 1, 512, 1600, 16, torch.float32, False, None, None, None),
    ("serve_B4", 4, 2048, 1600, 16, torch.bfloat16, False, None, None, None),
    ("decode", 8, 1, 1600, 16, torch.bfloat16, True, None, None, None),
    ("decode_f32", 8, 1, 1600, 16, torch.float32, True, None, None, None),
    ("ragged_777", 2, 777, 100, 16, torch.float32, True, None, None, None),
    ("ragged_777_step", 2, 777, 100, 16, torch.float32, True, None, "step", 64),
    ("ragged_777_n8_chunk16", 2, 777, 100, 8, torch.bfloat16, True, None, "split", 16),
    ("split_L-1", 2, 63, 1600, 16, torch.float32, True, None, "split", 64),
    ("split_L+1", 2, 65, 1600, 16, torch.bfloat16, True, None, "split", 64),
    ("smoke_n8", 2, 37, 64, 8, torch.bfloat16, True, None, None, None),
    ("sweep_n8_f32", 1, 64, 128, 8, torch.float32, False, None, None, None),
    ("past_the_clamp", 1, 256, 64, 16, torch.float32, False, (2.0, 3.0), None, None),
    ("split_past_the_clamp_777", 1, 777, 64, 16, torch.float32, True, (2.0, 3.0), "split", 64),
], ids=lambda c: c[0])
def test_ssm_scan_kernel_matches_plain(card, case):
    """Both routes against the plain version: the step route at decode and
    on request, the split route at the path's prefill, launch.serve's B=4,
    a chunk length either side of T, ragged T and D from a state, N = 8,
    and decays past the reference's clamp across chunk boundaries."""
    _, b, t, d, n, dtype, state, dt_range, route, chunk = case
    args = _ssm_inputs(card, b, t, d, n, dtype, t + d, state, dt_range)
    took = route or ssm_scan_route(t)
    before = ssm_scan.launches, ssm_scan.route_launches[took]
    y, h = ssm_scan(*args, route=route, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan.route_launches[took]) == (before[0] + 1, before[1] + 1)
    y_want, h_want = ssm_scan_ref(*args)
    assert y.dtype == y_want.dtype == dtype and h.dtype == torch.float32
    for got, want, rtol in ((y, y_want, SSM_RTOL[dtype]), (h, h_want, 0.0)):
        scale = max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), atol=SSM_ATOL * scale, rtol=rtol)


@pytest.mark.parametrize("case", ["state_size", "strided"])
def test_ssm_scan_kernel_refuses_what_it_does_not_take(card, case):
    """A state size with no instance, and operands that are not contiguous."""
    x, dt, a, b, c, _ = _ssm_inputs(card, 1, 8, 32, 12 if case == "state_size" else 16,
                                    torch.float32, 0)
    if case == "strided":
        x = torch.cat([x, x], dim=1)[:, ::2]
    before = ssm_scan.launches
    with pytest.raises(ValueError):
        ssm_scan(x, dt, a, b, c)
    assert ssm_scan.launches == before


def test_hymba_launches_one_kernel_each_per_layer(card):
    """hymba smoke on the card: a prefill and each decode step launch
    flash_attention and ssm_scan once per layer, decode crossing the
    16-token window; a step limited to one row leaves the other row's
    K/V, conv and SSM state as they were."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = get_config("hymba-1.5b", smoke=True)
    model = zoo.build_params(cfg, 0, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 14), device=card, dtype=torch.int32)
    cache = zoo.init_kv_cache(cfg, 2, 24, dtype=cfg.dtype, device=card)
    f0, s0 = flash_attention.launches, ssm_scan.launches
    logits, _, _ = zoo.forward(cfg, model, {"tokens": tokens}, caches=cache, offset=0)
    assert (flash_attention.launches - f0, ssm_scan.launches - s0) == (2, 2)
    step = zoo.make_serve_step(cfg)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for pos in range(14, 22):
        logits, cache = step(model, cache, tok, pos)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    kept = {name: leaf[:, 0].clone() for name, leaf in cache.items()}
    step(model, cache, tok, 22, rows=torch.tensor([1], device=card))
    torch.cuda.synchronize()
    assert flash_attention.launches - f0 == ssm_scan.launches - s0 == 10 * cfg.n_layers
    assert torch.isfinite(logits.float()).all()
    for name, leaf in cache.items():
        assert torch.equal(leaf[:, 0], kept[name]), name


# ------------------------------------------------------- the control layers
def test_tenant_router_rows_bit_exact_on_the_card(card):
    """A ``TenantRouter`` over the Gather service on the card: a throttled
    hot tenant and an express background tenant, every served request
    bit-exact, shed ones never served, one launch per server dispatch."""
    from repro_torch.runtime import EmbedShardService, TenantClass, TenantRouter

    cl = Cluster(4, wire="thor_bf2", device=card)
    svc = EmbedShardService(cl, vocab=4 * 256, dim=32, n_keys=8, max_slots=16)
    invokes0 = sum(pe.stats.invokes for pe in cl.servers)
    before = embed_lookup.launches
    cl.set_batching(True)
    svc.batching = True
    cl.set_flow(lanes=True, credit_window=8, poll_budget=16)
    router = TenantRouter(svc, [
        TenantClass("hot", slot_quota=2, queue_limit=6, credit_budget=1),
        TenantClass("bg", express=True),
    ])
    rng = np.random.default_rng(3)
    expected, done = {}, []
    for tick in range(12):
        for tenant, rate in (("hot", 4), ("bg", 1)):
            for _ in range(rate):
                keys = rng.integers(0, svc.vocab, rng.integers(1, 9)).astype(np.int32)
                rid = router.submit(tenant, keys)
                if rid is not None:
                    expected[rid] = svc.table[keys]
        done += router.tick()
    while svc.queue or svc.active:
        done += router.tick()
    torch.cuda.synchronize()
    assert sorted(r.rid for r in done) == sorted(expected)
    for req in done:
        assert not req.degraded
        assert np.array_equal(req.rows.view(np.int32), expected[req.rid].view(np.int32))
    assert router.stats["hot"].shed > 0 and router.stats["bg"].shed == 0
    dispatches = sum(pe.stats.invokes for pe in cl.servers) - invokes0
    assert embed_lookup.launches - before == dispatches > 0


def test_dapc_under_loss_on_the_card(card):
    """DAPC at 5% loss with reliability on: oracle-identical, and one
    ``chase_shard`` launch per server dispatch (a duplicate dropped at the
    seq gate launches nothing)."""
    from repro_torch.core import PointerChaseApp, ReliabilityConfig, chase_ref

    cl = Cluster(4, wire="thor_xeon", device=card)
    app = PointerChaseApp(cl, n_entries=1 << 14, max_slots=32, seed=0)
    cl.set_reliability(ReliabilityConfig.on())
    cl.fabric.set_loss(0.05, seed=1)
    starts = np.random.default_rng(2).integers(0, 1 << 14, 32).astype(np.int32)
    want = np.array([chase_ref(app.table, s, 16) for s in starts], np.int32)
    for batching in (False, True):
        invokes0 = sum(pe.stats.invokes for pe in cl.servers)
        before = chase_shard.launches
        rep = app.dapc(starts, 16, batching=batching)
        torch.cuda.synchronize()
        assert np.array_equal(rep.results, want)
        assert cl.fabric.stats.frames_lost > 0
        dispatches = sum(pe.stats.invokes for pe in cl.servers) - invokes0
        assert chase_shard.launches - before == dispatches > 0
    assert sum(pe.stats.retransmits for pe in cl.pes()) > 0


def test_sandbox_refuses_and_quarantines_a_card_slice(card):
    """A hostile ifunc with a ``cuda-sm90`` slice (an A_RETURN row without a
    ``returns:`` dep) is refused on a card PE and quarantined on every PE;
    the Gather beside it still serves bit-exact rows, no launch for the
    refused code."""
    from repro_torch.core import (
        A_RETURN, ACTION_WIDTH, IFunc, SandboxConfig, SandboxViolation, ShapeDtypeStruct,
    )
    from repro_torch.runtime import EmbedShardService

    def entry(payload):
        z = payload[0] * 0
        return torch.stack([z + A_RETURN, z, z + 1, payload[0]] + [z] * (ACTION_WIDTH - 4))

    bomb = IFunc.build(name="action_bomb", fn=entry, abi="xrdma", targets=("cuda-sm90",),
                       payload_aval=ShapeDtypeStruct((1,), torch.int32))
    cl = Cluster(2, wire="thor_xeon", device=card)
    svc = EmbedShardService(cl, vocab=512, dim=16, n_keys=4, max_slots=8)
    cl.set_sandbox(SandboxConfig.on())
    keys = [np.array([3, 300, 7], np.int32), np.array([511], np.int32)]
    svc.gather(keys)
    cl.toolchain.publish(bomb)
    cl.client.send_ifunc("server0", "action_bomb", np.array([3], np.int32))
    before = embed_lookup.launches
    with pytest.raises(SandboxViolation, match="A_RETURN"):
        cl.servers[0].poll()
    assert embed_lookup.launches == before
    assert cl.refusals() == {"verify_action": 1}
    assert all(bomb.digest.hex() in pe.verifier.quarantined for pe in cl.pes())
    rep = svc.gather(keys)
    for got, want in zip(rep.results, svc.oracle(keys)):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


SPMD_N, SPMD_CHASES, SPMD_DEPTH, SPMD_V, SPMD_D, SPMD_KEYS = 1 << 16, 256, 33, 4096, 128, 512


def _spmd_rank(rank: int, store: str, out_dir: str) -> None:
    """One of two gloo ranks sharing the card: dapc_shard_map and
    gather_shard_map on its shards, with its launches by route."""
    from datetime import timedelta
    from pathlib import Path

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.sharding import dapc_shard_map, gather_shard_map, init_mesh, shard_rows

    mesh = init_mesh((2,), ("model",), backend="gloo", rank=rank, init_method=f"file://{store}",
                     timeout=timedelta(seconds=120))
    dev = mesh.device
    rng = np.random.default_rng(6)
    chain = torch.from_numpy(make_chain(SPMD_N, seed=5)).to(dev)
    starts = torch.from_numpy(rng.integers(0, SPMD_N, SPMD_CHASES).astype(np.int32)).to(dev)
    tab = torch.from_numpy(rng.standard_normal((SPMD_V, SPMD_D), dtype=np.float32)).to(dev)
    keys = torch.from_numpy(rng.integers(0, SPMD_V, SPMD_KEYS).astype(np.int32)).to(dev)
    res = {}
    for name, fn in (
        ("dapc", lambda: dapc_shard_map(shard_rows(chain, mesh), starts, SPMD_DEPTH, mesh)),
        ("gather", lambda: gather_shard_map(shard_rows(tab, mesh), keys, mesh)),
    ):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        res[name] = out.cpu().numpy()
        res[name + "_launches"] = launch_counts()
        res[name + "_routes"] = {"chase_shard": dict(chase_shard.route_launches),
                                 "embed_lookup": dict(embed_lookup.route_launches)}
        res[name + "_device"] = str(out.device)
    mesh.close()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def spmd_on_card(tmp_path_factory):
    """Two gloo ranks on the one card (``torch.multiprocessing``), the
    kernels built here first so the ranks do not each run nvcc."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (sm_90)")
    build.build_all(["chase", "embed_lookup"])
    tmp = tmp_path_factory.mktemp("spmd_card")
    torch.multiprocessing.spawn(_spmd_rank, args=(str(tmp / "store"), str(tmp)), nprocs=2,
                                join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_dapc_shard_map_on_two_gloo_ranks(spmd_on_card):
    """Oracle-identical on both ranks; one chase_shard launch a round
    (``spread``: 256 chases), nothing else launched."""
    rng = np.random.default_rng(6)
    table = make_chain(SPMD_N, seed=5)
    f = rng.integers(0, SPMD_N, SPMD_CHASES).astype(np.int32)
    for _ in range(SPMD_DEPTH):
        f = table[f]
    for res in spmd_on_card:
        assert res["dapc_device"].startswith("cuda")
        assert np.array_equal(res["dapc"], f)
        assert res["dapc_launches"] == {**dict.fromkeys(res["dapc_launches"], 0),
                                        "chase_shard": SPMD_DEPTH}
        assert res["dapc_routes"]["chase_shard"]["spread"] == SPMD_DEPTH


def test_gather_shard_map_on_two_gloo_ranks(spmd_on_card):
    """Bit-identical to the numpy take on both ranks; one embed_lookup
    launch a rank (``warp``: 512-byte rows)."""
    rng = np.random.default_rng(6)
    rng.integers(0, SPMD_N, SPMD_CHASES)  # the starts, drawn first
    tab = rng.standard_normal((SPMD_V, SPMD_D), dtype=np.float32)
    keys = rng.integers(0, SPMD_V, SPMD_KEYS)
    for res in spmd_on_card:
        assert np.array_equal(res["gather"], tab[keys])
        assert res["gather_launches"] == {**dict.fromkeys(res["gather_launches"], 0),
                                          "embed_lookup": 1}
        assert res["gather_routes"]["embed_lookup"]["warp"] == 1


# ------------------------------------------------------- the train step
BWD_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=1e-3, rtol=2**-7)}
BWD_CASES = [
    # (name, b, s, t, h, kh, d, kwargs)
    ("gqa_S300_d128", 1, 300, 300, 32, 4, 128, {}),
    ("window_softcap_S_lt_T_d64", 2, 77, 333, 6, 2, 64, {"window": 50, "softcap": 30.0}),
    ("non_causal_d32", 1, 200, 130, 4, 1, 32, {"causal": False}),
    ("keyless_rows_d32", 1, 150, 100, 4, 2, 32, {}),  # rows of queries 0-49 see no key
]


def _bwd_case(card, case, dtype, seed=11):
    _, b, s, t, h, kh, d, kw = case
    q, k, v, dout = _flash_inputs(card, [(b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                                         (b, s, h, d)], dtype, seed)
    keyless = max(0, s - t) if kw.get("causal", True) else 0
    out = (flash_attention_ref if keyless else flash_attention)(q, k, v, **kw).contiguous()
    return q, k, v, out, dout, kw, keyless


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_flash_bwd_kernel_matches_plain(card, case, dtype):
    """dQ, dK and dV from the backward kernel against its plain version on
    the same inputs, on each route the dtype takes: bf16 on ``wgmma`` by
    default (the plain version rounds P and dS to bf16 where the kernel
    does) and on ``simt`` by name (all f32: its plain version is the plain
    one on f32 copies, rounded at the end), f32 on ``simt``.  f32 within
    2e-5 (f32 products summed in other orders); bf16 within one bf16
    rounding of the value plus 1e-3.  A row that sees no key gets a dQ of
    exactly 0; each call counts one launch on its route.  ``wgmma`` rounds
    P and dS to bf16 from f32 values summed in another order than the plain
    version's, so a row may also move by one bf16 step of its largest
    rounded term (``flash_attention_bwd_step_ref``)."""
    from repro_torch.kernels.flash_attention import (
        bwd_route, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_bwd_step_ref,
    )

    q, k, v, out, dout, kw, keyless = _bwd_case(card, case, dtype)
    routes = [bwd_route(dtype)] + (["simt"] if dtype == torch.bfloat16 else [])
    assert routes[0] == ("wgmma" if dtype == torch.bfloat16 else "simt")
    for route in routes:
        before = dict(flash_attention_bwd.route_launches)
        got = flash_attention_bwd(q, k, v, out, dout, route=None if route == routes[0] else route,
                                  **kw)
        torch.cuda.synchronize()
        assert flash_attention_bwd.route_launches == {**before, route: before[route] + 1}
        if route == "simt" and dtype == torch.bfloat16:
            want = [x.to(dtype) for x in flash_attention_bwd_ref(
                q.float(), k.float(), v.float(), out.float(), dout.float(), **kw)]
            steps = (0.0,) * 3
        else:
            want = flash_attention_bwd_ref(q, k, v, out, dout, **kw)
            steps = flash_attention_bwd_step_ref(q, k, v, out, dout, **kw)
        tol = BWD_TOL[dtype]
        for g, w, step in zip(got, want, steps):
            assert g.dtype == dtype
            g, w = g.float(), w.float()
            err = (g - w).abs() - (tol["atol"] + tol["rtol"] * w.abs() + step)
            assert torch.isfinite(g).all() and err.max() <= 0, (route, err.max().item())
        assert torch.equal(got[0][:, :keyless], torch.zeros_like(got[0][:, :keyless]))


@pytest.mark.parametrize("route", ["wgmma", "simt"])
def test_flash_bwd_is_deterministic(card, route):
    """No atomics: the same inputs give bit-identical gradients, call after
    call (a restored training run replays its steps)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, out, dout, kw, _ = _bwd_case(card, BWD_CASES[1], torch.bfloat16, seed=14)
    first = flash_attention_bwd(q, k, v, out, dout, route=route, **kw)
    for _ in range(3):
        again = flash_attention_bwd(q, k, v, out, dout, route=route, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("case", [
    # (route, dtype, b, s, t, h, kh, d, kwargs)
    ("wgmma", torch.bfloat16, 1, 300, 300, 32, 4, 128, {}),
    ("wgmma", torch.bfloat16, 2, 77, 333, 6, 2, 64, {"window": 50, "softcap": 30.0}),
    ("split", torch.bfloat16, 2, 1, 1000, 32, 4, 128, {}),  # split over keys, merged
    ("split", torch.bfloat16, 1, 2, 40, 8, 4, 32, {}),  # one chunk
    ("simt", torch.float32, 1, 300, 300, 32, 4, 128, {}),
    ("simt", torch.float32, 1, 40, 100, 6, 2, 64, {"window": 20, "softcap": 5.0}),
], ids=lambda c: f"{c[0]}_S{c[3]}_T{c[4]}_d{c[7]}")
def test_flash_forward_lse(card, case):
    """Each forward route's log-sum-exp against the plain one on the same
    inputs (atol 1e-4), and the output with and without an lse pointer
    bit-identical, with the same route counts."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    route, dtype, b, s, t, h, kh, d, kw = case
    q, k, v = _flash_inputs(card, [(b, s, h, d), (b, t, kh, d), (b, t, kh, d)], dtype, 12)
    opts = (kw.get("causal", True), kw.get("softcap"), None, kw.get("window", 0))
    before = dict(flash_attention.route_launches)
    plain_out, none = flash_kernel._forward(q, k, v, *opts)
    out, lse = flash_kernel._forward(q, k, v, *opts, save_lse=True)
    torch.cuda.synchronize()
    assert none is None and lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert flash_attention.route_launches == {**before, route: before[route] + 2}
    assert torch.equal(out, plain_out)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, **kw), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES[:3], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_flash_bwd_given_lse_matches_the_row_pass(card, case, dtype):
    """The backward given the forward's lse (the delta pass alone) against
    the one whose row pass recomputes it, within the backward's bounds."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    q, k, v, _, dout, kw, _ = _bwd_case(card, case, dtype, seed=13)
    out, lse = flash_kernel._forward(q, k, v, kw.get("causal", True), kw.get("softcap"), None,
                                     kw.get("window", 0), save_lse=True)
    got = flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
    want = flash_attention_bwd(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype])


def test_train_step_launches_the_backward_kernel(card):
    """One train step of yi smoke (bf16) with remat and 2 microbatches on
    the card: the flash forward runs twice a layer a microbatch (forward and
    recompute), the backward kernel once, on its ``wgmma`` route; the loss
    is finite and the weights move."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models import zoo
    from repro_torch.optim import AdamW

    cfg = get_config("yi-9b", smoke=True).replace(remat=True, microbatch=2)
    model = zoo.build_params(cfg, 0, device=card)
    before = model.blocks[0].wq.detach().clone()
    opt = AdamW(lr=1e-3)
    state = {"params": model, "opt": opt.init(zoo.model_params(model)), "step": 0}
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 128, 4, "train"), 0, device=card)
    kernels.reset_launches()
    state, metrics = zoo.make_train_step(cfg, opt)(state, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd"] == cfg.n_layers * 2
    assert flash_attention_bwd.route_launches == {"simt": 0, "wgmma": cfg.n_layers * 2}
    assert counts["flash_attention"] == cfg.n_layers * 2 * 2
    assert torch.isfinite(metrics["loss"]) and state["step"] == 1
    assert not torch.equal(model.blocks[0].wq, before)
    assert not any(p.requires_grad for p in model.parameters())


def test_forced_route_takes_a_whole_backward(card):
    """Under ``bwd_route_forced("simt")`` every backward launch of a yi
    smoke (bf16, remat) loss's gradient takes ``simt``, the checkpoint's
    recomputed forwards included; after the block bf16 is on ``wgmma``
    again."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import bwd_route_forced, flash_attention_bwd
    from repro_torch.models import zoo

    cfg = get_config("yi-9b", smoke=True).replace(remat=True)
    model = zoo.build_params(cfg, 0, device=card)
    params = list(zoo.model_params(model).values())
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 128, 2, "train"), 0, device=card)
    for p in params:
        p.requires_grad_(True)
    for forced, want in (("simt", "simt"), (None, "wgmma")):
        before = dict(flash_attention_bwd.route_launches)
        if forced:
            with bwd_route_forced(forced):
                torch.autograd.grad(zoo.loss_fn(cfg, model, batch)[0], params)
        else:
            torch.autograd.grad(zoo.loss_fn(cfg, model, batch)[0], params)
        torch.cuda.synchronize()
        assert flash_attention_bwd.route_launches == {**before, want: before[want]
                                                      + cfg.n_layers}


# the recurrences' backward kernels against their plain versions: both run
# the same f32 recurrence forward and back and sum in other orders, so f32
# agrees within 1e-4 of each gradient's largest; a bf16 gradient may also
# round to the other neighbour of the same f32 value (2**-7 of it)
REC_BWD_TOL = 1e-4


def _rec_bwd_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        g, w = g.float(), w.float()
        rtol = 2.0**-7 if got[0].dtype == torch.bfloat16 else 0.0
        bound = REC_BWD_TOL * w.abs().max() + rtol * w.abs()
        assert ((g - w).abs() <= bound).all(), (i, (g - w).abs().max().item())


@pytest.mark.parametrize("t", [1, 100, 300], ids=lambda t: f"T{t}")
@pytest.mark.parametrize("m,dtype,route", [
    (32, torch.float32, "split"), (64, torch.float32, "split"), (128, torch.float32, "split"),
    (64, torch.bfloat16, "split"), (32, torch.bfloat16, "mma"), (64, torch.bfloat16, "mma"),
    (128, torch.bfloat16, "mma"),
], ids=["m32", "m64", "m128", "m64_bf16", "m32_bf16_mma", "m64_bf16_mma", "m128_bf16_mma"])
def test_wkv6_bwd_kernel_matches_plain(card, t, m, dtype, route):
    """Every gradient of ``wkv6_bwd`` against ``wkv6_bwd_ref`` on the same
    inputs (decays from 1e-6 to 0.999, a given state and a final-state
    cotangent), below and above SPLIT_MIN_T, on each route its dtype takes
    (bf16: ``mma`` and ``split``); a second call gives the same bits; one
    launch a call, counted under the route."""
    from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_bwd_ref

    g = torch.Generator(card).manual_seed(t + m)
    r, k, v, dout = (torch.randn(2, t, 2, m, generator=g, device=card).to(dtype)
                     for _ in range(4))
    w = torch.exp(torch.rand(2, t, 2, m, generator=g, device=card) * np.log(1e-6 / 0.999)
                  + np.log(0.999))
    u = torch.randn(2, m, generator=g, device=card).to(dtype)
    s0, ds = (torch.randn(2, 2, m, m, generator=g, device=card) for _ in range(2))
    before = (wkv6_bwd.launches, dict(wkv6_bwd.route_launches))
    got = wkv6_bwd(r, k, v, w, u, s0, dout, ds, route=route)
    again = wkv6_bwd(r, k, v, w, u, s0, dout, ds, route=route)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == before[0] + 2
    assert wkv6_bwd.route_launches == {k2: n + 2 * (k2 == route) for k2, n in before[1].items()}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _rec_bwd_close(got, wkv6_bwd_ref(r, k, v, w, u, s0, dout, ds))


@pytest.mark.parametrize("w_dtype,u_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32)],
                         ids=["w_bf16_u_f32", "w_bf16_u_bf16", "w_f32_u_f32"])
def test_wkv6_bwd_mma_takes_each_decay_and_bonus_dtype(card, w_dtype, u_dtype):
    """The mma route with bf16 r, k, v and dout and each dtype of w and u it
    takes (the model passes f32 w): every gradient in its operand's dtype
    and within the plain version's bounds, on a ragged last chunk."""
    from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_bwd_ref

    g = torch.Generator(card).manual_seed(21)
    b, t, h, m = 2, 45, 2, 64
    r, k, v, dout = (torch.randn(b, t, h, m, generator=g, device=card).to(torch.bfloat16)
                     for _ in range(4))
    w = torch.exp(torch.rand(b, t, h, m, generator=g, device=card) * np.log(1e-6 / 0.999)
                  + np.log(0.999)).to(w_dtype)
    u = torch.randn(h, m, generator=g, device=card).to(u_dtype)
    s0, ds = (torch.randn(b, h, m, m, generator=g, device=card) for _ in range(2))
    got = wkv6_bwd(r, k, v, w, u, s0, dout, ds, route="mma")
    assert [x.dtype for x in got] == [torch.bfloat16] * 3 + [w_dtype, u_dtype, torch.float32]
    _rec_bwd_close(got, wkv6_bwd_ref(r, k, v, w, u, s0, dout, ds))


@pytest.mark.parametrize("t", [1, 100, 300], ids=lambda t: f"T{t}")
@pytest.mark.parametrize("d,n,dtype", [(37, 8, torch.float32), (1600, 16, torch.float32),
                                       (100, 16, torch.bfloat16)],
                         ids=["d37n8", "hymba", "d100_bf16"])
@pytest.mark.parametrize("route", ["split", "regs"])
def test_ssm_scan_bwd_kernel_matches_plain(card, t, d, n, dtype, route):
    """Every gradient of ``ssm_scan_bwd`` against ``ssm_scan_bwd_ref`` on
    the same inputs (dt in 2-3, so decays down to ~1e-4, a given state and
    a final-state cotangent), below and above SPLIT_MIN_T, on each route; a
    second call gives the same bits; one launch a call, counted under the
    route."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_bwd_ref

    g = torch.Generator(card).manual_seed(t + d)
    x, dy = (torch.randn(2, t, d, generator=g, device=card).to(dtype) for _ in range(2))
    dt = (torch.rand(2, t, d, generator=g, device=card) + 2.0).to(dtype)
    a = -torch.rand(d, n, generator=g, device=card) * 3.0 - 0.01
    b, c = (torch.randn(2, t, n, generator=g, device=card).to(dtype) for _ in range(2))
    h0, dh = (torch.randn(2, d, n, generator=g, device=card) for _ in range(2))
    before = (ssm_scan_bwd.launches, dict(ssm_scan_bwd.route_launches))
    got = ssm_scan_bwd(x, dt, a, b, c, h0, dy, dh, route=route)
    again = ssm_scan_bwd(x, dt, a, b, c, h0, dy, dh, route=route)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before[0] + 2
    assert ssm_scan_bwd.route_launches == {k: n + 2 * (k == route)
                                           for k, n in before[1].items()}
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    _rec_bwd_close(got, ssm_scan_bwd_ref(x, dt, a, b, c, h0, dy, dh))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_train_step_launches_the_backward_kernels(card, arch):
    """One bf16 train step of rwkv6 and hymba smoke with remat (each block
    under torch.utils.checkpoint) and 2 microbatches on the card: the
    recurrence's forward kernel runs twice a layer a microbatch (forward
    and recompute) and its backward kernel once; hymba's flash forward and
    backward likewise; the loss is finite and the weights move."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.optim import AdamW

    cfg = get_config(arch, smoke=True).replace(remat=True, microbatch=2)
    model = zoo.build_params(cfg, 0, device=card)
    probe = next(p for n, p in model.named_parameters() if n.endswith(("wo", "w_out")))
    probe0 = probe.detach().clone()
    opt = AdamW(lr=1e-3)
    state = {"params": model, "opt": opt.init(zoo.model_params(model)), "step": 0}
    batch = zoo.make_batch(cfg, zoo.ShapeSpec("t", 300, 4, "train"), 0, device=card)
    kernels.reset_launches()
    state, metrics = zoo.make_train_step(cfg, opt)(state, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rec = "wkv6" if arch == "rwkv6-1.6b" else "ssm_scan"
    per = cfg.n_layers * 2
    assert counts[rec] == 2 * per and counts[rec + "_bwd"] == per
    want_flash = (0, 0) if arch == "rwkv6-1.6b" else (2 * per, per)
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == want_flash
    bf16_route = "mma" if arch == "rwkv6-1.6b" else "regs"
    routes = kernels.WRAPPERS[rec + "_bwd"].route_launches
    assert routes == {r: per * (r == bf16_route) for r in routes}
    assert torch.isfinite(metrics["loss"]) and state["step"] == 1
    assert not torch.equal(probe, probe0)
    assert not any(p.requires_grad for p in model.parameters())


def test_embedding_backward_is_deterministic(card):
    """The embedding's table gradient on the card sums each row's
    cotangents in a fixed order: three backwards over ids that repeat
    (16,384 ids over 500 rows) give the same bits, and the forward gives
    index_select's."""
    from repro_torch.models.embedding import embed_plain

    g = torch.Generator(card).manual_seed(3)
    table = torch.randn(32000, 512, generator=g, device=card).to(torch.bfloat16)
    ids = torch.randint(0, 500, (4, 4096), generator=g, device=card)
    cot = torch.randn(4, 4096, 512, generator=g, device=card).to(torch.bfloat16)
    leaf = table.clone().requires_grad_()
    rows = embed_plain(leaf, ids)
    assert torch.equal(rows, table.index_select(0, ids.reshape(-1)).reshape(4, 4096, 512))
    grads = [torch.autograd.grad(embed_plain(leaf, ids), leaf, cot)[0] for _ in range(3)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])
