"""The launch plans of ``embed_lookup`` and ``chase_shard``: which route a
call takes and the grid it launches, in pure Python, and the wrappers'
CPU path with a route named, against the JAX package's oracles and its
Pallas kernels in interpret mode.

Everything compared is raw bits or int32, so every comparison is exact.
The routes themselves run only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chase.kernel import chase_shard as pallas_chase_shard
from repro.kernels.chase.ref import chase_ref as jax_chase_ref
from repro.kernels.embed_lookup.kernel import embed_lookup as pallas_embed_lookup
from repro.kernels.embed_lookup.ref import embed_lookup_ref as jax_embed_lookup_ref
from repro_torch.core import make_chain
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.chase import chase_grid, chase_route, chase_shard
from repro_torch.kernels.chase import kernel as chase_kernel
from repro_torch.kernels.embed_lookup import embed_grid, embed_lookup, embed_route
from repro_torch.kernels.embed_lookup import kernel as embed_kernel

SIZES = (0, 1, 16, 32, 33, 1024, 65_536)
ROW = 128 * 4  # the Gatherer's row: 128 f32 as their i32 bits


# ------------------------------------------------------------ embed_lookup
@pytest.mark.parametrize("n", SIZES)
def test_embed_route_takes_bulk_for_wide_aligned_rows(n):
    """The LMs' remote-embedding rows (8 KB and 16 KB of f32) go by bulk
    copies, at any N."""
    assert embed_route(n, 8 * 1024, True) == "bulk"  # rwkv6-1.6b's d_model
    assert embed_route(n, 16 * 1024, True) == "bulk"  # yi-9b's
    assert embed_route(n, embed_kernel.BULK_TILE_BYTES, True) == "bulk"


@pytest.mark.parametrize("n", SIZES)
def test_embed_route_takes_warp_for_other_rows(n):
    assert embed_route(n, ROW, True) == "warp"  # the Gather service's rows
    assert embed_route(n, 6400, True) == "warp"  # hymba-1.5b's d_model
    assert embed_route(n, 16 * 1024, False) == "warp"  # a table off a 16-byte boundary
    assert embed_route(n, 6, True) == "warp"  # bf16 rows of 3
    assert embed_route(n, 8 * 1024 + 8, True) == "warp"  # an 8-byte multiple only
    assert embed_route(n, embed_kernel.BULK_TILE_BYTES + 16, True) == "warp"  # over the tile


@pytest.mark.parametrize("row_bytes", [16, ROW, 4096, 6400, 16 * 1024, 46 * 1024])
@pytest.mark.parametrize("n", SIZES)
def test_embed_bulk_grid_covers_every_id_once(n, row_bytes):
    """Block k takes ids [k R, k R + R): every id in exactly one block, no
    block without one, R a lane or fewer, the tile in its shared memory."""
    blocks, threads, rows = embed_grid(n, row_bytes, "bulk")
    assert threads == 32 and 1 <= rows <= embed_kernel.BULK_ROWS
    assert rows * row_bytes <= embed_kernel.BULK_TILE_BYTES
    assert blocks * rows >= n and (blocks - 1) * rows < max(n, 1)
    if row_bytes == ROW:
        assert rows == 32 and blocks == -(-n // 32)  # N = 16 one block, 1,024 thirty-two


@pytest.mark.parametrize("n", SIZES)
def test_embed_warp_grid_is_one_warp_per_id(n):
    blocks, threads, per_block = embed_grid(n, ROW, "warp")
    assert (threads, per_block) == (256, 8)
    assert blocks == min(-(-n // 8), 1 << 20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("route", embed_kernel.ROUTES)
def test_embed_cpu_path_on_a_route_matches_jax(route, dtype):
    """A route named on the host changes nothing: the plain version, equal
    to the JAX oracle on the same bits and, for f32 and bf16 rows, to the
    Pallas kernel in interpret mode (its one-hot product runs in f32, which
    carries no 32-bit pattern whole, so the i32 view is held to the oracle)."""
    rng = np.random.default_rng(11)
    v_loc, d, lo = 64, 16, 64
    f32 = rng.standard_normal((v_loc, d)).astype(np.float32)
    tab = torch.from_numpy(f32)
    tab = tab.view(torch.int32) if dtype == torch.int32 else tab.to(dtype)
    ids = rng.integers(-1, 3 * v_loc, 48).astype(np.int32)
    ids[:4] = [-1, lo - 1, lo + v_loc, lo]
    got = embed_lookup(tab, torch.from_numpy(ids), torch.tensor(lo, dtype=torch.int32),
                       route=route)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    raw = jnp.asarray(tab.view(bits).numpy())
    want = jax_embed_lookup_ref(raw, jnp.asarray(ids), lo)
    np.testing.assert_array_equal(got.view(bits).numpy(), np.asarray(want))
    if dtype == torch.int32:
        return
    typed = jnp.asarray(f32) if dtype == torch.float32 else jax.lax.bitcast_convert_type(
        raw, jnp.bfloat16)
    want_pallas = pallas_embed_lookup(typed, jnp.asarray(ids), lo, bt=16, bv=64, interpret=True)
    np.testing.assert_array_equal(
        got.view(bits).numpy(), np.asarray(want_pallas).view(np.asarray(raw).dtype))


# ------------------------------------------------------------- chase_shard
@pytest.mark.parametrize("b", (0, 1, 31, 32, 33, 256, 65_536))
def test_chase_route_and_grid(b):
    """A message's lone chase and small batches keep the thread route
    (256 threads a block); from 128 chases the spread route's 32 a block,
    so B = 256 spreads over 8 blocks.  Each chase one thread of exactly one
    block, no block without one."""
    assert chase_route(b) == ("spread" if b >= 128 else "thread")
    for route, threads in (("spread", 32), ("thread", 256)):
        blocks, t = chase_grid(b, route)
        assert t == threads
        assert blocks * t >= b and (blocks - 1) * t < max(b, 1)
    assert chase_grid(256, "spread") == (8, 32)
    assert chase_grid(256, "thread") == (1, 256)


@pytest.mark.parametrize("route", chase_kernel.ROUTES)
@pytest.mark.parametrize("cycle", [True, False])
def test_chase_cpu_path_on_a_route_matches_jax(route, cycle):
    """Depth 0, frontiers below, inside and above the shard and one far
    below lo: equal to the JAX oracle and, at a budget that lets every
    chase finish, the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(12 + cycle)
    n_loc, b = 512, 40
    lo = 0 if cycle else 512
    table = (make_chain(n_loc, seed=4) if cycle
             else rng.integers(0, 3 * n_loc, n_loc).astype(np.int32))
    frontier = rng.integers(0, 3 * n_loc, b).astype(np.int32)
    depth = rng.integers(0, 40, b).astype(np.int32)
    frontier[:4], depth[:4] = [lo - 1, lo + n_loc, lo, -(2**31)], [5, 5, 0, 5]
    f, d = chase_shard(torch.from_numpy(table), torch.from_numpy(frontier),
                       torch.from_numpy(depth), torch.tensor([lo], dtype=torch.int32), route=route)
    f_j, d_j = jax_chase_ref(jnp.asarray(table), jnp.asarray(frontier), jnp.asarray(depth), lo,
                             max_hops=int(depth.max()))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    f_p, d_p = pallas_chase_shard(
        jnp.asarray(table), jnp.asarray(frontier), jnp.asarray(depth), lo,
        block=n_loc, hops_per_visit=int(depth.max()), rounds=1, interpret=True,
    )
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_p))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_p))


# ------------------------------------------------------------------- both
@pytest.mark.parametrize("kernel", ["embed_lookup", "chase_shard"])
def test_unknown_route_raises(kernel):
    if kernel == "embed_lookup":
        with pytest.raises(ValueError, match="route"):
            embed_lookup(torch.zeros(8, 4), torch.zeros(3, dtype=torch.int32), 0, route="tma")
    else:
        z = torch.zeros(3, dtype=torch.int32)
        with pytest.raises(ValueError, match="route"):
            chase_shard(torch.zeros(8, dtype=torch.int32), z, z, 0, route="block")


def test_reset_clears_routes_and_items():
    """``reset_launches`` zeroes the launches, the launches by route and
    the ids or chases handed to the card, on every wrapper that has them."""
    embed_lookup.route_launches["bulk"] += 3
    embed_lookup.items += 48
    chase_shard.route_launches["spread"] += 2
    chase_shard.items += 2
    reset_launches()
    assert set(launch_counts().values()) == {0}
    assert embed_lookup.route_launches == dict.fromkeys(embed_kernel.ROUTES, 0)
    assert chase_shard.route_launches == dict.fromkeys(chase_kernel.ROUTES, 0)
    assert embed_lookup.items == chase_shard.items == 0


def test_cpu_calls_launch_nothing():
    """The host path is the plain version: no launch, no route, no item."""
    reset_launches()
    embed_lookup(torch.zeros(8, 4), torch.arange(3, dtype=torch.int32), 0)
    z = torch.zeros(3, dtype=torch.int32)
    chase_shard(torch.zeros(8, dtype=torch.int32), z, z, 0)
    assert embed_lookup.launches == chase_shard.launches == 0
    assert embed_lookup.items == chase_shard.items == 0
