"""The port's ``embed_lookup`` against the JAX package's.

On the host the port's wrapper and its custom op take the plain PyTorch
version; it must equal the JAX oracle and the Pallas kernel (interpret
mode) bit for bit — the lookup is pure data movement.  The CUDA kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embed_lookup.kernel import embed_lookup as pallas_embed_lookup
from repro.kernels.embed_lookup.ref import embed_lookup_ref as jax_embed_lookup_ref
from repro_torch.core.bitcode import load_program
from repro_torch.core.xrdma import make_gatherer
from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_op, embed_lookup_ref

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _to_jax(t: torch.Tensor):
    """The same bits as a JAX array (bf16 travels as raw 16-bit words)."""
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16
        )
    return jnp.asarray(t.numpy())


def _table(rng, v_loc, d, dtype):
    """A random table made with numpy, as bf16 or f32 bits both sides share."""
    f32 = rng.normal(0, 1, (v_loc, d)).astype(np.float32)
    t = torch.from_numpy(f32).to(DTYPES[dtype][0])
    return t, _to_jax(t)


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    arr = np.asarray(x)
    return arr.view(np.int16 if arr.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("v_loc,d,n,lo,bt,bv", [
    (256, 8, 64, 256, 32, 64),
    (128, 16, 32, 0, 32, 128),
])
def test_plain_matches_jax_ref_and_pallas(v_loc, d, n, lo, bt, bv, dtype):
    rng = np.random.default_rng(v_loc + n)
    tab_t, tab_j = _table(rng, v_loc, d, dtype)
    ids_np = rng.integers(0, 4 * v_loc, n).astype(np.int32)
    got = embed_lookup(tab_t, torch.from_numpy(ids_np), lo)
    want_ref = jax_embed_lookup_ref(tab_j, jnp.asarray(ids_np), lo)
    want_pallas = pallas_embed_lookup(tab_j, jnp.asarray(ids_np), lo, bt=bt, bv=bv, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want_ref))
    np.testing.assert_array_equal(_bits(got), _bits(want_pallas))


EDGE_IDS = np.array([-1, 31, 32, 35, 36, 47, 48, 100, -1, 33], np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_edge_ids_match_jax(dtype):
    """Pads (-1) and ids below, inside and above the shard."""
    tab_t, tab_j = _table(np.random.default_rng(5), 16, 8, dtype)
    got = embed_lookup(tab_t, torch.from_numpy(EDGE_IDS), 32)
    want = jax_embed_lookup_ref(tab_j, jnp.asarray(EDGE_IDS), 32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_special_bits_survive(dtype):
    """Rows travel as raw bits: a NaN with a payload and -0.0 come out as
    they went in (the JAX oracle quiets a bf16 NaN payload on the host, so
    the expectation is built from the table's own bits)."""
    tab, _ = _table(np.random.default_rng(6), 16, 8, dtype)
    tab[3, 0] = -0.0
    raw = tab.view(torch.int16 if dtype == "bf16" else torch.int32)
    raw[4, 1] = 0x7FC1 if dtype == "bf16" else 0x7FC00123  # NaN with a payload
    got = embed_lookup(tab, torch.from_numpy(EDGE_IDS), 32)
    loc = EDGE_IDS.astype(np.int64) - 32
    inside = (loc >= 0) & (loc < 16)
    want = np.where(inside[:, None], raw.numpy()[np.clip(loc, 0, 15)], 0)
    np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_custom_op_cpu_dispatch_is_plain(dtype):
    rng = np.random.default_rng(7)
    tab, _ = _table(rng, 64, 8, dtype)
    ids = torch.from_numpy(rng.integers(-1, 200, 40).astype(np.int32))
    lo = torch.tensor(64, dtype=torch.int32)
    got = embed_lookup_op(tab, ids, lo)
    np.testing.assert_array_equal(_bits(got), _bits(embed_lookup_ref(tab, ids, lo)))


def test_vmap_rule_flattens_batch():
    """The vmap rule turns a (B, K) batch of ids into one lookup and equals
    B separate lookups."""
    rng = np.random.default_rng(9)
    tab, _ = _table(rng, 32, 8, "f32")
    ids = torch.from_numpy(rng.integers(-1, 96, (5, 6)).astype(np.int32))
    lo = torch.tensor(32, dtype=torch.int32)
    got = torch.vmap(embed_lookup_op, in_dims=(None, 0, None))(tab, ids, lo)
    want = torch.stack([embed_lookup_ref(tab, row, lo) for row in ids])
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bad", ["int64_ids", "f64_table", "2d_ids"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    tab = torch.zeros(8, 4)
    ids = torch.zeros(3, dtype=torch.int32)
    if bad == "int64_ids":
        ids = ids.long()
    elif bad == "f64_table":
        tab = tab.double()
    else:
        ids = ids.reshape(3, 1)
    with pytest.raises((TypeError, ValueError)):
        embed_lookup(tab, ids, 0)


def test_cuda_slice_carries_the_kernel_op():
    """The Gatherer's cuda-sm90 slice keeps a ``repro_torch::embed_lookup``
    node after save/load; its CPU slices resolve by masked take."""
    ifn = make_gatherer(rows_per_shard=16, n_servers=2, n_keys=4, dim=8)
    assert ifn.fat.triples() == ("cpu-a64fx", "cpu-bf2", "cpu-host", "cuda-sm90")

    def targets(triple):
        ep = load_program(ifn.fat.slices[triple], "cpu")
        return {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}

    assert "repro_torch.embed_lookup.default" in targets("cuda-sm90")
    assert not any("embed_lookup" in t for t in targets("cpu-host"))
