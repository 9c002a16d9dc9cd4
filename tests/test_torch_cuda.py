"""The hand-written kernels on the card, against their plain versions.

Marked ``cuda``: skipped on a host without a Hopper card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of JAX, so it runs where only the port is
installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.embed_lookup import embed_lookup, embed_lookup_op, embed_lookup_ref

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
