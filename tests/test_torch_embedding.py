"""The port's embedding take on the CPU against the JAX package: rows and
the table's gradient of ``repro_torch.models.embedding.embed_plain``
against ``jax.vjp`` of ``repro.models.embedding.embed_plain`` on the same
numpy table, ids and cotangent.  The forward is ``index_select``'s bits;
the backward sums each row's cotangents in a fixed order (its determinism
on the card is in tests/test_torch_cuda.py).

Tolerance: the forward exactly equal (a take); f32 gradients within 1e-6
(each row a sum of the same f32 terms; XLA may add them in another order);
bf16 gradients on the CPU bit-equal to the cotangents added in the ids'
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.embedding import embed_plain as jax_embed_plain
from repro_torch.models.embedding import embed_plain


def _draw(seed, vocab, dim, shape):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab // 4, shape).astype(np.int32)  # rows repeat
    cot = rng.standard_normal((*shape, dim)).astype(np.float32)
    return table, ids, cot


@pytest.mark.parametrize("shape", [(7,), (3, 40), (2, 4, 9)], ids=lambda s: f"ids{len(s)}d")
def test_take_and_its_gradient_match_jax_f32(shape):
    table, ids, cot = _draw(len(shape), 64, 16, shape)
    want, vjp = jax.vjp(lambda t: jax_embed_plain(t, jnp.asarray(ids)), jnp.asarray(table))
    (want_g,) = vjp(jnp.asarray(cot))
    leaf = torch.from_numpy(table).requires_grad_()
    rows = embed_plain(leaf, torch.from_numpy(ids))
    (got_g,) = torch.autograd.grad(rows, leaf, torch.from_numpy(cot))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


def test_take_in_bf16_gives_index_selects_rows_and_sums_in_index_order():
    """bf16 on the CPU: the rows are index_select's, and each row's gradient
    is its cotangents added in the order of the ids (a bf16 rounding each
    add), the fixed order the backward promises."""
    table, ids, cot = _draw(5, 96, 32, (4, 50))
    tb = torch.from_numpy(table).to(torch.bfloat16)
    cb = torch.from_numpy(cot).to(torch.bfloat16).reshape(-1, 32)
    idt = torch.from_numpy(ids)
    leaf = tb.clone().requires_grad_()
    rows = embed_plain(leaf, idt)
    assert torch.equal(rows, tb.index_select(0, idt.reshape(-1).long()).reshape(4, 50, 32))
    (got,) = torch.autograd.grad(rows, leaf, cb.reshape(4, 50, 32))
    want = torch.zeros(96, 32, dtype=torch.bfloat16)
    for j, i in enumerate(idt.reshape(-1).tolist()):
        want[i] = want[i] + cb[j]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_take_without_grad_is_index_select():
    """With grad off, or a table that needs none, the take is a plain
    ``index_select`` and builds no graph."""
    table, ids, _ = _draw(6, 32, 8, (5, 3))
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    rows = embed_plain(t, i)
    assert rows.grad_fn is None and torch.equal(rows, t.index_select(0, i.reshape(-1).long())
                                                .reshape(5, 3, 8))
    with torch.no_grad():
        assert embed_plain(t.clone().requires_grad_(), i).grad_fn is None
