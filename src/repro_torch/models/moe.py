"""Mixture-of-Experts: top-k routing with a capacity buffer, and the
expert-parallel dispatch over a :class:`~repro_torch.sharding.mesh.Mesh`.

The counterpart of ``repro.models.moe``.  The layer is the paper's
technique at tensor scale: ship the tokens to the rank that owns their
expert (``a2a``, the Chaser pattern: indices and payloads travel, the
tables stay put), against replicating the experts (``replicated``, the GET
baseline).

* :func:`moe_block_scatter`: the capacity-buffer formulation, one
  process.  Every choice takes a slot of its expert's buffer of
  :func:`moe_capacity` rows, ranked by a cumulative count in choice-major
  order (``idx.reshape(-1)`` of ``(n, topk)``); a choice past the capacity
  is dropped (Switch/GShard): it adds nothing and the residual passes
  through.
* :func:`moe_block_replicated`: every expert over every token,
  gate-masked.
* :func:`moe_block_a2a` and :func:`_moe_eplocal`: the expert-parallel
  dispatch as functions of one rank's blocks on a mesh, as
  :func:`~repro_torch.models.attention.attend_sp` is: the tokens bucketed
  by destination rank and exchanged with ``all_to_all`` over the EP axis,
  or, when the positions cannot split over it (decode), every rank's
  experts over every token and one psum.  With grad on and an operand that
  requires it, their collectives
  are ``repro_torch.sharding.mesh``'s gradient-carrying ones: the
  all_to_all's backward sends the cotangents back, the router (whole on
  every rank, used on the rank's own tokens) sums its gradient over the
  EP axis, and the aux's means stay in the graph.

Dispatch and combine are gathers both ways: the buffer is written with
``index_put`` (its backward a gather) and read by a gather whose backward
writes the cotangent rows back in place (:class:`_Rows`), each dropped
choice pointed at a spare row of zeros, so that every other slot is read
and written once.  No gradient is summed by atomics, so two runs of a train
step give the same bits.  :func:`moe_block_scatter`'s stages run under
profiler ranges (:data:`STAGES`), so that a trace can tell each stage's
kernels from the rest of the model's.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F
from torch.profiler import record_function

if TYPE_CHECKING:
    from ..sharding.mesh import Mesh


# the profiler ranges of moe_block_scatter's stages, in order
STAGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


def moe_capacity(n_tokens: int, n_experts: int, topk: int, factor: float = 1.25) -> int:
    c = int(n_tokens * topk * factor / n_experts)
    return max(8, -(-c // 8) * 8)  # multiple of 8, at least 8


def route(x: torch.Tensor, w_router: torch.Tensor, topk: int):
    """x: (N, D) -> gates (N, k) in x's dtype, idx (N, k), the load-balance
    aux loss (f32).  Logits and softmax in f32; the top k in
    ``jax.lax.top_k``'s order: descending, equal probabilities by the lower
    expert first (a stable sort), since that order ranks the choices in
    their buckets and so decides the drops."""
    return route_logits(x.float() @ w_router.float(), topk, x.dtype)


def route_logits(logits: torch.Tensor, topk: int, dtype: torch.dtype):
    """:func:`route` from the f32 router logits (N, E); gates in ``dtype``."""
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :topk], order[:, :topk]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    onehot = F.one_hot(idx[:, 0], e).float()  # the primary expert
    aux = e * torch.mean(torch.mean(onehot, dim=0) * torch.mean(probs, dim=0))
    return gates.to(dtype), idx, aux


def _bucket_positions(dst: torch.Tensor, n_buckets: int, capacity: int):
    """Rank of each element within its destination bucket (cumsum, no sort).

    dst: (M,) bucket ids.  Returns (slot, keep): slot in
    ``[0, n_buckets * capacity)``, keep False for the overflow drops (whose
    slot is clamped onto their bucket's last)."""
    # the one-hot laid out (B, M), so the count runs along the inner dim
    onehot = (dst[None, :] == torch.arange(n_buckets, device=dst.device)[:, None]).int()
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = ranks.gather(0, dst[None, :])[0].long()
    keep = pos < capacity
    slot = dst * capacity + torch.clamp(pos, max=capacity - 1)
    return slot, keep


def _dispatch(xt: torch.Tensor, dest: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The (n_slots, D) buffer holding token ``t``'s row at ``dest[t, j]``
    for each of its k choices, zeros elsewhere; ``dest`` points a dropped
    choice at the spare row ``n_slots`` (cut off).  The kept slots are
    distinct, so this is the reference's scatter-add onto zeros; its
    backward gathers the buffer's cotangent and sums a token's k rows."""
    n, k = dest.shape
    rows = xt[:, None, :].expand(n, k, xt.shape[1]).reshape(n * k, -1)
    buf = xt.new_zeros((n_slots + 1, xt.shape[1]))
    return buf.index_put((dest.reshape(-1),), rows)[:n_slots]


class _Rows(torch.autograd.Function):
    """``table[idx]`` where no two entries of ``idx`` share a row but the
    last (a spare row of zeros).  The backward writes each cotangent row back
    at its index: no row takes two, so nothing is summed (indexing's own
    backward, ``index_put_`` with ``accumulate``, sorts the indices first),
    and the spare row's cotangent is never used."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows, grad.shape[1]))
        return out.index_put_((idx,), grad), None


def _collect(y_buf: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """(n, k, D): the buffer's row at each choice's slot, zeros for a
    dropped choice (the spare row)."""
    n, k = dest.shape
    y_ext = torch.cat([y_buf, y_buf.new_zeros((1, y_buf.shape[1]))])
    return _Rows.apply(y_ext, dest.reshape(-1)).reshape(n, k, -1)


def expert_ffn(buf: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    """(E, C, D) x per-expert SwiGLU -> (E, C, D); the activation as
    :func:`~repro_torch.models.common.mlp` writes it."""
    h = torch.bmm(buf, wi)
    a = F.silu(h) * torch.bmm(buf, wg)
    return torch.bmm(a, wo)


# --------------------------------------------------------- scatter reference
def moe_block_scatter(
    x: torch.Tensor,  # (B, S, D)
    w_router: torch.Tensor,  # (D, E)
    wi: torch.Tensor,  # (E, D, F)
    wg: torch.Tensor,
    wo: torch.Tensor,  # (E, F, D)
    topk: int,
    capacity_factor: float = 1.25,
):
    """Capacity-buffer dispatch and combine (one process): (y, aux)."""
    b, s, d = x.shape
    e = w_router.shape[-1]
    n = b * s
    xt = x.reshape(n, d)
    with record_function("moe_route"):
        gates, idx, aux = route(xt, w_router, topk)
    with record_function("moe_dispatch"):
        cap = moe_capacity(n, e, topk, capacity_factor)
        slot, keep = _bucket_positions(idx.reshape(-1), e, cap)
        slot, keep = slot.reshape(n, topk), keep.reshape(n, topk)
        dest = torch.where(keep, slot, e * cap)
        buf = _dispatch(xt, dest, e * cap)
    with record_function("moe_experts"):
        y_buf = expert_ffn(buf.reshape(e, cap, d), wi, wg, wo).reshape(e * cap, d)
    with record_function("moe_combine"):
        picked = _collect(y_buf, dest)
        w = gates * keep.to(gates.dtype)
        y = torch.zeros_like(xt)
        for j in range(topk):  # in x's dtype, choice by choice, as the reference sums
            y = y + picked[:, j] * w[:, j, None]
    return y.reshape(b, s, d), aux


# ------------------------------------------------------ replicated baseline
def moe_block_replicated(
    x: torch.Tensor,
    w_router: torch.Tensor,
    wi: torch.Tensor,
    wg: torch.Tensor,
    wo: torch.Tensor,
    topk: int,
):
    """GET-style baseline: all experts over all tokens, gate-masked
    (compute E/topk x the dispatch path's)."""
    b, s, d = x.shape
    n = b * s
    xt = x.reshape(n, d)
    gates, idx, aux = route(xt, w_router, topk)
    e = w_router.shape[-1]
    dense_gates = xt.new_zeros((n, e)).scatter(1, idx, gates)  # a row's experts are distinct
    h = torch.einsum("nd,edf->enf", xt, wi)
    g = torch.einsum("nd,edf->enf", xt, wg)
    y_all = torch.einsum("enf,efd->end", F.silu(h) * g, wo)
    y = torch.einsum("end,ne->nd", y_all, dense_gates)
    return y.reshape(b, s, d), aux


# ----------------------------------------------------- expert parallelism
def moe_block_a2a(
    x: torch.Tensor,  # (B_loc, S, D): this rank's batch rows, every position
    w_router: torch.Tensor,  # (D, E)
    wi: torch.Tensor,  # (E_loc, D, F): this rank's experts along ep_axis
    wg: torch.Tensor,
    wo: torch.Tensor,  # (E_loc, F, D)
    topk: int,
    mesh: Mesh,
    ep_axis: str = "model",
    capacity_factor: float = 1.25,
):
    """Token dispatch by ``all_to_all`` over the EP axis; one rank's part of
    the reference's shard_map.  ``x`` is this rank's rows of the batch (all
    of them when the data axes do not split it), every position; the
    weights are its ``E / |ep_axis|`` experts, global ids ``me * E_loc``
    on.  When S splits over the axis (``S % m == 0``, ``S >= m``), the rank
    takes its ``S / m`` positions, buckets its tokens' choices by
    destination rank (a capacity ``c_pair`` per source and destination),
    exchanges the ``(m, c_pair, D)`` buckets and their local expert ids
    (``E_loc`` marks an empty slot), runs its experts gate-masked over what
    it received, sends the results back and combines them at the source
    slots.  Returns ``(y, aux)``: y this rank's ``(B_loc, S / m, D)``
    block, aux the mean of the ranks' own aux over the EP axis, then over
    each data axis.  Otherwise it is :func:`_moe_eplocal`, whose y is
    ``(B_loc, S, D)``."""
    from ..sharding.mesh import (
        all_to_all_region, copy_to_region, data_axes, pmean_region, scatter_to_region,
    )

    b, s, d = x.shape
    e = w_router.shape[-1]
    m = mesh.axis_size(ep_axis)
    e_loc = wi.shape[0]
    if e_loc * m != e:
        raise ValueError(f"moe_block_a2a: {e_loc} experts a rank over {m} ranks, want {e}")
    if not (s % m == 0 and s >= m):
        # the positions cannot split over the EP axis (decode, S = 1): eplocal
        return _moe_eplocal(x, w_router, wi, wg, wo, topk, mesh, ep_axis)
    sl = s // m
    n = b * sl
    c_pair = max(8, -(-int(n * topk * capacity_factor / m) // 8) * 8)
    xt = scatter_to_region(x, mesh, ep_axis, dim=1).reshape(n, d)
    w_router = copy_to_region(w_router, mesh, ep_axis)
    gates, idx, aux = route(xt, w_router, topk)
    dst = (idx // e_loc).reshape(-1)  # destination EP rank of each choice
    e_local_id = (idx % e_loc).reshape(-1)
    slot, keep = _bucket_positions(dst, m, c_pair)
    dest = torch.where(keep, slot, m * c_pair).reshape(n, topk)
    send = _dispatch(xt, dest, m * c_pair)
    meta = torch.full((m * c_pair + 1,), e_loc, dtype=torch.int32, device=x.device)
    meta = meta.index_put((dest.reshape(-1),), e_local_id.to(torch.int32))[: m * c_pair]

    recv = all_to_all_region(send.reshape(m, c_pair, d), mesh, ep_axis).reshape(m * c_pair, d)
    meta_r = mesh.all_to_all(meta.reshape(m, c_pair), ep_axis).reshape(m * c_pair)
    y_r = torch.zeros_like(recv)
    for el in range(e_loc):  # local experts, gate-masked over the received tokens
        mask = (meta_r == el)[:, None].to(recv.dtype)
        h = (recv * mask) @ wi[el]
        g = (recv * mask) @ wg[el]
        y_r = y_r + (F.silu(h) * g) @ wo[el] * mask
    back = all_to_all_region(y_r.reshape(m, c_pair, d), mesh, ep_axis).reshape(m * c_pair, d)
    w = (gates * keep.reshape(n, topk).to(gates.dtype)).reshape(n, topk, 1)
    y = torch.sum(_collect(back, dest) * w, dim=1)
    aux = pmean_region(aux, mesh, ep_axis)
    for ax in data_axes(mesh):
        aux = pmean_region(aux, mesh, ax)
    return y.reshape(b, sl, d), aux


def _moe_eplocal(x, w_router, wi, wg, wo, topk: int, mesh: Mesh, ep_axis: str = "model"):
    """Each rank: its ``E_loc`` experts over ALL its tokens, gate-masked,
    one psum of the (N, D) partials over the EP axis; aux the mean of the
    ranks' over the EP axis.  Right for S = 1 decode (the tokens cannot
    split over the EP axis; the compute is tiny).  The tokens and the
    router enter each rank's own experts through ``copy_to_region`` and
    the partials leave through ``reduce_from_region``."""
    from ..sharding.mesh import copy_to_region, pmean_region, reduce_from_region

    b, s, d = x.shape
    e_loc = wi.shape[0]
    n = b * s
    xt = x.reshape(n, d)
    xt, w_router = copy_to_region(xt, mesh, ep_axis), copy_to_region(w_router, mesh, ep_axis)
    gates, idx, aux = route(xt, w_router, topk)
    me = mesh.axis_index(ep_axis)
    y = torch.zeros_like(xt)
    zero = torch.zeros((), dtype=gates.dtype, device=x.device)
    for el in range(e_loc):
        gate_e = torch.sum(torch.where(idx == me * e_loc + el, gates, zero), dim=-1)  # (n,)
        h = xt @ wi[el]
        g = xt @ wg[el]
        y = y + (F.silu(h) * g) @ wo[el] * gate_e[:, None]
    return (reduce_from_region(y, mesh, ep_axis).reshape(b, s, d),
            pmean_region(aux, mesh, ep_axis))


def _experts_cut(recv: torch.Tensor, meta: torch.Tensor, wi, wg, wo, lay) -> torch.Tensor:
    """Each received token (rows of ``recv``, the rank's embed slice)
    through its local expert ``meta`` (``E_loc``: an empty slot, zeros),
    the expert's embed dim cut over ``data``: each token's products with its
    expert's blocks, the hidden (N, 2F) summed over ``data`` in one psum,
    then the output block.  The JAX rank runs every local expert over every
    token gate-masked; a token's own expert gives the same products."""
    f = wi.shape[2]
    rows = [torch.nonzero(meta == el)[:, 0] for el in range(wi.shape[0])]
    hid = recv.new_zeros((recv.shape[0], 2 * f))
    for el, r in enumerate(rows):
        if r.numel():
            x = recv.index_select(0, r)
            hid[r] = torch.cat([x @ wi[el], x @ wg[el]], dim=-1)
    hid = lay.sum_data(hid)
    act = F.silu(hid[:, :f]) * hid[:, f:]
    y = recv.new_zeros((recv.shape[0], wo.shape[2]))
    for el, r in enumerate(rows):
        if r.numel():
            y[r] = act.index_select(0, r) @ wo[el]
    return y


def moe_block_serve(x, w_router, wi, wg, wo, topk: int, lay, ep_axis: str = "model",
                    capacity_factor: float = 1.25):
    """:func:`moe_block_a2a` on a serving layout, whose experts' embed dims
    are cut over ``data`` too: ``x`` (B, S, D / dn) every row's embed slice
    (the serving residual stream), ``w_router`` (D / dn, E), ``wi`` and
    ``wg`` (E_loc, D / dn, F), ``wo`` (E_loc, F, D / dn).  The router logits
    are summed over ``data``, so every data rank routes every row alike.
    Where S splits over the EP axis, the rank routes its S / m positions of
    each data rank's rows and buckets each data rank's choices by
    destination with that rank's capacity, as the reference's source ranks
    do (``c_pair`` from B / dn x S / m tokens), exchanges its embed slice of
    every data rank's buckets over the EP axis, runs its experts with the
    hidden summed over ``data`` (:func:`_experts_cut`), sends them back,
    combines and gathers the positions.  Otherwise (decode) it is the
    eplocal path: every local expert over every token, gate-masked, the
    hidden summed over ``data`` and the output over the EP axis.  No
    weight moves.  Returns ``(y, aux)``: y (B, S, D / dn), aux the mean of
    the sources' aux over the EP axis and the data ranks."""
    mesh = lay.mesh
    b, s, d = x.shape
    e = w_router.shape[-1]
    m = mesh.axis_size(ep_axis)
    e_loc = wi.shape[0]
    if e_loc * m != e:
        raise ValueError(f"moe_block_serve: {e_loc} experts a rank over {m} ranks, want {e}")
    if not (s % m == 0 and s >= m):  # eplocal
        xt = x.reshape(b * s, d)
        gates, idx, aux = route_logits(lay.sum_data(xt.float() @ w_router.float()), topk,
                                       x.dtype)
        me = mesh.axis_index(ep_axis)
        zero = torch.zeros((), dtype=gates.dtype, device=x.device)
        f = wi.shape[2]
        hid = lay.sum_data(torch.cat([torch.cat([xt @ wi[el], xt @ wg[el]], dim=-1)
                                      for el in range(e_loc)], dim=-1))
        y = torch.zeros_like(xt)
        for el in range(e_loc):
            gate_e = torch.sum(torch.where(idx == me * e_loc + el, gates, zero), dim=-1)
            h = hid[:, 2 * f * el : 2 * f * el + 2 * f]
            y = y + (F.silu(h[:, :f]) * h[:, f:]) @ wo[el] * gate_e[:, None]
        return lay.sum_model(y).reshape(b, s, d), mesh.psum(aux, ep_axis) / m
    sl = s // m
    groups = lay.dn if lay.row_split(b) else 1  # the data ranks whose rows are sources
    n = b // groups * sl
    c_pair = max(8, -(-int(n * topk * capacity_factor / m) // 8) * 8)
    xs = lay.model_block(x, dim=1)  # this rank's positions of every row
    logits = lay.sum_data(xs.reshape(b * sl, d).float() @ w_router.float())
    sends, metas, dests, weights, auxes = [], [], [], [], []
    for g in range(groups):
        xt = xs[g * (b // groups) : (g + 1) * (b // groups)].reshape(n, d)
        gates, idx, aux = route_logits(logits[g * n : (g + 1) * n], topk, x.dtype)
        dst = (idx // e_loc).reshape(-1)
        slot, keep = _bucket_positions(dst, m, c_pair)
        dest = torch.where(keep, slot, m * c_pair).reshape(n, topk)
        sends.append(_dispatch(xt, dest, m * c_pair))
        meta = torch.full((m * c_pair + 1,), e_loc, dtype=torch.int32, device=x.device)
        metas.append(meta.index_put((dest.reshape(-1),),
                                    (idx % e_loc).reshape(-1).to(torch.int32))[: m * c_pair])
        dests.append(dest)
        weights.append((gates * keep.reshape(n, topk).to(gates.dtype)).reshape(n, topk, 1))
        auxes.append(aux)
    recv = mesh.all_to_all(torch.stack(sends).reshape(groups, m, c_pair, d), ep_axis,
                           split_dim=1, concat_dim=1)
    meta_r = mesh.all_to_all(torch.stack(metas).reshape(groups, m, c_pair), ep_axis,
                             split_dim=1, concat_dim=1)
    y_r = _experts_cut(recv.reshape(-1, d), meta_r.reshape(-1), wi, wg, wo, lay)
    back = mesh.all_to_all(y_r.reshape(groups, m, c_pair, d), ep_axis, split_dim=1,
                           concat_dim=1).reshape(groups, m * c_pair, d)
    y = torch.cat([torch.sum(_collect(back[g], dests[g]) * weights[g], dim=1)
                   for g in range(groups)])
    aux = mesh.psum(torch.stack(auxes).mean(), ep_axis) / m
    return lay.gather_model(y.reshape(b, sl, d), dim=1), aux


def moe_block(x, w_router, wi, wg, wo, topk: int, mode: str = "c2d", mesh: Mesh | None = None):
    """The reference's switch: ``replicated`` runs every expert over every
    token; ``c2d`` with a mesh that has a ``model`` axis dividing the
    experts dispatches by ``all_to_all`` (the weights then this rank's
    experts), else the capacity-buffer scatter."""
    e = w_router.shape[-1]
    if mode == "replicated":
        return moe_block_replicated(x, w_router, wi, wg, wo, topk)
    if (mode == "c2d" and mesh is not None and "model" in mesh.names
            and e % mesh.shape["model"] == 0):
        return moe_block_a2a(x, w_router, wi, wg, wo, topk, mesh)
    return moe_block_scatter(x, w_router, wi, wg, wo, topk)
