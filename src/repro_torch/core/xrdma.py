"""X-RDMA operations: the Gatherer and its RETURN (paper Secs. IV-B/IV-C).

An X-RDMA operation is an ifunc whose arrival *executes user code next to
the data*, and whose code may re-inject itself (FORWARD), answer the
requester (RETURN), or generate new code (SPAWN).  The decision logic lives
in the shipped code; see :mod:`repro_torch.core.pe.exec` for the fixed
action ABI.

All integer state is int32, as in the JAX package, so payloads, action rows
and completion-queue words are byte-identical across the two.  Entry bodies
create no tensor on a device of their own: constants derive from the
inputs (``*_like``, ``new_*``), so a slice traced on the host runs on the
card once loaded there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels.embed_lookup import embed_lookup_op
from .bitcode import ShapeDtypeStruct
from .dataplane import SlabLayout
from .frame import FrameKind
from .pe import A_FORWARD, A_NOP, A_RETURN, IFunc
from .transport import RegionWrite

I32 = torch.int32
GATHER_HDR = 3  # [requester, slot, epoch] routing header (PE.submit convention)
DEFAULT_TARGETS = ("cpu-host", "cpu-bf2", "cpu-a64fx", "cuda-sm90")


# ----------------------------------------------------------------- Gather
def _take_rows(shard: torch.Tensor, keys: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Masked-take local resolution: rows for keys inside [lo, lo+V_loc),
    zeros elsewhere (the plain semantics of kernels.embed_lookup)."""
    v_loc = shard.shape[0]
    loc = keys - lo
    inside = (loc >= 0) & (loc < v_loc)
    rows = shard.index_select(0, loc.clamp(0, v_loc - 1))
    return torch.where(inside[:, None], rows, 0)


def _kernel_rows(shard: torch.Tensor, keys: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The ``cuda-sm90`` resolver: the hand-written row-gather kernel.  The
    slice records it by its custom op name (``repro_torch::embed_lookup``),
    resolved on the target when the slice loads."""
    return embed_lookup_op(shard, keys, lo)


def make_gatherer(
    rows_per_shard: int,
    n_servers: int,
    n_keys: int,
    dim: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "gatherer",
    returns: str = "gather_return",
) -> IFunc:
    """The X-RDMA Gather op: one hop of a sharded embedding/KV-row gather.

    Payload (completion-queue convention): ``[requester, slot, epoch,
    key0..key_{K-1}]`` with unused key positions padded to -1.  ``epoch``
    is the slot's generation tag: a late or re-delivered RETURN whose
    epoch no longer matches the slot's is dropped by the RETURN code, so
    slot recycling is safe under at-least-once delivery.  On arrival the
    shipped code

    * resolves the locally-owned subset of the keys against the shard
      region (the CUDA ``embed_lookup`` kernel in the ``cuda-sm90`` slice,
      masked take elsewhere — both produce the identical rows),
    * FORWARDs the unresolved remainder to the owning PE(s), preserving
      each key's *position* so every partial RETURN scatters into the
      right rows of the requester's slot (non-owned positions travel as
      -1), and
    * RETURNs the resolved rows (bit-cast f32->i32, never converted) plus
      their positions and a count to the requester's completion queue.

    One action matrix of ``n_servers + 1`` rows covers every case: row
    ``s`` is the potential FORWARD to server ``s``, the last row the
    partial RETURN; unneeded rows are NOPs.  A request whose keys span
    ``m`` shards costs ``m`` RETURNs and at most ``m`` FORWARDs — network
    actions only on locality breaks, exactly the Chaser's contract.
    """
    K, D, S = n_keys, dim, n_servers
    if K > 31:
        raise ValueError("n_keys > 31 would overflow the i32 position bitmask")
    ret_plen = 3 + K + K * D  # [slot, epoch, nres, pos(K), rows(K*D)]

    def entry_with(resolve):
        def entry(payload: torch.Tensor, shard: torch.Tensor, meta: torch.Tensor):
            requester, slot, epoch = payload[0], payload[1], payload[2]
            keys = payload[GATHER_HDR:]
            shard_id, rows_per = meta[0], meta[1]
            lo = shard_id * rows_per
            loc = keys - lo
            real = keys >= 0
            mine = real & (loc >= 0) & (loc < rows_per)
            # resolve the rows as their i32 bit patterns (bit-cast, never
            # converted): the view is taken on the shard, which a batched
            # dispatch shares, because view.dtype has no vmap batching rule
            rows = resolve(shard.view(I32), keys, lo)  # (K, D), zeros off-shard
            irows = torch.where(mine[:, None], rows, 0).reshape(-1)
            pos = torch.cumsum(torch.ones_like(keys), 0, dtype=I32) - 1
            nres = mine.sum(dtype=I32)
            one = torch.ones_like(nres)
            ret = torch.cat([
                torch.stack([
                    torch.where(nres > 0, one * A_RETURN, one * A_NOP),
                    requester, one * ret_plen, slot, epoch, nres,
                ]),
                torch.where(mine, pos, -1),
                irows,
            ])
            # one potential FORWARD row per peer shard (position-preserving)
            owner = torch.where(real & ~mine, keys // rows_per, -1)
            zpad = torch.zeros_like(irows)
            fwd_rows = []
            for s in range(S):
                take = owner == s
                cnt = take.sum(dtype=I32)
                fwd_rows.append(torch.cat([
                    torch.stack([
                        torch.where(cnt > 0, one * A_FORWARD, one * A_NOP),
                        one * s, one * (GATHER_HDR + K), requester, slot, epoch,
                    ]),
                    torch.where(take, keys, -1),
                    zpad,
                ]))
            return torch.stack([*fwd_rows, ret])  # (S + 1, 3 + ret_plen)

        return entry

    return IFunc.build(
        name=name,
        fn=entry_with(_take_rows),
        payload_aval=ShapeDtypeStruct((GATHER_HDR + K,), I32),
        dep_avals=(
            ShapeDtypeStruct((rows_per_shard, D), torch.float32),
            ShapeDtypeStruct((3,), I32),
        ),
        deps=("region:embed_shard", "cap:gather_meta", f"returns:{returns}"),
        abi="xrdma",
        targets=targets,
        kind=kind,
        fn_by_platform={"cuda": entry_with(_kernel_rows)},
    )


def _gather_slab(n_keys: int, dim: int, region: str = "cq_results") -> SlabLayout:
    """Zero-copy layout of one completion-queue slot: row ``[posmask,
    epoch, data(K*D)]`` of i32 words.  A partial RETURN's resolved rows
    become contiguous-run WRITE segments at their position offsets; the
    doorbell ORs the arrived-position bits into ``posmask`` (idempotent
    under re-delivery, same as the framed fold) and the guard pins the
    slot's generation — a stale write for a retired gather is refused at
    the 'NIC' instead of corrupting the slot's next owner."""
    K, D = n_keys, dim
    stride = (2 + K * D) * 4  # slot row bytes

    def plan(pay: np.ndarray) -> list[RegionWrite]:
        slot, epoch = int(pay[0]), int(pay[1])
        pos = pay[3 : 3 + K]
        rows = pay[3 + K :].reshape(K, D)
        base = slot * stride
        guard = (base + 4, epoch)
        valid = np.flatnonzero(pos >= 0)
        if valid.size == 0:
            return []
        bits = int(np.bitwise_or.reduce(1 << (pos[valid].astype(np.int64))))
        # contiguous (index, position) runs -> one scatter segment each
        breaks = np.where(
            (np.diff(valid) != 1) | (np.diff(pos[valid]) != 1)
        )[0] + 1
        writes = []
        for run in np.split(valid, breaks):
            i0, i1 = int(run[0]), int(run[-1])
            writes.append(
                RegionWrite(
                    region,
                    base + (2 + int(pos[i0]) * D) * 4,
                    rows[i0 : i1 + 1].tobytes(),
                    guard=guard,
                )
            )
        # the doorbell rides the last segment: it fires only after every
        # data word of this partial landed (fenced WQE chain)
        last = writes[-1]
        writes[-1] = RegionWrite(
            last.region, last.offset, last.data,
            doorbell=(base, bits, "or"), guard=guard,
        )
        return writes

    return SlabLayout(region=region, plan=plan)


def make_gather_return(
    max_slots: int,
    n_keys: int,
    dim: int,
    region: str = "cq_results",
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "gather_return",
) -> IFunc:
    """Scatter one partial gather result into the requester's completion
    queue: rows land at their request positions (out-of-order safe, any
    interleaving of slots), and the slot's arrived-position *bitmask* ORs
    in the positions this partial carried.  The bitmask (not a counter)
    is what makes at-least-once delivery safe within a generation: a
    re-delivered partial ORs bits already set and scatters rows already
    written — exactly idempotent — so completion (popcount == expected)
    can never fire early off a duplicate.  A RETURN whose epoch does not
    match the slot's current generation is a late result for a *retired*
    gather — dropped whole, so a recycled slot can never be corrupted by
    stale traffic.  Update-ABI, so a burst of partial returns folds into
    the region in one dispatch under the batched runtime.

    Region row layout: ``[posmask, epoch, data(K*D)]``."""
    K, D = n_keys, dim
    if K > 31:
        raise ValueError("n_keys > 31 would overflow the i32 position bitmask")

    def entry(payload: torch.Tensor, results: torch.Tensor) -> torch.Tensor:
        epoch = payload[1]  # payload[0] = slot, payload[2] = nres (diagnostic)
        pos = payload[3 : 3 + K]
        rows = payload[3 + K :].reshape(K, D)
        # index_select, not results[slot]: a tensor index traced as .item()
        # would synchronise the card on every fold
        cur = results.index_select(0, payload[:1])[0]
        live = cur[1] == epoch  # stale-generation RETURNs drop whole
        valid = pos >= 0
        shifted = torch.bitwise_left_shift(torch.ones_like(pos), pos.clamp(0, 30))
        bits = torch.where(valid, shifted, 0).sum(dtype=I32)
        # scatter into a spare row K, which stands for "dropped"
        safe = torch.where(valid, pos, K)
        block = cur[2:].reshape(K, D)
        block = torch.cat([block, block[:1]]).index_put((safe,), rows)[:K]
        newrow = torch.cat([(cur[0] | bits)[None], cur[1][None], block.reshape(-1)])
        keep = torch.where(live, newrow, cur)
        return results.index_put((payload[:1],), keep[None])

    return IFunc.build(
        name=name,
        fn=entry,
        payload_aval=ShapeDtypeStruct((3 + K + K * D,), I32),
        dep_avals=(ShapeDtypeStruct((max_slots, 2 + K * D), I32),),
        deps=(f"region:{region}",),
        abi="update",
        targets=targets,
        kind=kind,
        slab=_gather_slab(n_keys, dim, region),
    )
