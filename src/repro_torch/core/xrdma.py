"""X-RDMA operations: Chaser, ReturnResult, TSI, Spawner, and the Gatherer
with its RETURN (paper Secs. IV-B/IV-C).

An X-RDMA operation is an ifunc whose arrival *executes user code next to
the data*, and whose code may re-inject itself (FORWARD), answer the
requester (RETURN via ReturnResult), or generate new code (SPAWN).  The decision logic lives
in the shipped code; see :mod:`repro_torch.core.pe.exec` for the fixed
action ABI.

All integer state is int32, as in the JAX package, so payloads, action rows
and completion-queue words are byte-identical across the two.  Entry bodies
create no tensor on a device of their own: constants derive from the
inputs (``*_like``, ``new_*``), so a slice traced on the host runs on the
card once loaded there.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np
import torch

from ..kernels.chase import chase_shard_op
from ..kernels.embed_lookup import embed_lookup_op
from .bitcode import ShapeDtypeStruct
from .dataplane import SlabLayout
from .frame import FrameKind
from .pe import ACTION_WIDTH, A_FORWARD, A_NOP, A_RETURN, A_SPAWN, IFunc
from .transport import RegionWrite

I32 = torch.int32
CHASER_PAYLOAD = 4  # [addr, depth, requester, slot]
GATHER_HDR = 3  # [requester, slot, epoch] routing header (PE.submit convention)
DEFAULT_TARGETS = ("cpu-host", "cpu-bf2", "cpu-a64fx", "cuda-sm90")


def _vec(like: torch.Tensor, *slots) -> torch.Tensor:
    """Build a padded i32 action vector from (action, dst, plen, payload...).

    One stack of 0-d tensors: every int slot becomes ``one * value`` with
    ``one`` derived from ``like`` (a 0-d i32 input), so the trace creates no
    constant on a device of its own and the slice runs wherever it loads.
    """
    one = torch.ones_like(like)
    vals = [s if isinstance(s, torch.Tensor) else one * s for s in slots]
    zero = one * 0
    return torch.stack([*vals, *([zero] * (ACTION_WIDTH - len(slots)))])


# ------------------------------------------------------------------ Chaser
def chaser_entry(
    payload: torch.Tensor, shard: torch.Tensor, meta: torch.Tensor
) -> torch.Tensor:
    """One X-RDMA Chaser hop (paper Sec. IV-C).

    Chase locally until the chase completes or the frontier leaves this
    shard — the paper's in-process recursive call, here one call of the
    ``repro_torch::chase_shard`` custom op (the hand-written kernel on the
    card, its plain version on the host; under a batched dispatch its vmap
    rule runs every Chaser of the group in one launch) — then RETURN the
    result to the requester or FORWARD *this same code* to the owner of
    the next entry.
    """
    addr0, depth0, requester, slot = payload[0], payload[1], payload[2], payload[3]
    shard_id, shard_size = meta[0], meta[1]
    base = shard_id * shard_size
    f, d = chase_shard_op(shard, addr0[None], depth0[None], base.reshape(1))
    addr, depth = f[0], d[0]
    done = depth == 0
    ret = _vec(addr, A_RETURN, requester, 2, slot, addr)
    fwd = _vec(addr, A_FORWARD, addr // shard_size, 4, addr, depth, requester, slot)
    return torch.where(done, ret, fwd)


def make_chaser(
    shard_size: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "chaser",
) -> IFunc:
    return IFunc.build(
        name=name,
        fn=chaser_entry,
        payload_aval=ShapeDtypeStruct((CHASER_PAYLOAD,), I32),
        dep_avals=(
            ShapeDtypeStruct((shard_size,), I32),
            ShapeDtypeStruct((3,), I32),
        ),
        deps=("region:table_shard", "cap:shard_meta", "returns:return_result"),
        abi="xrdma",
        targets=targets,
        kind=kind,
    )


# ------------------------------------------------------------ ReturnResult
def return_result_entry(payload: torch.Tensor, results: torch.Tensor) -> torch.Tensor:
    """Write ``value`` into the requester's result slot and bump the
    completion counter (last element)."""
    # index_put, not results[slot] = ...: a tensor index traced as .item()
    # would synchronise the card on every fold
    out = results.index_put((payload[:1],), payload[1:2])
    return torch.cat([out[:-1], out[-1:] + 1])


def _chase_slab(max_slots: int, region: str = "results") -> SlabLayout:
    """Zero-copy layout of the chase result buffer: one i32 word per slot
    plus the completion counter at the end.  A RETURN payload ``[slot,
    value]`` becomes one 4-byte WRITE at ``slot*4`` whose doorbell
    FETCH_ADDs the counter word — the paper's 'final PUT' verbatim."""

    def plan(pay: np.ndarray) -> list[RegionWrite]:
        slot, value = int(pay[0]), int(pay[1])
        return [
            RegionWrite(
                region,
                slot * 4,
                struct.pack("<i", value),
                doorbell=(max_slots * 4, 1, "add"),
            )
        ]

    return SlabLayout(region=region, plan=plan)


def make_return_result(
    max_slots: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
) -> IFunc:
    return IFunc.build(
        name="return_result",
        fn=return_result_entry,
        payload_aval=ShapeDtypeStruct((2,), I32),
        dep_avals=(ShapeDtypeStruct((max_slots + 1,), I32),),
        deps=("region:results",),
        abi="update",
        targets=targets,
        kind=kind,
        slab=_chase_slab(max_slots),
    )


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


# --------------------------------------------------------------------- TSI
def tsi_entry(payload: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Target-Side Increment (paper Sec. IV-B): counter += payload[0]."""
    return counter + payload[0]


def make_tsi(
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "tsi",
) -> IFunc:
    return IFunc.build(
        name=name,
        fn=tsi_entry,
        payload_aval=ShapeDtypeStruct((1,), I32),
        dep_avals=(ShapeDtypeStruct((1,), I32),),
        deps=("region:counter",),
        abi="update",
        targets=targets,
        kind=kind,
    )


# ------------------------------------------------------------------- Spawn
def spawner_entry(payload: torch.Tensor) -> torch.Tensor:
    """Demo of 'injected code generating new code' (paper Sec. I): arrival
    spawns a TSI ifunc at peer ``payload[0]`` with increment ``payload[1]``."""
    return _vec(payload[0], A_SPAWN, payload[0], 1, payload[1])


def make_spawner(targets: Sequence[str] = DEFAULT_TARGETS) -> IFunc:
    return IFunc.build(
        name="spawner",
        fn=spawner_entry,
        payload_aval=ShapeDtypeStruct((2,), I32),
        deps=("spawn:tsi",),
        abi="xrdma",
        targets=targets,
    )
