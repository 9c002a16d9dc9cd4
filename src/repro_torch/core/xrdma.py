"""X-RDMA operations: Chaser, ReturnResult, TSI, Spawner, the Gatherer and
the Filter with their RETURNs, and the Reducer and Gossiper that ride the
propagation tree (paper Secs. I, IV-B/IV-C).

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
from .pe import (
    ACTION_WIDTH, A_DONE, A_FORWARD, A_NOP, A_PUBLISH, A_RETURN, A_SPAWN, IFunc,
)
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


# ----------------------------------------------------------------- Filter
FILTER_HDR = GATHER_HDR + 2  # [requester, slot, epoch, lo, thresh_bits]


def _f32_key(bits: torch.Tensor) -> torch.Tensor:
    """Map f32 bit patterns (held as i32) to i32 keys that order as the
    floats do: a pattern with the sign bit clear is its own key, one with
    it set is minus its magnitude bits.  So ``key(a) > key(b)`` is ``a > b``
    for every pair of non-NaN floats, +0 and -0 alike (both key 0), and
    subnormals compare by value.

    The Filter compares in this integer domain because its threshold
    travels as i32 bits inside a per-payload (so, under a batched dispatch,
    batched) scalar, and ``view(dtype)`` has no vmap rule on the card's
    torch (2.11 on the H100 raises "Batching rule not implemented for
    aten::view.dtype"; ROADMAP T3) — unlike the Gatherer, there is no
    shared tensor to take the view on."""
    return torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))


def _f32_nan(bits: torch.Tensor) -> torch.Tensor:
    """Which f32 bit patterns (as i32) are NaNs: all-ones exponent, nonzero
    mantissa.  ``>`` is false for a NaN on either side."""
    return (bits & 0x7FFFFFFF) > 0x7F800000


def _arange_like(x: torch.Tensor, n: int) -> torch.Tensor:
    """``arange(n)`` in i32 derived from the 0-d i32 input ``x``, so the
    traced graph creates no tensor on a device of its own."""
    return torch.cumsum(torch.ones_like(x)[None].expand(n), 0, dtype=I32) - 1


def make_filter(
    rows_per_shard: int,
    n_servers: int,
    window: int,
    dim: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "filter",
    returns: str = "filter_return",
) -> IFunc:
    """The DPU predicate-pushdown op: filter a contiguous row window *next
    to the shard* and RETURN only the survivors.

    Payload ``[requester, slot, epoch, lo, thresh_bits]``: scan the
    ``window`` rows at global offset ``lo`` (the service aligns windows
    inside one shard), keep rows whose first column exceeds the f32
    threshold (``thresh_bits`` travels bit-cast through the i32 payload),
    and emit ONE ragged RETURN row::

        [slot, epoch, evalmask, spos(W), rows(nsurv*D)]

    with ``plen = 3 + W + nsurv*D`` — the action row's self-describing
    ``plen`` means only the survivor rows cross the wire, which is the
    whole point of pushdown: wire payload bytes scale with selectivity,
    not with the window.  ``spos`` carries the survivors' window
    positions packed to the front (-1 beyond ``nsurv``); ``evalmask`` is
    the full window bitmask, so completion fires after one RETURN even
    when *nothing* survives.  Dropped positions read as zeros at the
    requester (CQ slots are zeroed at alloc), matching the masked oracle
    ``where(pred, rows, 0)``.

    The window is resolved as the rows' i32 bit patterns (the view taken on
    the shared shard, as the Gatherer does) and compared in the integer
    domain (:func:`_f32_key`, NaN masked by :func:`_f32_nan`): IEEE ``>``
    exactly, NaN included.  The survivors are packed by their rank (a
    cumulative sum of the mask) through a one-hot of rank against position
    and one ``gather`` — no sort, no tensor index, no host sync; ``plen``
    stays a tensor.

    Per-ISA slices via ``fn_by_platform`` (paper Fig. 3): the default body
    resolves the window as a slice whose start is clamped into the shard
    (the reference's ``dynamic_slice``), the DPU (``cpu-bf2``) slice ships
    a masked-take body, and the ``cuda-sm90`` slice resolves the window
    ``lo + arange(W)`` through the hand-written ``embed_lookup`` kernel
    (``repro_torch::embed_lookup``): one launch per dispatch, and one per
    batched group through the op's vmap rule.  On an aligned window every
    slice computes identical survivors.
    """
    W, D = window, dim
    if W > 31:
        raise ValueError("window > 31 would overflow the i32 position bitmask")
    evalmask = (1 << W) - 1
    ret_hdr = 3  # [slot, epoch, evalmask]

    def entry_with(resolve):
        def entry(payload: torch.Tensor, shard: torch.Tensor, meta: torch.Tensor):
            requester, slot, epoch = payload[0], payload[1], payload[2]
            lo, tbits = payload[3], payload[4]
            shard_id, rows_per = meta[0], meta[1]
            base = shard_id * rows_per
            ar = _arange_like(lo, W)
            rows = resolve(shard.view(I32), lo + ar, base)  # (W, D) f32 bits
            col = rows[:, 0]
            passed = (
                (_f32_key(col) > _f32_key(tbits)) & ~_f32_nan(col) & ~_f32_nan(tbits)
            )
            nsurv = passed.sum(dtype=I32)
            rank = torch.cumsum(passed, 0, dtype=I32) - 1
            # order[j]: the window position of the j-th survivor (0 past nsurv)
            onehot = passed[None, :] & (rank[None, :] == ar[:, None])
            order = torch.where(onehot, ar[None, :], 0).sum(1, dtype=I32)
            packed = ar < nsurv
            spos = torch.where(packed, order, -1)
            srows = rows.gather(0, order[:, None].expand(W, D))
            irows = torch.where(packed[:, None], srows, 0).reshape(-1)
            one = torch.ones_like(nsurv)
            plen = ret_hdr + W + nsurv * D  # ragged: survivors only
            return torch.cat([
                torch.stack([one * A_RETURN, requester, plen]),
                torch.stack([slot, epoch, one * evalmask]),
                spos,
                irows,
            ])  # one self-describing action row of 3 + 3 + W + W*D words

        return entry

    def sliced_resolve(shard, keys, base):
        # the reference's dynamic_slice: the start clamped into the shard
        start = (keys[0] - base).clamp(0, max(rows_per_shard - W, 0))
        return shard.index_select(0, start + (keys - keys[0]))

    return IFunc.build(
        name=name,
        fn=entry_with(sliced_resolve),
        payload_aval=ShapeDtypeStruct((FILTER_HDR,), I32),
        dep_avals=(
            ShapeDtypeStruct((rows_per_shard, D), torch.float32),
            ShapeDtypeStruct((3,), I32),
        ),
        deps=("region:embed_shard", "cap:gather_meta", f"returns:{returns}"),
        abi="xrdma",
        targets=targets,
        kind=kind,
        fn_by_platform={
            "cpu-bf2": entry_with(_take_rows),
            "cuda": entry_with(_kernel_rows),
        },
    )


def _filter_slab(window: int, dim: int, region: str = "cq_results") -> SlabLayout:
    """Zero-copy layout of a Filter RETURN over the gather CQ slot row
    ``[posmask, epoch, data(W*D)]``: survivor rows become contiguous-run
    WRITE segments at their window-position offsets and the doorbell ORs
    the *evalmask* (whole window observed) — so the chain stays
    proportional to survivors while completion still fires, even with an
    empty survivor set (doorbell-only write).  Ragged-aware: the payload
    the sender hands over carries ``3 + W + nsurv*D`` words."""
    W, D = window, dim
    stride = (2 + W * D) * 4  # slot row bytes

    def plan(pay: np.ndarray) -> list[RegionWrite]:
        slot, epoch, evalmask = int(pay[0]), int(pay[1]), int(pay[2])
        spos = pay[3 : 3 + W]
        nsurv = int(np.sum(spos >= 0))
        rows = pay[3 + W : 3 + W + nsurv * D].reshape(nsurv, D)
        base = slot * stride
        guard = (base + 4, epoch)
        writes = []
        if nsurv:
            pos = spos[:nsurv].astype(np.int64)
            # survivors are packed; split only on window-position gaps
            breaks = np.where(np.diff(pos) != 1)[0] + 1
            for run in np.split(np.arange(nsurv), breaks):
                i0, i1 = int(run[0]), int(run[-1])
                writes.append(
                    RegionWrite(
                        region,
                        base + (2 + int(pos[i0]) * D) * 4,
                        rows[i0 : i1 + 1].tobytes(),
                        guard=guard,
                    )
                )
        if writes:
            last = writes[-1]
            writes[-1] = RegionWrite(
                last.region, last.offset, last.data,
                doorbell=(base, evalmask, "or"), guard=guard,
            )
        else:
            # nothing survived: the doorbell alone completes the window
            writes.append(
                RegionWrite(
                    region, base, b"", doorbell=(base, evalmask, "or"), guard=guard
                )
            )
        return writes

    return SlabLayout(region=region, plan=plan)


def make_filter_return(
    max_slots: int,
    window: int,
    dim: int,
    region: str = "cq_results",
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "filter_return",
) -> IFunc:
    """Fold one Filter RETURN into the requester's completion queue.

    Same idempotent position-scatter discipline as ``gather_return`` —
    OR the arrived bits, scatter rows by position (out-of-window positions
    dropped), drop stale-epoch returns whole — with two filter-specific
    twists.  The bits come from the payload's ``evalmask`` word: the whole
    window was *observed* even where nothing survived (unobserved is
    different from empty), so one RETURN completes the window regardless
    of the survivor count.  And the payload is **ragged**: only ``nsurv``
    rows travel behind the always-full ``spos`` vector, and the
    ``ragged:zeros`` dep tag tells the exec layer to zero-extend to the
    declared aval — safe because the ``-1`` sentinels in ``spos`` arrive
    intact and mask off exactly the zero-padded row slots.

    Region row layout: ``[posmask, epoch, data(W*D)]``."""
    W, D = window, dim
    if W > 31:
        raise ValueError("window > 31 would overflow the i32 position bitmask")

    def entry(payload: torch.Tensor, results: torch.Tensor) -> torch.Tensor:
        epoch, evalmask = payload[1], payload[2]  # payload[0] = slot
        spos = payload[3 : 3 + W]
        rows = payload[3 + W :].reshape(W, D)
        # index_select, not results[slot]: a tensor index traced as .item()
        # would synchronise the card on every fold
        cur = results.index_select(0, payload[:1])[0]
        live = cur[1] == epoch  # stale-generation RETURNs drop whole
        valid = (spos >= 0) & (spos < W)  # packed survivor prefix; -1 beyond
        # scatter into a spare row W, which stands for "dropped"
        safe = torch.where(valid, spos, W)
        block = cur[2:].reshape(W, D)
        block = torch.cat([block, block[:1]]).index_put((safe,), rows)[:W]
        newrow = torch.cat([(cur[0] | evalmask)[None], cur[1][None], block.reshape(-1)])
        keep = torch.where(live, newrow, cur)
        return results.index_put((payload[:1],), keep[None])

    return IFunc.build(
        name=name,
        fn=entry,
        payload_aval=ShapeDtypeStruct((3 + W + W * D,), I32),
        dep_avals=(ShapeDtypeStruct((max_slots, 2 + W * D), I32),),
        deps=(f"region:{region}", "ragged:zeros"),
        abi="update",
        targets=targets,
        kind=kind,
        slab=_filter_slab(window, dim, region),
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


# ------------------------------------------------------------------ Reduce
def make_reducer(
    width: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    kind: FrameKind = FrameKind.BITCODE,
    name: str = "reducer",
) -> IFunc:
    """The multi-hop X-RDMA reduction op (one node's step of
    :func:`repro_torch.sharding.collectives.xrdma_reduce`).

    Propagate-ABI: every invocation folds one contribution into this PE's
    ``reduce_acc`` region — ``[count, acc(width)]`` — and emits at most one
    action row.  Payload ``[count, value(width)]``:

    * ``count == 0`` is the broadcast *seed* (delivered by the tree
      publish): fold this PE's own ``reduce_src`` contribution, count 1.
    * ``count > 0`` is a child subtree's partial: fold ``value``, count
      the subtree's nodes.

    When the fold's count reaches the subtree size in ``reduce_meta``
    (``[expected, parent, is_root]``), the completing invocation FORWARDs
    the folded partial — this same ifunc, code and all — to the tree
    parent; at the root it emits DONE with the cluster-wide result.  Under
    the batched runtime several children's partials fold in one dispatch
    (the code cache's propagate fold, in payload order) and only the row
    that completes the subtree carries the upward FORWARD — the fold's
    sequential carry is exactly the fold-before-forward the tree needs.

    At-least-once caveat: seed delivery is deduplicated by the publish
    layer, but a *duplicated child partial* would double-fold and overshoot
    ``expected`` — the count then never equals it and the reduction
    surfaces as an idle timeout (loud containment), matching the paper's
    reliable-connection transport assumption for RETURN traffic.
    """
    W = width

    def entry(payload, acc, src, meta):
        count, val = payload[0], payload[1:]
        seed = count == 0
        one = torch.ones_like(count)
        new_cnt = acc[0] + torch.where(seed, one, count)
        new_val = acc[1:] + torch.where(seed, src, val)
        expected, parent, is_root = meta[0], meta[1], meta[2]
        done = new_cnt == expected
        action = torch.where(
            done, torch.where(is_root > 0, one * A_DONE, one * A_FORWARD), one * A_NOP
        )
        dst = torch.where(done & (is_root == 0), parent, one * 0)
        plen = torch.where(done, one * (1 + W), one * 0)
        new_acc = torch.cat([new_cnt[None], new_val])
        row = torch.cat([torch.stack([action, dst, plen]), new_acc])
        return new_acc, row

    return IFunc.build(
        name=name,
        fn=entry,
        payload_aval=ShapeDtypeStruct((1 + W,), I32),
        dep_avals=(
            ShapeDtypeStruct((1 + W,), I32),
            ShapeDtypeStruct((W,), I32),
            ShapeDtypeStruct((3,), I32),
        ),
        deps=("region:reduce_acc", "region:reduce_src", "cap:reduce_meta"),
        abi="propagate",
        targets=targets,
        kind=kind,
    )


# ------------------------------------------------------------------ Gossip
def make_gossiper(
    targets: Sequence[str] = DEFAULT_TARGETS,
    name: str = "gossiper",
) -> IFunc:
    """Injected code that re-publishes *itself* (paper Sec. I, literally).

    Payload ``[hops_left, value]``; deps ``region:gossip_log`` (``[visits,
    sum]``) and ``cap:gossip_meta`` (``[my_index, n_peers]``).  Each
    arrival logs itself locally and, while ``hops_left > 0``, emits
    ``A_PUBLISH`` to the next peer on the ring — the *code* decides where
    its next copy goes; the runtime only carries it.  Hop budget 1 per
    publish, so the tree layer never fans this out: the recursion is
    entirely the ifunc's own.
    """

    def entry(payload, log, meta):
        hops, value = payload[0], payload[1]
        me, n = meta[0], meta[1]
        new_log = torch.stack([log[0] + 1, log[1] + value])
        nxt = torch.where(me + 1 >= n, me * 0, me + 1)
        row = torch.where(
            hops > 0,
            _vec(hops, A_PUBLISH, nxt, 3, 1, hops - 1, value),
            _vec(hops, A_NOP, 0, 0),
        )
        return new_log, row

    return IFunc.build(
        name=name,
        fn=entry,
        payload_aval=ShapeDtypeStruct((2,), I32),
        dep_avals=(
            ShapeDtypeStruct((2,), I32),
            ShapeDtypeStruct((2,), I32),
        ),
        deps=("region:gossip_log", "cap:gossip_meta"),
        abi="propagate",
        targets=targets,
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
