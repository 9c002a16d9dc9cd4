"""Completion queues: client-side tracking for overlapped X-RDMA ops.

The paper's ifuncs complete by writing into requester memory the requester
polls (ReturnResult + a counter).  This layer generalizes that to *many
overlapped operations* with epoch-tagged slot recycling; see
:class:`CompletionQueue` for the full protocol.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - annotations only
    from .pe import PE


class CompletionQueue:
    """Client-side completion queue for in-flight X-RDMA submissions.

    The paper's ifuncs complete by writing into requester memory the
    requester polls (ReturnResult + a counter).  This layer generalizes
    that to *many overlapped operations*: a results region laid out as
    ``(max_slots, 2 + width)`` int32 rows — ``row[0]`` is the slot's
    arrived-position bitmask (popcount = distinct results arrived, so a
    re-delivered partial RETURN ORs in bits it already set and can never
    complete a slot early), ``row[1]`` its generation tag (epoch),
    ``row[2:]`` its data block — plus a free-list of slots and a future
    per in-flight submission.  RETURN ifuncs
    (e.g. :func:`repro_torch.core.xrdma.make_gather_return`) scatter into a
    slot's block and bump its counter; because each RETURN names its slot,
    completions may arrive *out of order* and interleaved across many
    in-flight gathers, and retire through the batched update-ABI fold in
    one dispatch per poll.  Each allocation bumps the slot's epoch and
    stamps it into every frame of that submission, so a late or
    re-delivered RETURN for a *retired* gather mismatches the recycled
    slot's generation and is dropped by the RETURN code — at-least-once
    delivery cannot corrupt a successor request.  Completion is
    poll-driven: nothing blocks, :meth:`GatherFuture.done` just reads the
    counter the next poll wrote.

    ``shape`` is the logical shape of one slot's data block (e.g.
    ``(n_keys, dim)`` for a gather); ``dtype`` its logical element type —
    the wire/region representation is always int32 (bit-cast, never
    converted, so float rows survive bit-identically).

    The results region doubles as the zero-copy data plane's registered
    slab: under ``DataPlaneConfig.zero_copy`` the remote PE WRITEs partial
    rows straight into the slot's data words and the fabric ORs the
    arrived-position bits into ``row[0]`` as the doorbell, guarded by the
    generation word ``row[1]`` — so ``done()``/``result()`` poll the same
    memory whether results arrived framed, one-sided, or mixed.

    Slot exhaustion is an *admission* signal, not an error:
    :meth:`try_alloc` returns ``None`` when no slot is free (the
    would-block contract :meth:`repro_torch.core.pe.pe.PE.submit` exposes), so a
    saturated queue backpressures new submissions without disturbing the
    in-flight ones.  :meth:`_alloc` keeps the raising contract for callers
    that treat exhaustion as a bug.
    """

    def __init__(
        self,
        pe: "PE",
        shape: tuple[int, ...],
        dtype=np.int32,
        max_slots: int = 64,
        region: str = "cq_results",
    ) -> None:
        self.pe = pe
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        assert self.dtype.itemsize == 4, "slot blocks are int32-word addressed"
        self.width = int(np.prod(self.shape))
        self.max_slots = max_slots
        self.region = region
        pe.register_region(region, np.zeros((max_slots, 2 + self.width), np.int32))
        # the owning PE tracks its queues so a sandbox quarantine can
        # degrade the in-flight futures of a banished digest (older stub
        # PEs in unit tests may lack the registry)
        queues = getattr(pe, "completion_queues", None)
        if queues is not None:
            queues.append(self)
        self._free: deque[int] = deque(range(max_slots))
        self._inflight: dict[int, "GatherFuture"] = {}
        # per-tag (tenant) slot occupancy, for quota-bounded admission:
        # how many in-flight slots each tag currently holds
        self._tag_inflight: dict[str, int] = {}
        self._slot_tag: dict[int, str] = {}
        # deadline clock: advanced by the driving scheduler (one per service
        # tick); futures submitted under reliability expire against it
        self.ticks = 0

    def advance(self, n: int = 1) -> None:
        """Advance the deadline clock (the scheduler's tick, not wall time)."""
        self.ticks += n

    def expired(self) -> list["GatherFuture"]:
        """In-flight futures past their deadline and still incomplete —
        the set the service layer must resubmit or degrade."""
        return [f for f in list(self._inflight.values()) if f.expired()]

    # -- slot lifecycle ----------------------------------------------------
    def try_alloc(
        self, tag: str | None = None, quota: int = 0
    ) -> tuple[int, int] | None:
        """Take a free slot and advance its generation; -> (slot, epoch),
        or ``None`` when every slot is in flight (would-block).

        ``tag``/``quota`` add per-tenant admission control: with a quota
        set, a tag already holding ``quota`` in-flight slots is refused
        (the same would-block ``None``) even while global slots remain —
        one tenant cannot monopolize the completion queue."""
        if tag is not None and quota > 0 and self._tag_inflight.get(tag, 0) >= quota:
            return None
        if not self._free:
            return None
        slot = self._free.popleft()
        if tag is not None:
            self._tag_inflight[tag] = self._tag_inflight.get(tag, 0) + 1
            self._slot_tag[slot] = tag
        arr = self.pe.region(self.region)
        epoch = int(arr[slot, 1]) + 1
        arr[slot, 0] = 0
        arr[slot, 1] = epoch
        arr[slot, 2:] = 0
        # re-register so the device-resident copy the RETURN fold reads is
        # refreshed with the new generation tag
        self.pe.register_region(self.region, arr)
        tracer = getattr(getattr(self.pe, "fabric", None), "tracer", None)
        if tracer is not None:
            ev = {"src": getattr(self.pe, "name", ""), "slot": slot, "epoch": epoch}
            if tag is not None:
                ev["tn"] = tag
            tracer.emit("cq_alloc", **ev)
        return slot, epoch

    def _alloc(self) -> tuple[int, int]:
        """Raising variant of :meth:`try_alloc` (legacy contract)."""
        got = self.try_alloc()
        if got is None:
            raise RuntimeError(
                f"completion queue full ({self.max_slots} slots in flight); "
                "poll and retire futures before submitting more"
            )
        return got

    def _release(self, slot: int) -> None:
        # count/data cleared on next alloc; the epoch stays, so RETURNs
        # still in flight for the retired generation mismatch and drop
        self._inflight.pop(slot, None)
        tag = self._slot_tag.pop(slot, None)
        if tag is not None:
            left = self._tag_inflight.get(tag, 0) - 1
            if left > 0:
                self._tag_inflight[tag] = left
            else:
                self._tag_inflight.pop(tag, None)
        self._free.append(slot)
        tracer = getattr(getattr(self.pe, "fabric", None), "tracer", None)
        if tracer is not None:
            tracer.emit("cq_free", src=getattr(self.pe, "name", ""), slot=slot)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def tag_inflight(self, tag: str) -> int:
        """In-flight slots currently held by ``tag`` (tenant occupancy)."""
        return self._tag_inflight.get(tag, 0)

    def _count(self, slot: int) -> int:
        """Distinct results arrived: popcount of the position bitmask."""
        return bin(int(self.pe.region(self.region)[slot, 0]) & 0xFFFFFFFF).count("1")

    def _data(self, slot: int) -> np.ndarray:
        raw = self.pe.region(self.region)[slot, 2:]
        return raw.view(self.dtype).reshape(self.shape)

    def completed(self) -> list["GatherFuture"]:
        """Every in-flight future whose results have fully arrived."""
        return [f for f in list(self._inflight.values()) if f.done()]


@dataclass
class GatherFuture:
    """Poll-driven handle for one completion-queue submission.

    ``done()`` becomes true once ``expected`` result units have been
    RETURNed into the slot (out-of-order, possibly from several PEs);
    ``result()`` copies the slot's data block out and recycles the slot.
    ``cancel()`` abandons an in-flight submission (failed send, lost
    frame) and recycles the slot — the epoch guard makes that safe even
    if the abandoned gather's RETURNs later arrive.  ``meta`` is caller
    scratch (e.g. the original un-padded key batch).

    Reliability additions: ``submit_tick``/``deadline`` arm expiry against
    the queue's tick clock (``deadline=0`` never expires — the
    pre-reliability contract); ``attempts`` counts service-level
    resubmissions of the same logical request; :meth:`valid_mask` /
    :meth:`result_partial` expose the per-position arrival bitmask so a
    gather whose owner died can degrade to a partial result instead of
    hanging — each position is marked valid iff its RETURN actually
    landed.
    """

    queue: CompletionQueue
    slot: int
    expected: int
    meta: Any = None
    submit_tick: int = 0
    deadline: int = 0  # ticks before expiry; 0 = no deadline
    attempts: int = 0  # service-level resubmissions so far
    code_digest: str = ""  # digest of the submitted ifunc (quarantine sweep)
    poisoned: bool = False  # the submitted code was quarantined mid-flight
    _released: bool = False

    def poison(self) -> None:
        """Mark this future's code quarantined: it reads as expired from
        now on, so the service's recovery sweep degrades it through
        :meth:`result_partial` (partial rows + validity mask) instead of
        waiting for RETURNs that are never coming."""
        self.poisoned = True

    def expired(self) -> bool:
        """Past the deadline with results still missing — or poisoned by a
        sandbox quarantine (never true for a completed or released
        future; absent both, no deadline armed means no expiry)."""
        if self._released or self.done():
            return False
        if self.poisoned:
            return True
        return (
            self.deadline > 0
            and self.queue.ticks - self.submit_tick >= self.deadline
        )

    def valid_mask(self) -> np.ndarray:
        """Per-position arrival mask: ``mask[i]`` is True iff result unit
        ``i`` has been RETURNed into the slot."""
        bits = int(self.queue.pe.region(self.queue.region)[self.slot, 0])
        return np.array(
            [(bits >> i) & 1 == 1 for i in range(self.expected)], bool
        )

    def result_partial(self, release: bool = True) -> "tuple[np.ndarray, np.ndarray]":
        """Degraded completion: whatever arrived, plus the validity mask.
        Positions with ``mask[i] == False`` hold zeros (their owner died
        or their RETURN was lost past recovery) — the loud, attributed
        alternative to hanging forever."""
        if self._released:
            raise RuntimeError("future already consumed")
        mask = self.valid_mask()
        out = self.queue._data(self.slot).copy()
        if release:
            self._released = True
            self.queue._release(self.slot)
        return out, mask

    def done(self) -> bool:
        return not self._released and self.queue._count(self.slot) >= self.expected

    def result(self, release: bool = True) -> np.ndarray:
        if self._released:
            raise RuntimeError("future already consumed")
        if not self.done():
            raise RuntimeError(
                f"slot {self.slot} incomplete: "
                f"{self.queue._count(self.slot)}/{self.expected} results arrived"
            )
        out = self.queue._data(self.slot).copy()
        if release:
            self._released = True
            self.queue._release(self.slot)
        return out

    def cancel(self) -> None:
        """Abandon this submission and recycle its slot (idempotent)."""
        if not self._released:
            self._released = True
            self.queue._release(self.slot)
