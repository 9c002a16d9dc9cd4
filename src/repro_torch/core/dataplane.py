"""Protocol-selecting data plane: eager / zero-copy / rendezvous RETURNs.

The paper's X-RDMA operations win precisely because bulk data moves
one-sidedly while only *control* travels as injected code (Sec. V: the
pointer chase returns its result with a final PUT).  The framed runtime
ships every RETURN payload inside a header-carrying PUT the receiver must
poll, decode, and re-dispatch — a framing-and-requeue tax that dominates
when the payload is rows, not control words.  This module is the UCX-style
protocol selection (short/eager/rendezvous) that removes it:

``framed``      the RETURN payload travels inside a (coalescable) frame and
                is applied by a requester-side dispatch.  Right for small
                payloads: one ``alpha`` covers a whole coalesced burst.
                Modeled cost: ``alpha + (hdr + n)/beta`` per frame.
``zerocopy``    eager one-sided: the remote PE WRITEs partial rows straight
                into the requester's registered completion slab and bumps a
                doorbell word; the requester discovers completion by polling
                memory, and the requester-side dispatch disappears.
                Modeled cost: ``alpha + (n + 4)/beta`` — no header, no code,
                no requeue.
``rendezvous``  a 16-byte descriptor travels framed; the requester pulls the
                payload with a one-sided GET from a source-registered
                staging region.  Modeled cost: ``alpha + (hdr+16)/beta +
                2*alpha + n/beta`` — the extra round trip amortizes to
                nothing once the payload dwarfs ``2*alpha``, and the eager
                path's receive-side bounce copy (which the wire model does
                not charge, but real NICs do) is avoided entirely.

Selection is sender-side, per RETURN, from the payload size and this
config — the same decision table UCX evaluates per message.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from .frame import RNDV_DESC_NBYTES
from .transport import RegionWrite, WireModel

#: Eager/zero-copy boundary: RETURN payloads at or below this many bytes
#: stay framed (one coalesced alpha covers many of them); above it the
#: payload is written one-sidedly into the completion slab.
DEFAULT_EAGER_MAX = 256

#: Framed-eager/rendezvous boundary, calibrated by benchmarks/wire_model.py:
#: the crossover where a receive-side bounce copy at memcpy bandwidth costs
#: more than the rendezvous round trip (~2*alpha*copy_bandwidth, tens of KB
#: on every calibrated profile — the same order as UCX's default).
DEFAULT_RNDV_MIN = 32 * 1024

#: Receive-side copy bandwidth (bytes/us) charged against eager delivery in
#: the crossover model only: an eager unexpected message lands in a bounce
#: buffer and must be copied out; rendezvous and zero-copy land in place.
COPY_BUS = 10_000.0


@dataclass(frozen=True)
class SlabLayout:
    """Sender-side recipe for the zero-copy path: maps one RETURN action
    payload onto one-sided writes into the requester's registered slab —
    data segments at their slot/position offsets, a doorbell word the
    requester polls, and a generation guard that drops stale writes.

    Built next to the RETURN ifunc's codegen (``make_gather_return`` /
    ``make_return_result``), the single place that knows the slab's row
    layout; the PE runtime stays protocol-generic.
    """

    region: str
    plan: Callable[[np.ndarray], List[RegionWrite]]


@dataclass(frozen=True)
class DataPlaneConfig:
    """Per-PE protocol-selection thresholds (all sizes in payload bytes).

    The default is the pure framed plane (both fast paths disabled), which
    is bit-compatible with the pre-dataplane runtime — benchmarks A/B the
    three modes explicitly via the constructors below.
    """

    eager_max: int = DEFAULT_EAGER_MAX
    rndv_min: int = 1 << 62  # rendezvous disabled unless opted in
    zerocopy: bool = False

    @classmethod
    def framed(cls) -> "DataPlaneConfig":
        """Everything travels in frames (the framed runtime, the A/B base)."""
        return cls(eager_max=1 << 62, rndv_min=1 << 62, zerocopy=False)

    @classmethod
    def zero_copy(cls, eager_max: int = DEFAULT_EAGER_MAX) -> "DataPlaneConfig":
        """Eager frames below ``eager_max``, one-sided slab WRITEs above."""
        return cls(eager_max=eager_max, rndv_min=1 << 62, zerocopy=True)

    @classmethod
    def rendezvous(cls, rndv_min: int = DEFAULT_RNDV_MIN) -> "DataPlaneConfig":
        """Eager frames below ``rndv_min``, descriptor+GET at/above it."""
        return cls(eager_max=1 << 62, rndv_min=rndv_min, zerocopy=False)

    def select(self, nbytes: int, *, slab: bool, code_cached: bool) -> str:
        """Pick the protocol for one RETURN of ``nbytes`` payload bytes.

        ``slab`` — the RETURN type declares a registered-slab layout, so a
        one-sided write knows where the bytes go.  ``code_cached`` — the
        requester already holds the RETURN ifunc's executable; rendezvous
        descriptors cannot carry code, so first contact always goes framed.
        """
        if self.zerocopy and slab and nbytes > self.eager_max:
            return "zerocopy"
        if nbytes >= self.rndv_min and code_cached:
            return "rendezvous"
        return "framed"


# ------------------------------------------------------- modeled cost table
def framed_us(wire: WireModel, nbytes: int, hdr: int = 64, copy: bool = True) -> float:
    """Eager framed delivery of one ``nbytes`` payload: wire latency plus
    (optionally) the receive-side bounce copy real NICs pay for unexpected
    eager messages."""
    t = wire.latency_us(hdr + nbytes)
    if copy:
        t += nbytes / COPY_BUS
    return t


def zerocopy_us(wire: WireModel, nbytes: int) -> float:
    """One-sided WRITE + 4-byte doorbell, landing in place (no copy)."""
    return wire.latency_us(nbytes + 4)


def rendezvous_us(wire: WireModel, nbytes: int, hdr: int = 64) -> float:
    """Framed 16-byte descriptor + one GET round trip, landing in place."""
    return wire.latency_us(hdr + RNDV_DESC_NBYTES) + 2 * wire.alpha_us + nbytes / wire.beta_Bus


def eager_rndv_crossover(wire: WireModel, hdr: int = 64, max_bytes: int = 1 << 22) -> int:
    """Smallest payload size where rendezvous beats framed eager delivery
    (doubling + bisection over the monotone cost difference)."""
    lo, hi = 1, 1
    while hi < max_bytes and framed_us(wire, hi, hdr) <= rendezvous_us(wire, hi, hdr):
        lo, hi = hi, hi * 2
    if hi >= max_bytes:
        return max_bytes
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if framed_us(wire, mid, hdr) <= rendezvous_us(wire, mid, hdr):
            lo = mid
        else:
            hi = mid
    return hi
