"""Profile-driven autotuning of the runtime knob space.

The runtime grew a real configuration space — batching, the data-plane
thresholds (``eager_max``/``rndv_min``/``zerocopy``), credit windows, poll
budgets, priority lanes, the propagation tree's fanout — all hand-tuned
per calibrated hardware profile.  This module closes the loop the ROADMAP
asked for: **replay a captured trace through the calibrated wire model
under candidate knob settings** (:class:`ReplayModel`), search the
discrete knob grid per hardware profile with deterministic coordinate
descent (:func:`autotune`), and emit a tuned :class:`FlowProfile` that
``Cluster.set_flow(profile=...)`` loads from disk.

The estimator re-derives, from a trace captured under the *default*
runtime (per-message, framed), what the fabric's ``modeled_us`` would be
under a candidate profile:

* **batching** — data sends are regrouped by (src, dst, kind, name,
  payload size, poll cycle): one coalesced frame per group costs one
  ``alpha`` plus the summed bytes, exactly the wire layer's coalesce rule
  (ragged payload sizes refuse to merge, which is why zero-copy can beat
  framed batching on ragged RETURN streams).
* **data plane** — every RETURN (``ret`` event) is re-selected through the
  candidate :class:`DataPlaneConfig`: framed RETURNs join the coalesced
  streams, zero-copy RETURNs join per-(src, dst, cycle) doorbell-batched
  write chains (``alpha + sum(bytes)/beta + (k-1)*o``), rendezvous RETURNs
  cost a framed 16-byte descriptor plus a GET round trip.  The ``zc``
  field captured per RETURN is the counterfactual write-burst size, so the
  re-selection needs no knowledge of the slab layout.
* **placement** — the heterogeneous placement axis (pushdown vs pull) is
  carried as a knob so tuned profiles pin a cluster-wide policy via
  ``Cluster.set_placement``, but it is cost-neutral in the replay (a
  trace captured under one placement has no counterfactual byte stream
  for the other — pricing that flip is
  :class:`repro_torch.sharding.placement.PlacementOptimizer`'s job against the
  live capability registry), so like ``lanes`` the search keeps the
  incumbent.
* **flow knobs** — ``poll_budget`` and ``credit_window`` never reduce
  modeled wire time (they bound memory and latency inversion, not bytes),
  so the estimator charges them honest per-split/per-stall overheads and
  the search keeps them at their defaults unless a future trace kind
  rewards them; ``lanes`` and the tree fanout are cost-neutral on
  reorder-insensitive traces and likewise stay put.

Everything iterates in event order with a seed-pinned knob permutation,
so the same trace + profile + seed yields a bit-identical tuned profile
(tests/test_torch_autotune.py).
"""

from __future__ import annotations

import json
from bisect import bisect_right
from dataclasses import dataclass, field, replace
from typing import Iterable

import numpy as np

from ..core.dataplane import DataPlaneConfig
from ..core.frame import FrameKind
from ..core.propagate import PropagationConfig
from ..core.transport import WIRE_PROFILES, WireModel

from .trace import Trace, TraceError, TraceRecorder, _trace_of

#: ``rndv_min`` value that disables rendezvous (matches the core default).
RNDV_OFF = 1 << 62

#: Fixed header + trailing MAGIC bytes around one frame's name/payload/code
#: sections (mirrors ``core/frame.py``; the estimator only needs the sum).
FRAME_OVERHEAD = 64 + 8

#: The discrete knob grid coordinate descent walks, in declaration order
#: (the search permutes the *knob* order by seed, never the value order).
KNOB_GRID: dict[str, tuple] = {
    "batching": (False, True),
    "zerocopy": (False, True),
    "eager_max": (0, 64, 256, 1024, 4096),
    "rndv_min": (4096, 16384, 32768, 65536, RNDV_OFF),
    "lanes": (False, True),
    "credit_window": (0, 8, 16, 32, 64),
    "poll_budget": (None, 8, 16, 32, 64),
    "k_code": (None, 0, 2, 3, 4),
    "placement": (None, "pushdown", "pull"),
}


class ProfileError(ValueError):
    """A FlowProfile file/dict is malformed or schema-incompatible."""


PROFILE_SCHEMA = "xrdma-flowprofile/1"


@dataclass(frozen=True)
class FlowProfile:
    """One complete knob assignment for a hardware profile.

    The defaults ARE the runtime's defaults (per-message, framed,
    unwindowed), so ``FlowProfile(wire=...)`` is the hand-tuned baseline
    every A/B measures against.  ``k_code=None`` leaves the cluster's
    propagation policy untouched; ``0`` forces binomial, ``k>=2`` a k-ary
    tree.  ``tenant_budgets`` is a sorted tuple of (tenant, payloads)
    pairs so the profile stays hashable and deterministic.
    """

    wire: str = "ideal"
    batching: bool = False
    lanes: bool = False
    credit_window: int = 0
    poll_budget: int | None = None
    eager_max: int = 256
    rndv_min: int = RNDV_OFF
    zerocopy: bool = False
    k_code: int | None = None
    placement: str | None = None
    tenant_budgets: tuple[tuple[str, int], ...] = ()

    def dataplane(self) -> DataPlaneConfig:
        return DataPlaneConfig(
            eager_max=self.eager_max, rndv_min=self.rndv_min, zerocopy=self.zerocopy
        )

    def propagation(self) -> PropagationConfig | None:
        if self.k_code is None:
            return None
        if self.k_code == 0:
            return PropagationConfig()
        return PropagationConfig(topology="kary", k=self.k_code)

    def as_dict(self) -> dict:
        return {
            "schema": PROFILE_SCHEMA,
            "wire": self.wire,
            "batching": self.batching,
            "lanes": self.lanes,
            "credit_window": self.credit_window,
            "poll_budget": self.poll_budget,
            "eager_max": self.eager_max,
            "rndv_min": self.rndv_min,
            "zerocopy": self.zerocopy,
            "k_code": self.k_code,
            "placement": self.placement,
            "tenant_budgets": dict(self.tenant_budgets),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FlowProfile":
        if not isinstance(d, dict):
            raise ProfileError(f"profile is not an object: {d!r}")
        schema = d.get("schema", PROFILE_SCHEMA)
        if schema != PROFILE_SCHEMA:
            raise ProfileError(f"not a {PROFILE_SCHEMA} profile (got {schema!r})")
        try:
            budgets = d.get("tenant_budgets", {})
            return cls(
                wire=str(d.get("wire", "ideal")),
                batching=bool(d.get("batching", False)),
                lanes=bool(d.get("lanes", False)),
                credit_window=int(d.get("credit_window", 0)),
                poll_budget=(
                    None if d.get("poll_budget") is None else int(d["poll_budget"])
                ),
                eager_max=int(d.get("eager_max", 256)),
                rndv_min=int(d.get("rndv_min", RNDV_OFF)),
                zerocopy=bool(d.get("zerocopy", False)),
                k_code=(None if d.get("k_code") is None else int(d["k_code"])),
                placement=(
                    None if d.get("placement") is None else str(d["placement"])
                ),
                tenant_budgets=tuple(sorted((str(k), int(v)) for k, v in dict(budgets).items())),
            )
        except (TypeError, ValueError) as e:
            raise ProfileError(f"malformed profile field: {e}") from None

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(self.as_dict(), fp, indent=1)
            fp.write("\n")

    @classmethod
    def load(cls, path: str) -> "FlowProfile":
        try:
            with open(path) as fp:
                d = json.load(fp)
        except OSError as e:
            raise ProfileError(f"cannot read profile {path!r}: {e}") from None
        except json.JSONDecodeError as e:
            raise ProfileError(f"profile {path!r}: invalid JSON ({e.msg})") from None
        return cls.from_dict(d)

    def apply(self, cluster) -> None:
        """Install every knob on a live cluster (batching, data plane,
        propagation, flow, tenant budgets) via the core's plain-JSON
        profile loader."""
        cluster.set_flow(profile=self.as_dict())


# ----------------------------------------------------------------- estimator
def _uvarint_len(v: int) -> int:
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


@dataclass
class _Send:
    src: str
    dst: str
    kind: int
    name: str
    n: int  # wire bytes as captured
    p: int  # payloads packed
    pb: int  # payload bytes
    cb: int  # code bytes
    cycle: int

    @property
    def spp(self) -> int:
        return self.pb // max(self.p, 1)


@dataclass
class _Ret:
    src: str
    dst: str
    name: str
    n: int  # framed payload bytes
    zc: int  # zero-copy write-burst bytes (-1: no slab)
    cached: bool
    cycle: int
    send_n: int = 0  # wire bytes of the captured framed send (0 if none)


class ReplayModel:
    """Replays one captured trace under candidate knob settings.

    Expects a trace captured under the default runtime (per-message,
    framed RETURNs), as :func:`repro_torch.analysis.trace.capture` records a
    run of the default cluster, and
    estimates the fabric ``modeled_us`` a candidate :class:`FlowProfile`
    would produce for the same logical workload.  All aggregation follows
    fixed event order, so estimates are bit-deterministic.
    """

    def __init__(self, trace: Trace | TraceRecorder, wire: WireModel | str | None = None):
        tr = _trace_of(trace)
        if wire is None:
            wire = tr.wire_name
        self.wire = WIRE_PROFILES[wire] if isinstance(wire, str) else wire

        polls: dict[str, list[int]] = {}
        for ev in tr.events:
            if ev["k"] == "poll":
                polls.setdefault(ev["src"], []).append(ev["i"])

        def cycle_of(src: str, i: int) -> int:
            return bisect_right(polls.get(src, ()), i)

        self.data_sends: list[_Send] = []
        self.rets: list[_Ret] = []
        self.poll_sizes: list[int] = []  # payloads retired per poll event
        # (kind, (src,dst), payloads) stream for the credit-window model
        self._flow: list[tuple[bool, tuple[str, str], int]] = []
        self.base_us = 0.0  # knob-invariant wire time
        ret_names: set[str] = set()
        pending: dict[tuple[str, str, str], list[int]] = {}
        w = self.wire
        for ev in tr.events:
            k = ev["k"]
            if k == "send":
                src, dst, n = ev["src"], ev["dst"], ev["n"]
                name = ev.get("name", "")
                control = bool(ev.get("hop")) or ev.get("kind") in (
                    int(FrameKind.RNDV), int(FrameKind.ACK)
                )
                if control:
                    # hop frames never coalesce and descriptors/ACKs are
                    # latency-critical singles: knob-invariant
                    self.base_us += w.latency_us(n)
                    continue
                key = (src, dst, name)
                if name in ret_names and pending.get(key):
                    # the framed flight of a RETURN the data plane may
                    # re-route: its bytes belong to the ret record
                    self.rets[pending[key].pop(0)].send_n = n
                    self._flow.append((True, (src, dst), ev.get("p", 1)))
                    continue
                self.data_sends.append(
                    _Send(
                        src=src, dst=dst, kind=int(ev.get("kind", 0)), name=name,
                        n=n, p=int(ev.get("p", 1)), pb=int(ev.get("pb", 0)),
                        cb=int(ev.get("cb", 0)), cycle=cycle_of(src, ev["i"]),
                    )
                )
                self._flow.append((True, (src, dst), ev.get("p", 1)))
            elif k == "ret":
                name = ev.get("name", "")
                ret_names.add(name)
                rec = _Ret(
                    src=ev["src"], dst=ev["dst"], name=name, n=ev["n"],
                    zc=int(ev.get("zc", -1)), cached=bool(ev.get("cached", False)),
                    cycle=cycle_of(ev["src"], ev["i"]),
                )
                pending.setdefault((ev["src"], ev["dst"], name), []).append(
                    len(self.rets)
                )
                self.rets.append(rec)
            elif k == "ack" or k == "retx":
                self.base_us += w.latency_us(ev.get("n", FRAME_OVERHEAD))
            elif k == "get":
                self.base_us += 2 * w.alpha_us + ev["n"] / w.beta_Bus
            elif k == "rput":
                self.base_us += (
                    w.latency_us(ev["n"]) + (ev["w"] - 1) * w.o_us
                )
            elif k == "poll":
                self.poll_sizes.append(int(ev["p"]))
            elif k == "frame":
                self._flow.append((False, (ev["src"], ev["dst"]), ev["p"]))
            # put events mirror sends/acks/retx byte-for-byte; stall /
            # cq_alloc / cq_free carry no wire time

    # -- cost pieces --------------------------------------------------------
    def _single_us(self, s: _Send) -> float:
        """Per-message cost of one captured send (decomposing a captured
        coalesced frame into per-payload frames if needed)."""
        w = self.wire
        if s.p <= 1:
            return w.latency_us(s.n)  # exact: the captured bytes
        sub = _uvarint_len(s.p) + _uvarint_len(s.spp)
        hdr = s.n - s.pb - s.cb - sub
        return s.p * w.alpha_us + (s.p * hdr + s.pb + s.cb) / w.beta_Bus

    def _group_us(self, members: list[_Send]) -> float:
        """Cost of one coalesced frame carrying every member's payloads."""
        w = self.wire
        first = members[0]
        if len(members) == 1 and first.p <= 1:
            return w.latency_us(first.n)
        hdr = first.n - first.pb - first.cb
        if first.p > 1:  # strip the captured frame's own batch subheader
            hdr -= _uvarint_len(first.p) + _uvarint_len(first.spp)
        total_p = sum(m.p for m in members)
        sub = _uvarint_len(total_p) + _uvarint_len(first.spp)
        nbytes = hdr + sub + sum(m.pb for m in members) + sum(m.cb for m in members)
        return w.latency_us(nbytes)

    def _ret_framed_single(self, r: _Ret) -> float:
        n = r.send_n or (FRAME_OVERHEAD + len(r.name) + r.n)
        return self.wire.latency_us(n)

    def cost(self, profile: FlowProfile) -> float:
        """Estimated fabric ``modeled_us`` under ``profile``."""
        w = self.wire
        dp = profile.dataplane()
        total = self.base_us

        # --- data sends (requests, forwards, AMs) under the batching knob
        if profile.batching:
            groups: dict[tuple, list[_Send]] = {}
            for s in self.data_sends:
                groups.setdefault(
                    (s.src, s.dst, s.kind, s.name, s.spp, s.cb > 0, s.cycle), []
                ).append(s)
            for members in groups.values():
                total += self._group_us(members)
        else:
            for s in self.data_sends:
                total += self._single_us(s)

        # --- RETURNs re-selected through the candidate data plane
        framed_groups: dict[tuple, list[_Ret]] = {}
        zc_chains: dict[tuple, list[int]] = {}
        desc_groups: dict[tuple, tuple[int, str]] = {}
        solo = 0  # unbatched RETURNs get unique keys (no grouping)
        for r in self.rets:
            proto = dp.select(r.n, slab=r.zc >= 0, code_cached=r.cached)
            solo += 1
            if proto == "zerocopy":
                # doorbell-batched write chain per peer per cycle
                key = (r.src, r.dst, r.cycle) if profile.batching else (solo,)
                zc_chains.setdefault(key, []).append(r.zc)
            elif proto == "rendezvous":
                # framed 16-byte descriptor (coalescable) + one GET pull
                key = (r.src, r.dst, r.name, r.cycle) if profile.batching else (solo,)
                desc_groups[key] = (
                    (desc_groups.get(key, (0, r.name))[0] + 1), r.name
                )
                total += 2 * w.alpha_us + r.n / w.beta_Bus
            else:
                key = (
                    (r.src, r.dst, r.name, r.n, r.cycle)
                    if profile.batching
                    else (solo,)
                )
                framed_groups.setdefault(key, []).append(r)
        for key, members in framed_groups.items():
            if len(members) == 1:
                total += self._ret_framed_single(members[0])
            else:
                first = members[0]
                hdr = FRAME_OVERHEAD + len(first.name)
                sub = _uvarint_len(len(members)) + _uvarint_len(first.n)
                total += w.latency_us(hdr + sub + sum(m.n for m in members))
        for writes in zc_chains.values():
            total += w.latency_us(sum(writes)) + (len(writes) - 1) * w.o_us
        for count, name in desc_groups.values():
            hdr = FRAME_OVERHEAD + len(name)
            if count == 1:
                total += w.latency_us(hdr + 16)
            else:
                sub = _uvarint_len(count) + _uvarint_len(16)
                total += w.latency_us(hdr + sub + count * 16)

        # --- flow knobs: honest overheads, never wins
        if profile.poll_budget:
            b = profile.poll_budget
            for p in self.poll_sizes:
                total += (-(-p // b) - 1) * w.o_us
        if profile.credit_window:
            total += self._window_stalls(profile.credit_window) * w.o_us
        return total

    def _window_stalls(self, window: int) -> int:
        occ: dict[tuple[str, str], int] = {}
        stalls = 0
        for is_send, link, p in self._flow:
            if is_send:
                if occ.get(link, 0) >= window:
                    stalls += 1
                occ[link] = occ.get(link, 0) + p
            else:
                occ[link] = max(0, occ.get(link, 0) - p)
        return stalls


# -------------------------------------------------------------------- search
@dataclass
class TuneReport:
    """What one autotune run decided and why."""

    profile: FlowProfile
    default_us: float
    tuned_us: float
    evaluations: int
    passes: int
    knob_order: tuple[str, ...] = ()
    history: list = field(default_factory=list)

    @property
    def improvement_pct(self) -> float:
        if self.default_us <= 0:
            return 0.0
        return 100.0 * (1.0 - self.tuned_us / self.default_us)

    def as_dict(self) -> dict:
        return {
            "profile": self.profile.as_dict(),
            "default_modeled_us": round(self.default_us, 3),
            "tuned_modeled_us": round(self.tuned_us, 3),
            "improvement_pct": round(self.improvement_pct, 2),
            "evaluations": self.evaluations,
            "passes": self.passes,
            "knob_order": list(self.knob_order),
            "history": list(self.history),
        }


def autotune(
    trace: Trace | TraceRecorder,
    wire: str | None = None,
    seed: int = 0,
    grid: dict[str, tuple] | None = None,
    max_passes: int = 8,
) -> TuneReport:
    """Coordinate descent over :data:`KNOB_GRID` against one trace.

    Starts from the hand-tuned default profile, sweeps one knob at a time
    (knob order permuted once by ``seed`` — value order is the grid's),
    accepts only strict improvements, and repeats until a full pass
    changes nothing.  Same trace + same wire + same seed is bit-identical:
    every float accumulates in fixed event order and ties keep the
    incumbent value.
    """
    tr = _trace_of(trace)
    if wire is None:
        wire = tr.wire_name
    if wire not in WIRE_PROFILES:
        raise TraceError(f"unknown wire profile {wire!r}")
    model = ReplayModel(tr, wire)
    grid = dict(grid or KNOB_GRID)
    knobs = list(grid)
    order = [knobs[i] for i in np.random.default_rng(seed).permutation(len(knobs))]

    best = FlowProfile(wire=wire)
    best_cost = model.cost(best)
    default_cost = best_cost
    evals = 1
    history: list = []
    passes = 0
    for passes in range(1, max_passes + 1):
        changed = False
        for knob in order:
            for value in grid[knob]:
                if getattr(best, knob) == value:
                    continue
                cand = replace(best, **{knob: value})
                c = model.cost(cand)
                evals += 1
                if c < best_cost - 1e-9:
                    history.append([knob, value, round(c, 3)])
                    best, best_cost = cand, c
                    changed = True
        if not changed:
            break
    return TuneReport(
        profile=best,
        default_us=default_cost,
        tuned_us=best_cost,
        evaluations=evals,
        passes=passes,
        knob_order=tuple(order),
        history=history,
    )


def load_traces(paths: Iterable[str]) -> list[Trace]:
    """Convenience: load several trace files (each validated)."""
    from .trace import load_trace

    return [load_trace(p) for p in paths]
