"""Safe code injection: install-time bitcode verifier + runtime sandbox.

The paper's headline capability — remotely injected code that recursively
propagates itself — is exactly what a multi-tenant fabric cannot extend
on trust.  This module is the eBPF-shaped answer (Kourtis et al.,
PAPERS.md): *verify before install, bound at run time*.

Install-time (:meth:`Verifier.admit`): every code slice entering
:meth:`repro_torch.core.cache.TargetCodeCache.install` — direct install,
SenderCache ship, or PUBLISH hop — is checked against its declared ABI
before it becomes resolvable:

* **op budget** — the exported graph's op count (its ``call_function``
  nodes) must fit ``SandboxConfig.max_ops`` (a graph bomb is refused
  before it becomes callable);
* **region whitelist** — the ``region:``/``cap:`` names in the slice's
  dep list must fall inside ``SandboxConfig.allowed_regions`` (empty =
  any *declared* region; ``rndv/``-prefixed transport staging regions are
  always refused — shipped code never touches the rendezvous ring);
* **action derivation** — the ``A_*`` rows the slice may emit are derived
  from its ABI (``returns:``/``spawn:`` deps gate ``A_RETURN``/``A_SPAWN``)
  and intersected with ``SandboxConfig.allowed_actions``;
* **ttl ceiling** — the capability stamp records
  ``min(config.max_publish_ttl, admitting hop's ttl)``, so hostile code
  cannot re-mint deeper publish trees than it was admitted with.

The result is a :class:`CapabilityStamp` keyed by code digest, cached
per-PE: warm-tree digest-only hops hit the stamp dict and pay nothing
(the benchmark's ``verify_overhead_pct`` pins this at 0).

Run-time (:meth:`Verifier.charge_invoke` / :meth:`Verifier.charge_action`
/ :meth:`Verifier.check_publish_ttl`): per-digest cumulative quotas —
payload bytes ingested, invoke ticks, action rows, publish fan-out —
enforced at retire time with the publish-path poison pattern: loud
:class:`SandboxViolation`, a per-reason bump in ``PEStats.refusals``, and
the offending digest **quarantined** — uninstalled everywhere, sender
caches told to forget, queued frames dropped, in-flight CQ futures
degraded via the validity-mask path rather than hung.

``SandboxConfig`` threads like :class:`repro_torch.core.reliability.ReliabilityConfig`:
frozen, ``enabled=False`` by default, and the disabled path is bit-for-bit
the prior runtime (every hook exits on one attribute read).
"""

from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter
from typing import Callable

from .frame import ProtocolError
from .propagate import DEFAULT_TTL

# Action row codes, mirrored from repro_torch.core.pe.exec (importing the pe
# package here would cycle: pe.pe facade <- verify <- pe.exec).  The exec
# layer asserts this mirror at import time.
A_DONE, A_FORWARD, A_RETURN, A_SPAWN, A_NOP, A_PUBLISH = range(6)
ALL_ACTIONS = (A_DONE, A_FORWARD, A_RETURN, A_SPAWN, A_NOP, A_PUBLISH)
_ACTION_NAMES = {
    A_DONE: "A_DONE", A_FORWARD: "A_FORWARD", A_RETURN: "A_RETURN",
    A_SPAWN: "A_SPAWN", A_NOP: "A_NOP", A_PUBLISH: "A_PUBLISH",
}

#: Default op budget per slice.  The JAX package budgets 4096 StableHLO
#: SSA ops; the same ifuncs trace to 5.2-7.8x fewer ATen graph nodes here
#: (Gatherer 567 -> 88 and 690 -> 132 ops, GatherReturn 256 -> 33, at
#: (servers, keys, dim) = (4, 8, 8) and (8, 16, 128)), so the budget keeps
#: the reference's headroom at the Gatherer's ratio: 4096 / 6.4.
MAX_OPS_DEFAULT = 640

#: transport rendezvous staging regions — never grantable to shipped code
RNDV_PREFIX = "rndv/"


class SandboxViolation(ProtocolError):
    """A code slice failed verification or blew a runtime quota.

    Subclasses :class:`repro_torch.core.frame.ProtocolError` so the progress
    engine's per-frame containment (one poisoned frame never takes its
    batch siblings down) applies unchanged."""


@dataclass(frozen=True)
class SandboxConfig:
    """Per-PE (per tenant-class, via the router's strictest-merge) sandbox
    policy.  Frozen + off by default: with ``enabled=False`` every
    enforcement hook is a single attribute read and the runtime is
    bit-for-bit the unsandboxed one.

    Quota fields use ``0`` = unlimited.  ``allowed_regions`` empty means
    "any region the ABI declares" — the install check then only refuses
    the always-forbidden ``rndv/`` staging names — while a non-empty
    tuple is a hard whitelist over both ``region:`` and ``cap:`` deps.
    """

    enabled: bool = False
    # --- install-time verifier ---
    max_ops: int = MAX_OPS_DEFAULT  # graph ops per slice (0 = unlimited)
    max_publish_ttl: int = DEFAULT_TTL  # ttl ceiling shipped code may re-mint
    allowed_regions: tuple = ()  # () = any ABI-declared region/cap
    allowed_actions: tuple = ALL_ACTIONS  # A_* codes grantable at all
    # --- run-time quotas (per code digest; 0 = unlimited) ---
    max_invoke_payload_bytes: int = 0  # largest single payload accepted
    max_payload_bytes: int = 0  # cumulative payload bytes ingested
    max_invokes: int = 0  # cumulative invoke ticks consumed
    max_actions: int = 0  # cumulative action rows emitted
    max_publish_fanout: int = 0  # cumulative A_PUBLISH rows emitted

    @classmethod
    def on(cls, **kwargs) -> "SandboxConfig":
        """Enabled config in one call: ``SandboxConfig.on(max_invokes=8)``."""
        kwargs.setdefault("enabled", True)
        return cls(**kwargs)

    @classmethod
    def strictest(cls, configs: "list[SandboxConfig]") -> "SandboxConfig":
        """Fold many tenant-class policies into the one policy the fabric
        can enforce (frames carry no tenant attribution below the router,
        so per-PE enforcement takes the conservative envelope): quotas
        take the tightest non-zero bound, action whitelists intersect,
        and region whitelists union **only when every class restricts**
        (one unrestricted class means declared-region semantics stand)."""
        if not configs:
            return cls()

        def tight(vals: "list[int]") -> int:
            nz = [v for v in vals if v]
            return min(nz) if nz else 0

        actions: set = set(ALL_ACTIONS)
        for c in configs:
            actions &= set(c.allowed_actions)
        if all(c.allowed_regions for c in configs):
            regions = tuple(sorted({r for c in configs for r in c.allowed_regions}))
        else:
            regions = ()
        return cls(
            enabled=any(c.enabled for c in configs),
            max_ops=tight([c.max_ops for c in configs]),
            max_publish_ttl=min(c.max_publish_ttl for c in configs),
            allowed_regions=regions,
            allowed_actions=tuple(sorted(actions)),
            max_invoke_payload_bytes=tight(
                [c.max_invoke_payload_bytes for c in configs]
            ),
            max_payload_bytes=tight([c.max_payload_bytes for c in configs]),
            max_invokes=tight([c.max_invokes for c in configs]),
            max_actions=tight([c.max_actions for c in configs]),
            max_publish_fanout=tight([c.max_publish_fanout for c in configs]),
        )


@dataclass
class CapabilityStamp:
    """What one verified code digest is allowed to do on this PE.  Minted
    once at cold install; every later resolve of the same digest —
    including warm-tree digest-only PUBLISH hops — is a dict hit."""

    digest: str  # sha256 hex of the fat-bitcode slice
    ops: int  # graph op count measured at admission
    regions: frozenset  # region/cap names the ABI grants
    actions: frozenset  # A_* codes this code may emit
    max_ttl: int  # deepest publish tree it may re-mint
    verify_ms: float = 0.0  # cold verification cost (informational)


@dataclass
class UsageLedger:
    """Cumulative runtime consumption of one digest on one PE."""

    invokes: int = 0
    payload_bytes: int = 0
    actions: int = 0
    publishes: int = 0


def count_ops(exported) -> int:
    """Op count of one exported slice: the ``call_function`` nodes of its
    ATen graph.  This is the instruction-budget metric — deterministic,
    cheap (one walk over the graph), and measured on the *traced* code
    before it becomes callable."""
    if exported is None:
        return 0
    return sum(1 for n in exported.graph.nodes if n.op == "call_function")


class Verifier:
    """Per-PE verifier + sandbox ledger.

    The layers call four hooks: :meth:`admit` at every code-cache ingress
    (install / resolve / publish-resolve), :meth:`charge_invoke` and
    :meth:`charge_action` from the exec layer at retire time, and
    :meth:`check_publish_ttl` when locally-running code mints a new
    publish tree.  All four exit immediately when the config is disabled.
    """

    def __init__(self, name: str, stats) -> None:
        self.name = name
        self.stats = stats  # the PE's PEStats (refusal counters)
        self.config = SandboxConfig()
        self.stamps: dict[str, CapabilityStamp] = {}
        self.usage: dict[str, UsageLedger] = {}
        self.quarantined: set[str] = set()
        # local teardown (uninstall + CQ poison + queue purge), set by the
        # owning PE; fired on every quarantine, local or absorbed
        self.local_cleanup: Callable[[str, str], None] | None = None
        # cluster-wide listeners (sender-cache forget + absorb on peers),
        # fired only by the PE that *originates* the quarantine
        self.on_quarantine: list = []
        # accounting for the benchmark's warm/cold split
        self.verifies = 0  # cold verifications performed
        self.stamp_hits = 0  # warm stamp-cache reuses
        self.verify_ms_total = 0.0

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    # ------------------------------------------------------------ refusals
    def _refuse(self, reason: str, msg: str) -> None:
        self.stats.refuse(reason)
        raise SandboxViolation(f"{self.name}: {msg}")

    # ------------------------------------------------------------ admission
    def admit(
        self,
        name: str,
        digest: str,
        deps: tuple,
        exported=None,
        admitted_ttl: int | None = None,
    ) -> CapabilityStamp:
        """Gate one code-cache ingress.  Quarantined digests are refused
        outright; a stamped digest is a dict hit (the warm path); anything
        else is cold-verified against the config and stamped.

        ``admitted_ttl`` is the admitting PUBLISH hop's remaining ttl —
        the stamp's re-mint ceiling is clamped under it, so code can never
        grow a deeper tree than the one that delivered it."""
        if digest in self.quarantined:
            self._refuse(
                "verify_quarantined", f"{name} [{digest[:12]}] is quarantined"
            )
        stamp = self.stamps.get(digest)
        if stamp is not None:
            self.stamp_hits += 1
            return stamp
        t0 = perf_counter()
        cfg = self.config
        ops = count_ops(exported) if cfg.max_ops else 0
        if cfg.max_ops and ops > cfg.max_ops:
            self.quarantine(digest, name)
            self._refuse(
                "verify_ops",
                f"{name} [{digest[:12]}] has {ops} ops > budget {cfg.max_ops}",
            )
        regions = frozenset(
            d.split(":", 1)[1]
            for d in deps
            if d.startswith(("region:", "cap:"))
        )
        for r in sorted(regions):
            if r.startswith(RNDV_PREFIX) or (
                cfg.allowed_regions and r not in cfg.allowed_regions
            ):
                self.quarantine(digest, name)
                self._refuse(
                    "verify_region",
                    f"{name} [{digest[:12]}] declares region {r!r} "
                    f"outside its whitelist",
                )
        actions = {A_DONE, A_NOP, A_FORWARD, A_PUBLISH}
        if any(d.startswith("returns:") for d in deps):
            actions.add(A_RETURN)
        if any(d.startswith("spawn:") for d in deps):
            actions.add(A_SPAWN)
        actions &= set(cfg.allowed_actions)
        max_ttl = cfg.max_publish_ttl
        if admitted_ttl is not None:
            max_ttl = min(max_ttl, int(admitted_ttl))
        ms = (perf_counter() - t0) * 1e3
        stamp = CapabilityStamp(
            digest=digest, ops=ops, regions=regions,
            actions=frozenset(actions), max_ttl=max_ttl, verify_ms=ms,
        )
        self.stamps[digest] = stamp
        self.verifies += 1
        self.verify_ms_total += ms
        return stamp

    # ------------------------------------------------------- runtime quotas
    def _ledger(self, digest: str) -> UsageLedger:
        led = self.usage.get(digest)
        if led is None:
            led = self.usage[digest] = UsageLedger()
        return led

    def charge_invoke(self, exe, nbytes_list: "list[int]") -> None:
        """Charge one retire-time dispatch (``len(nbytes_list)`` payloads)
        against the digest's invoke-tick and payload-byte quotas.  Runs
        *before* the dispatch: code over budget never executes again."""
        cfg = self.config
        if not cfg.enabled:
            return
        digest = exe.digest
        if digest in self.quarantined:
            self._refuse(
                "verify_quarantined",
                f"{exe.name} [{digest[:12]}] invoked while quarantined",
            )
        led = self._ledger(digest)
        if cfg.max_invoke_payload_bytes:
            worst = max(nbytes_list, default=0)
            if worst > cfg.max_invoke_payload_bytes:
                self.quarantine(digest, exe.name)
                self._refuse(
                    "quota_payload",
                    f"{exe.name} payload {worst}B > per-invoke cap "
                    f"{cfg.max_invoke_payload_bytes}B",
                )
        total = sum(nbytes_list)
        if cfg.max_payload_bytes and led.payload_bytes + total > cfg.max_payload_bytes:
            self.quarantine(digest, exe.name)
            self._refuse(
                "quota_payload",
                f"{exe.name} cumulative payload {led.payload_bytes + total}B "
                f"> quota {cfg.max_payload_bytes}B",
            )
        n = len(nbytes_list)
        if cfg.max_invokes and led.invokes + n > cfg.max_invokes:
            self.quarantine(digest, exe.name)
            self._refuse(
                "quota_invokes",
                f"{exe.name} invoke ticks {led.invokes + n} "
                f"> quota {cfg.max_invokes}",
            )
        led.invokes += n
        led.payload_bytes += total

    def charge_action(self, exe, code: int) -> None:
        """Charge one emitted action row against the digest's capability
        stamp (which ``A_*`` rows it may emit at all) and its cumulative
        action / publish-fanout quotas."""
        cfg = self.config
        if not cfg.enabled:
            return
        digest = exe.digest
        if digest in self.quarantined:
            self._refuse(
                "verify_quarantined",
                f"{exe.name} [{digest[:12]}] acting while quarantined",
            )
        stamp = self.stamps.get(digest)
        if stamp is not None and code not in stamp.actions:
            self.quarantine(digest, exe.name)
            self._refuse(
                "verify_action",
                f"{exe.name} emitted {_ACTION_NAMES.get(code, code)} "
                f"outside its capability stamp",
            )
        led = self._ledger(digest)
        led.actions += 1
        if cfg.max_actions and led.actions > cfg.max_actions:
            self.quarantine(digest, exe.name)
            self._refuse(
                "quota_actions",
                f"{exe.name} emitted {led.actions} action rows "
                f"> quota {cfg.max_actions}",
            )
        if code == A_PUBLISH:
            led.publishes += 1
            if cfg.max_publish_fanout and led.publishes > cfg.max_publish_fanout:
                self.quarantine(digest, exe.name)
                self._refuse(
                    "quota_fanout",
                    f"{exe.name} published {led.publishes} times "
                    f"> fan-out quota {cfg.max_publish_fanout}",
                )

    def check_publish_ttl(self, exe, granted_ttl: int) -> None:
        """Refuse a locally-minted publish whose granted ttl exceeds the
        code's stamped ceiling — hostile code cannot re-mint a deeper
        propagation tree than the hop that admitted it."""
        cfg = self.config
        if not cfg.enabled:
            return
        stamp = self.stamps.get(exe.digest)
        ceiling = stamp.max_ttl if stamp is not None else cfg.max_publish_ttl
        if granted_ttl > ceiling:
            self.quarantine(exe.digest, exe.name)
            self._refuse(
                "verify_ttl",
                f"{exe.name} re-minted publish ttl {granted_ttl} "
                f"> stamped ceiling {ceiling}",
            )

    # ------------------------------------------------------------ quarantine
    def quarantine(self, digest: str, name: str = "") -> None:
        """Originate a quarantine: local teardown, then tell the cluster
        (listeners invalidate sender caches and absorb on every peer)."""
        if digest in self.quarantined:
            return
        self._absorb(digest, name)
        for cb in list(self.on_quarantine):
            cb(digest, name)

    def absorb_quarantine(self, digest: str, name: str = "") -> None:
        """Apply a quarantine decided elsewhere: local teardown only —
        never re-fires the cluster listeners (no broadcast recursion)."""
        if digest in self.quarantined:
            return
        self._absorb(digest, name)

    def _absorb(self, digest: str, name: str) -> None:
        self.quarantined.add(digest)
        self.stamps.pop(digest, None)
        if self.local_cleanup is not None:
            self.local_cleanup(digest, name)
