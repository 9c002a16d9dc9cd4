"""In-process cluster of processing elements (hosts + DPUs) on one fabric.

Peer indexing convention: peers[0..n_servers-1] are the servers (DPU role),
peers[n_servers] is the client (host role).  This index space is what
X-RDMA action vectors use for ``dst``/``requester`` fields.

The scheduler is a deterministic single-threaded round-robin poll loop
(daemon-thread polling is supported by the same PE.poll API but benchmarks
use the scheduler for reproducibility).

Every PE runs its code on one torch device: the CUDA card unless the caller
asks for ``device="cpu"`` — and a host without a card raises rather than
quietly running the port on the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .bitcode import local_triple, resolve_device
from .dataplane import DataPlaneConfig
from .pe import PE, Toolchain
from .propagate import PropagationConfig
from .reliability import ReliabilityConfig
from .transport import Fabric, WireModel
from .verify import SandboxConfig


class Cluster:
    def __init__(
        self,
        n_servers: int,
        wire: WireModel | str = "ideal",
        server_triple: str | None = None,
        client_triple: str | None = None,
        toolchain: Toolchain | None = None,
        device: "torch.device | str | None" = None,
    ) -> None:
        # triples default to the device's own: on the card every PE takes
        # the cuda-sm90 slice; on the host the servers play the DPUs
        # (cpu-bf2) and the client the Xeon host (cpu-host)
        self.device = resolve_device(device)
        on_host = self.device.type == "cpu"
        if server_triple is None:
            server_triple = "cpu-bf2" if on_host else local_triple(self.device)
        if client_triple is None:
            client_triple = "cpu-host" if on_host else local_triple(self.device)
        self.fabric = Fabric(wire)
        self.toolchain = toolchain or Toolchain()
        self.n_servers = n_servers
        names = [f"server{i}" for i in range(n_servers)] + ["client"]
        self.servers = [
            PE(
                n, self.fabric, triple=server_triple, toolchain=self.toolchain,
                peers=names, device=self.device,
            )
            for n in names[:-1]
        ]
        self.client = PE(
            "client", self.fabric, triple=client_triple, toolchain=self.toolchain,
            peers=names, device=self.device,
        )

    @property
    def client_index(self) -> int:
        return self.n_servers

    def load_reference_state(self, state: "dict[str, dict]") -> None:
        """Install another cluster's PE state here, so both compute on the
        same bytes: ``state`` maps a PE name to ``{"regions": {name: array},
        "caps": {name: array}}`` of numpy arrays (what a reference cluster's
        ``pe.region(name)`` and ``pe.caps`` hold).  Regions register as
        copies, so this cluster never aliases the source's memory."""
        by_name = {pe.name: pe for pe in self.pes()}
        for pe_name, st in state.items():
            pe = by_name[pe_name]
            for name, arr in st.get("regions", {}).items():
                pe.register_region(name, np.array(arr, copy=True))
            for name, arr in st.get("caps", {}).items():
                pe.register_cap(name, np.array(arr, copy=True))

    def set_batching(self, enabled: bool) -> None:
        """Flip every PE between the per-message and the batched runtime
        (coalesced sends + grouped polls)."""
        for pe in self.pes():
            pe.batching = enabled

    def set_dataplane(self, config: DataPlaneConfig | None) -> None:
        """Install one data-plane protocol selection (framed / zero-copy /
        rendezvous thresholds) on every PE; ``None`` restores the default
        all-framed plane."""
        cfg = config or DataPlaneConfig()
        for pe in self.pes():
            pe.dataplane = cfg

    def set_propagation(self, config: PropagationConfig | None) -> None:
        """Install one propagation policy (tree topology / fanout / ttl)
        on every PE, the way :meth:`set_dataplane` threads the data plane;
        ``None`` restores the default (binomial, DEFAULT_TTL)."""
        cfg = config or PropagationConfig()
        for pe in self.pes():
            pe.propagation = cfg

    def set_reliability(self, config: ReliabilityConfig | None) -> None:
        """Install one reliability policy (seq/ack tracking, retransmit
        timers, failure detection) on every PE; ``None`` restores the
        default (disabled — the pre-reliability runtime, bit-for-bit)."""
        cfg = config or ReliabilityConfig()
        for pe in self.pes():
            pe.reliability = cfg

    def set_sandbox(self, config: SandboxConfig | None) -> None:
        """Install one safe-code-injection policy (install-time verifier +
        runtime quotas) on every PE, and wire quarantine propagation: a
        digest refused anywhere is uninstalled everywhere, every sender
        cache forgets it, and each PE degrades its own in-flight futures;
        ``None`` restores the default (disabled — the unverified runtime,
        bit-for-bit)."""
        cfg = config or SandboxConfig()
        for pe in self.pes():
            pe.sandbox = cfg
            # idempotent re-wiring: exactly one cluster listener per PE
            pe.verifier.on_quarantine = [self._quarantine_cluster_wide]

    def _quarantine_cluster_wide(self, digest: str, name: str) -> None:
        """One PE originated a quarantine: absorb it on every PE (local
        uninstall + CQ degradation + queue purge, no re-broadcast) and
        make every sender cache forget the digest, so no truncated frame
        referencing the banished code ever travels again."""
        for pe in self.pes():
            pe.sender_cache.invalidate_digest(digest)
            pe.verifier.absorb_quarantine(digest, name)

    def refusals(self) -> dict[str, int]:
        """Cluster-wide rollup of every PE's refusal counters (publish-path
        refusals, verifier refusals, sandbox quota refusals), per reason."""
        total: dict[str, int] = {}
        for pe in self.pes():
            for reason, n in pe.stats.refusals.items():
                total[reason] = total.get(reason, 0) + n
        return total

    def _recovery_grace(self) -> int:
        """Zero-progress rounds the scheduler must tolerate before calling
        the cluster dead: under reliability, a lost frame sits silent until
        its retransmit timer fires, so idleness up to the recovery horizon
        is recovery in progress, not a hang."""
        graces = [
            pe.reliability.idle_grace()
            for pe in self.alive_pes()
            if pe.reliability.enabled
        ]
        return max(graces, default=0)

    def pes(self) -> list[PE]:
        return [*self.servers, self.client]

    def drain_rounds(self, max_rounds: int = 100_000) -> int:
        """Poll every live PE until a full round makes no progress; returns
        the round count.  (Unlike :meth:`drain` this needs no idle-grace
        heuristics when reliability is off: propagation traffic is
        self-contained, so one zero-progress round means the fabric is
        empty.  Under reliability a lost frame is silent until its
        retransmit timer fires, so idle rounds up to the recovery horizon
        are tolerated before declaring the fabric drained.)"""
        rounds = 0
        idle = 0
        grace = self._recovery_grace()
        while rounds < max_rounds:
            rounds += 1
            if sum(pe.poll() for pe in self.alive_pes()) == 0:
                idle += 1
                if idle > grace:
                    break
            else:
                idle = 0
        return rounds

    def publish_and_cover(
        self,
        name: str,
        payload: bytes = b"",
        config: PropagationConfig | None = None,
        ttl: int | None = None,
        reparent: bool = True,
        max_rounds: int = 100_000,
    ) -> tuple[int, int, list[PE]]:
        """The fault-handling core every tree publish shares: publish from
        the client down the spanning tree, drain, and re-cover any alive
        server a dropped hop or dead mid-tree PE left without the code by
        a *direct* root publish (ttl=1; ``publish_to`` forgets the stale
        sender-cache row so the code travels again).  Returns ``(rounds,
        reparented, still_uncovered)`` — reporting layers
        (:func:`repro_torch.sharding.collectives.xrdma_bcast`) and strict layers
        (:meth:`distribute_code`) decide what partial coverage means.
        """
        cfg = config or PropagationConfig()
        self.set_propagation(cfg)
        client = self.client
        hexd = client.resolve_source(name).digest.hex()
        alive = [pe for pe in self.servers if pe.endpoint.alive]

        def uncovered() -> list[PE]:
            return [
                pe for pe in alive if pe.target_cache.lookup_digest(hexd) is None
            ]

        client.publish_ifunc(name, payload, ttl=ttl, config=cfg)
        rounds = self.drain_rounds(max_rounds)
        reparented = 0
        if reparent:
            missing = uncovered()
            for pe in missing:
                client.publish_to(pe.name, name, payload, ttl=1)
                reparented += 1
            if missing:
                rounds += self.drain_rounds(max_rounds)
        return rounds, reparented, uncovered()

    def distribute_code(self, name: str, config: PropagationConfig | None = None) -> None:
        """Tree-publish an ifunc's code from the client to every alive
        server (code-only publish: install + re-publish, no invoke), then
        mark *every* sender's cache for the covered peers so the whole
        subsequent request stream — client launches and server-to-server
        FORWARDs alike — travels digest-only.  A degraded cluster
        distributes exactly as a healthy one minus its corpses
        (:meth:`publish_and_cover` re-parents orphaned subtrees); residual
        gaps are an error here, because a workload is about to send
        digest-only frames that an uncovered PE cannot decode.
        """
        _, _, still = self.publish_and_cover(name, b"", config=config)
        if still:  # direct publishes cannot be lost on this fabric
            raise TimeoutError(
                f"code distribution of {name!r} left "
                f"{[pe.name for pe in still]} uncovered"
            )
        hexd = self.client.resolve_source(name).digest.hex()
        alive = [pe for pe in self.servers if pe.endpoint.alive]
        for sender in self.alive_pes():
            for pe in alive:
                sender.sender_cache.mark(pe.name, hexd)

    def alive_pes(self) -> list[PE]:
        return [pe for pe in self.pes() if pe.endpoint.alive]

    # ------------------------------------------------------------- schedule
    def run_until(
        self,
        pred: Callable[[], bool],
        max_rounds: int = 1_000_000,
    ) -> int:
        """Round-robin poll all live PEs until ``pred()`` holds.

        Returns the number of scheduler rounds.  Raises TimeoutError if the
        cluster goes idle (no messages in flight) while ``pred`` is false —
        that means a message was lost (e.g. a PE died), which is the fault
        the runtime layer recovers from.
        """
        idle = 0
        idle_limit = max(2, self._recovery_grace())
        for rounds in range(max_rounds):
            if pred():
                return rounds
            progress = sum(pe.poll() for pe in self.alive_pes())
            if progress == 0:
                idle += 1
                if idle > idle_limit:
                    raise TimeoutError("cluster idle but predicate unsatisfied")
            else:
                idle = 0
        raise TimeoutError("max_rounds exceeded")

    def drain(self, max_rounds: int = 1_000_000) -> None:
        """Poll until no traffic remains in flight."""
        try:
            self.run_until(lambda: False, max_rounds=max_rounds)
        except TimeoutError:
            pass

    # ------------------------------------------------------- fault injection
    def kill_server(self, idx: int) -> None:
        self.fabric.kill(f"server{idx}")

    def restart_server(self, idx: int) -> PE:
        """Process restart: fresh endpoint, empty caches — and every other
        PE's sender-cache entries for this endpoint dropped, because the
        restarted process no longer holds any code a sender believes it
        sent.  Without the invalidation a sender would ship digest-only
        (truncated) frames the fresh PE cannot decode; with it, the next
        send pays the full code frame once and re-warms."""
        name = f"server{idx}"
        # PE() connects a fresh endpoint, displacing the dead one: fresh
        # inbox, no regions, empty caches — exactly a restarted process.
        pe = PE(
            name,
            self.fabric,
            triple=self.servers[idx].triple,
            toolchain=self.toolchain,
            peers=self.servers[idx].peers,
            device=self.device,
        )
        self.servers[idx] = pe
        for peer in self.pes():
            # drops sender-cache rows, reliability seq/retransmit state,
            # pairwise credits, and the publish dedup keys of the previous
            # life (a restarted process re-mints publish ids from zero, and
            # its fresh seq stream restarts at 1 — stale windows would
            # swallow both)
            peer.forget_peer_state(name)
        return pe
