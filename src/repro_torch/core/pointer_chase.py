"""DAPC miniapp + GBPC baseline (paper Secs. IV-C/IV-D).

The pointer table is a random permutation cycle over ``n_entries`` int32
entries, split into even shards across the servers ("indexed using the
server number first": owner(addr) = addr // shard_size).  Three execution
modes, as in the paper:

* ``bitcode`` — X-RDMA Chaser ifunc, fat-bitcode representation (on the
  card every server takes its ``cuda-sm90`` slice, whose local loop is the
  hand-written ``chase_shard`` kernel).
* ``binary``  — same Chaser, single-triple binary representation.
* ``am``      — Active Messages: pre-deployed python handlers, payload-only
  frames (the paper's evaluation baseline).

plus ``gbpc(...)`` — the RDMA-GET baseline: the client chases by itself,
one one-sided READ round-trip per hop (move-data-to-compute).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cluster import Cluster
from .dataplane import DataPlaneConfig
from .frame import FrameKind
from .pe import PE
from .propagate import PropagationConfig
from .transport import WireReportMixin
from .xrdma import make_chaser, make_return_result

RESULT_SENTINEL = -1


def make_chain(n_entries: int, seed: int = 0) -> np.ndarray:
    """A single random cycle: table[i] = successor of i (int32)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_entries)
    table = np.empty(n_entries, np.int32)
    table[perm] = np.roll(perm, -1)
    return table


def chase_ref(table: np.ndarray, start: int, depth: int) -> int:
    """Pure-numpy oracle for any chase implementation."""
    a = int(start)
    for _ in range(depth):
        a = int(table[a])
    return a


@dataclass
class ChaseReport(WireReportMixin):
    results: np.ndarray
    rounds: int
    puts: int
    gets: int
    put_bytes: int
    get_bytes: int
    modeled_us: float
    invokes: int = 0  # dispatches across all PEs (batched dispatch = 1)
    coalesced_frames: int = 0  # PUTs that carried >1 payload
    coalesced_payloads: int = 0  # payloads carried inside those PUTs
    region_puts: int = 0  # one-sided slab-write batches (zero-copy RETURNs)
    region_put_bytes: int = 0  # data + doorbell bytes those writes carried
    hop_frames: int = 0  # PUBLISH hop frames (tree code distribution)
    wire_bytes_by_kind: dict = field(default_factory=dict)


class PointerChaseApp:
    """Wires a Cluster with a sharded pointer table and runs chases."""

    def __init__(self, cluster: Cluster, n_entries: int, max_slots: int = 256, seed: int = 0):
        if n_entries % cluster.n_servers:
            raise ValueError("n_entries must divide evenly across servers")
        self.cluster = cluster
        self.table = make_chain(n_entries, seed)
        self.n_entries = n_entries
        self.max_slots = max_slots
        self.shard_size = n_entries // cluster.n_servers
        # distribute shards + metadata to servers
        for i, pe in enumerate(cluster.servers):
            lo = i * self.shard_size
            pe.register_region("table_shard", self.table[lo : lo + self.shard_size].copy())
            pe.register_cap(
                "shard_meta", np.array([i, self.shard_size, cluster.n_servers], np.int32)
            )
        # client result buffer: slots + completion counter
        cluster.client.register_region("results", np.zeros(max_slots + 1, np.int32))
        # toolchain artifacts (the "directory Three-Chains can locate")
        tc = cluster.toolchain
        tc.publish(make_chaser(self.shard_size))
        tc.publish(make_return_result(max_slots))
        tc.publish(
            make_chaser(
                self.shard_size,
                targets=(cluster.servers[0].triple,) if cluster.servers else ("cpu-host",),
                kind=FrameKind.BINARY,
                name="chaser_bin",
            )
        )
        # AM mode: handlers must be pre-deployed on every PE (the baseline's
        # defining constraint)
        for pe in cluster.servers:
            pe.am_table["chase"] = _chase_am_handler
        cluster.client.am_table["chase_result"] = _chase_result_am_handler

    # ----------------------------------------------------------------- util
    def owner(self, addr: int) -> int:
        return int(addr) // self.shard_size

    def _reset_results(self) -> np.ndarray:
        res = self.cluster.client.region("results")
        res.fill(0)
        res[: self.max_slots] = RESULT_SENTINEL
        # in-place mutation under the registration: invalidate any device-
        # resident mirror so the first RETURN fold reads the reset state
        self.cluster.client.endpoint.touch_region("results")
        return res

    def _finish(self, n: int, rounds: int, invokes0: int = 0) -> ChaseReport:
        st = self.cluster.fabric.stats
        res = self.cluster.client.region("results")[:n].copy()
        return ChaseReport(
            results=res,
            rounds=rounds,
            invokes=self._total_invokes() - invokes0,
            **st.report_kwargs(),
        )

    def _total_invokes(self) -> int:
        return sum(pe.stats.invokes for pe in self.cluster.pes())

    # ----------------------------------------------------------------- DAPC
    def dapc(
        self,
        starts: np.ndarray,
        depth: int,
        mode: str = "bitcode",
        batching: bool = False,
        dataplane: DataPlaneConfig | None = None,
        propagation: PropagationConfig | None = None,
    ) -> ChaseReport:
        """Launch one X-RDMA Chaser per start and run to completion.

        ``batching=True`` switches the whole cluster onto the batched
        runtime: all launches are enqueued and flushed as one coalesced PUT
        per destination, every PE retires same-type arrivals in one
        dispatch, and FORWARD/RETURN bursts coalesce per destination.  The
        per-message path (``batching=False``, the default) is kept as the
        A/B baseline.  ``dataplane`` selects the RETURN protocol for this
        run (framed / zero-copy slab writes / rendezvous); the chase
        result buffer doubles as the zero-copy slab, so the completion
        predicate (the counter word) is identical on every path.
        ``propagation`` switches code distribution from the implicit flat
        push (each launch's first contact carries the code) to a tree
        multicast ahead of the launches — fewer client-side code sends,
        identical results.
        """
        starts = np.asarray(starts, np.int32)
        n = len(starts)
        if n > self.max_slots:
            raise ValueError("too many concurrent chases")
        cl = self.cluster
        client = cl.client
        self._reset_results()
        cl.fabric.stats.reset()
        cl.set_batching(batching)
        cl.set_dataplane(dataplane)
        invokes0 = self._total_invokes()
        name = {"bitcode": "chaser", "binary": "chaser_bin"}.get(mode)
        if propagation is not None and name is not None:
            cl.distribute_code(name, propagation)
        results = cl.client.region("results")
        if mode == "am":
            for slot, start in enumerate(starts):
                payload = np.array([start, depth, cl.client_index, slot], np.int32)
                client.send_am(f"server{self.owner(start)}", "chase", payload)
        elif name is not None:
            for slot, start in enumerate(starts):
                payload = np.array([start, depth, cl.client_index, slot], np.int32)
                client.send_ifunc(f"server{self.owner(start)}", name, payload)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        client.flush()
        try:
            rounds = cl.run_until(lambda: results[self.max_slots] >= n)
        finally:
            # don't leak batched mode or a non-default data plane into later
            # traffic on this cluster: a send after dapc() would queue
            # silently / keep writing slabs nobody is polling
            cl.set_batching(False)
            cl.set_dataplane(None)
        return self._finish(n, rounds, invokes0)

    # ----------------------------------------------------------------- GBPC
    def gbpc(self, starts: np.ndarray, depth: int) -> ChaseReport:
        """RDMA-GET baseline: the client does every hop itself."""
        cl = self.cluster
        self._reset_results()
        cl.fabric.stats.reset()
        invokes0 = self._total_invokes()
        results = cl.client.region("results")
        for slot, start in enumerate(np.asarray(starts, np.int32)):
            a = int(start)
            for _ in range(depth):
                srv = self.owner(a)
                off = (a - srv * self.shard_size) * 4
                data = cl.fabric.get(cl.client.name, f"server{srv}", "table_shard", off, 4)
                a = int(np.frombuffer(data, np.int32)[0])
            results[slot] = a
            results[self.max_slots] += 1
        return self._finish(len(starts), rounds=0, invokes0=invokes0)


# -------------------------------------------------------------- AM handlers
def _chase_am_handler(pe: PE, payload: bytes) -> None:
    """Pre-deployed chase step (the Active Message baseline): identical
    logic to the Chaser ifunc, but as resident code + payload-only frames."""
    addr, depth, requester, slot = np.frombuffer(payload, np.int32)
    shard = pe.region("table_shard")
    shard_id, shard_size, _ = pe.caps["shard_meta"]
    base = int(shard_id) * int(shard_size)
    a, d = int(addr), int(depth)
    while d > 0 and a // int(shard_size) == int(shard_id):
        a = int(shard[a - base])
        d -= 1
    if d == 0:
        pe.send_am(pe.peers[int(requester)], "chase_result", np.array([slot, a], np.int32))
    else:
        pe.send_am(
            pe.peers[a // int(shard_size)],
            "chase",
            np.array([a, d, requester, slot], np.int32),
        )


def _chase_result_am_handler(pe: PE, payload: bytes) -> None:
    slot, value = np.frombuffer(payload, np.int32)
    res = pe.region("results")
    res[slot] = value
    res[-1] += 1
