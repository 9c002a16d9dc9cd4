"""X-RDMA multi-hop tree collectives over the simulated fabric (the
runtime where code really travels, paper Sec. I).

* :func:`xrdma_bcast` — tree multicast of one ifunc (code + payload) with
  O(log N) root dispatches, subtree re-parenting for mid-tree deaths, and
  a LogP-style completion-time model for the A/B against
  :func:`xrdma_flat_push` (the O(N) point-to-point baseline).
* :func:`xrdma_reduce` — the inverse flow: every PE contributes a local
  vector, children FORWARD partials that fold into their parent's
  accumulator through the propagate ABI (one dispatch per arrived group
  under the batched runtime), and the folded partial forwards up only when
  the subtree is complete.

Compiled-mesh side (over a :class:`~repro_torch.sharding.mesh.Mesh`, the
gradient reductions of the JAX package's launch layer):

* :func:`hierarchical_psum` — two-level gradient reduction for multi-pod
  meshes: reduce fully inside the pod first, then once across pods.
* :func:`compressed_psum_with_feedback` — int8 error-feedback compression:
  agree one scale over the axis (a scalar pmax), quantize to int8, sum the
  int8 values as int32 (the reference accumulates in int32, so the
  all-reduce carries 4 B a value, as f32 does), dequantize, and carry each
  rank's rounding residual into the next step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..core import Cluster, IFunc, PropagationConfig
from ..core.frame import Frame, hop_nbytes
from ..core.propagate import (
    subtree_sizes,
    tree_children_map,
    tree_completion_us,
    tree_parent,
)
from ..core.transport import WireReportMixin
from ..core.xrdma import make_reducer
from .mesh import Axes, Mesh


# ======================================================================
# Compiled-mesh gradient reductions
# ======================================================================
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def hierarchical_psum(tree, axes: tuple[str, ...], mesh: Mesh):
    """psum every tensor of ``tree`` innermost-first: ``("pod", "data")``
    reduces over data, then over pod."""

    def red(x: torch.Tensor) -> torch.Tensor:
        for ax in reversed(axes):
            x = mesh.psum(x, ax)
        return x

    return _tree_map(red, tree)


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round, like jnp.round, rounds half to even
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x = x.float()
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_with_feedback(
    grad: torch.Tensor, err: torch.Tensor, axis: Axes, mesh: Mesh
) -> tuple[torch.Tensor, torch.Tensor]:
    """One tensor's compressed all-reduce over ``axis`` with error feedback.

    Returns (reduced_grad_f32, new_error).  The scale is agreed over the
    axis first (a scalar pmax), so every rank's int8 units mean the same
    thing and the int32-accumulated sum dequantizes exactly; each rank
    carries its own rounding residual forward.  The f32 operations run in
    the JAX package's order, so both give the same bits; under ``jit``
    XLA fuses the residual ``g - q * scale`` into one multiply-add, rounded
    once, which the port computes exactly in f64 (``q * scale`` takes 32
    bits and ``g`` lies within ``scale / 2`` of it) and rounds once."""
    g = grad.float() + err
    amax = mesh.pmax(g.abs().max(), axis)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = _quantize(g, scale)
    new_err = (g.double() - q.double() * scale.double()).float()
    acc = mesh.psum(q.to(torch.int32), axis)
    return acc.float() * scale, new_err


def init_error_feedback(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


# ======================================================================
# X-RDMA multi-hop collectives (the runtime where code really travels)
# ======================================================================


@dataclass
class PropagateReport(WireReportMixin):
    """Accounting for one multicast (tree or flat) over the fabric.

    ``modeled_completion_us`` is the LogP-style *parallel* completion time
    (see :func:`repro_torch.core.propagate.tree_completion_us`) — the number the
    tree wins on; ``modeled_us`` stays the fabric's serial wire-latency sum
    (the tree's is never lower: every PE still receives the code once, plus
    hop headers)."""

    covered: int  # targets that hold the code when the multicast settled
    n_targets: int  # alive non-root peers the multicast was meant to reach
    rounds: int
    client_sends: int  # frames the root itself dispatched
    client_code_sends: int  # of those, frames carrying code bytes
    publishes: int  # hop frames sent cluster-wide (root + re-publishes)
    publish_dupes: int
    publish_send_failures: int
    reparented: int  # orphaned-subtree members the root re-covered directly
    modeled_completion_us: float
    puts: int
    gets: int
    put_bytes: int
    get_bytes: int
    modeled_us: float
    coalesced_frames: int = 0
    coalesced_payloads: int = 0
    region_puts: int = 0
    region_put_bytes: int = 0
    hop_frames: int = 0
    wire_bytes_by_kind: dict = field(default_factory=dict)


@dataclass
class ReduceReport(WireReportMixin):
    """Accounting for one tree reduction."""

    result: np.ndarray  # (width,) folded int32 vector at the root
    rounds: int
    forwards: int  # upward partial FORWARDs (== inner tree nodes + leaves)
    puts: int
    gets: int
    put_bytes: int
    get_bytes: int
    modeled_us: float
    coalesced_frames: int = 0
    coalesced_payloads: int = 0
    region_puts: int = 0
    region_put_bytes: int = 0
    hop_frames: int = 0
    wire_bytes_by_kind: dict = field(default_factory=dict)


def _cluster_publish_stats(cluster: Cluster) -> dict[str, int]:
    out = {"publishes": 0, "publish_dupes": 0, "publish_send_failures": 0}
    for pe in cluster.pes():
        out["publishes"] += pe.stats.publishes
        out["publish_dupes"] += pe.stats.publish_dupes
        out["publish_send_failures"] += pe.stats.publish_send_failures
    return out


def _multicast_completion_us(
    cluster: Cluster,
    ifn: IFunc,
    inner_nbytes: int,
    children: dict[int, list[int]],
    root: int,
    hop_headers: bool,
) -> float:
    """Completion-time model for one multicast over ``children``: per-edge
    frame sizes from the sender-cache state *before* the frames move (cold
    edges pay the code section, warm edges a digest-only frame), hop-header
    bytes growing with the sender's tree depth."""
    pes = cluster.pes()
    depth: dict[int, int] = {root: 0}
    stack = [root]
    while stack:
        p = stack.pop()
        for c in children.get(p, ()):
            depth[c] = depth[p] + 1
            stack.append(c)
    code = ifn.code_bytes
    hexd = ifn.digest.hex()

    def edge_nbytes(p: int, c: int) -> int:
        extra = hop_nbytes(depth[p] + 1) if hop_headers else 0
        f = Frame(
            kind=ifn.kind,
            name=ifn.name,
            payload=b"\x00" * (extra + inner_nbytes),
            code=code,
            deps=ifn.deps,
        )
        warm = pes[p].sender_cache.has(pes[c].name, hexd)
        return f.cached_nbytes if warm else f.full_nbytes

    return tree_completion_us(cluster.fabric.wire, children, root, edge_nbytes)


def xrdma_bcast(
    cluster: Cluster,
    name: str,
    payload: np.ndarray | bytes = b"",
    *,
    config: PropagationConfig | None = None,
    ttl: int | None = None,
    reparent: bool = True,
    reset_stats: bool = True,
    max_rounds: int = 100_000,
) -> PropagateReport:
    """Tree multicast of one ifunc (code + payload) to every other peer.

    The root publishes only to its spanning-tree children — O(log N)
    dispatches for the binomial default — and every PE that installs the
    code re-publishes it one level down (``repro_torch.core.ifunc`` PUBLISH
    path).  An empty ``payload`` distributes code without invoking it; a
    non-empty payload is invoked at every covered PE.

    Fault handling lives in :meth:`repro_torch.core.cluster.Cluster.publish_and_cover`
    (shared with ``Cluster.distribute_code``): after the fabric settles,
    any alive peer still missing the code (its publish was dropped, or its
    tree parent died mid-hop) is re-covered by a *direct* root publish
    (``reparent=True``) — the orphaned subtree drains cleanly because
    re-parent publishes carry a fresh pub_id, and duplicates of the
    original publish that later surface are dropped by the dedup key.
    Unlike ``distribute_code`` this layer *reports* partial coverage
    instead of raising: a payload broadcast to the survivors is a result,
    not a protocol violation.
    """
    cfg = config or PropagationConfig()
    client = cluster.client
    ifn = client.resolve_source(name)
    pay = payload if isinstance(payload, bytes) else np.asarray(payload).tobytes()
    n = len(client.peers)
    root = cluster.client_index
    if reset_stats:
        cluster.fabric.stats.reset()
    sends0, code0 = client.stats.sends, client.stats.code_sends
    pub0 = _cluster_publish_stats(cluster)
    children = tree_children_map(cfg.k_code, root, n)
    modeled_completion = _multicast_completion_us(
        cluster, ifn, len(pay), children, root, hop_headers=True
    )
    n_targets = sum(1 for pe in cluster.servers if pe.endpoint.alive)
    rounds, reparented, still = cluster.publish_and_cover(
        name, pay, config=cfg, ttl=ttl, reparent=reparent, max_rounds=max_rounds
    )
    pub1 = _cluster_publish_stats(cluster)
    st = cluster.fabric.stats
    return PropagateReport(
        covered=n_targets - len(still),
        n_targets=n_targets,
        rounds=rounds,
        client_sends=client.stats.sends - sends0,
        client_code_sends=client.stats.code_sends - code0,
        publishes=pub1["publishes"] - pub0["publishes"],
        publish_dupes=pub1["publish_dupes"] - pub0["publish_dupes"],
        publish_send_failures=pub1["publish_send_failures"]
        - pub0["publish_send_failures"],
        reparented=reparented,
        modeled_completion_us=modeled_completion,
        **st.report_kwargs(),
    )


def xrdma_flat_push(
    cluster: Cluster,
    name: str,
    payload: np.ndarray | bytes = b"",
    *,
    reset_stats: bool = True,
    max_rounds: int = 100_000,
) -> PropagateReport:
    """The O(N) baseline: the root pushes code + payload point-to-point to
    every alive peer itself (what every pre-propagation workload did).
    Reported through the same :class:`PropagateReport` so the A/B is
    column-for-column, with the completion model over the star tree."""
    client = cluster.client
    ifn = client.resolve_source(name)
    hexd = ifn.digest.hex()
    pay = payload if isinstance(payload, bytes) else np.asarray(payload).tobytes()
    root = cluster.client_index
    pes = cluster.pes()
    targets = [i for i, pe in enumerate(pes) if i != root and pe.endpoint.alive]
    if reset_stats:
        cluster.fabric.stats.reset()
    sends0, code0 = client.stats.sends, client.stats.code_sends
    star = {root: targets}
    modeled_completion = _multicast_completion_us(
        cluster, ifn, len(pay), star, root, hop_headers=False
    )
    for i in targets:
        client.send_ifunc(pes[i].name, name, pay)
    if client.batching:
        client.flush()
    rounds = cluster.drain_rounds(max_rounds)
    st = cluster.fabric.stats
    covered = sum(
        1 for i in targets if pes[i].target_cache.lookup_digest(hexd) is not None
    )
    return PropagateReport(
        covered=covered,
        n_targets=len(targets),
        rounds=rounds,
        client_sends=client.stats.sends - sends0,
        client_code_sends=client.stats.code_sends - code0,
        publishes=0,
        publish_dupes=0,
        publish_send_failures=0,
        reparented=0,
        modeled_completion_us=modeled_completion,
        **st.report_kwargs(),
    )


_reducer_for_width = lru_cache(maxsize=None)(make_reducer)


def xrdma_reduce(
    cluster: Cluster,
    values: np.ndarray,
    *,
    config: PropagationConfig | None = None,
    reset_stats: bool = True,
) -> ReduceReport:
    """Tree reduction: fold one int32 vector per PE down to the client.

    ``values`` is ``(n_servers + 1, width)`` — row ``i`` is peer ``i``'s
    contribution (the client's own row last, matching the cluster's peer
    indexing).  The reducer ifunc broadcasts down the same spanning tree
    (code + seed payload via :func:`xrdma_bcast`'s machinery), every PE
    folds its local ``reduce_src`` into its ``reduce_acc``, and each
    completed subtree FORWARDs its folded partial one hop up — children's
    partials folding at the parent through the propagate-ABI fold —
    until the root's count covers the whole cluster and it emits DONE.
    O(log N) hops deep, N-1 upward frames total, no O(N) client fan-in.
    """
    values = np.asarray(values, np.int32)
    n = cluster.n_servers + 1
    if values.shape[0] != n:
        raise ValueError(f"values must carry one row per peer ({n})")
    width = values.shape[1]
    cfg = config or PropagationConfig()
    cluster.set_propagation(cfg)
    root = cluster.client_index
    sizes = subtree_sizes(cfg.k_code, root, n)
    pes = cluster.pes()
    for i, pe in enumerate(pes):
        pe.register_region("reduce_acc", np.zeros(1 + width, np.int32))
        pe.register_region("reduce_src", values[i].copy())
        pe.register_cap(
            "reduce_meta",
            np.array(
                [sizes[i], tree_parent(cfg.k_code, root, i, n),
                 1 if i == root else 0],
                np.int32,
            ),
        )
    cluster.toolchain.publish(_reducer_for_width(width))
    if reset_stats:
        cluster.fabric.stats.reset()
    forwards0 = sum(pe.stats.forwards for pe in pes)
    seed = np.zeros(1 + width, np.int32)
    done0 = len(cluster.client.completed)
    # the root seeds its own contribution locally; the tree seeds the rest
    cluster.client.send_ifunc("client", "reducer", seed)
    cluster.client.publish_ifunc("reducer", seed, config=cfg)
    if cluster.client.batching:
        cluster.client.flush()
    rounds = cluster.run_until(lambda: len(cluster.client.completed) > done0)
    out = np.asarray(cluster.client.completed[-1], np.int32)
    assert out[0] == n, f"root folded {out[0]} of {n} contributions"
    st = cluster.fabric.stats
    return ReduceReport(
        result=out[1:].copy(),
        rounds=rounds,
        forwards=sum(pe.stats.forwards for pe in pes) - forwards0,
        **st.report_kwargs(),
    )
