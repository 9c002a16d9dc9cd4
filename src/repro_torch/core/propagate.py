"""Recursive code propagation: spanning-tree multicast of injected code.

The paper's signature claim (Sec. I) is that remotely injected code "can
recursively propagate itself to other remote machines": a PE that installs
shipped code may re-publish it onward, so distributing one ifunc to N peers
costs the source O(log N) sends instead of O(N) point-to-point pushes.
This module holds the *shape* of that propagation:

* :class:`PropagationConfig` — per-PE policy (tree topology, fanout, ttl),
  threaded through :class:`repro_torch.core.cluster.Cluster` exactly like
  :class:`repro_torch.core.dataplane.DataPlaneConfig`.
* tree math — binomial and k-ary spanning trees over the cluster's dense
  peer-index space, rooted at *any* peer (indices are relabeled
  ``(i - root) mod n`` so one rule serves every root).
* :func:`tree_completion_us` — the LogP-style completion-time model for a
  multicast: a sender injects successive child frames ``o_us`` apart, each
  hop pays ``alpha_us`` latency, and subtrees proceed in parallel.  This is
  the quantity a tree wins on: the *serial* wire-byte total of tree and
  flat push is identical (every PE receives the code once either way, plus
  the tree's small hop headers), but the root's NIC stops being the serial
  bottleneck.

Wire-format counterpart: :class:`repro_torch.core.frame.HopHeader` (ttl + path
digest); runtime counterpart: the PUBLISH path in
:mod:`repro_torch.core.pe.progress` (target side) and the publish fan-out on the
:mod:`repro_torch.core.pe.pe` facade (source side).

Safety counterpart: :mod:`repro_torch.core.verify`.  Under a sandbox the
verifier caps recursive propagation *below* this module's ttl: a digest's
capability stamp records ``min(SandboxConfig.max_publish_ttl, admitting
hop's ttl)``, so shipped code re-publishing itself (A_PUBLISH) can spend
hops but never re-mint a budget larger than the one it arrived with —
``DEFAULT_TTL`` here is the ceiling an *unsandboxed* publish starts from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

from .transport import WireModel

#: Default remaining-hop budget for a fresh publish: covers a binomial tree
#: of 2^16 PEs or a binary k-ary tree 16 levels deep — deep enough for any
#: cluster this runtime simulates, small enough to strangle a forwarding
#: loop that somehow survives the path-based cycle refusal.
DEFAULT_TTL = 16

BINOMIAL = 0  #: wire k-code for the binomial tree (HopHeader.k == 0)


@dataclass(frozen=True)
class PropagationConfig:
    """Per-PE propagation policy (all trees are over the dense peer-index
    space X-RDMA action vectors use).

    ``topology`` — ``"binomial"`` (fanout falls with depth: peer 2^j gets
    its subtree early and keeps the root's NIC busy exactly ``ceil(log2 n)``
    sends) or ``"kary"`` (fixed fanout ``k``: shallower trees for small
    ``n``, bounded per-node send burst).
    ``ttl`` — hop budget stamped into fresh publishes from this PE.
    """

    topology: str = "binomial"
    k: int = 2
    ttl: int = DEFAULT_TTL

    def __post_init__(self) -> None:
        if self.topology not in ("binomial", "kary"):
            raise ValueError(f"unknown tree topology {self.topology!r}")
        if self.topology == "kary" and self.k < 1:
            raise ValueError("k-ary tree needs k >= 1")
        if not 1 <= self.ttl <= 255:
            raise ValueError("ttl must fit the hop header's u8")

    @property
    def k_code(self) -> int:
        """The tree-shape byte that travels in the hop header."""
        return BINOMIAL if self.topology == "binomial" else self.k

    # convenience pass-throughs so callers hold one object
    def children(self, root: int, me: int, n: int) -> list[int]:
        return tree_children(self.k_code, root, me, n)

    def parent(self, root: int, me: int, n: int) -> int:
        return tree_parent(self.k_code, root, me, n)


# ------------------------------------------------------------- tree shapes
def _binomial_children_label(l: int, n: int) -> list[int]:
    """Children of label ``l`` in the binomial broadcast tree over labels
    0..n-1: ``l + 2^j`` for ascending j below ``l``'s lowest set bit (the
    root, label 0, parents every power of two)."""
    limit = (l & -l) if l else 1 << max(n - 1, 1).bit_length()
    out, j = [], 1
    while j < limit and l + j < n:
        out.append(l + j)
        j <<= 1
    return out


def _binomial_parent_label(l: int) -> int:
    """Parent of label ``l``: clear its lowest set bit (root parents itself)."""
    return l - (l & -l) if l else 0


def _kary_children_label(l: int, n: int, k: int) -> list[int]:
    return [c for c in range(k * l + 1, k * l + k + 1) if c < n]


def _kary_parent_label(l: int, k: int) -> int:
    return (l - 1) // k if l else 0


def tree_children(k_code: int, root: int, me: int, n: int) -> list[int]:
    """Peer indices ``me`` re-publishes to, in the tree rooted at ``root``
    over ``n`` peers (``k_code`` 0 = binomial, else k-ary fanout)."""
    l = (me - root) % n
    labels = (
        _binomial_children_label(l, n)
        if k_code == BINOMIAL
        else _kary_children_label(l, n, k_code)
    )
    return [(c + root) % n for c in labels]


def tree_parent(k_code: int, root: int, me: int, n: int) -> int:
    """Peer index ``me`` reports to (``root`` maps to itself)."""
    l = (me - root) % n
    p = (
        _binomial_parent_label(l)
        if k_code == BINOMIAL
        else _kary_parent_label(l, k_code)
    )
    return (p + root) % n


def tree_children_map(k_code: int, root: int, n: int) -> dict[int, list[int]]:
    """The whole tree at once: peer index -> list of child peer indices."""
    return {i: tree_children(k_code, root, i, n) for i in range(n)}


def subtree_sizes(k_code: int, root: int, n: int) -> dict[int, int]:
    """Peer index -> number of tree nodes in its subtree (itself included).
    This is the contribution count a reduction over the same tree expects
    from each node before it may fold upward."""
    children = tree_children_map(k_code, root, n)
    sizes: dict[int, int] = {}

    def size(i: int) -> int:
        if i not in sizes:
            sizes[i] = 1 + sum(size(c) for c in children[i])
        return sizes[i]

    size(root)
    assert len(sizes) == n and sizes[root] == n, "tree does not span the peers"
    return sizes


def tree_depth(k_code: int, root: int, n: int) -> int:
    """Longest root-to-leaf hop count (the ttl a full-coverage publish needs)."""
    children = tree_children_map(k_code, root, n)

    def depth(i: int) -> int:
        return 1 + max((depth(c) for c in children[i]), default=-1)

    return depth(root)


# --------------------------------------------------- completion-time model
def tree_completion_us(
    wire: WireModel,
    children: Mapping[int, Sequence[int]],
    root: int,
    edge_nbytes: Callable[[int, int], int],
) -> float:
    """Modeled multicast completion time over an arbitrary rooted tree.

    LogP-style: a node sends to its children back-to-back (successive
    injections ``inverse_throughput_us`` apart — gap + bytes at the
    pipelined bandwidth), each frame then pays the ``alpha_us`` wire hop,
    and every subtree proceeds in parallel from its own arrival time.
    ``edge_nbytes(parent, child)`` supplies the per-edge frame size (cold
    edges carry code, warm edges a digest-only frame).  A flat push is the
    same model over a star tree — which is exactly why it loses: the root
    serializes all N injections while the tree amortizes them down the
    levels.
    """
    arrive = {root: 0.0}
    stack = [root]
    while stack:
        p = stack.pop()
        t = arrive[p]
        for c in children.get(p, ()):  # send order = tree child order
            t += wire.inverse_throughput_us(edge_nbytes(p, c))
            arrive[c] = t + wire.alpha_us
            stack.append(c)
    return max(arrive.values())
