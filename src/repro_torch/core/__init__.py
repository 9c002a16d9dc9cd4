"""Three-Chains core, in PyTorch: code+data movement over a (simulated)
RDMA fabric.

Public API re-exports.  Layering:

  transport  — fabric, endpoints, one-sided PUT/GET, wire models
  frame      — message frames + truncation protocol (Figs. 2/3) + hop headers
  bitcode    — fat-bitcode archives over torch.export blobs (Sec. III-C)
  cache      — SenderCache / TargetCodeCache (Sec. III-D, Fig. 4)
  propagate  — spanning-tree multicast shapes + completion model (Sec. I)
  pe         — the layered PE runtime: source / wire / codecache / exec /
               progress layers + CompletionQueue + the PE facade
               (re-exported by the stable `ifunc` module)
  reliability — exactly-once delivery config: seq/ack windows, retransmit
               timers, failure detection knobs
  verify     — safe code injection: install-time verifier + runtime
               resource sandbox (capability stamps, quotas, quarantine)
  xrdma      — Chaser / ReturnResult / TSI / Spawner / Gatherer /
               GatherReturn / Filter / FilterReturn / Reducer / Gossiper
  cluster    — in-process cluster + deterministic scheduler
  pointer_chase — the DAPC miniapp (bitcode / binary / AM) + GBPC baseline
"""

from .bitcode import (
    BitcodeSlice, FatBitcode, ShapeDtypeStruct, local_triple, platform_of, resolve_device,
)
from .cache import CacheStats, SenderCache, TargetCodeCache
from .cluster import Cluster
from .dataplane import DataPlaneConfig, SlabLayout
from .frame import (
    MAGIC,
    CorruptFrame,
    Frame,
    FrameFlags,
    FrameKind,
    HopHeader,
    ProtocolError,
    coalesce,
    delivery_complete,
    pack_hop,
    peek_header,
    split_hop,
    split_payloads,
    unpack,
    unpack_hop,
)
from .pe import (
    ACTION_WIDTH,
    A_DONE,
    A_FORWARD,
    A_NOP,
    A_PUBLISH,
    A_RETURN,
    A_SPAWN,
    PE,
    CompletionQueue,
    GatherFuture,
    IFunc,
    ISAMismatch,
    PEStats,
    ProgressEngine,
    Toolchain,
    WireLayer,
)
from .pointer_chase import ChaseReport, PointerChaseApp, chase_ref, make_chain
from .propagate import (
    PropagationConfig,
    subtree_sizes,
    tree_children,
    tree_children_map,
    tree_completion_us,
    tree_depth,
    tree_parent,
)
from .reliability import ReliabilityConfig
from .transport import (
    MEM_BW_BUS,
    MEM_BW_CLASS,
    TRIPLE_WIRE,
    WIRE_PROFILES,
    Capability,
    Endpoint,
    EndpointDead,
    Fabric,
    RegionWrite,
    WireModel,
)
from .verify import CapabilityStamp, SandboxConfig, SandboxViolation, Verifier
from .xrdma import (
    make_chaser,
    make_filter,
    make_filter_return,
    make_gather_return,
    make_gatherer,
    make_gossiper,
    make_reducer,
    make_return_result,
    make_spawner,
    make_tsi,
)

__all__ = [
    "ACTION_WIDTH", "A_DONE", "A_FORWARD", "A_NOP", "A_PUBLISH", "A_RETURN",
    "A_SPAWN", "BitcodeSlice", "CacheStats", "Capability", "CapabilityStamp",
    "ChaseReport", "Cluster", "CompletionQueue", "CorruptFrame", "DataPlaneConfig", "Endpoint",
    "EndpointDead", "Fabric", "FatBitcode", "Frame", "FrameFlags", "FrameKind",
    "GatherFuture", "HopHeader", "IFunc", "ISAMismatch", "MAGIC", "MEM_BW_BUS",
    "MEM_BW_CLASS", "PE", "PEStats", "ProgressEngine", "PropagationConfig",
    "ProtocolError", "RegionWrite", "ReliabilityConfig", "SandboxConfig",
    "SandboxViolation", "SenderCache", "ShapeDtypeStruct", "SlabLayout",
    "TRIPLE_WIRE", "TargetCodeCache", "Toolchain", "Verifier", "WIRE_PROFILES",
    "PointerChaseApp", "WireLayer", "WireModel", "chase_ref", "coalesce",
    "delivery_complete", "local_triple", "make_chain", "make_chaser",
    "make_filter", "make_filter_return", "make_gather_return", "make_gatherer",
    "make_gossiper", "make_reducer", "make_return_result", "make_spawner",
    "make_tsi", "pack_hop", "peek_header", "platform_of", "resolve_device",
    "split_hop", "split_payloads", "subtree_sizes", "tree_children",
    "tree_children_map", "tree_completion_us", "tree_depth", "tree_parent",
    "unpack", "unpack_hop",
]
