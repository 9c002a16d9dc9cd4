"""Layered PE runtime — the processing-element side of Three-Chains.

Layering (each module imports downward only; the facade composes them):

  source     — IFunc handles + Toolchain artifact registry (source side)
  wire       — frame egress: batching queues, coalesced flush, rendezvous
               staging, per-peer credit-based flow control
  codecache  — install/digest-validate arriving code, bucketed batched
               executables over the TargetCodeCache
  exec       — invoke + masked-scan update ABI + the X-RDMA action protocol
  progress   — the ProgressEngine poll loop: priority lanes, per-poll
               budget, credit return
  cq         — completion queues + futures for overlapped submissions
  pe         — the thin PE facade wiring the layers together

:mod:`repro_torch.core.ifunc` re-exports everything here; that import surface is
guaranteed stable (``from repro_torch.core.ifunc import PE, ...`` keeps working).
"""

from .codecache import CodeCacheLayer, ISAMismatch
from .cq import CompletionQueue, GatherFuture
from .exec import (
    ACTION_WIDTH,
    A_DONE,
    A_FORWARD,
    A_NOP,
    A_PUBLISH,
    A_RETURN,
    A_SPAWN,
    ExecLayer,
    dep_named,
    region_arg_pos,
)
from .pe import PE, PEStats
from .progress import ProgressEngine
from .source import IFunc, Toolchain
from .wire import RNDV_STAGING_DEPTH, WireLayer, is_control

__all__ = [
    "ACTION_WIDTH",
    "A_DONE",
    "A_FORWARD",
    "A_NOP",
    "A_PUBLISH",
    "A_RETURN",
    "A_SPAWN",
    "CodeCacheLayer",
    "CompletionQueue",
    "ExecLayer",
    "GatherFuture",
    "IFunc",
    "ISAMismatch",
    "PE",
    "PEStats",
    "ProgressEngine",
    "RNDV_STAGING_DEPTH",
    "Toolchain",
    "WireLayer",
    "dep_named",
    "is_control",
    "region_arg_pos",
]
