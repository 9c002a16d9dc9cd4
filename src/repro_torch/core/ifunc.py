"""ifuncs: injected functions — code that travels with the message.

.. note::
   This module is a **stable re-export facade**.  The runtime it used to
   hold in one file now lives in the layered package :mod:`repro_torch.core.pe`:

   * :mod:`repro_torch.core.pe.source`    — :class:`IFunc`, :class:`Toolchain`
   * :mod:`repro_torch.core.pe.wire`      — frame egress, batching queues,
     coalesced flush, rendezvous staging, credit-based flow control
   * :mod:`repro_torch.core.pe.codecache` — install + digest validation +
     bucketed batched executables
   * :mod:`repro_torch.core.pe.exec`      — invoke, masked-scan update ABI, the
     X-RDMA action protocol (and its ``A_*`` constants)
   * :mod:`repro_torch.core.pe.progress`  — the :class:`ProgressEngine` poll
     loop: priority lanes, per-poll budget, credit return
   * :mod:`repro_torch.core.pe.cq`        — :class:`CompletionQueue`,
     :class:`GatherFuture`
   * :mod:`repro_torch.core.pe.pe`        — the thin :class:`PE` facade

   Every name importable from here before the split stays importable from
   here (``from repro_torch.core.ifunc import PE, CompletionQueue, GatherFuture,
   IFunc`` keeps working); new code should import
   from :mod:`repro_torch.core` or the specific layer.

Source side, an :class:`IFunc` couples an entry function (a pure function
on tensors) with its fat-bitcode archive (``torch.export`` blobs for every
toolchain target, Sec. III-C) and its dependency list (Sec. III-C
``.deps``).  Target side, a :class:`PE` (processing element) polls its
endpoint, installs arriving code (extract slice -> load -> move to the
PE's device -> digest cache) and invokes it.  The ABI the runtime and
injected code meet at — the action protocol, the ``update``/``xrdma``/
``propagate`` conventions, the dependency tags — is documented in
:mod:`repro_torch.core.pe.exec` and :mod:`repro_torch.core.pe.source`.
"""

from __future__ import annotations

from .frame import ProtocolError  # historical re-export (its first home)
from .pe import (
    ACTION_WIDTH,
    A_DONE,
    A_FORWARD,
    A_NOP,
    A_PUBLISH,
    A_RETURN,
    A_SPAWN,
    CompletionQueue,
    GatherFuture,
    IFunc,
    ISAMismatch,
    PE,
    PEStats,
    RNDV_STAGING_DEPTH,
    Toolchain,
)

__all__ = [
    "ACTION_WIDTH",
    "A_DONE",
    "A_FORWARD",
    "A_NOP",
    "A_PUBLISH",
    "A_RETURN",
    "A_SPAWN",
    "CompletionQueue",
    "GatherFuture",
    "IFunc",
    "ISAMismatch",
    "PE",
    "PEStats",
    "ProtocolError",
    "RNDV_STAGING_DEPTH",
    "Toolchain",
]
