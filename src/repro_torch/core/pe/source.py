"""Source layer: ifunc handles and the toolchain artifact registry.

Source side, an :class:`IFunc` couples an entry function (a pure function
on tensors) with its fat-bitcode archive (``torch.export`` blobs for every
toolchain target, Sec. III-C) and its dependency list (Sec. III-C
``.deps``).  Nothing here touches the wire: frames are *built* by
:meth:`IFunc.make_frame` and moved by the wire layer
(:mod:`repro_torch.core.pe.wire`).

Dependency tags (the wire ``DEPS`` list, Sec. III-C):

* ``abi:<update|xrdma|propagate|pure>`` — invoke convention (see
  :mod:`repro_torch.core.pe.exec` for the action protocol).
* ``region:<name>`` — link the PE's registered memory region as an argument.
* ``cap:<name>``    — link a host capability (small constant array, e.g.
  shard metadata) as an argument.
* ``returns:<ifunc>`` / ``spawn:<ifunc>`` — ifunc types this code may emit;
  resolved through the PE's source registry / toolchain at action time.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable, Sequence

from ..bitcode import DEFAULT_TOOLCHAIN_TARGETS, FatBitcode, ShapeDtypeStruct
from ..dataplane import SlabLayout
from ..frame import Frame, FrameKind


@dataclass
class IFunc:
    """Source-side handle: name + fat-bitcode + deps (paper Fig. 1 register)."""

    name: str
    fat: FatBitcode
    deps: tuple[str, ...]
    abi: str
    payload_aval: ShapeDtypeStruct
    kind: FrameKind = FrameKind.BITCODE
    # Optional zero-copy layout for RETURN-type ifuncs: lets a sender map
    # this ifunc's payload onto one-sided slab writes instead of a frame.
    # Sender-side only — never travels on the wire, never affects digest.
    slab: SlabLayout | None = None

    # an archive is built once and never edited: serialize and hash it once,
    # not on every frame (a torch.export archive runs to hundreds of KB)
    @cached_property
    def code_bytes(self) -> bytes:
        return self.fat.to_bytes()

    @cached_property
    def digest(self) -> bytes:
        return hashlib.sha256(self.code_bytes).digest()

    @classmethod
    def build(
        cls,
        name: str,
        fn: Callable[..., Any],
        payload_aval: ShapeDtypeStruct,
        dep_avals: Sequence[ShapeDtypeStruct] = (),
        deps: Sequence[str] = (),
        abi: str = "pure",
        targets: Sequence[str] = DEFAULT_TOOLCHAIN_TARGETS,
        kind: FrameKind = FrameKind.BITCODE,
        fn_by_platform=None,
        slab: SlabLayout | None = None,
    ) -> "IFunc":
        """Run the Three-Chains toolchain: cross-compile ``fn`` for every
        target triple into a fat-bitcode archive.

        ``kind=BINARY`` models Sec. III-B: the archive holds exactly one
        slice (the source machine's own triple) and the target will refuse
        a triple mismatch instead of re-lowering.  ``fn_by_platform``
        optionally swaps the entry per platform (see FatBitcode.build).
        """
        if kind == FrameKind.BINARY and len(targets) != 1:
            raise ValueError("binary ifuncs are single-triple by definition")
        fat = FatBitcode.build(
            fn, (payload_aval, *dep_avals), targets=targets,
            fn_by_platform=fn_by_platform,
        )
        wire_deps = (f"abi:{abi}", *deps)
        return cls(
            name=name,
            fat=fat,
            deps=wire_deps,
            abi=abi,
            payload_aval=payload_aval,
            kind=kind,
            slab=slab,
        )

    def make_frame(self, payload: bytes, seq: int = 0) -> Frame:
        return Frame(
            kind=self.kind,
            name=self.name,
            payload=payload,
            code=self.code_bytes,
            deps=self.deps,
            digest=self.digest,
            seq=seq,
        )


class Toolchain:
    """The shared filesystem of toolchain artifacts (paper Fig. 1: generated
    files 'placed in a directory that can be located by Three-Chains').

    Any PE may *register as a sender* from here — that is how a server that
    received a Chaser can emit a ReturnResult it never received over the
    wire, just as the paper's SPMD app binaries can register any ifunc
    library present on their local disk.  What is NOT pre-deployed is the
    target-side executable: code still travels in frames and installs via
    the cache protocol.
    """

    def __init__(self) -> None:
        self._artifacts: dict[str, IFunc] = {}

    def publish(self, ifunc: IFunc) -> IFunc:
        self._artifacts[ifunc.name] = ifunc
        return ifunc

    def lookup(self, name: str) -> IFunc:
        return self._artifacts[name]

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._artifacts))
