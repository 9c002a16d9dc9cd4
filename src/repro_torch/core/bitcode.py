"""Fat-bitcode: multi-target portable code archives.

The paper ships LLVM bitcode compiled for every ISA the ifunc may land on
("fat-bitcode", Fig. 3) so the target can extract the slice matching its own
triple and JIT-optimize it for the local microarchitecture.

Here a slice is a ``torch.export`` ExportedProgram serialized with
``torch.export.save``: a device-neutral ATen graph that the *target* loads,
moves onto its own device and runs.  A :class:`FatBitcode` maps target
triples (e.g. ``cpu-host``, ``cuda-sm90``) to those blobs inside the same
``FBC1`` archive layout as the JAX package, so archives cross-parse;
archives are content-addressed by a sha256 digest, which is what the
caching protocol (frame truncation + target code cache) keys on.

A slice may call a hand-written kernel through a named custom op (the
Gatherer's ``cuda-sm90`` slice calls ``repro_torch::embed_lookup``).  The
graph records the op by name only; loading the slice on a target resolves
it against the op registered by :mod:`repro_torch.kernels` — the
target-side link step.
"""

from __future__ import annotations

import hashlib
import io
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from .frame import CorruptFrame

# Target triples -> the device platform the slice runs on.  ``mcpu``-style
# variants of one platform share a slice body (the target specializes at
# load time); ``cuda-sm90`` is a Hopper card (compute capability 9.0), whose
# slice may carry the hand-written CUDA kernels.  Every slice is traced on
# the host and generated here whatever the local device is — the paper's
# cross-compilation of AArch64 bitcode on a Xeon.
_TRIPLE_PLATFORM: dict[str, str] = {
    "cpu-host": "cpu",
    "cpu-a64fx": "cpu",
    "cpu-bf2": "cpu",
    "cuda-sm90": "cuda",
}

DEFAULT_TOOLCHAIN_TARGETS: tuple[str, ...] = ("cpu-host", "cuda-sm90")

_MAGIC = b"FBC1"


def platform_of(triple: str) -> str:
    try:
        return _TRIPLE_PLATFORM[triple]
    except KeyError:
        raise ValueError(f"unknown target triple: {triple!r}") from None


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default; the CPU
    only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run it on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def local_triple(device: "torch.device | str | None" = None) -> str:
    """The triple of a processing element running on ``device`` (default:
    the current CUDA device when there is one, else the host)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu-host"
    if device.type == "cuda":
        cap = torch.cuda.get_device_capability(device)
        if cap == (9, 0):
            return "cuda-sm90"
        raise ValueError(f"no target triple for a CUDA device of capability {cap}")
    raise ValueError(f"no target triple for device {device}")


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """Static shape + dtype of one entry argument (the toolchain's aval)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy dtype payload bytes decode as on the host."""
        return np.dtype(str(self.dtype).removeprefix("torch."))

    def example(self) -> torch.Tensor:
        # uninitialised host memory: export only reads shape and dtype, so a
        # full-width shard costs address space, not a fill
        return torch.empty(self.shape, dtype=self.dtype)


@dataclass(frozen=True)
class BitcodeSlice:
    """One target's worth of code: the analogue of a single .bc file."""

    triple: str
    blob: bytes

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.blob).hexdigest()


class _Entry(torch.nn.Module):
    """Module shell so ``torch.export`` can trace a plain entry function."""

    def __init__(self, fn: Callable[..., Any]) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_blob(fn: Callable[..., Any], in_avals: Sequence[ShapeDtypeStruct]) -> bytes:
    """Trace ``fn`` at ``in_avals`` and serialize the ExportedProgram."""
    ep = torch.export.export(_Entry(fn), tuple(a.example() for a in in_avals))
    # save() would otherwise ship the example tensors inside the slice: a
    # full-width shard placeholder is hundreds of MiB of code frame
    ep.example_inputs = None
    # ... and each node's stack trace, which names the tracing checkout's
    # absolute source paths: the slice's bytes, hence its digest (what the
    # caches key on) and its code-frame size, must not depend on where the
    # tree lives
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                node.meta.pop("stack_trace", None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


@dataclass
class FatBitcode:
    """Archive of per-triple export blobs (paper Fig. 3 BITCODE fields)."""

    slices: dict[str, bytes] = field(default_factory=dict)

    # -- construction -------------------------------------------------------
    @classmethod
    def build(
        cls,
        fn: Callable[..., Any],
        in_avals: Sequence[ShapeDtypeStruct],
        targets: Sequence[str] = DEFAULT_TOOLCHAIN_TARGETS,
        fn_by_platform: Mapping[str, Callable[..., Any]] | None = None,
    ) -> "FatBitcode":
        """Cross-compile ``fn`` for every toolchain target.

        Mirrors "the Three-Chains toolchain will generate bitcode files for
        all the targets supported by the toolchain's Clang compiler".

        ``fn_by_platform`` optionally overrides the entry per *platform*
        (``"cpu"``/``"cuda"``) or per exact *triple* (``"cpu-bf2"``): the
        toolchain analogue of per-ISA intrinsics behind one source — the
        Gatherer ships the CUDA ``embed_lookup`` kernel in its ``cuda-sm90``
        slice and the masked-take body everywhere else.  A triple key wins
        over its platform key.  Every slice must compute the same function;
        only the body differs.  Triples that resolve to the same entry share
        one trace (the export is device-neutral).
        """
        overrides = dict(fn_by_platform or {})
        blobs: dict[int, bytes] = {}
        slices: dict[str, bytes] = {}
        for triple in targets:
            entry = overrides.get(triple, overrides.get(platform_of(triple), fn))
            if id(entry) not in blobs:
                blobs[id(entry)] = export_blob(entry, in_avals)
            slices[triple] = blobs[id(entry)]
        return cls(slices=slices)

    # -- the wire format ----------------------------------------------------
    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        out.write(_MAGIC)
        out.write(struct.pack("<H", len(self.slices)))
        for triple in sorted(self.slices):
            blob = self.slices[triple]
            t = triple.encode()
            out.write(struct.pack("<HI", len(t), len(blob)))
            out.write(t)
            out.write(blob)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "FatBitcode":
        """Parse one archive; anything malformed — truncated slice table,
        undecodable triple, lengths past the end of the buffer — is a loud
        :class:`~repro_torch.core.frame.CorruptFrame`, never a struct/index/
        decode error leaking out of a hostile frame."""
        if data[:4] != _MAGIC:
            raise CorruptFrame("not a fat-bitcode archive")
        if len(data) < 6:
            raise CorruptFrame("corrupt fat-bitcode: truncated slice count")
        (n,) = struct.unpack_from("<H", data, 4)
        off = 6
        slices: dict[str, bytes] = {}
        for _ in range(n):
            if len(data) < off + 6:
                raise CorruptFrame("corrupt fat-bitcode: truncated slice header")
            tlen, blen = struct.unpack_from("<HI", data, off)
            off += 6
            if len(data) < off + tlen + blen:
                raise CorruptFrame("corrupt fat-bitcode: slice exceeds archive")
            try:
                triple = data[off : off + tlen].decode()
            except UnicodeDecodeError as e:
                raise CorruptFrame(
                    f"corrupt fat-bitcode: undecodable triple ({e})"
                ) from None
            off += tlen
            slices[triple] = data[off : off + blen]
            off += blen
        return cls(slices=slices)

    # -- target-side extraction --------------------------------------------
    def extract(self, triple: str | None = None) -> BitcodeSlice:
        """Pick the slice matching the local target triple.

        Falls back to any slice with the same *platform* (µarch variants of
        one ISA share bitcode; the target specializes at load time).
        """
        triple = triple or local_triple()
        if triple in self.slices:
            return BitcodeSlice(triple, self.slices[triple])
        want = platform_of(triple)
        for t, blob in sorted(self.slices.items()):
            if platform_of(t) == want:
                return BitcodeSlice(t, blob)
        raise LookupError(
            f"fat-bitcode has no slice for {triple!r} (have {sorted(self.slices)})"
        )

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()

    @property
    def nbytes(self) -> int:
        return len(self.to_bytes())

    def triples(self) -> tuple[str, ...]:
        return tuple(sorted(self.slices))


def in_avals_of(ep: torch.export.ExportedProgram) -> tuple[ShapeDtypeStruct, ...]:
    """The user-input avals of a loaded program, in call order."""
    return tuple(
        ShapeDtypeStruct(tuple(spec_val.shape), spec_val.dtype)
        for spec_val in (
            n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"
        )
    )


def load_program(
    blob: bytes, device: "torch.device | str | None" = None
) -> torch.export.ExportedProgram:
    """Deserialize one slice and move it onto ``device`` (default: the card,
    see :func:`resolve_device`).

    A trace records the device of every tensor it creates (``arange``,
    constants, dtype-conversion asserts) as the host's; the move pass
    rewrites them so the program runs on the PE's own device.  Custom ops
    in the graph resolve by name against the registered kernels."""
    from .. import kernels  # noqa: F401  (registers the custom ops: link step)

    device = resolve_device(device)
    ep = torch.export.load(io.BytesIO(blob))
    return move_to_device_pass(ep, device)


def deserialize_and_jit(
    blob: bytes, device: "torch.device | str | None" = None
) -> tuple[Callable[..., Any], tuple]:
    """Target-side ORC-JIT analogue: load a slice onto the PE's device.

    Returns (callable, in_avals).  PyTorch runs the loaded graph eagerly, so
    the "compile" is the load and device move; the result is what
    :class:`repro_torch.core.cache.TargetCodeCache` keeps alive across
    messages.
    """
    ep = load_program(blob, device)
    return ep.module(), in_avals_of(ep)


def deserialize_eager(
    blob: bytes, device: "torch.device | str | None" = None
) -> tuple[Callable[..., Any], tuple]:
    """Binary-mode analogue: code arrives ready-to-run, no target JIT.

    The port runs both renderings eagerly, so this is the same load as
    :func:`deserialize_and_jit`; it stays a separate name for the binary
    ifunc path (Sec. III-B).
    """
    return deserialize_and_jit(blob, device)
