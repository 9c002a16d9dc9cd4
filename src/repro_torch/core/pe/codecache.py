"""Code-cache layer: install arriving code, validate digests, and build
the batched (bucketed) executables the batched runtime dispatches.

Target side of Sec. III-C/D: extract the triple's slice from a fat-bitcode
archive -> load the ExportedProgram onto the PE's device -> digest cache,
with the name registry deciding whether a truncated (digest-only) frame is
acceptable and the digest deciding whether a name's code is *current*.
The batched renderings — ``torch.vmap`` for value ABIs, a masked loop for
the update ABI — are cached per (digest, power-of-two bucket) in
the same :class:`repro_torch.core.cache.TargetCodeCache`.
"""

from __future__ import annotations

import hashlib
import time

import torch

from ..bitcode import FatBitcode, in_avals_of, load_program, resolve_device
from ..cache import CachedExecutable, TargetCodeCache
from ..frame import Frame, FrameKind, ProtocolError
from .exec import region_arg_pos


class ISAMismatch(RuntimeError):
    """Binary ifunc landed on a PE whose triple it was not compiled for."""


class CodeCacheLayer:
    """Install/resolve/batch-compile for one PE's target code cache."""

    def __init__(
        self, name: str, triple: str, cache: TargetCodeCache, stats, verifier=None,
        device: "torch.device | str | None" = None,
    ) -> None:
        self.name = name
        self.triple = triple
        self.device = resolve_device(device)
        self.cache = cache
        self.stats = stats  # the PE's PEStats (shared across layers)
        self.verifier = verifier  # the PE's Verifier (None in bare tests)

    def _gate(self, name, digest_hex, deps, exported, admitted_ttl=None) -> None:
        """Run the install-time verifier over one code-cache ingress.  A
        stamped digest is a dict hit (the warm path the benchmark pins at
        zero cost); a quarantined or failing one raises SandboxViolation
        before the code becomes resolvable."""
        ver = self.verifier
        if ver is not None and ver.config.enabled:
            ver.admit(name, digest_hex, deps, exported, admitted_ttl)

    # --- install ----------------------------------------------------------
    def install(
        self, frame: Frame, admitted_ttl: int | None = None
    ) -> CachedExecutable:
        """Extract slice -> verify -> load onto the device -> digest cache (Sec.
        III-C/D).  ``admitted_ttl`` is the admitting PUBLISH hop's
        remaining budget, clamped into the capability stamp's re-mint
        ceiling.

        A digest hit skips compilation entirely (ORC-JIT's internal symbol
        cache, which the paper observed makes re-JIT of already-seen code
        free) — only the name registration is new."""
        hit = self.cache.lookup_digest(frame.digest.hex())
        if hit is not None:
            self._gate(
                frame.name, hit.digest, frame.deps or hit.deps,
                hit.extras.get("exported"), admitted_ttl,
            )
            exe = CachedExecutable(
                name=frame.name,
                digest=hit.digest,
                fn=hit.fn,
                in_avals=hit.in_avals,
                deps=frame.deps or hit.deps,
                kind=int(frame.kind),
                extras=dict(hit.extras),
            )
            self.cache.install(exe, jit_ms=0.0)
            self.stats.ifunc_installs += 1
            return exe

        fat = FatBitcode.from_bytes(frame.code)
        if frame.kind == FrameKind.BINARY:
            # binary code is ISA/uarch-specific: exact triple or bust
            if self.triple not in fat.slices:
                raise ISAMismatch(
                    f"binary ifunc {frame.name!r} built for {fat.triples()} "
                    f"cannot run on {self.triple!r} (Sec. III-B problem; "
                    f"ship bitcode instead)"
                )
            picked = self.triple
        else:
            picked = fat.extract(self.triple).triple
        blob = fat.slices[picked]
        t0 = time.perf_counter()
        exported = load_program(blob, self.device)
        # verify before the program becomes callable: a refused slice is
        # never run here
        self._gate(frame.name, frame.digest.hex(), frame.deps, exported, admitted_ttl)
        compiled = exported.module()
        jit_ms = (time.perf_counter() - t0) * 1e3
        abi = "pure"
        for d in frame.deps:
            if d.startswith("abi:"):
                abi = d.split(":", 1)[1]
        exe = CachedExecutable(
            name=frame.name,
            digest=frame.digest.hex(),
            fn=compiled,
            in_avals=in_avals_of(exported),
            deps=frame.deps,
            kind=int(frame.kind),
            extras={"code": frame.code, "abi": abi, "exported": exported, "triple": picked},
        )
        self.cache.install(exe, jit_ms=jit_ms)
        self.stats.ifunc_installs += 1
        self.stats.jit_ms_total += jit_ms
        return exe

    # --- resolve ----------------------------------------------------------
    def resolve_exe(self, buf: bytes, hdr) -> tuple[CachedExecutable, Frame]:
        """Find (or install) the executable a frame refers to; returns it
        with the frame unpacked exactly once (code-carrying frames are
        multi-KB, a second parse is a second copy).

        The name registry decides whether a truncated frame is acceptable;
        the digest decides whether the name's code is *current* — a frame
        carrying new code under a known name (republished ifunc) installs
        and supersedes, it never silently runs the stale executable.
        """
        from ..frame import unpack

        has_code = len(buf) >= hdr.full_total and hdr.code_len > 0
        frame = unpack(buf, has_code=has_code)
        if not self.cache.has_name(hdr.name):
            if not has_code:
                raise ProtocolError(
                    f"{self.name}: truncated frame for unregistered ifunc "
                    f"{hdr.name!r} (stale sender cache — was this PE restarted?)"
                )
            return self.install(frame), frame
        exe = self.cache.lookup(hdr.name)
        assert exe is not None
        if exe.digest != hdr.digest.hex():
            if has_code:
                return self.install(frame), frame
            hit = self.cache.lookup_digest(hdr.digest.hex())
            if hit is None:
                raise ProtocolError(
                    f"{self.name}: truncated frame for {hdr.name!r} with "
                    f"unknown code digest (stale sender cache)"
                )
            exe = hit
        # warm-path gate: quarantine refusal or stamp dict hit; a digest
        # never seen by an (enabled-later) verifier is admitted here
        self._gate(exe.name, exe.digest, exe.deps, exe.extras.get("exported"))
        return exe, frame

    def validate_publish_code(self, frame: Frame, hdr) -> None:
        """Poisoned-code gate: a code-carrying publish whose code section
        does not hash to the header digest is refused loudly (and the
        caller must not re-publish it down the tree)."""
        if hashlib.sha256(frame.code).digest() != frame.digest:
            self.stats.refuse("publish_digest")
            raise ProtocolError(
                f"{self.name}: publish of {hdr.name!r} carries code that does "
                f"not match its digest (poisoned code refused, not re-published)"
            )

    def resolve_publish_exe(
        self, hdr, admitted_ttl: int | None = None
    ) -> CachedExecutable:
        """Resolve a digest-only (truncated) publish: the code must already
        be digest-cached here, or the sender's cache belief was stale."""
        exe = self.cache.lookup(hdr.name)
        if exe is None or exe.digest != hdr.digest.hex():
            hit = self.cache.lookup_digest(hdr.digest.hex())
            if hit is None:
                raise ProtocolError(
                    f"{self.name}: digest-only publish for unknown code "
                    f"{hdr.name!r} (stale sender cache — was this PE "
                    f"restarted?)"
                )
            exe = CachedExecutable(
                name=hdr.name,
                digest=hit.digest,
                fn=hit.fn,
                in_avals=hit.in_avals,
                deps=hit.deps,
                kind=int(hdr.kind),
                extras=dict(hit.extras),
            )
            self._gate(
                exe.name, exe.digest, exe.deps,
                exe.extras.get("exported"), admitted_ttl,
            )
            self.cache.install(exe, jit_ms=0.0)
            self.stats.ifunc_installs += 1
        else:
            self._gate(
                exe.name, exe.digest, exe.deps,
                exe.extras.get("exported"), admitted_ttl,
            )
        return exe

    # --- batched executables ----------------------------------------------
    @staticmethod
    def bucket(n: int) -> int:
        """Power-of-two padding bucket: bounds batched recompiles to log2."""
        return 1 << max(0, n - 1).bit_length()

    def batched_executable(self, exe: CachedExecutable, bucket: int):
        """The batched rendering of an installed ifunc, cached per (digest,
        bucket) in the target code cache; one call retires the whole
        ``(bucket, ...)`` payload block and counts as one dispatch.

        Value ABIs (``xrdma``/``pure``) run under ``torch.vmap`` with the
        dependencies shared: the shipped graph runs once over the block, and
        a custom op with a vmap rule launches its kernel once for the whole
        block.  ``update`` code folds the valid payloads into the region in
        order — the masked fold of the JAX runtime, written as a loop:
        padded rows are skipped, so they never touch the region.  The
        batched ``propagate`` fold comes with the propagation slice.
        """
        hit = self.cache.lookup_batched(exe.digest, bucket)
        if hit is not None:
            return hit
        call = exe.fn
        abi = exe.extras.get("abi", "pure")
        if abi == "propagate":
            raise NotImplementedError("batched propagate-ABI fold is not ported yet")
        if abi == "update":
            rpos = region_arg_pos(exe)

            def batched(pays, valid, region, *extra):
                for p, v in zip(pays, valid.tolist()):
                    if v:
                        dep_args = list(extra)
                        dep_args.insert(rpos, region)
                        region = call(p, *dep_args)
                return region
        else:
            n_deps = len(exe.in_avals) - 1
            batched = torch.vmap(call, in_dims=(0, *([None] * n_deps)))
        self.cache.install_batched(exe.digest, bucket, batched)
        return batched
