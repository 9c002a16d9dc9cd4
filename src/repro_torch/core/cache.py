"""The two caches of the Three-Chains protocol (Sec. III-D, Fig. 4).

* :class:`SenderCache` — source side. A hash table keyed by
  (endpoint, code digest): if present, the target has seen *these exact
  bytes*, so the PUT is truncated at the first MAGIC (code bytes never
  travel again).  Keying by digest rather than ifunc name matters when an
  ifunc is republished under the same name with different code (e.g. a
  rebuilt ``chaser`` after a table resize): the new digest misses, the new
  code travels, and the target never invokes stale code on a fresh payload.

* :class:`TargetCodeCache` — target side. Digest-keyed registry of JIT'd
  executables (the ORC-JIT in-memory cache): the first frame of a type pays
  deserialize+compile; every later frame of that type goes straight to
  invoke. Also remembers which ifunc *names* are registered, which is how the
  receiver decides whether to expect a truncated or a full frame.  The
  batched runtime additionally caches one *batched* executable per
  (digest, padding bucket): a vmapped (or masked-loop) rendering of the same
  code that retires a whole (B, ...) payload block in one dispatch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    bytes_saved: int = 0
    jit_compiles: int = 0
    jit_ms_total: float = 0.0

    def as_dict(self) -> dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "bytes_saved": self.bytes_saved,
            "jit_compiles": self.jit_compiles,
            "jit_ms_total": round(self.jit_ms_total, 3),
        }


class SenderCache:
    """Tracks which (endpoint, code digest) pairs have already received code."""

    def __init__(self) -> None:
        self._seen: set[tuple[str, str]] = set()
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def has(self, endpoint: str, digest: str) -> bool:
        """Non-mutating peek: does the target already hold this code?  Used
        by the data plane to decide protocols (a rendezvous descriptor
        cannot carry code) without claiming a send happened."""
        with self._lock:
            return (endpoint, digest) in self._seen

    def mark(self, endpoint: str, digest: str) -> None:
        """Record that the target holds this code *without* a send having
        happened: a completed tree publish confirmed coverage (the paper's
        predeployment-by-propagation), so later sends may truncate.  Unlike
        :meth:`check_and_add` this neither counts a hit nor a miss — no
        frame moved."""
        with self._lock:
            self._seen.add((endpoint, digest))

    def check_and_add(self, endpoint: str, digest: str, code_nbytes: int) -> bool:
        """True if the target already has the code (=> truncate the send)."""
        key = (endpoint, digest)
        with self._lock:
            if key in self._seen:
                self.stats.hits += 1
                self.stats.bytes_saved += code_nbytes
                return True
            self._seen.add(key)
            self.stats.misses += 1
            return False

    def forget(self, endpoint: str, digest: str) -> None:
        """Drop one (endpoint, digest) entry: the sender has reason to
        believe this specific delivery never happened (failed PUT, subtree
        re-parent after a drop) and must re-send the full frame."""
        with self._lock:
            self._seen.discard((endpoint, digest))

    def invalidate_endpoint(self, endpoint: str) -> None:
        """Drop all entries for an endpoint (e.g. PE restarted after a fault:
        its code cache is gone, full frames must be re-sent)."""
        with self._lock:
            self._seen = {k for k in self._seen if k[0] != endpoint}

    def invalidate_digest(self, digest: str) -> None:
        """Drop all entries for one code digest, every endpoint: the digest
        was quarantined (sandbox refusal) and uninstalled fabric-wide, so
        any later send of those bytes must travel full — where the
        receiving verifier refuses it loudly instead of silently invoking
        a stale truncated reference."""
        with self._lock:
            self._seen = {k for k in self._seen if k[1] != digest}


@dataclass
class CachedExecutable:
    name: str
    digest: str
    fn: Callable[..., Any]  # compiled entry
    in_avals: tuple
    deps: tuple[str, ...]
    kind: int
    extras: dict[str, Any] = field(default_factory=dict)


class TargetCodeCache:
    """Digest-keyed executable cache + name registry on the target PE."""

    def __init__(self) -> None:
        self._by_digest: dict[str, CachedExecutable] = {}
        self._by_name: dict[str, CachedExecutable] = {}
        self._batched: dict[tuple[str, int], Callable[..., Any]] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()
        self.batched_compiles = 0

    def has_name(self, name: str) -> bool:
        with self._lock:
            return name in self._by_name

    def lookup(self, name: str) -> CachedExecutable | None:
        with self._lock:
            exe = self._by_name.get(name)
            if exe is not None:
                self.stats.hits += 1
            return exe

    def lookup_digest(self, digest: str) -> CachedExecutable | None:
        with self._lock:
            return self._by_digest.get(digest)

    def install(self, exe: CachedExecutable, jit_ms: float = 0.0) -> None:
        with self._lock:
            self._by_digest[exe.digest] = exe
            self._by_name[exe.name] = exe
            self.stats.misses += 1
            self.stats.jit_compiles += 1
            self.stats.jit_ms_total += jit_ms

    # batched executables: one per (digest, power-of-two padding bucket) ----
    def lookup_batched(self, digest: str, bucket: int) -> Callable[..., Any] | None:
        with self._lock:
            return self._batched.get((digest, bucket))

    def install_batched(self, digest: str, bucket: int, fn: Callable[..., Any]) -> None:
        with self._lock:
            self._batched[(digest, bucket)] = fn
            self.batched_compiles += 1

    def deregister(self, name: str) -> None:
        """ifunc de-registration discards the JIT'd code (Sec. III-C)."""
        with self._lock:
            exe = self._by_name.pop(name, None)
            if exe is not None:
                self._by_digest.pop(exe.digest, None)
                self._batched = {
                    k: v for k, v in self._batched.items() if k[0] != exe.digest
                }

    def forget_names(self) -> None:
        """Drop the Three-Chains registry but keep the digest-keyed JIT
        artifacts — the paper's two cache layers (Sec. V-A 'Lookup'): the
        TSI uncached benchmark forgets registrations so full frames travel
        and the install path runs, while LLVM's (here: the loaded program's) compiled
        code is still found by content digest, so re-JIT costs nothing."""
        with self._lock:
            self._by_name.clear()

    def clear(self) -> None:
        with self._lock:
            self._by_digest.clear()
            self._by_name.clear()
            self._batched.clear()
