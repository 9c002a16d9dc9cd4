"""Sharded, prefetching token pipeline (the port's own copy of
``repro.data.pipeline``, numpy only: its batches equal the JAX package's
bit for bit, so both packages train on the same tokens).

Sources:
* ``synthetic`` — a deterministic Zipfian token stream (evaluation and
  smoke tests; seeded per (epoch, shard) so every data-parallel rank reads
  a disjoint, reproducible slice).
* ``memmap``   — a flat uint16/uint32 token file (np.memmap), the usual
  packed-corpus format; sharded by contiguous stripes per rank.

The pipeline is *stateless given (step, shard)* — restart-safe by
construction: after a crash the runtime resumes from checkpoint step k and
the pipeline regenerates batch k+1 bit-for-bit (no reader state to
checkpoint).  A small background thread keeps ``prefetch`` batches ready.
Batches are numpy arrays; the train step moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np


def synthetic_corpus(path: str | Path, n_tokens: int, vocab: int, seed: int = 0) -> Path:
    """Write a packed uint32 token file (for the memmap source)."""
    rng = np.random.default_rng(seed)
    toks = zipf_tokens(rng, n_tokens, vocab)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    toks.astype(np.uint32).tofile(path)
    return path


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int, alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab) — LM-like marginal statistics."""
    z = rng.zipf(alpha, size=n)
    return ((z - 1) % vocab).astype(np.int32)


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    source: str = "synthetic"  # synthetic | memmap
    path: str | None = None
    seed: int = 0
    shard_id: int = 0  # this host's stripe
    n_shards: int = 1
    prefetch: int = 2

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class TokenPipeline:
    """Iterator of {"tokens", "labels", "mask"} int32/float32 numpy batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm: np.ndarray | None = None
        if cfg.source == "memmap":
            assert cfg.path, "memmap source needs a path"
            raw = np.memmap(cfg.path, dtype=np.uint32, mode="r")
            self._mm = raw
        self._q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step = 0

    # ------------------------------------------------------------- batches
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe)."""
        cfg = self.cfg
        b, s = cfg.local_batch, cfg.seq_len
        if self._mm is not None:
            span = b * (s + 1)
            total = len(self._mm)
            stride = total // cfg.n_shards
            lo = cfg.shard_id * stride
            off = lo + (step * span) % max(stride - span, 1)
            flat = np.asarray(self._mm[off : off + span], dtype=np.int32) % cfg.vocab
            chunk = flat.reshape(b, s + 1)
        else:
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard_id
            )
            chunk = zipf_tokens(rng, b * (s + 1), cfg.vocab).reshape(b, s + 1)
        return {
            "tokens": chunk[:, :-1].astype(np.int32),
            "labels": chunk[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32),
        }

    # ------------------------------------------------------------ prefetch
    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, step: int = 0) -> "TokenPipeline":
        self._step = step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._thread is None:
            batch = self.batch_at(self._step)
            self._step += 1
            return batch
        _, batch = self._q.get()
        return batch
