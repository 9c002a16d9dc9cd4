"""Continuous-batching serving runtime.

The counterpart of ``repro.runtime.serving``.  A fixed decode batch of
``slots`` rides one serve step; requests are admitted into free slots as
others complete.  Admission runs a single-sequence prefill and writes its
cache into the slot's stripe of the shared cache: the prompt's K/V for the
dense family, the recurrent state for rwkv.  A tick decodes one group per
distinct position (the step's offset is one number), and each group's
step writes the cache rows of that group only: the cache is updated in
place, so writing every row would overwrite the neighbours' history at
that position, or advance their rwkv state by a token they did not take
(the JAX scheduler merges the old rows back instead).  Every attention
call of a prefill or a group is one launch of the ``flash_attention``
kernel on the card, one per layer; every WKV call one of ``wkv6``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.zoo import LM, init_kv_cache, make_prefill_step, make_serve_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    out: list[int] = field(default_factory=list)
    slot: int | None = None
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ServeScheduler:
    def __init__(
        self,
        cfg,
        model: LM,
        slots: int = 4,
        t_max: int = 256,
        embed_client: Any = None,
    ):
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.slots = slots
        self.t_max = t_max
        # serving-tier mode: embedding rows come from a remote shard service
        # (RemoteEmbedClient: CQ gathers over the PE fabric) instead of a
        # local table lookup; the steps take the rows as an input
        self.embed_client = embed_client
        self.cache = init_kv_cache(cfg, slots, t_max, dtype=cfg.dtype, device=self.device)
        self.pos = np.zeros(slots, np.int32)  # next position per slot
        self.active: dict[int, Request] = {}  # slot -> request
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_rid = 0
        self._tokens = np.zeros((slots, 1), np.int32)
        self._step = make_serve_step(cfg)
        self._prefill = make_prefill_step(cfg)
        self.prefills = 0  # single-sequence prefills run
        self.decode_groups = 0  # serve steps run (one per position group per tick)

    # ------------------------------------------------------------------ API
    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        req = Request(self._next_rid, np.asarray(prompt, np.int32), max_new,
                      t_submit=time.perf_counter())
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _write_slot(self, slot: int, cache1: dict[str, torch.Tensor]) -> None:
        """Copy a 1-batch prompt cache into slot ``slot`` of the shared cache,
        leaf by leaf whatever its shape (dim 1 is batch for every leaf).  A
        K/V leaf (L, B, T, K, hd) takes the prompt's positions, and positions
        past the prompt keep stale values (no step reads a position before
        writing it); a state leaf (rwkv's ``tm_shift``, ``cm_shift``,
        ``wkv``) is the same size in both and is copied whole."""
        for name, full in self.cache.items():
            one = cache1[name]
            full[:, slot, : one.shape[2]] = one[:, 0]

    def _admit(self) -> None:
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            p = len(req.prompt)
            assert p + req.max_new <= self.t_max, "prompt too long for cache"
            batch = {"tokens": self._on_device(req.prompt[None])}
            if self.embed_client is not None:
                batch["token_rows"] = self._on_device(self.embed_client.rows(req.prompt[None]))
            logits, cache1 = self._prefill(self.model, batch)
            self.prefills += 1
            self._write_slot(slot, cache1)
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            req.t_first = time.perf_counter()
            req.slot = slot
            self.pos[slot] = p
            self._tokens[slot, 0] = tok
            self.active[slot] = req

    def _retire(self) -> None:
        for slot, req in list(self.active.items()):
            if len(req.out) >= req.max_new:
                req.done = True
                req.t_done = time.perf_counter()
                self.finished.append(req)
                del self.active[slot]

    def tick(self) -> int:
        """One scheduler round: admit -> retire satisfied -> one decode step
        per position group -> retire.  Returns the number of active
        sequences that advanced.  The early retire matters: admission's
        prefill already appended a token, so a ``max_new=1`` request is
        satisfied before any decode."""
        self._admit()
        self._retire()
        if not self.active:
            return 0
        groups: dict[int, list[int]] = {}
        for slot in self.active:
            groups.setdefault(int(self.pos[slot]), []).append(slot)
        advanced = 0
        # remote-embed: one row gather covers every group this tick (the
        # step input is the full (slots, 1) token batch either way)
        step_rows = None
        if self.embed_client is not None:
            step_rows = self._on_device(self.embed_client.rows(self._tokens))
        for pos, slots in sorted(groups.items()):
            tokens = self._on_device(self._tokens)
            rows = self._on_device(np.asarray(slots, np.int64))
            logits, _ = self._step(self.model, self.cache, tokens, pos, step_rows, rows=rows)
            self.decode_groups += 1
            toks = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
            for slot in slots:
                req = self.active[slot]
                req.out.append(int(toks[slot]))
                self.pos[slot] += 1
                self._tokens[slot, 0] = toks[slot]
                advanced += 1
        self._retire()
        return advanced

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        for _ in range(max_ticks):
            if not self.queue and not self.active:
                break
            self.tick()
        return self.finished
