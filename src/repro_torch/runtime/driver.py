"""Fault-tolerant training driver: the loop a deployment runs (the
counterpart of ``repro.runtime.driver``).

Responsibilities:
  * run the train step (``models.zoo.make_train_step``) over the token
    pipeline, on the card unless the caller names the CPU
  * async-checkpoint every ``ckpt_every`` steps, in the JAX package's
    layout and leaf names (``params.blocks.wq`` stacked over layers, the
    moments under ``opt'][<flat index 0>]`` and ``<flat index 1>``, the
    count under ``<flat index 2>``, ``step``), so a
    checkpoint of either package restores in the other
  * watch health (heartbeats + straggler EWMA); on a fault, restore the
    latest committed checkpoint and resume from the restored step: the
    data pipeline is stateless given (step, shard), so batch k is the same
    across the restart
  * inject faults deterministically for tests (``fail_at_step``)

The JAX driver rebuilds its mesh without the lost host and restores with
the new shardings; the port has no mesh through the train step until
``sharding/partition.py`` is ported (ROADMAP.md section 1, item 5), so
``mesh`` must be None and a restore lands on the same device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..checkpoint import CheckpointStore, latest_step, restore_state
from ..core.bitcode import resolve_device
from ..data import DataConfig, TokenPipeline
from ..models.zoo import (
    LM, build_params, from_jax_names, load_named, make_train_step, model_params,
    to_jax_params,
)
from ..optim import AdamW, OptState
from .monitor import HeartbeatMonitor, StepTimer


@dataclass
class TrainReport:
    steps_run: int = 0
    restarts: int = 0
    losses: list[float] = field(default_factory=list)
    restored_steps: list[int] = field(default_factory=list)
    step_time_s: float = 0.0


class TrainDriver:
    def __init__(
        self,
        cfg,
        ckpt_dir: str | Path,
        opt: AdamW | None = None,
        mesh=None,
        data: DataConfig | None = None,
        ckpt_every: int = 10,
        seed: int = 0,
        device: "torch.device | str | None" = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "TrainDriver takes no mesh yet: a sharded train step waits for "
                "sharding/partition.py (ROADMAP.md section 1, item 5)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt = opt or AdamW(lr=1e-3)
        self.ckpt = CheckpointStore(ckpt_dir, keep=3)
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.data = data or DataConfig(seq_len=128, global_batch=4, vocab=cfg.vocab)
        self.monitor = HeartbeatMonitor()
        self.timer = StepTimer()
        self._step_fn: Callable | None = None

    # ------------------------------------------------------------- plumbing
    def state_of(self, model: LM) -> dict:
        """A fresh train state around ``model``: zero moments, step 0."""
        return {"params": model, "opt": self.opt.init(model_params(model)), "step": 0}

    def init_state(self) -> dict:
        return self.state_of(build_params(self.cfg, self.seed, device=self.device))

    def tree(self, state: dict) -> dict:
        """``state`` as the JAX package's state tree (stacked leaves), the
        structure a checkpoint holds."""
        opt = state["opt"]
        return {
            "params": to_jax_params(self.cfg, state["params"]),
            "opt": OptState(m=to_jax_params(self.cfg, opt.m),
                            v=to_jax_params(self.cfg, opt.v), count=opt.count),
            "step": int(state["step"]),
        }

    def load_tree(self, state: dict, tree: dict) -> dict:
        """Copy a restored state tree into ``state`` in place."""
        load_named(model_params(state["params"]), from_jax_names(self.cfg, tree["params"]),
                   "restore params")
        opt = state["opt"]
        load_named(opt.m, from_jax_names(self.cfg, tree["opt"].m), "restore m")
        load_named(opt.v, from_jax_names(self.cfg, tree["opt"].v), "restore v")
        opt.count.copy_(tree["opt"].count)
        state["step"] = int(tree["step"])
        return state

    def _compile(self):
        # eager PyTorch: the step function is built once, not traced
        self._step_fn = make_train_step(self.cfg, self.opt)

    # ------------------------------------------------------------ recovery
    def restore_or_init(self) -> tuple[dict, int]:
        state = self.init_state()
        if latest_step(self.ckpt.path) is None:
            return state, 0
        tree, step = restore_state(self.ckpt.path, self.tree(state), device=self.device)
        return self.load_tree(state, tree), step

    def handle_fault(self, lost_host: str | None = None) -> tuple[dict, int]:
        """Restore the last committed checkpoint after losing a host."""
        self.ckpt.wait()
        if lost_host:
            self.monitor.dead.add(lost_host)
        self._compile()
        return self.restore_or_init()

    # ----------------------------------------------------------------- run
    def run(
        self,
        n_steps: int,
        fail_at_step: int | None = None,
        max_restarts: int = 2,  # the JAX driver's signature; it too fails once
    ) -> TrainReport:
        report = TrainReport()
        self._compile()
        state, start = self.restore_or_init()
        pipe = TokenPipeline(self.data)
        step = start
        failed_once = False
        t_loop = time.perf_counter()
        while step < n_steps:
            if fail_at_step is not None and step == fail_at_step and not failed_once:
                # simulated host loss mid-run (after ckpt step k, before k+1)
                failed_once = True
                report.restarts += 1
                state, step = self.handle_fault("host-7")
                report.restored_steps.append(step)
                continue
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, pipe.batch_at(step))
            loss = float(metrics["loss"])
            self.timer.record("host-0", time.perf_counter() - t0)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}: {loss}")
            report.losses.append(loss)
            step += 1
            report.steps_run += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(self.tree(state), step)
        self.ckpt.wait()
        self.ckpt.save_async(self.tree(state), step)
        self.ckpt.wait()
        report.step_time_s = (time.perf_counter() - t_loop) / max(report.steps_run, 1)
        return report
