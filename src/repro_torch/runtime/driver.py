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

With a ``mesh`` (``repro_torch.sharding.mesh.Mesh``; every rank of it runs
the driver), the state is each rank's blocks under the train rules'
specs (``models.zoo.layout``; moments under ZeRO-1), every rank reads the
same global batch and takes its rows of it, a checkpoint is gathered one
leaf at a time (no rank holds more than one whole leaf on its device) to
rank 0's host and written by rank 0 alone, and a restore takes each rank's
blocks for the mesh it is given, as the JAX driver restores with the
mesh's shardings.  The port's simulated host loss keeps
the mesh it has (the JAX driver's rebuild runs on the same devices too).
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
    LM, build_params, from_jax_names, layout, load_named, logical_axes, make_train_step,
    model_params, shard_params, to_jax_params,
)
from ..sharding.mesh import Mesh
from ..sharding.partition import full_leaf, leaf_key
from ..optim import AdamW, OptState
from .monitor import HeartbeatMonitor, StepTimer


def refuse_unfed(cfg) -> None:
    """The token pipeline makes tokens, labels and a mask, and no frames: an
    encoder-decoder has nothing to encode, so the driver refuses it before
    any step (the JAX driver fails at its first step on the same config,
    its decoder finding no cross K/V).  ``zoo.make_train_step`` trains it on
    ``zoo.make_batch``'s batches, which carry the frames."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the token pipeline makes no audio frames for the encoder, so the "
            "driver cannot train the encoder-decoder family; train it with "
            "zoo.make_train_step on zoo.make_batch's batches (ROADMAP.md section 3)")


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
        refuse_unfed(cfg)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"TrainDriver takes a repro_torch.sharding.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh
        self.lay = None if mesh is None else layout(cfg, mesh)
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
    @property
    def writes(self) -> bool:
        """Does this rank write the checkpoints (rank 0 of a mesh, or no mesh)?"""
        return self.mesh is None or self.mesh.rank == 0

    def state_of(self, model: LM) -> dict:
        """A fresh train state around ``model`` (whole; cut to this rank's
        blocks with a mesh): zero moments, step 0."""
        if self.mesh is not None:
            shard_params(self.cfg, model, self.mesh, self.lay)
        return {"params": model, "step": 0,
                "opt": self.opt.init(model_params(model), constrain=self.lay)}

    def init_state(self) -> dict:
        return self.state_of(build_params(self.cfg, self.seed, device=self.device))

    def tree(self, state: dict) -> dict | None:
        """``state`` as the JAX package's state tree (stacked whole leaves),
        the structure a checkpoint holds.  With a mesh every rank calls it:
        the leaves are gathered one at a time and rank 0 keeps each whole
        leaf on the host, so no rank holds the whole state on its device;
        the other ranks get None."""
        opt = state["opt"]
        params, m, v = model_params(state["params"]), opt.m, opt.v
        if self.mesh is not None:
            params = self._host_leaves(params, self.lay.params)
            m, v = (self._host_leaves(t, self.lay.moments) for t in (m, v))
            if not self.writes:
                return None
        return {
            "params": to_jax_params(self.cfg, params),
            "opt": OptState(m=to_jax_params(self.cfg, m), v=to_jax_params(self.cfg, v),
                            count=opt.count),
            "step": int(state["step"]),
        }

    def _host_leaves(self, named: dict, specs: dict) -> dict:
        """Each of this rank's blocks (laid out by ``specs``, by leaf key)
        gathered whole over the mesh, one leaf at a time, and moved to rank
        0's host; empty on the other ranks."""
        out = {}
        for name, t in named.items():
            whole = full_leaf(t, specs[leaf_key(name)], self.mesh)
            if self.writes:
                out[name] = whole.cpu()
            del whole
        return out

    def like(self, state: dict) -> dict:
        """The structure of the state tree a checkpoint holds, each tensor
        leaf an empty one on the meta device (``restore_state`` reads the
        structure only): nothing is gathered or copied."""
        shapes, _ = logical_axes(self.cfg)
        empty = {k: torch.empty(shape, device="meta") for k, shape in shapes.items()}
        return {"params": empty, "opt": OptState(m=empty, v=empty, count=state["opt"].count),
                "step": 0}

    def specs(self) -> dict | None:
        """Each checkpoint leaf's spec on the mesh, by leaf name (the stacked
        ``blocks.*`` leaves' layer axis whole), for ``restore_state`` to take
        this rank's blocks; None without a mesh."""
        if self.mesh is None:
            return None
        stack = lambda key, spec: (None, *spec) if key.startswith("blocks.") else spec  # noqa: E731
        out = {f"params.{k}": stack(k, spec) for k, spec in self.lay.params.items()}
        for i in (0, 1):  # m and v, under OptState's flat indices
            out |= {f"opt'][<flat index {i}>]['{k}": stack(k, spec)
                    for k, spec in self.lay.moments.items()}
        return out

    def load_tree(self, state: dict, tree: dict) -> dict:
        """Copy a restored state tree (this rank's blocks, with a mesh) into
        ``state`` in place."""
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
        self._step_fn = make_train_step(self.cfg, self.opt, mesh=self.mesh)

    def _barrier(self) -> None:
        """Every rank of the mesh waits here (rank 0's checkpoint committed)."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _save(self, state: dict, step: int) -> None:
        tree = self.tree(state)  # with a mesh every rank gathers, leaf by leaf
        if self.writes:
            self.ckpt.save_async(tree, step)

    # ------------------------------------------------------------ recovery
    def restore_or_init(self) -> tuple[dict, int]:
        state = self.init_state()
        if latest_step(self.ckpt.path) is None:
            return state, 0
        tree, step = restore_state(self.ckpt.path, self.like(state), device=self.device,
                                   specs=self.specs(), mesh=self.mesh)
        return self.load_tree(state, tree), step

    def handle_fault(self, lost_host: str | None = None) -> tuple[dict, int]:
        """Restore the last committed checkpoint after losing a host."""
        self.ckpt.wait()
        self._barrier()
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
                self._save(state, step)
        self.ckpt.wait()
        self._save(state, step)
        self.ckpt.wait()
        self._barrier()
        report.step_time_s = (time.perf_counter() - t_loop) / max(report.steps_run, 1)
        return report
