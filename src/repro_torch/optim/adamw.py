"""AdamW with global-norm clipping and schedules, on name-keyed dicts of
tensors (the counterpart of ``repro.optim.adamw``).

The optimizer state mirrors the parameters leaf for leaf ({m, v}) and the
update runs in place under ``torch.no_grad()``: the JAX package returns new
arrays, the port overwrites the parameters and moments it is given, so a
train step holds one copy of each.  Moments are f32 whatever the parameter
dtype; the update is computed in f32 and cast back to the parameter's
dtype, in the JAX package's order of operations, so the same inputs give
the same f32 values up to the order of the global norm's sum.

The JAX ``update`` takes ``constrain`` (the ZeRO-1 moment shardings of
``repro.sharding.partition``); the port's takes a
:class:`~repro_torch.sharding.partition.Layout`, and the params are then a
rank's blocks and the moments its blocks under the ZeRO-1 specs: the
gradients are reduce-scattered over the data axes (a psum where a leaf's
moments are whole), each rank updates its block of the weight, and the
blocks are all-gathered.  Under an FSDP layout (``Layout.fsdp``) the params
are the rank's blocks at the moments' specs: a cut leaf's gradient arrives
reduce-scattered by the forward's gather, and each rank updates its own
block with no collective after.  The global norm counts every element once: each
leaf's sum of squares is weighted by one over the ranks that hold the same
block, then summed over the mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

Params = dict[str, torch.Tensor]


def global_norm(leaves: Params | Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by leaf."""
    if isinstance(leaves, dict):
        leaves = leaves.values()
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_schedule(
    peak_lr: float, warmup_steps: int = 100, total_steps: int = 10_000, floor: float = 0.1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` x it;
    ``step`` -> f32 learning rate."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


@dataclass
class OptState:
    """Leaf-parallel f32 moments and the int32 step count (a 0-d tensor)."""

    m: Params
    v: Params
    count: torch.Tensor


@dataclass(frozen=True)
class AdamW:
    """AdamW + decoupled weight decay + global-norm clip.

    ``lr`` may be a float or a schedule ``count -> lr``.  ``wd_skip`` names
    substrings of parameter names exempt from decay (norm gains, biases)."""

    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    wd_skip: tuple[str, ...] = ("ln", "bias", "norm", ".b")

    def init(self, params: Params, constrain=None) -> OptState:
        """Zero moments; with a layout ``constrain``, this rank's ZeRO-1
        (or FSDP) blocks of them (``params`` its param blocks)."""
        first = next(iter(params.values()))

        def shape(k, p):
            return tuple(p.shape) if constrain is None else constrain.block_shape(k, p.shape)

        return OptState(
            m={k: torch.zeros(shape(k, p), dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            v={k: torch.zeros(shape(k, p), dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            count=torch.zeros((), dtype=torch.int32, device=first.device),
        )

    def _decays(self, name: str) -> bool:
        return not any(s in name for s in self.wd_skip)

    @torch.no_grad()
    def update(
        self, grads: Params, state: OptState, params: Params, constrain=None
    ) -> tuple[Params, OptState, dict[str, torch.Tensor]]:
        """One step: ``params``, ``state.m``, ``state.v`` and
        ``state.count`` are updated in place and returned, with metrics
        ``grad_norm`` (before clipping) and ``lr``.  ``constrain``: a
        :class:`~repro_torch.sharding.partition.Layout`, for this rank's
        part of a ZeRO-1 step (``grads`` its unreduced gradients) or of an
        FSDP step (``grads`` its blocks, reduced where the leaf is cut)."""
        state.count += 1
        count = state.count
        f32 = dict(dtype=torch.float32, device=count.device)
        if constrain is not None:
            grads = {k: constrain.reduce_grad(k, grads[k]) for k in params}
            total = None
            for k in params:
                sq = torch.sum(torch.square(grads[k])) * constrain.norm_weight(k)
                total = sq if total is None else total + sq
            gnorm = torch.sqrt(constrain.psum_all(total))
        else:
            gnorm = global_norm(grads[k] for k in params)
        if self.clip_norm is not None:
            scale = torch.minimum(torch.tensor(1.0, **f32), torch.tensor(
                self.clip_norm, **f32) / torch.maximum(gnorm, torch.tensor(1e-9, **f32)))
        else:
            scale = torch.tensor(1.0, **f32)
        lr = self.lr(count) if callable(self.lr) else torch.tensor(self.lr, **f32)
        c = count.float()
        bc1 = 1.0 - self.b1**c
        bc2 = 1.0 - self.b2**c
        for k, p_all in params.items():
            p = p_all if constrain is None else constrain.param_block(k, p_all)
            g = grads[k].float() * scale
            m, v = state.m[k], state.v[k]
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay and self._decays(k):
                upd = upd + self.weight_decay * p.float()
            new = (p.float() - lr * upd).to(p.dtype)
            p_all.copy_(new if constrain is None else constrain.gather_param(k, new))
        return params, state, {"grad_norm": gnorm, "lr": lr}
