"""Mesh shapes and construction (the counterpart of ``repro.launch.mesh``).

The production shapes are kept as data, as the JAX package defines them:

  single-pod  (16, 16)      axes ("data", "model")         = 256 chips
  multi-pod   (2, 16, 16)   axes ("pod", "data", "model")  = 512 chips

They are not built here (a mesh of 256 ranks is a deployment's, not a
card's).  :func:`make_smoke_mesh` builds a ``(data, model)``
:class:`~repro_torch.sharding.mesh.Mesh` over the ranks of this process
group; :func:`host_mesh` is ``launch.train --mesh host``'s.
"""

from __future__ import annotations

import math
import os
import socket

import torch

from ..sharding.mesh import Mesh, init_mesh


def production_mesh_shape(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``(shape, axis names)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_smoke_mesh(data: int = 1, model: int = 1, device=None, **kw) -> Mesh:
    """A ``(data, model)`` mesh over this process group's ranks
    (:func:`~repro_torch.sharding.mesh.init_mesh`'s keywords pass on)."""
    return init_mesh((data, model), ("data", "model"), device=device, **kw)


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.names)


def n_devices(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.names)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_mesh(device: str | None = None) -> tuple[Mesh, torch.device]:
    """``(data = world, model = 1)``, as JAX's ``--mesh host`` over its
    devices.  Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` set) every rank takes card ``LOCAL_RANK`` and nccl;
    without that environment, one rank on this process's card (a process
    group of one on a free localhost port).  ``device="cpu"`` runs on
    gloo.  Returns the mesh and this rank's device."""
    launched = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--mesh host: no CUDA device (pass --device cpu for gloo)")
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) if launched else
                           (torch.device(device).index or 0) if device else 0)
        torch.cuda.set_device(dev)
    if launched:
        mesh = make_smoke_mesh(world, 1, device=dev, rank=int(os.environ["RANK"]))
    else:
        mesh = make_smoke_mesh(1, 1, device=dev, rank=0,
                               init_method=f"tcp://127.0.0.1:{_free_port()}")
    return mesh, dev
