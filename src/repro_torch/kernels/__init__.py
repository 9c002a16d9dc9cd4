"""Hand-written Hopper kernels for the port, one package per TPU kernel.

Each package holds ``kernel.py`` (the wrapper that launches the CUDA kernel
from ``csrc/`` and counts its launches, plus the ``torch.library`` custom
op a traced ifunc slice calls it through) and ``ref.py`` (the plain PyTorch
version the wrapper takes for a CPU tensor and the tests compare against).
Importing this package registers every custom op — the link step a target
performs before it loads a slice that names one.

  embed_lookup/  partial row lookup of one vocab shard (the Gatherer's
                 ``cuda-sm90`` resolver); replaces the Pallas one-hot MXU
                 matmul of ``repro.kernels.embed_lookup``
"""

from .embed_lookup import kernel as _embed_lookup_kernel

#: every kernel wrapper, by kernel name (each carries a ``launches`` count)
WRAPPERS = {"embed_lookup": _embed_lookup_kernel.embed_lookup}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "reset_launches"]
