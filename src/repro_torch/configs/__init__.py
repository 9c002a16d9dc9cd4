"""Architecture registry: ``--arch <id>`` resolution.

The counterpart of ``repro.configs``, for the archs the port has brought
over.  Each module defines ``full()`` (the assigned config) and ``smoke()``
(a reduced config of the same family for CPU tests).  Every other arch of
the JAX package waits for its slice of the port (ROADMAP.md, section 1) and
raises ``KeyError`` here.
"""

from __future__ import annotations

from importlib import import_module

from repro_torch.models.common import ModelConfig

#: the archs the port runs, by id (the JAX registry's ids)
_MODULES = {"yi-9b": "yi_9b", "rwkv6-1.6b": "rwkv6_1_6b", "hymba-1.5b": "hymba_1_5b"}
ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ported: {sorted(_MODULES)}); "
            "ROADMAP.md section 1 says which slice brings it"
        )
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke() if smoke else mod.full()


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


__all__ = ["ARCH_IDS", "get_config", "list_archs"]
