"""Architecture registry: ``--arch <id>`` resolution.

The counterpart of ``repro.configs``, for the archs the port has brought
over: all ten of its archs.  Each module defines ``full()`` (the assigned
config) and ``smoke()`` (a reduced config of the same family for CPU
tests).  An unknown arch raises ``KeyError``.
"""

from __future__ import annotations

from importlib import import_module

from repro_torch.models.common import ModelConfig

#: the archs the port runs, by id (the JAX registry's ids)
_MODULES = {"yi-9b": "yi_9b", "rwkv6-1.6b": "rwkv6_1_6b", "hymba-1.5b": "hymba_1_5b",
            "granite-moe-1b-a400m": "granite_moe", "phi3.5-moe-42b-a6.6b": "phi35_moe",
            "qwen2.5-14b": "qwen25_14b", "starcoder2-15b": "starcoder2_15b",
            "gemma2-2b": "gemma2_2b", "internvl2-26b": "internvl2_26b",
            "seamless-m4t-medium": "seamless_m4t"}
ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(_MODULES)}, the JAX registry's ids "
            "(ROADMAP.md section 1 lists the port's slices)"
        )
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke() if smoke else mod.full()


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


__all__ = ["ARCH_IDS", "get_config", "list_archs"]
