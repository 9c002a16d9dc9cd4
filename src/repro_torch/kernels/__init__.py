"""Hand-written Hopper kernels for the port, one package per TPU kernel.

Each package holds ``kernel.py`` (the wrapper that launches the CUDA kernel
from ``csrc/`` and counts its launches, plus, for a kernel that a traced
ifunc slice calls, the ``torch.library`` custom op it calls it through)
and ``ref.py`` (the plain PyTorch version the wrapper takes for a CPU
tensor and the tests compare against).
Importing this package registers every custom op — the link step a target
performs before it loads a slice that names one.

  embed_lookup/  partial row lookup of one vocab shard (the Gatherer's
                 ``cuda-sm90`` resolver), by bulk copies or a warp per id;
                 replaces the Pallas one-hot MXU matmul of
                 ``repro.kernels.embed_lookup``
  chase/         run-to-exit shard-local pointer chase (the Chaser's local
                 loop in every slice), one thread a chase; replaces the
                 Pallas VMEM block sweep of ``repro.kernels.chase``
  flash_attention/  blockwise online-softmax GQA attention (every attention
                 call of the LM serving path); replaces the Pallas
                 ``_flash_kernel`` of ``repro.kernels.flash_attention``
  wkv6/          the RWKV-6 time-mix recurrence, step by step or split over
                 time with a carried state (every WKV call of the rwkv
                 serving path); replaces the Pallas chunked ``_wkv6_kernel``
                 of ``repro.kernels.wkv6``
  ssm_scan/      the diagonal selective scan of Mamba, step by step or split
                 over time with a carried state (every SSM call of the hymba
                 serving path); replaces the Pallas chunked ``_ssm_kernel``
                 of ``repro.kernels.ssm_scan``
"""

from .chase import kernel as _chase_kernel
from .embed_lookup import kernel as _embed_lookup_kernel
from .flash_attention import kernel as _flash_attention_kernel
from .ssm_scan import kernel as _ssm_scan_kernel
from .wkv6 import kernel as _wkv6_kernel

#: every kernel wrapper, by kernel name (each carries a ``launches`` count)
WRAPPERS = {
    "embed_lookup": _embed_lookup_kernel.embed_lookup,
    "chase_shard": _chase_kernel.chase_shard,
    "flash_attention": _flash_attention_kernel.flash_attention,
    "wkv6": _wkv6_kernel.wkv6,
    "ssm_scan": _ssm_scan_kernel.ssm_scan,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        if hasattr(fn, "items"):  # ids or chases handed to the card (embed_lookup, chase)
            fn.items = 0


__all__ = ["WRAPPERS", "launch_counts", "reset_launches"]
