"""Time the flash kernel's default (end-aligned) calls of the checkout at a
given root, for comparing two commits' kernels on one card in turns.

Usage, from the root of a checkout on a host with a Hopper card::

    python3 tools/flash_ab.py ROOT

``ROOT`` is the checkout whose ``src/repro_torch`` is imported (``.`` for
this one, or another commit's tree unpacked with ``git archive``).  Builds
that tree's ``flash_attention`` library, prints its ptxas report, then one
line ``FLASH_AB {...}``: the device ms a call of yi-9b's prefill (B=1,
S=T=2,048) and decode (B=8, T=2,048 of 4,096-slot caches), hymba-1.5b's
windowed decode (B=8, T=4,096, window 2,048), all bf16, and an f32 prefill
(S=T=1,024), each from CUDA events around calls queued behind a sleep
kernel.  Run the two trees in turns (A B B A) in one call of the card.
"""

import json
import sys

import torch


def event_ms(fn, sets, reps: int) -> float:
    """Device ms a call of ``reps`` calls cycling through ``sets``, queued
    behind ``torch.cuda._sleep`` so that no host time between them counts."""
    for args in sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(8):
        awake, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(cycles)
        awake.record()
        start.record()
        for i in range(reps):
            fn(*sets[i % len(sets)])
        end.record()
        queued_in_time = not awake.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError("the host could not queue the calls inside the sleep")


def main(root: str) -> None:
    sys.path.insert(0, root + "/src")
    from repro_torch.kernels import build

    build.build_all(["flash_attention"])
    for line in build.build_logs.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("PTXAS", root, line.strip())
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(4)

    def case(b, s, t, h, kh, d, dtype, t_max):
        q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
        kc = torch.randn(b, t_max, kh, d, generator=g, device=dev).to(dtype)
        vc = torch.randn(b, t_max, kh, d, generator=g, device=dev).to(dtype)
        return q, kc[:, :t], vc[:, :t]

    bf, f32 = torch.bfloat16, torch.float32
    shapes = {  # name: (shape, input sets, calls, window)
        "yi prefill S=T=2048": ((1, 2048, 2048, 32, 4, 128, bf, 2048), 1, 20, 0),
        "yi decode B=8 T=2048": ((8, 1, 2048, 32, 4, 128, bf, 4096), 8, 200, 0),
        "hymba decode B=8 T=4096 window 2048": ((8, 1, 4096, 25, 5, 64, bf, 4096), 8, 200, 2048),
        "f32 prefill S=T=1024": ((1, 1024, 1024, 32, 4, 128, f32, 1024), 1, 10, 0),
    }
    out = {}
    for name, (shape, n, reps, w) in shapes.items():
        sets = [case(*shape) for _ in range(n)]
        out[name] = event_ms(lambda q, k, v: flash_attention(q, k, v, window=w), sets, reps)
    print("FLASH_AB " + json.dumps({"root": root, "ms": out}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
