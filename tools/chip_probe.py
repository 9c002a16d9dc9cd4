"""Run some of chip_smoke.py's phases on the card, for a short call.

Usage, from the root of a checkout on a host with a Hopper card::

    python3 tools/chip_probe.py            # the flash phase, its timings, phase 40
    python3 tools/chip_probe.py serve      # phase 40 (sharded serving) alone
    python3 tools/chip_probe.py train      # phases 39 and 41 (ZeRO-1 and FSDP), then 42
    python3 tools/chip_probe.py d256       # phase 43 (head dim 256, gemma2, internvl2)
    python3 tools/chip_probe.py seamless   # phase 44 (seamless-m4t-medium, encoder-decoder)
    python3 tools/chip_probe.py flash-ab PARENT
        # tools/flash_ab.py on PARENT (another commit's tree) and on this
        # checkout in turns (parent, this, this, parent), then the card's
        # flash tests (tests/test_torch_cuda.py -k flash)

Builds the kernels the phases run first; prints chip_smoke's log lines.
The sharded phases spawn their ranks, which import this module's caller
by name, so they run under ``if __name__ == "__main__"``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def flash_ab(parent: str) -> int:
    for root in (parent, ".", ".", parent):
        subprocess.run([sys.executable, "tools/flash_ab.py", root], check=True, cwd=ROOT)
    run = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m",
                          "cuda", "tests/test_torch_cuda.py", "-k", "flash"],
                         env={**os.environ, "PYTHONPATH": "src"}, capture_output=True,
                         text=True, cwd=ROOT)
    print(run.stdout[-3000:], run.stderr[-2000:])
    return run.returncode


def main(argv: list[str]) -> int:
    if argv[:1] == ["flash-ab"]:
        return flash_ab(argv[1])
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    cs.log(f"card: {cs.gpu_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    def elapsed(done: str) -> None:
        cs.log(f"elapsed after {done}: {time.perf_counter() - t:.1f} s")

    if argv[:1] == ["train"]:
        build.build_all()
        cs.log(f"built in {time.perf_counter() - t:.1f} s")
        cs.sharded_train_phase(dev)
        elapsed("phases 39 and 41")
        cs.dense_phases(dev, elapsed)
        return 0
    if argv[:1] == ["seamless"]:
        build.build_all(["flash_attention", "flash_attention_bwd", "embed_lookup"])
        cs.log(f"built in {time.perf_counter() - t:.1f} s")
        cs.seamless_phases(dev, elapsed)
        return 0
    if argv[:1] == ["d256"]:
        build.build_all(["flash_attention", "flash_attention_bwd", "embed_lookup"])
        cs.log(f"built in {time.perf_counter() - t:.1f} s")
        cs.d256_phases(dev, None, elapsed)
        return 0
    build.build_all(["flash_attention", "embed_lookup", "wkv6", "ssm_scan"])
    cs.log(f"built in {time.perf_counter() - t:.1f} s")
    if argv[:1] != ["serve"]:
        cs.log(f"flash phase: {json.dumps(cs.flash_kernel_phase(dev))}")
        cs.time_flash(dev)
    out = cs.sharded_serve_phase(dev)
    cs.log(f"phase 40 {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
