"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant ``TrainDriver`` (``runtime/driver.py``) over the
token pipeline with async checkpointing, on the card (``--device cpu`` runs
it on the host), and prints one JSON line with the keys of
``repro.launch.train``.  ``--smoke`` (the default) trains the reduced
config; ``--no-smoke`` the full one.  ``--mesh host`` trains on a
``(data = world, model = 1)`` mesh (``launch/mesh.py``'s ``host_mesh``):
under ``torchrun`` one NCCL rank a card, without it one rank on this
process's card, and with ``--device cpu`` on gloo; rank 0 prints the
record.  An encoder-decoder (seamless-m4t-medium) is refused: the token
pipeline makes no frames for its encoder.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import get_config
from ..data import DataConfig
from ..optim import AdamW, cosine_schedule
from ..runtime.driver import TrainDriver, refuse_unfed


def train(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns its JSON record."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="reduced config; --no-smoke = full config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data", choices=["synthetic", "memmap"], default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--mesh", choices=["none", "host"], default="none",
                    help="host = mesh over this process group's devices")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a simulated host loss (fault-tolerance demo)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    refuse_unfed(cfg)  # before a mesh exists
    mesh, device = None, args.device
    if args.mesh == "host":
        from .mesh import host_mesh

        mesh, device = host_mesh(args.device)

    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    data = DataConfig(
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        vocab=cfg.vocab,
        source=args.data,
        path=args.data_path,
    )
    driver = TrainDriver(
        cfg,
        ckpt_dir=f"{args.ckpt_dir}/{cfg.name}",
        opt=opt,
        data=data,
        ckpt_every=args.ckpt_every,
        mesh=mesh,
        device=device,
    )
    t0 = time.time()
    try:
        report = driver.run(args.steps, fail_at_step=args.fail_at_step)
    finally:
        if mesh is not None:
            mesh.close()
    return {
        "arch": cfg.name,
        "steps": report.steps_run,
        "restarts": report.restarts,
        "restored_steps": report.restored_steps,
        "first_loss": report.losses[0] if report.losses else None,
        "last_loss": report.losses[-1] if report.losses else None,
        "step_time_s": round(report.step_time_s, 4),
        "wall_s": round(time.time() - t0, 1),
        "tokens_per_s": round(
            args.seq_len * args.global_batch / max(report.step_time_s, 1e-9)
        ),
    }


def main() -> int:
    rec = train()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
