"""Serving launcher: batched prefill + greedy decode loop.

``python -m repro_torch.launch.serve --arch <id> [--no-smoke] [--layers N]
--batch 4 --prompt-len 64 --gen 32 [--remote-embed --embed-servers 2]``
prefills a batch of random prompts and decodes greedily, printing one JSON line with
the prefill and decode throughput (the keys of ``repro.launch.serve``; with
``--layers``, the arch's first N layers, also ``layers``).  The prompts are
``make_batch``'s, patch embeddings included for an arch with a patch
frontend (internvl2-26b), as JAX's launcher hands them to its prefill; the
decode steps take tokens only.  An encoder-decoder (seamless-m4t-medium)
prefills with ``make_batch``'s audio frames (``frontend_len`` of them, the
encoder's input; its session cache holds their cross K/V) and decodes over
the cached cross K/V; ``--layers N`` cuts both of its stacks to N, and the
JSON gives ``enc_layers`` beside ``layers``.
It runs on the card; ``--device cpu`` runs it on the host.  With
``--remote-embed`` the tokens' embedding rows come from an embedding-shard
service over the PE fabric instead of a local lookup, and the token stream
is bit-identical to the local one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.bitcode import resolve_device
from ..models.zoo import (
    ShapeSpec, build_params, first_layers, make_batch, make_prefill_step, make_serve_step,
)
from ..runtime.tenancy import RemoteEmbedClient


def serve(argv: list[str] | None = None) -> tuple[dict, np.ndarray]:
    """Run the launcher; returns its JSON record and the generated tokens
    ``(batch, gen)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the arch's first N layers (a model too large for the card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--remote-embed",
        action="store_true",
        help="serving-tier mode: fetch embedding rows from an embedding-shard "
        "service (CQ gathers over the PE fabric) instead of a local lookup",
    )
    ap.add_argument("--embed-servers", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has {cfg.n_layers} layers")
        cfg = first_layers(cfg, args.layers)
    model = build_params(cfg, args.seed, device=dev)
    t_max = args.prompt_len + args.gen

    # prefill against a cache sized for the whole session
    spec = ShapeSpec("serve", args.prompt_len, args.batch, "prefill")
    batch = make_batch(cfg, spec, seed=args.seed, device=dev)
    prefill_step, serve_step = make_prefill_step(cfg, t_max=t_max), make_serve_step(cfg)

    embed_client = None
    if args.remote_embed:
        embed_client = RemoteEmbedClient(
            model.embed.tok.float().cpu().numpy(), n_servers=args.embed_servers, device=dev
        )
        rows = embed_client.rows(batch["tokens"].cpu().numpy())
        batch["token_rows"] = torch.from_numpy(rows).to(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, batch)
    sync()
    t_prefill = time.perf_counter() - t0

    toks = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for i in range(args.gen):
        toks.append(tok[:, 0].cpu().numpy())
        pos = args.prompt_len + i
        rows = None
        if embed_client is not None:
            rows = torch.from_numpy(embed_client.rows(toks[-1][:, None])).to(dev)
        logits, cache = serve_step(model, cache, tok, pos, rows)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    sync()
    t_decode = time.perf_counter() - t0

    gen = np.stack(toks, 1)
    assert torch.isfinite(logits.float()).all(), "non-finite logits"
    out = {
        "arch": cfg.name,
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "generated": int(gen.shape[1]),
        "prefill_s": round(t_prefill, 3),
        "prefill_tok_s": round(args.batch * args.prompt_len / t_prefill),
        "decode_ms_per_tok": round(1e3 * t_decode / args.gen, 2),
        "decode_tok_s": round(args.batch * args.gen / t_decode),
        "sample_ids": gen[0, :8].tolist(),
    }
    if args.layers is not None:
        out["layers"] = cfg.n_layers
        if cfg.is_encdec:
            out["enc_layers"] = cfg.enc_layers
    if embed_client is not None:
        out["remote_embed"] = True
        out["embed_servers"] = args.embed_servers
        out["embed_gathers"] = embed_client.gathers
    return out, gen


def main(argv: list[str] | None = None) -> int:
    out, _ = serve(argv)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
