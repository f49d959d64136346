"""Serving launcher: batched greedy prefill + decode on one device.

    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --batch 4 --prompt-len 2048 --tokens 32
    python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --batch 4 --prompt-len 2048 --tokens 32
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \
        --batch 4 --prompt-len 2048 --tokens 32

Without ``--smoke`` it serves the full configuration with bfloat16
parameters on one GPU (no mesh); ``--smoke`` takes the reduced one.
Parameters come from ``init_params(seed=0)``, the prompt from
``numpy.random.default_rng(0)``. ``--device`` defaults to the GPU and
raises when there is none; ``--device cpu`` runs the plain versions of the
kernels. Every decoder of the registry is served: GQA and MLA attention,
mamba2, the jamba hybrid, and qwen2-vl on a text prompt (as the reference's
launcher serves it). An encoder (hubert-xlarge) has no decode and raises
``ValueError``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..core.coo import resolve_device
from ..models import Model, init_params
from ..serve import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.smoke:
        cfg = get_smoke(args.arch)
    else:
        cfg = get_config(args.arch).scaled(param_dtype="bfloat16")
    if cfg.kind == "encoder":
        raise ValueError(f"{cfg.name} is an encoder: it has no decode to "
                         f"serve")
    model = Model(cfg)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    max_len = args.max_len or (args.prompt_len + args.tokens + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = greedy_generate(model, params, prompt, max_len, args.tokens,
                          device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: {args.batch}×{args.tokens} tokens in "
          f"{dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s, first "
          f"launches and kernel builds included)")
    print("first sequence:", out[0].cpu().numpy()[:24])
    return out


if __name__ == "__main__":
    main()
