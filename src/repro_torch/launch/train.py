"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-3-2b --smoke --steps 50 --device cpu
    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke \\
        --steps 30                                  # on the GPU

The reference's loop: ``SyntheticLM(seed=11)`` through a ``Prefetcher``,
the ``StepWatchdog`` around each step, ``make_train_step`` (gradient
accumulation with ``--accum``, ``--compress int8`` quantizes the gradients;
``topk`` applies no compressor, as in the reference, where it needs state
threaded through the step), atomic checkpoints every ``--ckpt-every`` steps
into ``--ckpt-dir`` and auto-resume from its latest step. ``--smoke`` takes
the architecture's reduced config with a 2,048-token vocabulary, as the
reference. Without it the reference trains the full config under the
production mesh's sharding plan; the port has the mesh and the plan
(``launch/mesh.py``, ``dist/shardings.py``) but not yet a training step
under a plan (the gradients through its gathers and expert sums) nor the
dry-run that sizes it (``launch/dryrun.py``, ``launch/roofline.py``), so
it raises. ``--device`` defaults to the GPU and raises
when there is none; ``--device cpu`` runs the plain versions of the
kernels. On a GPU the watchdog times each step to a synchronize.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_smoke
from ..core.coo import resolve_device
from ..models import Model, init_params
from ..train import (AdamWConfig, Prefetcher, SyntheticLM, init_opt_state,
                     latest_step, make_train_step, restore_checkpoint,
                     save_checkpoint)
from ..models.weights import params_from_numpy
from .elastic import StepWatchdog


def main(argv=None):
    """Runs the loop; returns (params, opt_state, losses), one loss a step
    run (floats, read after the step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress", choices=["none", "int8", "topk"],
                    default="none")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if not args.smoke:
        raise NotImplementedError(
            "training without --smoke needs a training step under the "
            "production mesh's sharding plan and the dry-run that sizes it "
            "(launch/dryrun.py, launch/roofline.py), not ported yet "
            "(ROADMAP queue 1 item 3)")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch).scaled(vocab=2048)
    model = Model(cfg)
    params = init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    compressor = None
    if args.compress == "int8":
        from ..dist.compression import int8_quantize
        compressor = int8_quantize
    opt_cfg = AdamWConfig(warmup_steps=20, decay_steps=max(args.steps, 100))
    step_fn = make_train_step(model, opt_cfg, accum=args.accum,
                              compressor=compressor)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=11)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir, (params, opt))
        params, opt = (params_from_numpy(t, device=dev) for t in state)
        print(f"resumed from step {start}")
    pf = Prefetcher(data, start_step=start)
    wd = StepWatchdog()
    losses = []
    try:
        for step in range(start, args.steps):
            wd.start()
            batch = {k: v.to(dev) for k, v in pf.next().items()}
            params, opt, metrics = step_fn(params, opt, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = wd.stop()
            losses.append(float(metrics["loss"]))
            if wd.is_straggling(dt):
                print(f"WARNING step {step}: straggler ({dt:.2f}s > "
                      f"{wd.budget():.2f}s budget)")
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"({dt:.2f}s/step)")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1, (params, opt))
    finally:
        pf.close()
    return params, opt, losses


if __name__ == "__main__":
    main()
