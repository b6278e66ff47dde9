"""End-to-end trainer (the port of ``repro/launch/train.py``).

Wires: config -> params -> train step -> deterministic data pipeline ->
checkpoint/restore -> preemption guard -> straggler detector -> HMU
embedding telemetry + tiering report.  It runs on the CUDA device unless
``--device cpu`` is given; each layer's attention runs its forward on the
hand-written ``flash_attention`` kernel (twice a step under remat) and its
backward in plain PyTorch, and the tiering report's ``rebalance`` launches
``hist_select`` every 10 steps.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --batch 4 --seq 2048 --steps 12                 # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --smoke --device cpu                            # anywhere
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --smoke --steps 50 --resume --ckpt-dir CKPT --device cpu

The ``[tiering]`` lookup times are modeled by the ``TPU_V5E_SYSTEM``
two-tier cost model, as in the reference; they are not times measured on
this device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import (ARCH_IDS, get_config, get_optimizer_name,
                       get_smoke_config)
from ..core.tiered_embedding import TieredEmbedding
from ..data import DataConfig, TokenPipeline
from ..kernels.dispatch import resolve_device
from ..models.model import init_params
from ..optim import cosine_schedule, get_optimizer
from ..optim.optimizers import OptState
from ..runtime import PreemptionGuard, StragglerDetector
from ..train.steps import make_train_step


def main(argv=None, cfg=None) -> dict:
    """Run the trainer; prints the reference's lines and returns what it
    printed as numbers: ``start_step``, per step ``losses``,
    ``grad_norms``, ``lrs`` and ``step_s`` (the wall from the step's call
    to its loss on the host), ``preempted`` and ``seconds``.  ``cfg``
    trains that config in place of ``--arch``'s (the 100M example's); the
    optimizer is still ``--arch``'s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tiering", action="store_true", default=True,
                    help="HMU embedding telemetry + tiering report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
    if cfg.frontend == "embeddings":
        print(f"note: {args.arch} uses an embedding frontend; the trainer "
              "feeds token batches through the (stub-bypassed) embed table")
        cfg = dataclasses.replace(cfg, frontend="tokens")

    opt = get_optimizer(get_optimizer_name(args.arch))
    lr = cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps)
    step_fn = make_train_step(cfg, opt, lr, grad_accum=args.grad_accum)

    params = init_params(cfg, args.seed, dev)
    opt_state = opt.init(params)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    pipeline = TokenPipeline(data_cfg)
    start_step = 0

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(device=dev)
        params = state["params"]
        # namedtuples restore as dicts: re-wrap the optimizer state
        opt_state = OptState(state["opt"]["step"], state["opt"]["inner"])
        pipeline, start_step = TokenPipeline.resume(data_cfg, extra["data"])
        print(f"resumed from step {start_step}")

    report = dict(start_step=start_step, losses=[], grad_norms=[], lrs=[],
                  step_s=[], preempted=False)
    guard = PreemptionGuard()
    straggler = StragglerDetector()
    emb = TieredEmbedding.create(params["embed"].detach(), fast_fraction=0.1) \
        if args.tiering else None

    t_start = time.time()
    saved_at = None
    try:
        for step in range(start_step, args.steps):
            batch_np = pipeline.batch(step)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_np.items()}
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            action = straggler.observe(step, dt)
            if action:
                print(f"[straggler] step {step}: {action}")
            if emb is not None:
                emb.observe_tokens(batch_np["tokens"])
                if (step + 1) % 10 == 0:
                    moved = emb.rebalance()
                    rep = emb.modeled_lookup_time_s()
                    print(f"[tiering] step {step}: promoted {moved} blocks, "
                          f"hit={rep['fast_hit_rate']:.2%} "
                          f"tiered={rep['tiered_s']*1e6:.0f}us "
                          f"all_fast={rep['all_fast_s']*1e6:.0f}us "
                          f"all_slow={rep['all_slow_s']*1e6:.0f}us")
            lr_now, gnorm = float(metrics["lr"]), float(metrics["grad_norm"])
            for key, val in (("losses", loss), ("grad_norms", gnorm),
                             ("lrs", lr_now), ("step_s", dt)):
                report[key].append(val)
            print(f"step {step}: loss={loss:.4f} lr={lr_now:.2e} "
                  f"gnorm={gnorm:.3f} {dt*1e3:.0f}ms", flush=True)
            if ckpt and ((step + 1) % args.ckpt_every == 0
                         or guard.preempted):
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"data": pipeline.state(step + 1)},
                          block=guard.preempted)
                saved_at = step + 1
                if guard.preempted:
                    print(f"preempted: checkpointed at step {step + 1}, "
                          f"exiting")
                    report.update(preempted=True,
                                  seconds=time.time() - t_start)
                    return report
        if ckpt and saved_at == args.steps:
            # the loop's own save is the final state: finish it rather than
            # write the same checkpoint again, as the reference does
            ckpt.wait()
        elif ckpt:
            ckpt.save(args.steps, {"params": params, "opt": opt_state},
                      extra={"data": pipeline.state(args.steps)}, block=True)
    finally:
        # the reference leaves its handlers installed; the port puts the
        # process's own back, so a caller that trains twice is still
        # stopped by SIGTERM and SIGINT afterwards
        guard.restore()
    report["seconds"] = time.time() - t_start
    print(f"done: {args.steps - start_step} steps in "
          f"{report['seconds']:.1f}s")
    return report


if __name__ == "__main__":
    main()
