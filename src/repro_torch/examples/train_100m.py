"""End-to-end training example (the port of ``examples/train_100m.py``): a
~100M-parameter llama-family model with checkpointing, preemption-safe
resume, straggler detection and HMU embedding tiering — the full
production loop at a small scale, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 5 \\
        --device cpu --ckpt-dir CKPT

It resumes from the newest checkpoint in ``--ckpt-dir`` (by default a
directory under the temporary directory), so a second run continues the
first.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

from ..configs import get_config
from ..launch import train as trainer


def config_100m():
    return dataclasses.replace(
        get_config("llama3.2-3b"), name="llama-100m", n_layers=12,
        d_model=768, n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32_000, tie_embeddings=True,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    cfg = config_100m()
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")
    # the production trainer with this config in place of --arch's
    return trainer.main([
        "--arch", "llama3.2-3b", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, "--resume", "--device", args.device,
    ], cfg=cfg)


if __name__ == "__main__":
    main()
