"""Batched serving launcher: prefill a prompt batch, decode N tokens, with
tiered-KV-cache telemetry (per-page attention mass -> hot-page promotion
report, the serving analogue of Table 1).  PyTorch port of
``repro/launch/serve.py``, every family: dense, MoE (``--arch
mixtral-8x22b``), RWKV-6 (``--arch rwkv6-3b``) and Zamba2 (``--arch
zamba2-2.7b``); it runs on the CUDA device unless ``--device cpu`` is
given.  The recurrent families keep no per-layer KV cache, so they decode
without page telemetry and print no ``[kv-tiering]`` lines, as the
reference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --batch 4 --prompt-len 64 --gen 32             # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --smoke --device cpu                           # anywhere

The ``[kv-tiering]`` cache-read times are modeled by the
``TPU_V5E_SYSTEM`` two-tier cost model (HBM vs host memory over PCIe), as
in the reference; they are not times measured on this device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.costmodel import TPU_V5E_SYSTEM
from ..core.metrics import pages_for_access_fraction
from ..kernels.dispatch import resolve_device
from ..models.model import init_params
from ..serve import engine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run the launcher; prints the reference's report lines and returns them
    as numbers (``init_s``, the parameter draw; ``prefill_s``,
    ``decode_s``, tokens/s, ``tokens``, ``page_mass`` (None without a KV
    cache) and the modeled tiering times)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page granularity for tiering telemetry")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend == "embeddings":
        cfg = type(cfg)(**{**cfg.__dict__, "frontend": "tokens"})
    _sync(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, args.seed, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    max_len = args.prompt_len + args.gen
    report = {"arch": cfg.name, "device": str(dev), "batch": args.batch,
              "prompt_len": args.prompt_len, "gen": args.gen,
              "init_s": init_s}

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = engine.prefill(params, cfg, tokens=prompts,
                                   max_len=max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    report["prefill_s"] = t_prefill
    report["prefill_tok_s"] = args.batch * args.prompt_len / t_prefill
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill*1e3:.0f}ms "
          f"({report['prefill_tok_s']:.0f} tok/s)")

    # page telemetry needs a per-layer KV cache (the attn and moe families)
    has_kv = cfg.family in ("attn", "moe")
    page_size = args.page_size if has_kv else 0
    tokens = torch.argmax(logits, -1).to(torch.int32)
    out_tokens, masses = [tokens], []
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache, aux = engine.decode_step(params, cfg, cache, tokens,
                                                page_size=page_size)
        tokens = torch.argmax(logits, -1).to(torch.int32)
        out_tokens.append(tokens)
        if has_kv:
            masses.append(aux["kv_page_mass"])
    _sync(dev)
    t_dec = time.perf_counter() - t0
    # one pull at the end: generated tokens and the per-step page masses
    gen = torch.stack(out_tokens, 1).cpu().numpy()
    report["decode_s"] = t_dec
    report["decode_tok_s"] = args.batch * (args.gen - 1) / max(t_dec, 1e-9)
    report["tokens"] = gen
    print(f"decode: {args.gen - 1} steps in {t_dec*1e3:.0f}ms "
          f"({report['decode_tok_s']:.0f} tok/s)")
    print(f"sample generation (row 0): {gen[0][:16].tolist()}")

    page_mass = None
    if masses:
        for m in torch.stack(masses).cpu().numpy().astype(np.float64):
            m = m.sum((0, 1))
            page_mass = m if page_mass is None else page_mass + m
    report["page_mass"] = page_mass
    if page_mass is not None:
        frac = pages_for_access_fraction(page_mass, 0.90)
        k = max(int(len(page_mass) * 0.25), 1)
        hot = np.argsort(-page_mass)[:k]
        covered = page_mass[hot].sum() / max(page_mass.sum(), 1e-9)
        print(f"[kv-tiering] {len(page_mass)} pages/seq: top {frac:.0%} of "
              f"pages carry 90% of attention mass; keeping 25% of pages "
              f"fast-tier covers {covered:.0%} of mass")
        sysm = TPU_V5E_SYSTEM
        bpa = cfg.n_kv_heads * cfg.head_dim * 2 * 2  # k+v bf16 per token read
        n = page_mass.sum()
        t_tier = sysm.access_time_s(covered * n, (1 - covered) * n, bpa)
        t_fast = sysm.access_time_s(n, 0, bpa)
        print(f"[kv-tiering] modeled cache-read time (TPU_V5E_SYSTEM cost "
              f"model, not this device's): tiered(25% fast)="
              f"{t_tier*1e6:.1f}us vs all-HBM={t_fast*1e6:.1f}us "
              f"(footprint 4x smaller)")
        report.update(pages_for_90pct=frac, covered_25pct=covered,
                      modeled_tiered_s=t_tier, modeled_all_hbm_s=t_fast)
    return report


if __name__ == "__main__":
    main()
