"""Expert tiering for MoE (PyTorch counterpart of
``examples/expert_tiering_moe.py``): the paper's DLRM sparsity argument
applied to expert weights.  With 384 experts top-8, about 2 % of expert
bytes are live per token; the router's expert counters ARE memory-side
telemetry (full coverage, zero extra cost), so hot experts can live in HBM
and cold ones in the capacity tier.

Part 1 sizes the opportunity offline: 16 batches of Zipf-popular tokens
through the kimi-k2 smoke model, the traffic share of the hottest quarter of
the experts, and their fetch times under the ``TPU_V5E_SYSTEM`` cost model
(modeled HBM against host memory over PCIe, as in the reference; not times
measured on this device).  Part 2 places the expert banks online:
:class:`~repro_torch.scenarios.MoEExpertScenario` turns the router's
per-epoch counters into EpochRuntime access batches and ``run_scenario``
drives the proactive and NB lanes over a mid-run routing shift.

    python -m repro_torch.examples.expert_tiering_moe                # GPU
    python -m repro_torch.examples.expert_tiering_moe --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core.costmodel import TPU_V5E_SYSTEM
from ..core.metrics import true_top_k
from ..kernels.dispatch import resolve_device
from ..models.model import forward, init_params
from ..scenarios import MoEExpertScenario, run_scenario

__all__ = ["ARCH", "LANES", "run", "scenario", "size_opportunity"]

ARCH = "kimi-k2-1t-a32b"
LANES = ("proactive_ewma", "nb_two_touch")


def size_opportunity(device="cuda", seed: int = 0) -> dict:
    """Part 1: summed router counts over 16 batches of (4, 64) Zipf tokens,
    the top quarter of the experts and its modeled fetch times."""
    dev = resolve_device(device)
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed, dev)
    rng = np.random.default_rng(seed)
    counts = []
    with torch.no_grad():
        for _ in range(16):
            zipf = np.minimum(rng.zipf(1.3, size=(4, 64)) - 1,
                              cfg.vocab_size - 1).astype(np.int32)
            counts.append(forward(params, cfg, tokens=torch.from_numpy(
                zipf).to(dev))[1]["expert_counts"])
    per_expert = torch.stack(counts).sum((0, 1)).cpu().numpy().astype(
        np.int64)
    e = cfg.moe.n_experts
    k_fast = max(e // 4, 1)                   # HBM capacity: 25% of experts
    hot = true_top_k(per_expert, k_fast)
    bytes_per_expert = 3 * cfg.d_model * cfg.moe.d_expert * 2
    total = int(per_expert.sum())
    fast = int(per_expert[hot].sum())
    sysm = TPU_V5E_SYSTEM
    return {
        "n_experts": e, "top_k": cfg.moe.top_k, "k_fast": k_fast,
        "per_expert": per_expert, "hot": np.sort(hot),
        "bytes_per_expert": bytes_per_expert, "fast_share": fast / total,
        "modeled_tiered_s": sysm.access_time_s(fast, total - fast,
                                               bytes_per_expert),
        "modeled_all_hbm_s": sysm.access_time_s(total, 0, bytes_per_expert),
        "modeled_all_host_s": sysm.access_time_s(0, total, bytes_per_expert),
    }


def scenario(device="cuda") -> MoEExpertScenario:
    return MoEExpertScenario(n_epochs=6, batches_per_epoch=4, shift_at=3,
                             seed=3, device=device)


def run(device="cuda") -> dict:
    """Both parts: the opportunity and the online run (few experts, so
    little history is needed: the EWMA adapts fast, alpha 0.9)."""
    sc = scenario(device)
    return {
        "opportunity": size_opportunity(device),
        "scenario": sc,
        "online": run_scenario(sc, policies=LANES, ewma_alpha=0.9,
                               device=device),
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    op, sc, out = res["opportunity"], res["scenario"], res["online"]
    e = op["n_experts"]
    print(f"experts={e} top_k={op['top_k']}; counts over 16 batches:")
    print("  per-expert activation counts:", op["per_expert"].tolist())
    print(f"\nHMU (router) telemetry -> promote {op['k_fast']} experts: "
          f"{op['hot'].tolist()}")
    t_tier, t_hbm, t_host = (op["modeled_tiered_s"], op["modeled_all_hbm_s"],
                             op["modeled_all_host_s"])
    print(f"hot-expert traffic share: {op['fast_share']:.1%} at "
          f"{op['k_fast'] / e:.0%} of expert bytes resident in HBM")
    print(f"modeled expert-weight fetch (TPU_V5E_SYSTEM cost model, not this "
          f"device's): tiered={t_tier * 1e6:.0f}us all-HBM={t_hbm * 1e6:.0f}"
          f"us all-host={t_host * 1e6:.0f}us")
    print(f"=> {t_host / t_tier:.1f}x faster than full offload, "
          f"{op['bytes_per_expert'] * (e - op['k_fast']) / 1e6:.0f} MB of "
          f"HBM freed per layer")

    lanes = out["trajectory"]["lanes"]
    print(f"\nonline expert tiering (scenario='{sc.name}', {sc.n_blocks} "
          f"expert banks, k_hot={sc.k_hot}): {sc.n_epochs} epochs, routing "
          f"shift at epoch {sc.shift_at}")
    for ep in range(sc.n_epochs):
        mark = "<- shift" if ep == sc.shift_at else ""
        print(f"  epoch {ep}: " + "  ".join(
            f"{n}={lanes[n][ep]['time_s'] * 1e6:7.0f}us"
            f"/acc={lanes[n][ep]['accuracy']:.2f}" for n in LANES)
            + f"  {mark}")
    s = out["summary"]
    print(f"=> post-shift mean fetch (modeled): "
          f"proactive={s['proactive_ewma']['post_shift_mean_time_us']:.0f}us "
          f"nb={s['nb_two_touch']['post_shift_mean_time_us']:.0f}us "
          f"({s['proactive_vs_nb_post_shift']:.2f}x); recovery to >=50% "
          f"placement accuracy: "
          f"proactive={s['proactive_ewma']['post_shift_recovery_epochs']} "
          f"epochs nb={s['nb_two_touch']['post_shift_recovery_epochs']} "
          f"epochs")


if __name__ == "__main__":
    main()
