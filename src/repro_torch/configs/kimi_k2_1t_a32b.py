"""Kimi-K2 1T-A32B [moe]: 61L d_model=7168 64H (GQA kv=8, head_dim=112)
expert d_ff=2048, MoE 384 experts top-8 + 1 shared, vocab=163840
[arXiv:2501.kimi2; paper-table, unverified].

~1.03T params; the flagship arch for the paper's technique: top-8 of 384
experts => ~2% of expert bytes hot per token (expert tiering telemetry).
bf16 params + Adafactor: 1T fp32 AdamW state cannot fit 256 chips; see
DESIGN.md and the dry-run memory table."""
import torch
from ..models.model import ModelConfig, MoECfg

OPTIMIZER = "adafactor"


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
        d_ff=2048, vocab_size=163840,
        moe=MoECfg(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
        rope="rope", rope_theta=5e4, param_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=128,
        moe=MoECfg(n_experts=8, top_k=2, d_expert=64, n_shared=1),
        rope="rope", rope_theta=5e4, param_dtype=torch.bfloat16,
    )
