"""Mixtral-8x22B [moe]: 8 experts top-2, SWA. 56L d_model=6144 48H (kv=8)
expert d_ff=16384 vocab=32768 [arXiv:2401.04088; hf].

Sharding: 8 experts do not divide the 16-way model axis, so experts stay
replicated across "model" and the expert d_ff is tensor-parallel instead
(SHARDING_OVERRIDES below)."""
from ..models.model import ModelConfig, MoECfg

SHARDING_OVERRIDES = {"experts": None, "expert_mlp": "model"}


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=32768, window=4096,
        moe=MoECfg(n_experts=8, top_k=2, d_expert=16384),
        rope="rope", rope_theta=1e6, sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, window=32,
        moe=MoECfg(n_experts=4, top_k=2, d_expert=64),
        rope="rope", rope_theta=1e6, sub_quadratic=True,
    )
