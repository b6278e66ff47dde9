"""Zamba2-2.7B [hybrid]: Mamba2 backbone + shared attention block (with
per-invocation LoRA) every 6 layers. 54L d_model=2560 32H (kv=32, MHA)
d_ff=10240 ssm_state=64 [arXiv:2411.15242; hf]."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="zamba2",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000, ssm_state=64, zamba_attn_every=6,
        rope="rope", sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="zamba2",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=128, ssm_state=16, zamba_attn_every=2,
        rope="rope", sub_quadratic=True,
    )
