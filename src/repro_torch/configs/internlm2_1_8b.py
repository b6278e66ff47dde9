"""InternLM2-1.8B [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297; hf]."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="attn",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=92544, rope="rope", rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke", family="attn",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, rope="rope", rope_theta=1e6,
    )
