"""Llama-3.2-3B [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-3B; unverified]."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="attn",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=128256, rope="rope", rope_theta=500000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke", family="attn",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, rope="rope", rope_theta=500000.0,
    )
