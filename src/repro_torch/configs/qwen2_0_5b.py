"""Qwen2-0.5B [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias [arXiv:2407.10671; hf]."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="attn",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151936, qkv_bias=True, rope="rope",
        rope_theta=1e6, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="attn",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, qkv_bias=True, rope="rope",
        rope_theta=1e6, tie_embeddings=True,
    )
