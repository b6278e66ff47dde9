"""Yi-9B [dense]: llama-arch GQA. 48L d_model=4096 32H (kv=4) d_ff=11008
vocab=64000 [arXiv:2403.04652; hf]."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="attn",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab_size=64000, rope="rope", rope_theta=5e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", family="attn",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, rope="rope", rope_theta=5e6,
    )
