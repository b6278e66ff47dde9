"""RWKV6-3B "Finch" [ssm]: attention-free, data-dependent decay.
32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf]."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="rwkv6",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab_size=65536, rope="none", sub_quadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="rwkv6",
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=128, rope="none", sub_quadratic=True,
    )
