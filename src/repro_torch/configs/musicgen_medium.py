"""MusicGen-medium [audio]: decoder-only over EnCodec tokens.
48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec audio frontend is a STUB: input_specs provide token ids (the
frontend's output); generation decodes EnCodec codes."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="attn",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048, rope="rope", frontend="tokens",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", family="attn",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, rope="rope", frontend="tokens",
    )
