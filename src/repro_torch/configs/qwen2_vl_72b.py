"""Qwen2-VL-72B [vlm]: M-RoPE, dynamic resolution. 80L d_model=8192 64H
(GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191; hf].
The vision tower is a STUB: input_specs provide precomputed patch
embeddings (B, S, d_model) plus 3D (t,h,w) M-RoPE position ids."""
from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="attn",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064, qkv_bias=True,
        rope="mrope", rope_theta=1e6, frontend="embeddings",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke", family="attn",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, qkv_bias=True,
        rope="mrope", rope_theta=1e6, frontend="embeddings",
    )
