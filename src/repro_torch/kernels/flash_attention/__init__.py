"""flash_attention — causal / sliding-window GQA attention with an online
softmax (f32 running max, sum and accumulator), for the models' prefill and
forward passes; ``FlashAttentionFn`` carries its gradient
(``flash_attention_bwd``: the backward kernels on the card, the plain
``attention_bwd_ref`` on the CPU).

``q (B·H, Sq, d)``, ``k, v (B·KVH, Sk, d)``; query row ``bh`` reads KV row
``bh // q_per_kv``; the output has q's dtype; rows with no valid key give 0.
"""
from .autograd import FlashAttentionFn
from .ops import flash_attention, flash_attention_bwd
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["FlashAttentionFn", "attention_bwd_ref", "attention_lse_ref",
           "attention_ref", "flash_attention", "flash_attention_bwd"]
