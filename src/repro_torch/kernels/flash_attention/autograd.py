"""``FlashAttentionFn``: flash_attention with a gradient.

Forward: :func:`~repro_torch.kernels.flash_attention.ops.flash_attention`,
which launches the hand-written kernel on a CUDA tensor and runs the plain
version on a CPU tensor (grad mode is off inside ``forward``, so the CUDA
wrapper's ``refuse_grad`` does not trip here).  Backward:
:func:`~repro_torch.kernels.flash_attention.ref.attention_bwd_ref`, plain
PyTorch on every device, as the reference's gradient is XLA's autodiff of
its pure-JAX attention, outside any Pallas kernel.  Only q, k and v are
saved; the backward recomputes the scores block by block.
"""
from __future__ import annotations

import torch

from .ops import flash_attention
from .ref import attention_bwd_ref

__all__ = ["FlashAttentionFn"]


class FlashAttentionFn(torch.autograd.Function):
    """``FlashAttentionFn.apply(q, k, v, q_per_kv, causal, window,
    sm_scale, block_q)``: q (B·H, Sq, d), k and v (B·KVH, Sk, d), as
    :func:`flash_attention`; ``block_q`` query rows per block of the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_per_kv: int, causal: bool, window,
                sm_scale, block_q: int):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(q_per_kv=q_per_kv, causal=causal, window=window,
                      sm_scale=sm_scale)
        ctx.block_q = block_q
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd_ref(q, k, v, do, block_q=ctx.block_q,
                                       **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
