"""``FlashAttentionFn``: flash_attention with a gradient.

Forward: :func:`~repro_torch.kernels.flash_attention.ops.flash_attention`,
which launches the hand-written kernel on a CUDA tensor and runs the plain
version on a CPU tensor (grad mode is off inside ``forward``, so the CUDA
wrapper's ``refuse_grad`` does not trip here).  Backward:
:func:`~repro_torch.kernels.flash_attention.ops.flash_attention_bwd`, by the
same rule: the hand-written backward kernels on a CUDA tensor (the route of
the forward's dtype; a failed build or launch raises), the plain
``attention_bwd_ref`` on a CPU tensor (the reference's gradient is XLA's
autodiff of its pure-JAX attention), the meta route on a ``meta`` tensor.
Saved, when some input needs a gradient (serving's forward saves and
writes nothing more): q, k, v, the output in float32 (in bfloat16 a copy
the forward writes before its rounding; in float32 the output itself) and
each row's log-sum-exp (``flash_attention(..., return_lse=True)``); the
kernels take P from the lse and D = rowsum(dO o) from that output, and the
plain backward recomputes everything from q, k and v.
"""
from __future__ import annotations

import torch

from .ops import flash_attention, flash_attention_bwd

__all__ = ["FlashAttentionFn"]


class FlashAttentionFn(torch.autograd.Function):
    """``FlashAttentionFn.apply(q, k, v, q_per_kv, causal, window,
    sm_scale, block_q)``: q (B·H, Sq, d), k and v (B·KVH, Sk, d), as
    :func:`flash_attention`; ``block_q`` query rows per block of the plain
    backward (the CPU's; the kernels take their own tiles)."""

    @staticmethod
    def forward(ctx, q, k, v, q_per_kv: int, causal: bool, window,
                sm_scale, block_q: int):
        ctx.kw = dict(q_per_kv=q_per_kv, causal=causal, window=window,
                      sm_scale=sm_scale)
        ctx.block_q = block_q
        if not any(ctx.needs_input_grad[:3]):   # no backward: nothing saved
            return flash_attention(q, k, v, **ctx.kw)
        out, lse, out32 = flash_attention(q, k, v, return_lse=True,
                                          **ctx.kw)
        ctx.save_for_backward(q, k, v, out32, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out32, do, lse,
                                         block_q=ctx.block_q, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
