"""Public wrappers for flash_attention and its backward: dispatch by the
tensor's device (a CUDA tensor launches the kernels, a CPU tensor runs the
plain version, a ``meta`` tensor takes the dry run's meta route: the
kernels' checks and output shapes, counted in ``kernel.META_CALLS`` /
``kernel.BWD_META_CALLS``, no launch)."""
from __future__ import annotations

import torch

from ..dispatch import DEFAULT_BACKEND, KernelBackend, use_kernel
from .kernel import (flash_attention_bwd_cuda, flash_attention_bwd_meta,
                     flash_attention_cuda, flash_attention_meta)
from .ref import attention_bwd_ref, attention_ref


def flash_attention(
    q: torch.Tensor,    # (B*H, Sq, d) float32 / bfloat16
    k: torch.Tensor,    # (B*KVH, Sk, d), q's dtype
    v: torch.Tensor,
    *,
    q_per_kv: int = 1,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    backend: KernelBackend = DEFAULT_BACKEND,
) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale, causal / window mask) v, per query row; KV
    row ``bh // q_per_kv``; default ``sm_scale = d ** -0.5``."""
    if q.device.type == "meta":
        return flash_attention_meta(q.contiguous(), k.contiguous(),
                                    v.contiguous(), q_per_kv=q_per_kv,
                                    causal=causal, window=window,
                                    sm_scale=sm_scale)
    if not use_kernel(q, backend):
        return attention_ref(q, k, v, q_per_kv=q_per_kv, causal=causal,
                             window=window, sm_scale=sm_scale)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), q_per_kv=q_per_kv,
                                causal=causal, window=window,
                                sm_scale=sm_scale)


def flash_attention_bwd(
    q: torch.Tensor,    # (B*H, Sq, d) float32 / bfloat16
    k: torch.Tensor,    # (B*KVH, Sk, d), q's dtype
    v: torch.Tensor,
    do: torch.Tensor,   # (B*H, Sq, d): the output's gradient
    *,
    q_per_kv: int = 1,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    block_q: int = 512,
):
    """(dq, dk, dv) of :func:`flash_attention` for the output's gradient
    ``do``: a CUDA tensor always launches the kernels (there is no plain
    route on the card), a CPU tensor runs ``attention_bwd_ref``.
    ``block_q``: the query rows a block of that plain version; the kernels
    take their own tiles."""
    kw = dict(q_per_kv=q_per_kv, causal=causal, window=window,
              sm_scale=sm_scale)
    if q.device.type == "meta":
        return flash_attention_bwd_meta(q.contiguous(), k.contiguous(),
                                        v.contiguous(), do.contiguous(), **kw)
    if not use_kernel(q):
        return attention_bwd_ref(q, k, v, do, block_q=block_q, **kw)
    return flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), do.contiguous(), **kw)
