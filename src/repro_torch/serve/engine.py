"""Prefill + single-token decode for the dense and MoE families (PyTorch
port of ``repro/serve/engine.py``; the ``rwkv6`` and ``zamba2`` branches
raise ``NotImplementedError``, ROADMAP Queue 1 item 13).  A MoE decode step
routes with ``capacity_factor`` 4.0, as the reference's, and returns the
step's (L, E) router counts as ``aux["expert_counts"]``.

Cache: ``{"k", "v": (L, B, KVH, max_len, hd) in the activation dtype,
"pos": (B,) int32}``, the reference's layout.  ``decode_step`` writes the
new token into the K/V tensors of the cache it is given, in place (the
reference returns updated copies; no caller here reads the old cache, and a
copy would move the whole cache once per token), and returns a cache dict
holding those same tensors and a new ``pos``.

The decode path optionally emits per-KV-page attention-mass telemetry
(``page_size`` > 0) — the serving-side HMU feed for the tiered KV cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..models import attention as attn_lib
from ..models.layers import apply_rope, rms_norm, swiglu
from ..models.model import (ModelConfig, default_positions, embed_inputs,
                            layer_params, logits_fn, moe_params,
                            require_attn, transformer_block)
from ..models.moe import moe_block

__all__ = ["decode_step", "decode_telemetry", "init_cache",
           "kv_page_geometry", "prefill"]

Cache = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Cache:
    require_attn(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = dtype or cfg.activ_dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params: dict, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence pass that also builds the cache.  Returns (last-token
    logits (B, V), cache).  Every layer's attention runs the
    ``flash_attention`` kernel once on a CUDA device."""
    require_attn(cfg, "prefill")
    # the reference swaps the triangular schedule for the masked one at
    # prefill (an XLA layout choice; the same function here)
    if cfg.causal_schedule == "triangular":
        cfg = dataclasses.replace(cfg, causal_schedule="masked")
    x = embed_inputs(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    max_len = max_len or s
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    cache["pos"].fill_(s)
    for i in range(cfg.n_layers):
        x, _, (k, v) = transformer_block(x, layer_params(params, i), cfg,
                                         positions, return_kv=True)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, page_size: int = 0
                ) -> Tuple[torch.Tensor, Cache, Dict[str, Any]]:
    """One token for every sequence in the batch.  tokens: (B,) int.
    Returns (logits (B, V), cache, telemetry aux); the cache's K/V tensors
    are the given ones, written in place, and its ``pos`` is ``pos + 1``.
    With ``page_size`` aux["kv_page_mass"] is (L, B, ceil(S / page_size))
    float32; for the MoE family aux["expert_counts"] is (L, E) int32."""
    require_attn(cfg, "decode_step")
    x = params["embed"][tokens.long()].to(cfg.activ_dtype)       # (B, D)
    pos = cache["pos"]
    b = x.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    ks, vs = cache["k"], cache["v"]
    masses, counts = [], []
    for i in range(cfg.n_layers):
        bp = layer_params(params, i)
        h = rms_norm(x[:, None], bp["ln1"], cfg.norm_eps)[:, 0]

        def proj(w, bias, n):
            y = h @ w.to(h.dtype)
            if bias is not None:
                y = y + bias.to(h.dtype)
            return y.reshape(b, n, hd)

        q = proj(bp["wq"], bp.get("bq"), nh)
        k = proj(bp["wk"], bp.get("bk"), nkv)
        v = proj(bp["wv"], bp.get("bv"), nkv)
        if cfg.rope in ("rope", "mrope"):
            # mrope degenerates to 1-D rope at decode (text position)
            q = apply_rope(q[:, :, None, :], pos[:, None, None],
                           cfg.rope_theta)[:, :, 0]
            k = apply_rope(k[:, :, None, :], pos[:, None, None],
                           cfg.rope_theta)[:, :, 0]
        attn_lib.write_kv_(ks[i], vs[i], k, v, pos)
        if page_size:
            o, mass = attn_lib.decode_step(q, ks[i], vs[i], pos,
                                           window=cfg.window,
                                           page_size=page_size)
            masses.append(mass)
        else:
            o = attn_lib.decode_step(q, ks[i], vs[i], pos, window=cfg.window)
        x = x + o.reshape(b, nh * hd) @ bp["wo"].to(h.dtype)
        h2 = rms_norm(x[:, None], bp["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            h2, moe_aux = moe_block(h2, moe_params(bp), top_k=cfg.moe.top_k,
                                    capacity_factor=4.0)
            counts.append(moe_aux["counts"])
        else:
            h2 = swiglu(h2, bp["w_gate"], bp["w_up"], bp["w_down"])
        x = x + h2[:, 0]
    cache = dict(cache, k=ks, v=vs, pos=pos + 1)
    aux: Dict[str, Any] = {}
    if cfg.family == "moe":
        aux["expert_counts"] = torch.stack(counts)               # (L, E)
    if page_size:
        aux["kv_page_mass"] = torch.stack(masses)                # (L, B, P)
    else:
        aux["kv_page_mass"] = torch.zeros((cfg.n_layers, b, 1),
                                          dtype=torch.float32,
                                          device=x.device)
    x = rms_norm(x[:, None], params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x)[:, 0], cache, aux


def kv_page_geometry(cfg: ModelConfig, batch: int, max_len: int,
                     page_size: int) -> Dict[str, int]:
    """Page-space geometry of a tiered KV cache: how the decode loop's
    ``kv_page_mass`` telemetry maps onto tiering blocks.

    Each ``(layer, sequence, page)`` triple is one block.  Pages are
    ceil-divided (``pages_per_seq``), so a ``max_len`` that is not a page
    multiple gets a ragged final page.  ``bytes_per_access`` is one attended
    position's K+V read; ``block_bytes`` one full page of K+V."""
    if cfg.family not in ("attn", "moe"):
        raise ValueError(f"kv_page_mass telemetry needs a KV cache; "
                         f"family {cfg.family!r} has none")
    pages_per_seq = -(-max_len // page_size)
    kv_item = torch.empty((), dtype=cfg.activ_dtype).element_size()
    pos_bytes = 2 * cfg.n_kv_heads * cfg.head_dim * kv_item    # K + V
    return {
        "n_blocks": cfg.n_layers * batch * pages_per_seq,
        "pages_per_seq": pages_per_seq,
        "bytes_per_access": pos_bytes,
        "block_bytes": pos_bytes * page_size,
    }


def decode_telemetry(params: dict, cfg: ModelConfig, cache: Cache,
                     tokens: torch.Tensor, page_size: int
                     ) -> Tuple[Cache, np.ndarray]:
    """Drive a multi-step decode loop and collect its KV telemetry feed.

    ``tokens`` is ``(T, B)`` — one token per sequence per step.  The
    per-step ``kv_page_mass`` tensors stay on the device and are stacked and
    pulled to the host once, at the end, as ``(T, L, B, pages_per_seq)``
    float64 — the access-mass stream a
    :class:`repro_torch.scenarios.kv_cache.KVCacheScenario` quantizes into
    the EpochRuntime's page-index batches.  Returns ``(final cache, mass)``."""
    masses = []
    for t in tokens:
        _, cache, aux = decode_step(params, cfg, cache, t,
                                    page_size=page_size)
        masses.append(aux["kv_page_mass"])
    mass = torch.stack(masses).cpu().numpy().astype(np.float64)
    return cache, mass
