"""Prefill + single-token decode for every architecture family (PyTorch
port of ``repro/serve/engine.py``).  A MoE decode step routes with
``capacity_factor`` 4.0, as the reference's, and returns the step's (L, E)
router counts as ``aux["expert_counts"]``.

Caches, the reference's layouts:

* attn / moe: ``{"k", "v": (L, B, KVH, max_len, hd) in the activation
  dtype, "pos": (B,) int32}``;
* rwkv6: ``{"wkv": (L, B, H, 64, 64) float32, "sh_mix", "sh_ffn": (L, B,
  D) in the activation dtype (the last normed inputs of the time and
  channel mixes, their token shift), "pos"}``;
* zamba2: ``{"ssm": (L, B, H, P, N) float32, "conv": (L, B, 3, convC) (the
  last three pre-conv inputs), "k", "v": (n_shared_attn, B, KVH, max_len,
  hd), "pos"}``.

``decode_step`` writes the new token's state into the tensors of the cache
it is given, in place (K/V rows through ``attention.write_kv_``; the
recurrent states and shifts by copy), and returns a cache dict holding those
same tensors and a new ``pos``.  The reference returns updated copies; no
caller here reads the old cache, and a copy would move the whole cache
once per token.

The decode path optionally emits per-KV-page attention-mass telemetry
(``page_size`` > 0; the attn and moe families) — the serving-side HMU feed
for the tiered KV cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..models import attention as attn_lib
from ..models.layers import apply_rope, rms_norm, swiglu
from ..models.mamba2 import mamba2_mix_step
from ..models.model import (ModelConfig, constrain_batch, default_positions,
                            embed_inputs, layer_params, logits_fn,
                            mamba2_params, moe_params, rwkv6_block,
                            rwkv6_ffn_params, rwkv6_params, shared_qkv,
                            transformer_block, zamba2_mamba_block,
                            zamba2_shared_attention)
from ..models.moe import moe_block
from ..models.rwkv6 import rwkv6_channel_mix_step, rwkv6_mix_step

__all__ = ["abstract_cache", "decode_step", "decode_telemetry", "init_cache",
           "kv_page_geometry", "prefill"]

Cache = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Cache:
    """A zeroed cache of ``batch`` sequences of ``max_len`` positions on
    ``device`` (``"meta"``: shapes and dtypes only, see
    :func:`abstract_cache`)."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    dtype = dtype or cfg.activ_dtype
    L, kvh, hd, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.d_model

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache = {"pos": zeros((batch,), torch.int32)}
    if cfg.family in ("attn", "moe"):
        shape = (L, batch, kvh, max_len, hd)
        cache.update(k=zeros(shape), v=zeros(shape))
    elif cfg.family == "rwkv6":
        cache.update(wkv=zeros((L, batch, d // 64, 64, 64), torch.float32),
                     sh_mix=zeros((L, batch, d)), sh_ffn=zeros((L, batch, d)))
    elif cfg.family == "zamba2":
        h = cfg.mamba_heads
        shape = (cfg.n_shared_attn, batch, kvh, max_len, hd)
        cache.update(
            ssm=zeros((L, batch, h, cfg.d_inner // h, cfg.ssm_state),
                      torch.float32),
            conv=zeros((L, batch, 3, cfg.d_inner + 2 * cfg.ssm_state)),
            k=zeros(shape), v=zeros(shape))
    else:
        raise ValueError(cfg.family)
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """:func:`init_cache`'s tree as ``meta`` tensors (the reference's
    ``jax.eval_shape`` of it): nothing is allocated."""
    return init_cache(cfg, batch, max_len, device="meta")


def prefill(params: dict, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, max_len: Optional[int] = None, mesh=None
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence pass that also builds the cache.  Returns (last-token
    logits (B, V), cache).  On a CUDA device every attention runs the
    ``flash_attention`` kernel once: each layer of the attn and moe
    families, each of zamba2's ``n_shared_attn`` shared-block invocations,
    none for rwkv6.

    ``mesh`` as :func:`repro_torch.models.model.forward` takes it: the
    inputs are this rank's slice of a batch split over
    ``cfg.act_batch_axes``, and each MoE layer routes by ``cfg``'s
    ``moe_groups`` / ``moe_expert_sharded`` (the expert-parallel path,
    ``params``' expert leaves this rank's block), as the reference's
    prefill passes them; the cache is this rank's slice's."""
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
    if cfg.family in ("attn", "moe"):
        for i in range(cfg.n_layers):
            x = constrain_batch(x, cfg)
            x, _, (k, v) = transformer_block(x, layer_params(params, i), cfg,
                                             positions, return_kv=True,
                                             mesh=mesh)
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
    elif cfg.family == "rwkv6":
        # sh_ffn is the channel mix's own input (ln2 of x after the time
        # mix), what decode_step continues from; the reference stores ln2
        # of the block's output there (ROADMAP Queue 3)
        for i in range(cfg.n_layers):
            x, cache["wkv"][i], (cache["sh_mix"][i], cache["sh_ffn"][i]) = \
                rwkv6_block(x, layer_params(params, i), cfg,
                            return_shift=True)
    elif cfg.family == "zamba2":
        every, di, n = cfg.zamba_attn_every, cfg.d_inner, cfg.ssm_state
        tail = min(s, 3)
        for inv in range(cfg.n_shared_attn):
            for i in range(inv * every, (inv + 1) * every):
                bp = layer_params(params, i)
                # the conv state: the last 3 pre-conv inputs, in_proj's
                # x / B / C slice of the last rows (zeros before a shorter
                # prompt, as the causal conv pads)
                xn = rms_norm(x[:, -tail:], bp["ln1"], cfg.norm_eps)
                cache["conv"][i, :, 3 - tail:] = \
                    xn @ bp["in_proj"][:, di:2 * di + 2 * n].to(x.dtype)
                x, cache["ssm"][i] = zamba2_mamba_block(x, bp, cfg)
            x, (k, v) = zamba2_shared_attention(
                x, params["shared_attn"], cfg, inv, positions,
                return_kv=True)
            cache["k"][inv, :, :, :s] = k
            cache["v"][inv, :, :, :s] = v
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, x[:, -1:])[:, 0], cache


def _zamba_shared_attn_decode(x, sp, cfg, inv, kc, vc, pos):
    """The shared block for one token at invocation ``inv``: K/V written
    into ``kc`` / ``vc`` (B, KVH, S, hd) in place with
    ``attention.write_kv_``, decode attention in plain PyTorch
    (``attention.decode_step``), as for every family."""
    b = x.shape[0]
    hd, nh = cfg.head_dim, cfg.n_heads
    h = rms_norm(x[:, None], sp["ln"], cfg.norm_eps)[:, 0]
    q, k, v = (t.reshape(b, -1, hd) for t in shared_qkv(h, sp, cfg, inv))
    q = apply_rope(q[:, :, None, :], pos[:, None, None],
                   cfg.rope_theta)[:, :, 0]
    k = apply_rope(k[:, :, None, :], pos[:, None, None],
                   cfg.rope_theta)[:, :, 0]
    attn_lib.write_kv_(kc, vc, k, v, pos)
    o = attn_lib.decode_step(q, kc, vc, pos, window=cfg.window)
    x = x + o.reshape(b, nh * hd) @ sp["wo"].to(h.dtype)
    hm = rms_norm(x[:, None], sp["ln_mlp"], cfg.norm_eps)
    return x + swiglu(hm, sp["w_gate"], sp["w_up"], sp["w_down"])[:, 0]


def decode_step(params: dict, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, page_size: int = 0
                ) -> Tuple[torch.Tensor, Cache, Dict[str, Any]]:
    """One token for every sequence in the batch.  tokens: (B,) int.
    Returns (logits (B, V), cache, telemetry aux); the cache's tensors are
    the given ones, written in place, and its ``pos`` is ``pos + 1``.  For
    the attn and moe families aux["kv_page_mass"] is (L, B, ceil(S /
    page_size)) float32 with ``page_size`` (zeros (L, B, 1) without), and
    for moe aux["expert_counts"] is (L, E) int32; for rwkv6 and zamba2
    aux is empty (no page telemetry; ``page_size`` is ignored, as in the
    reference)."""
    x = params["embed"][tokens.long()].to(cfg.activ_dtype)       # (B, D)
    pos = cache["pos"]
    b = x.shape[0]
    aux: Dict[str, Any] = {}
    if cfg.family in ("attn", "moe"):
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        ks, vs = cache["k"], cache["v"]
        masses, counts = [], []
        for i in range(cfg.n_layers):
            x = constrain_batch(x, cfg)
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
                o = attn_lib.decode_step(q, ks[i], vs[i], pos,
                                         window=cfg.window)
            x = x + o.reshape(b, nh * hd) @ bp["wo"].to(h.dtype)
            h2 = rms_norm(x[:, None], bp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                h2, moe_aux = moe_block(h2, moe_params(bp),
                                        top_k=cfg.moe.top_k,
                                        capacity_factor=4.0)
                counts.append(moe_aux["counts"])
            else:
                h2 = swiglu(h2, bp["w_gate"], bp["w_up"], bp["w_down"])
            x = x + h2[:, 0]
        if cfg.family == "moe":
            aux["expert_counts"] = torch.stack(counts)           # (L, E)
        if page_size:
            aux["kv_page_mass"] = torch.stack(masses)            # (L, B, P)
        else:
            aux["kv_page_mass"] = torch.zeros((cfg.n_layers, b, 1),
                                              dtype=torch.float32,
                                              device=x.device)
    elif cfg.family == "rwkv6":
        for i in range(cfg.n_layers):
            bp = layer_params(params, i)
            xn = rms_norm(x[:, None], bp["ln1"], cfg.norm_eps)[:, 0]
            h, cache["wkv"][i] = rwkv6_mix_step(
                xn, cache["sh_mix"][i], cache["wkv"][i], rwkv6_params(bp),
                n_heads=cfg.d_model // 64)
            x = x + h
            xn2 = rms_norm(x[:, None], bp["ln2"], cfg.norm_eps)[:, 0]
            x = x + rwkv6_channel_mix_step(xn2, cache["sh_ffn"][i],
                                           rwkv6_ffn_params(bp))
            cache["sh_mix"][i], cache["sh_ffn"][i] = xn, xn2
    elif cfg.family == "zamba2":
        every = cfg.zamba_attn_every
        for inv in range(cfg.n_shared_attn):
            for i in range(inv * every, (inv + 1) * every):
                bp = layer_params(params, i)
                xn = rms_norm(x[:, None], bp["ln1"], cfg.norm_eps)[:, 0]
                h, cache["conv"][i], cache["ssm"][i] = mamba2_mix_step(
                    xn, cache["conv"][i], cache["ssm"][i], mamba2_params(bp),
                    d_inner=cfg.d_inner, n_heads=cfg.mamba_heads,
                    d_state=cfg.ssm_state)
                x = x + h
            x = _zamba_shared_attn_decode(
                x, params["shared_attn"], cfg, inv, cache["k"][inv],
                cache["v"][inv], pos)
    else:
        raise ValueError(cfg.family)
    cache = dict(cache, pos=pos + 1)
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
