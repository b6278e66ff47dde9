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

Sharded serving (``mesh=``, the caller's process group; this module never
starts one): ``params`` DTensors laid out by
``launch.sharding.model_pspecs``, ``cfg`` as ``serve.sharded.serve_config``
makes it for the call (the batch axes, the MoE route, ``tp_axes``), the
tokens this rank's slice of the batch (or a DTensor laid out by
``batch_specs``).  Each rank computes its part of the single-device
function and holds no whole leaf or cache beyond the block that reads it:

* each leaf goes over as ``launch.sharding.hand_over`` hands it (the
  rank's block, all-gathered inside the block that reads it, over every
  axis that cuts it but "model" for a leaf the rank uses as its block
  there);
* the attention, the dense MLP, the embedding and the head run tensor
  parallel over "model" as in the sharded train step
  (``models.layers``); the logits are all-gathered over "model", whole
  over the vocabulary as the reference's ``out_shardings`` give them;
* the cache rests as the rank's block of
  ``launch.sharding.cache_pspecs`` (``prefill`` returns it, and
  ``decode_step`` takes and returns it, as DTensors): KV heads over
  "model" where they divide it, else the sequence over "model" (and over
  the batch axes for a batch that does not split).  Over a cut sequence
  a decode step scores each rank's slice, and the softmax's max and sum
  and the weighted values meet in all-reduces over those axes
  (``attention.decode_step``'s ``seq``); the new token's K / V land on
  the rank whose slice holds its position (a masked write);
* MoE decode routes the whole batch at capacity factor 4.0
  (``moe_block``'s ``batch_axes``); with the rules' experts on "model"
  each rank runs its experts' slots and the outputs meet in one
  all-reduce over "model", else the layer's experts are gathered at use;
* rwkv6's and Mamba2's blocks run whole on every rank; their recurrent
  state rests as the rank's block over "model", gathered at use.

``prefill(mesh=)`` with plain tensors for params (each rank's leaves as
it reads them, the expert leaves its block under expert parallelism)
keeps the older form: the cache is the rank's batch slice, whole
otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..launch import sharding as sh
from ..models import attention as attn_lib
from ..models.layers import (AttnParams, apply_rope, attn_proj, rms_norm,
                             swiglu)
from ..models.mamba2 import mamba2_mix_step
from ..models.model import (ModelConfig, constrain_batch, default_positions,
                            embed_inputs, gathered, layer_params, logits_fn,
                            mamba2_params, moe_params, rwkv6_block,
                            rwkv6_ffn_params, rwkv6_params, shared_proj,
                            tensor_parallel, transformer_block,
                            zamba2_mamba_block, zamba2_shared_attention)
from ..models.moe import moe_block
from ..models.rwkv6 import rwkv6_channel_mix_step, rwkv6_mix_step
from ..pytree import leaves

__all__ = ["abstract_cache", "cache_leaves", "decode_step",
           "decode_telemetry", "init_cache", "kv_page_geometry", "prefill"]

Cache = Dict[str, Any]


def cache_leaves(cfg: ModelConfig, batch: int, max_len: int, dtype=None
                 ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """``{name: (shape, dtype)}`` of the cache of ``batch`` sequences of
    ``max_len`` positions (nothing allocated)."""
    dtype = dtype or cfg.activ_dtype
    L, kvh, hd, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    out = {"pos": ((batch,), torch.int32)}
    if cfg.family in ("attn", "moe"):
        shape = (L, batch, kvh, max_len, hd)
        out.update(k=(shape, dtype), v=(shape, dtype))
    elif cfg.family == "rwkv6":
        out.update(wkv=((L, batch, d // 64, 64, 64), torch.float32),
                      sh_mix=((L, batch, d), dtype),
                      sh_ffn=((L, batch, d), dtype))
    elif cfg.family == "zamba2":
        h = cfg.mamba_heads
        shape = (cfg.n_shared_attn, batch, kvh, max_len, hd)
        out.update(
            ssm=((L, batch, h, cfg.d_inner // h, cfg.ssm_state),
                 torch.float32),
            conv=((L, batch, 3, cfg.d_inner + 2 * cfg.ssm_state), dtype),
            k=(shape, dtype), v=(shape, dtype))
    else:
        raise ValueError(cfg.family)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Cache:
    """A zeroed cache of ``batch`` sequences of ``max_len`` positions on
    ``device`` (``"meta"``: shapes and dtypes only, see
    :func:`abstract_cache`)."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_leaves(cfg, batch, max_len,
                                               dtype).items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """:func:`init_cache`'s tree as ``meta`` tensors (the reference's
    ``jax.eval_shape`` of it): nothing is allocated."""
    return init_cache(cfg, batch, max_len, device="meta")


def _is_laid_out(tree) -> bool:
    """Whether a tree holds DTensors (sharded serving's layout)."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(
        isinstance(x, mod.DTensor) for x in leaves(tree))


def _local(x):
    """A DTensor's local block, else ``x``."""
    return x.to_local() if hasattr(x, "to_local") else x


class _Layout(NamedTuple):
    """Sharded serving's cache layout on one call: the cache's
    ``NamedSharding`` and whole shape a leaf, the rank's block of the KV
    cache's sequence (``launch.sharding.Block``; None without a KV
    cache), whether its KV heads are the rank's block over "model", and
    the logits' and page masses' batch entry."""
    mesh: Any
    shardings: Dict[str, Any]
    shapes: Dict[str, Tuple[int, ...]]
    kv: Any
    kv_local: bool
    batch: Any


def _layout(cfg: ModelConfig, mesh, batch: int, max_len: int) -> _Layout:
    """The serving cache's layout for a global ``batch`` of ``max_len``
    positions on ``mesh``, checked against ``cfg``'s batch axes and its
    tensor parallelism (``serve.sharded.serve_config``'s)."""
    specs = sh.cache_pspecs(mesh, cfg, batch, max_len)
    bax = sh.entry_axes(specs["pos"][0])
    if bax != tuple(cfg.act_batch_axes or ()):
        raise ValueError(
            f"the batch of {batch} splits over {bax} on this mesh, the "
            f"config's batch axes are {cfg.act_batch_axes}: make the config "
            f"with serve.sharded.serve_config")
    kv, kv_local = None, False
    if "k" in specs:
        kv = sh.block(mesh, specs["k"][3], max_len)
        kv_local = bool(sh.block(mesh, specs["k"][2], cfg.n_kv_heads).axes)
        tp = tensor_parallel(cfg, mesh)
        if kv_local and (tp is None or tp.kv != "local"):
            raise ValueError(
                "the cache's KV heads are cut over \"model\" but the "
                "attention does not run on the rank's KV heads: make the "
                "config with serve.sharded.serve_config")
    shapes = {k: shape for k, (shape, _) in
              cache_leaves(cfg, batch, max_len).items()}
    return _Layout(mesh, sh.named(mesh, specs), shapes, kv, kv_local,
                   specs["pos"][0])


def _block_cache(cfg: ModelConfig, lay: _Layout, device) -> Cache:
    """Zeros of the rank's block of every cache leaf."""
    return {k: torch.zeros(sh.block_shape(lay.mesh, lay.shardings[k].spec,
                                       lay.shapes[k]), dtype=dt, device=device)
            for k, (_, dt) in cache_leaves(cfg, 1, 1).items()}


def _wrap(lay: _Layout, local, spec, shape):
    return sh.wrap(local, sh.NamedSharding(lay.mesh, spec), shape)


def _wrap_cache(lay: _Layout, cache: Cache) -> Cache:
    return {k: sh.wrap(v, lay.shardings[k], lay.shapes[k])
            for k, v in cache.items()}


def _state_cuts(lay: Optional[_Layout], name: str):
    """(dim, axis) of each mesh axis of more than one rank that cuts a
    layer's slice of the recurrent cache leaf ``name`` (its dims after
    the layer dim; the batch entry left out: the rank's rows are its
    own)."""
    if lay is None:
        return ()
    sizes = sh.mesh_axes(lay.mesh)
    return tuple((d, a) for d, e in enumerate(lay.shardings[name].spec[2:], 1)
                 for a in sh.entry_axes(e) if sizes[a] > 1)


def _rest(t: torch.Tensor, lay: Optional[_Layout], name: str):
    """A layer's whole recurrent state ``t`` -> the rank's block of it."""
    for d, a in _state_cuts(lay, name):
        t = sh.split_seq(t, lay.mesh, a, d)
    return t


def _at_use(t: torch.Tensor, lay: Optional[_Layout], name: str):
    """The rank's block of a layer's recurrent state -> the whole state
    (one all-gather an axis that cuts it)."""
    for d, a in reversed(_state_cuts(lay, name)):
        t = sh.gather_seq(t, lay.mesh, a, d)
    return t


def _kv_rows(lay: Optional[_Layout], s: int):
    """The prompt's rows of the rank's block of the KV cache's sequence:
    ``(first, count)`` (None: all of it, no layout)."""
    if lay is None or lay.kv is None:
        return None
    return lay.kv.first, max(0, min(lay.kv.count, s - lay.kv.first))


def prefill(params: dict, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, max_len: Optional[int] = None, mesh=None
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence pass that also builds the cache.  Returns (last-token
    logits (B, V), cache).  On a CUDA device every attention runs the
    ``flash_attention`` kernel once: each layer of the attn and moe
    families, each of zamba2's ``n_shared_attn`` shared-block invocations,
    none for rwkv6.

    ``mesh``: sharded serving (the module doc): with DTensor ``params``
    the logits come back as a DTensor of the batch split over the batch
    axes, the cache as the rank's blocks of ``cache_pspecs``, each rank's
    attention at its heads; each MoE layer routes by ``cfg``'s
    ``moe_groups`` / ``moe_expert_sharded`` as the reference's prefill
    passes them (the expert-parallel path, the expert leaves this rank's
    block of them).  With plain ``params`` the older form (the module
    doc)."""
    # the reference swaps the triangular schedule for the masked one at
    # prefill (an XLA layout choice; the same function here)
    if cfg.causal_schedule == "triangular":
        cfg = dataclasses.replace(cfg, causal_schedule="masked")
    lay = None
    tokens, embeds, positions = (None if t is None else _local(t)
                                 for t in (tokens, embeds, positions))
    laid = mesh is not None and _is_laid_out(params)
    if laid:
        params = sh.hand_over(params, cfg, mesh)
    x = embed_inputs(params, cfg, tokens, embeds, mesh)
    b, s, _ = x.shape
    max_len = max_len or s
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    if laid:
        sizes = sh.mesh_axes(mesh)
        n = math.prod(sizes[a] for a in cfg.act_batch_axes or ())
        lay = _layout(cfg, mesh, b * n, max_len)
        cache = _block_cache(cfg, lay, x.device)
    else:
        cache = init_cache(cfg, b, max_len, device=x.device)
    cache["pos"].fill_(s)
    rows = _kv_rows(lay, s)
    if cfg.family in ("attn", "moe"):
        for i in range(cfg.n_layers):
            x = constrain_batch(x, cfg)
            x, _, (k, v) = transformer_block(
                x, gathered(layer_params(params, i)), cfg, positions,
                return_kv=True, mesh=mesh, kv_rows=rows)
            cache["k"][i, :, :, :k.shape[2]] = k
            cache["v"][i, :, :, :v.shape[2]] = v
    elif cfg.family == "rwkv6":
        # sh_ffn is the channel mix's own input (ln2 of x after the time
        # mix), what decode_step continues from; the reference stores ln2
        # of the block's output there (ROADMAP Queue 3)
        for i in range(cfg.n_layers):
            x, st, (cache["sh_mix"][i], cache["sh_ffn"][i]) = rwkv6_block(
                x, gathered(layer_params(params, i)), cfg, return_shift=True)
            cache["wkv"][i] = _rest(st, lay, "wkv")
    elif cfg.family == "zamba2":
        every = cfg.zamba_attn_every
        for inv in range(cfg.n_shared_attn):
            for i in range(inv * every, (inv + 1) * every):
                x = _mamba_prefill(x, gathered(layer_params(params, i)), cfg,
                                   cache, i, lay)
            x, (k, v) = zamba2_shared_attention(
                x, gathered(params["shared_attn"]), cfg, inv, positions,
                return_kv=True, mesh=mesh, kv_rows=rows)
            cache["k"][inv, :, :, :k.shape[2]] = k
            cache["v"][inv, :, :, :v.shape[2]] = v
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, gathered(params["final_norm"]), cfg.norm_eps)
    logits = logits_fn(params, cfg, x[:, -1:], mesh)[:, 0]
    if lay is None:
        return logits, cache
    return (_wrap(lay, logits, sh.PartitionSpec(lay.batch, None),
                  (lay.shapes["pos"][0], logits.shape[1])),
            _wrap_cache(lay, cache))


def _mamba_prefill(x, bp, cfg: ModelConfig, cache: Cache, i: int,
                   lay: Optional[_Layout]):
    """Zamba2's Mamba2 layer ``i`` at prefill: its conv state, the last 3
    pre-conv inputs (in_proj's x / B / C slice of the last rows; zeros
    before a shorter prompt, as the causal conv pads), and its SSM state
    into the cache (the rank's blocks of them)."""
    di, n = cfg.d_inner, cfg.ssm_state
    tail = min(x.shape[1], 3)
    xn = rms_norm(x[:, -tail:], bp["ln1"], cfg.norm_eps)
    cache["conv"][i, :, 3 - tail:] = _rest(
        xn @ bp["in_proj"][:, di:2 * di + 2 * n].to(x.dtype), lay, "conv")
    x, st = zamba2_mamba_block(x, bp, cfg)
    cache["ssm"][i] = _rest(st, lay, "ssm")
    return x


def _attn_decode(h, proj, wo, kc, vc, pos, cfg: ModelConfig, tp,
                 lay: Optional[_Layout], page_size: int, rope: bool = True):
    """One token's attention of a layer -> (its output (B, D) before the
    residual, the page mass or None).  ``proj(h, name, sel, local)`` the
    q / k / v projections (``layers.attention_block``'s), ``wo`` the
    output projection (the rank's rows of it under ``tp``); K / V written
    into the cache blocks ``kc`` / ``vc`` in place.  Under ``tp`` the rank
    projects its query heads; where the cache holds its own KV heads it
    attends them with its k / v, else every rank takes all the heads (q
    all-gathered over "model", k / v from the whole weights) over its
    slice of the sequence and keeps its heads' output."""
    b, hd = h.shape[0], cfg.head_dim
    kv_local = lay is not None and lay.kv_local
    if tp is None:
        q, k, v = (proj(h, n, None, False) for n in ("q", "k", "v"))
    else:
        m, r = tp.size, tp.rank
        qw, kvw = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q = proj(h, "q", (r * qw // m, qw // m), True)
        if kv_local:
            k, v = (proj(h, n, (r * kvw // m, kvw // m), True)
                    for n in ("k", "v"))
        else:
            q = sh.gather_seq(q, tp.mesh, "model", -1)
            k, v = (proj(h, n, None, False) for n in ("k", "v"))
    q, k, v = (t.reshape(b, -1, hd) for t in (q, k, v))
    if rope:
        q = apply_rope(q[:, :, None, :], pos[:, None, None],
                       cfg.rope_theta)[:, :, 0]
        k = apply_rope(k[:, :, None, :], pos[:, None, None],
                       cfg.rope_theta)[:, :, 0]
    seq = lay.kv if lay is not None and lay.kv.axes else None
    attn_lib.write_kv_(kc, vc, k, v, pos,
                       first=None if seq is None else seq.first)
    out = attn_lib.decode_step(
        q, kc, vc, pos, window=cfg.window, page_size=page_size,
        seq=None if seq is None else (seq.first, lay.mesh, seq.axes))
    o, mass = out if page_size else (out, None)
    o = o.reshape(b, -1)
    if tp is not None and not kv_local:
        o = o.narrow(-1, r * qw // m, qw // m)
    o = o @ wo.to(h.dtype)
    if tp is None:
        return o, mass
    if mass is not None and kv_local:
        # the rank's heads' share of each page's mass
        sh.all_reduce(mass, tp.mesh, ("model",))
    return sh.from_model(o, tp.mesh), mass


def _zamba_shared_attn_decode(x, sp, cfg, inv, kc, vc, pos, tp=None,
                              lay=None):
    """The shared block for one token at invocation ``inv``: K/V written
    into ``kc`` / ``vc`` (B, KVH, S, hd) in place with
    ``attention.write_kv_``, decode attention in plain PyTorch
    (``attention.decode_step``), as for every family; tensor parallel
    under ``tp`` (:func:`_attn_decode`)."""
    h = rms_norm(x[:, None], sp["ln"], cfg.norm_eps)[:, 0]
    o, _ = _attn_decode(
        h, lambda t, nm, sel, local: shared_proj(t, sp, cfg, inv, nm, sel,
                                                 local),
        sp["wo"], kc, vc, pos, cfg, tp if tp is not None and tp.heads
        else None, lay, 0)
    x = x + o
    hm = rms_norm(x[:, None], sp["ln_mlp"], cfg.norm_eps)
    return x + swiglu(hm, sp["w_gate"], sp["w_up"], sp["w_down"],
                      tp=tp if tp is not None and tp.mlp else None)[:, 0]


def _decode_layer(x, bp, cfg: ModelConfig, kc, vc, pos, tp,
                  lay: Optional[_Layout], page_size: int, mesh):
    """One dense or MoE layer for one token -> (x, the page mass or None,
    the MoE layer's router counts or None); K / V written into ``kc`` /
    ``vc`` in place.  A MoE layer routes with capacity factor 4.0, the
    whole batch's routing under ``mesh``."""
    h = rms_norm(x[:, None], bp["ln1"], cfg.norm_eps)[:, 0]
    ap = AttnParams(bp["wq"], bp["wk"], bp["wv"], bp["wo"], bp.get("bq"),
                    bp.get("bk"), bp.get("bv"))
    # mrope degenerates to 1-D rope at decode (text position)
    o, mass = _attn_decode(
        h, lambda t, nm, sel, local: attn_proj(ap, t, nm, sel, local),
        bp["wo"], kc, vc, pos, cfg,
        tp if tp is not None and tp.heads else None, lay, page_size,
        rope=cfg.rope in ("rope", "mrope"))
    x = x + o
    h2 = rms_norm(x[:, None], bp["ln2"], cfg.norm_eps)
    counts = None
    if cfg.family == "moe":
        h2, moe_aux = moe_block(h2, moe_params(bp), top_k=cfg.moe.top_k,
                                capacity_factor=4.0,
                                batch_axes=cfg.act_batch_axes, mesh=mesh)
        counts = moe_aux["counts"]
    else:
        h2 = swiglu(h2, bp["w_gate"], bp["w_up"], bp["w_down"],
                    tp=tp if tp is not None and tp.mlp else None)
    return x + h2[:, 0], mass, counts


def _rwkv6_decode(x, bp, cfg: ModelConfig, cache: Cache, i: int,
                  lay: Optional[_Layout]):
    """RWKV-6 layer ``i`` for one token; its states written into the
    cache (the wkv state gathered at use, the rank's block kept)."""
    xn = rms_norm(x[:, None], bp["ln1"], cfg.norm_eps)[:, 0]
    h, st = rwkv6_mix_step(
        xn, cache["sh_mix"][i], _at_use(cache["wkv"][i], lay, "wkv"),
        rwkv6_params(bp), n_heads=cfg.d_model // 64)
    cache["wkv"][i] = _rest(st, lay, "wkv")
    x = x + h
    xn2 = rms_norm(x[:, None], bp["ln2"], cfg.norm_eps)[:, 0]
    x = x + rwkv6_channel_mix_step(xn2, cache["sh_ffn"][i],
                                   rwkv6_ffn_params(bp))
    cache["sh_mix"][i], cache["sh_ffn"][i] = xn, xn2
    return x


def _mamba_decode(x, bp, cfg: ModelConfig, cache: Cache, i: int,
                  lay: Optional[_Layout]):
    """Zamba2's Mamba2 layer ``i`` for one token; its conv and SSM states
    written into the cache (gathered at use, the rank's blocks kept)."""
    xn = rms_norm(x[:, None], bp["ln1"], cfg.norm_eps)[:, 0]
    h, conv, st = mamba2_mix_step(
        xn, _at_use(cache["conv"][i], lay, "conv"),
        _at_use(cache["ssm"][i], lay, "ssm"), mamba2_params(bp),
        d_inner=cfg.d_inner, n_heads=cfg.mamba_heads, d_state=cfg.ssm_state)
    cache["conv"][i] = _rest(conv, lay, "conv")
    cache["ssm"][i] = _rest(st, lay, "ssm")
    return x + h


def _decode_layout(cfg: ModelConfig, mesh, cache: Cache):
    """(layout, the rank's cache blocks) of a DTensor cache laid out by
    ``cache_pspecs`` on ``mesh``."""
    if not _is_laid_out(cache):
        raise ValueError("decode_step(mesh=) takes the cache as DTensors "
                         "laid out by cache_pspecs (prefill(mesh=)'s)")
    max_len = cache["k"].shape[3] if "k" in cache else 1
    lay = _layout(cfg, mesh, cache["pos"].shape[0], max_len)
    for k, x in cache.items():
        if tuple(x.placements) != lay.shardings[k].placements:
            raise ValueError(f"cache leaf {k!r} is laid out {x.placements}, "
                             f"not by cache_pspecs "
                             f"({lay.shardings[k].placements})")
    return lay, {k: x.to_local() for k, x in cache.items()}


def decode_step(params: dict, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor, page_size: int = 0, mesh=None
                ) -> Tuple[torch.Tensor, Cache, Dict[str, Any]]:
    """One token for every sequence in the batch.  tokens: (B,) int.
    Returns (logits (B, V), cache, telemetry aux); the cache's tensors are
    the given ones, written in place, and its ``pos`` is ``pos + 1``.  For
    the attn and moe families aux["kv_page_mass"] is (L, B, ceil(S /
    page_size)) float32 with ``page_size`` (zeros (L, B, 1) without), and
    for moe aux["expert_counts"] is (L, E) int32; for rwkv6 and zamba2
    aux is empty (no page telemetry; ``page_size`` is ignored, as in the
    reference).

    ``mesh``: sharded serving (the module doc): ``params`` and the cache
    DTensors (the cache ``prefill(mesh=)``'s), ``tokens`` the rank's
    slice; the logits, the cache and the page mass come back as DTensors
    (each rank its pages: those of its slice of the sequence, summed over
    every head), the expert counts whole."""
    lay = None
    if mesh is not None:
        lay, cache = _decode_layout(cfg, mesh, cache)
        params = sh.hand_over(params, cfg, mesh)
        tokens = _local(tokens)
    tp = tensor_parallel(cfg, mesh)
    x = embed_inputs(params, cfg, tokens, mesh=mesh)             # (B, D)
    pos = cache["pos"]
    b = x.shape[0]
    aux: Dict[str, Any] = {}
    if cfg.family in ("attn", "moe"):
        masses, counts = [], []
        for i in range(cfg.n_layers):
            x, mass, count = _decode_layer(
                constrain_batch(x, cfg), gathered(layer_params(params, i)),
                cfg, cache["k"][i], cache["v"][i], pos, tp, lay, page_size,
                mesh)
            masses.append(mass)
            counts.append(count)
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
            x = _rwkv6_decode(x, gathered(layer_params(params, i)), cfg,
                              cache, i, lay)
    elif cfg.family == "zamba2":
        every = cfg.zamba_attn_every
        for inv in range(cfg.n_shared_attn):
            for i in range(inv * every, (inv + 1) * every):
                x = _mamba_decode(x, gathered(layer_params(params, i)), cfg,
                                  cache, i, lay)
            x = _zamba_shared_attn_decode(
                x, gathered(params["shared_attn"]), cfg, inv,
                cache["k"][inv], cache["v"][inv], pos, tp, lay)
    else:
        raise ValueError(cfg.family)
    cache = dict(cache, pos=pos + 1)
    x = rms_norm(x[:, None], gathered(params["final_norm"]), cfg.norm_eps)
    logits = logits_fn(params, cfg, x, mesh)[:, 0]
    if lay is None:
        return logits, cache, aux
    if "kv_page_mass" in aux:
        mass = aux["kv_page_mass"]
        seq = lay.shardings["k"].spec[3] if page_size else None
        pages = -(-lay.shapes["k"][3] // page_size) if page_size else 1
        aux["kv_page_mass"] = _wrap(
            lay, mass, sh.PartitionSpec(None, lay.batch, seq),
            (mass.shape[0], lay.shapes["pos"][0], pages))
    return (_wrap(lay, logits, sh.PartitionSpec(lay.batch, None),
                  (lay.shapes["pos"][0], logits.shape[1])),
            _wrap_cache(lay, cache), aux)


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
