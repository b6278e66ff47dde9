"""The causal LM of ``repro/models/model.py`` in PyTorch, all four
families.

``ModelConfig`` describes every family of the reference, and
:func:`iter_schema` walks the parameters of all of them (a pure shape walk,
so :meth:`ModelConfig.param_count` works for every config).  The forward
passes:

* ``attn`` — dense decoder-only transformers (llama3.2, qwen2, internlm2,
  yi, musicgen, qwen2-vl with the token frontend);
* ``moe`` — routed-FFN transformers (mixtral, kimi-k2; the FFN is
  :func:`repro_torch.models.moe.moe_block`, whose router counts come back
  as ``aux["expert_counts"]``);
* ``rwkv6`` — attention-free RWKV-6 (:mod:`repro_torch.models.rwkv6`);
* ``zamba2`` — Mamba2 layers (:mod:`repro_torch.models.mamba2`) with a
  shared attention block after every ``zamba_attn_every`` of them, its
  q/k/v adapted by a per-invocation LoRA.

Parameters are a nested dict of tensors in the reference's layout: the
per-layer leaves are stacked along a leading ``n_layers`` dim under
``params["blocks"]``, and a Python loop over layers takes the place of the
reference's ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.dispatch import resolve_device
from . import attention as attn_lib
from .layers import AttnParams, apply_rope, attention_block, rms_norm, swiglu
from .mamba2 import Mamba2Params, mamba2_mix
from .moe import MoEParams, moe_block
from .rwkv6 import (RWKV6FFNParams, RWKV6Params, rwkv6_channel_mix,
                    rwkv6_mix)

__all__ = ["LeafSpec", "MoECfg", "ModelConfig", "constrain_batch", "forward",
           "init_params", "iter_schema", "layer_params", "logits_fn",
           "loss_fn", "loss_terms", "mamba2_params", "moe_params",
           "param_pspecs", "rwkv6_ffn_params", "rwkv6_params", "rwkv6_block",
           "shared_qkv", "transformer_block", "zamba2_mamba_block",
           "zamba2_shared_attention"]


# =============================================================== configuration
@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # attn | moe | rwkv6 | zamba2
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    window: Optional[int] = None    # sliding-window attention (mixtral)
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 10000.0
    moe: Optional[MoECfg] = None
    ssm_state: int = 64             # zamba2
    zamba_attn_every: int = 6
    frontend: str = "tokens"        # tokens | embeddings (audio/vlm stubs)
    param_dtype: Any = torch.float32
    activ_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-5
    causal_schedule: str = "triangular"  # triangular | masked (same math)
    attn_block_k: int = 512
    loss_chunk: int = 256
    remat: str = "full"             # full | dots | none
    sub_quadratic: bool = False     # eligible for long_500k
    tie_embeddings: bool = False
    # mesh axes the activation batch dim shards over (set by the sharded
    # train step; None = no constraint, e.g. single-device runs)
    act_batch_axes: Optional[Tuple[str, ...]] = None
    moe_groups: Optional[Tuple[int, int]] = None
    moe_expert_sharded: bool = False

    @property
    def d_inner(self) -> int:       # zamba2 mamba expansion
        return 2 * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.d_inner // 64

    @property
    def n_shared_attn(self) -> int:
        return self.n_layers // self.zamba_attn_every

    def param_count(self) -> int:
        return sum(int(np.prod(spec.shape)) for _, spec in iter_schema(self))


# ============================================================== schema leaves
@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | small_normal
    dtype: Any = None               # default: cfg.param_dtype


def _attn_leaves(cfg: ModelConfig, prefix: str, stacked: bool
                 ) -> Dict[str, LeafSpec]:
    L = (cfg.n_layers,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    leaves = {
        f"{prefix}wq": LeafSpec(L + (d, h * hd), lax_ + ("embed", "heads")),
        f"{prefix}wk": LeafSpec(L + (d, kvh * hd), lax_ + ("embed", "kv_heads")),
        f"{prefix}wv": LeafSpec(L + (d, kvh * hd), lax_ + ("embed", "kv_heads")),
        f"{prefix}wo": LeafSpec(L + (h * hd, d), lax_ + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        leaves |= {
            f"{prefix}bq": LeafSpec(L + (h * hd,), lax_ + ("heads",), "zeros"),
            f"{prefix}bk": LeafSpec(L + (kvh * hd,), lax_ + ("kv_heads",), "zeros"),
            f"{prefix}bv": LeafSpec(L + (kvh * hd,), lax_ + ("kv_heads",), "zeros"),
        }
    return leaves


def _mlp_leaves(cfg: ModelConfig, prefix: str = "") -> Dict[str, LeafSpec]:
    L, lax_ = (cfg.n_layers,), ("layers",)
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{prefix}w_gate": LeafSpec(L + (d, f), lax_ + ("embed", "mlp")),
        f"{prefix}w_up": LeafSpec(L + (d, f), lax_ + ("embed", "mlp")),
        f"{prefix}w_down": LeafSpec(L + (f, d), lax_ + ("mlp", "embed")),
    }


def iter_schema(cfg: ModelConfig):
    """Yields (path, LeafSpec) for every parameter of the model, in the
    reference's order."""
    d, v = cfg.d_model, cfg.vocab_size
    L, lax_ = (cfg.n_layers,), ("layers",)

    yield "embed", LeafSpec((v, d), ("vocab", "embed"))
    yield "final_norm", LeafSpec((d,), (None,), "ones")
    if not cfg.tie_embeddings:
        yield "lm_head", LeafSpec((d, v), ("embed", "vocab"))

    fam = cfg.family
    if fam in ("attn", "moe"):
        yield from _attn_leaves(cfg, "blocks.", True).items()
        yield "blocks.ln1", LeafSpec(L + (d,), lax_ + (None,), "ones")
        yield "blocks.ln2", LeafSpec(L + (d,), lax_ + (None,), "ones")
        if fam == "attn":
            yield from _mlp_leaves(cfg, "blocks.").items()
        else:
            m = cfg.moe
            e, fe = m.n_experts, m.d_expert
            yield "blocks.router", LeafSpec(L + (d, e), lax_ + ("embed", None), "small_normal")
            yield "blocks.e_gate", LeafSpec(L + (e, d, fe), lax_ + ("experts", "embed", "expert_mlp"))
            yield "blocks.e_up", LeafSpec(L + (e, d, fe), lax_ + ("experts", "embed", "expert_mlp"))
            yield "blocks.e_down", LeafSpec(L + (e, fe, d), lax_ + ("experts", "expert_mlp", "embed"))
            if m.n_shared:
                fs = m.d_expert * m.n_shared
                yield "blocks.s_gate", LeafSpec(L + (d, fs), lax_ + ("embed", "mlp"))
                yield "blocks.s_up", LeafSpec(L + (d, fs), lax_ + ("embed", "mlp"))
                yield "blocks.s_down", LeafSpec(L + (fs, d), lax_ + ("mlp", "embed"))

    elif fam == "rwkv6":
        yield "blocks.ln1", LeafSpec(L + (d,), lax_ + (None,), "ones")
        yield "blocks.ln2", LeafSpec(L + (d,), lax_ + (None,), "ones")
        yield "blocks.tm_mu", LeafSpec(L + (5, d), lax_ + (None, None), "zeros")
        yield "blocks.tm_lora_a", LeafSpec(L + (d, 32), lax_ + ("embed", None), "small_normal")
        yield "blocks.tm_lora_b", LeafSpec(L + (5, 32, d), lax_ + (None, None, "embed"), "zeros")
        yield "blocks.w0", LeafSpec(L + (d,), lax_ + (None,), "ones")
        yield "blocks.w_lora_a", LeafSpec(L + (d, 64), lax_ + ("embed", None), "small_normal")
        yield "blocks.w_lora_b", LeafSpec(L + (64, d), lax_ + (None, "embed"), "zeros")
        yield "blocks.u", LeafSpec(L + (d,), lax_ + (None,), "zeros")
        for w in ("wr", "wk", "wv", "wg", "wo"):
            yield f"blocks.{w}", LeafSpec(L + (d, d), lax_ + ("embed", "heads"))
        yield "blocks.ln_x", LeafSpec(L + (d,), lax_ + (None,), "ones")
        yield "blocks.f_mu_k", LeafSpec(L + (d,), lax_ + (None,), "zeros")
        yield "blocks.f_mu_r", LeafSpec(L + (d,), lax_ + (None,), "zeros")
        yield "blocks.f_wk", LeafSpec(L + (d, cfg.d_ff), lax_ + ("embed", "mlp"))
        yield "blocks.f_wv", LeafSpec(L + (cfg.d_ff, d), lax_ + ("mlp", "embed"))
        yield "blocks.f_wr", LeafSpec(L + (d, d), lax_ + ("embed", "heads"))

    elif fam == "zamba2":
        di, n = cfg.d_inner, cfg.ssm_state
        h = cfg.mamba_heads
        conv_ch = di + 2 * n
        yield "blocks.ln1", LeafSpec(L + (d,), lax_ + (None,), "ones")
        yield "blocks.in_proj", LeafSpec(L + (d, 2 * di + 2 * n + h), lax_ + ("embed", "mlp"))
        yield "blocks.conv_w", LeafSpec(L + (4, conv_ch), lax_ + (None, "mlp"), "small_normal")
        yield "blocks.conv_b", LeafSpec(L + (conv_ch,), lax_ + ("mlp",), "zeros")
        yield "blocks.a_log", LeafSpec(L + (h,), lax_ + (None,), "ones")
        yield "blocks.d_skip", LeafSpec(L + (h,), lax_ + (None,), "ones")
        yield "blocks.dt_bias", LeafSpec(L + (h,), lax_ + (None,), "zeros")
        yield "blocks.norm", LeafSpec(L + (di,), lax_ + (None,), "ones")
        yield "blocks.out_proj", LeafSpec(L + (di, d), lax_ + ("mlp", "embed"))
        ninv = cfg.n_shared_attn
        for k, spec in _attn_leaves(cfg, "shared_attn.", False).items():
            yield k, spec
        yield "shared_attn.ln", LeafSpec((d,), (None,), "ones")
        yield "shared_attn.ln_mlp", LeafSpec((d,), (None,), "ones")
        yield "shared_attn.w_gate", LeafSpec((d, cfg.d_ff), ("embed", "mlp"))
        yield "shared_attn.w_up", LeafSpec((d, cfg.d_ff), ("embed", "mlp"))
        yield "shared_attn.w_down", LeafSpec((cfg.d_ff, d), ("mlp", "embed"))
        r = 32
        for nm in ("q", "k", "v"):
            yield f"shared_attn.lora_{nm}_a", LeafSpec(
                (ninv, d, r), (None, "embed", None), "small_normal")
            yield f"shared_attn.lora_{nm}_b", LeafSpec(
                (ninv, r, d), (None, None, "heads"), "zeros")
    else:
        raise ValueError(cfg.family)


# ----------------------------------------------------------- schema consumers
def _set(tree: dict, path: str, val) -> None:
    parts = path.split(".")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = val


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random-init parameters, the reference's scales: ``normal`` leaves
    ``N(0, 1) * min(0.02, fan_in ** -0.5)``, ``small_normal`` with 0.006.

    The draws come from one CPU ``torch.Generator`` seeded with ``seed``, leaf
    after leaf in schema order, and are then moved to ``device``, so a GPU run
    and a CPU run get the same weights.  (They are not the reference's
    ``jax.random`` weights; tests carry those across with
    :func:`repro_torch.convert.params_from_numpy`.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    tree: dict = {}
    for path, spec in iter_schema(cfg):
        dt = spec.dtype or cfg.param_dtype
        if spec.init == "zeros":
            val = torch.zeros(spec.shape, dtype=dt, device=dev)
        elif spec.init == "ones":
            val = torch.ones(spec.shape, dtype=dt, device=dev)
        else:
            scale = 0.02 if spec.init == "normal" else 0.006
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            scale = min(scale, fan_in ** -0.5)
            val = (torch.randn(spec.shape, generator=gen, dtype=torch.float32)
                   * scale).to(dt).to(dev)
        _set(tree, path, val)
    return tree


def param_pspecs(cfg: ModelConfig, rules: Dict[Optional[str], Any]) -> dict:
    """Each parameter's :class:`repro_torch.launch.sharding.PartitionSpec`:
    its logical axes mapped through ``rules``."""
    from ..launch.sharding import PartitionSpec
    tree: dict = {}
    for path, spec in iter_schema(cfg):
        _set(tree, path, PartitionSpec(*(rules.get(a)
                                         for a in spec.logical_axes)))
    return tree


# ================================================================ block passes
def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["blocks"]`` leaves."""
    return {k: v[i] for k, v in params["blocks"].items()}


def _attn_params(bp: dict) -> AttnParams:
    return AttnParams(wq=bp["wq"], wk=bp["wk"], wv=bp["wv"], wo=bp["wo"],
                      bq=bp.get("bq"), bk=bp.get("bk"), bv=bp.get("bv"))


def moe_params(bp: dict) -> MoEParams:
    """One layer's MoE leaves (shared-expert leaves None when absent)."""
    return MoEParams(router=bp["router"], w_gate=bp["e_gate"],
                     w_up=bp["e_up"], w_down=bp["e_down"],
                     shared_w_gate=bp.get("s_gate"),
                     shared_w_up=bp.get("s_up"),
                     shared_w_down=bp.get("s_down"))


def transformer_block(x: torch.Tensor, bp: dict, cfg: ModelConfig,
                      positions: torch.Tensor, return_kv: bool = False,
                      mesh=None):
    """One dense or MoE transformer layer -> (x, aux), aux the MoE layer's
    ``{"counts", "aux_loss"}`` or None; with ``return_kv``
    (x, aux, (k, v)), the prefill's cache rows.  ``mesh``: ``x`` is a
    rank's slice of a batch split over ``cfg.act_batch_axes`` of it (see
    :func:`forward`)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    h = attention_block(
        h, _attn_params(bp),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        positions=positions, rope_mode=cfg.rope, rope_theta=cfg.rope_theta,
        window=cfg.window, causal_schedule=cfg.causal_schedule,
        block_k=cfg.attn_block_k, return_kv=return_kv,
    )
    kv = None
    if return_kv:
        h, kv = h
    x = x + h
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    aux = None
    if cfg.family == "moe":
        h, aux = moe_block(h, moe_params(bp), top_k=cfg.moe.top_k,
                           capacity_factor=cfg.moe.capacity_factor,
                           groups=cfg.moe_groups or (1, 1),
                           batch_axes=cfg.act_batch_axes, mesh=mesh,
                           expert_sharded=cfg.moe_expert_sharded)
    else:
        h = swiglu(h, bp["w_gate"], bp["w_up"], bp["w_down"])
    if return_kv:
        return x + h, aux, kv
    return x + h, aux


def rwkv6_params(bp: dict) -> RWKV6Params:
    """One layer's RWKV-6 time-mix leaves."""
    return RWKV6Params(*(bp[f] for f in RWKV6Params._fields))


def rwkv6_ffn_params(bp: dict) -> RWKV6FFNParams:
    """One layer's RWKV-6 channel-mix leaves (``f_*``)."""
    return RWKV6FFNParams(*(bp["f_" + f] for f in RWKV6FFNParams._fields))


def mamba2_params(bp: dict) -> Mamba2Params:
    """One layer's Mamba2 leaves."""
    return Mamba2Params(*(bp[f] for f in Mamba2Params._fields))


def rwkv6_block(x: torch.Tensor, bp: dict, cfg: ModelConfig, state=None,
                return_shift: bool = False):
    """One RWKV-6 layer -> (x, final wkv state).  Heads of 64 channels
    (``d_model // 64``, as the reference; not ``cfg.n_heads``).  With
    ``return_shift`` -> (x, state, (sh_mix, sh_ffn)): the last position's
    normed inputs of the time mix and of the channel mix, the token shift
    a decode step continues from."""
    xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
    h, state = rwkv6_mix(xn, rwkv6_params(bp), state,
                         n_heads=cfg.d_model // 64)
    x = x + h
    xn2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + rwkv6_channel_mix(xn2, rwkv6_ffn_params(bp))
    if return_shift:
        return x, state, (xn[:, -1], xn2[:, -1])
    return x, state


def zamba2_mamba_block(x: torch.Tensor, bp: dict, cfg: ModelConfig,
                       state=None):
    """One Zamba2 Mamba2 layer (no MLP) -> (x, final SSM state)."""
    h, state = mamba2_mix(rms_norm(x, bp["ln1"], cfg.norm_eps),
                          mamba2_params(bp), state, d_inner=cfg.d_inner,
                          n_heads=cfg.mamba_heads, d_state=cfg.ssm_state)
    return x + h, state


def shared_qkv(h: torch.Tensor, sp: dict, cfg: ModelConfig, inv: int):
    """The shared block's q, k, v projections of the normed input ``h``
    (..., D), each with invocation ``inv``'s LoRA delta (h a) b added:
    (..., H * hd), (..., KVH * hd), (..., KVH * hd)."""
    dt, hd = h.dtype, cfg.head_dim
    out = []
    for nm, n in (("q", cfg.n_heads), ("k", cfg.n_kv_heads),
                  ("v", cfg.n_kv_heads)):
        delta = (h @ sp[f"lora_{nm}_a"][inv].to(dt)) \
            @ sp[f"lora_{nm}_b"][inv].to(dt)
        out.append(h @ sp["w" + nm].to(dt) + delta[..., :n * hd])
    return out


def zamba2_shared_attention(x: torch.Tensor, sp: dict, cfg: ModelConfig,
                            inv: int, positions: torch.Tensor,
                            return_kv: bool = False):
    """The shared attention block at invocation ``inv``: per-invocation
    LoRA on q/k/v, RoPE, causal attention through
    :func:`repro_torch.models.attention.flash_train` (the
    ``flash_attention`` kernel on a CUDA tensor), the output projection,
    then the shared SwiGLU.  With ``return_kv`` -> (x, (k, v)), the
    prefill's cache rows (after RoPE)."""
    h = rms_norm(x, sp["ln"], cfg.norm_eps)
    b, s, _ = h.shape
    hd, nh = cfg.head_dim, cfg.n_heads
    q, k, v = (t.reshape(b, s, -1, hd).transpose(1, 2)
               for t in shared_qkv(h, sp, cfg, inv))
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    o = attn_lib.flash_train(q, k, v, causal=True, window=cfg.window,
                             causal_schedule=cfg.causal_schedule,
                             block_k=cfg.attn_block_k)
    x = x + o.transpose(1, 2).reshape(b, s, nh * hd) @ sp["wo"].to(h.dtype)
    hm = rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
    x = x + swiglu(hm, sp["w_gate"], sp["w_up"], sp["w_down"])
    if return_kv:
        return x, (k, v)
    return x


# ================================================================== forward
def constrain_batch(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pin the activation batch dim to ``cfg.act_batch_axes``: a DTensor is
    redistributed to ``Shard`` over them on its batch dim; a plain tensor
    (a rank's own slice, or a single-device run) is returned as it is."""
    # no DTensor exists before its module is imported (which takes seconds)
    mod = sys.modules.get("torch.distributed.tensor")
    if not cfg.act_batch_axes or mod is None or not isinstance(x,
                                                               mod.DTensor):
        return x
    from ..launch.sharding import PartitionSpec, placements
    axes = tuple(cfg.act_batch_axes)
    want = placements(x.device_mesh, PartitionSpec(
        axes if len(axes) > 1 else axes[0], *([None] * (x.ndim - 1))))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def default_positions(cfg: ModelConfig, b: int, s: int,
                      device: torch.device) -> torch.Tensor:
    positions = torch.arange(s, device=device).expand(b, s)
    if cfg.rope == "mrope":
        positions = positions.expand(3, b, s)
    return positions


def embed_inputs(params: dict, cfg: ModelConfig, tokens=None, embeds=None
                 ) -> torch.Tensor:
    if embeds is not None:
        return embeds.to(cfg.activ_dtype)
    return params["embed"][tokens.long()].to(cfg.activ_dtype)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` by ``cfg.remat`` when grad
    mode is on (the reference's ``jax.checkpoint`` per block): its
    activations are dropped after the forward and recomputed in the
    backward, so every attention runs its forward twice a training step.
    ``"dots"`` runs as ``"full"``: the reference's policy saves the matmul
    outputs, which changes memory and time but not one number.  With grad
    mode off (prefill, serving) ``fn`` runs as it is."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat {cfg.remat!r}")
    return fn if cfg.remat == "none" else _checkpointed(fn)


def _checkpointed(fn):
    """``fn`` under ``torch.utils.checkpoint`` when grad mode is on, else
    ``fn`` itself.  Nothing it runs draws random numbers, so the RNG state
    is not saved (saving it would read the generator's state)."""
    if not torch.is_grad_enabled():
        return fn

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def forward(params: dict, cfg: ModelConfig, tokens=None, embeds=None,
            positions=None, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced forward pass -> (hidden (B, S, D), aux).  Every
    attention (each layer of the dense and MoE families, each invocation of
    zamba2's shared block) goes through
    :func:`repro_torch.models.attention.flash_train`, which launches the
    ``flash_attention`` kernel on a CUDA tensor; rwkv6 runs none.  Under
    grad mode each block is rematerialized by ``cfg.remat`` (zamba2: each
    Mamba2 layer and each group with its shared block, as the reference).
    For the MoE family ``aux["expert_counts"]`` is the (L, E) int32 router
    telemetry and ``aux["moe_aux_loss"]`` the layers' mean balance loss;
    for the other families ``aux`` is empty.  Each block's input and
    output pass :func:`constrain_batch`.

    ``mesh`` (the sharded train step's): the inputs are this rank's slice
    of a batch split over ``cfg.act_batch_axes`` of ``mesh``, and each MoE
    layer routes as the whole batch would (``moe_block``'s ``batch_axes``),
    its counts the whole batch's and its balance loss this slice's share;
    with ``cfg.moe_groups`` and ``cfg.moe_expert_sharded`` it takes the
    expert-parallel path (``params``' expert leaves this rank's block of
    experts over "model")."""
    x = constrain_batch(embed_inputs(params, cfg, tokens, embeds), cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    aux: Dict[str, Any] = {}
    if cfg.family in ("attn", "moe"):
        def layer(x, i):
            x, moe_aux = transformer_block(constrain_batch(x, cfg),
                                           layer_params(params, i), cfg,
                                           positions, mesh=mesh)
            return constrain_batch(x, cfg), moe_aux
        layer_aux = []
        for i in range(cfg.n_layers):
            x, moe_aux = _remat(lambda x, i=i: layer(x, i), cfg)(x)
            layer_aux.append(moe_aux)
        if cfg.family == "moe":
            aux["expert_counts"] = torch.stack(
                [a["counts"] for a in layer_aux])
            aux["moe_aux_loss"] = torch.stack(
                [a["aux_loss"] for a in layer_aux]).mean()
    elif cfg.family == "rwkv6":
        def layer(x, i):
            x, _ = rwkv6_block(constrain_batch(x, cfg),
                               layer_params(params, i), cfg)
            return constrain_batch(x, cfg)
        for i in range(cfg.n_layers):
            x = _remat(lambda x, i=i: layer(x, i), cfg)(x)
    elif cfg.family == "zamba2":
        # groups of zamba_attn_every Mamba2 layers, each followed by the
        # shared block at its invocation index
        every = cfg.zamba_attn_every

        def layer(x, i):
            x, _ = zamba2_mamba_block(constrain_batch(x, cfg),
                                      layer_params(params, i), cfg)
            return constrain_batch(x, cfg)

        def group(x, inv):
            for i in range(inv * every, (inv + 1) * every):
                x = _remat(lambda x, i=i: layer(x, i), cfg)(x)
            return zamba2_shared_attention(x, params["shared_attn"], cfg,
                                           inv, positions)
        for inv in range(cfg.n_shared_attn):
            x = _remat(lambda x, inv=inv: group(x, inv), cfg)(x)
    else:
        raise ValueError(cfg.family)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def logits_fn(params: dict, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", hidden, head.to(hidden.dtype))


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Sum of the masked token NLLs of one chunk: logits in the
    activation dtype, then f32 (the reference's rounding)."""
    logits = torch.einsum("bsd,dv->bsv", h, head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def loss_fn(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
            labels: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Chunked-vocab softmax cross entropy over ``cfg.loss_chunk``
    positions at a time (one chunk when it does not divide S): the masked
    token NLL sum of :func:`loss_terms` over its token count."""
    tot, cnt = loss_terms(params, cfg, hidden, labels, mask)
    return tot / torch.clamp(cnt, min=1.0)


def loss_terms(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
               labels: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked token NLLs, the mask's count), both float32
    scalars; a sharded step sums each over the batch's ranks before it
    divides.  Under grad mode each chunk is checkpointed, so only one
    chunk's (B, chunk, V) logits are alive at a time in the backward
    too."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    head = head.to(hidden.dtype)
    b, s, d = hidden.shape
    chunk = min(cfg.loss_chunk or s, s)
    n_chunks = s // chunk if s % chunk == 0 else 1
    if s % chunk != 0:
        chunk = s
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll = _checkpointed(_chunk_nll)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + nll(hidden[:, sl], head, labels[:, sl], mask[:, sl])
        cnt = cnt + mask[:, sl].sum()
    return tot, cnt
