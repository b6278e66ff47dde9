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
reference's ``lax.scan``.  The sharded train step hands :func:`forward`
and :func:`loss_terms` each leaf as this rank's block
(``launch.sharding.AtUse``): every block gathers the leaves it reads
inside itself (:func:`gathered`; a stacked leaf sliced to its layer
first), the embedding, the loss's head and the final norm where they are
read.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.dispatch import resolve_device
from .layers import (AttnParams, TensorParallel, attention_block, pick,
                     rms_norm, swiglu)
from .mamba2 import Mamba2Params, mamba2_mix
from .moe import MoEParams, moe_block
from .rwkv6 import (RWKV6FFNParams, RWKV6Params, rwkv6_channel_mix,
                    rwkv6_mix)

__all__ = ["LeafSpec", "MoECfg", "ModelConfig", "abstract_params",
           "constrain_batch", "forward", "gathered", "init_params",
           "iter_schema", "layer_params", "logits_fn", "loss_fn", "loss_terms",
           "mamba2_params", "moe_params",
           "param_pspecs", "rwkv6_ffn_params", "rwkv6_params", "rwkv6_block",
           "shared_proj", "tensor_parallel", "tp_layout", "tp_roles",
           "transformer_block", "zamba2_mamba_block",
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
    # logical axes ("heads", "kv_heads", "mlp", "vocab") the rules put on
    # the mesh axis "model" (set by the sharded train step at more than one
    # "model" rank; None = no tensor parallelism): see tensor_parallel()
    tp_axes: Optional[Tuple[str, ...]] = None
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


def abstract_params(cfg: ModelConfig) -> dict:
    """Every parameter as a ``meta`` tensor of its shape and dtype (the
    reference's ``jax.ShapeDtypeStruct`` tree): nothing is allocated."""
    tree: dict = {}
    for path, spec in iter_schema(cfg):
        _set(tree, path, torch.empty(spec.shape,
                                     dtype=spec.dtype or cfg.param_dtype,
                                     device="meta"))
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


# ======================================================= tensor parallelism
def tp_layout(cfg: ModelConfig, size: int):
    """(heads, kv, mlp, vocab, experts, mix, ffn) of
    :class:`layers.TensorParallel` for ``cfg.tp_axes`` at ``size``
    "model" ranks: which modules run on their rank's block of the leaves
    the rules split over "model".  The dense and MoE attention and
    zamba2's shared block split their heads; the dense MLP and zamba2's
    shared MLP their columns; the MoE expert FFN every expert's
    ``d_expert`` where the rules put ``expert_mlp`` on "model" (the
    reference's expert tensor parallelism: Mixtral's 8 experts at 16
    ranks) and it splits evenly, else the layer's experts are gathered at
    use; the embedding and the loss their vocabulary when it splits
    evenly.  RWKV-6's time mix (where the rules put "heads" on "model")
    and Mamba2's mix (``mlp``) run the rank's heads
    (``layers.head_share``; ``d_model // 64`` heads of RWKV-6's,
    ``mamba_heads`` of Mamba2's): ``mix`` "local" where the heads divide
    "model" (the rules' block of ``wr`` / ``wk`` / ``wv`` / ``wg``'s
    columns, of ``out_proj``'s rows, is then the rank's heads'), else
    "sliced"; RWKV-6's channel mix (``ffn``) its blocks of ``d_ff`` and of
    the receptance's columns where both split evenly."""
    axes = cfg.tp_axes or ()
    heads = kv = None
    if "heads" in axes and cfg.family in ("attn", "moe", "zamba2"):
        if cfg.n_heads % size == 0:
            heads = "whole"
        elif cfg.n_heads * cfg.head_dim % size == 0:
            heads = "cut"
    if heads == "whole":
        kv = ("local" if "kv_heads" in axes and cfg.n_kv_heads % size == 0
              else "sliced")
    elif "kv_heads" in axes and cfg.family in ("attn", "moe", "zamba2"):
        raise ValueError(f"{cfg.name}: KV heads split over {size} \"model\" "
                         f"ranks while the query heads are not split whole")
    mlp = "mlp" in axes and cfg.family in ("attn", "zamba2")
    vocab = "vocab" in axes and cfg.vocab_size % size == 0
    experts = ("expert_mlp" in axes and cfg.family == "moe"
               and cfg.moe.d_expert % size == 0)
    mix = None
    if cfg.family == "rwkv6" and "heads" in axes:
        mix = "local" if (cfg.d_model // 64) % size == 0 else "sliced"
    elif cfg.family == "zamba2" and "mlp" in axes:
        mix = "local" if cfg.mamba_heads % size == 0 else "sliced"
    ffn = (cfg.family == "rwkv6" and "heads" in axes and "mlp" in axes
           and cfg.d_ff % size == 0 and cfg.d_model % size == 0)
    return heads, kv, mlp, vocab, experts, mix, ffn


# the recurrent leaves a rank uses whole, sliced to its heads (or, on the
# input side, all of them): their gradients are partial sums on each rank
_RWKV6_PARTIAL = ("wo", "u", "w0", "ln_x", "w_lora_a", "w_lora_b", "tm_mu",
                  "tm_lora_a", "tm_lora_b")
_MAMBA2_PARTIAL = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip",
                   "dt_bias", "norm")


def tp_roles(cfg: ModelConfig, size: int) -> Dict[str, str]:
    """``{path: role}`` of the leaves :func:`tp_layout` changes: "local"
    for a leaf the step hands over as this rank's block over "model" (its
    gradient is that block's), "partial" for a whole leaf whose gradient
    is a partial sum on each rank (the step sums it over "model")."""
    heads, kv, mlp, vocab, experts, mix, ffn = tp_layout(cfg, size)
    out: Dict[str, str] = {}
    paths = {path for path, _ in iter_schema(cfg)}

    def put(path: str, role: str) -> None:
        if path in paths:
            out[path] = role
    if vocab:
        put("embed", "local")
        put("lm_head", "local")
    prefix = "shared_attn." if cfg.family == "zamba2" else "blocks."
    if heads is not None:
        for w in ("wq", "bq", "wo"):
            put(prefix + w, "local")
        kv_role = {"local": "local", "sliced": "partial"}.get(kv)
        if kv_role:
            for w in ("wk", "wv", "bk", "bv"):
                put(prefix + w, kv_role)
        # zamba2's LoRA on q / k / v: both factors whole, each rank using
        # its columns of the product; partial where the projection splits
        for nm in (("q", "k", "v") if kv_role else ("q",)):
            put(f"shared_attn.lora_{nm}_a", "partial")
            put(f"shared_attn.lora_{nm}_b", "partial")
    if mlp:
        for w in ("w_gate", "w_up", "w_down"):
            put(prefix + w, "local")
    if experts:
        for w in ("e_gate", "e_up", "e_down"):
            put("blocks." + w, "local")
    own = "local" if mix == "local" else "partial"
    if mix and cfg.family == "rwkv6":
        for w in ("wr", "wk", "wv", "wg"):
            put("blocks." + w, own)
        for w in _RWKV6_PARTIAL:
            put("blocks." + w, "partial")
    if ffn:
        for w in ("f_wk", "f_wv", "f_wr"):
            put("blocks." + w, "local")
        for w in ("f_mu_k", "f_mu_r"):
            put("blocks." + w, "partial")
    if mix and cfg.family == "zamba2":
        put("blocks.out_proj", own)
        for w in _MAMBA2_PARTIAL:
            put("blocks." + w, "partial")
    return out


def tensor_parallel(cfg: ModelConfig, mesh) -> Optional[TensorParallel]:
    """The blocks' :class:`layers.TensorParallel` on ``mesh``, or None
    without ``cfg.tp_axes``, without a mesh or at one "model" rank."""
    if not cfg.tp_axes or mesh is None \
            or "model" not in mesh.mesh_dim_names:
        return None
    size = mesh.size(list(mesh.mesh_dim_names).index("model"))
    if size == 1:
        return None
    return TensorParallel(mesh, size, mesh.get_local_rank("model"),
                          *tp_layout(cfg, size))


# ================================================================ block passes
def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["blocks"]`` leaves."""
    return {k: v[i] for k, v in params["blocks"].items()}


def gathered(tree):
    """A tree of leaves as a block reads them: a leaf the sharded train
    step hands over as this rank's block (``launch.sharding.AtUse``)
    gathered now, a tensor as it is."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return tree if isinstance(tree, torch.Tensor) else tree.gather()


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
                      mesh=None, kv_rows=None):
    """One dense or MoE transformer layer -> (x, aux), aux the MoE layer's
    ``{"counts", "aux_loss"}`` or None; with ``return_kv``
    (x, aux, (k, v)), the prefill's cache rows (those this rank holds:
    ``layers.attention_block``'s ``kv_rows``).  ``mesh``: ``x`` is a
    rank's slice of a batch split over ``cfg.act_batch_axes`` of it (see
    :func:`forward`), and with ``cfg.tp_axes`` the attention, the dense
    MLP and the MoE expert FFN run on this rank's blocks
    (:func:`tensor_parallel`)."""
    tp = tensor_parallel(cfg, mesh)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    h = attention_block(
        h, _attn_params(bp),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        positions=positions, rope_mode=cfg.rope, rope_theta=cfg.rope_theta,
        window=cfg.window, causal_schedule=cfg.causal_schedule,
        block_k=cfg.attn_block_k, return_kv=return_kv,
        tp=tp if tp is not None and tp.heads else None, kv_rows=kv_rows,
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
                           expert_sharded=cfg.moe_expert_sharded,
                           tp=tp if tp is not None and tp.experts else None)
    else:
        h = swiglu(h, bp["w_gate"], bp["w_up"], bp["w_down"],
                   tp=tp if tp is not None and tp.mlp else None)
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
                return_shift: bool = False, mesh=None):
    """One RWKV-6 layer -> (x, final wkv state).  Heads of 64 channels
    (``d_model // 64``, as the reference; not ``cfg.n_heads``).  With
    ``return_shift`` -> (x, state, (sh_mix, sh_ffn)): the last position's
    normed inputs of the time mix and of the channel mix, the token shift
    a decode step continues from.  ``mesh`` with ``cfg.tp_axes``: the time
    mix on the rank's heads (``state`` and the final state the rank's
    heads') and the channel mix on its blocks (:func:`tensor_parallel`,
    ``models.rwkv6``)."""
    tp = tensor_parallel(cfg, mesh)
    xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
    h, state = rwkv6_mix(xn, rwkv6_params(bp), state,
                         n_heads=cfg.d_model // 64, tp=tp)
    x = x + h
    xn2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + rwkv6_channel_mix(xn2, rwkv6_ffn_params(bp), tp)
    if return_shift:
        return x, state, (xn[:, -1], xn2[:, -1])
    return x, state


def zamba2_mamba_block(x: torch.Tensor, bp: dict, cfg: ModelConfig,
                       state=None, mesh=None):
    """One Zamba2 Mamba2 layer (no MLP) -> (x, final SSM state); ``mesh``
    with ``cfg.tp_axes``: on the rank's heads (``state`` and the final
    state the rank's heads'; :func:`tensor_parallel`,
    ``models.mamba2``)."""
    h, state = mamba2_mix(rms_norm(x, bp["ln1"], cfg.norm_eps),
                          mamba2_params(bp), state, d_inner=cfg.d_inner,
                          n_heads=cfg.mamba_heads, d_state=cfg.ssm_state,
                          tp=tensor_parallel(cfg, mesh))
    return x + h, state


def shared_proj(h: torch.Tensor, sp: dict, cfg: ModelConfig, inv: int,
                nm: str, sel=None, local: bool = False) -> torch.Tensor:
    """Projection ``nm`` ("q", "k", "v") of the shared block's normed
    input ``h`` (..., D) with invocation ``inv``'s LoRA delta (h a) b
    added, on columns ``sel`` (``layers.pick``; None: all), ``sp``'s
    weight already this rank's block of them where ``local`` (the LoRA
    factors are always whole)."""
    dt = h.dtype
    width = (cfg.n_heads if nm == "q" else cfg.n_kv_heads) * cfg.head_dim
    w = sp["w" + nm]
    delta = (h @ sp[f"lora_{nm}_a"][inv].to(dt)) \
        @ sp[f"lora_{nm}_b"][inv].to(dt)
    return h @ (w if local else pick(w, sel)).to(dt) \
        + pick(delta[..., :width], sel)


def zamba2_shared_attention(x: torch.Tensor, sp: dict, cfg: ModelConfig,
                            inv: int, positions: torch.Tensor,
                            return_kv: bool = False, mesh=None,
                            kv_rows=None):
    """The shared attention block at invocation ``inv``: per-invocation
    LoRA on q/k/v, RoPE, causal attention through
    :func:`repro_torch.models.attention.flash_train` (the
    ``flash_attention`` kernel on a CUDA tensor), the output projection,
    then the shared SwiGLU.  With ``return_kv`` -> (x, (k, v)), the
    prefill's cache rows (after RoPE; those this rank holds, as
    :func:`transformer_block`'s).  ``mesh`` with ``cfg.tp_axes``:
    the attention and the MLP on this rank's blocks (:func:`tensor_parallel`;
    the LoRA factors whole, each rank using its columns of the delta)."""
    tp = tensor_parallel(cfg, mesh)
    h = rms_norm(x, sp["ln"], cfg.norm_eps)
    o = attention_block(
        h, AttnParams(sp["wq"], sp["wk"], sp["wv"], sp["wo"], None, None,
                      None),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions, rope_mode="rope",
        rope_theta=cfg.rope_theta, window=cfg.window,
        causal_schedule=cfg.causal_schedule, block_k=cfg.attn_block_k,
        return_kv=return_kv, tp=tp if tp is not None and tp.heads else None,
        proj=lambda t, nm, sel, local: shared_proj(t, sp, cfg, inv, nm, sel,
                                                   local), kv_rows=kv_rows)
    if return_kv:
        o, kv = o
    x = x + o
    hm = rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
    x = x + swiglu(hm, sp["w_gate"], sp["w_up"], sp["w_down"],
                   tp=tp if tp is not None and tp.mlp else None)
    if return_kv:
        return x, kv
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


def embed_inputs(params: dict, cfg: ModelConfig, tokens=None, embeds=None,
                 mesh=None) -> torch.Tensor:
    """The input activations; with a tensor-parallel vocabulary
    (:func:`tensor_parallel`) ``params["embed"]`` is this rank's block of
    rows: a token outside it gives 0, and the ranks' rows are summed."""
    if embeds is not None:
        return embeds.to(cfg.activ_dtype)
    tp = tensor_parallel(cfg, mesh)
    table = gathered(params["embed"])
    if tp is None or not tp.vocab:
        return table[tokens.long()].to(cfg.activ_dtype)
    from ..launch.sharding import from_model
    idx = tokens.long() - tp.rank * table.shape[0]
    here = (idx >= 0) & (idx < table.shape[0])
    rows = table[torch.where(here, idx, 0)]
    rows = torch.where(here[..., None], rows, 0).to(cfg.activ_dtype)
    return from_model(rows, tp.mesh)


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
    experts over "model"); with ``cfg.tp_axes`` the leaves of
    :func:`tp_roles` are this rank's blocks over "model" and the
    embedding, attention, MLP and RWKV-6's and Mamba2's mixes run
    tensor-parallel (:func:`tensor_parallel`).  A leaf handed over as a
    ``launch.sharding.AtUse`` is gathered inside each block that reads it
    (:func:`gathered`)."""
    x = constrain_batch(embed_inputs(params, cfg, tokens, embeds, mesh), cfg)
    b, s, _ = x.shape
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    aux: Dict[str, Any] = {}
    if cfg.family in ("attn", "moe"):
        def layer(x, i):
            x, moe_aux = transformer_block(constrain_batch(x, cfg),
                                           gathered(layer_params(params, i)),
                                           cfg, positions, mesh=mesh)
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
                               gathered(layer_params(params, i)), cfg,
                               mesh=mesh)
            return constrain_batch(x, cfg)
        for i in range(cfg.n_layers):
            x = _remat(lambda x, i=i: layer(x, i), cfg)(x)
    elif cfg.family == "zamba2":
        # groups of zamba_attn_every Mamba2 layers, each followed by the
        # shared block at its invocation index
        every = cfg.zamba_attn_every

        def layer(x, i):
            x, _ = zamba2_mamba_block(constrain_batch(x, cfg),
                                      gathered(layer_params(params, i)),
                                      cfg, mesh=mesh)
            return constrain_batch(x, cfg)

        def group(x, inv):
            for i in range(inv * every, (inv + 1) * every):
                x = _remat(lambda x, i=i: layer(x, i), cfg)(x)
            return zamba2_shared_attention(x, gathered(params["shared_attn"]),
                                           cfg, inv, positions, mesh=mesh)
        for inv in range(cfg.n_shared_attn):
            x = _remat(lambda x, inv=inv: group(x, inv), cfg)(x)
    else:
        raise ValueError(cfg.family)
    return rms_norm(x, gathered(params["final_norm"]), cfg.norm_eps), aux


def logits_fn(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """hidden (B, S, D) -> logits (B, S, V).  With a tensor-parallel
    vocabulary (:func:`tensor_parallel` of ``mesh``) the head is this
    rank's block of it and its logits are all-gathered over "model": the
    reference's serving ``out_shardings`` give them whole over the
    vocabulary."""
    head = gathered(params["embed" if cfg.tie_embeddings else "lm_head"])
    head = head.T if cfg.tie_embeddings else head
    logits = torch.einsum("bsd,dv->bsv", hidden, head.to(hidden.dtype))
    tp = tensor_parallel(cfg, mesh)
    if tp is None or not tp.vocab:
        return logits
    from ..launch.sharding import gather_seq
    return gather_seq(logits, tp.mesh, "model", -1)


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


def _chunk_nll_tp(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, first: int, mesh) -> torch.Tensor:
    """:func:`_chunk_nll` from this rank's block of the vocabulary
    (``head``'s columns, from ``first``): the row max and the sums of
    exponentials summed over "model", the gold logit from the rank that
    holds it (every rank takes part in every collective)."""
    import torch.distributed as dist
    from ..launch.sharding import all_reduce, from_model
    logits = torch.einsum("bsd,dv->bsv", h, head).to(torch.float32)
    top = logits.detach().amax(-1)
    all_reduce(top, mesh, ("model",), op=dist.ReduceOp.MAX)
    idx = labels.long() - first
    here = (idx >= 0) & (idx < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(here, idx, 0)[..., None])
    gold = torch.where(here, gold[..., 0], 0.0)
    part = torch.stack([torch.exp(logits - top[..., None]).sum(-1), gold], -1)
    total, gold = from_model(part, mesh).unbind(-1)
    return ((top + torch.log(total) - gold) * mask).sum()


def loss_terms(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
               labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked token NLLs, the mask's count), both float32
    scalars; a sharded step sums each over the batch's ranks before it
    divides.  Under grad mode each chunk is checkpointed, so only one
    chunk's (B, chunk, V) logits are alive at a time in the backward
    too.  With a tensor-parallel vocabulary (:func:`tensor_parallel` of
    ``mesh``) the head is this rank's block of it, (B, chunk, V / m)
    logits a chunk, and both terms are the whole vocabulary's on every
    rank."""
    head = gathered(params["embed" if cfg.tie_embeddings else "lm_head"])
    head = (head.T if cfg.tie_embeddings else head).to(hidden.dtype)
    tp = tensor_parallel(cfg, mesh)
    if tp is not None and tp.vocab:
        from ..launch.sharding import to_model
        hidden = to_model(hidden, tp.mesh)
        part = _checkpointed(_chunk_nll_tp)

        def nll(h, head, labels, mask):
            return part(h, head, labels, mask, tp.rank * head.shape[1],
                        tp.mesh)
    else:
        nll = _checkpointed(_chunk_nll)
    b, s, d = hidden.shape
    chunk = min(cfg.loss_chunk or s, s)
    n_chunks = s // chunk if s % chunk == 0 else 1
    if s % chunk != 0:
        chunk = s
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + nll(hidden[:, sl], head, labels[:, sl], mask[:, sl])
        cnt = cnt + mask[:, sl].sum()
    return tot, cnt
