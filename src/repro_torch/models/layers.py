"""Shared building blocks: norms, RoPE/M-RoPE, SwiGLU, attention block
(PyTorch port of ``repro/models/layers.py``; same layouts: activations
``(B, S, D)``, heads ``(B, H, S, hd)``).

Tensor parallelism (``tp``, a :class:`TensorParallel`; the sharded train
step and sharded serving set it): :func:`swiglu` and
:func:`attention_block` then run on this rank's block of their weights
over the mesh axis "model", the rules' layout
(``launch.sharding.default_rules``).  The block's input enters through
``launch.sharding.to_model`` (the backward sums the ranks' partial input
gradients) and its partial outputs join through ``from_model`` (one
all-reduce), two all-reduces a block and step, and one more for each
forward again under remat.  The attention:

* ``heads == "whole"`` (H divisible by the ranks): the rank projects and
  attends its H / m query heads.  Its KV heads are its own block when the
  rules split them (``kv == "local"``); when they stay replicated
  (``kv == "sliced"``: internlm2's 16 / 8 at 16 ranks) the rank slices the
  KV heads its query heads read from the whole ``wk`` / ``wv``, whose
  gradient is then a partial sum on each rank (the step sums it over
  "model").
* ``heads == "cut"``: the rules split the fused H·hd dim through a head
  (qwen2-0.5b's 14 heads at 16 ranks).  q is projected on the rank's
  columns and all-gathered over "model" (the backward keeps the rank's
  slice), k and v are projected whole from the input before
  ``to_model``, and every rank attends all the heads; the rank's columns
  of the output go into its rows of ``wo``.  GSPMD must do the same with
  that layout: RoPE and the softmax read a whole head.

With ``return_kv`` (the serving prefill) the block returns the cache rows
the rank holds under the serving cache's layout
(``launch.sharding.cache_pspecs``): its own k / v where the KV heads are
its block (``kv == "local"``), else every KV head at the sequence rows
``kv_rows`` names (the cache's sequence cut over "model", or over the
batch axes for a batch of one), projected from the whole ``wk`` / ``wv``
at those rows alone under "sliced" and cut from the whole k / v under
"cut" or without ``tp``.  The attention itself is unchanged.

RWKV-6's and Mamba2's blocks (``tp.mix``, ``tp.ffn``; the mixes are
``models.rwkv6`` / ``models.mamba2``'s) run on the rank's heads,
:func:`head_share`'s: the input enters through ``to_model`` and the
rank's partial output leaves through ``from_model``.  A weight whose
rules' block over "model" is the rank's heads' slice is used as that
block (``mix == "local"``), any other weight the mix reads is whole on
the rank and sliced to its heads (its gradient a partial sum).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import attention as attn_lib


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


# ----------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: a tensor made from theta would be a host->device
    # copy, which stalls the host on every layer
    return 1.0 / torch.pow(theta, exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, d); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, d/2)
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10000.0
                ) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the rotary dims are split into (t, h, w) sections,
    each rotated by its own position stream.  x: (B, H, S, d);
    positions_3d: (3, B, S)."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(d, theta, x.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        f = freqs[start:start + sec]
        parts.append(positions_3d[i][..., None].to(torch.float32) * f)
        start += sec
    angles = torch.cat(parts, dim=-1)[:, None]               # (B,1,S,half)
    return _rotate(x, angles)


# ------------------------------------------------------- tensor parallelism
class TensorParallel(NamedTuple):
    """Tensor parallelism over the mesh axis "model" (``size`` ranks, this
    one ``rank``): ``heads`` "whole" / "cut" / None and ``kv`` "local" /
    "sliced" / None as the module doc says, ``mlp`` (the dense MLP on its
    block of columns), ``vocab`` (the embedding and the loss on its block
    of the vocabulary), ``experts`` (the MoE expert FFN on its block of
    every expert's ``d_expert``: ``models.moe``), ``mix`` (RWKV-6's time
    mix or Mamba2's mix on the rank's heads: "local" where the rules'
    block of its head-split weights is the rank's heads' slice, "sliced"
    where they are whole and sliced, None: the mix runs whole) and
    ``ffn`` (RWKV-6's channel mix on the rank's block of ``d_ff`` and of
    the receptance's columns)."""
    mesh: Any
    size: int
    rank: int
    heads: Optional[str]
    kv: Optional[str]
    mlp: bool
    vocab: bool
    experts: bool
    mix: Optional[str]
    ffn: bool


def head_share(n_heads: int, size: int, rank: int) -> Tuple[int, int]:
    """``(first, count)``: rank ``rank`` of ``size``'s heads of
    ``n_heads``, in order, the first ``n_heads % size`` ranks taking one
    more (so rank 0 is never the smallest; a rank may take none)."""
    per, extra = divmod(n_heads, size)
    return rank * per + min(rank, extra), per + int(rank < extra)


def kv_heads_read(n_heads: int, n_kv_heads: int, size: int, rank: int):
    """The KV heads that rank ``rank`` of ``size``'s query heads read, in
    order: the range they fall in when each of them serves the same number
    of the rank's heads, else one KV head a query head (repeated)."""
    per = n_heads // size
    group = n_heads // n_kv_heads
    kv = [h // group for h in range(rank * per, (rank + 1) * per)]
    first, n = kv[0], kv[-1] - kv[0] + 1
    if per % n == 0 and kv == [first + i // (per // n) for i in range(per)]:
        return list(range(first, first + n))
    return kv


def pick(t: Optional[torch.Tensor], sel):
    """Columns ``sel`` of the last dim of ``t``: ``(first, count)``, an
    index tensor, or None (all of them)."""
    if t is None or sel is None:
        return t
    if isinstance(sel, tuple):
        return t.narrow(-1, *sel)
    return t.index_select(-1, sel)


def _head_cols(heads, head_dim: int, device):
    """The columns of a fused (..., n·hd) projection that hold ``heads``:
    ``(first, count)`` for a run of heads, else an index tensor."""
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return (heads[0] * head_dim, len(heads) * head_dim)
    idx = torch.tensor(heads, device=device)[:, None] * head_dim
    return (idx + torch.arange(head_dim, device=device)).reshape(-1)


# --------------------------------------------------------------------- SwiGLU
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, tp: Optional[TensorParallel] = None
           ) -> torch.Tensor:
    """``tp``: the weights are this rank's block of the mlp dim (columns
    of ``w_gate`` / ``w_up``, rows of ``w_down``); the ranks' outputs
    summed."""
    if tp is not None:
        from ..launch.sharding import from_model, to_model
        x = to_model(x, tp.mesh)
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    out = (F.silu(g) * u) @ w_down.to(x.dtype)
    return out if tp is None else from_model(out, tp.mesh)


# ------------------------------------------------------------ attention block
class AttnParams(NamedTuple):
    wq: torch.Tensor            # (D, H*hd)
    wk: torch.Tensor            # (D, KVH*hd)
    wv: torch.Tensor            # (D, KVH*hd)
    wo: torch.Tensor            # (H*hd, D)
    bq: Optional[torch.Tensor]  # (H*hd,) or None (qwen2 QKV bias)
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]


def attn_proj(p: AttnParams, h: torch.Tensor, name: str, sel=None,
              local: bool = False) -> torch.Tensor:
    """Projection ``name`` ("q", "k", "v") of ``h`` with its bias, on
    columns ``sel`` of the whole projection (``pick``; None: all of them),
    ``p``'s weight and bias already this rank's block of them where
    ``local``."""
    dt = h.dtype
    w, bias = getattr(p, "w" + name), getattr(p, "b" + name)
    y = h @ (w if local else pick(w, sel)).to(dt)
    if bias is not None:
        y = y + (bias if local else pick(bias, sel)).to(dt)
    return y


def mrope_sections(head_dim: int):
    half = head_dim // 2
    return (half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8)


def attention_block(
    x: torch.Tensor,             # (B, S, D)
    p: AttnParams,
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,     # (B, S) or (3, B, S) for mrope
    rope_mode: str = "rope",     # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0,
    window: int | None = None,
    causal_schedule: str = "masked",
    block_k: int = 512,
    return_kv: bool = False,
    tp: Optional[TensorParallel] = None,
    proj: Optional[Callable] = None,
    kv_rows: Optional[Tuple[int, int]] = None,
):
    """``tp``: on this rank's heads and blocks of ``p`` (see the module
    doc).  ``proj(h, name, sel, local)``, in place of ``p``'s weights and
    biases (zamba2's shared block adds its LoRA delta): projection
    ``name`` ("q", "k", "v") of ``h`` on columns ``sel`` of the whole
    projection (None: all of them), its weight already this rank's block
    of them where ``local``.  ``return_kv`` -> (out, (k, v)), the cache
    rows this rank holds: ``kv_rows`` ``(first, count)`` of the sequence
    (None: all of it), its KV heads as the module doc says."""
    b, s, _ = x.shape
    hd = head_dim

    def heads(t):                                  # (B, heads, rows, hd)
        return t.reshape(b, t.shape[1], t.shape[2] // hd, hd).transpose(1, 2)

    def rope(t, pos):
        if rope_mode == "rope":
            return apply_rope(t, pos[:, None], rope_theta)
        if rope_mode == "mrope":
            return apply_mrope(t, pos, mrope_sections(head_dim), rope_theta)
        return t

    proj = proj or (lambda h, name, sel, local:
                    attn_proj(p, h, name, sel, local))
    if tp is None:
        q, k, v = (heads(proj(x, n, None, False)) for n in ("q", "k", "v"))
    else:
        from ..launch.sharding import gather_seq, to_model
        m, r = tp.size, tp.rank
        qw, kvw = n_heads * hd, n_kv_heads * hd
        xm = to_model(x, tp.mesh)
        q = proj(xm, "q", (r * qw // m, qw // m), True)
        if tp.heads == "whole":
            q = heads(q)
            if tp.kv == "local":
                k, v = (heads(proj(xm, n, (r * kvw // m, kvw // m), True))
                        for n in ("k", "v"))
            else:
                cols = _head_cols(kv_heads_read(n_heads, n_kv_heads, m, r),
                                  hd, x.device)
                k, v = (heads(proj(xm, n, cols, False)) for n in ("k", "v"))
        elif tp.heads == "cut":
            q = heads(gather_seq(q, tp.mesh, "model", -1))
            # whole on every rank, so from the input before to_model: their
            # gradient is already the whole one
            k, v = (heads(proj(x, n, None, False)) for n in ("k", "v"))
        else:
            raise ValueError(f"tensor parallel heads {tp.heads!r}")

    q, k = rope(q, positions), rope(k, positions)

    o = attn_lib.flash_train(q, k, v, causal=True, window=window,
                             causal_schedule=causal_schedule, block_k=block_k)
    o = o.transpose(1, 2).reshape(b, s, -1)
    if tp is not None and tp.heads == "cut":
        from ..launch.sharding import split_seq
        o = split_seq(o, tp.mesh, "model", -1)
    out = o @ p.wo.to(x.dtype)
    if tp is not None:
        from ..launch.sharding import from_model
        out = from_model(out, tp.mesh)
    if not return_kv:
        return out
    first, count = kv_rows or (0, s)
    rows = slice(first, first + count)
    if tp is not None and tp.kv == "sliced":
        # every KV head at the rank's rows alone, from the whole wk / wv
        k, v = (heads(proj(xm[:, rows], n, None, False)) for n in ("k", "v"))
        return out, (rope(k, positions[..., rows]), v)
    if kv_rows is None:
        return out, (k, v)
    return out, (k[:, :, rows], v[:, :, rows])
