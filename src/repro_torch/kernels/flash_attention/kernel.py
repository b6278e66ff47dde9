"""ctypes wrapper around ``csrc/flash_attention.cu`` (see the notes there and
in ``csrc/flash_attention_wgmma.cuh`` and ``csrc/flash_attention_tf32x3.cuh``
for what they replace, what bounds them and how).

Three kernels, one function.  :func:`route` picks one from the dtype, at
every head dim in ``HEAD_DIMS``: bfloat16 runs
on the tensor cores (``"tensor_core"``: wgmma fed by TMA; d that is not
whole 64-column panels, 16, 32, 80 and 112, in a last panel that TMA fills
with zeros past d; d 256 in four panels over 64-key tiles), float32 on the
TF32 tensor cores with every product split three ways (``"tf32x3"``: wgmma
fed by TMA at d 16 to 128, K and V split once into shared hi / lo planes
and Q into registers; mma.sync fed by cp.async at d 256).  The third
kernel runs on the CUDA cores (``"cuda_core"``) and no route gives it: the
private :func:`_launch` names it, to hold it against a tensor-core route on
the same input and to time it in turns with one (float32 at every d,
bfloat16 at 16, 32, 80, 112 and 256); no path calls it.  A launch that
fails raises; no route stands in for another.

The wrapper checks its inputs, allocates the output, launches on the current
stream and raises if the launch failed (a launch refused for its shared
memory never runs, and a later synchronize would not report it).
``LAUNCHES`` counts the launches of all three routes, ``ROUTE_LAUNCHES`` each
route's.  With ``return_lse`` (``FlashAttentionFn``'s forward, which saves
them for the backward) the tensor-core routes also write each row's
log-sum-exp in log2 units (float32, (B·H, Sq), +inf for a row with no valid
key) and, in bfloat16, the output in float32 before its rounding; without
it they write neither.

On ``meta`` tensors (the dry run, ``launch.dryrun``) :func:`flash_attention_meta`
makes the same checks, launches nothing and returns ``meta`` outputs of the
kernel's shapes; it adds the call to ``META_CALLS`` (keyed by :func:`meta_key`)
and leaves ``LAUNCHES`` alone.  :func:`charge` is a call's own work: the
FLOPs of its products over the (query, key) pairs the mask keeps, and q, k,
v read and the output written once (and the saved lse and float32 output
written, on the saving path).

The backward (``csrc/flash_attention_bwd.cuh``, ``csrc/flash_attention_bwd_wgmma.cuh``):
:func:`flash_attention_bwd_cuda` gives dq, dk and dv from q, k, v, the
forward's float32 output and lse and dO, on the route :func:`route` names
for the forward's dtype (bfloat16 on the tensor cores, wgmma fed by TMA and
mma.sync at d 256, P and dS split hi + lo; float32 on 3xTF32 mma.sync), two
kernels a call (dq, whose prologue computes D = rowsum(dO o), corrected on
the bf16 route by its sweep's residual, into a float32 scratch beside each
row's lse, then dk / dv; under GQA the dk / dv blocks take a query head
each (two on the bf16 wgmma kernels) and sum their parts in head order).
``BWD_LAUNCHES`` counts its calls, ``BWD_ROUTE_LAUNCHES`` each route's; the
forward's counts do not see them.  On ``meta`` tensors
:func:`flash_attention_bwd_meta` makes its checks and records the call in
``BWD_META_CALLS``; :func:`bwd_charge` is its work: five products (Q·Kᵀ
again, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q) over the kept pairs, 10 · d · B·H · pairs
FLOPs (the hi / lo split uncounted, as the forward's charge counts none),
and q, k, v, dO, the float32 output and the lse read and dq, dk, dv written
once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import refuse_grad

__all__ = ["BWD_LAUNCHES", "BWD_META_CALLS", "BWD_ROUTE_LAUNCHES", "HEAD_DIMS",
           "LAUNCHES", "META_CALLS", "ROUTE_LAUNCHES", "TF32X3_WGMMA_HEAD_DIMS",
           "bwd_charge", "charge", "flash_attention_bwd_cuda",
           "flash_attention_bwd_meta", "flash_attention_cuda",
           "flash_attention_meta", "kept_pairs", "meta_key", "route",
           "tf32x3_blocks_per_sm"]

LAUNCHES = 0
# launches by route; "cuda_core" counts only the named comparisons
ROUTE_LAUNCHES = {"tensor_core": 0, "tf32x3": 0, "cuda_core": 0}
# calls on meta tensors: meta_key(...) -> calls (nothing launched)
META_CALLS: dict = {}
# the backward's calls (each launches its route's two kernels), by route,
# and its calls on meta tensors
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"tensor_core": 0, "tf32x3": 0}
BWD_META_CALLS: dict = {}

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels take: the smoke configs' 16, the published configs'
# 64 and 128, zamba2's 80 and kimi-k2's 112, and 32 / 256 beside them; each
# dtype runs at every one on the tensor cores (bfloat16 on wgmma, float32 on
# the TF32 ones)
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
# the head dims at which the "tf32x3" route runs its wgmma body (TMA, K and
# V split once into shared hi / lo planes); at 256 it runs mma.sync
TF32X3_WGMMA_HEAD_DIMS = (16, 32, 64, 80, 112, 128)
# the head dims the CUDA-core kernel takes when it is named through _launch
_CUDA_CORE_HEAD_DIMS = {torch.bfloat16: (16, 32, 80, 112, 256),
                        torch.float32: HEAD_DIMS}
# the routes whose copies (TMA, cp.async) need 16-byte-aligned q, k and v:
# both that route() gives
_ALIGNED_ROUTES = ("tensor_core", "tf32x3")


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that computes (dtype, d): ``"tensor_core"`` (bfloat16) or
    ``"tf32x3"`` (float32)."""
    if dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    return "tensor_core" if dtype == torch.bfloat16 else "tf32x3"


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        common = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_float]
        lib.flash_attention_launch.argtypes = common + [ctypes.c_int, _P]
        lib.flash_attention_launch.restype = ctypes.c_int
        # the tensor-core routes: lse (and in bf16 the float32 output)
        # before the stream
        lib.flash_attention_wgmma_launch.argtypes = common + [_P, _P, _P]
        lib.flash_attention_wgmma_launch.restype = ctypes.c_int
        lib.flash_attention_tf32x3_launch.argtypes = common + [_P, _P]
        lib.flash_attention_tf32x3_launch.restype = ctypes.c_int
        lib.flash_attention_tf32x3_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.flash_attention_tf32x3_blocks_per_sm.restype = ctypes.c_int
        bwd = [_P] * 12 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_longlong, _P]
        for fn in (lib.flash_attention_bwd_launch,
                   lib.flash_attention_bwd_tf32x3_launch):
            fn.argtypes = bwd
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def tf32x3_blocks_per_sm(d: int) -> int:
    """Resident blocks an SM of the ``"tf32x3"`` kernel at head dim ``d``
    (the current CUDA device)."""
    n = _lib().flash_attention_tf32x3_blocks_per_sm(d)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, q_per_kv: int, causal: bool = True,
                         window: int | None = None,
                         sm_scale: float | None = None,
                         return_lse: bool = False):
    """(B·H, Sq, d) q, (B·KVH, Sk, d) k and v, all float32 or all bfloat16,
    contiguous, on one CUDA device -> (B·H, Sq, d) output in q's dtype, on
    :func:`route`'s kernel; with ``return_lse`` (output, lse, the output in
    float32), what the backward takes (:func:`_saved`)."""
    return _launch(None, q, k, v, q_per_kv=q_per_kv, causal=causal,
                   window=window, sm_scale=sm_scale, return_lse=return_lse)


def _saved(out: torch.Tensor):
    """The saving path's extra outputs beside ``out`` (B·H, Sq, d): each
    row's lse (float32, (B·H, Sq)) and the output in float32 (``out``
    itself when it is float32)."""
    lse = torch.empty(out.shape[:2], dtype=torch.float32, device=out.device)
    return lse, out if out.dtype == torch.float32 else torch.empty_like(
        out, dtype=torch.float32)


def _check(way: str | None, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, q_per_kv: int, window: int | None,
           device_type: str) -> str:
    """The wrapper's checks of its inputs -> the route that computes them
    (``way`` when it names one the inputs allow)."""
    refuse_grad("flash_attention", q, k, v)
    dev = q.device
    if dev.type != device_type:
        raise ValueError(f"flash_attention_{device_type} needs "
                         f"{device_type.upper()} tensors, got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D {q.dtype} "
                             f"tensor on {dev}")
    bh, sq, d = q.shape
    bkh, sk, _ = k.shape
    if k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B*KVH, Sk, {d})")
    which = route(q.dtype, d)
    if way is not None and way != which and not (
            way == "cuda_core" and d in _CUDA_CORE_HEAD_DIMS[q.dtype]):
        raise ValueError(f"route {way!r} does not take {q.dtype} at d={d}")
    if q_per_kv < 1 or bh != bkh * q_per_kv:
        raise ValueError(f"{bh} query rows with q_per_kv={q_per_kv} need "
                         f"{bh // max(q_per_kv, 1)} KV rows, got {bkh}")
    if sq >= 2 ** 31 or sk >= 2 ** 31:
        raise ValueError(f"sequence lengths {(sq, sk)} must fit int32")
    if window is not None and window < 0:
        raise ValueError(f"window {window} must be >= 0")
    return way or which


def _launch(way: str | None, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, q_per_kv: int, causal: bool = True,
            window: int | None = None, sm_scale: float | None = None,
            return_lse: bool = False):
    """:func:`flash_attention_cuda` on the kernel ``way`` names, or on
    :func:`route`'s when it is None.  ``"cuda_core"`` takes float32 at every
    head dim and bfloat16 at every one but 64 and 128; ``"tensor_core"`` and
    ``"tf32x3"`` only what :func:`route` gives them (their dtype), and
    ``return_lse`` only on those two."""
    global LAUNCHES
    which = _check(way, q, k, v, q_per_kv, window, "cuda")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if which in _ALIGNED_ROUTES and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"the {which} route's copies need q, k and v to "
                         f"start on 16-byte boundaries")
    if return_lse and which not in _ALIGNED_ROUTES:
        raise ValueError(f"the {which} route writes no lse")
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty_like(q)
    lse, out32 = _saved(out) if return_lse else (None, None)

    def result():
        return (out, lse, out32) if return_lse else out
    if bh == 0 or sq == 0:
        return result()
    if sk == 0:             # no key: every row gives 0, nothing to launch
        out.zero_()
        if return_lse:
            lse.fill_(float("inf"))
            out32.zero_()
        return result()
    args = (bh, sq, sk, d, q_per_kv, int(causal),
            -1 if window is None else min(int(window), 2 ** 31 - 1),
            float(sm_scale))
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "tensor_core":
            rc = _lib().flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args, ptr(lse), ptr(out32), stream)
        elif which == "tf32x3":
            rc = _lib().flash_attention_tf32x3_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args, ptr(lse), stream)
        else:
            rc = _lib().flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args, _DTYPES[q.dtype], stream)
    LAUNCHES += 1
    ROUTE_LAUNCHES[which] += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention ({which}) launch failed: "
                           + (f"CUDA error {rc}" if rc > 0 else
                              f"tensor map refused (code {rc})"))
    return result()


# ------------------------------------------------------ the meta route
def meta_key(q: torch.Tensor, k: torch.Tensor, *, q_per_kv: int,
             causal: bool, window: int | None, saves: bool = False) -> tuple:
    """``META_CALLS``' and ``BWD_META_CALLS``' key of a call: (B·H, Sq, Sk,
    d, q_per_kv, causal, window, dtype, saves); ``saves``: the forward
    writes the lse and the float32 output for the backward (which reads
    them: its key has it True)."""
    bh, sq, d = q.shape
    return (bh, sq, k.shape[1], d, q_per_kv, bool(causal),
            None if window is None else int(window), q.dtype, bool(saves))


@functools.lru_cache(maxsize=None)
def kept_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """The (query i, key j) pairs the mask keeps, ``attention_ref``'s mask:
    j <= i if ``causal``, j >= i - ``window`` if a window is given."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = 0 if window is None else max(0, i - window)
        total += max(0, hi - lo + 1)
    return total


def _saved_bytes(bh: int, sq: int, d: int, dtype: torch.dtype) -> int:
    """The bytes of what the forward saves beyond its output: the lse and,
    in bfloat16, the float32 output."""
    return 4 * bh * sq * (1 + (d if dtype != torch.float32 else 0))


def charge(key: tuple) -> tuple:
    """(FLOPs, bytes) of one call at :func:`meta_key` ``key``: 4 · d · B·H
    · the pairs the mask keeps (Q·Kᵀ and P·V, two FLOPs a multiply-add),
    and q, k, v read once and the output written once (and, when it saves,
    the lse and in bfloat16 the float32 output written once)."""
    bh, sq, sk, d, q_per_kv, causal, window, dtype, saves = key
    flops = 4 * d * bh * kept_pairs(sq, sk, causal, window)
    elems = 2 * bh * sq * d + 2 * (bh // q_per_kv) * sk * d
    return flops, elems * dtype.itemsize + (
        _saved_bytes(bh, sq, d, dtype) if saves else 0)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, q_per_kv: int, causal: bool = True,
                         window: int | None = None,
                         sm_scale: float | None = None,
                         return_lse: bool = False):
    """:func:`flash_attention_cuda`'s checks on ``meta`` tensors, and its
    outputs' shapes and dtypes, with no launch: the call is added to
    ``META_CALLS`` (``LAUNCHES`` counts launches only)."""
    _check(None, q, k, v, q_per_kv, window, "meta")
    key = meta_key(q, k, q_per_kv=q_per_kv, causal=causal, window=window,
                   saves=return_lse)
    META_CALLS[key] = META_CALLS.get(key, 0) + 1
    out = torch.empty_like(q)
    return (out, *_saved(out)) if return_lse else out


# ------------------------------------------------------------ the backward
# the backward's entry point by route
_BWD_ENTRY = {"tensor_core": "flash_attention_bwd_launch",
              "tf32x3": "flash_attention_bwd_tf32x3_launch"}


def _check_bwd(q, k, v, o, do, lse, q_per_kv, window, device_type) -> str:
    """The forward's checks, dO's (q's shape, dtype and device,
    contiguous), the saved output's (float32, q's shape) and the lse's
    (float32, (B·H, Sq)) -> the route."""
    which = _check(None, q, k, v, q_per_kv, window, device_type)
    if do.device != q.device or do.dtype != q.dtype or do.shape != q.shape \
            or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous {q.dtype} tensor of q's "
                         f"shape {tuple(q.shape)} on {q.device}")
    for name, t, shape in (("o", o, q.shape), ("lse", lse, q.shape[:2])):
        if t.device != q.device or t.dtype != torch.float32 \
                or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"of shape {tuple(shape)} on {q.device}")
    return which


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             q_per_kv: int, causal: bool = True,
                             window: int | None = None,
                             sm_scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention_cuda`'s output for its
    gradient ``do`` (q's shape and dtype), from what its forward saved with
    ``return_lse``: ``o``, the output in float32, and ``lse``; in q's, k's
    and v's dtype, on the backward kernels of :func:`route`'s route; dk and
    dv summed over each KV head's ``q_per_kv`` query heads."""
    global BWD_LAUNCHES
    which = _check_bwd(q, k, v, o, do, lse, q_per_kv, window, "cuda")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do, lse)):
        raise ValueError("the backward's copies need q, k, v, o, do and lse "
                         "to start on 16-byte boundaries")
    if sm_scale is None:
        sm_scale = d ** -0.5
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0 or sq == 0 or sk == 0:   # nothing to launch: no pair is kept
        return dq.zero_(), dk.zero_(), dv.zero_()
    # scratch: each query row's lse and D (written by the dq kernel, read by
    # the dk / dv one), rows padded to whole 128-row tiles; with q_per_kv > 1
    # a slot a query head for the parts of dk and dv (keys padded to whole
    # 128-key tiles, columns to whole 64-column panels) and a zeroed ticket a
    # key block (the dk / dv kernel's blocks take a head or two each and the
    # last to finish sums the parts in head order)
    sq_pad = -(-sq // 128) * 128
    stats = torch.empty((2, bh, sq_pad), dtype=torch.float32,
                        device=q.device)
    parts = tickets = stats[:0]
    if q_per_kv > 1:
        parts = torch.empty((bh, 2, -(-sk // 128) * 128, -(-d // 64) * 64),
                            dtype=torch.float32, device=q.device)
        tickets = torch.zeros((bh // q_per_kv, -(-sk // 32)),
                              dtype=torch.int32, device=q.device)
    args = (bh, sq, sk, d, q_per_kv, int(causal),
            -1 if window is None else min(int(window), 2 ** 31 - 1),
            float(sm_scale), sq_pad)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(_lib(), _BWD_ENTRY[which])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), parts.data_ptr(),
            tickets.data_ptr(), *args, stream)
    BWD_LAUNCHES += 1
    BWD_ROUTE_LAUNCHES[which] += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention backward ({which}) launch "
                           f"failed: " + (f"CUDA error {rc}" if rc > 0 else
                                          f"tensor map refused (code {rc})"))
    return dq, dk, dv


def bwd_charge(key: tuple) -> tuple:
    """(FLOPs, bytes) of one backward call at :func:`meta_key` ``key``: 10 ·
    d · B·H · the pairs the mask keeps (five products, two FLOPs a
    multiply-add), and q, k, v, dO, the saved float32 output and lse read
    and dq, dk, dv written once."""
    bh, sq, sk, d, q_per_kv, causal, window, dtype, _ = key
    flops = 10 * d * bh * kept_pairs(sq, sk, causal, window)
    elems = 3 * bh * sq * d + 4 * (bh // q_per_kv) * sk * d
    return flops, elems * dtype.itemsize + 4 * bh * sq * (d + 1)


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             q_per_kv: int, causal: bool = True,
                             window: int | None = None,
                             sm_scale: float | None = None):
    """:func:`flash_attention_bwd_cuda`'s checks on ``meta`` tensors and
    its outputs' shapes and dtypes, with no launch: the call is added to
    ``BWD_META_CALLS`` (``BWD_LAUNCHES`` counts launches only)."""
    _check_bwd(q, k, v, o, do, lse, q_per_kv, window, "meta")
    key = meta_key(q, k, q_per_kv=q_per_kv, causal=causal, window=window,
                   saves=True)
    BWD_META_CALLS[key] = BWD_META_CALLS.get(key, 0) + 1
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
