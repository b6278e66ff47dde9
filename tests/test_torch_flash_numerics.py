"""The numerics that flash_attention's tensor-core route rests on, on the CPU
(no GPU, no JAX), and the route rule itself.

The route (every head dim in bfloat16) multiplies P·V on the tensor cores,
whose A operand is bfloat16.
Its card check (``chip_smoke.py``'s ``FLASH_TOL`` for bfloat16, mirrored in
``tests/test_torch_cuda.py``) holds every output within one bfloat16 step
(2**-7 of the value) plus 1e-3 of the largest output, with at most 1 % of
the outputs differing from the plain version at all — the plain version, as
the JAX kernel, computes P·V in float32.  Here the kernel's blocked online
softmax (128-key tiles, 64 at d=256; float32 max, sum and accumulator, p
taken against
the running max, S = Q·Kᵀ summed over 16-column k-steps, P·V in 16-column
slices of the output) is emulated in float32 PyTorch with P rounded three
ways before the product: kept in float32; rounded once to bfloat16 (FA2 /
FA3's choice); and split as P_hi = bf16(p) plus P_lo = bf16(p - P_hi), two
products into one float32 accumulator (the kernel's choice).  Inputs are
the card check's: numpy normals, q scaled by 3, k and v by 1, rounded once
to bfloat16, causal, at qwen2-0.5b's 14 query heads over 2 KV heads (d=64,
and at the smoke configs' d=16 and 32), internlm2-1.8b's 16 over 8
(d=128), zamba2-2.7b's 32 over 32 (d=80), kimi-k2's 64 over 8 (d=112) and
8 over 1 at d=256.  The split must pass with at most 0.5 % of the outputs
differing; the single bfloat16 P must fail the 1 % rule, which is why the
kernel pays for a third product.

At d=16, 32, 80 and 112 the kernel holds q, k and v in shared-memory
panels of 64 columns that TMA fills with zeros past d: the emulation on
inputs padded with zero columns to whole panels gives the unpadded result
bit for bit in the first d columns and exact zeros beyond.

The route rule: every (dtype, d) in ``HEAD_DIMS`` has a tensor-core route,
bfloat16 on wgmma (``"tensor_core"``) and float32 on the TF32 tensor cores
(``"tf32x3"``); none is the CUDA-core kernel's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402

# chip_smoke.py's FLASH_TOL["bfloat16"] and FLASH_QKV_SCALE
RTOL, ATOL_OF_MAX, DIFFERING_SHARE = 2 ** -7, 1e-3, 0.01
QKV_SCALE = (3.0, 1.0, 1.0)
SHAPES = {"qwen2-0.5b": (14, 2, 1024, 64), "internlm2-1.8b": (16, 8, 512, 128),
          "zamba2-2.7b": (32, 32, 512, 80), "kimi-k2": (64, 8, 512, 112),
          "qwen2-0.5b d=16": (14, 2, 512, 16),
          "qwen2-0.5b d=32": (14, 2, 512, 32), "mqa d=256": (8, 1, 512, 256)}
PANEL = 64             # the kernel's shared-memory panel, in columns


def _block_k(d):
    """The tensor-core kernel's KV tile."""
    return 128 if d <= 128 else 64
STEP = 16              # a wgmma k-step, and the width of an output slice


def _qkv(seed, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=shape) * scale)
                             .astype(np.float32)).to(torch.bfloat16)
            for shape, scale in zip(((h, s, d), (kvh, s, d), (kvh, s, d)),
                                    QKV_SCALE)]


def _split(p: torch.Tensor, rounding: str):
    """The float32 operands whose products with V the kernel sums."""
    if rounding == "float32":
        return [p]
    hi = p.to(torch.bfloat16).float()
    if rounding == "bf16":
        return [hi]
    return [hi, (p - hi).to(torch.bfloat16).float()]


def _steps(x):
    """x's last dim in contiguous slices of STEP columns."""
    return [x[..., c:c + STEP].contiguous() for c in range(0, x.shape[-1], STEP)]


def _emulated(q, k, v, q_per_kv, rounding, scale=None):
    """Causal blocked online softmax in float32, P rounded as ``rounding``
    before P·V, output rounded once to bfloat16.  Every product is one
    16-column slice (S over k-steps, P·V slice by slice of the output), so
    a slice of zero columns adds exact zeros and changes no other slice."""
    h, s, d = q.shape
    qf = q.float() * (d ** -0.5 if scale is None else scale)
    kf = torch.repeat_interleave(k, q_per_kv, 0).float()
    vf = torch.repeat_interleave(v, q_per_kv, 0).float()
    m = torch.full((h, s, 1), -torch.inf)
    l = torch.zeros((h, s, 1))
    acc = torch.zeros((h, s, d))
    qpos = torch.arange(s)[:, None]
    q_steps = _steps(qf)
    bk = _block_k(d)
    for k0 in range(0, s, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        sc = sum(qs @ ks.transpose(1, 2)
                 for qs, ks in zip(q_steps, _steps(kt)))
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        sc = torch.where(kpos <= qpos, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for part in _split(p, rounding):
            acc = acc + torch.cat([part @ vs for vs in _steps(vt)], -1)
        m = m_new
    return (acc / l).to(torch.bfloat16)


def _verdict(got, ref):
    """(largest |got - ref| over FLASH_TOL's bound, share of outputs that
    differ at all)."""
    diff = (got.float() - ref.float()).abs()
    ref_abs = ref.float().abs()
    allowed = ATOL_OF_MAX * float(ref_abs.max()) + RTOL * ref_abs
    return float((diff / allowed).max()), float((diff > 0).float().mean())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("rounding,passes,most_differing", [
    ("float32", True, DIFFERING_SHARE),
    ("bf16_hi_lo", True, 0.005),
    ("bf16", False, None),
])
def test_p_rounding_against_the_bf16_check(shape, rounding, passes,
                                           most_differing):
    h, kvh, s, d = SHAPES[shape]
    q, k, v = _qkv(s + d, h, kvh, s, d)
    ref = attention_ref(q, k, v, q_per_kv=h // kvh, causal=True)
    got = _emulated(q, k, v, h // kvh, rounding)
    largest, differing = _verdict(got, ref)
    if passes:
        assert largest <= 1.0 and differing <= most_differing, \
            (largest, differing)
    else:
        assert differing > DIFFERING_SHARE, (largest, differing)


@pytest.mark.parametrize("shape", ["zamba2-2.7b", "kimi-k2",
                                   "qwen2-0.5b d=16", "qwen2-0.5b d=32"])
def test_zero_padded_columns_change_nothing(shape):
    """q, k and v padded with zero columns to whole 64-column panels (the
    kernel's shared-memory panels: two at d=80 and 112, one at 16 and 32),
    at the unpadded scale d**-0.5: the first d output columns equal the
    unpadded emulation's bit for bit, the rest are exact zeros."""
    h, kvh, s, d = SHAPES[shape]
    dp = -(-d // PANEL) * PANEL
    q, k, v = _qkv(s + d, h, kvh, s, d)
    padded = [torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v)]
    want = _emulated(q, k, v, h // kvh, "bf16_hi_lo")
    got = _emulated(*padded, h // kvh, "bf16_hi_lo", scale=d ** -0.5)
    assert got.shape == (h, s, dp)
    assert torch.equal(got[..., :d], want)
    assert not got[..., d:].any()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 80, "tensor_core"),
    (torch.bfloat16, 112, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"),
    (torch.float32, 80, "tf32x3"),
    (torch.float32, 112, "tf32x3"),
    (torch.float32, 16, "tf32x3"),
    (torch.float32, 32, "tf32x3"),
    (torch.float32, 256, "tf32x3"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert fa_kernel.route(dtype, d) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fa_kernel.HEAD_DIMS)
def test_route_never_names_the_cuda_core_kernel(dtype, d):
    assert fa_kernel.route(dtype, d) in ("tensor_core", "tf32x3")


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.bfloat16, 48),
                                     (torch.float32, 512)])
def test_route_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        fa_kernel.route(dtype, d)
