"""The numerics that flash_attention's float32 route (``"tf32x3"``) rests on,
on the CPU (no GPU, no JAX).

The route (every head dim in float32) multiplies on the TF32 tensor cores,
whose operands keep 10 mantissa bits.  Its card check (``chip_smoke.py``'s ``FLASH_TOL`` for
float32, and ``tests/test_torch_cuda.py``) holds every output within 2e-5,
relative and absolute, of the plain version, which computes in float32.
Here the kernel's blocked online softmax (KV tiles of 64 keys at d <= 64, 32
at d = 80, 112 and 128, 8 at d = 256; float32 max, sum and accumulator) is
emulated in float32 PyTorch
with both products, S = Q·Kᵀ and P·V, taken three ways: in float32; with
each operand rounded once to TF32; and with each operand split as
hi = tf32(x) plus lo = tf32(x - hi), three products (lo·hi + hi·lo + hi·hi)
summed into one float32 accumulator (the kernel's choice).  A product of two
TF32 values is exact in float32, as in the tensor core.  Rounding is
``cvt.rna.tf32.f32``'s: to nearest, ties away from zero, emulated on the
int32 view (add 0x1000, clear the 13 low bits).  Inputs are the card
check's: numpy normals, q scaled by 3, k and v by 1, causal, at qwen2-0.5b's
14 query heads over 2 KV heads (d=64, and at the smoke configs' d=16 and
32), internlm2-1.8b's 16 over 8 (d=128), zamba2-2.7b's 32 over 32 (d=80),
kimi-k2's 64 over 8 (d=112) and 8 over 1 at d=256.  The split must pass the
float32 check; one TF32 product must fail it, which is why the kernel pays
for three.

The tensor core also rounds each of its sums toward zero (an mma adds its
8 products to the accumulator and truncates).  A second emulation models
that, one mma of 8 products at a time, and holds the kernel's choice of a
fresh accumulator for each KV tile's P·V (added to O by a rounded fma)
against summing P·V into O itself: the latter drifts toward zero with the
row's length (on the card it failed the check at S=4096).  S sums 3 x d/8
truncating mma adds a row; at d=256 (96 of them) the kernel sums it 64
columns of d at a time in fresh accumulators, joined by rounded adds, which
the emulation holds against one accumulator."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402

# chip_smoke.py's FLASH_TOL["float32"] and FLASH_QKV_SCALE
RTOL = ATOL = 2e-5
QKV_SCALE = (3.0, 1.0, 1.0)
# the TF32 kernel's KV tile, and the columns of d its S sums in one
# accumulator
BLOCK_K = {16: 64, 32: 64, 64: 64, 80: 32, 112: 32, 128: 32, 256: 8}
S_CHUNK = {256: 64}

SHAPES = {"qwen2-0.5b": (14, 2, 1024, 64), "internlm2-1.8b": (16, 8, 512, 128),
          "qwen2-0.5b d=16": (14, 2, 256, 16),
          "qwen2-0.5b d=32": (14, 2, 256, 32),
          "zamba2-2.7b": (32, 32, 256, 80), "kimi-k2": (64, 8, 256, 112),
          "mqa d=256": (8, 1, 256, 256)}


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 ``x``: round to 10 mantissa bits, to
    nearest, ties away from zero (the sign bit rides along), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _parts(x: torch.Tensor, how: str):
    """The float32 operands whose products the kernel sums, biggest last."""
    if how == "float32":
        return [x]
    hi = rna_tf32(x)
    if how == "tf32":
        return [hi]
    return [rna_tf32(x - hi), hi]           # lo, hi


def _product(a: torch.Tensor, b: torch.Tensor, how: str) -> torch.Tensor:
    """a @ b as the route multiplies it: every hi·hi, hi·lo and lo·hi pair
    of a 3xTF32 split (lo·lo dropped), the small ones first."""
    if how != "tf32x3":
        return _parts(a, how)[0] @ _parts(b, how)[0]
    (a_lo, a_hi), (b_lo, b_hi) = _parts(a, how), _parts(b, how)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated(q, k, v, q_per_kv, how):
    """Causal blocked online softmax in float32, both products taken as
    ``how``; the scale applied to the scores, as the kernel does."""
    h, s, d = q.shape
    kf = torch.repeat_interleave(k, q_per_kv, 0)
    vf = torch.repeat_interleave(v, q_per_kv, 0)
    m = torch.full((h, s, 1), -torch.inf)
    l = torch.zeros((h, s, 1))
    acc = torch.zeros((h, s, d))
    qpos = torch.arange(s)[:, None]
    bk = BLOCK_K[d]
    for k0 in range(0, s, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        sc = _product(q, kt.transpose(1, 2), how) * d ** -0.5
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        sc = torch.where(kpos <= qpos, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _product(p, vt, how)
        m = m_new
    return acc / l


def _qkv(seed, h, kvh, s, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=shape) * scale)
                             .astype(np.float32))
            for shape, scale in zip(((h, s, d), (kvh, s, d), (kvh, s, d)),
                                    QKV_SCALE)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("how,passes", [("float32", True), ("tf32x3", True),
                                        ("tf32", False)])
def test_products_against_the_float32_check(shape, how, passes):
    h, kvh, s, d = SHAPES[shape]
    q, k, v = _qkv(s + d, h, kvh, s, d)
    ref = attention_ref(q, k, v, q_per_kv=h // kvh, causal=True)
    got = _emulated(q, k, v, h // kvh, how)
    within = torch.allclose(got, ref, rtol=RTOL, atol=ATOL)
    worst = float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())
    assert within == passes, worst
    if not passes:      # not a near miss: one TF32 product is far outside
        assert worst > 10, worst


def _round_toward_zero(exact: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mma3_truncating(c, a, b):
    """c + a @ b as the kernel's mma.sync sequence sums it: k in steps of 8,
    each step lo·hi, hi·lo, hi·hi, each mma exact and then truncated."""
    (a_lo, a_hi), (b_lo, b_hi) = _parts(a, "tf32x3"), _parts(b, "tf32x3")
    for k0 in range(0, a.shape[-1], 8):
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            c = _round_toward_zero(c.double() + x[..., k0:k0 + 8].double()
                                   @ y[..., k0:k0 + 8, :].double())
    return c


def _s_truncating(q, kt, chunk):
    """S = q kᵀ summed as :func:`_mma3_truncating`, ``chunk`` columns of d
    at a time in fresh accumulators joined by rounded float32 adds."""
    s = torch.zeros(q.shape[:2] + kt.shape[1:2])
    for c0 in range(0, q.shape[-1], chunk):
        s = s + _mma3_truncating(torch.zeros_like(s), q[..., c0:c0 + chunk],
                                 kt[..., c0:c0 + chunk].transpose(1, 2))
    return s


def _emulated_truncating(q, k, v, q_per_kv, q0, fresh, s_chunk=None):
    """Rows q0.. of the causal blocked online softmax with every product
    summed as :func:`_mma3_truncating`; each KV tile's P·V into a fresh
    accumulator added to O by a rounded fma (``fresh``), or into O; S in
    ``s_chunk`` columns of d at a time (:func:`_s_truncating`; all of d by
    default)."""
    _, s, d = q.shape
    kf = torch.repeat_interleave(k, q_per_kv, 0)
    vf = torch.repeat_interleave(v, q_per_kv, 0)
    qs = q[:, q0:]
    m = torch.full(qs.shape[:2] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs)
    qpos = torch.arange(q0, s)[:, None]
    bk = BLOCK_K[d]
    for k0 in range(0, s, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        ok = torch.arange(k0, k0 + kt.shape[1])[None, :] <= qpos
        sc = _s_truncating(qs, kt, s_chunk or d) * d ** -0.5
        sc = torch.where(ok, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(sc - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if fresh:
            pv = _mma3_truncating(torch.zeros_like(o), p, vt)
            o = torch.addcmul(pv, o, alpha)
        else:
            o = _mma3_truncating(o * alpha, p, vt)
        m = m_new
    return o / l


def test_a_fresh_accumulator_per_kv_tile_keeps_the_truncation_off_o():
    """qwen2-0.5b heads, S=1024, the last 256 rows (the longest sums): with
    the tile accumulator the output stays well inside the check and its
    mean drift toward zero is several times smaller than with O summed in
    place."""
    h, kvh, s, d = SHAPES["qwen2-0.5b"]
    q, k, v = _qkv(s + d, h, kvh, s, d)
    q0 = s - 256
    ref = attention_ref(q, k, v, q_per_kv=h // kvh, causal=True)[:, q0:]
    drift = {}
    for fresh in (True, False):
        got = _emulated_truncating(q, k, v, h // kvh, q0, fresh)
        drift[fresh] = -float(((got - ref) * ref.sign()).mean())
        if fresh:
            worst = float(((got - ref).abs() / (ATOL + RTOL * ref.abs()))
                          .max())
            assert worst <= 0.5, worst
    assert drift[False] > 4 * max(drift[True], 0.0), drift


def test_s_in_64_column_accumulators_at_d_256():
    """d=256, 8 over 1 heads, S=256, every row: S summed 64 columns at a time
    (the kernel's S_CHUNK) keeps the output within a third of the check,
    and nearer the plain version than S in one accumulator (96 truncating
    adds a row)."""
    h, kvh, s, d = SHAPES["mqa d=256"]
    q, k, v = _qkv(s + d, h, kvh, s, d)
    ref = attention_ref(q, k, v, q_per_kv=h // kvh, causal=True)
    worst = {}
    for chunk in (S_CHUNK[d], d):
        got = _emulated_truncating(q, k, v, h // kvh, 0, True, chunk)
        worst[chunk] = float(((got - ref).abs()
                              / (ATOL + RTOL * ref.abs())).max())
    assert worst[S_CHUNK[d]] <= 1 / 3, worst
    assert worst[S_CHUNK[d]] < worst[d], worst


# (float32 bits, the bits cvt.rna.tf32.f32 gives)
RNA_CASES = [
    (0x3F800000, 0x3F800000),   # 1.0, already TF32
    (0x3F800FFF, 0x3F800000),   # just below half an ulp: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F803000, 0x3F804000),   # a tie from an odd TF32 value: up
    (0xBF800FFF, 0xBF800000),   # negative, below the tie: toward zero
    (0x3FFFF000, 0x40000000),   # the mantissa carries into the exponent: 2.0
    (0xBFFFF800, 0xC0000000),   # the same, negative: -2.0
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x00001000, 0x00002000),   # a subnormal tie
]


@pytest.mark.parametrize("bits,want", RNA_CASES)
def test_rna_tf32_on_hand_picked_bits(bits, want):
    x = torch.from_numpy(np.array([bits], dtype=np.uint32).view(np.float32))
    got = rna_tf32(x).view(torch.int32)
    assert int(got[0]) & 0xFFFFFFFF == want


def test_split_keeps_22_bits():
    """hi + lo is x within 2**-22 of |x|, and each part has at most 11
    significant bits (its 13 low bits clear)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10_000)
                         .astype(np.float32) * 3)
    lo, hi = _parts(x, "tf32x3")
    for part in (lo, hi):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((x - hi).abs() > 2.0 ** -12 * x.abs()).any())
