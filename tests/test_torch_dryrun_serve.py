"""The dry run's serving cells (``repro_torch.launch.dryrun.build_step``'s
prefill and decode) on the reference's layouts, on a fake process group
of 4 ranks at the (2, 2), (1, 4) and (4, 1) ("data", "model") meshes, in
one subprocess (``tests/_torch_dryrun_serve_worker.py``): the qwen2-0.5b
smoke model's prefill (B 4, S 64) and decode step (B 4 against 64
positions).

* A rank's FLOPs are exactly the count worked out from the config
  (:func:`serve_rank_flops`): the batch splits over "data"; the matmuls
  the rules split over "model" and the attention at the rank's heads (or,
  over a cache whose sequence is cut over "model", every head at the
  rank's positions) count 1/m; summed over the mesh that part is the
  single-device cell's, and the single-device cell is the formula at one
  rank.  Where the KV heads do not divide "model" the k / v projections
  run on more than a rank's share (the KV heads the rank's query heads
  read, and at prefill every KV head at the rank's cache rows too).
* The meta count (each ``flash_attention`` charge swapped for the plain
  version's count at its shape) equals ``FlopCounterMode``'s count of the
  same cell run on CPU tensors laid out on the same mesh, exactly.
* A rank's peak and arguments are below those of the cell as the dry run
  counted it before sharded serving (full params on every rank, the
  rank's batch slice, its whole cache).
* The rwkv6 and zamba2 smoke models' cells the same way
  (:func:`recurrent_serve_rank_flops`): every RWKV-6 and Mamba2 mix at
  the rank's heads, and their meta count against the cell on CPU
  tensors.

Tolerances: exact (FLOPs, launches, shapes); memory strictly below."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import _torch_dryrun_serve_worker as dw  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models.layers import head_share, kv_heads_read  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = [f"{d}x{m}" for d, m in dw.MESHES]
KINDS = ("prefill", "decode")


class _Worker:
    """The worker process: started once, joined on first read."""

    def __init__(self, out):
        self.out = str(out)
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(HERE), "src")
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in [env.get("PYTHONPATH")] if p])
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE,
                                          "_torch_dryrun_serve_worker.py"),
             self.out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.cases = None

    def read(self) -> dict:
        if self.cases is None:
            log, _ = self.proc.communicate(timeout=300)
            err = os.path.join(self.out, "error.txt")
            assert self.proc.returncode == 0 and not os.path.exists(err), \
                log[-4000:]
            with open(os.path.join(self.out, "cases.json")) as f:
                self.cases = json.load(f)
        return self.cases


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    w = _Worker(tmp_path_factory.mktemp("dryrun_serve"))
    yield w
    if w.proc.poll() is None:
        w.proc.kill()
        w.proc.communicate()


def serve_rank_flops(cfg, kind: str, b: int, s: int, data: int, m: int):
    """(split, kv) FLOPs of a rank's serving cell of the dense config
    ``cfg`` at a ("data", "model") mesh of (``data``, ``m``), worked out
    from the config (each matmul once: no gradient).  The rank takes
    ``b / data`` rows.  Split: q and o on H / m heads, the MLP on
    d_ff / m columns, the head on vocab / m (the last token's at prefill),
    and the attention (the kernel's charge at prefill, 4 · d · B·H · kept
    pairs; at decode the two dots, at the rank's H / m heads over every
    position, or over a sequence cut over "model" at every head over
    S / m positions).  kv: the k and v projections, on KVH / m heads where
    they divide "model"; else at prefill on the KV heads the rank's query
    heads read and every KV head at its S / m cache rows, at decode on
    every KV head."""
    bl, hd, d, L = b // data, cfg.head_dim, cfg.d_model, cfg.n_layers
    t = bl * s if kind == "prefill" else bl
    heads = cfg.n_heads // m
    kv_split = cfg.n_kv_heads % m == 0

    def mm(k, n, rows=t):
        return 2 * rows * k * n
    split = L * (mm(d, heads * hd) + mm(heads * hd, d)
                 + 2 * mm(d, cfg.d_ff // m) + mm(cfg.d_ff // m, d)) \
        + mm(d, cfg.vocab_size // m, bl)
    if kind == "prefill":
        split += L * 4 * hd * bl * heads * fa_kernel.kept_pairs(s, s, True,
                                                                None)
        if kv_split:
            kv = L * 2 * mm(d, cfg.n_kv_heads // m * hd)
        else:
            read = len(kv_heads_read(cfg.n_heads, cfg.n_kv_heads, m, 0))
            kv = L * 2 * (mm(d, read * hd)
                          + mm(d, cfg.n_kv_heads * hd, bl * s // m))
        return split, kv
    # decode: one token a row against s positions
    split += L * 2 * 2 * bl * (heads * s if kv_split
                               else cfg.n_heads * (s // m)) * hd
    kv = L * 2 * mm(d, (cfg.n_kv_heads // m if kv_split
                        else cfg.n_kv_heads) * hd)
    return split, kv


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_serving_rank_flops_are_worked_out(worker, mesh, kind):
    cases = worker.read()
    data, model = map(int, mesh.split("x"))
    cfg = get_smoke_config(dw.ARCH)
    split, kv = serve_rank_flops(cfg, kind, dw.BATCH, dw.SEQ, data, model)
    assert cases[f"{kind} {mesh}"]["flops"] == split + kv
    one_split, one_kv = serve_rank_flops(cfg, kind, dw.BATCH, dw.SEQ, 1, 1)
    assert one_split + one_kv == cases[f"single {kind}"]
    assert data * model * split == one_split
    # the smoke config's 2 KV heads divide 2 "model" ranks, not 4
    assert (data * model * kv == one_kv) == (model != 4)


def swapped_flops(case: dict) -> float:
    """The meta count with each ``flash_attention`` charge swapped for
    ``FlopCounterMode``'s count of the plain version at the call's
    shape."""
    flops = case["flops"]
    for c in case["kernels"]["flash_attention"]["calls"]:
        dt = getattr(torch, c["dtype"])
        q = torch.empty(c["bh"], c["sq"], c["d"], dtype=dt, device="meta")
        k = torch.empty(c["bh"] // c["q_per_kv"], c["sk"], c["d"], dtype=dt,
                        device="meta")
        with FlopCounterMode(display=False) as f:
            attention_ref(q, k, k, q_per_kv=c["q_per_kv"],
                          causal=c["causal"], window=c["window"])
        flops += c["calls"] * (f.get_total_flops() - c["flops"])
    return flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_serving_meta_count_follows_the_cell_on_cpu_tensors(worker, mesh,
                                                            kind):
    case = worker.read()[f"{kind} {mesh}"]
    assert swapped_flops(case) == case["cpu_flops"]


@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_attends_the_ranks_heads(worker, mesh):
    """One ``flash_attention`` call a layer at the rank's batch rows and
    H / m heads over the whole prompt; none at decode."""
    cases = worker.read()
    data, model = map(int, mesh.split("x"))
    cfg = get_smoke_config(dw.ARCH)
    fa = cases[f"prefill {mesh}"]["kernels"]["flash_attention"]
    assert fa["launches"] == cfg.n_layers
    assert [(c["bh"], c["sq"], c["sk"]) for c in fa["calls"]] == [
        (dw.BATCH // data * cfg.n_heads // model, dw.SEQ, dw.SEQ)]
    assert cases[f"decode {mesh}"]["kernels"]["flash_attention"][
        "launches"] == 0


def recurrent_serve_rank_flops(cfg, kind: str, b: int, s: int, data: int,
                               m: int) -> dict:
    """The FLOPs of rank 0's serving cell of the rwkv6 or zamba2 config
    ``cfg`` at a ("data", "model") mesh of (``data``, ``m``), worked out
    from the config, by part (each product once: no gradient; the rank
    takes ``b / data`` rows, ``s`` prompt tokens or one token a row
    against ``s`` positions).  ``heads``: the products of the rank's
    heads (``head_share``: ``c`` of ``H``) of every mix, as
    ``test_torch_dryrun.recurrent_rank_flops`` names them (at decode the
    step's: RWKV-6's r by its heads' ``(state + u k v)``, Mamba2's state
    by C); ``split``: RWKV-6's channel mix on ``d_ff / m`` and ``d / m``
    columns, zamba2's shared block at ``H / m`` heads and ``d_ff / m``
    columns (its attention: the kernel's charge at prefill, the two dots
    over ``s`` positions at decode), Mamba2's conv state: the last 3
    positions' (at prefill) or the new token's (at decode, where the mix
    runs on the rank's heads) channels of the rank's block of them
    (``(d_inner + 2 N) / m`` where it divides "model"), the head on
    ``vocab / m`` for the last token; ``whole``: the token-shift LoRAs,
    the decay LoRA's first factor, Mamba2's B and C and their ``C Bᵀ``,
    the shared block's LoRA."""
    bl, d, V = b // data, cfg.d_model, cfg.vocab_size
    t = bl * s if kind == "prefill" else bl
    lc, nc = 64, -(-s // 64)

    def mm(k, n, rows=t):
        return 2 * rows * k * n
    head = mm(d, V // m, bl)
    if cfg.family == "rwkv6":
        _, c = head_share(d // 64, m, 0)
        w, f = 64 * c, cfg.d_ff
        heads = mm(d, 4 * w) + mm(64, w) + mm(w, d)
        heads += (nc * (2 * bl * c * lc * lc * 64 + 2 * 2 * bl * c * lc * 64
                        * 64) if kind == "prefill"
                  else 2 * bl * c * 64 * 64)
        return {"heads": cfg.n_layers * heads,
                "split": cfg.n_layers * (mm(d, f // m) + mm(f // m, d)
                                         + mm(d, d // m)) + head,
                "whole": cfg.n_layers * (mm(d, 32) + 5 * mm(32, d)
                                         + mm(d, 64))}
    di, n = cfg.d_inner, cfg.ssm_state
    p, conv = di // cfg.mamba_heads, di + 2 * n
    block = conv // m if conv % m == 0 else conv
    _, c = head_share(cfg.mamba_heads, m, 0)
    heads = mm(d, c * (2 * p + 1)) + mm(c * p, d)
    whole = mm(d, 2 * n)
    if kind == "prefill":
        heads += nc * (2 * bl * c * lc * lc * p + 2 * 2 * bl * c * lc * n * p)
        whole += nc * 2 * bl * lc * lc * n
        split = mm(d, block, 3 * bl)
    else:
        heads += 2 * bl * c * p * n
        split = mm(d, block, bl) if m > 1 else 0
    hr, kr, hd, f = (cfg.n_heads // m, cfg.n_kv_heads // m, cfg.head_dim,
                     cfg.d_ff // m)
    shared = mm(d, hr * hd) + 2 * mm(d, kr * hd) + mm(hr * hd, d) \
        + 2 * mm(d, f) + mm(f, d)
    shared += (4 * hd * bl * hr * fa_kernel.kept_pairs(s, s, True, None)
               if kind == "prefill" else 2 * 2 * bl * hr * s * hd)
    inv = cfg.n_shared_attn
    return {"heads": cfg.n_layers * heads,
            "split": cfg.n_layers * split + inv * shared + head,
            "whole": cfg.n_layers * whole + inv * 3 * (mm(d, 32)
                                                       + mm(32, d))}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", dw.RECURRENT_ARCHS)
def test_recurrent_serving_rank_flops_are_worked_out(worker, arch, mesh,
                                                     kind):
    """rwkv6's and zamba2's serving cells: a rank's FLOPs are exactly
    :func:`recurrent_serve_rank_flops`; the single-device cell is the
    formula at one rank, and the head products are the single-device
    cell's at the rank's share of the heads and of the batch."""
    cases = worker.read()
    data, model = map(int, mesh.split("x"))
    cfg = get_smoke_config(arch)
    got = recurrent_serve_rank_flops(cfg, kind, dw.BATCH, dw.SEQ, data,
                                     model)
    assert cases[f"{arch} {kind} {mesh}"]["flops"] == sum(got.values())
    one = recurrent_serve_rank_flops(cfg, kind, dw.BATCH, dw.SEQ, 1, 1)
    assert sum(one.values()) == cases[f"{arch} single {kind}"]
    heads = cfg.d_model // 64 if cfg.family == "rwkv6" else cfg.mamba_heads
    _, count = head_share(heads, model, 0)
    assert data * heads * got["heads"] == count * one["heads"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", dw.RECURRENT_ARCHS)
def test_recurrent_serving_meta_count_follows_the_cell_on_cpu_tensors(
        worker, arch, mesh, kind):
    case = worker.read()[f"{arch} {kind} {mesh}"]
    assert swapped_flops(case) == case["cpu_flops"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_serving_peak_below_full_params(worker, mesh, kind):
    case = worker.read()[f"{kind} {mesh}"]
    mem, old = case["memory"], case["full_params"]
    assert mem["peak_bytes"] < old["peak_bytes"], (mem, old)
    assert mem["argument_bytes"] < old["argument_bytes"], (mem, old)
