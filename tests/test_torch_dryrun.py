"""The port's dry run (``repro_torch.launch.dryrun``): ``abstract_params``
/ ``abstract_cache`` and the MoE decision against the reference's; the
meta trace against the same step on CPU tensors and against
``repro.launch.hloanalysis.analyze`` of the reference's compiled step;
``flash_attention``'s meta route; and, in one subprocess on fake process
groups (``tests/_torch_dryrun_worker.py``), per-rank FLOPs and collectives
over meshes of 4, ``make_production_mesh`` and one CLI run.

Tolerances.  Shapes, dtypes, decisions, FLOPs on CPU tensors, per-rank
FLOPs, collectives and the meta route's charge: exact.  Against the
reference's HLO: relative 1e-9 for the attn and moe families' prefill
and decode; 5 % for train steps and the recurrent families, whose gaps
PERF.md explains op by op (the port's checkpointed loss chunks and its
attention backward recompute products the reference's autodiff saves;
the reference writes some reductions over the head dim as dots, which
``FlopCounterMode`` does not see as elementwise products summed)."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import hloanalysis as j_hlo  # noqa: E402
from repro.launch import sharding as j_sh  # noqa: E402
from repro.launch.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import get_optimizer as j_get_optimizer  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_sharding_overrides  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttentionFn,  # noqa: E402
                                                 attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.shapes import SHAPES, ShapeSpec, input_specs  # noqa: E402
from repro_torch.models.model import abstract_params, init_params  # noqa: E402
from repro_torch.optim import cosine_schedule, get_optimizer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.steps import loss_and_grads, make_train_step  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
B, S = 2, 64
REL_EXACT, REL_NEAR = 1e-9, 0.05
# a reference step compiles without LLVM's optimisation passes: the same
# HLO in less time (as tests/test_torch_train.py)
REFERENCE_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the Motivation's cells: train on four families, serving on five
TRAIN_ARCHS = ("qwen2-0.5b", "mixtral-8x22b", "rwkv6-3b", "zamba2-2.7b")
SERVE_ARCHS = TRAIN_ARCHS[:1] + ("internlm2-1.8b",) + TRAIN_ARCHS[1:]
CELLS = [(a, "train") for a in TRAIN_ARCHS] + [
    (a, k) for a in SERVE_ARCHS for k in ("prefill", "decode")]


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


# ------------------------------------------------- the fake-group worker
class _Worker:
    """The worker process: started once, joined on first read."""

    def __init__(self, out):
        self.out = str(out)
        env = dict(os.environ)
        src = os.path.join(os.path.dirname(HERE), "src")
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in [env.get("PYTHONPATH")] if p])
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_dryrun_worker.py"),
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


@pytest.fixture(scope="module", autouse=True)
def worker(tmp_path_factory):
    """Started before the module's first test, so the fake-group cases run
    while this process traces."""
    w = _Worker(tmp_path_factory.mktemp("dryrun"))
    yield w
    if w.proc.poll() is None:
        w.proc.kill()
        w.proc.communicate()


@pytest.fixture(scope="module")
def reference():
    """The reference's compiled cells' FLOPs, compiled on two threads (XLA
    compiles outside the interpreter lock) while the port's steps trace:
    ``reference[(arch, kind)]`` is a future."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        yield {cell: pool.submit(reference_flops, *cell) for cell in CELLS}


# --------------------------------------- abstract params and caches
def shapes_dtypes(tree) -> dict:
    """The reference's leaves -> {path: (shape, torch dtype)}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape),
                                      getattr(torch, jnp.dtype(x.dtype).name))
            for p, x in flat}


def torch_shapes_dtypes(tree) -> dict:
    """The port's meta leaves -> {path: (shape, dtype)}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + f"[{k!r}]")
        else:
            assert node.device.type == "meta", path
            out[path] = (tuple(node.shape), node.dtype)
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_the_reference(arch):
    want = shapes_dtypes(jm.abstract_params(j_config(arch)))
    assert torch_shapes_dtypes(abstract_params(get_config(arch))) == want


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_matches_the_reference(arch, shape):
    sp = SHAPES[shape]
    want = shapes_dtypes(j_engine.abstract_cache(
        j_config(arch), sp.global_batch, sp.seq_len))
    got = engine.abstract_cache(get_config(arch), sp.global_batch,
                                sp.seq_len)
    assert torch_shapes_dtypes(got) == want


# ------------------------------------------------------ the MoE decision
def reference_decision(jc, shape, mesh, overrides) -> dict:
    """``repro/launch/dryrun.py:97-107`` on the reference's own helpers."""
    bax = j_sh.batch_axes(mesh, shape.global_batch)
    if bax is not None and not isinstance(bax, tuple):
        bax = (bax,)
    updates = dict(act_batch_axes=bax, moe_groups=None,
                   moe_expert_sharded=False)
    if jc.moe is not None and bax is not None:
        rules = j_sh.apply_overrides(j_sh.default_rules(mesh, jc), overrides)
        gd = math.prod(mesh.shape[a] for a in bax)
        gm = mesh.shape.get("model", 1)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        if tokens % (gd * gm) == 0 and tokens // (gd * gm) >= jc.moe.top_k:
            updates["moe_groups"] = (gd, gm)
            updates["moe_expert_sharded"] = rules.get("experts") == "model"
    return updates


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_moe_decision_matches_the_reference(arch, shape, mesh):
    m = FakeMesh(MESHES[mesh])
    ov = get_sharding_overrides(arch)
    want = reference_decision(j_config(arch), J_SHAPES[shape], m, ov)
    cfg = dryrun.step_config(get_config(arch), SHAPES[shape], m, ov)
    assert {k: getattr(cfg, k) for k in want} == want


# ------------------------------------- the meta trace against the program
def tokens_np() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 128, (B, S)).astype(np.int32)


def attention_ref_flops(call: dict) -> int:
    """FlopCounterMode's count of the plain version at a recorded call's
    shape."""
    dt = getattr(torch, call["dtype"])
    q = torch.empty(call["bh"], call["sq"], call["d"], dtype=dt,
                    device="meta")
    k = torch.empty(call["bh"] // call["q_per_kv"], call["sk"], call["d"],
                    dtype=dt, device="meta")
    with FlopCounterMode(display=False) as f:
        attention_ref(q, k, k, q_per_kv=call["q_per_kv"],
                      causal=call["causal"], window=call["window"])
    return f.get_total_flops()


def attention_bwd_ref_flops(call: dict) -> int:
    """FlopCounterMode's count of the plain backward at a recorded
    backward call's shape, in blocks of 512 query rows (the configs'
    ``attn_block_k``, which ``flash_train`` passes it)."""
    dt = getattr(torch, call["dtype"])
    q = torch.empty(call["bh"], call["sq"], call["d"], dtype=dt,
                    device="meta")
    k = torch.empty(call["bh"] // call["q_per_kv"], call["sk"], call["d"],
                    dtype=dt, device="meta")
    with FlopCounterMode(display=False) as f:
        attention_bwd_ref(q, k, k, q, q_per_kv=call["q_per_kv"],
                          causal=call["causal"], window=call["window"],
                          block_q=512)
    return f.get_total_flops()


def swapped(rec: dict) -> float:
    """``count_step``'s FLOPs with each flash_attention charge swapped for
    the plain version's count at its shape, and each backward charge for
    the plain backward's."""
    flops = rec["executed"]["flops"]
    for c in rec["kernels"]["flash_attention"]["calls"]:
        flops += c["calls"] * (attention_ref_flops(c) - c["flops"])
    for c in rec["kernels"]["flash_attention_bwd"]["calls"]:
        flops += c["calls"] * (attention_bwd_ref_flops(c) - c["flops"])
    return flops


@lru_cache(maxsize=None)
def port_counts(arch: str, kind: str):
    """(count_step's record on meta, FlopCounterMode's count of the same
    step on CPU tensors) for the smoke config at B 2, S 64."""
    cfg = get_smoke_config(arch)
    toks = torch.from_numpy(tokens_np())
    meta_params, cpu_params = abstract_params(cfg), init_params(cfg, 0, "cpu")
    if kind == "train":
        opt = get_optimizer(dryrun.get_optimizer_name_from_cfg(cfg))
        fn = make_train_step(cfg, opt, cosine_schedule(3e-4, 100, 10000))
        meta = (meta_params, opt.init(meta_params),
                input_specs(cfg, ShapeSpec("t", S, B, "train")))
        cpu = (cpu_params, opt.init(cpu_params),
               {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        def fn(params, tokens):
            return engine.prefill(params, cfg, tokens=tokens)
        meta = (meta_params, torch.empty(B, S, dtype=torch.int32,
                                         device="meta"))
        cpu = (cpu_params, toks)
    else:
        def fn(params, cache, tokens):
            return engine.decode_step(params, cfg, cache, tokens)[:2]
        meta = (meta_params, engine.abstract_cache(cfg, B, S),
                torch.empty(B, dtype=torch.int32, device="meta"))
        cpu = (cpu_params, engine.init_cache(cfg, B, S, device="cpu"),
               toks[:, 0])
    rec = dryrun.count_step(fn, meta)
    with FlopCounterMode(display=False) as f:
        fn(*cpu)
    return rec, f.get_total_flops()


def reference_flops(arch: str, kind: str) -> float:
    """``hloanalysis.analyze`` of the reference's compiled single-device
    step on the same cell."""
    jc = j_smoke(arch)
    params = jm.init_params(jc, jax.random.PRNGKey(0))
    toks = jnp.asarray(tokens_np())
    if kind == "train":
        opt = j_get_optimizer(dryrun.get_optimizer_name_from_cfg(jc))
        step = j_steps.make_train_step(jc, opt, j_cosine(3e-4, 100, 10000))
        lowered = jax.jit(step).lower(params, opt.init(params),
                                      {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        lowered = jax.jit(lambda p, t: j_engine.prefill(p, jc, tokens=t)
                          ).lower(params, toks)
    else:
        lowered = jax.jit(
            lambda p, c, t: j_engine.decode_step(p, jc, c, t)[:2]).lower(
                params, j_engine.init_cache(jc, B, S), toks[:, 0])
    text = lowered.compile(REFERENCE_COMPILER_OPTIONS).as_text()
    return j_hlo.analyze(text)["flops"]


@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("arch,kind", CELLS)
def test_meta_trace_follows_the_program(arch, kind):
    rec, cpu_flops = port_counts(arch, kind)
    calls = rec["kernels"]["flash_attention"]["launches"]
    bwd_calls = rec["kernels"]["flash_attention_bwd"]["launches"]
    if get_smoke_config(arch).family == "rwkv6" or kind == "decode":
        assert calls == 0
    else:
        assert calls > 0
    # one backward an attention under grad (the train step's), none else
    assert bwd_calls == (calls // 2 if kind == "train" else 0)
    assert swapped(rec) == cpu_flops


@pytest.mark.parametrize("arch,kind", CELLS)
def test_swapped_flops_against_the_reference(reference, arch, kind):
    rec, _ = port_counts(arch, kind)
    exact = get_smoke_config(arch).family in ("attn", "moe") \
        and kind != "train"
    want = reference[(arch, kind)].result()
    assert swapped(rec) == pytest.approx(
        want, rel=REL_EXACT if exact else REL_NEAR, abs=0)


# ------------------------------------------------------- the meta route
def test_meta_route_charge_at_row_5_and_no_launch():
    """qwen2-0.5b's prefill attention (B 4, H 14, KVH 2, S 4096, d 64,
    bf16): 4 · d · B·H · the causal pairs, 120.3 GFLOP; q, k, v and the
    output once; recorded, no LAUNCHES; the training forward
    (``FlashAttentionFn``) takes the same route."""
    q = torch.empty(56, 4096, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(8, 4096, 64, dtype=torch.bfloat16, device="meta")
    launches = fa_kernel.LAUNCHES
    fa_kernel.META_CALLS.clear()
    out = flash_attention(q, k, k, q_per_kv=7)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype
    key = (56, 4096, 4096, 64, 7, True, None, torch.bfloat16)
    assert fa_kernel.META_CALLS == {key: 1}
    pairs = 4096 * 4097 // 2
    assert fa_kernel.charge(key) == (4 * 64 * 56 * pairs,
                                     (2 * 56 + 2 * 8) * 4096 * 64 * 2)
    assert fa_kernel.charge(key)[0] == 120_288_444_416
    FlashAttentionFn.apply(q.requires_grad_(True), k, k, 7, True, None,
                           None, 512)
    assert fa_kernel.META_CALLS == {key: 2}
    assert fa_kernel.LAUNCHES == launches
    # windows keep fewer pairs: Mixtral's window 4096 keeps all causal ones
    assert fa_kernel.kept_pairs(4096, 4096, True, 4096) == pairs
    assert fa_kernel.kept_pairs(5, 5, True, 1) == 1 + 2 * 4
    assert fa_kernel.kept_pairs(3, 4, False, None) == 12
    with pytest.raises(ValueError, match="KV rows"):
        flash_attention(q.detach(), k, k, q_per_kv=6)
    fa_kernel.META_CALLS.clear()


def _other_wrapper(name: str):
    m = lambda shape, dt: torch.zeros(shape, dtype=dt, device="meta")  # noqa: E731
    i32 = torch.int32
    if name == "observe_scatter":
        from repro_torch.kernels.observe_scatter import observe_scatter
        return lambda: observe_scatter(m((8,), i32), m((), i32),
                                       n_blocks=4, period=3)
    if name == "hist_select":
        from repro_torch.kernels.hist_select import kth_key
        return lambda: kth_key(m((1, 8), i32), None, [2])
    if name == "gather_count":
        from repro_torch.kernels.gather_count import gather_count
        return lambda: gather_count(m((8, 4), torch.float32), m((3,), i32),
                                    m((2,), i32), block_rows=4)
    from repro_torch.kernels.embedding_bag import embedding_bag
    return lambda: embedding_bag(m((8, 4), torch.float32), m((2, 3), i32),
                                 m((2,), i32), block_rows=4)


@pytest.mark.parametrize("name", ["observe_scatter", "hist_select",
                                  "gather_count", "embedding_bag"])
def test_other_wrappers_raise_on_meta(name):
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        _other_wrapper(name)()


# ---------------------------------------- the fake-group cases (worker)
@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1"])
def test_per_rank_flops_conserve_over_the_fake_group(worker, mesh):
    """A rank's FLOPs times the batch axis's ranks are the single-device
    step's: the batch splits over "data", the "model" ranks repeat it."""
    cases = worker.read()
    data = int(mesh.split("x")[0])
    assert cases[f"mesh {mesh}"]["flops"] * data \
        == cases["single_device_flops"]


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1"])
def test_collectives_equal_the_counted(worker, mesh):
    case = worker.read()[f"mesh {mesh}"]
    got, counted = case["collectives"], case["counted"]
    for kind, ref_kind in (("all_gather", "all-gather"),
                           ("all_reduce", "all-reduce"),
                           ("all_to_all", "all-to-all")):
        assert got["count"][ref_kind] == counted[kind]
        assert got["bytes"][ref_kind] == counted[kind + "_bytes"]
    assert got["count"]["all-gather"] > 0 and got["count"]["all-reduce"] > 0
    assert got["total_bytes"] == sum(counted[k] for k in counted
                                     if k.endswith("_bytes"))
    ex = case["executed"]
    assert ex["collective_count"] == got["count"]
    assert ex["collective_total_bytes"] == sum(
        ex["collective_wire_bytes"].values())


@pytest.mark.parametrize("multi", [False, True])
def test_make_production_mesh(worker, multi):
    got = worker.read()[f"production multi_pod={multi}"]
    want = ({"shape": [2, 16, 16], "axes": ["pod", "data", "model"],
             "size": 512} if multi else
            {"shape": [16, 16], "axes": ["data", "model"], "size": 256})
    assert {k: got[k] for k in want} == want
    assert got["device_type"] == "cpu"


def test_make_production_mesh_needs_enough_ranks(worker):
    msg = worker.read()["too_small"]
    assert msg is not None and "does not fit the 4-rank" in msg


def test_cli_writes_a_record(worker):
    cases = worker.read()
    assert cases["cli_exit"] == 0 and not cases["cli_left_a_group"]
    path = os.path.join(worker.out, "cli",
                        "qwen2-0_5b__train_4k__16x16.json")
    with open(path) as f:
        rec = json.load(f)
    assert {"arch", "shape", "mesh", "status", "reason", "devices", "flops",
            "bytes_accessed", "executed", "collectives", "memory",
            "trace_s", "kernels"} <= set(rec)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"],
            rec["devices"]) == ("qwen2-0.5b", "train_4k", "16x16", "ok", 256)
    assert rec["flops"] == rec["executed"]["flops"] > 0
    assert rec["bytes_accessed"] == rec["executed"]["hbm_bytes"]
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    fa = rec["kernels"]["flash_attention"]
    # 24 layers, each attention's forward twice (remat)
    assert fa["launches"] == 48
    assert [c["calls"] for c in fa["calls"]] == [48]
    assert (fa["calls"][0]["bh"], fa["calls"][0]["sq"]) == (16 * 14, 4096)


# ------------------------- a fault the grid found: the embeddings frontend
def embeddings_batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"embeds": embeds, "positions": pos, "labels": labels}


def test_embeddings_frontend_train_step_matches_the_reference():
    """qwen2-vl-72b's smoke config in float32 with its embeddings frontend
    (M-RoPE positions): ``embed`` is read by no op, and its gradient is
    zero, as ``jax.grad`` gives it (the train step raised before); the
    loss within 1e-5 relative and every gradient leaf within 1e-4 of its
    largest magnitude of the reference's (PERF.md §2's train bounds)."""
    f32 = dict(param_dtype=jnp.float32, activ_dtype=jnp.float32)
    jc = dataclasses.replace(j_smoke("qwen2-vl-72b"), **f32)
    cfg = dataclasses.replace(get_smoke_config("qwen2-vl-72b"),
                              param_dtype=torch.float32,
                              activ_dtype=torch.float32)
    assert cfg.frontend == "embeddings" and cfg.rope == "mrope"
    j_params = jm.init_params(jc, jax.random.PRNGKey(1))
    batch = embeddings_batch(cfg)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_steps.compute_loss(p, jc, b), has_aux=True))(
            j_params, jax.tree.map(jnp.asarray, batch))
    params = params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    loss, _, grads = loss_and_grads(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    want = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + f"[{k!r}]")
        else:
            got[path] = node.numpy()
    walk(grads, "")
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, w in want:
        g, w = got[jax.tree_util.keystr(path)], np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)
    assert not np.any(got["['embed']"]) \
        and not np.any(np.asarray(j_grads["embed"]))
