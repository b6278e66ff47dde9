"""Worker side of ``tests/test_torch_sharded_train.py``: one process per rank
of a 4-rank gloo group, importing only ``repro_torch``.

Every rank builds the meshes of the module (subgroups of the one group:
``new_group`` is collective over the whole group), then runs every case:

* ``<case>``: two sharded train steps at a (2, 2) ("data", "model") mesh
  from CASES' inputs, then the first step's reduced gradient again;
  rank 0 writes ``<case>.npz`` (the gathered state after each step, the
  metrics, the gradient), every rank ``<case>.<rank>.json`` (each leaf's
  placements against ``named``, the collectives of each step);
* ``restore``: the first case's state after its two steps saved from the
  (2, 2) mesh, restored at a (4,) ("data",) mesh and with no mesh, then
  one more sharded step at (4,);
* ``major_first``: a ("pod", "data") spec on meshes ordered ("pod",
  "data") and ("data", "pod"): which rank holds which block;
* ``constrain``: ``constrain_batch`` on a DTensor over a 2-rank mesh.

A rank that fails writes ``<case>.<rank>.error`` and leaves the group, so
the others fail at their next collective instead of waiting forever.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import traceback

import numpy as np

from _perturbed_weights import perturbed_tree

N_RANKS = 4
# case -> (arch, MoE capacity factor): the smoke config of each family,
# dense (the reference test's case), dense with a tied embedding and qkv
# bias, the two MoE (Adafactor on kimi-k2) at capacity factor 8 (no token
# drops), the two recurrent; then the two MoE at their configs' own
# capacity factor (1.25), where experts overflow and which tokens drop
# follows the whole batch's order
CASES = {"llama3.2-3b": ("llama3.2-3b", None),
         "qwen2-0.5b": ("qwen2-0.5b", None),
         "mixtral-8x22b": ("mixtral-8x22b", 8.0),
         "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", 8.0),
         "rwkv6-3b": ("rwkv6-3b", None),
         "zamba2-2.7b": ("zamba2-2.7b", None),
         "mixtral-8x22b-drops": ("mixtral-8x22b", None),
         "kimi-k2-1t-a32b-drops": ("kimi-k2-1t-a32b", None)}
B, S, CHUNK = 4, 48, 16
LR = (1e-3, 10, 100)          # peak, warmup, total: lr(1) = 1e-4
STEP_SEEDS = (1, 2)           # the two steps' batches
RESTORE_SEED = 3              # the step after the restore


def config(case: str):
    """The case's smoke config in float32, S 48 in three loss chunks and
    three attention blocks, at the case's MoE capacity factor."""
    import torch
    from repro_torch.configs import get_smoke_config
    arch, capacity_factor = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=torch.float32,
                              activ_dtype=torch.float32, loss_chunk=CHUNK,
                              attn_block_k=CHUNK)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def inputs(case: str):
    """(cfg, params, optimizer, schedule): every leaf drawn (the init's
    zero leaves too), the arch's optimizer."""
    import torch
    from repro_torch.configs import get_optimizer_name
    from repro_torch.models.model import iter_schema
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import tree_map
    cfg = config(case)
    params = tree_map(torch.from_numpy, perturbed_tree(iter_schema(cfg)))
    return (cfg, params, get_optimizer(get_optimizer_name(CASES[case][0])),
            cosine_schedule(*LR))


def batch_np(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def batch(cfg, seed: int) -> dict:
    import torch
    return {k: torch.from_numpy(v) for k, v in batch_np(cfg, seed).items()}


def named_leaves(tree, prefix: str = "") -> dict:
    """``{"a/b": numpy}`` of a tree of dicts and namedtuples (of tensors
    or arrays)."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu()
    return {prefix[:-1]: np.asarray(tree)}


def _metrics(m: dict) -> dict:
    return {k: v.tolist() for k, v in m.items()}


def _placements_ok(tree, shardings) -> list:
    from repro_torch.pytree import leaves, tree_map
    return leaves(tree_map(lambda x, sh: tuple(x.placements) == sh.placements,
                           tree, shardings))


def run_case(case: str, mesh, rank: int, out_dir: str) -> dict:
    from repro_torch.launch import sharding as sh
    from repro_torch.pytree import leaves
    from repro_torch.train import sharded

    cfg, params, opt, sched = inputs(case)
    state = opt.init(params)
    shardings = sharded.state_shardings(mesh, cfg, state)
    p, s = sh.distribute((params, state), shardings)
    step = sharded.make_sharded_train_step(cfg, opt, sched, mesh)
    res = {"placements_ok": [], "collectives": [], "metrics": []}
    save = {}
    for i, seed in enumerate(STEP_SEEDS, 1):
        bt = batch(cfg, seed)
        db = sh.distribute(bt, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                                  bt)))
        before = dict(sh.COLLECTIVES)
        p, s, m = step(p, s, db)
        res["collectives"].append({k: sh.COLLECTIVES[k] - before[k]
                                   for k in before})
        res["placements_ok"].append(_placements_ok((p, s), shardings))
        res["metrics"].append(_metrics(m))
        full_p, full_s = sh.gather((p, s))
        save.update({f"p{i}/{k}": v for k, v in named_leaves(full_p).items()})
        save.update({f"s{i}/{k}": v for k, v in named_leaves(full_s).items()})
    # the first step's gradient (from the same params), reduced over the
    # batch axes
    bt = batch(cfg, STEP_SEEDS[0])
    axes = ("data",)
    local = {k: sh.local_block(v, sh.named(mesh, spec))
             for (k, v), spec in zip(bt.items(),
                                     sh.batch_specs(mesh, cfg, bt).values())}
    _, _, grads = sharded.sharded_loss_and_grads(params, cfg, local, mesh,
                                                 axes)
    for g in leaves(grads):
        sh.all_reduce(g, mesh, axes)
    save.update({f"g/{k}": v for k, v in named_leaves(grads).items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case}.npz"), **save)
    res["state"] = (p, s)
    return res


def run_restore(state, meshes: dict, rank: int, out_dir: str) -> dict:
    """Save the (2, 2) state, restore it at (4,) and with no mesh, take one
    more step at (4,)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import OptState
    from repro_torch.pytree import leaves
    from repro_torch.train import sharded

    cfg, _, opt, sched = inputs(next(iter(CASES)))
    p22, s22 = state
    full = sh.gather({"params": p22, "opt": s22})
    ck = CheckpointManager(os.path.join(out_dir, "ckpt"))
    ck.save(len(STEP_SEEDS), {"params": p22, "opt": s22})
    if rank == 0:
        ck.wait()
    dist.barrier()
    mesh4 = meshes["data4"]
    p_sh, o_sh = sharded.state_shardings(mesh4, cfg, s22)
    got, _ = ck.restore(shardings={"params": p_sh, "opt": o_sh})
    want = {"params": full["params"],
            "opt": {"step": full["opt"].step, "inner": full["opt"].inner}}
    shards = {"params": p_sh, "opt": {"step": o_sh.step,
                                      "inner": o_sh.inner}}
    pairs = list(zip(leaves(got), leaves(want), leaves(shards)))
    res = {
        "placements_ok": [tuple(g.placements) == sh_.placements
                          for g, _, sh_ in pairs],
        "blocks_equal": [torch.equal(g.to_local(), sh.local_block(w, sh_))
                         for g, w, sh_ in pairs],
        "gathered_equal": [torch.equal(a, b) for a, b in zip(
            leaves(sh.gather(got)), leaves(want))],
    }
    plain, _ = ck.restore(device="cpu")
    res["meshless_equal"] = [torch.equal(a, b) for a, b in
                             zip(leaves(plain), leaves(want))]
    step = sharded.make_sharded_train_step(cfg, opt, sched, mesh4)
    bt = batch(cfg, RESTORE_SEED)
    db = sh.distribute(bt, sh.named(mesh4, sh.batch_specs(mesh4, cfg,
                                                               bt)))
    p, s, m = step(got["params"], OptState(**got["opt"]), db)
    res["metrics"] = _metrics(m)
    # a batch of 2 does not split 4 ways: every rank takes all of it
    half = {k: v[:2] for k, v in bt.items()}
    specs = sh.batch_specs(mesh4, cfg, half)
    assert all(spec[0] is None for spec in specs.values()), specs
    _, _, m2 = step(got["params"], OptState(**got["opt"]),
                    sh.distribute(half, sh.named(mesh4, specs)))
    res["unsplit_metrics"] = _metrics(m2)
    res["step_placements_ok"] = _placements_ok((p, s), (p_sh, o_sh))
    full_p, full_s = sh.gather((p, s))
    if rank == 0:
        np.savez(os.path.join(out_dir, "restore.npz"),
                 **{f"p/{k}": v for k, v in named_leaves(full_p).items()},
                 **{f"s/{k}": v for k, v in named_leaves(full_s).items()})
    return res


def run_major_first(meshes: dict, rank: int) -> dict:
    """Rows of an (8, 3) tensor split over ("pod", "data"): rank (pod p,
    data q) must hold block p * 2 + q whichever order the mesh lists the
    axes in, by DTensor's own gather and by ``gather``; and
    ``gather_slices`` (MoE's routed counts of each batch slice) stacks the
    ranks' rows in that order and gives each rank its block's index."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.sharding import NamedSharding, PartitionSpec

    full = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    out = {}
    for name in ("pod_data", "data_pod"):
        mesh = meshes[name]
        ns = NamedSharding(mesh, PartitionSpec(("pod", "data"), None))
        dt = sh.distribute(full, ns)
        blk = mesh.get_local_rank("pod") * 2 + mesh.get_local_rank("data")
        slices, index = sh.gather_slices(full[2 * blk:2 * blk + 2], mesh,
                                         ("pod", "data"))
        out[name] = {
            "placements": [repr(p) for p in ns.placements],
            "block": blk,
            "holds_major_first_block": torch.equal(
                dt.to_local(), full[2 * blk:2 * blk + 2]),
            "dtensor_full_tensor_equal": torch.equal(dt.full_tensor(), full),
            "gather_equal": torch.equal(sh.gather(dt), full),
            "slices_in_block_order": torch.equal(
                slices, full.reshape(4, 2, 3)) and index == blk,
        }
    return out


def run_constrain(meshes: dict, rank: int) -> dict:
    """``constrain_batch`` on a replicated DTensor over a 2-rank ("data",)
    mesh: the batch dim ends Shard(0), each rank its half, the whole
    unchanged; off (act_batch_axes None) it is the same object."""
    import torch
    from torch.distributed.tensor import Shard
    from repro_torch.launch.sharding import NamedSharding, PartitionSpec
    from repro_torch.launch import sharding as sh
    from repro_torch.models.model import constrain_batch

    mesh = meshes["data2"]
    cfg = dataclasses.replace(config("llama3.2-3b"), act_batch_axes=("data",))
    x = torch.arange(4 * 5 * 6, dtype=torch.float32).reshape(4, 5, 6)
    dt = sh.distribute(x, NamedSharding(mesh, PartitionSpec()))
    y = constrain_batch(dt, cfg)
    r = mesh.get_local_rank("data")
    return {
        "placements": [repr(p) for p in y.placements],
        "sharded": tuple(y.placements) == (Shard(0),),
        "local_is_half": torch.equal(y.to_local(), x[2 * r:2 * r + 2]),
        "whole_equal": torch.equal(y.full_tensor(), x),
        "again_same_object": constrain_batch(y, cfg) is y,
        "off_same_object": constrain_batch(
            dt, dataclasses.replace(cfg, act_batch_axes=None)) is dt,
        "plain_same_object": constrain_batch(x, cfg) is x,
    }


def worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, N_RANKS),
                            rank=rank, world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import make_mesh

    meshes = {"mesh22": make_mesh((2, 2), ("data", "model"), device="cpu"),
              "data4": make_mesh((4,), ("data",), device="cpu"),
              "pod_data": make_mesh((2, 2), ("pod", "data"), device="cpu"),
              "data_pod": make_mesh((2, 2), ("data", "pod"), device="cpu"),
              "data2": make_mesh((2,), ("data",), device="cpu")}
    name = "setup"
    try:
        first = None
        for name in CASES:
            res = run_case(name, meshes["mesh22"], rank, out_dir)
            state = res.pop("state")
            first = first or state
            _write(out_dir, name, rank, res)
        name = "restore"
        _write(out_dir, name, rank, run_restore(first, meshes, rank,
                                                out_dir))
        name = "major_first"
        _write(out_dir, name, rank, run_major_first(meshes, rank))
        name = "constrain"
        if rank < 2:
            _write(out_dir, name, rank, run_constrain(meshes, rank))
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def _write(out_dir: str, name: str, rank: int, res: dict) -> None:
    with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
        json.dump(res, f, sort_keys=True)
