"""Worker side of ``tests/test_torch_sharded_train.py``: one process per rank
of a 4-rank gloo group, importing only ``repro_torch``.

Every rank builds the meshes of the module (subgroups of the one group:
``new_group`` is collective over the whole group), then runs every case:

* ``<case>``: two sharded train steps at the case's ("data", "model")
  mesh, (2, 2), (1, 4) or (4, 1), from CASES' inputs on the arch's
  sharding overrides (FSDP over "data", tensor parallel over "model"),
  then the first step's reduced gradient
  again; rank 0 writes ``<case>.npz`` (the gathered state after each
  step, the metrics, the gradient), every rank ``<case>.<rank>.json``
  (each leaf's placements against ``named``, the collectives of each step,
  those of the gradient (``launch.sharding.recording``: over "model" by
  kind, every one over "data"), the leaves the step gathers over "model"
  or sums over it, and each leaf's block: its bytes and whether "data"
  cuts it);
* ``adafactor``: at (2, 2) and (4, 1), Adafactor's update of kimi-k2's
  smoke leaves on each rank's blocks (``means=``, as the sharded step
  calls it) against its update of the whole leaves, from the same whole
  gradient and state (rank 0 writes the worst relative error);
* ``restore``: the first case's state after its two steps saved from the
  (2, 2) mesh, restored at a (4,) ("data",) mesh and with no mesh, then
  one more sharded step at (4,);
* ``major_first``: a ("pod", "data") spec on meshes ordered ("pod",
  "data") and ("data", "pod"): which rank holds which block;
* ``constrain``: ``constrain_batch`` on a DTensor over a 2-rank mesh;
* ``units``: at a (1, 2) mesh, the tensor-parallel ``swiglu``,
  ``attention_block`` (KV heads local, sliced, and heads cut), the
  vocab-parallel loss (tied and untied), the embedding lookup, the
  MoE expert FFN on each rank's block of ``d_expert`` and RWKV-6's time
  and channel mixes and Mamba2's mix on each rank's heads (whole heads a
  rank, and heads that do not divide the ranks) against their unsharded
  calls, outputs, final states and gradients (ranks 0 and 1);
* ``digest``: two steps at a (1, 1) mesh and two without a mesh, hashed,
  and the (1, 1) run's arrays in ``digest-<case>.npz`` (rank 0).

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
# a variant whose heads the rules cut at 4 "model" ranks: 6 heads of d 16
# (96 columns, 24 a rank: a head and a half), GQA over 2 KV heads
CUT = {"n_heads": 6, "head_dim": 16}
# case -> (arch, MoE capacity factor, mesh, config changes): at (2, 2) the
# smoke config of each family, dense (the reference test's case), dense
# with a tied embedding and qkv bias, the two MoE (Adafactor on kimi-k2)
# at capacity factor 8 (no token drops), the two recurrent; then the two
# MoE at their configs' own capacity factor (1.25), where experts overflow
# and which tokens drop follows the whole batch's order; at (1, 4)
# Mixtral at its own capacity factor (its experts' d_expert over 4 ranks),
# the dense config (4 heads over 2 KV heads: each rank slices the KV head its
# query head reads), the tied one (with qkv bias) and the cut variant; at
# (4, 1) (FSDP alone) the dense config on AdamW and kimi-k2 on Adafactor;
# at (1, 4) the two recurrent configs too: rwkv6's 2 heads (1 / 1 / 0 / 0
# a rank, its time mix's weights gathered and sliced), zamba2's 4 Mamba2
# heads (1 a rank)
CASES = {"llama3.2-3b": ("llama3.2-3b", None, "mesh22", {}),
         "qwen2-0.5b": ("qwen2-0.5b", None, "mesh22", {}),
         "mixtral-8x22b": ("mixtral-8x22b", 8.0, "mesh22", {}),
         "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", 8.0, "mesh22", {}),
         "rwkv6-3b": ("rwkv6-3b", None, "mesh22", {}),
         "zamba2-2.7b": ("zamba2-2.7b", None, "mesh22", {}),
         "mixtral-8x22b-drops": ("mixtral-8x22b", None, "mesh22", {}),
         "kimi-k2-1t-a32b-drops": ("kimi-k2-1t-a32b", None, "mesh22", {}),
         "mixtral-8x22b-1x4-drops": ("mixtral-8x22b", None, "mesh14", {}),
         "llama3.2-3b-1x4": ("llama3.2-3b", None, "mesh14", {}),
         "qwen2-0.5b-1x4": ("qwen2-0.5b", None, "mesh14", {}),
         "llama3.2-3b-cut-1x4": ("llama3.2-3b", None, "mesh14", CUT),
         "rwkv6-3b-1x4": ("rwkv6-3b", None, "mesh14", {}),
         "zamba2-2.7b-1x4": ("zamba2-2.7b", None, "mesh14", {}),
         "llama3.2-3b-4x1": ("llama3.2-3b", None, "mesh41", {}),
         "kimi-k2-1t-a32b-4x1": ("kimi-k2-1t-a32b", 8.0, "mesh41", {})}
MESH_SHAPES = {"mesh22": (2, 2), "mesh14": (1, 4), "mesh41": (4, 1)}
B, S, CHUNK = 4, 48, 16
LR = (1e-3, 10, 100)          # peak, warmup, total: lr(1) = 1e-4
STEP_SEEDS = (1, 2)           # the two steps' batches
RESTORE_SEED = 3              # the step after the restore


def config(case: str):
    """The case's smoke config in float32, S 48 in three loss chunks and
    three attention blocks, at the case's MoE capacity factor, with its
    changes."""
    import torch
    from repro_torch.configs import get_smoke_config
    arch, capacity_factor, _, changes = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=torch.float32,
                              activ_dtype=torch.float32, loss_chunk=CHUNK,
                              attn_block_k=CHUNK, **changes)
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


def overrides(case: str) -> dict:
    """The case's arch's sharding overrides (Mixtral's: its experts'
    ``expert_mlp`` on "model", the reference's expert tensor
    parallelism)."""
    from repro_torch.configs import get_sharding_overrides
    return get_sharding_overrides(CASES[case][0])


def mesh_size(case: str, axis: str) -> int:
    return dict(zip(("data", "model"), MESH_SHAPES[CASES[case][2]]))[axis]


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


def _model_leaves(cfg, mesh, over: dict) -> dict:
    """The step's leaves by what it does with them over "model" (the rules
    with the overrides ``over``): the paths of the whole leaves it
    all-gathers over "model" (their spec puts "model" on a dim), of the
    local leaves (each rank its block) and of the partial ones (the
    gradient summed over "model")."""
    from repro_torch.launch import sharding as sh
    from repro_torch.train import sharded
    local, partial = sharded.leaf_roles(cfg, mesh, over)
    specs = named_specs(sh.model_pspecs(mesh, cfg, over))
    loc, part = named_leaves_of(local), named_leaves_of(partial)
    return {"gathered": sorted(k for k, sp in specs.items()
                               if not loc[k] and any(
                                   "model" in sh.entry_axes(e) for e in sp)),
            "local": sorted(k for k in loc if loc[k]),
            "partial": sorted(k for k in part if part[k])}


def named_specs(tree, prefix: str = "") -> dict:
    from repro_torch.launch.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(named_specs(v, f"{prefix}{k}/"))
    return out


def named_leaves_of(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves_of(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _by_axis(log: list, axis: str) -> dict:
    out = {"all_gather": 0, "all_reduce": 0, "all_to_all": 0,
           "reduce_scatter": 0}
    for kind, _, _, a in log:
        if a == axis:
            out[kind] += 1
    return out


def run_case(case: str, mesh, rank: int, out_dir: str) -> dict:
    from repro_torch.launch import sharding as sh
    from repro_torch.train import sharded

    cfg, params, opt, sched = inputs(case)
    over = overrides(case)
    state = opt.init(params)
    shardings = sharded.state_shardings(mesh, cfg, state, over)
    p, s = sh.distribute((params, state), shardings)
    step = sharded.make_sharded_train_step(cfg, opt, sched, mesh, over)
    res = {"placements_ok": [], "collectives": [], "metrics": [],
           "leaves": _model_leaves(cfg, mesh, over)}
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
    # the first step's gradient (from the same params), reduced as the step
    # reduces it, the local leaves' blocks gathered over "model"
    bt = batch(cfg, STEP_SEEDS[0])
    p0 = sh.distribute(params, shardings[0])
    db = sh.distribute(bt, sh.named(mesh, sh.batch_specs(mesh, cfg, bt)))
    with sh.recording() as log:
        _, _, grads = sharded.sharded_grads(cfg, mesh, p0, db, over)
    res["grads_over_model"] = _by_axis(log, "model")
    res["grads_over_data"] = [[kind, n] for kind, n, _, a in log
                              if a == "data"]
    res["blocks"] = {k: {"bytes": x.to_local().numel()
                         * x.to_local().element_size(),
                         "whole": x.numel() * x.element_size(),
                         "data_cut": "data" in sh.cut_axes(x)}
                     for k, x in named_leaves_of(p0).items()}
    grads = sharded.gather_local(grads, p0, shardings[0])
    save.update({f"g/{k}": v for k, v in named_leaves(grads).items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case}.npz"), **save)
    res["state"] = (p, s)
    return res


def run_adafactor(meshes: dict, rank: int) -> dict:
    """Adafactor's update on each rank's blocks (``means=`` from the
    sharded step's ``block_means``) against its update of the whole
    leaves, from the same whole gradient and state drawn once (both
    gathered): of each mesh, the worst error of the new params over each
    leaf's largest magnitude and the worst relative error of the state,
    element by element (its factored statistics are positive)."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import OptState
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.train import sharded

    cfg, params, opt, _ = inputs("kimi-k2-1t-a32b")
    g = torch.Generator().manual_seed(7)

    def draw(x, scale):
        return torch.randn(x.shape, generator=g) * scale
    grads = tree_map(lambda x: draw(x, 1e-2), params)
    state = opt.init(params)
    state = OptState(torch.tensor(3, dtype=torch.int32),
                     tree_map(lambda x: draw(x, 1e-3).abs(), state.inner))
    lr = torch.tensor(1e-3)
    want = opt.update(grads, state, params, lr)
    out = {}
    for name in ("mesh22", "mesh41"):
        mesh = meshes[name]
        p_sh, o_sh = sharded.state_shardings(mesh, cfg, state)
        p, s, gr = sh.distribute((params, state, grads), (p_sh, o_sh, p_sh))
        local = tree_map(lambda x: x.to_local(), (p, s, gr))
        means = sharded.block_means(p, mesh)
        new_p, new_s = opt.update(local[2], local[1], local[0], lr,
                                  means=means)
        got = sh.gather((tree_map(lambda x, sh_, old: sh.wrap(x, sh_,
                                                              old.shape),
                                  new_p, p_sh, p),
                         tree_map(lambda x, sh_, old: sh.wrap(x, sh_,
                                                              old.shape),
                                  new_s, o_sh, s)))
        new_p_got, new_p_want = leaves(got[0]), leaves(want[0])
        params_err = [float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(new_p_got, new_p_want)]
        state_err = [float(((a - b).abs() / b.abs()).max())
                     for a, b in zip(leaves(got[1].inner),
                                     leaves(want[1].inner))]
        out[name] = {"params_of_max": max(params_err),
                     "state_relative": max(state_err),
                     "steps": [int(got[1].step), int(want[1].step)],
                     "cut": sum(m is not None for m in leaves(means))}
    return out


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


# ------------------------------------------- the tensor-parallel modules
UNIT_B, UNIT_S = 2, 32
# attention layouts at 2 "model" ranks: (heads, KV heads, head dim) ->
# "whole" with its KV heads local, "whole" with one replicated KV head
# each rank slices, "whole" with 3 heads a rank over KV heads of 2 (rank 0
# reads KV heads 0, 0, 1: one KV head a query head, repeated), heads cut
# (3 heads of 16: 24 columns a rank)
UNIT_ATTENTION = {"attention-kv-local": (4, 2, 16),
                  "attention-kv-sliced": (4, 1, 16),
                  "attention-kv-repeated": (6, 3, 16),
                  "attention-heads-cut": (3, 1, 16)}
UNITS = ("swiglu",) + tuple(UNIT_ATTENTION) + ("loss-tied", "loss-untied",
                                               "embedding")


def _err(got, want) -> float:
    """max |got - want| over max |want|."""
    import torch
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()
                 / torch.clamp(want.abs().max(), min=1e-30))


def _unit_case(name: str, mesh, rank: int) -> dict:
    """One module tensor-parallel at ``mesh`` (1, 2) against its unsharded
    call on the same draw: the output and, from the same cotangent, the
    gradients of the input and of every weight (a local weight's against
    its block of the whole gradient; a whole weight's summed over "model"
    first when the module marks it partial)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers, model as tm
    from repro_torch.train import sharded

    g = torch.Generator().manual_seed(sum(map(ord, name)))
    m = 2

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              param_dtype=torch.float32,
                              activ_dtype=torch.float32, loss_chunk=CHUNK)
    d = cfg.d_model
    if name in UNIT_ATTENTION:
        h, kvh, hd = UNIT_ATTENTION[name]
        cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kvh,
                                  head_dim=hd)
    cfg = sharded.tp_config(cfg, mesh)
    tp = tm.tensor_parallel(cfg, mesh)
    x = rnd(UNIT_B, UNIT_S, d)
    pos = torch.arange(UNIT_S).expand(UNIT_B, UNIT_S)
    if name == "swiglu":
        w = {"w_gate": rnd(d, 128, scale=0.1), "w_up": rnd(d, 128, scale=0.1),
             "w_down": rnd(128, d, scale=0.1)}
        cut = {"w_gate": -1, "w_up": -1, "w_down": 0}
        partial = set()

        def run(w, x, tp):
            return layers.swiglu(x, w["w_gate"], w["w_up"], w["w_down"],
                                 tp=tp)
    elif name in UNIT_ATTENTION:
        h, kvh, hd = UNIT_ATTENTION[name]
        w = {"wq": rnd(d, h * hd, scale=0.1), "wk": rnd(d, kvh * hd, scale=0.1),
             "wv": rnd(d, kvh * hd, scale=0.1), "wo": rnd(h * hd, d, scale=0.1),
             "bq": rnd(h * hd, scale=0.1), "bk": rnd(kvh * hd, scale=0.1),
             "bv": rnd(kvh * hd, scale=0.1)}
        roles = {k.split(".")[-1]: r for k, r in tm.tp_roles(cfg, m).items()
                 if k.startswith("blocks.")}
        cut = {k: (0 if k == "wo" else -1) for k, r in roles.items()
               if r == "local"}
        partial = {k for k, r in roles.items() if r == "partial"}

        def run(w, x, tp):
            return layers.attention_block(
                x, layers.AttnParams(**w), n_heads=h, n_kv_heads=kvh,
                head_dim=hd, positions=pos, rope_theta=cfg.rope_theta,
                block_k=CHUNK, tp=tp)
    elif name.startswith("loss"):
        tied = name == "loss-tied"
        cfg = dataclasses.replace(cfg, tie_embeddings=tied)
        key = "embed" if tied else "lm_head"
        w = {key: rnd(*((cfg.vocab_size, d) if tied
                        else (d, cfg.vocab_size)), scale=0.5)}
        cut = {key: 0 if tied else -1}
        partial = set()
        labels = torch.randint(0, cfg.vocab_size, (UNIT_B, UNIT_S),
                               generator=g)
        mask = (torch.rand((UNIT_B, UNIT_S), generator=g) > 0.2).float()

        def run(w, x, tp):
            tot, cnt = tm.loss_terms(w, cfg, x, labels, mask,
                                     mesh=mesh if tp else None)
            return torch.stack([tot, cnt])
    else:
        w = {"embed": rnd(cfg.vocab_size, d)}
        cut = {"embed": 0}
        partial = set()
        tokens = torch.randint(0, cfg.vocab_size, (UNIT_B, UNIT_S),
                               generator=g)

        def run(w, x, tp):
            return tm.embed_inputs(w, cfg, tokens, mesh=mesh if tp else None)
    if tp is None:
        raise AssertionError(f"{name}: no tensor parallelism at {mesh}")

    def leaves_of(w, x):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        return ws, x.clone().requires_grad_(True)

    ws, xs = leaves_of(w, x)
    want = run(ws, xs, None)
    cot = torch.randn(want.shape, generator=g)
    want_g = torch.autograd.grad((want * cot).sum(), [xs, *ws.values()],
                                 allow_unused=True, materialize_grads=True)
    blocks = {k: (v.chunk(m, cut[k])[rank] if k in cut else v)
              for k, v in w.items()}
    wl, xl = leaves_of(blocks, x)
    got = run(wl, xl, tp)
    got_g = torch.autograd.grad((got * cot).sum(), [xl, *wl.values()],
                                allow_unused=True, materialize_grads=True)
    errs = {"out": _err(got, want), "x": _err(got_g[0], want_g[0])}
    for k, gg, wg in zip(w, got_g[1:], want_g[1:]):
        if k in partial:
            sh.all_reduce(gg, mesh, ("model",))
        if k in cut:
            wg = wg.chunk(m, cut[k])[rank]
        errs[k] = _err(gg, wg)
    return {"errors": errs, "local": sorted(cut), "partial": sorted(partial),
            "heads": tp.heads, "kv": tp.kv}


# the MoE expert FFN on each rank's block of d_expert at 2 "model" ranks
# (Mixtral's smoke widths: 4 experts of 64, top 2): at capacity factor 8
# (no drops) and at 0.5 (16 slots an expert for 128 routed pairs: experts
# overflow)
MOE_UNITS = {"moe-experts": 8.0, "moe-experts-drops": 0.5}


def _moe_unit_case(name: str, mesh, rank: int) -> dict:
    """``moe_block`` tensor parallel over "model" (``tp.experts``: each
    rank's ``Fe / 2`` columns of ``w_gate`` / ``w_up`` and rows of
    ``w_down``) against its unsharded call on the same draw: the output
    and, from the same cotangent plus the balance loss (so a balance
    loss counted once a rank would show in the router's gradient), the
    gradients of the input, the router (whole) and each expert leaf (its
    block of the whole gradient); the counts and dropped pairs of each."""
    import torch
    from repro_torch.configs import get_smoke_config, get_sharding_overrides
    from repro_torch.models import model as tm
    from repro_torch.models.moe import MoEParams, moe_block
    from repro_torch.train import sharded

    g = torch.Generator().manual_seed(sum(map(ord, name)))
    m = 2
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              param_dtype=torch.float32,
                              activ_dtype=torch.float32)
    cfg = sharded.tp_config(cfg, mesh, get_sharding_overrides(
        "mixtral-8x22b"))
    tp = tm.tensor_parallel(cfg, mesh)
    if tp is None or not tp.experts:
        raise AssertionError(f"{name}: no expert tensor parallelism: {tp}")
    d, e, fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale
    w = {"router": rnd(d, e, scale=0.3), "w_gate": rnd(e, d, fe, scale=0.1),
         "w_up": rnd(e, d, fe, scale=0.1), "w_down": rnd(e, fe, d, scale=0.1)}
    cut = {"w_gate": -1, "w_up": -1, "w_down": 1}
    x = rnd(UNIT_B, UNIT_S, d)
    cot = rnd(UNIT_B, UNIT_S, d)

    def run(w, tp):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        xs = x.clone().requires_grad_(True)
        out, aux = moe_block(xs, MoEParams(**ws, shared_w_gate=None,
                                           shared_w_up=None,
                                           shared_w_down=None),
                             top_k=cfg.moe.top_k,
                             capacity_factor=MOE_UNITS[name],
                             mesh=mesh if tp else None, tp=tp)
        grads = torch.autograd.grad((out * cot).sum() + aux["aux_loss"],
                                    [xs, *ws.values()])
        return out, aux, dict(zip(["x", *ws], grads))
    want, want_aux, want_g = run(w, None)
    blocks = {k: (v.chunk(m, cut[k])[rank] if k in cut else v)
              for k, v in w.items()}
    got, got_aux, got_g = run(blocks, tp)
    errs = {"out": _err(got, want)}
    for k in got_g:
        wg = want_g[k].chunk(m, cut[k])[rank] if k in cut else want_g[k]
        errs[k] = _err(got_g[k], wg)
    return {"errors": errs, "local": sorted(cut), "partial": [],
            "block_shapes": {k: list(v.shape) for k, v in blocks.items()},
            "counts": got_aux["counts"].tolist(),
            "counts_equal": torch.equal(got_aux["counts"],
                                        want_aux["counts"]),
            "dropped": got_aux["dropped"].tolist(),
            "dropped_equal": torch.equal(got_aux["dropped"],
                                         want_aux["dropped"]),
            "n_dropped": int(want_aux["dropped"].sum()),
            "heads": tp.heads, "kv": tp.kv}


# RWKV-6's and Mamba2's mixes at 2 "model" ranks: unit -> (arch, config
# changes).  RWKV-6 at d 128 (2 heads: one a rank, the rank's blocks of
# wr / wk / wv / wg its heads) and d 192 (3 heads: 2 / 1, the weights
# whole and sliced); its channel mix (d_ff 256: 128 columns a rank);
# Mamba2 at d 128 (4 heads: 2 a rank, out_proj's block its rows) and d 96
# (3 heads: 2 / 1, out_proj whole and sliced)
RECURRENT_UNITS = {
    "rwkv6-time-mix": ("rwkv6-3b", {}),
    "rwkv6-time-mix-cut": ("rwkv6-3b", {"d_model": 192, "n_heads": 3}),
    "rwkv6-channel-mix": ("rwkv6-3b", {}),
    "mamba2-mix": ("zamba2-2.7b", {}),
    "mamba2-mix-cut": ("zamba2-2.7b", {"d_model": 96})}


def _recurrent_unit_case(name: str, mesh, rank: int) -> dict:
    """A recurrent mix on each rank's heads at ``mesh`` (1, 2) against its
    unsharded call on the same draw (layer 0's leaves of the smoke
    config, every leaf drawn): from the same cotangents of the output and
    of the final state (the rank's heads' slice of it), the output, the
    rank's heads' final state and the gradients of the input and of every
    leaf the mix reads (a local leaf's against its block of the whole
    gradient, a partial one's summed over "model" first)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import mamba2, rwkv6, model as tm
    from repro_torch.models.layers import head_share
    from repro_torch.train import sharded

    arch, changes = RECURRENT_UNITS[name]
    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype=torch.float32,
                              activ_dtype=torch.float32, **changes)
    cfg = sharded.tp_config(cfg, mesh)
    tp = tm.tensor_parallel(cfg, mesh)
    m = tp.size
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    layer = {k: torch.from_numpy(v[0]) for k, v in
             perturbed_tree(tm.iter_schema(cfg))["blocks"].items()}
    rules = sh.default_rules(mesh, cfg)
    cut = {}
    for path, spec in tm.iter_schema(cfg):
        key = path.split(".")[-1]
        dims = [d for d, a in enumerate(spec.logical_axes[1:])
                if rules.get(a) == "model"]
        if path.startswith("blocks.") and dims:
            cut[key] = dims[0]
    roles = {k.split(".")[-1]: r for k, r in tm.tp_roles(cfg, m).items()}
    if name.startswith("rwkv6-time"):
        fields, heads = tm.RWKV6Params._fields, cfg.d_model // 64

        def run(w, x, tp):
            return rwkv6.rwkv6_mix(x, tm.RWKV6Params(**w), n_heads=heads,
                                   tp=tp)
    elif name.startswith("rwkv6-channel"):
        fields, heads = ["f_" + f for f in tm.RWKV6FFNParams._fields], 0

        def run(w, x, tp):
            return rwkv6.rwkv6_channel_mix(x, tm.RWKV6FFNParams(
                *(w["f_" + f] for f in tm.RWKV6FFNParams._fields)),
                tp), None
    else:
        fields, heads = tm.Mamba2Params._fields, cfg.mamba_heads

        def run(w, x, tp):
            return mamba2.mamba2_mix(x, tm.Mamba2Params(**w),
                                     d_inner=cfg.d_inner, n_heads=heads,
                                     d_state=cfg.ssm_state, tp=tp)
    w = {k: layer[k] for k in fields}
    local = {k for k in w if roles.get(k) == "local"}
    partial = {k for k in w if roles.get(k) == "partial"}
    x = torch.randn(UNIT_B, UNIT_S, cfg.d_model, generator=g)
    first, count = head_share(heads, m, rank) if heads else (0, 0)

    def grads(w, x, tp):
        ws = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        xs = x.clone().requires_grad_(True)
        out, state = run(ws, xs, tp)
        loss = (out * cot).sum()
        if state is not None:
            whole = cot_state if tp is None \
                else cot_state[:, first:first + count]
            loss = loss + (state * whole).sum()
        return out, state, torch.autograd.grad(loss, [xs, *ws.values()])
    cot = torch.randn(UNIT_B, UNIT_S, cfg.d_model, generator=g)
    _, state_shape = run(w, x, None)
    cot_state = None if state_shape is None else torch.randn(
        state_shape.shape, generator=g)
    want, want_state, want_g = grads(w, x, None)
    blocks = {k: v.chunk(m, cut[k])[rank] if k in local else v
              for k, v in w.items()}
    got, got_state, got_g = grads(blocks, x, tp)
    errs = {"out": _err(got, want), "x": _err(got_g[0], want_g[0])}
    if want_state is not None:
        errs["state"] = _err(got_state,
                             want_state[:, first:first + count]) \
            if count else float(got_state.numel())
    for k, gg, wg in zip(w, got_g[1:], want_g[1:]):
        if k in partial:
            sh.all_reduce(gg, mesh, ("model",))
        if k in local:
            wg = wg.chunk(m, cut[k])[rank]
        errs[k] = _err(gg, wg)
    return {"errors": errs, "local": sorted(local), "partial": sorted(partial),
            "whole": sorted(set(w) - local - partial), "mix": tp.mix,
            "ffn": tp.ffn, "heads": [first, count],
            "state_shape": None if got_state is None
            else list(got_state.shape)}


def run_units(meshes: dict, rank: int) -> dict:
    out = {name: _unit_case(name, meshes["mesh12"], rank) for name in UNITS}
    out.update({name: _moe_unit_case(name, meshes["mesh12"], rank)
                for name in MOE_UNITS})
    out.update({name: _recurrent_unit_case(name, meshes["mesh12"], rank)
                for name in RECURRENT_UNITS})
    return out


# ------------------------------------- one "model" rank: the step as it was
DIGEST_CASES = ("qwen2-0.5b", "kimi-k2-1t-a32b", "rwkv6-3b", "zamba2-2.7b")


def digest_platform() -> str:
    """What the digests' float32 bytes depend on besides the program: the
    torch build and the CPU's instruction set (one thread)."""
    import platform
    import torch
    return (f"torch {torch.__version__} {platform.machine()} "
            f"{torch.backends.cpu.get_cpu_capability()}")


def step_digest(case: str, mesh) -> tuple:
    """(sha256 of two steps of ``case``, their metrics, the gathered state
    after each step and the first step's gradient as ``run_case`` saves
    them) with ``mesh`` None the single-device ``make_train_step``, else
    the sharded step on it.  The hash covers every leaf of the params and
    optimizer state after each step and the metrics' bytes, in named
    order."""
    import hashlib
    from repro_torch.launch import sharding as sh
    from repro_torch.train import sharded
    from repro_torch.train.steps import loss_and_grads, make_train_step

    cfg, params, opt, sched = inputs(case)
    state = opt.init(params)
    bt = batch(cfg, STEP_SEEDS[0])
    if mesh is None:
        step = make_train_step(cfg, opt, sched)
        grads = loss_and_grads(params, cfg, bt)[2]
    else:
        shardings = sharded.state_shardings(mesh, cfg, state)
        params, state = sh.distribute((params, state), shardings)
        db = sh.distribute(bt, sh.named(mesh, sh.batch_specs(mesh, cfg, bt)))
        _, _, grads = sharded.sharded_grads(cfg, mesh, params, db)
        grads = sharded.gather_local(grads, params, shardings[0])
        step = sharded.make_sharded_train_step(cfg, opt, sched, mesh)
    h = hashlib.sha256()
    save = {f"g/{k}": v for k, v in named_leaves(grads).items()}
    metrics = []
    for i, seed in enumerate(STEP_SEEDS, 1):
        bt = batch(cfg, seed)
        if mesh is not None:
            bt = sh.distribute(bt, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                                 bt)))
        params, state, m = step(params, state, bt)
        tree = (params, state) if mesh is None else sh.gather((params,
                                                               state))
        named = named_leaves({"p": tree[0], "s": tree[1]})
        for k, v in sorted(named.items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).tobytes())
        for k in sorted(m):
            h.update(k.encode())
            h.update(m[k].detach().cpu().numpy().tobytes())
        save.update({f"{k[0]}{i}{k[1:]}": v for k, v in named.items()})
        metrics.append(_metrics(m))
    return h.hexdigest(), metrics, save


def run_digest(meshes: dict, out_dir: str) -> dict:
    """Each digest case without a mesh and at the (1, 1) mesh: the
    digests and metrics; ``digest-<case>.npz`` holds the (1, 1) run's
    arrays."""
    out = {"platform": digest_platform()}
    for case in DIGEST_CASES:
        out[case] = {}
        for name, mesh in (("meshless", None), ("mesh11", meshes["mesh11"])):
            digest, metrics, save = step_digest(case, mesh)
            out[case][name] = {"digest": digest, "metrics": metrics}
        np.savez(os.path.join(out_dir, f"digest-{case}.npz"), **save)
    return out


def worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, N_RANKS),
                            rank=rank, world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import make_mesh

    meshes = {"mesh22": make_mesh((2, 2), ("data", "model"), device="cpu"),
              "mesh14": make_mesh((1, 4), ("data", "model"), device="cpu"),
              "mesh41": make_mesh((4, 1), ("data", "model"), device="cpu"),
              "mesh12": make_mesh((1, 2), ("data", "model"), device="cpu"),
              "mesh11": make_mesh((1, 1), ("data", "model"), device="cpu"),
              "data4": make_mesh((4,), ("data",), device="cpu"),
              "pod_data": make_mesh((2, 2), ("pod", "data"), device="cpu"),
              "data_pod": make_mesh((2, 2), ("data", "pod"), device="cpu"),
              "data2": make_mesh((2,), ("data",), device="cpu")}
    name = "setup"
    try:
        first = None
        for name in CASES:
            res = run_case(name, meshes[CASES[name][2]], rank, out_dir)
            state = res.pop("state")
            first = first or state
            _write(out_dir, name, rank, res)
        name = "restore"
        _write(out_dir, name, rank, run_restore(first, meshes, rank,
                                                out_dir))
        name = "adafactor"
        _write(out_dir, name, rank, run_adafactor(meshes, rank))
        name = "major_first"
        _write(out_dir, name, rank, run_major_first(meshes, rank))
        name = "constrain"
        if rank < 2:
            _write(out_dir, name, rank, run_constrain(meshes, rank))
        name = "units"
        if rank < 2:
            _write(out_dir, name, rank, run_units(meshes, rank))
        name = "digest"
        if rank == 0:
            _write(out_dir, name, rank, run_digest(meshes, out_dir))
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def _write(out_dir: str, name: str, rank: int, res: dict) -> None:
    with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
        json.dump(res, f, sort_keys=True)
