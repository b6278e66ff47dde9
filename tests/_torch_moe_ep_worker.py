"""Worker side of ``tests/test_torch_moe_ep.py``: one process per rank of a
4-rank gloo group, importing only ``repro_torch``; and the port's
single-device per-group MoE (:func:`per_group_moe`), which the parent
patches into ``models.model`` for its comparators.

Every rank builds the meshes of the module, (1, 2), (2, 2) and (1, 4)
("data", "model") (subgroups of the one group), then runs every case:

* ``model-<cf>``: ``forward`` and ``engine.prefill`` of the kimi-k2 smoke
  model at (2, 2) with ``moe_groups=(2, 2)``, ``moe_expert_sharded``,
  each rank its batch slice and its block of experts;
* ``train-<opt>-<cf>``: two sharded train steps at (2, 2) with expert
  parallelism; rank 0 writes the gathered state after each step, every
  rank the metrics, the placements, and the collectives of each step
  (counted, and each call's kind, bytes, group size and axis);
* ``block-<mesh>-<cf>``: the kimi-k2 smoke ``moe_block`` on the expert-
  parallel path, its inputs read from ``block.npz`` (which the parent
  writes with its oracle meanwhile); each rank of the mesh writes its
  output, counts, dropped pairs and the collectives of the call.

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
ARCH = "kimi-k2-1t-a32b"
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
FACTORS = (1.25, 8.0)
B, S, CHUNK = 4, 32, 16
LR = (1e-3, 10, 100)            # peak, warmup, total: lr(1) = 1e-4
STEP_SEEDS = (1, 2)
OPTIMIZERS = ("adamw", "adafactor")


def config(capacity_factor: float, groups=None):
    """The kimi-k2 smoke config in float32 (S 32 in two loss chunks and two
    attention blocks) at ``capacity_factor``; with ``groups`` on the
    expert-parallel path."""
    import torch
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(ARCH)
    cfg = dataclasses.replace(
        cfg, param_dtype=torch.float32, activ_dtype=torch.float32,
        loss_chunk=CHUNK, attn_block_k=CHUNK,
        moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    if groups is not None:
        cfg = dataclasses.replace(cfg, moe_groups=tuple(groups),
                                  moe_expert_sharded=True)
    return cfg


def params(cfg, device="cpu"):
    import torch
    from repro_torch.models.model import iter_schema
    from repro_torch.pytree import tree_map
    return tree_map(lambda a: torch.from_numpy(a).to(device),
                    perturbed_tree(iter_schema(cfg)))


def batch(cfg, seed: int, device="cpu") -> dict:
    import torch
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(device)
        for k in ("tokens", "labels")}


def block_inputs() -> dict:
    """``moe_block``'s inputs at the smoke widths (D 64, E 8, top 2, one
    shared expert): x N(0, 1), a router of std 0.3 (peaked routing, so
    experts overflow at capacity factor 1.25), the expert and shared
    weights at their init scale."""
    rng = np.random.default_rng(7)
    d, e, fe = 64, 8, 64

    def w(*shape):
        return rng.normal(0.0, shape[-2] ** -0.5, shape).astype(np.float32)
    return {"x": rng.normal(0.0, 1.0, (B, S, d)).astype(np.float32),
            "router": rng.normal(0.0, 0.3, (d, e)).astype(np.float32),
            "w_gate": w(e, d, fe), "w_up": w(e, d, fe), "w_down": w(e, fe, d),
            "shared_w_gate": w(d, fe), "shared_w_up": w(d, fe),
            "shared_w_down": w(fe, d)}


def ep_capacity(t_l: int, top_k: int, cf: float, e: int, gm: int) -> int:
    """The reference's local capacity (``repro/models/moe.py:190-193``)."""
    c = max(int(t_l * top_k * cf / e), 2)
    return -(-c // gm) * gm


def per_group_moe(groups):
    """``moe_block``'s signature, computing on one device the function the
    expert-parallel path computes over a mesh of ``groups``: the router,
    counts and balance loss over the whole batch, each of the gd x gm
    groups (batch slice i, sequence slice j) dispatched on its own at the
    local capacity through the port's ``_dispatch_local`` /
    ``_expert_ffn`` / ``_combine_local`` with all the experts, the shared
    expert on the whole ``x``.  ``aux["dropped"]`` is (B, S, k), the
    groups' drops in place."""
    import torch
    from repro_torch.models import moe as tmoe
    gd, gm = groups

    def block(x, p, *, top_k, capacity_factor=1.25, **_):
        b, s, d = x.shape
        e = p.router.shape[1]
        probs, topw, tope = tmoe._route(x, p.router, top_k)
        counts = torch.sum(tope.reshape(-1)[:, None]
                           == torch.arange(e, device=x.device), dim=0,
                           dtype=torch.int32)
        f_e = counts.to(torch.float32) / float(max(b * s * top_k, 1))
        aux_loss = e * torch.sum(f_e * probs.mean((0, 1)))
        bl, sl = b // gd, s // gm
        cap = ep_capacity(bl * sl, top_k, capacity_factor, e, gm)
        rows, drops = [], []
        for i in range(gd):
            cols, dcols = [], []
            for j in range(gm):
                at = (slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl))
                flat_e = tope[at].reshape(-1)
                x_buf, pos = tmoe._dispatch_local(
                    x[at].reshape(bl * sl, d), flat_e, top_k, e, cap)
                y = tmoe._expert_ffn(x_buf, p.w_gate, p.w_up, p.w_down)
                cols.append(tmoe._combine_local(
                    y, pos, flat_e, topw[at].reshape(bl * sl, top_k),
                    cap).reshape(bl, sl, d))
                dcols.append((pos >= cap).reshape(bl, sl, top_k))
            rows.append(torch.cat(cols, 1))
            drops.append(torch.cat(dcols, 1))
        out = torch.cat(rows, 0)
        if p.shared_w_gate is not None:
            out = out + tmoe._shared_ffn(x, p)
        return out, {"counts": counts, "aux_loss": aux_loss,
                     "dropped": torch.cat(drops, 0)}
    return block


def one_device_steps(opt_name: str, cf: float, groups=None,
                     device="cpu"):
    """Two single-device ``make_train_step`` steps of the port on the
    module's inputs, each MoE layer per group when ``groups`` is given ->
    (named state arrays after each step, metrics, the dropped pairs of
    each MoE call)."""
    from repro_torch.models import model as tm
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.train.steps import make_train_step
    cfg = config(cf)
    opt = get_optimizer(opt_name)
    step = make_train_step(cfg, opt, cosine_schedule(*LR))
    prm = params(cfg, device)
    state = opt.init(prm)
    real, drops = tm.moe_block, []
    if groups is not None:
        block = per_group_moe(groups)

        def counted(*a, **kw):
            out, aux = block(*a, **kw)
            drops.append(int(aux["dropped"].sum()))
            return out, aux
        tm.moe_block = counted
    out, metrics = {}, []
    try:
        for i, seed in enumerate(STEP_SEEDS, 1):
            prm, state, m = step(prm, state, batch(cfg, seed, device))
            out.update({f"p{i}/{k}": v
                        for k, v in named_leaves(prm).items()})
            out.update({f"s{i}/{k}": v
                        for k, v in named_leaves(state).items()})
            metrics.append({k: v.cpu().numpy() for k, v in m.items()})
    finally:
        tm.moe_block = real
    return out, metrics, drops


def named_leaves(tree, prefix: str = "") -> dict:
    """``{"a/b": numpy}`` of a tree of dicts and namedtuples."""
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


def _delta(before: dict) -> dict:
    from repro_torch.launch import sharding as sh
    return {k: sh.COLLECTIVES[k] - before[k] for k in before}


def _slices(mesh, gd: int, gm: int):
    """(this rank's batch slice, its expert block) of the module's B and
    the smoke config's 8 experts."""
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    e = 8 // gm
    return slice(i * B // gd, (i + 1) * B // gd), slice(j * e, (j + 1) * e)


def run_block(mesh, shape, cf: float, inputs: dict) -> dict:
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.models.moe import MoEParams, moe_block
    gd, gm = shape
    bsl, esl = _slices(mesh, gd, gm)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    p = MoEParams(t["router"], t["w_gate"][esl], t["w_up"][esl],
                  t["w_down"][esl], t["shared_w_gate"], t["shared_w_up"],
                  t["shared_w_down"])
    before = dict(sh.COLLECTIVES)
    out, aux = moe_block(t["x"][bsl], p, top_k=2, capacity_factor=cf,
                         groups=shape, batch_axes=("data",), mesh=mesh,
                         expert_sharded=True)
    return {"out": out, "counts": aux["counts"], "dropped": aux["dropped"],
            "aux_loss": aux["aux_loss"], "collectives": _delta(before)}


def run_model(mesh, cf: float) -> dict:
    from repro_torch.models.model import forward
    from repro_torch.serve import engine
    cfg = dataclasses.replace(config(cf, (2, 2)), act_batch_axes=("data",))
    bsl, esl = _slices(mesh, 2, 2)
    p = params(cfg)
    for k in ("e_gate", "e_up", "e_down"):
        p["blocks"][k] = p["blocks"][k][:, esl].contiguous()
    toks = batch(cfg, 5)["tokens"][bsl]
    hidden, aux = forward(p, cfg, tokens=toks, mesh=mesh)
    logits, cache = engine.prefill(p, cfg, tokens=toks, mesh=mesh)
    return {"hidden": hidden, "expert_counts": aux["expert_counts"],
            "moe_aux_loss": aux["moe_aux_loss"], "logits": logits,
            "k": cache["k"], "v": cache["v"]}


def run_train(mesh, opt_name: str, cf: float, rank: int, out_dir: str,
              case: str, groups=(2, 2), device="cpu") -> dict:
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.train import sharded

    cfg = config(cf, groups)
    opt = get_optimizer(opt_name)
    prm = params(cfg, device)
    state = opt.init(prm)
    shardings = sharded.state_shardings(mesh, cfg, state)
    p, s = sh.distribute((prm, state), shardings)
    step = sharded.make_sharded_train_step(cfg, opt, cosine_schedule(*LR),
                                           mesh)
    res = {"placements_ok": [], "collectives": [], "metrics": [],
           "log": []}
    save = {}
    for i, seed in enumerate(STEP_SEEDS, 1):
        bt = batch(cfg, seed, device)
        db = sh.distribute(bt, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                             bt)))
        before = dict(sh.COLLECTIVES)
        with sh.recording() as log:
            p, s, m = step(p, s, db)
        res["collectives"].append(_delta(before))
        res["log"].append([list(e) for e in log])
        res["placements_ok"].append(leaves(tree_map(
            lambda x, sh_: tuple(x.placements) == sh_.placements,
            (p, s), shardings)))
        res["metrics"].append({k: v.tolist() for k, v in m.items()})
        full_p, full_s = sh.gather((p, s))
        save.update({f"p{i}/{k}": v
                     for k, v in named_leaves(full_p).items()})
        save.update({f"s{i}/{k}": v
                     for k, v in named_leaves(full_s).items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case}.npz"), **save)
    return res


def _save(out_dir: str, name: str, rank: int, res: dict) -> None:
    """Tensors to ``<name>.<rank>.npz``, the rest to ``.json``."""
    arrays = {k: v.detach().cpu().numpy() for k, v in res.items()
              if hasattr(v, "detach")}
    np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
        json.dump({k: v for k, v in res.items() if k not in arrays}, f,
                  sort_keys=True)


def _block_file(out_dir: str, wait_s: float = 120.0) -> dict:
    """``moe_block``'s inputs from ``block.npz``, which the parent writes
    (with its oracle) while the ranks run the other cases."""
    import time
    path = os.path.join(out_dir, "block.npz")
    end = time.monotonic() + wait_s
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {wait_s} s")
        time.sleep(0.05)
    with np.load(path) as z:
        return {k: z[k] for k in block_inputs()}


def worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, N_RANKS),
                            rank=rank, world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import make_mesh

    meshes = {name: make_mesh(shape, ("data", "model"), device="cpu")
              for name, shape in MESHES.items()}
    name = "setup"
    try:
        for cf in FACTORS:
            name = f"model-{cf}"
            _save(out_dir, name, rank, run_model(meshes["2x2"], cf))
        for opt_name in OPTIMIZERS:
            for cf in FACTORS:
                name = f"train-{opt_name}-{cf}"
                res = run_train(meshes["2x2"], opt_name, cf, rank, out_dir,
                                name)
                with open(os.path.join(out_dir, f"{name}.{rank}.json"),
                          "w") as f:
                    json.dump(res, f, sort_keys=True)
        name = "block-inputs"
        inputs = _block_file(out_dir)
        for mname, shape in MESHES.items():
            for cf in FACTORS:
                name = f"block-{mname}-{cf}"
                if rank < shape[0] * shape[1]:
                    _save(out_dir, name, rank,
                          run_block(meshes[mname], shape, cf, inputs))
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def cuda_train_worker(rank: int, store_path: str, out_dir: str) -> None:
    """One of 2 gloo ranks on the one card (NCCL takes one rank a device):
    ``run_train`` at a (1, 2) ("data", "model") mesh of CUDA tensors, with
    AdamW and with Adafactor at the config's capacity factor, each case
    written as :func:`worker` writes it (``tests/test_torch_cuda.py``)."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import make_mesh

    name = "setup"
    try:
        mesh = make_mesh((1, 2), ("data", "model"))
        for opt_name in OPTIMIZERS:
            name = f"cuda-train-{opt_name}"
            res = run_train(mesh, opt_name, 1.25, rank, out_dir, name,
                            groups=(1, 2), device=dev)
            with open(os.path.join(out_dir, f"{name}.{rank}.json"),
                      "w") as f:
                json.dump(res, f, sort_keys=True)
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()
