"""Multi-pod dry run: count every (arch x shape x mesh) cell's step without
running it (the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted step on 512 fake host
devices over ``ShapeDtypeStruct`` inputs and reads XLA's memory and cost
analyses and the HLO's collectives.  An eager PyTorch program has no HLO,
so the port runs its OWN step on ``meta`` tensors (shapes and dtypes, no
storage) as one rank, rank 0, of a fake process group the size of the
production mesh, and counts what that rank's program does:

* ``executed.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total
  plus the work the ``flash_attention`` kernels would do: on meta tensors
  the forward's and the backward's wrappers check their inputs, return
  meta outputs and record the call (``kernels.flash_attention.kernel``'s
  ``META_CALLS`` and ``BWD_META_CALLS``), and each call is charged
  ``kernel.charge`` (4 · d · B·H · the pairs the mask keeps) or
  ``kernel.bwd_charge`` (10 · d · B·H · the pairs);
* ``executed.hbm_bytes``: the tensor inputs and outputs of every aten op
  that is not a view (nor an allocation alone), plus the kernels' own
  bytes (q, k, v read once, the output written once; the backward's q, k,
  v, dO read and dq, dk, dv written once);
* ``executed.collective_*``: the collectives counted at the port's call
  sites (``launch.sharding.recording``), by the reference's kind, wire
  bytes from ``hloanalysis.wire_bytes`` at each call's group size;
* ``memory``: ``argument_bytes`` the rank's local inputs, ``peak_bytes``
  the largest sum of live meta storages during the trace (arguments
  included), ``temp_bytes`` the difference, ``output_bytes`` the output's.

Nothing runs on a device, so the entry points' device rule ("cuda" unless
the caller asks for the CPU) has nothing to act on: the mesh is a
``"cpu"`` DeviceMesh over the fake group and every tensor is on ``meta``.
The library functions never start a process group (as ``launch.mesh``);
:func:`main` starts the fake group of 512 ranks when none is running, the
counterpart of the reference's ``XLA_FLAGS`` line.

Each cell's step is what the port's program runs, which is not what GSPMD
would compile:

* **train**: ``train.sharded.make_sharded_train_step``, FSDP over "data"
  and tensor parallel over "model" (the batch split over the batch axes;
  each leaf the rank's block at rest, all-gathered inside the block that
  reads it and again in its recompute, its gradient reduce-scattered over
  "data" and Adafactor's state updated on the rank's blocks; the
  attention's q / o and its k / v where the rules split them, the dense
  MLP, the embedding and the loss's head on the rank's block over
  "model", the attention at the rank's heads, two all-reduces over
  "model" a block; where the rules cut through a head, the projections on
  the rank's columns and the attention on all heads; MoE layers
  single-program or expert parallel, rwkv6's and Mamba2's blocks whole on
  every rank, gathered block by block);
* **prefill** and **decode**: ``serve.engine.prefill(mesh=)`` /
  ``decode_step(mesh=)``, sharded serving on the reference's layouts
  (``serve.sharded``): the params laid out by ``model_pspecs`` as the
  train cell's (each leaf the rank's block, gathered inside the block
  that reads it; the attention, the dense MLP, the embedding and the head
  on the rank's blocks over "model", the attention at its heads), the
  cache by ``cache_pspecs`` (the decode cell's an argument, the prefill
  cell's its output), the rank's slice of the batch; prefill's MoE layers
  on the step's groups (expert parallel where the rules put the experts
  on "model"), decode's on the whole batch's routing with each rank's
  experts' slots (or the layer's experts gathered at use); rwkv6's and
  Mamba2's blocks whole on every rank, their states the rank's block
  over "model".  ``long_500k``'s batch of 1 does not split: the cache's
  sequence takes the batch axes too, and a decode step combines the
  ranks' slices of it.

The reference's ``--save-hlo`` is not ported: there is no HLO to save.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config, get_sharding_overrides
from ..kernels.flash_attention import kernel as fa_kernel
from ..models.model import ModelConfig, abstract_params
from ..optim import cosine_schedule, get_optimizer
from ..pytree import leaves, tree_map
from ..serve import engine
from ..serve.sharded import serve_config
from ..train.sharded import make_sharded_train_step, state_shardings
from . import hloanalysis
from . import sharding as sh
from .mesh import make_production_mesh
from .shapes import SHAPES, applicable, input_specs

__all__ = ["FAKE_WORLD", "build_step", "collective_bytes", "count_step",
           "get_optimizer_name_from_cfg", "main", "run_cell", "step_config"]

# the fake group's ranks: two pods of 16 x 16 (the reference's 512 host
# devices)
FAKE_WORLD = 512

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s32": 4, "u32": 4,
                "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8, "f8e4m3": 1,
                "f8e5m2": 1, "s16": 2, "u16": 2}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# launch.sharding's counted kinds -> the reference's
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "all_to_all": "all-to-all", "reduce_scatter": "reduce-scatter"}


def _shape_bytes(hlo_type: str) -> int:
    """bytes of an HLO shape string like 'bf16[256,4096,3072]{2,1,0}'."""
    m = re.match(r"([a-z0-9]+)\[([\d,]*)\]", hlo_type)
    if not m:
        return 0
    dt, dims = m.group(1), m.group(2)
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def collective_bytes(hlo_text: str) -> dict:
    """Sum output-shape bytes of every collective op in the optimized HLO.
    Tuple shapes contribute each element (the reference's function, for
    HLO text; the dry run's own records count the port's collectives)."""
    out = {c: 0 for c in _COLLECTIVES}
    count = {c: 0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # matches:  %name = TYPE all-gather(...)  /  ... = (T1, T2) all-reduce(
        m = re.match(r"%?[\w.\-]+\s*=\s*(\(?[^=]*?\)?)\s+([a-z\-]+)\(", stripped)
        if not m:
            continue
        op = m.group(2)
        if op.rstrip("-start") in _COLLECTIVES or op in [c + "-start" for c in _COLLECTIVES] or op in _COLLECTIVES:
            base = op[:-6] if op.endswith("-start") else op
            if base not in _COLLECTIVES:
                continue
            types = re.findall(r"[a-z0-9]+\[[\d,]*\]", m.group(1))
            total = sum(_shape_bytes(t) for t in types)
            out[base] += total
            count[base] += 1
    return {"bytes": out, "count": count,
            "total_bytes": int(sum(out.values()))}


def get_optimizer_name_from_cfg(cfg) -> str:
    # adafactor for the 1T cell (see configs/kimi_k2_1t_a32b.py)
    return "adafactor" if cfg.name.startswith("kimi") else "adamw"


# ------------------------------------------------------------ the step
def step_config(cfg: ModelConfig, shape, mesh, overrides) -> ModelConfig:
    """``cfg`` as the cell's step runs it: the activation batch axes, and
    for a MoE cell whose tokens split into ``gd · gm`` groups of at least
    ``top_k`` the groups (gd the batch axes' size, gm "model"'s) and
    whether the rules put the experts on "model" (the reference's
    ``build_step``, ``dryrun.py:97-107``).  ``mesh`` may be a stand-in
    with only ``.shape``."""
    bax = sh.batch_axes(mesh, shape.global_batch)
    if bax is not None and not isinstance(bax, tuple):
        bax = (bax,)
    updates = dict(act_batch_axes=bax)
    if cfg.moe is not None and bax is not None:
        rules = sh.apply_overrides(sh.default_rules(mesh, cfg), overrides)
        sizes = sh.mesh_axes(mesh)
        gd = math.prod(sizes[a] for a in bax)
        gm = sizes.get("model", 1)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        if tokens % (gd * gm) == 0 and tokens // (gd * gm) >= cfg.moe.top_k:
            updates["moe_groups"] = (gd, gm)
            updates["moe_expert_sharded"] = rules.get("experts") == "model"
    return dataclasses.replace(cfg, **updates)


def _fresh(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _rank_block(x: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of the meta tensor ``x`` laid out by ``sharding``,
    as a meta tensor of its own (a block of the full tensor would share
    its storage, which no rank holds)."""
    local = sh.local_block(x, sharding)
    return _fresh(local.shape, local.dtype)


def _laid_out(tree, shardings):
    """Meta DTensors: each rank's own block, laid out by ``shardings``."""
    return tree_map(lambda x, s: sh.wrap(_rank_block(x, s), s, x.shape),
                    tree, shardings)


def _rank_batch(cfg: ModelConfig, mesh, batch: dict) -> dict:
    """The rank's slice of a global meta batch, as plain meta tensors."""
    specs = sh.named(mesh, sh.batch_specs(mesh, cfg, batch))
    return {k: _rank_block(v, specs[k]) for k, v in batch.items()}


def build_step(cfg: ModelConfig, shape, mesh, overrides):
    """(fn, args): the cell's step and this rank's meta inputs; ``fn(*args)``
    runs it (see the module doc for what each kind runs)."""
    cfg = step_config(cfg, shape, mesh, overrides)
    params = abstract_params(cfg)

    if shape.kind == "train":
        opt = get_optimizer(get_optimizer_name_from_cfg(cfg))
        fn = make_sharded_train_step(cfg, opt,
                                     cosine_schedule(3e-4, 100, 10000), mesh,
                                     overrides)
        state = opt.init(params)
        p_sh, o_sh = state_shardings(mesh, cfg, state, overrides)
        batch = input_specs(cfg, shape)
        b_sh = sh.named(mesh, sh.batch_specs(mesh, cfg, batch))
        return fn, (_laid_out(params, p_sh), _laid_out(state, o_sh),
                    _laid_out(batch, b_sh))

    p_sh = sh.named(mesh, sh.model_pspecs(mesh, cfg, overrides))
    params = _laid_out(params, p_sh)
    batch = input_specs(cfg, shape)
    if shape.kind == "prefill":
        serve_cfg = serve_config(cfg, mesh, shape.global_batch,
                                 shape.seq_len, "prefill", overrides)

        def prefill(params, batch):
            with torch.no_grad():
                return engine.prefill(params, serve_cfg,
                                      tokens=batch.get("tokens"),
                                      embeds=batch.get("embeds"),
                                      positions=batch.get("positions"),
                                      mesh=mesh)

        return prefill, (params, _rank_batch(cfg, mesh, batch))

    # decode: the rank's blocks of the cache, one token a row
    serve_cfg = serve_config(cfg, mesh, shape.global_batch, shape.seq_len,
                             "decode", overrides)
    cache = _laid_out(engine.abstract_cache(cfg, shape.global_batch,
                                            shape.seq_len),
                      sh.cache_shardings(mesh, cfg, shape.global_batch,
                                         shape.seq_len))

    def decode(params, cache, tokens):
        with torch.no_grad():
            logits, cache, _ = engine.decode_step(params, serve_cfg, cache,
                                                  tokens, mesh=mesh)
        return logits, cache

    return decode, (params, cache, _rank_batch(cfg, mesh, batch)["tokens"])


# ------------------------------------------------------------ counting
def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block, else ``t``."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list:
    return [_local(t) for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _flat(obj) -> list:
    """The tensors in an op's arguments or outputs (lists and tuples)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _flat(o)]
    return []


# ops that move no bytes: allocations alone, and views that
# OpOverload.is_view does not mark
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh"}


class _Traffic(TorchDispatchMode):
    """Counts the bytes every aten op reads and writes (its tensor inputs
    and outputs, but for views and bare allocations) and the live bytes:
    every storage an op returns stays counted until it is freed (a
    weakref finalizer on the storage, which outlives its last tensor's
    Python object while autograd holds it)."""

    def __init__(self, args):
        super().__init__()
        self.hbm_bytes = 0
        self.live = {}
        self.now = self.peak = 0
        for t in _tensors(args):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.now -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _flat(out)
        if not (func.is_view
                or func.overloadpacket.__name__ in _NO_TRAFFIC):
            self.hbm_bytes += sum(
                _local(t).numel() * _local(t).element_size()
                for t in _flat(args) + _flat(kwargs or {}) + outs)
        for t in outs:
            self._track(t)
        return out


def _kernel_calls(meta_calls: dict, charge) -> dict:
    """A kernel's meta calls (``meta_calls``, each charged ``charge``):
    launches, own FLOPs and bytes, and the calls by shape."""
    calls, flops, nbytes = [], 0, 0
    for key, n in sorted(meta_calls.items(), key=str):
        f, b = charge(key)
        flops += n * f
        nbytes += n * b
        bh, sq, sk, d, q_per_kv, causal, window, dtype, saves = key
        calls.append({"bh": bh, "sq": sq, "sk": sk, "d": d,
                      "q_per_kv": q_per_kv, "causal": causal,
                      "window": window, "dtype": str(dtype).split(".")[-1],
                      "saves": saves, "calls": n, "flops": f, "bytes": b})
    return {"launches": sum(c["calls"] for c in calls), "flops": flops,
            "bytes": nbytes, "calls": calls}


def count_step(fn, args) -> dict:
    """Run ``fn(*args)`` (meta inputs) once and count it: ``executed``
    (flops, hbm_bytes, collectives by the reference's kind), ``memory``
    (argument, output, temp and peak bytes), ``collectives`` (the counted
    collectives' output bytes and calls, the form of
    :func:`collective_bytes`) and ``kernels`` (``flash_attention``'s and
    its backward's calls on the meta route, ``flash_attention`` and
    ``flash_attention_bwd``, with their own FLOPs and bytes)."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_bytes = _storage_bytes(_tensors(args))
    fa_kernel.META_CALLS.clear()
    fa_kernel.BWD_META_CALLS.clear()
    traffic = _Traffic(args)
    with sh.recording() as log, FlopCounterMode(display=False) as flops, \
            traffic:
        out = fn(*args)
    kern = {"flash_attention": _kernel_calls(fa_kernel.META_CALLS,
                                             fa_kernel.charge),
            "flash_attention_bwd": _kernel_calls(fa_kernel.BWD_META_CALLS,
                                                 fa_kernel.bwd_charge)}
    fa_kernel.META_CALLS.clear()
    fa_kernel.BWD_META_CALLS.clear()
    out_bytes = _storage_bytes(_tensors(out))
    wire = {c: 0.0 for c in _COLLECTIVES}
    raw = {c: 0 for c in _COLLECTIVES}
    count = {c: 0 for c in _COLLECTIVES}
    for kind, nbytes, group, _ in log:
        k = _KIND[kind]
        wire[k] += hloanalysis.wire_bytes(k, nbytes, group)
        raw[k] += nbytes
        count[k] += 1
    return {
        "executed": {
            "flops": float(flops.get_total_flops()
                           + sum(k["flops"] for k in kern.values())),
            "hbm_bytes": float(traffic.hbm_bytes
                               + sum(k["bytes"] for k in kern.values())),
            "collective_wire_bytes": wire,
            "collective_count": count,
            "collective_total_bytes": float(sum(wire.values())),
        },
        "collectives": {"bytes": raw, "count": dict(count),
                        "total_bytes": int(sum(raw.values()))},
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": traffic.peak - arg_bytes,
                   "peak_bytes": traffic.peak},
        "kernels": kern,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             cfg_override=None, cfg_updates: dict | None = None) -> dict:
    """Count one cell as rank 0 of the running (fake) process group, on
    ``make_production_mesh``, and write its record to ``out_dir``."""
    cfg = cfg_override or get_config(arch)
    if cfg_updates:
        cfg = dataclasses.replace(cfg, **cfg_updates)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "skipped", "reason": None,
    }
    if not applicable(cfg, shape):
        rec["reason"] = "long_500k skipped: pure full-attention arch (DESIGN.md §5)"
        return rec

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    fn, args = build_step(cfg, shape, mesh, get_sharding_overrides(arch))
    counted = count_step(fn, args)
    del fn, args
    executed = counted["executed"]
    rec.update(
        status="ok",
        trace_s=round(time.time() - t0, 1),
        devices=mesh.size(),
        # an eager program has no loop body counted once: the raw totals
        # are the executed ones
        flops=executed["flops"],
        bytes_accessed=executed["hbm_bytes"],
        executed=executed,
        collectives=counted["collectives"],
        memory=counted["memory"],
        kernels=counted["kernels"],
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{arch.replace('.', '_')}__{shape_name}__{rec['mesh']}.json"
    (out_dir / fname).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="not ported: an eager PyTorch step has no HLO")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. remat=dots)")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo is not ported: the port's dry run traces an "
                 "eager PyTorch step, which has no HLO to save")
    cfg_updates = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg_updates[k] = int(v) if v.isdigit() else v

    out_dir = Path(args.out)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    started = not dist.is_initialized()
    if started:
        # the reference's 512 host devices: rank 0 of a fake group
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=FAKE_WORLD)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    try:
        for arch, shape in cells:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, out_dir,
                                   cfg_updates=cfg_updates or None)
                    if rec["status"] == "ok":
                        m = rec["memory"]
                        ex = rec["executed"]
                        print(f"[ok]   {tag}: trace={rec['trace_s']}s "
                              f"exflops={ex['flops']:.3e} "
                              f"excoll={ex['collective_total_bytes']:.3e}B "
                              f"args={m['argument_bytes']/1e9:.2f}GB "
                              f"temp={m['temp_bytes']/1e9:.2f}GB",
                              flush=True)
                    else:
                        print(f"[skip] {tag}: {rec['reason']}", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                    traceback.print_exc()
    finally:
        if started:
            dist.destroy_process_group()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
