"""The dry run's serving cells on a fake process group, in a process of
their own (a fake default group cannot live beside the other tests'
groups).  Imports only ``repro_torch``.

``python tests/_torch_dryrun_serve_worker.py OUT``: writes
``OUT/cases.json`` (or ``OUT/error.txt``).

A fake group of 4 ranks, rank 0: the qwen2-0.5b smoke model's prefill (B
4, S 64) and decode step (B 4 against a cache of 64 positions), each
built by ``dryrun.build_step`` and counted by ``dryrun.count_step`` at
the meshes (2, 2), (1, 4) and (4, 1) over ("data", "model"); the same
cell run on CPU tensors (the params and the cache laid out on the same
mesh) under ``FlopCounterMode``; and the cell as the dry run counted it
before sharded serving, counted the same way: full params on every rank,
the rank's batch slice, and at decode the slice's whole cache.  Beside
them the single-device prefill's and decode step's counts.
"""
import json
import os
import sys
import traceback

ARCH = "qwen2-0.5b"
MESHES = ((2, 2), (1, 4), (4, 1))
BATCH, SEQ = 4, 64


def cases(out: dict) -> None:
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_sharding_overrides, get_smoke_config
    from repro_torch.launch import dryrun, sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec, input_specs
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.serve import engine
    from repro_torch.serve import sharded as ss

    cfg = get_smoke_config(ARCH)
    ov = get_sharding_overrides(ARCH)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                         dtype=torch.int32)
    meta = abstract_params(cfg)
    with torch.no_grad():
        out["single prefill"] = dryrun.count_step(
            lambda p, t: engine.prefill(p, cfg, tokens=t),
            (meta, input_specs(cfg, ShapeSpec("p", SEQ, BATCH, "prefill"))[
                "tokens"]))["executed"]["flops"]
        out["single decode"] = dryrun.count_step(
            lambda p, c, t: engine.decode_step(p, cfg, c, t)[:2],
            (meta, engine.abstract_cache(cfg, BATCH, SEQ),
             torch.empty(BATCH, dtype=torch.int32, device="meta"))
        )["executed"]["flops"]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        for shp in MESHES:
            mesh = make_mesh(shp, ("data", "model"), device="cpu")
            for kind in ("prefill", "decode"):
                shape = ShapeSpec(kind, SEQ, BATCH, kind)
                fn, args = dryrun.build_step(cfg, shape, mesh, ov)
                rec = dryrun.count_step(fn, args)
                # the same cell on CPU tensors
                params = ss.lay_out_params(init_params(cfg, 0, "cpu"), mesh,
                                           cfg, ov)
                scfg = ss.serve_config(cfg, mesh, BATCH, SEQ, kind, ov)
                if kind == "prefill":
                    cpu = (params, {"tokens": ss.batch_block(toks, mesh,
                                                             scfg)})
                else:
                    cache = sh.distribute(
                        engine.init_cache(cfg, BATCH, SEQ, device="cpu"),
                        sh.cache_shardings(mesh, cfg, BATCH, SEQ))
                    cpu = (params, cache,
                           ss.batch_block(toks[:, 0], mesh, scfg))
                with FlopCounterMode(display=False) as f:
                    fn(*cpu)
                out[f"{kind} {shp[0]}x{shp[1]}"] = {
                    "flops": rec["executed"]["flops"],
                    "cpu_flops": f.get_total_flops(),
                    "kernels": rec["kernels"], "memory": rec["memory"],
                    "collectives": rec["collectives"],
                    "full_params": full_params_memory(cfg, shape, mesh, ov)}
    finally:
        dist.destroy_process_group()


def full_params_memory(cfg, shape, mesh, ov) -> dict:
    """count_step's memory of the cell as the dry run built it before
    sharded serving: full params on every rank, the rank's batch slice,
    at decode the slice's whole cache."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import input_specs
    from repro_torch.models.model import abstract_params
    from repro_torch.serve import engine
    scfg = dryrun.step_config(cfg, shape, mesh, ov)
    params = abstract_params(scfg)
    batch = dryrun._rank_batch(scfg, mesh, input_specs(scfg, shape))
    if shape.kind == "prefill":
        def fn(p, b):
            with torch.no_grad():
                return engine.prefill(p, scfg, tokens=b["tokens"], mesh=mesh)
        return dryrun.count_step(fn, (params, batch))["memory"]
    tokens = batch["tokens"]

    def fn(p, c, t):
        with torch.no_grad():
            return engine.decode_step(p, scfg, c, t)[:2]
    return dryrun.count_step(fn, (params, engine.abstract_cache(
        scfg, tokens.shape[0], shape.seq_len), tokens))["memory"]


def main(out_dir: str) -> None:
    out: dict = {}
    try:
        cases(out)
        with open(os.path.join(out_dir, "cases.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    main(sys.argv[1])
