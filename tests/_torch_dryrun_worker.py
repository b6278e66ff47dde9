"""The dry run's fake-process-group cases, in a process of their own (a
fake default group cannot live beside the other tests' groups).  Imports
only ``repro_torch``.

``python tests/_torch_dryrun_worker.py OUT``: writes ``OUT/cases.json``,
and the CLI's record under ``OUT/cli`` (or ``OUT/error.txt``).

1. A fake group of 4 ranks, rank 0: the qwen2-0.5b smoke model's sharded
   train step (B 4, S 64) counted by ``dryrun.count_step`` at the meshes
   (2, 2), (1, 4) and (4, 1) over ("data", "model"), beside the
   single-device step's count, ``launch.sharding.COLLECTIVES``' change
   over each trace, and ``FlopCounterMode``'s count of the same step run
   on CPU tensors (the fake group's collectives move nothing, which
   changes no count); at (4, 1) the same step's memory at the config's
   layers and at twice as many; ``make_production_mesh`` on too few
   ranks.
   Then Mixtral's smoke step on its override (its experts' d_expert over
   "model") the same way at (2, 2) and (1, 4), beside its single-device
   count; and the rwkv6 and zamba2 smoke steps (each "model" rank on its
   heads of every RWKV-6 and Mamba2 mix) the same way at (2, 2), (1, 4)
   and (4, 1), beside their single-device counts.
2. A fake group of 512 ranks: ``make_production_mesh`` one pod and two.
3. No group: ``dryrun.main`` on qwen2-0.5b x train_4k x 16x16, which
   starts its own fake group of 512.
"""
import dataclasses
import json
import os
import sys
import traceback

ARCH = "qwen2-0.5b"
MESHES = ((2, 2), (1, 4), (4, 1))
BATCH, SEQ = 4, 64
# Mixtral's smoke step on its override (each expert's d_expert over
# "model"): at the meshes whose "model" axis it cuts
MOE_ARCH = "mixtral-8x22b"
MOE_MESHES = ((2, 2), (1, 4))
# the recurrent smoke steps: rwkv6's 2 heads are 1 / 1 / 0 / 0 a rank at
# (1, 4) (rank 0, the counted one, takes one), zamba2's 4 Mamba2 heads 1
RECURRENT_ARCHS = ("rwkv6-3b", "zamba2-2.7b")
RECURRENT_MESHES = ((2, 2), (1, 4), (4, 1))


def fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def moe_cases(out: dict) -> None:
    """Mixtral's smoke train step (B 4, S 64) on its override, then the
    recurrent smoke steps (:func:`train_cases`)."""
    train_cases(out, MOE_ARCH, MOE_MESHES, "moe ")
    for arch in RECURRENT_ARCHS:
        train_cases(out, arch, RECURRENT_MESHES, f"{arch} ")


def train_cases(out: dict, arch: str, meshes, prefix: str) -> None:
    """``arch``'s smoke train step (B 4, S 64) on its overrides: the
    single-device count without a group, then on the fake group of 4 at
    each of ``meshes`` the sharded step's count and ``FlopCounterMode``'s
    count of the same step on CPU tensors, keyed by ``prefix``."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_sharding_overrides, get_smoke_config
    from repro_torch.launch import dryrun, sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec, input_specs
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.train.sharded import state_shardings
    from repro_torch.train.steps import make_train_step

    cfg = get_smoke_config(arch)
    over = get_sharding_overrides(arch)
    shape = ShapeSpec("train_smoke", SEQ, BATCH, "train")
    opt = get_optimizer(dryrun.get_optimizer_name_from_cfg(cfg))
    step = make_train_step(cfg, opt, cosine_schedule(3e-4, 100, 10000))
    params = abstract_params(cfg)
    out[f"{prefix}single_device_flops"] = dryrun.count_step(
        step, (params, opt.init(params),
               input_specs(cfg, shape)))["executed"]["flops"]
    fake_group(4)
    try:
        for shp in meshes:
            mesh = make_mesh(shp, ("data", "model"), device="cpu")
            fn, args = dryrun.build_step(cfg, shape, mesh, over)
            rec = dryrun.count_step(fn, args)
            step_cfg = dryrun.step_config(cfg, shape, mesh, over)
            params_cpu = init_params(step_cfg, 0, "cpu")
            state_cpu = opt.init(params_cpu)
            toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                 generator=torch.Generator().manual_seed(0),
                                 dtype=torch.int32)
            batch = {"tokens": toks, "labels": toks}
            cpu_args = sh.distribute(
                (params_cpu, state_cpu, batch),
                (*state_shardings(mesh, step_cfg, state_cpu, over),
                 sh.named(mesh, sh.batch_specs(mesh, step_cfg, batch))))
            with FlopCounterMode(display=False) as f:
                fn(*cpu_args)
            out[f"{prefix}mesh {shp[0]}x{shp[1]}"] = {
                "flops": rec["executed"]["flops"],
                "kernels": rec["kernels"], "executed": rec["executed"],
                "cpu_flops": f.get_total_flops()}
    finally:
        dist.destroy_process_group()


def small_group_cases(out: dict) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_sharding_overrides, get_smoke_config
    from repro_torch.launch import dryrun, sharding as sh
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.shapes import ShapeSpec, input_specs
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.train.sharded import state_shardings
    from repro_torch.train.steps import make_train_step

    cfg = get_smoke_config(ARCH)
    shape = ShapeSpec("train_smoke", SEQ, BATCH, "train")
    opt = get_optimizer(dryrun.get_optimizer_name_from_cfg(cfg))
    step = make_train_step(cfg, opt, cosine_schedule(3e-4, 100, 10000))
    params = abstract_params(cfg)
    one = dryrun.count_step(step, (params, opt.init(params),
                                   input_specs(cfg, shape)))
    out["single_device_flops"] = one["executed"]["flops"]
    fake_group(4)
    try:
        for shp in MESHES:
            mesh = make_mesh(shp, ("data", "model"), device="cpu")
            fn, args = dryrun.build_step(cfg, shape, mesh,
                                         get_sharding_overrides(ARCH))
            before = dict(sh.COLLECTIVES)
            rec = dryrun.count_step(fn, args)
            counted = {k: sh.COLLECTIVES[k] - before[k] for k in before}
            step_cfg = dryrun.step_config(cfg, shape, mesh,
                                          get_sharding_overrides(ARCH))
            params_cpu = init_params(step_cfg, 0, "cpu")
            state_cpu = opt.init(params_cpu)
            toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                 generator=torch.Generator().manual_seed(0),
                                 dtype=torch.int32)
            batch = {"tokens": toks, "labels": toks}
            cpu_args = sh.distribute(
                (params_cpu, state_cpu, batch),
                (*state_shardings(mesh, step_cfg, state_cpu),
                 sh.named(mesh, sh.batch_specs(mesh, step_cfg, batch))))
            with FlopCounterMode(display=False) as f:
                fn(*cpu_args)
            out[f"mesh {shp[0]}x{shp[1]}"] = {
                "flops": rec["executed"]["flops"],
                "collectives": rec["collectives"],
                "executed": rec["executed"],
                "kernels": rec["kernels"],
                "cpu_flops": f.get_total_flops(),
                "counted": counted,
                "memory": rec["memory"]}
        mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
        for layers in (cfg.n_layers, 2 * cfg.n_layers):
            deep = dataclasses.replace(cfg, n_layers=layers)
            fn, args = dryrun.build_step(deep, shape, mesh,
                                         get_sharding_overrides(ARCH))
            out[f"memory 4x1 layers={layers}"] = dryrun.count_step(
                fn, args)["memory"]
        try:
            make_production_mesh(device="cpu")
            out["too_small"] = None
        except ValueError as e:
            out["too_small"] = str(e)
    finally:
        dist.destroy_process_group()


def production_cases(out: dict) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    fake_group(512)
    try:
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            out[f"production multi_pod={multi}"] = {
                "shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
                "device_type": mesh.device_type, "size": mesh.size()}
    finally:
        dist.destroy_process_group()


def cli_case(out_dir: str, out: dict) -> None:
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    try:
        dryrun.main(["--arch", ARCH, "--shape", "train_4k", "--out",
                     os.path.join(out_dir, "cli")])
    except SystemExit as e:
        out["cli_exit"] = e.code
    out["cli_left_a_group"] = dist.is_initialized()


def main(out_dir: str) -> None:
    out: dict = {}
    try:
        small_group_cases(out)
        moe_cases(out)
        production_cases(out)
        cli_case(out_dir, out)
        with open(os.path.join(out_dir, "cases.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    main(sys.argv[1])
