"""Worker side of ``tests/test_torch_sharded_serve.py``: one process per
rank of a 4-rank gloo group, importing only ``repro_torch``.

Every rank builds the meshes (subgroups of the one group), then runs each
case of CASES: the case's smoke config in float32, its params laid out by
``model_pspecs`` on the arch's sharding overrides
(``serve.sharded.lay_out_params``), ``engine.prefill``
of the prompt (PROMPT tokens into a cache of MAX_LEN positions) and
DECODE_STEPS ``engine.decode_step`` calls with page masses of PAGE
positions, each under ``launch.sharding.recording``.  Then:

* rank 0 writes ``<case>.npz``: the logits of every call, the cache after
  the prefill and after the last step, the page masses and expert counts
  of every step, all gathered whole (``serve.sharded.gather_outputs``);
* every rank writes ``<case>.<rank>.json``: each call's collectives
  ``(kind, bytes, group size, axis)``; its largest error, cache leaf by
  cache leaf, against its block of the same calls' single-device cache
  (the port's ``prefill`` / ``decode_step`` without a mesh, laid out by
  DTensor's own ``distribute_tensor``), after the prefill and after the
  last step, with the leaf's largest magnitude; each cache block's shape
  beside the whole leaf's;
* for MEMORY_CASES, every rank writes ``memory-<case>.<rank>.json``: the
  prefill's and a decode step's memory (``launch.dryrun.count_step``'s
  live-storage trace on these CPU tensors) at the config's layers and at
  twice as many.

A rank that fails writes ``<case>.<rank>.error`` and leaves the group.
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
PROMPT, MAX_LEN, PAGE, DECODE_STEPS = 8, 20, 5, 3
# a variant whose heads the rules cut at 4 "model" ranks (q gathered over
# "model" at prefill, every head on every rank at decode)
CUT = {"n_heads": 6, "head_dim": 16}
# case -> (arch, mesh, batch, config changes).  At (2, 2) the KV heads of
# every attention family go over "model" (2 of them a config); at (1, 4)
# they do not divide it, so the cache's sequence goes over "model" (and
# the decode combines the ranks' slices), zamba2's 4 over "model"; at
# (4, 1) FSDP alone; at a batch of one the sequence takes "data" too.
# Mixtral with a window of 6 (the window cuts the combined rows) and its
# override (each rank every expert on its block of d_expert); the MoE
# at capacity factor 8 (no token drops at prefill, where the groups'
# local capacity differs from the single program's)
CASES = {
    "llama3.2-3b-2x2": ("llama3.2-3b", (2, 2), 4, {}),
    "qwen2-0.5b-2x2": ("qwen2-0.5b", (2, 2), 4, {}),
    "mixtral-8x22b-2x2": ("mixtral-8x22b", (2, 2), 4, {"window": 6}),
    "kimi-k2-1t-a32b-2x2": ("kimi-k2-1t-a32b", (2, 2), 4, {}),
    "zamba2-2.7b-2x2": ("zamba2-2.7b", (2, 2), 4, {}),
    "rwkv6-3b-2x2": ("rwkv6-3b", (2, 2), 4, {}),
    "qwen2-0.5b-1x4": ("qwen2-0.5b", (1, 4), 4, {}),
    "llama3.2-3b-cut-1x4": ("llama3.2-3b", (1, 4), 4, CUT),
    "mixtral-8x22b-1x4": ("mixtral-8x22b", (1, 4), 4, {"window": 6}),
    "kimi-k2-1t-a32b-1x4": ("kimi-k2-1t-a32b", (1, 4), 4, {}),
    "zamba2-2.7b-1x4": ("zamba2-2.7b", (1, 4), 4, {}),
    "rwkv6-3b-1x4": ("rwkv6-3b", (1, 4), 4, {}),
    "llama3.2-3b-4x1": ("llama3.2-3b", (4, 1), 4, {}),
    "kimi-k2-1t-a32b-4x1": ("kimi-k2-1t-a32b", (4, 1), 4, {}),
    "zamba2-2.7b-4x1": ("zamba2-2.7b", (4, 1), 4, {}),
    "rwkv6-3b-4x1": ("rwkv6-3b", (4, 1), 4, {}),
    "qwen2-0.5b-4x1-b1": ("qwen2-0.5b", (4, 1), 1, {}),
    "kimi-k2-1t-a32b-4x1-b1": ("kimi-k2-1t-a32b", (4, 1), 1, {}),
    "zamba2-2.7b-4x1-b1": ("zamba2-2.7b", (4, 1), 1, {}),
    "rwkv6-3b-4x1-b1": ("rwkv6-3b", (4, 1), 1, {}),
    "qwen2-0.5b-2x2-b1": ("qwen2-0.5b", (2, 2), 1, {}),
}
MEMORY_CASES = ("llama3.2-3b-2x2", "qwen2-0.5b-1x4", "kimi-k2-1t-a32b-2x2",
                "zamba2-2.7b-2x2")
CAPACITY_FACTOR = 8.0


def config(case: str, layers: int | None = None):
    """The case's smoke config in float32 with its changes (and
    ``layers`` layers)."""
    import torch
    from repro_torch.configs import get_smoke_config
    arch, _, _, changes = CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype=torch.float32,
                              activ_dtype=torch.float32, **changes)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY_FACTOR))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def tokens_np(case: str) -> np.ndarray:
    """(B, PROMPT + DECODE_STEPS) int32: the prompt, then one token a
    decode step."""
    cfg = config(case)
    rng = np.random.default_rng(7)
    return rng.integers(0, cfg.vocab_size,
                        (CASES[case][2], PROMPT + DECODE_STEPS)
                        ).astype(np.int32)


def overrides(case: str) -> dict:
    """The case's arch's sharding overrides (Mixtral's: its experts'
    ``expert_mlp`` on "model", each rank running every expert on its block
    of ``d_expert``)."""
    from repro_torch.configs import get_sharding_overrides
    return get_sharding_overrides(CASES[case][0])


def params_np(cfg) -> dict:
    from repro_torch.models.model import iter_schema
    return perturbed_tree(iter_schema(cfg))


def single_device(cfg, params, toks):
    """The port's single-device prefill and decode steps -> (logits of each
    call, cache after the prefill, cache after the last step, page masses
    and expert counts of each step)."""
    import torch
    from repro_torch.serve import engine
    with torch.no_grad():
        logits, cache = engine.prefill(params, cfg, tokens=toks[:, :PROMPT],
                                       max_len=MAX_LEN)
        first = {k: v.clone() for k, v in cache.items()}
        out, auxes = [logits], []
        for t in range(DECODE_STEPS):
            logits, cache, aux = engine.decode_step(
                params, cfg, cache, toks[:, PROMPT + t], page_size=PAGE)
            out.append(logits)
            auxes.append(aux)
    return out, first, cache, auxes


def sharded(cfg, params, toks, mesh, over: dict):
    """The sharded prefill and decode steps on ``mesh`` (the rules with the
    overrides ``over``) -> (logits of each call, cache after the prefill
    (cloned DTensors), cache after the last step, the aux of each step,
    the collectives of each call)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding as sh
    from repro_torch.serve import engine
    from repro_torch.serve import sharded as ss
    b = toks.shape[0]
    cfg_p = ss.serve_config(cfg, mesh, b, PROMPT, "prefill", over)
    cfg_d = ss.serve_config(cfg, mesh, b, MAX_LEN, "decode", over)
    p = ss.lay_out_params(params, mesh, cfg, over)
    logs = []
    with torch.no_grad():
        with sh.recording() as log:
            logits, cache = engine.prefill(
                p, cfg_p, tokens=ss.batch_block(toks[:, :PROMPT], mesh,
                                                cfg_p),
                max_len=MAX_LEN, mesh=mesh)
        logs.append(log)
        # decode_step writes the cache in place: keep the prefill's
        first = {k: DTensor.from_local(v.to_local().clone(), v.device_mesh,
                                       v.placements, run_check=False,
                                       shape=v.shape, stride=v.stride())
                 for k, v in cache.items()}
        out, auxes = [logits], []
        for t in range(DECODE_STEPS):
            with sh.recording() as log:
                logits, cache, aux = engine.decode_step(
                    p, cfg_d, cache,
                    ss.batch_block(toks[:, PROMPT + t], mesh, cfg_d),
                    page_size=PAGE, mesh=mesh)
            logs.append(log)
            out.append(logits)
            auxes.append(aux)
    return out, first, cache, auxes, logs


def _block_errors(got: dict, whole: dict, mesh, cfg, b: int) -> dict:
    """Each cache leaf's rank block ``got`` (DTensors) against this rank's
    block of the single-device cache ``whole`` (``local_block``, DTensor's
    own layout) -> {leaf: [largest error, largest magnitude]}."""
    from repro_torch.launch import sharding as sh
    shardings = sh.cache_shardings(mesh, cfg, b, MAX_LEN)
    out = {}
    for k, x in got.items():
        want = sh.local_block(whole[k], shardings[k])
        mine = x.to_local()
        assert tuple(mine.shape) == tuple(want.shape), (k, mine.shape,
                                                        want.shape)
        out[k] = [float((mine.double() - want.double()).abs().max()),
                  float(want.double().abs().max())]
    return out


def run_case(case: str, mesh, rank: int, out_dir: str) -> dict:
    import torch
    from repro_torch.pytree import tree_map
    from repro_torch.serve import sharded as ss
    cfg = config(case)
    params = tree_map(torch.from_numpy, params_np(cfg))
    toks = torch.from_numpy(tokens_np(case))
    b = toks.shape[0]
    one_logits, one_first, one_last, _ = single_device(cfg, params, toks)
    logits, first, last, auxes, logs = sharded(cfg, params, toks, mesh,
                                               overrides(case))
    res = {"collectives": [[list(e) for e in log] for log in logs],
           "blocks_prefill": _block_errors(first, one_first, mesh, cfg, b),
           "blocks_last": _block_errors(last, one_last, mesh, cfg, b),
           "block_shapes": {k: [list(v.to_local().shape), list(v.shape)]
                            for k, v in last.items()}}
    del one_logits
    whole = ss.gather_outputs({"logits": logits, "first": first,
                               "last": last, "aux": auxes})
    if rank == 0:
        save = {f"logits/{i}": x.numpy() for i, x in
                enumerate(whole["logits"])}
        for when in ("first", "last"):
            save.update({f"{when}/{k}": v.numpy()
                         for k, v in whole[when].items()})
        for i, aux in enumerate(whole["aux"]):
            save.update({f"aux/{i}/{k}": v.numpy() for k, v in aux.items()})
        np.savez(os.path.join(out_dir, f"{case}.npz"), **save)
    return res


def run_memory(case: str, mesh) -> dict:
    """count_step's memory of the sharded prefill and of a decode step at
    the case's layers and at twice as many."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.pytree import tree_map
    from repro_torch.serve import engine
    from repro_torch.serve import sharded as ss
    toks = torch.from_numpy(tokens_np(case))
    b = toks.shape[0]
    over = overrides(case)
    out = {}
    for layers in (config(case).n_layers, 2 * config(case).n_layers):
        cfg = config(case, layers)
        params = ss.lay_out_params(tree_map(torch.from_numpy,
                                            params_np(cfg)), mesh, cfg, over)
        cfg_p = ss.serve_config(cfg, mesh, b, PROMPT, "prefill", over)
        cfg_d = ss.serve_config(cfg, mesh, b, MAX_LEN, "decode", over)
        tok_p = ss.batch_block(toks[:, :PROMPT], mesh, cfg_p)
        tok_d = ss.batch_block(toks[:, PROMPT], mesh, cfg_d)

        def prefill(p, t):
            with torch.no_grad():
                return engine.prefill(p, cfg_p, tokens=t, max_len=MAX_LEN,
                                      mesh=mesh)

        def decode(p, c, t):
            with torch.no_grad():
                return engine.decode_step(p, cfg_d, c, t, page_size=PAGE,
                                          mesh=mesh)[:2]
        pre = dryrun.count_step(prefill, (params, tok_p))
        _, cache = prefill(params, tok_p)
        dec = dryrun.count_step(decode, (params, cache, tok_d))
        out[f"layers={layers}"] = {"prefill": pre["memory"],
                                   "decode": dec["memory"]}
    return out


def worker(rank: int, store_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, N_RANKS),
                            rank=rank, world_size=N_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.launch.mesh import make_mesh

    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
              for shape in ((2, 2), (1, 4), (4, 1))}
    name = "setup"
    try:
        for name in CASES:
            _write(out_dir, name, rank,
                   run_case(name, meshes[CASES[name][1]], rank, out_dir))
        for case in MEMORY_CASES:
            name = f"memory-{case}"
            _write(out_dir, name, rank,
                   run_memory(case, meshes[CASES[case][1]]))
    except BaseException:
        with open(os.path.join(out_dir, f"{name}.{rank}.error"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def _write(out_dir: str, name: str, rank: int, res: dict) -> None:
    with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
        json.dump(res, f, sort_keys=True)
