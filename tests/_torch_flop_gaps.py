"""Where the port's counted FLOPs and the reference's HLO FLOPs part, product
by product (the explanation PERF.md gives for the gaps that
``tests/test_torch_dryrun.py`` bounds at 5 %).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_flop_gaps.py \\
        [arch:kind ...]

For each cell (default: the test's, smoke configs at B 2, S 64) it prints
the port's matrix products on CPU tensors (every ``mm`` / ``bmm`` /
``addmm`` / ``baddbmm`` the step dispatches, the plain attention included,
as ``FlopCounterMode`` counts them) and the reference's dots in its
compiled HLO (with ``hloanalysis``' trip counts), both keyed by (the
contracted length, the two other sides with their batch folded in), and
the keys on which the two differ.  Imports both packages, as the tests do.
"""
import collections
import math
import re
import sys

import numpy as np

B, S = 2, 64
CELLS = [(a, "train") for a in ("qwen2-0.5b", "mixtral-8x22b", "rwkv6-3b",
                                 "zamba2-2.7b")] + [
    (a, k) for a in ("qwen2-0.5b", "internlm2-1.8b", "mixtral-8x22b",
                     "rwkv6-3b", "zamba2-2.7b") for k in ("prefill", "decode")]


def _key(k: int, m: int, n: int) -> tuple:
    return (k, tuple(sorted((m, n))))


def port_products(arch: str, kind: str) -> collections.Counter:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import get_optimizer_name_from_cfg
    from repro_torch.models.model import init_params
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.serve import engine
    from repro_torch.train.steps import make_train_step

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                a, b = args[:2] if name in ("mm", "bmm") else args[1:3]
                batch = math.prod(a.shape[:-2])
                self.flops[_key(a.shape[-1], batch * a.shape[-2],
                                batch * b.shape[-1])] += \
                    2 * out.numel() * a.shape[-1]
            return out

    cfg = get_smoke_config(arch)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    params = init_params(cfg, 0, "cpu")
    with Products() as p:
        if kind == "train":
            opt = get_optimizer(get_optimizer_name_from_cfg(cfg))
            step = make_train_step(cfg, opt, cosine_schedule(3e-4, 100,
                                                             10000))
            step(params, opt.init(params), {"tokens": toks, "labels": toks})
        elif kind == "prefill":
            engine.prefill(params, cfg, tokens=toks)
        else:
            engine.decode_step(params, cfg,
                               engine.init_cache(cfg, B, S, device="cpu"),
                               toks[:, 0])
    return p.flops


def reference_products(arch: str, kind: str) -> collections.Counter:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.launch import hloanalysis as H
    from repro.models import model as jm
    from repro.optim import cosine_schedule, get_optimizer
    from repro.serve import engine
    from repro.train import steps

    jc = get_smoke_config(arch)
    params = jm.init_params(jc, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32))
    if kind == "train":
        opt = get_optimizer("adamw")
        step = steps.make_train_step(jc, opt, cosine_schedule(3e-4, 100,
                                                              10000))
        lowered = jax.jit(step).lower(params, opt.init(params),
                                      {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        lowered = jax.jit(lambda p, t: engine.prefill(p, jc, tokens=t)
                          ).lower(params, toks)
    else:
        lowered = jax.jit(lambda p, c, t: engine.decode_step(p, jc, c, t)[:2]
                          ).lower(params, engine.init_cache(jc, B, S),
                                  toks[:, 0])
    text = lowered.compile().as_text()
    comps = H.parse_hlo(text)
    entry = next(H._COMP_RE.match(line).group(1)
                 for line in text.splitlines() if line.startswith("ENTRY"))
    flops = collections.Counter()

    def dims(t):
        m = H._SHAPE_RE.match(t)
        return [int(x) for x in m.group(2).split(",")] if m.group(2) else []

    def walk(name, mult):
        comp = comps[name]
        for op in comp.ops:
            if op.opcode == "dot":
                lhs = dims(comp.symbols[op.operands[0]])
                contract = re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                     op.rest).group(1)
                batch = re.search(r"lhs_batch_dims=\{([\d,]*)\}", op.rest)
                ci = [int(x) for x in contract.split(",") if x]
                bi = [int(x) for x in batch.group(1).split(",") if x] \
                    if batch else []
                k = math.prod(lhs[i] for i in ci)
                nb = math.prod(lhs[i] for i in bi)
                m = math.prod(d for i, d in enumerate(lhs)
                              if i not in ci and i not in bi)
                n = math.prod(dims(op.out_type)) // (nb * m)
                flops[_key(k, nb * m, nb * n)] += \
                    H._dot_flops(comp, op) * mult
            elif op.opcode == "while":
                body = re.search(r"body=%?([\w.\-]+)", op.rest).group(1)
                cond = re.search(r"condition=%?([\w.\-]+)", op.rest).group(1)
                walk(body, mult * H._trip_count(comps, cond))
            elif op.opcode in ("fusion", "call", "custom-call"):
                mb = re.search(r"(?:to_apply|calls)=%?([\w.\-]+)", op.rest)
                if mb and mb.group(1) in comps:
                    walk(mb.group(1), mult)
    walk(entry, 1)
    return flops


def main(cells) -> None:
    for arch, kind in cells:
        port, ref = port_products(arch, kind), reference_products(arch, kind)
        gap = sum(port.values()) - sum(ref.values())
        print(f"{arch} {kind}: port {sum(port.values()):,} reference "
              f"{sum(ref.values()):,.0f} gap {gap:+,.0f}")
        for k in sorted(set(port) | set(ref)):
            if port.get(k, 0) != ref.get(k, 0):
                print(f"    contracted {k[0]}, sides {k[1]}: port "
                      f"{port.get(k, 0):,} reference {ref.get(k, 0):,.0f}")


if __name__ == "__main__":
    main([tuple(c.split(":")) for c in sys.argv[1:]] or CELLS)
