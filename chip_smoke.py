#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one Hopper GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device of compute capability 9.0 and the CUDA toolkit (``nvcc``); it
imports nothing of JAX or of the JAX package.  Phases, each reported on its
own line:

1. device: the card's name, power limit and capability (must be 9.0);
2. build: both CUDA kernels compiled from ``src/repro_torch/**/csrc``;
3. observe_scatter vs its plain version, exact, on the shared-memory path
   (5,000 blocks) and the global-atomics path (5,242,880 blocks);
4. hist_select vs its plain version, exact, at 5 x 5,242,880 keys, S=1 and
   S=3, with caps of 0 and of the full segment and heavy ties;
5. SMALL DLRM parity: ``run_scenario`` on the GPU and on the CPU give
   byte-identical results for hints in {False, True} x sync_every in
   {1, 4, 7};
6. the main path at paper scale: 5,242,880 pages, 2.4 M lookups per batch,
   486,587 fast slots, hints on, sync_every=4, under
   ``torch.cuda.set_sync_debug_mode("error")`` (only the record pull may
   sync); the kernels' launch counts and the record-pull count are checked;
   then the same loop five times warm, timed without the sync checks;
7. kernel times at the paper-scale shapes (CUDA events), beside the bound,
   the plain version and one PyTorch library call; then the paper run once
   more under ``torch.profiler``: device busy time, idle share and the
   kernels that take the most device time.

Any failure exits non-zero before the result lines.  The last lines are the
kernel table (JSON), the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor-core rate (float32)
PAPER_PAGES = 5_242_880
PAPER_K_HOT = 486_587


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=True), flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / SCALAR_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps: int):
    """plain, kernel, kernel, plain on one card; mean of each pair."""
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main(until: int = 7) -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))

    from repro_torch.core import runtime, selectk
    from repro_torch.dlrm import datagen
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import KernelBackend
    from repro_torch.kernels.hist_select import kernel as hs_kernel
    from repro_torch.kernels.hist_select import kth_key
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.kernels.observe_scatter import observe_scatter
    from repro_torch.scenarios import DLRMScenario, build_hints, run_scenario

    plain = KernelBackend(plain=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    cap = torch.cuda.get_device_capability(dev)
    say("device", name=torch.cuda.get_device_name(dev), smi=smi_line,
        capability=list(cap), torch=torch.__version__,
        cuda=torch.version.cuda)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    if until < 2:
        fail(f"stopped after phase {until} (--until)")
    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    took = _build.build_all()
    ptxas = {}
    for name in took:
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln] if log.exists() else []
    say("build", seconds=time.perf_counter() - t0, per_kernel=took,
        ptxas=ptxas)

    rng = np.random.default_rng(0)
    errors = {}

    # ------------------------------------ 3. observe_scatter vs plain, exact
    shared_limit = os_kernel.shared_limit()
    for n_blocks, m in ((5_000, 40_003), (PAPER_PAGES, 2_400_001)):
        ids = (rng.zipf(1.3, m) - 1) % (n_blocks + 6) - 3   # -3 .. n+2
        ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        keep = torch.from_numpy(rng.random(m) < 0.7).to(dev)
        cursor = torch.tensor(123, dtype=torch.int32, device=dev)
        worst = 0
        for km in (None, keep):
            got = observe_scatter(ids, cursor, n_blocks=n_blocks, period=401,
                                  keep=km)
            ref = observe_scatter(ids, cursor, n_blocks=n_blocks, period=401,
                                  keep=km, backend=plain)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                worst = max(worst, int((g - r).abs().max()))
        path = "shared" if n_blocks <= shared_limit else "global"
        say("observe_scatter", n_blocks=n_blocks, m=m, path=path,
            max_abs_err=worst)
        errors["observe_scatter"] = max(errors.get("observe_scatter", 0),
                                        worst)
        if worst != 0:
            fail(f"observe_scatter differs from its plain version "
                 f"(n_blocks={n_blocks}, max abs err {worst})")
    if not 5_000 <= shared_limit < PAPER_PAGES:
        fail(f"unexpected shared-memory limit {shared_limit}")

    # ---------------------------------------- 4. hist_select vs plain, exact
    n = PAPER_PAGES
    keys = rng.integers(0, 40, (5, n)).astype(np.int32)          # heavy ties
    keys[1] = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
    keys[2, : n // 2] = -2 ** 31                                   # sentinel
    keys[3] = np.float32(rng.random(n) * (rng.random(n) < 0.1)).view(
        np.int32)
    keys_t = torch.from_numpy(keys).to(dev)
    seg_bounds = (0, 1_000_003, 1_000_003 + 2_500_000, n)
    lens = np.diff(seg_bounds)
    seg = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32),
                                     lens)).to(dev)
    worst = 0
    cases = [(None, (PAPER_K_HOT,)), (None, (0,)), (None, (n,)),
             (None, (1,)), (seg, (0, int(lens[1]), 7_777))]
    for sg, ks in cases:
        got = kth_key(keys_t, sg, ks)
        ref = kth_key(keys_t, sg, ks, backend=plain)
        torch.cuda.synchronize()
        worst = max(worst, int((got - ref).abs().max()))
    # and the whole selection built on it, against the plain threshold
    v1, i1, s1 = selectk.select_top_k(keys_t, PAPER_K_HOT, return_mask=True)
    v2, i2, s2 = selectk.select_top_k(keys_t, PAPER_K_HOT, return_mask=True,
                                      backend=plain)
    sel_equal = bool(torch.equal(v1, v2) and torch.equal(i1, i2)
                     and torch.equal(s1, s2))
    say("hist_select", rows=5, n=n, cases=[list(c[1]) for c in cases],
        max_abs_err=worst, select_top_k_equal=sel_equal)
    errors["hist_select"] = worst
    if worst != 0 or not sel_equal:
        fail(f"hist_select differs from its plain version (max abs err "
             f"{worst}, select_top_k equal {sel_equal})")

    if until < 5:
        fail(f"stopped after phase {until} (--until)")
    # -------------------------------- 5. SMALL parity, GPU vs CPU, bytewise
    t0 = time.perf_counter()
    for hints in (False, True):
        for k in (1, 4, 7):
            out = {d: json.dumps(run_scenario(
                DLRMScenario(spec=datagen.SMALL), hints=hints, sync_every=k,
                device=d), sort_keys=True) for d in ("cuda", "cpu")}
            if out["cuda"] != out["cpu"]:
                fail(f"SMALL trajectory differs GPU vs CPU (hints={hints}, "
                     f"sync_every={k})")
    say("small_parity", runs=12, identical=True,
        seconds=time.perf_counter() - t0)

    if until < 6:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------------------ 6. the main path, paper scale
    spec = datagen.DLRMTraceSpec(n_params=5_368_709_120)
    if spec.n_pages != PAPER_PAGES:
        fail(f"paper spec has {spec.n_pages} pages")
    scen = DLRMScenario(spec=spec, n_epochs=6, batches_per_epoch=2,
                        shift_at=3, k_hot=PAPER_K_HOT)
    t0 = time.perf_counter()
    epochs = list(scen.epochs())
    pipeline = build_hints(scen)
    setup_s = time.perf_counter() - t0
    os_kernel.LAUNCHES = 0
    hs_kernel.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with runtime.counting() as c:
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = run_scenario(scen, hints=pipeline, sync_every=4,
                               epochs=epochs)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
    launches = {"observe_scatter": os_kernel.LAUNCHES,
                "hist_select": hs_kernel.LAUNCHES}
    record_sync = c.dispatch["record_sync"]
    lanes = res["trajectory"]["lanes"]
    say("paper_run", n_pages=spec.n_pages, k_hot=scen.k_hot,
        lookups_per_batch=spec.lookups_per_batch, epochs=scen.n_epochs,
        batches_per_epoch=scen.batches_per_epoch, setup_s=setup_s,
        wall_s=wall, epoch_wall_s_mean=wall / scen.n_epochs,
        launches=launches, record_sync=record_sync,
        hint_refresh=c.dispatch["hint_refresh"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    say("paper_summary", **res["summary"])
    if launches != {"observe_scatter": 12, "hist_select": 6}:
        fail(f"kernel launches {launches}, expected 12 and 6")
    if record_sync != 2:
        fail(f"record_sync {record_sync}, expected 2")
    if set(lanes) != set(runtime.ALL_POLICIES):
        fail(f"lanes {sorted(lanes)}")
    for name, recs in lanes.items():
        if len(recs) != scen.n_epochs:
            fail(f"lane {name} has {len(recs)} records")
        for r in recs:
            nums = [v for v in r.values() if isinstance(v, (int, float))]
            if not all(math.isfinite(v) for v in nums):
                fail(f"non-finite record {r}")
            if not (0.0 <= r["accuracy"] <= 1.0
                    and 0.0 <= r["coverage"] <= 1.0
                    and 0 <= r["resident"] <= scen.k_hot and r["time_s"] > 0):
                fail(f"record out of range {r}")
    # the same stream on the CPU (plain versions) must give the same first
    # two epochs: their records depend on epochs 0..2 only (lookahead 1)
    t0 = time.perf_counter()
    head = DLRMScenario(spec=spec, n_epochs=3, batches_per_epoch=2,
                        shift_at=1, k_hot=PAPER_K_HOT)
    cpu = run_scenario(head, hints=build_hints(head), sync_every=1,
                       epochs=epochs[:3], device="cpu")
    cpu_lanes = cpu["trajectory"]["lanes"]
    same = all(cpu_lanes[name][:2] == lanes[name][:2] for name in lanes)
    say("paper_cpu_parity", epochs_compared=2, identical=same,
        seconds=time.perf_counter() - t0)
    if not same:
        fail("paper-scale GPU records differ from the CPU run's")
    # the run above is the first at this size (allocator growth, pinned
    # buffers, sync checks): time the same loop warm, five times, without
    # the sync debug mode.  The process's CPU time beside each wall time
    # tells a slower host (wall up, CPU time flat) from more work (both up).
    warm_wall_s, warm_cpu_s = [], []
    for _ in range(5):
        pipeline = build_hints(scen)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs)
        torch.cuda.synchronize()
        warm_wall_s.append(time.perf_counter() - t0)
        warm_cpu_s.append(time.process_time() - c0)
    warm_epoch_s = [w / scen.n_epochs for w in warm_wall_s]
    say("paper_warm", runs=len(warm_wall_s), wall_s=warm_wall_s,
        process_cpu_s=warm_cpu_s, epoch_wall_s=warm_epoch_s,
        epoch_wall_s_mean=sum(warm_epoch_s) / len(warm_epoch_s),
        cold_epoch_wall_s_mean=wall / scen.n_epochs)

    if until < 7:
        fail(f"stopped after phase {until} (--until)")
    # ---------------------------------------- 7. kernel times, paper shapes
    ids = torch.from_numpy(epochs[0][0]).to(dev)
    cursor = torch.zeros((), dtype=torch.int32, device=dev)
    m = ids.numel()
    os_ms, os_plain = in_turns(
        lambda: observe_scatter(ids, cursor, n_blocks=n, period=401,
                                backend=plain),
        lambda: observe_scatter(ids, cursor, n_blocks=n, period=401), 20)
    os_lib = time_ms(lambda: torch.bincount(ids, minlength=n), 20)
    os_bound, os_by = bound_ms(4 * m + 2 * 4 * n, 2 * m)

    h0 = observe_scatter(ids, cursor, n_blocks=n, period=401)[0]
    h1 = observe_scatter(torch.from_numpy(epochs[1][0]).to(dev), cursor,
                         n_blocks=n, period=401)[0]
    hf = h0.to(torch.float32)
    rows = torch.stack([
        h0, (h0 > 0).to(torch.int32), selectk.sortable_key(0.5 * hf),
        selectk.sortable_key(torch.where(h0 > 0, hf / hf.max(), -1.0)),
        selectk.sortable_key(h1.to(torch.float32) / h1.max())]).contiguous()
    ks = (PAPER_K_HOT,)
    hs_ms, hs_plain = in_turns(lambda: kth_key(rows, None, ks, backend=plain),
                               lambda: kth_key(rows, None, ks), 10)
    hs_lib = time_ms(lambda: torch.kthvalue(rows, n - PAPER_K_HOT + 1,
                                            dim=-1), 10)
    lib_t = torch.kthvalue(rows, n - PAPER_K_HOT + 1, dim=-1).values
    if not torch.equal(lib_t.to(torch.int64) + 2 ** 31,
                       kth_key(rows, None, ks)[:, 0]):
        fail("hist_select disagrees with torch.kthvalue")
    hs_bound, hs_by = bound_ms(4 * rows.numel(), 4 * rows.numel())

    # -------------------- where the time goes: the paper run, profiled once
    from torch.profiler import ProfilerActivity, profile
    pipeline = build_hints(scen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    kernel_us, op_us = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # kernel and copy events carry the device time; op events repeat it
        # as the time of what they launched, so they rank but never add up
        into = kernel_us if ev.device_type == DeviceType.CUDA else op_us
        if us > 0:
            into[ev.key] = into.get(ev.key, 0.0) + us
    busy_s = sum(kernel_us.values()) / 1e6
    def top(table, n):
        return {key[:80]: us / 1e3 for key, us in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]}

    # the profiler slows the host, so the idle share is given both over the
    # profiled wall and over the mean unprofiled warm wall of phase 6
    warm_mean = sum(warm_wall_s) / len(warm_wall_s)
    say("profile", wall_s=prof_wall, device_busy_s=busy_s,
        device_idle_share_profiled=1.0 - busy_s / prof_wall,
        device_idle_share_warm=1.0 - busy_s / warm_mean,
        top_op_device_ms=top(op_us, 10), top_kernel_ms=top(kernel_us, 10),
        port_kernel_ms={key[:80]: us / 1e3 for key, us in kernel_us.items()
                        if "observe_scatter" in key or "hs_" in key})

    # the host's side of the same run: where the Python process spends it
    import cProfile
    import pstats
    pipeline = build_hints(scen)
    torch.cuda.synchronize()
    host = cProfile.Profile()
    host.enable()
    run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs)
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats
    by_own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    say("host_profile", total_s=sum(v[2] for v in stats.values()),
        top_own_s={f"{Path(k[0]).name}:{k[1]}:{k[2]}": v[2]
                   for k, v in by_own})

    kernels = [
        {"name": "observe_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/observe_scatter/csrc/"
                   "observe_scatter.cu",
         "replaces": "src/repro/kernels/observe_scatter/kernel.py:34",
         "launches": launches["observe_scatter"],
         "max_abs_err": errors["observe_scatter"], "ms": os_ms,
         "plain_ms": os_plain, "bound_ms": os_bound, "bound_by": os_by,
         "library_ms": os_lib},
        {"name": "hist_select", "route": "cuda",
         "source": "src/repro_torch/kernels/hist_select/csrc/hist_select.cu",
         "replaces": "src/repro/kernels/hist_select/kernel.py:45",
         "launches": launches["hist_select"],
         "max_abs_err": errors["hist_select"], "ms": hs_ms,
         "plain_ms": hs_plain, "bound_ms": hs_bound, "bound_by": hs_by,
         "library_ms": hs_lib},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    # --until N stops after phase N (a short first check of a new kernel);
    # it fails by design, since the result lines are never reached
    args = sys.argv[1:]
    main(int(args[1]) if args[:1] == ["--until"] else 7)
