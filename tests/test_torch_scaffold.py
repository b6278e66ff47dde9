"""repro_torch scaffold: the port stands alone, runs on the card by default,
raises without one, and refuses the options it does not carry yet.

Everything here is structural (imports, devices, errors), so there is no
tolerance to state."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro_torch.core import TieringManager  # noqa: E402
from repro_torch.core.runtime import ALL_POLICIES, EpochRuntime, Tenancy  # noqa: E402
from repro_torch.dlrm import datagen, tracesim  # noqa: E402
from repro_torch.examples import dlrm_tiering, train_100m  # noqa: E402
from repro_torch.faults import FaultModel, Hardening  # noqa: E402
from repro_torch.kernels.dispatch import (KernelBackend, refuse_grad,  # noqa: E402
                                          resolve_device, use_kernel)
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.gather_count.kernel import gather_count_cuda  # noqa: E402
from repro_torch.kernels.hist_select.kernel import kth_key_cuda  # noqa: E402
from repro_torch.kernels.observe_scatter.kernel import observe_scatter_cuda  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.scenarios import DLRMScenario, run_online, run_scenario  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = DLRMScenario(spec=datagen.DLRMTraceSpec(n_params=256_000,
                                               lookups_per_batch=500),
                    n_epochs=2, batches_per_epoch=2, shift_at=1)

_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.scenarios, repro_torch.core.runtime, "
            "repro_torch.core.blockstore, repro_torch.core.manager, "
            "repro_torch.core.tiered_embedding, repro_torch.dlrm.tracesim, "
            "repro_torch.examples.dlrm_tiering, "
            "repro_torch.kernels.gather_count, "
            "repro_torch.kernels.embedding_bag, "
            "repro_torch.workloads.mmap_bench, repro_torch.models, "
            "repro_torch.models.model, repro_torch.models.rwkv6, "
            "repro_torch.models.mamba2, repro_torch.serve, "
            "repro_torch.serve.engine, repro_torch.launch, "
            "repro_torch.launch.serve, repro_torch.configs, "
            "repro_torch.scenarios.kv_cache, "
            "repro_torch.kernels.flash_attention, repro_torch.faults.prng, "
            "repro_torch.examples.degraded_telemetry, repro_torch.obs, "
            "repro_torch.export, repro_torch.examples.runtime_timeline, "
            "repro_torch.examples.telemetry_export, repro_torch.optim, "
            "repro_torch.optim.optimizers, repro_torch.optim.schedule, "
            "repro_torch.train, repro_torch.train.steps, "
            "repro_torch.train.compression, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.launch.train, repro_torch.examples.train_100m, "
            "repro_torch.pytree, "
            "repro_torch.kernels.flash_attention.autograd\n"
            "repro_torch.configs.get_config('qwen2-0.5b')\n"
            "repro_torch.scenarios.KVCacheScenario\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    offenders = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
                 for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if _IMPORT.match(line)]
    assert offenders == []


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EpochRuntime(100, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_online(spec=TINY.spec, n_epochs=1)


@pytest.mark.parametrize("entry", [
    lambda: TieringManager(100, 10),
    lambda: tracesim.run_table1(datagen.SMALL, k_hot=50),
    lambda: tracesim.run_fig3(total_accesses=1_000, n_batches=1),
    lambda: dlrm_tiering.run(dlrm_tiering.SMALL),
    lambda: train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"]),
    lambda: train_100m.main(["--steps", "1"]),
], ids=["TieringManager", "run_table1", "run_fig3", "dlrm_tiering.run",
        "launch.train", "train_100m"])
def test_offline_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, entry):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_entry_points_run_on_the_cpu_when_asked():
    out = run_scenario(TINY, hints=True, device="cpu")
    assert len(out["trajectory"]["lanes"]["hmu_oracle"]) == TINY.n_epochs
    rt = EpochRuntime(100, 10, device="cpu")
    assert rt.device.type == "cpu"


@pytest.mark.parametrize("option,item", [
    (dict(mesh=object()), "15"),
    (dict(faults=object()), "10"),
    (dict(hardening=object()), "10"),
])
def test_unported_options_raise(option, item):
    """Items 10 (``faults=``, ``hardening=``) and 15 (``mesh=``) are
    ported, so a value of the wrong type is refused by a TypeError that
    names the container it needs."""
    with pytest.raises(TypeError, match="FaultModel|Hardening" if item == "10"
                       else "DeviceMesh"):
        run_scenario(TINY, device="cpu", **option)


def test_export_option_is_accepted_and_leaves_the_run_identical():
    """``export=`` is ported (the export plane): the run takes a client,
    streams one epoch record per lane and epoch and one lane summary per
    lane through it, and its output is byte-identical to the run without
    one."""
    from repro_torch.export import ExportClient, MemorySink
    sink = MemorySink()
    client = ExportClient(sink)
    try:
        on = run_scenario(TINY, device="cpu", export=client)
        client.flush(timeout=30)
    finally:
        client.close()
    off = run_scenario(TINY, device="cpu")
    assert json.dumps(on) == json.dumps(off)
    kinds = [r["record_type"] for r in sink.snapshot()]
    n_lanes = len(ALL_POLICIES)
    assert kinds.count("epoch") == TINY.n_epochs * n_lanes
    assert kinds.count("lane_summary") == n_lanes


def test_tenancy_option_runs():
    """``tenancy=`` is ported (the fleet): a two-tenant layout with quotas
    runs through run_scenario and leaves one row set of tenant counts an
    epoch."""
    n = TINY.n_blocks
    ten = Tenancy(offsets=(0, n // 2, n), hot_k=(5, 5), caps=(6, 4))
    out = run_scenario(TINY, device="cpu", tenancy=ten)
    assert len(out["trajectory"]["lanes"]["hmu_oracle"]) == TINY.n_epochs


def test_fault_containers_are_not_ported():
    """The fault containers are ported: ``FaultModel.create()`` holds every
    knob at its no-op value with fresh state, and ``Hardening()`` has the
    reference's defaults."""
    fm = FaultModel.create()
    assert int(fm.hmu_counter_max) == 2 ** 31 - 1
    assert float(fm.pebs_drop_p) == 0.0 and float(fm.nb_stall_p) == 0.0
    assert fm.reset_p.tolist() == [0.0, 0.0, 0.0]
    assert fm.key.tolist() == [0, 0]
    assert int(fm.pebs_dropped) == 0 and fm.resets.tolist() == [0, 0, 0]
    assert int(fm.nb_stalls) == 0
    assert (fm.stale_epochs, fm.seed) == (0, 0)
    assert tuple(Hardening()) == (1, (), 0.5, 0.5)
    assert Hardening.make() == Hardening()


def test_dispatch_rule_follows_the_tensor():
    cpu = torch.zeros(4, dtype=torch.int32)
    assert not use_kernel(cpu)
    assert not use_kernel(cpu, KernelBackend(plain=True))
    assert hash(KernelBackend()) == hash(KernelBackend(plain=False))
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(4, device="meta"))
    # the CUDA wrappers never run a CPU tensor through anything
    with pytest.raises(ValueError, match="CUDA"):
        observe_scatter_cuda(cpu, torch.zeros(1, dtype=torch.int32),
                             n_blocks=8, period=3)
    with pytest.raises(ValueError, match="CUDA"):
        kth_key_cuda(cpu.reshape(1, 4), None, (1,))


# case: (its inputs from a float g that requires grad, a float f and an
# int32 i; grad mode on; refuse_grad raises)
_GRAD_CASES = {
    "one float input requires grad": (lambda g, f, i: (g,), True, True),
    "one of several, with None": (lambda g, f, i: (i, None, f, g), True,
                                  True),
    "a view of a leaf": (lambda g, f, i: (g[1:],), True, True),
    "under no_grad": (lambda g, f, i: (g, f), False, False),
    "integer inputs only": (lambda g, f, i: (i, i), True, False),
    "no input requires grad": (lambda g, f, i: (f, i, None), True, False)}


@pytest.mark.parametrize("case", sorted(_GRAD_CASES))
def test_refuse_grad(case):
    make, grad_mode, raises = _GRAD_CASES[case]
    inputs = make(torch.ones(3, requires_grad=True), torch.ones(3),
                  torch.ones(3, dtype=torch.int32))
    with torch.set_grad_enabled(grad_mode):
        if raises:
            with pytest.raises(RuntimeError, match="no backward"):
                refuse_grad("some_kernel", *inputs)
        else:
            refuse_grad("some_kernel", *inputs)


def _wrapper_call(name, requires_grad):
    """One CPU call of a CUDA wrapper with float inputs that require grad
    (or not)."""
    f = torch.ones(2, 1, 16, requires_grad=requires_grad)
    ids = torch.zeros(1, 2, dtype=torch.int32)
    counts = torch.zeros(1, dtype=torch.int32)
    st = torch.ones(4, 16, requires_grad=requires_grad)
    w = torch.ones(1, 2, requires_grad=requires_grad)
    if name == "flash_attention":
        return lambda: flash_attention_cuda(f, f, f, q_per_kv=1)
    if name == "embedding_bag":
        return lambda: embedding_bag_cuda(st, ids, w, counts, block_rows=1)
    return lambda: gather_count_cuda(st, ids.reshape(-1), counts,
                                     block_rows=1)


@pytest.mark.parametrize("name", ["flash_attention", "embedding_bag",
                                  "gather_count"])
def test_cuda_wrappers_refuse_grad_before_anything_else(name):
    """The guard comes first: a CPU input that requires grad is refused for
    its gradient, not for its device; without grad the device check
    speaks."""
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        _wrapper_call(name, True)()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _wrapper_call(name, True)()
    with pytest.raises(ValueError, match="CUDA"):
        _wrapper_call(name, False)()


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120, env={"PATH": "/usr/bin:/bin",
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
