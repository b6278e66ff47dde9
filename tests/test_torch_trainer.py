"""The port's trainer (``repro_torch.launch.train``) on the CPU, at
smoke size: every family's smoke config takes steps, a run resumed from
its step-6 checkpoint continues to the uninterrupted run's losses exactly
(the CPU's sums are deterministic), a preempted run checkpoints and a
second run finishes it, and the trainer prints the reference's lines.  The
100M example runs one step.  Everything here is exact or structural, so
there is no tolerance to state."""
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.launch import train  # noqa: E402

SMOKE = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32"]


def _run(tmp, *extra, arch="qwen2-0.5b"):
    return train.main(["--arch", arch, *SMOKE, "--steps", "12",
                       "--ckpt-every", "6", "--ckpt-dir", str(tmp), *extra])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_trains_through_the_trainer(arch, capsys):
    rep = train.main(["--arch", arch, *SMOKE, "--steps", "3"])
    assert rep["start_step"] == 0 and len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"])) and all(
        g > 0 for g in rep["grad_norms"])
    out = capsys.readouterr().out
    assert re.search(r"^step 2: loss=\d+\.\d{4} lr=\d\.\d\de-\d\d "
                     r"gnorm=\d+\.\d{3} \d+ms$", out, re.M), out
    assert "done: 3 steps in" in out


def test_resume_reproduces_the_uninterrupted_run_exactly(tmp_path, capsys):
    full = _run(tmp_path / "a")
    assert (tmp_path / "a" / "step_00000012").is_dir()
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000006",
                    tmp_path / "b" / "step_00000006")
    resumed = _run(tmp_path / "b", "--resume")
    assert resumed["start_step"] == 6
    assert resumed["losses"] == full["losses"][6:]
    assert resumed["grad_norms"] == full["grad_norms"][6:]
    out = capsys.readouterr().out
    assert "resumed from step 6" in out
    assert re.search(r"^\[tiering\] step 9: promoted \d+ blocks, hit=[\d.]+% "
                     r"tiered=\d+us all_fast=\d+us all_slow=\d+us$", out,
                     re.M), out


def test_preempted_run_checkpoints_and_a_second_run_finishes(tmp_path,
                                                             monkeypatch):
    class Preempted(train.PreemptionGuard):
        def __init__(self):
            super().__init__(install=False)
            self.trigger()
    full = _run(tmp_path / "a")
    monkeypatch.setattr(train, "PreemptionGuard", Preempted)
    first = _run(tmp_path / "b")
    assert first["preempted"] and len(first["losses"]) == 1
    monkeypatch.undo()
    rest = _run(tmp_path / "b", "--resume")
    assert rest["start_step"] == 1
    assert first["losses"] + rest["losses"] == full["losses"]


def test_grad_accum_flag(tmp_path):
    rep = train.main(["--arch", "llama3.2-3b", *SMOKE, "--steps", "2",
                      "--grad-accum", "2"])
    assert len(rep["losses"]) == 2 and all(np.isfinite(rep["losses"]))


def test_trainer_puts_the_signal_handlers_back():
    import signal
    before = signal.getsignal(signal.SIGTERM)
    train.main(["--arch", "qwen2-0.5b", *SMOKE, "--steps", "1"])
    assert signal.getsignal(signal.SIGTERM) == before


def test_100m_example_takes_a_step(tmp_path, capsys):
    """The reference example's llama-100m (its module, loaded from
    ``examples/``), one step on the CPU."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / "train_100m.py"
    spec = importlib.util.spec_from_file_location("ref_train_100m", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want, got = ref.config_100m(), train_100m.config_100m()
    assert got.param_count() == want.param_count()
    assert {k: v for k, v in got.__dict__.items() if "dtype" not in k} == {
        k: v for k, v in want.__dict__.items() if "dtype" not in k}
    rep = train_100m.main(["--steps", "1", "--batch", "1", "--seq", "16",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(rep["losses"]) == 1 and np.isfinite(rep["losses"][0])
    assert "model: llama-100m  params=100.1M" in capsys.readouterr().out
    assert (tmp_path / "step_00000001").is_dir()
