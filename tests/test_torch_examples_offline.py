"""The two top-level examples on the port: ``python -m
repro_torch.examples.quickstart`` and ``... hinted_prefetch`` with
``--device cpu`` print exactly what ``examples/quickstart.py`` and
``examples/hinted_prefetch.py`` print, line for line.

Tolerance: exact — the comparison is of the printed text."""
import contextlib
import io
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()

from repro_torch.examples import hinted_prefetch, quickstart  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


@pytest.mark.parametrize("name,port", [("quickstart", quickstart),
                                       ("hinted_prefetch", hinted_prefetch)])
def test_port_example_prints_what_the_reference_prints(name, port):
    want = _stdout(lambda: runpy.run_path(str(EXAMPLES / f"{name}.py"),
                                          run_name="__main__"))
    got = _stdout(lambda: port.main(["--device", "cpu"]))
    assert got.splitlines() == want.splitlines()
    assert got.strip()


@pytest.mark.parametrize("port", [quickstart, hinted_prefetch])
def test_port_example_defaults_to_the_card(monkeypatch, port):
    """Without ``--device`` the example runs on the card, so without one
    it raises, as every entry point does."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.main([])
