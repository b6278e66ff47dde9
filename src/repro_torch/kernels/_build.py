"""Build the port's CUDA sources into shared libraries at first use.

Each kernel's source, ``kernels/<name>/csrc/<name>.cu``, exposes a plain C
entry point.  ``nvcc`` compiles it for Hopper (``sm_90a``) into
``build/kernels/<name>-<hash>.so`` at the repository root (a git-ignored
directory), keyed by a hash of every file under the kernel's ``csrc/`` (the
``.cu`` and the headers it includes) and of the flags ``nvcc`` is given, so
a changed source, header or flag rebuilds and an unchanged one is loaded as
it is.  The library is bound with
``ctypes``; nothing here includes PyTorch's headers, which keeps ``nvcc``
fast.  :func:`build_all` starts one ``nvcc`` per missing library, all at
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "library_path", "load"]

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
SOURCES: Dict[str, Path] = {
    name: _KERNELS / name / "csrc" / f"{name}.cu"
    for name in ("observe_scatter", "hist_select", "gather_count",
                 "embedding_bag", "flash_attention")
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    csrc = SOURCES[name].parent
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(b"\0" + f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process each, in parallel.  Returns the seconds each build
    took (0.0 for a library that was already built); the ``ptxas`` report
    of registers and shared memory lands beside it as ``<lib>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    took = {name: 0.0 for name in names}
    errors = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
