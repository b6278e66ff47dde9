"""Async, mesh-agnostic checkpointing (the port of
``repro/checkpoint/manager.py``, on the same on-disk layout: a checkpoint
written by either package restores in the other).

Layout (one directory per step):
    ckpt_dir/
      step_000123.tmp/            # written first
        manifest.json              # tree structure, shapes, dtypes, step,
                                   # data-pipeline state, mesh shape at save
        arr_<idx>.npy              # one file per leaf (per-host shard in a
                                   # real multi-host run; full array here)
      step_000123/                 # atomic rename on completion -> publish

Design points for 1000+-node runs:
  * **Atomic publish**: readers only ever see complete checkpoints (tmp dir
    renamed after fsync of every file + manifest) — a preempted save never
    corrupts the latest-good pointer.
  * **Async**: `save()` snapshots to host memory synchronously (cheap) and
    writes in a background thread, overlapping the next training steps;
    `wait()` joins before the next save or exit.
  * **Restore anywhere**: arrays are stored unsharded-logical (per-leaf
    global layout) in the reference's leaf order (``repro_torch.pytree``:
    dict keys sorted, namedtuple fields in order); ``restore(device=)``
    puts them on a device, ``restore(shardings=)`` lays them out on a mesh
    (any mesh: the one they were saved from or another).  A tree of
    DTensors saves each leaf's full array: every rank of its mesh gathers
    (``repro_torch.launch.sharding.full``) and rank 0 of the default
    group writes.
  * **Retention**: keep_last N checkpoints, garbage-collect older.
"""
from __future__ import annotations

import json
import shutil
import sys
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..pytree import flatten


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` (pytree of arrays) and write asynchronously.
        A tree holding DTensors is gathered on every rank, and only rank 0
        of the default group writes: a restore on another rank waits for
        that write (rank 0's ``wait()``, then a barrier)."""
        self.wait()
        leaves, skeleton = flatten(tree)
        if any(_is_dtensor(x) for x in leaves):
            from ..launch.sharding import full
            leaves = [full(x) if _is_dtensor(x) else x for x in leaves]
            if dist.get_rank() != 0:
                return
        # synchronous host snapshot: training can mutate buffers afterwards
        host_leaves = [_host(x) for x in leaves]
        meta = {
            "step": int(step),
            "treedef": skeleton,
            "extra": extra or {},
            "time": time.time(),
        }

        def _write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for i, arr in enumerate(host_leaves):
                    np.save(tmp / f"arr_{i}.npy", arr)
                (tmp / "manifest.json").write_text(json.dumps({
                    "step": meta["step"],
                    "tree": _encode_tree(meta["treedef"]),
                    "n_arrays": len(host_leaves),
                    "extra": meta["extra"],
                    "time": meta["time"],
                }))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)                  # atomic publish
                self._gc()
            except BaseException as e:             # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Returns (tree, extra): numpy arrays, tensors on ``device`` when
        one is given, or DTensors laid out by ``shardings`` (a tree of
        :class:`repro_torch.launch.sharding.NamedSharding` like the saved
        one; its namedtuples are read by field, as the tree restores
        them), each rank keeping its own blocks."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays = [np.load(d / f"arr_{i}.npy")
                  for i in range(manifest["n_arrays"])]
        if device is not None:
            arrays = [torch.from_numpy(a).to(device) for a in arrays]
        tree = _decode_tree(manifest["tree"], arrays)
        if shardings is not None:
            from ..launch.sharding import distribute
            tree = distribute(tree, _fields_as_dicts(shardings))
        return tree, manifest["extra"]

    # ------------------------------------------------------------------- gc
    def _gc(self):
        steps = sorted(p for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for p in steps[: -self.keep_last]:
            shutil.rmtree(p, ignore_errors=True)


def _host(x) -> np.ndarray:
    """A leaf's host copy: a tensor is copied off its device (or copied on
    the CPU, so that a later in-place update cannot reach the snapshot)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported (which takes seconds)
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _fields_as_dicts(t):
    """Namedtuples -> dicts keyed by field, as :func:`_decode_tree`
    restores them."""
    if hasattr(t, "_fields"):
        return {k: _fields_as_dicts(v) for k, v in t._asdict().items()}
    if isinstance(t, dict):
        return {k: _fields_as_dicts(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_fields_as_dicts(v) for v in t)
    return t


def _encode_tree(t):
    if isinstance(t, dict):
        return {"__d": {k: _encode_tree(v) for k, v in t.items()}}
    if hasattr(t, "_fields"):   # namedtuple (check before tuple!)
        return {"__n": type(t).__name__,
                "__f": {k: _encode_tree(v) for k, v in t._asdict().items()}}
    if isinstance(t, (list, tuple)):
        tag = "__l" if isinstance(t, list) else "__t"
        return {tag: [_encode_tree(v) for v in t]}
    return int(t)


def _decode_tree(t, arrays):
    if isinstance(t, dict):
        if "__d" in t:
            return {k: _decode_tree(v, arrays) for k, v in t["__d"].items()}
        if "__l" in t:
            return [_decode_tree(v, arrays) for v in t["__l"]]
        if "__t" in t:
            return tuple(_decode_tree(v, arrays) for v in t["__t"])
        if "__n" in t:
            # namedtuples restore as plain dicts keyed by field (callers that
            # need the concrete type re-wrap; OptState handled in launch/train.py)
            return {k: _decode_tree(v, arrays) for k, v in t["__f"].items()}
    return arrays[int(t)]
