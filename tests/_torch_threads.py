"""One intra-op thread budget for the port's tests under pytest-xdist.

Each xdist worker is a process of its own, and torch gives every process
as many intra-op threads as the machine has CPUs; N workers then run N
times that many threads on the same CPUs, and a test whose ops are small
spends most of its time switching between them.  ``limit`` gives each
worker an equal share of the CPUs (at least one thread) when
``PYTEST_XDIST_WORKER_COUNT`` is set, and leaves a single-process run as
it is.  The port's test files call it right after importing torch."""
import os

import torch

__all__ = ["limit"]


def limit() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers > 0:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
