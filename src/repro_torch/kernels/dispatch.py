"""Dispatch rule for the port's hand-written Hopper kernels.

Every kernel package in ``repro_torch.kernels`` follows the reference
package's triad — ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the CUDA wrapper around ``csrc/*.cu``), ``ops.py`` (dispatch) — and the
core integration points (``selectk``, ``telemetry``, ``runtime``) all make
the same choice the same way, from the tensor they hold:

* a CUDA tensor launches the hand-written kernel, or the call raises — no
  path falls back to the plain version on the card;
* a CPU tensor runs the plain version (how the CPU parity tests reach the
  kernels' arithmetic);
* ``KernelBackend(plain=True)`` is an explicit override that runs the plain
  version on a CUDA tensor too.  Only ``chip_smoke.py`` sets it, to time
  the plain version on the card; nothing sets it implicitly;
* a CUDA wrapper has no backward, so one whose output would need a
  gradient raises (:func:`refuse_grad`) rather than return an output that
  silently carries none.  Training carries attention's gradient through
  ``models.attention.flash_train``, which calls
  ``kernels.flash_attention.FlashAttentionFn`` (the kernel's forward, a
  plain backward); the direct wrappers still refuse.  The plain versions
  stay differentiable.

:class:`KernelBackend` mirrors the reference's ``PallasBackend``: hashable,
so it rides in the runtime's static config.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["DEFAULT_BACKEND", "KernelBackend", "refuse_grad",
           "resolve_device", "use_kernel"]


class KernelBackend(NamedTuple):
    """Static (hashable) kernel-dispatch config.

    ``plain`` — run the plain PyTorch version even on a CUDA tensor (the
    explicit timing override; never taken silently)."""
    plain: bool = False


DEFAULT_BACKEND = KernelBackend()


def resolve_device(device) -> torch.device:
    """The entry points' device rule: ``"cuda"`` (their default) needs a
    CUDA device and raises without one; the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions on "
                "the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def use_kernel(t: torch.Tensor, backend: KernelBackend = DEFAULT_BACKEND,
               ) -> bool:
    """True when ``t``'s op must launch its kernel, False for the plain
    version (a CPU tensor, or the explicit ``plain`` override)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return not backend.plain


def refuse_grad(kernel: str, *inputs: Optional[torch.Tensor]) -> None:
    """Raise when grad mode is on and a floating input requires grad: the
    kernel's output could carry no gradient back to it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.is_floating_point() and t.requires_grad
            for t in inputs):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the kernel has no "
            f"backward; call it under torch.no_grad() or on detached "
            f"inputs (models.attention.flash_train carries attention's "
            f"gradient through FlashAttentionFn)")
