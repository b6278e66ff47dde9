"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It grows beside the JAX package, which stays the reference it is held
against, and imports neither JAX nor anything of ``repro``.  Entry points
(``scenarios.run_scenario``, ``scenarios.run_online``,
``fleet.run_fleet``, ``core.runtime.EpochRuntime``) run on the CUDA device
by default and raise without one; the CPU runs only when the caller passes
``device="cpu"``.
"""
__version__ = "0.1.0"
