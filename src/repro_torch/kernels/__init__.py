"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see :mod:`repro_torch.kernels.dispatch` for the dispatch rule and
:mod:`repro_torch.kernels._build` for how the CUDA sources are built)."""
