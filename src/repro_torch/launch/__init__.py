"""Launchers (PyTorch port of ``repro/launch``): the batched serving launcher."""
