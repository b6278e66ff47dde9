"""Launchers (PyTorch port of ``repro/launch``): the batched serving
launcher and the trainer."""
