"""Model substrate (PyTorch port of ``repro/models``): the dense
decoder-only transformer family, its layers and its attention paths."""
