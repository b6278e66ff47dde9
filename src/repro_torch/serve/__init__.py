"""Serving runtime (PyTorch port of ``repro/serve``): prefill/decode for the
dense family with the tiered-KV telemetry hook."""
