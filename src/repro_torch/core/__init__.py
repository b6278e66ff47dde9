"""repro_torch.core — the online tiering runtime's modules (PyTorch port of
``repro/core``): cost model, metrics, selection, telemetry, policies,
placement and the fused epoch runtime."""
