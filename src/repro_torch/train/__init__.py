"""Training (the port of ``repro/train``): loss and step functions, gradient
accumulation, gradient compression."""
