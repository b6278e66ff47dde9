"""Perturbed weights for the recurrent families' parity checks (numpy
only, so the card tests, which import no JAX, use it too).

The reference's init zeroes exactly the leaves that make the recurrent
blocks interesting (rwkv6: the token-shift mixes, the decay and shift
LoRAs' second factors, the bonus; zamba2: the conv bias, ``dt_bias`` and
every shared-block LoRA's second factor), so a parity check on init weights
would pass with those terms wrong.  ``perturbed_tree`` fills every leaf
from a seeded numpy draw instead: weight matrices at the reference's init
scale, the token-shift mixes U(0, 1), the decay offset ``w0`` U(-3, 1) and
``a_log`` U(-2, 1) (per-step decays from 0.95 down to 0.07, so the state
carried across a chunk matters), the bonus ``u`` and ``dt_bias`` N(0,
0.5), scales 1 + N(0, 0.1) and the other zero leaves N(0, 0.02)."""
from __future__ import annotations

import numpy as np


def perturbed_tree(schema, seed: int = 0) -> dict:
    """Every leaf of ``schema`` (``iter_schema(cfg)`` of either package:
    (dotted path, LeafSpec) pairs) drawn from ``seed``, as a nested dict of
    float32 numpy arrays in the reference's layout."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, spec in schema:
        name, shape = path.split(".")[-1], spec.shape
        if name in ("tm_mu", "f_mu_k", "f_mu_r"):
            val = rng.uniform(0.0, 1.0, shape)
        elif name == "w0":
            val = rng.uniform(-3.0, 1.0, shape)
        elif name == "a_log":
            val = rng.uniform(-2.0, 1.0, shape)
        elif name in ("u", "dt_bias"):
            val = rng.normal(0.0, 0.5, shape)
        elif spec.init == "ones":
            val = 1.0 + rng.normal(0.0, 0.1, shape)
        elif spec.init == "zeros":
            val = rng.normal(0.0, 0.02, shape)
        else:
            scale = 0.02 if spec.init == "normal" else 0.006
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            val = rng.normal(0.0, min(scale, fan_in ** -0.5), shape)
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val.astype(np.float32)
    return tree
