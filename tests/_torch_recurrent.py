"""Shared by ``test_torch_rwkv6.py`` and ``test_torch_zamba2.py``: the smoke
configs on both sides, perturbed weights (``_perturbed_weights``) carried
across, and the comparison helpers."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy

from _perturbed_weights import perturbed_tree

ACTS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# test_torch_models.py's bfloat16 tolerances: the frameworks round the same
# bf16 products at other places
BF16_HIDDEN_TOL, BF16_LOGIT_TOL = 6e-2, 1e-2
BF16_WITHIN = 0.99


def carried(arch: str, act: str, seed: int = 0):
    """(reference config, port config, reference params, port params): the
    smoke config with activations ``act`` and one perturbed draw on both
    sides."""
    jdt, tdt = ACTS[act]
    jc = dataclasses.replace(j_smoke(arch), activ_dtype=jdt)
    tc = dataclasses.replace(get_smoke_config(arch), activ_dtype=tdt)
    tree = perturbed_tree(jm.iter_schema(jc), seed)
    return (jc, tc, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def both(x: np.ndarray, act: str):
    """One numpy array as the same values in both frameworks' dtype."""
    jdt, tdt = ACTS[act]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def close(got: torch.Tensor, want, tol: float, act: str = "float32"
          ) -> None:
    """|got - want| <= tol + tol |want| everywhere in float32.  With
    bfloat16 activations on at least BF16_WITHIN of the elements, and
    within twice that everywhere: the reference's own bfloat16 run lies up
    to 0.10 / 0.055 (hidden, rwkv6 / zamba2) and 0.014 / 0.008 (logits)
    from its float32 run on these weights (S 19 and 150), so two bfloat16
    runs that round at other places land that far apart, above the 6e-2 /
    1e-2 of a few elements (``bf16_error_within_the_references``
    bounds them from the other side)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if act == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    assert np.isfinite(got).all()
    diff, bound = np.abs(got - want), tol + tol * np.abs(want)
    assert (diff <= 2 * bound).all(), float((diff / bound).max())
    assert (diff <= bound).mean() >= BF16_WITHIN, (diff <= bound).mean()


def bf16_error_within_the_references(bf: dict, f32: dict) -> None:
    """The port's bfloat16 run lies no farther from the reference's float32
    run than twice the reference's own bfloat16 run does: the final hidden
    states and each decode step's logits (``_run_both``'s dicts of one S;
    measured at most 1.73x)."""
    pairs = [(bf["hidden"][0], bf["hidden"][1], f32["hidden"][1])]
    pairs += [(b[0], b[3], f[3]) for b, f in zip(bf["decode"], f32["decode"])]
    for port, ref, truth in pairs:
        truth = np.asarray(truth, np.float32)
        port_err = np.abs(port.float().numpy() - truth).max()
        ref_err = np.abs(np.asarray(ref, np.float32) - truth).max()
        assert 0 < port_err <= 2 * ref_err, (port_err, ref_err)


def layer(tree, i: int):
    """Layer ``i``'s slice of a stacked ``blocks`` dict (either side)."""
    return {k: v[i] for k, v in tree["blocks"].items()}

