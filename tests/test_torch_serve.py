"""The port's serving path (``repro_torch.serve.engine``,
``repro_torch.launch.serve``) and the KV-cache scenario
(``repro_torch.scenarios.kv_cache``) vs the reference, with the reference's
``jax.random`` weights carried across (``convert.params_from_numpy``).

Tolerances: logits and caches as in ``test_torch_models.py`` — float32
activations 2e-5, bfloat16 1e-2 on logits and 2e-2 on the cache (one bf16
rounding of the same K/V).  ``kv_page_mass`` is an f32 sum of softmax
probabilities: 1e-5 with float32 activations (measured 1.8e-7), 5e-4
with bfloat16 (the bf16 keys and queries differ by a rounding; measured
5e-5).  Integer outputs — geometry, quantized counts, trajectories — are
exact: ``run_scenario`` fed the reference's epoch stream must give the
reference's trajectory JSON byte for byte."""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.scenarios import KVCacheScenario as JKV  # noqa: E402
from repro.scenarios import run_scenario as jrun  # noqa: E402
from repro.scenarios.kv_cache import quantize_access_counts as j_quantize  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.scenarios import KVCacheScenario as TKV  # noqa: E402
from repro_torch.scenarios import run_scenario as trun  # noqa: E402
from repro_torch.scenarios.kv_cache import quantize_access_counts  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ACTS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(logits=2e-5, cache=2e-5, mass=1e-5),
       "bfloat16": dict(logits=1e-2, cache=2e-2, mass=5e-4)}
KV_SMALL = dict(batch=2, n_epochs=5, batches_per_epoch=2,
                accesses_per_batch=1_024)


def setup(arch: str, act: str, seed: int = 0):
    jdt, tdt = ACTS[act]
    jc = dataclasses.replace(j_smoke(arch), activ_dtype=jdt)
    tc = dataclasses.replace(get_smoke_config(arch), activ_dtype=tdt)
    jp = jm.init_params(jc, jax.random.key(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internlm2-1.8b"])
def test_prefill_and_decode_step(arch, act):
    jc, tc, jp, tp = setup(arch, act)
    tol = TOL[act]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab_size, (2, 11))
    max_len, page = 13, 8                    # pages of 8 and 5 positions
    jl, jcache = jeng.prefill(jp, jc, tokens=jnp.asarray(toks),
                              max_len=max_len)
    tl, tcache = teng.prefill(tp, tc, tokens=torch.from_numpy(toks),
                              max_len=max_len)
    close(tl, jl, tol["logits"])
    for key in ("k", "v"):
        assert tcache[key].dtype == ACTS[act][1]
        close(tcache[key], jcache[key], tol["cache"])
    assert torch.equal(tcache["pos"], torch.full((2,), 11, dtype=torch.int32))

    nxt = rng.integers(0, jc.vocab_size, (2,))
    jl2, jcache2, jaux = jeng.decode_step(jp, jc, jcache,
                                         jnp.asarray(nxt, jnp.int32),
                                         page_size=page)
    k_before = tcache["k"].clone()
    tl2, tcache2, taux = teng.decode_step(tp, tc, tcache,
                                          torch.from_numpy(nxt),
                                          page_size=page)
    close(tl2, jl2, tol["logits"])
    close(tcache2["k"], jcache2["k"], tol["cache"])
    assert torch.equal(tcache2["pos"], tcache["pos"] + 1)
    mass = taux["kv_page_mass"]
    assert mass.shape == (tc.n_layers, 2, 2) and mass.dtype == torch.float32
    close(mass, jaux["kv_page_mass"], tol["mass"])
    # the ragged final page: page mass == the per-position mass summed over
    # each page's positions; n_heads per (layer, sequence) conserved; the
    # positions past the new token carry none.  tcache still holds pos 11,
    # so this step rewrites position 11 with the same K/V
    _, _, by_pos = teng.decode_step(tp, tc, tcache, torch.from_numpy(nxt),
                                    page_size=1)
    by_pos = by_pos["kv_page_mass"].double().numpy()
    np.testing.assert_allclose(mass[..., 0].double().numpy(),
                               by_pos[..., :page].sum(-1), rtol=1e-6)
    np.testing.assert_allclose(mass[..., 1].double().numpy(),
                               by_pos[..., page:].sum(-1), rtol=1e-6)
    np.testing.assert_allclose(mass.double().sum(-1).numpy(), tc.n_heads,
                               rtol=1e-3)
    assert np.all(by_pos[..., 12] == 0.0)
    # decode writes the new token into the cache it was given, in place,
    # and touches no other position
    assert tcache2["k"] is tcache["k"] and tcache2["v"] is tcache["v"]
    assert torch.all(k_before[:, :, :, 11] == 0)
    assert torch.any(tcache["k"][:, :, :, 11] != 0)
    k_before[:, :, :, 11] = tcache["k"][:, :, :, 11]
    assert torch.equal(tcache["k"], k_before)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internlm2-1.8b"])
def test_decode_telemetry_matches_reference_and_stepping(arch):
    jc, tc, jp, tp = setup(arch, "float32", seed=1)
    rng = np.random.default_rng(5)
    max_len, page, steps = 14, 4, 3
    toks = rng.integers(0, jc.vocab_size, (2, 9))
    _, jcache = jeng.prefill(jp, jc, tokens=jnp.asarray(toks), max_len=max_len)
    # the cache crosses too: decode from the reference's own prefill
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    np.testing.assert_array_equal(cache_to_numpy(tcache)["pos"],
                                  np.asarray(jcache["pos"]))
    step_toks = rng.integers(0, jc.vocab_size, (steps, 2))
    _, jmass = jeng.decode_telemetry(jp, jc, jcache, jnp.asarray(step_toks),
                                     page_size=page)
    # decode writes K/V in place: step from a copy, keep tcache for the
    # step-by-step run below
    final, tmass = teng.decode_telemetry(
        tp, tc, {key: t.clone() for key, t in tcache.items()},
        torch.from_numpy(step_toks), page_size=page)
    assert tmass.shape == jmass.shape == (steps, tc.n_layers, 2, 4)
    assert tmass.dtype == np.float64
    np.testing.assert_allclose(tmass, jmass, rtol=1e-5, atol=1e-5)
    cache = tcache
    for t in range(steps):
        _, cache, aux = teng.decode_step(tp, tc, cache,
                                         torch.from_numpy(step_toks[t]),
                                         page_size=page)
        np.testing.assert_array_equal(tmass[t],
                                      aux["kv_page_mass"].double().numpy())
    assert torch.equal(final["k"], cache["k"])
    np.testing.assert_allclose(tmass.sum(-1), tc.n_heads, rtol=1e-3)


@pytest.mark.parametrize("arch,batch,max_len,page", [
    ("internlm2-1.8b", 4, 43, 4), ("qwen2-0.5b", 2, 96, 16),
    ("llama3.2-3b", 3, 7, 8)])
def test_kv_page_geometry_matches_reference(arch, batch, max_len, page):
    for full in (False, True):
        jc = j_config(arch) if full else j_smoke(arch)
        tc = get_config(arch) if full else get_smoke_config(arch)
        assert (teng.kv_page_geometry(tc, batch, max_len, page)
                == jeng.kv_page_geometry(jc, batch, max_len, page))


# ------------------------------------------------------------ the KV scenario
@pytest.mark.parametrize("case", ["random", "ties", "zeros", "one_hot",
                                  "tiny_total", "negative"])
def test_quantize_access_counts_bit_identical(case):
    rng = np.random.default_rng(7)
    total = 4096
    if case == "random":
        w = rng.random((2, 3, 11)).astype(np.float32)
    elif case == "ties":
        w = np.repeat(rng.random(5), 7)                 # equal remainders
        total = 1000
    elif case == "zeros":
        w = np.zeros(13)
    elif case == "one_hot":
        w = np.eye(1, 9, 4).ravel()
    elif case == "tiny_total":
        w, total = rng.random(50), 3
    else:
        w = rng.normal(size=40)                         # negatives -> 0
    got = quantize_access_counts(w, total)
    want = j_quantize(w, total)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case != "zeros":
        assert got.sum() == total


@pytest.mark.parametrize("kw", [{}, KV_SMALL,
                                dict(arch="qwen2-0.5b", page_size=5,
                                     prefill_len=10, k_hot=7, shift_at=1)])
def test_kv_scenario_geometry_matches_reference(kw):
    j, t = JKV(**kw), TKV(device="cpu", **kw)
    for key in ("n_blocks", "k_hot", "shift_at", "pages_per_seq", "max_len",
                "bytes_per_access", "block_bytes", "pebs_period",
                "nb_scan_rate", "n_steps", "name"):
        assert getattr(t, key) == getattr(j, key), key
    assert dataclasses.asdict(t.system) == dataclasses.asdict(j.system)
    assert t.hint_layout() is None and j.hint_layout() is None


@pytest.fixture(scope="module")
def kv_pair():
    """The reference's small KV scenario (its stream made once) and the
    port's twin on the CPU with the reference's weights carried across."""
    j = JKV(**KV_SMALL)
    j_epochs = list(j.epochs())
    jp = jm.init_params(j.cfg, jax.random.key(j.seed))
    t = TKV(device="cpu", params=params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"), **KV_SMALL)
    return j, j_epochs, t


@pytest.mark.parametrize("hints", [False, True])
@pytest.mark.parametrize("sync_every", [1, 4])
def test_kv_run_scenario_on_reference_stream_byte_identical(kv_pair, hints,
                                                            sync_every):
    """The workload-blind runtime places the reference's KV stream exactly
    as the reference does (K=4 over 5 epochs: a full buffer and a tail)."""
    j, j_epochs, t = kv_pair
    want = jrun(j, hints=hints, sync_every=sync_every)
    with trt.counting() as c:
        got = trun(t, hints=hints, sync_every=sync_every, epochs=j_epochs,
                   device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert c.dispatch["record_sync"] == math.ceil(t.n_epochs / sync_every)


def test_kv_scenario_own_stream_follows_the_reference(kv_pair):
    """The port's own decode loop (carried weights, bf16 smoke model): its
    masses are within tolerance of the reference's, its stream has the
    reference's shape and totals.  The per-step counts may differ where a
    last-bit mass difference flips a largest-remainder rounding; that
    count is bounded, not zero."""
    j, j_epochs, t = kv_pair
    t_epochs = list(t.epochs())
    assert len(t_epochs) == len(j_epochs) == t.n_epochs
    jp = jm.init_params(j.cfg, jax.random.key(j.seed))
    prompt_rng = np.random.default_rng(j.seed)
    prompt = prompt_rng.integers(0, j.cfg.vocab_size, (j.batch, j.prefill_len))
    _, cache = jeng.prefill(jp, j.cfg, tokens=jnp.asarray(prompt, jnp.int32),
                            max_len=j.max_len)
    steps = prompt_rng.integers(0, j.cfg.vocab_size, (j.n_steps, j.batch))
    _, j_mass = jeng.decode_telemetry(jp, j.cfg, cache,
                                      jnp.asarray(steps, jnp.int32),
                                      page_size=j.page_size)
    np.testing.assert_allclose(t.masses, j_mass, rtol=5e-4, atol=5e-4)
    flips = 0
    for a, b in zip(t_epochs, j_epochs):
        assert a.shape == b.shape and a.dtype == b.dtype
        for row_a, row_b in zip(a, b):
            ca = np.bincount(row_a, minlength=t.n_blocks)
            cb = np.bincount(row_b, minlength=t.n_blocks)
            flips += int(np.abs(ca - cb).sum())
    assert flips <= 0.01 * t.n_steps * t.accesses_per_batch


# --------------------------------------------------------------- entry points
def test_serve_launcher_runs_end_to_end_on_the_cpu(capsys):
    rep = tserve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "21", "--gen", "6",
                       "--page-size", "8"])
    out = capsys.readouterr().out
    for line in ("prefill: 2x21 in", "decode: 5 steps in",
                 "sample generation (row 0):", "[kv-tiering] 4 pages/seq",
                 "[kv-tiering] modeled cache-read time"):
        assert line in out
    assert rep["tokens"].shape == (2, 6)
    assert rep["page_mass"].shape == (4,)
    # 5 decode steps x 2 layers x 2 sequences x n_heads of mass, conserved
    np.testing.assert_allclose(rep["page_mass"].sum(), 5 * 2 * 2 * 4,
                               rtol=1e-3)
    assert all(math.isfinite(rep[k]) for k in ("prefill_tok_s",
                                               "decode_tok_s",
                                               "modeled_tiered_s"))


def test_serve_module_entry_point_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "internlm2-1.8b", "--smoke", "--device", "cpu", "--gen", "3"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "decode: 2 steps" in out.stdout


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: tserve.main(["--arch", "qwen2-0.5b", "--smoke"]),
    lambda: TKV(),
    lambda: init_params(get_smoke_config("qwen2-0.5b")),
    lambda: teng.init_cache(get_smoke_config("qwen2-0.5b"), 1, 4),
], ids=["serve.main", "KVCacheScenario", "init_params", "init_cache"])
def test_serving_entry_points_default_to_cuda(monkeypatch, entry):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()

