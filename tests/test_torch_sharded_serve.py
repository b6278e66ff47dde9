"""Sharded serving (``serve.engine.prefill(mesh=)`` / ``decode_step(mesh=)``
through ``serve.sharded``) at (2, 2), (1, 4) and (4, 1) ("data", "model")
gloo meshes and at a batch of one, against the port's single-device
``prefill`` + ``decode_step`` and against the reference's single-device
``engine.prefill`` / ``decode_step`` (jitted) on the same weights.

The params are laid out by ``model_pspecs`` (FSDP over "data", heads /
MLP / vocabulary over "model"), the cache by ``cache_pspecs``: the KV
heads over "model" at (2, 2) (and zamba2's at (1, 4)), the sequence over
"model" where they do not divide it (the decode's log-sum-exp combine
over "model"), and over "data" too at a batch of one (the combine over
"data").  Families: dense (llama3.2-3b, and qwen2-0.5b tied with qkv
bias), a variant whose heads the rules cut, Mixtral (its override puts
``expert_mlp`` on "model": every expert on the rank's block of
``d_expert`` at prefill and at decode, never gathered over "model"; a
window of 6) and kimi-k2 (experts on "model": expert parallel at
prefill, each rank's experts' slots at decode), zamba2 and rwkv6 (each
rank running its heads of every Mamba2 and RWKV-6 mix, rwkv6's channel
mix on its blocks; at (1, 4) rwkv6's 2 heads give two ranks none and its
wkv state rests whole, joined from the ranks' heads; their states
otherwise the rank's block over "model").  The reference's
own sharded paths raise on this jax
(``tests/test_distribution.py::test_serve_decode_compiles_sharded``), so
the single-device functions of either package are the oracle.  The
reference's decode chain starts from the port's prefill cache, carried
across: its rwkv6 prefill stores another token shift (ROADMAP Queue 3;
``tests/test_torch_rwkv6.py``), and its prefill cache is held to the
port's leaf by leaf, that leaf left out.

One spawn of 4 gloo ranks (``tests/_torch_sharded_serve_worker.py``, which
imports only ``repro_torch``) serves the module; this process takes the
single-device runs of both packages meanwhile.

Tolerances (float32; PERF.md §2's sharded-serving bounds): the logits of
every call within 1e-5 of their largest magnitude; every cache leaf, whole
and each rank's block against its block of the single-device cache, within
1e-5 of the leaf's largest magnitude; the page masses within 1e-6; ``pos``,
the expert counts, the blocks' shapes and the collectives' counts exact."""
import dataclasses
import functools
import json
import multiprocessing
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402
_torch_threads.limit()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_sharded_serve_worker as sw  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models.model import tp_layout  # noqa: E402
from repro_torch.pytree import tree_map  # noqa: E402
from repro_torch.serve.sharded import serve_config  # noqa: E402

LOGITS_TOL_OF_MAX, CACHE_TOL_OF_MAX, MASS_TOL = 1e-5, 1e-5, 1e-6
CASES = list(sw.CASES)


class _Ranks:
    """The spawned ranks: started once, joined on first read."""

    def __init__(self, tmp):
        self.out = str(tmp)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=sw.worker,
                                  args=(r, str(tmp / "store"), self.out))
                      for r in range(sw.N_RANKS)]
        for p in self.procs:
            p.start()
        self.joined = False

    def join(self):
        if not self.joined:
            for p in self.procs:
                p.join(timeout=300)
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
            self.joined = True
        errors = [f for f in os.listdir(self.out) if f.endswith(".error")]
        for name in errors:
            with open(os.path.join(self.out, name)) as f:
                print(name, f.read())
        assert not errors, errors

    def results(self, case: str) -> list:
        self.join()
        got = []
        for r in range(sw.N_RANKS):
            with open(os.path.join(self.out, f"{case}.{r}.json")) as f:
                got.append(json.load(f))
        return got

    def arrays(self, case: str) -> dict:
        self.join()
        with np.load(os.path.join(self.out, f"{case}.npz")) as z:
            return dict(z)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("sharded_serve"))
    yield r
    for p in r.procs:
        if p.is_alive():
            p.terminate()


class FakeMesh:
    """A stand-in mesh: the rules read only ``shape``."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


def as_arrays(logits, first, last, auxes) -> dict:
    """A run's outputs in the worker's ``<case>.npz`` form."""
    out = {f"logits/{i}": np.asarray(x) for i, x in enumerate(logits)}
    for when, cache in (("first", first), ("last", last)):
        out.update({f"{when}/{k}": np.asarray(v) for k, v in cache.items()})
    for i, aux in enumerate(auxes):
        out.update({f"aux/{i}/{k}": np.asarray(v) for k, v in aux.items()})
    return out


@functools.cache
def single_device(case: str) -> dict:
    """The port's prefill and decode steps without a mesh."""
    cfg = sw.config(case)
    params = tree_map(torch.from_numpy, sw.params_np(cfg))
    toks = torch.from_numpy(sw.tokens_np(case))
    return as_arrays(*sw.single_device(cfg, params, toks))


@functools.lru_cache(maxsize=None)
def _reference_fns(arch: str, changes: tuple):
    jc = dataclasses.replace(j_smoke(arch), param_dtype=jnp.float32,
                             activ_dtype=jnp.float32, **dict(changes))
    if jc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=sw.CAPACITY_FACTOR))
    prefill = jax.jit(lambda p, t: j_engine.prefill(p, jc, tokens=t,
                                                    max_len=sw.MAX_LEN))
    decode = jax.jit(lambda p, c, t: j_engine.decode_step(
        p, jc, c, t, page_size=sw.PAGE))
    return prefill, decode


@functools.cache
def reference(case: str) -> dict:
    """The reference's prefill of the prompt and its decode steps from the
    port's single-device prefill cache, on the same weights."""
    arch, _, _, changes = sw.CASES[case]
    prefill, decode = _reference_fns(arch, tuple(sorted(changes.items())))
    params = jax.tree.map(jnp.asarray, sw.params_np(sw.config(case)))
    toks = sw.tokens_np(case)
    logits, first = prefill(params, jnp.asarray(toks[:, :sw.PROMPT]))
    one = single_device(case)
    cache = {k[len("first/"):]: jnp.asarray(v) for k, v in one.items()
             if k.startswith("first/")}
    out, auxes = [logits], []
    for t in range(sw.DECODE_STEPS):
        lg, cache, aux = decode(params, cache,
                                jnp.asarray(toks[:, sw.PROMPT + t]))
        out.append(lg)
        auxes.append(aux)
    return as_arrays(out, first, cache, auxes)


def assert_close_of_max(got, want, tol: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def assert_outputs(got: dict, want: dict) -> None:
    """Logits, caches, page masses and expert counts at the module's
    bounds."""
    assert sorted(got) == sorted(want)
    for k in want:
        leaf = k.split("/")[-1]
        if k.startswith("logits/"):
            assert_close_of_max(got[k], want[k], LOGITS_TOL_OF_MAX, k)
        elif leaf in ("pos", "expert_counts"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif leaf == "kv_page_mass":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=MASS_TOL, err_msg=k)
        else:
            assert_close_of_max(got[k], want[k], CACHE_TOL_OF_MAX, k)


@pytest.mark.parametrize("case", CASES)
def test_sharded_serving_matches_the_single_device_port(ranks, case):
    """The gathered logits of every call, the cache after the prefill and
    after the last decode step, the page masses and expert counts: the
    port's single-device run's."""
    assert_outputs(ranks.arrays(case), single_device(case))


@pytest.mark.parametrize("case", CASES)
def test_sharded_serving_matches_the_reference(ranks, case):
    """The same outputs against the reference's single-device engine
    (rwkv6's prefill token shift ``sh_ffn`` left out: module doc)."""
    drop = {"first/sh_ffn"} if sw.CASES[case][0] == "rwkv6-3b" else set()
    got, want = ranks.arrays(case), reference(case)
    assert_outputs({k: v for k, v in got.items() if k not in drop},
                   {k: v for k, v in want.items() if k not in drop})


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_block_of_the_cache(ranks, case):
    """Each rank's cache, after the prefill and after the last step, is
    its block of the single-device cache as DTensor lays the cache's
    specs out, leaf by leaf within 1e-5 of the leaf's largest magnitude;
    each block's shape is the whole leaf's cut by the specs' axes."""
    _, shape, b, _ = sw.CASES[case]
    cfg = sw.config(case)
    sizes = dict(zip(("data", "model"), shape))
    specs = sh.cache_pspecs(FakeMesh(shape), cfg, b, sw.MAX_LEN)
    for res in ranks.results(case):
        for when in ("blocks_prefill", "blocks_last"):
            for leaf, (err, top) in res[when].items():
                assert err <= CACHE_TOL_OF_MAX * max(top, 1e-30), (when, leaf,
                                                                   err)
        for leaf, (local, whole) in res["block_shapes"].items():
            want = [n // int(np.prod([sizes[a] for a in
                                      sh.entry_axes(e)] or [1]))
                    for n, e in zip(whole, specs[leaf])]
            assert local == want, (leaf, local, whole)


def expected_collectives(case: str, kind: str) -> Counter:
    """``{(kind, axis): calls}`` of one sharded ``kind`` call, worked out
    from the config and the layouts: each leaf gathered once a use over
    each axis that cuts it (but "model" for a leaf the rank keeps as its
    block there); the tensor-parallel all-reduces (the attention's and
    the dense MLP's outputs, the embedding) and the logits' all-gather
    over "model"; at prefill, q gathered where the rules cut a head, and
    the MoE's (the whole batch's routing: one gather of the slices'
    counts over each batch axis; expert parallel: q's sequence slices back
    over "model" and two all-to-alls; expert tensor parallel: the partial
    outputs summed over "model"); at decode, q gathered where the
    rank does not hold its KV heads, the combine's three all-reduces over
    each axis of the cache's sequence, the page mass summed over the
    ranks' heads, the experts' slots or the expert-tensor-parallel
    outputs summed over "model", and each
    recurrent state the mix does not read as the rank's heads (Mamba2's
    conv state) gathered over the axes that cut it.  RWKV-6's and
    Mamba2's mixes on the rank's heads, at both: one all-reduce over
    "model" of each mix's output, Mamba2's sum of squares one more, the
    heads' states joined in one more where they do not divide "model";
    RWKV-6's channel mix one reduce-scatter and one all-gather over
    "model"."""
    arch, shape, b, _ = sw.CASES[case]
    cfg = sw.config(case)
    mesh = FakeMesh(shape)
    sizes = mesh.shape
    over = sw.overrides(case)
    scfg = serve_config(cfg, mesh, b, sw.PROMPT if kind == "prefill"
                        else sw.MAX_LEN, kind, over)
    local, _ = sh.leaf_roles(scfg, mesh, over)
    pspecs = sh.model_pspecs(mesh, cfg, over)
    fam, n_layers = cfg.family, cfg.n_layers
    n_attn = {"attn": n_layers, "moe": n_layers, "rwkv6": 0,
              "zamba2": cfg.n_shared_attn}[fam]
    out = Counter()

    def walk(spec, loc, path):
        if isinstance(spec, sh.PartitionSpec):
            uses = {"embed": 2 if cfg.tie_embeddings else 1}.get(path, 1)
            if path.startswith("blocks."):
                uses = n_layers
            elif path.startswith("shared_attn."):
                uses = cfg.n_shared_attn
            for e in spec:
                for a in sh.entry_axes(e):
                    if sizes[a] > 1 and not (a == "model" and loc):
                        out[("all_gather", a)] += uses
            return
        for k in spec:
            walk(spec[k], loc[k], f"{path}.{k}" if path else k)
    walk(pspecs, local, "")
    m = sizes["model"]
    heads, kv, mlp, vocab, experts, mix, ffn = (
        tp_layout(scfg, m) if scfg.tp_axes
        else (None, None, False, False, False, None, False))
    if vocab:
        out[("all_gather", "model")] += 1
        out[("all_reduce", "model")] += 1
    if heads:
        out[("all_reduce", "model")] += n_attn
    if mlp:
        out[("all_reduce", "model")] += n_attn if fam == "zamba2" \
            else n_layers
    if experts:
        out[("all_reduce", "model")] += n_layers
    bax = [a for a in scfg.act_batch_axes or () if sizes[a] > 1]
    if fam == "moe":
        for a in bax:
            out[("all_gather", a)] += n_layers
    if mix:
        out[("all_reduce", "model")] += n_layers * (
            (2 if fam == "zamba2" else 1) + (mix == "sliced"))
    if ffn:
        out[("reduce_scatter", "model")] += n_layers
        out[("all_gather", "model")] += n_layers
    cache = sh.cache_pspecs(mesh, cfg, b, sw.MAX_LEN)
    if kind == "prefill":
        if heads == "cut":
            out[("all_gather", "model")] += n_attn
        if fam == "moe" and sh.experts_local(scfg):
            out[("all_gather", "model")] += n_layers
            out[("all_to_all", "model")] += 2 * n_layers
        return out
    if n_attn:
        seq = [a for a in sh.entry_axes(cache["k"][3]) if sizes[a] > 1]
        kv_local = m > 1 and "model" in sh.entry_axes(cache["k"][2])
        if heads and not kv_local:
            out[("all_gather", "model")] += n_attn
        for a in seq:
            out[("all_reduce", a)] += 3 * n_attn
        if fam in ("attn", "moe") and kv_local:
            out[("all_reduce", "model")] += n_layers
    if fam == "moe" and sh.experts_local(scfg):
        out[("all_reduce", "model")] += n_layers
    states = {"rwkv6": ("wkv",), "zamba2": ("ssm", "conv")}.get(fam, ())
    for leaf in states:
        if mix and leaf != "conv":
            continue
        for e in cache[leaf][2:]:
            for a in sh.entry_axes(e):
                if sizes[a] > 1:
                    out[("all_gather", a)] += n_layers
    return out


@pytest.mark.parametrize("case", CASES)
def test_collectives_are_the_layouts(ranks, case):
    """Every rank's collectives, call by call, are exactly those worked
    out from the layouts (:func:`expected_collectives`): one gather a leaf
    and use over "data" and none of a cache (no gather over "data" but the
    params' and the MoE routing's counts), the tensor-parallel all-reduces
    over "model" a layer, and the decode's combine only over the axes
    that cut the cache's sequence.  Every gather of a call returns at most
    a layer's leaf, a layer's recurrent state, q or the logits: none is a
    KV cache."""
    for res in ranks.results(case):
        calls = res["collectives"]
        assert len(calls) == 1 + sw.DECODE_STEPS
        for i, log in enumerate(calls):
            kind = "prefill" if i == 0 else "decode"
            got = Counter((k, a) for k, _, _, a in log)
            assert got == expected_collectives(case, kind), (kind, got)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if sw.CASES[c][0] == "mixtral-8x22b"])
def test_mixtral_experts_stay_the_ranks_block(case):
    """On Mixtral's override, at prefill and at decode: the expert FFN
    runs on the rank's block of ``d_expert`` (``tp_layout``'s experts), no
    expert leaf is gathered over "model" (each is local there, its spec
    ``expert_mlp`` dim on "model"), and neither route of the experts on
    "model" is taken (no expert parallelism, no experts' slots)."""
    _, shape, b, _ = sw.CASES[case]
    cfg, mesh, over = sw.config(case), FakeMesh(shape), sw.overrides(case)
    pspecs = sh.model_pspecs(mesh, cfg, over)["blocks"]
    assert pspecs["e_gate"][3] == pspecs["e_up"][3] == "model"
    assert pspecs["e_down"][2] == "model"
    for kind, seq in (("prefill", sw.PROMPT), ("decode", sw.MAX_LEN)):
        scfg = serve_config(cfg, mesh, b, seq, kind, over)
        assert tp_layout(scfg, shape[1])[4] and not sh.experts_local(scfg)
        local, _ = sh.leaf_roles(scfg, mesh, over)
        assert all(local["blocks"][k] for k in ("e_gate", "e_up", "e_down"))


@pytest.mark.parametrize("case", sw.MEMORY_CASES)
def test_no_whole_leaf_outlives_its_block(ranks, case):
    """A rank's memory at twice the layers (``launch.dryrun.count_step``'s
    live storages, on the worker's CPU tensors): the arguments grow by
    the rank's blocks of the added layers, and the temporary peak of a
    decode step, or of the prefill less its cache blocks (its output),
    grows by less than one layer's whole gathered leaves: a whole leaf or
    cache kept past the block that reads it would grow it by that much a
    layer."""
    shape = sw.CASES[case][1]
    cfg = sw.config(case)
    sizes = FakeMesh(shape).shape
    blocks = sw.params_np(cfg)["blocks"]
    layer_whole = sum(
        blocks[path][0].nbytes for path, spec in
        sh.model_pspecs(FakeMesh(shape), cfg,
                        sw.overrides(case))["blocks"].items()
        if any(sizes[a] > 1 for e in spec for a in sh.entry_axes(e)))
    for res in ranks.results(f"memory-{case}"):
        small, deep = res[f"layers={cfg.n_layers}"], \
            res[f"layers={2 * cfg.n_layers}"]
        for kind in ("prefill", "decode"):
            grown = deep[kind]["temp_bytes"] - small[kind]["temp_bytes"]
            if kind == "prefill":
                grown -= (deep["decode"]["argument_bytes"]
                          - small["decode"]["argument_bytes"]) \
                    - (deep["prefill"]["argument_bytes"]
                       - small["prefill"]["argument_bytes"])
            assert grown < layer_whole, (kind, grown, layer_whole)
