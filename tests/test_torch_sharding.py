"""The port's sharding rules and assigned shapes (``repro_torch.launch.
sharding`` / ``shapes``, ``models.model.param_pspecs``) against the
reference's, as tuples, on stand-in meshes that carry only ``.shape`` (as
the reference's own rule tests do): every published and smoke config on
meshes of 16 x 16, 2 x 16 x 16 and 2 x 2.  No process group, no device.

Tolerance: exact (specs, shapes and dtypes are equal)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import _torch_threads
_torch_threads.limit()

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_config
from repro.configs import get_sharding_overrides as j_overrides
from repro.configs import get_smoke_config as j_smoke
from repro.launch import shapes as j_shapes
from repro.launch import sharding as j_sh
from repro.models import model as jm
from repro.optim import get_optimizer as j_get_optimizer
from repro_torch.configs import get_config, get_sharding_overrides
from repro_torch.configs import get_smoke_config
from repro_torch.launch import shapes, sharding as sh
from repro_torch.models import model as tm
from repro_torch.optim import get_optimizer

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
CONFIGS = [(a, k) for a in ARCH_IDS for k in ("published", "smoke")]
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def cfgs(arch: str, kind: str):
    if kind == "published":
        return j_config(arch), get_config(arch)
    return j_smoke(arch), get_smoke_config(arch)


def as_tuples(tree):
    """Spec trees of either package -> nested dicts of tuples."""
    if isinstance(tree, (jax.sharding.PartitionSpec, sh.PartitionSpec)):
        return tuple(tree)
    if hasattr(tree, "_fields"):
        return {k: as_tuples(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    raise TypeError(type(tree))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,kind", CONFIGS)
def test_rules_and_param_specs_match_the_reference(arch, kind, mesh):
    jc, tc = cfgs(arch, kind)
    m = FakeMesh(MESHES[mesh])
    assert sh.default_rules(m, tc) == j_sh.default_rules(m, jc)
    assert get_sharding_overrides(arch) == j_overrides(arch)
    ov = get_sharding_overrides(arch)
    got = sh.model_pspecs(m, tc, ov)
    assert as_tuples(got) == as_tuples(j_sh.model_pspecs(m, jc, ov))
    rules = sh.apply_overrides(sh.default_rules(m, tc), ov)
    assert as_tuples(tm.param_pspecs(tc, rules)) == as_tuples(got)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_specs_match_the_reference(arch, opt):
    """Both optimizers' state specs on every published config (states built
    abstractly: meta tensors here, ``jax.eval_shape`` there)."""
    jc, tc = cfgs(arch, "published")
    m = FakeMesh(MESHES["2x16x16"])
    j_state = jax.eval_shape(j_get_optimizer(opt).init, jm.abstract_params(jc))
    meta = {}
    for path, spec in tm.iter_schema(tc):
        tm._set(meta, path, torch.empty(spec.shape, device="meta"))
    t_state = get_optimizer(opt).init(meta)
    want = j_sh.opt_pspecs(j_sh.model_pspecs(m, jc), j_state)
    got = sh.opt_pspecs(sh.model_pspecs(m, tc), t_state)
    assert type(got).__name__ == "OptState"
    assert as_tuples(got) == as_tuples(want)


@pytest.mark.parametrize("shape", sorted(j_shapes.SHAPES))
@pytest.mark.parametrize("arch,kind", CONFIGS)
def test_input_specs_and_batch_and_cache_specs_match(arch, kind, shape):
    jc, tc = cfgs(arch, kind)
    js, ts = j_shapes.SHAPES[shape], shapes.SHAPES[shape]
    assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    assert shapes.applicable(tc, ts) == j_shapes.applicable(jc, js)
    want, got = j_shapes.input_specs(jc, js), shapes.input_specs(tc, ts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == DTYPES[want[k].dtype.type], k
    for name, shp in MESHES.items():
        m = FakeMesh(shp)
        assert ({k: tuple(v) for k, v in sh.batch_specs(m, tc, got).items()}
                == {k: tuple(v) for k, v in
                    j_sh.batch_specs(m, jc, want).items()}), name
        if js.kind != "train":
            assert (as_tuples(sh.cache_pspecs(m, tc, js.global_batch,
                                              js.seq_len))
                    == as_tuples(j_sh.cache_pspecs(m, jc, js.global_batch,
                                                   js.seq_len))), name


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 16, 32, 64, 256])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes_and_pspec_match_the_reference(mesh, batch):
    m = FakeMesh(MESHES[mesh])
    assert sh.batch_axes(m, batch) == j_sh.batch_axes(m, batch)
    assert sh.batch_axes(m) == j_sh.batch_axes(m)
    assert tuple(sh.batch_pspec(m, batch)) == tuple(j_sh.batch_pspec(m, batch))


@pytest.mark.parametrize("family", ["attn", "moe", "rwkv6", "zamba2"])
def test_cache_specs_cover_the_four_families(family):
    """A long_500k-style cache (B 1: the batch cannot shard, so the
    sequence absorbs the data axes) and a B 128 one, per family."""
    arch = next(a for a in ARCH_IDS if j_config(a).family == family)
    jc, tc = cfgs(arch, "published")
    m = FakeMesh(MESHES["2x16x16"])
    for b, s in ((1, 524288), (128, 32768)):
        got = as_tuples(sh.cache_pspecs(m, tc, b, s))
        assert got == as_tuples(j_sh.cache_pspecs(m, jc, b, s))
        assert got["pos"] == (j_sh.batch_axes(m, b),)


# the reference's two rule tests (tests/test_distribution.py), case for case
@pytest.mark.parametrize("arch,key,value", [
    ("mixtral-8x22b", "experts", None),       # 8 experts don't divide 16
    ("mixtral-8x22b", "expert_mlp", "model"),  # TP inside experts instead
    ("kimi-k2-1t-a32b", "experts", "model"),   # 384 divides 16 -> EP
    ("kimi-k2-1t-a32b", "kv_heads", None),     # 8 kv heads don't divide 16
])
def test_sharding_rules_divisibility(arch, key, value):
    rules = sh.default_rules(FakeMesh(MESHES["16x16"]), get_config(arch))
    assert rules[key] == value


def test_sharding_rules_reference_only_real_axes():
    rules = sh.default_rules(FakeMesh(MESHES["16x16"]),
                             get_config("kimi-k2-1t-a32b"))
    specs = tm.param_pspecs(get_config("kimi-k2-1t-a32b"), rules)
    found = []
    sh.map_specs(found.append, specs)
    assert found
    for leaf in found:
        for ax in leaf:
            assert ax in (None, "data", "model", "pod"), leaf


@pytest.mark.parametrize("batch,want", [(256, ("pod", "data")), (16, "data"),
                                        (1, None)])
def test_batch_axes_divisibility(batch, want):
    assert sh.batch_axes(FakeMesh(MESHES["2x16x16"]), batch) == want


def test_partition_spec_normalises_as_the_references():
    P, JP = sh.PartitionSpec, jax.sharding.PartitionSpec
    for entries in [(("data",), None), ((), "model"), (("pod", "data"),),
                    ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert isinstance(P("data")[:-1], tuple)


def test_placements_split_major_first():
    """Placements on a stand-in mesh: Shard in mesh order; an entry that
    puts a later mesh axis first makes the earlier one a _StridedShard of
    the later one's size; an axis the mesh lacks shards nothing."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    m = FakeMesh({"pod": 2, "data": 4, "model": 3})
    P = sh.PartitionSpec
    assert sh.placements(m, P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.placements(m, P(("data", "pod"), None)) == (
        _StridedShard(0, split_factor=4), Shard(0), Replicate())
    assert sh.placements(m, P(("model", "pod", "data"))) == (
        _StridedShard(0, split_factor=3), _StridedShard(0, split_factor=3),
        Shard(0))
    assert sh.placements(FakeMesh({"data": 4}), P("model", "data")) == (
        Shard(1),)
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements(m, P("data", "data"))
    named = sh.named(m, {"a": P("data"), "b": (P(), P("model"))})
    assert named["b"][1].placements == (Replicate(), Replicate(), Shard(0))
    assert named["a"].mesh is m


def test_constrain_batch_leaves_plain_tensors_and_the_meshless_path():
    """Without a DTensor, constrain_batch is the identity, and a forward
    with act_batch_axes set and no mesh equals the one without bit for
    bit, aux too (dense and MoE)."""
    for arch in ("llama3.2-3b", "mixtral-8x22b"):
        cfg = get_smoke_config(arch)
        params = tm.init_params(cfg, 0, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 8),
                             generator=torch.Generator().manual_seed(0))
        x = torch.ones(2, 3)
        on = dataclasses.replace(cfg, act_batch_axes=("data",))
        assert tm.constrain_batch(x, on) is x
        h0, a0 = tm.forward(params, cfg, tokens=toks)
        h1, a1 = tm.forward(params, on, tokens=toks)
        assert torch.equal(h0, h1)
        assert sorted(a1) == sorted(a0)
        for k in a0:
            assert torch.equal(a0[k], a1[k]), k
