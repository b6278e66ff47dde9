"""Carry the JAX package's state across into the port's.

The reference's state arrives as a flat dict of numpy arrays keyed by the
dotted path of each leaf — ``"hmu.counts"``, ``"hmu.log_used.hi"``,
``"pebs.cursor"``, ``"placement.slot_to_block"``, ``"out_buf.n_fast"`` and
so on (the caller flattens the pytree; this module never sees JAX).  Static
fields — log capacity, PEBS period, NB scan rate, record-buffer depth — are
not leaves there; they come from ``like``, a port state built with the same
configuration, which also names the device.

The reference's hi/lo int32 event counters recombine into the port's int64
:class:`~repro_torch.faults.Counter64` values, and its record-buffer dict
packs into the port's ``(sync_every, F)`` int64 rows (a hardened runtime's
float32 quality row as its bits).  A fault model crosses leaf by leaf, its
Threefry key words and counters included (:func:`fault_model_from_numpy`),
so a mid-run reference model continues on the port with the same draws; a
:class:`~repro_torch.faults.Hardening` holds no arrays and crosses as its
fields (:func:`hardening_from_fields`).  Its ``tenant_id``
leaf has no counterpart: the port's tenant layout is static and comes from
``like``.  :func:`bundle_to_numpy` goes the other way for the bundle, with
the reference's keys, so the two can be compared leaf by leaf.

Model weights and serving caches cross as nested dicts of numpy arrays in
the reference's layout (:func:`params_from_numpy`, :func:`cache_from_numpy`
and their inverses): the stacked ``blocks.*`` leaves keep their leading
layer dim, and each leaf keeps its dtype.  numpy has no bfloat16 of its own
(the reference's arrays carry ``ml_dtypes``' type, which torch cannot
take), so a bfloat16 leaf crosses through float32, which holds every
bfloat16 value exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .core import telemetry as tel
from .core.blockstore import TieredStore
from .core.placement import Placement
from .core.runtime import (_FusedState, _OUT_LANE_FIELDS, _OUT_SCALARS,
                           _out_columns)
from .faults.model import CARRY_BASE, Counter64, FaultModel, Hardening
from .kernels.dispatch import resolve_device

__all__ = ["bundle_from_numpy", "bundle_to_numpy", "cache_from_numpy",
           "cache_to_numpy", "fault_model_from_numpy",
           "fault_model_to_numpy", "fused_state_from_numpy",
           "hardening_from_fields", "params_from_numpy", "params_to_numpy",
           "store_from_numpy", "store_to_numpy"]

Flat = Mapping[str, np.ndarray]


def _t(flat: Flat, key: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(flat[key])
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{key}: shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(np.array(arr, copy=True)).to(
        dtype=like.dtype, device=like.device)


def _c64(flat: Flat, key: str, like: Counter64) -> Counter64:
    value = int(flat[key + ".hi"]) * CARRY_BASE + int(flat[key + ".lo"])
    return Counter64(torch.tensor(value, dtype=torch.int64,
                                  device=like.value.device))


_FAULT_TENSORS = ("hmu_counter_max", "pebs_drop_p", "reset_p", "nb_stall_p",
                  "resets", "nb_stalls")


def fault_model_from_numpy(flat: Flat, *, like: FaultModel,
                           prefix: str = "") -> FaultModel:
    """The port's :class:`FaultModel` from the reference's leaves (the
    uint32 key words under ``key``, the drop counter as ``pebs_dropped.hi``
    / ``.lo``); ``like`` gives ``stale_epochs``, ``seed``, the leaves'
    shapes and the device."""
    p = prefix
    # the uint32 key words, widened to the port's int64 words
    flat = {**flat, p + "key": np.asarray(flat[p + "key"]).astype(np.int64)}
    return dataclasses.replace(
        like, **{f: _t(flat, p + f, getattr(like, f))
                 for f in _FAULT_TENSORS + ("key",)},
        pebs_dropped=_c64(flat, p + "pebs_dropped", like.pebs_dropped))


def fault_model_to_numpy(fm: FaultModel) -> Dict[str, np.ndarray]:
    """The model's leaves under the reference's keys: the key as its two
    uint32 words, the drop counter as a hi/lo int32 pair."""
    out = {f: getattr(fm, f).cpu().numpy() for f in _FAULT_TENSORS}
    out["key"] = fm.key.cpu().numpy().astype(np.uint32)
    out["pebs_dropped.hi"] = np.int32(fm.pebs_dropped.hi)
    out["pebs_dropped.lo"] = np.int32(fm.pebs_dropped.lo)
    return out


def hardening_from_fields(fields: Mapping) -> Hardening:
    """A :class:`Hardening` from the reference's fields (its ``_asdict()``,
    the fallback as ``(lane, collector)`` pairs), validated."""
    h = Hardening(demote_hysteresis=int(fields["demote_hysteresis"]),
                  fallback=tuple((str(lane), str(col))
                                 for lane, col in fields["fallback"]),
                  quality_floor=float(fields["quality_floor"]),
                  quality_beta=float(fields["quality_beta"]))
    h.validate()
    return h


def bundle_from_numpy(flat: Flat, *, like: tel.TelemetryBundle,
                      prefix: str = "") -> tel.TelemetryBundle:
    """The port's :class:`TelemetryBundle` from the reference's leaves (its
    fault model's too, under ``faults.``, when ``like`` carries one)."""
    p = prefix
    return tel.TelemetryBundle(
        hmu=dataclasses.replace(
            like.hmu, counts=_t(flat, p + "hmu.counts", like.hmu.counts),
            log_used=_c64(flat, p + "hmu.log_used", like.hmu.log_used),
            log_dropped=_c64(flat, p + "hmu.log_dropped",
                             like.hmu.log_dropped),
            host_events=_c64(flat, p + "hmu.host_events",
                             like.hmu.host_events)),
        pebs=dataclasses.replace(
            like.pebs,
            sampled=_t(flat, p + "pebs.sampled", like.pebs.sampled),
            cursor=_t(flat, p + "pebs.cursor", like.pebs.cursor),
            host_events=_c64(flat, p + "pebs.host_events",
                             like.pebs.host_events)),
        nb=dataclasses.replace(
            like.nb, mapped=_t(flat, p + "nb.mapped", like.nb.mapped),
            faults=_t(flat, p + "nb.faults", like.nb.faults),
            scan_ptr=_t(flat, p + "nb.scan_ptr", like.nb.scan_ptr),
            host_events=_c64(flat, p + "nb.host_events",
                             like.nb.host_events)),
        true_counts=_t(flat, p + "true_counts", like.true_counts),
        faults=(None if like.faults is None else fault_model_from_numpy(
            flat, like=like.faults, prefix=p + "faults.")))


def bundle_to_numpy(bundle: tel.TelemetryBundle) -> Dict[str, np.ndarray]:
    """The bundle's leaves under the reference's keys (hi/lo int32 pairs
    for the event counters; a fault model's under ``faults.``)."""
    out: Dict[str, np.ndarray] = {}

    def put(key, val):
        if isinstance(val, Counter64):
            out[key + ".hi"] = np.int32(val.hi)
            out[key + ".lo"] = np.int32(val.lo)
        else:
            out[key] = val.cpu().numpy()

    for col in ("hmu", "pebs", "nb"):
        state = getattr(bundle, col)
        for f in dataclasses.fields(state):
            val = getattr(state, f.name)
            if isinstance(val, (torch.Tensor, Counter64)):
                put(f"{col}.{f.name}", val)
    put("true_counts", bundle.true_counts)
    if bundle.faults is not None:
        out.update({"faults." + key: val for key, val in
                    fault_model_to_numpy(bundle.faults).items()})
    return out


def store_from_numpy(flat: Flat, *, like: TieredStore) -> TieredStore:
    """The port's :class:`TieredStore` from the reference's leaves
    (``storage``, ``placement.slot_to_block``, ``placement.block_to_slot``);
    ``like`` gives the geometry, the dtype and the device.  A bfloat16
    ``storage`` leaf (numpy's ``ml_dtypes`` type, which torch cannot take)
    crosses as float32, exactly."""
    storage = np.asarray(flat["storage"])
    if storage.dtype.name == "bfloat16":
        flat = dict(flat, storage=storage.astype(np.float32))
    return dataclasses.replace(
        like, storage=_t(flat, "storage", like.storage),
        placement=Placement(
            slot_to_block=_t(flat, "placement.slot_to_block",
                             like.slot_to_block),
            block_to_slot=_t(flat, "placement.block_to_slot",
                             like.block_to_slot)))


def store_to_numpy(store: TieredStore) -> Dict[str, np.ndarray]:
    """The store's leaves under the reference's keys (bfloat16 storage
    comes out as float32, which holds every bfloat16 value exactly)."""
    storage = store.storage
    if storage.dtype == torch.bfloat16:
        storage = storage.to(torch.float32)
    return {"storage": storage.cpu().numpy(),
            "placement.slot_to_block": store.slot_to_block.cpu().numpy(),
            "placement.block_to_slot": store.block_to_slot.cpu().numpy()}


def fused_state_from_numpy(flat: Flat, *, like: _FusedState) -> _FusedState:
    """The runtime's :class:`_FusedState` (placement, record buffer and the
    robustness leaves ``like`` carries included) from the reference's
    ``_FusedState`` leaves (a fleet's buffered tenant rows are not
    carried)."""
    buf = like.out_buf
    k, n_lanes = buf.shape[0], like.placement.slot_to_block.shape[0]
    # the lane and quality columns precede the tenants'
    cols = _out_columns(n_lanes, 0, quality=like.quality is not None)
    rows = np.zeros(tuple(buf.shape), np.int64)
    for f in _OUT_SCALARS:
        hi = np.asarray(flat[f"out_buf.{f}_hi"], np.int64)
        lo = np.asarray(flat[f"out_buf.{f}_lo"], np.int64)
        rows[:, cols[f]] = hi * CARRY_BASE + lo
    for f in _OUT_LANE_FIELDS:
        rows[:, cols[f]] = np.asarray(flat[f"out_buf.{f}"],
                                      np.int64).reshape(k, n_lanes)
    if like.quality is not None:
        rows[:, cols["quality"]] = np.asarray(
            flat["out_buf.quality"], np.float32).view(np.int32)
    robust = {name: None if getattr(like, name) is None
              else _t(flat, name, getattr(like, name))
              for name in ("prev_true", "stale", "quality", "prev_nb",
                           "nb_ewma", "cold_streak")}
    return _FusedState(
        bundle=bundle_from_numpy(flat, like=like.bundle, prefix="bundle."),
        placement=Placement(
            slot_to_block=_t(flat, "placement.slot_to_block",
                             like.placement.slot_to_block),
            block_to_slot=_t(flat, "placement.block_to_slot",
                             like.placement.block_to_slot)),
        pred=_t(flat, "pred", like.pred),
        hint_rank=_t(flat, "hint_rank", like.hint_rank),
        prefetch_rank=_t(flat, "prefetch_rank", like.prefetch_rank),
        prev_hmu=_t(flat, "prev_hmu", like.prev_hmu),
        prev_pebs=_t(flat, "prev_pebs", like.prev_pebs),
        out_buf=torch.from_numpy(rows).to(buf.device),
        tenant_hot=like.tenant_hot, tenant_caps=like.tenant_caps,
        stale_ptr=(int(flat["stale_ptr"]) if like.stale is not None
                   else like.stale_ptr),
        **robust)


def _leaf_from_numpy(x, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def _map_tree(tree: Mapping, fn) -> dict:
    return {k: _map_tree(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def params_from_numpy(tree: Mapping, device="cuda") -> dict:
    """The port's parameter dict from the reference's (nested dict of numpy
    arrays, ``blocks.*`` stacked over layers), on ``device``."""
    dev = resolve_device(device)
    return _map_tree(tree, lambda x: _leaf_from_numpy(x, dev))


def params_to_numpy(params: Mapping) -> dict:
    """The parameters as a nested dict of numpy arrays (bfloat16 leaves as
    float32)."""
    return _map_tree(params, _leaf_to_numpy)


def cache_from_numpy(flat: Flat, device="cuda") -> dict:
    """A serving cache from the reference's, leaf for leaf, on ``device``:
    any family's layout (``k``, ``v``, ``pos``; rwkv6's ``wkv``,
    ``sh_mix``, ``sh_ffn``; zamba2's ``ssm``, ``conv``, ``k``, ``v``)."""
    dev = resolve_device(device)
    return _map_tree(flat, lambda x: _leaf_from_numpy(x, dev))


def cache_to_numpy(cache: Mapping) -> Dict[str, np.ndarray]:
    """Every leaf of the cache as numpy (bfloat16 as float32)."""
    return _map_tree(cache, _leaf_to_numpy)
