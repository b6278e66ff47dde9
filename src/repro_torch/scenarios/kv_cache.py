"""LLM KV-cache scenario — tiered KV pages placed online from attention mass
(PyTorch port of ``repro/scenarios/kv_cache.py``).

The serving engine's decode loop emits the per-KV-page attention-mass feed
(``aux["kv_page_mass"]``, the serving-side HMU): every decode step reports
how much attention probability each ``(layer, sequence, page)`` page of the
KV cache absorbed.  This scenario turns that feed into the EpochRuntime's
page-index access batches, so a tiered KV cache is placed online by the
same six policy lanes as the DLRM table — nothing KV-specific reaches the
runtime.

Mechanics: a model (smoke config by default) is prefilled once on
``device`` — one ``flash_attention`` launch per layer on a CUDA device —
then decoded step by step via
:func:`repro_torch.serve.engine.decode_telemetry`.  Each decode step's mass
tensor is quantized into exactly ``accesses_per_batch`` page accesses
(largest-remainder apportionment — deterministic, no sampling), one batch
row per step.  As ``pos`` advances past the prefill, freshly written pages
start absorbing mass, so the hot set drifts organically.  The final page is
ragged whenever ``max_len % page_size != 0`` (the default geometry makes it
so).

``hint_layout()`` returns ``None``: which pages a sequence attends to
depends on the decoded text, which no compiler knows ahead of time.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.costmodel import TPU_V5E_SYSTEM, MemSystem
from ..hints import HintLayout
from ..kernels.dispatch import resolve_device

__all__ = ["KVCacheScenario", "quantize_access_counts"]


def quantize_access_counts(weights: np.ndarray, total: int) -> np.ndarray:
    """Apportion ``total`` accesses over blocks proportionally to ``weights``
    (largest-remainder method): deterministic, exact total, zero weight ->
    zero accesses.  All-zero weights yield an all-zero count vector."""
    w = np.maximum(np.asarray(weights, np.float64).ravel(), 0.0)
    s = w.sum()
    counts = np.zeros(w.shape, np.int64)
    if s <= 0.0 or total <= 0:
        return counts
    exact = w * (float(total) / s)
    counts = np.floor(exact).astype(np.int64)
    short = int(total - counts.sum())
    if short > 0:
        top_up = np.argsort(-(exact - counts), kind="stable")[:short]
        counts[top_up] += 1
    return counts


class KVCacheScenario:
    """Tiered KV-cache placement driven by decode-time attention mass.

    Blocks are ``(layer, sequence, page)`` KV pages, indexed
    ``(layer * batch + seq) * pages_per_seq + page`` — the flattening of the
    engine's ``(L, B, P)`` mass tensor.  One epoch is ``batches_per_epoch``
    decode steps; one batch row is one step's mass quantized to
    ``accesses_per_batch`` page accesses.

    The decode loop runs once, on ``device`` (default ``"cuda"``: raises
    without one), and the epochs are cached.  ``params`` replaces the
    weights ``init_params(cfg, seed)`` would draw (the seam through which
    tests pass the reference's ``jax.random`` weights, which torch cannot
    draw); they must lie on ``device``.
    """

    name = "kv_cache"

    def __init__(
        self,
        arch: str = "internlm2-1.8b",
        batch: int = 4,
        page_size: int = 4,
        prefill_len: int = 19,
        n_epochs: int = 6,
        batches_per_epoch: int = 4,
        accesses_per_batch: int = 4096,
        k_hot: Optional[int] = None,
        shift_at: Optional[int] = None,
        system: MemSystem = TPU_V5E_SYSTEM,
        pebs_period: int = 101,
        seed: int = 0,
        device="cuda",
        params: Optional[dict] = None,
    ):
        from ..configs import get_smoke_config
        from ..serve.engine import kv_page_geometry

        self.arch = arch
        self.cfg = get_smoke_config(arch)
        self.batch = int(batch)
        self.page_size = int(page_size)
        self.prefill_len = int(prefill_len)
        self.n_epochs = int(n_epochs)
        self.batches_per_epoch = int(batches_per_epoch)
        self.accesses_per_batch = int(accesses_per_batch)
        self.n_steps = self.n_epochs * self.batches_per_epoch
        # every decode step appends one token per sequence, so the cache must
        # hold the prefill plus the whole decode run
        self.max_len = self.prefill_len + self.n_steps
        geom = kv_page_geometry(self.cfg, self.batch, self.max_len,
                                self.page_size)
        self.pages_per_seq = geom["pages_per_seq"]
        self.n_blocks = geom["n_blocks"]
        self.bytes_per_access = float(geom["bytes_per_access"])
        self.block_bytes = float(geom["block_bytes"])
        self.k_hot = (max(self.n_blocks // 4, 1) if k_hot is None
                      else min(int(k_hot), self.n_blocks))
        self.shift_at = (self.n_epochs // 2 if shift_at is None
                         else int(shift_at))
        self.system = system
        self.pebs_period = int(pebs_period)
        self.nb_scan_rate = max(self.n_blocks // self.batches_per_epoch, 1)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.params = params
        self.masses: Optional[np.ndarray] = None
        self._epochs: Optional[List[np.ndarray]] = None

    # ------------------------------------------------------------- generation
    def _generate(self) -> List[np.ndarray]:
        from ..models.model import init_params
        from ..serve import engine

        dev = self.device
        rng = np.random.default_rng(self.seed)
        params = (init_params(self.cfg, self.seed, dev) if self.params is None
                  else self.params)
        prompt = rng.integers(0, self.cfg.vocab_size,
                              (self.batch, self.prefill_len))
        _, cache = engine.prefill(
            params, self.cfg,
            tokens=torch.from_numpy(prompt.astype(np.int32)).to(dev),
            max_len=self.max_len)
        step_tokens = rng.integers(0, self.cfg.vocab_size,
                                   (self.n_steps, self.batch))
        _, mass = engine.decode_telemetry(
            params, self.cfg, cache,
            torch.from_numpy(step_tokens.astype(np.int32)).to(dev),
            page_size=self.page_size)           # (T, L, B, P)
        self.masses = mass
        rows = [self.access_batch(m) for m in mass]
        bpe = self.batches_per_epoch
        return [np.stack(rows[e * bpe:(e + 1) * bpe])
                for e in range(self.n_epochs)]

    def access_batch(self, step_mass: np.ndarray) -> np.ndarray:
        """One decode step's ``(L, B, P)`` mass -> one equal-length batch row
        of page-block indices (the flattened mass order IS the block id)."""
        counts = quantize_access_counts(step_mass, self.accesses_per_batch)
        return np.repeat(np.arange(self.n_blocks, dtype=np.int32), counts)

    # --------------------------------------------------------------- protocol
    def epochs(self) -> Iterator[np.ndarray]:
        if self._epochs is None:
            self._epochs = self._generate()
        return iter(self._epochs)

    def hint_layout(self) -> Optional[HintLayout]:
        return None          # attention hotness is runtime-only
