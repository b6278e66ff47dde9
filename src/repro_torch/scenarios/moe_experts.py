"""MoE expert-bank scenario — online placement of expert weights (PyTorch
port of ``repro/scenarios/moe_experts.py``).

The paper's DLRM sparsity argument applied to expert weights: with top-k
routing only a sliver of expert bytes is live per token, and the router's
expert-activation counters ARE memory-side telemetry (full coverage, zero
extra cost).  The router counters of a real MoE forward pass become the
EpochRuntime's access batches (via
:func:`repro_torch.models.moe.expert_access_batch`), and the six lanes
place the expert banks epoch by epoch while the routing mix shifts mid-run
(token popularity rotates, so different experts become hot).

Blocks are expert ids; one block spans the expert's gate/up/down weights in
every layer (``block_bytes = bytes_per_expert * n_layers``), as an
inference server pins an expert across its layer instances.  No static hint
layout: which experts run hot depends on the serving traffic.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.costmodel import TPU_V5E_SYSTEM, MemSystem
from ..hints import HintLayout
from ..kernels.dispatch import resolve_device

__all__ = ["MoEExpertScenario"]


class MoEExpertScenario:
    """Online expert-bank tiering from router telemetry.

    The model (smoke config by default) runs one forward pass per batch of
    Zipf-popular tokens, on ``device`` (default ``"cuda"``: raises without
    one; one ``flash_attention`` launch a layer on a CUDA device); at epoch
    ``shift_at`` token popularity rotates by half the vocabulary.  Each
    batch row is the layer-summed expert access stream, of constant length
    ``batch * seq * top_k * n_layers``, so epochs stack.  The forward passes
    run once and the epochs are cached, so repeated runs replay one stream.

    ``params`` replaces the weights ``init_params(cfg, seed)`` would draw
    (the seam through which tests pass the reference's ``jax.random``
    weights); they must lie on ``device``.
    """

    name = "moe_experts"

    def __init__(
        self,
        arch: str = "kimi-k2-1t-a32b",
        n_epochs: int = 6,
        batches_per_epoch: int = 4,
        shift_at: int = 3,
        batch: int = 4,
        seq: int = 64,
        zipf_a: float = 1.3,
        k_hot: Optional[int] = None,
        system: MemSystem = TPU_V5E_SYSTEM,
        pebs_period: int = 101,
        seed: int = 0,
        device="cuda",
        params: Optional[dict] = None,
    ):
        from ..configs import get_smoke_config

        self.arch = arch
        self.cfg = get_smoke_config(arch)
        if self.cfg.family != "moe":
            raise ValueError(f"expert tiering needs a MoE family arch, "
                             f"got {arch!r} ({self.cfg.family})")
        self.n_epochs = int(n_epochs)
        self.batches_per_epoch = int(batches_per_epoch)
        self.shift_at = int(shift_at)
        self.batch = int(batch)
        self.seq = int(seq)
        self.zipf_a = float(zipf_a)
        e = self.cfg.moe.n_experts
        self.n_blocks = e
        self.k_hot = (max(e // 4, 1) if k_hot is None
                      else min(int(k_hot), e))       # HBM: 25% of experts
        # gate/up/down bf16 per layer; a block is the expert across layers
        bytes_per_expert = 3 * self.cfg.d_model * self.cfg.moe.d_expert * 2
        self.bytes_per_access = float(bytes_per_expert)
        self.block_bytes = float(bytes_per_expert * self.cfg.n_layers)
        self.system = system
        self.pebs_period = int(pebs_period)
        self.nb_scan_rate = max(e // 2, 1)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.params = params
        self.counts: Optional[np.ndarray] = None
        self._epochs: Optional[List[np.ndarray]] = None

    @property
    def batch_len(self) -> int:
        """Every batch row's length: tokens * top_k * layers."""
        return (self.batch * self.seq * self.cfg.moe.top_k
                * self.cfg.n_layers)

    # ------------------------------------------------------------- generation
    def _token_batch(self, rng: np.random.Generator,
                     shifted: bool) -> np.ndarray:
        """Zipf-popular token ids; ``shifted`` rotates popularity so a
        different expert subset becomes hot."""
        v = self.cfg.vocab_size
        toks = np.minimum(rng.zipf(self.zipf_a, size=(self.batch, self.seq))
                          - 1, v - 1)
        if shifted:
            toks = (toks + v // 2) % v
        return toks.astype(np.int32)

    def token_batches(self) -> Iterator[np.ndarray]:
        """The stream's (batch, seq) int32 token batches in order, one per
        forward pass: ``batches_per_epoch`` an epoch, popularity rotated
        from epoch ``shift_at`` on."""
        rng = np.random.default_rng(self.seed)
        for ep in range(self.n_epochs):
            for _ in range(self.batches_per_epoch):
                yield self._token_batch(rng, shifted=ep >= self.shift_at)

    def model_params(self) -> dict:
        """The weights the forward passes use, on ``device``."""
        from ..models.model import init_params
        return (init_params(self.cfg, self.seed, self.device)
                if self.params is None else self.params)

    def _generate(self) -> List[np.ndarray]:
        from ..models.model import forward
        from ..models.moe import expert_access_batch

        cfg, dev = self.cfg, self.device
        params = self.model_params()
        counts = []
        with torch.no_grad():
            for toks in self.token_batches():
                _, aux = forward(params, cfg,
                                 tokens=torch.from_numpy(toks).to(dev))
                counts.append(aux["expert_counts"])              # (L, E)
        # one pull for the whole stream: (n_epochs * batches, L, E)
        self.counts = torch.stack(counts).cpu().numpy()
        rows = [expert_access_batch(c) for c in self.counts]
        bpe = self.batches_per_epoch
        return [np.stack(rows[e * bpe:(e + 1) * bpe])
                for e in range(self.n_epochs)]

    # --------------------------------------------------------------- protocol
    def epochs(self) -> Iterator[np.ndarray]:
        if self._epochs is None:
            self._epochs = self._generate()
        return iter(self._epochs)

    def hint_layout(self) -> Optional[HintLayout]:
        return None          # routing hotness is runtime-only
