"""Deterministic, resumable, shardable synthetic token pipeline (the
port's numpy copy of ``repro/data/pipeline.py``: batches are bit-identical
to the reference's).

Production properties the trainer depends on:
  * **Determinism**: batch(i) is a pure function of (seed, step) — restart at
    step k replays exactly the remaining stream, no data loss or dup.
  * **Sharding**: each data-parallel rank materializes only its slice
    (host-side; in a multi-host launch each rank uploads only its slice).
  * **Skew**: token ids are Zipf-distributed (configurable) so embedding-row
    hotness is realistic — this is what the TieredEmbedding telemetry sees.

The "dataset" is synthetic (procedural) because the paper's LM-side workload
only needs realistic *access statistics*; swap `_tokens_for` with a real
tokenized shard reader for production.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1      # token popularity skew
    n_ranks: int = 1
    rank: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_ranks:
            raise ValueError("global_batch must divide across ranks")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_ranks
        n = cfg.vocab_size
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_alpha)
        self._cdf = np.cumsum(w) / w.sum()
        # stable rank->token shuffle so hot tokens are spread over the table
        self._rank_to_tok = np.random.default_rng(cfg.seed).permutation(n) \
            .astype(np.int32)

    def batch(self, step: int) -> dict:
        """Deterministic batch for ``step`` (this rank's slice)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.rank))            # counter-based determinism
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = self._rank_to_tok[np.searchsorted(self._cdf, u)]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def state(self, step: int) -> dict:
        """Checkpointable pipeline state (tiny: it is all recomputable)."""
        return {"seed": self.cfg.seed, "step": step, "rank": self.cfg.rank}

    @staticmethod
    def resume(cfg: DataConfig, state: dict) -> tuple["TokenPipeline", int]:
        assert state["seed"] == cfg.seed, "seed mismatch on resume"
        return TokenPipeline(cfg), int(state["step"])
