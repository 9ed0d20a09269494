"""Recsys batch generation: Criteo-like 39 sparse fields + CTR labels.

Deterministic per-(seed, step) like the LM pipeline. Field ids follow a
per-field Zipf so embedding-row access is realistically skewed (hot rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RecsysBatchGen:
    n_fields: int
    vocab_per_field: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int):
        """Returns dict(ids [B, F] int32, label [B] float32)."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        ids = rng.zipf(1.2, size=(self.batch, self.n_fields))
        ids = np.minimum(ids - 1, self.vocab_per_field - 1).astype(np.int32)
        logits = (ids.astype(np.float64) % 7 - 3).mean(axis=1)
        label = (rng.random(self.batch) < 1 / (1 + np.exp(-logits))) \
            .astype(np.float32)
        return {"ids": ids, "label": label}
