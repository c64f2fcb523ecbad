"""CocktailSampler: the bridge from scheduler decisions to training batches;
counterpart of ``repro.data.sampler``.

Each slot the scheduler (``repro_torch.core``) emits x[i,j] / y[i,j,k]
(samples of CU i trained at EC j). With ECs mapped to data-parallel groups,
the sampler

  1. converts the per-EC trained counts into an integer batch composition
     (how many sequences of each source each EC's shard trains this step),
  2. draws that many sequences from each ``TokenSource``,
  3. emits per-sample weights so the weighted-mean loss implements the
     |D_j|-weighted parameter-server aggregation (paper eq. 15).

The decision's tensors (on any device) are copied to the host once a call;
the batch is numpy, equal to the JAX sampler's for the same decision.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core import CocktailConfig, Decision
from .sources import TokenSource


def _host(a) -> np.ndarray:
    """A tensor (any device) or an array as a float64 numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


@dataclasses.dataclass
class CocktailSampler:
    cfg: CocktailConfig
    sources: Sequence[TokenSource]
    batch_per_ec: int  # sequences each EC contributes to the global batch
    seed: int = 0

    def __post_init__(self):
        if len(self.sources) != self.cfg.n_cu:
            raise ValueError(f"{len(self.sources)} sources for {self.cfg.n_cu} CUs")
        self._rng = np.random.default_rng(self.seed)

    @staticmethod
    def _trained_at(decision: Decision) -> np.ndarray:
        """(N, M) samples of CU i trained at EC j: x + sum_k y[:, k]."""
        return _host(decision.x) + _host(decision.y).sum(axis=1)

    def _composition(self, trained_at: np.ndarray) -> np.ndarray:
        comp = np.zeros((self.cfg.n_ec, self.cfg.n_cu), np.int64)
        for j in range(self.cfg.n_ec):
            col = trained_at[:, j]
            tot = col.sum()
            if tot <= 0:
                continue
            frac = col / tot * self.batch_per_ec
            cnt = np.floor(frac).astype(np.int64)
            rem = self.batch_per_ec - cnt.sum()
            if rem > 0:
                order = np.argsort(-(frac - cnt))
                cnt[order[:rem]] += 1
            comp[j] = cnt
        return comp

    def composition(self, decision: Decision) -> np.ndarray:
        """(M, N) integer counts: sequences from CU i trained by EC j this
        step, scaled so each EC trains at most batch_per_ec sequences and
        proportions follow trained_at = x + sum_j y."""
        return self._composition(self._trained_at(decision))

    def sample(self, decision: Decision) -> dict:
        """Build the global batch for one step.

        Returns dict(tokens (M*B, S), labels, weights (M*B,), source_ids,
        ec_ids) as numpy arrays. weights scale each EC's samples by its
        |D_j| share (eq. 15); ECs that trained nothing this slot get
        zero-weight filler samples.
        """
        trained = self._trained_at(decision)
        comp = self._composition(trained)  # (M, N)
        d_j = trained.sum(axis=0)  # |D_j|
        mean_d = d_j.mean() if d_j.sum() > 0 else 1.0

        toks, weights, src_ids, ec_ids = [], [], [], []
        for j in range(self.cfg.n_ec):
            w_j = d_j[j] / max(mean_d, 1e-9)
            n_filled = 0
            for i in range(self.cfg.n_cu):
                n = int(comp[j, i])
                if n == 0:
                    continue
                toks.append(self.sources[i].sample(n))
                weights.extend([w_j] * n)
                src_ids.extend([i] * n)
                ec_ids.extend([j] * n)
                n_filled += n
            if n_filled < self.batch_per_ec:  # zero-weight padding
                pad = self.batch_per_ec - n_filled
                toks.append(self.sources[0].sample(pad))
                weights.extend([0.0] * pad)
                src_ids.extend([0] * pad)
                ec_ids.extend([j] * pad)
        tokens = np.concatenate(toks, axis=0)
        labels = np.roll(tokens, -1, axis=1).copy()
        labels[:, -1] = -1
        return {
            "tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32),
            "weights": np.asarray(weights, np.float32),
            "source_ids": np.asarray(src_ids, np.int32),
            "ec_ids": np.asarray(ec_ids, np.int32),
        }
