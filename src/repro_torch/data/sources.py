"""Synthetic non-IID data sources (the CUs of the paper); the port's own copy
of ``repro.data.sources`` (numpy only, so the same seed draws the same
arrays in both packages).

Each CU generates samples from its own distribution — the data-skew setting
of the paper. Two generators:

  * ``TokenSource``: LM tokens from a per-CU Zipf distribution over a
    permuted vocab slice (source id recoverable from distribution), used by
    the Cocktail-scheduled LM training examples.
  * ``TrafficSource``: the paper's own testbed task — base-station traffic
    time series (diurnal + weekly structure + noise); samples are
    (4 consecutive records -> next record) exactly as Sec. IV-A.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenSource:
    cu_id: int
    vocab_size: int
    seq_len: int
    zipf_a: float = 1.2
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed * 1000 + self.cu_id)
        # per-CU vocab permutation -> distinct unigram distributions
        self._perm = rng.permutation(self.vocab_size)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks ** -self.zipf_a
        self._p = p / p.sum()
        self._rng = rng

    def sample(self, n: int) -> np.ndarray:
        """n sequences of tokens, (n, seq_len) int32."""
        raw = self._rng.choice(self.vocab_size, size=(n, self.seq_len), p=self._p)
        return self._perm[raw].astype(np.int32)


@dataclasses.dataclass
class TrafficSource:
    """Paper testbed data generation: one CU covers a community of base
    stations; each record is normalized traffic; a sample is a history
    window of 4 records + the next record as the label."""

    cu_id: int
    n_stations: int = 90
    history: int = 4
    slot_minutes: int = 5
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed * 7919 + self.cu_id)
        self._phase = rng.uniform(0, 2 * np.pi, self.n_stations)
        self._scale = rng.uniform(0.4, 1.0, self.n_stations)
        # per-CU signature: traffic level and burstiness differ by community
        self._level = rng.uniform(0.2, 0.8)
        self._noise = rng.uniform(0.02, 0.12)
        self._rng = rng
        self._t = 0

    def _series(self, t: np.ndarray, station: np.ndarray) -> np.ndarray:
        day = 2 * np.pi * t * self.slot_minutes / (24 * 60)
        base = self._level + 0.35 * self._scale[station] * np.sin(day + self._phase[station])
        base = base + 0.1 * np.sin(2 * day + self._phase[station] * 0.5)
        noise = self._rng.normal(0, self._noise, size=t.shape)
        return np.clip(base + noise, 0.0, 1.0)

    def sample(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (x (n, history), y (n,)) float32."""
        stations = self._rng.integers(0, self.n_stations, n)
        starts = self._t + self._rng.integers(0, 288, n)
        offs = np.arange(self.history + 1)
        tt = starts[:, None] + offs[None, :]
        vals = self._series(tt, stations[:, None].repeat(self.history + 1, axis=1))
        self._t += 1
        return vals[:, :-1].astype(np.float32), vals[:, -1].astype(np.float32)
