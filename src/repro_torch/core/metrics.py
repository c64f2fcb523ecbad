"""Evaluation metrics used by the paper's figures (Sec. IV), read from the
port's state. Counterpart of ``repro.core.metrics``."""
from __future__ import annotations

import numpy as np

from .types import CocktailConfig, SchedulerState


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def stdev_collection(state: SchedulerState) -> float:
    """Fig. 5 metric: STDEV of cumulative per-CU upload amounts."""
    return float(np.std(_np(state.uploaded)))


def stdev_training_per_ec(state: SchedulerState) -> np.ndarray:
    """Fig. 6 metric: per-EC STDEV of cumulative trained amounts over CUs."""
    return np.std(_np(state.queues.omega), axis=0)


def unit_cost(state: SchedulerState) -> float:
    """Fig. 9 metric: total cost / total trained samples."""
    return float(state.total_cost) / max(float(state.total_trained), 1e-9)


def skew_matrix(cfg: CocktailConfig, state: SchedulerState) -> np.ndarray:
    """Per-(CU, EC) signed skew: Omega_ij/sum_l Omega_lj - zeta_i/sum zeta."""
    omega = _np(state.queues.omega).astype(np.float64)
    tot = omega.sum(axis=0, keepdims=True)
    frac = np.divide(omega, np.maximum(tot, 1e-9))
    return frac - cfg.proportions[:, None]


def summary(cfg: CocktailConfig, state: SchedulerState) -> dict:
    t = max(int(state.t), 1)
    return {
        "slots": int(state.t),
        "total_cost": float(state.total_cost),
        "avg_cost": float(state.total_cost) / t,
        "total_trained": float(state.total_trained),
        "unit_cost": unit_cost(state),
        "stdev_collection": stdev_collection(state),
        "stdev_training": [float(v) for v in stdev_training_per_ec(state)],
        "skew_degree": float(np.abs(skew_matrix(cfg, state)).max()),
        "q_backlog": float(_np(state.queues.q).sum()),
        "r_backlog": float(_np(state.queues.r).sum()),
    }
