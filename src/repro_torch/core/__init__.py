"""Cocktail core in PyTorch: cost-efficient, data-skew-aware online data
scheduling. Counterpart of ``repro.core``.

Public API:
  CocktailConfig, ShapeConfig, SliceParams, split_config, stack_slice_params,
  NetworkState, Heterogeneity, QueueState, Multipliers, Decision,
  SchedulerState, init_state           -- state types
  heterogeneity, sample_network_state, framework_cost
                                       -- stochastic environment (Sec. II)
  step, run, slot_network, AlgoSpec and the named specs (DS, LDS, ...) -- Sec. III
  COLLECTION_POLICIES, TRAINING_POLICIES, PolicyTable, SWITCHED, with_policy
                                       -- indexed policy tables; per-slice
                                          policy dispatch
  SliceJob, as_jobs, FleetEngine, ragged_pad_shape, trim_state
                                       -- K slices in one batched pass a slot:
                                          homogeneous, ragged (padding + entity
                                          masks) and mixed-policy fleets
  metrics                              -- Sec. IV evaluation metrics

``run``, ``init_state`` and ``FleetEngine.from_jobs`` run on CUDA unless
``device=`` names another device; with no GPU present they raise unless
given ``device="cpu"``.
"""
from .datasche import (ALL_SPECS, COLLECTION_POLICIES, CU_FULL, DS, DS_EXACT,
                       EC_FULL, EC_SELF, GREEDY, LDS, NO_LSA, NO_SDC, NO_SLT,
                       SWITCHED, SWITCHED_NOAID, TRAINING_POLICIES, AlgoSpec,
                       PolicyTable, SlotRecord, collection_weights, run,
                       skew_degree, slot_network, stack_slot_records, step,
                       training_weights, with_policy)
from .fleet import FleetEngine, ragged_pad_shape, trim_state
from .job import SliceJob, as_jobs
from .network import framework_cost, heterogeneity, sample_network_state
from .types import (MASKED_WEIGHT, CocktailConfig, Decision, Heterogeneity,
                    Multipliers, NetworkState, QueueState, SchedulerState,
                    ShapeConfig, SliceParams, entity_masks, init_state,
                    mask_pairs, resolve_device, split_config, stack_slice_params)

__all__ = [
    "ALL_SPECS", "AlgoSpec", "CocktailConfig", "COLLECTION_POLICIES",
    "CU_FULL", "DS", "DS_EXACT", "Decision", "EC_FULL", "EC_SELF",
    "FleetEngine", "GREEDY", "Heterogeneity", "LDS", "MASKED_WEIGHT",
    "Multipliers", "NetworkState", "NO_LSA", "NO_SDC", "NO_SLT", "PolicyTable",
    "QueueState", "SWITCHED", "SWITCHED_NOAID", "SchedulerState", "ShapeConfig",
    "SliceJob", "SliceParams", "SlotRecord", "TRAINING_POLICIES", "as_jobs",
    "collection_weights", "entity_masks", "framework_cost", "heterogeneity",
    "init_state", "mask_pairs", "ragged_pad_shape", "resolve_device", "run",
    "sample_network_state", "skew_degree", "slot_network", "split_config",
    "stack_slice_params", "stack_slot_records", "step", "training_weights",
    "trim_state", "with_policy",
]
