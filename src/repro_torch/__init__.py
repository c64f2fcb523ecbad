"""PyTorch / CUDA port of the Cocktail scheduler and its LM training and
serving paths (``repro`` is the JAX reference it is held against). Imports
torch and never jax.

  repro_torch.core       -- the scheduler: types, sampler, solvers, step/run, fleets
  repro_torch.kernels    -- hand-written CUDA kernels with plain versions
  repro_torch.configs    -- the architecture configs (all ten of the JAX package)
  repro_torch.models     -- build_model: every model family, its loss
  repro_torch.data       -- non-IID CU sources and the decision -> batch sampler
  repro_torch.optim      -- AdamW, schedules, gradient compression
  repro_torch.checkpoint -- atomic snapshots and auto-resume
  repro_torch.parallel   -- sharding rules, the FSDP gather, the int8 cross-pod sum
  repro_torch.launch     -- the mesh, train / serve / prefill steps, the entry points
  repro_torch.bridge     -- numpy <-> port state, LM parameters and AdamW state, for tests
"""
from . import core, kernels  # noqa: F401
