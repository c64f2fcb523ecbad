"""PyTorch / CUDA port of the Cocktail scheduler (``repro`` is the JAX
reference it is held against). Imports torch and never jax.

  repro_torch.core     -- the scheduler: types, sampler, solvers, step/run
  repro_torch.kernels  -- hand-written CUDA kernels with plain versions
  repro_torch.bridge   -- numpy <-> port state, for tests against ``repro``
"""
from . import core, kernels  # noqa: F401
