"""PyTorch / CUDA port of the Cocktail scheduler and its LM serving path
(``repro`` is the JAX reference it is held against). Imports torch and never
jax.

  repro_torch.core     -- the scheduler: types, sampler, solvers, step/run
  repro_torch.kernels  -- hand-written CUDA kernels with plain versions
  repro_torch.configs  -- ported architecture configs (minitron-4b, falcon-mamba-7b)
  repro_torch.models   -- build_model: dense transformer and Mamba-1 LMs
  repro_torch.launch   -- serve / prefill steps and the serving entry point
  repro_torch.bridge   -- numpy <-> port state and LM parameters, for tests
"""
from . import core, kernels  # noqa: F401
