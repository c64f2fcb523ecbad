"""Data of the port's LM training: non-IID CU sources (numpy, the JAX
package's draws) and the Cocktail decision -> batch bridge; counterpart of
``repro.data``."""
from .sampler import CocktailSampler
from .sources import TokenSource, TrafficSource

__all__ = ["CocktailSampler", "TokenSource", "TrafficSource"]
