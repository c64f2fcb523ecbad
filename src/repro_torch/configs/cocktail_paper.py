"""The paper's own testbed scale (Sec. IV-A): 6 CUs, 3 ECs. Counterpart of
``repro.configs.cocktail_paper``."""
from repro_torch.core import CocktailConfig

TESTBED = CocktailConfig(
    n_cu=6, n_ec=3, delta=0.02, eps=0.1, rho=1.0, q0=5000.0, zeta=500.0,
    d_base=2000.0, cap_d_base=8000.0, f_base=(8000.0, 20000.0, 8000.0),
    c_base=250.0, e_base=50.0, p_base=200.0, seed=0,
)
