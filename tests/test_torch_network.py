"""The PyTorch port's network sampler.

The port draws from ``torch.Generator``s, so its bits differ from JAX's
threefry streams; what is held here is what both samplers promise: the
distributions (means and ranges of the Beta and uniform draws, clip
bounds), symmetric EC-EC capacities and costs with a zero diagonal,
heterogeneity that persists across slots while the noise does not, and
masked entities that carry no capacity and no arrivals.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import CocktailConfig, SliceParams, init_state  # noqa: E402
from repro_torch.core import network  # noqa: E402
from repro_torch.core.types import ShapeConfig, make_generator  # noqa: E402

CFG = CocktailConfig(n_cu=10, n_ec=4, seed=3)


def _sample(seed, t=0, cfg=CFG, het=None):
    g = make_generator(seed, torch.device("cpu"))
    return network.sample_network_state(g, cfg, torch.tensor(t), het=het)


def test_beta_draws_have_their_moments():
    g = make_generator(0, torch.device("cpu"))
    for (a, b) in [(2, 4), (2, 5)]:
        x = network._beta(g, (200_000,), a, b).double()
        mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
        assert abs(float(x.mean()) - mean) < 3e-3
        assert abs(float(x.var()) - var) < 2e-3
        assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0


def test_heterogeneity_ranges():
    het = network.heterogeneity(make_generator(1, torch.device("cpu")), 300, 40)
    for mult in (het.link_het, het.ec_het):
        assert 0.5 <= float(mult.min()) and float(mult.max()) <= 1.5
        assert abs(float(mult.mean()) - 1.0) < 0.02
    for ph in (het.phase_d, het.phase_D):
        assert 0.0 <= float(ph.min()) and float(ph.max()) <= 2 * math.pi
        assert abs(float(ph.mean()) - math.pi) < 0.1


def test_network_ranges_and_symmetry():
    cfg = CocktailConfig(n_cu=400, n_ec=24, f_base=20000.0)
    net = _sample(5, t=17, cfg=cfg)
    # d = d_base * het * (1 - traffic), traffic in [0, 0.95], het in [0.5, 1.5]
    assert float(net.d.min()) >= 2000.0 * 0.5 * 0.05 - 1e-3
    assert float(net.d.max()) <= 2000.0 * 1.5 + 1e-3
    # f = f_base * (1 - clip(Beta(2,5), 0, 0.9)): E[f] = f_base * (1 - 2/7)
    assert float(net.f.min()) >= 20000.0 * 0.1 - 1e-3 and float(net.f.max()) <= 20000.0
    for name, base in (("c", 500.0), ("p", 100.0)):
        v = getattr(net, name)
        assert base <= float(v.min()) and float(v.max()) <= 2 * base
        assert abs(float(v.mean()) - 1.5 * base) < 0.05 * base
    assert abs(float(net.arrivals.mean()) - 500.0) < 25.0  # E[A_i] = zeta_i
    assert float(net.arrivals.min()) >= 250.0 and float(net.arrivals.max()) <= 750.0
    for sym in (net.cap_d, net.e):
        assert torch.equal(sym, sym.T)
        assert float(torch.diagonal(sym).abs().max()) == 0.0
    assert float(net.cap_d.max()) <= 8000.0 * 1.5


def test_traffic_mean_follows_its_model():
    """Averaged over links, traffic = 0.35 + 0.3 sin(.) + 0.4 Beta(2,4) has
    mean about 0.35 + 0.4/3 (the phases average the sinusoid out)."""
    het = network.heterogeneity(make_generator(2, torch.device("cpu")), 500, 40)
    g = make_generator(9, torch.device("cpu"))
    traffic = network._traffic(g, het.phase_d, torch.tensor(0))
    assert 0.0 <= float(traffic.min()) and float(traffic.max()) <= 0.95
    assert abs(float(traffic.mean()) - (0.35 + 0.4 / 3)) < 0.02


def test_heterogeneity_persists_while_noise_differs():
    st = init_state(CFG, device="cpu")
    s1 = init_state(CFG, device="cpu")
    for a, b in zip(st.het, s1.het):
        assert torch.equal(a, b)  # a pure function of the run seed
    other = init_state(CFG, seed=CFG.seed + 1, device="cpu")
    assert not torch.equal(st.het.link_het, other.het.link_het)

    from repro_torch.core import DS, step
    n1, _, _ = step(CFG, DS, st)
    n2, _, _ = step(CFG, DS, n1)
    for a, b, c in zip(st.het, n1.het, n2.het):
        assert torch.equal(a, b) and torch.equal(b, c)
    net_t = _sample(11, 0, het=st.het)
    net_t1 = _sample(12, 1, het=st.het)
    assert not torch.allclose(net_t.c, net_t1.c)
    assert not torch.allclose(net_t.d, net_t1.d)
    # The state's generator is forked, never advanced in place.
    assert torch.equal(st.rng.get_state(), init_state(CFG, device="cpu").rng.get_state())
    assert not torch.equal(n1.rng.get_state(), st.rng.get_state())


def test_capacity_time_mean_tracks_link_het():
    """Over a diurnal period the per-link mean capacity is ordered by the
    persistent multiplier."""
    st = init_state(CocktailConfig(n_cu=30, n_ec=6, seed=4), device="cpu")
    g = make_generator(7, torch.device("cpu"))
    cfg = CocktailConfig(n_cu=30, n_ec=6)
    ds = [network.sample_network_state(g, cfg, torch.tensor(3 * t), het=st.het).d
          for t in range(96)]
    mean_d = torch.stack(ds).mean(0).flatten().numpy()
    corr = np.corrcoef(mean_d, st.het.link_het.flatten().numpy())[0, 1]
    assert corr > 0.9


def test_masked_entities_get_no_capacity_or_arrivals():
    cfg = CocktailConfig(n_cu=5, n_ec=3)
    params = SliceParams.from_config(cfg, pad_shape=ShapeConfig(8, 5), device="cpu")
    net = network.sample_network_state(make_generator(2, torch.device("cpu")),
                                       ShapeConfig(8, 5), torch.tensor(0), params)
    assert float(net.d[5:].abs().sum()) == 0 and float(net.d[:, 3:].abs().sum()) == 0
    assert float(net.cap_d[3:].abs().sum()) == 0 and float(net.cap_d[:, 3:].abs().sum()) == 0
    assert float(net.f[3:].abs().sum()) == 0 and float(net.arrivals[5:].abs().sum()) == 0
    assert float(net.d[:5, :3].min()) > 0 and float(net.arrivals[:5].min()) > 0


def test_framework_cost_matches_jax():
    jax_network = pytest.importorskip("repro.core.network")
    import jax.numpy as jnp
    from repro.core.types import NetworkState as JNet
    rng = np.random.default_rng(0)
    n, m = 7, 3
    arrs = dict(d=rng.uniform(0, 100, (n, m)), cap_d=rng.uniform(0, 50, (m, m)),
                f=rng.uniform(0, 10, m), c=rng.uniform(1, 2, (n, m)),
                e=rng.uniform(1, 2, (m, m)), p=rng.uniform(1, 2, m),
                arrivals=rng.uniform(0, 9, n))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    col = rng.uniform(0, 30, (n, m)).astype(np.float32)
    x = rng.uniform(0, 30, (n, m)).astype(np.float32)
    y = rng.uniform(0, 30, (n, m, m)).astype(np.float32)
    want = jax_network.framework_cost(JNet(**{k: jnp.asarray(v) for k, v in arrs.items()}),
                                      jnp.asarray(col), jnp.asarray(x), jnp.asarray(y))
    got = network.framework_cost(network.NetworkState(
        **{k: torch.from_numpy(v) for k, v in arrs.items()}),
        torch.from_numpy(col), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
