"""The PyTorch port's network sampler.

The port draws from a keyed counter-based generator (Threefry-2x32), keyed
otherwise than JAX's streams, so its bits differ from the JAX package's;
what is held here is what both samplers promise: every element's value
depends only on (seed, stream, slot, indices), so padding leaves the true
block bit-identical; the distributions (means and quantiles against the
JAX sampler's own draws, ranges, clip bounds); symmetric EC-EC capacities
and costs with a zero diagonal; heterogeneity that persists across slots
while the noise does not; masked entities that carry no capacity and no
arrivals.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jax_prng  # noqa: E402

from repro_torch.core import (CocktailConfig, ShapeConfig, SliceParams, init_state,  # noqa: E402
                              slot_network)
from repro_torch.core import network  # noqa: E402
from repro_torch.core.types import het_seed  # noqa: E402

CFG = CocktailConfig(n_cu=10, n_ec=4, seed=3)


def _sample(seed, t=0, cfg=CFG, het=None):
    return network.sample_network_state(seed, cfg, torch.tensor(t), het=het, device="cpu")


def _block(a, like):
    return a[tuple(slice(0, s) for s in like.shape)]


# Random123's known-answer vectors for threefry2x32_20: (key, counter, out).
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]


@pytest.mark.parametrize("key, ctr, want", KAT, ids=str)
def test_threefry_known_answers(key, ctr, want):
    got = network.threefry2x32(*(torch.tensor(w) for w in (*key, *ctr)))
    assert tuple(int(v) for v in got) == want


def test_threefry_matches_jax_on_random_words():
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (rng.integers(0, 2 ** 32, 4096, dtype=np.uint64) for _ in range(4))
    want = jax_prng.threefry2x32_p.bind(*(jnp.asarray(w, jnp.uint32) for w in (k0, k1, x0, x1)))
    got = network.threefry2x32(*(torch.as_tensor(w.astype(np.int64)) for w in (k0, k1, x0, x1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_beta_draws_have_their_moments():
    for stream, (a, b) in ((network.NOISE_D, (2, 4)), (network.WORKLOAD, (2, 5))):
        u = network.uniforms(0, 0, [(stream, (200_000,), a + b - 1)], device="cpu")[0]
        x = network._beta(u, a).double()
        mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
        assert abs(float(x.mean()) - mean) < 3e-3
        assert abs(float(x.var()) - var) < 2e-3
        assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0


def test_uniforms_are_24_bit_and_in_range():
    u = network.uniforms(4, 9, [(network.COST_C, (300, 40), 1)], device="cpu")[0]
    assert u.dtype == torch.float32 and u.shape == (300, 40)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert torch.equal(u * 2 ** 24, torch.round(u * 2 ** 24))
    assert abs(float(u.double().mean()) - 0.5) < 5e-3


def test_heterogeneity_ranges():
    het = network.heterogeneity(1, 300, 40, device="cpu")
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
    het = network.heterogeneity(2, 500, 40, device="cpu")
    u = network.uniforms(9, 0, [(network.NOISE_D, (500, 40), 5)], device="cpu")[0]
    traffic = network._traffic(u, het.phase_d, torch.tensor(0))
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
    # The run seed is carried unchanged; the slot counter moves the draws.
    assert st.rng.dtype == torch.int64 and st.rng.dim() == 0
    assert torch.equal(n1.rng, st.rng) and torch.equal(n2.rng, st.rng)
    assert int(st.rng) == CFG.seed
    assert not torch.equal(slot_network(CFG, st).c, slot_network(CFG, n1).c)


def test_capacity_time_mean_tracks_link_het():
    """Over a diurnal period the per-link mean capacity is ordered by the
    persistent multiplier."""
    st = init_state(CocktailConfig(n_cu=30, n_ec=6, seed=4), device="cpu")
    cfg = CocktailConfig(n_cu=30, n_ec=6)
    ds = [network.sample_network_state(7, cfg, torch.tensor(3 * t), het=st.het, device="cpu").d
          for t in range(96)]
    mean_d = torch.stack(ds).mean(0).flatten().numpy()
    corr = np.corrcoef(mean_d, st.het.link_het.flatten().numpy())[0, 1]
    assert corr > 0.9


def test_masked_entities_get_no_capacity_or_arrivals():
    cfg = CocktailConfig(n_cu=5, n_ec=3)
    params = SliceParams.from_config(cfg, pad_shape=ShapeConfig(8, 5), device="cpu")
    net = network.sample_network_state(2, ShapeConfig(8, 5), torch.tensor(0), params)
    assert float(net.d[5:].abs().sum()) == 0 and float(net.d[:, 3:].abs().sum()) == 0
    assert float(net.cap_d[3:].abs().sum()) == 0 and float(net.cap_d[:, 3:].abs().sum()) == 0
    assert float(net.f[3:].abs().sum()) == 0 and float(net.arrivals[5:].abs().sum()) == 0
    assert float(net.d[:5, :3].min()) > 0 and float(net.arrivals[:5].min()) > 0


@pytest.mark.parametrize("true, pad", [((10, 4), (12, 5)), ((7, 3), (16, 8))], ids=str)
def test_padded_draws_equal_unpadded_on_true_block(true, pad):
    """Heterogeneity and network state of a slice zero-padded to a larger
    shape equal the unpadded slice's on the true block, bit for bit."""
    cfg = CocktailConfig(n_cu=true[0], n_ec=true[1], seed=11,
                         f_base=np.linspace(1e4, 3e4, true[1]), zeta=np.arange(1, true[0] + 1) * 50.0)
    params = SliceParams.from_config(cfg, pad_shape=ShapeConfig(*pad), device="cpu")
    st = init_state(cfg, device="cpu")
    stp = init_state(ShapeConfig(*pad), params, seed=cfg.seed)
    for f in st.het._fields:
        a, b = getattr(st.het, f), getattr(stp.het, f)
        assert b.shape == (pad[0] if f in ("link_het", "phase_d") else pad[1], pad[1])
        assert torch.equal(a, _block(b, a)), f
    for t in (0, 5, 287):
        net = network.sample_network_state(st.rng, cfg, torch.tensor(t), het=st.het)
        netp = network.sample_network_state(stp.rng, ShapeConfig(*pad), torch.tensor(t), params,
                                            het=stp.het)
        for f in net._fields:
            a, b = getattr(net, f), getattr(netp, f)
            assert torch.equal(a, _block(b, a)), (t, f)


def test_same_seed_and_slot_give_the_same_draws():
    draws = network.slot_draws(10, 4)
    a = network.uniform_bits(3, 7, draws, device="cpu")
    assert torch.equal(a, network.uniform_bits(torch.tensor(3), torch.tensor(7, dtype=torch.int32),
                                               draws))
    for x, y in zip(_sample(3, 7), _sample(3, 7)):
        assert torch.equal(x, y)
    other_t = network.uniform_bits(3, 8, draws, device="cpu")
    other_seed = network.uniform_bits(4, 7, draws, device="cpu")
    for other in (other_t, other_seed):
        assert float((a == other).double().mean()) < 1e-3
    # Streams of one call are independent of each other's presence.
    alone = network.uniform_bits(3, 7, draws[3:4], device="cpu")
    offset = sum(math.prod(s) * k for _, s, k in draws[:3])
    assert torch.equal(alone, a[offset:offset + alone.numel()])


# ---------------------------------------------------------------------------
# Distributions against the JAX sampler's own draws
# ---------------------------------------------------------------------------

DIST_N, DIST_M, DIST_VEC = 320, 448, 100_000
QUANTILES = np.array([0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99])


@pytest.fixture(scope="module")
def draws_of_both():
    """{name: (port draws, JAX draws)} as float64 numpy vectors of at least
    100,000 samples each: the matrices from one slot at 320 x 448 (the
    upper triangle of the symmetric EC-EC ones: 100,128 entries), f, p and
    the arrivals from the samplers' own per-element helpers at 100,000
    entities."""
    from repro.core import network as JN
    from repro.core import types as JT
    import repro.core as J

    n, m, v = DIST_N, DIST_M, DIST_VEC
    jcfg = J.CocktailConfig(n_cu=n, n_ec=m)
    jhet = JN.heterogeneity(JT.het_key_from_seed(0), n, m)
    jnet = jax.jit(JN.sample_network_state, static_argnums=(1,))(
        jax.random.PRNGKey(1), jcfg.shape, 17, jcfg.params, het_key=JT.het_key_from_seed(0))
    tcfg = CocktailConfig(n_cu=n, n_ec=m)
    thet = network.heterogeneity(het_seed(0), n, m, device="cpu")
    tnet = network.sample_network_state(1, tcfg, torch.tensor(17), het=thet, device="cpu")
    iu = np.triu_indices(m, 1)
    out = {}
    for f in ("link_het", "ec_het", "phase_d", "phase_D"):
        out[f] = (getattr(thet, f).numpy(), np.asarray(getattr(jhet, f)))
    for f in ("d", "c"):
        out[f] = (getattr(tnet, f).numpy(), np.asarray(getattr(jnet, f)))
    for f in ("cap_d", "e"):
        out[f] = (getattr(tnet, f).numpy()[iu], np.asarray(getattr(jnet, f))[iu])

    k = jax.random.split(jax.random.PRNGKey(2), 3)
    u_f, u_p, u_a = network.uniforms(5, 3, [(network.WORKLOAD, (v,), 6), (network.COST_P, (v,), 1),
                                            (network.ARRIVALS, (v,), 1)], device="cpu")
    out["f"] = ((1.0 - network._workload(u_f)).numpy(), 1.0 - np.asarray(JN._workload(k[0], v)))
    out["p"] = ((1.0 + u_p).numpy(), 1.0 + np.asarray(JN._uniform_vec(k[1], v)))
    out["arrivals"] = ((0.5 + u_a).numpy(), 0.5 + np.asarray(JN._uniform_vec(k[2], v)))
    return {name: (a.ravel().astype(np.float64), b.ravel().astype(np.float64))
            for name, (a, b) in out.items()}


@pytest.mark.parametrize("name", ["link_het", "ec_het", "phase_d", "phase_D", "d", "cap_d",
                                  "c", "e", "f", "p", "arrivals"])
def test_distribution_matches_jax(draws_of_both, name):
    """Mean within 0.5 % and the 1-99 % quantiles within 1.5 % of the JAX
    draws' 1-99 % range. With these seeds the eleven quantities read at most
    0.24 % (means) and 0.47 % (quantiles), sampling error at 100,000 or more
    samples a side; drawing the traffic noise from Beta(2,5) instead of
    Beta(2,4) moves d's and cap_d's means by 1.5 % and 2.3 % and their
    quantiles by 2.1 % and 2.7 %, which both limits catch."""
    port, ref = draws_of_both[name]
    assert port.size >= 100_000 and ref.size >= 100_000
    width = np.quantile(ref, 0.99) - np.quantile(ref, 0.01)
    assert abs(port.mean() - ref.mean()) <= 5e-3 * width, (port.mean(), ref.mean())
    np.testing.assert_allclose(np.quantile(port, QUANTILES), np.quantile(ref, QUANTILES),
                               rtol=0, atol=1.5e-2 * width)


def test_framework_cost_matches_jax():
    jax_network = pytest.importorskip("repro.core.network")
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
