"""The PyTorch port's training-allocation solvers held against the JAX
package, op by op, on inputs made from a numpy seed.

Tolerances: rtol 1e-5 where no loop amplifies rounding (waterfill, the
linear fills). ``pair_allocate`` and ``full_allocate`` run 20-120 dual
subgradient iterations whose sums XLA and PyTorch reduce in different
orders (and XLA may fuse a multiply-add); the last-bit differences grow
through the iterations, so those are held to 1e-4 of each output's scale.
Some pairs are ill-conditioned for the algorithm itself: there the port's
own float32 and float64 answers differ by far more than 1e-4, and such a
pair may differ from JAX by up to four times that spread as well.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import training_alloc as J  # noqa: E402
from repro_torch.core import training_alloc as T  # noqa: E402

N = 12
_JAX_WATERFILL = J.solo_waterfill


def _close(port, ref, rtol, scale_atol=0.0):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    atol = scale_atol * max(float(np.abs(ref).max()), 1e-30) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _pair_inputs(rng, p=None):
    lead = () if p is None else (p,)
    vec = lambda lo, hi: rng.uniform(lo, hi, (*lead, N)).astype(np.float32)  # noqa: E731
    b_j, b_k = vec(-20, 80), vec(-20, 80)
    g_kj, g_jk = vec(-30, 60), vec(-30, 60)
    r_j, r_k = vec(0, 400), vec(0, 400)
    r_j[..., 0] = 0.0  # an empty queue
    scal = lambda lo, hi: rng.uniform(lo, hi, lead).astype(np.float32)  # noqa: E731
    return [b_j, g_kj, b_k, g_jk, r_j, r_k, scal(200, 3000), scal(200, 3000), scal(0, 1500)]


def repaired_jax_waterfill(beta, r, budget):
    """The JAX ``solo_waterfill`` with its slack-budget defect repaired.

    When the budget covers every active queue, the reference finds the fill
    level max(r) only if its ``sum`` and ``cumsum`` round alike, and else
    trains nothing (ROADMAP.md, Queue 3). Here such a lost level fills every
    active queue, as the port does; every other answer is the reference's.
    """
    x, value = _JAX_WATERFILL(beta, r, budget)
    r_act = jnp.where((beta > 0) & (r > 1e-9), r, 0.0)
    lost = (budget >= jnp.sum(r_act)) & jnp.all(x == 0)
    full = jnp.sum(jnp.where(r_act > 1e-9, jnp.log(jnp.maximum(beta * r_act, 1e-9)), 0.0))
    return jnp.where(lost, r_act, x), jnp.where(lost, full, value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solo_waterfill(seed):
    rng = np.random.default_rng(seed)
    beta = rng.uniform(-10, 50, (5, N)).astype(np.float32)
    r = rng.uniform(0, 300, (5, N)).astype(np.float32)
    r[:, :2] = 0.0
    budget = np.array([0.0, 50.0, 900.0, 5000.0, -3.0], np.float32)  # tight .. slack
    x, v = T.solo_waterfill(torch.from_numpy(beta), torch.from_numpy(r), torch.from_numpy(budget))
    args = (jnp.asarray(beta), jnp.asarray(r), jnp.asarray(budget))
    xj, vj = map(np.asarray, jax.vmap(J.solo_waterfill)(*args))
    xf, vf = jax.vmap(repaired_jax_waterfill)(*args)
    _close(x, xf, 1e-5, 1e-6)
    _close(v, vf, 1e-5, 1e-6)
    # The repair touches only rows whose budget covers every active queue
    # and where the reference allocated nothing.
    r_act = np.where((beta > 0) & (r > 1e-9), r, 0.0)
    lost = (budget >= r_act.sum(-1)) & (xj == 0).all(-1)
    np.testing.assert_array_equal(np.asarray(xf)[~lost], xj[~lost])
    np.testing.assert_array_equal(np.asarray(vf)[~lost], vj[~lost])


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_solo_with_ties(seed):
    """Tied weights: the fill order must follow the stable sort."""
    rng = np.random.default_rng(seed)
    beta = rng.integers(-2, 5, (4, N)).astype(np.float32)  # many ties
    r = rng.uniform(0, 100, (4, N)).astype(np.float32)
    budget = np.array([10.0, 150.0, 400.0, 2000.0], np.float32)
    x, v = T.linear_solo(torch.from_numpy(beta), torch.from_numpy(r), torch.from_numpy(budget))
    xj, vj = jax.vmap(J.linear_solo)(jnp.asarray(beta), jnp.asarray(r), jnp.asarray(budget))
    _close(x, xj, 1e-5, 1e-7)
    _close(v, vj, 1e-5, 1e-7)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_linear_pair_batched(ties):
    rng = np.random.default_rng(7)
    args = _pair_inputs(rng, p=6)
    if ties:
        for a in args[:4]:
            a[...] = np.round(a / 20.0)
    pa = T.linear_pair(*map(torch.from_numpy, args))
    pj = jax.vmap(J.linear_pair)(*map(jnp.asarray, args))
    for f in pa._fields:
        _close(getattr(pa, f), getattr(pj, f), 1e-5, 1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_allocate_batched(seed):
    """P pairs on one leading axis against the JAX solver vmapped over them."""
    rng = np.random.default_rng(seed)
    args = _pair_inputs(rng, p=5)
    pa = T.pair_allocate(*map(torch.from_numpy, args), iters=60)
    p64 = T.pair_allocate(*[torch.from_numpy(a.astype(np.float64)) for a in args], iters=60)
    pj = jax.vmap(lambda *a: J.pair_allocate(*a, iters=60))(*map(jnp.asarray, args))
    unstable = np.zeros(5, bool)
    for f in pa._fields:
        port, ref = getattr(pa, f).double().numpy(), np.asarray(getattr(pj, f), np.float64)
        # The algorithm's own float32 sensitivity, per pair.
        spread = np.abs(port - getattr(p64, f).numpy()).reshape(5, -1).max(-1)
        scale = 1e-4 * np.abs(ref).max()
        unstable |= spread > scale
        spread = spread.reshape(5, *[1] * (port.ndim - 1))
        assert (np.abs(port - ref) <= scale + 4 * spread).all(), f
    assert unstable.sum() <= 1  # the rest are held to 1e-4 of scale
    # Feasibility of the port's own answer.
    b = [torch.from_numpy(a) for a in args]
    assert bool(((pa.x_j + pa.y_jk) <= b[4] * (1 + 1e-5) + 1e-4).all())
    assert bool((pa.y_jk.sum(-1) + pa.y_kj.sum(-1) <= b[8] * (1 + 1e-5) + 1e-3).all())


def test_pair_allocate_unbatched_matches_batched():
    rng = np.random.default_rng(4)
    args = _pair_inputs(rng, p=3)
    batched = T.pair_allocate(*map(torch.from_numpy, args), iters=30)
    for p in range(3):
        one = T.pair_allocate(*[torch.from_numpy(np.array(a[p])) for a in args],
                              iters=30)
        for f in one._fields:
            _close(getattr(one, f), getattr(batched, f)[p], 1e-6, 1e-6)


def test_full_allocate():
    rng = np.random.default_rng(3)
    n, m = 6, 3
    beta = rng.uniform(-10, 60, (n, m)).astype(np.float32)
    gamma = rng.uniform(-20, 50, (n, m, m)).astype(np.float32)
    r = rng.uniform(0, 300, (n, m)).astype(np.float32)
    budgets = rng.uniform(300, 2000, (m,)).astype(np.float32)
    links = rng.uniform(100, 1000, (m, m)).astype(np.float32)
    links = ((links + links.T) / 2).astype(np.float32)
    x, y, v = T.full_allocate(*map(torch.from_numpy, (beta, gamma, r, budgets, links)),
                              iters=20, sweeps=2)
    xj, yj, vj = J.full_allocate(*map(jnp.asarray, (beta, gamma, r, budgets, links)),
                                 iters=20, sweeps=2)
    _close(x, xj, 1e-4, 1e-4)
    _close(y, yj, 1e-4, 1e-4)
    _close(v, vj, 1e-4, 1e-4)
