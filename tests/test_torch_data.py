"""The port's data layer (``repro_torch.data``) against the JAX package's.

``TokenSource`` and ``TrafficSource`` are numpy in both packages: the same
seed must draw bit-equal arrays, call after call. ``CocktailSampler`` must
turn the same decision (numpy x / y on the JAX side, torch tensors on the
port's) into bit-equal batches: tokens, labels, weights, source ids and EC
ids, including an EC that trains nothing (zero-weight filler) and a slot in
which no EC trains.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.data import CocktailSampler as JSampler  # noqa: E402
from repro.data import TokenSource as JToken  # noqa: E402
from repro.data import TrafficSource as JTraffic  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.data import CocktailSampler, TokenSource, TrafficSource  # noqa: E402

N_CU, N_EC = 6, 3


@pytest.mark.parametrize("vocab,seq,seed", [(128, 16, 0), (1000, 8, 3), (256000, 4, 1)])
def test_token_source_draws_equal(vocab, seq, seed):
    ours = [TokenSource(i, vocab, seq, seed=seed) for i in range(3)]
    theirs = [JToken(i, vocab, seq, seed=seed) for i in range(3)]
    for n in (1, 5, 2):
        for a, b in zip(ours, theirs):
            got, want = a.sample(n), b.sample(n)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 4])
def test_traffic_source_draws_equal(seed):
    a, b = TrafficSource(2, seed=seed), JTraffic(2, seed=seed)
    for n in (3, 7):
        (gx, gy), (wx, wy) = a.sample(n), b.sample(n)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _decision(case: str, seed: int):
    """(x (N, M), y (N, M, M)) numpy: dense, one idle EC (EC 1 trains
    nothing) or an empty slot."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 300, (N_CU, N_EC)) * (rng.uniform(size=(N_CU, N_EC)) < 0.6)
    y = rng.uniform(0, 100, (N_CU, N_EC, N_EC)) * (rng.uniform(size=(N_CU, N_EC, N_EC)) < 0.3)
    if case == "idle_ec":
        x[:, 1] = 0.0
        y[:, :, 1] = 0.0
    if case == "empty":
        x[:], y[:] = 0.0, 0.0
    return x.astype(np.float32), y.astype(np.float32)


def _samplers(batch_per_ec: int, seed: int):
    ck = core.CocktailConfig(n_cu=N_CU, n_ec=N_EC, seed=seed)
    jck = jcore.CocktailConfig(n_cu=N_CU, n_ec=N_EC, seed=seed)
    ours = CocktailSampler(ck, [TokenSource(i, 64, 12, seed=seed) for i in range(N_CU)],
                           batch_per_ec=batch_per_ec, seed=seed)
    theirs = JSampler(jck, [JToken(i, 64, 12, seed=seed) for i in range(N_CU)],
                      batch_per_ec=batch_per_ec, seed=seed)
    return ours, theirs


@pytest.mark.parametrize("case", ["dense", "idle_ec", "empty"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_batches_equal(case, seed):
    x, y = _decision(case, seed)
    n, m = x.shape
    zeros = np.zeros((n, m), np.float32)
    jdec = jcore.Decision(alpha=zeros, theta=zeros, x=x, y=y, z=np.zeros((m, m), np.float32))
    dec = core.Decision(*(torch.as_tensor(a) for a in (zeros, zeros, x, y,
                                                       np.zeros((m, m), np.float32))))
    ours, theirs = _samplers(4, seed)
    np.testing.assert_array_equal(ours.composition(dec), theirs.composition(jdec))
    for _ in range(3):  # the sources' streams advance together
        got, want = ours.sample(dec), theirs.sample(jdec)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if case == "idle_ec":  # EC 1's rows are all zero-weight filler from source 0
        rows = got["ec_ids"] == 1
        assert rows.sum() == 4
        assert (got["weights"][rows] == 0).all() and (got["source_ids"][rows] == 0).all()
    if case == "empty":
        assert (got["weights"] == 0).all()


def test_sampler_checks_its_sources():
    with pytest.raises(ValueError, match="sources"):
        CocktailSampler(core.CocktailConfig(n_cu=N_CU, n_ec=N_EC),
                        [TokenSource(0, 64, 12)], batch_per_ec=2)
