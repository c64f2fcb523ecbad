"""The PyTorch port's greedy matchers held against the JAX package.

The port's plain versions (``repro_torch.kernels.matching.ref``, which are
what ``ops`` runs for CPU tensors) must return the same 0/1 decisions as
``repro.kernels.matching.ops`` with ``impl="auto"`` (the jnp refs on the
CPU) and as the Pallas kernels in interpret mode, on inputs made from a
numpy seed. The CUDA kernels themselves run only on the card; they are held
bit for bit against these plain versions by ``chip_smoke.py``.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matching import ops as jops  # noqa: E402
from repro.kernels.matching.kernel import (greedy_assignment_pallas,  # noqa: E402
                                           greedy_collection_pallas,
                                           greedy_pairing_pallas)
from repro.kernels.matching.ref import pairing_value_matrix as j_value_matrix  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.kernels.matching import kernel as tkernel  # noqa: E402
from repro_torch.kernels.matching import ops as tops  # noqa: E402
from repro_torch.kernels.matching.ref import (_marginal_penalty,  # noqa: E402
                                              greedy_assignment_ref,
                                              greedy_collection_ref,
                                              greedy_pairing_ref,
                                              pairing_value_matrix)

SHAPES = [(8, 3), (128, 16), (512, 16), (6, 9)]  # (6, 9): M > N


def _logw(rng, n, m, inf_frac=0.2):
    logw = np.log(rng.uniform(0.2, 40.0, (n, m))).astype(np.float32)
    logw[rng.random((n, m)) < inf_frac] = -np.inf
    return logw


def _weights(rng, n, m):
    return rng.uniform(-5.0, 40.0, (n, m)).astype(np.float32)


def _solo_pair(rng, m):
    solo = rng.uniform(-1.0, 5.0, (m,)).astype(np.float32)
    pair = rng.uniform(-2.0, 10.0, (m, m))
    return solo, ((pair + pair.T) / 2.0).astype(np.float32)


def _masks(rng, n, m):
    cu = (rng.random(n) > 0.3).astype(np.float32)
    ec = (rng.random(m) > 0.3).astype(np.float32)
    cu[0] = ec[0] = 1.0
    return cu, ec


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _equal(a_port, a_jax):
    np.testing.assert_array_equal(a_port.numpy(), np.asarray(a_jax))


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
class TestOpsParity:
    """Port ops (plain versions on CPU) against JAX ops with impl="auto"."""

    def test_collection(self, shape, masked):
        n, m = shape
        rng = np.random.default_rng(n * 100 + m)
        logw = _logw(rng, n, m)
        cu, ec = _masks(rng, n, m) if masked else (None, None)
        a_t, th_t = tops.greedy_collection(_t(logw), _t(cu), _t(ec))
        a_j, th_j = jops.greedy_collection(_j(logw), _j(cu), _j(ec))
        _equal(a_t, a_j)
        _equal(th_t, th_j)  # 1/n_j of equal integer counts: exact
        assert a_t.sum() > 0

    def test_assignment(self, shape, masked):
        n, m = shape
        rng = np.random.default_rng(n * 100 + m + 1)
        w = _weights(rng, n, m)
        cu, ec = _masks(rng, n, m) if masked else (None, None)
        a_t = tops.greedy_assignment(_t(w), _t(cu), _t(ec))
        _equal(a_t, jops.greedy_assignment(_j(w), _j(cu), _j(ec)))
        assert a_t.sum() > 0

    def test_pairing(self, shape, masked):
        _, m = shape
        rng = np.random.default_rng(m * 7 + int(masked))
        solo, pair = _solo_pair(rng, m)
        ec = _masks(rng, 1, m)[1] if masked else None
        mt = tops.greedy_pairing(_t(solo), _t(pair), _t(ec))
        _equal(mt, jops.greedy_pairing(_j(solo), _j(pair), _j(ec)))
        assert mt.sum() > 0


def test_against_pallas_interpret():
    """One case per matcher against the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(3)
    logw = _logw(rng, 8, 3)
    _equal(greedy_collection_ref(_t(logw))[0],
           greedy_collection_pallas(_j(logw), interpret=True))
    w = _weights(rng, 8, 3)
    _equal(greedy_assignment_ref(_t(w)), greedy_assignment_pallas(_j(w), interpret=True))
    solo, pair = _solo_pair(rng, 5)
    _equal(greedy_pairing_ref(_t(solo), _t(pair)),
           greedy_pairing_pallas(j_value_matrix(_j(solo), _j(pair)), interpret=True))


@pytest.mark.parametrize("op", ["collection", "assignment", "pairing", "assignment_inf_ties",
                                "assignment_row_dominated", "pairing_row_dominated",
                                "pairing_asymmetric"])
def test_integer_ties_match_jax(op):
    """Many equal weights: the first maximum in row-major order must win in
    both packages. The cases the CUDA designs are sensitive to are also held
    against the Pallas kernels in interpret mode: +inf entries that tie
    (assignment takes them, lowest flat index first), row-dominated weights
    w_ij = a_i b_ij (every column ranks the same rows first; integer b, so
    rows tie too), and an asymmetric tied value matrix (ties fall to the
    lower flat index j M + k)."""
    rng = np.random.default_rng(11)
    n, m = 64, 8
    if op == "collection":
        logw = rng.integers(-2, 6, (n, m)).astype(np.float32)
        _equal(tops.greedy_collection(_t(logw))[0], jops.greedy_collection(_j(logw))[0])
    elif op.startswith("assignment"):
        if op == "assignment_inf_ties":
            w = rng.integers(-2, 4, (n, m)).astype(np.float32)
            w[rng.random((n, m)) < 0.1] = np.inf
            w[rng.random((n, m)) < 0.05] = np.nan
        elif op == "assignment_row_dominated":
            a = np.array([1.0, 10.0, 100.0, 1000.0])[rng.integers(0, 4, (n, 1))]
            w = (a * rng.integers(1, 4, (n, m))).astype(np.float32)
        else:
            w = rng.integers(-2, 4, (n, m)).astype(np.float32)
        a_t = tops.greedy_assignment(_t(w))
        _equal(a_t, jops.greedy_assignment(_j(w)))
        if op != "assignment":
            _equal(a_t, greedy_assignment_pallas(_j(w), interpret=True))
            assert a_t.sum() == m
    else:
        solo = rng.integers(-1, 3, (m,)).astype(np.float32)
        pair = rng.integers(-1, 4, (m, m)).astype(np.float32)
        if op == "pairing_row_dominated":
            a = np.array([1.0, 10.0, 100.0])[rng.integers(0, 3, m)]
            solo, pair = solo * a * a, pair * a[:, None] * a[None, :]
        if op != "pairing_asymmetric":
            pair = np.maximum(pair, pair.T)
        mt = tops.greedy_pairing(_t(solo), _t(pair))
        _equal(mt, jops.greedy_pairing(_j(solo), _j(pair)))
        if op != "pairing":
            vals = pairing_value_matrix(_t(solo), _t(pair)).numpy()
            _equal(mt, greedy_pairing_pallas(_j(vals), interpret=True))
            assert mt.sum() > 0


def test_nan_rules_match_jax():
    """Pairing does not sanitize: the first NaN among free ECs wins the
    argmax and stops the loop. Collection maps non-finite values to -1e30,
    assignment drops them with w > 0."""
    rng = np.random.default_rng(5)
    solo, pair = _solo_pair(rng, 6)
    pair[2, 4] = pair[4, 2] = np.nan
    mt = tops.greedy_pairing(_t(solo), _t(pair))
    _equal(mt, jops.greedy_pairing(_j(solo), _j(pair)))
    assert mt.sum() == 0  # the NaN is free at the first step: nothing is taken
    logw = _logw(rng, 16, 4)
    logw[3, 1] = np.nan
    logw[5, 2] = np.inf
    _equal(tops.greedy_collection(_t(logw))[0], jops.greedy_collection(_j(logw))[0])
    w = _weights(rng, 16, 4)
    w[0, 0] = np.nan
    _equal(tops.greedy_assignment(_t(w)), jops.greedy_assignment(_j(w)))


def test_leading_axes_equal_per_problem():
    rng = np.random.default_rng(2)
    logw = np.stack([_logw(rng, 32, 4) for _ in range(6)]).reshape(2, 3, 32, 4)
    a, th = tops.greedy_collection(_t(logw))
    w = rng.uniform(-5, 40, (2, 3, 32, 4)).astype(np.float32)
    aa = tops.greedy_assignment(_t(w))
    sp = [_solo_pair(rng, 5) for _ in range(6)]
    solo = np.stack([s for s, _ in sp]).reshape(2, 3, 5)
    pair = np.stack([p for _, p in sp]).reshape(2, 3, 5, 5)
    mt = tops.greedy_pairing(_t(solo), _t(pair))
    assert a.shape == (2, 3, 32, 4) and mt.shape == (2, 3, 5, 5)
    for b in range(2):
        for c in range(3):
            a1, th1 = greedy_collection_ref(_t(logw[b, c]))
            assert torch.equal(a[b, c], a1) and torch.equal(th[b, c], th1)
            assert torch.equal(aa[b, c], greedy_assignment_ref(_t(w[b, c])))
            assert torch.equal(mt[b, c], greedy_pairing_ref(_t(solo[b, c]), _t(pair[b, c])))


def test_masked_entities_never_selected():
    rng = np.random.default_rng(9)
    n, m = 40, 6
    cu, ec = _masks(rng, n, m)
    a, _ = tops.greedy_collection(_t(_logw(rng, n, m, 0.0)), _t(cu), _t(ec))
    aa = tops.greedy_assignment(_t(rng.uniform(1, 40, (n, m)).astype(np.float32)),
                                _t(cu), _t(ec))
    mt = tops.greedy_pairing(_t(np.full(m, 5.0, np.float32)),
                             _t(np.full((m, m), 9.0, np.float32)), _t(ec))
    for sel in (a, aa):
        assert sel.numpy()[cu == 0].sum() == 0
        assert sel.numpy()[:, ec == 0].sum() == 0
    assert mt.numpy()[ec == 0].sum() == 0 and mt.numpy()[:, ec == 0].sum() == 0


def test_half_approximation_against_oracle():
    """Greedy max-weight matching is a 0.5-approximation (paper Sec. III-D)."""
    rng = np.random.default_rng(21)
    for _ in range(3):
        logw = _logw(rng, 10, 3)
        a, _ = greedy_collection_ref(_t(logw))
        a_opt, _ = oracle.exact_collection(logw)
        greedy = oracle.collection_objective(logw, a.numpy())
        assert greedy >= 0.5 * oracle.collection_objective(logw, a_opt) - 1e-5
        w = _weights(rng, 10, 3)
        aa = greedy_assignment_ref(_t(w)).numpy()
        opt = oracle.exact_assignment(w)
        assert (w * aa).sum() >= 0.5 * (w * opt).sum() - 1e-4
        solo, pair = _solo_pair(rng, 6)
        mt = greedy_pairing_ref(_t(solo), _t(pair)).numpy()
        vals = pairing_value_matrix(_t(solo), _t(pair)).numpy()
        opt = oracle.exact_pairing(solo, pair)
        value = lambda mm: float((np.triu(mm) * vals).sum())  # noqa: E731
        assert value(mt) >= 0.5 * value(opt) - 1e-4


def test_marginal_penalty_matches_jax():
    """Penalty tables agree within float32 rounding. XLA's log and
    PyTorch's may differ in the last ulp, and (n+1)log(n+1) - n log n
    cancels, so the bound is two ulps of the larger product."""
    from repro.kernels.matching.ref import _marginal_penalty as j_pen
    n = np.arange(0, 600, dtype=np.float32)
    diff = np.abs(_marginal_penalty(_t(n)).numpy() - np.asarray(j_pen(_j(n))))
    ulp = np.spacing(((n + 1) * np.log(n + 1)).astype(np.float32))
    assert (diff <= 2 * ulp).all()
    assert math.isclose(float(_marginal_penalty(torch.tensor(1.0))), 2 * math.log(2), rel_tol=1e-6)


def test_kernel_impl_refuses_cpu_tensors():
    """The CUDA wrapper runs only on CUDA tensors; ``impl="kernel"`` on a CPU
    tensor raises instead of falling back."""
    w = torch.ones(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tops.greedy_assignment(w, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        tops.greedy_assignment(w, impl="pallas")
    assert set(tkernel.launches) == {"greedy_collection", "greedy_assignment",
                                     "greedy_pairing"}


def test_kernel_source_builds_with_sm90a_flags():
    """The build is keyed by the sources and flags, targets sm_90a, and the
    module imports without compiling anything."""
    from repro_torch.kernels import _build
    path = _build.library_path("greedy_matching", tkernel.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libgreedy_matching-")
    src = tkernel.SOURCES[0].read_text()
    for fn in ("greedy_collection_launch", "greedy_assignment_launch",
               "greedy_pairing_launch"):
        assert f"int {fn}(" in src
    code = ("import sys; import repro_torch.kernels.matching.kernel as k; "
            "assert k._lib is None")
    env = {**os.environ, "PYTHONPATH": str(_build.REPO_ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
