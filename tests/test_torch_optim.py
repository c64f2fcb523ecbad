"""The port's optimizer (``repro_torch.optim``) against the JAX package's.

``adamw_update`` over three steps (bias corrections, moments carried) with
clipping active and inactive, ``adamw_update_`` (in place) equal to it, and
the schedules: within 1e-6 of the JAX functions (float32 both, other
reduction orders for the global norm). Top-k of distinct magnitudes and
int8 codes (both round half to even) are equal.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.optim.compression import topk_roundtrip_with_feedback as j_topk_fb  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import topk_roundtrip_with_feedback  # noqa: E402

TOL = 1e-6
SHAPES = {"embed": (16, 8), "blocks.wq": (2, 8, 3, 4), "final_norm": (8,)}


def _leaves(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), \
        (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("clip_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_adamw_update_matches_jax(clip_norm, lr_scale):
    cfg = optim.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jcfg = joptim.AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    p0 = _leaves(0)
    params = {k: torch.as_tensor(v) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = optim.adamw_init(params), joptim.adamw_init(jparams)
    for step in range(3):
        g = _leaves(10 + step, scale=0.3)
        params, state, met = optim.adamw_update(
            {k: torch.as_tensor(v) for k, v in g.items()}, state, params, cfg,
            torch.tensor(lr_scale))
        jparams, jstate, jmet = joptim.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams, jcfg,
            jnp.float32(lr_scale))
        _close(met["grad_norm"], jmet["grad_norm"])
        assert int(state.step) == int(jstate.step) == step + 1
        for k in SHAPES:
            _close(params[k], jparams[k])
            _close(state.m[k], jstate.m[k])
            _close(state.v[k], jstate.v[k])
    if clip_norm < 1.0:
        assert float(met["grad_norm"]) > clip_norm  # the clip was active


def test_adamw_in_place_equals_functional():
    cfg = optim.AdamWConfig(lr=3e-3, clip_norm=0.5)
    p0, g0 = _leaves(1), _leaves(2)
    params = {k: torch.as_tensor(v) for k, v in p0.items()}
    state = optim.adamw_init(params)
    want_p, want_s, want_m = optim.adamw_update(
        {k: torch.as_tensor(v) for k, v in g0.items()}, state, params, cfg, 0.5)
    # the functional form left its inputs as they were
    for k in SHAPES:
        np.testing.assert_array_equal(params[k].numpy(), p0[k])
        assert not state.m[k].any()
    grads = {k: torch.as_tensor(v.copy()) for k, v in g0.items()}
    new_state, met = adamw.adamw_update_(params, grads, state, cfg, 0.5)
    assert grads == {}  # consumed
    assert new_state.m is state.m and int(new_state.step) == 1
    for k in SHAPES:
        np.testing.assert_array_equal(params[k].numpy(), want_p[k].numpy())
        np.testing.assert_array_equal(new_state.v[k].numpy(), want_s.v[k].numpy())
    assert float(met["grad_norm"]) == float(want_m["grad_norm"])


def test_adamw_chunks_equal_whole_leaves(monkeypatch):
    """A leaf updated in chunks equals the same leaf updated at once."""
    cfg = optim.AdamWConfig()
    p0, g0 = _leaves(3), _leaves(4)
    outs = []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        params = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
        state = optim.adamw_init(params)
        adamw.adamw_update_(params, {k: torch.as_tensor(v.copy()) for k, v in g0.items()},
                            state, cfg)
        outs.append(params)
    for k in SHAPES:
        np.testing.assert_array_equal(outs[0][k].numpy(), outs[1][k].numpy())


def test_adamw_init_and_global_norm():
    p0 = _leaves(5)
    state = optim.adamw_init({k: torch.as_tensor(v) for k, v in p0.items()})
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 and not t.any() for t in state.m.values())
    assert all(state.m[k] is not state.v[k] for k in SHAPES)
    _close(adamw.global_norm({k: torch.as_tensor(v) for k, v in p0.items()}),
           joptim.adamw.global_norm({k: jnp.asarray(v) for k, v in p0.items()}))


@pytest.mark.parametrize("limit", [7, 100, 192])
def test_global_norm_of_leaves_above_the_dot_limit(limit, monkeypatch):
    """A leaf above ``torch.dot``'s 2**31 - 1 elements (``DOT_MAX``, made
    small here) sums its dots over pieces: the norm within 1e-6 of the JAX
    package's; leaves within the limit keep their bits."""
    p0 = _leaves(6)
    leaves = {k: torch.as_tensor(v) for k, v in p0.items()}
    whole = adamw.global_norm(leaves)
    monkeypatch.setattr(adamw, "DOT_MAX", limit)
    _close(adamw.global_norm(leaves),
           joptim.adamw.global_norm({k: jnp.asarray(v) for k, v in p0.items()}))
    if limit >= max(v.size for v in p0.values()):
        assert torch.equal(adamw.global_norm(leaves), whole)


@pytest.mark.parametrize("total,warmup", [(10, 1), (200, 20), (50, 0)])
def test_schedules_match_jax(total, warmup):
    for s in (0, 1, warmup, total // 2, total - 1, total + 5):
        st, jst = torch.tensor(s, dtype=torch.int32), jnp.int32(s)
        _close(optim.linear_warmup(st, warmup), joptim.linear_warmup(jst, warmup))
        _close(optim.cosine_schedule(st, total, warmup), joptim.cosine_schedule(jst, total, warmup))
        _close(optim.cosine_schedule(st, total, warmup, final_scale=0.3),
               joptim.cosine_schedule(jst, total, warmup, final_scale=0.3))


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_topk_matches_jax(frac):
    rng = np.random.default_rng(6)
    x = rng.permutation(np.arange(1, 201, dtype=np.float32) / 10.0).reshape(10, 20)
    x *= rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32)  # distinct magnitudes
    vals, idx = optim.compress_topk(torch.as_tensor(x), frac)
    jvals, jidx = joptim.compress_topk(jnp.asarray(x), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(
        optim.decompress_topk(vals, idx, x.shape).numpy(),
        np.asarray(joptim.decompress_topk(jvals, jidx, x.shape)))
    res = rng.normal(size=x.shape).astype(np.float32) * 1e-3
    g_hat, new_res = topk_roundtrip_with_feedback(torch.as_tensor(x), torch.as_tensor(res), frac)
    jg_hat, jnew_res = j_topk_fb(jnp.asarray(x), jnp.asarray(res), frac)
    np.testing.assert_array_equal(g_hat.numpy(), np.asarray(jg_hat))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(jnew_res))
    state = optim.compressed_allreduce_init({"w": torch.as_tensor(x)})
    assert not state.residual["w"].any() and state.residual["w"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=(33, 7)), -1.9, 1.9).astype(np.float32)
    x[0, 0] = 2.0  # a scale of 2 / 127, so the next two are exact halves of it
    x[1, :2] = np.float32(2.0 / 127.0) * np.float32(0.5) * np.array([1, -1], np.float32)
    q, scale = optim.int8_compress(torch.as_tensor(x))
    jq, jscale = joptim.int8_compress(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert q[1, :2].tolist() == [0, 0]  # half to even
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(scale, jscale)
    _close(optim.int8_decompress(q, scale), joptim.int8_decompress(jq, jscale))


def test_optim_exports_the_jax_names():
    assert sorted(optim.__all__) == sorted(joptim.__all__)
    assert optim.AdamWConfig() == optim.AdamWConfig(**{
        f: getattr(joptim.AdamWConfig(), f) for f in ("lr", "b1", "b2", "eps", "weight_decay",
                                                       "clip_norm")})
