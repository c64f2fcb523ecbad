"""The port's attention (``repro_torch.kernels.flash_attention``) against the
JAX package's: the exact reference, the plain online-softmax version, the
grouped decode path and the decode kernel's split-and-merge plain version
against ``repro``'s ``attention_ref`` and its Pallas kernel in interpret
mode, on the same numpy-seeded inputs.

Tolerances are the JAX package's own (``tests/test_kernels.py``): 2e-5 in
float32, 2e-2 in bfloat16. Rows that see no key must be exactly 0. The CUDA
kernel is held against these plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import AttnSpec as JSpec  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (AttnSpec, attention_mask,  # noqa: E402
                                                     attention_ref, decode_split_bounds,
                                                     decode_split_reference,
                                                     simt_tile_reference)

# (B, Sq, Skv, H, Hkv, hd, spec): tests/test_kernels.py's cases, then GQA 4:1,
# a head dim of 80, a short query at offset positions (16 rows at 112 .. 127
# over 128 keys) and hd 256 with G = 8 and a prefix.
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, AttnSpec(causal=True)),
    (1, 256, 256, 8, 8, 32, AttnSpec(causal=True, window=64)),
    (2, 128, 128, 4, 1, 64, AttnSpec(causal=True, softcap=30.0)),
    (1, 64, 192, 4, 2, 32, AttnSpec(causal=False)),
    (1, 128, 128, 2, 2, 16, AttnSpec(causal=True, prefix_len=32)),
    (1, 128, 128, 8, 2, 32, AttnSpec(causal=True)),
    (1, 64, 64, 2, 1, 80, AttnSpec(causal=True)),
    (2, 16, 128, 8, 2, 64, AttnSpec(causal=True)),
    (1, 64, 64, 8, 1, 256, AttnSpec(causal=True, prefix_len=16)),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _jspec(spec: AttnSpec) -> JSpec:
    return JSpec(causal=spec.causal, window=spec.window, softcap=spec.softcap,
                 prefix_len=spec.prefix_len)


def _inputs(case, seed):
    b, sq, skv, h, hkv, hd, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    return q, k, v, qp, kp


def _both(arrays, tdt, jdt):
    """The same numpy arrays as port tensors and as JAX arrays (floats in the
    given type, positions int32, validity bool)."""
    def conv(a):
        if a is None:
            return None, None
        if a.dtype == np.float32:
            return torch.as_tensor(a).to(tdt), jnp.asarray(a, jdt)
        return torch.as_tensor(a), jnp.asarray(a)
    pairs = [conv(a) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ref_and_chunked_match_jax_and_pallas(case, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    spec = case[-1]
    (q, k, v, qp, kp), jargs = _both(_inputs(case, 7), tdt, jdt)
    want = j_attention_ref(*jargs, _jspec(spec))
    pallas = flash_attention_pallas(*jargs, _jspec(spec), interpret=True,
                                    block_q=64, block_kv=64)
    ref = attention_ref(q, k, v, qp, kp, spec)
    chunked = tops.attention_chunked(q, k, v, qp, kp, spec, q_chunk=32, kv_chunk=32)
    for got in (ref, chunked):
        assert got.dtype == tdt and got.shape == q.shape
        _close(got, want, tol)
        _close(got, pallas, tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_group_path_matches_jax(case):
    spec = case[-1]
    (q, k, v, qp, kp), jargs = _both(_inputs(case, 11), torch.float32, jnp.float32)
    want = j_attention_ref(*jargs, _jspec(spec), gqa="group")
    _close(attention_ref(q, k, v, qp, kp, spec, gqa="group"), want, 2e-5)


def _decode_inputs(seed: int = 3):
    """One query row over a 48-slot ring buffer per batch row: slots hold
    permuted absolute positions, some slots are empty (position -1, invalid)
    and the last batch row's visible slots all lie after its query (a row
    that sees no key)."""
    b, skv, h, hkv, hd = 3, 48, 8, 2, 32
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)]).astype(np.int32)
    kp[0, rng.random(skv) < 0.25] = -1
    kp[1, :10] = -1
    qp = np.array([[140], [130], [20]], np.int32)
    valid = kp >= 0
    return q, k, v, qp, kp, valid


@pytest.mark.parametrize("spec", [AttnSpec(causal=True), AttnSpec(causal=True, window=16),
                                  AttnSpec(causal=True, softcap=20.0)], ids=str)
def test_decode_ring_buffer_matches_jax(spec):
    (q, k, v, qp, kp, valid), jargs = _both(_decode_inputs(), torch.float32, jnp.float32)
    jq, jk, jv, jqp, jkp, jvalid = jargs
    want = j_attention_ref(jq, jk, jv, jqp, jkp, _jspec(spec), kv_valid=jvalid)
    pallas = flash_attention_pallas(jq, jk, jv, jqp, jkp, _jspec(spec), kv_valid=jvalid,
                                    interpret=True, block_q=64, block_kv=16)
    outs = [
        tops.flash_attention(q, k, v, qp, kp, spec, kv_valid=valid),  # CPU: grouped ref
        tops.attention_chunked(q, k, v, qp, kp, spec, kv_valid=valid, kv_chunk=16),
        attention_ref(q, k, v, qp, kp, spec, kv_valid=valid),
    ]
    for got in outs:
        _close(got, want, 2e-5)
        _close(got, pallas, 2e-5)
        assert torch.equal(got[2], torch.zeros_like(got[2]))  # sees no key: exactly 0
        assert bool(got[:2].abs().sum(dim=(1, 2, 3)).gt(0).all())
    assert np.all(np.asarray(want[2]) == 0)


def test_fully_masked_rows_are_exactly_zero():
    """Query rows whose keys are all invalid, in a tile where other rows see
    keys: -1e30 masking keeps them finite, and they are written as 0."""
    case = (2, 64, 64, 4, 2, 16, AttnSpec(causal=False))
    q, k, v, qp, kp = _inputs(case, 5)
    valid = np.ones((2, 64), bool)
    valid[1] = False
    (tq, tk, tv, tqp, tkp, tvalid), jargs = _both((q, k, v, qp, kp, valid),
                                                  torch.float32, jnp.float32)
    want = j_attention_ref(*jargs[:5], _jspec(case[-1]), kv_valid=jargs[5])
    for got in (attention_ref(tq, tk, tv, tqp, tkp, case[-1], tvalid),
                tops.attention_chunked(tq, tk, tv, tqp, tkp, case[-1], tvalid, kv_chunk=16)):
        assert torch.equal(got[1], torch.zeros_like(got[1]))
        assert bool(torch.isfinite(got).all())
        _close(got, want, 2e-5)


def test_dispatch_and_refusals():
    case = ATTN_CASES[0]
    q, k, v, qp, kp = (torch.as_tensor(a) for a in _inputs(case, 1))
    spec = case[-1]
    torch.testing.assert_close(tops.flash_attention(q, k, v, qp, kp, spec),
                               tops.attention_chunked(q, k, v, qp, kp, spec), rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, qp, kp, spec, impl="pallas")
    before = dict(tkernel.launches)
    assert set(before) == {"flash_attention", "flash_attention_wgmma", "flash_attention_decode",
                           "flash_attention_decode_lse"}
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, v, qp, kp, spec, impl="kernel")
    with pytest.raises(ValueError, match="one query row"):  # the lse output is decode's
        tops.flash_attention(q, k, v, qp, kp, spec, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_cuda(q, k, v, qp, kp, spec)
    with pytest.raises(ValueError, match="CUDA"):  # the forced kernel refuses them as well
        tkernel.flash_attention_cuda(q, k, v, qp, kp, spec, force_simt=True)
    assert tkernel.launches == before
    tkernel.reset_launch_counts()
    assert tkernel.launches == {"flash_attention": 0, "flash_attention_wgmma": 0,
                                "flash_attention_decode": 0, "flash_attention_decode_lse": 0}


@pytest.mark.parametrize("sq", [1, 16, 63, 64, 333, 2048])
@pytest.mark.parametrize("hd", [32, 36, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
def test_kernel_variant(dtype, hd, sq):
    """One query row in float32 or bf16 with a head dim that is a multiple
    of 8 takes the decode kernel; bf16 with hd 64 or 128 and at least 64
    query rows the wgmma kernel; everything else (float32 prefill, other
    head dims, hd 36 at Sq = 1) the SIMT one."""
    decode = sq == 1 and dtype != torch.float16 and hd % 8 == 0
    wgmma = dtype == torch.bfloat16 and hd in (64, 128) and sq >= 64
    assert tkernel.variant(dtype, hd, sq) == ("decode" if decode else
                                              "wgmma" if wgmma else "simt")


def test_kernel_source_and_build_flags():
    """The library is keyed by its sources and flags, built for sm_90a with
    nvcc's default contraction (only the matchers pass --fmad=false), and the
    module imports without compiling anything."""
    from repro_torch.kernels.matching import kernel as mkernel
    from repro_torch.kernels.mamba_scan import kernel as skernel
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" not in _build.NVCC_FLAGS and "--fmad=false" in mkernel.EXTRA_FLAGS
    path = _build.library_path("flash_attention", tkernel.SOURCES)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libflash_attention-")
    assert path != _build.library_path("flash_attention", tkernel.SOURCES, ("--fmad=false",))
    assert "int flash_attention_launch(" in tkernel.SOURCES[0].read_text()
    assert "int mamba1_scan_launch(" in skernel.SOURCES[0].read_text()
    # The wgmma kernel: its own entry in the same library, both products as
    # wgmma (bf16 in, float32 out), k / v through cp.async; built with
    # nvcc's default contraction and ptxas's report, never --fmad=false.
    sm90 = tkernel.SOURCES[1]
    assert sm90.name == "flash_attention_sm90.cu" and len(tkernel.SOURCES) == 3
    text = sm90.read_text()
    assert "int flash_attention_wgmma_launch(" in text
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in text
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in text
    assert "cp.async.cg.shared.global" in text
    # The decode kernel: the third source of the same library; k / v in their
    # own type through cp.async, the splits merged in the same launch by the
    # last block of a (batch row, row group), found by an atomic counter.
    decode = tkernel.SOURCES[2]
    assert decode.name == "flash_decode_sm90.cu"
    text = decode.read_text()
    assert "int flash_decode_launch(" in text and "int flash_decode_occupancy(" in text
    assert "cp.async.cg.shared.global" in text and "atomicAdd(p.counters" in text
    assert "cudaFuncSetAttribute" in text and "ready.fetch_or" in text  # once an instance
    assert "--fmad=false" not in tkernel.EXTRA_FLAGS and "-v" in tkernel.EXTRA_FLAGS
    assert tkernel.library_path() == _build.library_path("flash_attention", tkernel.SOURCES,
                                                         tkernel.EXTRA_FLAGS, tkernel.SOURCE_FLAGS)
    assert tkernel.library_path() != path  # keyed by both sources and the flags
    assert tkernel.library_path() != _build.library_path("flash_attention", tkernel.SOURCES,
                                                         tkernel.EXTRA_FLAGS)
    # Split compilation (same SASS, measured) for the SIMT source alone.
    assert set(tkernel.SOURCE_FLAGS) == {tkernel.SOURCES[0].name}
    code = ("import repro_torch.kernels.flash_attention.ops as o, "
            "repro_torch.kernels.mamba_scan.ops as s; "
            "assert o.kernel._lib is None and s.kernel._lib is None")
    env = {**os.environ, "PYTHONPATH": str(_build.REPO_ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


@pytest.mark.parametrize("package", ["matching", "flash_attention", "mamba_scan"])
def test_build_runs_one_nvcc_per_source(package, tmp_path, monkeypatch):
    """A library of one source is one nvcc call (compile and link); a library
    of several compiles each source in its own nvcc, then links the objects;
    a source's own flags go to its nvcc alone. A stand-in nvcc records its
    arguments and writes the file it is asked for."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{package}.kernel")
    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls.txt"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('x')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "cuda_tool", lambda name="nvcc": str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    source_flags = getattr(mod, "SOURCE_FLAGS", {})
    out = _build.build(package, mod.SOURCES, mod.EXTRA_FLAGS, source_flags)
    assert out.is_file() and out.parent == tmp_path / "build"
    assert out.with_suffix(".log").is_file()
    assert not list(out.parent.glob("*.o")) and not list(out.parent.glob("*.tmp"))
    lines = calls.read_text().splitlines()
    sources = [str(Path(src).resolve()) for src in mod.SOURCES]
    if len(sources) == 1:
        assert len(lines) == 1 and "-shared" in lines[0].split() and "-c" not in lines[0].split()
        assert lines[0].split()[-1] == sources[0]
    else:
        compiles, link = lines[:-1], lines[-1].split()
        assert sorted(line.split()[-1] for line in compiles) == sorted(sources)
        assert all("-c" in line.split() and "-shared" not in line.split() for line in compiles)
        assert "-shared" in link and all(arg.endswith(".o") for arg in link[-len(sources):])
    for line in lines:
        assert all(flag in line.split() for flag in mod.EXTRA_FLAGS)
    for line in lines[:len(sources)] if len(sources) > 1 else lines:
        own = source_flags.get(Path(line.split()[-1]).name, ())
        assert all(flag in line.split() for flag in own)
        assert not any(flag in line.split() for flags in source_flags.values()
                       for flag in flags if flag not in own)
    assert _build.build(package, mod.SOURCES, mod.EXTRA_FLAGS, source_flags) == out  # once
    assert len(calls.read_text().splitlines()) == len(lines)


def _split_inputs(group: int, seed: int):
    """One query row a batch row over a 445-slot ring buffer (14 tiles of 32,
    the last partial) with 2 kv heads of ``group`` q heads: row 0 has a
    quarter of its slots empty (-1); row 1 has slots 64 .. 191 empty, so a
    split of 2 or 4 tiles over them sees no key; row 2's query lies before
    every position, so it sees no key at all (without a prefix)."""
    b, skv, hkv, hd = 3, 445, 2, 32
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, hkv * group, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)]).astype(np.int32)
    kp[0, rng.random(skv) < 0.25] = -1
    kp[1, 64:192] = -1
    qp = np.array([[100 + skv], [100 + skv - 60], [20]], np.int32)
    return q, k, v, qp, kp, kp >= 0


SPLIT_SPECS = [AttnSpec(causal=True), AttnSpec(causal=True, window=64),
               AttnSpec(causal=True, softcap=20.0), AttnSpec(causal=True, prefix_len=120)]


@pytest.mark.parametrize("spec", SPLIT_SPECS, ids=str)
@pytest.mark.parametrize("group", [1, 3, 4, 8])
def test_decode_split_reference_matches_jax(group, spec):
    """The decode kernel's plain version, split into 1, 2, 3 and 7 runs of
    tiles, against JAX's grouped reference (the decode path of its
    flash_attention) and the Pallas kernel in interpret mode, in float32
    within 2e-5; rows that see no key are exactly 0."""
    arrays = _split_inputs(group, 17 + group)
    (q, k, v, qp, kp, valid), (jq, jk, jv, jqp, jkp, jvalid) = _both(
        arrays, torch.float32, jnp.float32)
    # 448 keys for the Pallas kernel (its kv blocks must divide Skv): three
    # more empty slots.
    pad = lambda a, val: np.concatenate(  # noqa: E731
        [a, np.full((a.shape[0], 3) + a.shape[2:], val, a.dtype)], axis=1)
    want = j_attention_ref(jq, jk, jv, jqp, jkp, _jspec(spec), kv_valid=jvalid, gqa="group")
    pallas = flash_attention_pallas(
        jq, jnp.asarray(pad(arrays[1], 0.0)), jnp.asarray(pad(arrays[2], 0.0)), jqp,
        jnp.asarray(pad(arrays[4], -1)), _jspec(spec), kv_valid=jnp.asarray(pad(arrays[5], False)),
        interpret=True, block_q=64, block_kv=64)
    unseen = ~attention_mask(qp, kp, spec, valid)[:, 0].any(dim=-1)
    assert bool(unseen[2]) == (spec.prefix_len == 0)
    for n_split in (1, 2, 3, 7):
        assert len(decode_split_bounds(445, n_split)) == n_split
        got = decode_split_reference(q, k, v, qp, kp, spec, valid, n_split)
        assert got.shape == q.shape and got.dtype == torch.float32
        _close(got, want, 2e-5)
        _close(got, pallas, 2e-5)
        assert torch.equal(got[unseen], torch.zeros_like(got[unseen]))
        assert bool(got[~unseen].abs().sum(dim=(1, 2)).gt(0).all())


@pytest.mark.parametrize("group", [1, 3, 4, 8])
def test_decode_split_reference_bf16_matches_jax(group):
    """The same in bfloat16 (inputs and output; float32 inside), within 2e-2
    of JAX's grouped reference in bfloat16."""
    (q, k, v, qp, kp, valid), (jq, jk, jv, jqp, jkp, jvalid) = _both(
        _split_inputs(group, 29 + group), torch.bfloat16, jnp.bfloat16)
    want = j_attention_ref(jq, jk, jv, jqp, jkp, _jspec(SPLIT_SPECS[1]), kv_valid=jvalid,
                           gqa="group")
    for n_split in (1, 7):
        got = decode_split_reference(q, k, v, qp, kp, SPLIT_SPECS[1], valid, n_split)
        assert got.dtype == torch.bfloat16
        _close(got, want, 2e-2)
        assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_decode_split_merges_away_splits_with_no_key():
    """Splits with no visible key (m = -1e30) merge away exactly as if their
    keys were not there: the result equals that over the visible splits'
    keys alone; a row whose every split is empty is 0."""
    q, k, v, qp, kp, valid = (torch.as_tensor(a) for a in _split_inputs(4, 3))
    spec = AttnSpec()
    # Row 1's keys 64 .. 191 are empty: with 7 splits of 64 keys, splits 1
    # and 2 see nothing.
    assert decode_split_bounds(445, 7)[1:3] == [(64, 128), (128, 192)]
    got = decode_split_reference(q, k, v, qp, kp, spec, valid, 7)
    keep = torch.cat([torch.arange(0, 64), torch.arange(192, 445)])
    alone = attention_ref(q[1:2], k[1:2, keep], v[1:2, keep], qp[1:2], kp[1:2, keep], spec,
                          valid[1:2, keep], gqa="group")
    torch.testing.assert_close(got[1:2], alone, rtol=2e-5, atol=2e-5)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_decode_workspace_grows_and_keeps_its_buffers():
    """A stream's decode workspace is reused while it is large enough and
    grows to the larger of each need; the buffers it grew out of are kept
    (a CUDA graph captured before may hold them), and counters start at 0."""
    dev, stream = torch.device("cpu"), -12345
    saved = dict(tkernel._workspaces), list(tkernel._retired)
    try:
        first = tkernel._decode_workspace(dev, stream, 100, 4)
        assert tkernel._decode_workspace(dev, stream, 80, 2) is first
        grown = tkernel._decode_workspace(dev, stream, 50, 9)
        assert grown[0].numel() == 100 and grown[1].numel() == 9
        assert int(grown[1].abs().sum()) == 0
        assert any(ws is first for ws in tkernel._retired)
        assert tkernel._decode_workspace(dev, stream + 1, 10, 1) is not grown
    finally:
        tkernel._workspaces.clear()
        tkernel._workspaces.update(saved[0])
        tkernel._retired[:] = saved[1]


def test_decode_plan():
    """The decode kernel's splits, for a card that holds 660 blocks at once
    (132 SMs x 5): one split at the serve run's 48 keys; at B 4 x 32,768 as
    many as one wave of resident blocks holds (32 blocks a split: 20), which
    covers the SMs at least twice; at B 128 x 32,768 as many as 4096-key
    splits need; forced counts cut to whole tiles; more than 4096 keys a
    split refused. The plain version cuts the keys at the same places."""
    assert tkernel.decode_plan(4, 48, 8, 4, 660) == (1, 2)
    n, per = tkernel.decode_plan(4, 32768, 8, 4, 660)
    assert n == 20 and 2 * 132 <= n * 4 * 8 <= 660 and per <= tkernel.DECODE_MAX_SPLIT_TILES
    assert len(decode_split_bounds(32768, n)) == n
    assert decode_split_bounds(32768, n)[1] == (per * 32, 2 * per * 32)
    assert tkernel.decode_plan(128, 32768, 8, 4, 660) == (8, 128)
    assert tkernel.split_plan(100, 7) == (4, 1)  # 4 tiles
    assert tkernel.decode_plan(1, 40, 1, 20, 660) == (1, 2)  # 20 heads: 3 blocks of 8
    assert tkernel.decode_rows(20) == 8 and tkernel.decode_rows(3) == 4
    with pytest.raises(ValueError, match="4096 keys"):
        tkernel.split_plan(32768, 1)


def _simt_inputs(case, seed):
    """Inputs of a SIMT tiling case: "prefill" (positions are the indices,
    the queries last), "chunk" (16 queries at positions 100 .. 115 over keys
    at 0 .. Skv - 1, as a chunked prefill after a cache), "ring" (permuted
    key positions, a fifth of the slots empty at -1 and invalid; the last
    batch row's queries lie before every key: they see none) or "masked"
    (the last batch row has no valid key, the first some invalid ones)."""
    b, sq, skv, hkv, group, hd, _, kind = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hkv * group, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, hd)).astype(np.float32)
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32), (b, sq)).copy()
    valid = np.ones((b, skv), bool)
    if kind == "chunk":
        qp = np.broadcast_to(np.arange(100, 100 + sq, dtype=np.int32), (b, sq)).copy()
    elif kind == "ring":
        kp = np.stack([rng.permutation(np.arange(100, 100 + skv)) for _ in range(b)])
        kp = kp.astype(np.int32)
        kp[rng.random(kp.shape) < 0.2] = -1
        qp = np.broadcast_to(np.arange(100 + skv - sq + 1, 100 + skv + 1, dtype=np.int32),
                             (b, sq)).copy()
        qp[-1] = 50 - np.arange(sq)
        valid = kp >= 0
    elif kind == "masked":
        valid[-1] = False
        valid[0, 3:9] = False
    return q, k, v, qp, kp, valid


# (B, Sq, Skv, Hkv, G, hd, spec, inputs): Sq 1, 3, 16, 17 and 63; G 1, 3, 4
# and 8; hd 36, 80, 128 and 256; causal, window, prefix-LM, soft-cap and
# non-causal masks; rows that see no key; a chunk at positions 100 .. 115.
SIMT_CASES = [
    (2, 1, 100, 2, 4, 36, AttnSpec(), "ring"),
    (1, 3, 40, 2, 3, 80, AttnSpec(window=8), "prefill"),
    (2, 16, 16, 2, 4, 128, AttnSpec(), "prefill"),
    (2, 17, 50, 1, 8, 36, AttnSpec(softcap=20.0), "prefill"),
    (1, 63, 63, 2, 3, 80, AttnSpec(prefix_len=20), "prefill"),
    (2, 16, 128, 2, 4, 80, AttnSpec(), "chunk"),
    (1, 17, 70, 1, 8, 256, AttnSpec(prefix_len=10, window=5), "prefill"),
    (2, 16, 48, 2, 1, 256, AttnSpec(window=4), "masked"),
    (2, 3, 64, 1, 8, 36, AttnSpec(window=40), "ring"),
    (1, 63, 100, 2, 1, 80, AttnSpec(causal=False, window=30), "prefill"),
]


@pytest.mark.parametrize("case", SIMT_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_simt_tile_reference_matches_jax(case, dtype):
    """The SIMT kernel's plain version (flat (position, q head) row tiles of
    16, 32, 64 and 128 rows, 32- or 64-key tiles, tile skip on the block's least and
    greatest position) against JAX's attention_ref and its Pallas kernel in
    interpret mode: 2e-5 in float32, 2e-2 in bfloat16; rows that see no key
    exactly 0."""
    tdt, jdt, tol = DTYPES[dtype]
    spec = case[6]
    (q, k, v, qp, kp, valid), jargs = _both(_simt_inputs(case, 41), tdt, jdt)
    want = j_attention_ref(*jargs[:5], _jspec(spec), kv_valid=jargs[5])
    pallas = flash_attention_pallas(*jargs[:5], _jspec(spec), kv_valid=jargs[5],
                                    interpret=True, block_q=64, block_kv=64)
    unseen = ~attention_mask(qp, kp, spec, valid).any(dim=-1)  # (B, Sq)
    if case[-1] in ("ring", "masked"):
        assert bool(unseen.any())
    for rows in tkernel.SIMT_ROWS:
        got = simt_tile_reference(q, k, v, qp, kp, spec, valid, rows=rows)
        assert got.dtype == tdt and got.shape == q.shape
        _close(got, want, tol)
        _close(got, pallas, tol)
        assert torch.equal(got[unseen], torch.zeros_like(got[unseen]))
        assert bool(got[~unseen].abs().sum(dim=-1).gt(0).all())


def test_simt_tile_skip_changes_nothing():
    """A tile skipped for the block's rows changes no result: over a window,
    a chunk with keys only before the window gives the same float32 result
    as the exact reference (rows see 8 of 512 keys; 15 of 16 tiles skipped)."""
    b, sq, skv, hkv, group, hd = 1, 4, 512, 1, 4, 32
    q, k, v, qp, kp, valid = (torch.as_tensor(a) for a in _simt_inputs(
        (b, sq, skv, hkv, group, hd, None, "prefill"), 3))
    spec = AttnSpec(window=8)
    got = simt_tile_reference(q, k, v, qp, kp, spec, valid, rows=16)
    torch.testing.assert_close(got, attention_ref(q, k, v, qp, kp, spec, valid),
                               rtol=2e-5, atol=2e-5)


def test_simt_rows():
    """The SIMT kernel's rows a block, for a card of 132 SMs: minitron-4b's
    16-token forward (Sq G = 64 rows a kv head, 32 (batch row, kv head)
    pairs) halves 64 -> 32 to run 64 blocks, and no further (16 rows would
    add blocks, not threads); its 2048-token prefill takes 128 (64 at hd
    256, which has no 128-row instance), or 64 when 128 would leave SMs
    idle; one query row (Sq = 1, G = 4) takes 16; 17 rows take 32."""
    assert tkernel.simt_rows(4, 16, 8, 4, 128, 132) == 32
    assert tkernel.simt_rows(4, 2048, 8, 4, 128, 132) == 128
    assert tkernel.simt_rows(4, 2048, 1, 8, 256, 132) == 64
    assert tkernel.simt_rows(4, 2048, 32, 1, 80, 132) == 128
    assert tkernel.simt_rows(2, 256, 8, 4, 128, 132) == 64  # 128 blocks of 128: too few
    assert tkernel.simt_rows(4, 1, 8, 4, 36, 132) == 16
    assert tkernel.simt_rows(64, 17, 8, 1, 128, 132) == 32
    assert tkernel.simt_rows(1, 17, 1, 1, 128, 132) == 32
    assert tkernel.simt_rows(8, 3, 16, 8, 64, 132) == 32
    assert tkernel.simt_rows(1, 4, 1, 4, 64, 132) == 16
    assert tkernel.simt_row_sizes(256) == (16, 32, 64)
    assert all(tkernel.simt_rows(b, sq, 8, 4, hd, 132) in tkernel.simt_row_sizes(hd)
               for b in (1, 4, 64) for sq in (1, 7, 16, 100, 4096) for hd in (64, 256))


def test_simt_kernel_source():
    """The SIMT kernel: k / v staged by 16-byte cp.async, exponentials as
    ex2.approx, the shared-memory attribute raised once per instance and
    device (not on every launch), one entry taking the rows a block, and an
    occupancy report; its wrapper binds both."""
    text = tkernel.SOURCES[0].read_text()
    assert tkernel.SOURCES[0].name == "flash_attention.cu"
    assert "cp.async.cg.shared.global" in text and "ex2.approx.ftz.f32" in text
    assert "ready.fetch_or" in text and text.count("cudaFuncSetAttribute(") == 1
    assert "int flash_attention_launch(" in text and "int rows" in text
    assert "int flash_attention_occupancy(" in text
    assert "float4" in text and "__ballot_sync" in text
