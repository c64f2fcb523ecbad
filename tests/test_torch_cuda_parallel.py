"""The port's distribution layer over two CUDA cards with NCCL: the train
step, a sharded fleet, the int8 cross-pod sum, tensor-parallel serving
(minitron-4b at full width on a model axis of 2) and one train step on a
model axis of 2 in the tp, tp_sp and fsdp styles (minitron-4b at full
width, 4 layers) of
``tests/torch_cuda_world.py``, started by ``torchrun`` with one rank per
card, each held against the unsharded run on one card. Marked ``cuda``; it
skips below two cards. Imports nothing of JAX:

    python -m pytest -m cuda tests/test_torch_cuda_parallel.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


def _two_cards(tmp_path, *cases) -> dict:
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    out = tmp_path / "world.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", str(ROOT / "tests" / "torch_cuda_world.py"),
                        str(out), *cases], capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(out.read_text())


def test_two_cards_train_step_fleet_and_cross_pod_sum(tmp_path):
    result = _two_cards(tmp_path)
    assert result["world"] == 2 and "nccl" in result["backend"]
    assert result["train_f32"]["err_of_leaf_scale"]["params"] <= 1e-4
    assert result["fleet"]["within_rtol_1e-6"] and result["cross_pod"]["bit_equal"]
    assert result["tp"]["err_of_scale"] <= 1e-4 and result["tp"]["argmax_agreement"] == 1.0


def test_two_cards_tensor_parallel_train_step(tmp_path):
    """minitron-4b at 4 layers, one float32 train step in the tp style over
    two NCCL ranks: each rank's blocks within 1e-4 of the leaf's scale of
    the unsharded step on one card, f backward and g forward issued."""
    result = _two_cards(tmp_path, "tp_train")
    tp = result["tp_train"]
    assert result["world"] == 2 and "nccl" in result["backend"]
    assert tp["err_of_leaf_scale"] <= 1e-4 and tp["loss_rel_err"] <= 1e-5
    # g after wo and w_down in 4 layers, the embedding rows and the
    # cross-entropy's three; the remat recompute issues wo's again (it stops
    # at the last tensor the backward saved, before w_down's)
    assert tp["collectives"]["tp_all_reduce"] == 2 * 4 + 4 + 4
    assert tp["collectives"]["tp_copy_bwd"] == 2 * 4 + 1


def test_two_cards_tp_sp_and_fsdp_train_steps(tmp_path):
    """minitron-4b at 4 layers, one float32 train step in the tp_sp and the
    fsdp style over two NCCL ranks, each rank's blocks within 1e-4 of the
    leaf's scale of the unsharded step on one card. tp_sp: tp's g and f,
    and the carry gathered a layer forward and in the recompute and before
    the final norm (4 + 4 + 1), split a layer and after the embedding
    backward (5); fsdp: no g, f or carry collective, a layer's weights,
    the embedding and the head gathered (6, 4 more in the recompute) and
    reduce-scattered back (6)."""
    result = _two_cards(tmp_path, "tp_sp_train", "fsdp_train")
    assert result["world"] == 2 and "nccl" in result["backend"]
    for style in ("tp_sp", "fsdp"):
        r = result[f"{style}_train"]
        assert r["err_of_leaf_scale"] <= 1e-4 and r["loss_rel_err"] <= 1e-5, (style, r)
    sp, fsdp = result["tp_sp_train"]["collectives"], result["fsdp_train"]["collectives"]
    assert (sp["tp_all_reduce"], sp["tp_copy_bwd"]) == (2 * 4 + 4 + 4, 2 * 4 + 1)
    assert (sp["seq_gather"], sp["seq_split_bwd"]) == (4 + 4 + 1, 4 + 1)
    assert not any(k.startswith(("tp_", "seq_")) for k in fsdp), fsdp
    assert (fsdp["all_gather"], fsdp["reduce_scatter"]) == (6 + 4, 6)
