#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the greedy-matching CUDA kernels from ``src/repro_torch`` (nvcc,
     sm_90a) and time the build;
  2. hold each kernel bit for bit against its plain PyTorch version on the
     card, at the main path's shapes and at 4096 x 64, on dense, masked,
     integer-tied, batched (K = 4) and NaN-holding inputs (the collection
     also on near ties: weights one ulp apart that round to equal gains;
     assignment and pairing on row-dominated weights, w_ij = a_i b_ij, so
     that every column ranks the same rows first), and time both at the
     main and big shapes, a fleet's K = 8 x 1024 x 32 and (assignment,
     pairing) row-dominated 1024 x 32: CUDA events around back-to-back
     calls and device time per call by CUDA graph replay, per selection
     too, with the design variant each launch took and ptxas's registers
     and spills;
  3. check the keyed network sampler on the card (padded and unpadded
     slices draw the same true block, bit for bit; the card draws the CPU's
     bits), then drive the main path -- ``run(cfg, LDS, T)`` and
     ``run(cfg, DS, T)`` at N = 1024 CUs x M = 32 ECs with the paper's
     Sec. IV-C simulation constants -- check the kernel launch counts,
     finite records and the per-slot feasibility invariants;
  4. run two L-DS slots from the same state and network on the card (with
     the kernels) and on the CPU (with the plain versions) and compare;
  5. build the flash-attention and Mamba-1 scan CUDA kernels (all three
     libraries are compiled at once from phase 1 on, one nvcc per source,
     and are done before phase 3's host-clock timings),
     check with ``cuobjdump -sass`` that the bf16 prefill attention kernel
     runs its products as HGMMA (wgmma) instructions, and print ptxas's
     registers and spills of the wgmma, decode attention, SIMT attention
     and scan kernels (forward and backward);
  6. hold the LM kernels against their plain PyTorch versions on the
     card at the LM serving path's shapes (attention prefill B 4 x 2048,
     H 32 / Hkv 8, hd 128 on the wgmma kernel; decode on the decode kernel
     over a 48-slot cache, a half-full 48-slot ring buffer with a window,
     and 32,768 filled slots at B 4 and at B 128 -- the JAX package's
     decode_32k shape, a 17.2 GB cache -- each also on the SIMT kernel
     forced and as device time per call under torch.profiler; the plain
     version at B 128 over batch slices; the scan at B 4 x 2048 x 8192 x 16, also with
     a drawn per (channel, state) and b / c as strided bf16 slices of one
     x_proj-shaped tensor as the model passes them, at S = 1 with h0, over
     8192 steps and at N = 32; the scan's backward kernel, every gradient
     against the plain backward, at falcon-mamba-7b's train shape B 16 x
     128 and at B 4 x 2048 (bf16, strided b / c), and in float32 with h0
     and the final state's gradient at B 2 x 2048, odd S and DI, N 32
     (timed: the call by CUDA events, its three kernels' device ms apart
     by the profiler); windows, soft-cap, prefix, ragged lengths,
     8,192 and 32,768 keys,
     hd 36 / 64 / 80 / 128 / 256, Hkv 1 / 2 / 8 / 32, rows that see no key,
     in bf16 and float32; minitron-4b's 16-token forward and the bf16
     B 4 x 2048 prefills of zamba2-2.7b's and paligemma-3b's attention on
     the SIMT kernel; phase 12's bf16 shapes: zamba2-2.7b's hd 80 decode,
     granite-20b's MQA decode and prefill, whisper-base's cross-attention
     decode over 1,500 frames), check which attention kernel each case launched, and
     time kernel, plain version and, for attention, torch's
     scaled_dot_product_attention (the bf16 prefill also on the SIMT
     kernel; every SIMT case, and SDPA at the 16-token forward, the serve
     run's decode and the two new prefills, as device time per call by CUDA
     graph replay); the scan's decode also as device time per call under
     torch.profiler;
  7. serve minitron-4b at full size through ``repro_torch.launch.serve``
     (B 4, prompt 16, 32 generated; ms per decode step from its own loop),
     then check teacher-forced decode against forward in bf16 and in
     float32 compute and against the same decode with the plain versions,
     exact launch counts per forward (SIMT attention) and per decode step
     (decode attention), profile the 16-token forward (device busy time and
     the SIMT kernel's share), time a B 4 x 2048 prefill (wgmma attention in all
     32 layers), and time one decode step at B 4 over 32,768 filled cache
     positions against the same step with the plain attention;
  8. the same for falcon-mamba-7b;
  9. run every architecture (the ten of ``configs.ARCH_IDS``), reduced, in
     float32 on the card (kernels) and on the CPU (plain versions) with the
     same weights and compare the logits of a forward and 4 decode steps
     (1e-5 of scale) with exact launches; an MoE's chosen experts and kept
     assignments first, equal on both sides;
 10. drive the fleet path (``FleetEngine.from_configs`` / ``from_jobs`` ->
     ``run``) at 1024 x 32 with per-slice rates, costs and budgets: DS and
     L-DS fleets of K = 1 and K = 4 slices over 2 slots (ms per fleet slot
     and per slice-slot, device busy and launches per fleet slot, peak
     memory, matcher launches per run equal to 2 x one per policy group
     at both K), each K = 4 slice against its own single-slice run (rtol
     1e-6, first-slot decisions equal), one K = 4 L-DS slot on the card
     against the CPU, a ragged fleet (1024 x 32, 768 x 24, 512 x 16,
     1024 x 16 padded to 1024 x 32) and a mixed-policy fleet (ds, l-ds,
     no-sdc, no-slt, no-lsa, greedy, ecself, cufull under SWITCHED) over 2
     slots against their slices' own runs;
 11. train minitron-4b at its full width through ``repro_torch.launch.train``
     (B 16 x 128, DS every 4 steps, 8 steps, float32 master weights and
     AdamW, bf16 compute, per-layer remat, under a (1, 1) mesh: weights and
     moments as ZeRO blocks, each layer all-gathered in bf16 at use and its
     gradient reduce-scattered; 32 layers unless the peak memory
     passes 95 % of the card, then 16): ms per step, tokens/s, peak memory,
     every loss finite, the wgmma attention kernel launched exactly twice a
     layer a step (forward and recompute), the matchers' launches per slot;
     the same step without and under the mesh (median host ms of three, one
     profiled: device busy, launches, NCCL time); reduced minitron-4b's train
     step on the card against the CPU; a run killed after step 10 and
     resumed against an uninterrupted 20-step run; the attention Function at
     the train shape (forward against the plain version, gradients bit-equal
     to autograd through it, times beside SDPA's forward and backward); and
     the scan's CUDA route under autograd (``ops.KernelScan``: the forward
     kernel, then the backward kernel; gradients against autograd through
     the plain scan);
 12. serve each other family at its published widths through
     ``repro_torch.launch.serve`` as phases 7-8 do (B 4, prompt 16, 32
     generated; bf16 weights drawn on the card), cut in depth for the
     script's time: qwen2.5-32b (16 of 64 layers), gemma2-27b (8 of 46),
     granite-20b (16 of 52), mixtral-8x7b (8 of 32), zamba2-2.7b (12 of
     54), whisper-base whole (frames encoded into its cross-attention
     cache first) and paligemma-3b (6 of 18; 256 patch embeddings ahead of its
     forward and prefill); per arch the exact attention launches by kernel
     per decode step, 16-token forward and B 4 x 2048 prefill, the three
     decode checks of phase 7 (bf16 against forward at its own limit),
     ms per decode step, tokens/s, prefill ms, peak memory of the serve run,
     of the checks and of the prefill, device busy per decode step and
     attention's share of the forward and the prefill (profiler);
 13. the distribution layer (``repro_torch.parallel``, ``launch.mesh``) at a
     world of 1: a NCCL process group started in the process through an
     in-process store (no network address), a (1, 1) host mesh and a
     (1, 1, 1) pod mesh; the int8 cross-pod sum on float32 and bf16 leaves
     bit-equal to the plain pack dequantised (its all-gathers through
     NCCL); ``train.main`` under the mesh at minitron-4b's widths, 8 of 32
     layers, B 16 x 128, 3 steps, bit-equal (losses and parameters) to the
     unsharded ``make_train_step`` on the same weights and batches, ms per
     step of both and the all-gathers and reduce-scatters per step;
     ``FleetEngine.run(mesh=)`` of DS and L-DS fleets of K = 8 at 1024 x
     32 over 3 slots bit-equal to ``run()`` with the same matcher launches;
 14. tensor-parallel serving on the one card: two gloo ranks spawned on it
     (NCCL refuses two ranks on one device) serve through ``serve.main
     --model-parallel 2`` minitron-4b at 8 of 32 layers (kv heads on ``model``),
     granite-20b at 8 layers (one kv head: the cache split by slots, the
     decode kernel's log-sum-exp output and the merge), falcon-mamba-7b at
     8 and mixtral-8x7b at 4 (B 4, prompt 16, 16 generated), with exact
     launches and collectives a step; each held in float32 compute within
     1e-4 of scale of the unsharded run on the same card (greedy tokens
     equal) and in bf16 within 0.15 (argmax agreement reported); ms per
     decode step beside the unsharded run's;
 15. tensor parallelism of the hybrid and encoder-decoder families and the
     train step on a model axis of 2, with phase 14's two gloo ranks: (a)
     ``serve.main --model-parallel 2`` of zamba2-2.7b at 12 of 54 layers
     (Mamba-2 heads on ``model``, the gated norm's all-reduce, the shared
     block twice a step) and whisper-base whole (its cross-attention cache
     by kv heads), held as phase 14 holds its cells; (b) one train step
     through ``make_train_step`` under ``mesh_context(mesh, "tp")`` of
     minitron-4b at 4 of 32 layers, zamba2-2.7b at 6 and whisper-base, B 4
     x 128: in float32 each rank holds its blocks against the unsharded
     step on the card (loss 1e-5 relative; grad norm, moments and updated
     parameters 1e-4 of each leaf's scale), then a bf16 step: its ms,
     collectives of the forward and of the rest by kind, exact attention
     launches a step (the wgmma kernel through ``ops.KernelAttention`` at
     minitron-4b's 16 / 4 local heads), peak memory a rank.
 16. the tp_sp and fsdp styles on the same model axis of 2, in phase 15's
     world: the train cells of 15 (b) under ``mesh_context(mesh, style)``
     (tp_sp: each rank's block of positions between layers; fsdp: each
     rank's half of the rows, every leaf gathered whole at its
     use), held in float32 as 15 (b) holds them, then a bf16 step each
     with the same attention launches; minitron-4b's collectives of a step
     exactly ``tp_train_comm``'s in all three styles.
 17. (a) a batch below dp: phase 14's two gloo ranks as a (data 2, model 1)
     mesh serve ``serve.main --batch 1`` of minitron-4b at 4 of 32 layers
     and whisper-base whole (its self- and cross-attention caches), every
     decode cache's slots split over ``data`` (each rank decodes the whole
     batch over its half of the slots through the decode kernel's
     log-sum-exp route, and the halves merge by one all-gather an
     attention), with exact launches and collectives a step; 8
     teacher-forced steps held in float32 within 1e-4 of scale of the
     unsharded run on the card, the bf16 gap printed; ms per step. (b) the
     dry run (``repro_torch.launch.dryrun``, its own process each, started
     after phase 4 at a lower priority on the host's CPU) of whisper-base
     train_4k on the pod mesh, mixtral-8x7b long_500k on the pod mesh and
     minitron-4b decode_32k on the multipod mesh: each must print ``OK``;
     its roofline is printed as a projection from the H100 data sheet.
 18. the other families trained through ``repro_torch.launch.train`` at
     their published widths, as phase 11 trains minitron-4b (B 16 x 128,
     bf16 compute, per-layer remat, under the (1, 1) mesh), 4 steps with a
     DS slot every 2: gemma2-27b at 4 of 46 layers (two local, two global;
     soft-caps, a float32 stream), mixtral-8x7b at 2 of 32, zamba2-2.7b,
     whisper-base (1,500 frames a row) and paligemma-3b (256 patches a row)
     whole, falcon-mamba-7b at 32 of 64 layers (the scan's forward and
     backward kernels); per arch 4 finite losses, the peak under 95 % of
     the card, exact launches (each attention call on the kernel
     ``kernel.variant`` gives it, twice a step under remat, counted from the
     config; the scan's forward kernel twice a Mamba-1 layer a step and its
     backward kernel once; DS's matchers once a slot), ms per step,
     tokens/s; each arch's
     reduced float32 train step on the card against the CPU as phase 11
     holds minitron-4b's (an MoE's routing equal on both sides); and
     ``repro_torch.examples.quickstart`` on the card at 30 slots (exact
     matcher launches, DS's unit cost below CU_FULL's).
 19. the paper's evaluation (``repro_torch.paper``): the three matchers
     bit-equal to their plain versions at the figures' N x M; (a) Fig. 7 through
     ``repro_torch.examples.traffic_prediction`` at its 40 slots (the
     traffic predictor trained on what DS, NO-SDC, NO-SLT and NO-LSA
     schedule at the testbed's 6 CUs x 3 ECs), and one ``train_batch`` on
     the card against the CPU within 1e-5 of scale; (b) Figs. 5, 6 and 8
     at 20 of their 60 slots; (c) Fig. 9 at its five points: DS, EC_SELF
     and CU_FULL at 20 slots, EC_FULL at 4 (cuts for the script's time);
     per run ms a slot and exact matcher launches counted around it, one
     more slot of each run on the card against the CPU (decisions equal,
     the rest within 1e-5 of scale), every value finite,
     ``full_allocate``'s share of the EC_FULL slots; each figure's checks
     printed beside the JAX package's, as findings.
Phase 6 also holds the decode kernel's log-sum-exp output against its plain
version (granite-20b's decode on one of phase 14's ranks, a row that sees
no key, a rank's half of a 32,768-slot cache).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero without that last
line when there is no CUDA device or the port is not beside this script.
Imports nothing of JAX or of the JAX package. ``--json PATH`` also writes
every measurement to PATH.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# Slots of phase 3's main-path runs: 6 since phase 18 trained
# falcon-mamba-7b (12 before), for the script's time.
T_SLOTS = 6
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
H100_BF16_TC_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
# exp2 on the special-function units: 16 results per clock per SM (NVIDIA's
# arithmetic-throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz.
H100_SFU_PER_S = 16 * 132 * 1.98e9
MAIN_SHAPE = (1024, 32)
BIG_SHAPE = (4096, 64)


def sim_config(core, n_cu: int, n_ec: int):
    """The paper's Sec. IV-C simulation constants at N x M, f_base cycling
    over the four EC classes. ``repro_torch.paper.common.sim_config`` draws
    the classes from ``default_rng(0)`` instead, as the JAX package's figures
    do; phases 2-4 keep the cycled speeds so that their numbers stay
    comparable from one version of this script to the next."""
    f_classes = (8000.0, 14000.0, 20000.0, 48000.0)
    return core.CocktailConfig(
        n_cu=n_cu, n_ec=n_ec, delta=1e-4, eps=0.2, q0=5000.0, zeta=500.0,
        d_base=2000.0, cap_d_base=8000.0,
        f_base=tuple(f_classes[j % 4] for j in range(n_ec)),
        c_base=500.0, e_base=30.0, p_base=100.0, pair_iters=120, seed=0)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_inputs(torch, op: str, shape, case: str, seed: int, k: int = 0):
    """Inputs of one matcher on the card, made from a numpy seed. Values
    follow the main path: log-weights about 0..14 with -inf holes, linear
    weights d (mu - eta - c) of both signs, solo/pair objectives. k > 0
    stacks k problems (case "batched": 4). Row-dominated: w_ij = a_i b_ij
    with a_i over three decades, so every column ranks the same rows first
    (pairing: pair_jk = a_j a_k b_jk, every row's best column the same few
    ECs)."""
    rng = np.random.default_rng(seed)
    n, m = shape
    lead = (k,) if k else ((4,) if case == "batched" else ())
    if op == "collection" and case == "near_tie":
        # Each EC column holds weights in [12, 16) at most 7 ulps apart;
        # under penalties up to about 4.5, weights one ulp apart round to
        # the same gain (round-half-even), and the lower row must win.
        base = rng.uniform(12.0, 15.9, m).astype(np.float32).view(np.int32)
        w = (base[None, :] + rng.integers(0, 8, (n, m)).astype(np.int32)).view(np.float32)
        args = [w]
    elif op == "pairing" and case == "row_dominated":
        a = 10.0 ** rng.uniform(0.0, 3.0, (*lead, m))
        b = rng.uniform(0.5, 1.5, (*lead, m, m))
        b = (b + np.swapaxes(b, -1, -2)) / 2
        args = [(a * a * np.diagonal(b, axis1=-2, axis2=-1)).astype(np.float32),
                (a[..., :, None] * a[..., None, :] * b).astype(np.float32)]
    elif op == "pairing":
        if case == "ties":
            solo = rng.integers(-2, 6, (*lead, m)).astype(np.float32)
            pair = rng.integers(-2, 8, (*lead, m, m)).astype(np.float32)
        else:
            solo = rng.uniform(-1e3, 1e4, (*lead, m)).astype(np.float32)
            pair = rng.uniform(-2e3, 2e4, (*lead, m, m)).astype(np.float32)
        pair = np.maximum(pair, np.swapaxes(pair, -1, -2))
        if case == "nan":
            pair[..., m // 3, m // 2] = pair[..., m // 2, m // 3] = np.nan
        args = [solo, pair]
    else:
        if case == "ties":
            w = rng.integers(-2, 12, (*lead, n, m)).astype(np.float32)
        elif case == "row_dominated":
            a = 10.0 ** rng.uniform(0.0, 3.0, (*lead, n, 1))
            w = (a * rng.uniform(0.5, 1.5, (*lead, n, m))).astype(np.float32)
        elif op == "collection":
            w = np.log(rng.uniform(1.0, 1e6, (*lead, n, m))).astype(np.float32)
            w[rng.random(w.shape) < 0.2] = -np.inf
        else:
            w = rng.uniform(-5e5, 1e6, (*lead, n, m)).astype(np.float32)
        if case == "nan":
            w[rng.random(w.shape) < 0.01] = np.nan
            w[rng.random(w.shape) < 0.01] = np.inf
        args = [w]
    masks = {}
    if case == "masked":
        cu = (rng.random(n) > 0.3).astype(np.float32)
        ec = (rng.random(m) > 0.3).astype(np.float32)
        cu[0] = ec[0] = 1.0
        masks = {"ec_mask": ec} if op == "pairing" else {"cu_mask": cu, "ec_mask": ec}
    to = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return [to(a) for a in args], {k: to(v) for k, v in masks.items()}


def op_call(ops, op: str, args, masks, impl: str):
    fn = {"collection": ops.greedy_collection, "assignment": ops.greedy_assignment,
          "pairing": ops.greedy_pairing}[op]
    out = fn(*args, impl=impl, **masks)
    return out[0] if op == "collection" else out


def greedy_ops(op: str, n: int, m: int, takes: int) -> float:
    """Operations the greedy function needs on these inputs, however a
    kernel walks it (compares and float ops alike, at the float32 rate).

    Collection: sort each EC's column of gains once (N log2 N compares per
    column), then for each selection taken plus the final one that stops the
    loop, a gain head - pen[count] and a compare for each of the M column
    heads; over the whole run each column's head moves past each row at
    most once (N M). Assignment and pairing: one sort of the N M (M M)
    entries, then one walk over them."""
    if op == "collection":
        steps = min(takes + 1, n)
        return n * m * math.ceil(math.log2(n)) + n * m + 2.0 * m * steps
    e = n * m
    return e * math.ceil(math.log2(e)) + e


def matcher_ptxas(kernel) -> dict:
    """Registers and spills of each matcher kernel instance."""
    def short(mangled):
        m = re.search(r"greedy_(collection|assignment|pairing_warp|pairing_wide)_kernel"
                      r"(?:IL[bi](\d+)E)?", mangled)
        return f"{m.group(1)}{'<' + m.group(2) + '>' if m.group(2) else ''}" if m else None

    out = ptxas_report(kernel.library_path(), short)
    if not out:
        fail("the matchers' build log names no greedy kernel")
    return out


# Timing cells of phase 2: (label, problems, shape, case). "batched" is a
# fleet's K = 8 slices at the main shape; "row_dominated" weights make every
# column rank the same rows first (the collection has no such cell).
MATCHER_TIMINGS = (("main", 1, MAIN_SHAPE, "dense"), ("big", 1, BIG_SHAPE, "dense"),
                   ("batched", 8, MAIN_SHAPE, "dense"),
                   ("row_dominated", 1, MAIN_SHAPE, "row_dominated"))


# The matchers' cases held against their plain versions (phases 2 and 19).
MATCHER_CASES = ("dense", "masked", "ties", "batched", "nan")
MATCHER_EXTRA_CASES = {"collection": ("near_tie",), "assignment": ("row_dominated",),
                       "pairing": ("row_dominated",)}


def phase_kernels(torch, ops, kernel, ref):
    names = {"collection": "greedy_collection", "assignment": "greedy_assignment",
             "pairing": "greedy_pairing"}
    results = {}
    for idx, op in enumerate(("collection", "assignment", "pairing")):
        checks = []
        max_err = 0.0
        for shape in (MAIN_SHAPE, BIG_SHAPE):
            pshape = (shape[1], shape[1]) if op == "pairing" else shape
            for c, case in enumerate(MATCHER_CASES + MATCHER_EXTRA_CASES[op]):
                args, masks = kernel_inputs(torch, op, pshape, case, 1000 * idx + 10 * c + shape[1])
                got = op_call(ops, op, args, masks, "kernel")
                want = op_call(ops, op, args, masks, "ref")
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                checks.append({"shape": list(pshape), "case": case, "bit_equal": equal,
                               "tile_in_smem": kernel.tile_in_smem[names[op]],
                               "variant": kernel.variant[names[op]],
                               "selected": float(got.sum())})
                if not equal:
                    fail(f"{names[op]} differs from its plain version at {pshape} "
                         f"({case}): max abs err {err}")
        timing = time_matchers(torch, kernel, ref, op)
        for label, tm in timing.items():
            if not tm["bit_equal"]:
                fail(f"{names[op]} differs from its plain version in the {label} timing cell")
        results[op] = {"checks": checks, "max_abs_err": max_err, "timing": timing}
    return results


def time_matchers(torch, kernel, ref, op: str, plain: bool = True) -> dict:
    """Times of one matcher's wrapper alone against its plain version on the
    same tensors, in each cell of MATCHER_TIMINGS: CUDA events around
    back-to-back calls ("ms", which the host bounds at a few microseconds of
    kernel) and device time per call by CUDA graph replay ("device_ms").
    ``kernel`` may be an older tree's module (``scripts/matcher_times.py``)."""
    name = f"greedy_{op}"
    idx = ("collection", "assignment", "pairing").index(op)
    timing = {}
    for label, k, shape, case in MATCHER_TIMINGS:
        if case == "row_dominated" and op == "collection":
            continue
        n, m = (shape[1], shape[1]) if op == "pairing" else shape
        (args, _) = kernel_inputs(torch, op, (n, m), case, 7 + idx, k=k)
        if op == "collection":
            logw = args[0].reshape(k, n, m).contiguous()
            pen = ref.penalty_table(n, logw.device)
            run_k = lambda: kernel.greedy_collection_cuda(logw, pen)  # noqa: E731
            run_p = lambda: ref.greedy_collection_ref(logw)  # noqa: E731
            n_in = k * 2 * n * m + n + 1  # logw + pen read, alpha written (floats)
        elif op == "assignment":
            w = args[0].reshape(k, n, m).contiguous()
            run_k = lambda: kernel.greedy_assignment_cuda(w)  # noqa: E731
            run_p = lambda: ref.greedy_assignment_ref(w)  # noqa: E731
            n_in = k * 2 * n * m
        else:
            w = ref.pairing_value_matrix(*args).reshape(k, m, m).contiguous()
            run_k = lambda: kernel.greedy_pairing_cuda(w)  # noqa: E731
            run_p = lambda: ref.greedy_pairing_values(w)  # noqa: E731
            n_in = k * 2 * m * m
        out = run_k()
        want = run_p()
        want = want[0] if op == "collection" else want
        torch.cuda.synchronize()
        per = out.sum(dim=(1, 2)) if op != "pairing" else torch.triu(out).sum(dim=(1, 2))
        takes = [int(t) for t in per.tolist()]
        ops_needed = sum(greedy_ops(op, n, m, t) for t in takes)
        bound_bytes = 4.0 * n_in / H100_BYTES_PER_S * 1e3
        bound_ops = ops_needed / H100_FP32_OPS_PER_S * 1e3
        k_ms = cuda_ms(torch, run_k, reps=20, warmup=2)
        calls = int(min(64, max(2, round(20.0 / k_ms))))
        d_ms = graph_ms_per_call(torch, run_k, calls=calls, reps=3)
        p_ms = cuda_ms(torch, run_p, reps=3 if label == "main" else 1, warmup=1) \
            if plain else None
        steps = max(takes) + 1  # the selections plus the step that finds no gain
        timing[label] = {
            "shape": [k, n, m] if k > 1 else [n, m], "case": case,
            "selections": sum(takes), "ops_needed": ops_needed,
            "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
            "us_per_selection": k_ms * 1e3 / steps,
            "device_us_per_selection": d_ms * 1e3 / steps,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bit_equal": bool(torch.equal(out, want)),
            "variant": getattr(kernel, "variant", {}).get(name, "block_rescan"),
            "tile_in_smem": kernel.tile_in_smem[name],
        }
    return timing


# --------------------------------------------------------------------------
# Phase 3: the main path
# --------------------------------------------------------------------------

def check_feasible(torch, dec, net, queues, rho: float) -> None:
    """The per-slot constraints of the paper (2), (3), (5)-(8), (13)."""
    a = dec.alpha.double().cpu().numpy()
    th = dec.theta.double().cpu().numpy()
    x, y, z = (v.double().cpu().numpy() for v in (dec.x, dec.y, dec.z))
    cap_d, f, r = (v.double().cpu().numpy() for v in (net.cap_d, net.f, queues.r))
    conds = {
        "(2) one connection per CU": (a.sum(axis=1) <= 1 + 1e-5).all(),
        "(3) EC time shares <= 1": ((a * th).sum(axis=0) <= 1 + 1e-4).all(),
        "(5) z symmetric": np.allclose(z, z.T, atol=1e-6),
        "(5) one peer per EC": (z.sum(axis=1) <= 1 + 1e-5).all(),
        "(6) link capacity": ((y.sum(axis=0) + y.sum(axis=0).T)
                              <= cap_d * (1 + 1e-3) + 1e-2).all(),
        "(7) offload only on pairs": (y.sum(axis=0)[z < 0.5] <= 1e-4).all(),
        "(8) compute budget": (x.sum(axis=0) + y.sum(axis=(0, 1))
                               <= f / rho * (1 + 1e-3) + 1e-2).all(),
        "(13) queue caps": ((x + y.sum(axis=2)) <= r * (1 + 1e-3) + 1e-3).all(),
        "nonnegative": (x >= -1e-6).all() and (y >= -1e-6).all() and (th >= -1e-6).all(),
    }
    bad = [k for k, ok in conds.items() if not ok]
    if bad:
        fail(f"decision infeasible: {bad}")


def phase_sampler(torch, core, network):
    """The keyed sampler on the card: a slice padded from (10, 4) to
    (12, 5) and from 1024 x 32 to 1040 x 40 draws its heterogeneity and
    network state bit-identically on the true block; the card draws the
    CPU's 32-bit words at 1024 x 32; host ms of one slot's draw."""
    out = {}
    for true, pad in (((10, 4), (12, 5)), (MAIN_SHAPE, (1040, 40))):
        cfg = sim_config(core, *true)
        shape = core.ShapeConfig(*pad)
        params = core.SliceParams.from_config(cfg, pad_shape=shape)
        st = core.init_state(cfg)
        stp = core.init_state(shape, params, seed=cfg.seed)
        pairs = [(f"het.{f}", getattr(st.het, f), getattr(stp.het, f)) for f in st.het._fields]
        for t in (0, 5):
            st, stp = st._replace(t=torch.full_like(st.t, t)), stp._replace(t=torch.full_like(stp.t, t))
            net, netp = core.slot_network(cfg, st), core.slot_network(shape, stp, params)
            pairs += [(f"t{t}.{f}", getattr(net, f), getattr(netp, f)) for f in net._fields]
        for name, a, b in pairs:
            if not torch.equal(a, b[tuple(slice(0, s) for s in a.shape)]):
                fail(f"sampler: {name} differs on the true block of {true} padded to {pad}")
        out[f"{true[0]}x{true[1]}->{pad[0]}x{pad[1]}"] = {"bit_equal": True,
                                                          "compared": len(pairs)}
    draws = network.slot_draws(*MAIN_SHAPE)
    bits = network.uniform_bits(torch.tensor(12345, device="cuda"), 3, draws)
    if not torch.equal(bits.cpu(), network.uniform_bits(12345, 3, draws, device="cpu")):
        fail("sampler: the card's Threefry words differ from the CPU's")
    cfg = sim_config(core, *MAIN_SHAPE)
    st = core.init_state(cfg)
    core.slot_network(cfg, st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        core.slot_network(cfg, st)
    torch.cuda.synchronize()
    out["cpu_equal_words"] = int(bits.numel())
    out["slot_draw_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def phase_main_path(torch, core, kernel, metrics):
    cfg = sim_config(core, *MAIN_SHAPE)
    out = {}
    final = {}
    expected = {"l-ds": {"greedy_collection": T_SLOTS, "greedy_assignment": T_SLOTS,
                         "greedy_pairing": 2 * T_SLOTS},
                "ds": {"greedy_collection": T_SLOTS, "greedy_assignment": 0,
                       "greedy_pairing": T_SLOTS}}
    for spec in (core.LDS, core.DS):
        torch.cuda.synchronize()
        kernel.reset_launch_counts()
        t0 = time.perf_counter()
        state, recs = core.run(cfg, spec, T_SLOTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernel.launches)
        if counts != expected[spec.name]:
            fail(f"{spec.name}: kernel launches {counts}, expected {expected[spec.name]}")
        for f in recs._fields:
            v = getattr(recs, f)
            if v.shape != (T_SLOTS,) or not bool(torch.isfinite(v).all()):
                fail(f"{spec.name}: record {f} not finite of shape ({T_SLOTS},)")
        s = metrics.summary(cfg, state)
        out[spec.name] = {
            "slots": T_SLOTS, "ms_per_slot": wall / T_SLOTS * 1e3, "launches": counts,
            "unit_cost": s["unit_cost"], "skew_degree": s["skew_degree"],
            "total_trained": s["total_trained"], "last_cost": float(recs.cost[-1]),
        }
        # One more slot outside the counted window: its decision must meet
        # the paper's per-slot constraints. Its network is the one later
        # phases start from.
        net = core.slot_network(cfg, state)
        _, _, dec = core.step(cfg, spec, state, net)
        check_feasible(torch, dec, net, state.queues, cfg.rho)
        final[spec.name] = (state, net)
    return cfg, out, final


def time_training(torch, core, ta, cfg, state, net):
    """Host clock around the two pair solvers of one L-DS slot on the card,
    at that slot's 496 EC pairs: ``pair_allocate`` (skew-aware training)
    and ``linear_pair`` (the virtual linear training)."""
    beta, gamma = core.training_weights(cfg, net, state.emp_mults, True)
    budgets = net.f / cfg.rho
    pj, pk = torch.triu_indices(cfg.n_ec, cfg.n_ec, offset=1, device=beta.device)
    r = state.queues.r
    args = (beta[:, pj].T, gamma[:, pk, pj].T, beta[:, pk].T, gamma[:, pj, pk].T,
            r[:, pj].T, r[:, pk].T, budgets[pj], budgets[pk], net.cap_d[pj, pk])

    def host_ms(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    return {
        "linear_pair_ms": host_ms(lambda: ta.linear_pair(*args)),
        "pair_allocate_ms": host_ms(lambda: ta.pair_allocate(*args, iters=cfg.pair_iters)),
    }


def phase_profile(torch, core, cfg, state, main_res):
    """Device time of one slot of each spec under torch.profiler
    (``profile_window``): kernel time, the launch count, and the busy share
    of the slot's unprofiled wall time from phase 3."""
    out = {}
    for spec in (core.LDS, core.DS):
        core.step(cfg, spec, state)  # warm
        prof = profile_window(torch, lambda: core.step(cfg, spec, state), top=8)
        wall = main_res[spec.name]["ms_per_slot"]
        out[spec.name] = {k: prof[k] for k in ("device_busy_ms", "device_launches", "top")}
        out[spec.name].update(slot_ms=wall, busy_share=prof["device_busy_ms"] / wall)
    return out


# --------------------------------------------------------------------------
# Phase 4: one state, two devices
# --------------------------------------------------------------------------

def phase_parity(torch, core, bridge, cfg, state, net):
    """Two L-DS slots from the same state and network: CUDA (kernels) vs CPU
    (plain versions). 0/1 decisions must be equal. Floats agree within
    1e-5 of each tensor's scale: the card and the CPU sum in other orders
    and round log/exp differently, and pair_allocate's 120 dual iterations
    amplify those last-bit differences. Measured on an H100: at most
    9.77e-08 and 1.1e-07 of scale in two runs, so the limit leaves about
    100x headroom and still refuses a solver that computes in reduced
    precision (TF32 rounds at about 5e-4)."""
    report = []
    for s in range(2):
        if s > 0:
            net = core.slot_network(cfg, state)
        new_c, rec_c, dec_c = core.step(cfg, core.LDS, state, net)
        check_feasible(torch, dec_c, net, state.queues, cfg.rho)
        st_cpu = bridge.from_numpy(bridge.to_numpy(state), "cpu")
        net_cpu = bridge.from_numpy(bridge.to_numpy(net), "cpu")
        new_p, rec_p, dec_p = core.step(cfg, core.LDS, st_cpu, net_cpu)
        for f in ("alpha", "theta", "z"):
            a, b = getattr(dec_c, f).cpu(), getattr(dec_p, f)
            if not torch.equal(a, b):
                fail(f"slot {s}: decision {f} differs between CUDA and CPU "
                     f"({int((a != b).sum())} entries)")
        worst = {}
        pairs = [(f"dec.{f}", getattr(dec_c, f), getattr(dec_p, f)) for f in ("x", "y")]
        pairs += [(f"rec.{f}", getattr(rec_c, f), getattr(rec_p, f)) for f in rec_c._fields]
        for grp in ("queues", "mults", "emp_mults"):
            for f in getattr(new_c, grp)._fields:
                pairs.append((f"{grp}.{f}", getattr(getattr(new_c, grp), f),
                              getattr(getattr(new_p, grp), f)))
        for name, a, b in pairs:
            a = a.double().cpu()
            b = b.double()
            scale = float(b.abs().max()) or 1.0
            err = float((a - b).abs().max()) / scale
            worst[name] = err
            if err > 1e-5:
                fail(f"slot {s}: {name} differs by {err:.3e} of its scale")
        report.append({"slot": int(state.t), "decisions_equal": True,
                       "max_rel_err": max(worst.values()), "worst": max(worst, key=worst.get)})
        state = new_c
    return report


# --------------------------------------------------------------------------
# Phase 5: what the wgmma kernel compiled to
# --------------------------------------------------------------------------

def ptxas_report(lib: Path, short) -> dict:
    """ptxas's registers and spills of each kernel instance in a library's
    build log (``-Xptxas -v``), keyed by ``short(mangled name)``; instances
    for which ``short`` gives None are left out."""
    out, cur = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = short(m.group(1))
            if cur:
                out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if cur and m:
            out[cur].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out[cur]["registers"] = int(m.group(1))
    return out


def scan_ptxas(skernel) -> dict:
    """Registers and spills of each instance of the scan kernel (x's type,
    lanes per channel pair G)."""
    def short(mangled):  # mamba1_scan_kernel<T, G>
        m = re.search(r"mamba1_scan_kernelI(f|13__nv_bfloat16)Li(\d+)EE", mangled)
        return f"{'f32' if m.group(1) == 'f' else 'bf16'}_g{m.group(2)}" if m else None

    out = ptxas_report(skernel.library_path(), short)
    if not out:
        fail("the scan library's build log names no mamba1_scan_kernel instance")
    return out


def scan_bwd_ptxas(skernel) -> dict:
    """Registers and spills of each instance of the scan's backward kernel
    (x's type, lanes per channel pair G, the sweep or the walk back)."""
    def short(mangled):  # mamba1_scan_bwd_kernel<T, G, walk>
        m = re.search(r"mamba1_scan_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E", mangled)
        return (f"{'f32' if m.group(1) == 'f' else 'bf16'}_g{m.group(2)}_"
                f"{'walk' if m.group(3) == '1' else 'sweep'}") if m else None

    out = ptxas_report(skernel.library_path(), short)
    if not out:
        fail("the scan library's build log names no mamba1_scan_bwd_kernel instance")
    return out


def decode_ptxas(fkernel) -> dict:
    """Registers and spills of each instance of the decode attention kernel
    (storage type, padded head dim, q heads a block)."""
    def short(mangled):  # flash_decode_kernel<T, HDP, GM>
        m = re.search(r"flash_decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)EE", mangled)
        return (f"{'f32' if m.group(1) == 'f' else 'bf16'}_hd{m.group(2)}_rows{m.group(3)}"
                if m else None)

    out = ptxas_report(fkernel.library_path(), short)
    if len(out) != 24:
        fail(f"the flash library's build log names {len(out)} of the 24 decode kernel instances")
    return out


def simt_ptxas(fkernel) -> dict:
    """Registers and spills of each instance of the SIMT attention kernel
    (storage type, padded head dim, rows a block)."""
    def short(mangled):  # flash_fwd_kernel<T, HDP, R>
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)EE", mangled)
        return (f"{'f32' if m.group(1) == 'f' else 'bf16'}_hd{m.group(2)}_rows{m.group(3)}"
                if m else None)

    out = ptxas_report(fkernel.library_path(), short)
    if len(out) != 22:  # 2 types x (4 row tiles at hd 64 and 128, 3 at hd 256)
        fail(f"the flash library's build log names {len(out)} of the 22 SIMT kernel instances")
    return out


def wgmma_sass(fkernel, cuda_tool) -> dict:
    """HGMMA instructions in the SASS of each instance of the wgmma kernel
    (``cuobjdump -sass`` on the built library), with ptxas's registers and
    spills from the build log. Fails unless every instance holds HGMMA."""
    lib = fkernel.library_path()
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None

    def short(mangled):  # flash_fwd_sm90_kernel<HD>
        m = re.search(r"flash_fwd_sm90_kernelILi(\d+)E", mangled)
        return f"hd{m.group(1)}" if m else None

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = short(m.group(1))
            if cur:
                out[cur] = {"hgmma": 0}
        elif cur and "HGMMA" in line:
            out[cur]["hgmma"] += 1
    if sorted(out) != ["hd128", "hd64"] or min(r["hgmma"] for r in out.values()) == 0:
        fail(f"the wgmma kernel's SASS holds no HGMMA: {out}")
    for name, report in ptxas_report(lib, short).items():
        if name in out:
            out[name].update(report)
    return out


# --------------------------------------------------------------------------
# Phase 6: the LM kernels against their plain versions
# --------------------------------------------------------------------------

# Of scale. bf16: two bfloat16 steps (2^-8 of the value each): kernel and
# plain version both round one float32 result; measured worst on an H100:
# 2.7e-3. float32: sums in another order; measured worst 3.0e-7.
BF16_TOL = 8e-3
F32_TOL = 2e-5


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error over the reference's max abs value)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def attn_inputs(torch, b, sq, skv, h, hkv, hd, dtype, seed, decode=False):
    """q, k, v from a numpy seed; prefill positions are the indices, decode
    (True) holds one query over a ring buffer with permuted positions and
    empty slots (position -1, invalid). Decode over a "filled" cache (slots
    at positions 0 .. Skv - 1, the query at Skv) or a "half" full ring
    buffer (slots 0 .. Skv / 2 - 1 at their positions, the rest -1, the
    query at Skv / 2 - 1) draws q, k, v on the card from a seeded generator
    (32,768 slots at B 128 are 17.2 GB)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    if decode in ("filled", "half"):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=gen, device=dev, dtype=dtype)
                   for s in ((b, 1, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
        idx = torch.arange(skv, dtype=torch.int32, device=dev)
        last = skv if decode == "filled" else skv // 2 - 1
        kp = (idx if decode == "filled" else torch.where(idx <= last, idx, -1))
        kp = kp.expand(b, skv).contiguous()
        qp = torch.full((b, 1), last, dtype=torch.int32, device=dev)
        return q, k, v, qp, kp, kp >= 0
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev).to(dtype)
               for s in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    if decode:
        kp = np.stack([rng.permutation(np.arange(1000, 1000 + skv)) for _ in range(b)])
        kp[rng.random(kp.shape) < 0.2] = -1
        kp = torch.as_tensor(kp.astype(np.int32), device=dev)
        qp = torch.full((b, 1), 1000 + skv, dtype=torch.int32, device=dev)
        return q, k, v, qp, kp, kp >= 0
    qp = torch.arange(skv - sq, skv, dtype=torch.int32, device=dev).expand(b, sq).contiguous()
    kp = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv).contiguous()
    return q, k, v, qp, kp, None


def attn_bound(torch, fref, q, k, v, qp, kp, spec, valid):
    """Least time for this call: q, o, the positions and the validity moved
    once, and k and v of the keys some query row of the batch row sees (no
    function need read the rest: empty ring-buffer slots, keys outside the
    window); or 4 hd operations per visible (q, kv) pair at the type's peak
    (bf16 on the tensor cores, float32 on the float32 cores)."""
    mask = fref.attention_mask(qp, kp, spec, valid)  # (B, Sq, Skv)
    visible = float(mask.sum()) * q.shape[2]
    seen_keys = float(mask.any(dim=1).sum())  # (batch row, key) pairs
    nbytes = (2 * q.numel() + 2 * seen_keys * k.shape[2] * k.shape[3]) * q.element_size() + \
        4 * (qp.numel() + kp.numel()) + (valid.numel() if valid is not None else 0)
    peak = H100_BF16_TC_OPS_PER_S if q.dtype == torch.bfloat16 else H100_FP32_OPS_PER_S
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 4.0 * q.shape[-1] * visible / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), visible


def plain_attention(torch, fops, q, k, v, qp, kp, spec, valid, rows_at_once=None):
    """The plain version (``impl="chunked"``: the grouped exact reference at
    Sq = 1), over batch slices of ``rows_at_once`` rows where float32 copies
    of the whole cache would not fit beside it."""
    n = rows_at_once or q.shape[0]
    return torch.cat([fops.flash_attention(
        q[i:i + n], k[i:i + n], v[i:i + n], qp[i:i + n], kp[i:i + n], spec,
        kv_valid=None if valid is None else valid[i:i + n], impl="chunked")
        for i in range(0, q.shape[0], n)])


def sdpa_call(torch, fref, q, k, v, qp, kp, spec, valid):
    """One scaled_dot_product_attention call that computes the same function
    on the same inputs: the causal flag where positions are the indices and
    nothing else masks, else the boolean mask, built outside the call."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if spec == fref.AttnSpec() and valid is None and q.shape[1] == k.shape[1] and bool(
            (qp == torch.arange(q.shape[1], device=qp.device)).all()) and bool(
            (kp == torch.arange(k.shape[1], device=kp.device)).all()):
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    amask = fref.attention_mask(qp, kp, spec, valid)[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask, enable_gqa=True)


def graph_ms_per_call(torch, fn, calls: int, reps: int) -> float:
    """Device time of one call of ``fn`` (one kernel launch): ``calls``
    calls captured in a CUDA graph, replayed ``reps`` times between CUDA
    events. Back-to-back wrapper calls are host-bound at a few microseconds
    of kernel, so events around eager calls time the host; the graph replays
    the same launches without it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the wrapper (its workspace a stream) uncaptured
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [fn() for _ in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outs, graph
    return start.elapsed_time(end) / (calls * reps)


def scan_bound(x, b, c, h0):
    """Least time for this call: x, dt, y, a, b, c, h0 and h moved once;
    7 float32 operations per (token, channel, state) at the float32 rate;
    or one exponential per (token, channel, state) at the SFU rate."""
    bsz, s, di = x.shape
    n = b.shape[-1]
    nbytes = 3 * x.numel() * x.element_size() + 4 * di * n + \
        (b.numel() + c.numel()) * b.element_size() + 4 * bsz * di * n * (2 if h0 is not None else 1)
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "operations": max(7.0 * bsz * s * di * n / H100_FP32_OPS_PER_S,
                               1.0 * bsz * s * di * n / H100_SFU_PER_S) * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def scan_bwd_bound(x, b, h0, gh):
    """Least time for one backward call: x, dt, gy, a, b, c, h0 and gh read
    once, gx, gdt, ga, gb, gc and gh0 written once; 18 float32 operations per
    (token, channel, state) (the state's recurrence 3, the adjoint 2, the
    sums into gC, gB, gx, gdt and ga 2 each, the product lam alpha h 2, the
    carry 1) at the float32 rate; or one exponential per (token, channel,
    state) at the SFU rate."""
    bsz, s, di = x.shape
    n = b.shape[-1]
    state = 4 * bsz * di * n
    nbytes = 5 * x.numel() * x.element_size() + 2 * 4 * di * n + \
        4 * b.numel() * b.element_size() + state * (1 + (h0 is not None) + (gh is not None))
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "operations": max(18.0 * bsz * s * di * n / H100_FP32_OPS_PER_S,
                               1.0 * bsz * s * di * n / H100_SFU_PER_S) * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


# The scan's backward kernel against the plain backward, of each gradient's
# scale: float32 sums in other orders (and ex2.approx for exp); a bf16
# gradient is one rounding of the float32 sums.
SCAN_BWD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
# name, (B, S, DI, N), dtype, with h0 and the final state's gradient, b / c
# as strided slices of one (B, S, 256 + 2N) product as models/ssm.py passes
# them, timed: falcon-mamba-7b's train shape first (the kernels line's).
SCAN_BWD_CASES = (("train_bf16", (16, 128, 8192, 16), "bfloat16", False, True, True),
                  ("prefill_bf16", (4, 2048, 8192, 16), "bfloat16", False, True, True),
                  ("h0_f32", (2, 2048, 1024, 16), "float32", True, False, False),
                  ("odd_f32", (3, 77, 1000, 8), "float32", True, False, False),
                  ("n32_f32", (2, 300, 512, 32), "float32", True, False, False))


def cuda_draw(torch, rng, size, lo=None, hi=None):
    """A float32 tensor on the card: standard normal, or uniform in
    [lo, hi), drawn by ``rng``."""
    v = rng.normal(size=size) if lo is None else rng.uniform(lo, hi, size)
    return torch.as_tensor(v.astype(np.float32), device="cuda")


def scan_bwd_device_ms(torch, call, calls: int = 10) -> dict:
    """Device ms of each of the backward's kernels, a launch each a call,
    under torch.profiler over ``calls`` calls: the sweep to the checkpoints,
    the walk back, the reduction over blocks, and all three. Each is its
    recorded time over its recorded launches: here the profiler has
    dropped up to two of a window's records."""
    prof = profile_window(torch, lambda: [call() for _ in range(calls)], match="mamba1_scan_bwd")
    out = {"sweep_device_ms": 0.0, "walk_device_ms": 0.0, "reduce_device_ms": 0.0}
    for name, rec in prof["match_kernels"].items():
        key = ("reduce" if "reduce_kernel" in name else "walk" if ", true>" in name
               else "sweep" if ", false>" in name else None)
        if key is None or not 0 < rec["count"] <= calls:
            fail(f"mamba1_scan_bwd: the profiler saw {rec['count']} of {name} in {calls} calls")
        out[f"{key}_device_ms"] = rec["ms"] / rec["count"]
    if not all(out.values()):
        fail(f"mamba1_scan_bwd: the profiler missed a backward kernel: {prof['match_kernels']}")
    out["device_ms"] = sum(out.values())
    return out


def phase_scan_bwd(torch, skernel, sref) -> dict:
    """Phase 6's backward cases: every gradient of ``mamba1_scan_bwd_cuda``
    against ``ref.mamba1_scan_bwd_ref`` on the same inputs (dt drawn as the
    forward cases draw it, a per (channel, state) over 1..16), one launch a
    call; at the timed shapes, the call's ms (CUDA events), the device ms of
    each of its three kernels (profiler), plain and bound ms."""
    out = {}
    for idx, (name, (b, s, di, n), dname, with_h0, strided, timed) in enumerate(SCAN_BWD_CASES):
        rng = np.random.default_rng(300 + idx)
        dtype = getattr(torch, dname)

        def draw(size, lo=None, hi=None):
            return cuda_draw(torch, rng, size, lo, hi)

        x, dt = draw((b, s, di)).to(dtype), draw((b, s, di), 0.001, 0.1).to(dtype)
        a = -torch.exp(draw((di, n), 0.0, float(np.log(16.0))))
        if strided:
            _, bm, cm = draw((b, s, 256 + 2 * n)).to(dtype).split([256, n, n], dim=-1)
        else:
            bm, cm = draw((b, s, n)).to(dtype), draw((b, s, n)).to(dtype)
        h0, gh = (draw((b, di, n)), draw((b, di, n))) if with_h0 else (None, None)
        gy = draw((b, s, di)).to(dtype)
        args = (x, dt, a, bm, cm, h0, gy, gh)
        before = skernel.launches["mamba1_scan_bwd"]
        got = skernel.mamba1_scan_bwd_cuda(*args)
        if skernel.launches["mamba1_scan_bwd"] != before + 1:
            fail(f"mamba1_scan_bwd {name}: the wrapper did not count one launch")
        want = sref.mamba1_scan_bwd_ref(*args)
        torch.cuda.synchronize()
        tol = SCAN_BWD_TOL[dname]
        errs, abs_errs = {}, {}
        for gname, g, w in zip(("x", "dt", "a", "b", "c", "h0"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not bool(torch.isfinite(g).all()):
                fail(f"mamba1_scan_bwd {name}: gradient of {gname} is {g.dtype} "
                     f"{tuple(g.shape)} (want {w.dtype} {tuple(w.shape)}) or not finite")
            abs_errs[gname], errs[gname] = rel_err(g, w)
        if max(errs.values()) > tol:
            fail(f"mamba1_scan_bwd {name}: gradients {json.dumps(errs)} of scale from the "
                 f"plain backward (limit {tol:.0e})")
        bound, bound_by = scan_bwd_bound(x, bm, h0, gh)
        res = {"shape": [b, s, di, n], "dtype": dname, "h0": with_h0, "strided_bc": strided,
               "err_of_scale": max(errs.values()), "grad_err_of_scale": errs,
               "max_abs_err": max(abs_errs.values()), "tol_of_scale": tol,
               "bound_ms": bound, "bound_by": bound_by}
        if timed:
            res["ms"] = cuda_ms(torch, lambda: skernel.mamba1_scan_bwd_cuda(*args), reps=20,
                                warmup=2)
            res.update(scan_bwd_device_ms(torch, lambda: skernel.mamba1_scan_bwd_cuda(*args)))
            res["forward_ms"] = cuda_ms(torch, lambda: skernel.mamba1_scan_cuda(*args[:6]),
                                        reps=20, warmup=2)
            # warm: the plain backward ran on these inputs for the check above
            res["plain_ms"] = cuda_ms(torch, lambda: sref.mamba1_scan_bwd_ref(*args), reps=1,
                                      warmup=0)
        out[name] = res
        del x, dt, gy, got, want, args
        torch.cuda.empty_cache()
    return out


def phase_lm_kernels(torch, fops, fref, fkernel, sops, skernel):
    bf16, f32 = torch.bfloat16, torch.float32
    AttnSpec = fref.AttnSpec
    # name, (B, Sq, Skv, H, Hkv, hd), dtype, spec, decode
    attn_cases = [
        ("prefill_bf16", (4, 2048, 2048, 32, 8, 128), bf16, AttnSpec(), False),
        ("prefill_f32", (4, 2048, 2048, 32, 8, 128), f32, AttnSpec(), False),
        ("decode_bf16", (4, 1, 48, 32, 8, 128), bf16, AttnSpec(), True),
        ("decode_f32", (4, 1, 48, 32, 8, 128), f32, AttnSpec(), True),
        ("window_bf16", (2, 1024, 1024, 16, 8, 128), bf16, AttnSpec(window=256), False),
        ("softcap_f32", (2, 512, 512, 8, 2, 128), f32, AttnSpec(softcap=50.0), False),
        ("prefix_f32", (2, 512, 512, 8, 2, 64), f32, AttnSpec(prefix_len=100), False),
        ("hd80_f32", (2, 300, 300, 8, 8, 80), f32, AttnSpec(), False),
        ("hd64_bf16_noncausal", (2, 256, 777, 8, 1, 64), bf16, AttnSpec(causal=False), False),
        ("masked_rows_f32", (2, 256, 256, 8, 2, 128), f32, AttnSpec(window=64), "masked"),
    ]
    # The wgmma kernel's cases, at both of its head dims and Hkv 1, 2 and 8:
    # soft-cap, prefix-LM, a batch row with no valid key, Sq and Skv that are
    # not multiples of 64, a window of 256.
    for hd in (64, 128):
        attn_cases += [
            (f"softcap_bf16_hd{hd}", (2, 512, 512, 8, 1, hd), bf16, AttnSpec(softcap=50.0), False),
            (f"prefix_bf16_hd{hd}", (2, 512, 512, 8, 2, hd), bf16, AttnSpec(prefix_len=100),
             False),
            (f"masked_rows_bf16_hd{hd}", (2, 256, 256, 8, 8, hd), bf16, AttnSpec(window=64),
             "masked"),
            (f"ragged_bf16_hd{hd}", (2, 333, 555, 8, 2, hd), bf16, AttnSpec(), False),
        ]
    attn_cases.append(("window_bf16_hd64", (2, 1024, 1024, 16, 8, 64), bf16,
                       AttnSpec(window=256), False))
    # The wgmma kernel rounds P to bf16 before P V (the plain version keeps
    # float32): 8192 and 32,768 keys (the JAX package's prefill_32k length)
    # feeding every row show the error stays in bounds.
    attn_cases += [(f"long_bf16_noncausal_hd{hd}", (1, 256, 8192, 8, 2, hd), bf16,
                    AttnSpec(causal=False), False) for hd in (64, 128)]
    attn_cases += [(f"long32k_bf16_noncausal_hd{hd}", (1, 256, 32768, 8, 2, hd), bf16,
                    AttnSpec(causal=False), False) for hd in (64, 128)]
    # Decode: a half-full ring buffer with a window (its second tile is all
    # empty slots and never loaded), and 32,768 filled slots (the JAX
    # package's decode_32k length) at B 4 and at its batch of 128.
    attn_cases += [
        ("decode_ring_bf16", (4, 1, 48, 32, 8, 128), bf16, AttnSpec(window=16), "half"),
        ("decode32k_b4_bf16", (4, 1, 32768, 32, 8, 128), bf16, AttnSpec(), "filled"),
        ("decode32k_b128_bf16", (128, 1, 32768, 32, 8, 128), bf16, AttnSpec(), "filled"),
    ]
    # minitron-4b's 16-token forward, the SIMT kernel's one launch on a
    # driven path now that decode has its own kernel; the bf16 B 4 x 2048
    # prefills of zamba2-2.7b's attention (H 32 / 32, hd 80) and
    # paligemma-3b's (H 8 / 1, hd 256, a 256-token prefix), which the SIMT
    # kernel takes (ROADMAP.md Queue 2 item 11); the float32 prefill that
    # paligemma-3b launches (its stream is float32: 256 patches + 2048
    # tokens); decode at an odd head dim.
    attn_cases += [
        ("forward16_bf16", (4, 16, 16, 32, 8, 128), bf16, AttnSpec(), False),
        ("prefill_hd80_bf16", (4, 2048, 2048, 32, 32, 80), bf16, AttnSpec(), False),
        ("prefill_hd256_bf16", (4, 2048, 2048, 8, 1, 256), bf16, AttnSpec(prefix_len=256), False),
        ("prefill_hd256_f32", (4, 2304, 2304, 8, 1, 256), f32, AttnSpec(prefix_len=256), False),
        ("decode_hd36_f32", (4, 1, 48, 32, 8, 36), f32, AttnSpec(), True),
    ]
    # Phase 12's bf16 attention shapes that no case above holds: zamba2-2.7b's
    # decode (H 32 / 32, hd 80: the decode kernel's instance padded to 128),
    # granite-20b's MQA decode and B 4 x 2048 wgmma prefill (48 q heads over
    # one kv head), whisper-base's cross-attention decode (non-causal over its
    # 1,500 encoded frames, hd 64).
    attn_cases += [
        ("decode_hd80_bf16", (4, 1, 48, 32, 32, 80), bf16, AttnSpec(), True),
        ("decode_mqa_bf16", (4, 1, 48, 48, 1, 128), bf16, AttnSpec(), True),
        ("prefill_mqa_bf16", (4, 2048, 2048, 48, 1, 128), bf16, AttnSpec(), False),
        ("decode_cross_bf16", (4, 1, 1500, 8, 8, 64), bf16, AttnSpec(causal=False), "filled"),
    ]
    # SDPA's device time by graph replay (its event time is host-bound at
    # the short shapes).
    library_device = ("forward16_bf16", "decode_bf16", "prefill_hd80_bf16", "prefill_hd256_bf16",
                      "prefill_hd256_f32")
    attn = {}
    for idx, (name, (b, sq, skv, h, hkv, hd), dtype, spec, decode) in enumerate(attn_cases):
        q, k, v, qp, kp, valid = attn_inputs(torch, b, sq, skv, h, hkv, hd, dtype, 100 + idx,
                                             decode if decode != "masked" else False)
        if decode == "masked":  # one batch row has no valid key; others see some
            valid = torch.ones((b, skv), dtype=torch.bool, device="cuda")
            valid[1] = False
            valid[0, 100:180] = False
        route = fkernel.variant(dtype, hd, sq)
        before = dict(fkernel.launches)
        got = fops.flash_attention(q, k, v, qp, kp, spec, kv_valid=valid, impl="kernel")
        launched = {n: fkernel.launches[n] - before[n] for n in before}
        if launched != {"flash_attention": 1, "flash_attention_wgmma": int(route == "wgmma"),
                        "flash_attention_decode": int(route == "decode"),
                        "flash_attention_decode_lse": 0}:
            fail(f"flash_attention {name}: routed to {route}, but launches went "
                 f"{before} -> {fkernel.launches}")
        big = b * skv > 1_000_000  # B 128 x 32,768: the plain version in slices
        plain = lambda: plain_attention(  # noqa: E731
            torch, fops, q, k, v, qp, kp, spec, valid, 16 if big else None)
        want = plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        tol = BF16_TOL if dtype == bf16 else F32_TOL
        unseen = ~fref.attention_mask(qp, kp, spec, valid).any(dim=-1)  # (B, Sq)
        n_unseen = int(unseen.sum())
        if n_unseen and not bool((got[unseen] == 0).all()):
            fail(f"flash_attention {name}: a row that sees no key is not exactly 0")
        if rel > tol or not bool(torch.isfinite(got).all()):
            fail(f"flash_attention {name}: {rel:.3e} of scale from the plain version "
                 f"(limit {tol:.0e})")
        bound, bound_by, visible = attn_bound(torch, fref, q, k, v, qp, kp, spec, valid)
        res = {"shape": [b, sq, skv, h, hkv, hd], "dtype": str(dtype), "spec": str(spec),
               "route": route, "max_abs_err": err, "err_of_scale": rel, "tol_of_scale": tol,
               "rows_seeing_no_key": n_unseen, "visible_pairs": visible,
               "bound_ms": bound, "bound_by": bound_by}
        long = skv > 1024  # the 32,768-slot caches and 1,500 encoded frames
        if name.startswith(("prefill", "decode", "forward")):
            reps = 10 if name.startswith("prefill") else (20 if long else 200)
            res["ms"] = cuda_ms(torch, lambda: fops.flash_attention(
                q, k, v, qp, kp, spec, kv_valid=valid, impl="kernel"), reps=reps, warmup=2)
            res["plain_ms"] = cuda_ms(torch, plain, reps=3 if name.startswith("prefill") else
                                      (2 if long else 50), warmup=1)
        if route == "decode":
            res["n_split"] = fkernel.decode_plan(
                b, skv, hkv, h // hkv, fkernel.decode_slots(q.device, dtype, hd, h // hkv))[0]
        if route in ("decode", "simt"):  # every SIMT case, timed and written down
            heavy = long or sq * skv > 1_000_000
            res["device_ms"] = graph_ms_per_call(torch, lambda: fops.flash_attention(
                q, k, v, qp, kp, spec, kv_valid=valid, impl="kernel"),
                4 if heavy else 64, 3 if heavy else 10)
        if route == "simt":
            res["rows"] = fkernel.simt_rows(b, sq, hkv, h // hkv, hd,
                                            fkernel.device_sms(q.device))
            res["occupancy"] = fkernel.simt_occupancy(dtype, hd, res["rows"])
        if name == "prefill_bf16" or route == "decode":
            # The SIMT kernel of flash_attention.cu forced on the same inputs.
            simt = lambda: fkernel.flash_attention_cuda(  # noqa: E731
                q, k, v, qp, kp, spec, kv_valid=valid, force_simt=True)
            res["simt_err_of_scale"] = simt_rel = rel_err(simt(), want)[1]
            if simt_rel > tol:
                fail(f"flash_attention {name} (simt): {simt_rel:.3e} of scale from the plain "
                     f"version (limit {tol:.0e})")
            res["simt_ms"] = cuda_ms(torch, simt, reps=10 if sq > 1 else (3 if long else 200),
                                     warmup=2 if not big else 1)
        if route == "decode":
            res["simt_device_ms"] = graph_ms_per_call(torch, simt, 2 if long else 64,
                                                      2 if long else 10)
            res["occupancy"] = fkernel.decode_occupancy(dtype, hd, h // hkv)
        if name == "prefill_bf16":
            res["occupancy"] = fkernel.wgmma_occupancy(hd, skv)
        # Sq = Skv with positions 0 .. (the causal flag), decode (the mask as
        # a boolean argument, built outside) and the new prefills.
        sdpa = (sdpa_call(torch, fref, q, k, v, qp, kp, spec, valid)
                if name.startswith(("prefill", "forward")) or route == "decode" else None)
        if sdpa is not None:
            try:
                lib = sdpa().transpose(1, 2)
                res["library_err_of_scale"] = rel_err(lib, want)[1]
                del lib
                res["library_ms"] = cuda_ms(torch, sdpa, reps=10 if sq > 1 else
                                            (5 if long else 200), warmup=2)
                if name in library_device:
                    heavy = sq * skv > 1_000_000
                    res["library_device_ms"] = graph_ms_per_call(
                        torch, sdpa, 4 if heavy else 64, 3 if heavy else 10)
            except (torch.cuda.OutOfMemoryError, RuntimeError) as exc:
                # A library call that cannot run a shape is a missing
                # yardstick, not a fault of the port.
                res["library_ms"] = None
                res["library_note"] = f"scaled_dot_product_attention failed: " \
                    f"{str(exc).splitlines()[0]}"
                torch.cuda.empty_cache()
        attn[name] = res
        del q, k, v, got, want, plain, sdpa
        simt = None  # its closure holds the inputs
        if big:
            torch.cuda.empty_cache()

    scan = {}
    # name, (B, S, DI, N), dtype, with h0, a drawn per (channel, state) and b / c
    # as strided slices of one (B, S, 256 + 2N) tensor, as models/ssm.py passes
    # them (else a = -(1..N) and contiguous b / c)
    scan_cases = [("prefill_bf16", (4, 2048, 8192, 16), bf16, False, False),
                  ("decode_bf16", (4, 1, 8192, 16), bf16, True, False),
                  ("prefill_f32", (2, 512, 1024, 16), f32, True, False),
                  ("odd_f32", (3, 77, 1000, 8), f32, True, False),
                  ("prefill_bf16_rand_a", (4, 2048, 8192, 16), bf16, False, True),
                  ("long_bf16", (1, 8192, 2048, 16), bf16, True, False),
                  ("n32_f32", (2, 300, 512, 32), f32, True, False)]
    for idx, (name, (b, s, di, n), dtype, with_h0, model_like) in enumerate(scan_cases):
        rng = np.random.default_rng(200 + idx)
        dev = "cuda"
        x = torch.as_tensor(rng.normal(size=(b, s, di)).astype(np.float32), device=dev).to(dtype)
        dt = torch.as_tensor(rng.uniform(0.001, 0.1, (b, s, di)).astype(np.float32),
                             device=dev).to(dtype)
        if model_like:
            a = -torch.as_tensor(np.exp(rng.uniform(np.log(1.0), np.log(16.0), (di, n)))
                                 .astype(np.float32), device=dev)
            proj = torch.as_tensor(rng.normal(size=(b, s, 256 + 2 * n)).astype(np.float32),
                                   device=dev).to(dtype)
            _, bm, cm = proj.split([256, n, n], dim=-1)
        else:
            a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n).contiguous()
            bm, cm = (torch.as_tensor(rng.normal(size=(b, s, n)).astype(np.float32),
                                      device=dev).to(dtype) for _ in range(2))
        h0 = (torch.as_tensor(rng.normal(size=(b, di, n)).astype(np.float32), device=dev)
              if with_h0 else None)
        y, h = sops.mamba1_scan(x, dt, a, bm, cm, h0=h0, impl="kernel")
        y_want, h_want = sops.mamba1_scan(x, dt, a, bm, cm, h0=h0, impl="chunked")
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == bf16 else F32_TOL
        err_y, rel_y = rel_err(y, y_want)
        err_h, rel_h = rel_err(h, h_want)
        if max(rel_y, rel_h if dtype == f32 else 0.0) > tol or not bool(torch.isfinite(y).all()):
            fail(f"mamba1_scan {name}: y {rel_y:.3e}, h {rel_h:.3e} of scale from the plain "
                 f"version (limit {tol:.0e})")
        if rel_h > F32_TOL * 10:  # the state is float32 in both
            fail(f"mamba1_scan {name}: final state {rel_h:.3e} of scale from the plain version")
        bound, bound_by = scan_bound(x, bm, cm, h0)
        res = {"shape": [b, s, di, n], "dtype": str(dtype), "h0": with_h0,
               "model_like": model_like, "max_abs_err": max(err_y, err_h),
               "err_of_scale": rel_y, "state_err_of_scale": rel_h, "tol_of_scale": tol,
               "bound_ms": bound, "bound_by": bound_by}
        if name in ("prefill_bf16", "decode_bf16", "prefill_bf16_rand_a"):
            reps = 200 if s == 1 else 10
            res["ms"] = cuda_ms(torch, lambda: sops.mamba1_scan(
                x, dt, a, bm, cm, h0=h0, impl="kernel"), reps=reps, warmup=2)
            res["plain_ms"] = cuda_ms(torch, lambda: sops.mamba1_scan(
                x, dt, a, bm, cm, h0=h0, impl="chunked"),
                reps=50 if s == 1 else 2, warmup=1)
        if name == "decode_bf16":
            # Back-to-back wrapper calls are host-bound; the device's own time
            # per call is the profiler's sum over 64 calls, every kernel the
            # wrapper launched included, over the scan launches it recorded
            # (it can miss events at the start of a window).
            prof = profile_window(torch, lambda: [sops.mamba1_scan(
                x, dt, a, bm, cm, h0=h0, impl="kernel") for _ in range(64)])
            seen = sum(t["count"] for t in prof["top"] if "mamba1_scan_kernel" in t["name"])
            if seen == 0:
                fail("mamba1_scan decode: the profiler recorded no scan kernel")
            res.update(device_ms=prof["device_busy_ms"] / seen, profiled_launches=seen,
                       device_launches_per_call=prof["device_launches"] / seen)
        scan[name] = res
        del x, dt, y, y_want
    torch.cuda.empty_cache()
    return {"flash_attention": attn, "mamba1_scan": scan}


# --------------------------------------------------------------------------
# Phases 7-8: serve the full-size models
# --------------------------------------------------------------------------

# Of scale: at full size, bf16 teacher-forced decode against the bf16
# forward, and against the same decode with the plain versions. Two bf16
# routes round every layer's activations after products of other shapes, 32
# or 64 times over; measured on an H100: 2.1e-2 and 1.9e-2 for minitron-4b
# (relu^2 MLP); 0 (the same bits) and 4.2e-2 for falcon-mamba-7b. The
# float32 reduced models of phase 9 hold the same code to 1e-5.
MODEL_TOL = 5e-2
# Of scale: the same two bf16 gaps for phase 12's archs. On an H100, with
# the same weights and tokens (``scripts/bf16_gap.py``), each bf16 route is
# as far from the float32 forward as from the other: zamba2-2.7b's bf16
# forward 1.15e-1 and its bf16 decode 1.18e-1 from the float32 forward,
# decode against forward 8.5e-2 with the kernels and 8.0e-2 with the plain
# versions, kernels against plain decode 2.7e-2; mixtral-8x7b (24 layers)
# 6.3e-2 against forward and against the plain decode (an expert choice
# flips); qwen2.5-32b 3.5e-2 / 3.0e-2; cuBLAS's reduced-precision bf16
# reduction on or off gives the same bits. So the gap is bf16 rounding
# carried through depth, not a kernel (phase 6 holds each kernel at these
# archs' shapes); the limit is 1.8 times the largest reading.
FAMILY_BF16_TOL = 0.15
# Of scale: decode against forward at full width in float32 compute (the
# bf16 weights taken to float32 in every product, float32 caches, the
# kernels' float32 instances), as the JAX package's smoke tests hold it
# (rtol = atol = 2e-3 in float32).
F32_DECODE_TOL = 2e-3


def reset_counts(*kernels) -> None:
    for k in kernels:
        k.reset_launch_counts()


def all_counts(*kernels) -> dict:
    out = {}
    for k in kernels:
        out.update(k.launches)
    return out


def expect_counts(kernels, what: str, want: dict) -> dict:
    """The launch counts since the last reset; fails unless they are
    ``want`` exactly, every kernel not named in it at 0."""
    counts = all_counts(*kernels)
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        fail(f"{what}: launches {counts}, expected {full}")
    return counts


def profile_window(torch, fn, match: str = "", top: int = 6) -> dict:
    """Device time of ``fn`` under torch.profiler: kernel time summed over
    CUDA events, the launch count, the host-clock wall time of the same
    window and the busy share, plus the ``top`` largest kernels; with
    ``match``, also the time and launches of the kernels whose name holds
    it, summed and (``match_kernels``) each. The profiler records the
    card's events alone and they are summed from its raw records: host
    operators and ``key_averages()`` cost 46.0 s
    at an L-DS slot's 92,458 launches on an H100's host, the card's events
    through ``key_averages()`` 19.1 s (the same busy time and launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}  # name -> [device us, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            rec = kernels.setdefault(e.name(), [0.0, 0])
            rec[0] += e.duration_ns() / 1e3
            rec[1] += 1
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    if busy_ms <= 0.0:
        fail("the profiler saw no device time")
    largest = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:top]
    out = {"device_busy_ms": busy_ms, "wall_ms": wall_ms, "busy_share": busy_ms / wall_ms,
           "device_launches": sum(n for _, n in kernels.values()),
           "top": [{"name": name[:80], "ms": us / 1e3, "count": n}
                   for name, (us, n) in largest]}
    if match:
        hit = {name: rec for name, rec in kernels.items() if match in name}
        out.update(match_ms=sum(us for us, _ in hit.values()) / 1e3,
                   match_count=sum(n for _, n in hit.values()),
                   match_kernels={name[:80]: {"ms": us / 1e3, "count": n}
                                  for name, (us, n) in hit.items()})
    return out


def stub_inputs(torch, cfg, batch: int, seed: int, device: str = "cuda") -> dict:
    """The stub frontend's input of an encoder-decoder (``frames``) or a VLM
    (``patches``), drawn on ``device`` from a generator seeded with
    ``seed``; {} for the other families."""
    shape = {"encdec": ("frames", cfg.enc_ctx), "vlm": ("patches", cfg.n_img_tokens)}
    if cfg.family not in shape:
        return {}
    name, rows = shape[cfg.family]
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn((batch, rows, cfg.d_model), generator=gen, device=device)}


def decode_tokens(cfg, prompt):
    """The tokens a decode check decodes: the prompt, or an MoE's first 8 of
    batch row 0. An MoE forward drops assignments past an expert's capacity
    and decode (B tokens a call) none at B 4; at B 1 x 8 no expert can take
    more than its 8 slots (``reference_forward`` checks it)."""
    return prompt[:1, :8] if cfg.family == "moe" else prompt


def reference_forward(cfg, api, model, tokens, extra):
    """The forward that a teacher-forced decode of ``tokens`` must reproduce.
    A VLM decodes plain causal (no image prefix in the cache), as its
    backbone's forward without patches computes."""
    from repro_torch.models import moe, transformer
    if cfg.family == "vlm":
        return transformer.forward(cfg, model, tokens)
    with moe.recording_routing() as log:
        full = api.forward(model, {"tokens": tokens, **extra})
    if not all(bool(kept.all()) for _, kept in log):
        fail(f"{cfg.name}: the forward of {tuple(tokens.shape)} tokens dropped an assignment")
    return full


def teacher_forced(torch, cfg, api, model, tokens, extra, kernels, step_counts: dict,
                   cache_len: int):
    """(logits (B, S, V), the last step's launches) of decoding ``tokens`` one
    at a time from a fresh cache, with exact launches a step; an
    encoder-decoder's cache first takes ``prefill_cross`` of the frames."""
    from repro_torch.models import encdec
    cache = api.init_cache(tokens.shape[0], cache_len)
    if cfg.family == "encdec":
        cache = encdec.prefill_cross(cfg, model, extra["frames"], cache)
    outs = []
    for t in range(tokens.shape[1]):
        reset_counts(*kernels)
        logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
        launched = expect_counts(kernels, f"{cfg.name} decode step ({cfg.compute_dtype})",
                                 step_counts)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    if not bool(torch.isfinite(dec).all()):
        fail(f"{cfg.name}: decode logits ({cfg.compute_dtype}) not finite")
    return dec, launched


def logit_gap(got, want) -> dict:
    """Max abs error, the same over the reference's scale, argmax agreement."""
    err, rel = rel_err(got, want)
    return {"err_of_scale": rel, "max_abs": err, "shape": list(got.shape[:2]),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            "logit_scale": float(want.float().abs().max())}


def phase_serve(torch, arch, serve, steps, models, get_config, kernels, counts,
                forward_kernel: str, long_cache=False, layers: int = 0,
                decode_tol: float = MODEL_TOL):
    """Serve ``arch`` at full width through the user's entry point (the
    first ``layers`` layers where given) and time its decode steps, then
    check decode with exact launch counts, profile the 16-token forward
    (device busy time and the share of the kernels whose name holds
    ``forward_kernel``) and two decode steps, and time a B 4 x 2048
    prefill (a VLM's 256 patches ahead of it), profiled with the same
    kernels' share. ``counts`` holds the exact launches of one decode step
    ("step"; the serve run makes 48), of the 16-token forward ("forward"),
    of the prefill ("prefill") and, where given, of the serve run's set-up
    ("serve_extra": an encoder-decoder's ``prefill_cross``). Teacher-forced
    decode must reproduce the forward, and the same decode with the plain
    versions, within ``decode_tol`` of scale in bf16, and the forward within
    ``F32_DECODE_TOL`` in float32 compute (same weights, same launches a
    step). ``long_cache`` adds ``phase_long_cache``."""
    import gc
    batch, prompt_len, gen = 4, 16, 32
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len),
            "--gen", str(gen)] + (["--layers", str(layers)] if layers else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    summary = serve.main(argv)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    cfg = dataclasses.replace(get_config(arch), n_layers=summary["n_layers"])
    serve_counts = {k: n * (prompt_len + gen) for k, n in counts["step"].items()}
    for k, n in counts.get("serve_extra", {}).items():
        serve_counts[k] = serve_counts.get(k, 0) + n
    counts = {**counts, "serve": serve_counts}
    launched = expect_counts(kernels, f"{arch} serve", counts["serve"])
    # The serve run's own loop (teacher-forced prompt, then greedy tokens
    # copied to the host one step at a time) on the host clock.
    out = {"n_layers": cfg.n_layers, "serve_main": summary, "serve_main_s": serve_s,
           "serve_launches": launched,
           "ms_per_decode_step": summary["decode_s"] / (prompt_len + gen) * 1e3,
           "tokens_per_s": batch * (prompt_len + gen) / summary["decode_s"],
           "serve_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    api = models.build_model(cfg)
    t0 = time.perf_counter()
    model = api.init(0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_gb"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                             dtype=torch.int32, device="cuda")
    extra = stub_inputs(torch, cfg, batch, seed=2)
    reset_counts(*kernels)
    full = api.forward(model, {"tokens": prompt, **extra})
    torch.cuda.synchronize()
    out["forward_launches"] = expect_counts(kernels, f"{arch} forward of {prompt_len} tokens",
                                            counts["forward"])
    want_rows = prompt_len + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    if full.shape != (batch, want_rows, cfg.vocab_size) or not bool(torch.isfinite(full).all()):
        fail(f"{arch}: forward logits {tuple(full.shape)} not finite of the expected shape")
    del full
    prof = profile_window(torch, lambda: api.forward(model, {"tokens": prompt, **extra}),
                          match=forward_kernel)
    out["forward_profile"] = {**prof, "kernel": forward_kernel,
                              "kernel_share": prof["match_ms"] / prof["device_busy_ms"]}

    # Decode in bf16 against the forward and against the same decode with the
    # plain versions (impl="chunked", no launch; every product at the same
    # shapes), both held to ``decode_tol``; in float32 compute against the
    # forward, held to F32_DECODE_TOL.
    tokens, cache_len = decode_tokens(cfg, prompt), prompt_len + gen
    dec, out["step_launches"] = teacher_forced(torch, cfg, api, model, tokens, extra, kernels,
                                               counts["step"], cache_len)
    bf = logit_gap(dec, reference_forward(cfg, api, model, tokens, extra))
    out.update({"decode_vs_forward_err_of_scale": bf["err_of_scale"],
                "decode_vs_forward_max_abs": bf["max_abs"], "decode_vs_forward_shape": bf["shape"],
                "argmax_agreement": bf["argmax_agreement"], "logit_scale": bf["logit_scale"],
                "decode_tol": decode_tol})
    if bf["err_of_scale"] > decode_tol:
        fail(f"{arch}: teacher-forced decode is {bf['err_of_scale']:.3e} of scale from the "
             f"forward (limit {decode_tol})")
    plain, _ = teacher_forced(torch, cfg, models.build_model(cfg, impl="chunked"), model,
                              tokens, extra, kernels, {}, cache_len)
    out["decode_vs_plain_decode"] = pg = logit_gap(dec, plain)
    if pg["err_of_scale"] > decode_tol:
        fail(f"{arch}: decode with the kernels is {pg['err_of_scale']:.3e} of scale from decode "
             f"with the plain versions (limit {decode_tol})")
    del dec, plain
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    api32 = models.build_model(cfg32)
    dec32, _ = teacher_forced(torch, cfg32, api32, model, tokens, extra, kernels, counts["step"],
                              cache_len)
    out["decode_vs_forward_f32"] = f32 = logit_gap(
        dec32, reference_forward(cfg32, api32, model, tokens, extra))
    if f32["err_of_scale"] > F32_DECODE_TOL:
        fail(f"{arch}: teacher-forced decode in float32 is {f32['err_of_scale']:.3e} of "
             f"scale from the forward (limit {F32_DECODE_TOL})")
    del dec32
    out["check_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    step = steps.make_serve_step(api)
    cache = api.init_cache(batch, cache_len)
    if cfg.family == "encdec":
        cache = models.encdec.prefill_cross(cfg, model, extra["frames"], cache)
    tok = prompt[:, :1]

    def two_steps():
        nonlocal tok, cache
        for _ in range(2):
            tok, cache = step(model, cache, tok)

    out["decode_profile"] = prof = profile_window(torch, two_steps)
    # Shares of the unprofiled time, as in phase 3 (the profiler slows the host).
    out["decode_busy_share"] = prof["device_busy_ms"] / 2 / out["ms_per_decode_step"]
    out["decode_busy_ms_per_step"] = prof["device_busy_ms"] / 2
    out["decode_launches_per_step"] = prof["device_launches"] / 2
    del cache
    gc.collect()
    torch.cuda.empty_cache()

    prefill = steps.make_prefill_step(api)
    pbatch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 2048)),
                                        dtype=torch.int32, device="cuda"),
              **stub_inputs(torch, cfg, batch, seed=3)}
    # The prefill's own peak; the profiled call is the warm-up of the timed one.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["prefill_profile"] = prof = profile_window(torch, lambda: prefill(model, pbatch),
                                                   match=forward_kernel)
    reset_counts(*kernels)
    t0 = time.perf_counter()
    logits = prefill(model, pbatch)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    # Before the checks below: isfinite of float32 logits holds an abs()
    # copy of them (7.8 GiB at gemma2-27b's B 4 x 2048).
    out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["prefill_tokens_per_s"] = batch * 2048 / (out["prefill_ms"] / 1e3)
    out["prefill_launches"] = expect_counts(kernels, f"{arch} B {batch} x 2048 prefill",
                                            counts["prefill"])
    want_rows = 2048 + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    if logits.shape != (batch, want_rows, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: prefill logits {tuple(logits.shape)} not finite of the expected shape")
    out["prefill_busy_share"] = prof["device_busy_ms"] / out["prefill_ms"]
    out["prefill_kernel_share"] = prof["match_ms"] / prof["device_busy_ms"]
    del logits, pbatch
    gc.collect()
    torch.cuda.empty_cache()
    if long_cache:
        out["long_cache"] = phase_long_cache(torch, models, cfg, api, model, kernels,
                                             counts["step"])
    del model, api
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Filled positions of the long-cache decode step (the JAX package's
# decode_32k length) and its tolerance against the same step with the
# plain attention: both round attention's output once to bf16 and carry the
# difference through the other layers' bf16 products; held to MODEL_TOL.
LONG_CACHE = 32768
LONG_CACHE_TOL = 5e-2


def phase_long_cache(torch, models, cfg, api, model, kernels, per_step) -> dict:
    """One decode step of the full-size model at B 4 over a cache of
    ``LONG_CACHE`` filled positions: k / v drawn on the card from a seeded
    generator, kv_pos 0 .. LONG_CACHE - 1, the step at position LONG_CACHE.
    Exact launches (``per_step``), ms per step (host clock, 5 steps from the
    same cache state), the profiler's device busy time and attention's share
    of it (the decode kernels it recorded), and the logits against the same
    step with ``impl="chunked"``."""
    import gc
    batch = 4
    torch.cuda.reset_peak_memory_stats()
    cache = api.init_cache(batch, LONG_CACHE + 1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, t in cache.items():
        if name.startswith("kv_pos"):
            t[..., :LONG_CACHE] = torch.arange(LONG_CACHE, dtype=torch.int32, device="cuda")
        elif name.startswith(("k", "v")):
            t.normal_(generator=gen)
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()
                   if isinstance(t, torch.Tensor)) / 1e9
    tok = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (batch, 1)),
                          dtype=torch.int32, device="cuda")

    def step(api_=api):
        cache["pos"] = LONG_CACHE  # every step decodes the same position
        return api_.decode_step(model, cache, tok)[0]

    reset_counts(*kernels)
    logits = step()
    torch.cuda.synchronize()
    launched = expect_counts(kernels, f"{cfg.name} decode step over {LONG_CACHE} positions",
                             per_step)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile_window(torch, step, match="flash_decode_kernel")
    want = step(models.build_model(cfg, impl="chunked"))
    if logits.shape != (batch, 1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name} long-cache step: logits {tuple(logits.shape)} not finite of the "
             f"expected shape")
    err, rel = rel_err(logits, want)
    if rel > LONG_CACHE_TOL:
        fail(f"{cfg.name} long-cache step: {rel:.3e} of scale from the step with the plain "
             f"attention (limit {LONG_CACHE_TOL})")
    out = {"positions": LONG_CACHE, "batch": batch, "cache_gb": cache_gb,
           "ms_per_step": sum(times) / len(times), "ms_steps": times, "launches": launched,
           "device_busy_ms": prof["device_busy_ms"], "device_launches": prof["device_launches"],
           "attention_ms": prof["match_ms"], "attention_launches": prof["match_count"],
           "attention_share": prof["match_ms"] / prof["device_busy_ms"],
           "busy_share": prof["device_busy_ms"] / (sum(times) / len(times)),
           "vs_plain_err_of_scale": rel, "vs_plain_max_abs": err, "tol_of_scale": LONG_CACHE_TOL,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del cache, logits, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 9: reduced models, card against CPU
# --------------------------------------------------------------------------

def parity_counts(cfg) -> dict:
    """Exact launches of phase 9's reduced float32 run (a 16-token forward
    and 4 decode steps): every forward attention on the SIMT kernel (16
    query rows, float32), every decode attention on the decode kernel (head
    dim 16), the scan once a layer a call. The hybrid attends once a group,
    the encoder-decoder in the encoder, the decoder's self- and
    cross-attention and (``prefill_cross``) the encoder again."""
    n = cfg.n_layers
    if cfg.family == "ssm":
        return {"mamba1_scan": 5 * n}
    if cfg.family == "hybrid":
        n //= cfg.hybrid_attn_every
    if cfg.family == "encdec":
        e = cfg.n_enc_layers
        return {"flash_attention": e + 2 * n + e + 4 * 2 * n,
                "flash_attention_decode": 4 * 2 * n}
    return {"flash_attention": 5 * n, "flash_attention_decode": 4 * n}


def phase_lm_parity(torch, models, configs, kernels):
    """Every architecture, reduced, in float32 with the same weights: forward
    logits and 4 decode steps on the card (kernels) and on the CPU (plain
    versions) agree within 1e-5 of scale. Both sum in float32 in other
    orders (matmuls outside TF32, set in main). An MoE's routing is
    compared first: the experts each call chose and the assignments it
    kept, equal on both sides. Exact launches (``parity_counts``)."""
    from repro_torch.models import encdec, moe
    out = {}
    batch = 2
    for arch in configs.all_configs():
        cfg = configs.reduced(configs.get_config(arch))
        cpu = models.build_model(cfg, device="cpu")
        gpu = models.build_model(cfg)
        m_cpu = cpu.init(0)
        m_gpu = models.new_model(cfg, "cuda")
        m_gpu.load_state_dict(m_cpu.state_dict())
        tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (batch, 16)).astype(np.int32)
        tc, tg = torch.as_tensor(tokens), torch.as_tensor(tokens, device="cuda")
        xc = stub_inputs(torch, cfg, batch, seed=6, device="cpu")
        xg = {k: v.cuda() for k, v in xc.items()}
        reset_counts(*kernels)
        with moe.recording_routing() as log_g:
            fwd_g = gpu.forward(m_gpu, {"tokens": tg, **xg})
        with moe.recording_routing() as log_c:
            fwd_c = cpu.forward(m_cpu, {"tokens": tc, **xc})
        routing = None
        if cfg.family == "moe":
            if len(log_g) != cfg.n_layers or any(
                    not torch.equal(ig.cpu(), ic) or not torch.equal(kg.cpu(), kc)
                    for (ig, kg), (ic, kc) in zip(log_g, log_c)):
                fail(f"{arch} reduced: the card and the CPU routed tokens to other experts")
            routing = {"calls": len(log_g),
                       "dropped": int(sum(int((~kc).sum()) for _, kc in log_c))}
        pairs = [("forward", fwd_g, fwd_c)]
        c_cpu, c_gpu = cpu.init_cache(batch, 8), gpu.init_cache(batch, 8)
        if cfg.family == "encdec":
            c_cpu = encdec.prefill_cross(cfg, m_cpu, xc["frames"], c_cpu)
            c_gpu = encdec.prefill_cross(cfg, m_gpu, xg["frames"], c_gpu)
        for t in range(4):
            lg, c_gpu = gpu.decode_step(m_gpu, c_gpu, tg[:, t:t + 1])
            lc, c_cpu = cpu.decode_step(m_cpu, c_cpu, tc[:, t:t + 1])
            pairs.append((f"decode{t}", lg, lc))
        launched = expect_counts(kernels, f"{arch} reduced", parity_counts(cfg))
        worst = 0.0
        for name, g, c in pairs:
            rel = rel_err(g.cpu(), c)[1]
            worst = max(worst, rel)
            if rel > 1e-5:
                fail(f"{arch} reduced {name}: card and CPU logits differ by {rel:.3e} of scale")
        out[arch] = {"max_err_of_scale": worst, "launches": launched,
                     **({"routing": routing} if routing else {})}
    return out


# --------------------------------------------------------------------------
# Phase 12: every other family served at its published widths
# --------------------------------------------------------------------------

def attn_counts(simt: int = 0, wgmma: int = 0, decode: int = 0) -> dict:
    """The launch dict of ``simt`` SIMT, ``wgmma`` wgmma and ``decode``
    decode attention kernels (each counts under ``flash_attention`` too)."""
    out = {"flash_attention": simt + wgmma + decode}
    if wgmma:
        out["flash_attention_wgmma"] = wgmma
    if decode:
        out["flash_attention_decode"] = decode
    return out


# arch -> (depth cut, 0 for none; exact attention launches of one decode
# step, the 16-token forward, the B 4 x 2048 prefill and the serve run's
# set-up). One launch an attention layer a call: bf16 streams take the wgmma
# kernel in prefill at hd 64 / 128, the SIMT kernel below 64 query rows and
# at hd 80 / 256; gemma2-27b's and paligemma-3b's streams are float32 (the
# embedding scale promotes), so their prefill and forward run the SIMT
# kernel in float32 and their decode the decode kernel's float32 instances.
# zamba2-2.7b attends once per group of 6 Mamba-2 layers (2 a call at 12
# layers); whisper-base in its 6 encoder layers (float32), 6 causal
# self-attentions and 6 cross-attentions over 1,500 frames (float32 keys
# against the bf16 query in a forward, so the SIMT kernel in float32; the
# bf16 cache in decode), and ``prefill_cross`` encodes once (6). Six models
# are cut in depth to keep the script in half its time limit (whole, this
# phase took 169 s on the card; each arch's time goes with its layers):
# qwen2.5-32b 16 of 64, gemma2-27b 8 of 46 (four local, four global),
# granite-20b 16 of 52, mixtral-8x7b 8 of 32, zamba2-2.7b 12 of 54 (two
# groups), paligemma-3b 6 of 18; whisper-base serves whole.
FAMILY_CELLS = {
    "qwen2.5-32b": (16, attn_counts(decode=16), attn_counts(simt=16), attn_counts(wgmma=16),
                    {}),
    "gemma2-27b": (8, attn_counts(decode=8), attn_counts(simt=8), attn_counts(simt=8), {}),
    "granite-20b": (16, attn_counts(decode=16), attn_counts(simt=16), attn_counts(wgmma=16),
                    {}),
    "mixtral-8x7b": (8, attn_counts(decode=8), attn_counts(simt=8), attn_counts(wgmma=8), {}),
    "zamba2-2.7b": (12, attn_counts(decode=2), attn_counts(simt=2), attn_counts(simt=2), {}),
    "whisper-base": (0, attn_counts(decode=12), attn_counts(simt=18),
                     attn_counts(simt=12, wgmma=6), attn_counts(simt=6)),
    "paligemma-3b": (6, attn_counts(decode=6), attn_counts(simt=6), attn_counts(simt=6), {}),
}


def phase_families(torch, serve, steps, models, configs, kernels) -> dict:
    """``phase_serve`` of each ``FAMILY_CELLS`` arch at its published widths
    (bf16 weights drawn on the card from seed 0; bf16 decode against forward
    held to ``FAMILY_BF16_TOL``), with the attention kernels' share of the
    16-token forward and of the prefill; the scan never launches."""
    out = {}
    for arch, (layers, step, forward, prefill, extra) in FAMILY_CELLS.items():
        t0 = time.perf_counter()
        counts = {"step": step, "forward": forward, "prefill": prefill, "serve_extra": extra}
        out[arch] = r = phase_serve(torch, arch, serve, steps, models, configs.get_config,
                                    kernels, counts, "flash_", layers=layers,
                                    decode_tol=FAMILY_BF16_TOL)
        r["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# Phase 10: fleets
# --------------------------------------------------------------------------

# Slices of the homogeneous fleets: 4 since phase 18 trained falcon-mamba-7b
# (8 before), for the script's time; phase 13 (c) still runs K = 8 fleets.
FLEET_K = 4
# Slots of every fleet of this phase, few enough to keep the whole script in
# half its time limit (2 since phase 18 trained falcon-mamba-7b; 3 and 4
# before): the second slot still starts from the first one's queues,
# multipliers and virtual queues.
FLEET_SLOTS = 2
# Matcher launches per fleet slot: one per policy group, whatever K is.
FLEET_LAUNCHES = {"ds": {"greedy_collection": 1, "greedy_assignment": 0, "greedy_pairing": 1},
                  "l-ds": {"greedy_collection": 1, "greedy_assignment": 1, "greedy_pairing": 2}}
MIXED_SPECS = ("ds", "l-ds", "no-sdc", "no-slt", "no-lsa", "greedy", "ecself", "cufull")
RAGGED_SHAPES = ((1024, 32), (768, 24), (512, 16), (1024, 16))


def fleet_config(core, s: int, n_cu: int, n_ec: int):
    """Slice s of a fleet: the Sec. IV-C setup (``sim_config``) with zeta,
    eps, f_base and c_base varied by slice as benchmarks/fleet_scale.py's
    ``_heterogeneous_configs`` varies them, seed = slice index."""
    return dataclasses.replace(
        sim_config(core, n_cu, n_ec), seed=s, zeta=400.0 + 50.0 * (s % 5),
        eps=0.1 + 0.02 * (s % 3), c_base=50.0 + 25.0 * (s % 4),
        f_base=tuple(8000.0 + 4000.0 * ((s + j) % 4) for j in range(n_ec)))


def same_run(torch, what: str, recs, ref_recs, state, ref_state) -> float:
    """Fails unless a fleet slice's (T,) records and final state equal a
    single-slice run's within rtol 1e-6 (states: plus 1e-6 of each
    tensor's scale); returns the largest relative difference."""
    worst = 0.0
    for f in ref_recs._fields:
        a, b = getattr(recs, f).double().cpu(), getattr(ref_recs, f).double().cpu()
        err = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
        if not torch.allclose(a, b, rtol=1e-6, atol=0.0):
            fail(f"{what}: record {f} differs from the single-slice run ({err:.3e})")
        worst = max(worst, err)
    pairs = [(f"{g}.{f}", getattr(getattr(state, g), f), getattr(getattr(ref_state, g), f))
             for g in ("queues", "mults", "emp_mults") for f in getattr(ref_state, g)._fields]
    pairs += [(f, getattr(state, f), getattr(ref_state, f))
              for f in ("total_cost", "total_trained", "uploaded")]
    for name, a, b in pairs:
        a, b = a.double().cpu(), b.double().cpu()
        scale = float(b.abs().max())
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-6 * scale):
            fail(f"{what}: {name} differs from the single-slice run")
        worst = max(worst, float((a - b).abs().max()) / (scale or 1.0))
    return worst


def phase_fleet(torch, core, kernel, bridge, metrics):
    """The fleet path at the Sec. IV-C setup (1024 x 32, pair_iters 120):
    homogeneous DS and L-DS fleets at K = 1 and K = FLEET_K (host ms per
    fleet slot and per slice-slot, profiled device busy and launches per
    fleet slot, peak memory, matcher launches per run: T x the per-slot
    count at both K); each slice of the K = FLEET_K fleets against its own
    single-slice card run, one such L-DS slot against the CPU; a ragged
    fleet and a mixed-policy fleet against their slices' own runs."""
    from repro_torch.core.fleet import slice_records
    out = {"homogeneous": {}}
    cfgs = [fleet_config(core, s, *MAIN_SHAPE) for s in range(FLEET_K)]
    fleets = {}
    for spec in (core.DS, core.LDS):
        per_run = {op: FLEET_SLOTS * c for op, c in FLEET_LAUNCHES[spec.name].items()}
        for k in (1, FLEET_K):
            eng = core.FleetEngine.from_configs(cfgs[:k], spec)
            state0 = eng.init()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernel)
            t0 = time.perf_counter()
            state, recs = eng.run(FLEET_SLOTS, state0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = expect_counts((kernel,), f"fleet {spec.name} K={k}", per_run)
            peak = torch.cuda.max_memory_allocated()
            for f in recs._fields:
                v = getattr(recs, f)
                if v.shape != (FLEET_SLOTS, k) or not bool(torch.isfinite(v).all()):
                    fail(f"fleet {spec.name} K={k}: record {f} not finite of shape "
                         f"({FLEET_SLOTS}, {k})")
            prof = profile_window(torch, lambda: eng.step(state))
            s0 = metrics.summary(cfgs[0], eng.slice_state(state, 0))
            out["homogeneous"][f"{spec.name}_k{k}"] = {
                "slots": FLEET_SLOTS, "slices": k,
                "ms_per_fleet_slot": wall / FLEET_SLOTS * 1e3,
                "ms_per_slice_slot": wall / (FLEET_SLOTS * k) * 1e3,
                "device_busy_ms_per_fleet_slot": prof["device_busy_ms"],
                "device_launches_per_fleet_slot": prof["device_launches"],
                "profiled_slot_wall_ms": prof["wall_ms"], "busy_share": prof["busy_share"],
                "peak_memory_gib": peak / 2 ** 30, "launches": launches,
                "slice0": {key: s0[key] for key in ("unit_cost", "skew_degree", "total_trained")},
            }
            fleets[(spec.name, k)] = (eng, state0, state, recs)

    # Slice k of each K = FLEET_K fleet against the single-slice run of slice k.
    out["parity"] = {}
    t0 = time.perf_counter()
    for spec in (core.DS, core.LDS):
        eng, state0, state, recs = fleets[(spec.name, FLEET_K)]
        _, _, dec = eng.step(state0)
        worst = 0.0
        for k, cfg in enumerate(cfgs):
            _, _, ref_dec = core.step(cfg, spec, core.init_state(cfg))
            for f in ("alpha", "theta", "z"):
                if not torch.equal(getattr(dec, f)[k], getattr(ref_dec, f)):
                    fail(f"fleet {spec.name} slice {k}: first-slot decision {f} differs "
                         "from the single-slice step")
            ref_state, ref_recs = core.run(cfg, spec, FLEET_SLOTS)
            worst = max(worst, same_run(torch, f"fleet {spec.name} slice {k}",
                                        slice_records(recs, k), ref_recs,
                                        eng.slice_state(state, k), ref_state))
        out["parity"][spec.name] = {"slices": FLEET_K, "slots": FLEET_SLOTS,
                                    "first_slot_decisions_equal": True,
                                    "max_rel_err": worst, "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()

    # One teacher-forced K = FLEET_K L-DS slot: the card (kernels) against the CPU.
    eng, _, state, _ = fleets[("l-ds", FLEET_K)]
    net = core.slot_network(eng.shape, state, eng.params)
    new_c, rec_c, dec_c = eng.step(state, net)
    eng_cpu = core.FleetEngine.from_configs(cfgs, core.LDS, device="cpu")
    new_p, rec_p, dec_p = eng_cpu.step(bridge.from_numpy(bridge.to_numpy(state), "cpu"),
                                       bridge.from_numpy(bridge.to_numpy(net), "cpu"))
    for f in ("alpha", "theta", "z"):
        if not torch.equal(getattr(dec_c, f).cpu(), getattr(dec_p, f)):
            fail(f"fleet slot: decision {f} differs between CUDA and CPU")
    pairs = [(f"dec.{f}", getattr(dec_c, f), getattr(dec_p, f)) for f in ("x", "y")]
    pairs += [(f"rec.{f}", getattr(rec_c, f), getattr(rec_p, f)) for f in rec_c._fields]
    pairs += [(f"{g}.{f}", getattr(getattr(new_c, g), f), getattr(getattr(new_p, g), f))
              for g in ("queues", "mults", "emp_mults") for f in getattr(new_c, g)._fields]
    worst = 0.0
    for name, a, b in pairs:
        for k in range(FLEET_K):
            scale = float(b[k].abs().max()) or 1.0
            err = float((a[k].double().cpu() - b[k].double()).abs().max()) / scale
            if err > 1e-5:  # phase 4's tolerance
                fail(f"fleet slot: {name} of slice {k} differs by {err:.3e} of its scale")
            worst = max(worst, err)
    out["card_vs_cpu_slot"] = {"slices": FLEET_K, "decisions_equal": True,
                               "max_rel_err": worst, "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()

    # A ragged fleet: four true shapes padded to 1024 x 32, DS.
    jobs = [core.SliceJob(fleet_config(core, s, n, m), core.DS)
            for s, (n, m) in enumerate(RAGGED_SHAPES)]
    eng = core.FleetEngine.from_jobs(jobs)
    reset_counts(kernel)
    state, recs = eng.run(FLEET_SLOTS)
    launches = expect_counts((kernel,), "ragged fleet",
                             {op: FLEET_SLOTS * c for op, c in FLEET_LAUNCHES["ds"].items()})
    worst = 0.0
    for k, job in enumerate(jobs):
        ref_state, ref_recs = core.run(job.config, job.spec, FLEET_SLOTS)
        worst = max(worst, same_run(torch, f"ragged slice {job.config.n_cu}x{job.config.n_ec}",
                                    slice_records(recs, k), ref_recs,
                                    eng.slice_state(state, k), ref_state))
    out["ragged"] = {"shapes": [list(sh) for sh in RAGGED_SHAPES], "padded_to": list(MAIN_SHAPE),
                     "slots": FLEET_SLOTS, "launches": launches, "max_rel_err": worst,
                     "seconds": time.perf_counter() - t0}

    # A mixed-policy fleet: one slice of each spec but ecfull, SWITCHED.
    jobs = [core.SliceJob(fleet_config(core, s, *MAIN_SHAPE), core.ALL_SPECS[name])
            for s, name in enumerate(MIXED_SPECS)]
    eng = core.FleetEngine.from_jobs(jobs)
    if eng.spec != core.SWITCHED:
        fail(f"mixed fleet runs {eng.spec.name}, expected switched")
    # One launch per policy group a slot: collection groups skew (six
    # slices: greedy_collection), plain (no-sdc: greedy_assignment) and
    # cufull (none); training groups skew (six) and linear (no-slt), each
    # greedy_pairing, and solo (ecself, none); the L-DS slice's virtual
    # update (greedy_assignment and greedy_pairing).
    groups = {"collect skew": {"greedy_collection": 1}, "collect plain": {"greedy_assignment": 1},
              "collect cufull": {}, "train skew": {"greedy_pairing": 1},
              "train linear": {"greedy_pairing": 1}, "train solo": {},
              "virtual l-ds": {"greedy_assignment": 1, "greedy_pairing": 1}}
    per_slot = {}
    for g in groups.values():
        for op, c in g.items():
            per_slot[op] = per_slot.get(op, 0) + c
    reset_counts(kernel)
    t1 = time.perf_counter()
    state, recs = eng.run(FLEET_SLOTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = expect_counts((kernel,), "mixed fleet",
                             {op: FLEET_SLOTS * c for op, c in per_slot.items()})
    worst = 0.0
    for k, job in enumerate(jobs):
        ref_state, ref_recs = core.run(job.config, job.spec, FLEET_SLOTS)
        worst = max(worst, same_run(torch, f"mixed slice {job.spec.name}",
                                    slice_records(recs, k), ref_recs,
                                    eng.slice_state(state, k), ref_state))
    out["mixed_policy"] = {"specs": list(MIXED_SPECS), "slots": FLEET_SLOTS,
                           "ms_per_fleet_slot": wall / FLEET_SLOTS * 1e3,
                           "launches_per_slot_by_group": groups, "launches": launches,
                           "max_rel_err": worst, "seconds": time.perf_counter() - t1}
    return out


# --------------------------------------------------------------------------
# Phase 11: Cocktail-scheduled LM training
# --------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "minitron-4b", "--batch", "16", "--seq", "128", "--n-cu", "12",
              "--slot-every", "4", "--scheduler", "ds", "--steps", "8", "--seed", "0",
              "--log-every", "100"]
TRAIN_MEMORY_SHARE = 0.95  # of the card's memory; above it the run is cut to 16 layers
TRAIN_CUT_LAYERS = 16
# DS's matcher launches a scheduler slot (train.main schedules with DS).
DS_PER_SLOT = {"greedy_collection": 1, "greedy_assignment": 0, "greedy_pairing": 1}
# The reduced card step against the CPU's: float32 both, other summation
# orders (loss relative; gradients, moments and parameters of each leaf's
# scale; parameters where |g| is above the gradients' tolerance, as
# tests/test_torch_train.py holds them, since AdamW's first step moves an
# element by about lr whatever |g| is).
TRAIN_LOSS_TOL = 1e-5
TRAIN_LEAF_TOL = 1e-4
RESUME_TOL = 1e-6


class Crash(Exception):
    """A training run killed between two steps."""


def crash_after(train, n_steps: int):
    """Patch ``train.make_train_step`` so the run's step raises ``Crash`` on
    its call after ``n_steps``; returns the restoring function."""
    make = train.make_train_step

    def crashing(*args, **kwargs):
        step, calls = make(*args, **kwargs), []

        def run(*a):
            if len(calls) == n_steps:
                raise Crash
            calls.append(1)
            return step(*a)
        return run

    train.make_train_step = crashing
    return lambda: setattr(train, "make_train_step", make)


def train_full_width(torch, train, configs, kernels, n_layers: int) -> dict:
    """``train.main`` on minitron-4b (cut to ``n_layers``, registered as
    ``minitron-4b-<n>l``, when it is not 0) with exact launch counts: the
    wgmma attention twice a layer a step (forward and the remat
    recompute), no other attention kernel, and the matchers DS launches a
    slot (collection and pairing once each)."""
    import gc
    argv = list(TRAIN_ARGV)
    if n_layers:
        cut = configs.register(dataclasses.replace(configs.get_config("minitron-4b"),
                                                   name=f"minitron-4b-{n_layers}l",
                                                   n_layers=n_layers))
        argv[argv.index("minitron-4b")] = cut.name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    summary = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    layers, steps = summary["n_layers"], len(summary["losses"])
    slots = summary["sched_slots"]
    cfg = dataclasses.replace(configs.get_config("minitron-4b"), n_layers=layers)
    want = {**train_launches(cfg, 128, steps),
            **{k: n * slots for k, n in DS_PER_SLOT.items()}}
    launched = expect_counts(kernels, f"minitron-4b training, {layers} layers", want)
    if steps != 8 or not all(math.isfinite(x) for x in summary["losses"]):
        fail(f"training: losses {summary['losses']} are not 8 finite values")
    ms = summary["step_ms"][1:8]
    return {"summary": {k: v for k, v in summary.items() if k != "step_ms"},
            "step_ms": summary["step_ms"], "ms_per_step": sum(ms) / len(ms),
            "tokens_per_s": 16 * 128 / (sum(ms) / len(ms) / 1e3), "run_s": run_s,
            "peak_bytes": peak, "peak_gib": peak / 2 ** 30, "launches": launched,
            "wgmma_per_step": launched["flash_attention_wgmma"] / steps,
            "matcher_launches_per_slot": {k: launched[k] / slots for k in DS_PER_SLOT},
            "slots": slots}


def profile_train_step(torch, api, train, steps, optim, kernels, mesh=None,
                       match: str = "flash_fwd_sm90_kernel") -> dict:
    """Train steps of the same model and a batch of the run's sampler (an
    encoder-decoder's frames or a VLM's patches as ``train._stub_input``
    draws them): the host-clock time of three steps after a warm one (their
    median is ``unprofiled_step_ms``), then one profiled step: device busy
    time, launches, busy share, the time and launches of the kernels whose
    name holds ``match``; the attention and scan launches of one step
    counted exactly (``train_launches``). With
    ``mesh``, the model's blocks are sharded and the steps run under it
    (the profile then matches the NCCL kernels); without, the step's
    forward, backward and AdamW spans follow."""
    import gc
    from repro_torch.data import CocktailSampler, TokenSource
    from repro_torch.parallel import sharding
    cfg = api.cfg
    ck = train.build_cocktail(12, 2, 0)
    sampler = CocktailSampler(ck, [TokenSource(i, cfg.vocab_size, 128) for i in range(12)],
                              batch_per_ec=8)
    state = api.init(0)
    if mesh is not None:
        sharding.shard_params(state, mesh)
    opt = optim.adamw_init(state)
    plain_step = steps.make_train_step(api, optim.AdamWConfig(), total_steps=8)

    def step(*args):
        if mesh is None:
            return plain_step(*args)
        with sharding.mesh_context(mesh):
            return plain_step(*args)
    import types
    host = sampler.sample(types.SimpleNamespace(x=np.ones((12, 2), np.float32),
                                                y=np.zeros((12, 2, 2), np.float32)))
    batch = {k: torch.as_tensor(host[k], device="cuda") for k in ("tokens", "labels", "weights")}
    stub = train._stub_input(types.SimpleNamespace(seed=0, batch=16), cfg, 0, "cuda")
    if stub is not None:
        batch["frames" if cfg.family == "encdec" else "patches"] = stub
    reset_counts(*kernels)
    state, opt, met = step(state, opt, batch)
    torch.cuda.synchronize()
    per_step = expect_counts(kernels, f"one {cfg.name} train step",
                             train_launches(cfg, 128, 1))

    def one():
        nonlocal state, opt, met
        state, opt, met = step(state, opt, batch)

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(times)[1]
    prof = profile_window(torch, one, match=match if mesh is None else "nccl")
    if mesh is not None:
        out = {**prof, "unprofiled_step_ms": step_ms, "step_ms": times, "launches": per_step,
               "busy_share_of_unprofiled_step": prof["device_busy_ms"] / step_ms,
               "loss": float(met["loss"])}
        del state, opt, met, batch
        gc.collect()
        torch.cuda.empty_cache()
        return out

    # The same step in three spans between CUDA events (stream time, host
    # gaps included): the loss's forward, the backward with the per-layer
    # recompute, and the AdamW update with its global norm.
    from repro_torch.optim.adamw import adamw_update_
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    named = dict(state.named_parameters())
    torch.cuda.synchronize()
    events[0].record()
    loss, _ = api.loss(state, batch)
    events[1].record()
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    events[2].record()
    opt, _ = adamw_update_(named, grads, opt, optim.AdamWConfig(),
                           optim.cosine_schedule(opt.step, 8, 1))
    events[3].record()
    torch.cuda.synchronize()
    spans = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("forward_ms", "backward_ms", "optimizer_ms"))}
    del loss, grads, named
    out = {**prof, "unprofiled_step_ms": step_ms, "step_ms": times, "launches": per_step,
           "busy_share_of_unprofiled_step": prof["device_busy_ms"] / step_ms,
           "loss": float(met["loss"]), "spans": spans}
    del state, opt, met, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def attention_calls(cfg, seq: int) -> list:
    """(type, head dim, query rows) of each attention call of one forward of
    ``cfg`` over ``seq`` tokens, as the models make them: one call a layer,
    in the compute type, or in float32 where the embedding scale promotes
    the stream (gemma2, paligemma), a VLM's patches ahead of its tokens; the
    hybrid's shared block once a group; the encoder-decoder's encoder over
    its frames in float32 (its position table promotes), then per decoder
    layer a causal self-attention in the compute type and a cross-attention
    in float32 (the float32 keys promote the query); none in a pure SSM."""
    import torch
    from repro_torch.models import hybrid
    cdt, hd = getattr(torch, cfg.compute_dtype), cfg.head_dim
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [(cdt, hd, seq)] * hybrid.n_groups(cfg)
    if cfg.family == "encdec":
        return ([(torch.float32, hd, cfg.enc_ctx)] * cfg.n_enc_layers
                + [(cdt, hd, seq), (torch.float32, hd, seq)] * cfg.n_layers)
    stream = torch.float32 if cfg.scale_embed else cdt
    rows = seq + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    return [(stream, hd, rows)] * cfg.n_layers


def train_attention_launches(cfg, seq: int, forwards: int) -> dict:
    """Exact attention launches of ``forwards`` differentiated forwards of
    ``cfg`` over ``seq`` tokens: each call on the kernel that
    ``kernel.variant`` gives it, twice under remat (the backward's
    recompute)."""
    from repro_torch.kernels.flash_attention.kernel import variant
    routes = [variant(*call) for call in attention_calls(cfg, seq)]
    n = forwards * (2 if cfg.remat else 1)
    return attn_counts(simt=n * routes.count("simt"), wgmma=n * routes.count("wgmma"))


def train_scan_launches(cfg, forwards: int) -> dict:
    """Exact scan launches of ``forwards`` differentiated forwards of a
    Mamba-1 model (none for other families): the forward kernel once a layer
    (through ``ops.KernelScan``), twice under remat (the backward's
    recompute), and the backward kernel once a layer."""
    if cfg.family != "ssm":
        return {}
    n = forwards * cfg.n_layers
    return {"mamba1_scan": n * (2 if cfg.remat else 1), "mamba1_scan_bwd": n}


def train_launches(cfg, seq: int, forwards: int) -> dict:
    """Exact attention and scan launches of ``forwards`` differentiated
    forwards of ``cfg`` over ``seq`` tokens."""
    return {**train_attention_launches(cfg, seq, forwards),
            **train_scan_launches(cfg, forwards)}


def train_card_vs_cpu(torch, models, configs, steps, optim, kernels,
                      arch: str = "minitron-4b", device: str = "cuda") -> dict:
    """Reduced ``arch`` in float32, the same weights and batch (an
    encoder-decoder's frames or a VLM's patches as ``train._stub_input``
    draws them for step 0): the loss, the gradients and one train step
    (moments, updated parameters) on the card (kernels) and on the CPU
    (plain versions), with exact attention launches on the card. An MoE's
    routing of every call is recorded on both sides and must be equal: a
    flip fails as a flip."""
    import types
    from repro_torch.launch import train
    from repro_torch.models import moe
    cfg = configs.reduced(configs.get_config(arch))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    weights = np.array([1.3, 0.0, 0.7, 2.0], np.float32)
    stub = train._stub_input(types.SimpleNamespace(seed=0, batch=4), cfg, 0, "cpu")
    res = {}
    weights0 = models.build_model(cfg, device="cpu").init(0).state_dict()
    for side, dev in (("card", device), ("cpu", "cpu")):
        api = models.build_model(cfg, device=dev)
        model = models.new_model(cfg, dev)
        model.load_state_dict(weights0)
        batch = {"tokens": torch.as_tensor(tokens, device=dev),
                 "labels": torch.as_tensor(labels, device=dev),
                 "weights": torch.as_tensor(weights, device=dev)}
        if stub is not None:
            batch["frames" if cfg.family == "encdec" else "patches"] = stub.to(dev)
        if side == "card":
            reset_counts(*kernels)
        model.requires_grad_(True)
        named = dict(model.named_parameters())
        with moe.recording_routing() as routing:
            loss, _ = api.loss(model, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            p0 = {k: p.detach().cpu().clone() for k, p in named.items()}
            opt = optim.adamw_init(model)
            model, opt, met = steps.make_train_step(api, optim.AdamWConfig(), total_steps=10)(
                model, opt, batch)
        res[side] = {"loss": float(loss.detach()), "step_loss": float(met["loss"]),
                     "grads": {k: g.cpu() for k, g in zip(named, grads)}, "p0": p0,
                     "params": {k: p.detach().cpu() for k, p in model.named_parameters()},
                     "m": {k: t.cpu() for k, t in opt.m.items()},
                     "v": {k: t.cpu() for k, t in opt.v.items()},
                     "routing": [(i.cpu(), kept.cpu()) for i, kept in routing]}
        if side == "card":  # float32: the SIMT kernel, the loss's forward and the step's
            launched = expect_counts(kernels, f"reduced {arch} train step",
                                     train_launches(cfg, tokens.shape[1], 2))
    card, cpu = res["card"], res["cpu"]
    routing = None
    if cfg.family == "moe":
        flips = [c for c, ((ig, kg), (ic, kc)) in enumerate(zip(card["routing"], cpu["routing"]))
                 if not (torch.equal(ig, ic) and torch.equal(kg, kc))]
        if len(card["routing"]) != len(cpu["routing"]) or len(cpu["routing"]) != 2 * cfg.n_layers:
            fail(f"reduced {arch} train step: {len(card['routing'])} routed calls on the card, "
                 f"{len(cpu['routing'])} on the CPU, expected {2 * cfg.n_layers}")
        if flips:
            fail(f"reduced {arch} train step: the card and the CPU routed tokens to other "
                 f"experts (a flip) in calls {flips}")
        routing = {"calls": len(cpu["routing"]), "equal": True,
                   "dropped": int(sum(int((~kc).sum()) for _, kc in cpu["routing"]))}
    loss_rel = max(abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("loss", "step_loss"))
    if loss_rel > TRAIN_LOSS_TOL:
        fail(f"reduced {arch} train step: card and CPU losses differ by {loss_rel:.3e} "
             f"(relative)")
    worst = {"grads": 0.0, "m": 0.0, "v_root": 0.0, "params": 0.0}
    flips = 0
    for k, g in cpu["grads"].items():
        for name, a, b in (("grads", card["grads"][k], g), ("m", card["m"][k], cpu["m"][k]),
                           ("v_root", card["v"][k].sqrt(), cpu["v"][k].sqrt())):
            worst[name] = max(worst[name], rel_err(a, b)[1])
        above = g.abs() > TRAIN_LEAF_TOL * g.abs().max()
        want, got = cpu["params"][k], card["params"][k]
        if bool(above.any()):
            err = float((got - want).abs()[above].max()) / max(float(want.abs().max()), 1e-30)
            worst["params"] = max(worst["params"], err)
        flip = torch.sign(got - card["p0"][k]) != torch.sign(want - cpu["p0"][k])
        if bool((flip & above).any()):
            fail(f"reduced {arch} train step: {k} moved the other way where |g| is above "
                 f"{TRAIN_LEAF_TOL} of its scale")
        flips += int(flip.sum())
    bad = {k: v for k, v in worst.items() if v > TRAIN_LEAF_TOL}
    if bad:
        fail(f"reduced {arch} train step: card and CPU differ by {bad} of each leaf's scale "
             f"(limit {TRAIN_LEAF_TOL})")
    return {"loss_rel_err": loss_rel, "err_of_leaf_scale": worst,
            "sign_flips_below_noise": flips, "launches": launched,
            "loss": card["loss"], "tol": {"loss": TRAIN_LOSS_TOL, "leaf": TRAIN_LEAF_TOL},
            **({"routing": routing} if routing else {})}


def train_resume(torch, train, kernels, workdir: Path) -> dict:
    """On the card at reduced size: a 20-step run killed after step 10 and
    run again against an uninterrupted 20-step run (step-20 snapshots), with
    torch.use_deterministic_algorithms on."""
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    args = ["--arch", "minitron-4b", "--reduced", "--batch", "4", "--seq", "32",
            "--n-cu", "6", "--steps", "20", "--checkpoint-every", "10", "--slot-every", "3",
            "--lr", "1e-3", "--log-every", "100"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        restore = crash_after(train, 10)
        try:
            train.main(args + ["--checkpoint-dir", str(workdir / "a")])
            fail("the run meant to crash after step 10 ran to its end")
        except Crash:
            pass
        finally:
            restore()
        resumed = train.main(args + ["--checkpoint-dir", str(workdir / "a")])
        whole = train.main(args + ["--checkpoint-dir", str(workdir / "b")])
    finally:
        torch.use_deterministic_algorithms(False)
    if resumed["start_step"] != 10:
        fail(f"resume: started at step {resumed['start_step']}, expected 10")
    worst, bit_equal = 0.0, True
    with np.load(workdir / "a" / "step_0000000020.npz") as a, \
            np.load(workdir / "b" / "step_0000000020.npz") as b:
        if sorted(a.files) != sorted(b.files):
            fail("resume: the two step-20 snapshots hold other leaves")
        for key in b.files:
            if key == "__meta__":
                continue
            x, y = a[key].astype(np.float64), b[key].astype(np.float64)
            bit_equal &= bool(np.array_equal(a[key], b[key]))
            worst = max(worst, float(np.abs(x - y).max()) / max(float(np.abs(y).max()), 1e-30))
    shutil.rmtree(workdir, ignore_errors=True)
    if worst > RESUME_TOL:
        fail(f"resume: the resumed run's parameters are {worst:.3e} of scale from the "
             f"uninterrupted run's (limit {RESUME_TOL})")
    return {"bit_equal": bit_equal, "max_err_of_scale": worst,
            "losses_equal": resumed["losses"] == whole["losses"][10:],
            "deterministic_algorithms": True, "tol_of_scale": RESUME_TOL}


def attention_train_shape(torch, fops, fref, fkernel) -> dict:
    """The attention Function at the train step's shape (B 16 x 128, H 32 /
    8, hd 128, bf16, causal): forward against ``attention_chunked`` at
    BF16_TOL of scale, dq / dk / dv bit-equal to autograd through
    ``attention_chunked``; kernel forward and recompute backward times
    beside SDPA's forward and backward and the operations bound."""
    b, s, h, hkv, hd = 16, 128, 32, 8, 128
    spec = fref.AttnSpec(causal=True)
    q, k, v, qp, kp, _ = attn_inputs(torch, b, s, s, h, hkv, hd, torch.bfloat16, 21)
    g = torch.as_tensor(np.random.default_rng(22).normal(size=(b, s, h, hd)).astype(np.float32),
                        device="cuda").to(torch.bfloat16)
    before = dict(fkernel.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fops.flash_attention(*leaves, qp, kp, spec)
    if fkernel.launches["flash_attention_wgmma"] != before["flash_attention_wgmma"] + 1:
        fail("the attention Function at the train shape did not launch the wgmma kernel")
    grads = torch.autograd.grad(out, leaves, g)
    plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = fops.attention_chunked(*plain_leaves, qp, kp, spec)
    plain_grads = torch.autograd.grad(plain, plain_leaves, g)
    err, rel = rel_err(out, plain)
    if rel > BF16_TOL:
        fail(f"attention Function forward at the train shape: {rel:.3e} of scale from "
             f"attention_chunked (limit {BF16_TOL})")
    for name, a, c in zip("qkv", grads, plain_grads):
        if not torch.equal(a, c):
            fail(f"attention Function d{name} is not bit-equal to autograd through "
                 f"attention_chunked")

    def fwd():
        return fops.flash_attention(*leaves, qp, kp, spec)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves, g)

    F = torch.nn.functional
    sd_leaves = [t.transpose(1, 2).detach().clone().requires_grad_() for t in (q, k, v)]
    gt = g.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*sd_leaves, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), sd_leaves, gt)

    fwd_ms, fwd_bwd_ms = cuda_ms(torch, fwd, 20, 3), cuda_ms(torch, fwd_bwd, 10, 2)
    sdpa_ms, sdpa_fwd_bwd_ms = cuda_ms(torch, sdpa_fwd, 20, 3), cuda_ms(torch, sdpa_fwd_bwd, 10, 2)
    with torch.no_grad():
        plain_ms = cuda_ms(torch, lambda: fops.attention_chunked(q, k, v, qp, kp, spec), 10, 2)
    bound_ms, bound_by, visible = attn_bound(torch, fref, q, k, v, qp, kp, spec, None)
    # The backward's least time: q, k, v and the output's gradient read once,
    # dq, dk and dv written once (every key is seen here), the positions
    # read; or five products of 2 hd operations per visible pair (S
    # recomputed, dP, dV, dQ, dK) at the bf16 tensor-core peak.
    bwd_bytes = (3 * q.numel() + 4 * k.numel()) * q.element_size() + \
        4 * (qp.numel() + kp.numel())
    bwd_terms = {"bytes": bwd_bytes / H100_BYTES_PER_S * 1e3,
                 "operations": 5 * 2.0 * hd * visible / H100_BF16_TC_OPS_PER_S * 1e3}
    bwd_bound_by = max(bwd_terms, key=bwd_terms.get)
    return {"shape": [b, s, s, h, hkv, hd], "dtype": "bfloat16", "spec": "causal",
            "forward_err_of_scale": rel, "max_abs_err": err, "grads_bit_equal": True,
            "ms": fwd_ms, "forward_ms": fwd_ms, "backward_ms": fwd_bwd_ms - fwd_ms,
            "forward_backward_ms": fwd_bwd_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "backward_bound_ms": bwd_terms[bwd_bound_by], "backward_bound_by": bwd_bound_by,
            "library_ms": sdpa_ms, "library_forward_backward_ms": sdpa_fwd_bwd_ms}


def scan_function(torch, sops, skernel) -> dict:
    """The scan's CUDA route under autograd: the call is recorded as
    ``ops.KernelScan``, launches the forward kernel once (outputs bit-equal
    to the kernel called directly) and the backward kernel once in the
    backward; every gradient (with h0 and the final state's gradient) within
    SCAN_BWD_TOL of scale of autograd through ``mamba1_scan_chunked``."""
    rng = np.random.default_rng(41)
    b, s, di, n = 2, 64, 256, 16

    def draw(size, lo=None, hi=None):
        return cuda_draw(torch, rng, size, lo, hi)

    inputs = (draw((b, s, di)), draw((b, s, di), 0.001, 0.1),
              -torch.exp(draw((di, n), 0.0, float(np.log(16.0)))), draw((b, s, n)),
              draw((b, s, n)), draw((b, di, n)))
    gy, gh = draw((b, s, di)), draw((b, di, n))
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = dict(skernel.launches)
    y, h = sops.mamba1_scan(*leaves[:5], h0=leaves[5])
    if type(y.grad_fn).__name__ != "KernelScanBackward":
        fail(f"the scan's CUDA route under autograd recorded {type(y.grad_fn).__name__}, not "
             f"KernelScan")
    grads = torch.autograd.grad((y, h), leaves, (gy, gh))
    launched = {k: skernel.launches[k] - before[k] for k in before}
    if launched != {"mamba1_scan": 1, "mamba1_scan_bwd": 1}:
        fail(f"the scan's CUDA route under autograd launched {launched}, expected one forward "
             f"and one backward kernel")
    direct = skernel.mamba1_scan_cuda(*inputs)
    if not (torch.equal(y.detach(), direct[0]) and torch.equal(h.detach(), direct[1])):
        fail("the scan's Function forward is not bit-equal to the kernel called directly")
    plain = [t.clone().requires_grad_() for t in inputs]
    yp, hp = sops.mamba1_scan(*plain[:5], h0=plain[5], impl="chunked")
    want = torch.autograd.grad((yp, hp), plain, (gy, gh))
    errs = {name: rel_err(g, w)[1] for name, g, w in zip(("x", "dt", "a", "b", "c", "h0"),
                                                           grads, want)}
    if max(errs.values()) > SCAN_BWD_TOL["float32"]:
        fail(f"the scan's Function gradients are {json.dumps(errs)} of scale from autograd "
             f"through the chunked scan (limit {SCAN_BWD_TOL['float32']:.0e})")
    return {"function": "KernelScan", "shape": [b, s, di, n], "launches": launched,
            "forward_bit_equal": True, "grad_err_of_scale": errs,
            "tol_of_scale": SCAN_BWD_TOL["float32"]}


def phase_train(torch, models, configs, steps, kernels, fkernel, fops, fref, sops,
                skernel) -> dict:
    """Phase 11: the training path (``repro_torch.launch.train.main``) at
    minitron-4b's full width, 32 layers unless the peak memory passes
    TRAIN_MEMORY_SHARE of the card (then TRAIN_CUT_LAYERS); one profiled
    step; the reduced step card vs CPU; resume; the attention Function at
    the train shape; the scan's Function under autograd."""
    import gc
    from repro_torch import optim
    from repro_torch.launch import train
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"card_memory_bytes": total, "memory_share_limit": TRAIN_MEMORY_SHARE}
    t0 = time.perf_counter()
    full = None
    try:
        full = train_full_width(torch, train, configs, kernels, 0)
        peak, why = full["peak_bytes"], None
    except torch.cuda.OutOfMemoryError as exc:  # the cut the phase is told to make
        peak, why = total, f"out of memory: {str(exc).splitlines()[0]}"
    gc.collect()
    torch.cuda.empty_cache()
    if peak >= TRAIN_MEMORY_SHARE * total:
        out["cut"] = {"layers": TRAIN_CUT_LAYERS, "peak_at_32_bytes": peak, "reason": why}
        print(f"phase 11 cut to {TRAIN_CUT_LAYERS} layers: the 32-layer run's peak "
              f"{peak / 2 ** 30:.2f} GiB is at or above {TRAIN_MEMORY_SHARE:.0%} of "
              f"{total / 2 ** 30:.2f} GiB ({why or 'measured'})")
        full = train_full_width(torch, train, configs, kernels, TRAIN_CUT_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
    out["full"] = full
    out["full"]["peak_share"] = full["peak_bytes"] / total
    out["full_s"] = time.perf_counter() - t0
    cfg = configs.get_config("minitron-4b")
    cfg = dataclasses.replace(cfg, n_layers=full["summary"]["n_layers"])
    out["profile"] = profile_train_step(torch, models.build_model(cfg), train, steps, optim,
                                        kernels)
    from repro_torch.launch import mesh as lmesh
    out["profile_mesh"] = profile_train_step(torch, models.build_model(cfg), train, steps,
                                             optim, kernels, mesh=lmesh.make_host_mesh())
    out["card_vs_cpu"] = train_card_vs_cpu(torch, models, configs, steps, optim, kernels)
    out["resume"] = train_resume(torch, train, kernels, ROOT / "build" / "chip_smoke_resume")
    out["attention"] = attention_train_shape(torch, fops, fref, fkernel)
    out["scan"] = scan_function(torch, sops, skernel)
    return out


# --------------------------------------------------------------------------
# Phase 13: the distribution layer at a world of 1
# --------------------------------------------------------------------------

DIST_LAYERS = 8  # of minitron-4b's 32, for time
DIST_STEPS = 3
DIST_FLEET_K = 8
DIST_FLEET_SLOTS = 3


def dist_cross_pod(torch, collectives, sharding, pod_mesh) -> dict:
    """(a) ``cross_pod_sum_partials`` on a (1, 1, 1) pod mesh: the int8
    payload and the scale go through NCCL (two all-gathers a leaf); with one
    pod the sum is the plain pack dequantised, bit for bit."""
    rng = np.random.default_rng(31)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(rng.standard_normal((4096, 3072)).astype(np.float32),
                            device="cuda").to(dtype)

        def plain():
            q, scale = collectives._int8_pack(x)
            return (q.float() * scale).to(dtype)

        def summed():
            return collectives.cross_pod_sum_partials({"g": x}, pod_mesh)["g"]

        sharding.reset_comm_counts()
        got = summed()
        torch.cuda.synchronize()
        gathers = sharding.comm_counts["all_gather"]
        if gathers != 2:
            fail(f"cross-pod sum ({dtype}): {gathers} all-gathers, expected 2")
        if got.dtype != dtype or not torch.equal(got, plain()):
            fail(f"cross-pod sum ({dtype}): not bit-equal to the plain pack and dequantise")
        out[str(dtype).replace("torch.", "")] = {
            "shape": list(x.shape), "bit_equal": True, "all_gathers": gathers,
            "wire_bytes": sharding.comm_counts["all_gather_bytes"],
            "ms": cuda_ms(torch, summed, 10, 2), "plain_ms": cuda_ms(torch, plain, 10, 2)}
    return out


def recording_train_step(torch, train):
    """Patch ``train.make_train_step`` so the run's step records each batch
    (cloned), its own device time (synchronised on both sides) and the last
    (params, opt); returns (record, restoring function)."""
    make = train.make_train_step
    rec = {"batches": [], "ms": []}

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(params, opt, batch):
            rec["batches"].append({k: v.clone() for k, v in batch.items()})
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            rec["state"], rec["opt"] = out[0], out[1]
            return out
        return run

    train.make_train_step = recording
    return rec, lambda: setattr(train, "make_train_step", make)


def dist_train(torch, train, steps, optim, models, configs, sharding, kernels, mesh) -> dict:
    """(b) ``train.main`` under the (1, 1) mesh at minitron-4b's widths, cut
    to DIST_LAYERS layers, B 16 x 128, DIST_STEPS steps, against the
    unsharded ``make_train_step`` on the same weights (seed 0) and the
    batches the run drew: losses and parameters bit for bit (every
    collective of a world of 1 is a copy; deterministic algorithms on both
    sides). Counts the collectives of the run per step; then profiles one
    more step of each (device busy, NCCL kernels' time and launches)."""
    import gc
    cfg = configs.register(dataclasses.replace(configs.get_config("minitron-4b"),
                                               name=f"minitron-4b-{DIST_LAYERS}l",
                                               n_layers=DIST_LAYERS))
    argv = list(TRAIN_ARGV)
    argv[argv.index("minitron-4b")] = cfg.name
    argv[argv.index("--steps") + 1] = str(DIST_STEPS)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rec, restore = recording_train_step(torch, train)
        sharding.reset_comm_counts()
        reset_counts(*kernels)
        try:
            summary = train.main(argv)
        finally:
            restore()
        torch.cuda.synchronize()
        comm = dict(sharding.comm_counts)
        params = rec.pop("state")
        named = dict(params.named_parameters())
        shard = sharding.param_shardings(params)
        stacked = sum(1 for k, sh in shard.items() if sh.dim is not None and "blocks" in k)
        top = sum(1 for k, sh in shard.items() if sh.dim is not None and "blocks" not in k)
        host = {k: p.detach().cpu() for k, p in named.items()}
        api = models.build_model(cfg)
        last = rec["batches"][-1]
        mesh_step = steps.make_train_step(api, optim.AdamWConfig(), total_steps=DIST_STEPS)
        opt = rec.pop("opt")

        def one_mesh_step():
            with sharding.mesh_context(mesh):
                mesh_step(params, opt, last)

        mesh_prof = profile_window(torch, one_mesh_step, match="nccl")
        del params, named, shard, opt
        gc.collect()
        torch.cuda.empty_cache()

        model = api.init(0)
        opt = optim.adamw_init(model)
        step = steps.make_train_step(api, optim.AdamWConfig(), total_steps=DIST_STEPS)
        ref_losses, ref_ms = [], []
        for batch in rec["batches"]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt, met = step(model, opt, batch)
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t) * 1e3)
            ref_losses.append(float(met["loss"]))
        worst, unequal = 0.0, []
        for k, p in model.named_parameters():
            a, b = host[k], p.detach().cpu()
            if not torch.equal(a, b):
                unequal.append(k)
                worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        plain_prof = profile_window(torch, lambda: step(model, opt, last), match="nccl")
        del model, opt, met, host, rec["batches"], last
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    if summary["losses"] != ref_losses:
        fail(f"distributed train: losses {summary['losses']} under the mesh, {ref_losses} "
             f"unsharded")
    if unequal:
        fail(f"distributed train: {len(unequal)} parameters differ from the unsharded step "
             f"(largest {worst:.3e} of scale): {unequal[:5]}")
    # One all-gather a layer a forward pass (the remat recompute gathers
    # again) and one reduce-scatter a layer, each carrying the layer's
    # sharded leaves; the embedding and the head one each.
    remat = 2 if cfg.remat else 1
    want = {"all_gather": DIST_STEPS * (remat * DIST_LAYERS + top),
            "reduce_scatter": DIST_STEPS * (DIST_LAYERS + top)}
    if {k: comm.get(k, 0) for k in want} != want:
        fail(f"distributed train: collectives {comm}, expected {want}")
    return {"layers": DIST_LAYERS, "steps": DIST_STEPS, "losses": ref_losses,
            "bit_equal": True, "mesh_ms": rec["ms"], "unsharded_ms": ref_ms,
            "mesh_ms_per_step": sum(rec["ms"][1:]) / (DIST_STEPS - 1),
            "unsharded_ms_per_step": sum(ref_ms[1:]) / (DIST_STEPS - 1),
            "collectives": comm, "sharded_leaves": {"per_layer": stacked, "top": top},
            "per_step": {k: v / DIST_STEPS for k, v in comm.items()},
            "deterministic_algorithms": True, "summary_world": summary["world"],
            "profile": {"mesh": mesh_prof, "unsharded": plain_prof}}


def dist_fleet(torch, core, kernel, bridge, mesh) -> dict:
    """(c) ``FleetEngine.run(mesh=)`` of DS and L-DS fleets of K = 8 at
    1024 x 32 over DIST_FLEET_SLOTS slots against ``run()``: final states
    and records bit for bit, the same matcher launches."""
    out = {}
    for name, spec in (("ds", core.DS), ("l-ds", core.LDS)):
        cfgs = [fleet_config(core, s, *MAIN_SHAPE) for s in range(DIST_FLEET_K)]
        eng = core.FleetEngine.from_configs(cfgs, spec)
        runs = {}
        for label, mesh_arg in (("mesh", mesh), ("plain", None)):
            reset_counts(kernel)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, recs = eng.run(DIST_FLEET_SLOTS, mesh=mesh_arg)
            torch.cuda.synchronize()
            runs[label] = {"ms": (time.perf_counter() - t) * 1e3,
                           "launches": dict(kernel.launches),
                           "tree": {"state": bridge.to_numpy(state),
                                    "recs": bridge.to_numpy(recs)}}
        if runs["mesh"]["launches"] != runs["plain"]["launches"]:
            fail(f"fleet {name} with a mesh: launches {runs['mesh']['launches']}, without "
                 f"{runs['plain']['launches']}")

        def leaves(tree, prefix=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from leaves(v, f"{prefix}/{k}")
            elif tree is not None:
                yield prefix, tree

        got, want = dict(leaves(runs["mesh"]["tree"])), dict(leaves(runs["plain"]["tree"]))
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        if bad or set(got) != set(want):
            fail(f"fleet {name} with a mesh differs from run(): {bad[:5]}")
        out[name] = {"k": DIST_FLEET_K, "slots": DIST_FLEET_SLOTS, "bit_equal": True,
                     "launches": runs["mesh"]["launches"], "mesh_ms": runs["mesh"]["ms"],
                     "plain_ms": runs["plain"]["ms"]}
    return out


def phase_distributed(torch, train, steps, optim, models, configs, core, bridge,
                      kernels, kernel) -> dict:
    """Phase 13: the world-1 NCCL group (started in the process through an
    in-process store, or the one phase 11's ``train.main`` started), a
    (1, 1) host mesh and a (1, 1, 1) pod mesh on the card; (a) the int8
    cross-pod sum, (b) ``train.main`` under the mesh against the unsharded
    step, (c) sharded fleets against ``run()``. (d): a pod mesh of one rank
    has no pod peers, so (a) shows the code path on the card; the numerics
    across ranks are the CPU tests' (tests/test_torch_distributed.py)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import collectives, sharding
    lmesh.ensure_process_group()
    if dist.get_world_size() != 1:
        fail(f"phase 13 needs a world of 1, the process group has {dist.get_world_size()}")
    mesh = lmesh.make_host_mesh()
    pod_mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    backend = str(dist.get_backend())
    if "nccl" not in backend:
        fail(f"phase 13: the process group's backend is {backend}, not NCCL")
    out = {"world": dist.get_world_size(), "backend": backend,
           "mesh": {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names)},
           "pod_mesh": {"shape": list(pod_mesh.shape), "names": list(pod_mesh.mesh_dim_names)}}
    t = time.perf_counter()
    out["cross_pod"] = dist_cross_pod(torch, collectives, sharding, pod_mesh)
    out["cross_pod_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["train"] = dist_train(torch, train, steps, optim, models, configs, sharding, kernels,
                              mesh)
    out["train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["fleet"] = dist_fleet(torch, core, kernel, bridge, mesh)
    out["fleet_s"] = time.perf_counter() - t
    return out


# --------------------------------------------------------------------------
# Phase 6: the decode kernel's log-sum-exp output
# --------------------------------------------------------------------------

# The lse against the plain version's: both compute it in float32 from the
# same inputs (bf16 q / k widened exactly), so float32 is held to 1e-5
# relative and bf16 to BF16_TOL of scale; o as the other decode cases.
LSE_F32_TOL = 1e-5


def phase_lse(torch, fops, fref, fkernel) -> dict:
    """The decode kernel with ``return_lse`` against ``ref.attention_lse_ref``:
    granite-20b's decode on a rank of phase 14 (24 of 48 slots, all 48 q
    heads over its one kv head) in both types, a row that sees no key
    (lse -1e30, o 0), and a rank's half of a 32,768-slot cache (16,384
    slots, several splits merged in the launch); device ms per call by
    graph replay, the plain version's ms and the bound (q, o, lse and the
    positions moved once, k / v of the visible keys)."""
    bf16, f32 = torch.bfloat16, torch.float32
    AttnSpec = fref.AttnSpec
    cases = [("lse_seq_bf16", (4, 24, 48, 1, 128), bf16, True),
             ("lse_seq_f32", (4, 24, 48, 1, 128), f32, True),
             ("lse_unseen_f32", (4, 24, 48, 1, 128), f32, "unseen"),
             ("lse16k_bf16", (4, 16384, 32, 8, 128), bf16, "filled")]
    out = {}
    for idx, (name, (b, skv, h, hkv, hd), dtype, decode) in enumerate(cases):
        q, k, v, qp, kp, valid = attn_inputs(torch, b, 1, skv, h, hkv, hd, dtype, 300 + idx,
                                             decode if decode != "unseen" else True)
        if decode == "unseen":
            valid = valid.clone()
            valid[1] = False
        spec = AttnSpec()
        call = lambda: fops.flash_attention(  # noqa: E731
            q, k, v, qp, kp, spec, kv_valid=valid, impl="kernel", return_lse=True)
        before = dict(fkernel.launches)
        o, lse = call()
        launched = {n: fkernel.launches[n] - before[n] for n in before}
        if launched != {"flash_attention": 1, "flash_attention_wgmma": 0,
                        "flash_attention_decode": 1, "flash_attention_decode_lse": 1}:
            fail(f"flash_attention {name}: launches went {before} -> {fkernel.launches}")
        plain = lambda: fref.attention_lse_ref(q, k, v, qp, kp, spec, valid)  # noqa: E731
        o_ref, lse_ref = plain()
        torch.cuda.synchronize()
        seen = fref.attention_mask(qp, kp, spec, valid).any(dim=-1)  # (B, 1)
        err_o, rel_o = rel_err(o, o_ref)
        d = (lse - lse_ref).abs()[seen]
        lse_rel = float((d / lse_ref.abs()[seen].clamp(min=1e-30)).max())
        lse_of_scale = float(d.max()) / max(float(lse_ref.abs()[seen].max()), 1e-30)
        tol = BF16_TOL if dtype == bf16 else F32_TOL
        if rel_o > tol or not bool(torch.isfinite(o).all()):
            fail(f"flash_attention {name}: o {rel_o:.3e} of scale from the plain version")
        if (dtype == f32 and lse_rel > LSE_F32_TOL) or (dtype == bf16 and lse_of_scale > tol):
            fail(f"flash_attention {name}: lse {lse_rel:.3e} relative, {lse_of_scale:.3e} of "
                 f"scale from the plain version")
        unseen = ~seen
        if bool(unseen.any()) and not (bool((lse[unseen] == fref.NEG).all()) and
                                       bool((o[unseen] == 0).all())):
            fail(f"flash_attention {name}: a row that sees no key is not (0, -1e30)")
        bound, bound_by, _ = attn_bound(torch, fref, q, k, v, qp, kp, spec, valid)
        bound += 4.0 * lse.numel() / H100_BYTES_PER_S * 1e3 if bound_by == "bytes" else 0.0
        long = skv > 1024
        out[name] = {
            "shape": [b, 1, skv, h, hkv, hd], "dtype": str(dtype), "route": "decode",
            "max_abs_err": max(err_o, float(d.max()) if d.numel() else 0.0),
            "err_of_scale": rel_o, "lse_rel_err": lse_rel, "lse_err_of_scale": lse_of_scale,
            "rows_seeing_no_key": int(unseen.sum()),
            "n_split": fkernel.decode_plan(b, skv, hkv, h // hkv, fkernel.decode_slots(
                q.device, dtype, hd, h // hkv))[0],
            "ms": graph_ms_per_call(torch, call, 4 if long else 64, 3 if long else 10),
            "event_ms": cuda_ms(torch, call, reps=20 if long else 200, warmup=2),
            "plain_ms": cuda_ms(torch, plain, reps=3 if long else 50, warmup=1),
            "bound_ms": bound, "bound_by": bound_by,
            # No PyTorch call returns the log-sum-exp of an attention.
            "library_ms": None}
        del q, k, v, o, lse, o_ref, lse_ref, call, plain
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 14: tensor-parallel serving, two ranks on the one card
# --------------------------------------------------------------------------

# arch -> layers kept (0: all). minitron-4b serves with its 8 kv heads on
# model (the "heads" cache layout); granite-20b's one kv head leaves the
# cache split by slots ("seq": q gathered, the decode kernel's lse output,
# the log-sum-exp merge); falcon-mamba-7b splits its Mamba-1 channels,
# mixtral-8x7b its experts' ffn; all four are cut in depth for the phase's
# time (minitron-4b to 8 of 32 layers since phase 18 trained
# falcon-mamba-7b).
TP_CELLS = (("minitron-4b", 8), ("granite-20b", 8), ("falcon-mamba-7b", 8),
            ("mixtral-8x7b", 4))
TP_WORLD = 2
# Generated tokens of a two-rank serve run: 16 since phase 18 trained
# falcon-mamba-7b (32 before), for the script's time.
TP_BATCH, TP_PROMPT, TP_GEN = 4, 16, 16
TP_STEPS = 6  # teacher-forced decode steps held against the unsharded run
# Of scale: the two ranks' float32 partial sums meet in one more addition
# than the unsharded products (measured on an H100: 1.2e-6 to 2.6e-6).
TP_F32_TOL = 1e-4
TP_TIMEOUT_S = 480


@dataclasses.dataclass(frozen=True)
class ServeSetup:
    """The serve runs and checks of a two-rank phase: global batch,
    teacher-forced check steps, ranks on the ``model`` axis (the rest on
    ``data``)."""
    batch: int = TP_BATCH
    steps: int = TP_STEPS
    model_parallel: int = TP_WORLD


TP_SETUP = ServeSetup()


def tp_config(configs, arch: str, layers: int, compute_dtype: str = ""):
    cfg = configs.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype) if compute_dtype else cfg


def tp_argv(arch: str, layers: int, device: str, model_parallel: int,
            batch: int = TP_BATCH) -> list:
    return (["--arch", arch, "--device", device, "--batch", str(batch), "--prompt-len",
             str(TP_PROMPT), "--gen", str(TP_GEN), "--model-parallel", str(model_parallel)]
            + (["--layers", str(layers)] if layers else []))


def tp_tokens(torch, cfg, device, setup: ServeSetup = TP_SETUP):
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (setup.batch, setup.steps)),
                           dtype=torch.int32, device=device)


def tp_frames(torch, cfg, device, batch: int = TP_BATCH):
    """``serve.main``'s stub frames of an encoder-decoder (seed 1)."""
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randn((batch, cfg.enc_ctx, cfg.d_model), generator=gen, device=device)


def rank_rows(sharding, x, mesh):
    """This rank's rows of a global batch leaf, as ``serve.main`` takes
    them: its block where the rows divide over the data-parallel ranks, else
    the whole batch."""
    if mesh is None:
        return x
    try:
        return sharding.local_rows(x, mesh)
    except ValueError:
        return x


def tp_checks(torch, configs, models, sharding, arch, layers, device, mesh=None,
              setup: ServeSetup = TP_SETUP) -> dict:
    """Teacher-forced decode logits (B, steps, V) on the host, in float32
    compute and in bf16, of the bf16 weights drawn from seed 0 (the serve
    run's), this rank's block of them under ``mesh``; an MoE's expert ids
    of every step and layer (steps, L, B, k) beside them (``routing``); an
    encoder-decoder's cross-attention cache filled from ``serve.main``'s
    frames first."""
    from repro_torch.models import encdec, moe
    out = {}
    model = None
    for cdt in ("float32", "bfloat16"):
        cfg = tp_config(configs, arch, layers, cdt)
        api = models.build_model(cfg, device=device)
        if model is None:
            model = api.init(0, dtype=torch.bfloat16, mesh=mesh)
        tokens = rank_rows(sharding, tp_tokens(torch, cfg, device, setup), mesh)
        cache = api.init_cache(setup.batch, setup.steps + 2)
        if cfg.family == "encdec":  # serve.main's frames, each rank's rows
            frames = rank_rows(sharding, tp_frames(torch, cfg, device, setup.batch), mesh)
            cache = encdec.prefill_cross(cfg, model, frames, cache)
        steps, routes = [], []
        for t in range(setup.steps):
            with moe.recording_routing() as log:
                logits, cache = api.decode_step(model, cache, tokens[:, t:t + 1])
            steps.append(logits[:, 0].float().cpu())
            if log:
                routes.append(torch.stack([idx.cpu() for idx, _ in log]))
        out[cdt] = torch.stack(steps, dim=1)
        if routes:
            out[f"routing_{cdt}"] = torch.stack(routes)
        del cache
    del model
    torch.cuda.empty_cache()
    return out


def tp_agreeing_rows(torch, got: dict, want: dict, cdt: str):
    """(B, steps) mask of the decode steps of each batch row before the
    first step where an MoE picked other experts on the two sides in any
    layer (a near tie that the other rounding flips: from there the row's
    cache differs); all True without routing."""
    key = f"routing_{cdt}"
    if key not in want:
        return torch.ones(want[cdt].shape[:2], dtype=torch.bool)
    same = (got[key].sort(-1).values == want[key].sort(-1).values).all(-1).all(1)  # (steps, B)
    return same.t().int().cumprod(dim=1).bool()


def tp_worker(rank: int, world: int, work: str, cells, device: str, train_cells=(),
              train_styles=("tp",), setup: ServeSetup = TP_SETUP) -> None:
    """One rank of phases 14-17 (a spawned process): a gloo group through a
    FileStore under ``work``; per cell ``serve.main`` at ``--model-parallel
    setup.model_parallel`` and ``--batch setup.batch`` with every launch
    count set to 0 just before it and read just after, then ``tp_checks``
    on this rank's blocks; per train style and train cell
    ``tp_train_cell``; the results go to ``work/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(work) / "store"), world),
                            rank=rank, world_size=world)
    try:
        from repro_torch import configs, models
        from repro_torch.kernels.flash_attention import kernel as fkernel
        from repro_torch.kernels.mamba_scan import kernel as skernel
        from repro_torch.kernels.matching import kernel as mkernel
        from repro_torch.launch import serve
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel import sharding
        kernels = (mkernel, fkernel, skernel)
        out = {"backend": str(dist.get_backend())}
        for arch, layers in cells:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(*kernels)
            summary = serve.main(tp_argv(arch, layers, device, setup.model_parallel,
                                         setup.batch))
            launches = all_counts(*kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            mesh = make_host_mesh(model_parallel=setup.model_parallel, device=device)
            with sharding.mesh_context(mesh, "serve"):
                logits = tp_checks(torch, configs, models, sharding, arch, layers, device, mesh,
                                   setup)
            out[arch] = {"summary": summary, "launches": launches, "serve_peak_gib": peak,
                         "logits": logits}
        for style in train_styles:
            for arch, layers in train_cells:
                mesh = make_host_mesh(model_parallel=world, device=device)
                out[f"train {style} {arch}"] = r = tp_train_cell(
                    torch, models, configs, sharding, kernels, arch, layers, device, mesh, style)
                print(f"phase {train_phase(style)} rank {rank} train {style} {arch}: stages (s) "
                      f"{json.dumps(r['stage_s'])}", flush=True)
        torch.save(out, Path(work) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tp_expected(configs, arch: str, layers: int, steps: int, world: int):
    """(launches of a serve run of ``steps`` decode steps, collectives of a
    step) on a model axis of ``world``: one attention (decode kernel) a
    decode attention a step -- a layer's, zamba2's shared block once a group
    of layers, whisper's self- and cross-attention a decoder layer, which
    first encodes its frames (float32: the SIMT kernel a layer) -- the lse
    variant where the kv heads do not divide over model, or one scan launch
    a layer a step; all-reduces a step: 2 a layer (wo / w_down, the MoE
    combine, x_proj / out_proj, Mamba-2's gated norm / out_proj), 2 an
    application of the shared block, 3 a whisper decoder layer; 1 for the
    embedding rows and 1 logits gather where the vocabulary divides over
    model; a q gather and an lse merge an attention under "seq"."""
    cfg = tp_config(configs, arch, layers)
    vocab = int(cfg.vocab_size % world == 0)
    if cfg.family == "ssm":
        return ({"mamba1_scan": cfg.n_layers * steps},
                {"tp_all_reduce": 2 * cfg.n_layers + vocab, "tp_all_gather": vocab})
    seq = cfg.n_kv_heads % world != 0
    attns, reduces, extra = cfg.n_layers, 2 * cfg.n_layers, 0
    if cfg.family == "hybrid":
        attns = cfg.n_layers // cfg.hybrid_attn_every
        reduces = 2 * cfg.n_layers + 2 * attns
    elif cfg.family == "encdec":
        attns, reduces, extra = 2 * cfg.n_layers, 3 * cfg.n_layers, cfg.n_enc_layers
    n = attns * steps
    launches = {"flash_attention": n + extra, "flash_attention_decode": n}
    if seq:
        launches["flash_attention_decode_lse"] = n
    comm = {"tp_all_reduce": reduces + vocab, "tp_all_gather": vocab + (2 * attns if seq else 0)}
    return launches, {k: v for k, v in comm.items() if v}


def split_expected(configs, arch: str, layers: int, steps: int, world: int):
    """(launches of a serve run of ``steps`` decode steps, collectives of a
    step) of a batch below dp on a (world, 1) mesh: every slot split over
    ``data``, so every decode attention takes the decode kernel's
    log-sum-exp route and merges by one all-gather over ``data``
    (``slot_all_gather``); a whisper encoder's layers first (float32: the
    SIMT kernel a layer); nothing on the ``model`` axis of 1."""
    cfg = tp_config(configs, arch, layers)
    attns, extra = cfg.n_layers, 0
    if cfg.family == "hybrid":
        attns = cfg.n_layers // cfg.hybrid_attn_every
    elif cfg.family == "encdec":
        attns, extra = 2 * cfg.n_layers, cfg.n_enc_layers
    n = attns * steps
    return ({"flash_attention": n + extra, "flash_attention_decode": n,
             "flash_attention_decode_lse": n}, {"slot_all_gather": attns})


# --------------------------------------------------------------------------
# Phase 15: the hybrid and encoder-decoder families served on a model axis of
# 2, and one train step there for three families
# --------------------------------------------------------------------------

# zamba2-2.7b at 12 of its 54 layers (two groups of 6: the shared block
# twice a step) and whisper-base whole, served as phase 14 serves; both
# hold their kv heads on model at 2 (32 and 8 kv heads).
TP15_CELLS = (("zamba2-2.7b", 12), ("whisper-base", 0))
# Train cells at full width: minitron-4b at 4 of 32 layers (16 / 4 local q
# / kv heads: the wgmma kernel in bf16), zamba2-2.7b at 6 (one group: the
# SIMT kernel at hd 80) and whisper-base whole; B 4 x 128 each.
TP15_TRAIN_CELLS = (("minitron-4b", 4), ("zamba2-2.7b", 6), ("whisper-base", 0))
# One bf16 step a cell and style after the float32 one (two, the first a
# warm-up, until phase 18 trained falcon-mamba-7b: cut for the script's
# time), so its ms include the bf16 path's first call.
TP15_BATCH, TP15_SEQ, TP15_BF16_STEPS = 4, 128, 1
# 1e3 x AdamW's eps: a gradient below it sets a first update lr g / (|g| +
# eps) that moves by 1e-3 of its ulps' error and more (``hold_train_blocks``).
TP15_GRAD_FLOOR = 1e-5
# Attention launches of one bf16 train step (remat: forward and recompute):
# minitron-4b's 4 layers on the wgmma kernel; zamba2-2.7b's shared block
# once; whisper-base's float32 encoder (6) and cross-attentions (6, float32
# keys) on the SIMT kernel, its bf16 decoder self-attention (6) on wgmma.
TP15_TRAIN_LAUNCHES = {"minitron-4b": attn_counts(wgmma=8), "zamba2-2.7b": attn_counts(simt=2),
                       "whisper-base": attn_counts(simt=24, wgmma=12)}
# Phase 16: the same train cells in the tp_sp and fsdp styles, in phase 15's
# world; the same attention launches (fsdp: a rank runs every head of half
# the rows).
TP16_STYLES = ("tp_sp", "fsdp")


def train_phase(style: str) -> int:
    return 15 if style == "tp" else 16


def tp_train_comm(style: str, n_layers: int) -> dict:
    """Collectives of one train step of minitron-4b at ``n_layers`` with
    remat on a (1, 2) mesh, (forward through the loss, the rest) by kind
    (``tests/test_torch_tp_styles.py`` holds the same counts on the CPU):
    L + 2 gathers of weights forward (a layer's, the embedding's, the
    head's), L more in the recompute, L + 2 reduce-scatters back. tp: 2L +
    4 g forward (wo, w_down, the embedding rows, the CE's 3) and L in the
    recompute (wo's), 2L + 1 f backward; all-reduces: the denominator, the
    loss, 3 norms, the global norm's 2. tp_sp adds L + 1 carry gathers
    forward (a layer's, the final norm's), L in the recompute, and L + 1
    split gathers back. fsdp has no g, f or carry collective, and every
    all-reduce runs over data and model."""
    n = n_layers
    if style == "fsdp":
        return {"forward": {"all_gather": n + 2, "all_reduce": 2},
                "rest": {"all_gather": n, "reduce_scatter": n + 2, "all_reduce": 10}}
    fwd = {"tp_all_reduce": 2 * n + 4, "all_gather": n + 2, "all_reduce": 1}
    rest = {"tp_all_reduce": n, "all_gather": n, "tp_copy_bwd": 2 * n + 1,
            "reduce_scatter": n + 2, "all_reduce": 6}
    if style == "tp_sp":
        fwd["seq_gather"] = n + 1
        rest.update(seq_gather=n, seq_split_bwd=n + 1)
    return {"forward": fwd, "rest": rest}


def tp15_batch(torch, cfg, device) -> dict:
    """A global train batch (seed 9): next-token labels, one masked,
    per-sample weights, stub frames for an encoder-decoder."""
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (TP15_BATCH, TP15_SEQ))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=device),
           "labels": torch.as_tensor(labels, device=device),
           "weights": torch.tensor([1.3, 0.0, 0.7, 2.0], device=device)}
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(2)
        out["frames"] = torch.randn((TP15_BATCH, cfg.enc_ctx, cfg.d_model), generator=gen,
                                    device=device)
    return out


def hold_train_blocks(torch, models, api, batch, model, opt, met, shardings,
                      tol: float = TP_F32_TOL) -> dict:
    """The unsharded train step of ``api`` on the global ``batch`` (weights
    drawn from seed 0, as the sharded run's), and this rank's blocks of the
    sharded step held against it by the port's parity rule: the loss within
    1e-5 relative, the grad norm, every leaf's first moment (the clipped
    gradient) and sqrt of its second within ``tol`` of the whole leaf's
    scale; the updated parameters within ``tol`` of scale where the
    gradient is above ``tol`` of its largest and above ``TP15_GRAD_FLOOR``,
    and an update's sign flipped only below that, on at most 2 % of the
    block.
    Fails on a miss; returns the worst errors."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    ref = api.init(0)
    p0 = {k: shardings[k].local(p).clone() for k, p in ref.named_parameters()}
    ref, ref_opt, ref_met = make_train_step(api, AdamWConfig(), total_steps=10)(
        ref, adamw_init(ref), batch)
    worst = {"loss_rel": abs(float(met["loss"]) - float(ref_met["loss"])) / abs(
        float(ref_met["loss"])), "grad_norm_rel": abs(float(met["grad_norm"]) - float(
            ref_met["grad_norm"])) / float(ref_met["grad_norm"]), "m": 0.0, "v_root": 0.0,
        "params": 0.0, "flip_share": 0.0}
    got = dict(model.named_parameters())
    for k, want in ref.named_parameters():
        sh, want = shardings[k], want.detach()
        m_full, v_root = ref_opt.m[k], ref_opt.v[k].sqrt()
        worst["m"] = max(worst["m"], float((opt.m[k] - sh.local(m_full)).abs().max())
                         / float(m_full.abs().max()))
        worst["v_root"] = max(worst["v_root"], float(
            (opt.v[k].sqrt() - sh.local(v_root)).abs().max()) / float(v_root.abs().max()))
        # The first update is lr g / (|g| + eps): where |g| is within a few
        # hundred eps of eps it magnifies a gradient's last ulps (a zero-init
        # norm's parameters are that update), so the parameters are held
        # where |g| is above tol of its largest and above 1e3 eps.
        grad = sh.local(m_full).abs() / (1.0 - AdamWConfig.b1)
        above = (grad > tol * m_full.abs().max() / (1.0 - AdamWConfig.b1)) & (
            grad > TP15_GRAD_FLOOR)
        p, w = got[k].detach(), sh.local(want)
        err = (p - w).abs()[above]
        if err.numel() and float(err.max()) / float(want.abs().max()) > worst["params"]:
            worst["params"] = float(err.max()) / float(want.abs().max())
            worst["params_leaf"] = k
        flips = torch.sign(p - p0[k]) != torch.sign(w - p0[k])
        if bool((flips & above).any()):
            fail(f"train step: {k}: an update above {tol} of the gradient's scale flipped sign")
        worst["flip_share"] = max(worst["flip_share"], float(flips.float().mean()))
    if worst["loss_rel"] > 1e-5 or worst["flip_share"] > 0.02 or max(
            worst[k] for k in ("grad_norm_rel", "m", "v_root", "params")) > tol:
        fail(f"train step against the unsharded one on the card: {worst} (limit {tol})")
    del ref, ref_opt, p0
    torch.cuda.empty_cache()
    return worst


def tp_train_cell(torch, models, configs, sharding, kernels, arch: str, layers: int, device,
                  mesh, style: str = "tp") -> dict:
    """One rank's train cell of phase 15 (``style`` tp) or 16 (tp_sp, fsdp)
    under ``mesh_context(mesh, style)``: one float32 step of the sharded
    model (weights from seed 0 drawn as blocks) on this rank's rows of the
    global batch, then each rank in turn runs the unsharded step on the
    card and holds its blocks (``hold_train_blocks``); then
    ``TP15_BF16_STEPS`` bf16 steps of a fresh sharded
    model: ms a step, collectives of the forward (through the loss) and of
    the rest of each step by kind (minitron-4b's exactly
    ``tp_train_comm``'s), exact attention launches a step, peak memory."""
    import torch.distributed as dist
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    base = tp_config(configs, arch, layers)
    batch = tp15_batch(torch, base, device)
    out = {"n_layers": base.n_layers}
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        out.setdefault("stage_s", {})[what] = time.perf_counter() - t0
    phase = train_phase(style)
    api = models.build_model(dataclasses.replace(base, compute_dtype="float32"), device=device)
    with sharding.mesh_context(mesh, style):
        model = api.init(0, mesh=mesh)
        opt = adamw_init(model)
        local = {k: sharding.local_rows(v, mesh) for k, v in batch.items()}
        reset_counts(*kernels)
        mark("f32 init")
        model, opt, met = make_train_step(api, AdamWConfig(), total_steps=10)(model, opt, local)
        out["f32_launches"] = all_counts(*kernels)
        float(met["loss"])
        mark("f32 step")
    shardings = {k: sharding.sharding_of(p) for k, p in model.named_parameters()}
    # Each rank's cached blocks go back to the card before any rank runs the
    # unsharded step: fsdp's float32 step peaks on whole float32 tables,
    # which a rank waiting its turn would otherwise keep (at minitron-4b's
    # 256,000 x 3,072 the other rank's unsharded step then runs out of
    # memory).
    torch.cuda.empty_cache()
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == dist.get_rank():
            out["f32_held"] = hold_train_blocks(torch, models, api, batch, model, opt, met,
                                                shardings)
            mark("f32 held")
    dist.barrier()
    out.update(f32_loss=float(met["loss"]), f32_grad_norm=float(met["grad_norm"]))
    del model, opt, met
    torch.cuda.empty_cache()

    api = models.build_model(base, device=device)
    forward = {}

    def loss(model, batch, _loss=api.loss):
        res = _loss(model, batch)
        forward.clear()
        forward.update(sharding.comm_counts)
        return res

    api = dataclasses.replace(api, loss=loss)
    step = make_train_step(api, AdamWConfig(), total_steps=10)
    ms, comm, launches, losses = [], [], [], []
    with sharding.mesh_context(mesh, style):
        model = api.init(0, mesh=mesh)
        opt = adamw_init(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TP15_BF16_STEPS):
            sharding.reset_comm_counts()
            reset_counts(*kernels)
            t = time.perf_counter()
            model, opt, met = step(model, opt, local)
            losses.append(float(met["loss"]))  # waits for the step
            ms.append((time.perf_counter() - t) * 1e3)
            launches.append(all_counts(*kernels))
            mark(f"bf16 step {len(ms)}")
            total = {k: v for k, v in sharding.comm_counts.items() if not k.endswith("_bytes")}
            fwd = {k: v for k, v in forward.items() if not k.endswith("_bytes")}
            comm.append({"forward": fwd, "rest": {k: v - fwd.get(k, 0) for k, v in total.items()
                                                  if v - fwd.get(k, 0)}})
    want = TP15_TRAIN_LAUNCHES[arch]
    for got in launches:
        if got != {k: want.get(k, 0) for k in got}:
            fail(f"phase {phase} train {style} {arch}: bf16 step launches {got}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase {phase} train {style} {arch}: bf16 losses {losses}")
    if arch == "minitron-4b" and any(c != tp_train_comm(style, base.n_layers) for c in comm):
        fail(f"phase {phase} train {style} {arch}: collectives {comm}, expected "
             f"{tp_train_comm(style, base.n_layers)}")
    out.update(bf16_ms=ms, bf16_losses=losses, bf16_comm=comm[-1], bf16_launches=launches[-1],
               bf16_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, opt
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 17: (a) a batch below dp on the card; (b) the dry run on its host
# --------------------------------------------------------------------------

# minitron-4b at 4 of 32 layers (its self cache's slots on data) and
# whisper-base whole (self and cross caches on data), served at B 1 by two
# gloo ranks on a (2, 1) mesh and held over 8 teacher-forced steps.
SPLIT_CELLS = (("minitron-4b", 4), ("whisper-base", 0))
SPLIT_SETUP = ServeSetup(batch=1, steps=8, model_parallel=1)
# Dry-run cells, each its own process on the host's CPU; their rooflines are
# projections from the H100 data sheet's constants.
DRYRUN_CELLS = (("whisper-base", "train_4k", "pod"), ("mixtral-8x7b", "long_500k", "pod"),
                ("minitron-4b", "decode_32k", "multipod"))
DRYRUN_TIMEOUT_S = 600


def _lower_priority() -> None:
    os.nice(10)


def start_dryrun() -> dict:
    """Start ``python -m repro_torch.launch.dryrun`` for every cell of
    ``DRYRUN_CELLS`` (one intra-op thread each, at a lower priority than
    this process); they are stopped when this process exits."""
    out = ROOT / "build" / "chip_smoke_dryrun"
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        procs[(arch, shape, mesh)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--out", str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, preexec_fn=_lower_priority)

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return {"procs": procs, "out": out, "t0": time.perf_counter(), "stop": stop}


def join_dryrun(started: dict) -> dict:
    """Each cell's ``OK`` line and record (fails on another line, a non-zero
    exit or ``DRYRUN_TIMEOUT_S`` after the start)."""
    deadline = started["t0"] + DRYRUN_TIMEOUT_S
    out = {}
    try:
        for (arch, shape, mesh), proc in started["procs"].items():
            try:
                stdout, stderr = proc.communicate(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                fail(f"phase 17 (b): the dry run of {arch} {shape} {mesh} did not finish in "
                     f"{DRYRUN_TIMEOUT_S} s")
            line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            if proc.returncode != 0 or not line.startswith("OK "):
                fail(f"phase 17 (b): dry run of {arch} {shape} {mesh} exited "
                     f"{proc.returncode}: {line}\n{stderr[-2000:]}")
            tag = f"{arch}_{shape}_{mesh}".replace(".", "_")
            rec = json.loads((started["out"] / f"{tag}.json").read_text())
            out[tag] = {"line": line, "route": rec["route"], "host_s": rec["compile_seconds"],
                        "memory": rec["memory"], "cost": rec["cost"],
                        "collectives_bytes": rec["collectives_bytes"],
                        "collective_calls_by_group": rec["collective_calls_by_group"],
                        "analytic_memory": rec["analytic_memory"], "roofline": rec["roofline"]}
    finally:
        started["stop"]()
    return out


def phase_tp(torch, serve, models, configs, kernels, cells=TP_CELLS, device="cuda:0",
             train_cells=(), phase: int = 14, train_styles=("tp",),
             setup: ServeSetup = TP_SETUP, expected=tp_expected) -> dict:
    """Phase 14: a world of two gloo ranks on the one card (NCCL refuses two
    ranks on one device), spawned after the main process frees its cached
    memory; each serves every cell through ``serve.main`` at model = 2 and
    decodes the check tokens. Then the main process serves each cell
    unsharded on the same card and holds the ranks' float32 logits within
    ``TP_F32_TOL`` of scale (greedy tokens and an MoE's expert choices
    equal) and their bf16 logits within ``FAMILY_BF16_TOL``: an MoE's rows
    up to the first step where the two sides' bf16 roundings pick another
    expert (a near tie of the router; the row's cache differs from there),
    the whole gap and the argmax agreement reported beside; exact launches
    of the serve run on each rank; exact collectives a step. Each rank then
    runs the train cells in each of ``train_styles`` (``tp_train_cell``).
    ``setup`` sets the batch, the check steps and the model axis (phase 17:
    B 1 on (2, 1)), ``expected`` the launches and collectives."""
    import gc
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.parallel import sharding
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = ROOT / "build" / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(tp_worker, args=(TP_WORLD, str(work), cells, device, train_cells,
                                              train_styles, setup),
                             nprocs=TP_WORLD, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                fail(f"phase {phase}: the {TP_WORLD} ranks did not finish in {TP_TIMEOUT_S} s")
    except mp.ProcessRaisedException as exc:
        fail(f"phase {phase}: a rank failed:\n{exc}")
    except mp.ProcessExitedException as exc:
        fail(f"phase {phase}: a rank exited: {exc}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(TP_WORLD)]
    shutil.rmtree(work, ignore_errors=True)
    out = {"world": TP_WORLD, "backend": ranks[0]["backend"], "device": device,
           "world_s": time.perf_counter() - t0, "cells": {},
           "train": {style: {arch: [r[f"train {style} {arch}"] for r in ranks]
                             for arch, _ in train_cells} for style in train_styles}}
    steps = TP_PROMPT + TP_GEN
    for arch, layers in cells:
        r0 = ranks[0][arch]
        want_launches, want_comm = expected(configs, arch, layers, steps, TP_WORLD)
        for rank, r in enumerate(ranks):
            got = r[arch]["launches"]
            if got != {k: want_launches.get(k, 0) for k in got}:
                fail(f"phase {phase} {arch} rank {rank}: serve launches {got}, expected "
                     f"{want_launches}")
            comm = {k: v for k, v in r[arch]["summary"]["collectives_per_step"].items()
                    if k.startswith(("tp_", "slot_"))}
            if comm != want_comm:
                fail(f"phase {phase} {arch} rank {rank}: collectives a step {comm}, expected "
                     f"{want_comm}")
            if r[arch]["summary"]["sample_tokens"] != r0["summary"]["sample_tokens"] or any(
                    not torch.equal(r[arch]["logits"][c], r0["logits"][c]) for c in r0["logits"]):
                fail(f"phase {phase} {arch}: rank {rank}'s gathered logits differ from rank 0's")
        # The same cell unsharded on the same card.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        single = serve.main(tp_argv(arch, layers, device, 1, setup.batch))
        single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ref = tp_checks(torch, configs, models, sharding, arch, layers, device, setup=setup)
        cdts = ("float32", "bfloat16")
        gaps = {c: rel_err(r0["logits"][c], ref[c])[1] for c in cdts}
        agree = {c: float((r0["logits"][c].argmax(-1) == ref[c].argmax(-1)).float().mean())
                 for c in cdts}
        rows = {c: tp_agreeing_rows(torch, r0["logits"], ref, c) for c in cdts}
        held = {c: rel_err(r0["logits"][c][rows[c]], ref[c][rows[c]])[1] for c in cdts}
        if not bool(rows["float32"].all()) or gaps["float32"] > TP_F32_TOL or \
                agree["float32"] != 1.0:
            fail(f"phase {phase} {arch}: float32 logits {gaps['float32']:.3e} of scale from the "
                 f"unsharded run (limit {TP_F32_TOL:.0e}), argmax agreement "
                 f"{agree['float32']:.4f}, routing equal {bool(rows['float32'].all())}")
        if held["bfloat16"] > FAMILY_BF16_TOL:
            fail(f"phase {phase} {arch}: bf16 logits {held['bfloat16']:.3e} of scale from the "
                 f"unsharded run (limit {FAMILY_BF16_TOL})")
        cfg = tp_config(configs, arch, layers)
        s = r0["summary"]
        out["cells"][arch] = {
            "n_layers": cfg.n_layers, "mesh": s["mesh"],
            "layout": "ssm" if cfg.family == "ssm" else "slots on data" if (
                setup.model_parallel == 1) else "seq" if cfg.n_kv_heads % TP_WORLD else "heads",
            "ms_per_decode_step": s["decode_s"] / steps * 1e3,
            "unsharded_ms_per_decode_step": single["decode_s"] / steps * 1e3,
            "tokens_per_s": s["tokens_per_s"], "unsharded_tokens_per_s": single["tokens_per_s"],
            "collectives_per_step": s["collectives_per_step"],
            "f32_err_of_scale": gaps["float32"], "bf16_err_of_scale": gaps["bfloat16"],
            "bf16_err_of_scale_same_experts": held["bfloat16"],
            "bf16_steps_same_experts": [int(rows["bfloat16"].sum()), rows["bfloat16"].numel()],
            "argmax_agreement": agree, "launches": r0["launches"],
            "lse_launches_per_step": r0["launches"].get("flash_attention_decode_lse", 0) / steps,
            "serve_peak_gib_per_rank": [r[arch]["serve_peak_gib"] for r in ranks],
            "unsharded_serve_peak_gib": single_peak}
        del ref
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# Phase 18: the other families trained at their published widths
# --------------------------------------------------------------------------

TRAIN18_STEPS = 4
TRAIN18_ARGV = list(TRAIN_ARGV)
TRAIN18_ARGV[TRAIN18_ARGV.index("--steps") + 1] = str(TRAIN18_STEPS)
TRAIN18_ARGV[TRAIN18_ARGV.index("--slot-every") + 1] = "2"
# arch -> layers kept (0: all). gemma2-27b (46 layers, 27 B parameters) and
# mixtral-8x7b (32 layers, 47 B) cannot train on one card at about 16 bytes a
# parameter (float32 weights, AdamW's m and v, the gradient): 4 layers of
# gemma2-27b (two local, two global) are 3.4 B parameters, 2 of
# mixtral-8x7b 3.2 B. falcon-mamba-7b whole is 7.0 B (104 GiB at 16 bytes a
# parameter); 32 of its 64 layers are 3.6 B (54 GiB). The other three train
# whole.
TRAIN18_CELLS = (("gemma2-27b", 4), ("mixtral-8x7b", 2), ("zamba2-2.7b", 0),
                 ("whisper-base", 0), ("paligemma-3b", 0), ("falcon-mamba-7b", 32))
# The quickstart's slots and its specs' matcher launches a slot: L-DS adds
# its virtual plain-P1 assignment and a second pairing; CU_FULL collects
# without a matcher.
QUICKSTART_SLOTS = 30  # the example's 60, halved for the script's time
QUICKSTART_PER_SLOT = {
    "ds": DS_PER_SLOT,
    "l-ds": {"greedy_collection": 1, "greedy_assignment": 1, "greedy_pairing": 2},
    "cufull": {"greedy_collection": 0, "greedy_assignment": 0, "greedy_pairing": 1}}


def train18_cell(torch, train, configs, kernels, arch: str, layers: int, total: int) -> dict:
    """``train.main`` on ``arch`` at its published widths (its first
    ``layers`` layers, registered as ``<arch>-<layers>l``, when not 0),
    B 16 x 128, 4 steps, DS every 2: the losses finite, the peak under
    TRAIN_MEMORY_SHARE of the card, exact launches (``train_launches`` of 4
    steps: attention and the scan's two kernels; DS's matchers per slot)."""
    import gc
    cfg = configs.get_config(arch)
    if layers:
        cfg = configs.register(dataclasses.replace(cfg, name=f"{arch}-{layers}l",
                                                   n_layers=layers))
    argv = list(TRAIN18_ARGV)
    argv[argv.index("--arch") + 1] = cfg.name
    batch, seq = (int(argv[argv.index(k) + 1]) for k in ("--batch", "--seq"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    summary = train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps, slots = len(summary["losses"]), summary["sched_slots"]
    want = {**train_launches(cfg, seq, steps),
            **{k: n * slots for k, n in DS_PER_SLOT.items()}}
    launched = expect_counts(kernels, f"{cfg.name} training", want)
    if steps != TRAIN18_STEPS or not all(math.isfinite(x) for x in summary["losses"]):
        fail(f"{cfg.name} training: losses {summary['losses']} are not {TRAIN18_STEPS} finite "
             f"values")
    if peak >= TRAIN_MEMORY_SHARE * total:
        fail(f"{cfg.name} training: peak {peak / 2 ** 30:.2f} GiB is at or above "
             f"{TRAIN_MEMORY_SHARE:.0%} of the card's {total / 2 ** 30:.2f} GiB: keep a layer "
             f"less")
    ms = sorted(summary["step_ms"][1:])[len(summary["step_ms"][1:]) // 2]
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": summary["n_layers"],
            "losses": summary["losses"], "step_ms": summary["step_ms"], "ms_per_step": ms,
            "tokens_per_s": batch * seq / (ms / 1e3), "run_s": run_s, "peak_bytes": peak,
            "peak_gib": peak / 2 ** 30, "peak_share": peak / total, "launches": launched,
            "attention_per_step": {k: v / steps for k, v in launched.items()
                                   if k.startswith("flash_")},
            "scan_per_step": {k: v / steps for k, v in launched.items()
                              if k.startswith("mamba1_scan")},
            "matcher_launches_per_slot": {k: launched[k] / slots for k in DS_PER_SLOT},
            "slots": slots, "sched_cost": summary["sched_cost"],
            "sched_trained": summary["sched_trained"]}


def quickstart_on_card(torch, kernels) -> dict:
    """``repro_torch.examples.quickstart.main`` on the card at 30 slots:
    exact matcher launches of its three runs, DS's unit cost below
    CU_FULL's (the example's claim); its printed spec lines kept."""
    import contextlib
    import io
    from repro_torch.examples import quickstart
    env = os.environ.get("COCKTAIL_EXAMPLE_SLOTS")
    os.environ["COCKTAIL_EXAMPLE_SLOTS"] = str(QUICKSTART_SLOTS)
    printed = io.StringIO()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            summaries = quickstart.main([])
    finally:
        if env is None:
            os.environ.pop("COCKTAIL_EXAMPLE_SLOTS")
        else:
            os.environ["COCKTAIL_EXAMPLE_SLOTS"] = env
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = {k: QUICKSTART_SLOTS * sum(QUICKSTART_PER_SLOT[name][k] for name in summaries)
            for k in DS_PER_SLOT}
    launched = expect_counts(kernels, "the quickstart", want)
    if sorted(summaries) != sorted(QUICKSTART_PER_SLOT) or any(
            s["slots"] != QUICKSTART_SLOTS for s in summaries.values()):
        fail(f"the quickstart ran {json.dumps({k: s['slots'] for k, s in summaries.items()})} "
             f"slots, expected {QUICKSTART_SLOTS} of each of {sorted(QUICKSTART_PER_SLOT)}")
    cost = {name: s["unit_cost"] for name, s in summaries.items()}
    if not (math.isfinite(cost["ds"]) and cost["ds"] < cost["cufull"]):
        fail(f"the quickstart on the card: DS's unit cost {cost['ds']} is not below "
             f"CU_FULL's {cost['cufull']}")
    lines = [ln for ln in printed.getvalue().splitlines() if "unit_cost=" in ln]
    return {"slots": QUICKSTART_SLOTS, "seconds": seconds, "unit_cost": cost,
            "skew_degree": {name: s["skew_degree"] for name, s in summaries.items()},
            "reduction_pct": 100 * (cost["cufull"] - cost["ds"]) / cost["cufull"],
            "launches": launched, "lines": lines}


def phase_train_families(torch, models, configs, steps, kernels, device: str = "cuda") -> dict:
    """Phase 18: ``train18_cell`` of every ``TRAIN18_CELLS`` arch, then
    each one's reduced train step card against CPU (``train_card_vs_cpu``),
    then the quickstart on the card."""
    from repro_torch import optim
    from repro_torch.launch import train
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"card_memory_bytes": total, "memory_share_limit": TRAIN_MEMORY_SHARE,
           "cells": {}, "card_vs_cpu": {}}
    for arch, layers in TRAIN18_CELLS:
        out["cells"][arch] = train18_cell(torch, train, configs, kernels, arch, layers, total)
    t0 = time.perf_counter()
    for arch, _ in TRAIN18_CELLS:
        out["card_vs_cpu"][arch] = train_card_vs_cpu(torch, models, configs, steps, optim,
                                                     kernels, arch, device)
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    out["quickstart"] = quickstart_on_card(torch, kernels)
    return out


def report_families(fam: dict, smi: str, t0: float) -> None:
    for arch, r in fam.items():
        print(f"phase 12 {arch} ({r['n_layers']} layers, {r['weights_gb']:.2f} GB of bf16 "
              f"weights) [{smi}]: " + json.dumps(
                  {k: r[k] for k in ("ms_per_decode_step", "tokens_per_s", "prefill_ms", "prefill_peak_gib", "check_peak_gib",
                                     "serve_peak_gib",
                                     "decode_busy_ms_per_step", "decode_busy_share",
                                     "decode_launches_per_step", "step_launches",
                                     "forward_launches", "prefill_launches", "serve_launches",
                                     "decode_vs_forward_err_of_scale", "argmax_agreement",
                                     "prefill_kernel_share",
                                     "prefill_busy_share", "init_s", "phase_s")}))
        print(f"phase 12 {arch} " + decode_gaps(r))
        fp, pp = r["forward_profile"], r["prefill_profile"]
        print(f"phase 12 {arch} attention share: forward {fp['kernel_share']:.4f} "
              f"({fp['match_ms']:.4f} of {fp['device_busy_ms']:.4f} ms), prefill "
              f"{r['prefill_kernel_share']:.4f} ({pp['match_ms']:.3f} of "
              f"{pp['device_busy_ms']:.3f} ms)")
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")


def decode_gaps(r: dict) -> str:
    """``phase_serve``'s three decode checks, each against its limit."""
    f32, pg = r["decode_vs_forward_f32"], r["decode_vs_plain_decode"]
    return (f"decode vs forward: bf16 {r['decode_vs_forward_err_of_scale']:.4e} of scale "
            f"(limit {r['decode_tol']}), float32 {f32['err_of_scale']:.4e} (limit "
            f"{F32_DECODE_TOL}); bf16 decode vs plain decode {pg['err_of_scale']:.4e} (limit "
            f"{r['decode_tol']}), argmax agreement {pg['argmax_agreement']:.4f}, "
            f"{r['decode_vs_forward_shape']}")


# --------------------------------------------------------------------------
# Phase 19: the paper's evaluation (repro_torch.paper) on the card
# --------------------------------------------------------------------------

# Fig. 7 keeps its 40 slots (the example's default); Figs. 5, 6, 8 and 9 run
# PAPER_SLOTS of their 60, and Fig. 9's EC_FULL PAPER_ECFULL_SLOTS (2.2 s a
# slot at 20 x 8 on the card: full_allocate's Python loops), for the
# script's time (the whole figures: ``python -m repro_torch.paper.paper_figs``).
PAPER_FIG7_SLOTS = 40
PAPER_SLOTS = 20
PAPER_ECFULL_SLOTS = 4
# The figures' N x M: the testbed, then Fig. 9's five points.
PAPER_SHAPES = ((6, 3), (20, 3), (20, 5), (20, 8), (10, 5), (40, 5))
# Matcher launches a slot by spec (core/datasche.py): the skew-aware
# collection launches greedy_collection, the plain one (NO-SDC, and L-DS's
# virtual step) greedy_assignment, CU_FULL's none; every training policy but
# ECFULL's and ECSELF's launches greedy_pairing once (L-DS's virtual linear
# step once more).
PAPER_PER_SLOT = {
    "ds": DS_PER_SLOT, "no-slt": DS_PER_SLOT, "no-lsa": DS_PER_SLOT,
    "no-sdc": {"greedy_collection": 0, "greedy_assignment": 1, "greedy_pairing": 1},
    "l-ds": QUICKSTART_PER_SLOT["l-ds"], "cufull": QUICKSTART_PER_SLOT["cufull"],
    "ecfull": {"greedy_collection": 1, "greedy_assignment": 0, "greedy_pairing": 0},
    "ecself": {"greedy_collection": 1, "greedy_assignment": 0, "greedy_pairing": 0}}
# The figures' checks in the JAX package's own run on the CPU (60 slots,
# Fig. 7 40, seed 0), printed beside the card's. The two packages' random
# streams differ and the card's figures are cut to PAPER_SLOTS, so these are
# findings, not gates; the card is held to the CPU by the matchers at the
# figures' shapes and by one slot of every run (``PaperRuns``).
PAPER_REFERENCE_CHECKS = {"fig7/ds_at_least_competitive": "true", "fig5/ds_most_even": "false",
                          "fig6/ds_mean_below_ablations": "true", "fig8/theory_checks": "3/3",
                          "fig9/max_cost_reduction_vs_cufull_pct": "19.1"}
PAPER_TRAIN_TOL = 1e-5  # of each leaf's scale: one train_batch, card against CPU
PAPER_SLOT_TOL = 1e-5  # of each tensor's scale: one slot, card against CPU (phase 4's)


def paper_matchers(torch, ops, kernels) -> dict:
    """The three matchers on the card against their plain versions at the
    figures' shapes (collection and assignment N x M, pairing M x M) in
    phase 2's cases; fails unless bit-equal. Returns the cases checked by
    kernel."""
    checked = {}
    for idx, op in enumerate(("collection", "assignment", "pairing")):
        shapes = sorted({(m, m) if op == "pairing" else (n, m) for n, m in PAPER_SHAPES})
        for shape in shapes:
            for c, case in enumerate(MATCHER_CASES + MATCHER_EXTRA_CASES[op]):
                args, masks = kernel_inputs(torch, op, shape, case,
                                            1000 * idx + 10 * c + 64 * shape[0] + shape[1])
                got = op_call(ops, op, args, masks, "kernel")
                want = op_call(ops, op, args, masks, "ref")
                if not torch.equal(got, want):
                    fail(f"phase 19: greedy_{op} differs from its plain version at {shape} "
                         f"({case}): max abs err {float((got - want).abs().max())}")
                checked[f"greedy_{op}"] = checked.get(f"greedy_{op}", 0) + 1
    reset_counts(*kernels)
    return checked


class PaperRuns:
    """Stands in for ``paper_figs.timed_run``: the matcher launches of each
    run are counted around it (exactly ``PAPER_PER_SLOT`` of its spec times
    its slots, no other kernel), its ms a slot kept; then one more slot of
    its final state runs on the card and on the CPU (once per config and
    spec): decisions bit-equal, every other tensor within PAPER_SLOT_TOL of
    its scale."""

    def __init__(self, torch, core, bridge, kernels, timed_run):
        self.torch, self.core, self.bridge = torch, core, bridge
        self.kernels, self.timed_run = kernels, timed_run
        self.figure, self.runs, self.slot_err, self.in_run = None, [], {}, False

    def __call__(self, cfg, spec, slots, device):
        reset_counts(*self.kernels)
        self.in_run = True
        st, us = self.timed_run(cfg, spec, slots, device)
        self.in_run = False
        what = f"phase 19 {self.figure} {spec.name} at {cfg.n_cu} x {cfg.n_ec}, eps {cfg.eps}"
        counts = expect_counts(self.kernels, what, {k: v * slots for k, v in
                                                    PAPER_PER_SLOT[spec.name].items()})
        self.runs.append({"figure": self.figure, "shape": [cfg.n_cu, cfg.n_ec], "eps": cfg.eps,
                          "spec": spec.name, "slots": slots, "ms_per_slot": us / 1e3,
                          "launches": {k: counts[k] for k in DS_PER_SLOT}})
        key = f"{cfg.n_cu}x{cfg.n_ec}/eps{cfg.eps}/{spec.name}"
        if key not in self.slot_err:
            self.slot_err[key] = self.card_vs_cpu(cfg, spec, st, what)
        reset_counts(*self.kernels)
        return st, us

    def card_vs_cpu(self, cfg, spec, st, what: str) -> float:
        torch, core, bridge = self.torch, self.core, self.bridge
        net = core.slot_network(cfg, st)
        new_c, rec_c, dec_c = core.step(cfg, spec, st, net)
        to_cpu = lambda t: bridge.from_numpy(bridge.to_numpy(t), "cpu")  # noqa: E731
        new_p, rec_p, dec_p = core.step(cfg, spec, to_cpu(st), to_cpu(net))
        for f in ("alpha", "theta", "z"):
            if not torch.equal(getattr(dec_c, f).cpu(), getattr(dec_p, f)):
                fail(f"{what}: the next slot's decision {f} differs between the card and the CPU")
        pairs = [(f"dec.{f}", getattr(dec_c, f), getattr(dec_p, f)) for f in ("x", "y")]
        pairs += [(f"rec.{f}", getattr(rec_c, f), getattr(rec_p, f)) for f in rec_c._fields]
        pairs += [(f"{g}.{f}", getattr(getattr(new_c, g), f), getattr(getattr(new_p, g), f))
                  for g in ("queues", "mults", "emp_mults") for f in getattr(new_c, g)._fields]
        worst = 0.0
        for name, a, b in pairs:
            err = float((a.double().cpu() - b.double()).abs().max()) / (
                float(b.abs().max()) or 1.0)
            if err > PAPER_SLOT_TOL:
                fail(f"{what}: the next slot's {name} differs between the card and the CPU by "
                     f"{err:.3e} of its scale (limit {PAPER_SLOT_TOL})")
            worst = max(worst, err)
        return worst


def figure_output(what: str, fn, *args):
    """``fn(*args)``, its printed lines echoed under ``phase 19 <what>``.
    Returns (fn's result, {line name: (us a call, derived)}, seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    seconds = time.perf_counter() - t0
    emitted = {}
    for line in buf.getvalue().splitlines():
        print(f"phase 19 {what}: {line}")
        parts = line.split(",", 2)
        if len(parts) == 3 and parts[0].startswith("fig"):
            emitted[parts[0]] = (float(parts[1]), parts[2])
    return result, emitted, seconds


def all_finite(values) -> bool:
    """Every number in ``values`` (a number, a sequence of numbers, or a
    dict of these or of dicts) is finite."""
    if isinstance(values, dict):
        return all(all_finite(v) for v in values.values())
    return bool(np.all(np.isfinite(np.asarray(values, dtype=np.float64))))


def paper_train_batch(torch, fig7, device: str = "cuda") -> dict:
    """One ``train_batch`` of the Fig. 7 model from the same seeded weights
    on ``device`` and on the CPU, on one numpy-seeded batch of ``BATCH``
    records: loss and every leaf within PAPER_TRAIN_TOL of its scale; ms a
    call on ``device`` (CUDA events) and on the CPU (host clock)."""
    rng = np.random.default_rng(0)
    batch = (rng.uniform(0.0, 1.0, (fig7.BATCH, 4)).astype(np.float32),
             rng.uniform(0.2, 0.8, fig7.BATCH).astype(np.float32),
             np.ones(fig7.BATCH, np.float32))
    models, args, losses = {}, {}, {}
    for dev in (device, "cpu"):
        models[dev] = fig7.TrafficMLP(generator=torch.Generator().manual_seed(0), device=dev)
        args[dev] = [torch.as_tensor(a, device=dev) for a in batch]
        losses[dev] = float(fig7.train_batch(models[dev], *args[dev]))
    cpu = dict(models["cpu"].named_parameters())
    errs = {name: float((p.detach().cpu() - cpu[name].detach()).abs().max()
                        / cpu[name].detach().abs().max())
            for name, p in models[device].named_parameters()}
    errs["loss"] = abs(losses[device] - losses["cpu"]) / abs(losses["cpu"])
    if not (all_finite(losses) and max(errs.values()) <= PAPER_TRAIN_TOL):
        fail(f"phase 19 (a): train_batch on the card against the CPU: losses {losses}, "
             f"errors of scale {errs} (limit {PAPER_TRAIN_TOL})")
    ms = cuda_ms(torch, lambda: fig7.train_batch(models[device], *args[device]), reps=50,
                 warmup=5)
    t0 = time.perf_counter()
    for _ in range(20):
        fig7.train_batch(models["cpu"], *args["cpu"])
    return {"losses": losses, "max_err_of_scale": max(errs.values()), "errs_of_scale": errs,
            "ms": ms, "cpu_ms": (time.perf_counter() - t0) / 20 * 1e3}


def phase_paper(torch, core, bridge, ops, kernels, training_alloc,
                device: str | None = None) -> dict:
    """Phase 19: the matchers at the figures' shapes (``paper_matchers``);
    (a) ``examples.traffic_prediction`` (Fig. 7) at its 40 slots, each
    spec's matcher launches counted around its ``step`` calls, and one
    ``train_batch`` card against CPU; (b) Figs. 5, 6 and 8 at PAPER_SLOTS;
    (c) ``fig9_point`` of DS, EC_SELF and CU_FULL at each point at
    PAPER_SLOTS, then of EC_FULL at PAPER_ECFULL_SLOTS, ``full_allocate``
    timed there (a synchronise on each side), and the headline reduction.
    Every run of (b) and (c) goes through ``PaperRuns``. Finite values
    throughout; the checks are returned as findings. The figures run on
    ``device`` (the entry points' default, the card, when None)."""
    from repro_torch.core import CU_FULL, DS, EC_FULL, EC_SELF
    from repro_torch.examples import traffic_prediction
    from repro_torch.paper import common, fig7_accuracy, paper_figs
    out = {"fig7_slots": PAPER_FIG7_SLOTS, "slots": PAPER_SLOTS,
           "ecfull_slots": PAPER_ECFULL_SLOTS, "figures": {}, "checks": {}}
    t0 = time.perf_counter()
    out["matchers"] = paper_matchers(torch, ops, kernels)
    out["matchers_s"] = time.perf_counter() - t0

    fig7_counts = {}
    real_step = fig7_accuracy.step

    def counted_step(cfg, spec, st, **kw):
        res = real_step(cfg, spec, st, **kw)
        counts = fig7_counts.setdefault(spec.name, {})
        for k, v in all_counts(*kernels).items():
            counts[k] = counts.get(k, 0) + v
        reset_counts(*kernels)
        return res

    reset_counts(*kernels)
    with mock.patch.dict(os.environ, COCKTAIL_EXAMPLE_SLOTS=str(PAPER_FIG7_SLOTS)), \
            mock.patch.object(fig7_accuracy, "step", counted_step):
        accs, emitted, seconds = figure_output("fig7", traffic_prediction.main,
                                               ["--device", device] if device else [])
    torch.cuda.synchronize()
    expect_counts(kernels, "phase 19 (a) outside the scheduler's steps", {})
    if sorted(accs) != sorted(s.name for s in fig7_accuracy.SPECS) or any(
            len(a) != PAPER_FIG7_SLOTS // fig7_accuracy.EVAL_EVERY or not all_finite(a)
            or not all(0.0 <= x <= 1.0 for x in a) for a in accs.values()):
        fail(f"phase 19 (a): Fig. 7's accuracies {json.dumps(accs)}")
    runs7 = []
    for name, counts in fig7_counts.items():
        want = {k: PAPER_PER_SLOT[name].get(k, 0) * PAPER_FIG7_SLOTS for k in counts}
        if counts != want:
            fail(f"phase 19 (a) {name}: launches {counts}, expected {want}")
        runs7.append({"figure": "fig7", "shape": [6, 3], "eps": 0.1, "spec": name,
                      "slots": PAPER_FIG7_SLOTS,
                      "ms_per_slot": emitted[f"fig7/accuracy/{name}"][0] / 1e3,
                      "launches": {k: counts[k] for k in DS_PER_SLOT}})
    out["figures"]["fig7"] = {"seconds": seconds, "values": accs}
    out["checks"].update({k: v[1] for k, v in emitted.items() if k in PAPER_REFERENCE_CHECKS})
    out["train_batch"] = paper_train_batch(torch, fig7_accuracy, device or "cuda")

    runs = PaperRuns(torch, core, bridge, kernels, paper_figs.timed_run)
    with mock.patch.object(paper_figs, "timed_run", runs):
        for name, fn in (("fig5", paper_figs.fig5_collection_evenness),
                         ("fig6", paper_figs.fig6_training_evenness),
                         ("fig8", paper_figs.fig8_ds_vs_lds)):
            runs.figure = name
            vals, emitted, seconds = figure_output(name, fn, device, PAPER_SLOTS)
            if not all_finite(vals):
                fail(f"phase 19 (b) {name}: values {vals}")
            out["figures"][name] = {"seconds": seconds}
            out["checks"].update({k: v[1] for k, v in emitted.items()
                                  if k in PAPER_REFERENCE_CHECKS})

        runs.figure = "fig9"
        costs, t9 = {}, time.perf_counter()
        for key, n_cu, n_ec in paper_figs.FIG9_POINTS:
            costs[key], _, _ = figure_output("fig9", paper_figs.fig9_point,
                                             common.sim_config(n_cu, n_ec), key,
                                             (DS, EC_SELF, CU_FULL), device, PAPER_SLOTS)
        out["figures"]["fig9"] = {"seconds": time.perf_counter() - t9}

        timing = {}
        full_allocate = training_alloc.full_allocate

        def timed_full_allocate(beta, *args, **kw):
            if not runs.in_run:  # the slot held against the CPU
                return full_allocate(beta, *args, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = full_allocate(beta, *args, **kw)
            torch.cuda.synchronize()
            key = "x".join(str(s) for s in beta.shape[-2:])
            timing.setdefault(key, []).append(time.perf_counter() - t)
            return res

        runs.figure, t9 = "fig9_ecfull", time.perf_counter()
        with mock.patch.object(training_alloc, "full_allocate", timed_full_allocate):
            for key, n_cu, n_ec in paper_figs.FIG9_POINTS:
                costs[key].update(figure_output("fig9_ecfull", paper_figs.fig9_point,
                                                common.sim_config(n_cu, n_ec), key, (EC_FULL,),
                                                device, PAPER_ECFULL_SLOTS)[0])
        out["figures"]["fig9_ecfull"] = {"seconds": time.perf_counter() - t9}
    if not all_finite(costs):
        fail(f"phase 19 (c) fig9: unit costs {costs}")
    # Fig. 9's headline, as fig9_unit_cost computes it.
    reduction = max(100 * (c["cufull"] - c["ds"]) / c["cufull"] for c in costs.values())
    out["checks"]["fig9/max_cost_reduction_vs_cufull_pct"] = f"{reduction:.1f}"
    out["fig9_costs"] = costs
    calls = {k: len(v) for k, v in timing.items()}
    if sorted(calls.values()) != [PAPER_ECFULL_SLOTS] * len(paper_figs.FIG9_POINTS):
        fail(f"phase 19 (c): full_allocate calls {json.dumps(calls)}, expected "
             f"{PAPER_ECFULL_SLOTS} at each of {len(paper_figs.FIG9_POINTS)} points")
    ecfull_ms = {"x".join(map(str, r["shape"])): r["ms_per_slot"] for r in runs.runs
                 if r["figure"] == "fig9_ecfull"}
    out["full_allocate"] = {
        "ms_per_call": {k: 1e3 * sum(v) / len(v) for k, v in timing.items()},
        "ecfull_ms_per_slot": ecfull_ms,
        "share_of_ecfull_slots": 1e3 * sum(sum(v) for v in timing.values())
        / (PAPER_ECFULL_SLOTS * sum(ecfull_ms.values()))}
    out["runs"] = runs7 + runs.runs
    out["slot_err"] = runs.slot_err
    out["launches"] = {}
    for r in out["runs"]:
        fig = out["launches"].setdefault(r["figure"], dict.fromkeys(DS_PER_SLOT, 0))
        for k in DS_PER_SLOT:
            fig[k] += r["launches"][k]
    return out
def report_paper(paper: dict, smi: str, t0: float) -> None:
    m = paper["matchers"]
    print(f"phase 19 matchers at the figures' N x M {list(PAPER_SHAPES)} (pairing M x M), "
          f"phase 2's cases: {json.dumps(m)} checks, all bit-equal to the plain versions "
          f"({paper['matchers_s']:.1f} s)")
    for fig, f in paper["figures"].items():
        runs = " | ".join(
            f"{r['spec']} {r['shape'][0]}x{r['shape'][1]} eps {r['eps']} {r['ms_per_slot']:.3f} "
            f"ms/slot {json.dumps([r['launches'][k] for k in DS_PER_SLOT])}"
            for r in paper["runs"] if r["figure"] == fig)
        slots = {"fig7": paper["fig7_slots"], "fig9_ecfull": paper["ecfull_slots"]}.get(
            fig, paper["slots"])
        print(f"phase 19 {fig}, {slots} slots, {f['seconds']:.1f} s [{smi}] (ms a slot, "
              f"launches of {', '.join(DS_PER_SLOT)}): {runs}")
    checks = "; ".join(f"{name} {v} (JAX on the CPU: {PAPER_REFERENCE_CHECKS[name]})"
                       for name, v in paper["checks"].items())
    print(f"phase 19 checks (findings, not gates): {checks}")
    errs = paper["slot_err"]
    print(f"phase 19 one more slot of each run, card vs CPU: decisions bit-equal in "
          f"{len(errs)} config x spec pairs, largest other gap {max(errs.values()):.3e} of "
          f"scale (limit {PAPER_SLOT_TOL})")
    tb = paper["train_batch"]
    print(f"phase 19 (a) train_batch card vs CPU: {tb['max_err_of_scale']:.3e} of scale (limit "
          f"{PAPER_TRAIN_TOL:.0e}), {tb['ms']:.4f} ms a call on the card, {tb['cpu_ms']:.4f} "
          f"on the CPU; accuracies {json.dumps(paper['figures']['fig7']['values'])}")
    fa = paper["full_allocate"]
    print(f"phase 19 (c) unit costs {json.dumps(paper['fig9_costs'])}; full_allocate ms a call "
          f"by N x M {json.dumps(fa['ms_per_call'])}; EC_FULL ms a slot "
          f"{json.dumps(fa['ecfull_ms_per_slot'])}; full_allocate "
          f"{100 * fa['share_of_ecfull_slots']:.1f} % of the EC_FULL slots (a synchronise on "
          f"each side of each call)")
    print(f"phase 19 matcher launches by figure: {json.dumps(paper['launches'])}")
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s (cut: Figs. 5, 6, 8 and 9 at "
          f"{paper['slots']} of their 60 slots, Fig. 9's EC_FULL at {paper['ecfull_slots']}; "
          f"Fig. 7 at its {paper['fig7_slots']})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write every measurement to this JSON file")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import bridge, configs, core, models
    from repro_torch.core import metrics, network, training_alloc
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan import ref as sref
    from repro_torch.kernels.matching import kernel, ops, ref
    from repro_torch.launch import serve, steps

    # Float32 products in full float32 on the card, as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # One build per library (one nvcc per source, then a link), all started
    # together; phase 1 waits for the matchers, phase 3 for the other two.
    def timed_build(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    pool = ThreadPoolExecutor(max_workers=3)
    builds = {name: pool.submit(timed_build, mod.build) for name, mod in
              (("greedy_matching", kernel), ("flash_attention", fkernel),
               ("mamba1_scan", skernel))}
    build_s = builds["greedy_matching"].result()
    print(f"phase 1 build: {build_s:.1f} s")

    t0 = time.perf_counter()
    kres = phase_kernels(torch, ops, kernel, ref)
    print(f"phase 2 kernels vs plain: all bit-equal ({time.perf_counter() - t0:.1f} s)")
    for op, r in kres.items():
        for label, tm in r["timing"].items():
            print(f"phase 2 greedy_{op} {label} {tm['shape']} ({tm['variant']}): device "
                  f"{tm['device_ms']:.5g} ms ({tm['device_us_per_selection']:.5g} us a step), "
                  f"event {tm['ms']:.5g} ms, {tm['selections']} selections, bound "
                  f"{tm['bound_ms']:.4g} ms, plain {tm['plain_ms']:.5g} ms")
    matcher_regs = matcher_ptxas(kernel)
    print(f"phase 2 matcher kernels (ptxas registers and spills): {json.dumps(matcher_regs)}")
    # Phase 3 times host-bound loops on the host clock: the builds must not
    # share the CPU with them.
    lm_build_s = {name: builds[name].result() for name in ("flash_attention", "mamba1_scan")}
    pool.shutdown()

    t0 = time.perf_counter()
    sampler = phase_sampler(torch, core, network)
    print(f"phase 3 keyed sampler on the card: {json.dumps(sampler)}")
    cfg, main_res, final = phase_main_path(torch, core, kernel, metrics)
    train_ms = time_training(torch, core, training_alloc, cfg, *final["l-ds"])
    for name, r in main_res.items():
        print(f"phase 3 {name} {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: {r['ms_per_slot']:.1f} ms/slot, "
              f"unit_cost {r['unit_cost']:.4f}, skew_degree {r['skew_degree']:.6f}, "
              f"launches {r['launches']}")
    print(f"phase 3 training solvers of one L-DS slot (ms): {json.dumps(train_ms)}")
    prof = phase_profile(torch, core, cfg, final["l-ds"][0], main_res)
    for name, r in prof.items():
        print(f"phase 3 {name} profile: device busy {r['device_busy_ms']:.2f} ms of "
              f"{r['slot_ms']:.1f} ms/slot ({100 * r['busy_share']:.2f} %), "
              f"{r['device_launches']} launches")
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    parity = phase_parity(torch, core, bridge, cfg, *final["l-ds"])
    print(f"phase 4 CUDA vs CPU slots: {json.dumps(parity)} ({time.perf_counter() - t0:.1f} s)")
    # Phase 17 (b) is host work: it runs beside the card's phases from here
    # (after the host-clock timings of phases 3-4), at a lower priority.
    dryruns = start_dryrun()

    print(f"phase 5 build (started with phase 1, seconds each): {json.dumps(lm_build_s)}")
    from repro_torch.kernels import _build
    sass = wgmma_sass(fkernel, _build.cuda_tool)
    print(f"phase 5 wgmma kernel SASS (HGMMA instructions, ptxas registers and spills): "
          f"{json.dumps(sass)}")
    decode_regs = decode_ptxas(fkernel)
    print(f"phase 5 decode attention kernel (ptxas registers and spills per instance "
          f"<type, padded hd, rows>): {json.dumps(decode_regs)}")
    simt_regs = simt_ptxas(fkernel)
    print(f"phase 5 SIMT attention kernel (ptxas registers and spills per instance "
          f"<type, padded hd, rows a block>): {json.dumps(simt_regs)}")
    scan_regs = scan_ptxas(skernel)
    print(f"phase 5 scan kernel (ptxas registers and spills per instance <type, G>): "
          f"{json.dumps(scan_regs)}")
    scan_bwd_regs = scan_bwd_ptxas(skernel)
    print(f"phase 5 scan backward kernel (ptxas registers and spills per instance <type, G>): "
          f"{json.dumps(scan_bwd_regs)}")

    t0 = time.perf_counter()
    lm_kres = phase_lm_kernels(torch, fops, fref, fkernel, sops, skernel)
    for kname, cases in lm_kres.items():
        print(f"phase 6 {kname} vs plain: " + json.dumps(
            {c: {k: r[k] for k in ("err_of_scale", "state_err_of_scale", "ms", "device_ms",
                                   "simt_ms", "simt_device_ms", "n_split", "rows", "plain_ms",
                                   "bound_ms", "library_ms", "library_device_ms") if k in r}
             for c, r in cases.items()}))
    scan_bwd = phase_scan_bwd(torch, skernel, sref)
    print("phase 6 mamba1_scan_bwd vs plain: " + json.dumps(
        {c: {k: r[k] for k in ("err_of_scale", "grad_err_of_scale", "ms", "device_ms",
                               "sweep_device_ms", "walk_device_ms", "reduce_device_ms",
                               "forward_ms", "plain_ms", "bound_ms", "bound_by") if k in r}
         for c, r in scan_bwd.items()}))
    lse_res = phase_lse(torch, fops, fref, fkernel)
    print("phase 6 flash_attention_decode_lse vs plain: " + json.dumps(
        {c: {k: r[k] for k in ("err_of_scale", "lse_rel_err", "lse_err_of_scale", "n_split",
                               "ms", "event_ms", "plain_ms", "bound_ms", "rows_seeing_no_key")}
         for c, r in lse_res.items()}))
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    all_kernels = (kernel, fkernel, skernel)
    serve_res = {}
    # The B 4 x 2048 bf16 prefill takes the wgmma kernel in each of
    # minitron-4b's 32 layers, and every decode step (the serve run
    # prefills by decode) the decode kernel, each counted under its own name
    # and under flash_attention; the 16-token forward takes the SIMT one.
    n_mini = configs.get_config("minitron-4b").n_layers
    n_falcon = configs.get_config("falcon-mamba-7b").n_layers
    for phase, arch, counts, forward_kernel in (
            (7, "minitron-4b",
             {"step": {"flash_attention": n_mini, "flash_attention_decode": n_mini},
              "forward": {"flash_attention": n_mini},
              "prefill": {"flash_attention": n_mini, "flash_attention_wgmma": n_mini}},
             "flash_fwd_kernel"),
            (8, "falcon-mamba-7b", {name: {"mamba1_scan": n_falcon}
                                    for name in ("step", "forward", "prefill")},
             "mamba1_scan_kernel")):
        t0 = time.perf_counter()
        serve_res[arch] = r = phase_serve(torch, arch, serve, steps, models, configs.get_config,
                                          all_kernels, counts, forward_kernel,
                                          long_cache=phase == 7)
        print(f"phase {phase} {arch}: " + json.dumps(
            {k: r[k] for k in ("tokens_per_s", "ms_per_decode_step", "prefill_ms",
                               "decode_vs_forward_err_of_scale", "argmax_agreement",
                               "decode_busy_share", "decode_launches_per_step",
                               "prefill_busy_share", "serve_launches", "prefill_launches",
                               "prefill_peak_gib",
                               "init_s")})
            + f" ({time.perf_counter() - t0:.1f} s)")
        print(f"phase {phase} {arch} " + decode_gaps(r))
        for window in ("forward_profile", "decode_profile", "prefill_profile"):
            print(f"phase {phase} {arch} {window}: " + json.dumps(r[window]))
        if "long_cache" in r:
            print(f"phase {phase} {arch} decode step over {LONG_CACHE} positions: "
                  + json.dumps({k: v for k, v in r["long_cache"].items() if k != "ms_steps"}))

    t0 = time.perf_counter()
    lm_parity = phase_lm_parity(torch, models, configs, all_kernels)
    print(f"phase 9 reduced models, card vs CPU: {json.dumps(lm_parity)} "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    fleet = phase_fleet(torch, core, kernel, bridge, metrics)
    for name, r in fleet["homogeneous"].items():
        print(f"phase 10 fleet {name} {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}: "
              f"{r['ms_per_fleet_slot']:.1f} ms per fleet slot, "
              f"{r['ms_per_slice_slot']:.2f} ms per slice-slot, device busy "
              f"{r['device_busy_ms_per_fleet_slot']:.2f} ms and "
              f"{r['device_launches_per_fleet_slot']} launches per fleet slot, peak "
              f"{r['peak_memory_gib']:.3f} GiB, matcher launches per run {r['launches']}")
    for key in ("parity", "card_vs_cpu_slot", "ragged", "mixed_policy"):
        print(f"phase 10 fleet {key}: {json.dumps(fleet[key])}")
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    trn = phase_train(torch, models, configs, steps, all_kernels, fkernel, fops, fref, sops,
                      skernel)
    full = trn["full"]
    print(f"phase 11 train minitron-4b, {full['summary']['n_layers']} layers, B 16 x 128: "
          f"{full['ms_per_step']:.2f} ms per step (steps 2-8), {full['tokens_per_s']:.1f} "
          f"tokens/s, peak {full['peak_gib']:.2f} GiB ({100 * full['peak_share']:.1f} % of "
          f"the card), wgmma launches per step {full['wgmma_per_step']:.0f}, matcher "
          f"launches per slot {json.dumps(full['matcher_launches_per_slot'])} [{smi}]")
    print(f"phase 11 losses: {json.dumps(full['summary']['losses'])}; step ms: "
          f"{json.dumps(full['step_ms'])}")
    prof = trn["profile"]
    print(f"phase 11 one profiled train step: device busy {prof['device_busy_ms']:.2f} ms of "
          f"{prof['unprofiled_step_ms']:.2f} ms ({100 * prof['busy_share_of_unprofiled_step']:.1f} "
          f"%), {prof['device_launches']} launches, wgmma {prof['match_ms']:.3f} ms in "
          f"{prof['match_count']} launches; spans (events) {json.dumps(prof['spans'])}; "
          f"top {json.dumps(prof['top'])}")
    pm = trn["profile_mesh"]
    print(f"phase 11 the same step under the (1, 1) mesh: {pm['unprofiled_step_ms']:.2f} ms "
          f"(median of {json.dumps(pm['step_ms'])}; unsharded {prof['unprofiled_step_ms']:.2f}, "
          f"median of {json.dumps(prof['step_ms'])}), device busy {pm['device_busy_ms']:.2f} ms "
          f"(unsharded {prof['device_busy_ms']:.2f}), {pm['device_launches']} launches, NCCL "
          f"kernels {pm['match_ms']:.3f} ms in {pm['match_count']} [{smi}]")
    for key in ("card_vs_cpu", "resume", "attention", "scan"):
        print(f"phase 11 {key}: {json.dumps(trn[key])}")
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fam = phase_families(torch, serve, steps, models, configs, all_kernels)
    report_families(fam, smi, t0)

    t0 = time.perf_counter()
    from repro_torch import optim
    from repro_torch.launch import train
    dst = phase_distributed(torch, train, steps, optim, models, configs, core, bridge,
                            all_kernels, kernel)
    print(f"phase 13 world {dst['world']}, backend {dst['backend']}, meshes "
          f"{json.dumps(dst['mesh'])} and {json.dumps(dst['pod_mesh'])}")
    for dt, r in dst["cross_pod"].items():
        print(f"phase 13 (a) int8 cross-pod sum {dt} {r['shape']}: bit-equal to the plain pack, "
              f"{r['all_gathers']} all-gathers, {r['wire_bytes']} bytes sent, {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f} ms) [{smi}]")
    tr = dst["train"]
    print(f"phase 13 (b) train.main minitron-4b {tr['layers']} layers B 16 x 128 under the mesh: "
          f"{tr['mesh_ms_per_step']:.2f} ms per step, unsharded {tr['unsharded_ms_per_step']:.2f} "
          f"ms (steps 2-{tr['steps']}, deterministic algorithms), losses and parameters bit-equal; "
          f"collectives per step {json.dumps(tr['per_step'])} [{smi}]")
    for label, pr in tr["profile"].items():
        print(f"phase 13 (b) one profiled {label} step: device busy {pr['device_busy_ms']:.2f} ms "
              f"of {pr['wall_ms']:.2f} ms, {pr['device_launches']} launches, NCCL kernels "
              f"{pr['match_ms']:.3f} ms in {pr['match_count']}; top {json.dumps(pr['top'])}")
    for name, r in dst["fleet"].items():
        print(f"phase 13 (c) fleet {name} K {r['k']} x {MAIN_SHAPE[0]}x{MAIN_SHAPE[1]}, "
              f"{r['slots']} slots: bit-equal to run(), launches {json.dumps(r['launches'])}, "
              f"{r['mesh_ms']:.1f} ms with the mesh, {r['plain_ms']:.1f} ms without [{smi}]")
    print("phase 13 (d) a pod mesh of one rank has no pod peers: (a) runs the NCCL path; the "
          "numerics across ranks are the CPU tests'")
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tp = phase_tp(torch, serve, models, configs, all_kernels)
    print(f"phase 14 tensor-parallel serving: {tp['world']} {tp['backend']} ranks on "
          f"{tp['device']}, mesh data 1 x model {tp['world']} [{smi}]")
    for arch, r in tp["cells"].items():
        print(f"phase 14 {arch} ({r['n_layers']} layers, {r['layout']}): "
              f"{r['ms_per_decode_step']:.3f} ms per decode step (unsharded "
              f"{r['unsharded_ms_per_decode_step']:.3f}), collectives per step "
              f"{json.dumps(r['collectives_per_step'])}, float32 {r['f32_err_of_scale']:.3e} / "
              f"bf16 {r['bf16_err_of_scale']:.3e} of scale from unsharded (bf16 "
              f"{r['bf16_err_of_scale_same_experts']:.3e} over the "
              f"{r['bf16_steps_same_experts'][0]} of {r['bf16_steps_same_experts'][1]} row-steps "
              f"before an expert choice flips), argmax agreement "
              f"{json.dumps(r['argmax_agreement'])}, serve peak GiB per rank "
              f"{json.dumps([round(x, 3) for x in r['serve_peak_gib_per_rank']])} (unsharded "
              f"{r['unsharded_serve_peak_gib']:.3f}), launches {json.dumps(r['launches'])}")
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tp15 = phase_tp(torch, serve, models, configs, all_kernels, cells=TP15_CELLS,
                    train_cells=TP15_TRAIN_CELLS, phase=15, train_styles=("tp",) + TP16_STYLES)
    print(f"phase 15 (a) hybrid and encoder-decoder serving: {tp15['world']} {tp15['backend']} "
          f"ranks on {tp15['device']}, mesh data 1 x model {tp15['world']} [{smi}]")
    for arch, r in tp15["cells"].items():
        print(f"phase 15 (a) {arch} ({r['n_layers']} layers, {r['layout']}): "
              f"{r['ms_per_decode_step']:.3f} ms per decode step (unsharded "
              f"{r['unsharded_ms_per_decode_step']:.3f}), collectives per step "
              f"{json.dumps(r['collectives_per_step'])}, float32 {r['f32_err_of_scale']:.3e} / "
              f"bf16 {r['bf16_err_of_scale']:.3e} of scale from unsharded, argmax agreement "
              f"{json.dumps(r['argmax_agreement'])}, serve peak GiB per rank "
              f"{json.dumps([round(x, 3) for x in r['serve_peak_gib_per_rank']])} (unsharded "
              f"{r['unsharded_serve_peak_gib']:.3f}), launches {json.dumps(r['launches'])}")
    for style, arch, ranks in ((s, a, rs) for s, cells in tp15["train"].items()
                               for a, rs in cells.items()):
        r = ranks[0]
        label = "phase 15 (b)" if style == "tp" else "phase 16"
        print(f"{label} train {arch} ({r['n_layers']} layers, B {TP15_BATCH} x {TP15_SEQ}, "
              f"{style} style): float32 step held on each rank against the unsharded step "
              f"{json.dumps([x['f32_held'] for x in ranks])}, launches "
              f"{json.dumps(r['f32_launches'])}; bf16 ms per step "
              f"{json.dumps([round(x, 3) for x in r['bf16_ms']])}, losses "
              f"{json.dumps(r['bf16_losses'])}, collectives of the last step "
              f"{json.dumps(r['bf16_comm'])}, launches {json.dumps(r['bf16_launches'])}, peak "
              f"GiB per rank {json.dumps([round(x['bf16_peak_gib'], 3) for x in ranks])} [{smi}]")
    print(f"phases 15-16 took {time.perf_counter() - t0:.1f} s (phase 16's train cells in "
          f"phase 15's world)")

    t0 = time.perf_counter()
    split = phase_tp(torch, serve, models, configs, all_kernels, cells=SPLIT_CELLS, phase=17,
                     setup=SPLIT_SETUP, expected=split_expected)
    print(f"phase 17 (a) a batch below dp: {split['world']} {split['backend']} ranks on "
          f"{split['device']}, mesh data {split['world']} x model 1, B {SPLIT_SETUP.batch}, "
          f"every decode cache's slots split over data [{smi}]")
    for arch, r in split["cells"].items():
        print(f"phase 17 (a) {arch} ({r['n_layers']} layers, {r['layout']}): "
              f"{r['ms_per_decode_step']:.3f} ms per decode step (unsharded "
              f"{r['unsharded_ms_per_decode_step']:.3f}), lse kernel launches per step "
              f"{r['lse_launches_per_step']:g}, collectives per step "
              f"{json.dumps(r['collectives_per_step'])}, float32 {r['f32_err_of_scale']:.3e} "
              f"of scale from unsharded over {SPLIT_SETUP.steps} steps (limit {TP_F32_TOL:.0e}), "
              f"bf16 gap {r['bf16_err_of_scale']:.3e}, argmax agreement "
              f"{json.dumps(r['argmax_agreement'])}, launches {json.dumps(r['launches'])} [{smi}]")
    print(f"phase 17 (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = join_dryrun(dryruns)
    for tag, r in dry.items():
        rf, mem = r["roofline"], r["memory"]
        print(f"phase 17 (b) {r['line']}")
        print(f"phase 17 (b) {tag} projected from the H100 data sheet (not measured): "
              f"compute {rf['compute_s'] * 1e3:.4f} ms, memory {rf['memory_s'] * 1e3:.4f} ms "
              f"(counted traffic {rf['memory_s_upper'] * 1e3:.4f} ms), collectives "
              f"{rf['collective_s'] * 1e3:.4f} ms over InfiniBand ({rf['collective_s_nvlink'] * 1e3:.4f} "
              f"over NVLink) -> {rf['bottleneck']}; flops a rank "
              f"{r['cost']['flops_per_device']:.4g}, peak {mem['peak_bytes'] / 2 ** 30:.3f} GiB, "
              f"fits 80 GB {r['analytic_memory']['fits_hbm']}, host {r['host_s']} s")
    print(f"phase 17 (b) joined {time.perf_counter() - t0:.1f} s after phase 17 (a)")

    t0 = time.perf_counter()
    trf = phase_train_families(torch, models, configs, steps, all_kernels)
    for arch, r in trf["cells"].items():
        print(f"phase 18 train {r['arch']} ({r['n_layers']} layers, B 16 x 128, DS every 2 "
              f"steps) [{smi}]: {r['ms_per_step']:.2f} ms per step (median of steps 2-"
              f"{TRAIN18_STEPS}), {r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gib']:.2f} "
              f"GiB ({100 * r['peak_share']:.1f} % of the card), run {r['run_s']:.1f} s, "
              f"losses {json.dumps(r['losses'])}, step ms "
              f"{json.dumps([round(x, 2) for x in r['step_ms']])}, attention launches per step "
              f"{json.dumps(r['attention_per_step'])}, scan launches per step "
              f"{json.dumps(r['scan_per_step'])}, matcher launches per slot "
              f"{json.dumps(r['matcher_launches_per_slot'])} ({r['slots']} slots)")
    for arch, r in trf["card_vs_cpu"].items():
        print(f"phase 18 reduced {arch} train step, card vs CPU: {json.dumps(r)}")
    q = trf["quickstart"]
    print(f"phase 18 quickstart on the card, {q['slots']} slots, {q['seconds']:.1f} s [{smi}]: "
          f"DataSche {q['reduction_pct']:.1f} % below CU_FULL in unit cost, launches "
          f"{json.dumps(q['launches'])}; " + " | ".join(" ".join(ln.split()) for ln in q["lines"]))
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s (card vs CPU "
          f"{trf['card_vs_cpu_s']:.1f} s)")

    t0 = time.perf_counter()
    paper = phase_paper(torch, core, bridge, ops, all_kernels, training_alloc)
    report_paper(paper, smi, t0)

    for mod in ("jax", "repro", "benchmarks"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    sources = {"collection": "src/repro/kernels/matching/kernel.py:122",
               "assignment": "src/repro/kernels/matching/kernel.py:64",
               "pairing": "src/repro/kernels/matching/kernel.py:180"}
    line = []
    for op, r in kres.items():
        tm = r["timing"]["main"]
        line.append({
            "name": f"greedy_{op}", "route": "cuda",
            "source": "src/repro_torch/kernels/matching/csrc/greedy_matching.cu",
            "replaces": sources[op],
            "launches": main_res["l-ds"]["launches"][f"greedy_{op}"],
            "launches_ds": main_res["ds"]["launches"][f"greedy_{op}"],
            "launches_fleet": {name: r["launches"][f"greedy_{op}"]
                               for name, r in fleet["homogeneous"].items()},
            "launches_paper": {fig: n[f"greedy_{op}"] for fig, n in paper["launches"].items()},
            "max_abs_err": r["max_abs_err"], "ms": tm["device_ms"], "device_ms": tm["device_ms"],
            "event_ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None, "shape": tm["shape"],
            "variant": tm["variant"], "selections": tm["selections"],
            "device_us_per_selection": tm["device_us_per_selection"],
            "bit_equal": all(c["bit_equal"] for c in r["checks"]),
            **{label: r["timing"][label] for label in ("big", "batched", "row_dominated")
               if label in r["timing"]},
            "ptxas": {k: v for k, v in matcher_regs.items() if k.startswith(op)},
        })
    fa_replaces = "src/repro/kernels/flash_attention/kernel.py:133"
    fa = lm_kres["flash_attention"]
    pre, dec = fa["prefill_bf16"], fa["decode_bf16"]
    mini = serve_res["minitron-4b"]
    fa_err = {route: max(r["max_abs_err"] for r in fa.values() if r["route"] == route)
              for route in ("simt", "wgmma", "decode")}

    def simt_count(counts):
        return counts["flash_attention"] - counts["flash_attention_wgmma"] - \
            counts["flash_attention_decode"]

    def train_launches(name):
        """Phase 18's launches of one attention kernel a train step, by arch."""
        return {r["arch"]: r["attention_per_step"].get(name, 0.0)
                for r in trf["cells"].values()}

    def family_launches(count):
        """Phase 12's launches of one kernel per decode step, 16-token forward
        and prefill, per arch."""
        return {arch: {w: count(r[f"{w}_launches"]) for w in ("step", "forward", "prefill")}
                for arch, r in fam.items()}

    # The SIMT kernel's main path is now minitron-4b's 16-token forward, timed
    # at its shape (forward16_bf16); "decode_forced" keeps its time forced at
    # the serve run's decode shape, its main path before the decode kernel.
    # The decode kernel's is the serve run; the wgmma kernel's the B 4 x 2048
    # prefill. A SIMT or decode "ms" is the device time per call (CUDA graph
    # replay); "event_ms" times back-to-back wrapper calls, which the host
    # bounds at these few microseconds.
    fwd = fa["forward16_bf16"]
    fwd_prof = mini["forward_profile"]
    line.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": fa_replaces, "launches": simt_count(mini["forward_launches"]),
        "launches_serve": simt_count(mini["serve_launches"]),
        "launches_families": family_launches(simt_count),
        "launches_per_decode_step": simt_count(mini["step_launches"]),
        "launches_tp_train_step": {
            style: {arch: simt_count(ranks[0]["bf16_launches"]) for arch, ranks in cells.items()}
            for style, cells in tp15["train"].items()},
        "launches_train": {arch: n - train_launches("flash_attention_wgmma")[arch]
                           for arch, n in train_launches("flash_attention").items()},
        "max_abs_err": fa_err["simt"],
        "ms": fwd["device_ms"], "device_ms": fwd["device_ms"], "event_ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "library_device_ms": fwd.get("library_device_ms"),
        "shape": fwd["shape"], "rows": fwd["rows"], "occupancy": fwd["occupancy"],
        "forward16_profile": {"device_busy_ms": fwd_prof["device_busy_ms"],
                              "simt_ms": fwd_prof["match_ms"],
                              "simt_launches": fwd_prof["match_count"],
                              "simt_share": fwd_prof["kernel_share"]},
        "decode_forced": {"shape": dec["shape"], "ms": dec["simt_device_ms"],
                          "event_ms": dec["simt_ms"], "plain_ms": dec["plain_ms"],
                          "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
                          "library_ms": dec["library_ms"],
                          "library_device_ms": dec.get("library_device_ms")},
        "prefill": {"shape": pre["shape"], "ms": pre["simt_ms"], "bound_ms": pre["bound_ms"]},
        "cases": {c: {k: r.get(k) for k in (
            "shape", "dtype", "spec", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "library_note", "rows", "err_of_scale")}
            for c, r in fa.items() if r["route"] == "simt"},
        "ptxas": simt_regs,
        "registers": max(r["registers"] for r in simt_regs.values()),
        "spill_bytes": sum(r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
                           for r in simt_regs.values()),
    })
    line.append({
        "name": "flash_attention_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_decode_sm90.cu",
        "replaces": fa_replaces, "launches": mini["serve_launches"]["flash_attention_decode"],
        "launches_families": family_launches(lambda c: c["flash_attention_decode"]),
        "launches_per_decode_step": mini["step_launches"]["flash_attention_decode"],
        "launches_tp15": {arch: r["launches"]["flash_attention_decode"]
                          for arch, r in tp15["cells"].items()},
        "launches_train": train_launches("flash_attention_decode"),
        "max_abs_err": fa_err["decode"], "ms": dec["device_ms"], "event_ms": dec["ms"],
        "simt_ms": dec["simt_device_ms"], "simt_event_ms": dec["simt_ms"],
        "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "library_device_ms": dec.get("library_device_ms"),
        "shape": dec["shape"], "n_split": dec["n_split"],
        "cases": {c: {k: fa[c].get(k) for k in (
            "shape", "n_split", "ms", "device_ms", "simt_ms", "simt_device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_note", "err_of_scale")}
            for c in ("decode_ring_bf16", "decode32k_b4_bf16", "decode32k_b128_bf16",
                      "decode_f32", "decode_hd80_bf16", "decode_mqa_bf16", "decode_cross_bf16")},
        "occupancy": dec["occupancy"], "ptxas": decode_regs,
        "long_cache_step": {k: mini["long_cache"][k] for k in (
            "ms_per_step", "device_busy_ms", "attention_ms", "attention_share",
            "vs_plain_err_of_scale")},
    })
    line.append({
        "name": "flash_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
        "replaces": fa_replaces,
        "launches": mini["prefill_launches"]["flash_attention_wgmma"],
        "launches_serve": mini["serve_launches"]["flash_attention_wgmma"],
        "launches_families": family_launches(lambda c: c["flash_attention_wgmma"]),
        "launches_train": train_launches("flash_attention_wgmma"),
        "max_abs_err": fa_err["wgmma"], "ms": pre["ms"], "simt_ms": pre["simt_ms"],
        "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"], "shape": pre["shape"],
        "occupancy": pre["occupancy"], "sass": sass,
        "train": {**{k: trn["attention"][k] for k in (
            "shape", "ms", "forward_ms", "backward_ms", "forward_backward_ms", "plain_ms",
            "bound_ms", "bound_by", "backward_bound_ms", "backward_bound_by", "library_ms",
            "library_forward_backward_ms", "forward_err_of_scale", "grads_bit_equal")},
            "launches": full["launches"]["flash_attention_wgmma"],
            "launches_per_step": full["wgmma_per_step"],
            "launches_tp_step": {style: {arch: ranks[0]["bf16_launches"].get(
                "flash_attention_wgmma", 0) for arch, ranks in cells.items()}
                for style, cells in tp15["train"].items()}},
    })
    lse = lse_res["lse_seq_bf16"]
    line.append({
        "name": "flash_attention_decode_lse", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_decode_sm90.cu",
        "replaces": fa_replaces,
        "launches": tp["cells"]["granite-20b"]["launches"]["flash_attention_decode_lse"],
        "launches_per_decode_step": tp["cells"]["granite-20b"]["n_layers"],
        "launches_split_decode": {arch: r["launches"]["flash_attention_decode_lse"]
                                  for arch, r in split["cells"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in lse_res.values()),
        "ms": lse["ms"], "device_ms": lse["ms"], "event_ms": lse["event_ms"],
        "plain_ms": lse["plain_ms"], "bound_ms": lse["bound_ms"], "bound_by": lse["bound_by"],
        "library_ms": None, "shape": lse["shape"], "n_split": lse["n_split"],
        "cases": {c: {k: r[k] for k in ("shape", "n_split", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "err_of_scale", "lse_rel_err",
                                        "lse_err_of_scale")} for c, r in lse_res.items()},
    })
    sc = lm_kres["mamba1_scan"]
    pre, dec = sc["prefill_bf16"], sc["decode_bf16"]
    per_call = configs.get_config("falcon-mamba-7b").n_layers
    falcon_train = trf["cells"]["falcon-mamba-7b"]
    line.append({
        "name": "mamba1_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba1_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:54",
        "launches": serve_res["falcon-mamba-7b"]["serve_launches"]["mamba1_scan"],
        "launches_per_forward": per_call, "launches_per_decode_step": per_call,
        "launches_train": falcon_train["launches"]["mamba1_scan"],
        "launches_per_train_step": falcon_train["scan_per_step"]["mamba1_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in sc.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"], "library_ms": None, "shape": pre["shape"],
        "decode": {k: dec[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "model_like_ms": sc["prefill_bf16_rand_a"]["ms"],
        "registers": max(r["registers"] for r in scan_regs.values()),
        "spill_bytes": sum(r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
                           for r in scan_regs.values()),
        "ptxas": scan_regs,
    })
    # The backward kernel's main path is falcon-mamba-7b's train step (phase
    # 18), timed at its shape (train_bf16); "prefill" keeps the B 4 x 2048
    # case. The Pallas scan has no backward: JAX differentiates
    # mamba1_scan_chunked (src/repro/kernels/mamba_scan/ops.py:31) off the TPU.
    tr = scan_bwd["train_bf16"]
    line.append({
        "name": "mamba1_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba1_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:54",
        "launches": falcon_train["launches"]["mamba1_scan_bwd"],
        "launches_per_train_step": falcon_train["scan_per_step"]["mamba1_scan_bwd"],
        "launches_phase11": trn["scan"]["launches"]["mamba1_scan_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in scan_bwd.values()),
        "ms": tr["ms"], "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"],
        "bound_by": tr["bound_by"], "library_ms": None, "shape": tr["shape"],
        **{k: tr[k] for k in ("device_ms", "sweep_device_ms", "walk_device_ms",
                              "reduce_device_ms")},
        "forward_ms": tr["forward_ms"], "err_of_scale": tr["err_of_scale"],
        "prefill": {k: scan_bwd["prefill_bf16"][k] for k in (
            "shape", "ms", "device_ms", "sweep_device_ms", "walk_device_ms", "reduce_device_ms",
            "forward_ms", "plain_ms", "bound_ms", "bound_by", "err_of_scale")},
        "registers": max(r["registers"] for r in scan_bwd_regs.values()),
        "spill_bytes": sum(r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
                           for r in scan_bwd_regs.values()),
        "ptxas": scan_bwd_regs,
    })
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": smi, "torch": torch.__version__, "build_s": build_s, "kernels": kres,
            "matcher_ptxas": matcher_regs,
            "sampler": sampler, "main_path": main_res, "training_ms": train_ms,
            "profile": prof,
            "parity": parity, "lm_build_s": lm_build_s, "wgmma_sass": sass,
            "scan_ptxas": scan_regs, "scan_bwd_ptxas": scan_bwd_regs,
            "decode_ptxas": decode_regs, "simt_ptxas": simt_regs,
            "lm_kernels": lm_kres, "scan_bwd": scan_bwd,
            "serve": serve_res, "lm_parity": lm_parity, "fleet": fleet, "train": trn,
            "families": fam, "distributed": dst, "decode_lse": lse_res,
            "tensor_parallel": tp, "tensor_parallel_15": tp15, "split_decode": split,
            "dryrun": dry, "train_families": trf,
            "paper": paper},
            indent=1, default=str))
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"all phases took {time.perf_counter() - t_start:.1f} s (of a 1,200 s limit)")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
