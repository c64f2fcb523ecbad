#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the greedy-matching CUDA kernels from ``src/repro_torch`` (nvcc,
     sm_90a) and time the build;
  2. hold each kernel bit for bit against its plain PyTorch version on the
     card, at the main path's shapes and at 4096 x 64, on dense, masked,
     integer-tied, batched (K = 4) and NaN-holding inputs, and time both;
  3. drive the main path -- ``run(cfg, LDS, T)`` and ``run(cfg, DS, T)`` at
     N = 1024 CUs x M = 32 ECs with the paper's Sec. IV-C simulation
     constants -- check the kernel launch counts, finite records and the
     per-slot feasibility invariants;
  4. run two L-DS slots from the same state and network on the card (with
     the kernels) and on the CPU (with the plain versions) and compare.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero without that last
line when there is no CUDA device or the port is not beside this script.
Imports nothing of JAX or of the JAX package. ``--json PATH`` also writes
every measurement to PATH.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
T_SLOTS = 12
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
MAIN_SHAPE = (1024, 32)
BIG_SHAPE = (4096, 64)


def sim_config(core, n_cu: int, n_ec: int):
    """The paper's Sec. IV-C simulation constants (f_base cycling over the
    four EC classes) at N x M."""
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

def kernel_inputs(torch, op: str, shape, case: str, seed: int):
    """Inputs of one matcher on the card, made from a numpy seed. Values
    follow the main path: log-weights about 0..14 with -inf holes, linear
    weights d (mu - eta - c) of both signs, solo/pair objectives."""
    rng = np.random.default_rng(seed)
    n, m = shape
    lead = (4,) if case == "batched" else ()
    if op == "pairing":
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


def phase_kernels(torch, ops, kernel, ref):
    names = {"collection": "greedy_collection", "assignment": "greedy_assignment",
             "pairing": "greedy_pairing"}
    cases = ("dense", "masked", "ties", "batched", "nan")
    results = {}
    for idx, op in enumerate(("collection", "assignment", "pairing")):
        checks = []
        max_err = 0.0
        for shape in (MAIN_SHAPE, BIG_SHAPE):
            pshape = (shape[1], shape[1]) if op == "pairing" else shape
            for c, case in enumerate(cases):
                args, masks = kernel_inputs(torch, op, pshape, case, 1000 * idx + 10 * c + shape[1])
                got = op_call(ops, op, args, masks, "kernel")
                want = op_call(ops, op, args, masks, "ref")
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                checks.append({"shape": list(pshape), "case": case, "bit_equal": equal,
                               "tile_in_smem": kernel.tile_in_smem[names[op]],
                               "selected": float(got.sum())})
                if not equal:
                    fail(f"{names[op]} differs from its plain version at {pshape} "
                         f"({case}): max abs err {err}")
        results[op] = {"checks": checks, "max_abs_err": max_err}

    # Times at the main path's shapes (and 4096 x 64), dense inputs: the
    # wrapper alone against the plain version on the same tensors.
    for idx, op in enumerate(("collection", "assignment", "pairing")):
        timing = {}
        for label, shape in (("main", MAIN_SHAPE), ("big", BIG_SHAPE)):
            n, m = (shape[1], shape[1]) if op == "pairing" else shape
            (args, _) = kernel_inputs(torch, op, (n, m), "dense", 7 + idx)
            if op == "collection":
                logw = args[0].reshape(1, n, m).contiguous()
                pen = ref.penalty_table(n, logw.device)
                run_k = lambda: kernel.greedy_collection_cuda(logw, pen)  # noqa: E731
                run_p = lambda: ref.greedy_collection_ref(logw)  # noqa: E731
                n_in = 2 * n * m + n + 1  # logw + pen read, alpha written (floats)
            elif op == "assignment":
                w = args[0].reshape(1, n, m).contiguous()
                run_k = lambda: kernel.greedy_assignment_cuda(w)  # noqa: E731
                run_p = lambda: ref.greedy_assignment_ref(w)  # noqa: E731
                n_in = 2 * n * m
            else:
                w = ref.pairing_value_matrix(*args).reshape(1, m, m).contiguous()
                run_k = lambda: kernel.greedy_pairing_cuda(w)  # noqa: E731
                run_p = lambda: ref.greedy_pairing_values(w)  # noqa: E731
                n_in = 2 * m * m
            out = run_k()
            torch.cuda.synchronize()
            takes = int(out.sum()) if op != "pairing" else int(torch.triu(out[0]).sum())
            ops_needed = greedy_ops(op, n, m, takes)
            bound_bytes = 4.0 * n_in / H100_BYTES_PER_S * 1e3
            bound_ops = ops_needed / H100_FP32_OPS_PER_S * 1e3
            k_ms = cuda_ms(torch, run_k, reps=20, warmup=2)
            p_ms = cuda_ms(torch, run_p, reps=3 if label == "main" else 1, warmup=1)
            timing[label] = {
                "shape": [n, m], "selections": takes, "ops_needed": ops_needed,
                "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            }
        results[op]["timing"] = timing
    return results


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
    """Device time of one slot of each spec under torch.profiler: kernel
    time summed over CUDA events, the launch count, and the busy share of
    the slot's unprofiled wall time from phase 3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    out = {}
    for spec in (core.LDS, core.DS):
        core.step(cfg, spec, state)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            core.step(cfg, spec, state)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        if busy_ms <= 0.0:
            fail(f"{spec.name}: the profiler saw no device time")
        top = sorted(kernels, key=dev_us, reverse=True)[:8]
        wall = main_res[spec.name]["ms_per_slot"]
        out[spec.name] = {
            "device_busy_ms": busy_ms, "device_launches": sum(e.count for e in kernels),
            "slot_ms": wall, "busy_share": busy_ms / wall,
            "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "count": e.count} for e in top],
        }
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write every measurement to this JSON file")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import bridge, core
    from repro_torch.core import metrics, training_alloc
    from repro_torch.kernels.matching import kernel, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    kernel.build()
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.1f} s")

    t0 = time.perf_counter()
    kres = phase_kernels(torch, ops, kernel, ref)
    print(f"phase 2 kernels vs plain: all bit-equal ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
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

    for mod in ("jax", "repro"):
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
            "max_abs_err": r["max_abs_err"], "ms": tm["ms"], "kernel_ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "shape": tm["shape"],
            "bit_equal": all(c["bit_equal"] for c in r["checks"]),
            "big": r["timing"]["big"],
        })
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": smi, "torch": torch.__version__, "build_s": build_s, "kernels": kres,
            "main_path": main_res, "training_ms": train_ms, "profile": prof,
            "parity": parity}, indent=1))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
