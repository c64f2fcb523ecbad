#!/usr/bin/env python3
"""Device times and SASS census of the Mamba-1 scan's backward kernel
(``mamba1_scan_bwd.cu``) built from one or more sources, compared on one
card.

    python3 scripts/scan_bwd_times.py [--src LABEL=PATH ...] [--order L1,L2,...]
        [--cases train_bf16,prefill_bf16] [--unchecked LABEL,...] [--json PATH]

Each ``--src`` names a copy of ``mamba1_scan_bwd.cu`` inside this checkout
(default: ``new=`` the package's own); each is built alone into a library
of its own (``-Xptxas -v``) and called through the package's wrapper
(``kernel.mamba1_scan_bwd_cuda``) with that library bound, so every source
sees the same allocation and launch arguments. For each case of
``chip_smoke.SCAN_BWD_CASES`` named (drawn as phase 6 draws it) and each
label in ``--order`` (e.g. ``old,new,new,old``): every gradient against
``ref.mamba1_scan_bwd_ref`` (of scale, SCAN_BWD_TOL; labels listed in
``--unchecked`` are timed but not held to it), the call's ms by CUDA
events (20 calls after 2), and the device ms per call of each kernel the
call launches, summed from torch.profiler's raw records over 10 calls. Per
library: ptxas's registers, spills and shared memory per kernel instance,
and from ``cuobjdump -sass`` the instructions of each loop (a backward
branch and its target) of the bf16 G = 4 instance (N = 16, the models'),
by class. Prints the card and one JSON object; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "mamba_scan" / "csrc" / \
    "mamba1_scan_bwd.cu"
FLAGS = ("-Xptxas", "-v")
# Instruction classes of the census, by opcode prefix.
CLASSES = ("MUFU.EX2", "SHFL", "BAR", "LDS", "STS", "LDG", "STG", "LDGSTS", "FFMA", "FMUL",
           "FADD", "FSEL", "SEL", "SYNCS", "UCGABAR")
INSTANCE = "mamba1_scan_bwd_kernelI13__nv_bfloat16Li4E"


def short_name(mangled: str) -> str:
    """A kernel instance's name and template arguments from its mangled
    name (the length prefix keeps it off the source's file name)."""
    m = re.search(r"\d(mamba1_scan_bwd_\w*?kernel)I(\w+?)E+v", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled[:60]


def sass_census(lib: Path, cuda_tool, dump: Path | None = None) -> dict:
    """Per kernel function of ``lib`` whose name holds INSTANCE (or any
    reduce kernel): the instruction count by class of the whole function
    and of each loop, a loop being the range from a backward branch's
    target to the branch. With ``dump``, the INSTANCE's SASS is written
    there."""
    text = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur, kept = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if (INSTANCE in m.group(1) or "reduce" in m.group(1)) else None
            if cur:
                funcs[cur] = []
            continue
        if cur and INSTANCE in cur:
            kept.append(line)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);", line)
        if cur and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text("\n".join(kept) + "\n")

    def count(instrs) -> dict:
        out = {k: 0 for k in CLASSES}
        for _, op, _ in instrs:
            for k in CLASSES:
                if op == k or op.startswith(k + "."):
                    out[k] += 1
                    break
        out["all"] = len(instrs)
        return {k: v for k, v in out.items() if v}

    result = {}
    for name, instrs in funcs.items():
        loops = []
        for addr, op, rest in instrs:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                body = [i for i in instrs if lo <= i[0] <= addr]
                loops.append({"from": hex(lo), "to": hex(addr), **count(body)})
        result[short_name(name)] = {"function": count(instrs), "loops": loops}
    return result


def ptxas(lib: Path) -> dict:
    """ptxas's registers, spills and static shared memory per kernel
    instance, from the build log."""
    out, cur = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line) or \
            re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if cur and m:
            out[cur].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if cur and m:
            out[cur].update(registers=int(m.group(1)), static_smem_bytes=int(m.group(2)))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur]["registers"] = int(m.group(1))
    return {short_name(k): v for k, v in out.items() if "mamba1_scan_bwd" in k}


def bind(lib_path: Path):
    import ctypes
    lib = ctypes.CDLL(str(lib_path))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mamba1_scan_bwd_workspace_floats.argtypes = [i] * 4
    lib.mamba1_scan_bwd_workspace_floats.restype = i64
    lib.mamba1_scan_bwd_launch.argtypes = [vp] * 15 + [i] * 4 + [i64] * 4 + [i] * 2 + [vp]
    lib.mamba1_scan_bwd_launch.restype = i
    return lib


@contextmanager
def bound_library(skernel, lib):
    saved = skernel._lib
    skernel._lib = lib
    try:
        yield
    finally:
        skernel._lib = saved


def draw_case(torch, chip_smoke, name: str):
    """The inputs phase 6 of ``chip_smoke.py`` draws for this case."""
    idx = [c[0] for c in chip_smoke.SCAN_BWD_CASES].index(name)
    _, (b, s, di, n), dname, with_h0, strided, _ = chip_smoke.SCAN_BWD_CASES[idx]
    rng = np.random.default_rng(300 + idx)
    dtype = getattr(torch, dname)

    def draw(size, lo=None, hi=None):
        return chip_smoke.cuda_draw(torch, rng, size, lo, hi)

    x, dt = draw((b, s, di)).to(dtype), draw((b, s, di), 0.001, 0.1).to(dtype)
    a = -torch.exp(draw((di, n), 0.0, float(np.log(16.0))))
    if strided:
        _, bm, cm = draw((b, s, 256 + 2 * n)).to(dtype).split([256, n, n], dim=-1)
    else:
        bm, cm = draw((b, s, n)).to(dtype), draw((b, s, n)).to(dtype)
    h0, gh = (draw((b, di, n)), draw((b, di, n))) if with_h0 else (None, None)
    gy = draw((b, s, di)).to(dtype)
    return (x, dt, a, bm, cm, h0, gy, gh), dname


def kernel_ms(torch, chip_smoke, fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (profiler)."""
    prof = chip_smoke.profile_window(torch, lambda: [fn() for _ in range(calls)], top=12)
    out = {}
    for rec in prof["top"]:
        m = re.search(r"mamba1_scan_bwd\w*(<[^>]*>)?|\w+(?=<|\()", rec["name"])
        key = m.group(0) if m else rec["name"][:40]
        got = out.setdefault(key, {"ms": 0.0, "per_call": 0.0})
        got["ms"] += rec["ms"] / calls
        got["per_call"] += rec["count"] / calls
    out["busy_ms"] = prof["device_busy_ms"] / calls
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", action="append", default=[],
                        help="LABEL=PATH of a mamba1_scan_bwd.cu inside this checkout")
    parser.add_argument("--order", default="",
                        help="labels in the order timed (default: each once)")
    parser.add_argument("--cases", default="train_bf16,prefill_bf16")
    parser.add_argument("--unchecked", default="", help="labels not held to the tolerance")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    parser.add_argument("--sass-dir", type=Path, default=None,
                        help="write each library's bf16 G = 4 SASS here as LABEL.sass")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from repro_torch.kernels.mamba_scan import ref as sref
    srcs = dict(s.split("=", 1) for s in args.src) or {"new": str(PACKAGE_SOURCE)}
    srcs = {k: Path(v).resolve() for k, v in srcs.items()}
    order = args.order.split(",") if args.order else list(srcs)
    unchecked = set(filter(None, args.unchecked.split(",")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    skernel.build()  # the forward kernel, for the wrapper's error strings
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = dict(zip(srcs, pool.map(
            lambda kv: _build.build(f"scan_bwd_{kv[0]}", [kv[1]], FLAGS), srcs.items())))
    result = {"card": smi, "build_s": time.perf_counter() - t0, "sources": {}, "cases": {}}
    libs = {}
    for label, path in paths.items():
        libs[label] = bind(path)
        # the wrapper reads a launch's error through the forward's library
        libs[label].mamba1_scan_error_string = skernel._library().mamba1_scan_error_string
        result["sources"][label] = {"source": str(srcs[label].relative_to(ROOT)),
                                    "ptxas": ptxas(path),
                                    "sass": sass_census(path, _build.cuda_tool, args.sass_dir and
                                                        args.sass_dir / f"{label}.sass")}
        print(f"{label}: {json.dumps(result['sources'][label])}", flush=True)
    failed = []
    for name in args.cases.split(","):
        inputs, dname = draw_case(torch, chip_smoke, name)
        want = sref.mamba1_scan_bwd_ref(*inputs)
        x, _, _, bm, _, h0, _, gh = inputs
        bound, bound_by = chip_smoke.scan_bwd_bound(x, bm, h0, gh)
        rows = []
        for label in order:
            with bound_library(skernel, libs[label]):
                call = lambda: skernel.mamba1_scan_bwd_cuda(*inputs)  # noqa: E731
                got = call()
                torch.cuda.synchronize()
                errs = {g: chip_smoke.rel_err(a, w)[1]
                        for g, a, w in zip(("x", "dt", "a", "b", "c", "h0"), got, want)}
                same = all(torch.equal(p, q) for p, q in zip(got, call()))
                ms = chip_smoke.cuda_ms(torch, call, reps=20, warmup=2)
                kms = kernel_ms(torch, chip_smoke, call)
            ok = max(errs.values()) <= chip_smoke.SCAN_BWD_TOL[dname] and same
            if label not in unchecked and not ok:
                failed.append((name, label))
            rows.append({"label": label, "ms": ms, "kernels": kms, "err_of_scale": errs,
                         "rerun_bit_equal": same, "ok": ok})
            print(f"{name} {label}: {ms:.5g} ms (events), kernels {json.dumps(kms)}, "
                  f"max err {max(errs.values()):.3g}, rerun equal {same}", flush=True)
            del got
        result["cases"][name] = {"shape": list(x.shape) + [bm.shape[-1]], "dtype": dname,
                                 "bound_ms": bound, "bound_by": bound_by, "runs": rows}
        del inputs, want, x, bm, h0, gh
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    if failed:
        print(f"scan_bwd_times: {failed} differ from the plain backward", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
