#!/usr/bin/env python3
"""Device and event times of the greedy matching kernels of one source tree.

    python3 scripts/matcher_times.py [--src DIR] [--json PATH]

Builds the matchers of ``DIR/repro_torch`` (default: this checkout's
``src``) and times each kernel as ``chip_smoke.py`` phase 2 does, on the
same inputs: CUDA events around back-to-back calls, and device time per call
by CUDA graph replay, at 1024 x 32, 4096 x 64, a fleet's 8 x 1024 x 32 and
row-dominated 1024 x 32 weights (pairing: M x M at the same M), each cell
also held bit for bit against the plain version. To compare two trees on one
card, run it on both in turns in one session (A, B, B, A): an older tree's
wrapper is timed as it is. Prints the card and one JSON object; needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the tree's src directory, holding repro_torch")
    parser.add_argument("--json", type=Path, default=None, help="also write the result here")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("matcher_times: no CUDA device is available", file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import chip_smoke
    from repro_torch.kernels.matching import kernel, ref
    if src not in Path(kernel.__file__).resolve().parents:
        raise SystemExit(f"matcher_times: imported {kernel.__file__}, not a module of {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    kernel.build()
    result = {"card": smi, "src": str(src), "build_s": time.perf_counter() - t0}
    for op in ("collection", "assignment", "pairing"):
        result[op] = chip_smoke.time_matchers(torch, kernel, ref, op, plain=False)
        for label, tm in result[op].items():
            print(f"greedy_{op} {label} {tm['shape']} ({tm['variant']}): device "
                  f"{tm['device_ms']:.5g} ms, event {tm['ms']:.5g} ms, "
                  f"{tm['selections']} selections, bit-equal {tm['bit_equal']}")
    if not all(tm["bit_equal"] for op in ("collection", "assignment", "pairing")
               for tm in result[op].values()):
        print("matcher_times: a kernel differs from its plain version", file=sys.stderr)
        return 1
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
