#!/usr/bin/env python3
"""Compile time and SASS of each CUDA source of the port with and without
one nvcc flag (by default ``--split-compile=8``, which the flash library's
SIMT source takes through ``kernels/_build.py``'s ``source_flags``).

    python3 scripts/nvcc_split.py [--flag FLAG] [SOURCE ...]

Starts every source's nvcc at once (as ``chip_smoke.py`` builds the
libraries), with the repo's flags (``_build.NVCC_FLAGS`` and ``-Xptxas
-v``, as an object file), first without the flag, then with it; prints
each source's own wall time both ways and, function by function, whether
``cuobjdump -sass`` gives the same instructions. A flag goes to a source
only where every function's SASS is the same. Needs the CUDA toolkit (the
card's machine); writes under a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass_functions(cuobjdump: str, obj: Path) -> dict:
    """name -> instructions of each function in ``obj`` (addresses and
    encodings dropped)."""
    text = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(body)
            name, body = m.group(1), []
        elif name:
            body.append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    if name:
        out[name] = "\n".join(body)
    return out


def compile_all(nvcc: str, flags: list, sources: list, out_dir: Path) -> dict:
    """Each source's nvcc wall time (s), all started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    seconds, errors = {}, {}

    def one(src: Path):
        done = subprocess.run([nvcc, *flags, "-o", str(out_dir / f"{src.name}.o"), str(src)],
                              capture_output=True, text=True)
        seconds[src.name] = time.perf_counter() - t0
        if done.returncode:
            errors[src.name] = done.stdout + done.stderr

    threads = [threading.Thread(target=one, args=(src,)) for src in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit(f"nvcc failed: {json.dumps(errors)[:4000]}")
    return seconds


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--flag", default="--split-compile=8")
    parser.add_argument("sources", nargs="*", type=Path,
                        default=sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*/csrc/*.cu")))
    args = parser.parse_args(argv)
    nvcc, cuobjdump = _build.cuda_tool("nvcc"), _build.cuda_tool("cuobjdump")
    base = [f for f in _build.NVCC_FLAGS if f != "-shared"] + ["-Xptxas", "-v", "-c"]
    with tempfile.TemporaryDirectory() as tmp:
        plain = compile_all(nvcc, base, args.sources, Path(tmp) / "plain")
        flagged = compile_all(nvcc, base + [args.flag], args.sources, Path(tmp) / "flagged")
        for src in args.sources:
            a = sass_functions(cuobjdump, Path(tmp) / "plain" / f"{src.name}.o")
            b = sass_functions(cuobjdump, Path(tmp) / "flagged" / f"{src.name}.o")
            differ = sorted(n for n in a if a[n] != b.get(n))
            print(json.dumps({"source": src.name, "seconds": round(plain[src.name], 1),
                              "seconds_with_flag": round(flagged[src.name], 1),
                              "functions": len(a), "same_names": sorted(a) == sorted(b),
                              "functions_differ": len(differ), "differ": differ[:4]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
