"""Builds a package's CUDA sources into a shared library at first use.

The library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) with a plain C
interface and loaded with ``ctypes``: one ``nvcc`` call for a library of
one source; for several, one ``nvcc`` per source, all started together, then
a link. A source may add flags of its own (``source_flags``, by file name).
It lands in ``build/repro_torch/`` at the root of the checkout, named by a
hash of the sources and the flags, so an edited source is rebuilt and an
unchanged one is compiled once per checkout; nvcc's own output is kept
beside it (``.log``). Only sources inside this repository are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Mapping, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

# Flags of every library. A library adds its own (``extra_flags``): the
# greedy matchers pass --fmad=false, which keeps every float a*b+c a separate
# multiply and add as PyTorch computes them, because they are held bit for
# bit against their plain versions. Kernels held to a tolerance (attention,
# the selective scan) keep nvcc's default contraction into fused multiply-adds.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / name).is_file():
            return str(Path(root) / "bin" / name)
    raise RuntimeError(f"{name} was not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def library_path(name: str, sources: Sequence[Path], extra_flags: Sequence[str] = (),
                 source_flags: Mapping[str, Sequence[str]] = {}) -> Path:
    digest = hashlib.sha256()
    for flag in (*NVCC_FLAGS, *extra_flags):
        digest.update(flag.encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
        for flag in source_flags.get(Path(src).name, ()):
            digest.update(flag.encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path], extra_flags: Sequence[str] = (),
          source_flags: Mapping[str, Sequence[str]] = {}) -> Path:
    """Compile ``sources`` with ``NVCC_FLAGS``, ``extra_flags`` and each
    source's ``source_flags`` into one shared library unless it exists;
    returns its path. Raises with nvcc's output when the build fails."""
    sources = [Path(s).resolve() for s in sources]
    for src in sources:
        if REPO_ROOT not in src.parents:
            raise ValueError(f"{src} is not a source of this repository")
    out = library_path(name, sources, extra_flags, source_flags)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # One nvcc for a single source; with several, one per source, all started
    # together, then a link.
    objs = [out.with_suffix(f".{i}.{os.getpid()}.o") for i in range(len(sources))] \
        if len(sources) > 1 else []
    if not objs:
        compiles = [[cuda_tool(), *NVCC_FLAGS, *extra_flags,
                     *source_flags.get(sources[0].name, ()), "-o", str(tmp), str(sources[0])]]
    else:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        compiles = [[cuda_tool(), *compile_flags, *extra_flags, *source_flags.get(src.name, ()),
                     "-c", "-o", str(obj), str(src)] for obj, src in zip(objs, sources)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        runs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in zip(compiles, procs)]
        if objs and all(rc == 0 for _, _, rc in runs):
            link = [cuda_tool(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, objs)]
            done = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            runs.append((link, done.stdout, done.returncode))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    for cmd, text, rc in runs:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
    # nvcc's report (e.g. ptxas -v: registers and spills per kernel) beside it.
    out.with_suffix(".log").write_text("".join(text for _, text, _ in runs))
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def load(name: str, sources: Sequence[Path], extra_flags: Sequence[str] = (),
         source_flags: Mapping[str, Sequence[str]] = {}) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, sources, extra_flags, source_flags)))
